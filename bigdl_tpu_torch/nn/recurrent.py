"""Time-distributed wrapper.

Counterpart of ``bigdl_tpu/nn/recurrent.py:342`` ``TimeDistributed`` (only
this class of that module is on the port's path so far): fold time into
batch, one large product on (N*T, ...) instead of T small ones.
"""

from __future__ import annotations

from bigdl_tpu_torch.nn.abstractnn import AbstractModule, Container, child_state


class TimeDistributed(Container):
    """Apply the wrapped module at every timestep of (N, T, ...) input."""

    def __init__(self, module: AbstractModule):
        super().__init__(module)

    def run(self, input, state=None):
        n, t = input.shape[0], input.shape[1]
        x = input.reshape((n * t,) + tuple(input.shape[2:]))
        out, s = self[0].run(x, child_state(state, "0"))
        out = out.reshape((n, t) + tuple(out.shape[1:]))
        return out, (None if state is None or s is None else {"0": s})
