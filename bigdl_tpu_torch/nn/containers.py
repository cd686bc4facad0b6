"""Composition containers: Sequential, ConcatTable, CAddTable, Identity.

Counterpart of ``bigdl_tpu/nn/containers.py``. The residual join of the
transformer blocks is ``ConcatTable(Identity, branch) >> CAddTable``.
"""

from __future__ import annotations

from bigdl_tpu_torch.nn.abstractnn import AbstractModule, Container, child_state
from bigdl_tpu_torch.utils.table import T, Table


class Sequential(Container):
    """Chain children; output of child i feeds child i+1."""

    def run(self, input, state=None):
        x = input
        new_state = None if state is None else {}
        for name, m in self._modules.items():
            x, s = m.run(x, child_state(state, name))
            if new_state is not None and s is not None:
                new_state[name] = s
        return x, new_state


class ConcatTable(Container):
    """Apply each child to the same input; output a Table of the results."""

    def run(self, input, state=None):
        outs = []
        new_state = None if state is None else {}
        for name, m in self._modules.items():
            o, s = m.run(input, child_state(state, name))
            outs.append(o)
            if new_state is not None and s is not None:
                new_state[name] = s
        return T(*outs), new_state


class CAddTable(AbstractModule):
    """Element-wise sum of a Table of tensors."""

    def run(self, input, state=None):
        xs = input.values() if isinstance(input, Table) else list(input)
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out, state


class Identity(AbstractModule):
    def run(self, input, state=None):
        return input, state
