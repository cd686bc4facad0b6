"""Composition containers: Sequential, Concat, ConcatTable, CAddTable,
CMulTable, JoinTable, SelectTable, Identity, Remat.

Counterpart of ``bigdl_tpu/nn/containers.py``. The residual join of the
transformer blocks is ``ConcatTable(Identity, branch) >> CAddTable``; the
SwiGLU MLP's gate is ``ConcatTable(gate, up) >> CMulTable``; Inception's
branch blocks are ``Concat(2)``; the TreeLSTM's graph picks its two inputs
with ``SelectTable``. Table indices and dimensions are 1-based, as in JAX.
"""

from __future__ import annotations

import torch.utils.checkpoint
from torch.func import functional_call

import torch

from bigdl_tpu_torch.nn import layout
from bigdl_tpu_torch.nn.abstractnn import AbstractModule, Container, child_state
from bigdl_tpu_torch.nn.normalization import checkpoint_contexts
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


class Concat(Container):
    """Apply each child to the same input; concatenate the outputs along
    ``dimension``, 1-based counting the batch axis first (the reference's
    convention): the default 2 is NCHW's channel axis. Under NHWC
    (``nn/layout.py``), dimension 2 of a 4-D activation means the channel
    axis and resolves to the last one, as in JAX; ``literal_dim=True``
    keeps the literal second axis (4-D tables that are not images)."""

    def __init__(self, dimension: int = 2, literal_dim: bool = False):
        super().__init__()
        self.dimension = dimension
        self.literal_dim = literal_dim

    def run(self, input, state=None):
        outs = []
        new_state = None if state is None else {}
        for name, m in self._modules.items():
            o, s = m.run(input, child_state(state, name))
            outs.append(o)
            if new_state is not None and s is not None:
                new_state[name] = s
        axis = self.dimension - 1
        if axis == 1 and outs and outs[0].dim() == 4 and not self.literal_dim:
            axis = layout.channel_axis(4)
        return torch.cat(outs, dim=axis), new_state


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


class CMulTable(AbstractModule):
    """Element-wise product of a Table of tensors."""

    def run(self, input, state=None):
        xs = input.values() if isinstance(input, Table) else list(input)
        out = xs[0]
        for x in xs[1:]:
            out = out * x
        return out, state


class JoinTable(AbstractModule):
    """Concatenate a Table of tensors along ``dimension``; with
    ``n_input_dims`` a leading batch axis (one axis more than that) shifts
    the dimension by one."""

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def run(self, input, state=None):
        xs = input.values() if isinstance(input, Table) else list(input)
        axis = self.dimension - 1
        if self.n_input_dims > 0 and xs[0].dim() == self.n_input_dims + 1:
            axis += 1
        return torch.cat(xs, dim=axis), state


class SelectTable(AbstractModule):
    """Element ``index`` of the input Table (negative from the end)."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def run(self, input, state=None):
        xs = input.values() if isinstance(input, Table) else list(input)
        return xs[self.index - 1 if self.index > 0 else self.index], state


class Identity(AbstractModule):
    def run(self, input, state=None):
        return input, state


class Remat(Container):
    """Rematerialisation: runs its one child under non-reentrant
    ``torch.utils.checkpoint`` (JAX: ``jax.checkpoint``), so the child's
    activations are recomputed in the backward instead of kept. The
    recomputation re-runs the same ops, the kernels included (their launch
    counts grow accordingly), on the parameter tensors the forward used:
    under the trainer's ``functional_call`` those are the step's cast or
    detached ones, which are no longer in place when the backward runs.
    The generator's state is not saved for the recomputation (a captured
    training step may not read it): the dropout masks of the forward are
    kept and handed back to the recomputation instead
    (``normalization.checkpoint_contexts``). Without autograd, or with a
    decode state, the child runs plainly."""

    def __init__(self, module: AbstractModule = None):
        super().__init__(*([module] if module is not None else []))

    def add(self, module: AbstractModule) -> "Remat":
        if self._modules:
            raise ValueError("Remat wraps exactly one module")
        return super().add(module)

    def run(self, input, state=None):
        if not self._modules:
            raise RuntimeError("Remat has no child module: add() one first")
        m = self[0]
        if state is not None or not torch.is_grad_enabled():
            out, s = m.run(input, child_state(state, "0"))
            return out, (None if state is None or s is None else {"0": s})
        params = dict(m.named_parameters())     # the tensors in effect now
        out = torch.utils.checkpoint.checkpoint(
            lambda x: functional_call(m, params, (x,)), input,
            use_reentrant=False, preserve_rng_state=False,
            context_fn=checkpoint_contexts)
        return out, None
