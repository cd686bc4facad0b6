"""Composition containers and the table layers.

Counterpart of ``bigdl_tpu/nn/containers.py``, every class of it. The
residual join of the transformer blocks is ``ConcatTable(Identity,
branch) >> CAddTable``; the SwiGLU MLP's gate is ``ConcatTable(gate, up)
>> CMulTable``; Inception's branch blocks are ``Concat(2)``; the TreeLSTM's
graph picks its two inputs with ``SelectTable``. Table indices and
dimensions are 1-based, as in JAX. Table layers take and return the
port's ``utils/table.py`` ``Table`` (a list or tuple is taken too).

``MaskedSelect``'s output has a data-dependent size: JAX computes it
eagerly on the host and refuses it inside ``jit``. Here it runs eagerly
(``input[mask]``, whose size the host reads) and raises
``MaskedSelectCaptureError`` inside a CUDA graph capture
(``utils/programs.py``), where a host read cannot happen.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch.func import functional_call

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


class ParallelTable(Container):
    """Child i applied to element i of the input Table; a Table of the
    outputs."""

    def run(self, input, state=None):
        xs = _values(input)
        outs = []
        new_state = None if state is None else {}
        for (name, m), x in zip(self._modules.items(), xs):
            o, s = m.run(x, child_state(state, name))
            outs.append(o)
            if new_state is not None and s is not None:
                new_state[name] = s
        return T(*outs), new_state


class MapTable(Container):
    """One child, its parameters shared, applied to every element of the
    input Table; a Table of the outputs."""

    def __init__(self, module: Optional[AbstractModule] = None):
        super().__init__(*([module] if module is not None else []))

    def run(self, input, state=None):
        m, s = self[0], child_state(state, "0")
        outs = []
        for x in _values(input):
            o, s = m.run(x, s)
            outs.append(o)
        return T(*outs), (None if state is None or s is None else {"0": s})


class Bottle(Container):
    """Run the child on the input with its leading axes folded into one,
    so that the child sees ``n_input_dims`` axes, and unfold them in the
    output."""

    def __init__(self, module: AbstractModule, n_input_dims: int = 2):
        super().__init__(module)
        self.n_input_dims = n_input_dims

    def run(self, input, state=None):
        n_lead = input.dim() - (self.n_input_dims - 1)
        lead = tuple(input.shape[:n_lead])
        x = input.reshape((-1,) + tuple(input.shape[n_lead:])) \
            if n_lead > 1 else input
        out, s = self[0].run(x, child_state(state, "0"))
        if n_lead > 1:
            out = out.reshape(lead + tuple(out.shape[1:]))
        return out, (None if state is None or s is None else {"0": s})


def _values(input) -> list:
    return input.values() if isinstance(input, Table) else list(input)


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


class CSubTable(AbstractModule):
    """``x1 - x2`` of a Table pair."""

    def run(self, input, state=None):
        xs = _values(input)
        return xs[0] - xs[1], state


class CDivTable(AbstractModule):
    """``x1 / x2`` of a Table pair."""

    def run(self, input, state=None):
        xs = _values(input)
        return xs[0] / xs[1], state


class CMaxTable(AbstractModule):
    """Element-wise maximum of a Table of tensors."""

    def run(self, input, state=None):
        xs = _values(input)
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return out, state


class CMinTable(AbstractModule):
    """Element-wise minimum of a Table of tensors."""

    def run(self, input, state=None):
        xs = _values(input)
        out = xs[0]
        for x in xs[1:]:
            out = torch.minimum(out, x)
        return out, state


class CAveTable(AbstractModule):
    """Element-wise mean of a Table of tensors."""

    def __init__(self, inplace: bool = False):
        super().__init__()

    def run(self, input, state=None):
        xs = _values(input)
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out / float(len(xs)), state


class FlattenTable(AbstractModule):
    """Nested Tables (and lists) flattened into one Table, depth first."""

    def run(self, input, state=None):
        flat = []

        def rec(x):
            if isinstance(x, (Table, list, tuple)):
                for v in _values(x):
                    rec(v)
            else:
                flat.append(x)

        rec(input)
        return T(*flat), state


class NarrowTable(AbstractModule):
    """``length`` entries of the input Table from ``offset`` (1-based; a
    negative length counts back from the end); one entry comes out bare."""

    def __init__(self, offset: int, length: int = 1):
        super().__init__()
        self.offset, self.length = offset, length

    def run(self, input, state=None):
        xs = _values(input)
        start, length = self.offset - 1, self.length
        if length < 0:
            length = len(xs) - start + length + 1
        picked = xs[start:start + length]
        return (picked[0] if len(picked) == 1 else T(*picked)), state


class Pack(AbstractModule):
    """The entries of a Table stacked along a new axis ``dim`` (1-based)."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def run(self, input, state=None):
        return torch.stack(_values(input), dim=self.dim - 1), state


class BifurcateSplitTable(AbstractModule):
    """A Table of the two halves of the input along ``dimension``
    (1-based; its size must be even)."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def run(self, input, state=None):
        axis = self.dimension - 1 if self.dimension > 0 \
            else input.dim() + self.dimension
        n = input.shape[axis]
        if n % 2:
            raise ValueError(f"BifurcateSplitTable: dim {self.dimension} "
                             f"has odd size {n}")
        a, b = input.chunk(2, dim=axis)
        return T(a, b), state


class MixtureTable(AbstractModule):
    """``Table(gater (N, E), experts)``: the sum over e of ``gater[:, e] *
    expert_e``; the experts a Table of E tensors (stacked along ``dim``)
    or one tensor whose axis ``dim`` (1-based, batch first) holds them."""

    def __init__(self, dim: int = 2):
        super().__init__()
        self.dim = dim

    def run(self, input, state=None):
        xs = _values(input)
        gater, experts = xs[0], xs[1]
        axis = self.dim - 1
        stacked = torch.stack(_values(experts), dim=axis) \
            if isinstance(experts, (Table, list, tuple)) else experts
        shape = [1] * stacked.dim()
        shape[0], shape[axis] = gater.shape[0], gater.shape[1]
        return (gater.reshape(shape) * stacked).sum(axis), state


class Echo(AbstractModule):
    """Prints the shape of its input (every call; JAX prints at each
    trace) and passes it on."""

    def run(self, input, state=None):
        def shapes(x):
            if isinstance(x, (Table, list, tuple)):
                return [shapes(v) for v in _values(x)]
            return tuple(x.shape)
        print(f"[Echo {self.name}] {shapes(input)}")
        return input, state


class MaskedSelectCaptureError(RuntimeError):
    """``MaskedSelect`` was asked to run inside a CUDA graph capture."""


class MaskedSelect(AbstractModule):
    """``Table(x, mask)``: the 1-D tensor of x's entries where the mask is
    nonzero, eager only: its size is read from the mask on the host, so
    inside a captured program it raises ``MaskedSelectCaptureError``."""

    def run(self, input, state=None):
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise MaskedSelectCaptureError(
                "MaskedSelect has a data-dependent output size and cannot "
                "run inside a captured program (utils/programs.py): run it "
                "eagerly, or mask with torch.where for a static shape")
        xs = _values(input)
        return xs[0][xs[1].to(torch.bool)], state


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
