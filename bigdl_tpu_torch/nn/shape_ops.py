"""Shape layers.

Counterpart of ``bigdl_tpu/nn/shape_ops.py``, every layer of it (LeNet-5
reshapes its flat input to (1, 28, 28) and its features to 192; VGG views
its features as 512; the text classifier squeezes the pooled time axis,
the TreeLSTM selects the root node). ``batch_mode=None`` detects a batch
axis as JAX does: the input is batched when its non-batch axes hold
exactly ``prod(size)`` elements. Dimensions and indices are 1-based,
negative ones count from the end, as in JAX; ``Index``'s indices are
0-based, and an index out of range gives JAX's ``jnp.take`` result (the
fill value: NaN, or the integer type's minimum) instead of an error.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import AbstractModule, TensorModule
from bigdl_tpu_torch.utils.table import T, Table


def _axis(dim: int, ndim: int) -> int:
    return dim - 1 if dim > 0 else ndim + dim


class Reshape(TensorModule):
    """Reshape the non-batch axes to ``size``."""

    def __init__(self, size: Sequence[int], batch_mode: Optional[bool] = None):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def run(self, input, state=None):
        batched = self.batch_mode
        if batched is None:
            batched = (input.dim() >= 2 and math.prod(input.shape[1:])
                       == math.prod(self.size))
        if batched:
            return input.reshape((input.shape[0],) + self.size), state
        return input.reshape(self.size), state

    def extra_repr(self):
        return "x".join(map(str, self.size))


class View(Reshape):
    """Reshape with the same batch handling (the reference's ``View``)."""


class Squeeze(TensorModule):
    """Drop axis ``dim`` (1-based; it must have size 1), or every axis of
    size 1 with ``dim=None``."""

    def __init__(self, dim: Optional[int] = None,
                 num_input_dims: Optional[int] = None):
        super().__init__()
        self.dim = dim

    def run(self, input, state=None):
        if self.dim is None:
            return input.squeeze(), state
        axis = self.dim - 1
        if input.shape[axis] != 1:
            raise ValueError(f"Squeeze({self.dim}): axis {axis} of "
                             f"{tuple(input.shape)} does not have size 1")
        return input.squeeze(axis), state


class Select(TensorModule):
    """Index ``index`` of axis ``dim``, the axis dropped."""

    def __init__(self, dim: int, index: int):
        super().__init__()
        self.dim, self.index = dim, index

    def run(self, input, state=None):
        axis = self.dim - 1 if self.dim > 0 else input.dim() + self.dim
        idx = (self.index - 1 if self.index > 0
               else input.shape[axis] + self.index)
        return input.select(axis, idx), state

    def extra_repr(self):
        return f"dim={self.dim}, index={self.index}"


class Flatten(TensorModule):
    def run(self, input, state=None):
        return input.reshape(input.shape[0], -1), state


class Unsqueeze(TensorModule):
    """A new axis of size 1 at ``pos`` (1-based)."""

    def __init__(self, pos: int, num_input_dims: Optional[int] = None):
        super().__init__()
        self.pos = pos

    def run(self, input, state=None):
        return input.unsqueeze(self.pos - 1), state


class Transpose(TensorModule):
    """Swap the listed (1-based) axis pairs, in order."""

    def __init__(self, permutations: Sequence[tuple]):
        super().__init__()
        self.permutations = [(a - 1, b - 1) for a, b in permutations]

    def run(self, input, state=None):
        perm = list(range(input.dim()))
        for a, b in self.permutations:
            perm[a], perm[b] = perm[b], perm[a]
        return input.permute(perm), state


class Narrow(TensorModule):
    """``length`` elements from ``offset`` (1-based) along ``dim``; a
    negative length counts back from the end."""

    def __init__(self, dim: int, offset: int, length: int = 1):
        super().__init__()
        self.dim, self.offset, self.length = dim, offset, length

    def run(self, input, state=None):
        axis = _axis(self.dim, input.dim())
        start, length = self.offset - 1, self.length
        if length < 0:
            length = input.shape[axis] - start + length + 1
        return input.narrow(axis, start, length), state


class SplitTable(AbstractModule):
    """A Table of the slices of the input along ``dim`` (1-based; with
    ``num_input_dims`` a leading batch axis shifts it by one)."""

    def __init__(self, dim: int, num_input_dims: int = -1):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def run(self, input, state=None):
        axis = _axis(self.dim, input.dim())
        if self.num_input_dims > 0 and input.dim() == self.num_input_dims + 1:
            axis += 1
        return T(*input.unbind(axis)), state


class Padding(TensorModule):
    """``pad`` entries of ``value`` along ``dim`` (1-based): before the
    input for a negative ``pad``, after it for a positive one."""

    def __init__(self, dim: int, pad: int, num_input_dims: int = 0,
                 value: float = 0.0, n_index: int = 1):
        super().__init__()
        self.dim, self.pad, self.value = dim, pad, value
        self.num_input_dims = num_input_dims

    def run(self, input, state=None):
        axis = self.dim - 1
        if self.num_input_dims > 0 and input.dim() == self.num_input_dims + 1:
            axis += 1
        lo_hi = [-self.pad, 0] if self.pad < 0 else [0, self.pad]
        # F.pad's pairs run from the last axis back to ``axis``
        return F.pad(input, [0, 0] * (input.dim() - 1 - axis) + lo_hi,
                     value=self.value), state


class SpatialZeroPadding(TensorModule):
    """Zeros around the last two axes: (left, right) on the last, (top,
    bottom) on the one before."""

    def __init__(self, pad_left: int, pad_right: int, pad_top: int,
                 pad_bottom: int):
        super().__init__()
        self.pads = (pad_left, pad_right, pad_top, pad_bottom)

    def run(self, input, state=None):
        return F.pad(input, self.pads), state


class Contiguous(TensorModule):
    """The input itself (JAX's arrays are always contiguous)."""

    def run(self, input, state=None):
        return input, state


class Replicate(TensorModule):
    """``n_features`` copies of the input along a new axis ``dim``
    (1-based)."""

    def __init__(self, n_features: int, dim: int = 1, n_input_dims: int = -1):
        super().__init__()
        self.n_features, self.dim, self.n_input_dims = \
            n_features, dim, n_input_dims

    def run(self, input, state=None):
        axis = self.dim - 1
        if self.n_input_dims > 0 and input.dim() == self.n_input_dims + 1:
            axis += 1
        x = input.unsqueeze(axis)
        shape = list(x.shape)
        shape[axis] = self.n_features
        return x.expand(shape), state


class Tile(TensorModule):
    """``copies`` repeats of the input along ``dim`` (1-based)."""

    def __init__(self, dim: int = 1, copies: int = 2):
        super().__init__()
        self.dim, self.copies = dim, copies

    def run(self, input, state=None):
        reps = [1] * input.dim()
        reps[_axis(self.dim, input.dim())] = self.copies
        return input.repeat(reps), state


class Reverse(TensorModule):
    """The input flipped along ``dimension`` (1-based)."""

    def __init__(self, dimension: int = 1, is_inplace: bool = False):
        super().__init__()
        self.dimension = dimension

    def run(self, input, state=None):
        return input.flip(_axis(self.dimension, input.dim())), state


class Index(AbstractModule):
    """``Table(source, indices)``: the source's entries at the 0-based
    ``indices`` along ``dimension`` (1-based), as ``jnp.take``: an index in
    [-n, 0) counts from the end, one outside [-n, n) gives the fill value
    (NaN for floating sources, the type's minimum for integer ones) on
    every device, where an unchecked gather would fault."""

    def __init__(self, dimension: int = 1):
        super().__init__()
        self.dimension = dimension

    def run(self, input, state=None):
        xs = input.values() if isinstance(input, Table) else list(input)
        src, idx = xs[0], xs[1].long()
        axis = _axis(self.dimension, src.dim())
        n = src.shape[axis]
        valid = (idx >= -n) & (idx < n)
        safe = torch.where(valid, torch.remainder(idx, n),
                           torch.zeros_like(idx))
        out = src.index_select(axis, safe.reshape(-1))
        out = out.reshape(src.shape[:axis] + idx.shape + src.shape[axis + 1:])
        fill = (float("nan") if src.is_floating_point()
                else torch.iinfo(src.dtype).min)
        mask = valid.reshape((1,) * axis + idx.shape
                             + (1,) * (src.dim() - axis - 1))
        return torch.where(mask, out, fill), state


class InferReshape(TensorModule):
    """Reshape where a target axis of -1 is inferred and one of 0 keeps
    the input's axis at that position (after the batch axis with
    ``batch_mode``)."""

    def __init__(self, size: Sequence[int], batch_mode: bool = False):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def run(self, input, state=None):
        in_shape = input.shape[1:] if self.batch_mode else input.shape
        target = [in_shape[i] if s == 0 else s
                  for i, s in enumerate(self.size)]
        if self.batch_mode:
            target = [input.shape[0]] + target
        return input.reshape(target), state
