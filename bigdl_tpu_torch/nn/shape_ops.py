"""Shape layers: Reshape, View, Squeeze and Select.

Counterpart of ``bigdl_tpu/nn/shape_ops.py:19`` ``Reshape``, ``:45``
``View``, ``:54`` ``Squeeze`` and ``:88`` ``Select`` (LeNet-5 reshapes its
flat input to (1, 28, 28) and its features to 192; VGG views its features
as 512; the text classifier squeezes the pooled time axis, the TreeLSTM
selects the root node). ``batch_mode=None`` detects a batch axis as JAX
does: the input is batched when its non-batch axes hold exactly
``prod(size)`` elements. Dimensions and indices are 1-based, negative ones
count from the end, as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from bigdl_tpu_torch.nn.abstractnn import TensorModule


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
