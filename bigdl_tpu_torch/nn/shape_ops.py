"""Shape layers of the vision zoo: Reshape and View.

Counterpart of ``bigdl_tpu/nn/shape_ops.py:19`` ``Reshape`` and ``:45``
``View`` (LeNet-5 reshapes its flat input to (1, 28, 28) and its features
to 192; VGG views its features as 512). ``batch_mode=None`` detects a
batch axis as JAX does: the input is batched when its non-batch axes hold
exactly ``prod(size)`` elements.
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
