"""Weight initialisation drawn from an explicit ``torch.Generator``.

Counterpart of ``bigdl_tpu/nn/initialization.py``, which draws from the
global ``RandomGenerator``. Fan-in/fan-out follow Torch/BigDL: a Linear
weight of shape (out, in) has fan_in = in, fan_out = out. Values are drawn
in fp32 on the CPU, so a seed gives the same weights on every device.
``generator=None`` uses PyTorch's default generator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class InitializationMethod:
    def init(self, shape, fan_in: int, fan_out: int,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


class Xavier(InitializationMethod):
    """Glorot uniform: U(-sqrt(6/(fan_in+fan_out)), +)."""

    def init(self, shape, fan_in, fan_out, generator=None):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape).uniform_(-limit, limit, generator=generator)


class RandomUniform(InitializationMethod):
    """The Torch default U(-1/sqrt(fan_in), +1/sqrt(fan_in))."""

    def init(self, shape, fan_in, fan_out, generator=None):
        stdv = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 1.0
        return torch.empty(shape).uniform_(-stdv, stdv, generator=generator)


class RandomNormal(InitializationMethod):
    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean, self.stdv = mean, stdv

    def init(self, shape, fan_in, fan_out, generator=None):
        return torch.empty(shape).normal_(self.mean, self.stdv,
                                          generator=generator)
