"""Weight initialisation drawn from an explicit ``torch.Generator``.

Counterpart of ``bigdl_tpu/nn/initialization.py``, which draws from the
global ``RandomGenerator``. Fan-in/fan-out follow Torch/BigDL: a Linear
weight of shape (out, in) has fan_in = in, fan_out = out; a convolution
weight (out, in/groups, kh, kw) has fan_in = in/groups·kh·kw and fan_out =
out/groups·kh·kw (``nn/convolution.py``). Values are drawn
in fp32 on the CPU, so a seed gives the same weights on every device.
``generator=None`` uses PyTorch's default generator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.nn.abstractnn import RecordsInit


class InitializationMethod(metaclass=RecordsInit):
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


class MsraFiller(InitializationMethod):
    """He/MSRA normal: N(0, sqrt(2/fan)), fan = fan_out (or the mean of
    fan_in and fan_out): the ResNet convolutions' init."""

    def __init__(self, variance_norm_average: bool = False):
        self.variance_norm_average = variance_norm_average

    def init(self, shape, fan_in, fan_out, generator=None):
        n = (fan_in + fan_out) / 2.0 if self.variance_norm_average \
            else fan_out
        return torch.empty(shape).normal_(0.0, math.sqrt(2.0 / n),
                                          generator=generator)


class RandomUniform(InitializationMethod):
    """U(lower, upper); without bounds the Torch default
    U(-1/sqrt(fan_in), +1/sqrt(fan_in))."""

    def __init__(self, lower: Optional[float] = None,
                 upper: Optional[float] = None):
        self.lower, self.upper = lower, upper

    def init(self, shape, fan_in, fan_out, generator=None):
        if self.lower is not None:
            return torch.empty(shape).uniform_(self.lower, self.upper,
                                               generator=generator)
        stdv = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 1.0
        return torch.empty(shape).uniform_(-stdv, stdv, generator=generator)


class RandomNormal(InitializationMethod):
    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean, self.stdv = mean, stdv

    def init(self, shape, fan_in, fan_out, generator=None):
        return torch.empty(shape).normal_(self.mean, self.stdv,
                                          generator=generator)


class Zeros(InitializationMethod):
    def init(self, shape, fan_in, fan_out, generator=None):
        return torch.zeros(shape)


class Ones(InitializationMethod):
    def init(self, shape, fan_in, fan_out, generator=None):
        return torch.ones(shape)


class ConstInitMethod(InitializationMethod):
    def __init__(self, value: float):
        self.value = value

    def init(self, shape, fan_in, fan_out, generator=None):
        return torch.full(shape, float(self.value))


class BilinearFiller(InitializationMethod):
    """The bilinear up-sampling kernel of a (nOut, nIn, kH, kW) weight (the
    deconvolution's init), the same filter at every (out, in) pair."""

    def init(self, shape, fan_in, fan_out, generator=None):
        if len(shape) != 4:
            raise ValueError("BilinearFiller expects a 4-D conv weight shape")
        kh, kw = shape[-2], shape[-1]
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        yy = torch.arange(kh, dtype=torch.float64)[:, None]
        xx = torch.arange(kw, dtype=torch.float64)[None, :]
        filt = (1 - (yy / f_h - c_h).abs()) * (1 - (xx / f_w - c_w).abs())
        return filt.float().expand(*shape).clone()
