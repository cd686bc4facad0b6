"""Pooling: SpatialMaxPooling, SpatialAveragePooling and
TemporalMaxPooling.

Counterpart of ``bigdl_tpu/nn/pooling.py:66`` and ``:115``, with JAX's
padding arithmetic (``_out_size``, ``_pad_amounts``, ``_same_pad``,
``:22-48``): the Torch output size in floor or ceil mode (the last window
must start inside the low-padded input), the extra high-side padding that
ceil mode needs, and SAME padding. JAX pads explicitly, so here too, in
the activation's own layout: max pooling pads with −inf, average pooling
with zeros, and then a window reduction with no padding of its own runs
over exactly JAX's windows.
Average pooling sums in fp32 and casts back (JAX's fp32 island) and divides
as JAX does: by kh·kw when the input is unpadded or ``count_include_pad``
holds, else by the count of real elements in each window.

The reductions are PyTorch's ``max_pool2d``/``avg_pool2d`` (outside any
Pallas kernel in JAX, ``lax.reduce_window``), on a channels-last view under
NHWC (``layout.to_nchw``).

``TemporalMaxPooling`` is ``bigdl_tpu/nn/pooling.py:199`` and
``TemporalAveragePooling`` ``:229``: (N, T, F) -> (N, (T - kw) // dw + 1,
F), VALID windows; ``kernel_w=-1`` pools the whole sequence.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import layout
from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.convolution import same_pad


def out_size(in_size: int, k: int, s: int, p: int, ceil_mode: bool) -> int:
    rnd = math.ceil if ceil_mode else math.floor
    out = int(rnd((in_size + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= in_size + p:
        out -= 1       # the last window must start inside the input
    return out


def pad_amounts(in_size: int, k: int, s: int, p: int, ceil_mode: bool):
    """(lo, hi, out) of one axis."""
    out = out_size(in_size, k, s, p, ceil_mode)
    return p, max((out - 1) * s + k - in_size - p, 0), out


class _Pooling(TensorModule):
    def __init__(self, kw: int, kh: int, dw: Optional[int], dh: Optional[int],
                 pad_w: int, pad_h: int, ceil_mode: bool, pad_mode: str):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = ceil_mode
        if pad_mode not in ("torch", "same"):
            raise ValueError(f"pad_mode must be torch|same, got {pad_mode!r}")
        self.pad_mode = pad_mode

    def ceil(self):
        self.ceil_mode = True
        return self

    def floor(self):
        self.ceil_mode = False
        return self

    def _pads(self, h, w, kh, kw, dh, dw) -> tuple:
        """((lo, hi) on H, (lo, hi) on W)."""
        if self.pad_mode == "same":
            return same_pad(h, kh, dh), same_pad(w, kw, dw)
        return (pad_amounts(h, kh, dh, self.pad_h, self.ceil_mode)[:2],
                pad_amounts(w, kw, dw, self.pad_w, self.ceil_mode)[:2])

    def run(self, input, state=None):
        x = input
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        ha, wa = layout.spatial_axes(4)
        out = self._pool(x, x.shape[ha], x.shape[wa])
        return (out[0] if squeeze else out), state

    def extra_repr(self):
        return (f"{self.kw}x{self.kh}, {self.dw},{self.dh}, {self.pad_w},"
                f"{self.pad_h}{', ceil' if self.ceil_mode else ''}")


class SpatialMaxPooling(_Pooling):
    def __init__(self, kw: int, kh: int, dw: Optional[int] = None,
                 dh: Optional[int] = None, pad_w: int = 0, pad_h: int = 0,
                 ceil_mode: bool = False, pad_mode: str = "torch"):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h, ceil_mode, pad_mode)

    def _pool(self, x, h, w):
        ph, pw = self._pads(h, w, self.kh, self.kw, self.dh, self.dw)
        x = layout.pad_spatial(x, ph, pw, value=-math.inf)
        return layout.from_nchw(F.max_pool2d(
            layout.to_nchw(x), (self.kh, self.kw), (self.dh, self.dw)))


class SpatialAveragePooling(_Pooling):
    def __init__(self, kw: int, kh: int, dw: Optional[int] = None,
                 dh: Optional[int] = None, pad_w: int = 0, pad_h: int = 0,
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 divide: bool = True, global_pooling: bool = False,
                 pad_mode: str = "torch"):
        super().__init__(kw, kh, dw, dh, pad_w, pad_h, ceil_mode, pad_mode)
        if pad_mode == "same" and global_pooling:
            raise ValueError("pad_mode='same' is meaningless with "
                             "global_pooling (the window already covers the "
                             "whole input)")
        self.count_include_pad = count_include_pad
        self.divide = divide
        self.global_pooling = global_pooling

    def _pool(self, x, h, w):
        kh, kw = (h, w) if self.global_pooling else (self.kh, self.kw)
        dh, dw = (1, 1) if self.global_pooling else (self.dh, self.dw)
        ph, pw = self._pads(h, w, kh, kw, dh, dw)
        include_pad = self.pad_mode != "same" and self.count_include_pad \
            and (self.pad_h > 0 or self.pad_w > 0)
        no_pad = not any(ph + pw)

        def window_sums(t):
            t = layout.pad_spatial(t, ph, pw)
            return layout.from_nchw(F.avg_pool2d(
                layout.to_nchw(t), (kh, kw), (dh, dw), divisor_override=1))

        sums = window_sums(x.float())
        if not self.divide:
            out = sums
        elif include_pad or no_pad:
            out = sums / float(kh * kw)
        else:
            ones = torch.ones((1, h, w, 1) if layout.is_nhwc()
                              else (1, 1, h, w), device=x.device)
            out = sums / window_sums(ones).clamp(min=1.0)
        return out.to(x.dtype)


class TemporalMaxPooling(TensorModule):
    """1-D max pooling over time; ``stride_w`` defaults to ``kernel_w``."""

    def __init__(self, kernel_w: int, stride_w: Optional[int] = None):
        super().__init__()
        self.kernel_w = kernel_w
        self.stride_w = stride_w if stride_w is not None else kernel_w

    def run(self, input, state=None):
        x = input[None] if input.dim() == 2 else input
        t = x.shape[1]
        kw, dw = (t, t) if self.kernel_w == -1 else (self.kernel_w,
                                                     self.stride_w)
        out = F.max_pool1d(x.transpose(1, 2), kw, dw).transpose(1, 2)
        return (out[0] if input.dim() == 2 else out), state

    def extra_repr(self):
        return f"{self.kernel_w}, {self.stride_w}"


class TemporalAveragePooling(TensorModule):
    """1-D average pooling over time; ``stride_w`` defaults to
    ``kernel_w``."""

    def __init__(self, kernel_w: int, stride_w: Optional[int] = None):
        super().__init__()
        self.kernel_w = kernel_w
        self.stride_w = stride_w if stride_w is not None else kernel_w

    def run(self, input, state=None):
        x = input[None] if input.dim() == 2 else input
        t = x.shape[1]
        kw, dw = (t, t) if self.kernel_w == -1 else (self.kernel_w,
                                                     self.stride_w)
        out = F.avg_pool1d(x.transpose(1, 2), kw, dw).transpose(1, 2)
        return (out[0] if input.dim() == 2 else out), state

    def extra_repr(self):
        return f"{self.kernel_w}, {self.stride_w}"
