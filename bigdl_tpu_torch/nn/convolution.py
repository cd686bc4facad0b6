"""Spatial convolution.

Counterpart of ``bigdl_tpu/nn/convolution.py:31`` ``SpatialConvolution``:
OIHW weights in both image formats (``nn/layout.py``), stride (dW, dH),
padding (padW, padH) with −1 meaning TensorFlow's SAME (``:24-28``), groups
(``n_group``), optional bias, weight regularizers, unbatched 3-D input, and
``propagate_back=False`` (no gradient to the input, ``:73-76``). Default
init U(−1/√fan_in, +) with JAX's fan-in and fan-out (``:57-68``).

JAX's convolution is ``lax.conv_general_dilated``, outside any Pallas
kernel; here it is ``F.conv2d`` (cuDNN on the card), as the plain matrix
products are ``torch.matmul``. Under NHWC the input is handed over as a
channels-last view (``layout.to_nchw``) and the weight in channels-last
memory, so cuDNN runs its NHWC kernels with no layout transposes.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import layout
from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.initialization import InitializationMethod, RandomUniform


def same_pad(in_size: int, k: int, s: int) -> tuple[int, int]:
    """TF/Keras SAME padding of one axis: out = ceil(in / s), the total pad
    split low/high with the odd one high, as XLA's "SAME" does."""
    out = -(-in_size // s)
    total = max((out - 1) * s + k - in_size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias, stride: tuple,
           pads: tuple, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` of a 4-D activation in the current image format, with
    (lo, hi) pads ``pads = ((ph_lo, ph_hi), (pw_lo, pw_hi))``; uneven pads
    are applied first, in the activation's own layout."""
    ph, pw = pads
    padding = (ph[0], pw[0])
    if ph[0] != ph[1] or pw[0] != pw[1]:
        x = layout.pad_spatial(x, ph, pw)
        padding = (0, 0)
    if layout.is_nhwc():
        weight = weight.contiguous(memory_format=torch.channels_last)
    return layout.from_nchw(F.conv2d(layout.to_nchw(x), weight, bias, stride,
                                     padding, 1, groups))


class SpatialConvolution(TensorModule):
    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 w_regularizer=None, b_regularizer=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane} -> {n_output_plane} "
                             f"do not divide into {n_group} groups")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.propagate_back = propagate_back
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        w_init = w_init or RandomUniform()
        b_init = b_init or RandomUniform()
        fan_in = (n_input_plane // n_group) * kernel_h * kernel_w
        fan_out = (n_output_plane // n_group) * kernel_h * kernel_w
        self.weight = torch.nn.Parameter(w_init.init(
            (n_output_plane, n_input_plane // n_group, kernel_h, kernel_w),
            fan_in=fan_in, fan_out=fan_out, generator=generator))
        self.bias = (torch.nn.Parameter(b_init.init(
            (n_output_plane,), fan_in=fan_in, fan_out=fan_out,
            generator=generator)) if with_bias else None)

    def pads(self, h: int, w: int) -> tuple:
        """((lo, hi) on H, (lo, hi) on W) for an (h, w) input."""
        if self.pad_w == -1 or self.pad_h == -1:
            return (same_pad(h, self.kernel_h, self.stride_h),
                    same_pad(w, self.kernel_w, self.stride_w))
        return (self.pad_h, self.pad_h), (self.pad_w, self.pad_w)

    def run(self, input, state=None):
        return self.conv(input, self.weight, self.bias), state

    def conv(self, input, weight, bias):
        """This layer's convolution with the given weight and bias (the
        folded ones of ``kernels/conv_bn.py`` among them)."""
        x = input if self.propagate_back else input.detach()
        squeeze = x.dim() == 3
        if squeeze:
            x = x[None]
        ha, wa = layout.spatial_axes(4)
        out = conv2d(x, weight, bias, (self.stride_h, self.stride_w),
                     self.pads(x.shape[ha], x.shape[wa]), self.n_group)
        return out[0] if squeeze else out

    def fuse_bn(self, bn, relu: bool = False,
                fold_inference: Optional[bool] = None):
        """This convolution and an adjacent ``SpatialBatchNormalization``
        (and ReLU) as one ``kernels.conv_bn.FusedConvBNReLU``, sharing this
        module's parameters."""
        from bigdl_tpu_torch.kernels.conv_bn import FusedConvBNReLU
        if bn.n_output != self.n_output_plane:
            raise ValueError(
                f"fuse_bn: bn features {bn.n_output} != conv output planes "
                f"{self.n_output_plane}")
        return FusedConvBNReLU(self, bn, relu=relu,
                               fold_inference=fold_inference)

    def extra_repr(self):
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_w}x{self.kernel_h}, {self.stride_w},"
                f"{self.stride_h}, {self.pad_w},{self.pad_h}")
