"""Volumetric (3-D) layers of (N, C, D, H, W) input.

Counterpart of ``bigdl_tpu/nn/volumetric.py``: ``VolumetricConvolution``
(OIDHW weight, symmetric padding; ``F.conv3d``, cuDNN on the card, as
JAX's is ``lax.conv_general_dilated``), ``VolumetricFullConvolution`` (the
(in, out/groups, kt, kh, kw) weight, padding and ``adj`` of JAX's
lhs-dilated convolution: ``nn/convolution.full_convolution``), and the
max and average pooling. JAX pools with ``lax.reduce_window`` over
explicitly padded windows and no ceil mode: the output has
``(n + 2p - k) // s + 1`` windows on each axis, max pooling pads with
-inf and average pooling divides every window's sum by its full volume
(the padding counted). Here the input is padded the same way first and
PyTorch's pooling then runs with no padding of its own. Unbatched
(C, D, H, W) input is taken too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.convolution import _param, _squeezed, full_convolution
from bigdl_tpu_torch.nn.initialization import InitializationMethod, RandomUniform


class VolumetricConvolution(TensorModule):
    """(N, C, T, H, W) -> (N, O, T', H', W'); weight (O, C, kt, kh, kw)."""

    ndim = 5

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 k_t: int, k_w: int, k_h: int,
                 d_t: int = 1, d_w: int = 1, d_h: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.k_t, self.k_w, self.k_h = k_t, k_w, k_h
        self.d_t, self.d_w, self.d_h = d_t, d_w, d_h
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h
        fan_in = n_input_plane * k_t * k_h * k_w
        self.weight = _param(w_init or RandomUniform(), (
            n_output_plane, n_input_plane, k_t, k_h, k_w), fan_in,
            n_output_plane, generator)
        self.bias = _param(b_init or RandomUniform(), (n_output_plane,),
                           fan_in, n_output_plane, generator) \
            if with_bias else None

    @_squeezed
    def run(self, x):
        return F.conv3d(x, self.weight, self.bias,
                        (self.d_t, self.d_h, self.d_w),
                        (self.pad_t, self.pad_h, self.pad_w))

    def extra_repr(self):
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.k_t}x{self.k_h}x{self.k_w}")


class _VolumetricPool(TensorModule):
    ndim = 5

    def __init__(self, k_t: int, k_w: int, k_h: int,
                 d_t: Optional[int] = None, d_w: Optional[int] = None,
                 d_h: Optional[int] = None,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0):
        super().__init__()
        self.k_t, self.k_w, self.k_h = k_t, k_w, k_h
        self.d_t = d_t if d_t is not None else k_t
        self.d_w = d_w if d_w is not None else k_w
        self.d_h = d_h if d_h is not None else k_h
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h

    def _padded(self, x, value: float):
        p = (self.pad_w, self.pad_w, self.pad_h, self.pad_h, self.pad_t,
             self.pad_t)
        return F.pad(x, p, value=value) if any(p) else x

    def _window(self):
        return (self.k_t, self.k_h, self.k_w), (self.d_t, self.d_h, self.d_w)


class VolumetricMaxPooling(_VolumetricPool):
    @_squeezed
    def run(self, x):
        return F.max_pool3d(self._padded(x, float("-inf")), *self._window())


class VolumetricAveragePooling(_VolumetricPool):
    """The padding counted in every window's volume (Torch's default for
    ``AvgPool3d``)."""

    @_squeezed
    def run(self, x):
        return F.avg_pool3d(self._padded(x, 0.0), *self._window())


class VolumetricFullConvolution(TensorModule):
    """The 3-D transposed convolution."""

    ndim = 5

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kt: int, kw: int, kh: int, dt: int = 1, dw: int = 1,
                 dh: int = 1, pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 adj_t: int = 0, adj_w: int = 0, adj_h: int = 0,
                 n_group: int = 1, no_bias: bool = False,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kt, self.kw, self.kh = kt, kw, kh
        self.dt, self.dw, self.dh = dt, dw, dh
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h
        self.adj_t, self.adj_w, self.adj_h = adj_t, adj_w, adj_h
        self.n_group = n_group
        fan_in = n_input_plane * kt * kh * kw
        fan_out = n_output_plane * kt * kh * kw
        self.weight = _param(w_init or RandomUniform(), (
            n_input_plane, n_output_plane // n_group, kt, kh, kw), fan_in,
            fan_out, generator)
        self.bias = None if no_bias else _param(
            b_init or RandomUniform(), (n_output_plane,), fan_in, fan_out,
            generator)

    @_squeezed
    def run(self, x):
        return full_convolution(
            x, self.weight, self.bias, (self.dt, self.dh, self.dw),
            (self.pad_t, self.pad_h, self.pad_w),
            (self.adj_t, self.adj_h, self.adj_w), self.n_group)
