"""Spatial and temporal convolution.

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

``TemporalConvolution`` is ``bigdl_tpu/nn/convolution.py:379``: (N, T, F)
input, VALID padding, stride ``stride_w``, its weight in JAX's (kw, in,
out) layout (so ``convert.load_jax_params`` carries it as it is), run as
``F.conv1d`` on the (N, F, T) view with the weight permuted to (out, in,
kw).

The tail (``:115-545``): ``SpatialConvolutionMap`` (its per-connection
kernels summed into one dense weight) and ``SpatialSeparableConvolution``
follow the image format; ``SpatialDilatedConvolution``,
``SpatialFullConvolution`` (JAX's (in, out/groups, kh, kw) weight and
``adj``, as ``F.conv_transpose2d``) and ``LocallyConnected2D`` take (N, C,
H, W) in both formats, as JAX's do; the locally connected layers keep
JAX's (locations, out, patch) weights and contract their patches in one
batched product.
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


class TemporalConvolution(TensorModule):
    """1-D convolution over time: (N, T, input_frame_size) -> (N, (T - kw)
    // dw + 1, output_frame_size); unbatched (T, F) input too."""

    def __init__(self, input_frame_size: int, output_frame_size: int,
                 kernel_w: int, stride_w: int = 1, with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        fan_in = input_frame_size * kernel_w
        w_init = w_init or RandomUniform()
        b_init = b_init or RandomUniform()
        self.weight = torch.nn.Parameter(w_init.init(
            (kernel_w, input_frame_size, output_frame_size), fan_in=fan_in,
            fan_out=output_frame_size, generator=generator))
        self.bias = (torch.nn.Parameter(b_init.init(
            (output_frame_size,), fan_in=fan_in, fan_out=output_frame_size,
            generator=generator)) if with_bias else None)

    def run(self, input, state=None):
        x = input[None] if input.dim() == 2 else input
        out = F.conv1d(x.transpose(1, 2), self.weight.permute(2, 1, 0),
                       None, self.stride_w).transpose(1, 2)
        if self.bias is not None:
            out = out + self.bias
        return (out[0] if input.dim() == 2 else out), state

    def extra_repr(self):
        return (f"{self.input_frame_size} -> {self.output_frame_size}, "
                f"{self.kernel_w}, {self.stride_w}")


def _param(init, shape, fan_in, fan_out, generator):
    return torch.nn.Parameter(init.init(shape, fan_in=fan_in,
                                        fan_out=fan_out, generator=generator))


def _squeezed(run):
    """``run(x)`` on a batched view of unbatched input (one fewer axis
    than ``ndim``), the batch axis dropped again after."""
    def call(self, input, state=None):
        unbatched = input.dim() == self.ndim - 1
        out = run(self, input[None] if unbatched else input)
        return (out[0] if unbatched else out), state
    return call


class SpatialShareConvolution(SpatialConvolution):
    """``SpatialConvolution`` under the reference's other name (upstream it
    shares an im2col workspace across threads; the computation is the
    same)."""


class SpatialConvolutionMap(TensorModule):
    """A convolution over a connection table: ``conn_table`` lists 1-based
    (input plane, output plane) pairs, one learned (kh, kw) kernel each.
    The kernels are summed into one dense (O, I, kh, kw) weight (zeros
    where unconnected, a repeated pair adds up), as JAX does, and run as
    one convolution in the current image format."""

    ndim = 4

    def __init__(self, conn_table, kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        table = [(int(a), int(b)) for a, b in
                 torch.as_tensor(conn_table).reshape(-1, 2).tolist()]
        self.conn_table = table
        self.n_input_plane = max(a for a, _ in table)
        self.n_output_plane = max(b for _, b in table)
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        # each connection's row of the dense (O·I, kh·kw) weight
        self.register_buffer("dense_rows", torch.tensor(
            [(b - 1) * self.n_input_plane + (a - 1) for a, b in table]),
            persistent=False)
        k = len(table)
        fan_in = kernel_h * kernel_w * max(1, k // self.n_output_plane)
        self.weight = _param(w_init or RandomUniform(), (k, kernel_h,
                             kernel_w), fan_in, fan_in, generator)
        self.bias = _param(b_init or RandomUniform(), (self.n_output_plane,),
                           fan_in, fan_in, generator)

    @staticmethod
    def full(n_in: int, n_out: int):
        return [(i + 1, o + 1) for o in range(n_out) for i in range(n_in)]

    @staticmethod
    def one_to_one(n: int):
        return [(i + 1, i + 1) for i in range(n)]

    @staticmethod
    def random(n_in: int, n_out: int, n_from: int, seed: int = 0):
        import numpy as np
        rng = np.random.default_rng(seed)
        return [(int(i) + 1, o + 1) for o in range(n_out)
                for i in rng.choice(n_in, size=n_from, replace=False)]

    def dense_weight(self) -> torch.Tensor:
        kh, kw = self.kernel_h, self.kernel_w
        dense = self.weight.new_zeros(
            self.n_output_plane * self.n_input_plane, kh * kw).index_add(
            0, self.dense_rows, self.weight.reshape(-1, kh * kw))
        return dense.reshape(self.n_output_plane, self.n_input_plane, kh, kw)

    @_squeezed
    def run(self, x):
        ha, wa = layout.spatial_axes(4)
        if self.pad_w == -1 or self.pad_h == -1:
            pads = (same_pad(x.shape[ha], self.kernel_h, self.stride_h),
                    same_pad(x.shape[wa], self.kernel_w, self.stride_w))
        else:
            pads = (self.pad_h, self.pad_h), (self.pad_w, self.pad_w)
        out = conv2d(x, self.dense_weight(), None,
                     (self.stride_h, self.stride_w), pads)
        return out + self.bias.reshape(layout.bias_shape(self.n_output_plane))


class SpatialSeparableConvolution(TensorModule):
    """A depthwise convolution (``depth_multiplier`` filters a channel,
    ``depth_weight``), then a 1×1 pointwise one (``point_weight``), in the
    current image format."""

    ndim = 4

    def __init__(self, n_input_channel: int, n_output_channel: int,
                 depth_multiplier: int, kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0, with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ic, m, oc = n_input_channel, depth_multiplier, n_output_channel
        self.n_input_channel, self.n_output_channel = ic, oc
        self.depth_multiplier = m
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        w_init, b_init = w_init or RandomUniform(), b_init or RandomUniform()
        fan_d = kernel_h * kernel_w
        self.depth_weight = _param(w_init, (ic * m, 1, kernel_h, kernel_w),
                                   fan_d, fan_d * m, generator)
        self.point_weight = _param(w_init, (oc, ic * m, 1, 1), ic * m, oc,
                                   generator)
        self.bias = _param(b_init, (oc,), ic * m, oc, generator) \
            if with_bias else None

    @_squeezed
    def run(self, x):
        ha, wa = layout.spatial_axes(4)
        if self.pad_w == -1 or self.pad_h == -1:
            pads = (same_pad(x.shape[ha], self.kernel_h, self.stride_h),
                    same_pad(x.shape[wa], self.kernel_w, self.stride_w))
        else:
            pads = (self.pad_h, self.pad_h), (self.pad_w, self.pad_w)
        mid = conv2d(x, self.depth_weight, None,
                     (self.stride_h, self.stride_w), pads,
                     self.n_input_channel)
        out = conv2d(mid, self.point_weight, None, (1, 1), ((0, 0), (0, 0)))
        if self.bias is not None:
            out = out + self.bias.reshape(layout.bias_shape(
                self.n_output_channel))
        return out


class SpatialDilatedConvolution(TensorModule):
    """An atrous convolution of (N, C, H, W) input (in both image formats,
    as JAX's)."""

    ndim = 4

    def __init__(self, n_input_plane, n_output_plane, kw, kh, dw=1, dh=1,
                 pad_w=0, pad_h=0, dilation_w=1, dilation_h=1,
                 w_init=None, b_init=None, with_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.dilation_w, self.dilation_h = dilation_w, dilation_h
        fan_in = n_input_plane * kh * kw
        fan_out = n_output_plane * kh * kw
        self.weight = _param(w_init or RandomUniform(),
                             (n_output_plane, n_input_plane, kh, kw),
                             fan_in, fan_out, generator)
        self.bias = _param(b_init or RandomUniform(), (n_output_plane,),
                           fan_in, fan_out, generator) if with_bias else None

    @_squeezed
    def run(self, x):
        return F.conv2d(x, self.weight, self.bias, (self.dh, self.dw),
                        (self.pad_h, self.pad_w),
                        (self.dilation_h, self.dilation_w))


def full_convolution(x, weight, bias, stride: tuple, pad: tuple, adj: tuple,
                     groups: int):
    """The transposed convolution of JAX's full convolutions over the
    spatial axes after (N, C): the weight (I, O/g, *k) as PyTorch's
    ``conv_transpose`` takes it, output size ``(n - 1)·s - 2p + k + adj``
    on each axis. An ``adj`` of at least the stride (which
    ``output_padding`` refuses) takes the unpadded transposed convolution
    cut or zero-extended to that size."""
    conv = F.conv_transpose2d if x.dim() == 4 else F.conv_transpose3d
    if all(a < s for a, s in zip(adj, stride)):
        return conv(x, weight, bias, stride, pad, adj, groups)
    out = conv(x, weight, None, stride, 0, 0, groups)
    ks = weight.shape[2:]
    for axis, (n, s, p, a, k) in enumerate(zip(x.shape[2:], stride, pad, adj,
                                               ks)):
        size = (n - 1) * s - 2 * p + k + a
        full = out.shape[2 + axis]
        pads = [0, 0] * (out.dim() - 3 - axis) + [0, max(p + size - full, 0)]
        out = F.pad(out, pads).narrow(2 + axis, p, size)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * (out.dim() - 2))
    return out


class SpatialFullConvolution(TensorModule):
    """A transposed convolution (deconvolution) of (N, C, H, W) input with
    JAX's (in, out/groups, kh, kw) weight, padding and ``adj``."""

    ndim = 4

    def __init__(self, n_input_plane, n_output_plane, kw, kh, dw=1, dh=1,
                 pad_w=0, pad_h=0, adj_w=0, adj_h=0, n_group=1,
                 no_bias: bool = False, w_init=None, b_init=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h, self.adj_w, self.adj_h = \
            pad_w, pad_h, adj_w, adj_h
        self.n_group = n_group
        fan_in = n_input_plane * kh * kw
        fan_out = n_output_plane * kh * kw
        self.weight = _param(w_init or RandomUniform(), (
            n_input_plane, n_output_plane // n_group, kh, kw), fan_in,
            fan_out, generator)
        self.bias = None if no_bias else _param(
            b_init or RandomUniform(), (n_output_plane,), fan_in, fan_out,
            generator)

    @_squeezed
    def run(self, x):
        return full_convolution(x, self.weight, self.bias, (self.dh, self.dw),
                                (self.pad_h, self.pad_w),
                                (self.adj_h, self.adj_w), self.n_group)


class LocallyConnected2D(TensorModule):
    """An unshared convolution of (N, C, H, W) input: a filter bank for
    each output location, JAX's (n_loc, O, C·kh·kw) weight over patches in
    (c, kh, kw) order (``F.unfold``), contracted in one batched product."""

    ndim = 4

    def __init__(self, n_input_plane: int, input_width: int,
                 input_height: int, n_output_plane: int, kernel_w: int,
                 kernel_h: int, stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0, with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.input_width, self.input_height = input_width, input_height
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.out_h = (input_height + 2 * pad_h - kernel_h) // stride_h + 1
        self.out_w = (input_width + 2 * pad_w - kernel_w) // stride_w + 1
        k = n_input_plane * kernel_h * kernel_w
        n_loc = self.out_h * self.out_w
        self.weight = _param(w_init or RandomUniform(),
                             (n_loc, n_output_plane, k), k, n_output_plane,
                             generator)
        self.bias = _param(b_init or RandomUniform(), (n_loc, n_output_plane),
                           k, n_output_plane, generator) if with_bias else None

    @_squeezed
    def run(self, x):
        p = F.unfold(x, (self.kernel_h, self.kernel_w),
                     padding=(self.pad_h, self.pad_w),
                     stride=(self.stride_h, self.stride_w))     # (N, K, L)
        out = torch.bmm(p.permute(2, 0, 1), self.weight.transpose(1, 2))
        if self.bias is not None:                               # (L, N, O)
            out = out + self.bias[:, None]
        return out.permute(1, 2, 0).reshape(
            x.shape[0], self.n_output_plane, self.out_h, self.out_w)


class LocallyConnected1D(TensorModule):
    """An unshared temporal convolution of (N, T, C) input: a filter bank
    for each output frame, JAX's (n_out_frames, O, kw·C) weight over
    windows in (kw, C) order."""

    ndim = 3

    def __init__(self, n_input_frame: int, input_frame_size: int,
                 output_frame_size: int, kernel_w: int, stride_w: int = 1,
                 with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_input_frame = n_input_frame
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w, self.stride_w = kernel_w, stride_w
        self.n_output_frame = (n_input_frame - kernel_w) // stride_w + 1
        k = kernel_w * input_frame_size
        self.weight = _param(w_init or RandomUniform(), (
            self.n_output_frame, output_frame_size, k), k, output_frame_size,
            generator)
        self.bias = _param(b_init or RandomUniform(), (
            self.n_output_frame, output_frame_size), k, output_frame_size,
            generator) if with_bias else None

    @_squeezed
    def run(self, x):
        win = x.unfold(1, self.kernel_w, self.stride_w)     # (N, P, C, kw)
        p = win.transpose(2, 3).reshape(x.shape[0], self.n_output_frame, -1)
        out = torch.bmm(p.transpose(0, 1), self.weight.transpose(1, 2))
        if self.bias is not None:                            # (P, N, O)
            out = out + self.bias[:, None]
        return out.transpose(0, 1)
