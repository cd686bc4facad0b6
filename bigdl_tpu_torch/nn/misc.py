"""The rest of the layer zoo: reductions, shrink and threshold layers,
products and distances of tables, bilinear forms, up-sampling, resizing,
cropping, gradient tricks, activity penalties and on-device image
normalisation.

Counterpart of ``bigdl_tpu/nn/misc.py``, every layer of it. Dimensions
follow the reference's 1-based convention. ``UpSampling2D`` and
``ImageNormalize`` follow ``nn/layout.py``; the other spatial layers take
(N, C, H, W) in both formats, as JAX's do. ``SpatialUpSamplingBilinear``
and ``ResizeBilinear`` sample JAX's grids (the corners aligned, or
half-pixel centres clamped to the input; an axis of output size 1 with
the corners aligned takes the half-pixel grid, as in JAX) as two
interpolation-matrix products, and the nearest up-sampling layers repeat
by broadcasting: neither backward scatters with atomic adds, so a
captured program's replay equals its eager run bit for bit (PyTorch's
``F.interpolate`` and ``repeat_interleave`` backwards do not). ``RReLU``
and ``GaussianSampler`` draw from an explicit ``generator`` in training
mode, as ``Dropout`` does. The penalties of ``ActivityRegularization`` and
``NegativeEntropyPenalty`` are JAX's ``"penalty"`` state leaves: the
trainer adds them to the loss (:func:`collecting_penalties`).

``ImageNormalize`` is ``(x * scale - mean) / std`` per channel. The feed
stays uint8 and the layer casts it on the device: to the engine's compute
dtype when the engine is initialised (bf16 under the mixed policy, so the
whole model runs in bf16, as JAX's does), else fp32. ``scale``, mean and
std are rounded to the input's dtype before the arithmetic, as
``jnp.asarray(v, x.dtype)`` rounds them.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import layout
from bigdl_tpu_torch.nn.abstractnn import AbstractModule, TensorModule
from bigdl_tpu_torch.nn.initialization import (
    InitializationMethod, RandomUniform, Xavier, Zeros,
)
from bigdl_tpu_torch.nn.normalization import _draw_mask
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.table import Table


class ImageNormalize(TensorModule):
    """ImageNet mean and std (0–1 range) with ``scale=1/255`` for uint8
    pixels by default; ``scale=1.0`` for pre-scaled float input."""

    def __init__(self, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 scale: float = 1.0 / 255.0):
        super().__init__()
        mean = mean if isinstance(mean, (tuple, list)) else (mean,)
        std = std if isinstance(std, (tuple, list)) else (std,)
        self.mean = tuple(float(m) for m in mean)
        self.std = tuple(float(s) for s in std)
        if len(self.mean) != len(self.std):
            raise ValueError(
                f"ImageNormalize: mean has {len(self.mean)} channels but std "
                f"has {len(self.std)}: they must pair up")
        self.scale = float(scale)
        # (scale, mean..., std...) on the module's device, so that a
        # captured program copies nothing from the host
        self.register_buffer("consts", torch.tensor(
            (self.scale,) + self.mean + self.std, dtype=torch.float64),
            persistent=False)

    def run(self, input, state=None):
        x = input
        if not x.is_floating_point():
            x = x.to(Engine.compute_dtype() if Engine.is_initialized()
                     else torch.float32)
        n = len(self.mean)
        shape = layout.bias_shape(n, x.dim()) if x.dim() >= 3 else (n,)
        c = self.consts.to(x.dtype)
        mean = c[1:1 + n].reshape(shape)
        std = c[1 + n:].reshape(shape)
        return (x * c[0] - mean) / std, state

    def extra_repr(self):
        return f"mean={self.mean}, std={self.std}, scale={self.scale:g}"


def _axis(dim: int, ndim: int) -> int:
    return dim - 1 if dim > 0 else ndim + dim


def _values(input) -> list:
    return input.values() if isinstance(input, Table) else list(input)


class _Reduce(TensorModule):
    def __init__(self, dim: int = 1, n_input_dims: int = -1):
        super().__init__()
        self.dim = dim
        self.n_input_dims = n_input_dims

    def _resolve_axis(self, x) -> int:
        axis = _axis(self.dim, x.dim())
        # a leading batch axis shifts a positive dim only
        if self.dim > 0 and self.n_input_dims > 0 \
                and x.dim() == self.n_input_dims + 1:
            axis += 1
        return axis


class Max(_Reduce):
    """Max over ``dim``, the values only (ties share the gradient, as
    ``jnp.max``'s do)."""

    def run(self, input, state=None):
        return input.amax(self._resolve_axis(input)), state


class Min(_Reduce):
    def run(self, input, state=None):
        return input.amin(self._resolve_axis(input)), state


class Mean(_Reduce):
    def run(self, input, state=None):
        return input.mean(self._resolve_axis(input)), state


class Sum(_Reduce):
    def __init__(self, dim: int = 1, n_input_dims: int = -1,
                 size_average: bool = False):
        super().__init__(dim, n_input_dims)
        self.size_average = size_average

    def run(self, input, state=None):
        axis = self._resolve_axis(input)
        out = input.sum(axis)
        if self.size_average:
            out = out / input.shape[axis]
        return out, state


class Threshold(TensorModule):
    """``x`` where it exceeds ``threshold``, else ``value``."""

    def __init__(self, threshold: float = 1e-6, value: float = 0.0,
                 inplace: bool = False):
        super().__init__()
        self.th, self.value = threshold, value

    def run(self, input, state=None):
        return torch.where(input > self.th, input, self.value), state


class HardShrink(TensorModule):
    def __init__(self, lam: float = 0.5):
        super().__init__()
        self.lam = lam

    def run(self, input, state=None):
        return torch.where(input.abs() > self.lam, input, 0.0), state


class SoftShrink(TensorModule):
    def __init__(self, lam: float = 0.5):
        super().__init__()
        self.lam = lam

    def run(self, input, state=None):
        return (torch.where(input > self.lam, input - self.lam, 0.0)
                + torch.where(input < -self.lam, input + self.lam, 0.0)), \
            state


class RReLU(TensorModule):
    """Randomised leaky ReLU: in training mode each negative element's
    slope is drawn from U(lower, upper) (from ``generator``, as
    ``Dropout`` draws), in eval mode it is the midpoint."""

    draws_random = True

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 inplace: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lower, self.upper = lower, upper
        self.generator = generator

    def run(self, input, state=None):
        if self.training:
            a = _draw_mask(lambda: torch.rand(
                input.shape, generator=self.generator, device=input.device,
                dtype=input.dtype) * (self.upper - self.lower) + self.lower)
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(input >= 0, input, a * input), state


class Negative(TensorModule):
    def __init__(self, inplace: bool = False):
        super().__init__()

    def run(self, input, state=None):
        return -input, state


class DotProduct(AbstractModule):
    """Row-wise dot product of a Table pair."""

    def run(self, input, state=None):
        xs = _values(input)
        return (xs[0] * xs[1]).sum(-1), state


class MM(AbstractModule):
    """Matrix product of a Table pair, each optionally transposed; batched
    (N, a, b) operands too."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False):
        super().__init__()
        self.trans_a, self.trans_b = trans_a, trans_b

    def run(self, input, state=None):
        a, b = _values(input)[:2]
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b), state


class MV(AbstractModule):
    """Matrix-vector product of a Table (matrix, vector) pair; batched
    too."""

    def __init__(self, trans: bool = False):
        super().__init__()
        self.trans = trans

    def run(self, input, state=None):
        m, v = _values(input)[:2]
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.matmul(m, v.unsqueeze(-1)).squeeze(-1), state


class Euclidean(TensorModule):
    """Distances to learned centres: ``out[b, o] = ||x[b] - w[o]||``."""

    def __init__(self, input_size: int, output_size: int,
                 w_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self.weight = torch.nn.Parameter((w_init or RandomUniform()).init(
            (output_size, input_size), fan_in=input_size,
            fan_out=output_size, generator=generator))

    def run(self, input, state=None):
        x = input if input.dim() == 2 else input[None]
        d = x[:, None, :] - self.weight[None, :, :]
        out = torch.sqrt(d.square().sum(-1) + 1e-12)
        return (out[0] if input.dim() == 1 else out), state


class Bilinear(AbstractModule):
    """Bilinear form of a Table pair: ``out[b, o] = x1[b] W[o] x2[b] +
    bias[o]``."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size1, self.input_size2 = input_size1, input_size2
        self.output_size = output_size
        self.bias_res = bias_res
        fan_in = input_size1 * input_size2
        self.weight = torch.nn.Parameter((w_init or RandomUniform()).init(
            (output_size, input_size1, input_size2), fan_in=fan_in,
            fan_out=output_size, generator=generator))
        self.bias = torch.nn.Parameter((b_init or Zeros()).init(
            (output_size,), fan_in=fan_in, fan_out=output_size,
            generator=generator)) if bias_res else None

    def run(self, input, state=None):
        x1, x2 = _values(input)[:2]
        out = torch.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        if self.bias is not None:
            out = out + self.bias
        return out, state


class Maxout(TensorModule):
    """One Linear to ``output_size * pool_size`` units, then the max over
    each unit's ``pool_size`` pieces."""

    def __init__(self, input_size: int, output_size: int, pool_size: int,
                 with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.output_size, self.pool_size = \
            input_size, output_size, pool_size
        n_out = output_size * pool_size
        self.weight = torch.nn.Parameter((w_init or RandomUniform()).init(
            (n_out, input_size), fan_in=input_size, fan_out=n_out,
            generator=generator))
        self.bias = torch.nn.Parameter((b_init or RandomUniform()).init(
            (n_out,), fan_in=input_size, fan_out=n_out,
            generator=generator)) if with_bias else None

    def run(self, input, state=None):
        x = input if input.dim() == 2 else input[None]
        z = F.linear(x, self.weight, self.bias)
        out = z.reshape(z.shape[0], self.output_size, self.pool_size).amax(-1)
        return (out[0] if input.dim() == 1 else out), state


class SpatialUpSamplingNearest(TensorModule):
    """Each pixel of the last two axes repeated ``scale`` times on each."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = int(scale)

    def run(self, input, state=None):
        return _repeat_each(_repeat_each(input, self.scale, -2),
                            self.scale, -1), state


def _interpolation(out_size: int, in_size: int, align_corners: bool,
                   like: torch.Tensor) -> torch.Tensor:
    """The (out_size, in_size) matrix of JAX's linear interpolation along
    one axis: row i holds ``1 - w`` at ``floor(s_i)`` and ``w`` at the next
    index (clamped), ``s_i`` on the corner-aligned grid (an output of size
    1 takes the half-pixel one, as in JAX) or on half-pixel centres
    clamped to the input. Made on ``like``'s device from ``arange``."""
    i = torch.arange(out_size, device=like.device, dtype=torch.float32)
    if align_corners and out_size > 1:
        src = i * ((in_size - 1.0) / (out_size - 1))
    else:
        src = ((i + 0.5) * (in_size / out_size) - 0.5).clamp(0.0,
                                                              in_size - 1.0)
    lo = src.floor().clamp(0, in_size - 1)
    frac = (src - lo)[:, None]
    hi = (lo + 1).clamp(max=in_size - 1)
    cols = torch.arange(in_size, device=like.device,
                        dtype=torch.float32)[None, :]
    return ((1.0 - frac) * (cols == lo[:, None])
            + frac * (cols == hi[:, None])).to(like.dtype)


def _resize(x: torch.Tensor, oh: int, ow: int,
            align_corners: bool) -> torch.Tensor:
    """Bilinear resize of the last two axes of an (N, C, H, W) tensor to
    (oh, ow) on JAX's grid, as two interpolation matrices: ``Ry · x ·
    Rxᵀ``. Its backward is two products too, with no scattered atomic
    adds, so a replayed program gives the eager run's bits."""
    ry = _interpolation(oh, x.shape[-2], align_corners, x)
    rx = _interpolation(ow, x.shape[-1], align_corners, x)
    return torch.matmul(torch.matmul(ry, x), rx.transpose(0, 1))


def _repeat_each(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """Each entry along ``axis`` repeated ``n`` times (``jnp.repeat``), as
    a broadcast: its backward is a sum, not ``repeat_interleave``'s
    scattered atomic adds."""
    axis = axis % x.dim()
    shape = list(x.shape)
    x = x.unsqueeze(axis + 1).expand(*shape[:axis + 1], n,
                                     *shape[axis + 1:])
    shape[axis] *= n
    return x.reshape(shape)


class SpatialUpSamplingBilinear(TensorModule):
    """Bilinear up-sampling of (N, C, H, W) or (C, H, W) input by
    ``scale``, the corners aligned (torch's ``UpsamplingBilinear2d``)."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = int(scale)

    def run(self, input, state=None):
        x = input[None] if input.dim() == 3 else input
        out = _resize(x, x.shape[2] * self.scale, x.shape[3] * self.scale,
                      True)
        return (out[0] if input.dim() == 3 else out), state


class ResizeBilinear(TensorModule):
    """Bilinear resize of (N, C, H, W) or (C, H, W) input to
    (``output_height``, ``output_width``)."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False):
        super().__init__()
        self.output_height = int(output_height)
        self.output_width = int(output_width)
        self.align_corners = align_corners

    def run(self, input, state=None):
        x = input[None] if input.dim() == 3 else input
        out = _resize(x, self.output_height, self.output_width,
                      self.align_corners)
        return (out[0] if input.dim() == 3 else out), state


class _ReverseGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


class GradientReversal(TensorModule):
    """The identity forward; the backward multiplies the gradient by
    ``-the_lambda``."""

    def __init__(self, the_lambda: float = 1.0):
        super().__init__()
        self.the_lambda = float(the_lambda)

    def set_lambda(self, lam: float) -> "GradientReversal":
        self.the_lambda = float(lam)
        return self

    def run(self, input, state=None):
        return _ReverseGrad.apply(input, self.the_lambda), state


class _L1Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, strength):
        ctx.save_for_backward(x)
        ctx.strength = strength
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g + ctx.strength * torch.sign(x).to(g.dtype), None


class L1Penalty(TensorModule):
    """The identity forward; in training mode the backward adds
    ``l1weight * sign(x)`` (over the input's size with
    ``size_average``)."""

    def __init__(self, l1weight: float, size_average: bool = False,
                 provide_output: bool = True):
        super().__init__()
        self.l1weight = float(l1weight)
        self.size_average = size_average

    def run(self, input, state=None):
        if not self.training:
            return input, state
        strength = self.l1weight
        if self.size_average:
            strength = strength / input.numel()
        return _L1Grad.apply(input, strength), state


class Scale(AbstractModule):
    """``x * weight + bias``, both of shape ``size`` (ones and zeros at
    init), broadcast from the trailing axes."""

    def __init__(self, size):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.weight = torch.nn.Parameter(torch.ones(self.size))
        self.bias = torch.nn.Parameter(torch.zeros(self.size))

    def run(self, input, state=None):
        shape = (1,) * (input.dim() - self.weight.dim()) + self.size
        return input * self.weight.reshape(shape) \
            + self.bias.reshape(shape), state


class PairwiseDistance(AbstractModule):
    """The ``norm``-norm of the difference of a Table pair, a row each
    (the epsilon added once to the sum, as JAX's is)."""

    def __init__(self, norm: int = 2):
        super().__init__()
        self.norm = norm

    def run(self, input, state=None):
        x1, x2 = _values(input)[:2]
        d = x1 - x2
        if d.dim() == 1:
            d = d[None]
        p = float(self.norm)
        return (d.abs().pow(p).sum(-1) + 1e-12).pow(1.0 / p), state


class GaussianSampler(AbstractModule):
    """``Table(mu, log_var)``: in training mode ``mu + exp(log_var / 2) *
    eps`` with ``eps ~ N(0, 1)`` from ``generator``; in eval mode
    ``mu``."""

    draws_random = True

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.generator = generator

    def run(self, input, state=None):
        mu, log_var = _values(input)[:2]
        if not self.training:
            return mu, state
        eps = _draw_mask(lambda: torch.randn(
            mu.shape, generator=self.generator, device=mu.device,
            dtype=mu.dtype))
        return mu + torch.exp(0.5 * log_var) * eps, state


class Highway(AbstractModule):
    """``t * g(W x + b) + (1 - t) * x`` with the gate ``t = sigmoid(W_t x
    + b_t)``; ``g`` a parameter-free activation module (tanh when None).
    ``weight`` and ``gate_weight`` Xavier, ``bias`` zeros and
    ``gate_bias`` -1 at init."""

    def __init__(self, size: int, with_bias: bool = True, activation=None,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if activation is not None and list(activation.parameters()):
            raise ValueError(
                "Highway only supports parameter-free activations (got "
                f"{type(activation).__name__} with trainable params); apply "
                "parametric activations as a separate layer after Highway")
        self.size = size
        self.with_bias = with_bias
        self.activation = activation       # parameter-free: no new paths
        w_init, b_init = w_init or Xavier(), b_init or Zeros()
        s = size
        self.weight = torch.nn.Parameter(w_init.init(
            (s, s), fan_in=s, fan_out=s, generator=generator))
        self.gate_weight = torch.nn.Parameter(w_init.init(
            (s, s), fan_in=s, fan_out=s, generator=generator))
        if with_bias:
            self.bias = torch.nn.Parameter(b_init.init(
                (s,), fan_in=s, fan_out=s, generator=generator))
            self.gate_bias = torch.nn.Parameter(torch.full((s,), -1.0))
        else:
            self.bias = self.gate_bias = None

    def run(self, input, state=None):
        h = F.linear(input, self.weight, self.bias)
        t = torch.sigmoid(F.linear(input, self.gate_weight, self.gate_bias))
        h = torch.tanh(h) if self.activation is None \
            else self.activation.run(h, None)[0]
        return t * h + (1.0 - t) * input, state


class UpSampling1D(TensorModule):
    """Each step of (N, T, C) input repeated ``length`` times."""

    def __init__(self, length: int = 2):
        super().__init__()
        self.length = int(length)

    def run(self, input, state=None):
        return _repeat_each(input, self.length, input.dim() - 2), state


class UpSampling2D(TensorModule):
    """Nearest-neighbour up-sampling by (size_h, size_w) of the spatial
    axes of ``nn/layout.py``."""

    def __init__(self, size=(2, 2)):
        super().__init__()
        self.size = (int(size[0]), int(size[1]))

    def run(self, input, state=None):
        ha, wa = layout.spatial_axes(input.dim())
        return _repeat_each(_repeat_each(input, self.size[0], ha),
                            self.size[1], wa), state


class UpSampling3D(TensorModule):
    """Nearest-neighbour up-sampling of the last three axes by (d, h, w)."""

    def __init__(self, size=(2, 2, 2)):
        super().__init__()
        self.size = tuple(int(s) for s in size)

    def run(self, input, state=None):
        out = input
        for axis, n in zip((-3, -2, -1), self.size):
            out = _repeat_each(out, n, axis)
        return out, state


class Cropping2D(TensorModule):
    """(top, bottom) rows and (left, right) columns cropped off the last
    two axes."""

    def __init__(self, height_crop=(0, 0), width_crop=(0, 0)):
        super().__init__()
        self.height_crop = (int(height_crop[0]), int(height_crop[1]))
        self.width_crop = (int(width_crop[0]), int(width_crop[1]))

    def run(self, input, state=None):
        (t, b), (l, r) = self.height_crop, self.width_crop
        h, w = input.shape[-2], input.shape[-1]
        if t + b >= h or l + r >= w:
            raise ValueError(
                f"Cropping2D extents {self.height_crop}/{self.width_crop} "
                f"consume the whole {h}x{w} input")
        return input[..., t:h - b, l:w - r], state


class Cropping3D(TensorModule):
    """(lo, hi) pairs cropped off each of the last three axes."""

    def __init__(self, dim1_crop=(0, 0), dim2_crop=(0, 0), dim3_crop=(0, 0)):
        super().__init__()
        self.dim1_crop = tuple(int(v) for v in dim1_crop)
        self.dim2_crop = tuple(int(v) for v in dim2_crop)
        self.dim3_crop = tuple(int(v) for v in dim3_crop)

    def run(self, input, state=None):
        (a0, a1), (b0, b1), (c0, c1) = \
            self.dim1_crop, self.dim2_crop, self.dim3_crop
        d, h, w = input.shape[-3:]
        if a0 + a1 >= d or b0 + b1 >= h or c0 + c1 >= w:
            raise ValueError(
                f"Cropping3D extents {self.dim1_crop}/{self.dim2_crop}/"
                f"{self.dim3_crop} consume the whole {d}x{h}x{w} input")
        return input[..., a0:d - a1, b0:h - b1, c0:w - c1], state


_PENALTIES = threading.local()


@contextlib.contextmanager
def collecting_penalties():
    """Collect, into the yielded list, the penalty tensors that layers
    declare in the forward run inside the block (the trainer adds them to
    the loss). Outside such a block a penalty is only returned in the
    explicit state: no module keeps a tensor, or its autograd graph,
    after its forward."""
    prev = getattr(_PENALTIES, "sink", None)
    _PENALTIES.sink = sink = []
    try:
        yield sink
    finally:
        _PENALTIES.sink = prev


_AUX = threading.local()


@contextlib.contextmanager
def collecting_aux_losses():
    """Collect, into the yielded list, the auxiliary losses that layers
    declare in the forward run inside the block (JAX's ``"aux_loss"``
    state leaves, MoE's load balance): the trainer adds them scaled by
    ``set_aux_loss_weight``."""
    prev = getattr(_AUX, "sink", None)
    _AUX.sink = sink = []
    try:
        yield sink
    finally:
        _AUX.sink = prev


def declare_aux_loss(t: torch.Tensor) -> None:
    sink = getattr(_AUX, "sink", None)
    if sink is not None:
        sink.append(t)


def declare_penalty(t: torch.Tensor) -> None:
    """A full-strength loss term of a layer (JAX's ``"penalty"`` leaf)."""
    sink = getattr(_PENALTIES, "sink", None)
    if sink is not None:
        sink.append(t)


class _Penalty(TensorModule):
    """The identity forward with a loss term of its own, an fp32 scalar:
    the ``"penalty"`` leaf of the returned state when a state is passed
    (JAX's state leaf), and collected by :func:`collecting_penalties`,
    through which ``LocalOptimizer`` adds it to the loss at full
    strength."""

    def _term(self, x32: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def run(self, input, state=None):
        pen = self._term(input.float())
        sink = getattr(_PENALTIES, "sink", None)
        if sink is not None:
            # a sum over this rank's samples, under a data-parallel step
            from bigdl_tpu_torch.parallel.collectives import scale_sample_sum
            sink.append(scale_sample_sum(pen))
        return input, (None if state is None else dict(state, penalty=pen))


class ActivityRegularization(_Penalty):
    """``l1 * sum|x| + l2 * sum x²`` of the activation."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        super().__init__()
        self.l1, self.l2 = float(l1), float(l2)

    def _term(self, x):
        return self.l1 * x.abs().sum() + self.l2 * x.square().sum()


class NegativeEntropyPenalty(_Penalty):
    """``beta * sum(p log p)`` of a probability activation."""

    def __init__(self, beta: float = 0.01):
        super().__init__()
        self.beta = float(beta)

    def _term(self, p):
        return self.beta * (p * torch.log(p.clamp(min=1e-12))).sum()


class CrossProduct(AbstractModule):
    """The dot products of every pair of a Table of N same-shape tensors,
    (1,2), (1,3), ..., (N-1,N), along a new last axis."""

    def __init__(self, num_tensor: int = 0, embedding_size: int = 0):
        super().__init__()
        self.num_tensor = num_tensor
        self.embedding_size = embedding_size

    def run(self, input, state=None):
        xs = _values(input)
        if self.num_tensor and len(xs) != self.num_tensor:
            raise ValueError(f"CrossProduct expected {self.num_tensor} "
                             f"tensors, got {len(xs)}")
        if self.embedding_size:
            bad = [x.shape[-1] for x in xs
                   if x.shape[-1] != self.embedding_size]
            if bad:
                raise ValueError(f"CrossProduct expected embedding size "
                                 f"{self.embedding_size}, got {bad}")
        outs = [(xs[i] * xs[j]).sum(-1)
                for i in range(len(xs)) for j in range(i + 1, len(xs))]
        return torch.stack(outs, dim=-1), state
