"""Normalization layers: LayerNorm, RMSNorm, Dropout and batch norm.

Counterpart of ``bigdl_tpu/nn/normalization.py``:

- ``LayerNorm``: weight ones, bias zeros, eps 1e-5; every call goes through
  ``kernels.fused_layer_norm`` (the kernel on CUDA tensors, its plain
  version on CPU tensors);
- ``RMSNorm``: weight ones, eps 1e-6, JAX's rounding: the mean of squares
  in fp32, ``rsqrt(ms + eps)`` cast to the input's dtype, then
  ``input * that * weight`` (plain torch ops: it is jnp in JAX);
- ``Dropout``: inverted dropout in training mode, identity in eval mode or
  at p = 0. The mask is ``uniform < 1 - p`` drawn from ``generator`` (the
  default generator of the input's device when None). Under a captured
  training step (``utils/programs.py``) every replay draws a fresh mask:
  the default CUDA generator is tracked by the capture, and the trainer
  registers an explicit CUDA generator with the graph
  (:func:`dropout_generators`). Under rematerialisation
  (``nn.Remat``, ``set_remat``) the recomputation must see the masks of
  the forward, as JAX's explicit keys give it: the checkpoint's contexts
  (:func:`checkpoint_contexts`) keep each mask the forward drew and hand
  it back to the recomputation, so no generator state is read or restored
  (which a capture forbids);
- ``BatchNormalization`` over the feature axis of (N, F) input and
  ``SpatialBatchNormalization`` over the channel axis (``nn/layout.py``),
  with JAX's arithmetic (``:34-133``): an fp32 island whatever the input's
  dtype; training-mode statistics in a single pass, ``E[x²] − E[x]²``
  clamped at 0 (``BIGDL_BN_TWO_PASS=1``: the centred two-pass variance);
  the running variance updated with the unbiased ``n/(n−1)``; the output
  normalised in fp32 and cast back to the input's dtype. The running
  statistics are fp32 buffers updated in place in training mode, so a
  captured training step updates them at each replay and a gradient
  accumulation's micro-batch i sees what micro-batch i − 1 left, as JAX's
  scan carries them. A recomputation under a checkpoint (``Remat``,
  ``set_remat``) does not update them again (:func:`recomputing`). The
  training forward is one autograd Function whose backward is the
  derivative of that forward in fp32 torch ops; it keeps only the input and
  its per-channel statistics for the backward;
- ``SpatialCrossMapLRN`` (``:305``): local response normalisation across
  channels, ``x / (k + alpha/size · Σ x²) ** beta`` over Torch's asymmetric
  window (``size // 2`` channels before, ``(size - 1) // 2`` after), NCHW
  and NHWC. The windowed sum is JAX's banded C×C 0/1 product
  (``torch.einsum`` in the input's dtype; the trainer keeps TF32 off under
  its fp32 policy), the rest torch ops;
- the tail (``:247-610``): ``Normalize``, the learned ``CMul``, ``CAdd``,
  ``Mul`` and ``Add``; ``SpatialWithinChannelLRN`` (a SAME window of the
  last two axes: ``avg_pool2d`` counting the padding, so ``alpha · avg``
  is JAX's ``alpha/size² · sum``); the Spatial{Subtractive,Divisive,
  Contrastive}Normalization, whose kernel-weighted neighbourhood mean over
  every channel is one ``F.conv2d`` divided by the same convolution of
  ones (JAX's border correction); and the random layers
  ``SpatialDropout1D/2D/3D``, ``GaussianDropout`` and ``GaussianNoise``,
  which draw from ``generator`` as ``Dropout`` does (their masks and noise
  recorded for a recomputation the same way). Like JAX's, the Gaussian
  layers draw fp32 noise, so a bf16 input gives an fp32 output. The
  spatial normalizations take (N, C, H, W) in both image formats, as
  JAX's do; ``SpatialDropout2D``'s channel axis follows ``nn/layout.py``.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.kernels import fused_layer_norm
from bigdl_tpu_torch.nn import layout
from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.initialization import (
    InitializationMethod, RandomUniform, Zeros,
)


class LayerNorm(TensorModule):
    def __init__(self, n_output: int, eps: float = 1e-5):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(n_output))
        self.bias = torch.nn.Parameter(torch.zeros(n_output))

    def run(self, input, state=None):
        return fused_layer_norm(input, self.weight, self.bias, self.eps), state

    def extra_repr(self):
        return f"{self.n_output}, eps={self.eps}"


class RMSNorm(TensorModule):
    """Root-mean-square norm over the last axis (no centering, no bias)."""

    def __init__(self, n_output: int, eps: float = 1e-6):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(n_output))

    def run(self, input, state=None):
        ms = input.float().square().mean(dim=-1, keepdim=True)
        out = input * torch.rsqrt(ms + self.eps).to(input.dtype)
        return out * self.weight, state

    def extra_repr(self):
        return f"{self.n_output}, eps={self.eps}"


# the mask tapes of the checkpoints now running on this thread, innermost
# last: ("record", masks) while a checkpointed forward runs, ("replay",
# masks) while its recomputation runs
_TAPES = threading.local()


def _tapes() -> list:
    if not hasattr(_TAPES, "stack"):
        _TAPES.stack = []
    return _TAPES.stack


@contextlib.contextmanager
def _tape(mode: str, masks: list):
    stack = _tapes()
    stack.append((mode, masks))
    try:
        yield
    finally:
        stack.pop()


def _draw_mask(draw: Callable[[], torch.Tensor]) -> torch.Tensor:
    """A dropout mask: handed back by the innermost recomputation, or
    drawn; recorded by every checkpointed forward inside that."""
    stack = _tapes()
    start, mask = 0, None
    for i in range(len(stack) - 1, -1, -1):
        mode, masks = stack[i]
        if mode == "replay":
            mask, start = masks.pop(0), i + 1
            break
    if mask is None:
        mask = draw()
    for mode, masks in stack[start:]:
        masks.append(mask)
    return mask


def recomputing() -> bool:
    """Whether a checkpoint's recomputation is running on this thread (its
    forward already ran once: batch norm does not update its running
    statistics a second time)."""
    return any(mode == "replay" for mode, _ in _tapes())


def checkpoint_contexts(inner: Optional[Callable[[], tuple]] = None
                        ) -> tuple:
    """A ``context_fn`` for ``torch.utils.checkpoint``: the forward's
    context records the dropout masks drawn under it, the recomputation's
    hands them back in order. ``inner`` is another ``context_fn`` whose
    contexts are entered too (the selective policy of remat "dots")."""
    masks: list = []
    fwd, rec = inner() if inner is not None else (
        contextlib.nullcontext(), contextlib.nullcontext())
    return (_joined(fwd, _tape("record", masks)),
            _joined(rec, _tape("replay", masks)))


@contextlib.contextmanager
def _joined(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


class Dropout(TensorModule):
    draws_random = True

    """Inverted dropout (reference ``nn.Dropout``): in training mode each
    element is kept with probability ``1 - p`` and, with ``scale``, divided
    by it."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_p(init_p)
        self.p = init_p
        self.scale = scale
        self.generator = generator

    def set_p(self, p: float) -> "Dropout":
        _check_p(p)
        self.p = p
        return self

    def run(self, input, state=None):
        if not self.training or self.p == 0.0:
            return input, state
        keep = 1.0 - self.p
        mask = _draw_mask(lambda: torch.rand(
            input.shape, generator=self.generator,
            device=input.device) < keep)
        out = input.masked_fill(~mask, 0.0)
        if self.scale:
            out = out / keep
        return out, state

    def extra_repr(self):
        return f"p={self.p}"


def _check_p(p: float) -> None:
    if not 0.0 <= p < 1.0:
        raise ValueError("dropout probability must be in [0, 1)")


def dropout_generators(model: torch.nn.Module) -> list:
    """The explicit CUDA generators of ``model``'s random layers (Dropout
    and every layer marked ``draws_random``: the spatial and Gaussian
    dropouts, ``GaussianNoise``, ``RReLU``, ``GaussianSampler``), which a
    captured program must register with its graph."""
    gens = []
    for m in model.modules():
        g = m.generator if getattr(m, "draws_random", False) else None
        if g is not None and g.device.type == "cuda" and \
                all(g is not h for h in gens):
            gens.append(g)
    return gens


def _group_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of per-rank means over ``group`` (equal sample counts)."""
    if group is None:
        return t
    from bigdl_tpu_torch.parallel import collectives as C
    return C.all_reduce_(t.clone(), group) / C.size(group)


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode batch norm over ``axes`` in fp32: returns the output
    in x's dtype and the batch mean and (biased) variance. With a
    data-parallel ``group`` the moments, and the backward's two channel
    sums, are those of the global batch (JAX's, whose batch axis GSPMD
    reduces across the mesh): the raw moments ``(E[x], E[x²])`` averaged
    over the ranks, exact for equal per-rank counts."""

    @staticmethod
    def forward(ctx, x, weight, bias, axes, shape, eps, two_pass, group):
        x32 = x.float()
        mean_l = x32.mean(axes)
        mean = _group_mean(mean_l, group)
        if two_pass and group is None:
            var = x32.var(axes, correction=0)
            var_grad = torch.ones_like(var)
        else:
            if group is None:
                raw = x32.square().mean(axes) - mean.square()
            else:
                # the raw second moment averaged (JAX's two-pass variant
                # rebuilds it from the centred one)
                mean2 = (x32.var(axes, correction=0) + mean_l.square()
                         if two_pass else x32.square().mean(axes))
                raw = _group_mean(mean2, group) - mean.square()
            var = raw.clamp(min=0.0)
            # d max(v, 0)/dv as JAX takes it: 1 above, 0.5 at the tie
            var_grad = (raw > 0).float() + 0.5 * (raw == 0).float()
        inv = torch.rsqrt(var + eps)
        out = (x32 - mean.reshape(shape)) * inv.reshape(shape)
        if weight is not None:
            out = out * weight.float().reshape(shape) \
                + bias.float().reshape(shape)
        ctx.save_for_backward(x, weight, mean, inv, var_grad)
        ctx.axes, ctx.shape, ctx.group = axes, shape, group
        ctx.mark_non_differentiable(mean, var)
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, weight, mean, inv, var_grad = ctx.saved_tensors
        axes, shape = ctx.axes, ctx.shape
        n = x.numel() // mean.numel()
        g = dout.float()
        xhat = (x.float() - mean.reshape(shape)) * inv.reshape(shape)
        dweight = dbias = None
        if weight is not None:
            if ctx.needs_input_grad[1]:
                dweight = (g * xhat).sum(axes).to(weight.dtype)
            if ctx.needs_input_grad[2]:
                dbias = g.sum(axes).to(weight.dtype)
            g = g * weight.float().reshape(shape)
        dx = None
        if ctx.needs_input_grad[0]:
            if ctx.group is None:
                gm = g.sum(axes) / n
                gx = (g * xhat).sum(axes) * var_grad / n
            else:
                gm = _group_mean(g.sum(axes) / n, ctx.group)
                gx = _group_mean((g * xhat).sum(axes) / n,
                                 ctx.group) * var_grad
            dx = ((g - gm.reshape(shape) - xhat * gx.reshape(shape))
                  * inv.reshape(shape)).to(x.dtype)
        return dx, dweight, dbias, None, None, None, None, None


class BatchNormalization(TensorModule):
    """Batch norm over the feature axis of (N, F) input (reference
    ``nn.BatchNormalization``): weight U(0, 1) and bias zeros by default,
    running mean zeros and running variance ones, Torch's momentum
    convention ``running = (1 − m)·running + m·batch``."""

    _feature_axis = 1

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 sync: bool = False,
                 generator: Optional[torch.Generator] = None,
                 sync_axis: str = "data"):
        super().__init__()
        self.sync = bool(sync)
        self.sync_axis = sync_axis
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            init_weight = init_weight or RandomUniform(0.0, 1.0)
            init_bias = init_bias or Zeros()
            self.weight = torch.nn.Parameter(init_weight.init(
                (n_output,), n_output, n_output, generator=generator))
            self.bias = torch.nn.Parameter(init_bias.init(
                (n_output,), n_output, n_output, generator=generator))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(n_output))
        self.register_buffer("running_var", torch.ones(n_output))

    def _feature(self, ndim: int) -> int:
        return self._feature_axis

    def run(self, input, state=None):
        fa = self._feature(input.dim())
        axes = tuple(a for a in range(input.dim()) if a != fa)
        shape = tuple(self.n_output if a == fa else 1
                      for a in range(input.dim()))
        if self.training:
            from bigdl_tpu_torch.parallel.collectives import data_group, size
            group = data_group()
            if self.sync and group is None:
                # JAX's pmean over an axis name no program binds
                raise NameError(
                    f"BatchNormalization(sync=True): unbound axis name: "
                    f"{self.sync_axis} (sync=True needs a data-parallel "
                    f"step, DistriOptimizer)")
            out, mean, var = _BatchNormTrain.apply(
                input, self.weight, self.bias, axes, shape, self.eps,
                os.environ.get("BIGDL_BN_TWO_PASS", "0") == "1", group)
            n = input.numel() // self.n_output
            if group is not None:
                n *= size(group)
            if not recomputing():
                self._update_running(mean, var, n)
            return out, state
        x32 = input.float()
        out = (x32 - self.running_mean.reshape(shape)) * torch.rsqrt(
            self.running_var + self.eps).reshape(shape)
        if self.affine:
            out = out * self.weight.float().reshape(shape) \
                + self.bias.float().reshape(shape)
        return out.to(input.dtype), state

    @torch.no_grad()
    def _update_running(self, mean, var, n: int) -> None:
        m = self.momentum
        unbiased = var * (n / max(n - 1, 1))
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * unbiased)

    def extra_repr(self):
        return f"{self.n_output}, eps={self.eps}, momentum={self.momentum}"


class SpatialBatchNormalization(BatchNormalization):
    """Batch norm over the channel axis of spatial input (reference
    ``nn.SpatialBatchNormalization``; the axis follows ``nn/layout.py``)."""

    def _feature(self, ndim: int) -> int:
        return layout.channel_axis(ndim)

    def folded_scale_shift(self):
        """Per-channel (scale, shift) with ``bn(y) == y·scale + shift``
        under the running statistics (``kernels/conv_bn.py``)."""
        from bigdl_tpu_torch.kernels.conv_bn import fold_bn_scale_shift
        return fold_bn_scale_shift(self.weight, self.bias, self.running_mean,
                                   self.running_var, self.eps)


class SpatialCrossMapLRN(TensorModule):
    """Local response normalisation across channels (reference
    ``nn.SpatialCrossMapLRN``; Inception-v1, AlexNet):
    ``out = x / (k + alpha/size * sum_{size local channels} x^2) ** beta``.
    """

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def run(self, input, state=None):
        sq = input.square()
        pre, post = self.size // 2, (self.size - 1) // 2
        c = sq.shape[layout.channel_axis(sq.dim())]
        idx = torch.arange(c, device=input.device)
        # band[i, j] = 1 where channel i falls in j's window [j - pre, j + post]
        band = ((idx[:, None] >= idx[None, :] - pre)
                & (idx[:, None] <= idx[None, :] + post)).to(sq.dtype)
        eq = "nhwi,ij->nhwj" if layout.is_nhwc() else "nihw,ij->njhw"
        summed = torch.einsum(eq, sq, band)
        denom = (self.k + (self.alpha / self.size) * summed).pow(self.beta)
        return input / denom, state

    def extra_repr(self):
        return f"{self.size}, {self.alpha}, {self.beta}, {self.k}"


class _RandomLayer(TensorModule):
    """A layer that draws in training mode from ``generator`` (the
    default generator of the input's device when None)."""

    draws_random = True

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.generator = generator

    def _keep_mask(self, shape, keep: float, device) -> torch.Tensor:
        return _draw_mask(lambda: torch.rand(
            shape, generator=self.generator, device=device) < keep)

    def _normal(self, shape, device) -> torch.Tensor:
        """fp32 N(0, 1) noise of ``shape``, as ``jax.random.normal``'s."""
        return _draw_mask(lambda: torch.randn(
            shape, generator=self.generator, device=device))


class _SpatialDropout(_RandomLayer):
    def __init__(self, init_p: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        _check_p(init_p)
        self.p = init_p

    def _mask_shape(self, x) -> tuple:
        raise NotImplementedError

    def run(self, input, state=None):
        if not self.training or self.p == 0.0:
            return input, state
        keep = 1.0 - self.p
        mask = self._keep_mask(self._mask_shape(input), keep, input.device)
        return torch.where(mask, input / keep, 0.0), state

    def extra_repr(self):
        return f"p={self.p}"


class SpatialDropout1D(_SpatialDropout):
    """Whole feature channels of (N, T, C) input dropped (one mask a row),
    or of (T, C) input."""

    def _mask_shape(self, x):
        return (x.shape[0], 1, x.shape[-1]) if x.dim() == 3 \
            else (1, x.shape[-1])


class SpatialDropout2D(_SpatialDropout):
    """Whole channels of spatial input dropped (one mask a sample), the
    channel axis from ``nn/layout.py``."""

    def _mask_shape(self, x):
        ca = layout.channel_axis(x.dim())
        return tuple(x.shape[a] if a == ca or (a == 0 and x.dim() == 4)
                     else 1 for a in range(x.dim()))


class SpatialDropout3D(_SpatialDropout):
    """Whole channels of (N, C, D, H, W) input dropped."""

    def _mask_shape(self, x):
        return tuple(x.shape[:2]) + (1,) * (x.dim() - 2)


class GaussianDropout(_RandomLayer):
    """Multiplicative noise ``1 + sqrt(rate / (1 - rate)) · N(0, 1)`` in
    training mode."""

    def __init__(self, rate: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.rate = rate

    def run(self, input, state=None):
        if not self.training or self.rate == 0.0:
            return input, state
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        return input * (1.0 + stddev * self._normal(input.shape,
                                                    input.device)), state


class GaussianNoise(_RandomLayer):
    """Additive noise ``stddev · N(0, 1)`` in training mode."""

    def __init__(self, stddev: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.stddev = stddev

    def run(self, input, state=None):
        if not self.training:
            return input, state
        return input + self.stddev * self._normal(input.shape,
                                                  input.device), state


class Normalize(TensorModule):
    """The input over its ``p``-norm along axis 1 (plus ``eps``)."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10):
        super().__init__()
        self.p = p
        self.eps = eps

    def run(self, input, state=None):
        if self.p == float("inf"):
            norm = input.abs().amax(1, keepdim=True)
        else:
            norm = input.abs().pow(self.p).sum(1, keepdim=True) \
                .pow(1.0 / self.p)
        return input / (norm + self.eps), state


def _prod(size) -> int:
    out = 1
    for s in size:
        out *= int(s)
    return out


class CMul(TensorModule):
    """A learned scale of shape ``size``, broadcast over the input."""

    def __init__(self, size: tuple,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size = tuple(size)
        n = _prod(self.size)
        self.weight = torch.nn.Parameter(RandomUniform().init(
            self.size, n, n, generator=generator))

    def run(self, input, state=None):
        return input * self.weight, state


class CAdd(TensorModule):
    """A learned bias of shape ``size``, broadcast over the input."""

    def __init__(self, size: tuple,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size = tuple(size)
        n = _prod(self.size)
        self.bias = torch.nn.Parameter(RandomUniform().init(
            self.size, n, n, generator=generator))

    def run(self, input, state=None):
        return input + self.bias, state


class Mul(TensorModule):
    """One learned scalar gain."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = torch.nn.Parameter(RandomUniform().init(
            (1,), 1, 1, generator=generator))

    def run(self, input, state=None):
        return input * self.weight[0], state


class Add(TensorModule):
    """A learned bias vector added to (N, F) input."""

    def __init__(self, input_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.bias = torch.nn.Parameter(RandomUniform().init(
            (input_size,), input_size, input_size, generator=generator))

    def run(self, input, state=None):
        return input + self.bias, state


class SpatialWithinChannelLRN(TensorModule):
    """``x / (1 + alpha/size² · Σ_{size×size window} x²) ** beta`` per
    channel, the window SAME-padded (``size`` odd)."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75):
        super().__init__()
        if size % 2 == 0:
            raise ValueError("LRN window size must be odd")
        self.size, self.alpha, self.beta = size, alpha, beta

    def run(self, input, state=None):
        x = input[None] if input.dim() == 3 else input
        s = self.size
        avg = F.avg_pool2d(x.square(), s, 1, s // 2, count_include_pad=True)
        out = x / (1.0 + self.alpha * avg) ** self.beta
        return (out[0] if input.dim() == 3 else out), state


def _kernel2d(kernel) -> np.ndarray:
    k = np.asarray(kernel if kernel is not None else np.ones((9, 9)),
                   np.float32)
    if k.ndim == 1:              # a separable 1-D kernel: its outer product
        k = np.outer(k, k).astype(np.float32)
    return k


def _check_odd_kernel(kernel: np.ndarray, who: str) -> None:
    kh, kw = kernel.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(
            f"{who}: kernel must have odd dimensions for SAME-centered "
            f"neighborhoods, got {kh}x{kw}")


class _Neighbourhood(TensorModule):
    """The kernel-weighted mean over every channel around each pixel of
    (N, C, H, W) input, border-corrected: ``conv(x, k) / conv(1, k)`` with
    ``k = kernel / (Σ kernel · C)`` broadcast over the C input channels."""

    def __init__(self, n_input_plane: int, kernel, who: str):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.kernel = _kernel2d(kernel)
        _check_odd_kernel(self.kernel, who)
        k = torch.from_numpy(self.kernel)
        # the per-channel weight, made once (no host copy at run time)
        self.register_buffer("weight_k", (k / (k.sum() * n_input_plane))[
            None, None].expand(1, n_input_plane, *k.shape).contiguous(),
            persistent=False)

    def _mean(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight_k.to(x.dtype)
        pad = (w.shape[-2] // 2, w.shape[-1] // 2)
        mean = F.conv2d(x, w, padding=pad)
        ones = torch.ones((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return mean / F.conv2d(ones, w, padding=pad)


class SpatialSubtractiveNormalization(_Neighbourhood):
    """The input minus its neighbourhood mean (a 9×9 ones kernel by
    default; a 1-D kernel stands for its outer product)."""

    def __init__(self, n_input_plane: int = 1, kernel=None):
        super().__init__(n_input_plane, kernel,
                         "SpatialSubtractiveNormalization")

    def run(self, input, state=None):
        x = input[None] if input.dim() == 3 else input
        out = x - self._mean(x)
        return (out[0] if input.dim() == 3 else out), state


class SpatialDivisiveNormalization(_Neighbourhood):
    """The input over its local standard deviation (the square root of
    the neighbourhood mean of x²). With ``threshold``, a deviation at or
    below it is replaced by ``thresval`` (default: the threshold); without
    it, the divisor is floored by its per-sample mean."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: Optional[float] = None,
                 thresval: Optional[float] = None):
        super().__init__(n_input_plane, kernel,
                         "SpatialDivisiveNormalization")
        self.threshold = threshold
        self.thresval = thresval if thresval is not None else threshold

    def run(self, input, state=None):
        x = input[None] if input.dim() == 3 else input
        localstd = torch.sqrt(self._mean(x.square()).clamp(min=0.0))
        if self.threshold is not None:
            divisor = torch.where(localstd > self.threshold, localstd,
                                  self.thresval)
        else:
            divisor = torch.maximum(localstd, localstd.mean(
                (1, 2, 3), keepdim=True))
        out = x / divisor
        return (out[0] if input.dim() == 3 else out), state


class SpatialContrastiveNormalization(TensorModule):
    """Subtractive, then divisive normalization."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 threshold: Optional[float] = None,
                 thresval: Optional[float] = None):
        super().__init__()
        # children without parameters (JAX's has none): their kernel
        # buffers move with .to(device)
        self.sub = SpatialSubtractiveNormalization(n_input_plane, kernel)
        self.div = SpatialDivisiveNormalization(n_input_plane, kernel,
                                                threshold, thresval)

    def run(self, input, state=None):
        out = self.sub.run(input)[0]
        return self.div.run(out)[0], state
