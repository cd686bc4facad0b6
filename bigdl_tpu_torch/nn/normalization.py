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
  its per-channel statistics for the backward.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable, Optional

import torch

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
    """The explicit CUDA generators of ``model``'s Dropout layers, which a
    captured program must register with its graph."""
    gens = []
    for m in model.modules():
        g = m.generator if isinstance(m, Dropout) else None
        if g is not None and g.device.type == "cuda" and \
                all(g is not h for h in gens):
            gens.append(g)
    return gens


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode batch norm over ``axes`` in fp32: returns the output
    in x's dtype and the batch mean and (biased) variance."""

    @staticmethod
    def forward(ctx, x, weight, bias, axes, shape, eps, two_pass):
        x32 = x.float()
        mean = x32.mean(axes)
        if two_pass:
            var = x32.var(axes, correction=0)
            var_grad = torch.ones_like(var)
        else:
            raw = x32.square().mean(axes) - mean.square()
            var = raw.clamp(min=0.0)
            # d max(v, 0)/dv as JAX takes it: 1 above, 0.5 at the tie
            var_grad = (raw > 0).float() + 0.5 * (raw == 0).float()
        inv = torch.rsqrt(var + eps)
        out = (x32 - mean.reshape(shape)) * inv.reshape(shape)
        if weight is not None:
            out = out * weight.float().reshape(shape) \
                + bias.float().reshape(shape)
        ctx.save_for_backward(x, weight, mean, inv, var_grad)
        ctx.axes, ctx.shape = axes, shape
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
            gm = g.sum(axes) / n
            gx = (g * xhat).sum(axes) * var_grad / n
            dx = ((g - gm.reshape(shape) - xhat * gx.reshape(shape))
                  * inv.reshape(shape)).to(x.dtype)
        return dx, dweight, dbias, None, None, None, None


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
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if sync:
            raise NotImplementedError(
                "BatchNormalization(sync=True) needs the data-parallel "
                "trainer: ROADMAP Queue A.6 (optim/distri_optimizer.py)")
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
            out, mean, var = _BatchNormTrain.apply(
                input, self.weight, self.bias, axes, shape, self.eps,
                os.environ.get("BIGDL_BN_TWO_PASS", "0") == "1")
            if not recomputing():
                self._update_running(mean, var, input.numel() // self.n_output)
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
