"""Fused LayerNorm: the CUDA forward and backward kernels, their plain
versions, and the ``autograd.Function`` the ``LayerNorm`` layer calls.

Counterpart of ``bigdl_tpu/kernels/layernorm.py``. Both kernels live in
``csrc/layernorm.cu``. The forward replaces the Pallas
``_pallas_layer_norm``: one read and one write of each row, statistics in
fp32. JAX's backward, ``_fln_bwd``, is the recompute-form VJP of the plain
formula in jnp, which XLA fuses on the TPU; the port's is the backward
kernel, which recomputes the statistics from the saved input as JAX does
and sums dgamma and dbeta in a fixed order (no float atomics).
:func:`fused_layer_norm` launches the kernels for CUDA tensors and raises if
it cannot; the plain versions (:func:`layer_norm_reference`,
:func:`layer_norm_backward`) run only for CPU tensors. gamma and beta are
fp32, or bf16 with a bf16 x, as the mixed-precision step casts them (JAX
casts every floating parameter); the arithmetic is fp32 either way, and
dgamma and dbeta come out in gamma's dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from bigdl_tpu_torch.kernels import _cuda

launches = _cuda.LaunchCounter("layer_norm_fwd")
bwd_launches = _cuda.LaunchCounter("layer_norm_bwd")

# The backward kernel's shapes in csrc/layernorm.cu (kBwdWarps, kWarpMaxH,
# kLoopThreads, kReduceWarps), which checks every plan it is given against
# them
BWD_WARPS, WARP_MAX_H, LOOP_THREADS, REDUCE_WARPS = 8, 1024, 1024, 8
BWD_CTAS_PER_SM = 2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _dtype_key(x: torch.Tensor, gamma: torch.Tensor) -> str:
    """A launch's dtypes as its counter records them: "x/gamma"."""
    return f"{str(x.dtype)[6:]}/{str(gamma.dtype)[6:]}"


def layer_norm_reference(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch LayerNorm over the last axis with the kernel's
    arithmetic: fp32 mean, mean of squared deviations, rsqrt, affine, cast
    back to the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return ((x32 - mean) * inv * gamma.float() + beta.float()).to(x.dtype)


def _check_params(fn: str, x: torch.Tensor, *params) -> None:
    """gamma (and beta) must be (H,) on x's device, fp32 or in x's dtype,
    one dtype for both."""
    h = x.shape[-1]
    allowed = {torch.float32, x.dtype}
    for name, p in zip(("gamma", "beta"), params):
        if p.dtype not in allowed or p.dtype != params[0].dtype \
                or tuple(p.shape) != (h,) or p.device != x.device:
            raise ValueError(
                f"{fn}: {name} must be float32 or {x.dtype} (as gamma) of "
                f"shape ({h},) on {x.device}, got {p.dtype} "
                f"{tuple(p.shape)} on {p.device}")


def layer_norm_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on ``x`` (N, H), fp32 or bf16, contiguous, with
    ``gamma``/``beta`` of shape (H,) on the same device, both fp32 or both in
    x's dtype (the mixed-precision step casts them to bf16 with x)."""
    if not x.is_cuda:
        raise ValueError(f"layer_norm_cuda needs a CUDA tensor, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"layer_norm_cuda takes (N, H), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"layer_norm_cuda takes float32 or bfloat16, "
                         f"got {x.dtype}")
    n, h = x.shape
    _check_params("layer_norm_cuda", x, gamma, beta)
    if not (x.is_contiguous() and gamma.is_contiguous()
            and beta.is_contiguous()):
        raise ValueError("layer_norm_cuda needs contiguous tensors")
    out = torch.empty_like(x)
    lib = _cuda.library().lib
    with torch.cuda.device(x.device):
        code = lib.bigdl_layer_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            n, h, float(eps), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[gamma.dtype], _cuda.stream_handle(x))
    _cuda.check(code, "layer_norm_fwd")
    launches.add(_dtype_key(x, gamma))
    return out


class BwdPlan(NamedTuple):
    """How the backward kernel spreads its rows over the card; the order of
    the dgamma and dbeta sums follows from it and from nothing else."""
    ctas: int           # CTAs striding over the rows, one partial row each
    rows_per_cta: int   # rows a CTA holds at once: its warps, or 1
    threads: int        # threads holding one row: a warp, or LOOP_THREADS
    vec: int            # elements a chunk: 1, or 16 bytes' worth
    chunks: int         # chunks a thread holds; 0 on the loop path
    reduce_warps: int   # column sum: warp k adds partial rows k, k + this, ...


def layer_norm_bwd_plan(n: int, h: int, vec: int, sms: int) -> BwdPlan:
    """The backward kernel's plan for ``n`` rows of ``h`` with chunks of
    ``vec`` elements, on a card of ``sms`` SMs. Rows of h <= WARP_MAX_H
    take one warp each, BWD_WARPS a CTA, every lane holding the fewest
    chunks the kernel is built for that cover the row; wider rows take one
    CTA of LOOP_THREADS each and scalar loads. About BWD_CTAS_PER_SM CTAs
    an SM, fewer when there are fewer rows. The CUDA wrapper launches this
    plan, and the CPU emulation of the kernel's sums reads it."""
    if h > WARP_MAX_H:
        rows, threads, vec, chunks = 1, LOOP_THREADS, 1, 0
    else:
        rows, threads = BWD_WARPS, 32
        per_lane = math.ceil(h // vec / 32)
        if vec == 1:
            chunks = 2 if per_lane <= 2 else 8 if per_lane <= 8 else 32
        else:
            chunks = 1
            while chunks < per_lane:
                chunks *= 2
    ctas = max(1, min(math.ceil(n / rows), BWD_CTAS_PER_SM * sms))
    return BwdPlan(ctas, rows, threads, vec, chunks, REDUCE_WARPS)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def layer_norm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor,
                        g: torch.Tensor, eps: float = 1e-5
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: ``(dx, dgamma, dbeta)`` of LayerNorm for
    ``x`` (N, H), fp32 or bf16, contiguous, the output gradient ``g`` of the
    same shape and dtype, and ``gamma`` (H,), fp32 or in x's dtype, all on
    one device. dx comes out in x's dtype; dgamma and dbeta are summed in
    fp32 and rounded once to gamma's dtype, as JAX's cast transpose rounds
    them; two calls on the same inputs agree bit for bit."""
    if x.dim() != 2:
        raise ValueError(f"layer_norm_bwd_cuda takes (N, H), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"layer_norm_bwd_cuda takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if g.dtype != x.dtype or g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must be {x.dtype} of shape {tuple(x.shape)} on "
                         f"{x.device}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    n, h = x.shape
    _check_params("layer_norm_bwd_cuda", x, gamma)
    if not (x.is_contiguous() and g.is_contiguous()
            and gamma.is_contiguous()):
        raise ValueError("layer_norm_bwd_cuda needs contiguous tensors")
    if not x.is_cuda:
        raise ValueError(f"layer_norm_bwd_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    dx = torch.empty_like(x)
    wide = 16 // x.element_size()
    aligned = h % wide == 0 and all(t.data_ptr() % 16 == 0
                                    for t in (x, g, gamma, dx))
    plan = layer_norm_bwd_plan(n, h, wide if aligned else 1,
                               _sm_count(x.device.index))
    dgb = torch.empty(2, h, dtype=gamma.dtype, device=x.device)
    workspace = torch.empty(plan.ctas, 2 * h, dtype=torch.float32,
                            device=x.device)
    lib = _cuda.library().lib
    with torch.cuda.device(x.device):
        code = lib.bigdl_layer_norm_bwd(
            x.data_ptr(), g.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
            dgb.data_ptr(), workspace.data_ptr(), n, h, float(eps),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[gamma.dtype],
            (ctypes.c_int * len(plan))(*plan), _cuda.stream_handle(x))
    _cuda.check(code, "layer_norm_bwd")
    bwd_launches.add(_dtype_key(x, gamma))
    return dx, dgb[0], dgb[1]


def layer_norm_forward(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis without autograd: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, gamma, beta, eps)
    h = x.shape[-1]
    out = layer_norm_cuda(x.reshape(-1, h).contiguous(), gamma.contiguous(),
                          beta.contiguous(), eps)
    return out.reshape(x.shape)


def layer_norm_backward(x: torch.Tensor, gamma: torch.Tensor, eps: float,
                        g: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``(dx, dgamma, dbeta)`` of LayerNorm over the last axis for
    the output gradient ``g``, in fp32 torch ops from the saved input:
    with ``xhat = (x - mean)·inv`` and ``gx = g·gamma``,
    ``dx = inv·(gx - mean(gx) - xhat·mean(gx·xhat))``,
    ``dgamma = Σ g·xhat``, ``dbeta = Σ g`` over the leading axes.
    The plain version of the backward kernel and the counterpart of JAX
    ``_fln_bwd``; the dispatcher runs it only for CPU tensors."""
    x32, g32 = x.float(), g.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * inv
    gx = g32 * gamma.float()
    dx = inv * (gx - gx.mean(dim=-1, keepdim=True)
                - xhat * (gx * xhat).mean(dim=-1, keepdim=True))
    lead = tuple(range(x.dim() - 1))
    dgamma = (g32 * xhat).sum(dim=lead)
    dbeta = g32.sum(dim=lead)
    return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


def layer_norm_grad(x: torch.Tensor, gamma: torch.Tensor, eps: float,
                    g: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm's backward without autograd: the CUDA kernel for CUDA
    tensors, :func:`layer_norm_backward` for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_backward(x, gamma, eps, g)
    h = x.shape[-1]
    dx, dgamma, dbeta = layer_norm_bwd_cuda(
        x.reshape(-1, h).contiguous(), gamma.contiguous(),
        g.reshape(-1, h).contiguous(), eps)
    return dx.reshape(x.shape), dgamma, dbeta


class LayerNormFunction(torch.autograd.Function):
    """The kernel forward and backward (plain versions on the CPU); saves
    only x and gamma."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return layer_norm_forward(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_grad(x, gamma, ctx.eps, g)
        return dx, dgamma, dbeta, None


def fused_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, differentiable through
    :class:`LayerNormFunction`: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    return LayerNormFunction.apply(x, gamma, beta, eps)
