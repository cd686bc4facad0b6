"""Fused LayerNorm: the CUDA forward kernel, its plain version, the
closed-form backward, and the ``autograd.Function`` the ``LayerNorm``
layer calls.

Counterpart of ``bigdl_tpu/kernels/layernorm.py``. The kernel
(``csrc/layernorm.cu``) replaces the Pallas ``_pallas_layer_norm``: one
read and one write of each row, statistics in fp32. :func:`fused_layer_norm`
launches it for CUDA tensors and raises if it cannot; the plain version
runs only for CPU tensors. The backward has no kernel in either package:
JAX's ``_fln_bwd`` is the recompute-form VJP of the plain formula in jnp,
and :func:`layer_norm_backward` is its counterpart in torch ops, recomputing
the statistics from the saved input.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.kernels import _cuda

launches = _cuda.LaunchCounter("layer_norm_fwd")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def layer_norm_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on ``x`` (N, H), fp32 or bf16, contiguous, with
    fp32 ``gamma``/``beta`` of shape (H,) on the same device."""
    if not x.is_cuda:
        raise ValueError(f"layer_norm_cuda needs a CUDA tensor, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"layer_norm_cuda takes (N, H), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"layer_norm_cuda takes float32 or bfloat16, "
                         f"got {x.dtype}")
    n, h = x.shape
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.dtype != torch.float32 or tuple(p.shape) != (h,) \
                or p.device != x.device:
            raise ValueError(f"{name} must be float32 of shape ({h},) on "
                             f"{x.device}, got {p.dtype} {tuple(p.shape)} "
                             f"on {p.device}")
    if not (x.is_contiguous() and gamma.is_contiguous()
            and beta.is_contiguous()):
        raise ValueError("layer_norm_cuda needs contiguous tensors")
    out = torch.empty_like(x)
    lib = _cuda.library().lib
    with torch.cuda.device(x.device):
        code = lib.bigdl_layer_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            n, h, float(eps), _DTYPE_CODES[x.dtype], _cuda.stream_handle(x))
    _cuda.check(code, "layer_norm_fwd")
    launches.add()
    return out


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
    The counterpart of JAX ``_fln_bwd``; it runs as plain torch on every
    device (no kernel in either package)."""
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


class LayerNormFunction(torch.autograd.Function):
    """The kernel forward (plain version on the CPU) with
    :func:`layer_norm_backward`; saves only x and gamma."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return layer_norm_forward(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_backward(x, gamma, ctx.eps, g)
        return dx, dgamma, dbeta, None


def fused_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, differentiable through
    :class:`LayerNormFunction`: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    return LayerNormFunction.apply(x, gamma, beta, eps)
