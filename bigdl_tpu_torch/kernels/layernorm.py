"""Fused LayerNorm forward: the CUDA kernel, its plain version, and the
dispatcher the ``LayerNorm`` layer calls.

Counterpart of ``bigdl_tpu/kernels/layernorm.py``. The kernel
(``csrc/layernorm.cu``) replaces the Pallas ``_pallas_layer_norm``: one
read and one write of each row, statistics in fp32. :func:`fused_layer_norm`
launches it for CUDA tensors and raises if it cannot; the plain version
runs only for CPU tensors. The kernel is forward-only in this slice: the
backward (in JAX, the recompute-form VJP ``_fln_bwd``) comes with the
training step.
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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gamma, beta)):
        raise NotImplementedError(
            "the LayerNorm kernel is forward-only; run inference under "
            "torch.no_grad() (the backward comes with the training step)")
    out = torch.empty_like(x)
    lib = _cuda.library().lib
    with torch.cuda.device(x.device):
        code = lib.bigdl_layer_norm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            n, h, float(eps), _DTYPE_CODES[x.dtype], _cuda.stream_handle(x))
    _cuda.check(code, "layer_norm_fwd")
    launches.add()
    return out


def fused_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, gamma, beta, eps)
    h = x.shape[-1]
    out = layer_norm_cuda(x.reshape(-1, h).contiguous(), gamma.contiguous(),
                          beta.contiguous(), eps)
    return out.reshape(x.shape)
