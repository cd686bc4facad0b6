"""Flash-attention forward: the CUDA kernel, its plain version, and the
dispatcher ``MultiHeadAttention`` calls.

Counterpart of ``bigdl_tpu/kernels/flash_attention.py``. The kernel
(``csrc/flash_attention.cu``) replaces the Pallas ``_pallas_flash_call``:
streaming softmax over key tiles, scale ``1/sqrt(d)``, causal tile skip,
output O in the input dtype and the per-row logsumexp ``lse`` in fp32,
which :func:`flash_attention_fwd` returns so the backward kernels of the
training step can reuse it. Any T is handled by masking the ragged last
tile; there is no O(T^2) fallback. The dispatcher launches the kernel for
CUDA tensors and raises if it cannot; the plain version runs only for CPU
tensors.
"""

from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.kernels import _cuda

launches = _cuda.LaunchCounter("flash_attention_fwd")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain attention over (..., T, d) in fp32: ``(O, lse)`` with O in the
    input dtype and the fp32 per-row logsumexp of the scaled scores."""
    d = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        keep = torch.ones(t_q, t_k, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return (p @ v.float()).to(q.dtype), lse


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on (B·H, T, d) tensors: same shape, dtype
    (float32 or bfloat16) and CUDA device, contiguous, 16-byte aligned,
    d in {32, 64, 128}. Returns ``(O, lse)``."""
    if not q.is_cuda:
        raise ValueError(
            f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    if q.dim() != 3:
        raise ValueError(f"flash_attention_cuda takes (B*H, T, d), "
                         f"got {tuple(q.shape)}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and device")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention_cuda takes float32 or bfloat16, "
                         f"got {q.dtype}")
    bh, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for x in (q, k, v):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("flash_attention_cuda needs contiguous, "
                             "16-byte aligned tensors")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "the flash-attention kernel is forward-only; run inference "
            "under torch.no_grad() (the backward kernels come with the "
            "training step)")
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    lib = _cuda.library().lib
    with torch.cuda.device(q.device):
        code = lib.bigdl_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, t, d, int(bool(causal)),
            _DTYPE_CODES[q.dtype], _cuda.stream_handle(q))
    _cuda.check(code, "flash_attention_fwd")
    launches.add()
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B·H, T, d) attention → ``(O, lse)``: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Attention over (batch, heads, T, d) operands, the JAX function's
    layout; returns O in the same layout."""
    b, h, t, d = q.shape
    out, _ = flash_attention_fwd(q.reshape(b * h, t, d),
                                 k.reshape(b * h, t, d),
                                 v.reshape(b * h, t, d), causal)
    return out.reshape(b, h, t, d)
