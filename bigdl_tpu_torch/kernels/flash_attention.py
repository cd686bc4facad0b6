"""Flash attention, forward and backward: the CUDA kernels, their plain
versions, the dispatchers and the ``autograd.Function`` that joins them.

Counterpart of ``bigdl_tpu/kernels/flash_attention.py``. Three kernels:

- ``csrc/flash_attention.cu`` replaces the Pallas ``_pallas_flash_call``:
  streaming softmax over key tiles, scale ``1/sqrt(d)``, causal tile skip,
  output O in the input dtype and the per-row logsumexp ``lse`` in fp32,
  which the backward reuses. Both products run with ``wgmma`` on the
  tensor cores (fp32 as 3xTF32), fed by a TMA ring of K/V tiles;
- ``csrc/flash_attention_bwd.cu`` replaces ``_pallas_flash_bwd_dq`` and
  ``_pallas_flash_bwd_dkv``: the probabilities are recomputed from
  ``(q, k, lse)``, and ``D = rowsum(dO∘O)`` is computed beforehand with
  torch ops, as ``_flash_bwd`` does with jnp. All four products of each
  tile run with ``wgmma`` (fp32 as 3xTF32), fed by a TMA ring of the
  streamed tiles; every output is owned by one CTA, so the result is
  deterministic.

Any T is handled by masking the ragged last tile; there is no O(T^2)
fallback. The dispatchers launch the kernels for CUDA tensors and raise if
they cannot; the plain versions run only for CPU tensors.
:class:`FlashAttention` replaces the JAX ``custom_vjp`` glue.
"""

from __future__ import annotations

import ctypes
import math

import torch

from bigdl_tpu_torch.kernels import _cuda

launches = _cuda.LaunchCounter("flash_attention_fwd")
bwd_dq_launches = _cuda.LaunchCounter("flash_attention_bwd_dq")
bwd_dkv_launches = _cuda.LaunchCounter("flash_attention_bwd_dkv")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled fp32 scores q·kᵀ/sqrt(d); -inf above the diagonal if
    causal."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        keep = torch.ones(t_q, t_k, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain attention over (..., T, d) in fp32: ``(O, lse)`` with O in the
    input dtype and the fp32 per-row logsumexp of the scaled scores."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return (p @ v.float()).to(q.dtype), lse


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool = False
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain backward over (..., T, d) in fp32, on the formula of the two
    Pallas kernels: ``p = exp(s - lse)``, ``D = rowsum(dO∘O)``,
    ``ds = p·(dO·vᵀ - D)``, then ``dq = ds·k·scale``,
    ``dk = dsᵀ·q·scale``, ``dv = pᵀ·dO``. Returns ``(dq, dk, dv)`` in the
    dtypes of q, k, v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - lse.float()[..., None])
    do32 = do.float()
    dd = (do32 * o.float()).sum(-1, keepdim=True)
    ds = p * (do32 @ v.float().transpose(-1, -2) - dd)
    dq = (ds @ k.float()) * scale
    dk = (ds.transpose(-1, -2) @ q.float()) * scale
    dv = p.transpose(-1, -2) @ do32
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _variant(causal: bool) -> str:
    """The launch counters' variant of a flash launch."""
    return "causal" if causal else "full"


def _check_operands(fn: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    """The kernels take (B·H, T, d) tensors of one shape, dtype (float32 or
    bfloat16) and CUDA device, contiguous, 16-byte aligned, d in
    {32, 64, 128}."""
    if not q.is_cuda:
        raise ValueError(f"{fn} needs CUDA tensors, got {q.device}")
    if q.dim() != 3:
        raise ValueError(f"{fn} takes (B*H, T, d), got {tuple(q.shape)}")
    for x in others:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{fn}: every operand must match q's shape, "
                             f"dtype and device")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{fn} takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    for x in (q, *others):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{fn} needs contiguous, 16-byte aligned "
                             f"tensors")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on (B·H, T, d) tensors. Returns
    ``(O, lse)``."""
    _check_operands("flash_attention_cuda", q, k, v)
    bh, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    lib = _cuda.library().lib
    stream = _cuda.stream_handle(q)
    with torch.cuda.device(q.device):
        code = lib.bigdl_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, t, d, int(bool(causal)),
            _DTYPE_CODES[q.dtype], stream)
    _cuda.check(code, "flash_attention_fwd")
    launches.add(str(q.dtype)[6:], stream, variant=_variant(causal))
    return out, lse


def _launch_plan(entry: str, *args) -> dict:
    nwg, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    code = getattr(_cuda.library().lib, entry)(
        *args, ctypes.byref(nwg), ctypes.byref(threads), ctypes.byref(smem))
    _cuda.check(code, entry)
    return {"warpgroups": nwg.value, "threads": threads.value,
            "smem_bytes": smem.value}


def forward_launch_plan(bh: int, t: int, d: int, dtype: torch.dtype) -> dict:
    """The launch the forward kernel makes for (bh, T, d) operands of
    ``dtype`` on the current device: consumer warpgroups (64 query rows
    each) a CTA, threads a CTA and dynamic shared memory bytes a CTA."""
    return _launch_plan("bigdl_flash_attn_fwd_plan", bh, t, d,
                        _DTYPE_CODES[dtype])


def backward_launch_plan(bh: int, t: int, d: int, dtype: torch.dtype,
                         dkv: bool) -> dict:
    """The launch the dq (``dkv=False``) or dk/dv kernel makes for
    (bh, T, d) operands of ``dtype`` on the current device, as
    :func:`forward_launch_plan` reports it (64 resident rows a
    warpgroup)."""
    return _launch_plan("bigdl_flash_attn_bwd_plan", bh, t, d,
                        _DTYPE_CODES[dtype], int(bool(dkv)))


def _check_stats(fn: str, q: torch.Tensor, *stats: torch.Tensor) -> None:
    bh, t, _ = q.shape
    for x in stats:
        if x.shape != (bh, t) or x.dtype != torch.float32 \
                or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"{fn}: lse and delta must be contiguous "
                             f"float32 of shape ({bh}, {t}) on {q.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def flash_attention_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, do: torch.Tensor,
                                lse: torch.Tensor, delta: torch.Tensor,
                                causal: bool = False) -> torch.Tensor:
    """Launch the dq kernel on (B·H, T, d) tensors with the forward's fp32
    ``lse`` and ``delta = rowsum(dO∘O)``, both (B·H, T). Returns dq."""
    _check_operands("flash_attention_bwd_dq_cuda", q, k, v, do)
    _check_stats("flash_attention_bwd_dq_cuda", q, lse, delta)
    bh, t, d = q.shape
    dq = torch.empty_like(q)
    lib = _cuda.library().lib
    stream = _cuda.stream_handle(q)
    with torch.cuda.device(q.device):
        code = lib.bigdl_flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, t, d,
            int(bool(causal)), _DTYPE_CODES[q.dtype], stream)
    _cuda.check(code, "flash_attention_bwd_dq")
    bwd_dq_launches.add(str(q.dtype)[6:], stream, variant=_variant(causal))
    return dq


def flash_attention_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor,
                                 lse: torch.Tensor, delta: torch.Tensor,
                                 causal: bool = False
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel on the operands of
    :func:`flash_attention_bwd_dq_cuda`. Returns ``(dk, dv)``."""
    _check_operands("flash_attention_bwd_dkv_cuda", q, k, v, do)
    _check_stats("flash_attention_bwd_dkv_cuda", q, lse, delta)
    bh, t, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _cuda.library().lib
    stream = _cuda.stream_handle(q)
    with torch.cuda.device(q.device):
        code = lib.bigdl_flash_attn_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, t, d, int(bool(causal)), _DTYPE_CODES[q.dtype], stream)
    _cuda.check(code, "flash_attention_bwd_dkv")
    bwd_dkv_launches.add(str(q.dtype)[6:], stream,
                         variant=_variant(causal))
    return dk, dv


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = False
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The backward on (B·H, T, d) tensors with the forward's O and fp32
    ``lse`` (B·H, T): computes ``delta = rowsum(dO∘O)`` with torch ops and
    launches the dq and dk/dv kernels. Returns ``(dq, dk, dv)``."""
    _check_operands("flash_attention_bwd_cuda", q, k, v, o, do)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B·H, T, d) attention → ``(O, lse)``: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B·H, T, d) backward → ``(dq, dk, dv)``: the kernels for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
    return flash_attention_bwd_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), o.contiguous(),
        lse.contiguous(), do.contiguous(), causal)


class FlashAttention(torch.autograd.Function):
    """Flash attention on (B·H, T, d) operands with the flash backward:
    saves q, k, v, O and lse, recomputes the probabilities in ``backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.to(q.dtype),
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Attention over (batch, heads, T, d) operands, the JAX function's
    layout; returns O in the same layout, differentiable through
    :class:`FlashAttention`."""
    b, h, t, d = q.shape
    out = FlashAttention.apply(q.reshape(b * h, t, d), k.reshape(b * h, t, d),
                               v.reshape(b * h, t, d), causal)
    return out.reshape(b, h, t, d)
