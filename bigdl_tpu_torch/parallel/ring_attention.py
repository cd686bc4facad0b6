"""Single-device reference attention.

Counterpart of ``bigdl_tpu/parallel/ring_attention.py:114``
``full_attention``, in plain PyTorch (the JAX package leaves it to XLA,
outside any Pallas kernel). The sequence-parallel ``ring_attention`` of
that module is not ported yet. Masked scores take the finite constant
``-1e30``, not ``-inf``, so a fully masked row stays finite.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over (b, h, t, d) operands with an fp32 softmax.

    The two products run on fp32 copies of the operands (for bf16 inputs
    the same products the JAX contract computes with fp32 accumulation).
    ``kv_mask`` is a boolean mask broadcastable to the (b, h, q, k) scores;
    False positions are excluded (the KV-cached decode masks the unwritten
    cache tail with it). Returns the input dtype.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        keep = (torch.arange(t_q, device=s.device)[:, None]
                >= torch.arange(t_k, device=s.device)[None, :])
        s = s.masked_fill(~keep, _NEG_INF)
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)
