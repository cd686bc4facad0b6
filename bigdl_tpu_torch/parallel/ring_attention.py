"""Attention outside any kernel: ``full_attention`` and the
sequence-parallel ``ring_attention``.

Counterpart of ``bigdl_tpu/parallel/ring_attention.py``. ``full_attention``
(``:114``) is the single-device reference, in plain PyTorch; masked scores
take the finite constant ``-1e30``, not ``-inf``, so a fully masked row
stays finite.

``ring_attention`` (``:35-105``): on a mesh with a ``seq`` axis wider than
one, each rank of a ``seq`` slice keeps its block of the queries and
streams every block of keys and values past them around the ring, with
JAX's streaming-softmax accumulators (running max, normaliser,
unnormalised output) in fp32 and causal masking on global positions. JAX
shards the global arrays into ``shard_map``; a port rank holds its data
block of the batch with the whole sequence (the model around the
attention runs alike on every rank of the slice), so the function takes
the rank's block of queries, runs the ring, and gathers the output's
blocks back. The blocks move by ``batch_isend_irecv``
(``collectives.ring_shift``). Autograd does not differentiate through
point-to-point ops, so the backward is written out
(:class:`_RingAttention`): from the forward's log-sum-exp, each rank
recomputes every block's probabilities for its queries, accumulates its
``dq``, and sends each block's ``dk``/``dv`` partials around the ring
with the block until they are home; the input gradients are gathered
back as the output was. With no ``seq`` axis, or one of size 1, the
result is ``full_attention``, as in JAX. The ring's body is plain torch
(fp32 products), not the flash kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.parallel import collectives as C

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


def _scores(q, k, src, me, t, scale, causal):
    s = (q @ k.transpose(-1, -2)) * scale
    if causal:
        qp = me * t + torch.arange(t, device=q.device)
        kp = src * t + torch.arange(t, device=q.device)
        s = s.masked_fill(~(qp[:, None] >= kp[None, :]), _NEG_INF)
    return s


class _RingAttention(torch.autograd.Function):
    """(full q, k, v of this rank's batch block) -> full output; the ring
    runs over this rank's sequence block."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, me = C.size(group), C.index(group)
        dtype = q.dtype
        ql, kl, vl = (x.chunk(n, 2)[me].float().contiguous()
                      for x in (q, k, v))
        t = ql.shape[2]
        o = torch.zeros_like(ql)
        l = torch.zeros(ql.shape[:-1], device=ql.device)
        m = torch.full(ql.shape[:-1], _NEG_INF, device=ql.device)
        kb, vb = kl, vl
        for i in range(n):
            src = (me - i) % n
            s = _scores(ql, kb, src, me, t, scale, causal)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + p @ vb
            m = m_new
            if i < n - 1:
                kb, vb = C.ring_shift([kb, vb], group)
        l = l.clamp(min=1e-30)
        out = o / l[..., None]
        lse = m + torch.log(l)
        ctx.save_for_backward(ql, kl, vl, out, lse)
        ctx.group, ctx.causal, ctx.scale, ctx.dtype = group, causal, scale, \
            dtype
        return C.all_gather_cat(out.to(dtype), group, 2)

    @staticmethod
    def backward(ctx, dout):
        ql, kl, vl, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, me = C.size(group), C.index(group)
        t = ql.shape[2]
        do = dout.chunk(n, 2)[me].float()
        delta = (do * out).sum(-1)
        dq = torch.zeros_like(ql)
        kb, vb = kl, vl
        dkb, dvb = torch.zeros_like(kl), torch.zeros_like(vl)
        for i in range(n):
            src = (me - i) % n
            s = _scores(ql, kb, src, me, t, scale, causal)
            p = torch.exp(s - lse[..., None])
            dvb = dvb + p.transpose(-1, -2) @ do
            dp = do @ vb.transpose(-1, -2)
            ds = p * (dp - delta[..., None])
            dq = dq + (ds @ kb) * scale
            dkb = dkb + (ds.transpose(-1, -2) @ ql) * scale
            # the block and its partials move on; after n moves they are home
            kb, vb, dkb, dvb = C.ring_shift([kb, vb, dkb, dvb], group)
        grads = [C.all_gather_cat(g.to(ctx.dtype), group, 2)
                 for g in (dq, dkb, dvb)]
        return (*grads, None, None, None)


def ring_attention(q, k, v, mesh=None, seq_axis: str = "seq",
                   causal: bool = False, scale: Optional[float] = None):
    """Global attention over (batch, heads, seq, head_dim) operands with
    the sequence split over ``mesh``'s ``seq_axis`` (default: the Engine
    mesh); ``full_attention`` when the mesh has no such axis or it has
    size 1. The output has the inputs' shape."""
    if mesh is None:
        from bigdl_tpu_torch.utils.engine import Engine
        mesh = Engine.mesh()
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    n = dict(mesh.shape).get(seq_axis, 1)
    if n == 1:
        return full_attention(q, k, v, causal=causal, scale=scale)
    if q.shape[2] % n != 0:
        raise ValueError(
            f"sequence length {q.shape[2]} not divisible by seq-parallel size "
            f"{n}")
    return _RingAttention.apply(q, k, v, mesh.group(seq_axis), causal, scale)
