"""Multi-head self-attention with fused QKV projections.

Counterpart of ``bigdl_tpu/nn/attention.py`` ``MultiHeadAttention`` in its
fused-QKV layout (``qkv_weight`` (3E, E), ``out_weight`` (E, E), biases),
with two paths:

- the full-sequence call attends through ``_attend``: ``"auto"`` and
  ``"flash"`` take the flash kernel (``kernels.flash_attention``; the port
  has no sequence-parallel mesh yet, so "auto" is the single-device
  branch), ``"full"`` the plain ``full_attention``;
- the KV-cached step (``state`` from ``install_decode_cache``) appends the
  new keys and values at every row's own position and attends through
  ``full_attention`` with a position mask, as JAX ``_decode_step`` does
  for per-slot caches. It writes into the passed cache tensors and
  advances the positions in place (copying a whole cache grid per token
  would dominate decode, and a captured decode program replays over the
  same tensors) and returns the same tensors.

Grouped-query heads, RoPE, sliding windows, LoRA and the paged decode are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.kernels import flash_attention
from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.initialization import InitializationMethod, Xavier
from bigdl_tpu_torch.parallel.ring_attention import full_attention

ATTENTION_IMPLS = ("auto", "flash", "full")


class MultiHeadAttention(TensorModule):
    """Self-attention over (batch, seq, embed) inputs."""

    def __init__(self, embed_dim: int, num_heads: int, causal: bool = False,
                 with_bias: bool = True, attention_impl: str = "auto",
                 w_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(
                f"embed_dim {embed_dim} % num_heads {num_heads} != 0")
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of "
                             f"{ATTENTION_IMPLS}, got {attention_impl!r}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.attention_impl = attention_impl
        w_init = w_init or Xavier()
        e = embed_dim
        self.qkv_weight = torch.nn.Parameter(w_init.init(
            (3 * e, e), fan_in=e, fan_out=3 * e, generator=generator))
        self.out_weight = torch.nn.Parameter(w_init.init(
            (e, e), fan_in=e, fan_out=e, generator=generator))
        self.qkv_bias = (torch.nn.Parameter(torch.zeros(3 * e))
                         if with_bias else None)
        self.out_bias = torch.nn.Parameter(torch.zeros(e)) if with_bias \
            else None

    def _attend(self, q, k, v):
        if self.attention_impl == "full":
            return full_attention(q, k, v, causal=self.causal)
        return flash_attention(q, k, v, self.causal)

    def run(self, input, state=None):
        b, t, e = input.shape
        qkv = F.linear(input, self.qkv_weight, self.qkv_bias)
        qkv = qkv.reshape(b, t, 3, self.num_heads, self.head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (b,h,t,d)
        if state is not None and "cache_k" in state:
            o, state = self._decode_step(state, q, k, v)
        else:
            o = self._attend(q, k, v)
        o = o.transpose(1, 2).reshape(b, t, e)
        return F.linear(o, self.out_weight, self.out_bias), state

    def _decode_step(self, state, q, k, v):
        """Append k/v at each row's ``pos`` (a (b,) vector: every cache row
        sits at its own depth) and attend each query to the cached prefix
        up to its own position. ``t > 1`` is the chunked prefill the serving
        engine absorbs a prompt with. The write start clamps to
        ``max_len - t`` like JAX's ``dynamic_update_slice``, so an idle row
        whose position ran past the end stays in bounds."""
        pos = state["pos"]
        ck, cv = state["cache_k"], state["cache_v"]
        b, _, t, _ = q.shape
        lmax = ck.shape[2]
        steps = torch.arange(t, device=pos.device)
        rows = torch.arange(b, device=pos.device)[:, None]
        cols = pos.clamp(0, lmax - t)[:, None] + steps[None, :]    # (b, t)
        ck[rows, :, cols] = k.transpose(1, 2).to(ck.dtype)         # in place
        cv[rows, :, cols] = v.transpose(1, 2).to(cv.dtype)
        qpos = pos[:, None] + steps[None, :]                        # (b, t)
        kpos = torch.arange(lmax, device=pos.device)
        kv_mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]  # b,1,t,L
        o = full_attention(q, ck, cv, causal=False, kv_mask=kv_mask)
        return o, {"cache_k": ck, "cache_v": cv, "pos": pos.add_(t)}

    def extra_repr(self):
        return (f"embed={self.embed_dim}, heads={self.num_heads}, "
                f"causal={self.causal}, impl={self.attention_impl}")
