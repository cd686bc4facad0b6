"""Multi-head self-attention: fused or grouped-query projections, RoPE and
a sliding window.

Counterpart of ``bigdl_tpu/nn/attention.py`` ``MultiHeadAttention``, with
JAX's parameter layouts: with as many KV heads as query heads the fused
``qkv_weight`` (3E, E); with ``num_kv_heads < num_heads`` (grouped-query
attention; 1 is multi-query) ``q_weight`` (E, E) and ``kv_weight``
(2·kv·d, E); ``out_weight`` (E, E); biases beside them. KV head j serves
query heads j·g … j·g+g−1 (g = heads / kv heads), as ``jnp.repeat`` on the
head axis gives. ``rope=True`` rotates q and k by their positions
(:func:`rope_rotate`, split-half) before they are used or cached;
``window=W`` lets each position attend to the last W positions only.

Two paths:

- the full-sequence call applies RoPE, expands k and v over the query
  groups, and attends through ``_attend``: ``"auto"`` and ``"flash"`` take
  the flash kernel (``kernels.flash_attention``; the port has no
  sequence-parallel mesh yet, so "auto" is the single-device branch),
  ``"full"`` the plain ``full_attention``. A window takes the masked
  ``full_attention`` band, as in JAX;
- the KV-cached step (``state`` from ``install_decode_cache``) rotates the
  new positions by their absolute per-row positions, appends k and v at
  **kv-head** width at every row's own position, and attends through
  ``full_attention`` with a position (and window) mask, as JAX
  ``_decode_step`` does for per-slot caches. It writes into the passed
  cache tensors and advances the positions in place (copying a whole
  cache grid per token would dominate decode, and a captured decode
  program replays over the same tensors) and returns the same tensors.

LoRA (``_w``, ``add_lora``, ``merge_lora``; ROADMAP Queue A.5) and the
paged decode (Queue A.3.3) are not ported yet.
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


def rope_rotate(x: torch.Tensor, positions: torch.Tensor,
                base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding, split-half convention: ``x (..., t, d)``
    with each pair (x[i], x[i + d/2]) turned by ``pos / base^(i / (d/2))``.
    ``positions`` is (t,), or (b, t) per batch row with ``x`` (b, h, t, d)
    (the angles broadcast over heads). Angles and products in fp32, the
    result rounded once to ``x.dtype``, as JAX's promotion does."""
    half = x.shape[-1] // 2
    inv_freq = 1.0 / (base ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    ang = positions.float()[..., None] * inv_freq          # (..., t, half)
    if positions.dim() == 2:
        ang = ang[:, None]                  # (b, 1, t, half): over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


class MultiHeadAttention(TensorModule):
    """Self-attention over (batch, seq, embed) inputs."""

    def __init__(self, embed_dim: int, num_heads: int, causal: bool = False,
                 with_bias: bool = True, attention_impl: str = "auto",
                 w_init: Optional[InitializationMethod] = None,
                 num_kv_heads: Optional[int] = None, rope: bool = False,
                 rope_base: float = 10000.0, window: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(
                f"embed_dim {embed_dim} % num_heads {num_heads} != 0")
        if rope and (embed_dim // num_heads) % 2 != 0:
            raise ValueError("rope needs an even head_dim")
        if window is not None:
            if not causal:
                raise ValueError("window (sliding-window attention) requires "
                                 "causal=True")
            if int(window) < 1:
                raise ValueError(f"window must be >= 1, got {window!r}")
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of "
                             f"{ATTENTION_IMPLS}, got {attention_impl!r}")
        kv_heads = num_heads if num_kv_heads is None else int(num_kv_heads)
        if kv_heads < 1 or num_heads % kv_heads != 0:
            raise ValueError(f"num_kv_heads must be a positive divisor of "
                             f"num_heads {num_heads}, got {num_kv_heads!r}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.kv_heads = kv_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.attention_impl = attention_impl
        self.rope = bool(rope)
        self.rope_base = float(rope_base)
        self.window = None if window is None else int(window)
        w_init = w_init or Xavier()

        def param(*shape, fan_out):
            return torch.nn.Parameter(w_init.init(
                shape, fan_in=embed_dim, fan_out=fan_out,
                generator=generator))

        def bias(n):
            return torch.nn.Parameter(torch.zeros(n)) if with_bias else None

        e = embed_dim
        if kv_heads == num_heads:
            self.qkv_weight = param(3 * e, e, fan_out=3 * e)
            self.out_weight = param(e, e, fan_out=e)
            self.qkv_bias = bias(3 * e)
            self.out_bias = bias(e)
        else:
            kv = 2 * kv_heads * self.head_dim
            self.q_weight = param(e, e, fan_out=e)
            self.kv_weight = param(kv, e, fan_out=kv)
            self.out_weight = param(e, e, fan_out=e)
            self.q_bias = bias(e)
            self.kv_bias = bias(kv)
            self.out_bias = bias(e)

    def _expand_kv(self, x: torch.Tensor) -> torch.Tensor:
        """(b, kv_heads, t, d) → (b, num_heads, t, d), each KV head over its
        query group (``jnp.repeat`` order; its backward sums the group)."""
        if self.kv_heads == self.num_heads:
            return x
        b, kv, t, d = x.shape
        g = self.num_heads // kv
        return x[:, :, None].expand(b, kv, g, t, d).reshape(
            b, self.num_heads, t, d)

    def _project_qkv(self, input):
        """q (b, h, t, d); k and v (b, kv_heads, t, d)."""
        b, t, _ = input.shape
        h, d = self.num_heads, self.head_dim
        if self.kv_heads == self.num_heads:
            qkv = F.linear(input, self.qkv_weight, self.qkv_bias)
            qkv = qkv.reshape(b, t, 3, h, d)
            return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))
        q = F.linear(input, self.q_weight, self.q_bias)
        kv = F.linear(input, self.kv_weight, self.kv_bias)
        q = q.reshape(b, t, h, d).transpose(1, 2)
        kv = kv.reshape(b, t, 2, self.kv_heads, d)
        return (q, kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2))

    def _attend(self, q, k, v):
        if self.attention_impl == "full":
            return full_attention(q, k, v, causal=self.causal)
        return flash_attention(q, k, v, self.causal)

    def run(self, input, state=None):
        b, t, e = input.shape
        q, k, v = self._project_qkv(input)
        if state is not None and "cache_k" in state:
            o, state = self._decode_step(state, q, k, v)
        else:
            if self.rope:
                pos = torch.arange(t, device=input.device)
                q = rope_rotate(q, pos, self.rope_base)
                k = rope_rotate(k, pos, self.rope_base)
            k, v = self._expand_kv(k), self._expand_kv(v)
            if self.window is not None:
                i = torch.arange(t, device=input.device)
                diff = i[:, None] - i[None, :]
                band = (diff >= 0) & (diff < self.window)
                o = full_attention(q, k, v, causal=False, kv_mask=band)
            else:
                o = self._attend(q, k, v)
        o = o.transpose(1, 2).reshape(b, t, e)
        return F.linear(o, self.out_weight, self.out_bias), state

    def _decode_step(self, state, q, k, v):
        """Append k/v at each row's ``pos`` (a (b,) vector: every cache row
        sits at its own depth) and attend each query to the cached prefix
        up to its own position (and within the window). ``t > 1`` is the
        chunked prefill the serving engine absorbs a prompt with. The write
        start clamps to ``max_len - t`` like JAX's ``dynamic_update_slice``,
        so an idle row whose position ran past the end stays in bounds."""
        pos = state["pos"]
        ck, cv = state["cache_k"], state["cache_v"]
        b, _, t, _ = q.shape
        lmax = ck.shape[2]
        steps = torch.arange(t, device=pos.device)
        qpos = pos[:, None] + steps[None, :]                        # (b, t)
        if self.rope:
            q = rope_rotate(q, qpos, self.rope_base)
            k = rope_rotate(k, qpos, self.rope_base)
        rows = torch.arange(b, device=pos.device)[:, None]
        cols = pos.clamp(0, lmax - t)[:, None] + steps[None, :]    # (b, t)
        ck[rows, :, cols] = k.transpose(1, 2).to(ck.dtype)         # in place
        cv[rows, :, cols] = v.transpose(1, 2).to(cv.dtype)
        kpos = torch.arange(lmax, device=pos.device)
        kv_mask = kpos[None, None, :] <= qpos[:, :, None]           # b, t, L
        if self.window is not None:
            kv_mask &= kpos[None, None, :] > qpos[:, :, None] - self.window
        o = full_attention(q, self._expand_kv(ck), self._expand_kv(cv),
                           causal=False, kv_mask=kv_mask[:, None])
        return o, {"cache_k": ck, "cache_v": cv, "pos": pos.add_(t)}

    def extra_repr(self):
        gqa = (f", kv_heads={self.kv_heads}"
               if self.kv_heads != self.num_heads else "")
        return (f"embed={self.embed_dim}, heads={self.num_heads}{gqa}, "
                f"causal={self.causal}, impl={self.attention_impl}"
                + (", rope" if self.rope else "")
                + (f", window={self.window}" if self.window else ""))
