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
  groups, and attends through ``_attend`` (``bigdl_tpu/nn/attention.py:
  235-253``): ``"auto"`` takes ``parallel.ring_attention`` when the Engine
  mesh is up with a ``seq`` axis, else the flash kernel
  (``kernels.flash_attention``, which raises on the card for a head dim
  other than 32, 64 or 128), as ``"flash"`` always does; ``"ring"``
  needs such a mesh (the ring over a ``seq`` axis of size 1 is
  ``full_attention``, as in JAX); ``"full"`` the plain ``full_attention``.
  A window takes the masked ``full_attention`` band, as in JAX, and
  refuses ``"ring"``;
- the KV-cached step (``state`` from ``install_decode_cache``) rotates the
  new positions by their absolute per-row positions, appends k and v at
  **kv-head** width at every row's own position, and attends through
  ``full_attention`` with a position (and window) mask, as JAX
  ``_decode_step`` does for per-slot caches. It writes into the passed
  cache tensors and advances the positions in place (copying a whole
  cache grid per token would dominate decode, and a captured decode
  program replays over the same tensors) and returns the same tensors;
- the paged step (``state`` from ``serving/paged_cache.py``
  ``install_paged_cache``) writes k and v through the page table and
  gathers the pool back into the slot grid's view, then attends as the
  per-slot step does (:meth:`MultiHeadAttention._paged_decode_step`).

LoRA: ``lora_rank`` in the constructor or :meth:`MultiHeadAttention.add_lora`
gives every projection weight (``qkv_weight`` or ``q_weight``/``kv_weight``,
and ``out_weight``) a rank-r adapter under JAX's keys
``lora_<weight>_a`` (r, in) and ``lora_<weight>_b`` (out, r); every path
(full forward, per-slot and paged decode) projects with the effective
weight ``base + B·A·α/r`` (:meth:`MultiHeadAttention._w`), formed in the
parameters' dtype as JAX forms it, and ``grad_scales`` freezes the bases.
:meth:`MultiHeadAttention.merge_lora` bakes the adapters in.

:class:`CrossAttention` is the encoder-decoder attention of the seq2seq
Transformer: queries from the first element of its input ``Table``, keys
and values from the second (the memory), through the plain
``full_attention`` as in JAX (the query and key lengths differ, which the
flash kernel does not take).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.kernels import flash_attention
from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.initialization import (
    InitializationMethod, RandomNormal, Xavier,
)
from bigdl_tpu_torch.parallel.ring_attention import full_attention
from bigdl_tpu_torch.utils.table import Table

ATTENTION_IMPLS = ("auto", "ring", "flash", "full")


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
                 lora_rank: Optional[int] = None,
                 lora_alpha: Optional[float] = None,
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
            if attention_impl == "ring":
                raise ValueError(
                    "window is served by the masked single-device path; "
                    "it cannot honor attention_impl='ring' (sequence-"
                    "parallel banded attention is not implemented)")
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
        if lora_rank is not None and int(lora_rank) < 1:
            raise ValueError(f"lora_rank must be >= 1, got {lora_rank!r}")
        self.lora_rank = None
        self.lora_alpha = None
        self.w_init = w_init or Xavier()

        def bias(n):
            return torch.nn.Parameter(torch.zeros(n)) if with_bias else None

        e = embed_dim
        if kv_heads == num_heads:
            self.qkv_weight = torch.nn.Parameter(torch.empty(3 * e, e))
            self.out_weight = torch.nn.Parameter(torch.empty(e, e))
            self.qkv_bias = bias(3 * e)
            self.out_bias = bias(e)
        else:
            kv = 2 * kv_heads * self.head_dim
            self.q_weight = torch.nn.Parameter(torch.empty(e, e))
            self.kv_weight = torch.nn.Parameter(torch.empty(kv, e))
            self.out_weight = torch.nn.Parameter(torch.empty(e, e))
            self.q_bias = bias(e)
            self.kv_bias = bias(kv)
            self.out_bias = bias(e)
        self.reset(generator)
        if lora_rank is not None:
            self.add_lora(lora_rank, lora_alpha, generator=generator)

    def _weight_names(self) -> list:
        """The projection weights, in JAX's parameter order."""
        return [n for n in ("qkv_weight", "q_weight", "kv_weight",
                            "out_weight") if n in self._parameters]

    def reset(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw the projection weights anew (``w_init``, fan-in the embed
        width) and zero the biases, in place. Adapters survive: they are
        drawn anew too (``A`` seeded, ``B`` zero), as JAX's reset keeps
        them."""
        e = self.embed_dim
        with torch.no_grad():
            for name in self._weight_names():
                w = getattr(self, name)
                w.copy_(self.w_init.init(tuple(w.shape), fan_in=e,
                                         fan_out=w.shape[0],
                                         generator=generator))
            for name, p in self.named_parameters(recurse=False):
                if "bias" in name:
                    p.zero_()
        if self.lora_rank:
            self._extend_lora_params(generator)

    # ----------------------------------------------------------------- LoRA
    def _extend_lora_params(self, generator=None) -> None:
        """Adapters for every projection weight: ``A`` N(0, 0.02), ``B``
        zero, on the weights' device and in their dtype."""
        r = self.lora_rank
        for name in self._weight_names():
            w = getattr(self, name)
            out_d, in_d = w.shape
            a = RandomNormal(0.0, 0.02).init((r, in_d), fan_in=in_d,
                                             fan_out=r, generator=generator)
            setattr(self, f"lora_{name}_a", torch.nn.Parameter(
                a.to(device=w.device, dtype=w.dtype)))
            setattr(self, f"lora_{name}_b", torch.nn.Parameter(torch.zeros(
                out_d, r, device=w.device, dtype=w.dtype)))

    def add_lora(self, rank: int, alpha: Optional[float] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> "MultiHeadAttention":
        """Attach rank-``rank`` adapters to every projection; the base
        weights and biases freeze (grad scale 0), only the adapters
        train."""
        if self.lora_rank:
            raise ValueError("attention already has LoRA adapters")
        if int(rank) < 1:
            raise ValueError(f"rank must be >= 1, got {rank!r}")
        self.lora_rank = int(rank)
        self.lora_alpha = float(alpha) if alpha is not None else float(rank)
        self._extend_lora_params(generator)
        return self

    def merge_lora(self) -> "MultiHeadAttention":
        """Bake the adapters into the base projections and drop them."""
        if not self.lora_rank:
            raise ValueError("attention has no LoRA adapters to merge")
        with torch.no_grad():
            for name in self._weight_names():
                getattr(self, name).copy_(self._w(name))
        for name in self._weight_names():
            delattr(self, f"lora_{name}_a")
            delattr(self, f"lora_{name}_b")
        self.lora_rank = self.lora_alpha = None
        return self

    def grad_scales(self) -> dict:
        if self.lora_rank and not self._frozen:
            return {k: self.scale_w if k.startswith("lora_") else 0.0
                    for k, _ in self.named_parameters(recurse=False)}
        return super().grad_scales()

    def _w(self, name: str) -> torch.Tensor:
        """The effective projection weight: the base, or under LoRA
        ``base + B·A·α/r`` in the parameters' dtype (JAX's order)."""
        w = getattr(self, name)
        if self.lora_rank:
            w = w + (getattr(self, f"lora_{name}_b")
                     @ getattr(self, f"lora_{name}_a")
                     * (self.lora_alpha / self.lora_rank))
        return w

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
            qkv = F.linear(input, self._w("qkv_weight"), self.qkv_bias)
            qkv = qkv.reshape(b, t, 3, h, d)
            return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))
        q = F.linear(input, self._w("q_weight"), self.q_bias)
        kv = F.linear(input, self._w("kv_weight"), self.kv_bias)
        q = q.reshape(b, t, h, d).transpose(1, 2)
        kv = kv.reshape(b, t, 2, self.kv_heads, d)
        return (q, kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2))

    def _attend(self, q, k, v):
        impl = self.attention_impl
        if impl == "full":
            return full_attention(q, k, v, causal=self.causal)
        if impl in ("auto", "ring"):
            from bigdl_tpu_torch.utils.engine import Engine
            mesh = Engine.mesh_if_up()
            if mesh is not None and Engine.SEQ_AXIS in mesh.axis_names:
                from bigdl_tpu_torch.parallel.ring_attention import (
                    ring_attention,
                )
                return ring_attention(q, k, v, mesh=mesh,
                                      seq_axis=Engine.SEQ_AXIS,
                                      causal=self.causal)
            if impl == "ring":
                raise RuntimeError(
                    "attention_impl='ring' needs an Engine mesh with a "
                    f"'{Engine.SEQ_AXIS}' axis")
        return flash_attention(q, k, v, self.causal)

    def run(self, input, state=None):
        b, t, e = input.shape
        q, k, v = self._project_qkv(input)
        if state is not None and "cache_k" in state:
            o, state = self._decode_step(state, q, k, v)
        elif state is not None and "page_k" in state:
            o, state = self._paged_decode_step(state, q, k, v)
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
        return F.linear(o, self._w("out_weight"), self.out_bias), state

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
        o = self._attend_cached(q, ck, cv, qpos)
        return o, {"cache_k": ck, "cache_v": cv, "pos": pos.add_(t)}

    def _attend_cached(self, q, ck, cv, qpos):
        """Queries at absolute positions ``qpos`` (b, t) against a cache
        view (b, kv_heads, L, d): each sees the positions up to its own
        (and within the window); the rest weigh exactly 0."""
        kpos = torch.arange(ck.shape[2], device=qpos.device)
        kv_mask = kpos[None, None, :] <= qpos[:, :, None]           # b, t, L
        if self.window is not None:
            kv_mask &= kpos[None, None, :] > qpos[:, :, None] - self.window
        return full_attention(q, self._expand_kv(ck), self._expand_kv(cv),
                              causal=False, kv_mask=kv_mask[:, None])

    def _paged_decode_step(self, state, q, k, v):
        """The cached step over a page pool (``serving/paged_cache.py``):
        write k and v THROUGH the page table (physical page
        ``table[row, pos // P]``, offset ``pos % P``), then gather the pool
        back into the slot grid's ``(b, kv_heads, max_len, d)`` view, a
        static-shape gather by page index, and attend as
        :meth:`_decode_step` does, so the tokens are the slot grid's.
        ``t > 1`` is speculative decoding's verify chunk, written with one
        vectorised (b, t) scatter whose start clamps to ``max_len - t`` like
        the slot grid's. Free rows' table rows point at the trash page, so
        their writes land where nobody attends (several rows may write the
        same trash offset; which write lands is not fixed, and no one reads
        it); a row whose position ran past the window writes through its
        last table entry, trash again."""
        pos = state["pos"]
        table = state["page_table"]                             # (b, W)
        pk, pv = state["page_k"], state["page_v"]
        b, _, t, _ = q.shape
        ptok, w = pk.shape[2], table.shape[1]
        lmax = w * ptok
        steps = torch.arange(t, device=pos.device)
        qpos = pos[:, None] + steps[None, :]                        # (b, t)
        if self.rope:
            q = rope_rotate(q, qpos, self.rope_base)
            k = rope_rotate(k, qpos, self.rope_base)
        if t == 1:
            wpos = pos[:, None]
            lp = (wpos // ptok).clamp(0, w - 1)
        else:
            wpos = pos.clamp(0, lmax - t)[:, None] + steps[None, :]
            lp = wpos // ptok
        phys = table.gather(1, lp)                                  # (b, t)
        off = wpos % ptok
        pk[phys, :, off] = k.transpose(1, 2).to(pk.dtype)           # in place
        pv[phys, :, off] = v.transpose(1, 2).to(pv.dtype)
        # (b, W, kv, P, d) -> the slot grid's (b, kv, W·P, d)
        ck = pk[table].transpose(1, 2).reshape(b, pk.shape[1], lmax, -1)
        cv = pv[table].transpose(1, 2).reshape(b, pv.shape[1], lmax, -1)
        o = self._attend_cached(q, ck, cv, qpos)
        return o, {"page_k": pk, "page_v": pv, "page_table": table,
                   "pos": pos.add_(t)}

    def extra_repr(self):
        gqa = (f", kv_heads={self.kv_heads}"
               if self.kv_heads != self.num_heads else "")
        return (f"embed={self.embed_dim}, heads={self.num_heads}{gqa}, "
                f"causal={self.causal}, impl={self.attention_impl}"
                + (", rope" if self.rope else "")
                + (f", window={self.window}" if self.window else "")
                + (f", lora_rank={self.lora_rank}" if self.lora_rank else ""))


class CrossAttention(TensorModule):
    """Encoder-decoder attention: ``T(x, memory)`` with x (N, Tq, E) and
    memory (N, Tk, E) → (N, Tq, E). ``q_weight`` (E, E), ``kv_weight``
    (2E, E), ``out_weight`` (E, E) and their biases, JAX's layout; never
    causal, through the plain ``full_attention``."""

    def __init__(self, embed_dim: int, num_heads: int, with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError(
                f"embed_dim {embed_dim} % num_heads {num_heads} != 0")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        w_init = w_init or Xavier()
        e = embed_dim

        def param(rows):
            return torch.nn.Parameter(w_init.init(
                (rows, e), fan_in=e, fan_out=rows, generator=generator))

        self.q_weight = param(e)
        self.kv_weight = param(2 * e)
        self.out_weight = param(e)
        zeros = (lambda n: torch.nn.Parameter(torch.zeros(n))
                 if with_bias else None)
        self.q_bias = zeros(e)
        self.kv_bias = zeros(2 * e)
        self.out_bias = zeros(e)

    def run(self, input, state=None):
        x, memory = (input[1], input[2]) if isinstance(input, Table) \
            else tuple(input)
        b, tq, e = x.shape
        tk = memory.shape[1]
        h, d = self.num_heads, self.head_dim
        q = F.linear(x, self.q_weight, self.q_bias)
        kv = F.linear(memory, self.kv_weight, self.kv_bias)
        q = q.reshape(b, tq, h, d).transpose(1, 2)
        kv = kv.reshape(b, tk, 2, h, d)
        k, v = (kv[:, :, i].transpose(1, 2) for i in range(2))
        o = full_attention(q, k, v, causal=False)
        o = o.transpose(1, 2).reshape(b, tq, e)
        return F.linear(o, self.out_weight, self.out_bias), state

    def extra_repr(self):
        return f"embed={self.embed_dim}, heads={self.num_heads}"
