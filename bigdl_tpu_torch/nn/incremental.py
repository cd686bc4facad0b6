"""KV-cached incremental decoding.

Counterpart of ``bigdl_tpu/nn/incremental.py``. The cache is explicit
state, as ``apply(params, state, ...)`` carries it in JAX:
:func:`install_decode_cache` returns a nested dict keyed like the module
tree, holding zeroed (B, kv_heads, max_len, head_dim) K/V buffers
(grouped-query attention caches its KV heads only) and a per-row position
vector for every ``MultiHeadAttention`` and a position index for every
``PositionEmbedding`` (a rope model has none); ``model.run(tokens, state)``
consumes it and returns the advanced state. Nothing is stored on the
modules, so there is no cache to clear afterwards. The decode paths
(:func:`generate`, :func:`beam_generate`) run the model in eval mode, as
JAX passes ``training=False``.

Positions are always per row ((B,) vectors, JAX's ``per_slot=True``): each
row sits at its own depth, which lets a serving engine reset or reassign
one row while the others keep decoding. The cache tensors and positions
are updated in place by the cached step and by the slot primitives below,
so a state dict keeps its tensor objects from one call to the next: a
captured decode or prefill program (``serving/engine.py``) replays over
the same buffers.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from bigdl_tpu_torch.nn.abstractnn import evaluating
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.utils.device import require_on

#: per-row K/V buffers and the position counters (the JAX key names)
_CACHE_ROW_KEYS = ("cache_k", "cache_v")
_CACHE_POS_KEYS = ("pos", "pos_idx")


def _set_path(tree: dict, path: str, leaf: dict) -> None:
    if not path:   # the model itself is the cached module
        tree.update(leaf)
        return
    node = tree
    for part in path.split(".")[:-1]:
        node = node.setdefault(part, {})
    node[path.split(".")[-1]] = leaf


def _map_leaves(fn: Callable, *trees):
    """Call ``fn(key, *leaves)`` on the tensors of parallel nested dicts."""
    first = trees[0]
    for key, node in first.items():
        others = [t[key] for t in trees[1:]]
        if isinstance(node, dict):
            _map_leaves(fn, node, *others)
        else:
            fn(key, node, *others)


def install_decode_cache(model: torch.nn.Module, batch_size: int,
                         max_len: int, dtype: torch.dtype = torch.float32
                         ) -> dict:
    """Zeroed decode state for ``model``: ``batch_size`` cache rows of
    ``max_len`` positions each, on the model's device."""
    from bigdl_tpu_torch.models.transformerlm.transformerlm import (
        PositionEmbedding,
    )

    mods = list(model.named_modules())
    attns = [(p, m) for p, m in mods if isinstance(m, MultiHeadAttention)]
    if not attns:
        raise ValueError("model has no MultiHeadAttention modules to cache")
    for _, m in attns:
        if not m.causal:
            raise ValueError(
                f"decode cache requires causal attention ({m!r} is "
                f"bidirectional and cannot decode incrementally)")
    for _, m in mods:
        if isinstance(m, PositionEmbedding) and max_len > m.max_len:
            raise ValueError(
                f"decode length {max_len} exceeds the model's position "
                f"table (max_len={m.max_len})")
    dev = next(model.parameters()).device
    state: dict = {}
    for path, m in attns:
        shape = (batch_size, m.kv_heads, max_len, m.head_dim)
        _set_path(state, path, {
            "cache_k": torch.zeros(shape, dtype=dtype, device=dev),
            "cache_v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros(batch_size, dtype=torch.long, device=dev),
        })
    for path, m in mods:
        if isinstance(m, PositionEmbedding):
            _set_path(state, path, {"pos_idx": torch.zeros(
                batch_size, dtype=torch.long, device=dev)})
    return state


def reset_decode_slot(state: dict, slot: int) -> dict:
    """Wipe cache row ``slot`` in place: K/V zeroed, positions 0."""
    def wipe(key, leaf):
        if key in _CACHE_ROW_KEYS:
            leaf[slot].zero_()
        elif key in _CACHE_POS_KEYS:
            leaf[slot] = 0

    _map_leaves(wipe, state)
    return state


def zero_decode_cache(state: dict) -> dict:
    """Zero every leaf of ``state`` in place: all rows empty, positions 0,
    as :func:`install_decode_cache` made them."""
    _map_leaves(lambda key, leaf: leaf.zero_(), state)
    return state


def _row_index(v, device) -> torch.Tensor:
    """A slot or position as a (1,) long tensor on ``device``: a Python
    int, or a tensor of one element already there (a captured program's
    input; converting one would copy from the host)."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1 or v.device != device:
            raise ValueError(f"expected one index on {device}, got "
                             f"{tuple(v.shape)} on {v.device}")
        return v.reshape(1).long()
    return torch.tensor([int(v)], dtype=torch.long, device=device)


def assign_cache_slot(dst_state: dict, src_state: dict, slot,
                      pos=None) -> dict:
    """Copy a batch-1 cache (``src_state``, typically a just-prefilled
    prompt) into row ``slot`` of ``dst_state`` in place. The whole row is
    replaced, so nothing of the slot's previous occupant survives. The
    positions take the source's value unless ``pos`` overrides them: a
    prompt prefilled right-padded to a bucket length sits at its true
    length, and the pad positions beyond it are never attended. ``slot``
    and ``pos`` are ints or one-element long tensors on the cache's device,
    so one captured program serves every slot (JAX's traced ``slot`` and
    ``pos``)."""
    leaves = []
    _map_leaves(lambda key, leaf: leaves.append(leaf), dst_state)
    dev = leaves[0].device
    row = _row_index(slot, dev)
    at = None if pos is None else _row_index(pos, dev)

    def copy(key, d, s):
        if key in _CACHE_ROW_KEYS:
            if s.shape[0] != 1:
                raise ValueError(f"assign_cache_slot source must be a "
                                 f"batch-1 cache, got leading dim "
                                 f"{s.shape[0]} for {key}")
            if s.shape[1:] != d.shape[1:]:
                raise ValueError(
                    f"cache row shape mismatch for {key}: source "
                    f"{tuple(s.shape[1:])} vs destination "
                    f"{tuple(d.shape[1:])}")
            d.index_copy_(0, row, s)
        elif key in _CACHE_POS_KEYS:
            d.index_copy_(0, row, s.reshape(1) if at is None else at)

    _map_leaves(copy, dst_state, src_state)
    return dst_state


def greedy_generate(model: torch.nn.Module, prompt, decode_length: int,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> torch.Tensor:
    """KV-cached greedy decode: ``prompt`` (N, T0) → (N, T0 + decode_length)
    int32 tokens. One position per step, the prompt included, as the JAX
    ``lax.scan`` does. ``device`` defaults to ``"cuda"`` and must hold the
    model."""
    return generate(model, prompt, decode_length, dtype, device=device)


def generate(model: torch.nn.Module, prompt, decode_length: int,
             dtype: torch.dtype = torch.float32, *, sample: bool = False,
             temperature: float = 1.0, top_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
    """KV-cached decode, greedy or (``sample``) drawn from
    ``softmax(logits / temperature)`` restricted to the ``top_k`` most
    probable tokens when given, with ``generator`` (on the model's device;
    its default generator when None). The model runs in eval mode.
    ``prompt`` (N, T0) → (N, T0 + decode_length) int32 tokens."""
    if sample and top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k!r}")
    dev = require_on(model, device)
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(dev)
    n, t0 = prompt.shape
    total = t0 + decode_length

    def pick(logits):
        if not sample:
            return logits.argmax(-1)
        logits = logits.float() / max(temperature, 1e-6)
        if top_k is not None:
            kth = logits.topk(top_k, dim=-1).values[:, -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
        return torch.multinomial(torch.softmax(logits, -1), 1,
                                 generator=generator)[:, 0]

    with torch.no_grad(), evaluating(model):
        state = install_decode_cache(model, n, total, dtype)
        seqs = torch.zeros((n, total), dtype=torch.long, device=dev)
        seqs[:, :t0] = prompt
        tok = prompt[:, 0]
        for i in range(total - 1):
            logp, state = model.run(tok[:, None], state)
            tok = prompt[:, i + 1] if i + 1 < t0 else pick(logp[:, 0])
            seqs[:, i + 1] = tok
    return seqs.to(torch.int32)


def beam_generate(model: torch.nn.Module, prompt, decode_length: int,
                  beam_size: int, eos_id: int = -1, alpha: float = 0.0,
                  pad_id: int = 0, dtype: torch.dtype = torch.float32,
                  device=None) -> tuple:
    """KV-cached beam search, the O(L)-a-token form of
    :class:`~bigdl_tpu_torch.nn.beam_search.SequenceBeamSearch`: beams ride
    the batch axis (N·beam cache rows), the prompt is fed one position a
    step, and when a step reselects beams the K/V rows are gathered after
    their parent hypotheses in place (the cache tensors keep their
    identity). Returns ``(sequences (N, beam, T0 + decode_length) int32,
    scores (N, beam))``, best beam first: the search's contract and, ties
    aside, its result."""
    from bigdl_tpu_torch.nn.beam_search import (
        beam_step, final_ranking, new_beams,
    )

    if beam_size < 1 or decode_length < 1:
        raise ValueError("beam_size and decode_length must be >= 1")
    dev = require_on(model, device)
    prompt = torch.as_tensor(prompt, dtype=torch.long).to(dev)
    n, t0 = prompt.shape
    b, total = int(beam_size), t0 + decode_length
    beams = new_beams(prompt, b, total, pad_id)
    pb = prompt.repeat_interleave(b, dim=0)                    # (n·B, t0)
    with torch.no_grad(), evaluating(model):
        state = install_decode_cache(model, n * b, total, dtype)
        rows = []
        _map_leaves(lambda key, leaf: rows.append(leaf)
                    if key in _CACHE_ROW_KEYS else None, state)
        tok = pb[:, 0]
        for i in range(total - 1):
            logp, state = model.run(tok[:, None], state)
            if i + 1 < t0:                       # the prompt: no beam math
                tok = pb[:, i + 1]
                continue
            step_lp = torch.log_softmax(logp[:, 0].float(), -1)
            beams, parent, new_tok = beam_step(
                beams, step_lp.reshape(n, b, -1), i + 1, i + 2.0 - t0,
                eos_id, alpha)
            flat = (torch.arange(n, device=dev)[:, None] * b
                    + parent).reshape(-1)
            for leaf in rows:
                leaf.copy_(leaf.index_select(0, flat))
            tok = new_tok.reshape(-1)
    return final_ranking(beams, decode_length, alpha)
