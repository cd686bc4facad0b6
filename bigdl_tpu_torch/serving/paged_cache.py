"""Paged KV cache: a fixed-size page pool per attention layer and page tables.

Counterpart of ``bigdl_tpu/serving/paged_cache.py``. The slot grid reserves
``slots × max_len`` K/V rows up front, so a short sequence wastes almost its
whole row and resident concurrency is capped at ``slots``. Here a
sequence's LOGICAL history (positions ``0..depth``) lives in PHYSICAL
fixed-size pages of a shared pool, and residency scales with the tokens in
flight. Layout, per causal ``MultiHeadAttention``::

    page_k, page_v : (pages + 1, kv_heads, page_tokens, head_dim)
    page_table     : (slots, max_len // page_tokens) long, physical ids
    pos            : (slots,) long, per-slot depth

plus ``pos_idx`` per ``PositionEmbedding``. Physical page 0 is the trash
page: never allocated, it backs every unallocated table entry, so the free
rows riding the static decode batch write into a page nobody attends, and
unallocated logical pages gather finite junk that the position mask weighs
with exactly 0.

The decode step (``MultiHeadAttention._paged_decode_step``) writes through
the table and gathers the pool back into the slot grid's ``(slots,
kv_heads, max_len, head_dim)`` view, so the attention and the tokens are
the slot grid's. The host owns the table (:class:`PageAllocator` and the
engine's bookkeeping); every layer pages identically, so all layers hold
ONE table tensor, which :func:`with_page_table` overwrites in place before
a tick: a captured decode program reads the buffers it was captured with,
so no leaf of the state is ever rebound. :func:`assign_cache_pages` and
:func:`reset_page_slot` are the page-granular forms of ``assign_cache_slot``
and ``reset_decode_slot``; the slot and the page list are device tensors,
so one captured assign program serves every admission.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from bigdl_tpu_torch.nn.incremental import (
    _row_index, _set_path, cache_modules,
)
from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils.faults import check_fault
from bigdl_tpu_torch.utils.robustness import events

#: paged-cache leaf names (the page-granular ``_CACHE_ROW_KEYS``)
_PAGE_POOL_KEYS = ("page_k", "page_v")
_PAGE_TABLE_KEY = "page_table"

#: physical id of the reserved trash page (never allocated, never attended)
TRASH_PAGE = 0


def logical_pages(max_len: int, page_tokens: int) -> int:
    """Pages per sequence window (``W``). ``max_len`` must divide evenly,
    so that the gathered view is exactly the slot grid's shape."""
    if page_tokens < 1:
        raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
    if max_len % page_tokens != 0:
        raise ValueError(
            f"max_len {max_len} must be a multiple of page_tokens "
            f"{page_tokens} (the gathered view must tile exactly)")
    return max_len // page_tokens


class PageAllocator:
    """Host-side free list over physical pages ``1..pages`` (page 0 is the
    trash page). ``alloc`` returns None on exhaustion: that is
    backpressure, which the engine answers by blocking admission, shedding
    or preempting its youngest sequence."""

    def __init__(self, pages: int):
        if pages < 1:
            raise ValueError(f"pages must be >= 1, got {pages}")
        self.pages = int(pages)
        self._free = list(range(1, self.pages + 1))
        self._lock = threading.Lock()
        self.alloc_failures = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.pages - len(self._free)

    def alloc(self, n: int = 1) -> Optional[list[int]]:
        """Claim ``n`` pages, lowest ids first, or None when the pool cannot
        give them all (a partial grant would strand pages). The
        ``serve_page_alloc`` fault site makes an allocation report
        exhaustion."""
        with self._lock:
            if check_fault(faults.SITE_PAGE_ALLOC) is not None:
                self.alloc_failures += 1
                events.record("serving_page_alloc_fault", requested=n,
                              pages_free=len(self._free))
                return None
            if n < 0 or n > len(self._free):
                self.alloc_failures += 1
                return None
            got, self._free = self._free[:n], self._free[n:]
            return got

    def free(self, pages) -> None:
        """Return pages to the pool (the trash page is skipped); a page out
        of range or already free raises. The free list stays sorted, so
        allocation order is deterministic across recycles."""
        with self._lock:
            for p in pages:
                p = int(p)
                if p == TRASH_PAGE:
                    continue
                if p < 1 or p > self.pages:
                    raise ValueError(
                        f"page id {p} outside pool [1, {self.pages}]")
                if p in self._free:
                    raise ValueError(f"double free of page {p}")
                self._free.append(p)
            self._free.sort()

    def reset(self) -> None:
        """Every page back to the pool."""
        with self._lock:
            self._free = list(range(1, self.pages + 1))


def install_paged_cache(model: torch.nn.Module, slots: int, max_len: int,
                        pages: int, page_tokens: int,
                        dtype: torch.dtype = torch.float32) -> dict:
    """Zeroed paged decode state for ``model``: per attention layer a
    ``pages + 1``-page pool of K and of V (page 0 the trash page) and
    per-slot positions, one ``(slots, W)`` table of trash entries shared by
    every layer, and per-slot ``pos_idx`` for a position table."""
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    if pages < 1:
        raise ValueError(f"pages must be >= 1, got {pages}")
    w = logical_pages(max_len, page_tokens)
    attns, positions = cache_modules(model, max_len)
    dev = next(model.parameters()).device
    table = torch.full((slots, w), TRASH_PAGE, dtype=torch.long, device=dev)
    state: dict = {}
    for path, m in attns:
        shape = (pages + 1, m.kv_heads, page_tokens, m.head_dim)
        _set_path(state, path, {
            "page_k": torch.zeros(shape, dtype=dtype, device=dev),
            "page_v": torch.zeros(shape, dtype=dtype, device=dev),
            "page_table": table,
            "pos": torch.zeros(slots, dtype=torch.long, device=dev),
        })
    for path in positions:
        _set_path(state, path, {"pos_idx": torch.zeros(
            slots, dtype=torch.long, device=dev)})
    return state


def is_paged_state(state) -> bool:
    """True when ``state`` holds paged-cache leaves anywhere."""
    if isinstance(state, dict):
        if any(k in state for k in _PAGE_POOL_KEYS) \
                or _PAGE_TABLE_KEY in state:
            return True
        return any(is_paged_state(v) for v in state.values())
    return False


def _attention_nodes(state: dict) -> list:
    """The attention layers' dicts of a paged state, in tree order."""
    if "page_k" in state:
        return [state]
    return [n for v in state.values() if isinstance(v, dict)
            for n in _attention_nodes(v)]


def with_page_table(state: dict, table) -> dict:
    """Overwrite the state's page table in place with ``table`` (the host's
    ``(slots, W)`` table; a CPU tensor copies asynchronously when it is
    pinned) and return ``state``."""
    table = torch.as_tensor(table)
    seen = set()
    for node in _attention_nodes(state):
        leaf = node[_PAGE_TABLE_KEY]
        if id(leaf) in seen:
            continue
        seen.add(id(leaf))
        if leaf.shape != table.shape:
            raise ValueError(
                f"page table shape mismatch: state has {tuple(leaf.shape)}, "
                f"given {tuple(table.shape)}")
        leaf.copy_(table, non_blocking=True)
    return state


def assign_cache_pages(dst_state: dict, src_state: dict, pages, slot,
                       pos) -> dict:
    """Scatter a just-prefilled CONTIGUOUS batch-1 cache (``src_state``)
    into the page pool in place: logical page ``i`` of the source row lands
    in physical page ``pages[i]`` (``(W,)`` ids; trash 0 past the context,
    so the padding's junk goes where nobody attends), ``slot``'s table row
    becomes ``pages`` and its positions ``pos``, the true context length.
    ``pages`` is a long tensor on the cache's device and ``slot`` and
    ``pos`` ints or one-element tensors there, so one captured program
    serves every admission."""
    nodes = []

    def walk(d, s):
        if "page_k" in d:
            if not (isinstance(s, dict) and "cache_k" in s):
                raise ValueError(
                    "assign_cache_pages source must be a contiguous batch-1 "
                    "cache (install_decode_cache)")
            nodes.append((d, s))
        elif "cache_k" in d:
            raise ValueError(
                "assign_cache_pages destination is an unpaged slot-grid "
                "cache: use assign_cache_slot, or install_paged_cache")
        elif "pos_idx" in d:
            nodes.append((d, None))
        else:
            for k, v in d.items():
                if isinstance(v, dict):
                    walk(v, s[k])

    walk(dst_state, src_state)
    dev = next(iter(nodes[0][0].values())).device
    row = _row_index(slot, dev)
    at = _row_index(pos, dev)
    pages = torch.as_tensor(pages, dtype=torch.long, device=dev)
    for d, s in nodes:
        if s is None:
            d["pos_idx"].index_copy_(0, row, at)
            continue
        ck, cv = s["cache_k"], s["cache_v"]
        if ck.shape[0] != 1:
            raise ValueError(f"assign_cache_pages source must be a batch-1 "
                             f"cache, got leading dim {ck.shape[0]}")
        pk, pv, table = d["page_k"], d["page_v"], d[_PAGE_TABLE_KEY]
        kv_h, lmax, hd = ck.shape[1:]
        ptok, w = pk.shape[2], table.shape[1]
        if lmax != w * ptok:
            raise ValueError(
                f"source cache length {lmax} does not tile the page grid "
                f"({w} pages x {ptok} tokens): prefill and paged caches "
                f"must share max_len")
        if tuple(pages.shape) != (w,):
            raise ValueError(f"pages must be ({w},) physical ids, got "
                             f"{tuple(pages.shape)}")
        # (kv_h, W·ptok, hd) -> (W, kv_h, ptok, hd): one page a leading row
        pk.index_copy_(0, pages, ck[0].reshape(kv_h, w, ptok, hd)
                       .transpose(0, 1).to(pk.dtype))
        pv.index_copy_(0, pages, cv[0].reshape(kv_h, w, ptok, hd)
                       .transpose(0, 1).to(pv.dtype))
        table.index_copy_(0, row, pages[None])
        d["pos"].index_copy_(0, row, at)
    return dst_state


def reset_page_slot(state: dict, pages, slot: int) -> dict:
    """Wipe one slot's paged footprint in place: ZERO its physical pages (a
    poisoned row can hold NaN, and a 0 weight times NaN is NaN), point its
    table row at the trash page and rewind its positions. The fault path
    only; it runs eagerly. Refuses an unpaged state."""
    if not is_paged_state(state):
        raise ValueError(
            "reset_page_slot needs a paged cache (install_paged_cache); "
            "use reset_decode_slot for the slot-grid cache")

    def wipe(node):
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                wipe(leaf)
            elif key in _PAGE_POOL_KEYS:
                idx = torch.as_tensor(pages, dtype=torch.long,
                                      device=leaf.device).reshape(-1)
                leaf.index_fill_(0, idx, 0)
            elif key == _PAGE_TABLE_KEY:
                leaf[slot] = TRASH_PAGE
            elif key in ("pos", "pos_idx"):
                leaf[slot] = 0

    wipe(state)
    return state
