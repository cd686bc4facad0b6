"""Resident prefix KV-cache pool: shared-prompt traffic skips re-prefill.

Counterpart of ``bigdl_tpu/serving/prefix_cache.py``. Traffic shares prompt
PREFIXES (a system prompt, a few-shot header, a retrieved document); the
cold path pays a full prefill for each request. This pool keeps recently
prefilled batch-1 cache states (the states the engine's assign copies into
the decode grid), keyed by content hashes of chunk-aligned prefixes, so a
request whose prompt starts with a pooled prefix seeds from the pool and
prefills only the REMAINDER:

- **Chunk-aligned keys**: a context of length L registers keys at every
  multiple of ``chunk`` below L and at L itself, so a later prompt that
  shares the first ``c`` tokens finds the entry at the LONGEST boundary
  without scanning the pool.
- **Seeding is a position rewrite**: the pooled rows below ``c`` are what a
  fresh prefill of those tokens gives; the rows from ``c`` on are never
  attended and are overwritten by the remainder (the bucket padding's
  invariant). :meth:`PrefixPool.seeded` rewrites the position leaves to
  ``c``.
- **No new programs**: the remainder runs through the engine's bucket
  prefill programs from depth ``c`` (:func:`pick_seed_bucket` keeps the
  write inside the window), and an EXACT hit (c == the prompt's length)
  runs no prefill at all, using the entry's stored next token.
- **Page-truncated storage**: an entry keeps only the first ``ceil(L /
  page)`` pages of each cache row (``page`` is the chunk, or a paged
  engine's ``page_tokens``), so pool memory scales with prefix length;
  :meth:`PrefixPool.seeded` zero-pads the rows back.
- **LRU over entries**, capacity in entries; ``stats()["bytes"]`` reports
  the resident footprint.

A candidate hit is confirmed by exact token comparison, so a hash collision
is a miss, never wrong tokens. The pooled tensors are copies made outside
every captured program, in the allocator's ordinary memory.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from bigdl_tpu_torch.nn.incremental import _CACHE_POS_KEYS, _CACHE_ROW_KEYS
from bigdl_tpu_torch.serving.scheduler import pick_seed_bucket


def _digest(tokens: np.ndarray) -> bytes:
    return hashlib.sha1(np.ascontiguousarray(tokens, np.int32)
                        .tobytes()).digest()


def _map_state(fn, state: dict) -> dict:
    """A new nested dict of ``fn(key, leaf)`` over ``state``'s leaves."""
    return {k: _map_state(fn, v) if isinstance(v, dict) else fn(k, v)
            for k, v in state.items()}


def _trim_states(states: tuple, page: int, n: int) -> tuple[tuple, int]:
    """Copies of ``states`` with every cache row cut to its first
    ``ceil(n / page)`` pages along the length axis. Returns ``(copies,
    full_len)``, ``full_len`` the rows' length before the cut (0 when
    nothing was cut)."""
    kept = -(-n // page) * page
    full = [0]

    def cut(key, leaf):
        if key in _CACHE_ROW_KEYS and leaf.shape[-2] > kept:
            full[0] = max(full[0], leaf.shape[-2])
            return leaf[..., :kept, :].clone()
        return leaf.clone()

    return tuple(_map_state(cut, s) for s in states), full[0]


def _states_nbytes(states: tuple) -> int:
    total = [0]

    def count(key, leaf):
        total[0] += leaf.numel() * leaf.element_size()

    for s in states:
        _map_state(count, s)
    return total[0]


class PrefixEntry:
    """One pooled prefix: its tokens, the filled batch-1 cache state(s)
    (one per model when the engine runs a draft too), rows page-truncated,
    and the greedy next token after the whole context (the exact hit's
    answer). ``full_len`` is the rows' length before truncation (0: not
    truncated)."""

    __slots__ = ("tokens", "states", "next_token", "full_len", "nbytes")

    def __init__(self, tokens: np.ndarray, states: tuple, next_token: int,
                 full_len: int = 0):
        self.tokens = np.asarray(tokens, np.int32)
        self.states = tuple(states)
        self.next_token = int(next_token)
        self.full_len = int(full_len)
        self.nbytes = int(self.tokens.nbytes) + _states_nbytes(self.states)

    def __len__(self):
        return int(self.tokens.size)


class PrefixPool:
    """LRU pool of prefilled prefixes under chunk-aligned content hashes.
    Thread-safe; in practice only the owning engine's thread touches it."""

    def __init__(self, capacity: int, chunk: int = 16,
                 page: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if page is not None and page < 1:
            raise ValueError(f"page must be >= 1, got {page}")
        self.capacity = int(capacity)
        self.chunk = int(chunk)
        # storage granularity of cache rows: a paged engine's page_tokens,
        # or else the chunk
        self.page = int(page) if page is not None else self.chunk
        # full-length digest -> entry, oldest first
        self._entries: "OrderedDict[bytes, PrefixEntry]" = OrderedDict()
        # boundary digest -> full-length digest of the NEWEST entry there
        self._index: dict[bytes, bytes] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_saved = 0

    def _boundaries(self, n: int) -> list[int]:
        """Candidate prefix lengths of a length-``n`` context, longest
        first: n itself, then every chunk multiple below n."""
        bs = [n]
        b = (n - 1) // self.chunk * self.chunk
        while b >= self.chunk:
            bs.append(b)
            b -= self.chunk
        return bs

    def lookup(self, ctx: np.ndarray, buckets: Sequence[int],
               max_len: int) -> Optional[tuple[PrefixEntry, int]]:
        """The longest pooled prefix of ``ctx`` that is usable: the whole
        context (an exact hit, from an entry of exactly these tokens), or a
        proper prefix whose remainder fits a bucket from that depth
        (:func:`pick_seed_bucket`). Returns ``(entry, c)`` and refreshes
        the entry's LRU place, or None (a miss)."""
        ctx = np.asarray(ctx, np.int32)
        n = int(ctx.size)
        with self._lock:
            for c in self._boundaries(n):
                # an exact hit answers with the entry's next token, so it
                # takes the entry of exactly these tokens, keyed by their
                # full digest: a longer entry registered at boundary n
                # holds the token after ITS context
                key = (_digest(ctx) if c == n
                       else self._index.get(_digest(ctx[:c])))
                if key is None:
                    continue
                entry = self._entries.get(key)
                if entry is None or len(entry) < c \
                        or not np.array_equal(entry.tokens[:c], ctx[:c]):
                    continue   # a hash collision or a stale index: a miss
                if c < n and pick_seed_bucket(
                        n - c, buckets, c, max_len) is None:
                    continue   # the remainder would overflow the window
                self._entries.move_to_end(key)
                self.hits += 1
                self.tokens_saved += c
                return entry, c
            self.misses += 1
            return None

    def insert(self, ctx: np.ndarray, states: tuple,
               next_token: int) -> None:
        """Pool copies of a just-prefilled context's states. A context
        shorter than one chunk is not pooled; the same tokens again refresh
        their entry; over capacity, the least recently used entry goes with
        its index keys."""
        ctx = np.asarray(ctx, np.int32)
        n = int(ctx.size)
        if n < self.chunk:
            return
        full = _digest(ctx)
        states, full_len = _trim_states(states, self.page, n)
        entry = PrefixEntry(ctx, states, next_token, full_len=full_len)
        with self._lock:
            if full in self._entries:
                self._entries[full] = entry
                self._entries.move_to_end(full)
                return
            self._entries[full] = entry
            for c in self._boundaries(n):
                self._index[_digest(ctx[:c])] = full
            while len(self._entries) > self.capacity:
                old_key, old = self._entries.popitem(last=False)
                self.evictions += 1
                for c in self._boundaries(len(old)):
                    k = _digest(old.tokens[:c])
                    if self._index.get(k) == old_key:
                        del self._index[k]

    @staticmethod
    def seeded(entry: PrefixEntry, c: int,
               out: Optional[tuple] = None) -> tuple:
        """The entry's state(s) with every position leaf set to ``c`` and
        truncated rows zero-padded back to the full window, ready for the
        remainder prefill from depth ``c`` (or, on an exact hit, for the
        assign). With ``out`` (states of the full window, such as the
        engine's batch-1 prefill caches) the result is written into those
        tensors in place and ``out`` is returned; otherwise new tensors."""
        def fill(key, leaf, dst):
            if key in _CACHE_POS_KEYS:
                dst.fill_(c)
            elif key in _CACHE_ROW_KEYS:
                n = leaf.shape[-2]
                dst[..., :n, :].copy_(leaf)
                dst[..., n:, :].zero_()
            else:
                dst.copy_(leaf)

        def walk(src, dst):
            for key, leaf in src.items():
                if isinstance(leaf, dict):
                    walk(leaf, dst[key])
                else:
                    fill(key, leaf, dst[key])

        if out is None:
            full = entry.full_len

            def alloc(key, leaf):
                shape = list(leaf.shape)
                if key in _CACHE_ROW_KEYS and full:
                    shape[-2] = full
                return leaf.new_empty(shape)

            out = tuple(_map_state(alloc, s) for s in entry.states)
        for src, dst in zip(entry.states, out):
            walk(src, dst)
        return tuple(out)

    def clear(self) -> None:
        """Drop every entry (the counters stay)."""
        with self._lock:
            self._entries.clear()
            self._index.clear()

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "chunk": self.chunk,
                "page": self.page,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "tokens_saved": self.tokens_saved,
                "bytes": sum(e.nbytes for e in self._entries.values()),
            }
