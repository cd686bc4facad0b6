"""Streaming data plane: sharded record streams with a window shuffle and
a checkpointable position.

Counterpart of ``bigdl_tpu/dataset/streaming.py``. The dataset is a list
of shards, packed ``.bdlrec`` files (``dataset/recordio.py``) or plain
uncompressed ``.tar`` archives, each scanned once into (offset, length)
and read with ``os.pread``.

**Window shuffle.** Records are interleaved round-robin from the shards
(the shard order permuted each epoch), fill a window of
``BIGDL_SHUFFLE_WINDOW`` slots, and every further record replaces the
occupant of a slot drawn from a per-epoch seed. The shard permutation and
the seed are drawn from the port's ``RandomGenerator`` inside
``shuffle()``, the same draws as JAX's, and the window draws from
``np.random.default_rng(seed)``, so one seed gives JAX's record order.

**Checkpointable position.** The trainer keeps :meth:`stream_state` (shard
order, epoch seed, window) in its checkpoint at each epoch start, so a
mid-epoch resume rebuilds the epoch's stream and replays to its batch;
:meth:`position_after`/:meth:`data_from` seek without record IO.

Decoded records go through the decoded-sample cache when enabled
(``dataset/sample_cache.py``): the first epoch decodes and writes it, later
epochs read it and never build the decode pool. ``distributed=True`` marks
the stream for the data-parallel trainer, and :meth:`shard` takes a
host's strided slice of the shards (``bigdl_tpu/dataset/streaming.py:
266-282``), as in JAX; the default decoder is the image decoder (``recordio.image_record_decoder``).
"""

from __future__ import annotations

import os
import tarfile
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.recordio import (
    _RecordSource, _scan_index, read_verified,
)
from bigdl_tpu_torch.utils.random_generator import RandomGenerator


def shuffle_window(default: int = 256) -> int:
    """``BIGDL_SHUFFLE_WINDOW``: window-shuffle buffer size in records.
    ``<= 1`` disables shuffling within the stream (pure shard interleave —
    shard ORDER is still permuted per epoch)."""
    raw = os.environ.get("BIGDL_SHUFFLE_WINDOW", "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def _scan_tar(path: str) -> list[tuple[int, int]]:
    """One pass over an UNCOMPRESSED tar → [(offset, length)] per regular
    member, in archive order (the webdataset layout: one member per record).
    Compression is rejected — random ``pread`` access needs flat bytes."""
    index = []
    with tarfile.open(path, "r:") as tf:  # "r:" = no compression accepted
        for m in tf:
            if m.isfile():
                index.append((m.offset_data, m.size))
    return index


def _scan_shard(path: str) -> tuple[str, list[tuple[int, int]]]:
    """(kind, [(offset, length)]) for one shard file, by extension."""
    if path.endswith(".tar"):
        return "tar", _scan_tar(path)
    return "bdlrec", _scan_index(path)


class _IndexStream:
    """The order-producing heart of the stream: round-robin shard interleave
    feeding a bounded shuffle window, with every piece of state explicit so
    a position can be captured, serialized, and rebuilt exactly.

    State: per-shard cursors, the active-shard list + round-robin pointer,
    the window (global record ids), the numpy bit-generator state, and the
    emitted count. ``state()``/``from_state()`` round-trip all of it.
    """

    def __init__(self, counts: Sequence[int], bases: Sequence[int],
                 order: Sequence[int], window_size: int, seed: int):
        self._counts = [int(c) for c in counts]
        self._bases = [int(b) for b in bases]
        self.order = [int(s) for s in order]
        self.window_size = max(int(window_size), 0)
        # fresh stream: all non-empty shards active in epoch order
        self._cursors = {s: 0 for s in self.order}
        self._active = [s for s in self.order if self._counts[s] > 0]
        self._rr = 0
        self._window: list[int] = []
        self._rng = np.random.default_rng(int(seed) & 0x7FFFFFFFFFFFFFFF)
        self.emitted = 0

    # ------------------------------------------------------------- iterate
    def __iter__(self) -> "_IndexStream":
        return self

    def _pull(self) -> int:
        """Next record id from the shard interleave (round-robin, one record
        per shard visit; exhausted shards drop out keeping the rotation)."""
        s = self._active[self._rr]
        c = self._cursors[s]
        gid = self._bases[s] + c
        self._cursors[s] = c + 1
        if c + 1 >= self._counts[s]:
            self._active.pop(self._rr)
            if self._rr >= len(self._active):
                self._rr = 0
        else:
            self._rr += 1
            if self._rr >= len(self._active):
                self._rr = 0
        return gid

    def __next__(self) -> int:
        while self._active:
            gid = self._pull()
            if self.window_size <= 1:
                self.emitted += 1
                return gid
            if len(self._window) < self.window_size:
                self._window.append(gid)  # filling — nothing to emit yet
                continue
            j = int(self._rng.integers(0, self.window_size))
            out, self._window[j] = self._window[j], gid
            self.emitted += 1
            return out
        if self._window:  # drain: shards exhausted, window empties randomly
            j = int(self._rng.integers(0, len(self._window)))
            self.emitted += 1
            return self._window.pop(j)
        raise StopIteration

    # --------------------------------------------------------------- state
    def state(self) -> dict:
        return {
            "cursors": dict(self._cursors),
            "active": list(self._active),
            "rr": self._rr,
            "window": list(self._window),
            "rng": self._rng.bit_generator.state,
            "emitted": self.emitted,
            "order": list(self.order),
            "window_size": self.window_size,
        }

    @classmethod
    def from_state(cls, counts: Sequence[int], bases: Sequence[int],
                   state: dict) -> "_IndexStream":
        st = cls(counts, bases, state["order"], state["window_size"], 0)
        st._cursors = {int(k): int(v) for k, v in state["cursors"].items()}
        st._active = [int(s) for s in state["active"]]
        st._rr = int(state["rr"])
        st._window = [int(g) for g in state["window"]]
        st._rng.bit_generator.state = state["rng"]
        st.emitted = int(state["emitted"])
        return st


class StreamingDataSet(_RecordSource):
    """A sharded record stream: deterministic window shuffle, resumable
    position, cache-aware decoding.

    ``paths``: ``.bdlrec`` and/or uncompressed ``.tar`` shards. ``decoder``:
    payload bytes → record. ``shuffle_window``: records in the window (None
    → ``BIGDL_SHUFFLE_WINDOW``, default 256). ``cache``: None defers to
    ``BIGDL_SAMPLE_CACHE``.
    """

    _pool_name = "bigdl-stream"
    _cache_tag = "stream.v1"

    def __init__(self, paths: Sequence[str] | str,
                 decoder: Optional[Callable[[bytes], object]] = None,
                 shuffle_window: Optional[int] = None,
                 num_workers: int = 8,
                 cache: Optional[bool] = None,
                 cache_dir: Optional[str] = None,
                 distributed: bool = False):
        self._init_source(paths, decoder, num_workers, cache, cache_dir,
                          distributed)
        self.shuffle_window = shuffle_window
        self._kinds: list = []
        self._indices: list = []
        self._bases: list = []
        n = 0
        for p in self.paths:
            kind, idx = _scan_shard(p)
            self._kinds.append(kind)
            self._indices.append(idx)
            self._bases.append(n)
            n += len(idx)
        self._n = n
        if n == 0:
            raise ValueError(f"no records in stream shards {self.paths}")
        # the shard-granular epoch order: the trainer's resume keeps
        # `_order` as it keeps any source's
        self._order = np.arange(len(self.paths))
        self._epoch_seed = 0

    def size(self) -> int:
        return self._n

    def shuffle(self) -> None:
        """Permute the shard order and draw the epoch's window seed, both
        from the global ``RandomGenerator`` (JAX's two draws)."""
        rng = RandomGenerator.numpy()
        self._order = self._order[rng.permutation(len(self._order))]
        self._epoch_seed = int(rng.integers(0, 2 ** 31 - 1))

    def shard(self, host_index: int, host_count: int) -> "StreamingDataSet":
        """This dataset restricted to ``paths[host_index::host_count]``,
        the per-host assignment of multi-host input: every host builds the
        same shard list and takes its strided slice."""
        if host_count < 1 or not (0 <= host_index < host_count):
            raise ValueError(f"invalid shard({host_index}, {host_count})")
        mine = self.paths[host_index::host_count]
        if not mine:
            raise ValueError(
                f"host {host_index}/{host_count} got no shards from "
                f"{len(self.paths)} files — write more shards than hosts")
        return StreamingDataSet(
            mine, decoder=self.decoder, shuffle_window=self.shuffle_window,
            num_workers=self.num_workers, cache=self._cache_enabled,
            cache_dir=self._cache_dir, distributed=self.distributed)

    def _locate(self, gid: int) -> tuple:
        """Global record id → (shard, record within the shard)."""
        si = int(np.searchsorted(self._bases, gid, side="right")) - 1
        return si, gid - self._bases[si]

    def _read(self, gid: int) -> bytes:
        si, ri = self._locate(gid)
        off, ln = self._indices[si][ri]
        if self._kinds[si] == "bdlrec":
            return read_verified(self._fd(si), self.paths[si], off, ln)
        return os.pread(self._fd(si), ln, off)

    def stream_state(self) -> dict:
        """The epoch's stream identity for the checkpoint: with the shard
        order and the epoch seed pinned, the epoch's record order is a pure
        function, which a resumed process rebuilds without its shuffle."""
        return {"order": [int(s) for s in self._order],
                "epoch_seed": int(self._epoch_seed),
                "window": self._window_size()}

    def restore_stream_state(self, state: dict) -> None:
        self._order = np.asarray([int(s) for s in state["order"]])
        self._epoch_seed = int(state["epoch_seed"])

    def _window_size(self) -> int:
        return (shuffle_window() if self.shuffle_window is None
                else int(self.shuffle_window))

    def _fresh_stream(self) -> _IndexStream:
        counts = [len(ix) for ix in self._indices]
        return _IndexStream(counts, self._bases, list(self._order),
                            self._window_size(), self._epoch_seed)

    def position_after(self, n: int) -> dict:
        """The iterator state after ``n`` records of this epoch: index
        arithmetic only, no record IO. :meth:`data_from` seeks to it."""
        st = self._fresh_stream()
        for _ in range(int(n)):
            next(st)
        return st.state()

    def data_from(self, position: dict, train: bool = True) -> Iterator:
        """The rest of the epoch from a :meth:`position_after` capture."""
        counts = [len(ix) for ix in self._indices]
        return self._drive(_IndexStream.from_state(counts, self._bases,
                                                   position))

    def data(self, train: bool) -> Iterator:
        return self._drive(self._fresh_stream())
