"""On-disk decoded-sample cache: decode once, mmap after that.

Counterpart of ``bigdl_tpu/dataset/sample_cache.py``, file for file: the
first epoch of a cache-aware source (``dataset/recordio.py``,
``dataset/streaming.py``) writes every decoded record as it streams past,
and every later epoch ``np.memmap``\\ s the cache and never builds the decode
pool (the feed's ``decode`` stage drops out and ``cache`` takes its place).
The files are JAX's, so either package reads the other's cache:

- ``<key>.data``: the raw little-endian array bytes of every record,
  written to a ``.tmp``, fsynced and renamed, its CRC32 in the index and
  verified at the first open;
- ``<key>.idx``: a ``utils.file.save`` pickle (CRC footer, fsynced):
  record id → (offset, per-array (shape, dtype, bytes), small meta), the
  data's byte count and CRC.

A CRC mismatch, a short file or an unreadable index quarantines the pair
as ``*.corrupt`` with a ``cache_fallback`` robustness event and the epoch
decodes live from that record on; a build commits only when every record
of the dataset was written. The ``cache_read`` and ``cache_write`` fault
sites fire those paths in tests. The records are JAX's three kinds:
``ImageFeature`` (the decoded image, its label and uri), ``Sample`` and
bare arrays.
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import os
import time
import zlib
from collections import deque
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from bigdl_tpu_torch.dataset.profiling import STAGE_CACHE, feed_stats
from bigdl_tpu_torch.dataset.resilience import SKIPPED
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.obs import trace
from bigdl_tpu_torch.obs.registry import registry as _obs_registry
from bigdl_tpu_torch.utils import file as ckpt_file
from bigdl_tpu_torch.utils.faults import (
    SITE_CACHE_READ, SITE_CACHE_WRITE, check_fault, fault_point,
)
from bigdl_tpu_torch.utils.robustness import events

logger = logging.getLogger("bigdl_tpu_torch.dataset")

_IDX_VERSION = 1


class CacheCorruptError(RuntimeError):
    """A cache file pair failed an integrity check (CRC mismatch, short
    mmap, version skew, or an unreadable index)."""


# ------------------------------------------------------------------- knobs
def cache_enabled(default: bool = False) -> bool:
    """``BIGDL_SAMPLE_CACHE``: 1 enables the decoded-sample cache for every
    cache-aware dataset source (streaming / image folder / recordio)."""
    raw = os.environ.get("BIGDL_SAMPLE_CACHE", "").strip()
    if raw == "":
        return default
    return raw not in ("0", "false", "no")


def cache_dir(default_dir: str) -> str:
    """``BIGDL_SAMPLE_CACHE_DIR`` overrides the per-dataset default (a
    ``.bigdl-sample-cache/`` directory next to the source data)."""
    return os.environ.get("BIGDL_SAMPLE_CACHE_DIR", "").strip() or default_dir


def fingerprint(material) -> str:
    """Stable cache key from dataset identity material (shard paths, sizes,
    record counts, decoder name...). Anything repr-stable works."""
    h = hashlib.sha1()
    h.update(repr(material).encode())
    return h.hexdigest()[:16]


# ------------------------------------------------------------------- codec
def encode_record(rec) -> tuple[list[np.ndarray], dict]:
    """Record → (arrays, small picklable meta): ``ImageFeature`` (decoded
    image, label and uri), ``Sample`` (feature and label arrays) and bare
    ndarrays, with JAX's meta."""
    from bigdl_tpu_torch.transform.vision.image import ImageFeature

    if isinstance(rec, ImageFeature):
        return [np.asarray(rec.image)], {
            "k": "imf", "label": rec.get(ImageFeature.LABEL),
            "uri": rec.get(ImageFeature.URI)}
    if isinstance(rec, Sample):
        return [np.asarray(a) for a in (*rec.feature, *rec.label)], {
            "k": "smp", "nf": len(rec.feature)}
    if isinstance(rec, np.ndarray):
        return [rec], {"k": "arr"}
    raise TypeError(
        f"record type {type(rec).__name__} is not cacheable (ImageFeature, "
        f"Sample, or ndarray)")


def decode_record(arrays: list[np.ndarray], meta: dict):
    """Inverse of :func:`encode_record`: a record equal to the freshly
    decoded one."""
    kind = meta["k"]
    if kind == "imf":
        from bigdl_tpu_torch.transform.vision.image import ImageFeature
        return ImageFeature(arrays[0], meta.get("label"), uri=meta.get("uri"))
    if kind == "smp":
        nf = int(meta["nf"])
        return Sample(list(arrays[:nf]), list(arrays[nf:]) or None)
    if kind == "arr":
        return arrays[0]
    raise CacheCorruptError(f"unknown cache record kind {kind!r}")


# ------------------------------------------------------------------- cache
class SampleCache:
    """One dataset's decoded-record cache: a committed pair serves warm
    epochs via mmap; an uncommitted one accepts a single-epoch build."""

    def __init__(self, directory: str, key: str, n_records: int):
        self.dir = directory
        self.key = key
        self.n_records = int(n_records)
        self.data_path = os.path.join(directory, f"{key}.data")
        self.idx_path = os.path.join(directory, f"{key}.idx")
        self._entries: Optional[dict] = None   # gid -> (offset, specs, meta)
        self._mm: Optional[np.memmap] = None
        self._verified = False
        self._dead = False        # quarantined/unusable for this process

    # ---------------------------------------------------------------- open
    def try_open(self) -> bool:
        """True when a committed, integrity-verified cache is mmapped and
        ready to serve. A failed check quarantines the pair (loudly) and
        returns False — the caller decodes live instead."""
        if self._dead:
            return False
        if self._mm is not None:
            return True
        if not (os.path.exists(self.idx_path)
                and os.path.exists(self.data_path)):
            return False
        try:
            idx = ckpt_file.load(self.idx_path)
            if idx.get("version") != _IDX_VERSION:
                raise CacheCorruptError(
                    f"{self.idx_path}: cache index version "
                    f"{idx.get('version')!r} != {_IDX_VERSION}")
            if idx.get("n_records") != self.n_records:
                raise CacheCorruptError(
                    f"{self.idx_path}: cache built for {idx.get('n_records')} "
                    f"records, dataset has {self.n_records}")
            size = os.path.getsize(self.data_path)
            if size != idx["data_bytes"]:
                raise CacheCorruptError(
                    f"{self.data_path}: short mmap — {size} bytes on disk, "
                    f"index says {idx['data_bytes']}")
            mm = np.memmap(self.data_path, dtype=np.uint8, mode="r")
            if not self._verified:
                actual = zlib.crc32(mm)
                if actual != idx["data_crc"]:
                    raise CacheCorruptError(
                        f"{self.data_path}: CRC mismatch (expected "
                        f"{idx['data_crc']:#010x}, got {actual:#010x})")
                self._verified = True
            self._entries = idx["entries"]
            self._mm = mm
            return True
        except (OSError, ckpt_file.CheckpointCorruptError, CacheCorruptError,
                KeyError, TypeError, ValueError) as e:
            self.quarantine(str(e))
            return False

    @property
    def complete(self) -> bool:
        """A committed pair exists on disk (not yet necessarily verified)."""
        return (not self._dead and os.path.exists(self.idx_path)
                and os.path.exists(self.data_path))

    # ---------------------------------------------------------------- read
    def read(self, gid: int):
        """One record from the mmap. Raises :class:`CacheCorruptError` on
        any inconsistency (including a scripted ``cache_read`` fault) — the
        epoch's iteration answers with quarantine and a live decode."""
        t0 = time.perf_counter()
        with trace.span("feed/cache_read"):
            # non-raising poll: ANY scripted action at this site models a
            # corrupt read, which must route through quarantine, not crash
            action = check_fault(SITE_CACHE_READ)
            if action is not None:
                raise CacheCorruptError(
                    f"{self.data_path}: injected cache_read fault "
                    f"({action})")
            entry = self._entries.get(int(gid)) if self._entries else None
            if entry is None:
                raise CacheCorruptError(
                    f"{self.data_path}: record {gid} missing from cache index")
            offset, specs, meta = entry
            arrays = []
            nbytes_total = 0
            for shape, dtype_str, nbytes in specs:
                if offset + nbytes > self._mm.size:
                    raise CacheCorruptError(
                        f"{self.data_path}: record {gid} extends past end of "
                        f"data file")
                # copy out of the mmap: downstream transforms may mutate
                # in place, and a copy keeps the page-in cost while freeing
                # the read-only constraint
                arr = np.frombuffer(self._mm, dtype=np.dtype(dtype_str),
                                    count=int(np.prod(shape, dtype=np.int64))
                                    if shape else 1,
                                    offset=offset).reshape(shape).copy()
                arrays.append(arr)
                offset += nbytes
                nbytes_total += nbytes
            rec = decode_record(arrays, meta)
        feed_stats.add(STAGE_CACHE, time.perf_counter() - t0)
        _obs_registry.counter("feed/cache_hit").inc()
        _obs_registry.counter("feed/cache_bytes").inc(nbytes_total)
        return rec

    # ---------------------------------------------------------------- build
    def start_build(self) -> Optional["_CacheWriter"]:
        """A writer for this epoch's build, or None when building is not
        possible (already complete, quarantined, or the directory is not
        writable)."""
        if self._dead or self.complete:
            return None
        try:
            os.makedirs(self.dir, exist_ok=True)
            return _CacheWriter(self)
        except OSError as e:
            logger.warning("sample cache: cannot build under %s (%s); "
                           "continuing uncached", self.dir, e)
            return None

    # ----------------------------------------------------------- quarantine
    def quarantine(self, reason: str) -> None:
        """Move the pair aside as ``*.corrupt`` and mark the cache unusable
        for this process. The epoch that hit this falls back to live decode;
        the NEXT process/run rebuilds from scratch."""
        self._dead = True
        self._mm = None
        self._entries = None
        moved = []
        for p in (self.data_path, self.idx_path):
            if os.path.exists(p):
                try:
                    os.replace(p, p + ".corrupt")
                    moved.append(p + ".corrupt")
                except OSError:
                    pass
        events.record("cache_fallback", reason=reason[:200], files=moved)
        logger.error(
            "sample cache corrupt — quarantined %s and falling back to live "
            "decode for this run: %s", moved or [self.data_path], reason)

    def close(self) -> None:
        self._mm = None
        self._entries = None


class _CacheWriter:
    """Single-epoch cache build: append records as they stream past, commit
    only when every record landed. Never raises into the feed — any write
    failure (including a scripted ``cache_write`` fault) abandons the build
    with a ``cache_write_failed`` event and training continues uncached."""

    def __init__(self, cache: SampleCache):
        self.cache = cache
        self.tmp_path = cache.data_path + ".tmp"
        self._f = open(self.tmp_path, "wb")
        self._entries: dict = {}
        self._offset = 0
        self._crc = 0
        self._dead_reason: Optional[str] = None

    def put(self, gid: int, rec) -> None:
        if self._dead_reason is not None:
            return
        try:
            with trace.span("feed/cache_write"):
                fault_point(SITE_CACHE_WRITE)
                arrays, meta = encode_record(rec)
                specs = []
                offset = self._offset
                for a in arrays:
                    buf = np.ascontiguousarray(a).tobytes()
                    self._f.write(buf)
                    self._crc = zlib.crc32(buf, self._crc)
                    specs.append((tuple(a.shape), a.dtype.str, len(buf)))
                    self._offset += len(buf)
                self._entries[int(gid)] = (offset, specs, meta)
        except Exception as e:  # build is best-effort; the feed must not die
            self._fail(f"{type(e).__name__}: {e}")

    def _fail(self, reason: str) -> None:
        self._dead_reason = reason
        events.record("cache_write_failed", reason=reason[:200])
        logger.warning("sample cache build abandoned (%s); training "
                       "continues uncached", reason)
        self._discard()

    def _discard(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass
        try:
            os.remove(self.tmp_path)
        except OSError:
            pass

    def commit(self) -> bool:
        """Finalize IF the build is complete (every record written). The
        data file is fsynced before the atomic rename and the index rides
        ``utils.file.save`` (CRC footer + fsync + dir fsync), so a torn
        commit can never present a half-cache as valid."""
        if self._dead_reason is not None:
            return False
        if len(self._entries) != self.cache.n_records:
            # a skip-policy drop or a partial epoch: no half-caches
            logger.info(
                "sample cache build incomplete (%d/%d records); discarding — "
                "the next full epoch rebuilds", len(self._entries),
                self.cache.n_records)
            self._discard()
            return False
        try:
            self._f.flush()
            try:
                os.fsync(self._f.fileno())
            except OSError:
                pass
            self._f.close()
            os.replace(self.tmp_path, self.cache.data_path)
            ckpt_file.save({
                "version": _IDX_VERSION,
                "n_records": self.cache.n_records,
                "data_bytes": self._offset,
                "data_crc": self._crc,
                "entries": self._entries,
            }, self.cache.idx_path)
            logger.info("sample cache committed: %d records, %.1f MB → %s",
                        self.cache.n_records, self._offset / 2 ** 20,
                        self.cache.data_path)
            return True
        except OSError as e:
            self._fail(f"commit failed: {e}")
            return False

    def abort(self) -> None:
        if self._dead_reason is None:
            self._discard()
            self._dead_reason = "aborted"


# -------------------------------------------------------------- iteration
def cached_data_iter(indices: Iterable[int],
                     decode_submit: Callable,
                     cache: Optional[SampleCache],
                     depth: int) -> Iterator:
    """Drive one epoch over ``indices`` (global record ids) through the
    cache when possible, the decode pool otherwise — the shared iteration
    engine behind every cache-aware source.

    Warm path (committed cache): inline mmap reads, the decode pool is never
    touched. Any integrity failure mid-epoch quarantines the cache and the
    CURRENT record plus everything after it falls back to live decode —
    records already yielded stay valid, nothing crashes.

    Cold path: the classic ordered sliding window of decode futures
    (bounded memory, preserved order), building the cache when a writer is
    available. ``decode_submit(gid)`` returns a Future resolving to the
    record or :data:`~bigdl_tpu_torch.dataset.resilience.SKIPPED`.
    """
    it = iter(indices)
    if cache is not None and cache.try_open():
        for gid in it:
            try:
                rec = cache.read(gid)
            except CacheCorruptError as e:
                cache.quarantine(str(e))
                it = itertools.chain([gid], it)  # redecode from right here
                break
            yield rec
        else:
            return  # whole epoch served warm
    writer = cache.start_build() if cache is not None else None
    window: deque = deque()
    clean = False

    def resolve(gid, fut):
        out = fut.result()
        if out is SKIPPED:
            if writer is not None:
                writer._fail("record skipped by corrupt-sample policy")
        elif writer is not None:
            writer.put(gid, out)
        return out

    try:
        for gid in it:
            window.append((gid, decode_submit(gid)))
            if len(window) >= depth:
                out = resolve(*window.popleft())
                if out is not SKIPPED:
                    yield out
        while window:
            out = resolve(*window.popleft())
            if out is not SKIPPED:
                yield out
        clean = True
    finally:
        for _, f in window:
            f.cancel()
        if writer is not None:
            if clean:
                writer.commit()
            else:
                writer.abort()
