"""Packed record files (``.bdlrec``): the SeqFileFolder analog.

Counterpart of ``bigdl_tpu/dataset/recordio.py``, format for format: a
file is ``BDLR`` magic and a u32 version, then per record ``u32
payload_len | u32 crc32(payload) | payload`` (little-endian), so a file
written by either package is byte-identical to the other's and each reads
the other's. The reader scans the offsets once at open, shuffles at record
granularity with the port's ``RandomGenerator`` (JAX's draws), verifies
each record's CRC on read and decodes through a caller's ``decoder(bytes)``
on a thread pool with a bounded in-order window, through the
decoded-sample cache when enabled (``dataset/sample_cache.py``).

Image records (:func:`encode_image_record`, :func:`write_image_records`)
hold an i32 label and the file's bytes; :func:`image_record_decoder`, the
default decoder of both record sources as in JAX, decodes them with the
port's codec (``transform/vision/codec.py``, PIL's pixels) into
``ImageFeature`` records. ``distributed=True`` marks a source for the
data-parallel trainer (``DistriOptimizer``), as in JAX: every rank reads
the same global batches and trains on its block of each.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.profiling import STAGE_DECODE, feed_stats
from bigdl_tpu_torch.dataset.resilience import run_guarded
from bigdl_tpu_torch.obs import trace
from bigdl_tpu_torch.utils.faults import SITE_DECODE, fault_point
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

_MAGIC = b"BDLR"
_VERSION = 1
_HEADER = struct.Struct("<4sI")
_REC = struct.Struct("<II")

class RecordIOError(Exception):
    pass


class RecordWriter:
    """Append-only writer of one ``.bdlrec`` shard."""

    def __init__(self, path: str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "wb")
        self._f.write(_HEADER.pack(_MAGIC, _VERSION))
        self.count = 0

    def write(self, payload: bytes) -> None:
        self._f.write(_REC.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        self.count += 1

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path: str, payloads: Iterable[bytes]) -> int:
    with RecordWriter(path) as w:
        for p in payloads:
            w.write(p)
        return w.count


def _scan_index(path: str) -> list:
    """One sequential pass: [(offset, length)] of every record."""
    index = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        if len(head) < _HEADER.size:
            raise RecordIOError(f"{path}: truncated header")
        magic, version = _HEADER.unpack(head)
        if magic != _MAGIC:
            raise RecordIOError(f"{path}: not a .bdlrec file")
        if version > _VERSION:
            raise RecordIOError(
                f"{path}: written by newer format version {version}")
        pos = _HEADER.size
        while pos < size:
            rec = f.read(_REC.size)
            if len(rec) < _REC.size:
                raise RecordIOError(f"{path}: truncated record header @ {pos}")
            length, _ = _REC.unpack(rec)
            payload_pos = pos + _REC.size
            if payload_pos + length > size:
                raise RecordIOError(f"{path}: truncated payload @ {pos}")
            index.append((pos, length))
            f.seek(length, os.SEEK_CUR)
            pos = payload_pos + length
    return index


def read_verified(fd: int, path: str, off: int, length: int) -> bytes:
    """One record's payload by ``os.pread`` (thread-safe on a shared fd),
    its CRC checked."""
    rec = os.pread(fd, _REC.size + length, off)
    n, crc = _REC.unpack(rec[:_REC.size])
    payload = rec[_REC.size:]
    if len(payload) != n or zlib.crc32(payload) != crc:
        raise RecordIOError(f"{path}: corrupt record @ {off} (crc mismatch)")
    return payload


class _RecordSource(AbstractDataSet):
    """What the record sources share: the decode pool, shared read fds,
    guarded decodes and the decoded-sample cache."""

    _pool_name = "bigdl-records"
    _cache_tag = "records.v1"

    def _init_source(self, paths, decoder, num_workers, cache, cache_dir,
                      distributed) -> None:
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        if not self.paths:
            raise ValueError("no record files given")
        self.decoder = image_record_decoder if decoder is None else decoder
        self.num_workers = max(int(num_workers), 1)
        self.distributed = distributed
        self._cache_enabled = cache
        self._cache_dir = cache_dir
        self._cache = None
        self._fds: dict = {}
        self._ex: Optional[ThreadPoolExecutor] = None

    def _executor(self) -> ThreadPoolExecutor:
        """One decode pool per dataset, reused across epochs."""
        if self._ex is None:
            self._ex = ThreadPoolExecutor(self.num_workers,
                                          thread_name_prefix=self._pool_name)
        return self._ex

    def _fd(self, fi: int) -> int:
        fd = self._fds.get(fi)
        if fd is None:
            fd = os.open(self.paths[fi], os.O_RDONLY)
            self._fds[fi] = fd
        return fd

    def _read(self, i: int) -> bytes:
        raise NotImplementedError

    def _load_one(self, i: int):
        fault_point(SITE_DECODE)   # a scripted decode failure, if any
        t0 = time.perf_counter()
        with trace.span("feed/decode"):
            out = self.decoder(self._read(i))
        feed_stats.add(STAGE_DECODE, time.perf_counter() - t0)
        return out

    def _load(self, i: int):
        # the corrupt-sample policy (BIGDL_BAD_SAMPLE_POLICY) per record
        return run_guarded("decode", self._load_one, i)

    def _cache_obj(self):
        from bigdl_tpu_torch.dataset import sample_cache
        if self._cache is None and self._cache_enabled is not False:
            enabled = (sample_cache.cache_enabled()
                       if self._cache_enabled is None else True)
            if enabled:
                default_dir = os.path.join(
                    os.path.dirname(os.path.abspath(self.paths[0])),
                    ".bigdl-sample-cache")
                material = (self._cache_tag, tuple(self.paths),
                            tuple(os.path.getsize(p) for p in self.paths),
                            self.size(),
                            getattr(self.decoder, "__qualname__",
                                    type(self.decoder).__name__))
                self._cache = sample_cache.SampleCache(
                    sample_cache.cache_dir(self._cache_dir or default_dir),
                    sample_cache.fingerprint(material), self.size())
        return self._cache

    def _drive(self, ids: Iterable[int]) -> Iterator:
        from bigdl_tpu_torch.dataset.sample_cache import cached_data_iter

        def submit(i):
            return self._executor().submit(self._load, int(i))

        return cached_data_iter(ids, submit, self._cache_obj(),
                                self.num_workers * 2)

    def close(self) -> None:
        if self._ex is not None:
            self._ex.shutdown(wait=False, cancel_futures=True)
            self._ex = None
        for fd in self._fds.values():
            try:
                os.close(fd)
            except OSError:
                pass
        self._fds.clear()
        if self._cache is not None:
            self._cache.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RecordFileDataSet(_RecordSource):
    """Decoded records of one or more ``.bdlrec`` shards, in an order
    shuffled at record granularity."""

    _pool_name = "bigdl-recordio"
    _cache_tag = "recordio.v1"

    def __init__(self, paths, decoder: Callable[[bytes], object],
                 num_workers: int = 8, distributed: bool = False,
                 cache: Optional[bool] = None,
                 cache_dir: Optional[str] = None):
        self._init_source(paths, decoder, num_workers, cache, cache_dir,
                          distributed)
        # the global index: (file, offset, length)
        self._index = [(fi, off, ln) for fi, p in enumerate(self.paths)
                       for off, ln in _scan_index(p)]
        if not self._index:
            raise RecordIOError(f"no records in {self.paths}")
        self._order = np.arange(len(self._index))

    def size(self) -> int:
        return len(self._index)

    def shuffle(self) -> None:
        perm = RandomGenerator.numpy().permutation(len(self._index))
        self._order = self._order[perm]

    def _read(self, i: int) -> bytes:
        fi, off, ln = self._index[i]
        return read_verified(self._fd(fi), self.paths[fi], off, ln)

    def data(self, train: bool) -> Iterator:
        yield from self._drive(int(i) for i in self._order)


def encode_image_record(label: int, image_bytes: bytes) -> bytes:
    """(label, encoded image) → record payload (i32 label | image bytes)."""
    return struct.pack("<i", int(label)) + image_bytes


def image_record_decoder(payload: bytes):
    """Record payload → ImageFeature (HWC uint8 RGB + int label), the record
    type the image-folder source yields; decoded by the port's codec."""
    from bigdl_tpu_torch.transform.vision.codec import decode
    from bigdl_tpu_torch.transform.vision.image import ImageFeature

    (label,) = struct.unpack("<i", payload[:4])
    return ImageFeature(decode(payload[4:]), label)


def write_image_records(image_folder_root: str, out_path: str,
                        shards: int = 1, one_based: bool = False) -> list:
    """Pack an ImageFolder tree (class subdirs of images) into ``shards``
    ``.bdlrec`` files, the files' bytes as they are, in JAX's order and
    layout. Returns the shard paths."""
    from bigdl_tpu_torch.dataset.image_folder import ImageFolderDataSet

    src = ImageFolderDataSet(image_folder_root, one_based=one_based)
    paths = [out_path if shards == 1 else f"{out_path}.{s:05d}"
             for s in range(shards)]
    writers = [RecordWriter(p) for p in paths]
    try:
        for n, (path, label) in enumerate(src._items):
            with open(path, "rb") as f:
                writers[n % shards].write(encode_image_record(label, f.read()))
    finally:
        for w in writers:
            w.close()
        src.close()
    return paths
