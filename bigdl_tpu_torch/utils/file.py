"""Checkpoint and object files: one format shared with the JAX package.

A copy of ``bigdl_tpu/utils/file.py`` (stdlib only), so a file written by
either package loads in the other: the ``MAGIC`` header, the pickle payload
and a CRC32 footer verified on load. A torn or bit-rotten file raises
:class:`CheckpointCorruptError` (with its path) instead of a bare pickle
error; footer-less and plain pickles still load. A payload that names a
module only the JAX package can unpickle (``jax``, ``jaxlib``,
``bigdl_tpu``) raises :class:`ForeignObjectError` naming it: the port never
imports JAX to read a file. The one exception is the elastic manifest's
leaf marker, ``bigdl_tpu.utils.elastic_ckpt._LeafRef``, which is read as
the port's own class of that name (``utils/elastic_ckpt.py``), by name and
without an import. Writes are atomic and
durable: the payload is written to ``<path>.tmp`` and fsynced, renamed over
``path``, and the directory fsynced after the rename.
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import zlib

MAGIC = b"BIGDL_TPU_V1\n"
#: CRC footer: tag + crc32 of the pickle payload between header and footer
_CRC_TAG = b"BDLCRC32"
_FOOTER = struct.Struct("<8sI")


class CheckpointCorruptError(RuntimeError):
    """A persisted file failed its integrity check (CRC mismatch or
    truncated payload). Carries ``path`` so recovery layers can quarantine
    the exact file."""

    def __init__(self, path: str, message: str):
        super().__init__(message)
        self.path = path


class ForeignObjectError(RuntimeError):
    """A payload holds an object that only the JAX package can unpickle."""


#: top-level modules whose objects the port does not unpickle
_FOREIGN = ("jax", "jaxlib", "bigdl_tpu")


#: JAX's names of classes the port has a copy of: (module, name) -> the
#: port's module holding the class of that name
_MAPPED = {("bigdl_tpu.utils.elastic_ckpt", "_LeafRef"):
           "bigdl_tpu_torch.utils.elastic_ckpt"}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        mapped = _MAPPED.get((module, name))
        if mapped is not None:
            import importlib
            return getattr(importlib.import_module(mapped), name)
        if module.split(".")[0] in _FOREIGN:
            raise ForeignObjectError(
                f"the payload holds {module}.{name}, which only the JAX "
                f"package can unpickle; save numpy arrays instead")
        return super().find_class(module, name)


def dumps(obj, pickler=None) -> bytes:
    """Serialize ``obj`` to the on-disk format: header + pickle + CRC
    footer. ``pickler`` is a ``pickle.Pickler`` class to use instead of
    the default one."""
    if pickler is None:
        payload = pickle.dumps(obj)
    else:
        buf = io.BytesIO()
        pickler(buf).dump(obj)
        payload = buf.getvalue()
    return MAGIC + payload + _FOOTER.pack(_CRC_TAG, zlib.crc32(payload))


def loads(data: bytes, path: str = "<bytes>"):
    """Inverse of :func:`dumps`, with integrity verification. Accepts the
    footer-less V1 layout and plain pickles for back-compat."""
    return _read(io.BytesIO(data), len(data), path)


#: bytes the CRC pass reads at a time into its one buffer
_CRC_CHUNK = 8 << 20


def _read(f, size: int, path: str):
    """Verify and unpickle the file-like ``f`` of ``size`` bytes.

    No step holds the GIL for long, so a thread that loads a version
    beside a serving engine's loop does not stall the loop: the CRC is
    taken over chunks read into one buffer (``readinto`` and ``crc32``
    release the GIL for a file), and the pickle is read from ``f`` itself,
    each array's bytes straight into their object. Slicing the whole
    payload out of one ``bytes`` object instead made two copies of it and
    a third array by array, each holding the GIL throughout: a serving
    engine's loop beside the load of a 200 MB LM version went up to a
    quarter of a second without a tick."""
    head = f.read(len(MAGIC))
    start, end = 0, size
    if head == MAGIC:
        start = len(MAGIC)
        if size - start >= _FOOTER.size:
            f.seek(size - _FOOTER.size)
            tag, expected = _FOOTER.unpack(f.read(_FOOTER.size))
            if tag == _CRC_TAG:
                end = size - _FOOTER.size
                actual = _crc(f, start, end)
                if actual != expected:
                    raise CheckpointCorruptError(
                        path,
                        f"{path}: CRC mismatch (expected {expected:#010x}, "
                        f"got {actual:#010x}) — the file is corrupt")
        # else a pre-CRC writer: header but no footer
    f.seek(start)
    try:
        return _Unpickler(f).load()
    except (EOFError, pickle.UnpicklingError, IndexError) as e:
        # a CRC-verified payload that still fails to unpickle means the file
        # was TRUNCATED before the footer existed (torn write without rename
        # protection) or written torn by a crashed process
        raise CheckpointCorruptError(
            path,
            f"{path}: truncated or torn payload ({end - start} bytes "
            f"present; unpickling failed: {e})") from e


def _crc(f, start: int, end: int) -> int:
    """crc32 of ``f``'s bytes ``[start, end)``."""
    buf = memoryview(bytearray(min(_CRC_CHUNK, end - start)))
    f.seek(start)
    crc, left = 0, end - start
    while left:
        n = f.readinto(buf[:min(left, len(buf))])
        if not n:
            break
        crc = zlib.crc32(buf[:n], crc)
        left -= n
    return crc


def _fsync_dir(d: str) -> None:
    """Make the rename itself durable (the file's fsync alone does not pin
    the directory entry). Best-effort — not every FS supports dir fds."""
    try:
        fd = os.open(d or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_bytes(data: bytes, path: str, overwrite: bool = True) -> None:
    """Atomic + durable write of pre-serialized bytes (the tmp + fsync +
    rename + dir-fsync protocol of :func:`save`, without re-encoding).
    Callers that need the byte count for accounting — the elastic checkpoint
    writer's ``ckpt/bytes`` metric — serialize once with :func:`dumps` and
    hand the buffer here."""
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists (pass overwrite=True)")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        try:
            os.fsync(f.fileno())
        except OSError:
            pass  # exotic FS without fsync: atomicity still holds
    os.replace(tmp, path)
    _fsync_dir(d)


def save(obj, path: str, overwrite: bool = True) -> None:
    save_bytes(dumps(obj), path, overwrite=overwrite)


def load(path: str):
    with open(path, "rb") as f:
        return _read(f, os.fstat(f.fileno()).st_size, path)
