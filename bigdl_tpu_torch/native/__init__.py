"""Native host components of the port (C++, ctypes-bound).

Counterpart of ``bigdl_tpu/native/__init__.py``: ``batchpack.cpp`` (the
port's own copy) stacks sample buffers into a batch and gathers rows in C++
with the GIL released, so the prefetch producer assembles the next batch
while the loop thread runs the step. It is host code, not a device kernel.

The library is compiled at first use with the local ``g++`` into
``build/native/`` at the root of the checkout (listed in ``.gitignore``)
by :func:`build_so`, which the image codec's build uses too;
the JAX package's ``_batchpack.so`` is never loaded. When the toolchain or
the build fails, every entry point keeps JAX's numpy path, with JAX's
warning; ``BIGDL_NATIVE=0`` turns the library off. ``native_available()``
says whether the C++ path is in use.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
import time

import numpy as np

logger = logging.getLogger("bigdl_tpu_torch.native")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "batchpack.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "native")
_SO = os.path.join(_BUILD_DIR, "_batchpack.so")

_lock = threading.Lock()
_lib = None
_lib_failed = False


def build_so(src: str, so: str, extra_flags=()) -> float | None:
    """Compile the C++ source ``src`` into the shared library ``so`` with
    the local ``g++``, when ``so`` is missing or older than ``src``; returns
    the build's wall seconds, or None when the library was current. A
    failed build raises ``RuntimeError`` with the compiler's errors."""
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return None
    os.makedirs(os.path.dirname(so), exist_ok=True)
    # pid-unique temp: concurrent first-use builds (test workers) must not
    # install each other's half-written output
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                           *extra_flags, src, "-o", tmp],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {src} failed:\n{proc.stderr}")
    os.replace(tmp, so)
    return time.perf_counter() - t0


def _enabled() -> bool:
    return os.environ.get("BIGDL_NATIVE", "1") == "1"


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if build_so(_SRC, _SO, ["-pthread"]) is not None:
                logger.info("built native batchpack: %s", _SO)
            lib = ctypes.CDLL(_SO)
            lib.pack_batch.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p]
            lib.gather_rows.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
            _lib = lib
        except Exception as e:
            logger.warning("native batchpack unavailable (%s); using numpy", e)
            _lib_failed = True
    return _lib


def native_available() -> bool:
    return _enabled() and _load() is not None


def pack_batch(arrays) -> np.ndarray:
    """Stack same-shaped arrays into a new contiguous batch (np.stack analog).
    The copy runs in C++ with the GIL released."""
    first = np.asarray(arrays[0])
    n = len(arrays)
    lib = _load() if _enabled() else None
    if lib is None or n < 2:
        return np.stack([np.asarray(a) for a in arrays])
    # NB: np.ascontiguousarray promotes 0-d to 1-d — only call it when needed
    if first.dtype.hasobject:
        # raw memcpy of PyObject* slots would skip refcounting → corruption
        return np.stack([np.asarray(a) for a in arrays])
    mats = [m if m.flags.c_contiguous else np.ascontiguousarray(m)
            for m in (np.asarray(a) for a in arrays)]
    for m in mats:
        if m.shape != first.shape or m.dtype != first.dtype:
            return np.stack(mats)  # ragged → numpy's error/handling path
    out = np.empty((n,) + first.shape, first.dtype)
    ptrs = (ctypes.c_void_p * n)(*[m.ctypes.data for m in mats])
    lib.pack_batch(ptrs, n, first.nbytes, out.ctypes.data_as(ctypes.c_void_p))
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """dst[i] = src[idx[i]] over leading-axis rows (fancy-index analog)."""
    src = np.asarray(src)
    if src.dtype.hasobject:
        idx = np.asarray(idx)
        if len(idx) and (idx.min() < 0 or idx.max() >= len(src)):
            raise IndexError(f"gather_rows: index out of range [0, {len(src)})")
        return src[idx]
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, np.int64)
    # bounds policy is identical on both paths: negatives rejected (numpy's
    # wrap-around would make behavior depend on lib availability)
    if len(idx) and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(f"gather_rows: index out of range [0, {len(src)})")
    lib = _load() if _enabled() else None
    if lib is None:
        return src[idx]
    row_bytes = src[0].nbytes if len(src) else 0
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    if len(idx) == 0 or row_bytes == 0:
        return out
    lib.gather_rows(src.ctypes.data_as(ctypes.c_void_p),
                    idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    len(idx), row_bytes, out.ctypes.data_as(ctypes.c_void_p))
    return out
