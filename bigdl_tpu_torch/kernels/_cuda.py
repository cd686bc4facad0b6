"""Build, load and account for the port's hand-written CUDA kernels.

The sources in ``csrc/`` have a plain C interface and never include
PyTorch's headers, so they compile in seconds. At first use on a machine
with the CUDA toolkit, every ``.cu`` file is compiled by its own ``nvcc``
process (all started together), the objects are linked into one shared
library under ``build/torch_ext/<hash>/`` in the checkout, and the library
is loaded with ``ctypes``. The hash covers the sources and the flags, so an
unchanged checkout reuses its build. Pointers and the current CUDA stream
cross the boundary as integers; every entry point returns the
``cudaError_t`` of its launch, which :func:`check` turns into an exception.

Nothing here runs when the module is imported: the CPU tests import every
module of the port and never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("layernorm.cu", "flash_attention.cu", "flash_attention_bwd.cu",
           "runtime.cu")
HEADERS = ("common.cuh", "hopper.cuh", "tma.cuh")
# -Xptxas -v: ptxas reports each kernel's registers, spills and static
# shared memory; the report is kept beside the library (BUILD_LOG)
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
LIB_NAME = "libbigdl_tpu_torch_kernels.so"
BUILD_LOG = "build.log"

_lock = threading.Lock()
_library = None


class LaunchCounter:
    """Launches of one kernel, counted by its wrapper right after each
    successful launch and nowhere else, in all and by the launch's dtypes."""

    def __init__(self, name: str):
        self.name = name
        self._count = 0
        self._by_dtype: dict = {}
        self._lock = threading.Lock()

    def add(self, dtype: str) -> None:
        with self._lock:
            self._count += 1
            self._by_dtype[dtype] = self._by_dtype.get(dtype, 0) + 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def by_dtype(self) -> dict:
        with self._lock:
            return dict(self._by_dtype)

    def reset(self) -> None:
        with self._lock:
            self._count = 0
            self._by_dtype = {}


class KernelLibrary:
    """The loaded shared library, how long this process spent building it
    (0.0 when an earlier build of the same sources was reused) and the
    compiler's report of that build (``ptxas -v`` per kernel)."""

    def __init__(self, path: Path, build_seconds: float):
        self.path = path
        self.build_seconds = build_seconds
        log = path.parent / BUILD_LOG
        self.build_log = log.read_text() if log.is_file() else ""
        lib = ctypes.CDLL(str(path))
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
            ctypes.c_float
        lib.bigdl_layer_norm_fwd.argtypes = [p, p, p, p, ll, i, f, i, i, p]
        lib.bigdl_layer_norm_fwd.restype = i
        lib.bigdl_layer_norm_bwd.argtypes = \
            [p] * 6 + [ll, i, f, i, i, ctypes.POINTER(i), p]
        lib.bigdl_layer_norm_bwd.restype = i
        lib.bigdl_flash_attn_fwd.argtypes = [p, p, p, p, p, ll, i, i, i, i, p]
        lib.bigdl_flash_attn_fwd.restype = i
        lib.bigdl_flash_attn_fwd_plan.argtypes = \
            [ll, i, i, i] + [ctypes.POINTER(i)] * 3
        lib.bigdl_flash_attn_fwd_plan.restype = i
        lib.bigdl_flash_attn_bwd_dq.argtypes = [p] * 7 + [ll, i, i, i, i, p]
        lib.bigdl_flash_attn_bwd_dq.restype = i
        lib.bigdl_flash_attn_bwd_dkv.argtypes = [p] * 8 + [ll, i, i, i, i, p]
        lib.bigdl_flash_attn_bwd_dkv.restype = i
        lib.bigdl_flash_attn_bwd_plan.argtypes = \
            [ll, i, i, i, i] + [ctypes.POINTER(i)] * 3
        lib.bigdl_flash_attn_bwd_plan.restype = i
        lib.bigdl_cuda_error_string.argtypes = [i]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        lib.bigdl_empty_launch.argtypes = [p]
        lib.bigdl_empty_launch.restype = i
        self.lib = lib


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from bigdl_tpu_torch/kernels/csrc at first use on a machine with "
        "the CUDA toolkit")


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def _build(nvcc: str, out_dir: Path) -> Path:
    """Compile every source in parallel, link, and publish atomically."""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"tmp-{os.getpid()}-{threading.get_ident()}"
    tmp.mkdir(exist_ok=True)
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        errors, report = [], []
        for name, _, proc in procs:
            out, err = proc.communicate()
            report.append(f"--- {name}\n{out}{err}")
            if proc.returncode != 0:
                errors.append(f"--- {name} (exit {proc.returncode})\n"
                              f"{out}{err}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib_tmp = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib_tmp),
             *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        (tmp / BUILD_LOG).write_text("\n".join(report))
        os.replace(tmp / BUILD_LOG, out_dir / BUILD_LOG)
        final = out_dir / LIB_NAME
        os.replace(lib_tmp, final)
        return final
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> KernelLibrary:
    """Build (once per checkout and source state) and load the kernels."""
    global _library
    with _lock:
        if _library is None:
            nvcc = find_nvcc()
            out_dir = BUILD_ROOT / _digest(nvcc)
            path = out_dir / LIB_NAME
            t0 = time.perf_counter()
            if not path.is_file():
                path = _build(nvcc, out_dir)
            _library = KernelLibrary(path, time.perf_counter() - t0)
        return _library


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library().lib.bigdl_cuda_error_string(code)
        raise RuntimeError(
            f"{kernel}: CUDA launch failed with error {code} "
            f"({msg.decode() if msg else 'unknown'})")


def stream_handle(tensor) -> int:
    """The raw handle of PyTorch's current stream on ``tensor``'s device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
