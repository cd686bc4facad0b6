"""The process-wide ``Engine``: compute dtype, retry settings, and the
device mesh over ``torch.distributed``.

Counterpart of ``bigdl_tpu/utils/engine.py``. The compute-dtype and retry
parts keep JAX's names and variables: ``EngineConfig.compute_dtype``,
``_parse_dtype`` (``BIGDL_COMPUTE_DTYPE``), ``failure_retry_times`` and
``failure_retry_interval`` (``BIGDL_FAILURE_RETRY_TIMES``, default 5, and
``BIGDL_FAILURE_RETRY_INTERVAL``, default 15 s), ``Engine.compute_dtype()``,
``Engine.set_compute_dtype`` and ``seed`` (``BIGDL_SEED``, default 1), the
seed material of the vision transformers (unlike JAX's, ``init`` does not
reseed ``RandomGenerator``). An accessor called before ``init``
initialises with the defaults.

**The mesh.** JAX runs one program over a mesh of devices; the port runs
one process per rank (``torchrun`` or :func:`bigdl_tpu_torch.dryrun.spawn`)
and each holds its part of every array. :class:`Mesh` maps the ranks onto
named axes row-major, as ``np.asarray(devices).reshape(mesh_shape)`` does
(``bigdl_tpu/utils/engine.py:255-270``), and holds one process group per
slice of each axis: the ranks that differ only in that axis' coordinate.
The default mesh is 1-D ``("data",)`` over the world; a ``mesh_shape``
whose product is not the world size raises JAX's error.

The backend: ``None`` (or ``BIGDL_BACKEND``, or ``"auto"``) is NCCL on
``cuda:LOCAL_RANK`` and raises without a card; ``"cpu"`` is gloo on the
CPU (the tests); ``"gloo"`` is gloo with the ranks' tensors on
``cuda:LOCAL_RANK % device_count``, so that several ranks can share one
card (gloo moves host memory: ``parallel/collectives.py`` stages CUDA
tensors through the host by rule). Rank, world size and address come from
the arguments (``process_id``, ``node_number``, ``coordinator_address``:
``host:port`` or an init-method URL such as ``file:///path``) or from
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``); one process with none of them is world 1
over an in-process store. The runtime comes up at ``init`` when it is
asked for (a backend, a mesh, an address or ``torchrun``'s environment),
else at the first call of :meth:`Engine.mesh` or :meth:`Engine.device`.
``reset`` forgets the mesh and its groups but keeps the default process
group, as JAX's keeps its distributed client; ``shutdown_distributed``
destroys it.
"""

from __future__ import annotations

import datetime
import logging
import os
import threading
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)


@dataclass
class EngineConfig:
    compute_dtype: Any = None      # dtype of the step's compute (None = fp32)
    seed: int = 1                  # seed material of the vision transformers
    failure_retry_times: int = 5           # retries from the last checkpoint
    failure_retry_interval: float = 15.0   # seconds between them
    backend: Optional[str] = None  # "nccl" | "gloo" | "cpu" (None: auto)
    node_number: int = 1           # world size (JAX: processes)
    core_number: int = 1           # local ranks


def _parse_dtype(name: str) -> torch.dtype:
    table = {"float32": torch.float32, "fp32": torch.float32,
             "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
             "float16": torch.float16, "fp16": torch.float16}
    if name not in table:
        raise ValueError(f"Unsupported BIGDL_COMPUTE_DTYPE={name!r}; one of "
                         f"{list(table)}")
    return table[name]


class Mesh:
    """Ranks on named axes, row-major, with a process group a slice of
    each axis. ``shape`` maps each axis to its size, as JAX's
    ``mesh.shape`` does; ``devices`` is the rank grid."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 rank: int, backend: str):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.devices = np.arange(int(np.prod(shape))).reshape(tuple(shape))
        self.rank = rank
        self.backend = backend
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.argwhere(self.devices == rank)[0])))
        self._groups: dict = {}
        self._owned: list = []
        world = torch.distributed.group.WORLD
        for a, axis in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, a, -1).reshape(
                -1, self.shape[axis])
            for line in lines:
                ranks = [int(r) for r in line]
                if len(ranks) == self.devices.size:
                    group = world
                else:
                    # every rank creates every group, in one order
                    group = torch.distributed.new_group(ranks)
                    self._owned.append(group)
                if rank in ranks:
                    self._groups[axis] = (group, ranks)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        return self._groups[axis][0]

    def group_ranks(self, axis: str) -> list:
        """The global ranks of this rank's slice of ``axis``, in order."""
        return list(self._groups[axis][1])

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 without the axis)."""
        return self.coords.get(axis, 0)

    def destroy(self) -> None:
        for g in self._owned:
            try:
                torch.distributed.destroy_process_group(g)
            except (RuntimeError, ValueError):
                pass
        self._owned = []

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, backend={self.backend})"


class _EngineState:
    def __init__(self) -> None:
        self.initialized = False
        self.config = EngineConfig()
        self.lock = threading.RLock()
        self.mesh: Optional[Mesh] = None
        self.mesh_request = None       # (shape, axes) for a lazy bring-up
        self.dist_args: dict = {}
        self.device: Optional[torch.device] = None


_STATE = _EngineState()


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


class Engine:
    """Process-wide runtime settings; all methods are classmethods."""

    DATA_AXIS = "data"    # batch / data-parallel mesh axis
    MODEL_AXIS = "model"  # tensor- and expert-parallel axis
    SEQ_AXIS = "seq"      # sequence-parallel axis (ring attention)
    PIPE_AXIS = "pipe"    # pipeline-parallel axis

    @classmethod
    def init(cls, compute_dtype: Optional[torch.dtype] = None,
             seed: Optional[int] = None, backend: Optional[str] = None,
             mesh_shape: Optional[Sequence[int]] = None,
             mesh_axes: Optional[Sequence[str]] = None,
             coordinator_address: Optional[str] = None,
             process_id: Optional[int] = None,
             node_number: Optional[int] = None,
             core_number: Optional[int] = None) -> None:
        """Set the step's compute dtype (``compute_dtype``, else
        ``BIGDL_COMPUTE_DTYPE``, default float32) and the retry settings,
        and record the mesh: ``mesh_shape`` over ``mesh_axes`` (default
        the first ``len(mesh_shape)`` of data, model, seq, pipe), 1-D
        ``("data",)`` over the world without one. A second call replaces
        the first's settings and mesh. Master parameters stay fp32."""
        with _STATE.lock:
            cfg = EngineConfig()
            cfg.compute_dtype = (compute_dtype if compute_dtype is not None
                                 else _parse_dtype(os.environ.get(
                                     "BIGDL_COMPUTE_DTYPE", "float32")))
            cfg.seed = int(seed if seed is not None
                           else os.environ.get("BIGDL_SEED", "1"))
            cfg.failure_retry_times = int(
                os.environ.get("BIGDL_FAILURE_RETRY_TIMES", "5"))
            cfg.failure_retry_interval = float(
                os.environ.get("BIGDL_FAILURE_RETRY_INTERVAL", "15"))
            cfg.backend = backend or os.environ.get("BIGDL_BACKEND") or None
            if cfg.backend == "auto":
                cfg.backend = None
            if cfg.backend not in (None, "nccl", "gloo", "cpu"):
                raise ValueError(f"backend must be 'nccl', 'gloo' or 'cpu', "
                                 f"got {cfg.backend!r}")
            if _STATE.mesh is not None:
                _STATE.mesh.destroy()
            _STATE.mesh = None
            _STATE.device = None
            _STATE.config = cfg
            _STATE.mesh_request = (
                None if mesh_shape is None else tuple(mesh_shape),
                None if mesh_axes is None else tuple(mesh_axes))
            _STATE.dist_args = {"address": coordinator_address,
                                "rank": process_id, "world": node_number,
                                "local": core_number}
            _STATE.initialized = True
            eager = (backend is not None or mesh_shape is not None
                     or coordinator_address is not None
                     or process_id is not None or node_number is not None
                     or _env_int("WORLD_SIZE") is not None)
        if eager:
            cls.mesh()

    # ------------------------------------------------------------ the mesh
    @classmethod
    def _backend(cls) -> str:
        b = _STATE.config.backend
        if b is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Engine: no CUDA device for the default NCCL backend; "
                    "pass Engine.init(backend='cpu') to run on the CPU over "
                    "gloo")
            return "nccl"
        if b in ("nccl", "gloo") and not torch.cuda.is_available():
            raise RuntimeError(f"Engine: backend {b!r} needs a CUDA device; "
                               f"backend='cpu' runs on the CPU")
        return b

    @classmethod
    def _bring_up(cls) -> None:
        dist = torch.distributed
        backend = cls._backend()
        args = _STATE.dist_args
        rank = args["rank"] if args["rank"] is not None \
            else _env_int("RANK")
        world = args["world"] if args["world"] is not None \
            else _env_int("WORLD_SIZE")
        local = _env_int("LOCAL_RANK")
        address = args["address"]
        rank = 0 if rank is None else rank
        world = 1 if world is None else world
        local = rank if local is None else local
        if backend == "cpu":
            device = torch.device("cpu")
        else:
            device = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(device)
        pg_backend = "nccl" if backend == "nccl" else "gloo"
        if dist.is_initialized():
            if dist.get_world_size() != world and args["world"] is not None:
                raise RuntimeError(
                    f"Engine.init: a process group of world "
                    f"{dist.get_world_size()} is live; call "
                    f"Engine.shutdown_distributed() before asking for "
                    f"world {world}")
            have = dist.get_backend()
            if have != pg_backend:
                raise RuntimeError(
                    f"Engine.init: the live process group runs {have!r}, "
                    f"not {pg_backend!r}; call Engine.shutdown_distributed() "
                    f"first")
        else:
            timeout = datetime.timedelta(seconds=float(os.environ.get(
                "BIGDL_INIT_TIMEOUT", "300")))
            kw = {"backend": pg_backend, "rank": rank, "world_size": world,
                  "timeout": timeout}
            if pg_backend == "nccl":
                kw["device_id"] = device
            if address is not None:
                kw["init_method"] = (address if "://" in address
                                     else f"tcp://{address}")
            elif world == 1 and os.environ.get("MASTER_ADDR") is None:
                kw["store"] = dist.HashStore()
            else:
                kw["init_method"] = "env://"
            dist.init_process_group(**kw)
        _STATE.device = device
        cfg = _STATE.config
        cfg.backend = backend
        cfg.node_number = dist.get_world_size()
        cfg.core_number = args["local"] or int(os.environ.get(
            "LOCAL_WORLD_SIZE", cfg.node_number))

    @classmethod
    def _build_mesh(cls) -> Mesh:
        shape, axes = _STATE.mesh_request
        world = torch.distributed.get_world_size()
        if shape is None:
            shape, axes = (world,), (cls.DATA_AXIS,)
        elif axes is None:
            axes = (cls.DATA_AXIS, cls.MODEL_AXIS, cls.SEQ_AXIS,
                    cls.PIPE_AXIS)[:len(shape)]
        if len(axes) != len(shape):
            raise ValueError(f"mesh_axes {tuple(axes)} do not name the "
                             f"{len(shape)} dims of mesh_shape {tuple(shape)}")
        n = int(np.prod(shape))
        if n != world:
            raise ValueError(
                f"mesh_shape {tuple(shape)} needs {n} devices but "
                f"{world} are available: ranks {list(range(world))}")
        return Mesh(shape, axes, torch.distributed.get_rank(),
                    _STATE.config.backend)

    @classmethod
    def mesh(cls) -> Mesh:
        """The device mesh (1-D ``("data",)`` over the world unless
        ``init`` asked for another); brings the runtime up if needed."""
        cls._require_init()
        with _STATE.lock:
            if _STATE.mesh is None:
                if _STATE.device is None or \
                        not torch.distributed.is_initialized():
                    cls._bring_up()
                _STATE.mesh = cls._build_mesh()
                logger.info("Engine mesh %s on %s", _STATE.mesh,
                            _STATE.device)
            return _STATE.mesh

    @classmethod
    def mesh_if_up(cls) -> Optional[Mesh]:
        """The mesh when it is up, else None (never brings it up)."""
        return _STATE.mesh

    @classmethod
    def set_mesh(cls, mesh: Mesh) -> None:
        cls._require_init()
        _STATE.mesh = mesh

    @classmethod
    def device(cls) -> torch.device:
        """This rank's device: ``cuda:LOCAL_RANK`` (NCCL, gloo) or the
        CPU (``backend='cpu'``)."""
        cls.mesh()
        return _STATE.device

    @classmethod
    def devices(cls) -> list:
        """The mesh's ranks in order (JAX: its devices)."""
        return [int(r) for r in cls.mesh().devices.reshape(-1)]

    @classmethod
    def device_count(cls) -> int:
        """Ranks in the mesh (the reference's nodeNumber x coreNumber)."""
        return cls.mesh().size

    @classmethod
    def local_device_count(cls) -> int:
        cls.mesh()
        return _STATE.config.core_number

    @classmethod
    def node_number(cls) -> int:
        cls.mesh()
        return _STATE.config.node_number

    @classmethod
    def rank(cls) -> int:
        return cls.mesh().rank

    @classmethod
    def shutdown_distributed(cls, timeout: Optional[float] = None) -> None:
        """Destroy the mesh's groups and the default process group (JAX:
        ``jax.distributed.shutdown``), waiting at most ``timeout`` seconds
        (default ``BIGDL_INIT_TIMEOUT``) for the peers' barrier; a
        timeout leaves the group abandoned and logs it."""
        with _STATE.lock:
            if _STATE.mesh is not None:
                _STATE.mesh.destroy()
            _STATE.mesh = None
            _STATE.device = None
            if not torch.distributed.is_initialized():
                return
            if timeout is None:
                timeout = float(os.environ.get("BIGDL_INIT_TIMEOUT", "300"))
            done = threading.Event()

            def destroy():
                try:
                    torch.distributed.destroy_process_group()
                finally:
                    done.set()

            t = threading.Thread(target=destroy, name="bigdl-dist-shutdown",
                                 daemon=True)
            t.start()
            if not done.wait(timeout):
                logger.error("Engine.shutdown_distributed: the process group "
                             "did not shut down within %.0f s", timeout)

    # --------------------------------------------------------- settings
    @classmethod
    def is_initialized(cls) -> bool:
        return _STATE.initialized

    @classmethod
    def _require_init(cls) -> None:
        if not _STATE.initialized:
            cls.init()

    @classmethod
    def config(cls) -> EngineConfig:
        cls._require_init()
        return _STATE.config

    @classmethod
    def compute_dtype(cls) -> torch.dtype:
        cls._require_init()
        return _STATE.config.compute_dtype

    @classmethod
    def set_compute_dtype(cls, dtype: torch.dtype) -> None:
        cls._require_init()
        _STATE.config.compute_dtype = dtype

    @classmethod
    def reset(cls) -> None:
        """Forget the settings and the mesh (tests); the default process
        group stays up (:meth:`shutdown_distributed` ends it). The next
        accessor re-initialises."""
        with _STATE.lock:
            if _STATE.mesh is not None:
                _STATE.mesh.destroy()
            _STATE.mesh = None
            _STATE.device = None
            _STATE.mesh_request = None
            _STATE.dist_args = {}
            _STATE.initialized = False
            _STATE.config = EngineConfig()
