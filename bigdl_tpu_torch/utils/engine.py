"""The compute-dtype part of the process-wide ``Engine``.

Counterpart of the compute-dtype knob of ``bigdl_tpu/utils/engine.py``:
``EngineConfig.compute_dtype``, ``_parse_dtype`` (the same names, read from
the same ``BIGDL_COMPUTE_DTYPE`` variable), ``Engine.init(compute_dtype=)``,
``Engine.compute_dtype()``, ``Engine.set_compute_dtype`` and
``Engine.reset``. As in JAX, an accessor called before ``init`` initialises
with the defaults. The trainer reads the dtype to run its mixed-precision
step (``optim/optimizer.py``); nothing on the serving path reads it.

Device and mesh selection are not ported yet (ROADMAP Queue A.6).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass
class EngineConfig:
    compute_dtype: Any = None      # dtype of the step's compute (None = fp32)


def _parse_dtype(name: str) -> torch.dtype:
    table = {"float32": torch.float32, "fp32": torch.float32,
             "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
             "float16": torch.float16, "fp16": torch.float16}
    if name not in table:
        raise ValueError(f"Unsupported BIGDL_COMPUTE_DTYPE={name!r}; one of "
                         f"{list(table)}")
    return table[name]


class _EngineState:
    def __init__(self) -> None:
        self.initialized = False
        self.config = EngineConfig()
        self.lock = threading.Lock()


_STATE = _EngineState()


class Engine:
    """Process-wide runtime settings; all methods are classmethods."""

    @classmethod
    def init(cls, compute_dtype: Optional[torch.dtype] = None) -> None:
        """Set the step's compute dtype: ``compute_dtype``, else
        ``BIGDL_COMPUTE_DTYPE`` (default float32). Master parameters stay
        fp32. A second call replaces the first."""
        with _STATE.lock:
            cfg = EngineConfig()
            cfg.compute_dtype = (compute_dtype if compute_dtype is not None
                                 else _parse_dtype(os.environ.get(
                                     "BIGDL_COMPUTE_DTYPE", "float32")))
            _STATE.config = cfg
            _STATE.initialized = True

    @classmethod
    def is_initialized(cls) -> bool:
        return _STATE.initialized

    @classmethod
    def _require_init(cls) -> None:
        if not _STATE.initialized:
            cls.init()

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
        """Forget the settings (tests); the next accessor re-initialises."""
        _STATE.initialized = False
        _STATE.config = EngineConfig()
