"""Per-phase training timings.

A copy of ``bigdl_tpu/optim/metrics.py``: a thread-safe accumulator of
host-side phase times (``loss_fetch``, ``validation``, ...) that also
publishes each one to ``obs/registry.py`` as ``phase/<name>``. Device time
per kernel comes from ``torch.profiler`` (``Optimizer.set_profile``).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

from bigdl_tpu_torch.obs.registry import registry as _obs_registry


class Metrics:
    """Thread-safe phase-timing accumulator (the producer thread times
    ``put_batch`` while the step loop times ``feed``/``step_dispatch``).
    Every add also publishes into the process-wide obs registry as
    ``phase/<name>`` — the unified run report reads one source."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sums: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._sums[name] += seconds
            self._counts[name] += 1
        _obs_registry.histogram("phase/" + name).observe(seconds)

    def timer(self, name: str):
        return _Timer(self, name)

    def summary(self) -> dict[str, float]:
        """Mean seconds per phase occurrence."""
        with self._lock:
            return {k: self._sums[k] / max(self._counts[k], 1) for k in self._sums}

    def totals(self) -> dict[str, float]:
        """Total seconds per phase."""
        with self._lock:
            return dict(self._sums)

    def counts(self) -> dict[str, int]:
        """Occurrences per phase (feed-stage attribution needs sums AND
        counts to diff mean ms across a window)."""
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._sums.clear()
            self._counts.clear()

    def __repr__(self):
        parts = ", ".join(f"{k} {v * 1e3:.2f}ms" for k, v in sorted(self.summary().items()))
        return f"Metrics({parts})"


class _Timer:
    def __init__(self, metrics: Metrics, name: str):
        self.metrics, self.name = metrics, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metrics.add(self.name, time.perf_counter() - self.t0)
        return False
