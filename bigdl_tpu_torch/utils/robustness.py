"""Process-wide robustness event sink.

A copy of ``bigdl_tpu/utils/robustness.py`` (stdlib only). Every recovery
action is recorded by the layer that took it: the port's trainer records
``resume``, ``preemption``, ``nan_rollback``, ``retry_rollback`` and
``ckpt_quarantined``, and ``utils/faults.py`` records ``fault_injected``.
Each record also bumps the ``robustness/<kind>`` counter of
``obs/registry.py`` and lands in the JSONL event log of ``obs/trace.py``.
``events.snapshot()`` / ``events.deltas(snap)`` give a run's counts.
"""

from __future__ import annotations

import threading
from typing import Optional

from bigdl_tpu_torch.obs import trace as _obs_trace
from bigdl_tpu_torch.obs.registry import registry as _obs_registry

#: recent-event detail log bound — counts are unbounded, details are a window
_LOG_CAP = 256


class RobustnessEvents:
    """Thread-safe counter + bounded detail log. One process-wide instance
    (``events``); producer threads, decode pools, and the training loop all
    record into it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._log: list[dict] = []

    def record(self, kind: str, **info) -> None:
        with self._lock:
            self._counts[kind] = self._counts.get(kind, 0) + 1
            if len(self._log) < _LOG_CAP:
                entry = {"kind": kind}
                entry.update(info)
                self._log.append(entry)
        # unified rails: the counter is readable from the obs registry and
        # the action lands in the structured JSONL event log (when active)
        _obs_registry.counter("robustness/" + kind).inc()
        _obs_trace.event("robustness", event=kind, **info)

    def counts(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def snapshot(self) -> dict:
        """Baseline for :meth:`deltas` — take one at run start so a report
        covers THIS run, not the process's whole history."""
        return self.counts()

    def deltas(self, snapshot: dict) -> dict:
        """Per-kind counts accrued since ``snapshot`` (zero-delta kinds
        omitted)."""
        now = self.counts()
        out = {}
        for kind, n in now.items():
            d = n - snapshot.get(kind, 0)
            if d > 0:
                out[kind] = d
        return out

    def recent(self, kind: Optional[str] = None) -> list:
        with self._lock:
            log = list(self._log)
        if kind is None:
            return log
        return [e for e in log if e["kind"] == kind]

    def format_report(self, counts: Optional[dict] = None) -> str:
        """One-line-per-kind human report (the end-of-run robustness
        summary)."""
        counts = self.counts() if counts is None else counts
        if not counts:
            return "no robustness events"
        return "; ".join(f"{kind}={n}" for kind, n in sorted(counts.items()))

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._log.clear()


#: the process-wide sink
events = RobustnessEvents()
