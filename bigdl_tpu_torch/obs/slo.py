"""SLO monitor: windowed-percentile breach detection that gates health.

Counterpart of ``bigdl_tpu/obs/slo.py`` (stdlib only). It watches the
metric registry with three rules, each off until its limit is set:

- **p99 TTFT**: the ``serving/ttft_ms`` window's p99 over
  ``BIGDL_SLO_TTFT_MS``;
- **feed-stall rate**: ``train/feed_stall`` over the ``train/step_wall``
  count, above ``BIGDL_SLO_STALL_RATE``;
- **throughput floor**: the ``train/throughput`` gauge under
  ``BIGDL_SLO_MIN_TPS``.

A rule needs ``min_count`` samples before it fires. A breach records a
``slo_breach`` robustness event, counts ``slo/breaches``, traces an event
and flips every registered serving engine to ``degraded``
(``set_slo_degraded(True)``); once every rule recovers the flag clears.
:meth:`SLOMonitor.check` is one round (tests call it directly);
:meth:`SLOMonitor.start` runs it every ``BIGDL_SLO_INTERVAL_S`` seconds on
a daemon thread. The fault site ``slo_breach`` forces a synthetic breach
on the Nth check.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from bigdl_tpu_torch.obs import exporter, trace
from bigdl_tpu_torch.obs.registry import registry


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None
    return v if v > 0 else None


class SLOMonitor:
    """Breach detector over the process registry. An explicit limit wins
    over the ``BIGDL_SLO_*`` variable; None turns its rule off."""

    def __init__(self, ttft_p99_ms: Optional[float] = None,
                 stall_rate: Optional[float] = None,
                 min_tps: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 min_count: int = 8):
        self.ttft_p99_ms = (ttft_p99_ms if ttft_p99_ms is not None
                            else _env_float("BIGDL_SLO_TTFT_MS"))
        self.stall_rate = (stall_rate if stall_rate is not None
                           else _env_float("BIGDL_SLO_STALL_RATE"))
        self.min_tps = (min_tps if min_tps is not None
                        else _env_float("BIGDL_SLO_MIN_TPS"))
        self.interval_s = (interval_s if interval_s is not None
                           else (_env_float("BIGDL_SLO_INTERVAL_S") or 5.0))
        self.min_count = min_count
        self.active: dict = {}      # rule -> its current breach
        self.breaches = 0           # transitions from ok to firing
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_env(cls) -> Optional["SLOMonitor"]:
        """A monitor when any ``BIGDL_SLO_*`` rule is set, else None."""
        mon = cls()
        return mon if mon.enabled else None

    @property
    def enabled(self) -> bool:
        return any(v is not None
                   for v in (self.ttft_p99_ms, self.stall_rate, self.min_tps))

    # ------------------------------------------------------------- checking
    def _evaluate(self) -> list:
        """The rules in breach now, as ``{rule, value, limit}`` dicts."""
        snap = registry.snapshot()
        hists = snap["histograms"]
        breaches = []
        if self.ttft_p99_ms is not None:
            h = hists.get("serving/ttft_ms")
            if (h and h["count"] >= self.min_count
                    and h["p99"] is not None and h["p99"] > self.ttft_p99_ms):
                breaches.append({"rule": "ttft_p99_ms",
                                 "value": round(h["p99"], 3),
                                 "limit": self.ttft_p99_ms})
        if self.stall_rate is not None:
            steps = hists.get("train/step_wall", {}).get("count", 0)
            stalls = snap["counters"].get("train/feed_stall", 0)
            if steps >= self.min_count:
                rate = stalls / steps
                if rate > self.stall_rate:
                    breaches.append({"rule": "feed_stall_rate",
                                     "value": round(rate, 4),
                                     "limit": self.stall_rate})
        if self.min_tps is not None:
            tps = snap["gauges"].get("train/throughput")
            if tps is not None and tps < self.min_tps:
                breaches.append({"rule": "throughput_floor",
                                 "value": round(tps, 2),
                                 "limit": self.min_tps})
        # the drill: slo_breach@N forces a breach on the Nth check (a lazy
        # import: obs does not import utils at module load)
        from bigdl_tpu_torch.utils import faults
        if faults.check_fault(faults.SITE_SLO_BREACH) is not None:
            breaches.append({"rule": "injected", "value": 1, "limit": 0})
        return breaches

    def check(self) -> list:
        """One round: find transitions, record breaches, set or clear the
        engines' SLO flag, publish the state. Returns the rules in
        breach."""
        from bigdl_tpu_torch.utils.robustness import events
        current = {b["rule"]: b for b in self._evaluate()}
        for rule, b in current.items():
            if rule not in self.active:
                self.breaches += 1
                registry.counter("slo/breaches").inc()
                trace.event("slo_breach", **b)
                events.record("slo_breach", **b)
        for rule in self.active:
            if rule not in current:
                trace.event("slo_recovered", rule=rule)
        self.active = current
        degraded = bool(current)
        for eng in exporter.engines():
            set_flag = getattr(eng, "set_slo_degraded", None)
            if set_flag is not None:
                try:
                    set_flag(degraded)
                except Exception:
                    pass
        exporter.publish_status("slo", self.state())
        return list(current.values())

    def state(self) -> dict:
        return {"enabled": self.enabled,
                "active": list(self.active.values()),
                "breaches": self.breaches,
                "limits": {"ttft_p99_ms": self.ttft_p99_ms,
                           "stall_rate": self.stall_rate,
                           "min_tps": self.min_tps},
                "interval_s": self.interval_s}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "SLOMonitor":
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="bigdl-slo", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.check()
            except Exception:
                pass   # the monitor never takes the process down


_ACTIVE: Optional[SLOMonitor] = None
_ACTIVE_LOCK = threading.Lock()


def start_from_env() -> Optional[SLOMonitor]:
    """Start the process's monitor once when a ``BIGDL_SLO_*`` rule is set;
    None (allocating nothing) otherwise. Idempotent."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            return _ACTIVE
        mon = SLOMonitor.from_env()
        if mon is None:
            return None
        _ACTIVE = mon.start()
        return _ACTIVE


def active() -> Optional[SLOMonitor]:
    return _ACTIVE


def reset() -> None:
    """Test isolation: stop and drop the process's monitor."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        mon, _ACTIVE = _ACTIVE, None
    if mon is not None:
        mon.stop()
