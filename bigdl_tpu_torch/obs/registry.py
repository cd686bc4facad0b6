"""Process-wide metric registry: counters, gauges and histograms.

A copy of ``bigdl_tpu/obs/registry.py`` (stdlib only). The port's trainer
observes ``ckpt/stall_ms`` (how long the loop thread was held by a
checkpoint), counts ``ckpt/bytes`` and ``robustness/<kind>``, and times its
phases as ``phase/<name>``; ``MetricRegistry.snapshot`` diffs give a run's
share, since the registry outlives runs.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

#: histogram percentile window (recent observations; percentiles are over
#: this window, sums/counts are exact over the process lifetime)
_WINDOW = 4096


class Counter:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Exact (sum, count, min, max) plus a bounded recent-value window for
    p50/p95/p99 and the watchdog's rolling median."""

    __slots__ = ("_lock", "count", "total", "min", "max", "_window")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._window: deque = deque(maxlen=_WINDOW)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            self._window.append(v)

    def percentiles(self, qs=(50, 95, 99)) -> dict:
        """{q: value} over the recent window (empty dict when no data)."""
        with self._lock:
            vals = sorted(self._window)
        if not vals:
            return {}
        n = len(vals)
        return {q: vals[min(n - 1, int(round(q / 100.0 * (n - 1))))]
                for q in qs}

    def median(self, min_count: int = 8) -> Optional[float]:
        """Rolling median over the window, or None with fewer than
        ``min_count`` observations (the watchdog must not extrapolate from
        one compile-polluted sample)."""
        with self._lock:
            if len(self._window) < min_count:
                return None
            vals = sorted(self._window)
        return vals[len(vals) // 2]


class MetricRegistry:
    """Get-or-create registry of named metrics. Thread-safe; one instance
    per process (:data:`registry`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(self._lock))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(self._lock))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(self._lock))
        return h

    def snapshot(self) -> dict:
        """Plain-data view for delta math and the run report:
        ``{"counters": {name: n}, "gauges": {name: v}, "histograms":
        {name: {count, total, min, max, mean, p50, p95, p99}}}``."""
        # Every histogram field is captured under the registry lock so a
        # concurrent observe() can never tear (count, total, min, max, window)
        # against each other — a snapshot's mean is always total/count of the
        # SAME instant. Sorting the window copies happens outside the lock.
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: g.value for k, g in self._gauges.items()
                      if g.value is not None}
            hists = [(name, h.count, h.total, h.min, h.max, tuple(h._window))
                     for name, h in self._histograms.items() if h.count]
        out_h = {}
        for name, count, total, mn, mx, window in hists:
            vals = sorted(window)
            n = len(vals)
            ps = {q: vals[min(n - 1, int(round(q / 100.0 * (n - 1))))]
                  for q in (50, 95, 99)} if n else {}
            out_h[name] = {
                "count": count, "total": total,
                "min": mn, "max": mx,
                "mean": total / count,
                "p50": ps.get(50), "p95": ps.get(95), "p99": ps.get(99),
            }
        return {"counters": counters, "gauges": gauges, "histograms": out_h}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


#: the process-wide registry every rail publishes into
registry = MetricRegistry()
