"""Hang watchdog: turn a silent stall into a report.

Counterpart of ``bigdl_tpu/obs/watchdog.py`` (stdlib only). A monitor
thread watches a loop's heartbeat (the serving engine beats after each
decode tick's host read). When the time since the last beat exceeds the
limit, the smaller of the hard ``BIGDL_WATCHDOG_S`` timeout and
``BIGDL_WATCHDOG_FACTOR`` (default 10) times the median of the last 64
recorded durations (once there are 5, floored at 0.25 s), it dumps every
Python thread's stack, the tracer's open spans and each context
provider's in-flight requests to stderr, the JSONL event log and the
optional ``sink``, once a stall. A later heartbeat re-arms it.

The watchdog arms at its first heartbeat and :meth:`HangWatchdog.disarm`
returns it to the unarmed state (an idle engine is not a hang). ``clock``
(default ``time.perf_counter``) is the time source of the heartbeats and
of :meth:`HangWatchdog.check`, one round of the monitor, which a test calls
directly after advancing an injected clock.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
import weakref
from collections import deque
from typing import Callable, Optional

from bigdl_tpu_torch.obs import trace

#: the ratio rule's floor: a sub-ms median must not make a 10 ms hiccup a
#: hang
_MIN_LIMIT_S = 0.25

#: running watchdogs (weakly held); /healthz reads their arm state
_ACTIVE: "weakref.WeakSet" = weakref.WeakSet()

#: callables whose dict is added to every stall dump (the serving engine's
#: in-flight requests)
_CONTEXT_PROVIDERS: list = []


def active_watchdogs() -> list:
    """Watchdogs whose monitor thread is running."""
    return [wd for wd in _ACTIVE if wd._thread is not None]


def add_context_provider(fn: Callable[[], dict]) -> None:
    """Register a zero-argument callable whose dict joins stall dumps
    (idempotent; a provider's error is skipped at dump time)."""
    if fn not in _CONTEXT_PROVIDERS:
        _CONTEXT_PROVIDERS.append(fn)


def remove_context_provider(fn: Callable[[], dict]) -> None:
    try:
        _CONTEXT_PROVIDERS.remove(fn)
    except ValueError:
        pass


def clear_context_providers() -> None:
    """Test isolation."""
    _CONTEXT_PROVIDERS.clear()


def from_env() -> Optional["HangWatchdog"]:
    """A watchdog from ``BIGDL_WATCHDOG_S`` and ``BIGDL_WATCHDOG_FACTOR``,
    or None when the timeout is unset or not positive."""
    raw = os.environ.get("BIGDL_WATCHDOG_S", "").strip()
    if not raw:
        return None
    try:
        hard = float(raw)
    except ValueError:
        raise ValueError(
            f"BIGDL_WATCHDOG_S must be a number of seconds, got {raw!r}"
        ) from None
    if hard <= 0:
        return None
    factor = float(os.environ.get("BIGDL_WATCHDOG_FACTOR", "10"))
    return HangWatchdog(hard_s=hard, factor=factor)


class HangWatchdog:
    """Monitor thread and heartbeat API. ``sink`` receives the dump text
    besides stderr and the event log."""

    def __init__(self, hard_s: Optional[float] = None, factor: float = 10.0,
                 poll_s: Optional[float] = None,
                 sink: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if hard_s is None and factor <= 0:
            raise ValueError("watchdog needs a hard timeout or a factor")
        self.hard_s = hard_s
        self.factor = factor
        self.sink = sink
        self.clock = clock
        self.dumps = 0
        self._durs: deque = deque(maxlen=64)
        self._last: Optional[float] = None   # None: not armed
        self._dumped = False
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._check_lock = threading.Lock()   # monitor thread vs callers
        bound = hard_s if hard_s is not None else 1.0
        self._poll_s = poll_s if poll_s is not None else max(0.05, bound / 8)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="bigdl-watchdog", daemon=True)
        self._thread.start()
        _ACTIVE.add(self)

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        self._thread = None
        _ACTIVE.discard(self)

    @property
    def armed(self) -> bool:
        """True once a heartbeat landed and no disarm since: the monitor
        would flag a silence now."""
        return self._last is not None

    def heartbeat(self, duration_s: Optional[float] = None) -> None:
        """Mark a completed step (recording its duration into the median's
        window when given) and re-arm the dump."""
        if duration_s is not None:
            self._durs.append(float(duration_s))
        self._last = self.clock()
        self._dumped = False

    def disarm(self) -> None:
        """Back to the unarmed state: a quiet engine waiting for arrivals
        is not a hang."""
        self._last = None
        self._dumped = False

    # ------------------------------------------------------------- monitor
    def limit(self) -> Optional[float]:
        """The current limit in seconds (None: no rule can fire yet)."""
        limits = []
        if self.hard_s is not None:
            limits.append(self.hard_s)
        if self.factor > 0 and len(self._durs) >= 5:
            med = sorted(self._durs)[len(self._durs) // 2]
            limits.append(max(self.factor * med, _MIN_LIMIT_S))
        return min(limits) if limits else None

    def check(self) -> bool:
        """One monitor round: dump when armed, not yet dumped for this
        silence, and past the limit. Returns True when it dumped."""
        with self._check_lock:
            last = self._last
            if last is None or self._dumped:
                return False
            limit = self.limit()
            if limit is None:
                return False
            elapsed = self.clock() - last
            if elapsed <= limit:
                return False
            self._dumped = True
            self.dumps += 1
        try:
            self.dump(elapsed, limit)
        except Exception:
            traceback.print_exc(file=sys.stderr)
        return True

    def _run(self) -> None:
        while not self._stop_evt.wait(self._poll_s):
            self.check()

    # ---------------------------------------------------------------- dump
    @staticmethod
    def thread_stacks() -> dict:
        """{thread name (id): formatted stack} of every live Python
        thread."""
        names = {t.ident: t.name for t in threading.enumerate()}
        out = {}
        for tid, frame in sys._current_frames().items():
            out[f"{names.get(tid, '?')} ({tid})"] = "".join(
                traceback.format_stack(frame))
        return out

    def dump(self, elapsed: float, limit: float) -> None:
        """Write the stall report: every thread's stack, the open spans
        (none unless ``BIGDL_TRACE`` is on) and the providers' contexts."""
        stacks = self.thread_stacks()
        spans = trace.open_spans()
        contexts = []
        for provider in list(_CONTEXT_PROVIDERS):
            try:
                ctx = provider()
            except Exception:
                continue
            if ctx:
                contexts.append(ctx)
        lines = [
            "=" * 70,
            f"BIGDL WATCHDOG: no step completed for {elapsed:.1f}s "
            f"(limit {limit:.1f}s, median of last {len(self._durs)} steps: "
            + (f"{sorted(self._durs)[len(self._durs) // 2] * 1e3:.1f} ms)"
               if self._durs else "n/a)"),
            "possible hang — dumping all thread stacks and open spans",
        ]
        for label, entries in spans.items():
            chain = " > ".join(
                f"{e['name']} ({e['age_ms']:.0f}ms)" for e in entries)
            lines.append(f"open spans [{label}]: {chain}")
        if not spans:
            lines.append("open spans: none recorded (BIGDL_TRACE off?)")
        for ctx in contexts:
            who = ctx.get("engine", ctx.get("name", "?"))
            lines.append(f"in-flight [{who}] "
                         f"(health {ctx.get('health', '?')}):")
            flights = ctx.get("in_flight") or []
            for f in flights:
                lines.append(
                    f"  trace {f.get('trace_id')} request "
                    f"{f.get('request_id')} slot {f.get('slot')} "
                    f"generated {f.get('generated')} "
                    f"age {f.get('age_ms')}ms")
            if not flights:
                lines.append("  (no requests in flight)")
        for label, stack in stacks.items():
            lines.append(f"--- thread {label} ---")
            lines.append(stack.rstrip())
        lines.append("=" * 70)
        text = "\n".join(lines)
        print(text, file=sys.stderr, flush=True)
        trace.event("watchdog_dump", elapsed_s=round(elapsed, 3),
                    limit_s=round(limit, 3), threads=stacks,
                    open_spans=spans, contexts=contexts)
        if self.sink is not None:
            self.sink(text)
