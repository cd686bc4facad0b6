"""Thread-aware span tracer: Chrome-trace export and a JSONL event log.

A copy of ``bigdl_tpu/obs/trace.py`` (stdlib only). ``span(name)`` records
(name, thread, start, duration) when ``BIGDL_TRACE`` is truthy (a no-op
singleton otherwise); :func:`event` appends structured records (robustness
events) to the JSONL log named by ``BIGDL_OBS_LOG``; :func:`export_chrome`
writes the spans as Chrome-trace JSON under ``BIGDL_TRACE_DIR``. The port's
trainer opens ``ckpt/write`` spans on its checkpoint writer thread.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

#: finished-span buffer bound; beyond it spans are counted, not stored
_MAX_SPANS = 262_144

_lock = threading.Lock()
_ENABLED = False
_EXPLICIT = False          # configure() wins over configure_from_env()
_TRACE_DIR: Optional[str] = None
_JSONL_PATH: Optional[str] = None
_JSONL_FILE = None

_finished: list = []       # (name, tid, t0_s, dur_s, args)
_dropped = 0
_totals: dict = {}         # name -> [count, total_seconds]
_threads: dict = {}        # tid -> thread name (as of first span)
_open_stacks: dict = {}    # tid -> [(name, t0_s), ...] — owner-thread writes

#: _Span instances ever constructed — the zero-alloc-when-disabled pin
_SPANS_CREATED = 0


def _truthy(raw: Optional[str]) -> bool:
    return (raw or "").strip().lower() not in ("", "0", "false", "no", "off")


def configure(enabled: Optional[bool] = None, trace_dir: Optional[str] = None,
              jsonl: Optional[str] = None) -> None:
    """Explicit configuration (tests / bench legs). Overrides the environment
    until :func:`reset`."""
    global _ENABLED, _EXPLICIT, _TRACE_DIR, _JSONL_PATH
    with _lock:
        _EXPLICIT = True
        if trace_dir is not None:
            _TRACE_DIR = trace_dir
        if enabled is not None:
            _ENABLED = bool(enabled)
        if jsonl is not None:
            _set_jsonl(jsonl)
        elif _ENABLED and _JSONL_PATH is None:
            _set_jsonl(os.path.join(_dir_locked(), f"events-{os.getpid()}.jsonl"))


def configure_from_env() -> None:
    """Re-read ``BIGDL_TRACE`` / ``BIGDL_TRACE_DIR`` / ``BIGDL_OBS_LOG``.
    Called at the top of every training run (cheap); a prior explicit
    :func:`configure` sticks."""
    global _ENABLED, _TRACE_DIR, _JSONL_PATH
    if _EXPLICIT:
        return
    with _lock:
        if _EXPLICIT:
            return
        _ENABLED = _truthy(os.environ.get("BIGDL_TRACE"))
        env_dir = os.environ.get("BIGDL_TRACE_DIR")
        if env_dir:
            _TRACE_DIR = env_dir
        env_log = os.environ.get("BIGDL_OBS_LOG")
        if env_log:
            _set_jsonl(env_log)
        elif _ENABLED and _JSONL_PATH is None:
            _set_jsonl(os.path.join(_dir_locked(), f"events-{os.getpid()}.jsonl"))


def _dir_locked() -> str:
    global _TRACE_DIR
    if _TRACE_DIR is None:
        _TRACE_DIR = os.environ.get("BIGDL_TRACE_DIR") or "bigdl-trace"
    return _TRACE_DIR


def _set_jsonl(path: str) -> None:
    global _JSONL_PATH, _JSONL_FILE
    if path == _JSONL_PATH:
        return
    if _JSONL_FILE is not None:
        try:
            _JSONL_FILE.close()
        except Exception:
            pass
    _JSONL_PATH = path
    _JSONL_FILE = None  # opened lazily on first event


def enabled() -> bool:
    return _ENABLED


def trace_dir() -> Optional[str]:
    return _TRACE_DIR


def jsonl_path() -> Optional[str]:
    return _JSONL_PATH


def chrome_path() -> Optional[str]:
    if not _ENABLED:
        return None
    return os.path.join(_dir_locked(), f"trace-{os.getpid()}.json")


# ------------------------------------------------------------------- spans
class _NullSpan:
    """Shared no-op context manager — the whole disabled hot path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "_t0", "_tid")

    def __init__(self, name: str, args):
        global _SPANS_CREATED
        _SPANS_CREATED += 1
        self.name = name
        self.args = args

    def __enter__(self):
        tid = threading.get_ident()
        self._tid = tid
        stack = _open_stacks.get(tid)
        if stack is None:
            # first span on this thread: register its name for the trace
            _open_stacks[tid] = stack = []
            _threads[tid] = threading.current_thread().name
        self._t0 = time.perf_counter()
        stack.append((self.name, self._t0))
        return self

    def __exit__(self, *exc):
        global _dropped
        t1 = time.perf_counter()
        stack = _open_stacks.get(self._tid)
        if stack:
            stack.pop()
        dur = t1 - self._t0
        with _lock:
            tot = _totals.get(self.name)
            if tot is None:
                _totals[self.name] = [1, dur]
            else:
                tot[0] += 1
                tot[1] += dur
            if len(_finished) < _MAX_SPANS:
                _finished.append((self.name, self._tid, self._t0, dur,
                                  self.args))
            else:
                _dropped += 1
        return False


def span(name: str, args: Optional[dict] = None):
    """Context manager timing a named span on the current thread. When
    tracing is disabled this returns a module singleton — no allocation, no
    bookkeeping (``args`` must be passed as a dict, not ``**kwargs``, so the
    disabled call builds nothing)."""
    if not _ENABLED:
        return _NULL
    return _Span(name, args)


def span_totals() -> dict:
    """{name: {"count": n, "total_ms": ms}} aggregated over every finished
    span (survives :func:`export_chrome`; empty when tracing was off)."""
    with _lock:
        return {name: {"count": c, "total_ms": round(t * 1e3, 3)}
                for name, (c, t) in _totals.items()}


def open_spans() -> dict:
    """Live per-thread open-span stacks (outermost first) with ages — the
    watchdog's view of what every thread is in the middle of."""
    now = time.perf_counter()
    out = {}
    for tid, stack in list(_open_stacks.items()):
        entries = [{"name": n, "age_ms": round((now - t0) * 1e3, 1)}
                   for n, t0 in list(stack)]
        if entries:
            out[f"{_threads.get(tid, '?')} ({tid})"] = entries
    return out


# ------------------------------------------------------------- JSONL events
def event(kind: str, **payload) -> None:
    """Append one structured record to the JSONL event log (no-op when no
    log is configured). Flushed immediately: watchdog dumps and run reports
    must be on disk even if the process never exits cleanly."""
    global _JSONL_FILE
    if _JSONL_PATH is None:
        return
    rec = {"ts": time.time(), "kind": kind}
    rec.update(payload)
    line = json.dumps(rec, default=str) + "\n"
    with _lock:
        if _JSONL_FILE is None:
            d = os.path.dirname(_JSONL_PATH)
            if d:
                os.makedirs(d, exist_ok=True)
            _JSONL_FILE = open(_JSONL_PATH, "a")
        _JSONL_FILE.write(line)
        _JSONL_FILE.flush()


def read_events(path: str) -> list:
    """Decode a JSONL event log back into a list of dicts (the ``diag``
    subcommand's input; blank/truncated tail lines are skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line (crash mid-write)
    return out


# ------------------------------------------------------------ chrome export
def export_chrome(path: Optional[str] = None) -> Optional[str]:
    """Write every finished span as a Chrome-trace JSON file (``X`` complete
    events, per-thread ``tid``, thread-name metadata). Returns the path, or
    None when tracing is disabled. Idempotent — the span buffer is kept."""
    if not _ENABLED:
        return None
    path = path or chrome_path()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    pid = os.getpid()
    with _lock:
        spans = list(_finished)
        threads = dict(_threads)
        dropped = _dropped
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
               "args": {"name": "bigdl-tpu"}}]
    for tid, name in threads.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    for name, tid, t0, dur, args in spans:
        ev = {"name": name, "ph": "X", "cat": "bigdl",
              "ts": round(t0 * 1e6, 3), "dur": round(dur * 1e6, 3),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        events.append(ev)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    event("trace_exported", path=path, spans=len(spans), dropped=dropped)
    return path


def reset() -> None:
    """Drop all recorded state and configuration (tests)."""
    global _ENABLED, _EXPLICIT, _TRACE_DIR, _JSONL_PATH, _JSONL_FILE, _dropped
    with _lock:
        _ENABLED = False
        _EXPLICIT = False
        _TRACE_DIR = None
        if _JSONL_FILE is not None:
            try:
                _JSONL_FILE.close()
            except Exception:
                pass
        _JSONL_PATH = None
        _JSONL_FILE = None
        _finished.clear()
        _totals.clear()
        _threads.clear()
        _open_stacks.clear()
        _dropped = 0


# initial configuration from the process environment (BIGDL_TRACE=1 runs)
configure_from_env()
