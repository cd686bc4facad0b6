"""Degradable input pipeline: the corrupt-sample policy of the decode and
transform stages.

A copy of ``bigdl_tpu/dataset/resilience.py`` (stdlib only).

tf.data's production lesson (PAPERS.md 2101.12127) applies verbatim here: at
dataset scale some records ARE corrupt — truncated JPEGs, bit-rotted shards,
flaky network filesystems — and a pipeline without an explicit policy turns
one bad byte into a dead training job (the exception fires in a decode-pool
or producer thread and takes the whole feed down). This module centralizes
the policy:

- ``BIGDL_BAD_SAMPLE_POLICY`` — ``raise`` (default: fail loudly, the classic
  behavior, byte-for-byte unchanged), ``skip`` (drop the record, count it),
  or ``retry`` (re-execute with bounded exponential backoff — for transient
  IO — then propagate if it still fails; each attempt is counted).
- ``BIGDL_SAMPLE_RETRIES`` — retry attempts per record under ``retry``
  (default 3); ``BIGDL_RETRY_BACKOFF_MS`` — first backoff (default 10 ms,
  doubling, capped at 1 s).
- Per-stage counters ride the process-wide robustness event sink
  (``utils/robustness.py``) as ``sample_skipped`` / ``sample_retried``
  events tagged with the failing stage, and :func:`stage_counters` exposes a
  per-stage summary for reports and tests.

:class:`~bigdl_tpu_torch.utils.faults.WorkerDeathError` is NEVER absorbed here —
a dead worker is an executor-health event owned by the parallel engine's
crash budget (``dataset/parallel.py``), not a data-quality event.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable

from bigdl_tpu_torch.utils.faults import WorkerDeathError
from bigdl_tpu_torch.utils.robustness import events

logger = logging.getLogger("bigdl_tpu_torch.dataset")

#: sentinel yielded in place of a dropped record; stream stages filter it
SKIPPED = object()

_POLICIES = ("raise", "skip", "retry")
_BACKOFF_CAP_S = 1.0

_counter_lock = threading.Lock()
_stage_counters: dict[str, dict[str, int]] = {}


def bad_sample_policy() -> str:
    raw = os.environ.get("BIGDL_BAD_SAMPLE_POLICY", "raise").strip().lower()
    if raw not in _POLICIES:
        raise ValueError(
            f"BIGDL_BAD_SAMPLE_POLICY must be one of {_POLICIES}, got {raw!r}")
    return raw


def _retries() -> int:
    return max(0, int(os.environ.get("BIGDL_SAMPLE_RETRIES", "3")))


def _backoff_s() -> float:
    return max(0.0, float(os.environ.get("BIGDL_RETRY_BACKOFF_MS", "10"))) / 1e3


def _count(stage: str, kind: str) -> None:
    with _counter_lock:
        _stage_counters.setdefault(stage, {})[kind] = \
            _stage_counters.get(stage, {}).get(kind, 0) + 1


def stage_counters() -> dict:
    """``{stage: {"skipped": n, "retried": n}}`` accumulated this process."""
    with _counter_lock:
        return {s: dict(c) for s, c in _stage_counters.items()}


def reset_counters() -> None:
    with _counter_lock:
        _stage_counters.clear()


def run_guarded(stage: str, fn: Callable, *args):
    """Execute ``fn(*args)`` under the corrupt-sample policy.

    ``raise``: transparent call (no overhead beyond one env read).
    ``skip``: an exception drops the record — returns :data:`SKIPPED`.
    ``retry``: bounded exponential-backoff re-execution; exhausted retries
    propagate the final exception (a persistently corrupt record under
    ``retry`` is a data bug, not a transient — fail loudly; pick ``skip`` to
    degrade instead)."""
    policy = bad_sample_policy()
    if policy == "raise":
        return fn(*args)
    attempts = 1 + (_retries() if policy == "retry" else 0)
    delay = _backoff_s()
    for attempt in range(attempts):
        try:
            return fn(*args)
        except WorkerDeathError:
            raise  # executor health, not data quality
        except Exception as e:
            last = e
            if attempt + 1 < attempts:
                _count(stage, "retried")
                events.record("sample_retried", stage=stage,
                              error=type(e).__name__)
                logger.warning(
                    "stage %r failed (%s: %s); retry %d/%d after %.0f ms",
                    stage, type(e).__name__, e, attempt + 1, attempts - 1,
                    delay * 1e3)
                if delay > 0:
                    time.sleep(delay)
                delay = min(delay * 2, _BACKOFF_CAP_S)
    if policy == "skip":
        _count(stage, "skipped")
        events.record("sample_skipped", stage=stage,
                      error=type(last).__name__)
        logger.warning("stage %r dropped a corrupt record (%s: %s)",
                       stage, type(last).__name__, last)
        return SKIPPED
    raise last
