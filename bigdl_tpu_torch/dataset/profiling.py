"""Per-stage feed profiling: attribute host input-pipeline time.

A copy of ``bigdl_tpu/dataset/profiling.py`` (stdlib only).

The training loop's ``feed_wait_ms`` says how long the step loop *waited* on
data, but not where a slow feed actually spends its time. This module is the
attribution layer: the pipeline stages (decode in the dataset sources, augment
in the parallel transform workers, stack in ``SampleToMiniBatch``) report their
wall time here, and the consumers (the ``Optimizer``'s ``FeedStage/*``
training summaries) read snapshot deltas — so a regression in any single
stage is visible instead of smearing into one opaque wait number.

Kept dependency-free (no ``optim`` import): the dataset layer must not import
the optimizer. Timings are wall-clock sums per stage occurrence; decode/augment
count per IMAGE, stack per BATCH, h2d lives in the optimizer's own metrics
(``put_batch``) and is merged by the consumer. Every add also publishes into
the obs metric registry as ``feed/<stage>`` so the unified run report and
bench legs read one source.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

from bigdl_tpu_torch.obs.registry import registry as _obs_registry

STAGE_DECODE = "decode"
STAGE_AUGMENT = "augment"
STAGE_STACK = "stack"
#: mmap read from the decoded-sample cache (dataset/sample_cache.py) — a
#: warm epoch reports here INSTEAD of decode, so the attribution log shows
#: the cache taking over rather than decode going quietly near-zero
STAGE_CACHE = "cache"


class FeedStageStats:
    """Thread-safe (sum, count) accumulator per pipeline stage.

    Producers run in decode pools / transform workers / the prefetch producer
    thread concurrently; one lock guards the two dicts (the critical section is
    two float adds — contention is negligible next to ms-scale image work).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sums: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    def add(self, stage: str, seconds: float) -> None:
        with self._lock:
            self._sums[stage] += seconds
            self._counts[stage] += 1
        _obs_registry.histogram("feed/" + stage).observe(seconds)

    def timer(self, stage: str) -> "_StageTimer":
        return _StageTimer(self, stage)

    def snapshot(self) -> dict[str, tuple[float, int]]:
        """{stage: (total_seconds, occurrences)} — cheap copy for delta math."""
        with self._lock:
            return {k: (self._sums[k], self._counts[k]) for k in self._sums}

    def reset(self) -> None:
        with self._lock:
            self._sums.clear()
            self._counts.clear()


class _StageTimer:
    __slots__ = ("_stats", "_stage", "_t0")

    def __init__(self, stats: FeedStageStats, stage: str):
        self._stats, self._stage = stats, stage

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._stats.add(self._stage, time.perf_counter() - self._t0)
        return False


#: process-wide sink the pipeline stages report into (consumers diff snapshots,
#: so sharing one sink across datasets/epochs is fine)
feed_stats = FeedStageStats()


def stage_deltas_ms(before: dict[str, tuple[float, int]],
                    after: dict[str, tuple[float, int]] | None = None
                    ) -> dict[str, dict[str, float]]:
    """Per-stage mean ms and occurrence count between two snapshots."""
    if after is None:
        after = feed_stats.snapshot()
    out: dict[str, dict[str, float]] = {}
    for stage, (total, count) in after.items():
        t0, c0 = before.get(stage, (0.0, 0))
        dt, dc = total - t0, count - c0
        if dc > 0:
            out[stage] = {"ms": 1e3 * dt / dc, "count": dc,
                          "total_ms": 1e3 * dt}
    return out
