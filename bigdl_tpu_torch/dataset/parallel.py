"""Parallel host transform execution — multi-worker element-wise pipelines.

Counterpart of ``bigdl_tpu/dataset/parallel.py``. Every element-wise
transform used to run serially inside the single ``PrefetchingFeed``
producer thread; this module runs it on a worker pool:

- :func:`plan_stages` takes a transformer chain, fuses consecutive
  element-wise stages (``transformer.fuse_chain``) and wraps each fused run in
  a :class:`ParallelTransformer` — a bounded thread-pool map with ORDERED
  delivery. Threads, not processes: image decode and numpy ufuncs release
  the GIL, so the heavy per-image work genuinely overlaps.
- Deterministic parallel randomness: each element is executed under
  ``sample_index_scope(i)`` so randomized transforms draw from a per-sample
  generator derived from (pipeline seed, sample index) — W workers are
  bitwise-identical to 1 regardless of completion order.
- Exceptions raised in a worker surface at the consuming ``next()`` with the
  worker's original traceback (concurrent.futures preserves it), mirroring the
  PrefetchingFeed producer contract. A worker's death
  (:class:`~bigdl_tpu_torch.utils.faults.WorkerDeathError`, the
  ``transform_worker`` fault site) is absorbed up to
  ``BIGDL_WORKER_CRASH_BUDGET`` times by respawning the pool and re-running
  the element; a corrupt record follows ``BIGDL_BAD_SAMPLE_POLICY``
  (``dataset/resilience.py``).
- ``BIGDL_DATA_WORKERS`` selects the worker count process-wide: ``0``
  (default) keeps the classic serial generator chain byte-for-byte, ``auto``
  sizes to the host CPUs, N >= 1 runs the parallel engine with N workers.

Stream stages (``element_fn() is None`` — batching) stay serial between the
parallel runs, preserving stream semantics exactly.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

from bigdl_tpu_torch.dataset.profiling import STAGE_AUGMENT, feed_stats
from bigdl_tpu_torch.dataset.resilience import SKIPPED, run_guarded
from bigdl_tpu_torch.dataset.transformer import (
    Transformer, fuse_chain, sample_index_scope,
)
from bigdl_tpu_torch.obs import trace
from bigdl_tpu_torch.utils.faults import (
    SITE_TRANSFORM_WORKER, WorkerDeathError, fault_point,
)
from bigdl_tpu_torch.utils.robustness import events

logger = logging.getLogger("bigdl_tpu_torch.dataset")

#: upper bound for BIGDL_DATA_WORKERS=auto — beyond this the GIL'd fraction of
#: the per-image work dominates and extra threads only add contention
_AUTO_CAP = 8


def worker_crash_budget(default: int = 2) -> int:
    """``BIGDL_WORKER_CRASH_BUDGET``: transform-worker deaths absorbed per
    :class:`ParallelTransformer` (pool respawn + in-place re-execution)
    before the death propagates to the consumer."""
    return max(0, int(os.environ.get("BIGDL_WORKER_CRASH_BUDGET",
                                     str(default))))


def data_workers(default: int = 0) -> int:
    """Resolve ``BIGDL_DATA_WORKERS``: 0 = serial legacy path, ``auto`` =
    host-sized (cpu count capped at 8), N = that many workers."""
    raw = os.environ.get("BIGDL_DATA_WORKERS", "").strip().lower()
    if raw == "":
        return default
    if raw == "auto":
        return max(1, min(os.cpu_count() or 1, _AUTO_CAP))
    try:
        v = int(raw)
        if v < 0:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"BIGDL_DATA_WORKERS must be a non-negative integer or 'auto', "
            f"got {raw!r}") from None
    return v


class ParallelTransformer(Transformer):
    """Run an element-wise transformer across a bounded worker pool.

    Ordered delivery via a sliding window of futures: up to
    ``window = 2 * num_workers`` elements are in flight, results yield in
    submission order, and backpressure comes from the window bound — memory
    stays O(window) however fast the workers are.

    The executor is created lazily and REUSED across epochs (``__call__``
    invocations); ``close()``/GC shuts it down. One instance therefore costs
    ``num_workers`` threads for the life of the dataset, not per epoch.
    """

    def __init__(self, inner: Transformer, num_workers: int,
                 window: Optional[int] = None):
        fn = inner.element_fn()
        if fn is None:
            raise ValueError(
                f"{type(inner).__name__} is not element-wise; only "
                f"element_fn-bearing transformers can run parallel")
        self.inner = inner
        self._fn = fn
        self.num_workers = max(1, int(num_workers))
        self.window = int(window) if window else 2 * self.num_workers
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        self._ex: Optional[ThreadPoolExecutor] = None
        self._crashes = 0  # worker deaths absorbed so far (crash budget)

    def element_fn(self):
        # parallelism is an execution property, not a semantic one: the stage
        # still maps one element to one element (lets plans compose/refuse)
        return self._fn

    def _executor(self) -> ThreadPoolExecutor:
        if self._ex is None:
            self._ex = ThreadPoolExecutor(
                self.num_workers, thread_name_prefix="bigdl-data")
        return self._ex

    def _apply(self, index: int, item):
        fault_point(SITE_TRANSFORM_WORKER)  # scripted worker death, if any
        # worker-thread spans: the stage span wraps the per-element work span
        # so the trace shows transform workers nested under their stage
        with trace.span("feed/transform"):
            t0 = time.perf_counter()
            with sample_index_scope(index), trace.span("feed/augment"):
                out = run_guarded("transform", self._fn, item)
            feed_stats.add(STAGE_AUGMENT, time.perf_counter() - t0)
        return out

    def __call__(self, prev: Iterator) -> Iterator:
        return self._gen(prev)

    def _result(self, fut, index: int, item):
        """Resolve one ordered-window future. A worker death (simulated thread
        loss) is absorbed by the crash budget: the pool is respawned for
        future submissions and THIS element re-executes in place — under
        ``sample_index_scope`` the redo is bitwise-identical, so degraded
        epochs stay deterministic. Past the budget the death propagates."""
        try:
            return fut.result()
        except WorkerDeathError:
            self._crashes += 1
            budget = worker_crash_budget()
            events.record("worker_respawn", crashes=self._crashes,
                          budget=budget)
            if self._crashes > budget:
                logger.error(
                    "ParallelTransformer: worker crash budget exhausted "
                    "(%d > %d); propagating", self._crashes, budget)
                raise
            logger.warning(
                "ParallelTransformer: worker died (%d/%d absorbed); "
                "respawning pool and re-executing element %d",
                self._crashes, budget, index)
            self._respawn()
            return self._apply(index, item)

    def _respawn(self) -> None:
        """Retire the current executor (in-flight futures drain naturally —
        their threads are unaffected) and let the next submission build a
        fresh pool."""
        old, self._ex = self._ex, None
        if old is not None:
            old.shutdown(wait=False)

    def _gen(self, prev: Iterator):
        window: deque = deque()  # (future, index, item) in submission order
        try:
            for index, item in enumerate(prev):
                window.append(
                    (self._executor().submit(self._apply, index, item),
                     index, item))
                if len(window) >= self.window:
                    # result() re-raises a worker exception with the worker's
                    # original traceback attached — the consumer sees WHERE in
                    # the transform chain it blew up, not just that it did
                    out = self._result(*window.popleft())
                    if out is not SKIPPED:  # corrupt-sample policy drop
                        yield out
            while window:
                out = self._result(*window.popleft())
                if out is not SKIPPED:
                    yield out
        finally:
            # abandoned mid-epoch (endWhen break): drop queued work, keep the
            # pool — running tasks finish and are discarded
            for f, _, _ in window:
                f.cancel()

    def close(self) -> None:
        if self._ex is not None:
            self._ex.shutdown(wait=False, cancel_futures=True)
            self._ex = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def plan_stages(transformers: Sequence[Transformer],
                num_workers: int) -> list:
    """Build the execution plan for a transformer chain: fuse element-wise
    runs, wrap each fused run in a :class:`ParallelTransformer` with
    ``num_workers`` workers, keep stream stages serial in between.

    ``num_workers <= 0`` returns the chain unmodified (the serial path)."""
    chained = None
    for t in transformers:
        chained = t if chained is None else chained >> t
    if chained is None:
        return []
    if num_workers <= 0:
        return [chained]
    stages = []
    for stage in fuse_chain(chained):
        if stage.element_fn() is not None:
            stages.append(ParallelTransformer(stage, num_workers))
        else:
            stages.append(stage)
    return stages

