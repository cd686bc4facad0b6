"""Online ranking engine: batched candidate scoring over a recsys model.

Counterpart of ``bigdl_tpu/serving/ranking.py``. A scorer maps (N, 2) int
(user, item) id pairs to (N, C) scores whose last column orders the
candidates (NeuMF's log P(interaction)). The engine is an admission queue
and one program:

- clients ``submit()`` a (user, candidate ids) request from any thread and
  get a :class:`RankingHandle`; one worker thread owns the device;
- the worker coalesces up to ``max_batch`` waiting requests a tick into one
  fixed ``(max_batch · max_candidates, 2)`` pair tensor, unused rows padded
  with id 1 (valid 1-based in every table), so one program serves every
  tick: where JAX compiles once (``cached_forward_jit``), the port captures
  one ``utils/programs.Program`` (a CUDA graph on the card, eager on the
  CPU), its forward in eval mode without autograd;
- only the scores come back to the host, where a stable descending sort
  (``np.argsort(-s, kind="stable")``, JAX's tie order) ranks each request;
- ``ranking/requests``, ``ranking/batch_fill`` and ``ranking/latency_ms``
  go to the metric registry, as in JAX.

The engine serves ``model`` as given (on its device); the model is put in
eval mode.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.obs.registry import registry
from bigdl_tpu_torch.serving.engine import EngineShutdown
from bigdl_tpu_torch.utils.device import wait_for_stream
from bigdl_tpu_torch.utils.programs import Program
from bigdl_tpu_torch.utils.queues import CLOSED, EMPTY, ClosableQueue


class RankedResult:
    """One request's candidates, best first, and their aligned scores."""

    __slots__ = ("user_id", "item_ids", "scores", "latency_s")

    def __init__(self, user_id: int, item_ids: np.ndarray,
                 scores: np.ndarray, latency_s: float):
        self.user_id = user_id
        #: candidate ids, best first (np.int32, (n_candidates,))
        self.item_ids = item_ids
        #: scores aligned with ``item_ids`` (np.float32, descending)
        self.scores = scores
        self.latency_s = latency_s

    def topk(self, k: int) -> np.ndarray:
        return self.item_ids[:k]

    def __repr__(self):
        return (f"RankedResult(user={self.user_id}, "
                f"candidates={len(self.item_ids)}, "
                f"best={int(self.item_ids[0]) if len(self.item_ids) else None})")


class RankingHandle:
    """Client-side future of one ranking request."""

    def __init__(self):
        self._done = threading.Event()
        self._result: Optional[RankedResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> RankedResult:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"ranking request not finished within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, result: RankedResult) -> None:
        self._result = result
        self._done.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._done.set()


class _RankRequest:
    __slots__ = ("user_id", "item_ids", "submit_t", "handle")

    def __init__(self, user_id: int, item_ids: np.ndarray):
        self.user_id = user_id
        self.item_ids = item_ids
        self.submit_t = time.perf_counter()
        self.handle = RankingHandle()


class RankingEngine:
    """Batched candidate ranking over one scorer.

    ``max_candidates``: a request's candidate cap, the static shape;
    ``max_batch``: requests coalesced a tick (default 8); ``queue_depth``:
    the admission bound (default ``4 * max_batch``), ``submit`` waits when
    it is full.
    """

    def __init__(self, model: torch.nn.Module, max_candidates: int,
                 max_batch: int = 8, queue_depth: Optional[int] = None,
                 name: str = "ranking"):
        if max_candidates < 1:
            raise ValueError(
                f"max_candidates must be >= 1, got {max_candidates}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.model = model
        self.max_candidates = int(max_candidates)
        self.max_batch = int(max_batch)
        self.name = name
        model.eval()
        device = next(model.parameters()).device
        # the static pair tensor the program reads; the worker writes it
        self._pairs = torch.ones((max_batch * max_candidates, 2),
                                 dtype=torch.int32, device=device)
        self._program = Program(("ranking", self.max_batch,
                                 self.max_candidates), self._score,
                                (self._pairs,), device)
        self._queue = ClosableQueue(queue_depth or 4 * max_batch)
        self._n_ticks = 0
        self._fill_sum = 0
        self._lock = threading.Lock()
        self._shutdown = False
        # request pairs pad with id 1: the smallest 1-based id is in range
        # for every table, and the padded rows' scores are sliced away
        self._pad_pairs = np.ones((max_batch * max_candidates, 2), np.int32)
        self._thread = threading.Thread(
            target=self._worker, name=f"{name}-worker", daemon=True)
        self._thread.start()

    def _score(self, pairs):
        with torch.no_grad():
            out = self.model(pairs)
        return out.reshape(pairs.shape[0], -1)[:, -1]

    # ------------------------------------------------------------- client
    def submit(self, user_id: int, item_ids: Sequence[int]) -> RankingHandle:
        """Queue one request: rank ``item_ids`` (1-based, at most
        ``max_candidates``) for ``user_id``; ``handle.result()`` waits for
        the ranked candidates."""
        ids = np.asarray(item_ids, np.int32).reshape(-1)
        if ids.size < 1 or ids.size > self.max_candidates:
            raise ValueError(
                f"need 1..{self.max_candidates} candidate ids, got {ids.size}")
        req = _RankRequest(int(user_id), ids)
        if not self._queue.put(req):
            raise EngineShutdown(f"{self.name}: engine is shut down")
        return req.handle

    def rank(self, user_id: int, item_ids: Sequence[int],
             timeout: Optional[float] = None) -> RankedResult:
        """Synchronous ``submit`` + ``result``."""
        return self.submit(user_id, item_ids).result(timeout)

    # ------------------------------------------------------------- worker
    def _coalesce(self, first: _RankRequest) -> list:
        batch = [first]
        while len(batch) < self.max_batch:
            item = self._queue.get(timeout=0)
            if item is EMPTY or item is CLOSED:
                break
            batch.append(item)
        return batch

    def _score_batch(self, batch: list) -> None:
        pairs = self._pad_pairs.copy()
        for i, req in enumerate(batch):
            rows = slice(i * self.max_candidates,
                         i * self.max_candidates + req.item_ids.size)
            pairs[rows, 0] = req.user_id
            pairs[rows, 1] = req.item_ids
        self._pairs.copy_(torch.from_numpy(pairs))
        out = self._program()
        wait_for_stream(out)
        scores = out.cpu().numpy()
        now = time.perf_counter()
        for i, req in enumerate(batch):
            s = scores[i * self.max_candidates:
                       i * self.max_candidates + req.item_ids.size]
            order = np.argsort(-s, kind="stable")
            req.handle._complete(RankedResult(
                req.user_id, req.item_ids[order],
                s[order].astype(np.float32), now - req.submit_t))
            registry.histogram("ranking/latency_ms").observe(
                (now - req.submit_t) * 1e3)
        with self._lock:
            self._n_ticks += 1
            self._fill_sum += len(batch)
        registry.counter("ranking/requests").inc(len(batch))
        registry.histogram("ranking/batch_fill").observe(
            len(batch) / self.max_batch)

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is CLOSED:
                return
            batch = self._coalesce(item)
            try:
                self._score_batch(batch)
            except BaseException as e:  # noqa: BLE001 — futures must not hang
                for req in batch:
                    req.handle._fail(e)

    # ------------------------------------------------------------- admin
    def stats(self) -> dict:
        with self._lock:
            ticks = self._n_ticks
            fill = self._fill_sum
        return {
            "queue_depth": self._queue.qsize(),
            "ticks": ticks,
            "requests": fill,
            "mean_batch_fill": (fill / ticks if ticks else 0.0),
            "max_batch": self.max_batch,
            "max_candidates": self.max_candidates,
            # one static shape: one program, ever
            "compiled_programs": 1,
        }

    def shutdown(self, wait: bool = True, timeout: float = 10.0) -> None:
        """Stop admission, fail the queued requests, join the worker."""
        if self._shutdown:
            return
        self._shutdown = True
        self._queue.close()
        while True:
            item = self._queue.get(timeout=0)
            if item is EMPTY or item is CLOSED:
                break
            item.handle._fail(
                EngineShutdown(f"{self.name}: engine shut down"))
        if wait:
            self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
