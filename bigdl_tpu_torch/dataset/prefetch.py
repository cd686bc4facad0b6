"""Background batch pipeline — overlap host data work with device compute.

Counterpart of ``bigdl_tpu/dataset/prefetch.py``: a host-side producer
thread assembles batch ``k+1`` **and** starts its host-to-device copy while
the card runs step ``k``, so the step loop never waits on the feed in
steady state.

Design:
- ``PrefetchingFeed`` wraps a fresh dataset iterator per epoch. A daemon
  producer thread pulls ``MiniBatch``es, calls ``put_fn`` (the trainer's
  placement: on a CUDA device a copy from pinned memory on a stream of the
  producer's own, ``dataset/h2d.py``) and parks up to ``depth`` placed
  batches in a bounded queue, which bounds device-memory overcommit to
  ``depth`` batches.
- ``window > 1`` assembles fused training windows: the producer groups
  ``window`` consecutive batches and hands the LIST to ``put_fn`` (the
  trainer stacks them into one host buffer and copies it once). The
  trailing partial group at epoch end is delivered as a shorter list — the
  trainer places and runs it per step. Queue items are ``(batches, placed)``
  either way; with windowing, ``batches`` is a list.
- ``train=False`` selects eval-window semantics: the trailing partial group
  is split into SINGLE-batch groups instead of one shorter list. An eval
  consumer then sees exactly two static shapes — the full K-window and the
  single batch — so a ragged tail never captures a program per distinct
  tail length.
- Exceptions in the producer surface in the consumer (training loop) with
  their original type, and the producer's traceback as ``__cause__`` (a
  :class:`ProducerTraceback`) when they have no cause of their own; a CUDA
  error of the producer's copy among them: nothing falls back to a copy on
  the loop thread.
- ``close()`` (also on ``__exit__`` / generator abandonment) stops the
  producer promptly — mid-epoch breaks (endWhen triggers) must not leak
  threads. The hand-off queue is condition-based
  (``utils.queues.ClosableQueue``, shared with the serving request plane): a
  producer blocked on a full queue wakes the instant ``close()`` fires. A
  producer that fails to join within the timeout is logged loudly and
  remembered, so the NEXT ``__iter__`` can say which earlier epoch leaked
  it.
- ``depth=0`` degrades to fully synchronous iteration (debug / determinism
  studies): ``put_fn`` runs on the consumer's thread.
"""

from __future__ import annotations

import itertools
import logging
import threading
import traceback
from typing import Callable, Iterator

from bigdl_tpu_torch.obs import trace
from bigdl_tpu_torch.utils.queues import CLOSED as _CLOSED
from bigdl_tpu_torch.utils.queues import ClosableQueue as _ClosableQueue

logger = logging.getLogger("bigdl_tpu_torch.dataset")

_END = object()


class ProducerTraceback(Exception):
    """The producer thread's traceback of an exception that the consumer
    re-raises: set as the exception's ``__cause__``."""

    def __init__(self, exc: BaseException):
        super().__init__("in the feed's producer thread:\n" + "".join(
            traceback.format_exception(exc)))


class PrefetchingFeed:
    """Iterate ``(batch, placed)`` pairs with a background producer.

    ``make_iter``: zero-arg callable returning the epoch's batch iterator.
    ``put_fn``: MiniBatch → device placement (e.g. trainer's ``_put_batch``);
    with ``window > 1`` it receives a LIST of up to ``window`` MiniBatches instead.
    ``depth``: producer queue bound (placed batches in flight); 0 = synchronous.
    ``window``: fused-dispatch group size; 1 (default) feeds single batches.
    ``train``: window-tail policy — True delivers the trailing partial group as
    one shorter list (trainer runs it per step); False (eval mode) splits it
    into single-batch groups so eval programs keep exactly two static shapes.
    """

    #: close() waits this long for the producer before declaring it leaked
    JOIN_TIMEOUT = 5.0

    def __init__(self, make_iter: Callable[[], Iterator], put_fn: Callable,
                 depth: int = 2, window: int = 1, train: bool = True):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.make_iter = make_iter
        self.put_fn = put_fn
        self.depth = depth
        self.window = window
        self.train = train
        self._queue: _ClosableQueue | None = None
        self._stop: threading.Event | None = None
        self._thread: threading.Thread | None = None
        self._leaked_thread: threading.Thread | None = None
        #: groups handed to the consumer THIS epoch — the feed-position the
        #: streamed-resume machinery records (items parked in the queue or
        #: in flight in the producer are deliberately NOT counted: resume
        #: replays from what the training loop actually consumed)
        self.delivered = 0

    # ------------------------------------------------------------- producer
    def _grouped(self, it):
        """Group the epoch iterator into ``window``-sized lists (trailing
        partial list included) when windowing; pass through otherwise. Eval
        mode (``train=False``) splits the partial tail into singleton groups
        instead — two static shapes total for the consumer's programs."""
        if self.window == 1:
            return it
        groups = iter(lambda: list(itertools.islice(it, self.window)), [])
        if self.train:
            return groups

        def eval_groups():
            for group in groups:
                if len(group) == self.window:
                    yield group
                else:
                    for batch in group:
                        yield [batch]

        return eval_groups()

    def _produce(self, it, q: _ClosableQueue, stop: threading.Event) -> None:
        try:
            for batch in self._grouped(it):
                if stop.is_set():
                    return
                # producer-thread span: batch assembly + device placement
                # (h2d nests inside via the trainer's feed/h2d span)
                with trace.span("feed/put_batch"):
                    placed = self.put_fn(batch)
                # a False put means close() fired — the consumer is gone, so
                # dropping the item is the only non-deadlocking option
                if not q.put((batch, placed)) or stop.is_set():
                    return
            q.put(_END)
        except BaseException as e:  # surfaced in the consumer
            q.put(e)

    # ------------------------------------------------------------- consumer
    def __iter__(self):
        leaked = self._leaked_thread
        if leaked is not None and leaked.is_alive():
            # breadcrumb from an earlier close() that timed out: the producer
            # is still running (likely wedged in put_fn / dataset IO) and its
            # queue references are gone — say so instead of silently stacking
            # another thread on top of it
            logger.warning(
                "PrefetchingFeed: previously leaked producer thread %r is "
                "still alive; a prior close() timed out. Starting a new "
                "producer anyway — if this recurs, the put_fn or dataset "
                "iterator is blocking indefinitely.", leaked.name)
        elif leaked is not None:
            self._leaked_thread = None  # it eventually finished; forget it
        self.delivered = 0
        if self.depth == 0:
            for batch in self._grouped(self.make_iter()):
                placed = self.put_fn(batch)
                self.delivered += 1
                yield batch, placed
            return
        self._stop = threading.Event()
        self._queue = _ClosableQueue(maxsize=self.depth)
        self._thread = threading.Thread(
            target=self._produce, args=(self.make_iter(), self._queue, self._stop),
            name="bigdl-prefetch" if self.train else "bigdl-prefetch-eval",
            daemon=True)
        self._thread.start()
        try:
            while True:
                item = self._queue.get()
                if item is _END or item is _CLOSED:
                    return
                if isinstance(item, BaseException):
                    # re-raise the producer's exception with its original type
                    # (trainer retry/divisibility contracts depend on it), its
                    # producer traceback as the cause
                    if item.__cause__ is None:
                        item.__cause__ = ProducerTraceback(item)
                    raise item
                self.delivered += 1
                yield item
        finally:
            self.close()

    def position(self) -> dict:
        """Feed position for checkpoint payloads / diagnostics: how many
        groups (batches, or ``window``-sized lists) the consumer pulled this
        epoch. Multiply by ``window`` for a batch-granular upper bound."""
        return {"delivered": self.delivered, "window": self.window}

    def close(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._queue is not None:
            # wakes a producer blocked on put() immediately (no poll interval)
            self._queue.close()
        if self._thread is not None:
            self._thread.join(timeout=self.JOIN_TIMEOUT)
            if self._thread.is_alive():
                # the producer did not stop: it is wedged somewhere that
                # ignores the stop event (put_fn, dataset IO). Leaking a
                # daemon thread is survivable but must not be silent.
                logger.warning(
                    "PrefetchingFeed.close: producer thread %r did not join "
                    "within %.1fs and was leaked (daemon). It is likely "
                    "blocked in put_fn or the dataset iterator.",
                    self._thread.name, self.JOIN_TIMEOUT)
                self._leaked_thread = self._thread
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
