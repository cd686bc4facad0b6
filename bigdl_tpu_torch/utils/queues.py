"""Event-aware bounded queue: the serving engine's admission queue.

Counterpart of ``bigdl_tpu/utils/queues.py``. A consumer polls with
``get(timeout=0)`` between decode ticks and sleeps on ``get()`` only when
idle; ``close()`` wakes every waiter at once. ``get`` returns the sentinels
:data:`CLOSED` (closed and drained) and :data:`EMPTY` (a bounded wait ran
out) instead of raising.
"""

from __future__ import annotations

import threading
import time
from collections import deque

#: returned by ``get`` once the queue is closed and drained
CLOSED = object()
#: returned by ``get(timeout=...)`` when the wait expired with no item
EMPTY = object()


class ClosableQueue:
    """Bounded FIFO whose blocked ``put``/``get`` wake on ``close()``.

    ``put`` returns False once closed. ``close()`` keeps the items already
    queued, so the consumer can take each one out with ``get(timeout=0)``
    and fail it deliberately: a request racing the close is never stranded.
    """

    def __init__(self, maxsize: int):
        self._maxsize = maxsize
        self._items: deque = deque()
        lock = threading.Lock()
        self._not_full = threading.Condition(lock)
        self._not_empty = threading.Condition(lock)
        self._closed = False

    def put(self, item) -> bool:
        with self._not_full:
            while len(self._items) >= self._maxsize and not self._closed:
                self._not_full.wait()
            if self._closed:
                return False
            self._items.append(item)
            self._not_empty.notify()
            return True

    def get(self, timeout: float | None = None):
        with self._not_empty:
            if timeout is None:
                while not self._items and not self._closed:
                    self._not_empty.wait()
            else:
                deadline = time.monotonic() + timeout
                while not self._items and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return EMPTY
                    self._not_empty.wait(remaining)
            if not self._items:
                return CLOSED
            item = self._items.popleft()
            self._not_full.notify()
            return item

    def qsize(self) -> int:
        with self._not_empty:
            return len(self._items)

    def close(self) -> None:
        """Close the queue and wake every waiter. Idempotent."""
        with self._not_full:
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()
