"""Slot scheduler and prefill bucket grid for continuous batching.

Counterpart of ``bigdl_tpu/serving/scheduler.py``. The decode batch is a
fixed grid of ``num_slots`` cache rows: a finished sequence's row is handed
to the next waiting request mid-flight while the other rows keep decoding.
Prompts prefill right-padded to the smallest bucket of a doubling length
grid; the slot's depth is the true prompt length, so pad positions are
never attended. The scheduler is host-only bookkeeping.
"""

from __future__ import annotations

from typing import Optional, Sequence

from bigdl_tpu_torch.serving.request import Request


def default_buckets(max_len: int, lo: int = 16) -> tuple[int, ...]:
    """Doubling prefill-length grid ``lo, 2·lo, …`` capped at ``max_len``
    (always included), e.g. ``max_len=100 → (16, 32, 64, 100)``."""
    if max_len < 1:
        raise ValueError(f"max_len must be >= 1, got {max_len}")
    buckets = []
    b = lo
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def pick_bucket(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= n, or None when nothing fits."""
    for b in buckets:
        if b >= n:
            return b
    return None


class Slot:
    """One decode-batch row: which request owns it and the last token fed."""

    __slots__ = ("index", "request", "last_token")

    def __init__(self, index: int):
        self.index = index
        self.request: Optional[Request] = None
        self.last_token: int = 0


class SlotScheduler:
    """Admission into free rows and release on finish. Freed slots are
    reused first-in first-out, so recycling is deterministic."""

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self._slots = [Slot(i) for i in range(num_slots)]
        self._free = list(range(num_slots))
        self._ever_used: set[int] = set()
        self._recycles = 0   # admissions into a row a finished request left

    def has_free(self) -> bool:
        return bool(self._free)

    def any_active(self) -> bool:
        return len(self._free) < self.num_slots

    @property
    def active_count(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def recycles(self) -> int:
        return self._recycles

    def active_slots(self) -> list[Slot]:
        return [s for s in self._slots if s.request is not None]

    def admit(self, request: Request) -> Slot:
        """Claim the oldest-freed slot for ``request``."""
        if not self._free:
            raise RuntimeError("no free slot (caller must check has_free())")
        slot = self._slots[self._free.pop(0)]
        slot.request = request
        slot.last_token = 0
        if slot.index in self._ever_used:
            self._recycles += 1
        self._ever_used.add(slot.index)
        return slot

    def release(self, slot: Slot) -> None:
        """Free ``slot``: it is admissible to the next request at once."""
        if slot.request is None:
            raise RuntimeError(f"slot {slot.index} is already free")
        slot.request = None
        slot.last_token = 0
        self._free.append(slot.index)
