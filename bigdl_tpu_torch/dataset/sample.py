"""Sample and MiniBatch.

Counterpart of ``bigdl_tpu/dataset/sample.py``: a ``Sample`` is (feature
arrays, label arrays); ``SampleToMiniBatch`` stacks them into fixed-size
host batches. ``pad_last=True`` repeats the last sample so every batch has
``batch_size`` rows and records the real count in ``valid``;
``pad_last=False`` drops the final partial batch.

Zero-alloc assembly: ``SampleToMiniBatch`` stacks into a small RING of
preallocated output buffers (``BIGDL_BATCH_RING`` slots, default 4) instead
of fresh allocations every batch. A batch's buffers return to the ring when
the consumer calls ``MiniBatch.recycle()`` — the trainer's feed does, once
the batch's copy to the device has completed. Consumers that never recycle
(tests, ad-hoc iteration) simply drain the ring and fall back to fresh
allocations (``native.pack_batch``) — never a deadlock and never an aliased
buffer.

Pinned slots: a trainer whose device is CUDA calls :meth:`SampleToMiniBatch.pin`
(``pin_feed``), and the ring's slots become page-locked host tensors
(``torch.empty(..., pin_memory=True)``) exposed to ``np.stack(out=)`` as
numpy views, so the copy to the card is a true asynchronous DMA. On the CPU
nothing is pinned.
"""

from __future__ import annotations

import os
import queue
import time
from typing import Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.profiling import STAGE_STACK, feed_stats
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.obs import trace


class Sample:
    def __init__(self, feature, label=None):
        self.feature = (tuple(np.asarray(f) for f in feature)
                        if isinstance(feature, (tuple, list))
                        else (np.asarray(feature),))
        if label is None:
            self.label = ()
        else:
            self.label = (tuple(np.asarray(l) for l in label)
                          if isinstance(label, (tuple, list))
                          else (np.asarray(label),))

    @property
    def features(self):
        return self.feature

    @property
    def labels(self):
        return self.label

    def __repr__(self):
        fs = ",".join(str(f.shape) for f in self.feature)
        ls = ",".join(str(l.shape) for l in self.label)
        return f"Sample(feature={fs}, label={ls})"


class MiniBatch:
    """Stacked batch. ``size`` is the padded batch size; ``valid`` the real sample count."""

    def __init__(self, input, target=None, valid: Optional[int] = None):
        self.input = input
        self.target = target
        self.valid = valid if valid is not None else _batch_dim(input)
        self._ring_slot = None

    @property
    def pinned(self) -> bool:
        """Whether ``input`` and ``target`` lie in a pinned ring slot."""
        slot = self._ring_slot
        return slot is not None and slot.pinned

    def size(self) -> int:
        return _batch_dim(self.input)

    def recycle(self) -> None:
        """Return this batch's buffers to the assembly ring (no-op for
        non-ring batches). Only the consumer that has finished reading
        ``input``/``target`` may call this — afterwards the arrays may be
        overwritten by a later batch. Scalar metadata (``valid``) stays
        usable."""
        slot = self._ring_slot
        if slot is not None:
            self._ring_slot = None
            slot.release()

    def __repr__(self):
        return f"MiniBatch(size={self.size()}, valid={self.valid})"


def _batch_dim(x) -> int:
    if isinstance(x, (tuple, list)):
        return _batch_dim(x[0])
    return int(np.asarray(x).shape[0])


def batch_ring_depth(default: int = 4) -> int:
    """``BIGDL_BATCH_RING``: preallocated output-buffer slots per
    SampleToMiniBatch (0 disables the ring — every batch allocates fresh)."""
    raw = os.environ.get("BIGDL_BATCH_RING", "").strip()
    if raw == "":
        return default
    try:
        v = int(raw)
        if v < 0:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"BIGDL_BATCH_RING must be a non-negative integer, got {raw!r}"
        ) from None
    return v


def host_buffer(shape: tuple, dtype, pinned: bool) -> np.ndarray:
    """An empty host array; with ``pinned`` a numpy view of a page-locked
    torch tensor (the view keeps the tensor alive), allocated outside any
    program capture (``utils.programs.capture_guard``)."""
    if not pinned:
        return np.empty(shape, dtype)
    import torch

    from bigdl_tpu_torch.utils.programs import capture_guard
    tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
    with capture_guard():
        return torch.empty(shape, dtype=tdtype, pin_memory=True).numpy()


class _RingSlot:
    """One preallocated output buffer set: per-feature and per-label arrays of
    shape (batch_size, *sample_shape). Arrays materialize on first fill (the
    sample shapes are unknown until then) and are reused verbatim afterwards;
    ``pinned`` slots are page-locked."""

    __slots__ = ("feats", "labels", "pinned", "_free")

    def __init__(self, free: "queue.SimpleQueue", pinned: bool = False):
        self.feats: Optional[tuple] = None
        self.labels: Optional[tuple] = None
        self.pinned = pinned
        self._free = free

    def release(self) -> None:
        self._free.put(self)

    def compatible(self, samples: Sequence[Sample]) -> bool:
        if self.feats is None:
            return True
        s = samples[0]
        return (len(self.feats) == len(s.feature)
                and len(self.labels) == len(s.label)
                and all(b.shape[1:] == a.shape and b.dtype == a.dtype
                        for b, a in zip(self.feats, s.feature))
                and all(b.shape[1:] == a.shape and b.dtype == a.dtype
                        for b, a in zip(self.labels, s.label)))


class _BufferRing:
    """Fixed set of ``depth`` slots handed out through a thread-safe free
    queue. ``acquire`` never blocks: an exhausted ring (consumer not
    recycling) degrades to fresh allocations at the call site."""

    def __init__(self, depth: int, pinned: bool = False):
        self._free: queue.SimpleQueue = queue.SimpleQueue()
        for _ in range(depth):
            self._free.put(_RingSlot(self._free, pinned))

    def acquire(self) -> Optional[_RingSlot]:
        try:
            return self._free.get_nowait()
        except queue.Empty:
            return None


class SampleToMiniBatch(Transformer):
    """Group Samples into fixed-size MiniBatches.

    ``pad_last=True`` (default) repeats trailing samples so every batch has
    exactly ``batch_size`` rows (static shapes for a captured program) and
    records ``valid`` for correct metrics; ``pad_last=False`` drops the
    final partial batch.

    ``ring_depth`` (default from ``BIGDL_BATCH_RING``) sizes the preallocated
    output-buffer ring; 0 stacks into fresh arrays every batch. Samples whose
    shapes vary from batch to batch disable the ring automatically (static
    slot shapes can't serve them).
    """

    def __init__(self, batch_size: int, pad_last: bool = True,
                 ring_depth: Optional[int] = None):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.batch_size = batch_size
        self.pad_last = pad_last
        self.ring_depth = (batch_ring_depth() if ring_depth is None
                           else int(ring_depth))
        self.pinned = False
        self._ring = (_BufferRing(self.ring_depth)
                      if self.ring_depth > 0 else None)

    def pin(self, enabled: bool = True) -> "SampleToMiniBatch":
        """Page-locked ring slots (the feed of a trainer on a CUDA device)
        or plain ones; a change starts a fresh ring. Call it before
        iterating: batches already handed out keep their slots."""
        enabled = bool(enabled)
        if enabled != self.pinned:
            self.pinned = enabled
            if self._ring is not None:
                self._ring = _BufferRing(self.ring_depth, enabled)
        return self

    def __call__(self, prev: Iterator) -> Iterator:
        return self._gen(prev)

    def _gen(self, prev: Iterator):
        buf: list[Sample] = []
        for s in prev:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self._stack(buf, self.batch_size)
                buf = []
        if buf and self.pad_last:
            valid = len(buf)
            while len(buf) < self.batch_size:
                buf.append(buf[valid - 1])
            yield self._stack(buf, self.batch_size, valid)

    # ------------------------------------------------------------- stacking
    def _stack(self, samples: Sequence[Sample], batch_size: int,
               valid: Optional[int] = None) -> MiniBatch:
        t0 = time.perf_counter()
        with trace.span("feed/stack"):
            slot = self._ring.acquire() if self._ring is not None else None
            if slot is not None and not slot.compatible(samples):
                # variable-shape stream: the ring's static buffers can't
                # serve it
                slot.release()
                slot = None
                self._ring = None
            if slot is not None:
                batch = self._stack_into(slot, samples, batch_size, valid)
            else:
                batch = self._stack_fresh(samples, batch_size, valid)
        feed_stats.add(STAGE_STACK, time.perf_counter() - t0)
        return batch

    @staticmethod
    def _stack_into(slot: _RingSlot, samples: Sequence[Sample],
                    batch_size: int, valid: Optional[int]) -> MiniBatch:
        s0 = samples[0]
        if slot.feats is None:
            slot.feats = tuple(
                host_buffer((batch_size,) + a.shape, a.dtype, slot.pinned)
                for a in s0.feature)
            slot.labels = tuple(
                host_buffer((batch_size,) + a.shape, a.dtype, slot.pinned)
                for a in s0.label)
        # np.stack(out=...) copies straight into the preallocated slot — the
        # steady-state feed allocates nothing per batch
        for j, out in enumerate(slot.feats):
            np.stack([s.feature[j] for s in samples], out=out)
        for j, out in enumerate(slot.labels):
            np.stack([s.label[j] for s in samples], out=out)
        n_f, n_l = len(slot.feats), len(slot.labels)
        input = slot.feats[0] if n_f == 1 else slot.feats
        target = (slot.labels[0] if n_l == 1 else slot.labels) if n_l else None
        batch = MiniBatch(input, target,
                          valid if valid is not None else len(samples))
        batch._ring_slot = slot
        return batch

    @staticmethod
    def _stack_fresh(samples: Sequence[Sample], batch_size: int,
                     valid: Optional[int] = None) -> MiniBatch:
        # native GIL-free copy when available (runs in the prefetch producer
        # thread — overlap with the main thread is the point); numpy otherwise
        from bigdl_tpu_torch.native import pack_batch
        n_f = len(samples[0].feature)
        feats = tuple(pack_batch([s.feature[i] for s in samples]) for i in range(n_f))
        n_l = len(samples[0].label)
        labels = tuple(pack_batch([s.label[i] for s in samples]) for i in range(n_l))
        input = feats[0] if n_f == 1 else feats
        target = (labels[0] if n_l == 1 else labels) if n_l else None
        return MiniBatch(input, target, valid if valid is not None else len(samples))
