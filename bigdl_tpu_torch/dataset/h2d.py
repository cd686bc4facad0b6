"""The feed's host-to-device copies: pinned memory, a copy stream, events.

JAX's feed places a batch with ``jax.device_put`` in the producer thread,
which only enqueues a DMA (``bigdl_tpu/optim/optimizer.py:1048-1100``). A
copy in PyTorch overlaps the step only when it is issued so; this module
does it for the trainer's and the evaluator's ``PrefetchingFeed``:

- the copy reads page-locked host memory: a batch from a pinned ring slot
  (``SampleToMiniBatch.pin``) as it is, anything else (a plain array, a
  fused window of batches stacked along a new leading axis) after one host
  copy into a pinned staging buffer of this object;
- it is issued on a CUDA stream of this object's own, followed by an event;
- the issuing thread (the producer) waits for that event before it returns
  a ring slot to its ring (``MiniBatch.recycle``) or reuses a staging
  buffer, the counterpart of JAX's ``block_until_ready(placed);
  batch.recycle()``; a consumer that still reads a batch's host arrays
  after its placement (the evaluator's host folds read ``target``) places
  with ``recycle=False`` and recycles the batch itself when it is done;
- the consumer calls :meth:`Placed.ready` before the step reads the
  tensors: its stream waits on the event, and ``record_stream`` tells the
  caching allocator that the compute stream uses the tensors, so their
  memory is not handed out again while it still reads them;
- nothing is issued while a program is captured on another thread
  (``utils.programs.capture_guard``), so the producer cannot invalidate a
  capture.

A CUDA error of the copy raises in the producer and reaches the consumer
through the feed; nothing falls back to a copy on the loop thread. On the
CPU a placement is a copy into fresh tensors (a ring slot goes back at
once), so a placed batch never aliases a buffer the ring reuses.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.dataset.sample import host_buffer
from bigdl_tpu_torch.utils.programs import capture_guard


def _map(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(fn(a) for a in x)
    return fn(x)


def _leaves(x) -> list:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _signature(x) -> tuple:
    return tuple((np.shape(a), np.asarray(a).dtype) for a in _leaves(x))


class Placed:
    """A batch (or a stacked window) on the device: ``inp`` and ``target``
    (tensors, or tuples of them) and the event of their copy (None on the
    CPU)."""

    __slots__ = ("inp", "target", "event")

    def __init__(self, inp, target, event: Optional[torch.cuda.Event]):
        self.inp, self.target, self.event = inp, target, event

    def tensors(self) -> list:
        return [t for t in _leaves(self.inp) + _leaves(self.target)
                if t is not None]

    def ready(self) -> tuple:
        """``(inp, target)``, safe to read on the current stream."""
        if self.event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self.event)
            for t in self.tensors():
                t.record_stream(stream)
        return self.inp, self.target


class HostToDevice:
    """Places host batches on ``device`` (see the module docstring). One
    object serves one producer at a time: its staging buffers are reused
    after each copy has completed."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream: Optional[torch.cuda.Stream] = None
        self._staging: dict = {}

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def place(self, item, window: int, put=None, put_stacked=None,
              recycle: bool = True):
        """A feed item on the device: a batch as one placement; a full
        window of ``window`` batches of one shape stacked and copied once;
        any other window (a partial tail, batches that differ in shape) as
        a list of per-batch placements. ``put`` and ``put_stacked`` default
        to this object's (a caller's cache wraps them)."""
        put = put or (lambda b: self.put(b, recycle))
        put_stacked = put_stacked or (lambda bs: self.put_stacked(bs,
                                                                  recycle))
        if not isinstance(item, list):
            return put(item)
        if window > 1 and len(item) == window and all(
                _host_signature(b) == _host_signature(item[0])
                for b in item):
            return put_stacked(item)
        return [put(b) for b in item]

    def put(self, batch, recycle: bool = True) -> Placed:
        """One ``MiniBatch`` (a ``target`` of None places as None); its ring
        slot goes back once the copy has completed unless ``recycle`` is
        false."""
        trees = (batch.input, batch.target)
        if not self.on_card:
            placed = Placed(*(None if t is None else _map(_owned_tensor, t)
                              for t in trees), None)
        else:
            if not batch.pinned:
                bufs = self._buffers(("batch",), trees, ())
                for buf, t in zip(bufs, trees):
                    if t is not None:
                        for out, a in zip(_leaves(buf), _leaves(t)):
                            np.copyto(out, np.asarray(a))
                trees = bufs
            placed = self._copy(trees)
        self._release([batch], placed, recycle)
        return placed

    def put_stacked(self, batches: Sequence, recycle: bool = True) -> Placed:
        """A window of same-shaped ``MiniBatch``es stacked along a new
        leading axis: one host stack, one copy (``recycle`` as in
        :meth:`put`)."""
        k = len(batches)
        trees = (batches[0].input, batches[0].target)
        bufs = (self._buffers(("window", k), trees, (k,)) if self.on_card
                else [None if t is None else _map(
                    lambda a: np.empty((k,) + np.shape(a),
                                       np.asarray(a).dtype), t)
                      for t in trees])
        for j, buf in enumerate(bufs):
            if buf is None:
                continue
            for i, out in enumerate(_leaves(buf)):
                np.stack([np.asarray(_leaves((b.input, b.target)[j])[i])
                          for b in batches], out=out)
        placed = (self._copy(bufs) if self.on_card else
                  Placed(*(None if t is None else _map(torch.from_numpy, t)
                           for t in bufs), None))
        self._release(batches, placed, recycle)
        return placed

    @staticmethod
    def _release(batches, placed: Placed, recycle: bool) -> None:
        """The copy has completed: the staging buffers may be filled again
        and, with ``recycle``, the batches' ring slots go back."""
        if placed.event is not None:
            placed.event.synchronize()
        if recycle:
            for b in batches:
                b.recycle()

    def _buffers(self, kind: tuple, trees, lead: tuple):
        """Pinned staging buffers shaped like ``trees`` with a leading
        ``lead``, made at the first use of their shapes."""
        key = kind + tuple(None if t is None else _signature(t)
                           for t in trees)
        bufs = self._staging.get(key)
        if bufs is None:
            bufs = tuple(None if t is None else _map(
                lambda a: host_buffer(lead + np.shape(a),
                                      np.asarray(a).dtype, True), t)
                for t in trees)
            self._staging[key] = bufs
        return bufs

    def _copy(self, trees) -> Placed:
        """Issue the copies of ``(inp, target)`` (pinned numpy arrays) on
        this object's stream and record their event."""
        with capture_guard():
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            event = torch.cuda.Event()
            with torch.cuda.stream(self._stream):
                out = [None if t is None else _map(
                    lambda a: torch.from_numpy(a).to(self.device,
                                                     non_blocking=True), t)
                       for t in trees]
                event.record(self._stream)
        return Placed(out[0], out[1], event)


def ready_groups(item, placed) -> list:
    """``(batches, (inp, target))`` of each program to run over a feed item
    placed by :meth:`HostToDevice.place`, ready on the current stream: a
    stacked window is one group, a per-batch list a group a batch."""
    if isinstance(placed, list):
        return [([b], p.ready()) for b, p in zip(item, placed)]
    return [(item if isinstance(item, list) else [item], placed.ready())]


def _host_signature(b) -> tuple:
    return tuple(None if x is None else _signature(x)
                 for x in (b.input, b.target))


def _owned_tensor(a) -> torch.Tensor:
    """A CPU tensor holding a copy of host array ``a``."""
    return torch.from_numpy(np.array(a, copy=True))
