"""Device-resident evaluation: the eval forward and the metric folds as one
captured program a batch.

Counterpart of the device-eval part of ``bigdl_tpu/optim/evaluator.py``
(``cached_forward_jit``, ``_eval_programs``, ``run_device_eval``, ``:262``).
The forward runs in eval mode under the engine's precision policy (the
parameters and floating inputs cast to the compute dtype, the output cast
back to fp32, as JAX's ``cached_forward_jit`` does); each method with a
device fold (``optim/validation.py``) folds the batch on the card, padded
rows masked out by ``valid``; the partials add up on the card and the pass
fetches O(1) scalars at its end. Methods without a device fold get each
batch's output on the host. On the card the forward and the folds are one
program of ``utils/programs.py`` (a CUDA graph captured at its first batch
and replayed after), cached on the model as JAX caches its programs; on the
CPU the same function runs eagerly.

Eval windows, as JAX's (``eval_fuse_steps``, ``BIGDL_EVAL_FUSE_STEPS``,
default 8): K consecutive batches of one shape are stacked on the host,
copied in one transfer and folded by one program of K forwards; a trailing
group of fewer batches runs a batch at a time. The batches come through a
``PrefetchingFeed(train=False)`` (depth ``BIGDL_PREFETCH``, default 2), as
JAX's (``bigdl_tpu/optim/evaluator.py:184``, ``:322``, ``:424``): its
producer stacks and copies the next window (``HostToDevice.place``) while
the card folds the current one; a window whose batches differ in shape is
placed and folded a batch at a time. With a host fold, a batch goes back to
its ring only after the fold has read its target.

:class:`Evaluator` (``test``) and :class:`Predictor` (``predict``,
``predict_class``, padding rows dropped) are JAX's facade over the same
passes (``bigdl_tpu/optim/evaluator.py:367-475``).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from bigdl_tpu_torch.nn.abstractnn import evaluating
from bigdl_tpu_torch.nn.precision import cast_floating
from bigdl_tpu_torch.dataset.dataset import AbstractDataSet, DataSet
from bigdl_tpu_torch.dataset.h2d import HostToDevice, ready_groups
from bigdl_tpu_torch.dataset.prefetch import PrefetchingFeed
from bigdl_tpu_torch.dataset.sample import (
    MiniBatch, Sample, SampleToMiniBatch,
)
from bigdl_tpu_torch.obs import trace
from bigdl_tpu_torch.optim.optimizer import _copy_into, _map, _signature
from bigdl_tpu_torch.optim.validation import ValidationMethod, ValidationResult
from bigdl_tpu_torch.utils.device import require_on, wait_for_stream
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.programs import ProgramCache


def eval_forward(model: torch.nn.Module, inp):
    """The inference forward under the engine's precision policy; call it
    in eval mode (``evaluating``) and without autograd."""
    dtype = Engine.compute_dtype()
    if dtype == torch.float32:
        return model(inp)
    params = cast_floating(dict(model.named_parameters()), dtype)
    out = functional_call(model, params, (cast_floating(inp, dtype),))
    return cast_floating(out, torch.float32)


def eval_fuse_steps(override: Optional[int] = None) -> int:
    """Eval-window size: ``override`` if given, else
    ``BIGDL_EVAL_FUSE_STEPS`` (default 8); 1 runs a batch at a time."""
    raw = os.environ.get("BIGDL_EVAL_FUSE_STEPS", "8") if override is None \
        else override
    try:
        k = int(raw)
        if k < 1:
            raise ValueError
    except (TypeError, ValueError):
        raise ValueError(
            f"eval fuse steps must be an integer >= 1, got {raw!r}")
    return k


#: bound on the eval programs cached on a model, as JAX's
#: ``_EVAL_CACHE_MAX``: beyond it the oldest goes, so a caller that makes
#: fresh method objects for every pass does not grow the cache without limit
_EVAL_CACHE_MAX = 8


def _program(model, dev_methods: list, need_outs: bool, inp, target,
             device, k: int = 1):
    """The eval program of ``model`` for batches like ``(inp, target)``; with
    ``k > 1`` for windows of ``k`` such batches stacked on a leading axis,
    folded one after the other and merged on the card."""
    cache = model.__dict__.get("_eval_programs")
    if cache is None or cache.device != device:
        cache = model.__dict__["_eval_programs"] = ProgramCache(device)
        model.__dict__["_eval_methods"] = {}
    key = ("eval_fold" if k == 1 else ("eval_window", k),
           Engine.compute_dtype(),
           tuple(id(m) for m in dev_methods), need_outs,
           _signature(inp), _signature(target),
           tuple(p.data_ptr() for p in model.parameters()),
           tuple(b.data_ptr() for b in model.buffers()))

    def build():
        def fold_one(x, t, mask):
            out = eval_forward(model, x)
            return tuple(m.device_fold(out, t, mask)
                         for m in dev_methods), out

        def fold(x, t, mask):
            with torch.no_grad(), evaluating(model):
                if k == 1:
                    parts, out = fold_one(x, t, mask)
                    return parts, (out if need_outs else None)
                parts, outs = None, []
                for j in range(k):
                    p, out = fold_one(_map(lambda a: a[j], x),
                                      _map(lambda a: a[j], t), mask[j])
                    parts = p if parts is None else tuple(
                        m.merge(c, q) for m, c, q in
                        zip(dev_methods, parts, p))
                    outs.append(out)
            return parts, (torch.stack(outs) if need_outs else None)

        x0 = inp if torch.is_tensor(inp) else inp[0]
        mask_shape = x0.shape[:1] if k == 1 else x0.shape[:2]
        return fold, (_map(torch.empty_like, inp),
                      _map(torch.empty_like, target),
                      torch.empty(mask_shape, dtype=torch.bool,
                                  device=device))

    # the key's ids name the methods' objects only while they live: each
    # program pins its methods, and both go together, oldest first
    pinned = model.__dict__["_eval_methods"]
    pinned.setdefault(key, dev_methods)
    while len(pinned) > _EVAL_CACHE_MAX:
        oldest = next(iter(pinned))
        cache.drop(oldest)
        del pinned[oldest]
    return cache.get_or_capture(key, build)


def _with_target(b):
    """A batch without labels (prediction) gets a placeholder target of a
    0 a row, which no fold reads."""
    if b.target is None:
        out = MiniBatch(b.input, np.zeros(b.size(), np.int32), b.valid)
        out._ring_slot, b._ring_slot = b._ring_slot, None
        return out
    return b


def _eval_pass(model, dataset, dev_methods, need_outs: bool, dev, fuse: int,
               stats: dict, on_outputs=None):
    """Run every batch of ``dataset`` through the eval programs (windows of
    ``fuse``, fed by a ``PrefetchingFeed(train=False)``); returns the merged
    device partials of ``dev_methods`` (None without batches) and calls
    ``on_outputs(out, batch)`` with each batch's outputs on the host when
    ``need_outs``."""
    h2d = HostToDevice(dev)
    carry = None
    # a host fold reads each batch's target after its placement: the
    # batches then go back to their ring only once folded
    feed = PrefetchingFeed(
        lambda: map(_with_target, dataset.data(train=False)),
        lambda item: h2d.place(item, fuse, recycle=not need_outs),
        depth=int(os.environ.get("BIGDL_PREFETCH", "2")), window=fuse,
        train=False)
    with feed, trace.span("eval/pass"):
        for item, placed in feed:
            for group, (inp, target) in ready_groups(item, placed):
                carry = _fold(model, dev_methods, need_outs, dev, group, inp,
                              target, carry, stats, on_outputs)
                for b in group:
                    b.recycle()
    return carry


def _fold(model, dev_methods, need_outs, dev, group, inp, target, carry,
          stats, on_outputs):
    """One eval program over ``group`` (one batch, or a stacked window of
    them) already on the device; returns the merged partials."""
    k = len(group)
    stacked = k > 1
    # the mask of valid rows, made on the card (no host copy)
    n = group[0].size()
    rows = torch.arange(n, device=dev)
    mask = (torch.stack([rows < b.valid for b in group]) if stacked
            else rows < group[0].valid)
    if stacked:
        stats["fused_windows"] += 1
    prog = _program(model, dev_methods, need_outs, inp, target, dev, k)
    s_inp, s_target, s_mask = prog.inputs
    _copy_into(s_inp, inp)
    _copy_into(s_target, target)
    s_mask.copy_(mask)
    parts, out = prog()
    # the program's outputs are overwritten by its next call: merge on
    # the card now (into fresh tensors)
    carry = (tuple(tuple(p.clone() for p in part) for part in parts)
             if carry is None else
             tuple(m.merge(c, p) for m, c, p in
                   zip(dev_methods, carry, parts)))
    if need_outs:
        t0 = time.perf_counter()
        wait_for_stream(out)
        host_out = out.cpu()
        stats["wait_ms"] += (time.perf_counter() - t0) * 1e3
        stats["fetch_bytes"] += host_out.numel() * host_out.element_size()
        for j, b in enumerate(group):
            on_outputs(host_out[j] if stacked else host_out, b)
    stats["batches"] += k
    stats["samples"] += sum(b.valid for b in group)
    return carry


def run_device_eval(model: torch.nn.Module, dataset,
                    methods: Sequence[ValidationMethod], device=None,
                    allow_empty: bool = False,
                    fuse_steps: Optional[int] = None):
    """One evaluation pass over ``dataset`` (batches of ``MiniBatch``), in
    windows of ``eval_fuse_steps(fuse_steps)`` batches. Returns
    ``(results, stats)``: ``results`` aligned with ``methods``, ``stats``
    with ``batches``, ``samples``, ``fused_windows``, ``fetch_bytes`` (what
    the pass copied to the host) and ``wait_ms`` (how long it waited for
    those copies). ``device`` is where the model must live (``None``: the
    card)."""
    dev = require_on(model, device)
    fuse = eval_fuse_steps(fuse_steps)
    dev_methods = [m for m in methods if m.has_device_fold()]
    dev_idx = [i for i, m in enumerate(methods) if m.has_device_fold()]
    host_idx = [i for i, m in enumerate(methods) if not m.has_device_fold()]
    results: list[Optional[ValidationResult]] = [None] * len(methods)
    stats = {"batches": 0, "samples": 0, "fused_windows": 0,
             "fetch_bytes": 0, "wait_ms": 0.0}

    def host_fold(out, b):
        for i in host_idx:
            r = methods[i].apply(out, b.target, b.valid)
            results[i] = r if results[i] is None else results[i] + r

    carry = _eval_pass(model, dataset, dev_methods, bool(host_idx), dev,
                       fuse, stats, host_fold)
    if stats["batches"] == 0:
        if allow_empty:
            return results, stats
        raise ValueError("empty dataset")
    if dev_methods:
        flat = torch.stack([p.double() for part in carry for p in part])
        stats["fetch_bytes"] += flat.numel() * flat.element_size()
        t0 = time.perf_counter()
        wait_for_stream(flat)
        vals = iter(flat.tolist())
        stats["wait_ms"] += (time.perf_counter() - t0) * 1e3
        for i, m, part in zip(dev_idx, dev_methods, carry):
            results[i] = m.finalize(tuple(next(vals) for _ in part))
    return results, stats


def _as_dataset(data, batch_size: Optional[int]) -> AbstractDataSet:
    """A batched DataSet as given, or a list of Samples or a numpy array of
    features batched by ``batch_size`` (integer arrays cast to fp32, as
    JAX's ``_as_dataset``)."""
    if isinstance(data, AbstractDataSet):
        return data
    if batch_size is None:
        raise ValueError("batch_size is required when passing raw "
                         "samples/arrays")
    if isinstance(data, np.ndarray):
        if not np.issubdtype(data.dtype, np.floating):
            data = data.astype(np.float32)
        data = [Sample(x) for x in data]
    return DataSet.array(list(data)) >> SampleToMiniBatch(batch_size)


class Predictor:
    """Forward-only mapper (JAX's ``Predictor``): ``predict`` returns the
    stacked outputs with padding rows dropped, ``predict_class`` the argmax
    class of each sample; windows of ``eval_fuse_steps`` batches."""

    def __init__(self, model: torch.nn.Module, device=None):
        self.model = model
        self.device = device

    def predict(self, data, batch_size: Optional[int] = None,
                fuse_steps: Optional[int] = None) -> np.ndarray:
        dev = require_on(self.model, self.device)
        dataset = _as_dataset(data, batch_size)
        outs: list = []
        stats = {"batches": 0, "samples": 0, "fused_windows": 0,
                 "fetch_bytes": 0, "wait_ms": 0.0}
        _eval_pass(self.model, dataset, [], True, dev,
                   eval_fuse_steps(fuse_steps), stats,
                   lambda out, b: outs.append(out.numpy()[:b.valid]))
        if not outs:
            raise ValueError("empty dataset")
        return np.concatenate(outs, axis=0)

    def predict_class(self, data, batch_size: Optional[int] = None
                      ) -> np.ndarray:
        out = self.predict(data, batch_size)
        return out.reshape(out.shape[0], -1).argmax(axis=1).astype(np.int32)


class Evaluator:
    """Runs validation methods over a dataset (JAX's ``Evaluator``); the
    last pass's numbers are kept on ``last_stats``."""

    def __init__(self, model: torch.nn.Module, device=None):
        self.model = model
        self.device = device
        self.last_stats: Optional[dict] = None

    def test(self, dataset, methods: Sequence[ValidationMethod],
             batch_size: Optional[int] = None,
             fuse_steps: Optional[int] = None) -> list:
        """``[(result, method), ...]`` over ``dataset``."""
        if not methods:
            raise ValueError(
                "methods is required: pass ValidationMethods, e.g. "
                "Evaluator(model).test(ds, [Top1Accuracy()], batch_size=32)")
        dataset = _as_dataset(dataset, batch_size)
        results, stats = run_device_eval(self.model, dataset, list(methods),
                                         self.device, fuse_steps=fuse_steps)
        self.last_stats = stats
        return list(zip(results, methods))
