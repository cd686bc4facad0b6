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

JAX also fuses eval batches into windows (``BIGDL_EVAL_FUSE_STEPS``) and
prefetches the feed on a thread; here a batch is one replay and the feed is
serial.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from bigdl_tpu_torch.nn.abstractnn import evaluating
from bigdl_tpu_torch.nn.precision import cast_floating
from bigdl_tpu_torch.optim.optimizer import _copy_into, _map, _signature
from bigdl_tpu_torch.optim.validation import ValidationMethod, ValidationResult
from bigdl_tpu_torch.utils.device import require_on
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


#: bound on the eval programs cached on a model, as JAX's
#: ``_EVAL_CACHE_MAX``: beyond it the oldest goes, so a caller that makes
#: fresh method objects for every pass does not grow the cache without limit
_EVAL_CACHE_MAX = 8


def _program(model, dev_methods: list, need_outs: bool, inp, target,
             device):
    """The eval program of ``model`` for batches like ``(inp, target)``."""
    cache = model.__dict__.get("_eval_programs")
    if cache is None or cache.device != device:
        cache = model.__dict__["_eval_programs"] = ProgramCache(device)
        model.__dict__["_eval_methods"] = {}
    key = ("eval_fold", Engine.compute_dtype(),
           tuple(id(m) for m in dev_methods), need_outs,
           _signature(inp), _signature(target),
           tuple(p.data_ptr() for p in model.parameters()),
           tuple(b.data_ptr() for b in model.buffers()))

    def build():
        def fold(x, t, mask):
            with torch.no_grad(), evaluating(model):
                out = eval_forward(model, x)
                parts = tuple(m.device_fold(out, t, mask)
                              for m in dev_methods)
            return parts, (out if need_outs else None)

        rows = (inp if torch.is_tensor(inp) else inp[0]).shape[0]
        return fold, (_map(torch.empty_like, inp),
                      _map(torch.empty_like, target),
                      torch.empty(rows, dtype=torch.bool, device=device))

    # the key's ids name the methods' objects only while they live: each
    # program pins its methods, and both go together, oldest first
    pinned = model.__dict__["_eval_methods"]
    pinned.setdefault(key, dev_methods)
    while len(pinned) > _EVAL_CACHE_MAX:
        oldest = next(iter(pinned))
        cache.drop(oldest)
        del pinned[oldest]
    return cache.get_or_capture(key, build)


def run_device_eval(model: torch.nn.Module, dataset,
                    methods: Sequence[ValidationMethod], device=None,
                    allow_empty: bool = False):
    """One evaluation pass over ``dataset`` (batches of ``MiniBatch``).
    Returns ``(results, stats)``: ``results`` aligned with ``methods``,
    ``stats`` with ``batches``, ``samples`` and ``fetch_bytes`` (what the
    pass copied to the host). ``device`` is where the model must live
    (``None``: the card)."""
    dev = require_on(model, device)
    dev_methods = [m for m in methods if m.has_device_fold()]
    dev_idx = [i for i, m in enumerate(methods) if m.has_device_fold()]
    host_idx = [i for i, m in enumerate(methods) if not m.has_device_fold()]
    results: list[Optional[ValidationResult]] = [None] * len(methods)
    stats = {"batches": 0, "samples": 0, "fetch_bytes": 0}
    carry = None
    for b in dataset.data(train=False):
        inp, target = (_map(lambda a: torch.from_numpy(np.asarray(a)).to(
            dev, non_blocking=True), x) for x in (b.input, b.target))
        mask = torch.from_numpy(np.arange(b.size()) < b.valid).to(
            dev, non_blocking=True)
        prog = _program(model, dev_methods, bool(host_idx), inp, target, dev)
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
        if host_idx:
            host_out = out.cpu()
            stats["fetch_bytes"] += host_out.numel() * host_out.element_size()
            for i in host_idx:
                r = methods[i].apply(host_out, b.target, b.valid)
                results[i] = r if results[i] is None else results[i] + r
        stats["batches"] += 1
        stats["samples"] += b.valid
    if stats["batches"] == 0:
        if allow_empty:
            return results, stats
        raise ValueError("empty dataset")
    if dev_methods:
        flat = torch.stack([p.double() for part in carry for p in part])
        stats["fetch_bytes"] += flat.numel() * flat.element_size()
        vals = iter(flat.tolist())
        for i, m, part in zip(dev_idx, dev_methods, carry):
            results[i] = m.finalize(tuple(next(vals) for _ in part))
    return results, stats
