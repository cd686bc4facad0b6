"""The training loop: ``Optimizer`` / ``LocalOptimizer`` on one device.

Counterpart of the core of ``bigdl_tpu/optim/optimizer.py``
(``_make_step_fn`` and ``_optimize_impl``). One step runs the model and the
criterion forward, differentiates with autograd (the flash-attention and
LayerNorm ``autograd.Function``s carry the kernels' backward), averages
microbatch gradients under gradient accumulation, clips, and lets the
``OptimMethod`` update the parameters in place. The loop shuffles the
dataset at every epoch start and stops on ``end_when``, evaluated at the
top of each iteration with the 1-based ``state["neval"]``.

``state["loss"]`` is the loss of the last step, computed before its
update. The JAX trainer fetches losses in batches to keep its device
queue full; here each step reads its loss after the update has been
enqueued, so the card is never left waiting on the read, and a non-finite
loss raises :class:`NonFiniteLossError` at the step that produced it.

Not ported yet (ROADMAP Queue A.1): checkpointing, validation, summaries,
fused multi-step windows, remat, freeze and ``grad_scales``, sparse
embeddings, mixed precision, profiling and preemption.
"""

from __future__ import annotations

import logging
import math
import sys
import time
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.nn.criterion import AbstractCriterion
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.device import require_on

logger = logging.getLogger(__name__)


class NonFiniteLossError(RuntimeError):
    """A step produced a NaN or infinite loss."""

    def __init__(self, message: str, iteration: int = 0):
        super().__init__(message)
        self.iteration = iteration


def _map(fn, x):
    """Apply ``fn`` to a tensor or to each element of a tuple/list."""
    if isinstance(x, (tuple, list)):
        return type(x)(fn(a) for a in x)
    return fn(x)


class Optimizer:
    """Trainer front end. ``Optimizer(model, dataset, criterion)`` builds a
    :class:`LocalOptimizer`, as the JAX factory does for a local dataset.
    ``device`` is where the model must live: ``None`` means the card."""

    def __new__(cls, model=None, dataset=None, criterion=None, **kw):
        if cls is Optimizer:
            return super().__new__(LocalOptimizer)
        return super().__new__(cls)

    def __init__(self, model: torch.nn.Module, dataset: AbstractDataSet,
                 criterion: AbstractCriterion, device=None):
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.device = device
        self.optim_method: OptimMethod = SGD()
        self.end_when: Trigger = Trigger.max_iteration(sys.maxsize)
        self.grad_clip_const: Optional[tuple[float, float]] = None
        self.grad_clip_norm: Optional[float] = None
        self.grad_accum: int = 1
        self.state: dict = {"epoch": 1, "neval": 1, "epoch_finished": False}
        # optimizer slots, kept across optimize() calls: a second call
        # continues the run, as in JAX
        self._ostate: Optional[dict] = None

    # fluent config (reference API shape) ----------------------------------
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        self._ostate = None
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_constant_gradient_clipping(self, min_v: float,
                                       max_v: float) -> "Optimizer":
        self.grad_clip_const = (min_v, max_v)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float
                                         ) -> "Optimizer":
        self.grad_clip_norm = clip_norm
        return self

    def disable_gradient_clipping(self) -> "Optimizer":
        self.grad_clip_const = None
        self.grad_clip_norm = None
        return self

    def set_gradient_accumulation(self, n_micro: int) -> "Optimizer":
        """Split every mini-batch into ``n_micro`` strided microbatches
        (microbatch i is rows i::n_micro, as in JAX), one forward/backward
        each, and average their gradients before the single update. A
        criterion with ``size_average=False`` sums instead."""
        if n_micro != int(n_micro) or int(n_micro) < 1:
            raise ValueError(f"n_micro must be a positive integer, got "
                             f"{n_micro!r}")
        self.grad_accum = int(n_micro)
        return self

    # ------------------------------------------------------------- step
    def _clip_grads(self, grads: list) -> list:
        if self.grad_clip_const is not None:
            lo, hi = self.grad_clip_const
            grads = [g.clamp(lo, hi) for g in grads]
        if self.grad_clip_norm is not None:
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = (self.grad_clip_norm / (norm + 1e-12)).clamp(max=1.0)
            grads = [g * scale for g in grads]
        return grads

    def _value_and_grad(self, params: list, inp, target):
        loss = self.criterion.apply(self.model(inp), target)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), list(grads)

    def _loss_and_grads(self, params: list, inp, target):
        accum = self.grad_accum
        if accum == 1:
            return self._value_and_grad(params, inp, target)

        def micro(a, i):
            if a.shape[0] % accum:
                raise ValueError(
                    f"batch size {a.shape[0]} is not divisible by "
                    f"set_gradient_accumulation({accum})")
            return a[i::accum]

        lsum = gsum = None
        for i in range(accum):
            l, g = self._value_and_grad(
                params, _map(lambda a: micro(a, i), inp),
                _map(lambda a: micro(a, i), target))
            if gsum is None:
                lsum, gsum = l, g
            else:
                lsum = lsum + l
                gsum = [a + b for a, b in zip(gsum, g)]
        # averaging criteria: the mean of micro means is the full-batch
        # mean; summing criteria: the micro sums already are the full sum
        if not hasattr(self.criterion, "size_average"):
            logger.warning(
                "gradient accumulation: criterion %s does not expose "
                "size_average; assuming mean reduction (micro-grads "
                "averaged)", type(self.criterion).__name__)
        if bool(getattr(self.criterion, "size_average", True)):
            return lsum / accum, [g / accum for g in gsum]
        return lsum, gsum

    def train_step(self, inp, target) -> float:
        """One optimizer step on a batch already on the model's device, at
        iteration ``state["neval"]``: forward, backward, clip, update.
        Sets ``state["loss"]`` (the loss before the update), advances
        ``neval`` and returns the loss."""
        params = list(self.model.parameters())
        if self._ostate is None:
            self._ostate = self.optim_method.init_state(params)
        it = self.state["neval"]
        loss, grads = self._loss_and_grads(params, inp, target)
        grads = self._clip_grads(grads)
        self.optim_method.update(params, grads, self._ostate, it - 1)
        val = float(loss)
        if not math.isfinite(val):
            raise NonFiniteLossError(
                f"non-finite loss at iteration {it}: {val}", iteration=it)
        self.state["loss"] = val
        self.state["neval"] = it + 1
        return val

    # ------------------------------------------------------------- loop
    def optimize(self) -> torch.nn.Module:
        """Run the training loop until ``end_when`` fires; returns the
        model, trained in place."""
        device = require_on(self.model, self.device)
        self.model.train()
        state = self.state

        def put(a):
            return torch.as_tensor(np.asarray(a)).to(device,
                                                     non_blocking=True)

        stop = False
        while not stop:
            state["epoch_finished"] = False
            self.dataset.shuffle()
            batches = iter(self.dataset.data(train=True))
            had_data = False
            t0, records = time.perf_counter(), 0
            while True:
                # evaluated at loop top with the 1-based neval, so
                # max_iteration(n) runs exactly n iterations
                if self.end_when(state):
                    stop = True
                    break
                try:
                    batch = next(batches)
                except StopIteration:
                    break
                had_data = True
                loss = self.train_step(_map(put, batch.input),
                                       _map(put, batch.target))
                records += batch.valid
                logger.info("Epoch %d iter %d: loss %.6f, %.1f records/s",
                            state["epoch"], state["neval"] - 1, loss,
                            records / (time.perf_counter() - t0))
            if stop:
                break
            if not had_data:
                raise RuntimeError("dataset yielded no batches")
            state["epoch"] += 1
            state["epoch_finished"] = True
            if self.end_when(state):
                break
        return self.model


class LocalOptimizer(Optimizer):
    """Single-device trainer (the only one ported so far)."""
