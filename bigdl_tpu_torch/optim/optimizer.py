"""The training loop: ``Optimizer`` / ``LocalOptimizer`` on one device.

Counterpart of the core of ``bigdl_tpu/optim/optimizer.py``
(``_make_step_fn`` and ``_optimize_impl``). One step runs the model and the
criterion forward, differentiates with autograd (the flash-attention and
LayerNorm ``autograd.Function``s carry the kernels' backward), averages
microbatch gradients under gradient accumulation, scales them per
parameter (``grad_scales``), clips, and lets the ``OptimMethod`` update the
parameters in place. The loop shuffles the dataset at every epoch start
and stops on ``end_when``, evaluated at the top of each iteration with the
1-based ``state["neval"]``.

The step follows JAX's options:

- mixed precision: when ``Engine.compute_dtype()`` is not fp32, the fp32
  master parameters and the floating inputs are cast to it inside the
  step, the model runs on the cast parameters
  (``torch.func.functional_call``), and its output is cast to fp32 before
  the criterion; the casts' backward returns fp32 gradients;
- frozen parameters (``module.freeze()``) enter the forward detached, so no
  gradient is computed for them, and get no optimizer slots;
- attached regularizers add their penalty to the loss;
- ``set_remat("dots"|"full")`` runs the loss under non-reentrant
  ``torch.utils.checkpoint`` ("dots" keeps the matrix products' outputs);
- ``set_flat_update`` runs an elementwise method over flat buffers
  (``kernels/fused_update.py``);
- ``set_optim_methods`` routes named submodules to their own methods.

**The step as a program.** As JAX jits the whole step (``_make_step_fn``),
the port runs it as one program of ``utils/programs.py``: on the card a
CUDA graph of the forward under the precision policy, the criterion, the
backward, scales, clipping and the update, captured at the first step of
its key and replayed after that. The key holds what JAX's step cache is
keyed on and what a graph binds: the compute dtype, the gradient scales
(frozen ones are 0), the method and its slots, the batch's shapes and
dtypes, remat, accumulation, clipping, and the parameters' storage. The
update reads its step-dependent numbers (rates, bias corrections) from a
small device tensor written before each replay
(``OptimMethod.hyper``). Slots are created on the host before the first
run of a key, which is an eager warm-up; the program captures after it.

**Fused windows** (``set_fuse_steps(K)`` / ``BIGDL_FUSE_STEPS``, default
1), with JAX's semantics: a window runs ``min(K, end_when.next_fire_in)``
steps (so the stop trigger still fires at its exact iteration), its
batches stacked on the host and copied to the card in one transfer, the
step program replayed once a step over the window's slices, and the
window's losses fetched once; a non-finite one raises
:class:`NonFiniteLossError` there, with its iteration. A partial trailing
window at the end of an epoch runs step by step. ``state["neval"]``,
``state["loss"]`` and the iterations at which ``end_when`` fires are those
of a per-step run, and so are the losses and parameters. On the CPU the
same code runs eagerly.

``state["loss"]`` is the loss of the last step, computed before its
update.

**Module state.** Batch norm's running statistics are buffers of the model,
JAX's ``mstate`` (``_make_step_fn``, ``bigdl_tpu/optim/optimizer.py:748-870``):
the training forward updates them in place, once a (micro)batch, so they
follow the step through a captured program (the key holds their storage),
fused windows, remat (a recomputation does not update them again,
``nn.normalization.recomputing``) and gradient accumulation (micro-batch i
sees what micro-batch i − 1 left). Under mixed precision only the
parameters are cast (``functional_call``); the buffers stay fp32.
``BIGDL_CONVBN_FUSE=1`` rewrites the model's conv → BN (→ ReLU) chains into
``kernels.conv_bn.FusedConvBNReLU`` once, before the first step.

**Validation** (``set_validation``): when its trigger fires, after a window
with ``neval`` the iteration just run, as JAX evaluates it, or at an epoch's
end, ``optim/evaluator.run_device_eval`` runs the validation set in eval
mode through a captured program that folds the metrics on the card; the
results go to the log and ``state["scores"]`` (``state["score"]``: the
first method's). Windows are clipped so the trigger fires at its exact
iteration.

Not ported yet (ROADMAP Queue A.1.6): checkpointing, summaries, Plateau's
trainer hook, sparse embeddings, profiling and preemption.
"""

from __future__ import annotations

import functools
import logging
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch.func import functional_call

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.nn.criterion import AbstractCriterion
from bigdl_tpu_torch.nn.normalization import (
    checkpoint_contexts, dropout_generators,
)
from bigdl_tpu_torch.nn.precision import cast_floating
from bigdl_tpu_torch.optim.optim_method import (
    SGD, CompositeOptimMethod, OptimMethod,
)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.device import require_on
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.programs import Program

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


def _copy_into(dst, src) -> None:
    """Copy a tensor, or each tensor of a tuple/list, into ``dst``."""
    if isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            d.copy_(s)
    else:
        dst.copy_(src)


def _stack(xs: list):
    """Stack host arrays (or tuples of them) along a new leading axis."""
    if isinstance(xs[0], (tuple, list)):
        return type(xs[0])(np.stack([np.asarray(x[i]) for x in xs])
                           for i in range(len(xs[0])))
    return np.stack([np.asarray(x) for x in xs])


def _signature(x) -> tuple:
    """Shapes and dtypes of a tensor or a tuple/list of them."""
    if isinstance(x, (tuple, list)):
        return tuple(_signature(a) for a in x)
    return (tuple(x.shape), x.dtype)


def _fuse_steps(k) -> int:
    if k != int(k) or int(k) < 1:
        raise ValueError(f"fuse_steps must be a positive integer, got "
                         f"{k!r}")
    return int(k)


REMAT_MODES = ("none", "dots", "full")
# what remat "dots" keeps: the matrix products' outputs (JAX's
# checkpoint_dots); everything else is recomputed in the backward
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                  torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_mode(mode: str) -> str:
    mode = str(mode).strip().lower()
    if mode not in REMAT_MODES:
        raise ValueError(f"remat mode must be one of {REMAT_MODES}, got "
                         f"{mode!r}")
    return mode


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
        # rematerialization of the loss (set_remat / BIGDL_REMAT)
        self.remat: str = _remat_mode(os.environ.get("BIGDL_REMAT", "none"))
        # flat-buffer update (set_flat_update / BIGDL_FLAT_UPDATE)
        self.flat_update: bool = os.environ.get("BIGDL_FLAT_UPDATE",
                                                "0") == "1"
        # steps a fused window runs (set_fuse_steps / BIGDL_FUSE_STEPS)
        self.fuse_steps: int = _fuse_steps(
            int(os.environ.get("BIGDL_FUSE_STEPS", "1")))
        self.state: dict = {"epoch": 1, "neval": 1, "epoch_finished": False}
        # optimizer slots, kept across optimize() calls: a second call
        # continues the run, as in JAX; with the method that made them and
        # the trainable mask they were trimmed to
        self._ostate: Optional[dict] = None
        self._method: Optional[OptimMethod] = None
        self._ostate_mask = None
        self._ostate_version = 0
        # the step program of the current key (utils/programs.py)
        self._step_program: Optional[Program] = None
        self.val_trigger: Optional[Trigger] = None
        self.val_dataset: Optional[AbstractDataSet] = None
        self.val_methods: list = []
        self._convbn_fused = False

    # fluent config (reference API shape) ----------------------------------
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        self._ostate = None
        return self

    def set_optim_methods(self, methods: dict) -> "Optimizer":
        """Per-submodule optimizers (reference ``setOptimMethods``):
        ``methods`` maps module names (``set_name``) to OptimMethods; each
        named module's parameters update with its own method, the rest with
        the current ``set_optim_method`` default. A name that occurs more
        than once routes every occurrence."""
        prefixes: dict = {}

        def walk(m, path):
            if getattr(m, "name", None) in methods:
                prefixes.setdefault(m.name, []).append(path)
            for idx, child in m.named_children():
                walk(child, path + (idx,))

        walk(self.model, ())
        missing = set(methods) - set(prefixes)
        if missing:
            raise ValueError(f"set_optim_methods: module names not found in "
                             f"the model: {sorted(missing)}")
        groups = [(name, path, method) for name, method in methods.items()
                  for path in prefixes[name]]
        default = self.optim_method
        if isinstance(default, CompositeOptimMethod):
            # a repeated call: new names override, the rest carry over
            groups = [g for g in default.groups if g[0] not in methods] \
                + groups
            default = default.default
        return self.set_optim_method(CompositeOptimMethod(groups, default))

    def set_remat(self, mode: str) -> "Optimizer":
        """Rematerialization of the loss (model and criterion) in the
        backward, by non-reentrant ``torch.utils.checkpoint``: "none" keeps
        every activation, "dots" keeps the matrix products' outputs and
        recomputes the rest, "full" recomputes the whole forward."""
        self.remat = _remat_mode(mode)
        return self

    def set_flat_update(self, enabled: bool = True) -> "Optimizer":
        """Run an elementwise method over one flat buffer per parameter
        dtype (``kernels/fused_update.py``), bit for bit the per-leaf
        update. Methods that need the leaves (``layer_lr_mults``, LARS,
        L-BFGS, composite) keep the per-leaf path."""
        self.flat_update = bool(enabled)
        self._ostate = None
        return self

    def set_fuse_steps(self, k: int) -> "Optimizer":
        """Run up to ``k`` consecutive steps as one window: their batches
        go to the card in one copy, the step program is replayed ``k``
        times, and their losses come back in one fetch. The window is
        clipped so that ``end_when`` fires at its exact iteration; ``k=1``
        (the default) is the per-step loop."""
        self.fuse_steps = _fuse_steps(k)
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_validation(self, trigger: Trigger, dataset: AbstractDataSet,
                       methods) -> "Optimizer":
        """Evaluate ``methods`` (``optim/validation.py``) over ``dataset``
        whenever ``trigger`` fires."""
        self.val_trigger, self.val_dataset = trigger, dataset
        self.val_methods = list(methods)
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

    def _effective_method(self) -> OptimMethod:
        """The method the step runs: the configured one, wrapped for the
        flat update when that is on and the method allows it."""
        method = self.optim_method
        if self.flat_update:
            from bigdl_tpu_torch.kernels.fused_update import (
                FlatParamUpdate, flat_supported,
            )
            if flat_supported(method):
                return FlatParamUpdate(method)
            logger.warning("flat update: %r has no elementwise flat form; "
                           "keeping the per-leaf update", method)
        return method

    def _loss(self, frozen: frozenset, inp, target):
        """The loss of one (micro)batch, the function that remat
        checkpoints: the model under the precision policy, with frozen
        parameters detached, the criterion in fp32, and the regularizers'
        penalty on the parameters the model ran with."""
        model = self.model
        dtype = Engine.compute_dtype()
        mixed = dtype != torch.float32
        params = None
        if mixed or frozen:
            params = {n: p.detach() if n in frozen else p
                      for n, p in model.named_parameters()}
            if mixed:
                params = cast_floating(params, dtype)
                inp = cast_floating(inp, dtype)
            out = functional_call(model, params, (inp,))
            if mixed:
                out = cast_floating(out, torch.float32)
        else:
            out = model(inp)
        loss = self.criterion.apply(out, target)
        if model.has_regularizers():
            loss = loss + model.regularizer_penalty(params)
        return loss

    def _value_and_grad(self, params: list, inp, target, frozen=frozenset()):
        loss_fn = functools.partial(self._loss, frozen)
        if self.remat == "none":
            loss = loss_fn(inp, target)
        else:
            inner = (functools.partial(
                torch.utils.checkpoint.create_selective_checkpoint_contexts,
                _save_dots) if self.remat == "dots" else None)
            # a captured step may not read the generator's state: the
            # recomputation gets the forward's dropout masks instead
            loss = torch.utils.checkpoint.checkpoint(
                loss_fn, inp, target, use_reentrant=False,
                context_fn=functools.partial(checkpoint_contexts, inner),
                preserve_rng_state=False)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), list(grads)

    def _loss_and_grads(self, params: list, inp, target, frozen=frozenset()):
        accum = self.grad_accum
        if accum == 1:
            return self._value_and_grad(params, inp, target, frozen)

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
                _map(lambda a: micro(a, i), target), frozen)
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

    def _prepare_step(self):
        """Host side of a step: the parameters by path, their gradient
        scales and the trainable mask; creates the optimizer's slots for
        the mask (before any capture)."""
        named = dict(self.model.named_parameters())
        scales = self.model.grad_scales()
        trainable = [scales[n] != 0.0 for n in named]
        mask = None if all(trainable) else trainable
        if self._ostate is None or mask != self._ostate_mask:
            if self._ostate is not None:
                logger.warning("the frozen parameters changed: optimizer "
                               "slots start again")
            self._step_program = None
            self._method = self._effective_method()
            self._ostate = self._method.init_state_trimmed(named, mask)
            self._ostate_mask = mask
            self._ostate_version += 1
        return named, scales, mask

    def _make_step_fn(self, named: dict, scales: dict, mask):
        """One optimizer step over the program's static inputs
        ``(inp, target, h)``: forward, backward, scale, clip, and the update
        in place with the step's numbers ``h``. Returns the loss (before
        the update), on the device."""
        frozen = frozenset(n for n in named if scales[n] == 0.0)
        train = [n for n in named if n not in frozen]
        method, ostate = self._method, self._ostate

        def step(inp, target, h):
            loss, grads = self._loss_and_grads([named[n] for n in train],
                                               inp, target, frozen)
            grads = [g if scales[n] == 1.0 else g * scales[n]
                     for n, g in zip(train, grads)]
            grads = dict(zip(train, self._clip_grads(grads)))
            method.update_with_trimmed(
                named, {n: grads.get(n) for n in named}, ostate, h, mask)
            return loss

        return step

    def _program_for(self, inp, target) -> Program:
        """The step program for a batch like ``(inp, target)``, captured
        anew when its key changes (the previous graph is dropped first)."""
        named, scales, mask = self._prepare_step()
        key = ("train_step", Engine.compute_dtype(),
               tuple(scales.values()), self._method, self._ostate_version,
               self.criterion, self.remat, self.grad_accum,
               self.grad_clip_const, self.grad_clip_norm,
               _signature(inp), _signature(target),
               tuple(p.data_ptr() for p in named.values()),
               tuple(b.data_ptr() for b in self.model.buffers()))
        prog = self._step_program
        if prog is None or prog.key != key:
            self._step_program = prog = None
            h = torch.zeros(len(self._method.hyper(0, self._ostate)),
                            dtype=torch.float32,
                            device=next(iter(named.values())).device)
            prog = Program(key, self._make_step_fn(named, scales, mask),
                           (_map(torch.empty_like, inp),
                            _map(torch.empty_like, target), h),
                           h.device,
                           generators=dropout_generators(self.model))
            self._step_program = prog
        return prog

    def _run_steps(self, batches: list) -> list:
        """Run one optimizer step for each ``(inp, target)`` of
        ``batches`` (already on the model's device), from iteration
        ``state["neval"]``: the step program once a step, the losses
        fetched once at the end and checked there. Advances ``neval``,
        sets ``state["loss"]`` and returns the losses."""
        prog = self._program_for(*batches[0])
        start, n = self.state["neval"], len(batches)
        s_inp, s_target, s_h = prog.inputs
        h = torch.tensor([self._method.hyper(start - 1 + k, self._ostate)
                          for k in range(n)], dtype=torch.float32)
        h = h.to(s_h.device, non_blocking=True)
        losses = torch.empty(n, dtype=torch.float32, device=s_h.device)
        for k, (inp, target) in enumerate(batches):
            _copy_into(s_inp, inp)
            _copy_into(s_target, target)
            s_h.copy_(h[k])
            losses[k].copy_(prog())
        vals = losses.tolist()
        for k, val in enumerate(vals):
            if not math.isfinite(val):
                self.state["neval"] = start + n
                raise NonFiniteLossError(
                    f"non-finite loss at iteration {start + k}: {val}",
                    iteration=start + k)
        self.state["loss"] = vals[-1]
        self.state["neval"] = start + n
        return vals

    def train_step(self, inp, target) -> float:
        """One optimizer step on a batch already on the model's device, at
        iteration ``state["neval"]``: forward, backward, scale, clip,
        update. Sets ``state["loss"]`` (the loss before the update),
        advances ``neval`` and returns the loss."""
        return self._run_steps([(inp, target)])[0]

    def _fusible_steps(self, state: dict) -> int:
        """Iterations that may run from ``state["neval"]`` in one window
        before ``end_when`` or the validation trigger could fire (JAX also
        clips at its checkpoint and summary triggers, not ported yet)."""
        bound = self.end_when.next_fire_in(state)
        if self.val_trigger is not None and _in_scope(self.val_trigger,
                                                      boundary=False):
            bound = min(bound, self.val_trigger.next_fire_in(state))
        return bound

    def _fire_validation(self, boundary: bool) -> None:
        """Validate if the trigger fires here: inside the loop (``neval``
        read as the iteration just run, JAX's convention) or at an epoch's
        end."""
        trig = self.val_trigger
        if trig is None or not _in_scope(trig, boundary):
            return
        state = self.state if boundary else dict(
            self.state, neval=self.state["neval"] - 1)
        if trig(state):
            self._run_validation()

    def _run_validation(self) -> None:
        from bigdl_tpu_torch.optim.evaluator import run_device_eval
        if self.val_dataset is None or not self.val_methods:
            return
        results, stats = run_device_eval(self.model, self.val_dataset,
                                         self.val_methods, self.device,
                                         allow_empty=True)
        logger.info("Validation pass: %d batches, val_fetch_bytes=%d",
                    stats["batches"], stats["fetch_bytes"])
        self.state["val_fetch_bytes"] = stats["fetch_bytes"]
        scores = self.state.setdefault("scores", {})
        for m, r in zip(self.val_methods, results):
            if r is not None:
                v, c = r.result()
                logger.info("Validation %s: %.4f (%d samples)", m.name, v, c)
                scores[m.name] = v
        if results and results[0] is not None:
            self.state["score"] = results[0].result()[0]

    def _run_window(self, window: list, device) -> list:
        """The steps of a window of host batches: stacked on the host and
        copied to the card in one transfer, each step reading its slice."""
        inp, target = (
            _map(lambda a: torch.from_numpy(a).to(device, non_blocking=True),
                 _stack(xs))
            for xs in ([b.input for b in window], [b.target for b in window]))
        return self._run_steps([
            (_map(lambda a: a[k], inp), _map(lambda a: a[k], target))
            for k in range(len(window))])

    # ------------------------------------------------------------- loop
    def optimize(self) -> torch.nn.Module:
        """Run the training loop until ``end_when`` fires; returns the
        model, trained in place."""
        device = require_on(self.model, self.device)
        if os.environ.get("BIGDL_CONVBN_FUSE", "0") == "1" \
                and not self._convbn_fused:
            from bigdl_tpu_torch.nn.graph import fuse_conv_bn
            self.model = fuse_conv_bn(self.model)
            self._convbn_fused = True
            self._ostate = self._step_program = None
        self.model.train()
        state = self.state
        stop = False
        while not stop:
            state["epoch_finished"] = False
            self.dataset.shuffle()
            batches = iter(self.dataset.data(train=True))
            ahead: list = []            # taken from the epoch, not yet run
            exhausted = had_data = False
            t0, records = time.perf_counter(), 0
            while True:
                # evaluated at loop top with the 1-based neval, so
                # max_iteration(n) runs exactly n iterations
                if self.end_when(state):
                    stop = True
                    break
                want = min(self.fuse_steps, self._fusible_steps(state))
                while len(ahead) < want and not exhausted:
                    try:
                        ahead.append(next(batches))
                    except StopIteration:
                        exhausted = True
                if not ahead:
                    break
                # a full window runs fused; the epoch's partial trailing
                # one step by step
                n = want if len(ahead) >= want else 1
                window, ahead = ahead[:n], ahead[n:]
                had_data = True
                first = state["neval"]
                losses = self._run_window(window, device)
                for i, (b, loss) in enumerate(zip(window, losses)):
                    records += b.valid
                    logger.info("Epoch %d iter %d: loss %.6f, %.1f "
                                "records/s", state["epoch"], first + i, loss,
                                records / (time.perf_counter() - t0))
                self._fire_validation(boundary=False)
            if stop:
                break
            if not had_data:
                raise RuntimeError("dataset yielded no batches")
            state["epoch"] += 1
            state["epoch_finished"] = True
            self._fire_validation(boundary=True)
            if self.end_when(state):
                break
        return self.model


def _in_scope(trigger: Trigger, boundary: bool) -> bool:
    """Whether ``trigger`` is evaluated inside the batch loop
    (``boundary=False``) or at epoch boundaries: its ``scope``."""
    scope = getattr(trigger, "scope", "any")
    return scope == "any" or (scope == "epoch") == boundary


class LocalOptimizer(Optimizer):
    """Single-device trainer (the only one ported so far)."""
