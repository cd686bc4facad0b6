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

**Checkpoints** (``set_checkpoint(path, trigger)``, the pickle backend of
``bigdl_tpu/optim/optimizer.py:2185-2603``): when the trigger fires, the
loop thread copies the master parameters, batch norm's running statistics
and the optimizer slots to pinned host buffers once the window's last
replay is done, and a ``bigdl-ckpt-writer`` thread pickles them with the
trainer state, the resume record and the stateful schedule's state through
``utils/file.py`` (CRC32 footer, fsync, atomic rename) as
``checkpoint.<neval>.pkl``; at most one write is in flight, a failed write
raises at the next join, ``BIGDL_CKPT_ASYNC=0`` makes the write
synchronous, ``BIGDL_CKPT_KEEP=N`` keeps the newest N versions. The payload
is JAX's: ``params``, ``mstate`` and ``ostate`` nested as the JAX package
nests them (``convert.py``), fp32 numpy arrays, so either package resumes
the other's files. ``optimize(resume="auto")`` restores the newest loadable
file (a corrupt one is renamed ``*.corrupt`` and the one before it used) by
copying into the live parameters, buffers and slots, never rebinding them,
so a captured step program stays valid; the run then continues mid-epoch
under the saved epoch order and RNG state, skipping the batches already
run, bitwise as if never stopped.

**Recovery** (``optimize``): SIGTERM or SIGINT (handlers on the main thread
only) stops the run at the next window boundary, writes and joins an
emergency checkpoint and raises :class:`TrainingPreempted`; a
:class:`NonFiniteLossError` rolls back to the last good checkpoint at most
``BIGDL_MAX_NAN_ROLLBACKS`` times (default 2), other failures at most
``Engine.config().failure_retry_times`` times, ``failure_retry_interval``
seconds apart. Losses are fetched and checked before every checkpoint
write, so a poisoned state is never saved. ``set_check_numerics`` makes the
step program also record, in a device flag fetched with the window's
losses, whether the loss, a gradient or an updated parameter is not
finite; a failure then re-runs the failing step eagerly from its
pre-window state under a dispatch mode that names the first op that made a
NaN or inf from finite inputs. ``set_profile`` traces iterations
``[start, start + n)`` with ``torch.profiler`` (step by step) into a
Chrome trace. ``set_train_summary``
/ ``set_val_summary`` write Loss, LearningRate and Throughput at each
iteration's own step, the opt-in ``Parameters`` histograms, and the
validation scores with ``ValFetchBytes`` and ``ValWaitMs``; a ``Plateau``
schedule is fed after validation (monitor ``"score"`` or a method's name)
or at an epoch's end (``"loss"``), and SGD reads its rate from the host
(``OptimMethod.hyper``), so a lower rate takes effect at the next replay.

**The feed** (``set_prefetch(depth)`` / ``BIGDL_PREFETCH``, default 2, as
JAX's ``bigdl_tpu/optim/optimizer.py:216``, ``:1048-1100``): each epoch's
batches come through ``dataset/prefetch.PrefetchingFeed``, whose producer
thread assembles them (``SampleToMiniBatch``'s ring, pinned on a CUDA
device) and places them on the device (``_place``, through
``HostToDevice.place``: with ``set_fuse_steps(K)`` a full window of K
batches stacked on the host and copied once) while the card runs the steps
before them:
on the card from pinned memory on a copy stream of the producer's own,
recycling a ring slot only once its copy has completed
(``dataset/h2d.py``); ``depth=0`` places each batch synchronously on the
loop thread by the same path. The loop takes the placed steps it needs for
its trigger-aware window (``_fusible_steps``) and keeps the rest for the
next window; ``_epoch_batches`` counts the batches run, not those
prefetched. In-memory datasets of ``MiniBatch``es are copied to the device
once (the device batch cache, up to ``BIGDL_DEVICE_CACHE_MB``, default
2048; ``BIGDL_DEVICE_CACHE=0`` turns it off). The loop's wait for the feed
is the ``feed`` phase (``train/feed_wait`` span); the stages' mean ms
(stack, h2d, ...) go to ``feed_stage_ms`` (JAX's
``state["feed_stage_ms"]``) and the ``FeedStage/<stage>_ms`` train
summaries.

Not ported yet (ROADMAP Queue A): sparse embeddings, the auxiliary loss,
the model registry and the orbax and elastic checkpoint backends.
"""

from __future__ import annotations

import functools
import itertools
import logging
import math
import os
import re
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch.func import functional_call
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from bigdl_tpu_torch import convert
from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet, LocalDataSet, TransformedDataSet,
)
from bigdl_tpu_torch.dataset.h2d import HostToDevice, Placed, ready_groups
from bigdl_tpu_torch.dataset.prefetch import PrefetchingFeed
from bigdl_tpu_torch.dataset.profiling import (
    STAGE_AUGMENT, STAGE_CACHE, STAGE_DECODE, STAGE_STACK,
)
from bigdl_tpu_torch.dataset.sample import SampleToMiniBatch
from bigdl_tpu_torch.nn.criterion import AbstractCriterion
from bigdl_tpu_torch.nn.normalization import (
    checkpoint_contexts, dropout_generators,
)
from bigdl_tpu_torch.nn.precision import cast_floating
from bigdl_tpu_torch.obs import trace
from bigdl_tpu_torch.obs.registry import registry as obs_registry
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import (
    SGD, CompositeOptimMethod, OptimMethod,
)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils import file as ckpt_file
from bigdl_tpu_torch.utils.device import require_on, wait_for_stream
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.file import CheckpointCorruptError
from bigdl_tpu_torch.utils.programs import Program
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from bigdl_tpu_torch.utils.robustness import events

logger = logging.getLogger(__name__)

#: pickle checkpoint file names: ``checkpoint.<neval>.pkl`` (versioned) or
#: ``checkpoint.pkl`` (``over_write_checkpoint``'s rolling file), as JAX's
_CKPT_RE = re.compile(r"^checkpoint(?:\.(\d+))?\.pkl$")


def _ckpt_version(name: str) -> Optional[int]:
    """Numeric version of a checkpoint file name; the rolling file sorts
    below every versioned one; other names (``*.corrupt``, ``*.tmp``) give
    None."""
    m = _CKPT_RE.match(name)
    if m is None:
        return None
    return int(m.group(1)) if m.group(1) is not None else -1


class TrainingPreempted(RuntimeError):
    """Raised by ``optimize()`` after a SIGTERM/SIGINT stop at a window
    boundary, once the emergency checkpoint (when a checkpoint path is set)
    is on disk; ``optimize(resume="auto")`` continues the run bitwise.
    ``iteration`` is the first iteration not run; ``checkpoint_path`` is
    None without a checkpoint path."""

    def __init__(self, message: str, checkpoint_path: Optional[str] = None,
                 iteration: int = 0):
        super().__init__(message)
        self.checkpoint_path = checkpoint_path
        self.iteration = iteration


class NonFiniteLossError(RuntimeError):
    """A step produced a NaN or infinite loss (or, under
    ``set_check_numerics``, a non-finite gradient or parameter).
    ``optimize()`` rolls back to the last good checkpoint at most
    ``BIGDL_MAX_NAN_ROLLBACKS`` times (default 2), then raises it."""

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


class _FirstNonFinite(TorchDispatchMode):
    """Records the first op whose floating outputs hold a NaN or inf while
    its floating inputs (read before it runs) are all finite. Ops that
    only allocate are skipped: their outputs are not yet written."""

    _ALLOCATING = frozenset({"empty", "empty_like", "empty_strided",
                             "new_empty", "new_empty_strided"})

    def __init__(self):
        super().__init__()
        self.op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.op is not None \
                or func.overloadpacket.__name__ in self._ALLOCATING:
            return func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor) and t.is_floating_point()]
        finite_in = all(bool(t.isfinite().all()) for t in ins)
        out = func(*args, **kwargs)
        if finite_in and ins:
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor) and t.is_floating_point()]
            if not all(bool(t.isfinite().all()) for t in outs):
                self.op = str(func)
        return out


def _tensors_of(tree) -> list:
    """The tensors of nested dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors_of(v)]
    return []


#: the feed's stages in the obs registry, by the name of their
#: ``FeedStage/<stage>_ms`` curve (h2d is the trainer's ``put_batch`` phase)
_FEED_STAGES = {**{"feed/" + s: s for s in (
    STAGE_DECODE, STAGE_AUGMENT, STAGE_STACK, STAGE_CACHE)},
    "phase/put_batch": "h2d"}


def _feed_stage_totals() -> dict:
    """``{stage: (count, total seconds)}`` of the feed's stages so far."""
    return {stage: (h.count, h.total) for name, stage in _FEED_STAGES.items()
            for h in (obs_registry.histogram(name),)}


def pin_feed(dataset) -> None:
    """Page-locked ring slots for every ``SampleToMiniBatch`` of
    ``dataset``'s transformer chain (the feed of a CUDA device)."""
    while isinstance(dataset, TransformedDataSet):
        stages = [dataset.transformer]
        while stages:
            t = stages.pop()
            if isinstance(t, SampleToMiniBatch):
                t.pin()
            stages.extend(getattr(t, a) for a in ("first", "second")
                          if hasattr(t, a))
        dataset = dataset.base


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
        # feed pipeline depth (placed batches in flight); 0 = synchronous
        self.prefetch_depth: int = int(os.environ.get("BIGDL_PREFETCH", "2"))
        # the device batch cache of in-memory datasets (BIGDL_DEVICE_CACHE,
        # BIGDL_DEVICE_CACHE_MB), keyed by batch identity
        self.device_cache_mb: float = float(
            os.environ.get("BIGDL_DEVICE_CACHE_MB", "2048"))
        self._device_batch_cache: Optional[dict] = None
        self._device_cache_key = None
        self._window_cache_bytes = 0.0
        self._h2d: Optional[HostToDevice] = None
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
        # checkpoints (set_checkpoint / over_write_checkpoint)
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.overwrite_checkpoint = False
        self.checkpoint_backend = "pickle"
        # keep-last-N retention of versioned checkpoints (0 keeps all)
        self.ckpt_keep: int = int(os.environ.get("BIGDL_CKPT_KEEP", "0"))
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_error: Optional[BaseException] = None
        # summaries (set_train_summary / set_val_summary)
        self.train_summary = None
        self.val_summary = None
        self.metrics = Metrics()
        # records/s of the last window (not of the first, which holds the
        # warm-up and the capture); a wall-clock number, kept out of state
        self.throughput: Optional[float] = None
        # the feed's stage means of the run (ms an occurrence: stack a
        # batch, h2d a placement, ...); wall-clock numbers, out of state
        self.feed_stage_ms: dict = {}
        # the numerics check (set_check_numerics / BIGDL_CHECK_NUMERICS)
        self.check_numerics: bool = os.environ.get(
            "BIGDL_CHECK_NUMERICS", "0") == "1"
        # the torch.profiler window (set_profile / BIGDL_PROFILE_DIR)
        self.profile_dir: Optional[str] = os.environ.get("BIGDL_PROFILE_DIR")
        self.profile_start_iter = int(os.environ.get("BIGDL_PROFILE_START",
                                                     "10"))
        self.profile_n_iters = int(os.environ.get("BIGDL_PROFILE_ITERS", "10"))
        self._profiler = None
        self._profile_first = self._profile_stop_at = 0
        self.profile_trace: Optional[str] = None    # the last trace written
        # preemption: set by the signal handler, read at window boundaries
        self._preempt: Optional[threading.Event] = None
        self._prev_handlers: dict = {}
        # mid-epoch resume: the feed position and the epoch's RNG state and
        # order, carried in checkpoints
        self._epoch_batches = 0
        self._epoch_rng: Optional[dict] = None
        self._epoch_order = None
        self._resume_feed: Optional[dict] = None
        self._rob_snap0: dict = {}      # robustness events at optimize()

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

    def set_prefetch(self, depth: int) -> "Optimizer":
        """Feed-pipeline depth: placed batches kept in flight by the
        background producer (``dataset/prefetch.py``). 0 = synchronous
        feeding."""
        if depth < 0:
            raise ValueError("prefetch depth must be >= 0")
        self.prefetch_depth = depth
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_checkpoint(self, path: str, trigger: Trigger,
                       backend: Optional[str] = None) -> "Optimizer":
        """Write a checkpoint under ``path`` whenever ``trigger`` fires.
        ``backend``: "pickle" (one file, written on a background thread;
        None resolves to it). JAX's "orbax" and "elastic" backends are not
        ported (``BIGDL_CKPT_SHARDED=1`` asks for "elastic")."""
        if backend is None:
            backend = ("elastic"
                       if os.environ.get("BIGDL_CKPT_SHARDED", "0") == "1"
                       else "pickle")
        if backend == "orbax":
            raise NotImplementedError(
                "checkpoint backend 'orbax' writes through JAX's "
                "orbax-checkpoint library and is not ported; use 'pickle'")
        if backend == "elastic":
            raise NotImplementedError(
                "checkpoint backend 'elastic' (or BIGDL_CKPT_SHARDED=1) "
                "shards a mesh's state and waits for ROADMAP Queue A.6; "
                "use 'pickle'")
        if backend != "pickle":
            raise ValueError("checkpoint backend must be 'pickle', 'orbax' "
                             "or 'elastic'")
        self.checkpoint_path, self.checkpoint_trigger = path, trigger
        self.checkpoint_backend = backend
        return self

    def over_write_checkpoint(self, overwrite: bool = True) -> "Optimizer":
        """One rolling ``checkpoint.pkl`` instead of a file a version."""
        self.overwrite_checkpoint = overwrite
        return self

    def set_train_summary(self, summary) -> "Optimizer":
        self.train_summary = summary
        return self

    def set_val_summary(self, summary) -> "Optimizer":
        self.val_summary = summary
        return self

    def set_check_numerics(self, enabled: bool = True) -> "Optimizer":
        """Check every step for a NaN or inf in the loss, the gradients and
        the updated parameters, in a device flag fetched with the window's
        losses; a failure raises :class:`NonFiniteLossError` naming the op
        that produced it. The losses and parameters are those of the
        unchecked step, bit for bit."""
        self.check_numerics = bool(enabled)
        return self

    def set_profile(self, trace_dir: str, start_iter: int = 10,
                    n_iters: int = 10) -> "Optimizer":
        """Trace iterations ``[start_iter, start_iter + n_iters)`` with
        ``torch.profiler`` (run step by step) and write the Chrome trace
        under ``trace_dir``; one window per ``optimize()``."""
        self.profile_dir = trace_dir
        self.profile_start_iter = start_iter
        self.profile_n_iters = n_iters
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
        check = self.check_numerics

        def step(inp, target, h):
            loss, grads = self._loss_and_grads([named[n] for n in train],
                                               inp, target, frozen)
            grads = [g if scales[n] == 1.0 else g * scales[n]
                     for n, g in zip(train, grads)]
            grads = dict(zip(train, self._clip_grads(grads)))
            method.update_with_trimmed(
                named, {n: grads.get(n) for n in named}, ostate, h, mask)
            if not check:
                return loss
            # the numerics flag: 1 when the loss, a gradient or an updated
            # parameter holds a NaN or inf (read on the device, no host sync)
            with torch.no_grad():
                ok = torch.stack([t.isfinite().all() for t in
                                  [loss, *grads.values(),
                                   *(named[n] for n in train)]]).all()
            return torch.stack([loss, (~ok).to(loss.dtype)])

        return step

    def _program_for(self, inp, target) -> Program:
        """The step program for a batch like ``(inp, target)``, captured
        anew when its key changes (the previous graph is dropped first)."""
        named, scales, mask = self._prepare_step()
        key = ("train_step", Engine.compute_dtype(),
               tuple(scales.values()), self._method, self._ostate_version,
               self.check_numerics,
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
        ``state["neval"]``: the step program once a step, the losses (and
        numerics flags) fetched once at the end and checked there. Advances
        ``neval``, sets ``state["loss"]`` and returns the losses."""
        prog = self._program_for(*batches[0])
        start, n = self.state["neval"], len(batches)
        s_inp, s_target, s_h = prog.inputs
        h = torch.tensor([self._method.hyper(start - 1 + k, self._ostate)
                          for k in range(n)], dtype=torch.float32)
        h = h.to(s_h.device, non_blocking=True)
        check = self.check_numerics
        # the numerics check re-runs a failing step from the window's
        # starting state: kept on the device
        before = ([t.detach().clone() for t in self._live_tensors()]
                  if check else None)
        out = torch.empty((n, 2) if check else n, dtype=torch.float32,
                          device=s_h.device)
        for k, (inp, target) in enumerate(batches):
            _copy_into(s_inp, inp)
            _copy_into(s_target, target)
            s_h.copy_(h[k])
            out[k].copy_(prog())
        with self.metrics.timer("loss_fetch"):
            wait_for_stream(out)
            vals = out.tolist()
        self.state["neval"] = start + n
        if check:
            flags = [v[1] for v in vals]
            vals = [v[0] for v in vals]
            if any(flags):
                k = flags.index(1.0)
                self._diagnose_numerics(prog, batches, h, before, start, k)
        for k, val in enumerate(vals):
            vals[k] = self._guard_loss(start + k, val)
        self.state["loss"] = vals[-1]
        return vals

    def _guard_loss(self, it: int, val: float) -> float:
        """The finite-loss check of every fetched loss: NaN or inf raises
        :class:`NonFiniteLossError`. The ``nonfinite_loss`` fault site
        poisons the fetched value here, as in JAX."""
        if faults.check_fault(faults.SITE_NONFINITE_LOSS,
                              index=it) is not None:
            val = float("nan")
        if not math.isfinite(val):
            raise NonFiniteLossError(
                f"non-finite loss at iteration {it}: {val}", iteration=it)
        return val

    def _live_tensors(self) -> list:
        """Every tensor a step writes: the parameters, the module's buffers
        and the optimizer's slots."""
        return ([p for p in self.model.parameters()]
                + [b for b in self.model.buffers()]
                + _tensors_of(self._ostate))

    def _diagnose_numerics(self, prog, batches, h, before, start, k) -> None:
        """The numerics flag of step ``k`` of the window is set: put the
        window's starting state back, replay the steps before ``k``, and
        run step ``k`` eagerly under :class:`_FirstNonFinite`, which names
        the first op that made a NaN or inf from finite inputs (JAX's
        checkify names the primitive). Raises."""
        live = self._live_tensors()
        with torch.no_grad():
            for t, b in zip(live, before):
                t.copy_(b)
        s_inp, s_target, s_h = prog.inputs
        for j in range(k + 1):
            _copy_into(s_inp, batches[j][0])
            _copy_into(s_target, batches[j][1])
            s_h.copy_(h[j])
            if j < k:
                prog()
        finder = _FirstNonFinite()
        with finder:
            prog._fn(*prog.inputs)
        cause = (f"nan/inf generated by {finder.op}" if finder.op else
                 "no op of the eager re-run generated a nan or inf (one of "
                 "the port's CUDA kernels, whose launches are not ops)")
        raise NonFiniteLossError(
            f"non-finite values (nan/inf) in the step at iteration "
            f"{start + k} (set_check_numerics): {cause}",
            iteration=start + k)

    def train_step(self, inp, target) -> float:
        """One optimizer step on a batch already on the model's device, at
        iteration ``state["neval"]``: forward, backward, scale, clip,
        update. Sets ``state["loss"]`` (the loss before the update),
        advances ``neval`` and returns the loss."""
        return self._run_steps([(inp, target)])[0]

    def _fusible_steps(self, state: dict) -> int:
        """Iterations that may run from ``state["neval"]`` in one window
        before ``end_when``, validation, checkpoint or the ``Parameters``
        summary could fire, as JAX's ``_fusible_steps``; 1 while profiling,
        so the trace holds single steps."""
        if self.profile_dir is not None or self._profiler is not None:
            return 1
        bound = self.end_when.next_fire_in(state)
        for trig in (self.val_trigger, self.checkpoint_trigger):
            if trig is not None and _in_scope(trig, boundary=False):
                bound = min(bound, trig.next_fire_in(state))
        ptrig = self._summary_trigger("Parameters")
        if ptrig is not None:
            bound = min(bound, ptrig.next_fire_in(state))
        return bound

    def _summary_trigger(self, name: str):
        get = getattr(self.train_summary, "get_summary_trigger", None)
        return get(name) if get is not None else None

    def _fire_triggers(self, boundary: bool) -> None:
        """Validation (and Plateau after it), Plateau on the loss at an
        epoch's end, the checkpoint and the ``Parameters`` histograms, when
        their triggers fire here: inside the loop, with ``neval`` read as
        the iteration just run (JAX's convention), or at an epoch's end."""
        state = self.state
        if not boundary:
            state["neval"] -= 1
        try:
            monitor = getattr(self._schedule(), "monitor", None)
            trig = self.val_trigger
            if trig is not None and _in_scope(trig, boundary) \
                    and trig(state):
                self._run_validation()
                if monitor is not None and monitor not in ("loss", "Loss"):
                    self._update_stateful_schedule()
            if boundary and monitor in ("loss", "Loss"):
                self._update_stateful_schedule()
            trig = self.checkpoint_trigger
            if trig is not None and self.checkpoint_path is not None \
                    and _in_scope(trig, boundary) and trig(state):
                # the window's losses were fetched and checked: a poisoned
                # state never reaches a checkpoint
                self._save_checkpoint()
            ptrig = self._summary_trigger("Parameters")
            if not boundary and ptrig is not None and ptrig(state):
                for name, p in self.model.named_parameters():
                    self.train_summary.add_histogram(
                        name.replace(".", "/"), p.detach().float().cpu()
                        .numpy(), state["neval"])
        finally:
            if not boundary:
                state["neval"] += 1

    def _schedule(self):
        """The stateful learning-rate schedule the trainer feeds: the
        method's (a composite's default method's), as JAX observes it."""
        method = self.optim_method
        if isinstance(method, CompositeOptimMethod):
            method = method.default
        return getattr(method, "learningrate_schedule", None)

    def _update_stateful_schedule(self) -> None:
        """Feed the monitored metric to a stateful schedule (Plateau) and
        write its rate into the slots' ``clr``, which the next step's
        ``hyper`` reads on the host: no recapture (JAX's
        ``_update_stateful_schedule``)."""
        sched = self._schedule()
        owner = (None if self._ostate is None
                 else convert.slots_owner(self._method, self._ostate))
        if not getattr(sched, "stateful", False) or owner is None \
                or "clr" not in owner:
            return
        state = self.state
        monitor = getattr(sched, "monitor", "score")
        if monitor in ("loss", "Loss"):
            value = state.get("loss")
        elif monitor == "score":
            value = state.get("score")
        else:
            value = state.get("scores", {}).get(monitor)
            if value is None and "scores" in state:
                raise ValueError(
                    f"Plateau monitor {monitor!r} matches no validation "
                    f"method; available: {sorted(state['scores'])}")
        if value is None:
            return
        owner["clr"] = float(sched.on_metric(float(value)))

    def _run_validation(self) -> None:
        from bigdl_tpu_torch.optim.evaluator import run_device_eval
        if self.val_dataset is None or not self.val_methods:
            return
        state = self.state
        with self.metrics.timer("validation"), trace.span("train/validation"):
            results, stats = run_device_eval(self.model, self.val_dataset,
                                             self.val_methods, self.device,
                                             allow_empty=True)
        logger.info("Validation pass: %d batches, val_fetch_bytes=%d, "
                    "val_wait_ms=%.1f", stats["batches"],
                    stats["fetch_bytes"], stats["wait_ms"])
        state["val_fetch_bytes"] = stats["fetch_bytes"]
        state["val_wait_ms"] = stats["wait_ms"]
        if self.val_summary is not None:
            self.val_summary.add_scalar("ValFetchBytes",
                                        float(stats["fetch_bytes"]),
                                        state["neval"])
            self.val_summary.add_scalar("ValWaitMs", float(stats["wait_ms"]),
                                        state["neval"])
        scores = state.setdefault("scores", {})
        for m, r in zip(self.val_methods, results):
            if r is not None:
                v, c = r.result()
                logger.info("Validation %s: %.4f (%d samples)", m.name, v, c)
                scores[m.name] = v
                if self.val_summary is not None:
                    self.val_summary.add_scalar(m.name, v, state["neval"])
        if results and results[0] is not None:
            state["score"] = results[0].result()[0]

    def _write_iter_summary(self, it: int, loss: float) -> None:
        """Loss, LearningRate and Throughput of iteration ``it``, at its
        own step, from the window's fetched losses; a tag with a summary
        trigger is written where the trigger fires for ``it``."""
        summary = self.train_summary
        if summary is None:
            return
        tag_state = {"neval": it, "epoch": self.state.get("epoch", 1),
                     "epoch_finished": False}

        def fires(name: str) -> bool:
            trig = self._summary_trigger(name)
            return trig is None or trig(tag_state)

        if fires("Loss"):
            summary.add_scalar("Loss", loss, it)
        if fires("LearningRate"):
            summary.add_scalar(
                "LearningRate", self.optim_method.get_learning_rate(it - 1),
                it)
        if self.throughput is not None and fires("Throughput"):
            summary.add_scalar("Throughput", self.throughput, it)

    # ------------------------------------------------------------- feed
    def _setup_feed(self, device) -> None:
        """The feed's placement for ``device``, the ring pinned on a card,
        and the device batch cache (JAX's ``_setup_device_cache``): on when
        the dataset is a plain ``LocalDataSet`` (which re-yields the same
        ``MiniBatch`` objects every epoch; a transformed pipeline builds
        fresh ones) that fits ``device_cache_mb``; kept while the dataset
        and the device stay the same."""
        if self._h2d is None or self._h2d.device != torch.device(device):
            self._h2d = HostToDevice(device)
        if self._h2d.on_card:
            pin_feed(self.dataset)
            if self.val_dataset is not None:
                pin_feed(self.val_dataset)
        key = (id(self.dataset), str(device))
        if self._device_cache_key == key:
            return
        self._device_batch_cache = None
        self._window_cache_bytes = 0.0
        self._device_cache_key = key
        ds = self.dataset
        if os.environ.get("BIGDL_DEVICE_CACHE", "1") == "0" \
                or not isinstance(ds, LocalDataSet):
            return
        total = sum(getattr(b.input, "nbytes", 0)
                    + getattr(b.target, "nbytes", 0) for b in ds._data)
        if total <= self.device_cache_mb * 1e6:
            logger.info("device batch cache enabled (%.0f MB in-memory "
                        "dataset)", total / 1e6)
            self._device_batch_cache = {}

    def _put_batch(self, batch) -> Placed:
        """The producer's placement of one batch (once per distinct batch
        when the device cache is on)."""
        faults.fault_point(faults.SITE_H2D)  # scripted transfer failure
        cache = self._device_batch_cache
        if cache is not None:
            hit = cache.get(id(batch))
            if hit is not None and hit[0] is batch:
                return hit[1]
        with self.metrics.timer("put_batch"), trace.span("feed/h2d"):
            placed = self._h2d.put(batch)
        if cache is not None:
            cache[id(batch)] = (batch, placed)
        return placed

    def _put_stacked(self, batches: list) -> Placed:
        """The producer's placement of a full fused window, stacked on the
        host and copied once (``HostToDevice.place`` places a partial
        trailing window batch by batch, which the loop runs step by step).
        Stacked windows ride the device cache too, keyed by batch-identity
        tuples and bounded by ``device_cache_mb``."""
        faults.fault_point(faults.SITE_H2D)  # scripted transfer failure
        cache = self._device_batch_cache
        key = tuple(id(b) for b in batches)
        if cache is not None:
            hit = cache.get(key)
            if hit is not None and all(a is b for a, b in zip(hit[0],
                                                                batches)):
                return hit[1]
        with self.metrics.timer("put_batch"), trace.span("feed/h2d"):
            placed = self._h2d.put_stacked(batches)
        if cache is not None:
            nbytes = sum(t.numel() * t.element_size()
                         for t in placed.tensors())
            if self._window_cache_bytes + nbytes <= \
                    self.device_cache_mb * 1e6:
                cache[key] = (list(batches), placed)
                self._window_cache_bytes += nbytes
        return placed

    def _place(self, item):
        """The feed's placement of one item (a batch or a window)."""
        return self._h2d.place(item, self.fuse_steps, self._put_batch,
                               self._put_stacked)

    @staticmethod
    def _placed_steps(item, placed) -> list:
        """``(batch, (inp, target))`` for each step of a feed item, ready
        on the current stream: a stacked window's steps read its slices."""
        return [(b, (inp, target)) if len(group) == 1 else
                (b, (_map(lambda a: a[k], inp), _map(lambda a: a[k], target)))
                for group, (inp, target) in ready_groups(item, placed)
                for k, b in enumerate(group)]

    def _write_feed_stages(self, base: dict, it: int) -> None:
        """The feed's stage means since ``base`` into ``feed_stage_ms``
        (wall-clock numbers, kept out of ``state`` as ``throughput`` is)
        and, with a train summary, its ``FeedStage/<stage>_ms`` curves at
        iteration ``it``."""
        stages = self._feed_stage_report(base)
        if not stages:
            return
        self.feed_stage_ms = stages
        if self.train_summary is not None:
            for stage, ms in stages.items():
                self.train_summary.add_scalar(f"FeedStage/{stage}_ms", ms, it)

    @staticmethod
    def _feed_stage_report(base: dict) -> dict:
        """Mean ms per stage occurrence since ``base``
        (``_feed_stage_totals()``), JAX's ``_feed_stage_report``."""
        out = {}
        for stage, (count, total) in _feed_stage_totals().items():
            c0, t0 = base.get(stage, (0, 0.0))
            if count > c0:
                out[stage] = round(1e3 * (total - t0) / (count - c0), 3)
        return out

    # ------------------------------------------------------------- loop
    def optimize(self, resume: Optional[str] = None) -> torch.nn.Module:
        """Run the training loop until ``end_when`` fires; returns the
        model, trained in place. ``resume="auto"`` first restores the
        newest loadable checkpoint under ``set_checkpoint``'s path and
        continues that run (from scratch when there is none)."""
        if resume not in (None, "auto"):
            raise ValueError(f"resume must be None or 'auto', got {resume!r}")
        device = require_on(self.model, self.device)
        if os.environ.get("BIGDL_CONVBN_FUSE", "0") == "1" \
                and not self._convbn_fused:
            from bigdl_tpu_torch.nn.graph import fuse_conv_bn
            self.model = fuse_conv_bn(self.model)
            self._convbn_fused = True
            self._ostate = self._step_program = None
        # the robustness report covers the whole call: the resume, and the
        # rollbacks and retries between attempts
        self._rob_snap0 = events.snapshot()
        if resume == "auto" and self.checkpoint_path is not None \
                and self._has_checkpoint():
            self._load_latest_checkpoint()
            events.record("resume", path=self.checkpoint_path,
                          neval=self.state.get("neval", 0))
        retry_budget = Engine.config().failure_retry_times
        max_nan = int(os.environ.get("BIGDL_MAX_NAN_ROLLBACKS", "2"))
        self._install_signal_handlers()
        try:
            return self._optimize_with_retry(device, retry_budget, max_nan)
        finally:
            self._restore_signal_handlers()

    def _optimize_with_retry(self, device, retry_budget: int,
                             max_nan: int) -> torch.nn.Module:
        nan_rollbacks = 0
        while True:
            try:
                return self._optimize_impl(device)
            except (KeyboardInterrupt, TrainingPreempted):
                self._stop_profiler()
                raise
            except Exception as e:
                self._stop_profiler()
                if isinstance(e, NonFiniteLossError):
                    # a divergence has its own budget: the last good
                    # checkpoint comes back, and a NaN that keeps coming
                    # back raises
                    nan_rollbacks += 1
                    self.state["nan_rollbacks"] = nan_rollbacks
                    if nan_rollbacks > max_nan or not self._has_checkpoint():
                        raise
                    events.record("nan_rollback", rollbacks=nan_rollbacks)
                    logger.exception(
                        "non-finite loss; rolling back to the last good "
                        "checkpoint (%d/%d rollbacks, "
                        "BIGDL_MAX_NAN_ROLLBACKS)", nan_rollbacks, max_nan)
                    self._load_latest_checkpoint()
                    self.state["nan_rollbacks"] = nan_rollbacks
                    continue
                retry_budget -= 1
                if retry_budget < 0 or not self._has_checkpoint():
                    raise
                events.record("retry_rollback", retries_left=retry_budget)
                logger.exception("training failed; retrying from the last "
                                 "checkpoint (%d retries left)", retry_budget)
                time.sleep(Engine.config().failure_retry_interval)
                self._load_latest_checkpoint()

    def _optimize_impl(self, device) -> torch.nn.Module:
        sched = self._schedule()
        monitor = getattr(sched, "monitor", "score")
        if getattr(sched, "stateful", False) \
                and monitor not in ("loss", "Loss") \
                and self.val_trigger is None:
            logger.warning(
                "Plateau monitoring a validation metric without "
                "set_validation never sees a value: the rate stays at its "
                "base value; configure validation or use monitor='loss'")
        self.model.train()
        state = self.state
        stop = False
        resume_feed, self._resume_feed = self._resume_feed, None
        windows_run, records, window_t0 = 0, 0, time.perf_counter()
        self._setup_feed(device)
        stages0 = _feed_stage_totals()
        fuse = self.fuse_steps
        while not stop:
            state["epoch_finished"] = False
            skip = 0
            if resume_feed is not None and resume_feed.get("mid_epoch"):
                # re-enter the interrupted epoch: its RNG state and shuffled
                # order back, the batches already run skipped
                if resume_feed.get("epoch_rng") is not None:
                    RandomGenerator.load_state_dict(resume_feed["epoch_rng"])
                order = resume_feed.get("epoch_order")
                base = self._feed_base()
                if order is not None and hasattr(base, "_order"):
                    base._order = np.array(order, copy=True)
                skip = int(resume_feed.get("feed_pos", 0))
                self._epoch_rng = resume_feed.get("epoch_rng")
            else:
                if resume_feed is not None \
                        and resume_feed.get("epoch_rng") is not None:
                    # an epoch-boundary checkpoint: the next shuffle is the
                    # first draw after it
                    RandomGenerator.load_state_dict(resume_feed["epoch_rng"])
                self.dataset.shuffle()
                self._epoch_rng = RandomGenerator.state_dict()
            resume_feed = None
            self._epoch_order = self._base_order_copy()
            self._epoch_batches = skip
            make_iter = ((lambda s=skip: itertools.islice(
                self.dataset.data(train=True), s, None)) if skip
                else (lambda: self.dataset.data(train=True)))
            feed = PrefetchingFeed(
                make_iter, self._place, self.prefetch_depth, window=fuse)
            ahead: list = []     # placed steps taken from the feed, not run
            exhausted = False
            had_data = skip > 0         # a resumed epoch may have no more
            with feed, trace.span("train/epoch", {"epoch": state["epoch"]}):
                feed_it = iter(feed)
                while True:
                    # evaluated at loop top with the 1-based neval, so
                    # max_iteration(n) runs exactly n iterations
                    if self.end_when(state):
                        stop = True
                        break
                    self._maybe_start_profiler()
                    want = min(fuse, self._fusible_steps(state))
                    while len(ahead) < want and not exhausted:
                        # "feed" = the time the loop waits on data; in
                        # steady state the producer hides assembly and copy
                        with self.metrics.timer("feed"), \
                                trace.span("train/feed_wait"):
                            item = next(feed_it, None)
                        if item is None:
                            exhausted = True
                        else:
                            ahead.extend(self._placed_steps(*item))
                    if not ahead:
                        break
                    # a full window runs fused; the epoch's partial trailing
                    # one step by step
                    n = want if len(ahead) >= want else 1
                    window, ahead = ahead[:n], ahead[n:]
                    had_data = True
                    first = state["neval"]
                    with trace.span("train/window", {"k": n}):
                        losses = self._run_steps([p for _, p in window])
                    self._epoch_batches += n
                    for i, loss in enumerate(losses):
                        self._write_iter_summary(first + i, loss)
                    self._write_feed_stages(stages0, first + n - 1)
                    now = time.perf_counter()
                    records += sum(b.valid for b, _ in window)
                    if windows_run:
                        self.throughput = records / (now - window_t0)
                    for i, loss in enumerate(losses):
                        logger.info("Epoch %d iter %d: loss %.6f, %.1f "
                                    "records/s", state["epoch"], first + i,
                                    loss, self.throughput or 0.0)
                    # the first window holds the warm-up and the capture:
                    # the throughput counts from its end
                    windows_run += 1
                    records, window_t0 = 0, now
                    self._maybe_stop_profiler()
                    self._fire_triggers(boundary=False)
                    fired = [faults.fault_point(faults.SITE_SIGTERM, index=it)
                             for it in range(first, first + n)]
                    if any(a is not None for a in fired) \
                            and self._preempt is not None:
                        self._preempt.wait(1.0)
                    if self._preempt_requested():
                        self._do_preempt()
            if stop:
                break
            if not had_data:
                raise RuntimeError("dataset yielded no batches")
            state["epoch"] += 1
            state["epoch_finished"] = True
            self._epoch_batches = 0
            self._fire_triggers(boundary=True)
            if self._preempt_requested():
                self._do_preempt()
            if self.end_when(state):
                break
        self._stop_profiler()
        self._join_checkpoint_writer()  # optimize() returning: ckpt on disk
        rob = events.deltas(self._rob_snap0)
        if rob:
            state["robustness"] = rob
            logger.info("robustness report: %s", events.format_report(rob))
        return self.model

    # ---------------------------------------------------------- profiling
    def _maybe_start_profiler(self) -> None:
        if self.profile_dir is None or self._profiler is not None \
                or self.state["neval"] < self.profile_start_iter:
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and any(
                p.is_cuda for p in self.model.parameters()):
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()
        self._profile_first = self.state["neval"]
        self._profile_stop_at = self.state["neval"] + self.profile_n_iters

    def _maybe_stop_profiler(self) -> None:
        if self._profiler is not None \
                and self.state["neval"] >= self._profile_stop_at:
            self._stop_profiler(export=True)

    def _stop_profiler(self, export: bool = False) -> None:
        """Close a live trace (error paths too, so a retry does not meet an
        active profiler); ``export`` writes its Chrome trace."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        if export and self.profile_dir is not None:
            os.makedirs(self.profile_dir, exist_ok=True)
            path = os.path.join(
                self.profile_dir, f"trace.iter{self._profile_first}-"
                f"{self._profile_stop_at - 1}.json")
            prof.export_chrome_trace(path)
            self.profile_trace = path
            logger.info("profiler trace written: %s", path)
            self.profile_dir = None     # one window per optimize()

    # ---------------------------------------------------------- preemption
    def _install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT ask for a stop at the next window boundary, with
        an emergency checkpoint; a second SIGINT raises KeyboardInterrupt.
        Handlers install on the main thread only; elsewhere preemption is
        off, as in JAX."""
        import signal

        evt = threading.Event()

        def handler(signum, frame):
            if evt.is_set() and signum == signal.SIGINT:
                raise KeyboardInterrupt
            evt.set()
            logger.warning(
                "received %s: stopping at the next step boundary "
                "(emergency checkpoint%s)", signal.Signals(signum).name,
                "" if self.checkpoint_path else
                " skipped: no checkpoint path configured")

        try:
            self._prev_handlers = {
                sig: signal.signal(sig, handler)
                for sig in (signal.SIGTERM, signal.SIGINT)}
            self._preempt = evt
        except ValueError:  # not the main thread
            self._preempt = None
            self._prev_handlers = {}

    def _restore_signal_handlers(self) -> None:
        import signal

        for sig, h in self._prev_handlers.items():
            try:
                signal.signal(sig, h)
            except (ValueError, TypeError):
                pass
        self._prev_handlers = {}
        self._preempt = None

    def _preempt_requested(self) -> bool:
        return self._preempt is not None and self._preempt.is_set()

    def _do_preempt(self) -> None:
        """The stop at a window boundary: the emergency checkpoint written
        and joined (the window's losses were already fetched and checked),
        then :class:`TrainingPreempted`."""
        state = self.state
        path = None
        if self.checkpoint_path is not None:
            # state["neval"] is already the next iteration at a boundary
            self._save_checkpoint(neval_next=state["neval"])
            self._join_checkpoint_writer()
            path = self.checkpoint_path
        events.record("preemption", iteration=state["neval"],
                      checkpoint=path)
        logger.warning("training preempted before iteration %d%s",
                       state["neval"],
                       f"; emergency checkpoint in {path}" if path
                       else " (no checkpoint configured)")
        raise TrainingPreempted(
            f"training preempted before iteration {state['neval']}",
            checkpoint_path=path, iteration=state["neval"])

    # ------------------------------------------------- resume bookkeeping
    def _feed_base(self):
        """The innermost dataset, owner of the epoch's order."""
        ds = self.dataset
        while isinstance(ds, TransformedDataSet):
            ds = ds.base
        return ds

    def _base_order_copy(self):
        order = getattr(self._feed_base(), "_order", None)
        return None if order is None else np.array(order, copy=True)

    def _resume_info(self, neval_next: int) -> dict:
        """What a bitwise mid-epoch resume needs beyond the tensors, keyed
        as JAX's: the feed position in the epoch, the RNG state as of the
        epoch's shuffle (mid-epoch) or now (at a boundary), the epoch's
        order, and ``base_rng``: the states of the model's dropout
        generators (``dropout_generators``), None without any. JAX's
        ``base_rng`` is a PRNG key with no torch counterpart, so it is not
        carried between the packages."""
        state = self.state
        mid_epoch = not bool(state.get("epoch_finished", False))
        gens = dropout_generators(self.model)
        return {
            "neval_next": int(neval_next),
            "epoch": int(state.get("epoch", 1)),
            "mid_epoch": mid_epoch,
            "feed_pos": int(self._epoch_batches),
            "epoch_rng": (self._epoch_rng if mid_epoch
                          else RandomGenerator.state_dict()),
            "epoch_order": self._epoch_order,
            "stream": None,
            "base_rng": ([g.get_state().numpy() for g in gens]
                         if gens else None),
        }

    def _apply_resume_info(self, resume: dict) -> None:
        self.state["neval"] = int(resume["neval_next"])
        self._resume_feed = resume
        rng = resume.get("base_rng")
        gens = dropout_generators(self.model)
        if isinstance(rng, list) and len(rng) == len(gens):
            for g, st in zip(gens, rng):
                g.set_state(torch.from_numpy(np.asarray(st, np.uint8)))
        elif rng is not None:
            logger.warning("the checkpoint's base_rng (%s) is not this "
                           "model's dropout generators' state; dropout "
                           "masks after the resume differ from the "
                           "interrupted run's", type(rng).__name__)

    # ---------------------------------------------------------- checkpoint
    def _has_checkpoint(self) -> bool:
        # an in-flight write lands first; a failed one logs (older files may
        # still be a recovery point)
        self._join_checkpoint_writer(raise_error=False)
        if self.checkpoint_path is None \
                or not os.path.isdir(self.checkpoint_path):
            return False
        return any(_ckpt_version(p) is not None
                   for p in os.listdir(self.checkpoint_path))

    def _ckpt_file(self, state: dict) -> str:
        tag = "" if self.overwrite_checkpoint else f".{state['neval']}"
        return os.path.join(self.checkpoint_path, f"checkpoint{tag}.pkl")

    def _snapshot(self) -> dict:
        """``params``, ``mstate`` and ``ostate`` as host numpy arrays in
        JAX's layout. Device tensors are copied into pinned buffers after
        the work already queued (the window's last replay) and the stream
        is synchronised once; CPU tensors are cloned."""
        named, _, mask = self._prepare_step()
        model = self.model
        trees = {
            "params": convert.nest(model, named),
            "mstate": convert.nest(model, convert.module_state(model),
                                   "state"),
            "ostate": convert.ostate_tree(self._method, self._ostate, model,
                                          mask),
        }
        on_card = []

        def host(t):
            if not isinstance(t, torch.Tensor):
                return np.asarray(t, np.float32)
            t = t.detach()
            if t.is_cuda:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                on_card.append(buf)
                return buf
            return t.clone()

        trees = convert.map_tree(host, trees)
        if on_card:
            torch.cuda.current_stream().synchronize()
        trees = convert.map_tree(
            lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, trees)
        trees["ostate"] = convert.ostate_host_layout(self._method,
                                                     trees["ostate"])
        return trees

    def _save_checkpoint(self, neval_next: Optional[int] = None) -> None:
        """Snapshot on the loop thread, write on a ``bigdl-ckpt-writer``
        thread (JAX's ``_save_checkpoint_pickle``). ``neval_next`` is the
        first iteration a resume runs; in-loop triggers fire with
        ``neval`` the iteration just run, epoch boundaries and preemption
        with the next. ``ckpt/stall_ms`` records how long the loop thread
        was held: the snapshot (and the previous write, if still running)
        when async, everything when ``BIGDL_CKPT_ASYNC=0``."""
        os.makedirs(self.checkpoint_path, exist_ok=True)
        t0 = time.perf_counter()
        try:
            state = self.state
            if neval_next is None:
                neval_next = state["neval"] + \
                    (0 if state.get("epoch_finished") else 1)
            with trace.span("ckpt/snapshot"):
                payload = self._snapshot()
            payload["state"] = dict(state)
            payload["resume"] = self._resume_info(neval_next)
            sched = self._schedule()
            if getattr(sched, "stateful", False):
                payload["sched_state"] = sched.state_dict()
            path = self._ckpt_file(state)
            self._join_checkpoint_writer()
            self._ckpt_thread = threading.Thread(
                target=self._write_checkpoint, args=(payload, path),
                name="bigdl-ckpt-writer", daemon=False)
            self._ckpt_thread.start()
            if os.environ.get("BIGDL_CKPT_ASYNC", "1") == "0":
                self._join_checkpoint_writer()
        finally:
            obs_registry.histogram("ckpt/stall_ms").observe(
                (time.perf_counter() - t0) * 1e3)

    def _write_checkpoint(self, payload: dict, path: str) -> None:
        """The writer thread's body; a failure waits for the next join."""
        try:
            t0 = time.perf_counter()
            # scripted failures: "torn" leaves a truncated file at the final
            # path, "error" fails the write, "kill" SIGKILLs the process
            # with only the tmp file written
            action = faults.check_fault(faults.SITE_CKPT_WRITE)
            data = ckpt_file.dumps(payload)
            if action == "torn":
                with open(path, "wb") as f:
                    f.write(data[:max(len(ckpt_file.MAGIC) + 1,
                                      len(data) // 2)])
                logger.warning("fault plan: torn checkpoint at %s", path)
                return
            if action == "error":
                raise faults.FaultError("injected checkpoint write failure")
            if action == "kill":
                import signal
                with open(path + ".tmp", "wb") as f:
                    f.write(data[:len(data) // 2])
                    f.flush()
                    os.fsync(f.fileno())
                    os.kill(os.getpid(), signal.SIGKILL)
            with trace.span("ckpt/write", {"path": path}):
                ckpt_file.save_bytes(data, path)
            obs_registry.counter("ckpt/bytes").inc(len(data))
            self._prune_old_checkpoints()
            obs_registry.histogram("ckpt/async_write_ms").observe(
                (time.perf_counter() - t0) * 1e3)
            logger.info("checkpoint written: %s", path)
        except BaseException as e:  # noqa: BLE001 — raised at the next join
            self._ckpt_error = e

    def _prune_old_checkpoints(self) -> None:
        """Keep the newest ``BIGDL_CKPT_KEEP`` versions (0 keeps all), with
        their quarantined ``*.corrupt`` files; on the writer thread, after
        the new version is on disk."""
        keep = self.ckpt_keep
        if keep <= 0 or self.overwrite_checkpoint:
            return
        versioned = sorted(
            (p for p in os.listdir(self.checkpoint_path)
             if _CKPT_RE.match(p) and _ckpt_version(p) >= 0),
            key=_ckpt_version)
        for name in versioned[:-keep]:
            full = os.path.join(self.checkpoint_path, name)
            for victim in (full, full + ".corrupt"):
                try:
                    os.remove(victim)
                except OSError:
                    pass

    def _join_checkpoint_writer(self, raise_error: bool = True) -> None:
        """Wait for the write in flight; a failed write raises here (logs
        with ``raise_error=False``), so it never reads as durable."""
        t = self._ckpt_thread
        if t is not None:
            t.join()
            self._ckpt_thread = None
        err, self._ckpt_error = self._ckpt_error, None
        if err is not None:
            if raise_error:
                raise RuntimeError(
                    "background checkpoint write failed") from err
            logger.error("background checkpoint write failed: %r", err)

    def _load_latest_checkpoint(self) -> None:
        """Restore the newest loadable checkpoint: versions in numeric
        order, a candidate that fails its integrity check renamed
        ``<name>.corrupt`` and the one before it tried. The tensors are
        copied into the live parameters, buffers and slots."""
        self._join_checkpoint_writer()
        cand = sorted((p for p in os.listdir(self.checkpoint_path)
                       if _ckpt_version(p) is not None), key=_ckpt_version)
        if not cand:
            raise RuntimeError(
                f"no checkpoint found under {self.checkpoint_path}")
        payload = name = None
        while cand:
            name = cand.pop()
            full = os.path.join(self.checkpoint_path, name)
            try:
                payload = ckpt_file.load(full)
                break
            except CheckpointCorruptError as e:
                quarantined = full + ".corrupt"
                try:
                    os.replace(full, quarantined)
                except OSError:
                    quarantined = "<unremovable>"
                events.record("ckpt_quarantined", path=full, error=str(e))
                logger.error("corrupt checkpoint %s quarantined as %s (%s); "
                             "falling back to the previous version", full,
                             quarantined, e)
        if payload is None:
            raise RuntimeError(
                f"no loadable checkpoint under {self.checkpoint_path} (every "
                f"candidate failed its integrity check and was quarantined)")
        self._restore(payload)
        logger.info("resumed from checkpoint %s at iter %d", name,
                    self.state.get("neval", 0))

    def _restore(self, payload: dict) -> None:
        """Copy a payload (this package's or JAX's) into the live tensors:
        parameters, batch norm's statistics, then the slots, created first
        when this trainer has none yet."""
        model = self.model
        require_on(model, self.device)
        _, _, mask = self._prepare_step()
        convert.load_jax_params(model, payload["params"])
        convert.load_jax_state(model, payload["mstate"])
        convert.load_jax_ostate(self._method, self._ostate, model,
                                payload["ostate"], mask)
        self.state = dict(payload["state"])
        sched = self._schedule()
        if getattr(sched, "stateful", False) and "sched_state" in payload:
            sched.load_state_dict(payload["sched_state"])
        if payload.get("resume") is not None:
            self._apply_resume_info(payload["resume"])


def _in_scope(trigger: Trigger, boundary: bool) -> bool:
    """Whether ``trigger`` is evaluated inside the batch loop
    (``boundary=False``) or at epoch boundaries: its ``scope``."""
    scope = getattr(trigger, "scope", "any")
    return scope == "any" or (scope == "epoch") == boundary


class LocalOptimizer(Optimizer):
    """Single-device trainer (the only one ported so far)."""
