"""DistriOptimizer: synchronous data-parallel training over the mesh.

Counterpart of ``bigdl_tpu/optim/distri_optimizer.py``. JAX compiles one
SPMD program over the Engine mesh and GSPMD inserts the collectives; the
port runs one process per rank (``utils/engine.py``), each running the
trainer's step on its block of every global batch, with the collectives
issued explicitly (``parallel/collectives.py``) in one order on every
rank, always from the loop thread (the feed's producer, the checkpoint
writer and the evaluator issue none).

The three sync modes of JAX (``:42-150``):

- ``allreduce``: parameters replicated; the gradients summed over the
  ``data`` slice in one bucket a dtype (JAX's combiner buckets the
  per-leaf reductions the same way) and divided by its size for an
  averaging criterion. ``ParallelOptimizer`` is the same program, as in
  JAX;
- ``zero1``: each trainable leaf whose dim 0 is divisible by the data
  size (``zero1_state_sharding``'s rule) has its slots on this rank's
  block of rows only; its gradient is reduce-scattered, the update runs
  on the block (a view of the parameter), and the parameter is
  all-gathered after it; other leaves are all-reduced and updated whole;
- ``fsdp``: the same ownership, the all-gather moved to the start of the
  next step (and to every point that reads the weights: the end of
  ``optimize``, a checkpoint, validation). The working parameters stay
  full size, so per-rank memory drops for the slots only.

The results are JAX's global-batch results: the trainer takes rank
``i``'s contiguous block of each global batch (JAX's error when the batch
does not divide), runs the forward under ``collectives.data_parallel``
(batch norm's moments, MoE's routing, the criteria's data-dependent
counts reduced over the slice), averages the loss and, for the global
norm clip, adds the partial sums of squares over the ranks that hold
parts of the gradients. The numerics flag is reduced before any rank
acts on it; the end trigger and epoch boundaries agree because every rank
draws the same epoch order from the same seed. Rank 0 writes summaries
and checkpoints (``set_checkpoint``'s pickle, with ZeRO's slot blocks
gathered to full leaves: the layout ``LocalOptimizer`` and JAX read, so a
resume at another world size works; the elastic backend is refused).
Every rank starts from rank 0's parameters and buffers (broadcast at the
first step). Validation runs the whole validation set on every rank
(JAX's numbers, no batch is split).

The step stays the trainer's captured program (``utils/programs.py``)
when every group is NCCL: its collectives are captured in the CUDA graph.
A gloo group cannot be captured, so there the step runs eagerly, by that
rule (``step_mode`` says which) and never by catching a failed capture.
Dropout draws from each rank's own generator, seeded from the seed and
the rank (``Engine`` seeds; the masks never matched JAX's bits).

JAX's refusals: ``fsdp`` with tensor parallelism; the flat update only
under ``allreduce`` without TP (logged and ignored otherwise); the sparse
embedding step only under ``allreduce`` without TP (its rows' ids
gathered over the data slice, so every rank steps the batch's rows).
Under ``zero1``/``fsdp`` the update runs on row blocks, so a method whose
update is not elementwise (LARS, L-BFGS) raises. Tensor parallelism
(``set_tensor_parallel``) swaps the matched layers for explicit parallel
forms (``parallel/tensor_parallel.py``); a root ``GPipe`` on a mesh with a
``pipe`` axis trains through its own schedule
(``GPipe.pipeline_train_step``). Checkpoints of a tensor-parallel or
pipelined model are not ported.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.optim.optimizer import Optimizer, _map
from bigdl_tpu_torch.parallel import collectives as C
from bigdl_tpu_torch.parallel.sharding import shard_leading_axis
from bigdl_tpu_torch.utils.engine import Engine

logger = logging.getLogger(__name__)


def _tree_pairs(a, b):
    """(leaf of a, leaf of b) over two trees of one structure."""
    if isinstance(a, dict):
        for k in a:
            yield from _tree_pairs(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            yield from _tree_pairs(x, y)
    else:
        yield a, b


def _buckets(tensors: list) -> dict:
    """Indices of ``tensors`` grouped by dtype, in order."""
    out: dict = {}
    for i, t in enumerate(tensors):
        out.setdefault(t.dtype, []).append(i)
    return out


def _broadcast_tensors(tensors: list, src: int, group) -> None:
    """``tensors`` from global rank ``src`` over ``group``, in place: one
    broadcast a dtype."""
    with torch.no_grad():
        for idx in _buckets(tensors).values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            C.broadcast_(flat, src, group)
            off = 0
            for i in idx:
                k = tensors[i].numel()
                tensors[i].copy_(flat[off:off + k].view_as(tensors[i]))
                off += k


class DistriOptimizer(Optimizer):
    _SYNC_MODES = ("allreduce", "zero1", "fsdp")

    def __init__(self, model, dataset, criterion,
                 parameter_sync: str = "allreduce", device=None):
        if parameter_sync not in self._SYNC_MODES:
            raise ValueError(
                f"parameter_sync must be one of {self._SYNC_MODES}")
        super().__init__(model, dataset, criterion, device)
        self.parameter_sync = parameter_sync
        self.tp_rules = None
        self._mesh = None
        self._tp_split: dict = {}       # param path -> (dim, axis)
        self._shards: dict = {}         # param path -> this rank's rows
        self._synced = False            # rank 0's weights broadcast
        self._slices: dict = {}         # id(batch) -> (batch, rank block)
        self._stale = False             # fsdp: full weights not gathered
        self.step_mode: Optional[str] = None

    # ------------------------------------------------------------ config
    def set_parameter_sync(self, mode: str) -> "DistriOptimizer":
        if mode not in self._SYNC_MODES:
            raise ValueError(
                f"parameter_sync must be one of {self._SYNC_MODES}")
        self.parameter_sync = mode
        self._ostate = None
        self._sparse_memo = None
        return self

    def set_tensor_parallel(self, rules) -> "DistriOptimizer":
        """Tensor parallelism: ``rules`` (``parallel.TPRules``) split
        parameters over the mesh's ``model`` axis; the matched layers are
        swapped for their parallel forms at the first step."""
        self.tp_rules = rules
        self._ostate = None
        self._sparse_memo = None
        return self

    def _flat_update_ok(self) -> bool:
        if self.parameter_sync != "allreduce" or self.tp_rules is not None:
            if self.flat_update:
                logger.warning(
                    "BIGDL_FLAT_UPDATE ignored: flat-param updates need "
                    "replicated optimizer slots (parameter_sync='allreduce' "
                    "without tensor parallelism); got sync=%r tp=%s",
                    self.parameter_sync, self.tp_rules is not None)
            return False
        return True

    def _sparse_plan(self, scales=None):
        if self.parameter_sync != "allreduce" or self.tp_rules is not None:
            return None
        return super()._sparse_plan(scales)

    # ------------------------------------------------------------ mesh
    def _group(self, axis: str):
        return self._mesh.group(axis)

    @property
    def _dsize(self) -> int:
        return self._mesh.axis_size(Engine.DATA_AXIS)

    def _averages(self) -> bool:
        return bool(getattr(self.criterion, "size_average", True))

    def _setup(self) -> None:
        mesh = Engine.mesh()
        if Engine.DATA_AXIS not in mesh.axis_names:
            raise ValueError(f"Engine mesh {tuple(mesh.axis_names)} has no "
                             f"'{Engine.DATA_AXIS}' axis")
        if self.parameter_sync == "fsdp" and self.tp_rules is not None:
            raise ValueError(
                "parameter_sync='fsdp' cannot combine with tensor "
                "parallelism yet — pick one sharding of the weights")
        if self._mesh is not mesh:
            self._mesh = mesh
            self._synced = False
            self._ostate = None
        if self.tp_rules is not None and not self._tp_split:
            from bigdl_tpu_torch.parallel.tensor_parallel import (
                apply_tensor_parallel,
            )
            self._tp_split = apply_tensor_parallel(self.model, self.tp_rules,
                                                   mesh)
            self._ostate = None
        gloo = [a for a in mesh.axis_names
                if not C.capturable(mesh.group(a))]
        self.step_mode = ("eager (gloo groups cannot be captured)" if gloo
                          else "captured")
        if not self._synced:
            self._broadcast_weights()
            self._seed_dropout()
            self._synced = True

    def _seed_dropout(self) -> None:
        """Each rank draws its dropout masks from its own stream, seeded
        from the seed and the rank."""
        seed = Engine.config().seed * 1_000_003 + self._mesh.rank
        gens = {id(m.generator): m.generator for m in self.model.modules()
                if getattr(m, "draws_random", False)
                and getattr(m, "generator", None) is not None}
        for g in gens.values():
            g.manual_seed(seed)
        dev = torch.device(self.device)
        if dev.type == "cuda":
            torch.cuda.default_generators[dev.index or 0].manual_seed(seed)
        else:
            torch.default_generator.manual_seed(seed)

    def _broadcast_weights(self) -> None:
        """Every rank starts from rank 0's parameters and buffers: each
        leaf from the first rank of each axis slice, a split leaf within
        its data slice only."""
        mesh = self._mesh
        tensors = [(n, p.data) for n, p in self.model.named_parameters()] \
            + [(n, b) for n, b in self.model.named_buffers()]
        for axis in mesh.axis_names:
            ranks = mesh.group_ranks(axis)
            if len(ranks) > 1:
                _broadcast_tensors(
                    [t for n, t in tensors
                     if self._tp_split.get(n, (0, None))[1] != axis],
                    ranks[0], mesh.group(axis))

    # ------------------------------------------------------------ slots
    def _shard_views(self, named: dict) -> dict:
        """This rank's row block of every leaf ZeRO splits (the others
        whole): views of the parameters."""
        return {n: (p.chunk(self._dsize, 0)[self._mesh.index(
            Engine.DATA_AXIS)] if n in self._shards else p)
            for n, p in named.items()}

    def _init_slots(self, method, named: dict, mask) -> dict:
        self._shards = {}
        if self.parameter_sync in ("zero1", "fsdp"):
            trainable = (list(named) if mask is None else
                         [n for n, t in zip(named, mask) if t])
            for n in trainable:
                if n in self._tp_split:
                    continue
                sh = shard_leading_axis(self._mesh, tuple(named[n].shape),
                                        Engine.DATA_AXIS)
                if tuple(sh.spec) == (Engine.DATA_AXIS,):
                    self._shards[n] = True
            if self._shards and not getattr(method, "elementwise_update",
                                            False):
                raise ValueError(
                    f"parameter_sync={self.parameter_sync!r} updates row "
                    f"blocks of the parameters; {method!r} is not "
                    f"elementwise (use allreduce)")
        return method.init_state_trimmed(self._shard_views(named), mask)

    def _ostate_for_io(self) -> dict:
        if not self._shards:
            return self._ostate
        named, _, mask = self._prepare_step()
        full = self._method.init_state_trimmed(named, mask)
        group = self._group(Engine.DATA_AXIS)
        for part, whole in _tree_pairs(self._ostate, full):
            if isinstance(part, torch.Tensor) and part.shape != whole.shape:
                C.all_gather_into(whole.view(-1), part.contiguous(), group)
            elif isinstance(part, torch.Tensor):
                whole.copy_(part)
        # host numbers (SGD's clr) live in the dicts: take them over
        self._copy_numbers(self._ostate, full)
        return full

    @staticmethod
    def _copy_numbers(src, dst) -> None:
        if isinstance(src, dict):
            for k, v in src.items():
                if isinstance(v, (dict, list)):
                    DistriOptimizer._copy_numbers(v, dst[k])
                elif not isinstance(v, torch.Tensor):
                    dst[k] = v
        elif isinstance(src, list):
            for a, b in zip(src, dst):
                if isinstance(a, (dict, list)):
                    DistriOptimizer._copy_numbers(a, b)

    def _load_ostate(self, tree: dict, mask) -> None:
        if not self._shards:
            return super()._load_ostate(tree, mask)
        from bigdl_tpu_torch import convert
        named = dict(self.model.named_parameters())
        full = self._method.init_state_trimmed(named, mask)
        convert.load_jax_ostate(self._method, full, self.model, tree, mask)
        i = self._mesh.index(Engine.DATA_AXIS)
        with torch.no_grad():
            for part, whole in _tree_pairs(self._ostate, full):
                if isinstance(part, torch.Tensor):
                    part.copy_(whole.chunk(self._dsize, 0)[i]
                               if part.shape != whole.shape else whole)
        self._copy_numbers(full, self._ostate)

    # ------------------------------------------------------------ the step
    def _pipe_model(self):
        from bigdl_tpu_torch.parallel.pipeline import GPipe
        m = self.model
        return m if isinstance(m, GPipe) and m.pipe_mesh() is not None \
            else None

    def _grad_scales(self) -> dict:
        scales = super()._grad_scales()
        pipe = self._pipe_model()
        if pipe is None:
            return scales
        own = set(pipe.stage_params())
        return {n: (s if n in own else 0.0) for n, s in scales.items()}

    def _pipeline(self):
        pipe = self._pipe_model()
        if pipe is None:
            return None
        if self.grad_accum != 1:
            raise ValueError(
                "a pipelined model already microbatches inside the "
                "pipeline; combine via n_microbatches, not "
                "set_gradient_accumulation")
        if self.remat != "none":
            raise ValueError("set_remat does not apply to a pipelined "
                             "model; use GPipe(remat=True)")
        return lambda inp, target: pipe.pipeline_train_step(
            inp, target, self.criterion)

    def _step_context(self):
        stack = contextlib.ExitStack()
        stack.enter_context(C.data_parallel(self._group(Engine.DATA_AXIS),
                                            self._averages()))
        if self.parameter_sync == "fsdp":
            self._gather_shards()
        return stack

    def _sync_grads(self, names: list, grads: list) -> list:
        group = self._group(Engine.DATA_AXIS)
        scale = 1.0 / self._dsize if self._averages() else 1.0
        out = list(grads)
        full = [i for i, n in enumerate(names) if n not in self._shards]
        part = [i for i, n in enumerate(names) if n in self._shards]
        with torch.no_grad():
            for idx in _buckets([grads[i] for i in full]).values():
                idx = [full[j] for j in idx]
                flat = torch.cat([grads[i].reshape(-1) for i in idx])
                C.all_reduce_(flat, group)
                off = 0
                for i in idx:
                    k = grads[i].numel()
                    out[i] = flat[off:off + k].view_as(grads[i]) * scale
                    off += k
            d = self._dsize
            for idx in _buckets([grads[i] for i in part]).values():
                idx = [part[j] for j in idx]
                rows = torch.cat([grads[i].reshape(d, -1) for i in idx], 1)
                mine = rows.new_empty(rows.shape[1])
                C.reduce_scatter_into(mine, rows, group)
                off = 0
                for i in idx:
                    k = grads[i].numel() // d
                    shape = (grads[i].shape[0] // d,) + \
                        tuple(grads[i].shape[1:])
                    out[i] = mine[off:off + k].view(shape) * scale
                    off += k
        return out

    def _sync_loss(self, loss: torch.Tensor) -> torch.Tensor:
        total = C.all_reduce_(loss.detach().clone(),
                              self._group(Engine.DATA_AXIS))
        return total / self._dsize if self._averages() else total

    def _norm_sq(self, names: list, grads: list) -> torch.Tensor:
        """The global norm's square: the data-split blocks summed over the
        data slice, the model-split leaves over the model slice, a
        pipeline's stages over the pipe slice."""
        kinds: dict = {}
        pipe = self._pipe_model()
        for n, g in zip(names or [], grads):
            if n in self._shards:
                kind = Engine.DATA_AXIS
            elif n in self._tp_split:
                kind = self._tp_split[n][1]
            elif pipe is not None:
                kind = pipe.axis_name
            else:
                kind = None
            sq = g.square().sum()
            kinds[kind] = sq if kind not in kinds else kinds[kind] + sq
        total = kinds.pop(None, None)
        for axis, sq in kinds.items():
            sq = C.all_reduce_(sq, self._group(axis))
            total = sq if total is None else total + sq
        return total

    def _apply_update(self, method, named, grads, ostate, h, mask) -> None:
        if not self._shards:
            return super()._apply_update(method, named, grads, ostate, h,
                                         mask)
        method.update_with_trimmed(self._shard_views(named), grads, ostate,
                                   h, mask)
        if self.parameter_sync == "zero1":
            self._gather_shards()
        else:
            self._stale = True

    def _gather_shards(self) -> None:
        """Every ZeRO-split parameter whole again, from the ranks' blocks
        (one all-gather a dtype)."""
        if not self._shards:
            return
        named = dict(self.model.named_parameters())
        params = [named[n] for n in self._shards]
        d, i = self._dsize, self._mesh.index(Engine.DATA_AXIS)
        group = self._group(Engine.DATA_AXIS)
        with torch.no_grad():
            for idx in _buckets(params).values():
                mine = torch.cat([params[j].chunk(d, 0)[i].reshape(-1)
                                  for j in idx])
                rows = mine.new_empty((d, mine.numel()))
                C.all_gather_into(rows.view(-1), mine, group)
                off = 0
                for j in idx:
                    k = params[j].numel() // d
                    params[j].view(d, -1).copy_(rows[:, off:off + k])
                    off += k
        self._stale = False

    def _materialize(self) -> None:
        """FSDP: gather the full weights before anything reads them."""
        if self.parameter_sync == "fsdp" and self._stale:
            self._gather_shards()

    def _agree(self, flag: torch.Tensor) -> torch.Tensor:
        return C.all_reduce_(flag.clone(), None, op=C.MAX)

    def _program_for(self, inp, target):
        prog = super()._program_for(inp, target)
        prog.eager = not self.step_mode.startswith("captured")
        return prog

    # ------------------------------------------------------------ the feed
    def _rank_block(self, batch: MiniBatch) -> MiniBatch:
        hit = self._slices.get(id(batch))
        if hit is not None and hit[0] is batch:
            return hit[1]
        d, i = self._dsize, self._mesh.index(Engine.DATA_AXIS)
        n = batch.size()
        if n % d != 0:
            raise ValueError(
                f"batch size {n} not divisible by data-parallel size {d}")
        k = n // d
        block = MiniBatch(_map(lambda a: a[i * k:(i + 1) * k], batch.input),
                          None if batch.target is None else
                          _map(lambda a: a[i * k:(i + 1) * k], batch.target),
                          valid=int(np.clip(batch.valid - i * k, 0, k)))
        # the ring slot (pinned buffers) now belongs to the block's views
        block._ring_slot, batch._ring_slot = batch._ring_slot, None
        if self._device_batch_cache is not None:
            self._slices[id(batch)] = (batch, block)
        return block

    def _place(self, item):
        if isinstance(item, list):
            item = [self._rank_block(b) for b in item]
        else:
            item = self._rank_block(item)
        return super()._place(item)

    # ------------------------------------------------------------ the loop
    def optimize(self, resume: Optional[str] = None) -> torch.nn.Module:
        if self.device is None:
            self.device = Engine.device()
        self._setup()
        logger.info("DistriOptimizer: mesh=%s sync=%s step=%s",
                    self._mesh.shape, self.parameter_sync, self.step_mode)
        try:
            return super().optimize(resume)
        finally:
            self._materialize()
            self._pipe_gather()

    def _optimize_impl(self, device):
        keep = (self.train_summary, self.val_summary)
        if self._mesh.rank != 0:        # rank 0 writes the summaries
            self.train_summary = self.val_summary = None
        try:
            return super()._optimize_impl(device)
        finally:
            self.train_summary, self.val_summary = keep

    def _run_validation(self) -> None:
        self._materialize()
        super()._run_validation()

    def _preempt_requested(self) -> bool:
        flag = torch.tensor(float(super()._preempt_requested()),
                            device=self.device)
        return bool(C.all_reduce_(flag, None, op=C.MAX) > 0)

    def _pipe_gather(self) -> None:
        """Every rank of a pipe slice holds every stage's trained weights:
        each stage's from the rank that ran it."""
        pipe = self._pipe_model()
        if pipe is None:
            return
        group = self._group(pipe.axis_name)
        ranks = self._mesh.group_ranks(pipe.axis_name)
        for s in range(pipe.n_stages):
            _broadcast_tensors([p.data for p in pipe[s].parameters()],
                               ranks[s], group)

    # ------------------------------------------------------- checkpoints
    def _check_checkpointable(self) -> None:
        if self._tp_split or self._pipe_model() is not None:
            raise NotImplementedError(
                "checkpoints of a tensor-parallel or pipelined model are not "
                "ported; checkpoint an allreduce, zero1 or fsdp run")

    def _snapshot(self) -> dict:
        self._check_checkpointable()
        self._materialize()
        return super()._snapshot()

    def _save_checkpoint(self, neval_next=None) -> None:
        if self._mesh.rank == 0:
            return super()._save_checkpoint(neval_next)
        self._snapshot()            # the gathers every rank takes part in

    def _has_checkpoint(self) -> bool:
        if self.checkpoint_path is None:
            return False            # no collective: a failed rank raises
        if self._mesh.rank == 0:
            self._join_checkpoint_writer(raise_error=False)
        C.barrier()
        return super()._has_checkpoint()

    def _load_latest_checkpoint(self) -> None:
        self._check_checkpointable()
        if self._mesh is None:
            self._setup()
        if self._mesh.rank == 0:
            self._join_checkpoint_writer()
        C.barrier()
        super()._load_latest_checkpoint()
        self._synced = True


class ParallelOptimizer(DistriOptimizer):
    """Layer-wise parameter sync, the reference's ``ParallelOptimizer``:
    JAX compiles it to the same program as ``DistriOptimizer`` (per-leaf
    reductions the combiner buckets), and so does the port."""
