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
- ``fsdp``: the same ownership, and the parameters too are held as row
  blocks between steps (``_FSDP``): a layer's weights are all-gathered
  just before it runs and dropped after its forward (its ``run`` is
  wrapped; the backward gathers them again through saved-tensor hooks),
  each gradient is reduce-scattered to its block by the gather's own
  backward as soon as it is ready, and the update runs on the blocks.
  Per-rank parameter and slot memory is the unsplit leaves plus 1/N of
  the rest (``fsdp_bytes``). ``optimize`` returns the weights whole.

The results are JAX's global-batch results: the trainer takes rank
``i``'s contiguous block of each global batch (JAX's error when the batch
does not divide), runs the forward under ``collectives.data_parallel``
(batch norm's moments, MoE's routing, the criteria's data-dependent
counts reduced over the slice), averages the loss and, for the global
norm clip, adds the partial sums of squares over the ranks that hold
parts of the gradients. The numerics flag is reduced before any rank
acts on it; the end trigger and epoch boundaries agree because every rank
draws the same epoch order from the same seed. Rank 0 writes summaries.
Checkpoints: ``set_checkpoint``'s pickle is written by rank 0 with every
split leaf gathered whole (ZeRO's slot blocks, tensor-parallel leaves,
each pipeline stage's leaves from the rank that runs it): the layout
``LocalOptimizer`` and JAX read. The elastic backend
(``utils/elastic_ckpt.py``) has every rank write the blocks it owns, with
JAX's spec of each leaf; a resume on another mesh copies each whole leaf
into this trainer's layout of it (axes the new mesh lacks replicate).
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
Under ``zero1``/``fsdp`` the update runs on row blocks; a method whose
update is not elementwise (LarsSGD's per-leaf norms, LBFGS's dot
products) completes its sums over the data slice
(``optim_method.block_reductions``), and LBFGS's history holds this
rank's blocks. Tensor parallelism (``set_tensor_parallel``) swaps the
matched layers for explicit parallel forms
(``parallel/tensor_parallel.py``); a root ``GPipe`` on a mesh with a
``pipe`` axis trains through its own schedule
(``GPipe.pipeline_train_step``).
"""

from __future__ import annotations

import contextlib
import logging
import weakref
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch import convert
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.optim.optim_method import (
    BlockReductions, block_reductions,
)
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


def _gather_rows(block: torch.Tensor, group, d: int) -> torch.Tensor:
    """The ranks' row blocks of a leaf, whole (no gradient)."""
    out = block.new_empty((d * block.shape[0],) + tuple(block.shape[1:]))
    C.all_gather_into(out, block.contiguous(), group)
    return out


class _GatherRows(torch.autograd.Function):
    """A row block all-gathered whole over the data slice; the backward
    reduce-scatters the whole gradient to the block (summed over the
    slice)."""

    @staticmethod
    def forward(ctx, block, group, d):
        ctx.group, ctx.d = group, d
        return _gather_rows(block, group, d)

    @staticmethod
    def backward(ctx, g):
        d = ctx.d
        mine = g.new_empty((g.shape[0] // d,) + tuple(g.shape[1:]))
        C.reduce_scatter_into(mine, g.contiguous(), ctx.group)
        return mine, None, None


class _Regather:
    """What a saved-tensor hook keeps of a gathered weight: its block and
    the view the backward reads, gathered again at unpack."""

    __slots__ = ("block", "size", "stride", "offset")

    def __init__(self, block, t):
        self.block = block
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


class _FSDP:
    """``fsdp``'s sharded parameters: each split leaf (``names``) lives as
    its row block, a module's blocks are gathered around its ``run``, and
    the backward's saved weights are gathered again at use. ``live`` and
    ``peak`` count the bytes of gathered weights alive (the most at once
    since ``reset_peak``)."""

    def __init__(self, model, names, group, d: int, i: int):
        self.model, self.group, self.d, self.i = model, group, d, i
        self.names = list(names)
        self.full_shapes: dict = {}
        self.wrapped: list = []
        self.gathered: dict = {}      # id(whole) -> (weakref, block)
        self.live = self.peak = 0

    def _owners(self) -> dict:
        mods = dict(self.model.named_modules())
        out: dict = {}
        for n in self.names:
            owner, _, leaf = n.rpartition(".")
            out.setdefault(owner, []).append(leaf)
        return {mods[o]: leaves for o, leaves in out.items()}

    def shard(self) -> None:
        """Every split leaf to its row block; the owners' ``run`` wrapped."""
        named = dict(self.model.named_parameters())
        with torch.no_grad():
            for n in self.names:
                p = named[n]
                self.full_shapes.setdefault(n, tuple(p.shape))
                p.data = p.data.chunk(self.d, 0)[self.i].clone()
        for mod, leaves in self._owners().items():
            own = "run" in mod.__dict__
            orig = mod.run
            mod.run = self._wrap(mod, leaves, orig)
            self.wrapped.append((mod, own, orig))

    def unshard(self) -> None:
        """Every split leaf whole again (one all-gather each), the
        wrappers removed."""
        for mod, own, orig in self.wrapped:
            if own:
                mod.run = orig
            else:
                del mod.run
        self.wrapped = []
        named = dict(self.model.named_parameters())
        with torch.no_grad():
            for n in self.names:
                p = named[n]
                p.data = _gather_rows(p.data, self.group, self.d)

    def _note(self, whole: torch.Tensor) -> None:
        nbytes = whole.numel() * whole.element_size()
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(whole, self._free, nbytes)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _wrap(self, mod, leaves, orig):
        def run(input, state=None):
            held = {}
            for leaf in leaves:
                block = mod._parameters[leaf]
                whole = _GatherRows.apply(block, self.group, self.d)
                self._note(whole)
                self.gathered[id(whole)] = (weakref.ref(whole), block)
                held[leaf] = block
                mod._parameters[leaf] = whole
            try:
                return orig(input, state)
            finally:
                for leaf, block in held.items():
                    mod._parameters[leaf] = block
        return run

    def pack(self, t):
        base = t if t._base is None else t._base
        hit = self.gathered.get(id(base))
        if hit is not None and hit[0]() is base:
            return _Regather(hit[1], t)
        return t

    def unpack(self, x):
        if not isinstance(x, _Regather):
            return x
        whole = _gather_rows(x.block.detach(), self.group, self.d)
        self._note(whole)
        return whole.as_strided(x.size, x.stride, x.offset)

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                        self.unpack)


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
        self._fsdp: Optional[_FSDP] = None  # fsdp's blocks, while held
        self._full_shapes: dict = {}    # split leaf -> its whole shape
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
        whole): views of the parameters (fsdp's held blocks as they
        are)."""
        if self._fsdp is not None:
            return dict(named)
        return {n: (p.chunk(self._dsize, 0)[self._mesh.index(
            Engine.DATA_AXIS)] if n in self._shards else p)
            for n, p in named.items()}

    def _full_shape(self, name: str, t: torch.Tensor) -> tuple:
        return self._full_shapes.get(name, tuple(t.shape))

    def _init_slots(self, method, named: dict, mask) -> dict:
        self._shards = {}
        if self.parameter_sync in ("zero1", "fsdp"):
            trainable = (list(named) if mask is None else
                         [n for n, t in zip(named, mask) if t])
            for n in trainable:
                if n in self._tp_split:
                    continue
                shape = self._full_shape(n, named[n])
                sh = shard_leading_axis(self._mesh, shape, Engine.DATA_AXIS)
                if tuple(sh.spec) == (Engine.DATA_AXIS,):
                    self._shards[n] = True
                    self._full_shapes[n] = shape
            if self.parameter_sync == "fsdp" and self._shards \
                    and self._fsdp is None:
                self._fsdp_shard()
        return method.init_state_trimmed(self._shard_views(named), mask)

    def _fsdp_shard(self) -> None:
        self._fsdp = _FSDP(self.model, list(self._shards),
                           self._group(Engine.DATA_AXIS), self._dsize,
                           self._mesh.index(Engine.DATA_AXIS))
        self._fsdp.shard()

    def _fsdp_unshard(self) -> None:
        """The weights whole again (the step program's key holds the
        parameters' storage, so a later step captures anew)."""
        if self._fsdp is not None:
            self._fsdp.unshard()
            self._fsdp = None

    def fsdp_bytes(self) -> dict:
        """This rank's bytes of parameters and slots held between steps
        (``params``, ``slots``) and the most bytes of gathered weights alive
        at once during the steps so far (``gathered_peak``)."""
        def nbytes(ts):
            return sum(t.numel() * t.element_size() for t in ts
                       if isinstance(t, torch.Tensor))
        from torch.utils._pytree import tree_leaves
        return {"params": nbytes(self.model.parameters()),
                "slots": nbytes(tree_leaves(self._ostate or {})),
                "gathered_peak": (self._fsdp.peak if self._fsdp is not None
                                  else 0)}

    def _blocks(self, named: dict) -> Optional[BlockReductions]:
        """The block reductions of an update over row blocks."""
        if not self._shards:
            return None
        views = self._shard_views(named)
        group = self._group(Engine.DATA_AXIS)
        return BlockReductions(
            [views[n].data_ptr() for n in self._shards if n in views],
            lambda t: C.all_reduce_(t, group),
            self._mesh.index(Engine.DATA_AXIS) == 0)

    def _flat_layout(self, named: dict, mask) -> list:
        """``(numel whole, split?)`` of each leaf in a flat slot vector (an
        LBFGS history row), in the method's order."""
        out = []
        for k, (n, p) in enumerate(named.items()):
            if mask is not None and not mask[k]:
                continue
            out.append((int(np.prod(self._full_shape(n, p))),
                        n in self._shards))
        return out

    def _unblock_flat(self, part: torch.Tensor, layout: list) -> torch.Tensor:
        """A flat slot of this rank's blocks (the last dim) as the whole
        vector: each split leaf's segment all-gathered over the data
        slice."""
        d, group = self._dsize, self._group(Engine.DATA_AXIS)
        segs, off = [], 0
        for numel, split in layout:
            k = numel // d if split else numel
            seg = part[..., off:off + k]
            if split:
                rows = _gather_rows(seg.movedim(-1, 0).contiguous(), group,
                                    d)
                seg = rows.movedim(0, -1)
            segs.append(seg)
            off += k
        return torch.cat(segs, -1)

    def _block_flat(self, whole: torch.Tensor, layout: list) -> torch.Tensor:
        """The inverse of :meth:`_unblock_flat`: this rank's blocks of a
        whole flat slot."""
        d, i = self._dsize, self._mesh.index(Engine.DATA_AXIS)
        segs, off = [], 0
        for numel, split in layout:
            seg = whole[..., off:off + numel]
            segs.append(seg.chunk(d, -1)[i] if split else seg)
            off += numel
        return torch.cat(segs, -1)

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
        named = dict(self.model.named_parameters())
        full = self._method.init_state_trimmed(
            {n: p.new_empty(self._full_shape(n, p))
             for n, p in named.items()}, mask)
        convert.load_jax_ostate(self._method, full, self.model, tree, mask)
        i = self._mesh.index(Engine.DATA_AXIS)
        layout = self._flat_layout(named, mask)
        with torch.no_grad():
            for part, whole in _tree_pairs(self._ostate, full):
                if not isinstance(part, torch.Tensor):
                    continue
                if part.shape == whole.shape:
                    part.copy_(whole)
                elif part.shape[1:] == whole.shape[1:]:
                    part.copy_(whole.chunk(self._dsize, 0)[i])
                else:
                    part.copy_(self._block_flat(whole, layout))
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
        if self._fsdp is not None:
            stack.enter_context(self._fsdp.hooks())
        return stack

    def _sync_grads(self, names: list, grads: list) -> list:
        group = self._group(Engine.DATA_AXIS)
        scale = 1.0 / self._dsize if self._averages() else 1.0
        out = list(grads)
        full = [i for i, n in enumerate(names) if n not in self._shards]
        part = [i for i, n in enumerate(names) if n in self._shards]
        if self._fsdp is not None:
            # the gathers' backward already reduce-scattered these
            for i in part:
                out[i] = grads[i] * scale
            part = []
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
        with block_reductions(self._blocks(named)):
            method.update_with_trimmed(self._shard_views(named), grads,
                                       ostate, h, mask)
        if self._fsdp is None:
            self._gather_shards()

    def _gather_shards(self) -> None:
        """Every ZeRO-1-split parameter whole again, from the ranks' blocks
        (one all-gather a dtype)."""
        if not self._shards or self._fsdp is not None:
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
        if self.parameter_sync == "fsdp" and self._shards \
                and self._fsdp is None:
            self._fsdp_shard()        # a second optimize() of this trainer
        logger.info("DistriOptimizer: mesh=%s sync=%s step=%s",
                    self._mesh.shape, self.parameter_sync, self.step_mode)
        try:
            return super().optimize(resume)
        finally:
            self._fsdp_unshard()
            self._pipe_gather()

    def _optimize_impl(self, device):
        keep = (self.train_summary, self.val_summary)
        if self._mesh.rank != 0:        # rank 0 writes the summaries
            self.train_summary = self.val_summary = None
        try:
            return super()._optimize_impl(device)
        finally:
            self.train_summary, self.val_summary = keep

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
    def _process_index_count(self) -> tuple:
        return self._mesh.rank, self._mesh.size

    def _elastic_mesh(self):
        return self._mesh

    def _claims_barrier(self):
        return C.barrier

    def _pipe_trimmed(self, name: Optional[str]) -> bool:
        """A leaf of a pipeline stage this rank does not run (this rank
        keeps no slots for it; JAX's layout has them)."""
        stage = self._stage_of(name)
        return stage is not None and stage != self._mesh.index(
            self._pipe_model().axis_name)

    def _slot_tree(self, slots: dict, mask) -> dict:
        """``convert.ostate_tree`` of ``slots`` in JAX's layout: on a pipe
        mesh the other stages' slots, which this rank trims, come back
        whole-shaped (zeros: the ranks that run the stage hold them)."""
        named = dict(self.model.named_parameters())
        if self._pipe_model() is None or mask is None:
            return convert.ostate_tree(self._method, slots, self.model, mask)
        jmask = [t or self._pipe_trimmed(n) for n, t in zip(named, mask)]
        jmask = None if all(jmask) else jmask
        full = self._method.init_state_trimmed(named, jmask)

        def merged(a, b):
            if isinstance(a, dict):
                return {k: merged(v, b[k]) for k, v in a.items()}
            if isinstance(a, list):
                return [merged(x, y) for x, y in zip(a, b)]
            if isinstance(a, torch.Tensor) and a.numel() == 0 \
                    and b.numel() > 0:
                return b
            return a
        return convert.ostate_tree(self._method, merged(slots, full),
                                   self.model, jmask)

    def _stage_of(self, name: Optional[str]) -> Optional[int]:
        """The pipeline stage a leaf belongs to (its path's first part), or
        None off a pipe mesh."""
        pipe = self._pipe_model()
        if pipe is None or name is None:
            return None
        head = name.split(".", 1)[0]
        return int(head) if head.isdigit() and int(head) < pipe.n_stages \
            else None

    def _stage_ranks(self, stage: int) -> list:
        """The global ranks that run ``stage``."""
        mesh, pipe = self._mesh, self._pipe_model()
        a = mesh.axis_names.index(pipe.axis_name)
        return [int(r) for r in np.take(mesh.devices, stage,
                                        axis=a).reshape(-1)]

    def _name_at(self, path: tuple, names) -> Optional[str]:
        """The parameter (or buffer) a slot-tree path ends in."""
        parts = [".".join(p) if isinstance(p, tuple) else str(p)
                 for p in path]
        for j in range(len(parts)):
            cand = ".".join(parts[j:])
            if cand in names:
                return cand
        return None

    def _map_named(self, tree, fn, names, path=()):
        """``fn(name or None, leaf)`` over the leaves of nested dicts."""
        if isinstance(tree, dict):
            return {k: self._map_named(v, fn, names, path + (k,))
                    for k, v in tree.items()}
        return fn(self._name_at(path, names), tree)

    def _io_slots(self, whole_rows: bool) -> dict:
        """The slots for a checkpoint, structured as the live ones: ZeRO's
        row blocks gathered whole when ``whole_rows`` (else kept), LBFGS's
        flat history of blocks always whole (collectives on every rank)."""
        named, _, mask = self._prepare_step()
        if not self._shards:
            return self._ostate
        full = self._method.init_state_trimmed(
            {n: p.new_empty(self._full_shape(n, p))
             for n, p in named.items()}, mask)
        layout = self._flat_layout(named, mask)
        group = self._group(Engine.DATA_AXIS)

        def pick(part, whole):
            if not isinstance(part, torch.Tensor) or part.shape == whole.shape:
                return part
            if part.shape[1:] == whole.shape[1:]:
                if not whole_rows:
                    return part
                C.all_gather_into(whole.view(-1), part.contiguous(), group)
                return whole
            return self._unblock_flat(part, layout)

        def zipped(a, b):
            if isinstance(a, dict):
                return {k: zipped(v, b[k]) for k, v in a.items()}
            if isinstance(a, list):
                return [zipped(x, y) for x, y in zip(a, b)]
            return pick(a, b)
        return zipped(self._ostate, full)

    def _ostate_for_io(self) -> dict:
        return self._io_slots(whole_rows=True)

    def _whole(self, name: Optional[str], t, param: bool = False):
        """A leaf whole on every rank of its slice: a tensor-parallel
        leaf gathered over its axis, an fsdp block over data, a pipeline
        stage's leaf from the rank that runs the stage."""
        if name is None or not isinstance(t, torch.Tensor):
            return t
        if name in self._tp_split:
            dim, axis = self._tp_split[name]
            return C.all_gather_cat(t, self._group(axis), dim)
        if param and self._fsdp is not None and name in self._shards:
            return _gather_rows(t, self._group(Engine.DATA_AXIS),
                                self._dsize)
        stage = self._stage_of(name)
        pipe = self._pipe_model()
        if stage is not None and self._mesh.axis_size(pipe.axis_name) > 1:
            buf = t.clone()
            C.broadcast_(buf, self._mesh.group_ranks(pipe.axis_name)[stage],
                         self._group(pipe.axis_name))
            return buf
        return t

    def _jax_trees(self) -> dict:
        """The pickle backend's trees, every leaf whole (collectives on
        every rank; rank 0 writes them)."""
        named, _, mask = self._prepare_step()
        model = self.model
        state = convert.module_state(model)
        params = {n: self._whole(n, p.detach(), param=True)
                  for n, p in named.items()}
        mstate = {n: self._whole(n, b) for n, b in state.items()}
        ostate = self._map_named(self._slot_tree(self._ostate_for_io(), mask),
                                 self._whole, set(named))
        return {"params": convert.nest(model, params),
                "mstate": convert.nest(model, mstate, "state"),
                "ostate": ostate}

    def _elastic_tree(self) -> dict:
        """The elastic backend's trees: each leaf this rank's part of it,
        with JAX's spec of it over the mesh (``elastic_ckpt.PlacedLeaf``):
        ZeRO's slot blocks and fsdp's parameter blocks over ``data``,
        tensor-parallel leaves over their axis, a pipeline stage's leaves
        held by the ranks that run it, the rest replicated."""
        from bigdl_tpu_torch.utils.elastic_ckpt import PlacedLeaf
        named, _, mask = self._prepare_step()
        model, mesh = self.model, self._mesh

        def place(name, t):
            if not isinstance(t, torch.Tensor):
                return t
            shape, spec, holders = tuple(t.shape), (), None
            if name in self._tp_split:
                dim, axis = self._tp_split[name]
                shape = shape[:dim] + (shape[dim] * mesh.axis_size(axis),) \
                    + shape[dim + 1:]
                spec = (None,) * dim + (axis,)
            elif name in self._shards \
                    and shape != self._full_shape(name, t):
                shape, spec = self._full_shape(name, t), (Engine.DATA_AXIS,)
            stage = self._stage_of(name)
            if stage is not None:
                holders = self._stage_ranks(stage)
            return PlacedLeaf(t.detach(), shape, spec, mesh, holders)

        state = convert.module_state(model)
        ostate = convert.ostate_host_layout(
            self._method,
            self._slot_tree(self._io_slots(whole_rows=False), mask))
        return {
            "params": convert.nest(model, {n: place(n, p)
                                           for n, p in named.items()}),
            "mstate": convert.nest(model, {n: place(n, b)
                                           for n, b in state.items()},
                                   "state"),
            "ostate": self._map_named(ostate, place, set(named)),
        }

    def _local(self, name: Optional[str], a, param: bool = False):
        """A whole leaf (host array) cut to this rank's part of it in the
        live layout: a tensor-parallel leaf's slice, an fsdp block."""
        if name is None or not hasattr(a, "shape"):
            return a
        a = np.asarray(a)
        if name in self._tp_split:
            dim, axis = self._tp_split[name]
            n = self._mesh.axis_size(axis)
            if a.shape[dim] % n == 0 and a.ndim > dim:
                return np.split(a, n, dim)[self._mesh.index(axis)]
        if param and self._fsdp is not None and name in self._shards:
            return np.split(a, self._dsize, 0)[
                self._mesh.index(Engine.DATA_AXIS)]
        return a

    def _restore(self, payload: dict) -> None:
        """A payload of whole leaves (either backend, either package, any
        mesh) into this trainer's layout of them."""
        if self._mesh is None:
            if self.device is None:
                self.device = Engine.device()
            self._setup()
        named, _, _ = self._prepare_step()
        names = set(named)
        payload = dict(payload)
        payload["params"] = self._map_named(
            payload["params"], lambda n, a: self._local(n, a, True), names)
        if self._tp_split:
            payload["ostate"] = self._map_named(payload["ostate"],
                                                self._local, names)
        if self._pipe_model() is not None:
            # the stages this rank does not run: no slots here
            payload["ostate"] = self._map_named(
                payload["ostate"], lambda n, a: np.zeros((0,), np.float32)
                if self._pipe_trimmed(n) and hasattr(a, "shape") else a,
                names)
        super()._restore(payload)

    def _save_checkpoint(self, neval_next=None) -> None:
        if self.checkpoint_backend == "elastic" or self._mesh.rank == 0:
            return super()._save_checkpoint(neval_next)
        self._snapshot()            # the gathers every rank takes part in

    def _has_checkpoint(self) -> bool:
        if self.checkpoint_path is None:
            return False            # no collective: a failed rank raises
        if self.checkpoint_backend == "elastic" or self._mesh.rank == 0:
            self._join_checkpoint_writer(raise_error=False)
        C.barrier()
        return super()._has_checkpoint()

    def _load_latest_checkpoint(self) -> None:
        if self._mesh is None:
            if self.device is None:
                self.device = Engine.device()
            self._setup()
        if self.checkpoint_backend == "elastic" or self._mesh.rank == 0:
            self._join_checkpoint_writer()
        C.barrier()
        super()._load_latest_checkpoint()
        self._synced = True


class ParallelOptimizer(DistriOptimizer):
    """Layer-wise parameter sync, the reference's ``ParallelOptimizer``:
    JAX compiles it to the same program as ``DistriOptimizer`` (per-leaf
    reductions the combiner buckets), and so does the port."""
