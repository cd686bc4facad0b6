"""Embedding tables with deduplicated gathers and sparse row updates.

Counterpart of ``bigdl_tpu/parallel/embedding.py`` on one device. A recsys
table is large and a batch touches few of its rows: the plain
``LookupTable`` backward writes a dense (V, D) gradient and the optimizer
then steps every row. Three pieces avoid that:

- :func:`dedup_ids`: a static-shape unique of a batch's ids (sorted, padded
  with the out-of-range sentinel V) and the inverse map, made from a sort,
  first-occurrence flags, a cumulative sum and stores: no ``.item()``, no
  ``nonzero``, no host read, so it runs inside a captured program (JAX's
  ``jnp.unique(size=, fill_value=)`` at ``:54``);
- :class:`ShardedEmbedding` wraps a ``LookupTable`` or
  ``HashBucketEmbedding`` (its child ``table``: the weight's path is
  ``.../table/weight``, as in JAX). Its forward gathers each unique row once
  and scatters the rows back to the positions (``BIGDL_EMBED_DEDUP``,
  default on), bitwise JAX's and the wrapped layer's forward. Under the
  sparse step (:class:`SparsePlan` set its ``_sparse`` slot, the port's
  form of JAX's ``delta``/``uids`` state channel, ``:141-161``) it gathers
  the rows from the detached weight, adds the step's zero (U, D) ``delta``
  and leaves the batch's unique ids in the slot: the gradient with respect
  to ``delta`` is the exact row gradient, and no (V, D) gradient exists;
- :class:`SparseEmbeddingUpdate` wraps the optimizer's method: its dense
  pass skips the tables (their slots are 0-size under ``"dense"``), then
  per table it gathers the unique rows and their slot rows, runs the
  method's ``sparse_update`` on them and writes them back. Semantics are
  lazy: untouched rows and their slots stay bitwise unchanged. The slot
  layout is JAX's ``{"dense": ..., "embed": {key: ...}}``.

Determinism, for a captured step to replay its eager run bit for bit: the
scatter back of the unique rows (``rows[inv]``) has a backward that sums a
row's occurrences; :class:`_GatherRows` sums them by a sort and
``torch.segment_reduce``, in a fixed order with no atomic adds. The write
back of the updated rows stores each unique row once, and the sentinel's
positions store copies of real rows' new values (identical duplicates,
spread over the rows): torch has no dropping scatter (JAX's
``mode="drop"``).

The capacity U of a table is the flattened id count of its input in a
batch, fixed by the batch's shape: :meth:`SparsePlan.zero_deltas` finds it
by one eval-mode forward when the trainer builds a step program.

Over a mesh (``bigdl_tpu/parallel/embedding.py:183-200``): JAX's
placement rules ``embedding_parallel_rules`` and ``model_embedding_rules``
are ``TPRules`` that ``DistriOptimizer.set_tensor_parallel`` applies: each
rank of the ``model`` slice keeps its block of the table's rows and looks
ids up by a masked local gather summed over the slice
(``parallel/tensor_parallel.py``). JAX's data-sharded ids
(``BIGDL_EMBED_SHARD``) are what a port rank holds anyway: its block of
the batch. Under a data-parallel step the sparse update dedups the ids of
the whole global batch (gathered over the data slice), so every rank
steps the same rows, as JAX's one program does; it keeps JAX's
eligibility (``allreduce`` without tensor parallelism).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import AbstractModule, Container
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.optim.optim_method import OptimMethod

logger = logging.getLogger("bigdl_tpu_torch.parallel")

_DELTA_KEY = "delta"   # the step's zero (U, D) rows, set by SparsePlan.inject
_UIDS_KEY = "uids"     # the batch's unique ids, left by the forward


def _dedup_global(idx: torch.Tensor, n_rows: int):
    """:func:`dedup_ids` of the ids of the whole global batch under a
    data-parallel step (gathered over the data slice), with this rank's
    part of the inverse map; of ``idx`` alone outside one."""
    from bigdl_tpu_torch.parallel import collectives as C
    group = C.data_group()
    if group is None:
        return dedup_ids(idx, n_rows)
    flat = idx.reshape(-1)
    uids, inv = dedup_ids(C.all_gather_cat(flat, group, 0), n_rows)
    r, m = C.index(group), flat.numel()
    return uids, inv[r * m:(r + 1) * m]


def dedup_ids(flat_ids: torch.Tensor, n_rows: int):
    """Static-shape dedup of a 1-D id tensor: ``(uids, inv)``, ``uids`` the
    sorted unique ids padded to ``flat_ids``' length with the sentinel
    ``n_rows``, ``inv`` the inverse map (``uids[inv] == flat_ids``), both
    int64. JAX's values exactly."""
    flat = flat_ids.reshape(-1).long()
    m = flat.numel()
    srt, order = torch.sort(flat, stable=True)
    first = torch.ones(m, dtype=torch.bool, device=flat.device)
    first[1:] = srt[1:] != srt[:-1]
    seg = torch.cumsum(first, 0) - 1
    inv = torch.empty_like(seg).scatter_(0, order, seg)
    # each unique id is stored once, at its segment; each repeat goes to a
    # spare slot of its own past the end (one shared slot would serialize
    # their stores), and the spares are dropped
    idx = torch.arange(m, device=flat.device)
    buf = torch.full((2 * m,), n_rows, dtype=torch.long, device=flat.device)
    buf.scatter_(0, torch.where(first, seg, m + idx), srt)
    return buf[:m], inv


def segment_sum(values: torch.Tensor, inv: torch.Tensor,
                n: int) -> torch.Tensor:
    """``out[j] = Σ_{i: inv[i] = j} values[i]`` for j < n (0 where no
    ``inv`` is j): a stable sort by ``inv``, then ``torch.segment_reduce``
    over the sorted rows, each segment summed in order by one thread an
    output element. A fixed order of additions and no atomic adds: the
    same bits on every run. ``unsafe=True`` skips its argument checks,
    which read the lengths back to the host."""
    s_inv, order = torch.sort(inv, stable=True)
    j = torch.arange(n, device=inv.device)
    lengths = (torch.searchsorted(s_inv, j, right=True)
               - torch.searchsorted(s_inv, j))
    return torch.segment_reduce(values[order], "sum", lengths=lengths,
                                unsafe=True)


class _GatherRows(torch.autograd.Function):
    """``rows[inv]`` with :func:`segment_sum` as its backward."""

    @staticmethod
    def forward(ctx, rows, inv):
        ctx.save_for_backward(inv)
        ctx.n = rows.shape[0]
        return rows.index_select(0, inv)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        return segment_sum(grad, inv, ctx.n), None


def gather_rows(rows: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    return _GatherRows.apply(rows, inv)


def _dedup_enabled() -> bool:
    return os.environ.get("BIGDL_EMBED_DEDUP", "1") == "1"


class ShardedEmbedding(Container):
    """A ``LookupTable`` (or ``HashBucketEmbedding``) behind deduplicated
    gathers and the sparse step; one child, ``table``. Forward paths, each
    bitwise the wrapped layer's forward:

    - plain: the table's own lookup (dedup off);
    - dedup (``dedup=None`` reads ``BIGDL_EMBED_DEDUP``, default on): the
      unique rows gathered once, renormed, scattered back by the inverse;
    - sparse step: rows from the detached weight plus the injected
      ``delta``, the batch's unique ids left in ``_sparse["uids"]``.
    """

    def __init__(self, inner: LookupTable, axis: str = "model",
                 dedup: Optional[bool] = None):
        if not isinstance(inner, LookupTable):
            raise TypeError(
                f"ShardedEmbedding wraps a LookupTable/HashBucketEmbedding, "
                f"got {type(inner).__name__}")
        AbstractModule.__init__(self)
        self.table = inner
        self.axis = axis
        self.dedup = dedup
        self._sparse: Optional[dict] = None

    def _dedup_on(self) -> bool:
        return self.dedup if self.dedup is not None else _dedup_enabled()

    def run(self, input, state=None):
        t = self.table
        if hasattr(t, "tp_range"):      # vocab-parallel over a model slice
            return t.run(input, None)[0], state
        idx = t._ids(input)
        shape = idx.shape + (t.n_output,)
        last = t.n_index - 1
        if self._sparse is not None:
            uids, inv = _dedup_global(idx, t.n_index)
            # the sentinel's rows read the last row and reach no position
            rows = F.embedding(uids.clamp(max=last), t.weight.detach())
            delta = self._sparse.get(_DELTA_KEY)
            if delta is not None:
                rows = rows + delta
            rows = t._renorm_rows(rows)
            out = gather_rows(rows, inv).reshape(shape)
            self._sparse[_UIDS_KEY] = uids
        elif self._dedup_on():
            uids, inv = dedup_ids(idx, t.n_index)
            rows = t._renorm_rows(F.embedding(uids.clamp(max=last), t.weight))
            out = gather_rows(rows, inv).reshape(shape)
        else:
            out = t._renorm_rows(F.embedding(idx, t.weight))
        return t._mask_padding(out, idx), state

    def extra_repr(self):
        return f"axis={self.axis!r}"


def find_sharded_embeddings(model) -> list:
    """Every ``(module_path, module)`` ShardedEmbedding of a module tree in
    child order; a path is the tuple of child names (a Graph's children
    are its execution indices), JAX's paths."""
    found = []

    def walk(m, path):
        if isinstance(m, ShardedEmbedding):
            found.append((path, m))
            return
        for name, child in m.named_children():
            walk(child, path + (name,))

    walk(model, ())
    return found


@dataclasses.dataclass(frozen=True)
class SparseEntry:
    key: str            # the joined module path: the "embed" slot key
    module_path: tuple  # path to the ShardedEmbedding
    n_rows: int
    n_output: int

    @property
    def weight_path(self) -> tuple:
        return self.module_path + ("table", "weight")

    @property
    def weight_name(self) -> str:
        """The weight's ``named_parameters()`` name."""
        return ".".join(self.weight_path)


def _module_at(model, path: tuple):
    return model.get_submodule(".".join(path)) if path else model


class SparsePlan:
    """The tables that train sparsely and the step's plumbing: inject the
    zero deltas, collect the unique ids, mask the tables out of the dense
    pass."""

    def __init__(self, entries):
        self.entries = list(entries)

    def weight_names(self) -> set:
        return {e.weight_name for e in self.entries}

    def inject(self, model, deltas: dict) -> None:
        for e in self.entries:
            _module_at(model, e.module_path)._sparse = {
                _DELTA_KEY: deltas[e.key]}

    def pop_uids(self, model) -> dict:
        """The unique ids each table's forward left, and the slots
        cleared."""
        uids = {}
        for e in self.entries:
            mod = _module_at(model, e.module_path)
            uids[e.key] = mod._sparse[_UIDS_KEY]
            mod._sparse = None
        return uids

    def clear(self, model) -> None:
        for e in self.entries:
            _module_at(model, e.module_path)._sparse = None

    def mask_embed(self, named: dict, trainable=None) -> list:
        """The trainable mask of the dense pass over ``named`` (the
        ``named_parameters()`` dict): the tables' weights out, the rest as
        ``trainable`` (None: all)."""
        embed = self.weight_names()
        return [n not in embed and (trainable is None or t)
                for n, t in zip(named, trainable or [True] * len(named))]

    def zero_deltas(self, model, inp) -> dict:
        """Zero (U, D) deltas, U each table's unique-row capacity: the
        flattened id count its forward sees for a batch like ``inp``,
        found by one eval-mode forward without autograd (JAX's abstract
        probe, ``:280``)."""
        from bigdl_tpu_torch.nn.abstractnn import evaluating
        self.inject(model, {e.key: None for e in self.entries})
        try:
            with torch.no_grad(), evaluating(model):
                model(inp)
            uids = self.pop_uids(model)
        finally:
            self.clear(model)
        deltas = {}
        for e in self.entries:
            w = _module_at(model, e.module_path).table.weight
            deltas[e.key] = torch.zeros(
                (uids[e.key].numel(), e.n_output), dtype=w.dtype,
                device=w.device, requires_grad=True)
        return deltas

    def __repr__(self):
        return f"SparsePlan({[e.key for e in self.entries]})"


def build_sparse_plan(model, method):
    """``(SparsePlan | None, reason | None)``: the sparse-trainable tables
    of ``model`` under ``method``; ``reason`` says why sharded tables keep
    the dense path (JAX's rules, ``:305``)."""
    mods = find_sharded_embeddings(model)
    if not mods:
        return None, None
    if not method.supports_sparse_update():
        return None, (f"{method!r} does not support sparse_update "
                      "(stateful schedule / layer_lr_mults / non-elementwise)")
    if model.has_regularizers():
        return None, ("model has weight regularizers — their gradient is "
                      "dense over the table")
    entries = []
    for path, m in mods:
        if m.grad_scales()["table.weight"] != 1.0:
            # frozen (0) or grad-scaled tables keep the dense/frozen path
            continue
        t = m.table
        entries.append(SparseEntry(key="/".join(path) or ".",
                                   module_path=path,
                                   n_rows=t.n_index, n_output=t.n_output))
    if not entries:
        return None, "every sharded table is frozen or grad-scaled"
    return SparsePlan(entries), None


def _map_slots(slots: dict, fn) -> dict:
    return {k: [fn(t) for t in v] if isinstance(v, list) else v
            for k, v in slots.items()}


class SparseEmbeddingUpdate(OptimMethod):
    """The method wrapper of the sparse step (JAX's ``:335``). Slots::

        {"dense": the method's slots, the tables' weights trimmed to 0-size,
         "embed": {entry.key: the method's slots of the (V, D) weight}}

    Driven by the trainer's sparse step through :meth:`sparse_apply`; it
    has no dense ``update`` (there is no dense table gradient)."""

    elementwise_update = False

    def __init__(self, method: OptimMethod, plan: SparsePlan):
        self.method = method
        self.plan = plan

    def init_state(self, params) -> dict:
        return self.init_state_trimmed(params, None)

    def init_state_trimmed(self, params: dict, trainable=None) -> dict:
        dense = self.method.init_state_trimmed(
            params, self.plan.mask_embed(params, trainable))
        embed = {e.key: self.method.init_state([params[e.weight_name]])
                 for e in self.plan.entries}
        return {"dense": dense, "embed": embed}

    def hyper(self, step, state):
        return self.method.hyper(step, state["dense"])

    def update_with(self, params, grads, state, h):
        raise RuntimeError(
            "SparseEmbeddingUpdate is driven by the optimizer's sparse step "
            "(sparse_apply); it has no dense update form")

    def sparse_apply(self, params: dict, grads: dict, row_grads: dict,
                     uids_map: dict, state: dict, h: torch.Tensor,
                     trainable=None) -> None:
        """One update in place: the method's dense pass over everything but
        the tables, then per table the unique rows and their slot rows
        gathered, stepped by ``sparse_update`` and written back.
        ``row_grads``/``uids_map``: ``{entry.key: (U, D) / (U,)}``."""
        self.method.update_with_trimmed(
            params, grads, state["dense"], h,
            self.plan.mask_embed(params, trainable))
        with torch.no_grad():
            for e in self.plan.entries:
                w = params[e.weight_name]
                u = uids_map[e.key]
                valid = u < e.n_rows
                # u[0] is the smallest id of the batch: always a real row
                uc = torch.where(valid, u, u[0])
                slots = state["embed"][e.key]
                rows = w[uc]
                slot_rows = _map_slots(slots, lambda s: s[uc])
                self.method.sparse_update(rows, row_grads[e.key], slot_rows,
                                          h)
                # the writes back: position j < k (the k real rows) stores
                # its row; a sentinel position stores a copy of real
                # position j mod k's, an identical duplicate, spread over
                # the rows so that no row takes many stores
                src = torch.arange(u.numel(), device=u.device) % valid.sum()
                dst = u[src]
                w.index_copy_(0, dst, rows[src])
                for s, r in zip(_flat_slots(slots), _flat_slots(slot_rows)):
                    s.index_copy_(0, dst, r[src])

    def get_learning_rate(self, step: int) -> float:
        return self.method.get_learning_rate(step)

    def __repr__(self):
        return f"SparseEmbeddingUpdate({self.method!r}, {self.plan!r})"


def _flat_slots(slots: dict) -> list:
    """The slot tensors of a per-leaf slot dict, in order."""
    return [t for v in slots.values() if isinstance(v, list) for t in v]


from bigdl_tpu_torch.utils.serializer import register as _register  # noqa: E402

_register(ShardedEmbedding)


# --------------------------------------------------------------- placement
def embedding_parallel_rules(prefix: str = "", axis: str = "model",
                             rules=None):
    """TPRules placing every ``.../table/weight`` under ``prefix``
    row-split on ``axis`` (the embedding analog of
    ``moe.expert_parallel_rules``)."""
    import re
    from bigdl_tpu_torch.parallel.sharding import P
    from bigdl_tpu_torch.parallel.tensor_parallel import TPRules
    r = rules if rules is not None else TPRules()
    pre = f"(^|/){re.escape(prefix)}/" if prefix else "(^|/)"
    r.add(f"{pre}table/weight$", P(axis, None))
    return r


def model_embedding_rules(model, rules=None):
    """Exact-path TPRules for every :class:`ShardedEmbedding` of
    ``model``, each on its own configured axis."""
    import re
    from bigdl_tpu_torch.parallel.sharding import P
    from bigdl_tpu_torch.parallel.tensor_parallel import TPRules
    r = rules if rules is not None else TPRules()
    for path, mod in find_sharded_embeddings(model):
        leaf = "/".join(path + ("table", "weight"))
        r.add(f"^{re.escape(leaf)}$", P(mod.axis, None))
    return r
