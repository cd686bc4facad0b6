"""Tensor parallelism over the mesh's ``model`` axis.

Counterpart of ``bigdl_tpu/parallel/tensor_parallel.py:28-132``: the same
``TPRules`` (ordered ``(path regex, spec)`` pairs, first match wins,
matched against the ``/``-joined parameter path, e.g. ``0/weight``),
``column_parallel``, ``row_parallel`` and ``megatron_mlp_rules``. JAX's
rules are declarative: XLA's partitioner splits the products and inserts
the collectives. Torch eager has no partitioner, so
:func:`apply_tensor_parallel` (what ``DistriOptimizer.set_tensor_parallel``
runs) swaps the owner of every matched leaf for an explicit parallel
form holding only this rank's slice:

- ``Linear`` with weight ``P(model, None)`` (column): output features
  split; the input enters by ``copy_to`` (its gradient summed over the
  slice), the output is gathered unless a row-parallel ``Linear`` reads it
  through element-wise layers only, as in Megatron's MLP pair;
- ``Linear`` with weight ``P(None, model)`` (row): input features split;
  the partial products summed over the slice (``reduce_from``), the
  replicated bias added after the sum;
- ``LookupTable`` with weight ``P(model, None)`` (vocab-parallel, for
  ``embedding_parallel_rules``): a masked gather of the local rows, then
  the sum over the slice;
- ``MoE`` with its expert leaves on ``model`` (``expert_parallel_rules``):
  a rank runs its ``n_experts / tp`` experts (``parallel/moe.py``).

A rule that matches a leaf no form covers raises, naming the path; so do
a spec whose axis is not in the mesh and a split that does not divide.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.parallel import collectives as C
from bigdl_tpu_torch.parallel.sharding import (
    NamedSharding, P, PartitionSpec, shard_leading_axis,
)


def normalize_path(name: str) -> str:
    """A dotted torch parameter path as JAX's ``/``-joined one."""
    return name.replace(".", "/")


def column_parallel(model_axis: str = "model") -> PartitionSpec:
    """Linear weight (out, in) split on the output dim; bias with it."""
    return P(model_axis, None)


def row_parallel(model_axis: str = "model") -> PartitionSpec:
    """Linear weight (out, in) split on the input dim; bias replicated."""
    return P(None, model_axis)


class TPRules:
    """Ordered parameter-path -> spec rules (first match wins)."""

    def __init__(self, rules: Sequence[Tuple[str, PartitionSpec]] = (),
                 default: PartitionSpec = P()):
        self.rules = [(re.compile(pat), P(*spec)) for pat, spec in rules]
        self.default = default

    def add(self, pattern: str, spec) -> "TPRules":
        self.rules.append((re.compile(pattern), P(*spec)))
        return self

    def match(self, path: str, shape) -> Optional[PartitionSpec]:
        """The first matching rule's spec, or None."""
        for pat, spec in self.rules:
            if pat.search(path):
                self._check(path, spec, shape)
                return spec
        return None

    def spec_for(self, path: str, shape) -> PartitionSpec:
        spec = self.match(path, shape)
        return self.default if spec is None else spec

    @staticmethod
    def _check(path: str, spec, shape) -> None:
        if len(spec) > len(shape):
            raise ValueError(
                f"TP rule for {path!r}: spec {spec} has more axes than the "
                f"parameter shape {tuple(shape)}")

    def param_shardings(self, params: dict, mesh) -> dict:
        """A sharding for every parameter (``{path: tensor}``), each split
        checked against the mesh with the path named."""
        axes = dict(mesh.shape)
        out = {}
        for name, leaf in params.items():
            p = normalize_path(name)
            shape = tuple(np.shape(leaf))
            spec = self.spec_for(p, shape)
            for dim, ax in enumerate(spec):
                if ax is None:
                    continue
                if ax not in axes:
                    raise ValueError(
                        f"TP rule for {p!r} uses mesh axis {ax!r}, not in "
                        f"mesh {tuple(axes)}")
                if shape[dim] % axes[ax] != 0:
                    raise ValueError(
                        f"TP rule for {p!r}: dim {dim} of shape {shape} not "
                        f"divisible by {ax!r} axis size {axes[ax]}")
            out[name] = NamedSharding(mesh, spec)
        return out

    def slot_shardings(self, state_shapes: dict, mesh,
                       dp_axis: Optional[str] = None) -> dict:
        """Slots (``{path: shape}``) of a matched leaf follow its spec; the
        rest are replicated, or split on dim 0 over ``dp_axis``
        (ZeRO-1)."""
        out = {}
        for name, shape in state_shapes.items():
            p = normalize_path(name)
            spec = self.match(p, shape)
            if spec is not None:
                out[name] = NamedSharding(mesh, spec)
            elif dp_axis is not None:
                out[name] = shard_leading_axis(mesh, shape, dp_axis)
            else:
                out[name] = NamedSharding(mesh, P())
        return out


def megatron_mlp_rules(up_pattern: str, down_pattern: str,
                       model_axis: str = "model") -> TPRules:
    """Up-projection column-parallel, down-projection row-parallel: one
    reduction per MLP block. Patterns are anchored at path boundaries."""
    return TPRules([
        (rf"(^|/){up_pattern}/weight$", column_parallel(model_axis)),
        (rf"(^|/){up_pattern}/bias$", P(model_axis)),
        (rf"(^|/){down_pattern}/weight$", row_parallel(model_axis)),
        (rf"(^|/){down_pattern}/bias$", P()),
    ])


# ------------------------------------------------------------ the forms
def _shard(t: torch.Tensor, dim: int, n: int, i: int) -> torch.nn.Parameter:
    return torch.nn.Parameter(t.detach().chunk(n, dim)[i].clone(),
                              requires_grad=t.requires_grad)


class _TPForm:
    """Mixed into a swapped module: which leaf is split on which dim over
    which group, so the trainer can gather full leaves (checkpoints)."""

    def tp_leaves(self) -> dict:
        return dict(self._tp_leaves)


def _column_run(self, input, state=None):
    from bigdl_tpu_torch.nn.linear import normalize_linear_input
    from bigdl_tpu_torch.nn.precision import promote
    x, restore = normalize_linear_input(input)
    if not self.tp_input_parallel:
        x = C.copy_to(x, self.tp_group)
    y = torch.nn.functional.linear(*promote(x, *(
        t for t in (self.weight, self.bias) if t is not None)))
    if self.tp_gather_output:
        y = C.gather_from(y, self.tp_group, -1)
    return restore(y), state


def _row_run(self, input, state=None):
    from bigdl_tpu_torch.nn.linear import normalize_linear_input
    from bigdl_tpu_torch.nn.precision import promote
    x, restore = normalize_linear_input(input)
    if not self.tp_input_parallel:
        x = C.split_to(x, self.tp_group, -1)
    x, w = promote(x, self.weight)
    y = C.reduce_from(torch.nn.functional.linear(x, w), self.tp_group)
    if self.bias is not None:
        y = y + self.bias.to(y.dtype)
    return restore(y), state


def _vocab_run(self, input, state=None):
    idx = self._ids(input)
    lo, n_local = self.tp_range
    local = idx - lo
    inside = (local >= 0) & (local < n_local)
    rows = torch.nn.functional.embedding(
        torch.where(inside, local, torch.zeros_like(local)), self.weight)
    rows = rows * inside[..., None].to(rows.dtype)
    out = C.reduce_from(rows, self.tp_group)
    return self._mask_padding(self._renorm_rows(out), idx), state


_FORMS: dict = {}


def _swap(module, kind: str, run):
    """Turn ``module`` into its parallel form: a subclass of its class
    whose ``run`` is ``run`` (one subclass a class and kind)."""
    cls = type(module)
    sub = _FORMS.get((cls, kind))
    if sub is None:
        sub = _FORMS[(cls, kind)] = type(f"{kind}{cls.__name__}",
                                          (cls, _TPForm), {"run": run})
    module.__class__ = sub


def apply_tensor_parallel(model: torch.nn.Module, rules: TPRules,
                          mesh) -> dict:
    """Swap every matched leaf's owner for its parallel form over
    ``mesh``'s axis; returns ``{param path: (dim, axis)}`` of the split
    leaves. Idempotent on an already swapped model."""
    from bigdl_tpu_torch.nn.embedding import LookupTable
    from bigdl_tpu_torch.nn.linear import Linear
    from bigdl_tpu_torch.parallel.moe import MoE

    params = dict(model.named_parameters())
    shard = rules.param_shardings(params, mesh)
    matched = {n: sh.spec for n, sh in shard.items()
               if rules.match(normalize_path(n), tuple(params[n].shape))
               is not None}
    owners = dict(model.named_modules())
    split: dict = {}
    by_owner: dict = {}
    for name, spec in matched.items():
        owner, _, leaf = name.rpartition(".")
        by_owner.setdefault(owner, {})[leaf] = spec
    for owner_name, leaves in by_owner.items():
        mod = owners[owner_name]
        if isinstance(mod, _TPForm) or getattr(mod, "_ep", None):
            split.update({f"{owner_name}.{k}" if owner_name else k: v
                          for k, v in mod.tp_leaves().items()})
            continue
        specs = {k: tuple(s) for k, s in leaves.items()}
        axes = {a for s in specs.values() for a in s if a is not None}
        if not axes:
            continue        # every matched spec replicates
        if len(axes) != 1:
            raise ValueError(f"TP rules split {owner_name!r} over several "
                             f"axes {sorted(axes)}")
        axis = axes.pop()
        group, n, i = mesh.group(axis), mesh.shape[axis], mesh.index(axis)
        path = normalize_path(owner_name)
        w = specs.get("weight")
        if isinstance(mod, MoE):
            want = {"w1": (axis, None, None), "b1": (axis, None),
                    "w2": (axis, None, None), "b2": (axis, None)}
            if any(specs.get(k, want.get(k)) != want.get(k) for k in specs) \
                    or set(specs) - set(want):
                raise ValueError(f"TP rules for MoE {path!r} must split "
                                 f"w1, b1, w2 and b2 on the expert dim; got "
                                 f"{specs}")
            mod.set_expert_parallel(group, n, i, axis)
            split.update({f"{owner_name}.{k}" if owner_name else k: v
                          for k, v in mod.tp_leaves().items()})
            continue
        elif isinstance(mod, Linear) and w == (axis, None):
            if specs.get("bias", (axis,)) not in ((axis,), (axis, None)):
                raise ValueError(f"column-parallel {path!r}: its bias must "
                                 f"split with the weight, got "
                                 f"{specs['bias']}")
            mod.weight = _shard(mod.weight, 0, n, i)
            if mod.bias is not None:
                mod.bias = _shard(mod.bias, 0, n, i)
            dims = {"weight": 0, "bias": 0} if mod.bias is not None \
                else {"weight": 0}
            _swap(mod, "ColumnParallel", _column_run)
            mod.tp_gather_output, mod.tp_input_parallel = True, False
        elif isinstance(mod, Linear) and w == (None, axis):
            if specs.get("bias", ()) not in ((), (None,)):
                raise ValueError(f"row-parallel {path!r}: its bias is "
                                 f"replicated, got {specs['bias']}")
            mod.weight = _shard(mod.weight, 1, n, i)
            dims = {"weight": 1}
            _swap(mod, "RowParallel", _row_run)
            mod.tp_input_parallel = False
        elif isinstance(mod, LookupTable) and w == (axis, None) \
                and set(specs) == {"weight"}:
            rows = mod.weight.shape[0]
            mod.weight = _shard(mod.weight, 0, n, i)
            mod.tp_range = (i * (rows // n), rows // n)
            dims = {"weight": 0}
            _swap(mod, "VocabParallel", _vocab_run)
        else:
            raise ValueError(
                f"TP rules split {sorted(f'{path}/{k}' for k in specs)} "
                f"({specs}) of a {type(mod).__name__}, which has no "
                f"tensor-parallel form here (column or row Linear, "
                f"vocab-parallel LookupTable, expert-parallel MoE)")
        mod.tp_group, mod.tp_axis = group, axis
        mod._tp_leaves = {k: (d, axis) for k, d in dims.items()}
        split.update({f"{owner_name}.{k}" if owner_name else k: (d, axis)
                      for k, d in dims.items()})
    _pair_megatron(model)
    return split


def _pair_megatron(model: torch.nn.Module) -> None:
    """A column-parallel Linear whose output reaches a row-parallel one
    through element-wise layers only keeps its output split."""
    from bigdl_tpu_torch.nn import activation as A
    from bigdl_tpu_torch.nn.containers import Sequential
    from bigdl_tpu_torch.nn.normalization import Dropout
    elementwise = (A.ReLU, A.ReLU6, A.Tanh, A.Sigmoid, A.GELU, A.ELU,
                   A.LeakyReLU, A.SoftPlus, A.Swish, A.HardTanh, Dropout)
    for seq in model.modules():
        if not isinstance(seq, Sequential):
            continue
        kids = list(seq.children())
        for i, m in enumerate(kids):
            if not getattr(m, "tp_gather_output", False):
                continue
            j = i + 1
            while j < len(kids) and isinstance(kids[j], elementwise):
                j += 1
            nxt = kids[j] if j < len(kids) else None
            if nxt is not None and hasattr(nxt, "tp_input_parallel") \
                    and type(nxt).__name__.startswith("RowParallel") \
                    and nxt.tp_group is m.tp_group:
                m.tp_gather_output = False
                nxt.tp_input_parallel = True
