"""Sparse-feature layers over padded id lists.

Counterpart of ``bigdl_tpu/nn/sparse.py``. A sparse row is a padded list:
``ids (N, K)`` integers with pad ``-1`` and optional ``values (N, K)``
floats, static in shape, as in JAX (no ``torch.sparse``). A contraction
``out[b] = Σ_k values[b, k] · W[ids[b, k]]`` is one gather and a masked
sum over K. Input is an ``ids`` tensor, or a ``Table``/tuple
``(ids, values)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import AbstractModule
from bigdl_tpu_torch.nn.initialization import (
    InitializationMethod, RandomUniform, Zeros,
)
from bigdl_tpu_torch.utils.table import Table

PAD_ID = -1


def _split_ids_values(input):
    if isinstance(input, Table):
        xs = input.values()
    elif isinstance(input, (tuple, list)):
        xs = list(input)
    else:
        xs = [input]
    return xs[0], (xs[1] if len(xs) > 1 else None)


def _masked_rows(weight, ids, values):
    """``(rows (N, K, D), weights (N, K))``: the gathered rows of the live
    ids (pads read row 0) and each entry's weight (0 for a pad, ``values``
    or 1 for a live id)."""
    mask = ids != PAD_ID
    rows = F.embedding(torch.where(mask, ids, 0).long(), weight)
    w = mask.to(rows.dtype)
    if values is not None:
        w = w * values
    return rows, w


class SparseLinear(AbstractModule):
    """Linear layer over padded sparse ids: ``ids (N, K)`` [+ ``values``]
    -> ``(N, output_size)``; pad entries contribute nothing."""

    def __init__(self, n_features: int, output_size: int,
                 with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_features = n_features
        self.output_size = output_size
        self.with_bias = with_bias
        w_init = w_init or RandomUniform()
        b_init = b_init or Zeros()
        self.weight = torch.nn.Parameter(w_init.init(
            (n_features, output_size), fan_in=n_features,
            fan_out=output_size, generator=generator))
        self.bias = (torch.nn.Parameter(b_init.init(
            (output_size,), fan_in=n_features, fan_out=output_size,
            generator=generator)) if with_bias else None)

    def run(self, input, state=None):
        ids, values = _split_ids_values(input)
        rows, w = _masked_rows(self.weight, ids, values)
        out = (rows * w[..., None]).sum(1)
        if self.bias is not None:
            out = out + self.bias
        return out, state

    def extra_repr(self):
        return f"{self.n_features} -> {self.output_size}"


class SparseEmbeddingSum(AbstractModule):
    """Bag-of-ids embedding: the mean or sum of the rows of the live ids
    (weighted by ``values`` when given)."""

    def __init__(self, n_index: int, n_output: int, combiner: str = "mean",
                 w_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if combiner not in ("mean", "sum"):
            raise ValueError("combiner must be 'mean' or 'sum'")
        self.n_index = n_index
        self.n_output = n_output
        self.combiner = combiner
        w_init = w_init or RandomUniform(-0.05, 0.05)
        self.weight = torch.nn.Parameter(w_init.init(
            (n_index, n_output), fan_in=n_index, fan_out=n_output,
            generator=generator))

    def run(self, input, state=None):
        ids, values = _split_ids_values(input)
        rows, w = _masked_rows(self.weight, ids, values)
        out = (rows * w[..., None]).sum(1)
        if self.combiner == "mean":
            out = out / w.sum(1, keepdim=True).clamp(min=1e-12)
        return out, state

    def extra_repr(self):
        return f"{self.n_index} -> {self.n_output}, {self.combiner}"


class DenseToSparse(AbstractModule):
    """Dense one-hot or multi-hot rows -> a padded ``Table(ids, values)``
    of at most ``k`` entries a row: the ``k`` largest magnitudes (JAX's
    ``lax.top_k``), zeros dropped to pads."""

    def __init__(self, k: int):
        super().__init__()
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = int(k)

    def run(self, input, state=None):
        # a stable descending sort: equal magnitudes keep index order, as
        # lax.top_k does (torch.topk leaves the order of ties open)
        vals, ids = torch.sort(input.abs(), dim=-1, descending=True,
                               stable=True)
        vals, ids = vals[..., :self.k], ids[..., :self.k]
        taken = torch.gather(input, -1, ids)
        live = vals > 0
        ids = torch.where(live, ids, PAD_ID).to(torch.int32)
        taken = torch.where(live, taken, torch.zeros_like(taken))
        return Table(ids, taken), state


class SparseJoinTable(AbstractModule):
    """Concatenate padded ``(ids, values)`` pairs along the feature axis,
    each input's ids shifted by its ``offsets`` entry into one combined
    feature space; an input without values counts 1 a live id."""

    def __init__(self, offsets):
        super().__init__()
        self.offsets = [int(o) for o in offsets]

    def run(self, input, state=None):
        pairs = input.values() if isinstance(input, Table) else list(input)
        if len(pairs) != len(self.offsets):
            raise ValueError(
                f"SparseJoinTable got {len(pairs)} inputs for "
                f"{len(self.offsets)} offsets")
        all_ids, all_vals = [], []
        for p, off in zip(pairs, self.offsets):
            ids, values = _split_ids_values(p)
            live = ids != PAD_ID
            all_ids.append(torch.where(live, ids + off, PAD_ID))
            if values is None:
                values = live.float()
            all_vals.append(torch.where(live, values,
                                        torch.zeros_like(values)))
        return Table(torch.cat(all_ids, -1), torch.cat(all_vals, -1)), state


class LookupTableSparse(AbstractModule):
    """Embedding lookup over padded sparse ids with the ``sum``, ``mean``
    or ``sqrtn`` combiner (TF's ``embedding_lookup_sparse``):
    ``ids (N, K)`` [+ ``values``] -> ``(N, n_output)``."""

    def __init__(self, n_index: int, n_output: int, combiner: str = "sum",
                 w_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError("combiner must be sum|mean|sqrtn")
        self.n_index = n_index
        self.n_output = n_output
        self.combiner = combiner
        w_init = w_init or RandomUniform()
        self.weight = torch.nn.Parameter(w_init.init(
            (n_index, n_output), fan_in=n_index, fan_out=n_output,
            generator=generator))

    def run(self, input, state=None):
        ids, values = _split_ids_values(input)
        live = ids != PAD_ID
        weights = values if values is not None else live.float()
        weights = torch.where(live, weights, torch.zeros_like(weights))
        rows = F.embedding(torch.where(live, ids, 0).long(), self.weight)
        summed = (rows * weights[..., None]).sum(-2)
        if self.combiner == "sum":
            return summed, state
        norm = (weights.sum(-1, keepdim=True) if self.combiner == "mean"
                else weights.square().sum(-1, keepdim=True).sqrt())
        return summed / norm.clamp(min=1e-12), state
