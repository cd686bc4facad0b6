"""Sharding decisions over the port's mesh.

Counterpart of ``bigdl_tpu/parallel/sharding.py``, with JAX's decisions:
a spec is a tuple of axis names, one entry a dimension (None: not split),
trailing Nones implicit, as ``PartitionSpec`` and :func:`spec_to_tuple`
record it. JAX hands a ``NamedSharding`` to XLA, which then inserts the
collectives; the port's trainer reads the same decision and issues them
itself (``optim/distri_optimizer.py``): a leaf whose dim 0 is divisible
by, and at least, the axis size is split on dim 0 over that axis, any
other leaf is replicated (``shard_leading_axis``,
``zero1_state_sharding``). The collectives themselves live in
``parallel/collectives.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class PartitionSpec(tuple):
    """``P("data")``, ``P(None, "model")``, ``P()``: one entry a
    dimension, as JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (JAX's ``NamedSharding``)."""
    mesh: object
    spec: PartitionSpec


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh, axis: str = "data") -> NamedSharding:
    """Split the leading (batch) dim over ``axis``, replicate the rest."""
    return NamedSharding(mesh, P(axis))


def shard_leading_axis(mesh, x_shape, axis: str = "data") -> NamedSharding:
    """Split dim 0 over ``axis`` when divisible, else replicate (per
    leaf)."""
    n = int(mesh.shape[axis])
    if len(x_shape) > 0 and x_shape[0] % n == 0 and x_shape[0] >= n:
        return NamedSharding(mesh, P(axis))
    return NamedSharding(mesh, P())


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def zero1_state_sharding(mesh, state_tree, axis: str = "data"):
    """A sharding for every leaf of ``state_tree`` (nested dicts, lists):
    dim 0 split over ``axis`` where divisible, the slice-owned optimizer
    state of the reference's ``AllReduceParameter``."""
    return _map(lambda x: shard_leading_axis(mesh, np.shape(x), axis),
                state_tree)


def spec_to_tuple(sharding):
    """A sharding's spec as plain nested tuples (None for anything that is
    not a :class:`NamedSharding`: a whole array)."""
    if not isinstance(sharding, NamedSharding):
        return None
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in tuple(sharding.spec))


def adapt_spec(spec, mesh, shape) -> PartitionSpec:
    """Re-target a recorded spec tuple onto ``mesh``: per dimension, keep
    the axis names that exist on the new mesh and still divide the dim;
    everything else is replicated."""
    if spec is None:
        return P()
    sizes = dict(mesh.shape)
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = tuple(entry) if isinstance(entry, (list, tuple)) else (entry,)
        if not all(a in sizes for a in axes):
            out.append(None)
            continue
        n = int(np.prod([sizes[a] for a in axes]))
        if dim < len(shape) and shape[dim] % n == 0 and shape[dim] >= n:
            out.append(entry if isinstance(entry, str) else tuple(axes))
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)
