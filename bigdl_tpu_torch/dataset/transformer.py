"""Composable data transformers.

Counterpart of ``bigdl_tpu/dataset/transformer.py``: a ``Transformer`` maps
an iterator to an iterator and composes with ``>>`` (the reference's
``->``) or ``.chain``.

Chain fusion (the parallel pipeline's groundwork): most stages are
ELEMENT-WISE — one input record maps to exactly one output record with no
cross-record state. Such a stage exposes its per-element callable via
:meth:`Transformer.element_fn`, and :func:`fuse_chain` flattens a
``ChainedTransformer`` tree into maximal runs of element-wise stages
collapsed into ONE :class:`FusedTransformer` — a sample then crosses the
worker pool once instead of threading through N generator layers. Stages
that need the stream (``SampleToMiniBatch`` grouping) return ``None`` from
``element_fn`` and stay serial stream stages.

Deterministic parallel randomness rides on :func:`sample_index_scope`: the
parallel engine (``dataset/parallel.py``) tags each element with its
position in the epoch stream, and a randomized transform derives a
per-sample ``np.random.Generator`` from (pipeline seed, sample index)
through :func:`current_sample_index` — so W workers are bitwise-identical
to one, regardless of completion order.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Iterable, Iterator, Optional


class Transformer:
    """Base: override ``__call__`` mapping an iterator to an iterator."""

    def __call__(self, prev: Iterator) -> Iterator:
        raise NotImplementedError

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        """``a >> b`` — the reference's ``a -> b`` composition."""
        return ChainedTransformer(self, other)

    def chain(self, other: "Transformer") -> "ChainedTransformer":
        return self >> other

    def apply(self, data: Iterable) -> Iterator:
        return self(iter(data))

    def element_fn(self) -> Optional[Callable[[Any], Any]]:
        """Per-element callable when this stage is element-wise (one record in,
        one record out, no cross-record state); ``None`` for stream stages
        (grouping/batching). Element-wise stages are eligible for chain fusion
        and parallel execution (``dataset/parallel.py``)."""
        return None


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def __call__(self, prev: Iterator) -> Iterator:
        return self.second(self.first(prev))

    def element_fn(self):
        f, g = self.first.element_fn(), self.second.element_fn()
        if f is None or g is None:
            return None
        return lambda x: g(f(x))


class MapTransformer(Transformer):
    """Lift an element-wise function into a Transformer."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def __call__(self, prev: Iterator) -> Iterator:
        return (self.fn(x) for x in prev)

    def element_fn(self):
        return self.fn


class Identity(Transformer):
    def __call__(self, prev: Iterator) -> Iterator:
        return prev

    def element_fn(self):
        return lambda x: x


# ------------------------------------------------------------- chain fusion
def flatten_chain(transformer: Transformer) -> list:
    """Flatten a ``ChainedTransformer`` tree into its leaf stages, in order."""
    if isinstance(transformer, ChainedTransformer):
        return flatten_chain(transformer.first) + flatten_chain(transformer.second)
    return [transformer]


class FusedTransformer(Transformer):
    """Maximal run of element-wise stages collapsed into one per-element call.

    The fused callable applies every stage's element function in sequence, so
    a record crosses the (pool / generator) boundary ONCE per run instead of
    once per stage — the tf.data-style fused map (PAPERS.md 2101.12127)."""

    def __init__(self, stages: list):
        if not stages:
            raise ValueError("FusedTransformer needs at least one stage")
        self.stages = list(stages)
        fns = []
        for s in self.stages:
            fn = s.element_fn()
            if fn is None:
                raise ValueError(
                    f"stage {type(s).__name__} is not element-wise and "
                    f"cannot be fused")
            fns.append(fn)
        self._fns = fns

    def element_fn(self):
        fns = self._fns
        if len(fns) == 1:
            return fns[0]

        def fused(x):
            for fn in fns:
                x = fn(x)
            return x

        return fused

    def __call__(self, prev: Iterator) -> Iterator:
        fn = self.element_fn()
        return (fn(x) for x in prev)


def fuse_chain(transformer: Transformer) -> list:
    """Flatten ``transformer`` and collapse consecutive element-wise stages
    into :class:`FusedTransformer` runs. Returns the ordered stage list —
    stream stages (``element_fn() is None``) pass through unfused."""
    stages: list = []
    run: list = []

    def flush():
        if run:
            stages.append(run[0] if len(run) == 1 else FusedTransformer(run))
            run.clear()

    for stage in flatten_chain(transformer):
        if isinstance(stage, Identity):
            continue  # no-op stage: fusing it would only add a call frame
        if stage.element_fn() is not None:
            run.append(stage)
        else:
            flush()
            stages.append(stage)
    flush()
    return stages or [Identity()]


# ------------------------------------------- per-sample randomness context
_sample_ctx = threading.local()


def current_sample_index() -> Optional[int]:
    """Index of the sample being transformed in the current thread, when the
    parallel engine (or an explicit :func:`sample_index_scope`) set one."""
    return getattr(_sample_ctx, "index", None)


def current_sample_rng_cache() -> Optional[dict]:
    """Per-(thread, sample) generator cache — one ``np.random.Generator`` per
    transformer instance per sample, so multiple draws inside one
    ``transform_feature`` advance ONE stream instead of re-deriving it."""
    return getattr(_sample_ctx, "cache", None)


@contextmanager
def sample_index_scope(index: int):
    """Tag the current thread's transform work with ``index`` (position in the
    epoch stream). Randomized transforms then derive their draws from
    (pipeline seed, index) — deterministic regardless of worker count."""
    prev_index = getattr(_sample_ctx, "index", None)
    prev_cache = getattr(_sample_ctx, "cache", None)
    _sample_ctx.index = int(index)
    _sample_ctx.cache = {}
    try:
        yield
    finally:
        _sample_ctx.index = prev_index
        _sample_ctx.cache = prev_cache
