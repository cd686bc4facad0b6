"""DataSet abstraction, in memory.

Counterpart of ``bigdl_tpu/dataset/dataset.py`` for ``LocalDataSet``,
``TransformedDataSet`` and ``DataSet.array``. ``shuffle()`` draws one
permutation from the port's ``RandomGenerator`` and composes it with the
current order, as the JAX package does, so one seed gives the same epoch
orders in both. ``TransformedDataSet.data`` runs its transformer chain
serially, or through the parallel transform engine
(``dataset/parallel.py``) when ``BIGDL_DATA_WORKERS`` asks for workers.
The distributed marker and the on-disk sources are not ported (ROADMAP
Queue A.6 and A.4.2).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.utils.random_generator import RandomGenerator


class AbstractDataSet:
    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        raise NotImplementedError

    def data(self, train: bool) -> Iterator:
        """One pass over the (transformed) data; the trainer loops epochs."""
        raise NotImplementedError

    def transform(self, transformer: Transformer) -> "AbstractDataSet":
        return TransformedDataSet(self, transformer)

    def __rshift__(self, transformer: Transformer) -> "AbstractDataSet":
        """``dataset >> transformer``: the reference's
        ``dataset -> transformer``."""
        return self.transform(transformer)


class LocalDataSet(AbstractDataSet):
    def __init__(self, data: Sequence):
        self._data = list(data)
        self._order = np.arange(len(self._data))

    def size(self) -> int:
        return len(self._data)

    def shuffle(self) -> None:
        perm = RandomGenerator.numpy().permutation(len(self._data))
        self._order = self._order[perm]

    def data(self, train: bool) -> Iterator:
        for i in self._order:
            yield self._data[i]


class TransformedDataSet(AbstractDataSet):
    """Dataset + transformer chain. ``data()`` routes through the parallel
    transform engine when ``BIGDL_DATA_WORKERS`` > 0: the whole
    TransformedDataSet spine is collapsed into one chain, consecutive
    element-wise stages fuse into single per-sample callables, and each fused
    run executes across a bounded worker pool with ordered delivery and
    per-sample deterministic randomness (``dataset/parallel.py``). With the
    knob unset (0), the serial generator chain runs unchanged."""

    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer
        self._plan = None  # (workers, base, stages): pools persist across epochs

    def size(self) -> int:
        return self.base.size()

    def shuffle(self) -> None:
        self.base.shuffle()

    def _chain(self):
        """(innermost base, [transformers outward-in order]) — `ds >> a >> b`
        nests TransformedDataSets one transformer deep, so the whole spine
        must be gathered before fusion can see the full chain."""
        transformers, ds = [], self
        while isinstance(ds, TransformedDataSet):
            transformers.append(ds.transformer)
            ds = ds.base
        return ds, list(reversed(transformers))

    def data(self, train: bool) -> Iterator:
        from bigdl_tpu_torch.dataset.parallel import data_workers, plan_stages
        workers = data_workers()
        if workers <= 0:
            return self.transformer(self.base.data(train))
        if self._plan is None or self._plan[0] != workers:
            base, chain = self._chain()
            self._plan = (workers, base, plan_stages(chain, workers))
        _, base, stages = self._plan
        it = base.data(train)
        for stage in stages:
            it = stage(it)
        return it


class DataSet:
    """Factory namespace (reference ``DataSet.array``)."""

    @staticmethod
    def array(data: Iterable) -> AbstractDataSet:
        return LocalDataSet(list(data))
