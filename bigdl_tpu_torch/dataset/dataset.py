"""DataSet abstraction, serial and in memory.

Counterpart of ``bigdl_tpu/dataset/dataset.py`` for ``LocalDataSet``,
``TransformedDataSet`` and ``DataSet.array``. ``shuffle()`` draws one
permutation from the port's ``RandomGenerator`` and composes it with the
current order, as the JAX package does, so one seed gives the same epoch
orders in both. The parallel transform engine, the distributed marker and
the on-disk sources are not ported.
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
    """A dataset and one transformer applied serially to its stream."""

    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def size(self) -> int:
        return self.base.size()

    def shuffle(self) -> None:
        self.base.shuffle()

    def data(self, train: bool) -> Iterator:
        return self.transformer(self.base.data(train))


class DataSet:
    """Factory namespace (reference ``DataSet.array``)."""

    @staticmethod
    def array(data: Iterable) -> AbstractDataSet:
        return LocalDataSet(list(data))
