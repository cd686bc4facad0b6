"""Composable data transformers, serial.

Counterpart of ``bigdl_tpu/dataset/transformer.py``: a ``Transformer``
maps an iterator to an iterator and composes with ``>>``. The chain fusion
and per-sample randomness scopes of the parallel pipeline are not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator


class Transformer:
    """Base: override ``__call__`` mapping an iterator to an iterator."""

    def __call__(self, prev: Iterator) -> Iterator:
        raise NotImplementedError

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        """``a >> b``: the reference's ``a -> b`` composition."""
        return ChainedTransformer(self, other)

    def chain(self, other: "Transformer") -> "ChainedTransformer":
        return self >> other

    def apply(self, data: Iterable) -> Iterator:
        return self(iter(data))


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def __call__(self, prev: Iterator) -> Iterator:
        return self.second(self.first(prev))


class MapTransformer(Transformer):
    """Lift an element-wise function into a Transformer."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def __call__(self, prev: Iterator) -> Iterator:
        return (self.fn(x) for x in prev)


class Identity(Transformer):
    def __call__(self, prev: Iterator) -> Iterator:
        return prev
