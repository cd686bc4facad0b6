"""Torch-style ``Table`` activity: what ``ConcatTable`` emits and
``CAddTable`` consumes.

Counterpart of ``bigdl_tpu/utils/table.py`` without the JAX pytree
registration: keys are 1-based ints (Torch/Lua heritage) or strings, and
iteration is ints in order first, for determinism.
"""

from __future__ import annotations

from typing import Any, Iterator


class Table:
    """1-based int-keyed (plus string-keyed) container."""

    def __init__(self, *elements: Any, **named: Any) -> None:
        self._dict: dict[Any, Any] = {i + 1: e for i, e in enumerate(elements)}
        self._dict.update(named)

    def __getitem__(self, key: Any) -> Any:
        return self._dict[key]

    def __len__(self) -> int:
        return len(self._dict)

    def __iter__(self) -> Iterator[Any]:
        return iter(self.values())

    def keys(self) -> list:
        ints = sorted(k for k in self._dict if isinstance(k, int))
        others = sorted((k for k in self._dict if not isinstance(k, int)),
                        key=lambda k: (type(k).__name__, repr(k)))
        return ints + others

    def values(self) -> list:
        return [self._dict[k] for k in self.keys()]

    def items(self) -> list:
        return [(k, self._dict[k]) for k in self.keys()]

    def map(self, fn) -> "Table":
        """A Table of ``fn(value)`` under the same keys."""
        out = Table()
        out._dict = {k: fn(v) for k, v in self._dict.items()}
        return out

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}: {v!r}" for k, v in self.items())
        return f"T({{{inner}}})"


def T(*elements: Any, **named: Any) -> Table:
    """Builder mirroring the reference's ``T()`` helper."""
    return Table(*elements, **named)
