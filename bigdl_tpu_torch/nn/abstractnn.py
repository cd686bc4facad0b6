"""Module core of the port: ``torch.nn.Module`` with the JAX package's
explicit-state call.

Counterpart of ``bigdl_tpu/nn/abstractnn.py``. JAX's functional core is
``apply(params, state, input) -> (output, new_state)``. Here the parameters
live on the module, as PyTorch has them, and the state stays explicit:

- ``run(input, state)`` returns ``(output, new_state)``. ``state`` is
  ``None`` for a plain forward, or a nested dict keyed like the module tree
  (child names ``"0"``, ``"1"``, ...), the form ``install_decode_cache``
  builds for the KV-cached path;
- ``forward(input)`` is ``run(input, None)[0]``.

Containers register their children under ``"0"``, ``"1"``, ... so
``named_parameters()`` paths equal the JAX ``get_params()`` tree paths
(``set_name`` changes the display name only, as in JAX), which is what
``bigdl_tpu_torch.convert.load_jax_params`` relies on.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

Activity = Any  # a tensor or a Table


class AbstractModule(torch.nn.Module):
    """Base class of all layers and containers."""

    def __init__(self) -> None:
        super().__init__()
        self.name = type(self).__name__

    def run(self, input: Activity, state: Optional[dict] = None):
        """The call with explicit state. Override in subclasses."""
        raise NotImplementedError

    def forward(self, input: Activity) -> Activity:
        return self.run(input, None)[0]

    def set_name(self, name: str) -> "AbstractModule":
        self.name = name
        return self

    def evaluate(self) -> "AbstractModule":
        """Switch to eval mode (Torch/BigDL parity)."""
        self.eval()
        return self


class TensorModule(AbstractModule):
    """Module whose input and output are single tensors."""


class Container(AbstractModule):
    """Base for composite modules: children are named by their index."""

    def __init__(self, *modules: AbstractModule) -> None:
        super().__init__()
        for m in modules:
            self.add(m)

    def add(self, module: AbstractModule) -> "Container":
        self.add_module(str(len(self._modules)), module)
        return self

    def __getitem__(self, i: int) -> AbstractModule:
        return self._modules[str(i)]


def child_state(state: Optional[dict], name: str) -> Optional[dict]:
    """The part of a nested state that belongs to child ``name``."""
    return None if state is None else state.get(name)
