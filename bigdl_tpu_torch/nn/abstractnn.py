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

The training knobs of JAX's module are here too, and act in the trainer's
step (``optim/optimizer.py``): per-layer gradient multipliers
(``set_scale_w``/``set_scale_b``, read through :meth:`grad_scales`),
``freeze``/``unfreeze`` (a frozen parameter gets no gradient and no
optimizer slots), and the weight regularizers a layer was built with
(:meth:`regularizer_penalty`, added to the loss). On a container each call
reaches the whole subtree, as in JAX.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch

Activity = Any  # a tensor or a Table


class AbstractModule(torch.nn.Module):
    """Base class of all layers and containers."""

    scale_w: float = 1.0
    scale_b: float = 1.0
    _frozen: bool = False

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

    def inputs(self, *nodes):
        """Torch-style node wiring: ``layer.inputs(nodeA, nodeB)`` returns a
        graph ``ModuleNode`` wrapping this layer with the given predecessor
        nodes (``nn/graph.py``)."""
        from bigdl_tpu_torch.nn.graph import make_node
        return make_node(self, nodes)

    def evaluate(self) -> "AbstractModule":
        """Switch to eval mode (Torch/BigDL parity)."""
        self.eval()
        return self

    # per-layer gradient multipliers (reference setScaleW/setScaleB), set
    # on the whole subtree
    def set_scale_w(self, scale: float) -> "AbstractModule":
        self.scale_w = float(scale)
        for m in self.children():
            m.set_scale_w(scale)
        return self

    def set_scale_b(self, scale: float) -> "AbstractModule":
        self.scale_b = float(scale)
        for m in self.children():
            m.set_scale_b(scale)
        return self

    def grad_scales(self) -> dict:
        """``{parameter path: gradient multiplier}``, keyed and ordered as
        ``named_parameters()``: bias-like parameters get ``scale_b``, the
        others ``scale_w``, and a frozen module's parameters 0."""
        out = {k: 0.0 if self._frozen else
               (self.scale_b if "bias" in k else self.scale_w)
               for k, _ in self.named_parameters(recurse=False)}
        for name, m in self.named_children():
            out.update({f"{name}.{k}": v for k, v in m.grad_scales().items()})
        return out

    def freeze(self) -> "AbstractModule":
        """Exclude this subtree's parameters from training: the step
        computes no gradient for them and the optimizer keeps no slots."""
        self._frozen = True
        for m in self.children():
            m.freeze()
        return self

    def unfreeze(self) -> "AbstractModule":
        self._frozen = False
        for m in self.children():
            m.unfreeze()
        return self

    def is_frozen(self) -> bool:
        return self._frozen

    def has_regularizers(self) -> bool:
        return any(getattr(m, "w_regularizer", None) is not None
                   or getattr(m, "b_regularizer", None) is not None
                   for m in self.modules())

    def regularizer_penalty(self, params: Optional[dict] = None):
        """fp32 scalar: the sum of every attached regularizer's penalty
        (``optim/regularizer.py``) over its layer's parameters, bias-like
        ones under ``b_regularizer`` and the others under ``w_regularizer``.
        ``params`` maps parameter paths (as ``named_parameters()``) to the
        tensors to penalize (the step's cast parameters); None means the
        module's own."""
        total = None      # made on the parameters' device: no host copy
        for prefix, m in self.named_modules():
            w_reg = getattr(m, "w_regularizer", None)
            b_reg = getattr(m, "b_regularizer", None)
            if w_reg is None and b_reg is None:
                continue
            for k, p in m.named_parameters(recurse=False):
                reg = b_reg if "bias" in k else w_reg
                if reg is None:
                    continue
                if params is not None:
                    p = params[f"{prefix}.{k}" if prefix else k]
                if total is None:
                    total = torch.zeros((), dtype=torch.float32,
                                        device=p.device)
                total = total + reg.penalty(p)
        return torch.zeros((), dtype=torch.float32) if total is None \
            else total


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


@contextlib.contextmanager
def evaluating(module: torch.nn.Module):
    """Run ``module`` in eval mode inside the block (JAX passes
    ``training=False`` to the decode and search paths), then give every
    submodule back the mode it had."""
    modes = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        yield module
    finally:
        for m, mode in modes:
            m.training = mode


def child_state(state: Optional[dict], name: str) -> Optional[dict]:
    """The part of a nested state that belongs to child ``name``."""
    return None if state is None else state.get(name)
