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

Every instance keeps its constructor arguments as ``_init_args``
(:class:`RecordsInit`, JAX's metaclass, without the port-only
``generator``/``dropout_generator``/``device``), from which the portable
serializer (``utils/serializer.py``) rebuilds it. ``save`` pickles a module
(``utils/file.py``), ``save_module`` writes the portable format, and
``load``/``load_module`` read either, sniffing the format, as JAX's do.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch

Activity = Any  # a tensor or a Table

#: constructor arguments of the port that JAX's modules do not take
_PORT_ONLY_KWARGS = frozenset({"generator", "dropout_generator", "device"})


class RecordsInit(type):
    """Metaclass recording the constructor arguments of every instance as
    ``_init_args = (args, kwargs)`` (JAX's ``RecordsInit``), the port-only
    keyword arguments left out."""

    def __call__(cls, *args, **kwargs):
        obj = super().__call__(*args, **kwargs)
        if "_init_args" not in obj.__dict__:
            obj.__dict__["_init_args"] = (
                args, {k: v for k, v in kwargs.items()
                       if k not in _PORT_ONLY_KWARGS})
        return obj


class AbstractModule(torch.nn.Module, metaclass=RecordsInit):
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

    # serialization: ``save`` pickles (fast, in-version), ``save_module``
    # writes the portable format; ``load`` sniffs which it reads
    def save(self, path: str, overwrite: bool = True) -> "AbstractModule":
        """Persist this module via pickle (reference ``Module.save``)."""
        from bigdl_tpu_torch.utils import file as _file
        _file.save(self, path, overwrite=overwrite)
        return self

    def save_module(self, path: str, overwrite: bool = True
                    ) -> "AbstractModule":
        """Persist in the portable versioned format (reference
        ``saveModule``), readable by the JAX package."""
        from bigdl_tpu_torch.utils import serializer
        serializer.save_module(self, path, overwrite=overwrite)
        return self

    @staticmethod
    def load(path: str, device=None) -> "AbstractModule":
        """Read a module in either format onto ``device`` (default the
        card)."""
        from bigdl_tpu_torch.utils import file as _file
        from bigdl_tpu_torch.utils import serializer
        from bigdl_tpu_torch.utils.device import resolve_device
        if serializer.is_portable_file(path):
            obj = serializer.load_module(path, device)
        else:
            obj = _file.load(path)
        if not isinstance(obj, AbstractModule):
            raise TypeError(f"{path} does not contain a module "
                            f"(got {type(obj)})")
        return obj.to(resolve_device(device))

    load_module = load  # reference ``Module.loadModule`` alias

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

    def quantize(self, mode: str = "dynamic") -> "AbstractModule":
        """An int8 copy for inference (``nn/quantized.py``): Linear and
        the spatial convolutions become int8-weight modules; ``mode`` is
        "dynamic", "weight_only" or "static" (then ``nn.calibrate``)."""
        from bigdl_tpu_torch.nn.quantized import quantize_module
        return quantize_module(self, mode)

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
