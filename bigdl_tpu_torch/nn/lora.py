"""LoRA: low-rank adaptation for fine-tuning.

Counterpart of ``bigdl_tpu/nn/lora.py``. Instead of updating a pretrained
weight ``W`` (out, in), train a rank-``r`` residual ``B @ A`` (``A`` (r,
in), ``B`` (out, r)): ``out = x Wᵀ + (x Aᵀ) Bᵀ · α/r``. The base is frozen
through the gradient scales (:meth:`LoRALinear.grad_scales`: 0 for the
base, ``scale_w`` for the adapters), so the trainer detaches it before the
forward (no weight-gradient product of the base is computed) and trims its
optimizer slots to 0-size tensors (``optim/optim_method.py``).

:func:`apply_lora` swaps every ``nn.Linear`` of a module tree (containers
and Graph nodes) for a :class:`LoRALinear` carrying the original weights
and adds adapters to every ``MultiHeadAttention`` in place
(``MultiHeadAttention.add_lora``); :func:`merge_lora` bakes ``W + BA·α/r``
back into plain layers. The parameter keys are JAX's (``lora_a``,
``lora_b``; the attention's ``lora_<weight>_a``/``_b``), so
``convert.load_jax_params`` moves an adapted tree by path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import (
    AbstractModule, Container, TensorModule,
)
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.graph import Graph
from bigdl_tpu_torch.nn.initialization import RandomNormal
from bigdl_tpu_torch.nn.linear import Linear, normalize_linear_input
from bigdl_tpu_torch.nn.precision import promote


class LoRALinear(TensorModule):
    """A Linear whose base weights are frozen and whose update lives in a
    trainable rank-``rank`` residual. Built by :meth:`from_linear`; at init
    ``B`` is zero, so the adapter is the identity of the base."""

    def __init__(self, input_size: int, output_size: int, rank: int,
                 alpha: Optional[float] = None, with_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank!r}")
        self.input_size, self.output_size = int(input_size), int(output_size)
        self.rank = int(rank)
        self.alpha = float(alpha) if alpha is not None else float(rank)
        self.weight = torch.nn.Parameter(
            torch.zeros(self.output_size, self.input_size))
        # A gaussian, B zero: the adapter starts as the identity of the base
        self.lora_a = torch.nn.Parameter(RandomNormal(0.0, 0.02).init(
            (self.rank, self.input_size), fan_in=self.input_size,
            fan_out=self.rank, generator=generator))
        self.lora_b = torch.nn.Parameter(
            torch.zeros(self.output_size, self.rank))
        self.bias = (torch.nn.Parameter(torch.zeros(self.output_size))
                     if with_bias else None)

    @property
    def with_bias(self) -> bool:
        return self.bias is not None

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    @classmethod
    def from_linear(cls, lin: Linear, rank: int,
                    alpha: Optional[float] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> "LoRALinear":
        """The adapter of ``lin``: its weight and bias (copied), on its
        device and in its dtype."""
        m = cls(lin.input_size, lin.output_size, rank, alpha,
                with_bias=lin.with_bias, generator=generator)
        m.to(device=lin.weight.device, dtype=lin.weight.dtype)
        with torch.no_grad():
            m.weight.copy_(lin.weight)
            if lin.bias is not None:
                m.bias.copy_(lin.bias)
        m.set_name(lin.name)
        return m

    def grad_scales(self) -> dict:
        # the base weight and bias are frozen; only the adapter trains
        # (a whole-module freeze() still wins)
        return {k: 0.0 if self._frozen or not k.startswith("lora")
                else self.scale_w
                for k, _ in self.named_parameters(recurse=False)}

    def merged_weight(self) -> torch.Tensor:
        return self.weight + self.lora_b @ self.lora_a * self.scaling

    def run(self, input, state=None):
        x, restore = normalize_linear_input(input)
        x, w, a, b = promote(x, self.weight, self.lora_a, self.lora_b)
        out = F.linear(x, w) + F.linear(F.linear(x, a), b) * self.scaling
        if self.bias is not None:
            out = out + self.bias
        return restore(out), state

    def to_linear(self) -> Linear:
        """Bake the adapter into a plain Linear (the serving form)."""
        lin = Linear(self.input_size, self.output_size,
                     with_bias=self.with_bias)
        lin.to(device=self.weight.device, dtype=self.weight.dtype)
        with torch.no_grad():
            lin.weight.copy_(self.merged_weight())
            if self.bias is not None:
                lin.bias.copy_(self.bias)
        lin.set_name(self.name)
        return lin

    def extra_repr(self):
        return (f"{self.input_size} -> {self.output_size}, rank={self.rank}, "
                f"alpha={self.alpha}")


def _swap_modules(root: AbstractModule, replace) -> int:
    """Walk the container and Graph tree, calling ``replace(m)`` on every
    module below ``root``; a non-None return takes ``m``'s place. Returns
    the count of swaps."""
    count = 0

    def walk(m):
        nonlocal count
        if isinstance(m, Graph):
            for node in m.exec_nodes:
                new = replace(node.module)
                if new is not None:
                    node.module = new
                    m._modules[m._child_name[node.id]] = new
                    count += 1
                else:
                    walk(node.module)
        elif isinstance(m, Container):
            for name, c in list(m._modules.items()):
                new = replace(c)
                if new is not None:
                    m._modules[name] = new
                    count += 1
                else:
                    walk(c)

    walk(root)
    return count


def _adaptable_attention(m) -> bool:
    return isinstance(m, MultiHeadAttention) and not m.lora_rank


def apply_lora(model: AbstractModule, rank: int,
               alpha: Optional[float] = None, freeze_rest: bool = True,
               generator: Optional[torch.Generator] = None) -> int:
    """Swap every ``nn.Linear`` under ``model`` for a :class:`LoRALinear`
    carrying its (now frozen) weights and add adapters to every
    ``MultiHeadAttention`` that has none. Returns the count of adapted
    modules. ``freeze_rest=True`` (the LoRA convention) freezes every other
    module too (norms, embeddings, ...), so only the adapters train.
    Nothing changes when nothing can be adapted (``ValueError``). The
    adapters' ``A`` are drawn from ``generator``, in tree order."""
    if type(model) is Linear:
        raise ValueError(
            "apply_lora cannot swap a bare nn.Linear root in place: use "
            "LoRALinear.from_linear(model, rank) directly")
    found = []

    def probe(m):
        if type(m) is Linear or _adaptable_attention(m):
            found.append(m)
        return None

    _swap_modules(model, probe)
    if _adaptable_attention(model):
        found.append(model)
    if not found:
        raise ValueError(
            "apply_lora found no nn.Linear or MultiHeadAttention to adapt")
    if freeze_rest:
        model.freeze()
    n = 0

    def adapt(m):
        nonlocal n
        if type(m) is Linear:
            n += 1
            return LoRALinear.from_linear(m, rank, alpha, generator)
        if _adaptable_attention(m):
            # in place: freeze_rest froze it; grad_scales then freezes
            # its base leaves only
            m.unfreeze()
            m.add_lora(rank, alpha, generator=generator)
            n += 1
        return None

    adapt(model)            # the root itself may be an adaptable attention
    _swap_modules(model, adapt)
    return n


def merge_lora(model: AbstractModule) -> int:
    """Bake every adapter under ``model`` into its base (merged forward ==
    adapted forward): each :class:`LoRALinear` becomes a plain Linear and
    each adapted attention drops its adapters. Returns the merge count."""
    if isinstance(model, LoRALinear):
        raise ValueError(
            "merge_lora cannot swap a bare LoRALinear root in place: use "
            "model.to_linear() directly")
    n = 0

    def merge(m):
        nonlocal n
        if isinstance(m, LoRALinear):
            n += 1
            return m.to_linear()
        if isinstance(m, MultiHeadAttention) and m.lora_rank:
            m.merge_lora()
            n += 1
        return None

    merge(model)            # the root itself may be an adapted attention
    _swap_modules(model, merge)
    return n
