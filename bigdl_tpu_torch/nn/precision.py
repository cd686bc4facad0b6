"""Mixed-precision policy: compute in the engine's dtype, fp32 masters.

Counterpart of ``bigdl_tpu/nn/precision.py``. Under
``Engine.init(compute_dtype=torch.bfloat16)`` (or
``BIGDL_COMPUTE_DTYPE=bf16``) the trainer keeps fp32 master parameters and,
inside each step, casts every floating parameter (LayerNorm's gamma and
beta included) and every floating input to bf16, runs the model on the
cast parameters, and casts the output back to fp32 before the criterion (a
``Table`` too: ``FusedLMHead`` hands the criterion hidden, weight and
bias). The casts' backward returns fp32 gradients, so clipping and the
update run in fp32 on the masters. LogSoftMax and the attention softmax
statistics stay fp32 islands; there is no loss scaling (bf16 has fp32's
exponent range). ``torch.autocast`` is not used: its per-op lists are not
this policy.

JAX promotes mixed operands of a product (``jnp.matmul`` of an fp32
activation and a bf16 weight computes in fp32); ``torch.matmul`` and
``F.linear`` refuse them, so the layers whose operands can differ under
the policy (``Linear``, the recurrent cells) cast them with
:func:`promote` first.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.utils.table import Table


def cast_floating(tree, dtype: torch.dtype):
    """Cast every floating tensor of ``tree`` (a tensor, or a dict, list,
    tuple or ``Table`` of them, nested: JAX maps over every pytree, and
    ``Table`` is one) to ``dtype``; integer and bool tensors, and anything
    that is not a tensor, pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, Table):
        return tree.map(lambda v: cast_floating(v, dtype))
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree


def promote(*tensors: torch.Tensor) -> tuple:
    """The tensors cast to their common dtype by JAX's and torch's rule for
    floating operands (bf16 with fp32 gives fp32), so a product of mixed
    operands computes as JAX computes it; tensors of that dtype already
    pass through uncast."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t if t.dtype == dtype else t.to(dtype) for t in tensors)
