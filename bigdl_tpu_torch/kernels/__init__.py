"""Hand-written CUDA kernels of the port, each beside its plain version.

| kernel | replaces (Pallas) | source |
| --- | --- | --- |
| ``layer_norm_fwd`` | ``bigdl_tpu/kernels/layernorm.py:31`` | ``csrc/layernorm.cu`` |
| ``layer_norm_bwd`` | ``bigdl_tpu/kernels/layernorm.py:99`` (``_fln_bwd``, plain jnp) | ``csrc/layernorm.cu`` |
| ``flash_attention_fwd`` | ``bigdl_tpu/kernels/flash_attention.py:54`` | ``csrc/flash_attention.cu`` |
| ``flash_attention_bwd_dq`` | ``bigdl_tpu/kernels/flash_attention.py:132`` | ``csrc/flash_attention_bwd.cu`` |
| ``flash_attention_bwd_dkv`` | ``bigdl_tpu/kernels/flash_attention.py:199`` | ``csrc/flash_attention_bwd.cu`` |

``conv_bn.py`` (``FusedConvBNReLU``) is JAX's XLA-level conv-BN fusion,
ported as a torch module, not a kernel.

:func:`launch_counts` reads how often each kernel was launched since the
last :func:`reset_launch_counts`, which is how a run shows that its path
went through the kernels; :func:`launch_counts_by_dtype` splits the counts
by the launches' dtypes.
"""

from bigdl_tpu_torch.kernels import flash_attention as _flash
from bigdl_tpu_torch.kernels import layernorm as _layernorm
from bigdl_tpu_torch.kernels.flash_attention import (
    FlashAttention, backward_launch_plan, flash_attention, flash_attention_bwd,
    flash_attention_bwd_cuda, flash_attention_bwd_dkv_cuda,
    flash_attention_bwd_dq_cuda, flash_attention_bwd_reference,
    flash_attention_cuda, flash_attention_fwd, flash_attention_reference,
    forward_launch_plan,
)
from bigdl_tpu_torch.kernels.layernorm import (
    LayerNormFunction, fused_layer_norm, layer_norm_backward,
    layer_norm_bwd_cuda, layer_norm_cuda, layer_norm_reference,
)

_COUNTERS = (_layernorm.launches, _layernorm.bwd_launches, _flash.launches,
             _flash.bwd_dq_launches, _flash.bwd_dkv_launches)


def launch_counts() -> dict:
    """``{kernel name: launches}`` since the last reset."""
    return {c.name: c.count for c in _COUNTERS}


def launch_counts_by_dtype() -> dict:
    """``{kernel name: {dtypes: launches}}`` since the last reset: the
    operands' dtype for the flash kernels, ``"x/gamma"`` for LayerNorm."""
    return {c.name: c.by_dtype for c in _COUNTERS}


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        c.reset()


__all__ = [
    "FlashAttention", "LayerNormFunction", "backward_launch_plan",
    "flash_attention",
    "flash_attention_bwd", "flash_attention_bwd_cuda",
    "flash_attention_bwd_dkv_cuda", "flash_attention_bwd_dq_cuda",
    "flash_attention_bwd_reference", "flash_attention_cuda",
    "flash_attention_fwd", "flash_attention_reference", "forward_launch_plan",
    "fused_layer_norm",
    "launch_counts", "launch_counts_by_dtype", "layer_norm_backward",
    "layer_norm_bwd_cuda",
    "layer_norm_cuda", "layer_norm_reference", "reset_launch_counts",
]
