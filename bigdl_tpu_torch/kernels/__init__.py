"""Hand-written CUDA kernels of the port, each beside its plain version.

| kernel | replaces (Pallas) | source |
| --- | --- | --- |
| ``layer_norm_fwd`` | ``bigdl_tpu/kernels/layernorm.py:31`` | ``csrc/layernorm.cu`` |
| ``flash_attention_fwd`` | ``bigdl_tpu/kernels/flash_attention.py:54`` | ``csrc/flash_attention.cu`` |

:func:`launch_counts` reads how often each kernel was launched since the
last :func:`reset_launch_counts`, which is how a run shows that its path
went through the kernels.
"""

from bigdl_tpu_torch.kernels import flash_attention as _flash
from bigdl_tpu_torch.kernels import layernorm as _layernorm
from bigdl_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_cuda, flash_attention_fwd,
    flash_attention_reference,
)
from bigdl_tpu_torch.kernels.layernorm import (
    fused_layer_norm, layer_norm_cuda, layer_norm_reference,
)

_COUNTERS = (_layernorm.launches, _flash.launches)


def launch_counts() -> dict:
    """``{kernel name: launches}`` since the last reset."""
    return {c.name: c.count for c in _COUNTERS}


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        c.reset()


__all__ = [
    "flash_attention", "flash_attention_cuda", "flash_attention_fwd",
    "flash_attention_reference", "fused_layer_norm", "launch_counts",
    "layer_norm_cuda", "layer_norm_reference", "reset_launch_counts",
]
