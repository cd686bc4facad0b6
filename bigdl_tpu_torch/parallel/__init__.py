"""Attention helpers outside any kernel (single device so far)."""

from bigdl_tpu_torch.parallel.ring_attention import full_attention

__all__ = ["full_attention"]
