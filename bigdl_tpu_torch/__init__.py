"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu`` for NVIDIA Hopper.

The JAX package ``bigdl_tpu`` stays the reference; this package mirrors its
layout (``nn``, ``kernels``, ``models/transformerlm``, ``serving``,
``utils``) and never imports it or JAX. Every Pallas kernel on a ported
path is a hand-written CUDA kernel here (``kernels/csrc``), built at first
use. Entry points run on the GPU unless the caller passes ``device="cpu"``.

Ported so far: the serving path of the TransformerLM (continuous-batching
``serving.ServingEngine`` over the KV-cached decode) and its full-sequence
forward, with the LayerNorm and flash-attention forward kernels.
"""

__version__ = "0.1.0"
