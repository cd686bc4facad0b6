"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu`` for NVIDIA Hopper.

The JAX package ``bigdl_tpu`` stays the reference; this package mirrors its
layout (``nn``, ``kernels``, ``models``, ``serving``, ``optim``,
``dataset``, ``utils``) and never imports it or JAX. Every Pallas kernel on a ported
path is a hand-written CUDA kernel here (``kernels/csrc``), built at first
use. Entry points run on the GPU unless the caller passes ``device="cpu"``.

Ported so far: the serving path of the TransformerLM (continuous-batching
``serving.ServingEngine`` over the KV-cached decode) and its full-sequence
forward, with the LayerNorm and flash-attention forward kernels; and its
training step (``optim.LocalOptimizer`` over the ``dataset`` host path),
with the two flash-attention backward kernels; bf16 mixed precision and
the single-device optimizer; both as captured CUDA graphs; and every
TransformerLM option but LoRA (grouped-query heads, RoPE, RMSNorm +
SwiGLU, dropout, the fused LM head, sliding windows, beam search); and
the vision zoo's training path (convolution, pooling, batch norm with
running statistics, the NHWC layout, the conv-BN fold, ResNet, LeNet-5,
VGG, Top-1/Top-5 validation on the card), whose convolutions are cuDNN's;
the serving extras (paged KV cache, prefix pool, speculative decoding,
deadlines and overload control); and the trainer's robustness: checkpoints
either package resumes, preemption, NaN rollback and retries, the numerics
check, profiling, summaries, Plateau's hook, ``Evaluator``/``Predictor``.
All four Pallas kernels of the JAX package have a CUDA counterpart.
"""

__version__ = "0.1.0"
