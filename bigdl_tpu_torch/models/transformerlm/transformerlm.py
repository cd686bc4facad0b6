"""Decoder-only Transformer language model.

Counterpart of ``bigdl_tpu/models/transformerlm/transformerlm.py``, with
every option of the JAX constructor (LoRA adapts a built model through
``nn.apply_lora``): token
embedding, a learned position embedding or RoPE, pre-norm blocks
(``x + MHA(N(x))``; ``x + MLP(N(x))``, each residual the
``ConcatTable(Identity, branch) >> CAddTable`` idiom, N LayerNorm or
RMSNorm, the MLP GELU or SwiGLU, the attention full or grouped-query,
optional dropout), a final norm and a ``TimeDistributed`` Linear +
LogSoftMax head or the ``FusedLMHead``; :func:`lm_criterion` is its
training loss. Built from the same layers in the same order as the JAX
model, so its parameter paths equal the JAX ``get_params()`` paths.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.initialization import RandomNormal
from bigdl_tpu_torch.utils.device import resolve_device


class PositionEmbedding(TensorModule):
    """Learned absolute position embedding added to (N, T, E) inputs."""

    def __init__(self, max_len: int, embed_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_len, self.embed_dim = max_len, embed_dim
        self.pos = torch.nn.Parameter(RandomNormal(0.0, 0.02).init(
            (max_len, embed_dim), fan_in=embed_dim, fan_out=embed_dim,
            generator=generator))

    def run(self, input, state=None):
        t = input.shape[1]
        if state is not None and "pos_idx" in state:
            # cached decode: the next t positions of every row, each at its
            # own depth. An idle serving row's index may run past the table;
            # it is clamped (JAX fills NaN there) and its output is unused.
            # The index advances in place, as the attention's positions do.
            idx = state["pos_idx"]
            pp = idx[:, None] + torch.arange(t, device=idx.device)[None, :]
            pp = pp.clamp(max=self.max_len - 1)
            out = input + self.pos[pp]
            return out, {"pos_idx": idx.add_(t)}
        if t > self.max_len:
            raise ValueError(f"sequence length {t} > max_len {self.max_len}")
        return input + self.pos[None, :t], state


def _residual(inner: nn.AbstractModule) -> nn.Sequential:
    return (nn.Sequential()
            .add(nn.ConcatTable().add(nn.Identity()).add(inner))
            .add(nn.CAddTable()))


def TransformerBlock(embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                     dropout: float = 0.0, attention_impl: str = "auto",
                     causal: bool = True, num_kv_heads=None,
                     rope: bool = False, norm: str = "layer",
                     mlp_kind: str = "gelu",
                     generator: Optional[torch.Generator] = None
                     ) -> nn.Sequential:
    if norm not in ("layer", "rms"):
        raise ValueError(f"norm must be layer|rms, got {norm!r}")
    if mlp_kind not in ("gelu", "swiglu"):
        raise ValueError(f"mlp_kind must be gelu|swiglu, got {mlp_kind!r}")
    norm_layer = nn.RMSNorm if norm == "rms" else nn.LayerNorm

    def linear(n_in, n_out):
        return nn.TimeDistributed(nn.Linear(n_in, n_out, generator=generator))

    attn = nn.Sequential().add(norm_layer(embed_dim)).add(
        nn.MultiHeadAttention(embed_dim, num_heads, causal=causal,
                              attention_impl=attention_impl,
                              num_kv_heads=num_kv_heads, rope=rope,
                              generator=generator))
    hidden = mlp_ratio * embed_dim
    mlp = nn.Sequential().add(norm_layer(embed_dim))
    if mlp_kind == "swiglu":
        # (silu(x W_gate) * (x W_up)) W_down: ConcatTable >> CMulTable
        mlp.add(nn.ConcatTable()
                .add(nn.Sequential().add(linear(embed_dim, hidden))
                     .add(nn.Swish()))
                .add(linear(embed_dim, hidden)))
        mlp.add(nn.CMulTable())
    else:
        mlp.add(linear(embed_dim, hidden)).add(nn.GELU())
    mlp.add(linear(hidden, embed_dim))
    if dropout > 0:
        attn.add(nn.Dropout(dropout))
        mlp.add(nn.Dropout(dropout))
    return nn.Sequential().add(_residual(attn)).add(_residual(mlp))


def TransformerLM(vocab_size: int, embed_dim: int = 256, num_heads: int = 4,
                  num_layers: int = 4, max_len: int = 1024,
                  mlp_ratio: int = 4, dropout: float = 0.0,
                  remat: bool = False, attention_impl: str = "auto",
                  fused_head: bool = False, num_kv_heads=None,
                  position: str = "learned", norm: str = "layer",
                  mlp_kind: str = "gelu", *,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> nn.Sequential:
    """Token ids (N, T) → per-position log-probs (N, T, vocab).

    ``fused_head=True`` swaps the ``Linear >> LogSoftMax`` decoder for
    :class:`~bigdl_tpu_torch.nn.FusedLMHead`: training streams the loss over
    vocab chunks (pair with ``lm_criterion(fused_head=True)``), eval output
    stays per-position log-probs. ``position="rope"`` replaces the learned
    table with rotary embeddings inside every attention; ``num_kv_heads``
    makes the attention grouped-query; ``norm="rms"`` and
    ``mlp_kind="swiglu"`` give the llama-style block; ``dropout`` adds a
    Dropout after each block's attention and MLP.

    ``remat=True`` wraps every block in :class:`~bigdl_tpu_torch.nn.Remat`
    (its activations recomputed in the backward), as JAX does, which adds
    a ``"0"`` level to the block's parameter paths. Weights are drawn on the
    CPU from ``generator`` (PyTorch's default generator when None), so a
    seed gives the same model on every device, and the model is then moved
    to ``device`` (default ``"cuda"``)."""
    if position not in ("learned", "rope"):
        raise ValueError(f"position must be learned|rope, got {position!r}")
    dev = resolve_device(device)
    model = (nn.Sequential()
             .add(nn.LookupTable(vocab_size, embed_dim, zero_based=True,
                                 generator=generator)
                  .set_name("embedding")))
    if position == "learned":
        model.add(PositionEmbedding(max_len, embed_dim, generator=generator)
                  .set_name("pos"))
    for i in range(num_layers):
        block = TransformerBlock(embed_dim, num_heads, mlp_ratio, dropout,
                                 attention_impl, num_kv_heads=num_kv_heads,
                                 rope=position == "rope", norm=norm,
                                 mlp_kind=mlp_kind, generator=generator)
        if remat:
            block = nn.Remat(block)
        model.add(block.set_name(f"block{i + 1}"))
    final_norm = nn.RMSNorm if norm == "rms" else nn.LayerNorm
    model.add(final_norm(embed_dim).set_name("final_norm"))
    if fused_head:
        model.add(nn.FusedLMHead(embed_dim, vocab_size, eval_log_probs=True,
                                 generator=generator).set_name("decoder"))
    else:
        model.add(nn.TimeDistributed(nn.Linear(embed_dim, vocab_size,
                                               generator=generator))
                  .set_name("decoder"))
        model.add(nn.TimeDistributed(nn.LogSoftMax()))
    return model.to(dev)


def lm_criterion(fused_head: bool = False, chunk_size: int = 8192):
    """The training criterion matching :func:`TransformerLM`'s head: the
    per-position NLL of the log-probs averaged over batch and time, or
    (``fused_head``) the chunked softmax cross-entropy over the head's
    ``Table(hidden, weight, bias)``, averaged over valid tokens."""
    if fused_head:
        return nn.ChunkedSoftmaxCrossEntropy(chunk_size=chunk_size)
    return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)


from bigdl_tpu_torch.utils.serializer import register as _register  # noqa: E402

_register(PositionEmbedding)
