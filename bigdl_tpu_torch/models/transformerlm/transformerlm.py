"""Decoder-only Transformer language model.

Counterpart of ``bigdl_tpu/models/transformerlm/transformerlm.py`` for
``norm="layer"``, ``mlp_kind="gelu"`` and ``position="learned"``: token
embedding, learned position embedding, pre-LN blocks
(``x + MHA(LN(x))``; ``x + MLP(LN(x))``, each residual the
``ConcatTable(Identity, branch) >> CAddTable`` idiom), a final LayerNorm
and a ``TimeDistributed`` Linear + LogSoftMax head; :func:`lm_criterion`
is its training loss. Built from the same
layers in the same order as the JAX model, so its parameter paths equal
the JAX ``get_params()`` paths.
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
            idx = state["pos_idx"]
            pp = idx[:, None] + torch.arange(t, device=idx.device)[None, :]
            pp = pp.clamp(max=self.max_len - 1)
            return input + self.pos[pp], {"pos_idx": idx + t}
        if t > self.max_len:
            raise ValueError(f"sequence length {t} > max_len {self.max_len}")
        return input + self.pos[None, :t], state


def _residual(inner: nn.AbstractModule) -> nn.Sequential:
    return (nn.Sequential()
            .add(nn.ConcatTable().add(nn.Identity()).add(inner))
            .add(nn.CAddTable()))


def TransformerBlock(embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                     attention_impl: str = "auto", causal: bool = True,
                     generator: Optional[torch.Generator] = None
                     ) -> nn.Sequential:
    attn = nn.Sequential().add(nn.LayerNorm(embed_dim)).add(
        nn.MultiHeadAttention(embed_dim, num_heads, causal=causal,
                              attention_impl=attention_impl,
                              generator=generator))
    hidden = mlp_ratio * embed_dim
    mlp = (nn.Sequential()
           .add(nn.LayerNorm(embed_dim))
           .add(nn.TimeDistributed(nn.Linear(embed_dim, hidden,
                                             generator=generator)))
           .add(nn.GELU())
           .add(nn.TimeDistributed(nn.Linear(hidden, embed_dim,
                                             generator=generator))))
    return nn.Sequential().add(_residual(attn)).add(_residual(mlp))


def TransformerLM(vocab_size: int, embed_dim: int = 256, num_heads: int = 4,
                  num_layers: int = 4, max_len: int = 1024,
                  mlp_ratio: int = 4, attention_impl: str = "auto", *,
                  remat: bool = False,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> nn.Sequential:
    """Token ids (N, T) → per-position log-probs (N, T, vocab).

    ``remat=True`` wraps every block in :class:`~bigdl_tpu_torch.nn.Remat`
    (its activations recomputed in the backward), as JAX does, which adds
    a ``"0"`` level to the block's parameter paths. Weights are drawn on the
    CPU from ``generator`` (PyTorch's default generator when None), so a
    seed gives the same model on every device, and the model is then moved
    to ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    model = (nn.Sequential()
             .add(nn.LookupTable(vocab_size, embed_dim, generator=generator)
                  .set_name("embedding"))
             .add(PositionEmbedding(max_len, embed_dim, generator=generator)
                  .set_name("pos")))
    for i in range(num_layers):
        block = TransformerBlock(embed_dim, num_heads, mlp_ratio,
                                 attention_impl, generator=generator)
        if remat:
            block = nn.Remat(block)
        model.add(block.set_name(f"block{i + 1}"))
    model.add(nn.LayerNorm(embed_dim).set_name("final_norm"))
    model.add(nn.TimeDistributed(nn.Linear(embed_dim, vocab_size,
                                           generator=generator))
              .set_name("decoder"))
    model.add(nn.TimeDistributed(nn.LogSoftMax()))
    return model.to(dev)


def lm_criterion(fused_head: bool = False) -> nn.TimeDistributedCriterion:
    """The training criterion of :func:`TransformerLM`: per-position NLL of
    the log-probs, averaged over batch and time."""
    if fused_head:
        raise NotImplementedError(
            "fused_head (FusedLMHead + ChunkedSoftmaxCrossEntropy) is not "
            "ported yet: ROADMAP Queue A.2")
    return nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                       size_average=True)
