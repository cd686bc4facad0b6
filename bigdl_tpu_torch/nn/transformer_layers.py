"""The reference's transformer layer family.

Counterpart of ``bigdl_tpu/nn/transformer_layers.py``: the layer-level API
of the reference's transformer (``LayerNormalization``, ``ExpandSize``,
``TableOperation``, the reference-shaped ``Attention`` with an additive
bias on its logits, ``FeedForwardNetwork`` and the layer-level
``Transformer`` LM body), with JAX's parameter keys and layouts (``w_q``
... ``w_o`` (H, H) used as ``x @ w``; ``w1`` (H, F), ``b1``, ``w2`` (F, H),
``b2``). The attention is plain, as in JAX (no Pallas kernel there); the
LayerNorms run the LayerNorm kernels. Dropout is inverted dropout drawn
from each layer's ``generator`` (PyTorch's default when None).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.nn.abstractnn import Container, TensorModule, child_state
from bigdl_tpu_torch.nn.embedding import LookupTable
from bigdl_tpu_torch.nn.initialization import InitializationMethod, Xavier
from bigdl_tpu_torch.nn.normalization import LayerNorm, _draw_mask
from bigdl_tpu_torch.utils.table import Table


def _inverted_dropout(x: torch.Tensor, p: float,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """The one dropout of the family: keep with probability ``1 - p``,
    divide by it."""
    keep = 1.0 - p
    mask = _draw_mask(lambda: torch.rand(x.shape, generator=generator,
                                         device=x.device) < keep)
    return x.masked_fill(~mask, 0.0) / keep


def _elements(input) -> list:
    if isinstance(input, Table):
        return input.values()
    if isinstance(input, (tuple, list)):
        return list(input)
    return [input]


class LayerNormalization(LayerNorm):
    """The reference's name for the last-axis LayerNorm with learned gain
    and bias (``LayerNormalization(hiddenSize)``)."""


class ExpandSize(TensorModule):
    """Broadcast the input to ``sizes`` (-1 keeps that dim; only size-1
    dims broadcast)."""

    def __init__(self, sizes: Sequence[int]):
        super().__init__()
        self.sizes = [int(s) for s in sizes]

    def run(self, input, state=None):
        if len(self.sizes) != input.dim():
            raise ValueError(
                f"ExpandSize{tuple(self.sizes)} rank does not match input "
                f"rank {input.dim()}")
        target = [d if s == -1 else s for s, d in zip(self.sizes,
                                                        input.shape)]
        for s, d in zip(target, input.shape):
            if d != s and d != 1:
                raise ValueError(f"cannot expand dim of size {d} to {s} "
                                 f"(only size-1 dims broadcast)")
        return input.expand(*target), state

    def extra_repr(self):
        return f"{self.sizes}"


class TableOperation(Container):
    """Run a binary table layer after broadcasting the lower-rank operand
    of a 2-element Table to the higher-rank one (``TableOperation(
    CMulTable())`` multiplying (B, T, H) by (B, 1, 1))."""

    def __init__(self, operation_layer):
        super().__init__(operation_layer)

    def run(self, input, state=None):
        xs = _elements(input)
        if len(xs) != 2:
            raise ValueError("TableOperation expects a 2-element Table")
        a, b = xs
        if a.dim() < b.dim():
            a = a.reshape((1,) * (b.dim() - a.dim()) + tuple(a.shape))
        elif b.dim() < a.dim():
            b = b.reshape((1,) * (a.dim() - b.dim()) + tuple(b.shape))
        shape = torch.broadcast_shapes(a.shape, b.shape)
        out, s = self[0].run(Table(a.expand(shape), b.expand(shape)),
                             child_state(state, "0"))
        return out, (None if state is None or s is None else {"0": s})


class Attention(TensorModule):
    """Multi-head scaled-dot attention over ``Table(query, source, bias)``
    (``Attention(hiddenSize, numHeads, attentionDropout)``): the query
    attends to the source (self-attention for one tensor or the same one
    twice), with an additive ``bias`` broadcast onto the (B, heads, Tq, Tk)
    fp32 logits. Bias-free projections; the query scales by
    head_dim**-0.5."""

    def __init__(self, hidden_size: int, num_heads: int,
                 attention_dropout: float = 0.0,
                 w_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} not divisible by "
                             f"heads {num_heads}")
        self.hidden_size, self.num_heads = hidden_size, num_heads
        self.head_dim = hidden_size // num_heads
        self.dropout_p = float(attention_dropout)
        self.generator = generator
        w_init = w_init or Xavier()
        h = hidden_size
        for name in ("w_q", "w_k", "w_v", "w_o"):
            setattr(self, name, torch.nn.Parameter(w_init.init(
                (h, h), fan_in=h, fan_out=h, generator=generator)))

    def run(self, input, state=None):
        xs = _elements(input)
        q_in = xs[0]
        kv_in = xs[1] if len(xs) > 1 else q_in
        bias = xs[2] if len(xs) > 2 else None
        n, tq, h = q_in.shape
        tk = kv_in.shape[1]
        nh, hd = self.num_heads, self.head_dim

        def split(x, w, t):
            return (x @ w).reshape(n, t, nh, hd).transpose(1, 2)

        q = split(q_in, self.w_q, tq) * (hd ** -0.5)
        k = split(kv_in, self.w_k, tk)
        v = split(kv_in, self.w_v, tk)
        logits = torch.einsum("nhqd,nhkd->nhqk", q, k).float()
        if bias is not None:
            logits = logits + bias.float()
        weights = torch.softmax(logits, dim=-1).to(q_in.dtype)
        if self.training and self.dropout_p > 0:
            weights = _inverted_dropout(weights, self.dropout_p,
                                        self.generator)
        ctx = torch.einsum("nhqk,nhkd->nhqd", weights, v)
        return ctx.transpose(1, 2).reshape(n, tq, h) @ self.w_o, state

    def extra_repr(self):
        return (f"{self.hidden_size}, heads={self.num_heads}, "
                f"dropout={self.dropout_p}")


class FeedForwardNetwork(TensorModule):
    """Position-wise two-layer MLP (``FeedForwardNetwork(hiddenSize,
    filterSize, reluDropout)``): H → filter (ReLU, dropout) → H."""

    def __init__(self, hidden_size: int, filter_size: int,
                 relu_dropout: float = 0.0,
                 w_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size, self.filter_size = hidden_size, filter_size
        self.dropout_p = float(relu_dropout)
        self.generator = generator
        w_init = w_init or Xavier()
        h, f = hidden_size, filter_size
        self.w1 = torch.nn.Parameter(w_init.init((h, f), fan_in=h, fan_out=f,
                                                 generator=generator))
        self.b1 = torch.nn.Parameter(torch.zeros(f))
        self.w2 = torch.nn.Parameter(w_init.init((f, h), fan_in=f, fan_out=h,
                                                 generator=generator))
        self.b2 = torch.nn.Parameter(torch.zeros(h))

    def run(self, input, state=None):
        mid = torch.relu(input @ self.w1 + self.b1)
        if self.training and self.dropout_p > 0:
            mid = _inverted_dropout(mid, self.dropout_p, self.generator)
        return mid @ self.w2 + self.b2, state

    def extra_repr(self):
        return (f"{self.hidden_size} -> {self.filter_size} -> "
                f"{self.hidden_size}")


def _sinusoid_position(t: int, h: int) -> np.ndarray:
    """The reference transformer's sinusoidal position signal (t, h)."""
    pos = np.arange(t, dtype=np.float32)[:, None]
    dim = np.arange(0, h, 2, dtype=np.float32)[None, :]
    angles = pos / np.power(10000.0, dim / h)
    out = np.zeros((t, h), np.float32)
    out[:, 0::2] = np.sin(angles)
    out[:, 1::2] = np.cos(angles)[:, : out[:, 1::2].shape[1]]
    return out


class Transformer(Container):
    """The reference-shaped transformer LM body (``Transformer(vocabSize,
    hiddenSize, numHeads, filterSize, numHiddenlayers, ...)``): the
    embedding scaled by sqrt(H) plus the sinusoidal positions, N pre-norm
    blocks of :class:`Attention` (causal through a -1e9 additive bias) and
    :class:`FeedForwardNetwork`, and a final LayerNorm. (B, T) ids → (B,
    T, H) hidden states."""

    def __init__(self, vocab_size: int, hidden_size: int, num_heads: int,
                 filter_size: int, num_hidden_layers: int,
                 embedding_dropout: float = 0.0,
                 attention_dropout: float = 0.0,
                 ffn_dropout: float = 0.0, causal: bool = True,
                 generator: Optional[torch.Generator] = None):
        mods = [LookupTable(vocab_size, hidden_size, zero_based=True,
                            generator=generator)]
        for _ in range(num_hidden_layers):
            mods += [LayerNorm(hidden_size),
                     Attention(hidden_size, num_heads, attention_dropout,
                               generator=generator),
                     LayerNorm(hidden_size),
                     FeedForwardNetwork(hidden_size, filter_size, ffn_dropout,
                                        generator=generator)]
        mods.append(LayerNorm(hidden_size))
        super().__init__(*mods)
        self.vocab_size, self.hidden_size = vocab_size, hidden_size
        self.num_heads = num_heads
        self.filter_size = filter_size
        self.num_hidden_layers = num_hidden_layers
        self.embedding_dropout = float(embedding_dropout)
        self.causal = causal
        self.generator = generator

    def run(self, input, state=None):
        n, t = input.shape
        h = self.hidden_size
        x, _ = self[0].run(input)
        # the fp32 signal promotes a bf16 embedding to fp32, as in JAX
        x = x * math.sqrt(h) + torch.from_numpy(
            _sinusoid_position(t, h)).to(x.device)
        if self.training and self.embedding_dropout > 0:
            x = _inverted_dropout(x, self.embedding_dropout, self.generator)
        bias = None
        if self.causal:
            bias = torch.triu(torch.full((t, t), -1e9, device=x.device),
                              diagonal=1)[None, None]
        for i in range(1, 1 + 4 * self.num_hidden_layers, 4):
            ln1, attn, ln2, ffn = (self[j] for j in range(i, i + 4))
            y = ln1(x)
            x = x + attn(Table(y, y) if bias is None else Table(y, y, bias))
            x = x + ffn(ln2(x))
        return self[len(self._modules) - 1](x), state

    def extra_repr(self):
        return (f"vocab={self.vocab_size}, h={self.hidden_size}, "
                f"heads={self.num_heads}, layers={self.num_hidden_layers}")


from bigdl_tpu_torch.utils.serializer import register as _register  # noqa: E402

for _cls in (LayerNormalization, ExpandSize, TableOperation, Attention,
             FeedForwardNetwork):
    _register(_cls)
# JAX's registry names: the seq2seq zoo model owns the bare "Transformer"
_register(Transformer, name="nn.Transformer")
