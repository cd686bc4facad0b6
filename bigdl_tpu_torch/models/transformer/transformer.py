"""Encoder-decoder Transformer (seq2seq).

Counterpart of ``bigdl_tpu/models/transformer/transformer.py``, built from
the same layers in the same order, so its parameter paths are the JAX
``get_params()`` paths: an encoder (``LookupTable``, ``PositionEmbedding``,
non-causal pre-LN ``TransformerBlock``s whose attention runs the flash
kernels with ``causal=False``, ``enc_norm``), a target embedding, a
decoder of :class:`TransformerDecoderBlock` (causal self-attention through
the flash kernels, cross-attention over the memory through the plain
attention, the MLP) and a ``LayerNorm >> Linear >> LogSoftMax`` head.

``Transformer(...)`` maps ``T(src_ids, tgt_ids)`` (or a tuple, as the
trainer feeds a two-tensor batch) to (N, Tt, tgt_vocab) log-probs.
:func:`beam_translate` runs ``SequenceBeamSearch`` over the target side
against the encoded memory (the decoder's full forward every step);
:func:`translate_generate` is its KV-cached form through
``nn.beam_generate`` with the cache under the target embedding and the
decoder only (the bidirectional encoder runs once, up front). The memory
is a plain tensor, tiled to the N·beam rows of the search.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models.transformerlm.transformerlm import (
    PositionEmbedding, TransformerBlock,
)
from bigdl_tpu_torch.nn.abstractnn import Container, child_state, evaluating
from bigdl_tpu_torch.utils.device import require_on, resolve_device
from bigdl_tpu_torch.utils.table import T


def _two(input):
    """The pair of a Table (1-based) or of a tuple/list."""
    if isinstance(input, (tuple, list)):
        a, b = input
        return a, b
    return input[1], input[2]


def _keep(new: dict, name: str, s) -> None:
    if new is not None and s is not None:
        new[name] = s


class TransformerDecoderBlock(Container):
    """Pre-LN decoder block: causal self-attention, cross-attention over
    the memory, the MLP. Input and output ``T(x, memory)``, so blocks chain
    in a Sequential."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 dropout: float = 0.0, attention_impl: str = "auto",
                 generator: Optional[torch.Generator] = None):
        def linear(n_in, n_out):
            return nn.TimeDistributed(nn.Linear(n_in, n_out,
                                                generator=generator))

        self_attn = nn.Sequential().add(nn.LayerNorm(embed_dim)).add(
            nn.MultiHeadAttention(embed_dim, num_heads, causal=True,
                                  attention_impl=attention_impl,
                                  generator=generator))
        cross = nn.Sequential().add(nn.CrossAttention(embed_dim, num_heads,
                                                      generator=generator))
        mlp = (nn.Sequential().add(nn.LayerNorm(embed_dim))
               .add(linear(embed_dim, mlp_ratio * embed_dim))
               .add(nn.GELU())
               .add(linear(mlp_ratio * embed_dim, embed_dim)))
        if dropout > 0:
            for seq in (self_attn, cross, mlp):
                seq.add(nn.Dropout(dropout))
        super().__init__(self_attn, nn.LayerNorm(embed_dim), cross, mlp)

    def run(self, input, state=None):
        x, memory = _two(input)
        sa, cn, ca, mlp = (self[i] for i in range(4))
        new = None if state is None else {}
        h, s = sa.run(x, child_state(state, "0"))
        _keep(new, "0", s)
        x = x + h
        h, _ = ca.run(T(cn(x), memory), child_state(state, "2"))
        x = x + h
        return T(x + mlp(x), memory), new


class Transformer(Container):
    """Seq2seq transformer: ``forward(T(src, tgt))`` → (N, Tt, tgt_vocab)
    log-probs of int token ids (teacher-forced targets). Weights are drawn
    on the CPU from ``generator`` and moved to ``device`` (default
    ``"cuda"``)."""

    def __init__(self, src_vocab: int, tgt_vocab: int, embed_dim: int = 256,
                 num_heads: int = 4, num_encoder_layers: int = 2,
                 num_decoder_layers: int = 2, max_len: int = 512,
                 mlp_ratio: int = 4, dropout: float = 0.0,
                 attention_impl: str = "auto", *,
                 generator: Optional[torch.Generator] = None, device=None):
        dev = resolve_device(device)
        g = generator
        encoder = (nn.Sequential()
                   .add(nn.LookupTable(src_vocab, embed_dim, zero_based=True,
                                       generator=g))
                   .add(PositionEmbedding(max_len, embed_dim, generator=g)))
        for i in range(num_encoder_layers):
            encoder.add(TransformerBlock(
                embed_dim, num_heads, mlp_ratio, dropout, attention_impl,
                causal=False, generator=g).set_name(f"enc{i + 1}"))
        encoder.add(nn.LayerNorm(embed_dim).set_name("enc_norm"))
        tgt_embed = (nn.Sequential()
                     .add(nn.LookupTable(tgt_vocab, embed_dim,
                                         zero_based=True, generator=g))
                     .add(PositionEmbedding(max_len, embed_dim, generator=g)))
        decoder = nn.Sequential()
        for i in range(num_decoder_layers):
            decoder.add(TransformerDecoderBlock(
                embed_dim, num_heads, mlp_ratio, dropout, attention_impl,
                generator=g).set_name(f"dec{i + 1}"))
        head = (nn.Sequential()
                .add(nn.LayerNorm(embed_dim))
                .add(nn.TimeDistributed(nn.Linear(embed_dim, tgt_vocab,
                                                  generator=g)))
                .add(nn.TimeDistributed(nn.LogSoftMax())))
        super().__init__(encoder, tgt_embed, decoder, head)
        self.tgt_vocab = tgt_vocab
        self.to(dev)

    def run(self, input, state=None):
        src, tgt = _two(input)
        enc, emb, dec, head = (self[i] for i in range(4))
        new = None if state is None else {}
        memory, s = enc.run(src, child_state(state, "0"))
        _keep(new, "0", s)
        x, s = emb.run(tgt, child_state(state, "1"))
        _keep(new, "1", s)
        out, s = dec.run(T(x, memory), child_state(state, "2"))
        _keep(new, "2", s)
        logp, s = head.run(out[1], child_state(state, "3"))
        _keep(new, "3", s)
        return logp, new


def encode(model: Transformer, src) -> torch.Tensor:
    """The encoder's memory of ``src`` (N, Ts) ids, in eval mode."""
    dev = next(model.parameters()).device
    src = torch.as_tensor(src, dtype=torch.long).to(dev)
    with torch.no_grad(), evaluating(model):
        return model[0](src)


class _MemoryDecoder(Container):
    """The target side of a Transformer bound to an encoded memory, so a
    search over target tokens can drive it: the memory is tiled to the
    incoming N·beam rows. A decode-time helper."""

    def __init__(self, transformer: Transformer, memory: torch.Tensor):
        super().__init__(transformer)
        self.memory = memory

    def _memory_for(self, rows: int) -> torch.Tensor:
        return self.memory.repeat_interleave(rows // self.memory.shape[0],
                                             dim=0)

    def run(self, input, state=None):
        model = self[0]
        x = model[1](input)
        out = model[2](T(x, self._memory_for(input.shape[0])))
        return model[3](out[1]), state


class _CachedMemoryDecoder(_MemoryDecoder):
    """:class:`_MemoryDecoder` that threads the decode state of the target
    embedding and the decoder (``nn.install_decode_cache`` under those
    roots), so each step feeds one new position."""

    def run(self, input, state=None):
        model = self[0]
        sub = child_state(state, "0")
        x, s1 = model[1].run(input, child_state(sub, "1"))
        out, s2 = model[2].run(T(x, self._memory_for(input.shape[0])),
                               child_state(sub, "2"))
        logp, _ = model[3].run(out[1])
        return logp, (None if state is None else {"0": {"1": s1, "2": s2}})


def beam_translate(model: Transformer, src, *, beam_size: int = 4,
                   eos_id: int, bos_id: int, decode_length: int,
                   alpha: float = 0.6, pad_id: int = 0, device=None):
    """Beam-search translate ``src`` (N, Ts) ids → ``(sequences (N, beam,
    1 + decode_length) int32 starting with bos_id, scores (N, beam))``,
    best beam first. ``device`` defaults to ``"cuda"`` and must hold the
    model."""
    require_on(model, device)
    wrapped = _MemoryDecoder(model, encode(model, src))
    bs = nn.SequenceBeamSearch(wrapped, beam_size, eos_id, decode_length,
                               alpha=alpha, pad_id=pad_id)
    prompt = torch.full((len(src), 1), bos_id, dtype=torch.long)
    out = bs.forward(prompt)
    return out[1], out[2]


def translate_generate(model: Transformer, src, *, beam_size: int = 4,
                       eos_id: int, bos_id: int, decode_length: int,
                       alpha: float = 0.6, pad_id: int = 0, device=None):
    """KV-cached beam translate: :func:`beam_translate`'s contract and,
    ties aside, its result, with the decoder's self-attention one position
    a step through the decode cache."""
    dev = require_on(model, device)
    wrapped = _CachedMemoryDecoder(model, encode(model, src))
    prompt = torch.full((len(src), 1), bos_id, dtype=torch.long)
    return nn.beam_generate(wrapped, prompt, decode_length,
                            beam_size=beam_size, eos_id=eos_id, alpha=alpha,
                            pad_id=pad_id, device=dev,
                            cache_roots=[model[1], model[2]])


from bigdl_tpu_torch.utils.serializer import register as _register  # noqa: E402

_register(TransformerDecoderBlock)
_register(Transformer)
