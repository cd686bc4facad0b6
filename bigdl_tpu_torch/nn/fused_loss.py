"""Chunked-vocabulary softmax cross-entropy: the fused LM head and its loss.

Counterpart of ``bigdl_tpu/nn/fused_loss.py``. ``chunked_softmax_xent``
computes each token's NLL with an online logsumexp over vocabulary chunks
(the flash recurrence on the vocab axis) and, in the backward, recomputes
each chunk's probabilities from the saved per-token logsumexp, so neither
pass holds more than (N, chunk) logits: no (N, V) tensor exists.

Dtypes as in JAX: ``hidden`` is cast to fp32 once, each (chunk, d) slice
of ``weight`` (and of ``bias``) is cast to fp32 inside the loop, the chunk
products run in fp32 (``torch.matmul``, no TF32 where the caller keeps it
off, as JAX's products outside any Pallas kernel), and ``dh``, ``dW`` and
``db`` come back in the inputs' dtypes. JAX pads the vocabulary to a
chunk multiple with rows of bias ``-1e30`` (exactly 0 after ``exp``); here
the last chunk is a shorter slice, the same sums without the padded
copies of the weight.

The target's one-hot term of the gradient is formed inside its own chunk:
``pg`` loses ``geff`` at each row's label column before ``pg @ W``,
``pgᵀ @ h`` and the column sum, where JAX subtracts it afterwards with
``dw.at[lc].add`` (a scatter-add, float atomics on a GPU, whose order is
not fixed). The same sums in another order: results agree with JAX to
fp32 rounding (relative 1e-5 at test sizes) and repeat bit for bit.

``FusedLMHead`` owns the projection; in training mode it emits
``Table(hidden, weight[, bias])`` (criterions hold no parameters), which
``ChunkedSoftmaxCrossEntropy`` consumes with the labels. In eval mode it is
an ordinary logits head (log-probs with ``eval_log_probs=True``).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.criterion import AbstractCriterion
from bigdl_tpu_torch.nn.initialization import InitializationMethod, Xavier
from bigdl_tpu_torch.parallel.collectives import global_mean
from bigdl_tpu_torch.utils.table import Table

_NEG = -1e30   # the running max before any chunk: exp(_NEG - m) is 0


def _chunk(weight, bias, c0: int, c1: int):
    """Rows [c0, c1) of the head in fp32: (C, d) and (C,) or None."""
    wc = weight[c0:c1].float()
    return wc, (None if bias is None else bias[c0:c1].float())


def _logits(h, wc, bc):
    out = h @ wc.T
    return out if bc is None else out + bc


class ChunkedSoftmaxXent(torch.autograd.Function):
    """Per-row NLL over vocabulary chunks with the recomputing backward."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, labels, chunk: int):
        h = hidden.float()
        v = weight.shape[0]
        n = h.shape[0]
        m = torch.full((n,), _NEG, dtype=torch.float32, device=h.device)
        s = torch.zeros(n, dtype=torch.float32, device=h.device)
        for c0 in range(0, v, chunk):
            logits = _logits(h, *_chunk(weight, bias, c0, c0 + chunk))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
        lse = m + torch.log(s)
        # labels < 0 or >= V are masked alike (no loss, no gradient)
        valid = (labels >= 0) & (labels < v)
        lc = labels.clamp(0, v - 1).long()
        tgt = (h * weight[lc].float()).sum(dim=-1)
        if bias is not None:
            tgt = tgt + bias[lc].float()
        ctx.save_for_backward(hidden, weight, bias, labels, lse)
        ctx.chunk = chunk
        return torch.where(valid, lse - tgt, torch.zeros_like(lse))

    @staticmethod
    def backward(ctx, g):
        hidden, weight, bias, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        h = hidden.float()
        v, d = weight.shape
        valid = (labels >= 0) & (labels < v)
        geff = g.float() * valid                                  # (N,)
        lc = labels.clamp(0, v - 1).long()
        dh = torch.zeros_like(h)
        dw = torch.empty((v, d), dtype=torch.float32, device=h.device)
        db = torch.empty(v, dtype=torch.float32, device=h.device)
        for c0 in range(0, v, chunk):
            c1 = min(c0 + chunk, v)
            wc, bc = _chunk(weight, bias, c0, c1)
            pg = torch.exp(_logits(h, wc, bc) - lse[:, None]) * geff[:, None]
            # the one-hot term, at each row's label inside this chunk
            cols = torch.arange(c0, c1, device=h.device)
            pg = torch.where(cols[None, :] == lc[:, None],
                             pg - geff[:, None], pg)
            dh = dh + pg @ wc
            dw[c0:c1] = pg.T @ h
            db[c0:c1] = pg.sum(dim=0)
        return (dh.to(hidden.dtype), dw.to(weight.dtype),
                None if bias is None else db.to(bias.dtype), None, None)


def chunked_softmax_xent(hidden, weight, bias, labels, chunk_size=8192):
    """Per-row softmax cross-entropy ``-log softmax(hidden @ weight.T +
    bias)[label]`` in vocabulary chunks. ``hidden (N, d)``, ``weight (V,
    d)``, ``bias (V,) | None``, ``labels (N,)`` int (negative or >= V:
    ignored, loss 0). Returns ``(N,)`` fp32 losses."""
    chunk = min(int(chunk_size), weight.shape[0])
    return ChunkedSoftmaxXent.apply(hidden, weight, bias, labels, chunk)


class FusedLMHead(TensorModule):
    """LM projection head fused with its loss.

    Training mode: ``hidden (..., d)`` → ``Table(hidden, weight[, bias])``
    for :class:`ChunkedSoftmaxCrossEntropy`. Eval mode: logits
    ``(..., vocab)``, or log-probs with ``eval_log_probs``. :meth:`embed`
    looks ids up in the same weight (tied embeddings)."""

    def __init__(self, hidden_size: int, vocab_size: int,
                 with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 eval_log_probs: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size, self.vocab_size = int(hidden_size), int(vocab_size)
        self.eval_log_probs = bool(eval_log_probs)
        w_init = w_init or Xavier()
        self.weight = torch.nn.Parameter(w_init.init(
            (self.vocab_size, self.hidden_size), fan_in=self.hidden_size,
            fan_out=self.vocab_size, generator=generator))
        self.bias = None
        if with_bias:
            self.bias = torch.nn.Parameter(
                torch.zeros(self.vocab_size) if b_init is None else
                b_init.init((self.vocab_size,), fan_in=self.hidden_size,
                            fan_out=self.vocab_size, generator=generator))

    def embed(self, ids):
        """Tied-embedding lookup: ``ids (...)`` → ``(..., d)``."""
        return self.weight[ids.long()]

    def run(self, input, state=None):
        if self.training:
            out = [input, self.weight] + (
                [self.bias] if self.bias is not None else [])
            return Table(*out), state
        logits = input @ self.weight.T
        if self.bias is not None:
            logits = logits + self.bias
        if self.eval_log_probs:
            logits = torch.log_softmax(logits, dim=-1)
        return logits, state

    def extra_repr(self):
        return f"{self.hidden_size} -> {self.vocab_size}"


class ChunkedSoftmaxCrossEntropy(AbstractCriterion):
    """Consumes :class:`FusedLMHead`'s training output ``Table(hidden,
    weight[, bias])`` and integer targets of matching leading shape: the
    mean NLL over valid tokens (labels in [0, V) after the base shift).
    ``chunk_size`` bounds the live logits to tokens × chunk_size."""

    size_average = True

    def __init__(self, chunk_size: int = 8192, zero_based: bool = True):
        self.chunk_size = int(chunk_size)
        self.zero_based = zero_based

    def apply(self, input, target):
        xs = input.values() if isinstance(input, Table) else list(input)
        hidden, weight = xs[0], xs[1]
        bias = xs[2] if len(xs) > 2 else None
        t = target.reshape(-1).long()
        if not self.zero_based:
            t = t - 1
        losses = chunked_softmax_xent(hidden.reshape(-1, hidden.shape[-1]),
                                      weight, bias, t, self.chunk_size)
        n_valid = ((t >= 0) & (t < weight.shape[0])).sum()
        return global_mean(losses.sum(), n_valid, min_count=1)

    def __repr__(self):
        return f"ChunkedSoftmaxCrossEntropy(chunk={self.chunk_size})"
