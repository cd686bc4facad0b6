"""Wide & Deep.

Counterpart of ``bigdl_tpu/models/widedeep/widedeep.py``: a wide
``SparseLinear`` over padded id lists straight to the logits, plus a deep
branch (a mean bag of embeddings joined with the dense columns through a
ReLU tower), summed and mapped to log-probabilities, as one ``nn.Graph``.
Input: ``(wide_ids (N, Kw), deep_ids (N, Kd), dense (N, D))``, ids padded
with -1. Weights are drawn on the CPU from ``generator`` and the model is
moved to ``device`` (default the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def WideAndDeep(wide_features: int, deep_vocab: int, dense_dim: int,
                class_num: int = 2, embed_dim: int = 16,
                hidden_layers: tuple = (64, 32), *,
                generator: Optional[torch.Generator] = None,
                device=None) -> nn.Graph:
    inp = nn.Input()
    wide_ids = nn.SelectTable(1).inputs(inp)
    deep_ids = nn.SelectTable(2).inputs(inp)
    dense = nn.SelectTable(3).inputs(inp)

    wide_out = nn.SparseLinear(wide_features, class_num,
                               generator=generator).inputs(wide_ids)

    emb = nn.SparseEmbeddingSum(deep_vocab, embed_dim, combiner="mean",
                                generator=generator).inputs(deep_ids)
    x = nn.JoinTable(2).inputs(emb, dense)
    in_dim = embed_dim + dense_dim
    for width in hidden_layers:
        x = nn.Linear(in_dim, width, generator=generator).inputs(x)
        x = nn.ReLU().inputs(x)
        in_dim = width
    deep_out = nn.Linear(in_dim, class_num, generator=generator).inputs(x)

    out = nn.CAddTable().inputs(wide_out, deep_out)
    out = nn.LogSoftMax().inputs(out)
    return nn.Graph(inp, out).to(resolve_device(device))
