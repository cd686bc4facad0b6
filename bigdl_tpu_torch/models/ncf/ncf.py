"""Neural Collaborative Filtering (NeuMF).

Counterpart of ``bigdl_tpu/models/ncf/ncf.py``: a GMF branch (the
elementwise product of user and item embeddings) and an MLP branch (the
concatenated embeddings through a ReLU tower), joined and mapped to class
log-probabilities, as one ``nn.Graph`` whose parameter paths are JAX's.
Weights are drawn on the CPU from ``generator`` and the model is moved to
``device`` (default the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def NeuralCF(user_count: int, item_count: int, class_num: int = 2,
             user_embed: int = 16, item_embed: int = 16,
             hidden_layers: tuple = (32, 16, 8), mf_embed: int = 8,
             hash_buckets: int = 0, sharded: bool = False, *,
             generator: Optional[torch.Generator] = None,
             device=None) -> nn.Graph:
    """NeuMF over (N, 2) int (user, item) ids, 1-based (raw ids when
    ``hash_buckets > 0``: every table is a ``HashBucketEmbedding``);
    ``sharded=True`` wraps every table in ``parallel.ShardedEmbedding``
    (deduplicated gathers, sparse row updates when trained). Output:
    (N, class_num) log-probabilities."""
    def make_embed(count: int, dim: int):
        if hash_buckets > 0:
            table = nn.HashBucketEmbedding(hash_buckets, dim,
                                           generator=generator)
        else:
            table = nn.LookupTable(count, dim, generator=generator)
        if sharded:
            from bigdl_tpu_torch.parallel.embedding import ShardedEmbedding
            return ShardedEmbedding(table)
        return table

    inp = nn.Input()
    user = nn.Select(2, 1).inputs(inp)
    item = nn.Select(2, 2).inputs(inp)

    mf_user = make_embed(user_count, mf_embed).inputs(user)
    mf_item = make_embed(item_count, mf_embed).inputs(item)
    gmf = nn.CMulTable().inputs(mf_user, mf_item)

    mlp_user = make_embed(user_count, user_embed).inputs(user)
    mlp_item = make_embed(item_count, item_embed).inputs(item)
    x = nn.JoinTable(2).inputs(mlp_user, mlp_item)
    in_dim = user_embed + item_embed
    for width in hidden_layers:
        x = nn.Linear(in_dim, width, generator=generator).inputs(x)
        x = nn.ReLU().inputs(x)
        in_dim = width

    merged = nn.JoinTable(2).inputs(gmf, x)
    out = nn.Linear(mf_embed + in_dim, class_num,
                    generator=generator).inputs(merged)
    out = nn.LogSoftMax().inputs(out)
    return nn.Graph(inp, out).to(resolve_device(device))
