"""Attention helpers outside any kernel and the embedding engine (single
device so far; the mesh placements wait for ROADMAP Queue A.6)."""

from bigdl_tpu_torch.parallel.embedding import (
    ShardedEmbedding, SparseEmbeddingUpdate, build_sparse_plan, dedup_ids,
    find_sharded_embeddings,
)
from bigdl_tpu_torch.parallel.ring_attention import full_attention

__all__ = ["ShardedEmbedding", "SparseEmbeddingUpdate", "build_sparse_plan",
           "dedup_ids", "find_sharded_embeddings", "full_attention"]
