"""Parallel layers and sharding over the Engine mesh: the counterpart of
``bigdl_tpu/parallel`` with its exports (ring attention, the sharding
decisions, MoE, GPipe, tensor parallelism, the embedding engine), and the
port's collectives (``parallel/collectives.py``)."""

from bigdl_tpu_torch.parallel.ring_attention import (
    full_attention, ring_attention,
)
from bigdl_tpu_torch.parallel.sharding import (
    batch_sharding, replicated, shard_leading_axis, zero1_state_sharding,
)
from bigdl_tpu_torch.parallel.tensor_parallel import (
    TPRules, column_parallel, megatron_mlp_rules, row_parallel,
)
from bigdl_tpu_torch.parallel.moe import MoE, expert_parallel_rules
from bigdl_tpu_torch.parallel.pipeline import GPipe
from bigdl_tpu_torch.parallel.embedding import (
    ShardedEmbedding, SparseEmbeddingUpdate, build_sparse_plan, dedup_ids,
    embedding_parallel_rules, find_sharded_embeddings, model_embedding_rules,
)

__all__ = ["full_attention", "ring_attention", "batch_sharding",
           "replicated", "shard_leading_axis", "zero1_state_sharding",
           "MoE", "expert_parallel_rules", "GPipe", "TPRules",
           "column_parallel", "megatron_mlp_rules", "row_parallel",
           "ShardedEmbedding", "SparseEmbeddingUpdate", "build_sparse_plan",
           "dedup_ids", "embedding_parallel_rules", "find_sharded_embeddings",
           "model_embedding_rules"]
