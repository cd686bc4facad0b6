from bigdl_tpu_torch.models.transformerlm.transformerlm import (
    PositionEmbedding, TransformerBlock, TransformerLM,
)

__all__ = ["PositionEmbedding", "TransformerBlock", "TransformerLM"]
