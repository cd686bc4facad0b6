from bigdl_tpu_torch.models.transformerlm.transformerlm import (
    PositionEmbedding, TransformerBlock, TransformerLM, lm_criterion,
)

__all__ = ["PositionEmbedding", "TransformerBlock", "TransformerLM",
           "lm_criterion"]
