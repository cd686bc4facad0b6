from bigdl_tpu_torch.models.transformer.transformer import (
    Transformer, TransformerDecoderBlock, beam_translate, translate_generate,
)

__all__ = ["Transformer", "TransformerDecoderBlock", "beam_translate",
           "translate_generate"]
