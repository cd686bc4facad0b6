from bigdl_tpu_torch.models.textclassifier.textclassifier import TextClassifier

__all__ = ["TextClassifier"]
