from bigdl_tpu_torch.models.inception.inception import (
    Inception_Layer_v1, Inception_Layer_v2, Inception_v1,
    Inception_v1_NoAuxClassifier, Inception_v2, Inception_v2_NoAuxClassifier,
)

__all__ = ["Inception_Layer_v1", "Inception_Layer_v2", "Inception_v1",
           "Inception_v1_NoAuxClassifier", "Inception_v2",
           "Inception_v2_NoAuxClassifier"]
