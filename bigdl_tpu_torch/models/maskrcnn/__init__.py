from bigdl_tpu_torch.models.maskrcnn.maskrcnn import MaskRCNN, MaskRCNNBackbone

__all__ = ["MaskRCNN", "MaskRCNNBackbone"]
