from bigdl_tpu_torch.models.ssd.ssd import SSD, PermuteFlatten, detector

__all__ = ["PermuteFlatten", "SSD", "detector"]
