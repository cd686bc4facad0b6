from bigdl_tpu_torch.models.ncf.ncf import NeuralCF

__all__ = ["NeuralCF"]
