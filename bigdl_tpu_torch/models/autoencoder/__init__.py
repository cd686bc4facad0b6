from bigdl_tpu_torch.models.autoencoder.autoencoder import Autoencoder

__all__ = ["Autoencoder"]
