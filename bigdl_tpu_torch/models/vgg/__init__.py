from bigdl_tpu_torch.models.vgg.vgg import Vgg_16, Vgg_19, VggForCifar10

__all__ = ["Vgg_16", "Vgg_19", "VggForCifar10"]
