from bigdl_tpu_torch.models.lenet.lenet5 import LeNet5

__all__ = ["LeNet5"]
