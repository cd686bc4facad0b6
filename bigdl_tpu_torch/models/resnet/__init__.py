from bigdl_tpu_torch.models.resnet.resnet import (
    ResNet, ResNet50, basic_block, bottleneck, conv_bn,
)

__all__ = ["ResNet", "ResNet50", "basic_block", "bottleneck", "conv_bn"]
