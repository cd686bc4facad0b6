"""VGG family: ``VggForCifar10`` (BASELINE.md config 5), ``Vgg_16`` and
``Vgg_19``.

Counterpart of ``bigdl_tpu/models/vgg/vgg.py``: ``VggForCifar10`` is the
batch-normalised CIFAR VGG (3×3 conv + BN(eps 1e-3) + ReLU stacks, five
ceil-mode max pools, a 512-wide head with 2-D batch norm and dropout);
``Vgg_16``/``Vgg_19`` are the ImageNet configurations D and E (no BN,
4096-wide head). Weights are drawn on the CPU from ``generator`` and the
model is moved to ``device`` (default the card); ``dropout_generator`` is
the dropout layers' generator (``nn.Dropout``).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def _conv_bn_relu(n_in: int, n_out: int, g) -> list:
    return [nn.SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1, generator=g),
            nn.SpatialBatchNormalization(n_out, eps=1e-3, generator=g),
            nn.ReLU()]


def VggForCifar10(class_num: int = 10, has_dropout: bool = True, *,
                  generator: Optional[torch.Generator] = None,
                  dropout_generator: Optional[torch.Generator] = None,
                  device=None) -> nn.Sequential:
    g = generator
    dev = resolve_device(device)
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    model = nn.Sequential()
    n_in = 3
    for v in cfg:
        if v == "M":
            model.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
        else:
            for layer in _conv_bn_relu(n_in, v, g):
                model.add(layer)
            n_in = v
    model.add(nn.View([512]))
    if has_dropout:
        model.add(nn.Dropout(0.5, generator=dropout_generator))
    model.add(nn.Linear(512, 512, generator=g))
    model.add(nn.BatchNormalization(512, generator=g))
    model.add(nn.ReLU())
    if has_dropout:
        model.add(nn.Dropout(0.5, generator=dropout_generator))
    model.add(nn.Linear(512, class_num, generator=g))
    model.add(nn.LogSoftMax())
    return model.to(dev)


_VGG_CFG = {
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _vgg_imagenet(depth: int, class_num: int, has_dropout: bool, g,
                  dropout_generator, device) -> nn.Sequential:
    dev = resolve_device(device)
    model = nn.Sequential()
    n_in = 3
    for v in _VGG_CFG[depth]:
        if v == "M":
            model.add(nn.SpatialMaxPooling(2, 2, 2, 2).ceil())
        else:
            model.add(nn.SpatialConvolution(n_in, v, 3, 3, 1, 1, 1, 1,
                                            generator=g))
            model.add(nn.ReLU())
            n_in = v
    model.add(nn.View([512 * 7 * 7]))
    model.add(nn.Linear(512 * 7 * 7, 4096, generator=g))
    model.add(nn.ReLU())
    if has_dropout:
        model.add(nn.Dropout(0.5, generator=dropout_generator))
    model.add(nn.Linear(4096, 4096, generator=g))
    model.add(nn.ReLU())
    if has_dropout:
        model.add(nn.Dropout(0.5, generator=dropout_generator))
    model.add(nn.Linear(4096, class_num, generator=g))
    model.add(nn.LogSoftMax())
    return model.to(dev)


def Vgg_16(class_num: int = 1000, has_dropout: bool = True, *,
           generator: Optional[torch.Generator] = None,
           dropout_generator: Optional[torch.Generator] = None,
           device=None) -> nn.Sequential:
    return _vgg_imagenet(16, class_num, has_dropout, generator,
                         dropout_generator, device)


def Vgg_19(class_num: int = 1000, has_dropout: bool = True, *,
           generator: Optional[torch.Generator] = None,
           dropout_generator: Optional[torch.Generator] = None,
           device=None) -> nn.Sequential:
    return _vgg_imagenet(19, class_num, has_dropout, generator,
                         dropout_generator, device)
