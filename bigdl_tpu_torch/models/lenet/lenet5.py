"""LeNet-5, BASELINE.md config 1.

Counterpart of ``bigdl_tpu/models/lenet/lenet5.py``: conv(1→6, 5×5) → tanh
→ maxpool → conv(6→12, 5×5) → tanh → maxpool → fc(100) → tanh →
fc(class_num) → log-softmax, on NCHW (1, 28, 28) input (its front
``Reshape`` fixes the reference layout). Weights are drawn on the CPU from
``generator`` and the model is moved to ``device`` (default the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def LeNet5(class_num: int = 10, *, generator: Optional[torch.Generator] = None,
           device=None) -> nn.Sequential:
    g = generator
    dev = resolve_device(device)
    return (nn.Sequential()
            .add(nn.Reshape([1, 28, 28]))
            .add(nn.SpatialConvolution(1, 6, 5, 5, generator=g)
                 .set_name("conv1_5x5"))
            .add(nn.Tanh())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.SpatialConvolution(6, 12, 5, 5, generator=g)
                 .set_name("conv2_5x5"))
            .add(nn.Tanh())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.Reshape([12 * 4 * 4]))
            .add(nn.Linear(12 * 4 * 4, 100, generator=g).set_name("fc_1"))
            .add(nn.Tanh())
            .add(nn.Linear(100, class_num, generator=g).set_name("fc_2"))
            .add(nn.LogSoftMax())).to(dev)
