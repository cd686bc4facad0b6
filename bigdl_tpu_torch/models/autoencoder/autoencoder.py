"""The MNIST autoencoder.

Counterpart of ``bigdl_tpu/models/autoencoder/autoencoder.py``: 784 ->
Linear(784, class_num) -> ReLU -> Linear(class_num, 784) -> Sigmoid,
trained with ``MSECriterion`` to reconstruct its input. Weights are drawn
on the CPU from ``generator`` and the model is moved to ``device``
(default the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def Autoencoder(class_num: int = 32, *,
                generator: Optional[torch.Generator] = None,
                device=None) -> nn.Sequential:
    """``class_num`` is the bottleneck's width (the reference's name)."""
    return (nn.Sequential()
            .add(nn.Reshape([28 * 28]))
            .add(nn.Linear(28 * 28, class_num, generator=generator))
            .add(nn.ReLU())
            .add(nn.Linear(class_num, 28 * 28, generator=generator))
            .add(nn.Sigmoid())).to(resolve_device(device))
