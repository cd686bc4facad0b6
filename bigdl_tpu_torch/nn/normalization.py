"""LayerNorm over the last axis, served by the fused CUDA kernel.

Counterpart of ``bigdl_tpu/nn/normalization.py`` ``LayerNorm``: weight
ones, bias zeros, eps 1e-5; every call goes through
``kernels.fused_layer_norm`` (the kernel on CUDA tensors, its plain version
on CPU tensors).
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.kernels import fused_layer_norm
from bigdl_tpu_torch.nn.abstractnn import TensorModule


class LayerNorm(TensorModule):
    def __init__(self, n_output: int, eps: float = 1e-5):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(n_output))
        self.bias = torch.nn.Parameter(torch.zeros(n_output))

    def run(self, input, state=None):
        return fused_layer_norm(input, self.weight, self.bias, self.eps), state

    def extra_repr(self):
        return f"{self.n_output}, eps={self.eps}"
