"""Fully-connected layer.

Counterpart of ``bigdl_tpu/nn/linear.py``: weight (out, in), optional bias,
Torch default init U(-1/sqrt(fan_in), +), ``x @ W.T + b``. Takes 1-D or
2-D input; ``TimeDistributed`` folds time into the batch first.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.initialization import InitializationMethod, RandomUniform


class Linear(TensorModule):
    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        w_init = w_init or RandomUniform()
        b_init = b_init or RandomUniform()
        self.weight = torch.nn.Parameter(w_init.init(
            (output_size, input_size), fan_in=input_size,
            fan_out=output_size, generator=generator))
        self.bias = (torch.nn.Parameter(b_init.init(
            (output_size,), fan_in=input_size, fan_out=output_size,
            generator=generator)) if with_bias else None)

    def run(self, input, state=None):
        if input.dim() > 2:
            raise ValueError(f"Linear takes 1-D or 2-D input, got "
                             f"{tuple(input.shape)}; wrap it in "
                             f"TimeDistributed for (N, T, ...)")
        return F.linear(input, self.weight, self.bias), state

    def extra_repr(self):
        return f"{self.input_size} -> {self.output_size}"
