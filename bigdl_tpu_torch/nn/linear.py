"""Fully-connected layer.

Counterpart of ``bigdl_tpu/nn/linear.py``: weight (out, in), optional bias,
Torch default init U(-1/sqrt(fan_in), +), ``x @ W.T + b``. The input's
shape follows :func:`normalize_linear_input`, which ``LoRALinear``
(``nn/lora.py``) shares. ``w_regularizer``/``b_regularizer``
(``optim/regularizer.py``) add their penalty to the training loss. An
fp32 input meets bf16 parameters under the bf16 policy behind a
recurrent layer (JAX's cells carry fp32 state): the product is then
fp32, JAX's promotion (``nn/precision.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.initialization import InitializationMethod, RandomUniform
from bigdl_tpu_torch.nn.precision import promote


def normalize_linear_input(input):
    """JAX's Linear shape rule, shared with ``LoRALinear`` so the two
    cannot drift: input of more than 2 dims flattens to (batch, -1), 1-D
    input is one row (and the returned ``restore`` gives the output back
    its 1-D shape)."""
    if input.dim() > 2:
        return input.reshape(input.shape[0], -1), (lambda out: out)
    if input.dim() == 1:
        return input[None, :], (lambda out: out[0])
    return input, (lambda out: out)


class Linear(TensorModule):
    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None,
                 w_regularizer=None, b_regularizer=None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        w_init = w_init or RandomUniform()
        b_init = b_init or RandomUniform()
        self.weight = torch.nn.Parameter(w_init.init(
            (output_size, input_size), fan_in=input_size,
            fan_out=output_size, generator=generator))
        self.bias = (torch.nn.Parameter(b_init.init(
            (output_size,), fan_in=input_size, fan_out=output_size,
            generator=generator)) if with_bias else None)

    @property
    def with_bias(self) -> bool:
        return self.bias is not None

    def run(self, input, state=None):
        x, restore = normalize_linear_input(input)
        return restore(F.linear(*promote(x, *(
            t for t in (self.weight, self.bias) if t is not None)))), state

    def extra_repr(self):
        return f"{self.input_size} -> {self.output_size}"
