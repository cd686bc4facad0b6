"""Activations: GELU, Swish, LogSoftMax, and the vision zoo's ReLU and Tanh.

Counterpart of ``bigdl_tpu/nn/activation.py``. ``jax.nn.gelu`` defaults to
the tanh approximation, so GELU here is ``F.gelu(x, approximate="tanh")``;
Swish is ``jax.nn.silu`` (``x * sigmoid(x)``), the gate of the SwiGLU MLP.
LogSoftMax computes and returns fp32 whatever the input dtype, as the JAX
layer does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import TensorModule


class GELU(TensorModule):
    def run(self, input, state=None):
        return F.gelu(input, approximate="tanh"), state


class Swish(TensorModule):
    def run(self, input, state=None):
        return F.silu(input), state


class LogSoftMax(TensorModule):
    """Log-softmax over the last axis, an fp32 island."""

    def run(self, input, state=None):
        return F.log_softmax(input.float(), dim=-1), state


class ReLU(TensorModule):
    def __init__(self, ip: bool = False):   # in place: not used, as in JAX
        super().__init__()

    def run(self, input, state=None):
        return F.relu(input), state


class Tanh(TensorModule):
    def run(self, input, state=None):
        return torch.tanh(input), state
