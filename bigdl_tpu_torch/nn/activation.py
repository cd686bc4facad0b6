"""Activations on the language model's path: GELU and LogSoftMax.

Counterpart of ``bigdl_tpu/nn/activation.py``. ``jax.nn.gelu`` defaults to
the tanh approximation, so GELU here is ``F.gelu(x, approximate="tanh")``.
LogSoftMax computes and returns fp32 whatever the input dtype, as the JAX
layer does.
"""

from __future__ import annotations

import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import TensorModule


class GELU(TensorModule):
    def run(self, input, state=None):
        return F.gelu(input, approximate="tanh"), state


class LogSoftMax(TensorModule):
    """Log-softmax over the last axis, an fp32 island."""

    def run(self, input, state=None):
        return F.log_softmax(input.float(), dim=-1), state
