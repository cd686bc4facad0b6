"""Cosine-similarity layers.

Counterpart of ``bigdl_tpu/nn/cosine.py``: ``cosine_similarity`` (the one
definition the layers and the criteria share, the product of the norms
clipped at 1e-12), ``Cosine`` (the input against learned prototypes, each
side normalised with its norm clipped at 1e-12, then one product) and
``CosineDistance`` (row-wise, of a Table pair).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.abstractnn import AbstractModule, TensorModule
from bigdl_tpu_torch.nn.initialization import InitializationMethod, RandomUniform
from bigdl_tpu_torch.utils.table import Table


def cosine_similarity(x, y, axis: int = -1, eps: float = 1e-12):
    return (x * y).sum(axis) / (torch.linalg.vector_norm(x, dim=axis)
                                * torch.linalg.vector_norm(y, dim=axis)
                                ).clamp(min=eps)


class Cosine(TensorModule):
    """``out[b, o] = cos(x[b], weight[o])``, weight (output_size,
    input_size); (N, input_size) or (input_size,) input."""

    def __init__(self, input_size: int, output_size: int,
                 w_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.output_size = input_size, output_size
        self.weight = torch.nn.Parameter((w_init or RandomUniform()).init(
            (output_size, input_size), fan_in=input_size,
            fan_out=output_size, generator=generator))

    def run(self, input, state=None):
        if input.dim() > 2:
            raise ValueError(
                f"Cosine expects (N, {self.input_size}) or "
                f"({self.input_size},), got {tuple(input.shape)}; wrap with "
                f"Bottle for higher-rank inputs")
        x = input if input.dim() == 2 else input[None]
        w = self.weight
        xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(
            min=1e-12)
        wn = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp(
            min=1e-12)
        out = xn @ wn.T
        return (out[0] if input.dim() == 1 else out), state


class CosineDistance(AbstractModule):
    """Row-wise cosine similarity of a Table (or tuple) pair."""

    def run(self, input, state=None):
        x1, x2 = (input[1], input[2]) if isinstance(input, Table) \
            else (input[0], input[1])
        return cosine_similarity(x1, x2), state
