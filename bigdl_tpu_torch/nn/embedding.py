"""Embedding lookup.

Counterpart of ``bigdl_tpu/nn/embedding.py`` ``LookupTable`` as the
language model uses it (``zero_based=True``): ids are 0-based row indices
into a (n_index, n_output) weight drawn from N(0, 1) by default.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.initialization import InitializationMethod, RandomNormal


class LookupTable(TensorModule):
    def __init__(self, n_index: int, n_output: int,
                 w_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        w_init = w_init or RandomNormal(0.0, 1.0)
        self.weight = torch.nn.Parameter(w_init.init(
            (n_index, n_output), fan_in=n_index, fan_out=n_output,
            generator=generator))

    def run(self, input, state=None):
        return F.embedding(input.long(), self.weight), state

    def extra_repr(self):
        return f"{self.n_index} -> {self.n_output}"
