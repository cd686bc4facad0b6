"""Embedding lookup.

Counterpart of ``bigdl_tpu/nn/embedding.py`` ``LookupTable``: ids index the
rows of a (n_index, n_output) weight drawn from N(0, 1) by default. Ids are
1-based (Torch's convention) unless ``zero_based=True``, as in JAX; the
language model passes ``zero_based=True``. ``padding_value`` masks the
embedding of that id to zeros, with JAX's rule: in 1-based mode
``padding_value=0`` means no padding row (ids start at 1). ``max_norm`` is
not ported yet (ROADMAP Queue A.5).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.initialization import InitializationMethod, RandomNormal


class LookupTable(TensorModule):
    def __init__(self, n_index: int, n_output: int,
                 padding_value: Optional[float] = None,
                 w_init: Optional[InitializationMethod] = None,
                 zero_based: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.zero_based = zero_based
        w_init = w_init or RandomNormal(0.0, 1.0)
        self.weight = torch.nn.Parameter(w_init.init(
            (n_index, n_output), fan_in=n_index, fan_out=n_output,
            generator=generator))

    def _pad_index(self) -> Optional[int]:
        """The padding row as a 0-based index, or None when masking is
        off."""
        if self.padding_value is None:
            return None
        p = int(self.padding_value)
        if not self.zero_based:
            return None if p == 0 else p - 1
        return p

    def run(self, input, state=None):
        idx = input.long()
        if not self.zero_based:
            idx = idx - 1
        out = F.embedding(idx, self.weight)
        pad = self._pad_index()
        if pad is not None:
            out = out.masked_fill((idx == pad)[..., None], 0.0)
        return out, state

    def extra_repr(self):
        return f"{self.n_index} -> {self.n_output}"
