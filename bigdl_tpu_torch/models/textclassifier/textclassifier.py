"""The temporal-CNN text classifier.

Counterpart of ``bigdl_tpu/models/textclassifier/textclassifier.py``: a
learned embedding (zero-based ids, 0 the unknown and padding word) ->
``TemporalConvolution`` -> ReLU -> ``TemporalMaxPooling(2)`` ->
``TemporalConvolution`` -> ReLU -> the global max over the remaining time
(``TemporalMaxPooling(-1)``) -> ``Squeeze(2)`` -> Linear -> LogSoftMax.
Sequences are padded or cut to a fixed length, so a captured step sees one
shape. Weights are drawn on the CPU from ``generator`` and the model is
moved to ``device`` (default the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def TextClassifier(vocab_size: int, class_num: int, embed_dim: int = 64,
                   seq_len: int = 64, conv_channels: int = 128,
                   kernel_w: int = 5, *,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> nn.Sequential:
    """Input (N, seq_len) int token ids; output (N, class_num)
    log-probabilities."""
    g = generator
    return (nn.Sequential()
            .add(nn.LookupTable(vocab_size, embed_dim, zero_based=True,
                                generator=g))
            .add(nn.TemporalConvolution(embed_dim, conv_channels, kernel_w,
                                        generator=g))
            .add(nn.ReLU())
            .add(nn.TemporalMaxPooling(2))
            .add(nn.TemporalConvolution(conv_channels, conv_channels,
                                        kernel_w, generator=g))
            .add(nn.ReLU())
            .add(nn.TemporalMaxPooling(-1))
            .add(nn.Squeeze(2))
            .add(nn.Linear(conv_channels, class_num, generator=g))
            .add(nn.LogSoftMax())).to(resolve_device(device))
