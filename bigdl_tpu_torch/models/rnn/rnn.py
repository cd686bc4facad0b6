"""RNN language models: the PTB word-level LSTM LM and ``SimpleRNN``.

Counterpart of ``bigdl_tpu/models/rnn/rnn.py:22-48``. ``PTBModel`` is
``LookupTable(vocab -> hidden, zero_based=True)`` ("embedding"), then
``num_layers`` ``Recurrent(LSTM)`` layers ("lstm1", ...), a
``TimeDistributed(Linear(hidden -> vocab))`` ("decoder") and a
``TimeDistributed(LogSoftMax)``, trained with
``TimeDistributedCriterion(ClassNLLCriterion())`` on bptt windows;
``Dropout`` goes before each LSTM layer and before the decoder when
``dropout > 0``, never inside a cell. BASELINE.md config 4. ``SimpleRNN``
is the tanh-cell variant. Weights are drawn on the CPU from ``generator``
and the model is moved to ``device`` (default the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def PTBModel(input_size: int, hidden_size: int = 650,
             output_size: Optional[int] = None, num_layers: int = 2,
             dropout: float = 0.0, key_proj: bool = False, *,
             generator: Optional[torch.Generator] = None,
             device=None) -> nn.Sequential:
    """Word-level PTB LSTM LM; ``input_size``/``output_size`` are the
    vocabulary size."""
    g = generator
    dev = resolve_device(device)
    output_size = output_size if output_size is not None else input_size
    model = nn.Sequential().add(
        nn.LookupTable(input_size, hidden_size, zero_based=True, generator=g)
        .set_name("embedding"))
    for i in range(num_layers):
        if dropout > 0:
            model.add(nn.Dropout(dropout))
        model.add(nn.Recurrent(nn.LSTM(hidden_size, hidden_size, generator=g))
                  .set_name(f"lstm{i + 1}"))
    if dropout > 0:
        model.add(nn.Dropout(dropout))
    model.add(nn.TimeDistributed(nn.Linear(hidden_size, output_size,
                                           generator=g)).set_name("decoder"))
    model.add(nn.TimeDistributed(nn.LogSoftMax()))
    return model.to(dev)


def SimpleRNN(input_size: int, hidden_size: int, output_size: int, *,
              generator: Optional[torch.Generator] = None,
              device=None) -> nn.Sequential:
    """Tanh-cell RNN LM (1-based ids, as JAX's)."""
    g = generator
    return (nn.Sequential()
            .add(nn.LookupTable(input_size, hidden_size, generator=g))
            .add(nn.Recurrent(nn.RnnCell(hidden_size, hidden_size,
                                         generator=g)))
            .add(nn.TimeDistributed(nn.Linear(hidden_size, output_size,
                                              generator=g)))
            .add(nn.TimeDistributed(nn.LogSoftMax()))).to(
        resolve_device(device))
