"""Sample and MiniBatch.

Counterpart of ``bigdl_tpu/dataset/sample.py``: a ``Sample`` is (feature
arrays, label arrays); ``SampleToMiniBatch`` stacks them into fixed-size
host batches. ``pad_last=True`` repeats the last sample so every batch has
``batch_size`` rows and records the real count in ``valid``;
``pad_last=False`` drops the final partial batch. The preallocated buffer
ring of the JAX package is not ported: every batch is a fresh
``np.stack``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer


class Sample:
    def __init__(self, feature, label=None):
        self.feature = (tuple(np.asarray(f) for f in feature)
                        if isinstance(feature, (tuple, list))
                        else (np.asarray(feature),))
        if label is None:
            self.label = ()
        else:
            self.label = (tuple(np.asarray(l) for l in label)
                          if isinstance(label, (tuple, list))
                          else (np.asarray(label),))

    def __repr__(self):
        fs = ",".join(str(f.shape) for f in self.feature)
        ls = ",".join(str(l.shape) for l in self.label)
        return f"Sample(feature={fs}, label={ls})"


class MiniBatch:
    """Stacked batch. ``size()`` is the padded batch size; ``valid`` the
    real sample count."""

    def __init__(self, input, target=None, valid: Optional[int] = None):
        self.input = input
        self.target = target
        self.valid = valid if valid is not None else _batch_dim(input)

    def size(self) -> int:
        return _batch_dim(self.input)

    def __repr__(self):
        return f"MiniBatch(size={self.size()}, valid={self.valid})"


def _batch_dim(x) -> int:
    if isinstance(x, (tuple, list)):
        return _batch_dim(x[0])
    return int(np.asarray(x).shape[0])


class SampleToMiniBatch(Transformer):
    """Group Samples into fixed-size MiniBatches."""

    def __init__(self, batch_size: int, pad_last: bool = True):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.batch_size = batch_size
        self.pad_last = pad_last

    def __call__(self, prev: Iterator) -> Iterator:
        buf: list[Sample] = []
        for s in prev:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield _stack(buf)
                buf = []
        if buf and self.pad_last:
            valid = len(buf)
            buf.extend([buf[-1]] * (self.batch_size - valid))
            yield _stack(buf, valid)


def _stack(samples: Sequence[Sample], valid: Optional[int] = None
           ) -> MiniBatch:
    n_f, n_l = len(samples[0].feature), len(samples[0].label)
    feats = tuple(np.stack([s.feature[i] for s in samples])
                  for i in range(n_f))
    labels = tuple(np.stack([s.label[i] for s in samples])
                   for i in range(n_l))
    input = feats[0] if n_f == 1 else feats
    target = (labels[0] if n_l == 1 else labels) if n_l else None
    return MiniBatch(input, target,
                     valid if valid is not None else len(samples))
