"""Token streams for language-model training.

Counterpart of ``bigdl_tpu/dataset/text.py`` for ``synthetic_ptb`` (the
deterministic Markov corpus the training main uses when no corpus is given)
and ``ptb_windows``. The dictionary, tokenizers and the PTB reader are not
ported.
"""

from __future__ import annotations

import numpy as np


def ptb_windows(ids: np.ndarray, bptt: int):
    """Slice a token-id stream into (input, target) windows of length
    ``bptt``; the target is the input shifted by one token."""
    n = (len(ids) - 1) // bptt
    xs = ids[:n * bptt].reshape(n, bptt)
    ys = ids[1:n * bptt + 1].reshape(n, bptt)
    return xs.astype(np.int32), ys.astype(np.int32)


def synthetic_ptb(n_tokens: int, vocab_size: int = 1000, seed: int = 0
                  ) -> np.ndarray:
    """Deterministic Markov-chain corpus: each token strongly predicts its
    successor (4 likely successors per token, 10% uniform noise)."""
    rng = np.random.default_rng(seed)
    succ = np.random.default_rng(99).integers(1, vocab_size,
                                              size=(vocab_size, 4))
    ids = np.empty(n_tokens, np.int32)
    ids[0] = 1
    noise = rng.random(n_tokens)
    choice = rng.integers(0, 4, size=n_tokens)
    rand_tok = rng.integers(1, vocab_size, size=n_tokens)
    for i in range(1, n_tokens):
        ids[i] = succ[ids[i - 1], choice[i]] if noise[i] > 0.1 \
            else rand_tok[i]
    return ids
