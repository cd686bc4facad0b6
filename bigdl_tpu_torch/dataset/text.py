"""Text pipeline: the dictionary, the tokenizer, the sentence-to-sample
transformers, PTB loading and the LM token streams.

Counterpart of ``bigdl_tpu/dataset/text.py`` (a copy of its pure-Python
parts, since the port imports nothing of the JAX package):

- ``Dictionary``: token <-> index, index 0 the unknown token ``<unk>``, the
  vocabulary capped to the most frequent tokens;
- ``SentenceTokenizer`` (lower-case word tokens), ``TextToLabeledSentence``
  (ids and their next-token labels) and ``LabeledSentenceToSample``, as
  ``Transformer``s (``dataset/transformer.py``; the tokenizer and the
  sample stage are element-wise, so they fuse);
- ``load_ptb``: ``ptb.<split>.txt`` under a folder, each line's end an
  ``<eos>`` token, or the deterministic synthetic corpus
  (``synthetic_ptb``) with the ``w{i}`` dictionary when the folder has no
  such file;
- ``ptb_windows``: (input, target) windows of a token stream.
"""

from __future__ import annotations

import os
import re
from collections import Counter
from typing import Iterable, Iterator, Optional

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer


class Dictionary:
    """Token <-> index mapping with a frequency-capped vocabulary; index 0
    is ``<unk>``, which unknown tokens map to."""

    UNK = "<unk>"

    def __init__(self, tokens: Optional[Iterable[str]] = None,
                 vocab_size: Optional[int] = None):
        self._word2idx: dict[str, int] = {self.UNK: 0}
        self._idx2word: list[str] = [self.UNK]
        if tokens is not None:
            self.build(tokens, vocab_size)

    def build(self, tokens: Iterable[str],
              vocab_size: Optional[int] = None) -> "Dictionary":
        """Add the most frequent tokens (ties in first-seen order) up to
        ``vocab_size`` entries, ``<unk>`` included."""
        counts = Counter(tokens)
        counts.pop(self.UNK, None)
        most = counts.most_common(None if vocab_size is None
                                  else vocab_size - 1)
        for w, _ in most:
            self._word2idx[w] = len(self._idx2word)
            self._idx2word.append(w)
        return self

    def get_index(self, word: str) -> int:
        return self._word2idx.get(word, 0)

    def get_word(self, index: int) -> str:
        return (self._idx2word[index] if 0 <= index < len(self._idx2word)
                else self.UNK)

    def vocab_size(self) -> int:
        return len(self._idx2word)

    def __len__(self) -> int:
        return len(self._idx2word)

    @classmethod
    def synthetic(cls, vocab: int) -> "Dictionary":
        """``<unk>`` and the words ``w1`` .. ``w{vocab-1}``: the synthetic
        corpus's dictionary."""
        d = cls()
        d._idx2word = [cls.UNK] + [f"w{i}" for i in range(1, vocab)]
        d._word2idx = {w: i for i, w in enumerate(d._idx2word)}
        return d


class SentenceTokenizer(Transformer):
    """Sentences -> lower-case word tokens (``pattern``'s matches)."""

    def __init__(self, pattern: str = r"[A-Za-z0-9<>']+"):
        self.pattern = re.compile(pattern)

    def tokens(self, sentence: str) -> list:
        return self.pattern.findall(sentence.lower())

    def __call__(self, prev: Iterator) -> Iterator:
        return (self.tokens(s) for s in prev)

    def element_fn(self):
        return self.tokens


class TextToLabeledSentence(Transformer):
    """Tokens -> (input ids, next-token labels) for LM training; a sentence
    of fewer than two tokens is dropped (so this stage is not
    element-wise)."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def __call__(self, prev: Iterator) -> Iterator:
        for tokens in prev:
            idx = np.asarray([self.dictionary.get_index(t) for t in tokens],
                             np.int32)
            if len(idx) < 2:
                continue
            yield idx[:-1], idx[1:]


class LabeledSentenceToSample(Transformer):
    """(input ids, labels) -> ``Sample``."""

    @staticmethod
    def _sample(pair) -> Sample:
        return Sample(pair[0], pair[1])

    def __call__(self, prev: Iterator) -> Iterator:
        return (self._sample(p) for p in prev)

    def element_fn(self):
        return self._sample


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


def load_ptb(folder: Optional[str] = None, split: str = "train",
             dictionary: Optional[Dictionary] = None, vocab_size: int = 10000,
             synthetic_size: Optional[int] = None):
    """``(token ids int32, Dictionary)`` of a PTB split: the words of
    ``ptb.<split>.txt`` under ``folder`` with ``<eos>`` at every line's end
    (the train split builds the dictionary; pass it back for valid and
    test), or, without that file, the synthetic corpus of
    ``synthetic_size`` tokens (20000 train, else 2000) over at most 1000
    words, and at most the given dictionary's words when there is one."""
    path = folder and os.path.join(folder, f"ptb.{split}.txt")
    if path and os.path.exists(path):
        with open(path) as f:
            words = f.read().replace("\n", " <eos> ").split()
        if dictionary is None:
            dictionary = Dictionary(words, vocab_size)
        ids = np.asarray([dictionary.get_index(w) for w in words], np.int32)
        return ids, dictionary
    n = synthetic_size or (20000 if split == "train" else 2000)
    # a given dictionary also bounds the ids: JAX draws the valid and test
    # splits over min(vocab_size, 1000) words whatever the train split's
    # dictionary holds, ids past it that its model clamps (the same ids
    # whenever they fit the dictionary)
    vocab = min(vocab_size, 1000, len(dictionary) if dictionary is not None
                else vocab_size)
    if dictionary is None:
        dictionary = Dictionary.synthetic(vocab)
    ids = synthetic_ptb(n, vocab, seed=0 if split == "train" else 1)
    return ids, dictionary
