"""Text-classification training main of the port.

Counterpart of ``bigdl_tpu/models/textclassifier/train.py``: with no corpus
on disk it makes JAX's synthetic topic task (each class has its own keyword
vocabulary mixed into shared filler words), tokenizes the sentences with
``SentenceTokenizer``, builds a ``Dictionary``, pads or cuts the ids to
``--seq-len`` and trains ``TextClassifier`` with ``Adam`` and
``ClassNLLCriterion`` through ``LocalOptimizer``, validated with
``Top1Accuracy`` on the last tenth at every epoch's end. Prints the
held-out accuracy. Runs on the card unless ``--device cpu``::

    python -m bigdl_tpu_torch.models.textclassifier.train
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from bigdl_tpu_torch.models.mains import (
    add_distributed_flag, distributed_setup, seed_as_jax, trainer,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Temporal-CNN text "
                                            "classification (PyTorch port)")
    p.add_argument("-b", "--batch-size", type=int, default=64)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--max-epoch", type=int, default=4)
    p.add_argument("--sentences", type=int, default=2048)
    p.add_argument("--classes", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--vocab-size", type=int, default=2000)
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    add_distributed_flag(p)
    return p


def synthetic_corpus(n: int, classes: int, seed=0):
    """Sentences of filler words and class keywords (a learnable topic)
    and their labels, as JAX draws them."""
    rng = np.random.default_rng(seed)
    filler = [f"word{i}" for i in range(200)]
    keywords = [[f"topic{c}kw{i}" for i in range(20)] for c in range(classes)]
    texts, labels = [], []
    for _ in range(n):
        c = int(rng.integers(0, classes))
        length = int(rng.integers(8, 24))
        words = [filler[rng.integers(0, len(filler))] for _ in range(length)]
        for _ in range(max(2, length // 5)):
            pos = int(rng.integers(0, len(words)))
            words[pos] = keywords[c][rng.integers(0, 20)]
        texts.append(" ".join(words))
        labels.append(c)
    return texts, np.asarray(labels, np.int32)


def texts_to_samples(texts, labels, dictionary, seq_len):
    """``Sample``s of the texts' ids, padded with 0 or cut to
    ``seq_len``."""
    from bigdl_tpu_torch.dataset import Sample, SentenceTokenizer
    tok = SentenceTokenizer()
    samples = []
    for text, y in zip(texts, labels):
        ids = [dictionary.get_index(t) for t in tok.tokens(text)]
        ids = ids[:seq_len] + [0] * max(0, seq_len - len(ids))
        samples.append(Sample(np.asarray(ids, np.int32), np.int32(y)))
    return samples


def main(argv=None):
    """Train; returns the ``LocalOptimizer``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    seed_as_jax(always=True)
    distributed_setup(args)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import (
        DataSet, Dictionary, SampleToMiniBatch, SentenceTokenizer,
    )
    from bigdl_tpu_torch.models.textclassifier import TextClassifier
    from bigdl_tpu_torch.optim import Adam, Trigger
    from bigdl_tpu_torch.optim.validation import Top1Accuracy

    texts, labels = synthetic_corpus(args.sentences, args.classes)
    tok = SentenceTokenizer()
    dictionary = Dictionary((t for text in texts for t in tok.tokens(text)),
                            vocab_size=args.vocab_size)
    samples = texts_to_samples(texts, labels, dictionary, args.seq_len)
    split = int(0.9 * len(samples))
    train = DataSet.array(samples[:split],
                          distributed=args.distributed) >> SampleToMiniBatch(
        args.batch_size)
    test = DataSet.array(samples[split:]) >> SampleToMiniBatch(
        args.batch_size)
    model = TextClassifier(dictionary.vocab_size(), args.classes,
                           seq_len=args.seq_len,
                           generator=torch.Generator().manual_seed(0),
                           device=args.device)
    opt = (trainer(args)(model, train, nn.ClassNLLCriterion(),
                          device=args.device)
           .set_optim_method(Adam(learningrate=args.learning_rate))
           .set_end_when(Trigger.max_epoch(args.max_epoch))
           .set_validation(Trigger.every_epoch(), test, [Top1Accuracy()]))
    opt.optimize()
    acc = opt.state["scores"]["Top1Accuracy"]
    print(f"final loss: {opt.state['loss']:.4f}, TextClassifier held-out "
          f"Top1Accuracy: {acc:.4f}")
    return opt


if __name__ == "__main__":
    main()
