"""Wide & Deep training main of the port, on synthetic tabular data.

Counterpart of ``bigdl_tpu/models/widedeep/train.py`` with its flags and
defaults: each example has ``--wide-k`` wide ids (one carries the label
with noise), ``--deep-k`` deep category ids and ``--dense-dim`` numeric
columns; 90% train ``WideAndDeep`` with Adam and ``ClassNLLCriterion``,
the rest validate (Top1Accuracy, which must beat the class prior). Runs
on the card unless ``--device cpu``::

    python -m bigdl_tpu_torch.models.widedeep.train
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
    p = argparse.ArgumentParser(
        description="Wide&Deep on synthetic tabular data (PyTorch port)")
    p.add_argument("-b", "--batch-size", type=int, default=256)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--max-epoch", type=int, default=5)
    p.add_argument("--examples", type=int, default=8192)
    p.add_argument("--wide-features", type=int, default=500)
    p.add_argument("--deep-vocab", type=int, default=200)
    p.add_argument("--dense-dim", type=int, default=8)
    p.add_argument("--wide-k", type=int, default=4)
    p.add_argument("--deep-k", type=int, default=6)
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    add_distributed_flag(p)
    return p


def synthetic_tabular(n, wide_features, deep_vocab, dense_dim, wide_k, deep_k,
                      seed=0):
    """JAX's samples, draw for draw: the label from a memorizable wide id
    and a dense linear rule, so both branches matter."""
    from bigdl_tpu_torch.dataset import Sample
    rng = np.random.default_rng(seed)
    wide_signal = rng.integers(0, 2, size=wide_features)
    w_dense = rng.normal(size=dense_dim)
    samples = []
    for _ in range(n):
        wide_ids = rng.choice(wide_features, size=wide_k, replace=False)
        deep_ids = rng.choice(deep_vocab, size=deep_k, replace=False)
        dense = rng.normal(size=dense_dim).astype(np.float32)
        logit = (2.0 * wide_signal[wide_ids[0]] - 1.0) + dense @ w_dense
        y = np.int32(1 if logit + 0.3 * rng.normal() > 0 else 0)
        samples.append(Sample((wide_ids.astype(np.int32),
                               deep_ids.astype(np.int32), dense), y))
    return samples


def main(argv=None):
    """Train; returns the held-out Top1Accuracy."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    seed_as_jax(always=True)
    distributed_setup(args)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.models.widedeep import WideAndDeep
    from bigdl_tpu_torch.optim import (
        Adam, Top1Accuracy, Trigger,
    )

    samples = synthetic_tabular(args.examples, args.wide_features,
                                args.deep_vocab, args.dense_dim,
                                args.wide_k, args.deep_k)
    split = int(0.9 * len(samples))
    train = DataSet.array(samples[:split],
                          distributed=args.distributed) >> SampleToMiniBatch(
        args.batch_size)
    test = DataSet.array(samples[split:]) >> SampleToMiniBatch(
        args.batch_size)
    model = WideAndDeep(args.wide_features, args.deep_vocab, args.dense_dim,
                        generator=torch.Generator().manual_seed(0),
                        device=args.device)
    opt = (trainer(args)(model, train, nn.ClassNLLCriterion(),
                          device=args.device)
           .set_optim_method(Adam(learningrate=args.learning_rate))
           .set_end_when(Trigger.max_epoch(args.max_epoch))
           .set_validation(Trigger.every_epoch(), test, [Top1Accuracy()]))
    opt.optimize()
    acc = opt.state["scores"]["Top1Accuracy"]
    print(f"final loss: {opt.state['loss']:.6f}")
    print(f"Wide&Deep held-out Top1Accuracy: {acc:.4f}")
    return acc


if __name__ == "__main__":
    main()
