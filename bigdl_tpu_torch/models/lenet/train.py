"""LeNet-5 training main of the port, on the synthetic MNIST set.

Counterpart of ``bigdl_tpu/models/lenet/train.py``: ``LeNet5(10)`` trained
with ``SGD(learning rate, decay)`` and ``ClassNLLCriterion`` through
``LocalOptimizer`` for ``--max-epoch`` epochs, validated with
``Top1Accuracy`` at every epoch's end; prints the final loss and the last
Top-1. Runs on the card unless ``--device cpu``::

    python -m bigdl_tpu_torch.models.lenet.train -b 128
"""

from __future__ import annotations

import argparse
import sys

import torch

from bigdl_tpu_torch.models.unported import refuse_unported

UNPORTED_FLAGS = {
    "--folder": "Queue A.4 (the folder-backed image pipeline: "
                "dataset/image*.py)",
    "--checkpoint": "Queue A.1.6 (checkpointing and resume)",
    "--overwrite-checkpoint": "Queue A.1.6 (checkpointing and resume)",
    "--model-snapshot": "Queue A.6 (module save/load)",
    "--state-snapshot": "Queue A.6 (utils/file.py)",
    "--summary-dir": "Queue A.1.6 (train/val summaries)",
    "--distributed": "Queue A.6 (DistriOptimizer)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LeNet-5 on MNIST (PyTorch port)")
    p.add_argument("-b", "--batch-size", type=int, default=128)
    p.add_argument("--learning-rate", type=float, default=0.05)
    p.add_argument("--learning-rate-decay", type=float, default=0.0)
    p.add_argument("--max-epoch", type=int, default=1)
    p.add_argument("--synthetic-size", type=int, default=2048)
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    return p


def main(argv=None):
    """Train; returns the ``LocalOptimizer``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_unported(argv, UNPORTED_FLAGS)
    args = build_parser().parse_args(argv)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.dataset.mnist import load_mnist, to_samples
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.optim.validation import Top1Accuracy
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    RandomGenerator.set_seed(0)
    train = to_samples(*load_mnist(None, "train",
                                   synthetic_size=args.synthetic_size))
    test = to_samples(*load_mnist(
        None, "test", synthetic_size=max(args.synthetic_size // 4, 256)))
    train_set = DataSet.array(train) >> SampleToMiniBatch(args.batch_size)
    test_set = DataSet.array(test) >> SampleToMiniBatch(args.batch_size)
    model = LeNet5(10, generator=torch.Generator().manual_seed(0),
                   device=args.device)
    optimizer = (LocalOptimizer(model, train_set, nn.ClassNLLCriterion(),
                                device=args.device)
                 .set_optim_method(SGD(
                     learningrate=args.learning_rate,
                     learningrate_decay=args.learning_rate_decay))
                 .set_end_when(Trigger.max_epoch(args.max_epoch))
                 .set_validation(Trigger.every_epoch(), test_set,
                                 [Top1Accuracy()]))
    optimizer.optimize()
    print(f"final loss: {optimizer.state['loss']:.4f}, Top1Accuracy: "
          f"{optimizer.state['score']:.4f}")
    return optimizer


if __name__ == "__main__":
    main()
