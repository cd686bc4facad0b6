"""LeNet-5 training main of the port, on MNIST.

Counterpart of ``bigdl_tpu/models/lenet/train.py``: ``LeNet5(10)`` trained
with ``SGD(learning rate, decay)`` and ``ClassNLLCriterion`` through
``LocalOptimizer`` for ``--max-epoch`` epochs, validated with
``Top1Accuracy`` at every epoch's end; prints the final loss and the last
Top-1. The data are MNIST's idx files under ``--folder`` (else the
synthetic set); ``--model-snapshot`` starts from a saved module (either
format of ``AbstractModule.load``, JAX's files too) and
``--state-snapshot`` from a pickled optim method (``utils/file.py``). Runs
on the card unless ``--device cpu``::

    python -m bigdl_tpu_torch.models.lenet.train -b 128
"""

from __future__ import annotations

import argparse
import sys

import torch

from bigdl_tpu_torch.models.mains import (
    add_distributed_flag, distributed_setup, seed_as_jax, trainer,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LeNet-5 on MNIST (PyTorch port)")
    p.add_argument("-f", "--folder", default=None,
                   help="MNIST data dir (idx files)")
    p.add_argument("-b", "--batch-size", type=int, default=128)
    p.add_argument("--learning-rate", type=float, default=0.05)
    p.add_argument("--learning-rate-decay", type=float, default=0.0)
    p.add_argument("--max-epoch", type=int, default=1)
    p.add_argument("--synthetic-size", type=int, default=2048)
    p.add_argument("--checkpoint", default=None, help="checkpoint dir")
    p.add_argument("--overwrite-checkpoint", action="store_true")
    p.add_argument("--model-snapshot", default=None,
                   help="resume model snapshot")
    p.add_argument("--state-snapshot", default=None,
                   help="resume optim state snapshot")
    p.add_argument("--summary-dir", default=None,
                   help="TensorBoard summary dir")
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    add_distributed_flag(p)
    return p


def main(argv=None):
    """Train; returns the ``LocalOptimizer``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    seed_as_jax()
    distributed_setup(args)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.dataset.mnist import load_mnist, to_samples
    from bigdl_tpu_torch.models.lenet import LeNet5
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.optim.validation import Top1Accuracy

    train = to_samples(*load_mnist(args.folder, "train",
                                   synthetic_size=args.synthetic_size))
    test = to_samples(*load_mnist(
        args.folder, "test", synthetic_size=max(args.synthetic_size // 4, 256)))
    train_set = DataSet.array(train, distributed=args.distributed) >> SampleToMiniBatch(args.batch_size)
    test_set = DataSet.array(test, distributed=args.distributed) >> SampleToMiniBatch(args.batch_size)
    if args.model_snapshot:
        model = nn.AbstractModule.load(args.model_snapshot, args.device)
    else:
        model = LeNet5(10, generator=torch.Generator().manual_seed(0),
                       device=args.device)
    if args.state_snapshot:
        from bigdl_tpu_torch.utils import file as _file
        method = _file.load(args.state_snapshot)
    else:
        method = SGD(learningrate=args.learning_rate,
                     learningrate_decay=args.learning_rate_decay)
    optimizer = (trainer(args)(model, train_set, nn.ClassNLLCriterion(),
                                device=args.device)
                 .set_optim_method(method)
                 .set_end_when(Trigger.max_epoch(args.max_epoch))
                 .set_validation(Trigger.every_epoch(), test_set,
                                 [Top1Accuracy()]))
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
        optimizer.over_write_checkpoint(args.overwrite_checkpoint)
    if args.summary_dir:
        from bigdl_tpu_torch.visualization import (
            TrainSummary, ValidationSummary,
        )
        optimizer.set_train_summary(TrainSummary(args.summary_dir, "lenet"))
        optimizer.set_val_summary(ValidationSummary(args.summary_dir,
                                                    "lenet"))
    optimizer.optimize()
    print(f"final loss: {optimizer.state['loss']:.4f}, Top1Accuracy: "
          f"{optimizer.state['score']:.4f}")
    return optimizer


if __name__ == "__main__":
    main()
