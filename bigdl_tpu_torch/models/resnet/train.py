"""ResNet training main of the port, on the synthetic CIFAR-10 set.

Counterpart of ``bigdl_tpu/models/resnet/train.py``: builds
``ResNet(classes, {"depth", "dataSet", "shortcutType"})``, trains it with
``SGD`` (momentum, weight decay, Nesterov by default, dampening 0) and
``ClassNLLCriterion`` through ``LocalOptimizer`` for ``--max-epoch``
epochs, validating with ``Top1Accuracy`` at every epoch's end, and prints
the final loss and the last Top-1. Runs on the card unless ``--device
cpu``; ``BIGDL_COMPUTE_DTYPE=bf16`` trains in bf16 mixed precision,
``BIGDL_FUSE_STEPS=K`` runs K steps a window, ``BIGDL_IMAGE_FORMAT=NHWC``
runs channels-last::

    python -m bigdl_tpu_torch.models.resnet.train --depth 20 -b 128
"""

from __future__ import annotations

import argparse
import sys

import torch

from bigdl_tpu_torch.models.unported import refuse_unported

#: flags and values of the JAX main that this port does not take yet, and
#: the ROADMAP item that brings each
UNPORTED_FLAGS = {
    "--dataset=ImageNet": "Queue A.4 (the folder-backed image pipeline: "
                          "dataset/image*.py, imagenet_sets)",
    "--folder": "Queue A.4 (the folder-backed image pipeline: "
                "dataset/image*.py)",
    "--checkpoint": "Queue A.1.6 (checkpointing and resume)",
    "--summary-dir": "Queue A.1.6 (train/val summaries)",
    "--distributed": "Queue A.6 (DistriOptimizer)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ResNet training (PyTorch port)")
    p.add_argument("--dataset", default="CIFAR-10", choices=["CIFAR-10"])
    p.add_argument("--depth", type=int, default=20)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--shortcut-type", default=None, choices=["A", "B", "C"])
    p.add_argument("-b", "--batch-size", type=int, default=128)
    p.add_argument("--max-epoch", type=int, default=1)
    p.add_argument("--learning-rate", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--nesterov", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--synthetic-size", type=int, default=1024)
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    return p


def main(argv=None):
    """Train; returns the ``LocalOptimizer`` (its ``state`` holds the final
    loss and the validation scores)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_unported(argv, UNPORTED_FLAGS)
    args = build_parser().parse_args(argv)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import cifar
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.optim.validation import Top1Accuracy
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    RandomGenerator.set_seed(0)
    train_set, test_set = cifar.train_val_sets(
        None, args.batch_size, synthetic_size=args.synthetic_size)
    opt = {"depth": args.depth, "dataSet": args.dataset}
    if args.shortcut_type:
        opt["shortcutType"] = args.shortcut_type
    model = ResNet(args.classes, opt,
                   generator=torch.Generator().manual_seed(0),
                   device=args.device)
    optimizer = (LocalOptimizer(model, train_set, nn.ClassNLLCriterion(),
                                device=args.device)
                 .set_optim_method(SGD(learningrate=args.learning_rate,
                                       momentum=args.momentum,
                                       weightdecay=args.weight_decay,
                                       nesterov=args.nesterov,
                                       dampening=0.0))
                 .set_end_when(Trigger.max_epoch(args.max_epoch))
                 .set_validation(Trigger.every_epoch(), test_set,
                                 [Top1Accuracy()]))
    optimizer.optimize()
    print(f"final loss: {optimizer.state['loss']:.4f}, Top1Accuracy: "
          f"{optimizer.state['score']:.4f}")
    return optimizer


if __name__ == "__main__":
    main()
