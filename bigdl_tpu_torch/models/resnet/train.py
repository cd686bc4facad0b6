"""ResNet training main of the port: CIFAR-10 or ImageNet.

Counterpart of ``bigdl_tpu/models/resnet/train.py``: builds
``ResNet(classes, {"depth", "dataSet", "shortcutType"})``, trains it with
``SGD`` (momentum, weight decay, Nesterov by default, dampening 0) and
``ClassNLLCriterion`` through ``LocalOptimizer`` for ``--max-epoch``
epochs, validating with ``Top1Accuracy`` at every epoch's end, and prints
the final loss and the last Top-1. The data are CIFAR-10's batches under
``--folder`` (else the synthetic set) or, with ``--dataset ImageNet``, an
ImageNet-layout image folder through ``imagenet_sets`` (else a synthetic
folder of PNGs). Runs on the card unless ``--device
cpu``; ``BIGDL_COMPUTE_DTYPE=bf16`` trains in bf16 mixed precision,
``BIGDL_FUSE_STEPS=K`` runs K steps a window, ``BIGDL_IMAGE_FORMAT=NHWC``
runs channels-last::

    python -m bigdl_tpu_torch.models.resnet.train --depth 20 -b 128
    python -m bigdl_tpu_torch.models.resnet.train --dataset ImageNet \
        --depth 50 --classes 1000 -b 256 --folder /data/imagenet
"""

from __future__ import annotations

import argparse
import sys

import torch

from bigdl_tpu_torch.models.mains import (
    add_distributed_flag, distributed_setup, seed_as_jax, trainer,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ResNet training (PyTorch port)")
    p.add_argument("-f", "--folder", default=None, help="dataset dir")
    p.add_argument("--dataset", default="CIFAR-10",
                   choices=["CIFAR-10", "ImageNet"])
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
    p.add_argument("--checkpoint", default=None, help="checkpoint dir")
    p.add_argument("--summary-dir", default=None,
                   help="TensorBoard summary dir")
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    add_distributed_flag(p)
    return p


def main(argv=None):
    """Train; returns the ``LocalOptimizer`` (its ``state`` holds the final
    loss and the validation scores)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    seed_as_jax()
    distributed_setup(args)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import cifar
    from bigdl_tpu_torch.models.resnet import ResNet
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.optim.validation import Top1Accuracy

    if args.dataset == "ImageNet":
        from bigdl_tpu_torch.models.imagenet_data import imagenet_sets
        train_set, test_set = imagenet_sets(
            args.folder, args.batch_size, distributed=args.distributed,
            synthetic_per_class=max(args.synthetic_size // 4, 8))
    else:
        train_set, test_set = cifar.train_val_sets(
            args.folder, args.batch_size, distributed=args.distributed,
            synthetic_size=args.synthetic_size)
    opt = {"depth": args.depth, "dataSet": args.dataset}
    if args.shortcut_type:
        opt["shortcutType"] = args.shortcut_type
    model = ResNet(args.classes, opt,
                   generator=torch.Generator().manual_seed(0),
                   device=args.device)
    optimizer = (trainer(args)(model, train_set, nn.ClassNLLCriterion(),
                                device=args.device)
                 .set_optim_method(SGD(learningrate=args.learning_rate,
                                       momentum=args.momentum,
                                       weightdecay=args.weight_decay,
                                       nesterov=args.nesterov,
                                       dampening=0.0))
                 .set_end_when(Trigger.max_epoch(args.max_epoch))
                 .set_validation(Trigger.every_epoch(), test_set,
                                 [Top1Accuracy()]))
    if args.checkpoint:
        optimizer.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    if args.summary_dir:
        from bigdl_tpu_torch.visualization import (
            TrainSummary, ValidationSummary,
        )
        optimizer.set_train_summary(TrainSummary(args.summary_dir, "resnet"))
        optimizer.set_val_summary(ValidationSummary(args.summary_dir,
                                                    "resnet"))
    optimizer.optimize()
    print(f"final loss: {optimizer.state['loss']:.4f}, Top1Accuracy: "
          f"{optimizer.state['score']:.4f}")
    return optimizer


if __name__ == "__main__":
    main()
