"""VGG-for-CIFAR-10 training main of the port, on CIFAR-10.

Counterpart of ``bigdl_tpu/models/vgg/train.py``: ``VggForCifar10(10)``
trained with ``SGD`` (momentum, weight decay, dampening 0) and
``ClassNLLCriterion`` through ``LocalOptimizer`` for ``--max-epoch``
epochs, validated with ``Top1Accuracy`` at every epoch's end; prints the
final loss and the last Top-1. The data are CIFAR-10's batches under
``--folder`` (python or binary layout), else the synthetic set. Runs on
the card unless ``--device cpu``::

    python -m bigdl_tpu_torch.models.vgg.train -b 128
"""

from __future__ import annotations

import argparse
import sys

import torch

from bigdl_tpu_torch.models.mains import (
    add_distributed_flag, distributed_setup, seed_as_jax, trainer,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VggForCifar10 training "
                                            "(PyTorch port)")
    p.add_argument("-f", "--folder", default=None,
                   help="CIFAR-10 batches dir (python or binary layout)")
    p.add_argument("-b", "--batch-size", type=int, default=128)
    p.add_argument("--max-epoch", type=int, default=1)
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--synthetic-size", type=int, default=512)
    p.add_argument("--checkpoint", default=None, help="checkpoint dir")
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
    from bigdl_tpu_torch.dataset import cifar
    from bigdl_tpu_torch.models.vgg import VggForCifar10
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.optim.validation import Top1Accuracy
    from bigdl_tpu_torch.utils.device import resolve_device

    train_set, test_set = cifar.train_val_sets(
        args.folder, args.batch_size, distributed=args.distributed,
        synthetic_size=args.synthetic_size)
    dev = resolve_device(args.device)
    # the dropout masks' generator, on the card for a captured step
    dropout_gen = torch.Generator(device=dev).manual_seed(0)
    model = VggForCifar10(10, generator=torch.Generator().manual_seed(0),
                          dropout_generator=dropout_gen, device=args.device)
    optimizer = (trainer(args)(model, train_set, nn.ClassNLLCriterion(),
                                device=args.device)
                 .set_optim_method(SGD(learningrate=args.learning_rate,
                                       momentum=args.momentum,
                                       weightdecay=args.weight_decay,
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
        optimizer.set_train_summary(TrainSummary(args.summary_dir, "vgg"))
        optimizer.set_val_summary(ValidationSummary(args.summary_dir,
                                                    "vgg"))
    optimizer.optimize()
    print(f"final loss: {optimizer.state['loss']:.4f}, Top1Accuracy: "
          f"{optimizer.state['score']:.4f}")
    return optimizer


if __name__ == "__main__":
    main()
