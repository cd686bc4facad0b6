"""Inception-v1/v2 training main of the port, on synthetic images.

Counterpart of ``bigdl_tpu/models/inception/train.py``, with its flags
(``:15-29``) and ``--device`` (default ``cuda``): with the aux heads the
loss is ``ParallelCriterion(repeat_target=True)`` over the three outputs
(main ×1.0, aux ×0.3); ``--no-aux`` trains the NoAuxClassifier variant with
``ClassNLLCriterion``; ``--v2`` the BN-Inception family. The data is JAX's
synthetic in-memory set (clustered blobs of ``--image-size`` pixels, NCHW
float32, 10 classes at most, so the loss visibly drops) through
``SampleToMiniBatch`` and the trainer's prefetching feed; prints the final
loss. Runs on the card unless ``--device cpu``::

    python -m bigdl_tpu_torch.models.inception.train -b 32
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from bigdl_tpu_torch.models.unported import refuse_unported

UNPORTED_FLAGS = {
    "--folder": "Queue A.4.2 (the folder-backed image pipeline: "
                "dataset/image*.py, models/imagenet_data.py)",
    "--distributed": "Queue A.6 (DistriOptimizer)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Inception-v1/v2 training "
                                            "(PyTorch port)")
    p.add_argument("-b", "--batch-size", type=int, default=32)
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--no-aux", action="store_true",
                   help="NoAuxClassifier variant")
    p.add_argument("--v2", action="store_true",
                   help="BN-Inception (Inception_v2)")
    p.add_argument("--max-iteration", type=int, default=4)
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--synthetic-size", type=int, default=64)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--device", default="cuda",
                   help="where to train: cuda (default) or cpu")
    return p


def synthetic_set(size: int, image_size: int, classes: int):
    """JAX's main's synthetic samples (``:53-64``): ``min(classes, 10)``
    gaussian prototypes plus noise, labels from seed 0, 0-based int32."""
    from bigdl_tpu_torch.dataset import Sample
    rng = np.random.default_rng(0)
    n_cls = min(classes, 10)
    protos = np.random.default_rng(7).normal(
        0, 1, size=(n_cls, 3, image_size, image_size)).astype(np.float32)
    labels = rng.integers(0, n_cls, size=size)
    imgs = (protos[labels]
            + rng.normal(0, 0.5, size=(size, 3, image_size, image_size))
            .astype(np.float32))
    return [Sample(x, y) for x, y in zip(imgs, labels.astype(np.int32))]


def main(argv=None):
    """Train; returns the ``LocalOptimizer``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_unported(argv, UNPORTED_FLAGS)
    args = build_parser().parse_args(argv)

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.models.inception import (
        Inception_v1, Inception_v1_NoAuxClassifier, Inception_v2,
        Inception_v2_NoAuxClassifier,
    )
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.device import resolve_device
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    RandomGenerator.set_seed(0)
    train_set = (DataSet.array(synthetic_set(
        args.synthetic_size, args.image_size, args.classes))
        >> SampleToMiniBatch(args.batch_size))
    dev = resolve_device(args.device)
    g = torch.Generator().manual_seed(0)
    # the dropout masks' generator, on the card for a captured step
    dropout_gen = torch.Generator(device=dev).manual_seed(0)
    if args.v2:
        model = (Inception_v2_NoAuxClassifier if args.no_aux
                 else Inception_v2)(args.classes, generator=g,
                                    device=args.device)
    else:
        model = (Inception_v1_NoAuxClassifier if args.no_aux
                 else Inception_v1)(args.classes, generator=g,
                                    dropout_generator=dropout_gen,
                                    device=args.device)
    if args.no_aux:
        criterion = nn.ClassNLLCriterion()
    else:
        criterion = (nn.ParallelCriterion(repeat_target=True)
                     .add(nn.ClassNLLCriterion(), 1.0)
                     .add(nn.ClassNLLCriterion(), 0.3)
                     .add(nn.ClassNLLCriterion(), 0.3))
    optimizer = (LocalOptimizer(model, train_set, criterion,
                                device=args.device)
                 .set_optim_method(SGD(learningrate=args.learning_rate,
                                       momentum=args.momentum,
                                       weightdecay=args.weight_decay,
                                       dampening=0.0))
                 .set_end_when(Trigger.max_iteration(args.max_iteration)))
    optimizer.optimize()
    print(f"final loss: {optimizer.state['loss']:.4f}")
    return optimizer


if __name__ == "__main__":
    main()
