"""MNIST autoencoder training main of the port.

Counterpart of ``bigdl_tpu/models/autoencoder/train.py``: the images
scaled to [0, 1] and flattened are both input and target,
``Autoencoder(--bottleneck)`` is trained with ``Adam(--learning-rate)``
and ``MSECriterion`` through ``LocalOptimizer`` for ``--max-epoch``
epochs; prints the final loss. The images are MNIST's idx files under
``--folder`` (else the synthetic set). Runs on the card unless ``--device
cpu``::

    python -m bigdl_tpu_torch.models.autoencoder.train -b 128
"""

from __future__ import annotations

import argparse
import sys

import torch

from bigdl_tpu_torch.models.mains import (
    add_distributed_flag, distributed_setup, seed_as_jax, trainer,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="MNIST autoencoder (PyTorch port)")
    p.add_argument("-f", "--folder", default=None)
    p.add_argument("-b", "--batch-size", type=int, default=128)
    p.add_argument("--bottleneck", type=int, default=32)
    p.add_argument("--max-epoch", type=int, default=1)
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--synthetic-size", type=int, default=2048)
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

    import numpy as np

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.dataset.mnist import load_mnist
    from bigdl_tpu_torch.models.autoencoder import Autoencoder
    from bigdl_tpu_torch.optim import Adam, Trigger

    imgs, _ = load_mnist(args.folder, "train",
                         synthetic_size=args.synthetic_size)
    flat = (imgs.astype(np.float32) / 255.0).reshape(len(imgs), -1)
    train_set = (DataSet.array([Sample(x, x) for x in flat],
                                distributed=args.distributed)
                 >> SampleToMiniBatch(args.batch_size))
    model = Autoencoder(args.bottleneck,
                        generator=torch.Generator().manual_seed(0),
                        device=args.device)
    optimizer = (trainer(args)(model, train_set, nn.MSECriterion(),
                                device=args.device)
                 .set_optim_method(Adam(learningrate=args.learning_rate))
                 .set_end_when(Trigger.max_epoch(args.max_epoch)))
    optimizer.optimize()
    print(f"final loss: {optimizer.state['loss']:.6f}")
    return optimizer


if __name__ == "__main__":
    main()
