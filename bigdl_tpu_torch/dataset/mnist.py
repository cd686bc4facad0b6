"""MNIST, the synthetic set.

Counterpart of the synthetic path of ``bigdl_tpu/dataset/mnist.py``:
``synthetic_mnist`` (blurred class prototypes plus noise, uint8, numpy
only, the same seeds as JAX's), ``load_mnist`` without a folder and
``to_samples`` (normalised NCHW (1, 28, 28) features). Reading the idx
files (a ``folder``) is not ported: no dataset is in the repo.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample

TRAIN_MEAN, TRAIN_STD = 0.13066047740240005, 0.3081078


def synthetic_mnist(n: int, seed: int = 0):
    """``(images uint8 (n, 28, 28), labels int32 (n,))``; the 10 prototypes
    are fixed, ``seed`` draws the labels and the noise."""
    rng = np.random.default_rng(seed)
    protos = np.random.default_rng(1234).uniform(
        0, 1, size=(10, 28, 28)).astype(np.float32)
    for _ in range(3):
        protos = (protos + np.roll(protos, 1, 1) + np.roll(protos, -1, 1)
                  + np.roll(protos, 1, 2) + np.roll(protos, -1, 2)) / 5.0
    labels = rng.integers(0, 10, size=n)
    imgs = protos[labels] + rng.normal(0, 0.15, size=(n, 28, 28)).astype(
        np.float32)
    imgs = np.clip(imgs, 0, 1)
    return (imgs * 255).astype(np.uint8), labels.astype(np.int32)


def load_mnist(folder: Optional[str] = None, split: str = "train",
               synthetic_size: int = 2048):
    """The synthetic split (train seed 0, test seed 1)."""
    if folder:
        raise NotImplementedError(
            "reading MNIST idx files is not ported yet: ROADMAP Queue A.4 "
            "(dataset/image*.py, the folder-backed image pipeline)")
    return synthetic_mnist(synthetic_size, seed=0 if split == "train" else 1)


def to_samples(images: np.ndarray, labels: np.ndarray,
               mean: float = TRAIN_MEAN, std: float = TRAIN_STD) -> list:
    """Normalise and wrap as Samples with (1, 28, 28) features."""
    imgs = (images.astype(np.float32) / 255.0 - mean) / std
    return [Sample(imgs[i][None, :, :], np.int32(labels[i]))
            for i in range(len(labels))]
