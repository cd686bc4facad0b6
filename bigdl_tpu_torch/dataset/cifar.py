"""CIFAR-10, the synthetic set.

Counterpart of the synthetic path of ``bigdl_tpu/dataset/cifar.py``:
``synthetic_cifar10`` (``:25``; smooth class prototypes plus noise, numpy
only, the same seeds, so both packages see the same images), ``normalize``
(``:93``), ``to_samples`` (``:99``) and ``train_val_sets`` (``:103``)
without a folder. Reading the CIFAR-10 files (a ``folder``) is not ported:
no dataset is in the repo.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from bigdl_tpu_torch.dataset.dataset import DataSet
from bigdl_tpu_torch.dataset.sample import Sample, SampleToMiniBatch

TRAIN_MEAN = (0.4914, 0.4822, 0.4465)
TRAIN_STD = (0.2470, 0.2435, 0.2616)


def synthetic_cifar10(n: int, seed: int = 0):
    """``(images float32 (n, 3, 32, 32) in [0, 1], labels int32 (n,))``: a
    learnable stand-in, 10 smooth 3-channel prototypes plus noise."""
    rng = np.random.default_rng(seed)
    protos = np.random.default_rng(4321).uniform(
        0, 1, size=(10, 3, 32, 32)).astype(np.float32)
    for _ in range(3):
        protos = (protos + np.roll(protos, 1, 2) + np.roll(protos, -1, 2)
                  + np.roll(protos, 1, 3) + np.roll(protos, -1, 3)) / 5.0
    labels = rng.integers(0, 10, size=n)
    imgs = protos[labels] + rng.normal(0, 0.15, size=(n, 3, 32, 32)).astype(
        np.float32)
    return np.clip(imgs, 0, 1).astype(np.float32), labels.astype(np.int32)


def load_cifar10(folder: Optional[str] = None, split: str = "train",
                 synthetic_size: Optional[int] = None):
    """The synthetic split (train seed 0, test seed 1)."""
    if folder:
        raise NotImplementedError(
            "reading CIFAR-10 files is not ported yet: ROADMAP Queue A.4 "
            "(dataset/image*.py, the folder-backed image pipeline)")
    n = synthetic_size or (2048 if split == "train" else 512)
    return synthetic_cifar10(n, seed=0 if split == "train" else 1)


def normalize(images: np.ndarray) -> np.ndarray:
    mean = np.asarray(TRAIN_MEAN, np.float32).reshape(1, 3, 1, 1)
    std = np.asarray(TRAIN_STD, np.float32).reshape(1, 3, 1, 1)
    return (images - mean) / std


def to_samples(images: np.ndarray, labels: np.ndarray) -> list:
    return [Sample(images[i], labels[i]) for i in range(len(images))]


def train_val_sets(folder: Optional[str], batch_size: int,
                   synthetic_size: int = 1024):
    """Normalised train and validation MiniBatch datasets, the pipeline of
    the CIFAR training mains (ResNet, VGG)."""
    imgs, labels = load_cifar10(folder, "train",
                                synthetic_size=synthetic_size)
    timgs, tlabels = load_cifar10(folder, "test",
                                  synthetic_size=max(synthetic_size // 4, 256))
    train_set = (DataSet.array(to_samples(normalize(imgs), labels))
                 >> SampleToMiniBatch(batch_size))
    test_set = (DataSet.array(to_samples(normalize(timgs), tlabels))
                >> SampleToMiniBatch(batch_size))
    return train_set, test_set
