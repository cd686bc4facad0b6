"""CIFAR-10: the file readers and the synthetic set.

Counterpart of ``bigdl_tpu/dataset/cifar.py``: with a ``folder`` the
python-pickle batches (``data_batch_1..5``, ``test_batch``, also under
``cifar-10-batches-py/``) then the binary ones (``data_batch_*.bin``,
``test_batch.bin``: a label byte and 3072 pixel bytes a record, also under
``cifar-10-batches-bin/``) are read into JAX's arrays, and a folder without
them is an error; without one, ``synthetic_cifar10`` (smooth class
prototypes plus noise, numpy only, JAX's seeds). ``normalize``,
``to_samples`` and ``train_val_sets`` are JAX's.
"""

from __future__ import annotations

import os
import pickle
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


def _load_python_batches(folder: str, split: str):
    names = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
             else ["test_batch"])
    root = folder
    sub = os.path.join(folder, "cifar-10-batches-py")
    if os.path.isdir(sub):
        root = sub
    xs, ys = [], []
    for name in names:
        path = os.path.join(root, name)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32))
        ys.append(np.asarray(d[b"labels"], np.int64))
    return (np.concatenate(xs) / np.float32(255.0),
            np.concatenate(ys).astype(np.int32))


def _load_binary_batches(folder: str, split: str):
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if split == "train"
             else ["test_batch.bin"])
    root = folder
    sub = os.path.join(folder, "cifar-10-batches-bin")
    if os.path.isdir(sub):
        root = sub
    xs, ys = [], []
    for name in names:
        path = os.path.join(root, name)
        if not os.path.exists(path):
            return None
        raw = np.fromfile(path, np.uint8).reshape(-1, 3073)
        ys.append(raw[:, 0].astype(np.int64))
        xs.append(raw[:, 1:].reshape(-1, 3, 32, 32))
    return (np.concatenate(xs) / np.float32(255.0),
            np.concatenate(ys).astype(np.int32))


def load_cifar10(folder: Optional[str] = None, split: str = "train",
                 synthetic_size: Optional[int] = None):
    """``(images float32 NCHW in [0, 1], labels int32)``: the files under
    ``folder`` (python layout, then binary; none is an error), else the
    synthetic split (train seed 0, test seed 1)."""
    if folder:
        loaded = (_load_python_batches(folder, split)
                  or _load_binary_batches(folder, split))
        if loaded is None:
            raise FileNotFoundError(
                f"no CIFAR-10 batches (python or binary layout) under "
                f"{folder!r}")
        return loaded
    n = synthetic_size or (2048 if split == "train" else 512)
    return synthetic_cifar10(n, seed=0 if split == "train" else 1)


def normalize(images: np.ndarray) -> np.ndarray:
    mean = np.asarray(TRAIN_MEAN, np.float32).reshape(1, 3, 1, 1)
    std = np.asarray(TRAIN_STD, np.float32).reshape(1, 3, 1, 1)
    return (images - mean) / std


def to_samples(images: np.ndarray, labels: np.ndarray) -> list:
    return [Sample(images[i], labels[i]) for i in range(len(images))]


def train_val_sets(folder: Optional[str], batch_size: int,
                   distributed: bool = False, synthetic_size: int = 1024):
    """Normalised train and validation MiniBatch datasets, the pipeline of
    the CIFAR training mains (ResNet, VGG); ``distributed`` marks both for
    ``DistriOptimizer``, as JAX's does."""
    imgs, labels = load_cifar10(folder, "train",
                                synthetic_size=synthetic_size)
    timgs, tlabels = load_cifar10(folder, "test",
                                  synthetic_size=max(synthetic_size // 4, 256))
    train_set = (DataSet.array(to_samples(normalize(imgs), labels),
                               distributed=distributed)
                 >> SampleToMiniBatch(batch_size))
    test_set = (DataSet.array(to_samples(normalize(timgs), tlabels),
                              distributed=distributed)
                >> SampleToMiniBatch(batch_size))
    return train_set, test_set
