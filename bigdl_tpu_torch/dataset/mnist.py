"""MNIST: the idx-file reader and the synthetic set.

Counterpart of ``bigdl_tpu/dataset/mnist.py``: ``load_mnist`` reads the
idx files under a ``folder`` (``train-images-idx3-ubyte``, ...; gzipped as
``.gz`` or not) and falls back, as JAX does, to ``synthetic_mnist``
(blurred class prototypes plus noise, uint8, numpy only, JAX's seeds) when
they are missing; ``to_samples`` gives normalised NCHW (1, 28, 28)
features.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample

TRAIN_MEAN, TRAIN_STD = 0.13066047740240005, 0.3081078

_IMAGES = {"train": "train-images-idx3-ubyte", "test": "t10k-images-idx3-ubyte"}
_LABELS = {"train": "train-labels-idx1-ubyte", "test": "t10k-labels-idx1-ubyte"}


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find(folder: str, base: str):
    for cand in (base, base + ".gz"):
        p = os.path.join(folder, cand)
        if os.path.exists(p):
            return p
    return None


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
    """``(images uint8 (N, 28, 28), labels int32 (N,))`` from the idx
    files under ``folder``, else the synthetic split (train seed 0, test
    seed 1)."""
    if folder:
        img_p = _find(folder, _IMAGES[split])
        lab_p = _find(folder, _LABELS[split])
        if img_p and lab_p:
            return _read_idx(img_p), _read_idx(lab_p).astype(np.int32)
    return synthetic_mnist(synthetic_size, seed=0 if split == "train" else 1)


def to_samples(images: np.ndarray, labels: np.ndarray,
               mean: float = TRAIN_MEAN, std: float = TRAIN_STD) -> list:
    """Normalise and wrap as Samples with (1, 28, 28) features."""
    imgs = (images.astype(np.float32) / 255.0 - mean) / std
    return [Sample(imgs[i][None, :, :], np.int32(labels[i]))
            for i in range(len(labels))]
