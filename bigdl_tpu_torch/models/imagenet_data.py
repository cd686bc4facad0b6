"""Shared ImageNet-style data pipelines of the vision model mains.

Counterpart of ``bigdl_tpu/models/imagenet_data.py``: the source is the
on-disk image folder (``dataset/image_folder.py``) streaming through the
vision transformer pipeline; with no folder a small synthetic
ImageNet-layout directory of PNGs is written (JAX's arrays) so every main
runs end to end.

Train: aspect-scale → random crop → random hflip → channel normalize → CHW.
Val:   aspect-scale → center crop → channel normalize → CHW.
Normalisation uses the standard ImageNet RGB statistics on the 0-255 scale.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet, DataSet
from bigdl_tpu_torch.dataset.sample import SampleToMiniBatch
from bigdl_tpu_torch.transform.vision.image import (
    AspectScale, CenterCrop, ChannelNormalize, ImageFrameToSample, MatToTensor,
    RandomCrop, RandomHFlip,
)

IMAGENET_RGB_MEANS = (123.68, 116.779, 103.939)
IMAGENET_RGB_STDS = (58.393, 57.12, 57.375)


def _split_dir(folder: str, split: str) -> str:
    sub = os.path.join(folder, split)
    return sub if os.path.isdir(sub) else folder


def imagenet_sets(folder: Optional[str], batch_size: int, crop: int = 224,
                  distributed: bool = False, num_workers: int = 8,
                  synthetic_classes: int = 4, synthetic_per_class: int = 32,
                  ) -> tuple[AbstractDataSet, AbstractDataSet]:
    """(train_set, val_set) of MiniBatches from ``folder`` (``train/`` and
    ``val/`` subdirs honored when present), or from a synthetic fallback
    directory."""
    if folder is None:
        from bigdl_tpu_torch.dataset.image_folder import (
            write_synthetic_image_folder,
        )
        folder = tempfile.mkdtemp(prefix="bigdl_synth_imagenet_")
        write_synthetic_image_folder(
            folder, n_classes=synthetic_classes,
            n_per_class=synthetic_per_class, size=crop + crop // 4)

    scale = crop * 256 // 224
    train = (DataSet.image_folder(_split_dir(folder, "train"),
                                  num_workers=num_workers,
                                  distributed=distributed)
             >> AspectScale(scale)
             >> RandomCrop(crop, crop)
             >> RandomHFlip()
             >> ChannelNormalize(IMAGENET_RGB_MEANS, IMAGENET_RGB_STDS)
             >> MatToTensor()
             >> ImageFrameToSample()
             >> SampleToMiniBatch(batch_size))
    val = (DataSet.image_folder(_split_dir(folder, "val"),
                                num_workers=num_workers,
                                distributed=distributed)
           >> AspectScale(scale)
           >> CenterCrop(crop, crop)
           >> ChannelNormalize(IMAGENET_RGB_MEANS, IMAGENET_RGB_STDS)
           >> MatToTensor()
           >> ImageFrameToSample()
           >> SampleToMiniBatch(batch_size))
    return train, val
