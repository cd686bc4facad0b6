"""Classic image pipeline: the reference's pre-ImageFrame transformers.

Counterpart of ``bigdl_tpu/dataset/image.py``: ``BGRImgNormalizer``,
``BGRImgCropper``, ``BGRImgRdmCropper`` and ``BGRImgToSample`` are thin
parameterizations of the vision pipeline's transformers
(``transform/vision/image.py``) over :class:`ImageFeature` records (HWC
numpy in BGR order), as in JAX.
"""

from __future__ import annotations

from bigdl_tpu_torch.transform.vision.image import (
    CenterCrop, ChannelNormalize, ColorJitter, HFlip, ImageFeature, ImageFrame,
    ImageFrameToSample, Lighting, MatToTensor, RandomCrop,
)

__all__ = [
    "BGRImgNormalizer", "BGRImgCropper", "BGRImgRdmCropper", "BGRImgToSample",
    "HFlip", "ColorJitter", "Lighting", "ImageFeature", "ImageFrame",
]


def BGRImgNormalizer(mean_b: float, mean_g: float, mean_r: float,
                     std_b: float = 1.0, std_g: float = 1.0, std_r: float = 1.0):
    """Per-channel (BGR order) normalize — reference ``BGRImgNormalizer(mean, std)``."""
    return ChannelNormalize((mean_b, mean_g, mean_r), (std_b, std_g, std_r))


def BGRImgCropper(crop_width: int, crop_height: int, is_random: bool = False):
    """Center or random crop — reference ``BGRImgCropper``."""
    if is_random:
        return RandomCrop(crop_height, crop_width)
    return CenterCrop(crop_height, crop_width)


BGRImgRdmCropper = lambda crop_width, crop_height: BGRImgCropper(  # noqa: E731
    crop_width, crop_height, is_random=True)


def BGRImgToSample():
    """HWC float BGR image + label → Sample (CHW) — reference ``BGRImgToBatch``'s
    per-record half; batching is ``SampleToMiniBatch``."""
    return MatToTensor() >> ImageFrameToSample()
