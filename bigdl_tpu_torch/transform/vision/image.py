"""Vision pipeline: ``ImageFrame`` / ``ImageFeature`` and the feature
transformer zoo.

Counterpart of ``bigdl_tpu/transform/vision/image.py``, every public name.
The work stays on the host in numpy, as in JAX: images are HWC numpy
arrays and the pipeline ends in ``MatToTensor`` and ``ImageFrameToSample``
ahead of ``SampleToMiniBatch``. Where JAX calls PIL, the port calls its own
codec (``transform/vision/codec.py``): ``ImageFrame.read`` decodes with it
and ``Resize`` resizes with its port of Pillow's bilinear resampler, which
gives Pillow's pixels bitwise.

Randomized transformers draw from a ``numpy.random.Generator`` seeded with
JAX's material, ``[Engine seed, RandomGenerator.next_salt()]`` (a
process-random seed before ``Engine.init``), so one seed gives the same
crops, flips and jitter in both packages. Under ``sample_index_scope(i)``
(the parallel transform engine, ``dataset/parallel.py``) the draws come
from a per-sample generator of (seed material, ``i``) instead, the same for
any number of workers.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import (
    Transformer, current_sample_index, current_sample_rng_cache,
)

_FLOAT = np.float32


class ImageFeature(dict):
    """Dict-record for one image: keys ``image`` (HWC numpy), ``label``,
    ``uri``, plus anything transformers attach."""

    IMAGE, LABEL, URI, ORIGINAL_SIZE = "image", "label", "uri", "original_size"

    def __init__(self, image=None, label=None, uri: Optional[str] = None):
        super().__init__()
        if image is not None:
            self[self.IMAGE] = np.asarray(image)
            self[self.ORIGINAL_SIZE] = tuple(np.asarray(image).shape)
        if label is not None:
            self[self.LABEL] = label
        if uri is not None:
            self[self.URI] = uri

    @property
    def image(self) -> np.ndarray:
        return self[self.IMAGE]

    @image.setter
    def image(self, v) -> None:
        self[self.IMAGE] = v

    @property
    def label(self):
        return self.get(self.LABEL)


class ImageFrame:
    """A collection of ImageFeatures with ``transform`` chaining.

    The reference's distributed (RDD) variant collapses into the local one: data
    parallelism happens at the MiniBatch/mesh level, not the record level.
    """

    def __init__(self, features: Sequence[ImageFeature]):
        self.features = list(features)

    # ------------------------------------------------------------- factories
    @staticmethod
    def from_arrays(images, labels=None) -> "ImageFrame":
        labels = labels if labels is not None else [None] * len(images)
        return ImageFrame([ImageFeature(im, lb) for im, lb in zip(images, labels)])

    @staticmethod
    def read(paths, with_labels: Optional[dict] = None) -> "ImageFrame":
        """Decode image files with the port's codec (HWC uint8 RGB, the
        array of PIL's ``convert("RGB")``). ``with_labels`` maps path →
        label."""
        from bigdl_tpu_torch.transform.vision.codec import decode_file
        feats = []
        for p in paths:
            arr = decode_file(p)
            feats.append(ImageFeature(arr, (with_labels or {}).get(p), uri=p))
        return ImageFrame(feats)

    # ------------------------------------------------------------ transforms
    def transform(self, transformer: "FeatureTransformer") -> "ImageFrame":
        self.features = list(transformer(iter(self.features)))
        return self

    def __len__(self) -> int:
        return len(self.features)

    def __iter__(self):
        return iter(self.features)

    def to_samples(self) -> list:
        return list(ImageFrameToSample()(iter(self.features)))


class FeatureTransformer(Transformer):
    """Per-record transformer; compose with ``>>`` (the reference's ``->``)."""

    # Per-instance salt (RandomGenerator.next_salt): transformers built from the
    # same Engine seed must still draw *decorrelated* streams (Brightness/Contrast/
    # Saturation inside one ColorJitter would otherwise make identical random
    # picks). The salt counter resets with RandomGenerator.set_seed, so an
    # identically-seeded run rebuilding the same pipeline reproduces exactly.

    def __init__(self):
        self._seed_material = list(self._seed())
        self._stream_rng = np.random.default_rng(self._seed_material)

    @classmethod
    def _seed(cls):
        from bigdl_tpu_torch.utils.random_generator import RandomGenerator
        salt = RandomGenerator.next_salt()
        try:
            from bigdl_tpu_torch.utils.engine import Engine
            if Engine.is_initialized():
                return [Engine.config().seed, salt]
        except Exception:
            pass
        return [int.from_bytes(os.urandom(4), "little"), salt]

    @property
    def _rng(self) -> np.random.Generator:
        """Sequential stream rng — unless a ``sample_index_scope`` is active,
        in which case a per-(transformer, sample) generator derived from
        (seed material, sample index). The derived generator is cached for the
        scope's duration so several draws inside one ``transform_feature``
        advance ONE stream (Expand's ratio/y/x must not all see draw #1)."""
        index = current_sample_index()
        if index is None or self._seed_material is None:
            return self._stream_rng
        cache = current_sample_rng_cache()
        rng = cache.get(id(self)) if cache is not None else None
        if rng is None:
            rng = np.random.default_rng([*self._seed_material, index])
            if cache is not None:
                cache[id(self)] = rng
        return rng

    @_rng.setter
    def _rng(self, rng) -> None:
        # direct assignment (legacy/custom transformers): honor it as the
        # sequential stream; per-sample derivation is disabled because the
        # seed material behind the assigned generator is unknown
        self._seed_material = None
        self._stream_rng = rng

    def set_seed(self, seed: int) -> "FeatureTransformer":
        self._seed_material = [int(seed)]
        self._stream_rng = np.random.default_rng(self._seed_material)
        return self

    def transform_feature(self, feature: ImageFeature) -> ImageFeature:
        raise NotImplementedError

    def element_fn(self):
        """Per-record callable — FeatureTransformers are element-wise by
        construction, so every vision stage fuses and parallelizes."""
        return self.transform_feature

    def __call__(self, prev: Iterator) -> Iterator:
        return (self.transform_feature(f) for f in prev)


class Resize(FeatureTransformer):
    """Bilinear resize to (height, width), Pillow's resampler bitwise."""

    def __init__(self, resize_h: int, resize_w: int):
        super().__init__()
        self.resize_h, self.resize_w = resize_h, resize_w

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        from bigdl_tpu_torch.transform.vision.codec import resize_bilinear
        img = f.image
        dtype = img.dtype
        out = resize_bilinear(img.astype(np.uint8) if dtype != np.uint8
                              else img, self.resize_h, self.resize_w)
        f.image = out.astype(dtype) if dtype != np.uint8 else out
        return f


class AspectScale(FeatureTransformer):
    """Scale the short edge to ``min_size`` keeping aspect ratio (reference
    ``AspectScale``, the ImageNet eval resize)."""

    def __init__(self, min_size: int, max_size: int = 1000):
        super().__init__()
        self.min_size, self.max_size = min_size, max_size

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        h, w = f.image.shape[:2]
        scale = self.min_size / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        return Resize(int(round(h * scale)), int(round(w * scale))) \
            .transform_feature(f)


class CenterCrop(FeatureTransformer):
    def __init__(self, crop_h: int, crop_w: int):
        super().__init__()
        self.crop_h, self.crop_w = crop_h, crop_w

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        h, w = f.image.shape[:2]
        if h < self.crop_h or w < self.crop_w:
            raise ValueError(f"image {h}x{w} smaller than crop "
                             f"{self.crop_h}x{self.crop_w}")
        y = (h - self.crop_h) // 2
        x = (w - self.crop_w) // 2
        f.image = f.image[y:y + self.crop_h, x:x + self.crop_w]
        return f


class RandomCrop(FeatureTransformer):
    def __init__(self, crop_h: int, crop_w: int):
        super().__init__()
        self.crop_h, self.crop_w = crop_h, crop_w

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        h, w = f.image.shape[:2]
        if h < self.crop_h or w < self.crop_w:
            raise ValueError(f"image {h}x{w} smaller than crop "
                             f"{self.crop_h}x{self.crop_w}")
        y = int(self._rng.integers(0, h - self.crop_h + 1))
        x = int(self._rng.integers(0, w - self.crop_w + 1))
        f.image = f.image[y:y + self.crop_h, x:x + self.crop_w]
        return f


class HFlip(FeatureTransformer):
    """Deterministic horizontal flip (see RandomHFlip for the coin-toss)."""

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        f.image = f.image[:, ::-1]
        return f


class RandomHFlip(FeatureTransformer):
    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        if self._rng.random() < self.p:
            f.image = f.image[:, ::-1]
        return f


class ChannelNormalize(FeatureTransformer):
    """(x - mean) / std per channel; promotes to float32."""

    def __init__(self, means: Sequence[float], stds: Sequence[float]):
        super().__init__()
        self.means = np.asarray(means, _FLOAT)
        self.stds = np.asarray(stds, _FLOAT)

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        f.image = (f.image.astype(_FLOAT) - self.means) / self.stds
        return f


class PixelBytesToMat(FeatureTransformer):
    """Raw HWC bytes → float array (decode-less path for pre-decoded data)."""

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        f.image = f.image.astype(_FLOAT)
        return f


class Brightness(FeatureTransformer):
    """Add a uniform delta in [delta_low, delta_high] (reference Brightness)."""

    def __init__(self, delta_low: float, delta_high: float):
        super().__init__()
        self.delta_low, self.delta_high = delta_low, delta_high

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        delta = self._rng.uniform(self.delta_low, self.delta_high)
        f.image = f.image.astype(_FLOAT) + _FLOAT(delta)
        return f


class Contrast(FeatureTransformer):
    """Scale by a uniform factor in [low, high]."""

    def __init__(self, delta_low: float, delta_high: float):
        super().__init__()
        self.delta_low, self.delta_high = delta_low, delta_high

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        factor = self._rng.uniform(self.delta_low, self.delta_high)
        f.image = f.image.astype(_FLOAT) * _FLOAT(factor)
        return f


class Saturation(FeatureTransformer):
    """Blend with the grayscale image by a random factor in [low, high]."""

    def __init__(self, delta_low: float, delta_high: float):
        super().__init__()
        self.delta_low, self.delta_high = delta_low, delta_high

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        img = f.image.astype(_FLOAT)
        factor = _FLOAT(self._rng.uniform(self.delta_low, self.delta_high))
        gray = img.mean(axis=2, keepdims=True)
        f.image = gray + factor * (img - gray)
        return f


class ColorJitter(FeatureTransformer):
    """Random brightness/contrast/saturation in random order (reference
    ``ColorJitter``)."""

    def __init__(self, brightness: float = 32.0, contrast: float = 0.5,
                 saturation: float = 0.5):
        super().__init__()
        self.parts = [Brightness(-brightness, brightness),
                      Contrast(1 - contrast, 1 + contrast),
                      Saturation(1 - saturation, 1 + saturation)]

    def set_seed(self, seed: int) -> "ColorJitter":
        super().set_seed(seed)
        for i, p in enumerate(self.parts):
            p.set_seed(seed + i + 1)
        return self

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        order = self._rng.permutation(len(self.parts))
        for i in order:
            f = self.parts[int(i)].transform_feature(f)
        return f


class Lighting(FeatureTransformer):
    """AlexNet-style PCA lighting noise: ``img += eigvec @ (alpha * eigval)``
    with ``alpha ~ N(0, alphastd)`` (reference ``Lighting``)."""

    def __init__(self, alphastd: float, eigval: Sequence[float],
                 eigvec: Sequence[Sequence[float]]):
        super().__init__()
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, _FLOAT)
        self.eigvec = np.asarray(eigvec, _FLOAT)

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        alpha = self._rng.normal(0, self.alphastd, size=3).astype(_FLOAT)
        rgb = self.eigvec @ (alpha * self.eigval)
        f.image = f.image.astype(_FLOAT) + rgb
        return f


class Expand(FeatureTransformer):
    """Place the image on a larger canvas at a random offset (SSD-style)."""

    def __init__(self, max_expand_ratio: float = 4.0,
                 means: Sequence[float] = (123.0, 117.0, 104.0)):
        super().__init__()
        self.max_expand_ratio = max_expand_ratio
        self.means = np.asarray(means, _FLOAT)

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        img = f.image.astype(_FLOAT)
        h, w, c = img.shape
        ratio = self._rng.uniform(1.0, self.max_expand_ratio)
        nh, nw = int(h * ratio), int(w * ratio)
        canvas = np.broadcast_to(self.means, (nh, nw, c)).copy()
        y = int(self._rng.integers(0, nh - h + 1))
        x = int(self._rng.integers(0, nw - w + 1))
        canvas[y:y + h, x:x + w] = img
        f.image = canvas
        return f


class ChannelOrder(FeatureTransformer):
    """Swap RGB↔BGR (the reference pipelines are BGR; the codec decodes RGB)."""

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        f.image = f.image[:, :, ::-1]
        return f


class RandomTransformer(FeatureTransformer):
    """Apply ``inner`` with probability p."""

    def __init__(self, inner: FeatureTransformer, p: float):
        super().__init__()
        self.inner = inner
        self.p = p

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        if self._rng.random() < self.p:
            return self.inner.transform_feature(f)
        return f


class MatToTensor(FeatureTransformer):
    """HWC → CHW float32 (the device layout; reference ``MatToTensor``)."""

    def transform_feature(self, f: ImageFeature) -> ImageFeature:
        f.image = np.ascontiguousarray(
            f.image.astype(_FLOAT).transpose(2, 0, 1))
        return f


class ImageFrameToSample(Transformer):
    """ImageFeature stream → Sample stream (feature = image, label if any)."""

    @staticmethod
    def _to_sample(f: ImageFeature) -> Sample:
        label = f.get(ImageFeature.LABEL)
        if label is None:
            return Sample(f.image)
        return Sample(f.image, np.int32(label)
                      if np.isscalar(label) else np.asarray(label))

    def element_fn(self):
        # one feature → one sample: fuses with the vision chain ahead of it
        return self._to_sample

    def __call__(self, prev: Iterator) -> Iterator:
        return (self._to_sample(f) for f in prev)


class Pipeline:
    """Convenience: chain feature transformers then materialize samples."""

    def __init__(self, *transformers: FeatureTransformer):
        self.transformers = list(transformers)

    def __call__(self, frame: ImageFrame) -> list:
        for t in self.transformers:
            frame = frame.transform(t)
        return frame.to_samples()
