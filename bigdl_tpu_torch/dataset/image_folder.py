"""On-disk image-folder dataset, the ImageNet-scale input source.

Counterpart of ``bigdl_tpu/dataset/image_folder.py``: a host-side
streaming source over the standard ``root/<class_name>/<image>`` layout,
decoding JPEG, PNG and BMP files on a thread pool with the port's codec
(``transform/vision/codec.py``: PIL's pixels, the GIL released in C++),
composing with the vision ``FeatureTransformer`` pipeline and
``SampleToMiniBatch``. Behind the trainer's ``PrefetchingFeed`` the
decode→augment→stack→h2d chain runs off the step loop's critical path.

The layout is scanned once at construction (classes and files sorted);
``shuffle()`` permutes the file order with the port's ``RandomGenerator``
(JAX's draws). Labels are the sorted class-dir index, 0-based by default
(``one_based=True`` is the reference's 1-based convention). Each decode
runs under the ``feed/decode`` span, adds to the ``decode`` feed stage,
passes the ``decode`` fault site and follows ``BIGDL_BAD_SAMPLE_POLICY``
(a file the codec does not decode is treated as any unreadable file); the
decoded-sample cache serves later epochs when enabled. ``distributed=True``
marks the source for the data-parallel trainer (``DistriOptimizer``), as
in JAX.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.profiling import STAGE_DECODE, feed_stats
from bigdl_tpu_torch.dataset.resilience import run_guarded
from bigdl_tpu_torch.obs import trace
from bigdl_tpu_torch.utils.faults import SITE_DECODE, fault_point
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


class ImageFolderDataSet(AbstractDataSet):
    """Streams :class:`~bigdl_tpu_torch.transform.vision.image.ImageFeature` records
    (HWC uint8, RGB channel order — compose ``ChannelOrder`` for BGR models)."""

    def __init__(self, root: str, num_workers: int = 8,
                 extensions: Sequence[str] = _EXTENSIONS,
                 one_based: bool = False, distributed: bool = False,
                 cache: Optional[bool] = None, cache_dir: Optional[str] = None):
        if not os.path.isdir(root):
            raise FileNotFoundError(f"image folder root not found: {root}")
        self.root = root
        self.num_workers = max(int(num_workers), 1)
        self.distributed = distributed
        # decoded-sample cache (dataset/sample_cache.py): None defers to
        # BIGDL_SAMPLE_CACHE; the SampleCache instance persists across epochs
        # so CRC verification happens once and quarantine sticks
        self._cache_enabled = cache
        self._cache_dir = cache_dir
        self._cache = None
        exts = tuple(e.lower() for e in extensions)
        self.classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise ValueError(f"no class subdirectories under {root}")
        base = 1 if one_based else 0
        self.class_to_label = {c: i + base for i, c in enumerate(self.classes)}
        self._items: list[tuple[str, int]] = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for name in sorted(os.listdir(cdir)):
                if name.lower().endswith(exts):
                    self._items.append((os.path.join(cdir, name),
                                        self.class_to_label[c]))
        if not self._items:
            raise ValueError(f"no images with extensions {exts} under {root}")
        self._order = np.arange(len(self._items))
        self._ex: Optional[ThreadPoolExecutor] = None

    def size(self) -> int:
        return len(self._items)

    def _executor(self) -> ThreadPoolExecutor:
        """One decode pool per DATASET, reused across epochs — the per-epoch
        pool was spun up inside ``data()`` and abandoned (``shutdown(wait=
        False)``) whenever the generator closed, stacking orphaned idle
        threads epoch after epoch."""
        if self._ex is None:
            self._ex = ThreadPoolExecutor(self.num_workers,
                                          thread_name_prefix="bigdl-decode")
        return self._ex

    def close(self) -> None:
        """Deterministically shut the decode pool down (tests / long-lived
        processes swapping datasets). Safe to call repeatedly; a later
        ``data()`` recreates the pool."""
        if self._ex is not None:
            self._ex.shutdown(wait=False, cancel_futures=True)
            self._ex = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def shuffle(self) -> None:
        perm = RandomGenerator.numpy().permutation(len(self._items))
        self._order = self._order[perm]

    @staticmethod
    def _decode_one(item: tuple[str, int]):
        from bigdl_tpu_torch.transform.vision.codec import decode_file
        from bigdl_tpu_torch.transform.vision.image import ImageFeature

        fault_point(SITE_DECODE)  # scripted decode failure, if any
        path, label = item
        t0 = time.perf_counter()
        with trace.span("feed/decode"):
            arr = decode_file(path)
        feed_stats.add(STAGE_DECODE, time.perf_counter() - t0)
        return ImageFeature(arr, label, uri=path)

    def _decode(self, item: tuple[str, int]):
        # corrupt-sample policy (BIGDL_BAD_SAMPLE_POLICY): a truncated or
        # unreadable image can skip/retry instead of killing the decode pool
        return run_guarded("decode", self._decode_one, item)

    def _cache_obj(self):
        from bigdl_tpu_torch.dataset import sample_cache
        if self._cache is None and self._cache_enabled is not False:
            enabled = (sample_cache.cache_enabled()
                       if self._cache_enabled is None else True)
            if enabled:
                default_dir = os.path.join(self.root, ".bigdl-sample-cache")
                self._cache = sample_cache.SampleCache(
                    sample_cache.cache_dir(self._cache_dir or default_dir),
                    sample_cache.fingerprint(
                        ("image_folder.v1", self.root, tuple(self._items))),
                    len(self._items))
        return self._cache

    def data(self, train: bool) -> Iterator:
        # cache-aware iteration (dataset/sample_cache.py): a committed cache
        # serves the whole epoch via mmap and the decode pool is never
        # created; otherwise the classic sliding window of decode futures
        # (bounded memory, preserved order), building the cache as it goes
        from bigdl_tpu_torch.dataset.sample_cache import cached_data_iter

        def submit(i):
            return self._executor().submit(self._decode, self._items[i])

        yield from cached_data_iter((int(i) for i in self._order), submit,
                                    self._cache_obj(), self.num_workers * 2)


def write_synthetic_image_folder(root: str, n_classes: int = 4,
                                 n_per_class: int = 8, size: int = 64,
                                 seed: int = 0) -> str:
    """Materialise an ImageNet-layout directory of random PNGs (tests / demos /
    pipeline smoke runs), JAX's arrays written by the port's PNG writer.
    Returns ``root``."""
    from bigdl_tpu_torch.transform.vision.codec import write_png

    rng = np.random.default_rng(seed)
    for c in range(n_classes):
        cdir = os.path.join(root, f"class_{c:03d}")
        os.makedirs(cdir, exist_ok=True)
        for i in range(n_per_class):
            arr = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
            write_png(os.path.join(cdir, f"img_{i:04d}.png"), arr)
    return root
