"""Mask R-CNN module family: RoiAlign, FPN, Pooler, the box and mask heads,
the multi-level RPN and the Faster R-CNN detection decode.

Counterpart of ``bigdl_tpu/nn/maskrcnn.py``, on JAX's fixed budgets (R
ROIs, per-class NMS over static candidate lists), so a whole detector runs
with no host read and can be captured. The heads are containers of stock
convolutions and Linears, with JAX's child indices, so
``convert.load_jax_params`` carries their weights by path; the poolers and
proposal layers hold no parameters and stay off the tree, as in JAX.
:class:`DetectionOutputFrcnn` decodes and suppresses all classes as one
batch of rows: one NMS launch where JAX's Python loop makes 80 calls.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from bigdl_tpu_torch.nn.abstractnn import AbstractModule, Container
from bigdl_tpu_torch.nn.convolution import (
    SpatialConvolution, SpatialFullConvolution,
)
from bigdl_tpu_torch.nn.detection import (
    Proposal, _unregistered, clip_boxes, decode_rcnn, nms_mask,
)
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.roi import RoiPooling
from bigdl_tpu_torch.utils.table import Table


def _values(x) -> list:
    return list(x.values()) if isinstance(x, Table) else list(x)


class RoiAlign(RoiPooling):
    """``RoiAlign(spatial_scale, sampling_ratio, pooled_h, pooled_w)``: the
    aligned transform, boxes shifted by -0.5 feature pixels so the samples
    sit at pixel centres, over :class:`RoiPooling`'s sampler."""

    def __init__(self, spatial_scale: float, sampling_ratio: int,
                 pooled_h: int, pooled_w: int, mode: str = "avg"):
        super().__init__(pooled_h, pooled_w, spatial_scale=spatial_scale,
                         sampling_ratio=sampling_ratio, mode=mode)

    def run(self, input, state=None):
        feats, rois = _values(input)[:2]
        r = rois.to(torch.float32)
        shifted = torch.cat([r[:, :1], r[:, 1:] - 0.5 / self.spatial_scale],
                            dim=1)
        return super().run(Table(feats, shifted), state)


class FPN(Container):
    """Feature Pyramid Network: a 1x1 lateral convolution a level, top-down
    nearest-neighbour upsampling, a 3x3 output convolution a level;
    ``top_blocks=1`` adds a stride-2 subsampled P6. Input Table(C2..C5) fine
    to coarse (NCHW), output Table(P2..P5[, P6])."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 top_blocks: int = 0, generator=None):
        in_channels = list(in_channels)
        laterals = [SpatialConvolution(c, out_channels, 1, 1,
                                       generator=generator)
                    for c in in_channels]
        outputs = [SpatialConvolution(out_channels, out_channels, 3, 3,
                                      pad_w=1, pad_h=1, generator=generator)
                   for _ in in_channels]
        super().__init__(*(laterals + outputs))
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.top_blocks = int(top_blocks)

    def run(self, input, state=None):
        xs = _values(input)
        n_lvl = len(self.in_channels)
        if len(xs) != n_lvl:
            raise ValueError(f"FPN expects {n_lvl} levels, got {len(xs)}")
        lat = [self[i].run(x)[0] for i, x in enumerate(xs)]
        merged = [None] * n_lvl
        merged[-1] = lat[-1]
        for i in range(n_lvl - 2, -1, -1):
            up = merged[i + 1].repeat_interleave(2, dim=2) \
                .repeat_interleave(2, dim=3)
            up = up[:, :, : lat[i].shape[2], : lat[i].shape[3]]
            merged[i] = lat[i] + up
        outs = [self[n_lvl + i].run(m)[0] for i, m in enumerate(merged)]
        if self.top_blocks:
            outs.append(outs[-1][:, :, ::2, ::2])   # a 1x1 max pool, stride 2
        return Table(*outs), state

    def extra_repr(self):
        return (f"{self.in_channels} -> {self.out_channels}, "
                f"top_blocks={self.top_blocks}")


class Pooler(AbstractModule):
    """Multi-level ROI features: each ROI's level by the FPN rule
    ``floor(4 + log2(sqrt(area)/224))``, every ROI RoiAligned at every
    level and the levels merged by one-hot, as JAX does. Input
    Table(Table(features...), rois (R, 5)); output (R, C, res, res)."""

    def __init__(self, resolution: int, scales: Sequence[float],
                 sampling_ratio: int):
        super().__init__()
        self.resolution = int(resolution)
        self.scales = [float(s) for s in scales]
        self.sampling_ratio = int(sampling_ratio)
        _unregistered(self, "_aligners", [
            RoiAlign(s, sampling_ratio, resolution, resolution)
            for s in self.scales])
        self.finest_level = int(round(-math.log2(max(self.scales))))
        self.canonical = 224.0

    def run(self, input, state=None):
        feat_t, rois = _values(input)[:2]
        feats = _values(feat_t)
        if len(feats) != len(self.scales):
            raise ValueError(
                f"Pooler has {len(self.scales)} scales but got "
                f"{len(feats)} feature levels")
        r = rois.to(torch.float32)
        area = torch.clamp(r[:, 3] - r[:, 1], min=0) \
            * torch.clamp(r[:, 4] - r[:, 2], min=0)
        k = torch.floor(4.0 + torch.log2(torch.sqrt(area) / self.canonical
                                         + 1e-6))
        target = torch.clamp(k - self.finest_level, 0,
                             len(feats) - 1).to(torch.int64)
        stacked = torch.stack([al.run(Table(f, rois))[0] for f, al in zip(
            feats, self._aligners)])                   # (L, R, C, res, res)
        sel = torch.nn.functional.one_hot(target, len(feats)).to(
            stacked.dtype)                             # (R, L)
        return torch.einsum("lrchw,rl->rchw", stacked, sel), state

    def extra_repr(self):
        return (f"res={self.resolution}, scales={self.scales}, "
                f"sampling={self.sampling_ratio}")


class BoxHead(Container):
    """Fast R-CNN box head: Pooler, two ReLU Linears, class logits and
    per-class box deltas. Input Table(Table(features...), rois (R, 5));
    output Table(cls_logits (R, n_classes), bbox_deltas (R, 4·n_classes))."""

    def __init__(self, in_channels: int, resolution: int,
                 scales: Sequence[float], sampling_ratio: int,
                 n_classes: int, representation: int = 1024, generator=None):
        g = generator
        super().__init__(
            Linear(in_channels * resolution * resolution, representation,
                   generator=g),
            Linear(representation, representation, generator=g),
            Linear(representation, n_classes, generator=g),
            Linear(representation, 4 * n_classes, generator=g))
        self.in_channels = in_channels
        self.resolution = resolution
        self.scales = [float(s) for s in scales]
        self.sampling_ratio = sampling_ratio
        self.n_classes = n_classes
        self.representation = representation
        _unregistered(self, "pooler", Pooler(resolution, scales,
                                             sampling_ratio))

    def run(self, input, state=None):
        pooled = self.pooler.run(input)[0]
        x = pooled.reshape(pooled.shape[0], -1)
        x = torch.relu(self[0].run(x)[0])
        x = torch.relu(self[1].run(x)[0])
        return Table(self[2].run(x)[0], self[3].run(x)[0]), state

    def extra_repr(self):
        return (f"in={self.in_channels}, res={self.resolution}, "
                f"classes={self.n_classes}")


class MaskHead(Container):
    """Mask R-CNN mask head: Pooler, 3x3 ReLU convolutions, a 2x ReLU
    deconvolution, a 1x1 convolution to per-class mask logits (R,
    n_classes, 2·res, 2·res)."""

    def __init__(self, in_channels: int, resolution: int,
                 scales: Sequence[float], sampling_ratio: int,
                 n_classes: int, layers: Sequence[int] = (256, 256, 256, 256),
                 dilation: int = 1, generator=None):
        mods = []
        prev = in_channels
        for width in layers:
            mods.append(SpatialConvolution(prev, width, 3, 3, pad_w=dilation,
                                           pad_h=dilation, generator=generator))
            prev = width
        mods.append(SpatialFullConvolution(prev, prev, 2, 2, dw=2, dh=2,
                                           generator=generator))
        mods.append(SpatialConvolution(prev, n_classes, 1, 1,
                                       generator=generator))
        super().__init__(*mods)
        self.in_channels = in_channels
        self.resolution = resolution
        self.scales = [float(s) for s in scales]
        self.sampling_ratio = sampling_ratio
        self.n_classes = n_classes
        self.layers = list(layers)
        self.dilation = dilation
        _unregistered(self, "pooler", Pooler(resolution, scales,
                                             sampling_ratio))

    def run(self, input, state=None):
        x = self.pooler.run(input)[0]
        last = len(self._modules) - 1
        for i in range(last + 1):
            x = self[i].run(x)[0]
            if i < last:
                x = torch.relu(x)
        return x, state

    def extra_repr(self):
        return (f"in={self.in_channels}, res={self.resolution}, "
                f"classes={self.n_classes}")


class RegionProposal(Container):
    """Multi-level RPN: a shared 3x3 convolution and objectness/box 1x1
    heads over every level, a :class:`Proposal` a level (fixed budgets),
    concatenated. Input Table(Table(features...), im_info (1, 3)); output
    Table(rois (K, 5), valid (K,)), K the per-level budget × levels."""

    def __init__(self, in_channels: int,
                 anchor_sizes: Sequence[float] = (32, 64, 128, 256, 512),
                 aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 feat_strides: Sequence[float] = (4, 8, 16, 32, 64),
                 pre_nms_topn: int = 2000, post_nms_topn: int = 1000,
                 nms_thresh: float = 0.7, rpn_min_size: float = 0.0,
                 generator=None):
        if len(anchor_sizes) != len(feat_strides):
            raise ValueError("one anchor size per pyramid level")
        a = len(aspect_ratios)
        g = generator
        super().__init__(
            SpatialConvolution(in_channels, in_channels, 3, 3, pad_w=1,
                               pad_h=1, generator=g),
            SpatialConvolution(in_channels, 2 * a, 1, 1, generator=g),
            SpatialConvolution(in_channels, 4 * a, 1, 1, generator=g))
        self.in_channels = in_channels
        self.anchor_sizes = [float(s) for s in anchor_sizes]
        self.aspect_ratios = [float(r) for r in aspect_ratios]
        self.feat_strides = [float(s) for s in feat_strides]
        self.pre_nms_topn, self.post_nms_topn = pre_nms_topn, post_nms_topn
        n_lvl = len(feat_strides)
        _unregistered(self, "_proposals", [
            Proposal(pre_nms_topn=pre_nms_topn // n_lvl,
                     post_nms_topn=post_nms_topn // n_lvl,
                     ratios=aspect_ratios,
                     scales=[self.anchor_sizes[i] / self.feat_strides[i]],
                     rpn_min_size=rpn_min_size, nms_thresh=nms_thresh,
                     feat_stride=self.feat_strides[i])
            for i in range(n_lvl)])

    def run(self, input, state=None):
        feat_t, im_info = _values(input)[:2]
        all_rois, all_valid = [], []
        for lvl, f in enumerate(_values(feat_t)):
            h = torch.relu(self[0].run(f)[0])
            scores, deltas = self[1].run(h)[0], self[2].run(h)[0]
            rois, valid = self._proposals[lvl].run(
                Table(scores, deltas, im_info))[0].values()
            all_rois.append(rois)
            all_valid.append(valid)
        return Table(torch.cat(all_rois), torch.cat(all_valid)), state

    def extra_repr(self):
        return f"in={self.in_channels}, levels={len(self.feat_strides)}"


class DetectionOutputFrcnn(AbstractModule):
    """Faster R-CNN decode: softmax scores and per-class deltas against the
    proposals, per-class NMS on fixed budgets, the global top
    ``max_per_image``. Input Table(cls_logits (R, C), bbox_deltas (R, 4C),
    rois (R, 5), im_info (1, 3)[, roi_valid (R,)]); output Table(dets
    (max_per_image, 6) ``[label, score, x1, y1, x2, y2]``, valid
    (max_per_image,)). Class 0 is background."""

    def __init__(self, n_classes: int, score_thresh: float = 0.05,
                 nms_thresh: float = 0.5, max_per_image: int = 100):
        super().__init__()
        self.n_classes = int(n_classes)
        self.score_thresh = float(score_thresh)
        self.nms_thresh = float(nms_thresh)
        self.max_per_image = int(max_per_image)

    def run(self, input, state=None):
        xs = _values(input)
        logits, deltas, rois, im_info = xs[:4]
        roi_valid = xs[4] if len(xs) > 4 else None
        r, c = logits.shape[0], self.n_classes
        dev = logits.device
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        info = im_info.reshape(-1)
        # every class but the background as one batch of rows (C-1, R, ...)
        d = deltas.reshape(r, c, 4)[:, 1:].transpose(0, 1)
        boxes = clip_boxes(decode_rcnn(rois[:, 1:], d), info[0], info[1])
        sc = probs[:, 1:].t()
        ok = sc >= self.score_thresh
        if roi_valid is not None:
            ok = ok & roi_valid
        order, keep = nms_mask(boxes, sc, self.nms_thresh, valid=ok)
        boxes = boxes.gather(1, order[..., None].expand(c - 1, r, 4)) \
            .reshape(-1, 4)
        scores = torch.where(keep, sc.gather(1, order),
                             torch.full_like(sc, -math.inf)).reshape(-1)
        labels = torch.arange(1, c, device=dev)[:, None].expand(c - 1, r) \
            .reshape(-1)
        k = self.max_per_image
        if scores.shape[0] < k:   # budget > candidates: pad invalid
            pad = k - scores.shape[0]
            boxes = torch.cat([boxes, boxes.new_zeros((pad, 4))])
            scores = torch.cat([scores, scores.new_full((pad,), -math.inf)])
            labels = torch.cat([labels, labels.new_zeros((pad,))])
        top = torch.sort(-scores, stable=True).indices[:k]
        dets = torch.cat([labels[top][:, None].to(torch.float32),
                          scores[top][:, None], boxes[top]], dim=1)
        valid = torch.isfinite(scores[top])
        dets = torch.where(valid[:, None], dets,
                           torch.zeros((), dtype=dets.dtype, device=dev))
        return Table(dets, valid), state

    def extra_repr(self):
        return (f"classes={self.n_classes}, nms={self.nms_thresh}, "
                f"max={self.max_per_image}")


from bigdl_tpu_torch.utils.serializer import register as _register  # noqa: E402

for _cls in (RoiAlign, FPN, Pooler, BoxHead, MaskHead, RegionProposal,
             DetectionOutputFrcnn):
    _register(_cls)
