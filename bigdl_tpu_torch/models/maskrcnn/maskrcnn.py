"""Mask R-CNN: the inference model over the detection family.

Counterpart of ``bigdl_tpu/models/maskrcnn/maskrcnn.py``: backbone pyramid
→ FPN → RPN proposals → box head → per-class decode and NMS → mask head on
the kept detections, every stage on a fixed budget, so one image runs with
no host read (and can be captured into one CUDA graph). Single image, as
JAX's; inference only (training mode raises).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.detection import _Constants, _unregistered
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.table import Table


def MaskRCNNBackbone(in_channels: int = 3,
                     widths: Sequence[int] = (32, 64, 128),
                     out_channels: int = 64, *,
                     generator: Optional[torch.Generator] = None) -> nn.Graph:
    """A small conv pyramid (stride 4/8/16 maps) and an FPN: the stand-in
    for a ResNet-FPN backbone, with its wire format (a Table of (N, C, H, W)
    maps, fine to coarse)."""
    g = generator
    inp = nn.Input()

    def block(c_in, c_out, node):
        seq = nn.Sequential()
        seq.add(nn.SpatialMaxPooling(2, 2))
        seq.add(nn.SpatialConvolution(c_in, c_out, 3, 3, pad_w=1, pad_h=1,
                                      generator=g))
        seq.add(nn.ReLU())
        seq.add(nn.SpatialConvolution(c_out, c_out, 3, 3, pad_w=1, pad_h=1,
                                      generator=g))
        seq.add(nn.ReLU())
        return seq.inputs(node)

    stem = (nn.Sequential()
            .add(nn.SpatialConvolution(in_channels, widths[0], 3, 3,
                                       stride_w=2, stride_h=2,
                                       pad_w=1, pad_h=1, generator=g))
            .add(nn.ReLU())
            .add(nn.SpatialConvolution(widths[0], widths[0], 3, 3,
                                       stride_w=2, stride_h=2,
                                       pad_w=1, pad_h=1, generator=g))
            .add(nn.ReLU())).inputs(inp)
    c3 = block(widths[0], widths[1], stem)           # stride 8
    c4 = block(widths[1], widths[2], c3)             # stride 16
    fpn = nn.FPN(list(widths), out_channels, generator=g).inputs(stem, c3, c4)
    return nn.Graph(inp, fpn)


class MaskRCNN(nn.Container):
    """Single-image Mask R-CNN inference: ``(1, 3, H, W)`` pixels →
    Table(dets (max_per_image, 6) ``[label, score, x1, y1, x2, y2]``, valid
    (max_per_image,), masks (max_per_image, n_classes, 2·mask_res,
    2·mask_res)). The image size is fixed at construction; the model lives
    on ``device`` (the card unless the caller passes the CPU)."""

    def __init__(self, n_classes: int, image_size: Sequence[int] = (128, 128),
                 out_channels: int = 64, post_nms_topn: int = 60,
                 max_per_image: int = 20, box_resolution: int = 7,
                 mask_resolution: int = 14, *,
                 generator: Optional[torch.Generator] = None, device=None):
        g = generator
        scales = [1.0 / 4, 1.0 / 8, 1.0 / 16]
        super().__init__(
            MaskRCNNBackbone(out_channels=out_channels, generator=g),
            nn.RegionProposal(out_channels, anchor_sizes=(32, 64, 128),
                              feat_strides=(4, 8, 16),
                              pre_nms_topn=4 * post_nms_topn,
                              post_nms_topn=post_nms_topn, rpn_min_size=2,
                              generator=g),
            nn.BoxHead(out_channels, box_resolution, scales, 2,
                       n_classes=n_classes, representation=256, generator=g),
            nn.MaskHead(out_channels, mask_resolution, scales, 2,
                        n_classes=n_classes, layers=(64, 64), generator=g))
        self.n_classes = n_classes
        self.image_size = tuple(int(s) for s in image_size)
        self.max_per_image = max_per_image
        _unregistered(self, "detection_out", nn.DetectionOutputFrcnn(
            n_classes, score_thresh=0.05, max_per_image=max_per_image))
        _unregistered(self, "_im_info", _Constants())
        self.to(resolve_device(device))

    def run(self, input, state=None):
        if self.training:
            raise ValueError(
                "MaskRCNN is the inference composition (reference zoo "
                "contract); train the heads against your proposal/target "
                "sampler directly")
        h, w = self.image_size
        if tuple(input.shape[-2:]) != (h, w):
            raise ValueError(
                f"MaskRCNN compiled for {h}x{w} images, got "
                f"{input.shape[-2]}x{input.shape[-1]} (pad/resize, or build "
                f"with image_size matching the serving shape)")
        feats = self[0].run(input)[0]
        im_info = self._im_info.get(
            "im_info", lambda: [[float(h), float(w), 1.0]], input.device)
        rois, roi_valid = self[1].run(Table(feats, im_info))[0].values()
        logits, deltas = self[2].run(Table(feats, rois))[0].values()
        dets, valid = self.detection_out.run(
            Table(logits, deltas, rois, im_info, roi_valid))[0].values()
        det_rois = torch.cat([torch.zeros_like(dets[:, :1]), dets[:, 2:]],
                             dim=1)
        masks = self[3].run(Table(feats, det_rois))[0]
        return Table(dets, valid, masks), state

    def extra_repr(self):
        return (f"classes={self.n_classes}, image={self.image_size}, "
                f"max={self.max_per_image}")


from bigdl_tpu_torch.utils.serializer import register as _register  # noqa: E402

_register(MaskRCNN)
