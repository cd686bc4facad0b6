"""SSD: the single-shot multibox detector built from the detection family.

Counterpart of ``bigdl_tpu/models/ssd/ssd.py``: a shared conv trunk,
per-scale 3x3 location and confidence heads, priors a scale, concatenated
into the Caffe wire format ``Table(loc (N, P·4), conf (N, P·C), priors (1,
2, P·4))`` that ``nn.MultiBoxCriterion`` trains against and
``nn.DetectionOutputSSD`` serves from. The graph's children, and so its
parameter paths, are JAX's; the weights come from ``generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn import layout
from bigdl_tpu_torch.utils.device import resolve_device


class PermuteFlatten(nn.TensorModule):
    """(N, C, H, W) → (N, H·W·C) in Caffe's head order (y, x, anchor,
    coordinate); under NHWC the map is channel-last already."""

    def run(self, input, state=None):
        x = input if layout.is_nhwc() else input.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1), state


def _conv_block(c_in: int, c_out: int, g, stride_pool: bool = True):
    b = nn.Sequential()
    b.add(nn.SpatialConvolution(c_in, c_out, 3, 3, pad_w=1, pad_h=1,
                                generator=g))
    b.add(nn.ReLU())
    b.add(nn.SpatialConvolution(c_out, c_out, 3, 3, pad_w=1, pad_h=1,
                                generator=g))
    b.add(nn.ReLU())
    if stride_pool:
        b.add(nn.SpatialMaxPooling(2, 2, 2, 2))
    return b


def SSD(n_classes: int, img_size: int = 64,
        base_channels: Sequence[int] = (16, 32, 64),
        min_sizes: Optional[Sequence[float]] = None,
        aspect_ratios: Sequence[float] = (), *,
        generator: Optional[torch.Generator] = None, device=None) -> nn.Graph:
    """Two-scale SSD graph; ``n_classes`` includes the background (0).
    Scales: stride 8 and stride 16. Output ``Table(loc, conf, priors)``.
    The graph lives on ``device`` (the card unless the caller passes the
    CPU)."""
    if img_size % 16 != 0:
        raise ValueError("img_size must be divisible by 16 (two stride scales)")
    if min_sizes is None:
        min_sizes = [img_size * 0.15, img_size * 0.4]
    if len(min_sizes) != 2:
        raise ValueError("min_sizes must give one size per scale (2)")
    c1, c2, c3 = base_channels
    g = generator

    inp = nn.Input()
    s8 = nn.Sequential()
    s8.add(_conv_block(3, c1, g))
    s8.add(_conv_block(c1, c2, g))
    s8.add(_conv_block(c2, c3, g))
    feat8 = s8.set_name("trunk_s8").inputs(inp)
    norm8 = nn.NormalizeScale(p=2.0, scale=20.0, size=c3) \
        .set_name("norm_s8").inputs(feat8)
    feat16 = _conv_block(c3, c3, g).set_name("trunk_s16").inputs(feat8)

    locs, confs, priors = [], [], []
    for tag, node, ms in (("s8", norm8, min_sizes[0]),
                          ("s16", feat16, min_sizes[1])):
        pb = nn.PriorBox([ms], aspect_ratios=list(aspect_ratios), flip=True,
                         img_h=img_size, img_w=img_size)
        a = pb.num_priors
        loc = nn.SpatialConvolution(c3, a * 4, 3, 3, pad_w=1, pad_h=1,
                                    generator=g) \
            .set_name(f"loc_{tag}").inputs(node)
        conf = nn.SpatialConvolution(c3, a * n_classes, 3, 3, pad_w=1,
                                     pad_h=1, generator=g) \
            .set_name(f"conf_{tag}").inputs(node)
        locs.append(PermuteFlatten().inputs(loc))
        confs.append(PermuteFlatten().inputs(conf))
        priors.append(pb.set_name(f"priors_{tag}").inputs(node))

    loc_all = nn.JoinTable(2).set_name("loc_cat").inputs(*locs)
    conf_all = nn.JoinTable(2).set_name("conf_cat").inputs(*confs)
    prior_all = nn.JoinTable(3).set_name("prior_cat").inputs(*priors)
    return nn.Graph([inp], [loc_all, conf_all, prior_all]).to(
        resolve_device(device))


def detector(model: nn.Graph, n_classes: int, keep_topk: int = 20,
             conf_thresh: float = 0.3, nms_thresh: float = 0.45):
    """A trained SSD graph behind ``DetectionOutputSSD``: a callable image
    batch → (N, keep_topk, 6) detections, in eval mode, without autograd."""
    head = nn.DetectionOutputSSD(n_classes=n_classes, keep_topk=keep_topk,
                                 conf_thresh=conf_thresh,
                                 nms_thresh=nms_thresh)

    def run(images):
        model.evaluate()
        with torch.no_grad():
            return head.forward(model.forward(images))

    return run


from bigdl_tpu_torch.utils.serializer import register as _register  # noqa: E402

_register(PermuteFlatten)
