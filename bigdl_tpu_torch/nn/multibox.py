"""MultiBox training criterion: the SSD detection loss.

Counterpart of ``bigdl_tpu/nn/multibox.py``: match priors to the ground
truth by IoU (the best gt of each prior over a threshold, plus each gt's
best prior forced), encode the matched boxes against their priors,
smooth-L1 on the positives' locations, softmax cross-entropy on the
confidences with 3:1 hard-negative mining, all over the positive count.

Ground truth comes padded, ``(N, G, 5)`` rows ``[label, x1, y1, x2, y2]``
with label -1 for padding, so every step is a fixed-shape tensor program
over the whole batch (JAX's ``vmap`` over images written out). The mining's
``argsort`` is a stable sort, as JAX's. Nothing reads the host, so the
loss and its gradient run inside the trainer's one captured step.
"""

from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.nn.criterion import AbstractCriterion
from bigdl_tpu_torch.nn.detection import encode_ssd, pairwise_iou
from bigdl_tpu_torch.utils.table import Table


def match_priors(priors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_valid: torch.Tensor, iou_threshold: float):
    """SSD two-way matching. ``priors (P, 4)``, ``gt_boxes (..., G, 4)``,
    ``gt_valid (..., G)`` bool (leading batch dimensions allowed). Returns
    ``(matched_gt (..., P) int64, is_pos (..., P) bool)``."""
    p = priors.shape[0]
    iou = pairwise_iou(priors, gt_boxes)                 # (..., P, G)
    iou = torch.where(gt_valid[..., None, :], iou,
                      torch.full_like(iou, -1.0))
    best_gt_iou, best_gt = iou.max(dim=-1)               # first max, as JAX
    # every valid gt claims its best prior; padding gts go to slot P, which
    # is dropped (JAX's out-of-range scatter with mode="drop")
    best_prior = torch.where(gt_valid, iou.argmax(dim=-2),
                             torch.full_like(gt_valid, p, dtype=torch.int64))
    lead = gt_valid.shape[:-1]
    g_idx = torch.arange(gt_boxes.shape[-2], device=priors.device) \
        .expand(*lead, -1)
    forced = torch.zeros(*lead, p + 1, dtype=torch.bool, device=priors.device)
    forced.scatter_(-1, best_prior, True)
    forced_gt = torch.zeros(*lead, p + 1, dtype=torch.int64,
                            device=priors.device)
    forced_gt.scatter_(-1, best_prior, g_idx)
    forced, forced_gt = forced[..., :p], forced_gt[..., :p]
    is_pos = (best_gt_iou >= iou_threshold) | forced
    return torch.where(forced, forced_gt, best_gt), is_pos


class MultiBoxCriterion(AbstractCriterion):
    """SSD training loss over the head's raw predictions.

    input: Table ``(loc (N, P·4), conf (N, P·n_classes), priors (1, 2,
    P·4))``, the wire format ``DetectionOutputSSD`` serves from; target:
    ``(N, G, 5)`` padded ground truth (label -1 padding, 0 background).
    loss = (smooth-L1(loc) + softmax-CE(conf)) / max(#positives, 1)."""

    size_average = True

    def __init__(self, n_classes: int, iou_threshold: float = 0.5,
                 neg_pos_ratio: float = 3.0, loc_weight: float = 1.0):
        self.n_classes = int(n_classes)
        self.iou_threshold = float(iou_threshold)
        self.neg_pos_ratio = float(neg_pos_ratio)
        self.loc_weight = float(loc_weight)

    def apply(self, input, target):
        xs = input.values() if isinstance(input, Table) else list(input)
        loc, conf, priors = xs[0], xs[1], xs[2]
        n = loc.shape[0]
        p = loc.shape[1] // 4
        pri = priors.reshape(2, p, 4)
        prior_boxes, prior_var = pri[0], pri[1]
        loc = loc.reshape(n, p, 4)
        conf = conf.reshape(n, p, self.n_classes)
        labels = target[..., 0].to(torch.int64)
        gt = target[..., 1:]
        matched, is_pos = match_priors(prior_boxes, gt, labels > 0,
                                       self.iou_threshold)
        # localization: smooth-L1 on the encoded offsets, positives only
        tgt_boxes = gt.gather(1, matched[..., None].expand(n, p, 4))
        enc = encode_ssd(prior_boxes, prior_var, tgt_boxes)
        diff = (loc - enc).abs()
        sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
        zero = torch.zeros((), dtype=sl1.dtype, device=sl1.device)
        loc_loss = torch.where(is_pos, sl1.sum(-1), zero).sum(-1)
        # confidence: positives train their class, mined negatives bg (0)
        cls_tgt = torch.where(is_pos, labels.gather(1, matched),
                              torch.zeros_like(matched))
        logp = torch.log_softmax(conf, dim=-1)
        ce = -logp.gather(-1, cls_tgt[..., None])[..., 0]
        n_pos = is_pos.sum(-1)
        n_neg = torch.minimum((self.neg_pos_ratio * n_pos).to(torch.int64),
                              p - n_pos)
        neg_score = torch.where(is_pos, torch.full_like(ce, -math.inf),
                                ce).detach()
        order = torch.sort(-neg_score, dim=-1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            -1, order, torch.arange(p, device=order.device).expand(n, p))
        is_neg = ~is_pos & (rank < n_neg[:, None])
        ce_zero = torch.zeros((), dtype=ce.dtype, device=ce.device)
        conf_loss = torch.where(is_pos | is_neg, ce, ce_zero).sum(-1)
        denom = torch.clamp(n_pos.sum(), min=1).to(torch.float32)
        return (self.loc_weight * loc_loss.sum() + conf_loss.sum()) / denom

    def __repr__(self):
        return (f"MultiBoxCriterion(classes={self.n_classes}, "
                f"iou={self.iou_threshold}, neg:pos={self.neg_pos_ratio})")
