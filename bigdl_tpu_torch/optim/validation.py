"""Validation methods and their results.

Counterpart of ``bigdl_tpu/optim/validation.py``:
``ValidationResult``, ``AccuracyResult``, ``LossResult``,
``ValidationMethod``, ``TopKAccuracy`` (``Top1Accuracy``,
``Top5Accuracy``), ``TreeNNAccuracy`` (``:169-200``, the TreeLSTM's root
accuracy), ``Loss``, and the ranking and regression metrics: ``MAPResult``
and ``MeanAveragePrecision`` (detection mAP, VOC2010 all-points AP, a
host fold: AP ranks over every batch), ``MAE`` (``:380``), ``HitRatio``
(``:408``) and ``NDCG`` (``:513``) over groups of one positive and
``neg_num`` negatives, with JAX's device folds (``:394``, ``:464``). Partial results add with ``+`` and
``result()`` gives (value, count); ``valid`` is a batch's count of real
rows, so padding rows never count.

The device-fold protocol is JAX's: a method that can fold its metric on the
card has ``has_device_fold()``, ``device_fold(out, target, valid_mask)``
(torch ops that run inside the captured eval program, ``optim/evaluator.py``,
and return a tuple of 0-d tensors), ``merge`` (elementwise add) and
``finalize`` (host side, from the fetched sums), so a validation pass
fetches O(1) scalars, not the logits. ``TopKAccuracy`` counts ranks instead
of sorting: the target is in the top k iff (#scores strictly greater) +
(#equal scores at a smaller class index) < k, the stable descending sort's
answer, in comparisons only, so the host fold (numpy) and the device fold
(torch) agree exactly.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


class ValidationResult:
    def result(self) -> tuple[float, int]:
        raise NotImplementedError

    def __add__(self, other: "ValidationResult") -> "ValidationResult":
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    def __init__(self, correct: float, count: int):
        self.correct, self.count = float(correct), int(count)

    def result(self):
        return (self.correct / max(self.count, 1), self.count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __repr__(self):
        v, c = self.result()
        return f"Accuracy({v:.4f}, count={c})"


class LossResult(ValidationResult):
    def __init__(self, loss_sum: float, count: int):
        self.loss_sum, self.count = float(loss_sum), int(count)

    def result(self):
        return (self.loss_sum / max(self.count, 1), self.count)

    def __add__(self, other):
        return LossResult(self.loss_sum + other.loss_sum,
                          self.count + other.count)

    def __repr__(self):
        v, c = self.result()
        return f"Loss({v:.4f}, count={c})"


class ValidationMethod:
    name = "ValidationMethod"

    def apply(self, output, target, valid: Optional[int] = None
              ) -> ValidationResult:
        """Host fold of one batch (numpy arrays or CPU tensors)."""
        raise NotImplementedError

    def has_device_fold(self) -> bool:
        return False

    def device_fold(self, out, target, valid_mask) -> tuple:
        """One batch's partial as a tuple of 0-d tensors; rows with
        ``valid_mask`` False do not count."""
        raise NotImplementedError(f"{self.name} has no device fold")

    def merge(self, acc: tuple, part: tuple) -> tuple:
        return tuple(a + p for a, p in zip(acc, part))

    def finalize(self, acc: tuple) -> ValidationResult:
        """The fetched sums (host numbers) as a result."""
        raise NotImplementedError(f"{self.name} has no device fold")

    def __repr__(self):
        return self.name


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _mask_valid(n: int, valid: Optional[int]):
    if valid is None or valid >= n:
        return None
    return np.arange(n) < valid


class TopKAccuracy(ValidationMethod):
    def __init__(self, k: int, one_based: bool = False):
        self.k = k
        self.one_based = one_based
        self.name = f"Top{k}Accuracy"

    def apply(self, output, target, valid=None):
        out = _host(output)
        t = _host(target).astype(np.int64).reshape(-1)
        if self.one_based:
            t = t - 1
        if out.ndim == 1:
            out = out[None]
        out = out.reshape(out.shape[0], -1)
        c = out.shape[1]
        safe_t = np.clip(t, 0, c - 1)
        s = np.take_along_axis(out, safe_t[:, None], axis=1)[:, 0]
        greater = (out > s[:, None]).sum(axis=1)
        ties_before = ((out == s[:, None])
                       & (np.arange(c)[None, :] < t[:, None])).sum(axis=1)
        correct = ((greater + ties_before < self.k) & (t >= 0)
                   & (t < c)).astype(np.float64)
        mask = _mask_valid(len(t), valid)
        if mask is not None:
            correct = correct[mask]
        return AccuracyResult(correct.sum(), len(correct))

    def has_device_fold(self) -> bool:
        return True

    def device_fold(self, out, target, valid_mask):
        t = target.reshape(-1).long()
        if self.one_based:
            t = t - 1
        if out.dim() == 1:
            out = out[None]
        out = out.reshape(out.shape[0], -1)
        c = out.shape[1]
        s = out.gather(1, t.clamp(0, c - 1)[:, None])
        greater = (out > s).sum(1)
        ties_before = ((out == s) & (torch.arange(c, device=out.device)[None]
                                     < t[:, None])).sum(1)
        correct = ((greater + ties_before < self.k) & (t >= 0) & (t < c)
                   & valid_mask)
        return (correct.float().sum(), valid_mask.int().sum())

    def finalize(self, acc) -> ValidationResult:
        correct, count = acc
        return AccuracyResult(float(correct), int(count))


class Top1Accuracy(TopKAccuracy):
    def __init__(self, one_based: bool = False):
        super().__init__(1, one_based)


class Top5Accuracy(TopKAccuracy):
    def __init__(self, one_based: bool = False):
        super().__init__(5, one_based)


class TreeNNAccuracy(ValidationMethod):
    """Top-1 accuracy of the tree's root prediction: ``output`` (N, nodes,
    classes) is read at its first node (an (N, classes) output is plain
    Top-1); a per-node target (N, nodes) at its first column."""

    def __init__(self, one_based: bool = False):
        self.one_based = one_based
        self.name = "TreeNNAccuracy"

    @staticmethod
    def _roots(out, target):
        if out.ndim == 3:
            out = out[:, 0, :]
        if target.ndim == 2:
            target = target[:, 0]
        return out, target

    def apply(self, output, target, valid=None):
        out, t = self._roots(_host(output), _host(target))
        return Top1Accuracy(self.one_based).apply(out, t, valid)

    def has_device_fold(self) -> bool:
        return True

    def device_fold(self, out, target, valid_mask):
        out, target = self._roots(out, target)
        return Top1Accuracy(self.one_based).device_fold(out, target,
                                                        valid_mask)

    def finalize(self, acc) -> ValidationResult:
        return Top1Accuracy(self.one_based).finalize(acc)


class Loss(ValidationMethod):
    """The criterion's loss (``ClassNLLCriterion`` by default), averaged
    over the valid rows."""

    def __init__(self, criterion=None):
        from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
        self.criterion = criterion or ClassNLLCriterion()
        self.name = "Loss"

    def apply(self, output, target, valid=None):
        out = torch.as_tensor(_host(output))
        t = torch.as_tensor(_host(target))
        n = out.shape[0]
        if valid is not None and valid < n:
            out, t, n = out[:valid], t[:valid], valid
        loss = float(self.criterion.apply(out, t))
        return LossResult(loss * n, n)

    def has_device_fold(self) -> bool:
        """Only for a plain mean criterion: the fold sums per-row losses
        under the mask, which is ``mean(loss[:valid])·valid`` only when the
        batch loss is the mean of independent rows (JAX's rule)."""
        c = self.criterion
        if getattr(c, "weights", None) is not None:
            return False
        inner = getattr(c, "inner", None)
        if inner is not None and getattr(inner, "weights", None) is not None:
            return False
        return getattr(c, "size_average", None) is True

    def device_fold(self, out, target, valid_mask):
        crit = self.criterion
        per_row = torch.func.vmap(
            lambda o, t: crit.apply(o[None], t[None]))(out, target)
        per_row = torch.where(valid_mask, per_row, torch.zeros_like(per_row))
        return (per_row.sum(), valid_mask.int().sum())

    def finalize(self, acc) -> ValidationResult:
        loss_sum, count = acc
        return LossResult(float(loss_sum), int(count))


class MAPResult(ValidationResult):
    """Raw per-image detections and ground truth gathered across batches
    (AP ranks globally: per-batch fractions do not add); VOC2010
    all-points mAP at ``result()``."""

    def __init__(self, dets: list, gts: list, iou_threshold: float):
        self.dets = list(dets)     # per image: (K, 6) [label, score, 4 box]
        self.gts = list(gts)       # per image: (G, 5) [label, 4 box]
        self.iou_threshold = iou_threshold

    def __add__(self, other):
        if self.iou_threshold != other.iou_threshold:
            raise ValueError(
                f"cannot merge MAPResults with different IoU thresholds "
                f"({self.iou_threshold} vs {other.iou_threshold})")
        return MAPResult(self.dets + other.dets, self.gts + other.gts,
                         self.iou_threshold)

    @staticmethod
    def _iou(a, b):
        ix = np.maximum(0.0, np.minimum(a[2], b[:, 2])
                        - np.maximum(a[0], b[:, 0]))
        iy = np.maximum(0.0, np.minimum(a[3], b[:, 3])
                        - np.maximum(a[1], b[:, 1]))
        inter = ix * iy
        area_a = max(a[2] - a[0], 0.0) * max(a[3] - a[1], 0.0)
        area_b = (np.clip(b[:, 2] - b[:, 0], 0, None)
                  * np.clip(b[:, 3] - b[:, 1], 0, None))
        return inter / np.maximum(area_a + area_b - inter, 1e-12)

    def result(self):
        def by_class(rows):
            return {c: rows[rows[:, 0] == c]
                    for c in np.unique(rows[:, 0]).astype(int)}

        gt_grp = [by_class(g) for g in self.gts]
        det_grp = [by_class(d) for d in self.dets]
        aps = []
        for c in sorted({c for g in gt_grp for c in g}):
            gt_by_img = [g.get(c, np.zeros((0, 5)))[:, 1:] for g in gt_grp]
            n_gt = sum(len(b) for b in gt_by_img)
            if n_gt == 0:
                continue
            records = [(float(row[1]), i, row[2:])
                       for i, d in enumerate(det_grp)
                       for row in d.get(c, np.zeros((0, 6)))]
            records.sort(key=lambda r: -r[0])
            matched = [np.zeros(len(b), bool) for b in gt_by_img]
            tp = np.zeros(len(records))
            for k, (_, i, box) in enumerate(records):
                boxes = gt_by_img[i]
                if len(boxes):
                    ious = self._iou(box, boxes)
                    j = int(np.argmax(ious))
                    if ious[j] >= self.iou_threshold and not matched[i][j]:
                        matched[i][j] = True
                        tp[k] = 1.0
            cum_tp = np.cumsum(tp)
            recall = cum_tp / n_gt
            precision = cum_tp / (np.arange(len(records)) + 1)
            # the monotone precision envelope, integrated over recall
            for k in range(len(precision) - 2, -1, -1):
                precision[k] = max(precision[k], precision[k + 1])
            ap, prev_r = 0.0, 0.0
            for k in range(len(recall)):
                ap += (recall[k] - prev_r) * precision[k]
                prev_r = recall[k]
            aps.append(ap)
        return (float(np.mean(aps)) if aps else 0.0, len(self.dets))

    def __repr__(self):
        v, c = self.result()
        return f"MeanAveragePrecision({v:.4f}, images={c})"


class MeanAveragePrecision(ValidationMethod):
    """Detection mAP: ``output`` (N, K, 6) rows ``[label, score, xmin,
    ymin, xmax, ymax]``, ``target`` (N, G, 5) padded ground truth
    ``[label, x1, y1, x2, y2]``; rows with label <= 0 (padding, background)
    are dropped on both sides. A host fold."""

    def __init__(self, iou_threshold: float = 0.5):
        self.iou_threshold = float(iou_threshold)
        self.name = "MeanAveragePrecision"

    def apply(self, output, target, valid=None):
        out, gt = _host(output), _host(target)
        if valid is not None and valid < out.shape[0]:
            out, gt = out[:valid], gt[:valid]
        return MAPResult([img[img[:, 0] > 0] for img in out],
                         [g[g[:, 0] > 0] for g in gt], self.iou_threshold)


class MAE(ValidationMethod):
    """Mean absolute error, a row's mean over its elements averaged over
    the valid rows."""

    name = "MAE"

    def apply(self, output, target, valid=None):
        out, t = _host(output), _host(target)
        n = out.shape[0]
        if valid is not None and valid < n:
            out, t, n = out[:valid], t[:valid], valid
        return LossResult(float(np.abs(out - t).mean()) * n, n)

    def has_device_fold(self) -> bool:
        return True

    def device_fold(self, out, target, valid_mask):
        diff = (out - target).abs()
        per_row = diff.reshape(diff.shape[0], -1).mean(1)
        per_row = torch.where(valid_mask, per_row, 0.0)
        return (per_row.sum(), valid_mask.int().sum())

    def finalize(self, acc) -> ValidationResult:
        loss_sum, count = acc
        return LossResult(float(loss_sum), int(count))


class HitRatio(ValidationMethod):
    """HR@k over groups of ``neg_num + 1`` candidates (one positive, target
    1; negatives 0), formed in order: the share of groups whose positive
    has fewer than ``k`` candidates scoring strictly higher. Scores of an
    (N, C) output are its last column (NCF's log P(interaction))."""

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k
        self.neg_num = neg_num
        self.name = f"HitRatio@{k}"

    def _misaligned(self, n: int) -> ValueError:
        group = self.neg_num + 1
        return ValueError(
            f"{self.name}: got {n} scores, not a positive multiple of "
            f"neg_num+1={group}; evaluate with batch_size a multiple of "
            f"{group} so every (positive + negatives) group stays within "
            "one batch")

    def _no_positive(self, n: int = 1) -> ValueError:
        return ValueError(
            f"{self.name}: found {n} candidate group(s) with no positive "
            "label (every label 0); each neg_num+1 group must contain "
            "exactly one positive item")

    def _ranks(self, output, target, valid):
        output = _host(output).reshape(-1)
        target = _host(target).reshape(-1)
        if valid is not None:
            output, target = output[:valid], target[:valid]
        group = self.neg_num + 1
        if len(output) % group != 0 or len(output) == 0:
            raise self._misaligned(len(output))
        rows = len(output) // group
        scores = output.reshape(rows, group)
        labels = target.reshape(rows, group)
        if not (labels.max(axis=1) > 0).all():
            raise self._no_positive()
        pos = scores[np.arange(rows), labels.argmax(axis=1)]
        return 1 + (scores > pos[:, None]).sum(axis=1), rows

    def _gains(self, ranks):
        return (ranks <= self.k).astype(np.float64)

    def apply(self, output, target, valid: Optional[int] = None):
        ranks, n = self._ranks(output, target, valid)
        return AccuracyResult(float(self._gains(ranks).sum()), n)

    def has_device_fold(self) -> bool:
        return True

    def _device_gains(self, ranks):
        return (ranks <= self.k).float()

    def device_fold(self, out, target, valid_mask):
        group = self.neg_num + 1
        scores = out
        if scores.dim() > 1:
            scores = scores.reshape(scores.shape[0], -1)[:, -1]
        scores = scores.reshape(-1)
        n = scores.shape[0]
        if n == 0 or n % group != 0:
            raise self._misaligned(n)
        rows = n // group
        s = scores.reshape(rows, group)
        lab = target.reshape(rows, group)
        gvalid = valid_mask.reshape(rows, group).all(1)
        pos = lab.argmax(1, keepdim=True)
        ranks = 1 + (s > s.gather(1, pos)).sum(1)
        gains = torch.where(gvalid, self._device_gains(ranks), 0.0)
        # a valid group without a positive is refused at finalize (the
        # host path's error, once the sums are fetched)
        bad = gvalid & ~(lab.max(1).values > 0)
        return (gains.sum(), gvalid.int().sum(), bad.int().sum())

    def finalize(self, acc) -> ValidationResult:
        gains, count, bad = acc
        if int(bad) > 0:
            raise self._no_positive(int(bad))
        return AccuracyResult(float(gains), int(count))


class NDCG(HitRatio):
    """NDCG@k over :class:`HitRatio`'s groups: one relevant item a group,
    so a group's gain is ``log(2) / log(1 + rank)`` within the top k."""

    def __init__(self, k: int = 10, neg_num: int = 100):
        super().__init__(k, neg_num)
        self.name = f"NDCG@{k}"

    def _gains(self, ranks):
        return np.where(ranks <= self.k, np.log(2.0) / np.log(1.0 + ranks),
                        0.0)

    def _device_gains(self, ranks):
        r = ranks.float()
        return torch.where(ranks <= self.k,
                           math.log(2.0) / torch.log(1.0 + r), 0.0)
