"""Validation methods and their results.

Counterpart of ``bigdl_tpu/optim/validation.py:38-273``:
``ValidationResult``, ``AccuracyResult``, ``LossResult``,
``ValidationMethod``, ``TopKAccuracy`` (``Top1Accuracy``,
``Top5Accuracy``) and ``Loss``. Partial results add with ``+`` and
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
