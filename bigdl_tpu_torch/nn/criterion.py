"""Loss criterions.

Counterpart of ``bigdl_tpu/nn/criterion.py``, every criterion of it. A
criterion is a function ``apply(input, target) -> scalar`` in torch ops,
differentiated by autograd together with the model. Targets are 0-based
class indices unless ``one_based=True`` (the reference's Torch labels).
Each exposes ``size_average``, which the trainer's gradient accumulation
reads (a mean-like loss averages its micro-batches, a sum adds them).

JAX's ``jnp.maximum(0, z)`` splits the gradient at a tie, as
``torch.maximum`` does, so the hinges here take ``torch.maximum`` with a
0-d zero. ``SoftmaxWithCriterion`` and ``TimeDistributedMaskCriterion``
on logits are fp32 islands (their log-softmax runs in fp32), as in JAX.
Constant tables (class weights, the simplex's vertices) are copied to a
device once, at their first use there, and reused: a captured program
copies nothing from the host. ``MultiLabelMarginCriterion`` builds JAX's
(n, L, c) hinge: O(n·c²) memory, as JAX's does. ``TransformerCriterion``
runs its transforms in eval mode on detached parameters (JAX captures
them as constants): the gradient reaches the input, not the transforms.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from bigdl_tpu_torch.nn.abstractnn import RecordsInit, evaluating
from bigdl_tpu_torch.parallel.collectives import global_mean
from bigdl_tpu_torch.utils.table import Table


class AbstractCriterion(metaclass=RecordsInit):
    def apply(self, input, target) -> torch.Tensor:
        """The loss as a scalar tensor."""
        raise NotImplementedError

    def forward(self, input, target) -> torch.Tensor:
        return self.apply(input, target)

    def __call__(self, input, target) -> torch.Tensor:
        return self.apply(input, target)

    def __repr__(self):
        return type(self).__name__


def _reduce(loss: torch.Tensor, size_average: bool) -> torch.Tensor:
    return loss.mean() if size_average else loss.sum()


def _relu0(z: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(0, z)``: a tie at 0 splits the gradient."""
    return torch.maximum(z, z.new_zeros(()))


def _pair(input) -> tuple:
    return (input[1], input[2]) if isinstance(input, Table) \
        else (input[0], input[1])


class _OnDevice:
    """A constant host tensor, copied to each device once."""

    def __init__(self, value):
        self.host = torch.as_tensor(np.asarray(value, np.float32))
        self._copies: dict = {}

    def on(self, device) -> torch.Tensor:
        t = self._copies.get(device)
        if t is None:
            t = self._copies[device] = self.host.to(device)
        return t


class ClassNLLCriterion(AbstractCriterion):
    """Negative log-likelihood over log-probabilities (pairs with
    LogSoftMax). ``weights`` scales each class; with ``size_average`` the
    weighted sum is divided by the sum of the picked weights."""

    def __init__(self, weights=None, size_average: bool = True,
                 logprob_as_input: bool = True, one_based: bool = False):
        self.weights = None if weights is None else _OnDevice(weights)
        self.size_average = size_average
        self.logprob_as_input = logprob_as_input
        self.one_based = one_based

    def apply(self, input, target):
        logp = input if self.logprob_as_input \
            else torch.log(input.clamp(min=1e-8))
        if logp.dim() == 1:
            logp = logp[None]
            target = target.reshape(1)
        idx = target.reshape(-1).long()
        if self.one_based:
            idx = idx - 1
        picked = logp.gather(1, idx[:, None])[:, 0]
        if self.weights is not None:
            w = self.weights.on(picked.device)[idx]
            loss = -(picked * w)
            return (global_mean(loss.sum(), w.sum()) if self.size_average
                    else loss.sum())
        return _reduce(-picked, self.size_average)


class CrossEntropyCriterion(AbstractCriterion):
    """LogSoftMax + ClassNLL fused (input = raw logits)."""

    def __init__(self, weights=None, size_average: bool = True,
                 one_based: bool = False):
        self.inner = ClassNLLCriterion(weights, size_average,
                                       one_based=one_based)

    @property
    def size_average(self) -> bool:
        return self.inner.size_average

    def apply(self, input, target):
        return self.inner.apply(F.log_softmax(input, dim=-1), target)


class ParallelCriterion(AbstractCriterion):
    """Weighted sum of criterions over (Table input, Table target) pairs;
    ``repeat_target`` gives every criterion the same target (Inception's
    three heads)."""

    def __init__(self, repeat_target: bool = False):
        self.criterions: list = []
        self.repeat_target = repeat_target

    def add(self, criterion: AbstractCriterion,
            weight: float = 1.0) -> "ParallelCriterion":
        self.criterions.append((criterion, weight))
        return self

    @property
    def size_average(self) -> bool:
        # a weighted sum of means is itself mean-like under gradient
        # accumulation; only an all-sum composite accumulates by summing
        return all(bool(getattr(c, "size_average", True))
                   for c, _ in self.criterions)

    def apply(self, input, target):
        xs = input.values() if isinstance(input, Table) else list(input)
        if self.repeat_target:
            ts = [target] * len(xs)
        else:
            ts = target.values() if isinstance(target, Table) else list(target)
        total = 0.0
        for (crit, w), x, t in zip(self.criterions, xs, ts):
            total = total + w * crit.apply(x, t)
        return total


class TimeDistributedCriterion(AbstractCriterion):
    """Apply an inner criterion at every timestep of (N, T, ...) input.

    The reference argument ``size_average`` means "divide by T"; it is kept
    as ``time_average``, and the ``size_average`` property answers the batch
    question for gradient accumulation from the inner criterion, as in JAX.
    """

    def __init__(self, criterion: AbstractCriterion,
                 size_average: bool = False, dimension: int = 2):
        self.criterion = criterion
        self.time_average = size_average

    @property
    def size_average(self) -> bool:
        return bool(getattr(self.criterion, "size_average", True))

    def apply(self, input, target):
        # Σ_t inner(input[:, t], target[:, t]), over T when time-averaging,
        # computed as one inner call on the (N·T, ...) flattening: an
        # averaging inner criterion already divides by T there
        t_steps = input.shape[1]
        flat_in = input.reshape((-1,) + tuple(input.shape[2:]))
        flat_t = target.reshape((-1,) + tuple(target.shape[2:]))
        loss = self.criterion.apply(flat_in, flat_t)
        if bool(getattr(self.criterion, "size_average", False)):
            return loss if self.time_average else loss * t_steps
        return loss / t_steps if self.time_average else loss


class MSECriterion(AbstractCriterion):
    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        return _reduce((input - target).square(), self.size_average)


class AbsCriterion(AbstractCriterion):
    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        return _reduce((input - target).abs(), self.size_average)


class BCECriterion(AbstractCriterion):
    """Binary cross-entropy of probabilities (clipped to [1e-12, 1 -
    1e-12]), optionally weighted per element."""

    def __init__(self, weights=None, size_average: bool = True):
        self.weights = None if weights is None else _OnDevice(weights)
        self.size_average = size_average

    def apply(self, input, target):
        p = input.clamp(1e-12, 1.0 - 1e-12)
        loss = -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))
        if self.weights is not None:
            loss = loss * self.weights.on(loss.device)
        return _reduce(loss, self.size_average)


def _bce_logits(x, t):
    return _relu0(x) - x * t + torch.log1p(torch.exp(-x.abs()))


class BCECriterionWithLogits(AbstractCriterion):
    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        return _reduce(_bce_logits(input, target), self.size_average)


class SmoothL1Criterion(AbstractCriterion):
    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        d = (input - target).abs()
        return _reduce(torch.where(d < 1.0, 0.5 * d * d, d - 0.5),
                       self.size_average)


class MarginCriterion(AbstractCriterion):
    """Hinge loss, target in {-1, 1}."""

    def __init__(self, margin: float = 1.0, size_average: bool = True,
                 squared: bool = False):
        self.margin, self.size_average, self.squared = \
            margin, size_average, squared

    def apply(self, input, target):
        loss = _relu0(self.margin - input * target)
        if self.squared:
            loss = loss.square()
        return _reduce(loss, self.size_average)


class HingeEmbeddingCriterion(AbstractCriterion):
    def __init__(self, margin: float = 1.0, size_average: bool = True):
        self.margin, self.size_average = margin, size_average

    def apply(self, input, target):
        return _reduce(torch.where(target > 0, input,
                                   _relu0(self.margin - input)),
                       self.size_average)


class DistKLDivCriterion(AbstractCriterion):
    """KL(target || input): input log-probabilities, target
    probabilities."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        loss = torch.where(target > 0, target * (
            torch.log(target.clamp(min=1e-12)) - input), 0.0)
        return _reduce(loss, self.size_average)


class MultiLabelSoftMarginCriterion(AbstractCriterion):
    def __init__(self, weights=None, size_average: bool = True):
        self.weights = None if weights is None else _OnDevice(weights)
        self.size_average = size_average

    def apply(self, input, target):
        loss = _bce_logits(input, target)
        if self.weights is not None:
            loss = loss * self.weights.on(loss.device)
        return _reduce(loss, self.size_average)


def _cos(x1, x2):
    return (x1 * x2).sum(-1) / (torch.linalg.vector_norm(x1, dim=-1)
                                * torch.linalg.vector_norm(x2, dim=-1)
                                ).clamp(min=1e-12)


class CosineEmbeddingCriterion(AbstractCriterion):
    """``1 - cos`` for target 1, ``max(0, cos - margin)`` otherwise, on a
    Table pair."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        self.margin, self.size_average = margin, size_average

    def apply(self, input, target):
        cos = _cos(*_pair(input))
        t = target.reshape(cos.shape)
        return _reduce(torch.where(t > 0, 1.0 - cos,
                                   _relu0(cos - self.margin)),
                       self.size_average)


class MarginRankingCriterion(AbstractCriterion):
    """``max(0, -y (x1 - x2) + margin)`` on a Table pair of scores."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        self.margin, self.size_average = margin, size_average

    def apply(self, input, target):
        x1, x2 = _pair(input)
        t = target.reshape(x1.shape)
        return _reduce(_relu0(-t * (x1 - x2) + self.margin),
                       self.size_average)


class MultiMarginCriterion(AbstractCriterion):
    """Multi-class hinge: ``sum_{j != y} max(0, margin - x[y] + x[j])^p /
    c``, ``p`` 1 or 2, class ``weights`` optional."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True, one_based: bool = False):
        if p not in (1, 2):
            raise ValueError("p must be 1 or 2")
        self.p, self.margin, self.size_average = p, margin, size_average
        self.weights = None if weights is None else _OnDevice(weights)
        self.one_based = one_based

    def apply(self, input, target):
        x = input if input.dim() == 2 else input[None]
        t = target.reshape(-1).long()
        if self.one_based:
            t = t - 1
        c = x.shape[1]
        loss = _relu0(self.margin - x.gather(1, t[:, None]) + x)
        if self.p == 2:
            loss = loss.square()
        if self.weights is not None:
            loss = loss * self.weights.on(loss.device)[t][:, None]
        mask = torch.arange(c, device=x.device)[None, :] != t[:, None]
        per_sample = (loss * mask).sum(1) / c
        return per_sample.mean() if self.size_average else per_sample.sum()


class MultiLabelMarginCriterion(AbstractCriterion):
    """Multi-label hinge: each row of ``target`` lists label indices up
    to the first sentinel (0 with ``one_based``, else -1); every listed
    label's score is hinged against every unlisted class, over an (n, L,
    c) tensor, divided by c."""

    def __init__(self, size_average: bool = True, one_based: bool = False):
        self.size_average = size_average
        self.one_based = one_based

    def apply(self, input, target):
        x = input if input.dim() == 2 else input[None]
        t = (target if target.dim() == 2 else target[None]).long()
        n, c = x.shape
        sentinel = 0 if self.one_based else -1
        valid = (t == sentinel).cumsum(1) == 0                   # (n, L)
        idx = (t - (1 if self.one_based else 0)).clamp(0, c - 1)
        is_target = torch.zeros_like(x).scatter_add(
            1, idx, valid.to(x.dtype)).clamp(0.0, 1.0)           # (n, c)
        margins = _relu0(1.0 - x.gather(1, idx)[:, :, None]
                         + x[:, None, :])                        # (n, L, c)
        mask = valid[:, :, None] * (1.0 - is_target)[:, None, :]
        per_sample = (margins * mask).sum((1, 2)) / c
        return per_sample.mean() if self.size_average else per_sample.sum()


class SoftMarginCriterion(AbstractCriterion):
    """``log(1 + exp(-y x))``, target in {-1, 1}."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        z = -input * target
        return _reduce(torch.logaddexp(z.new_zeros(()), z), self.size_average)


class CosineDistanceCriterion(AbstractCriterion):
    """``1 - cos(input, target)``."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        from bigdl_tpu_torch.nn.cosine import cosine_similarity
        return _reduce(1.0 - cosine_similarity(input, target),
                       self.size_average)


class L1HingeEmbeddingCriterion(AbstractCriterion):
    """``d = |x1 - x2|_1`` of a Table pair: ``d`` for target 1, else
    ``max(0, margin - d)``; the batch mean."""

    size_average = True

    def __init__(self, margin: float = 1.0):
        self.margin = margin

    def apply(self, input, target):
        x1, x2 = _pair(input)
        d = (x1 - x2).abs().sum(-1)
        t = target.reshape(d.shape)
        return torch.where(t > 0, d, _relu0(self.margin - d)).mean()


class PoissonCriterion(AbstractCriterion):
    """``mean(pred - target · log(pred))`` (pred clipped at 1e-12)."""

    size_average = True

    def apply(self, input, target):
        return (input - target * torch.log(input.clamp(min=1e-12))).mean()


class CosineProximityCriterion(AbstractCriterion):
    """The negated mean cosine similarity."""

    size_average = True

    def apply(self, input, target):
        from bigdl_tpu_torch.nn.cosine import cosine_similarity
        return -cosine_similarity(input, target).mean()


class MeanAbsolutePercentageCriterion(AbstractCriterion):
    """``100 · mean(|t - x| / max(|t|, 1e-7))``."""

    size_average = True

    def apply(self, input, target):
        return 100.0 * ((target - input).abs()
                        / target.abs().clamp(min=1e-7)).mean()


class MeanSquaredLogarithmicCriterion(AbstractCriterion):
    """``mean((log(1 + t) - log(1 + x))²)``, both clipped at 0."""

    size_average = True

    def apply(self, input, target):
        return (torch.log1p(target.clamp(min=0.0))
                - torch.log1p(input.clamp(min=0.0))).square().mean()


class KullbackLeiblerDivergenceCriterion(AbstractCriterion):
    """KL(target || input) of probability rows (both clipped to [1e-7,
    1]), the batch mean."""

    size_average = True

    def apply(self, input, target):
        t = target.clamp(1e-7, 1.0)
        p = input.clamp(1e-7, 1.0)
        return (t * torch.log(t / p)).sum(-1).mean()


class ClassSimplexCriterion(AbstractCriterion):
    """MSE against class ``y``'s vertex of a regular simplex in
    R^n_classes (JAX's Gram-Schmidt construction)."""

    def __init__(self, n_classes: int, size_average: bool = True,
                 one_based: bool = False):
        if n_classes < 2:
            raise ValueError("n_classes must be >= 2")
        self.n_classes = n_classes
        self.size_average = size_average
        self.one_based = one_based
        self._simplex = _OnDevice(self._build_simplex(n_classes))

    @staticmethod
    def _build_simplex(k: int) -> np.ndarray:
        a = np.zeros((k, k), np.float32)
        for i in range(k):
            for j in range(i):
                a[i, j] = -(1.0 / k + np.dot(a[i], a[j])) / a[j, j] \
                    if a[j, j] != 0 else 0.0
            a[i, i] = np.sqrt(max(1.0 - np.sum(a[i] ** 2), 0.0))
        return a

    def apply(self, input, target):
        t = target.reshape(-1).long()
        if self.one_based:
            t = t - 1
        goal = self._simplex.on(input.device)[t]
        return _reduce((input - goal).square(), self.size_average)


class MultiCriterion(AbstractCriterion):
    """Weighted sum of criteria on the same (input, target)."""

    def __init__(self):
        self.criterions: list = []

    def add(self, criterion: AbstractCriterion,
            weight: float = 1.0) -> "MultiCriterion":
        self.criterions.append((criterion, weight))
        return self

    @property
    def size_average(self) -> bool:
        return all(bool(getattr(c, "size_average", True))
                   for c, _ in self.criterions)

    def apply(self, input, target):
        total = 0.0
        for crit, w in self.criterions:
            total = total + w * crit.apply(input, target)
        return total


class L1Cost(AbstractCriterion):
    """``sum |input|`` (the target is ignored)."""

    size_average = False

    def apply(self, input, target):
        return input.abs().sum()


class KLDCriterion(AbstractCriterion):
    """The Gaussian KL divergence of ``Table(mean, log_var)`` to the unit
    prior, ``0.5 · sum(mu² + exp(log_var) - 1 - log_var)`` a row (the
    target is ignored)."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        mu, log_var = _pair(input)
        kl = 0.5 * (mu.square() + torch.exp(log_var) - 1.0 - log_var).sum(-1)
        return kl.mean() if self.size_average else kl.sum()


class GaussianCriterion(AbstractCriterion):
    """The negative log-likelihood of ``target`` under N(mean,
    exp(log_var)) given ``Table(mean, log_var)``."""

    def __init__(self, size_average: bool = False):
        self.size_average = size_average

    def apply(self, input, target):
        mu, log_var = _pair(input)
        nll = 0.5 * (math.log(2.0 * math.pi) + log_var
                     + (target - mu).square() / torch.exp(log_var))
        return _reduce(nll, self.size_average)


class DiceCoefficientCriterion(AbstractCriterion):
    """``1 - 2·Σxy / (Σx + Σy + epsilon)`` a sample."""

    def __init__(self, size_average: bool = True, epsilon: float = 1.0):
        self.size_average = size_average
        self.epsilon = epsilon

    def apply(self, input, target):
        x = input.reshape(input.shape[0], -1)
        y = target.reshape(target.shape[0], -1).to(x.dtype)
        loss = 1.0 - 2.0 * (x * y).sum(1) / (x.sum(1) + y.sum(1)
                                              + self.epsilon)
        return loss.mean() if self.size_average else loss.sum()


class SoftmaxWithCriterion(AbstractCriterion):
    """Softmax and multinomial logistic loss over logits with classes on
    axis 1 (Caffe's ``SoftmaxWithLoss``): ``ignore_label`` optional, and
    the sum divided by the non-ignored count (``valid``), by every row
    (``full``), by the batch (``batch_size``) or not (``none``)."""

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode: str = "valid", one_based: bool = False):
        if normalize_mode not in ("valid", "full", "batch_size", "none"):
            raise ValueError(f"unknown normalize_mode {normalize_mode!r}")
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode
        self.one_based = one_based
        self.size_average = normalize_mode != "none"

    def apply(self, input, target):
        logp = F.log_softmax(input.float(), dim=1) if input.dim() > 1 \
            else F.log_softmax(input, dim=-1)
        logp = logp.movedim(1, -1).reshape(-1, input.shape[1])
        idx = target.reshape(-1).long()
        if self.one_based:
            idx = idx - 1
        if self.ignore_label is not None:
            ignore = self.ignore_label - (1 if self.one_based else 0)
            keep = idx != ignore
            mask = keep.to(logp.dtype)
            # an ignored row (Caffe's 255 may be out of range) picks class
            # 0, then is masked out: no NaN leaks through 0 * NaN
            idx = torch.where(keep, idx, torch.zeros_like(idx))
            picked = -logp.gather(1, idx[:, None])[:, 0] * mask
            valid = mask.sum()
        else:
            picked = -logp.gather(1, idx[:, None])[:, 0]
            valid = picked.shape[0]
        total = picked.sum()
        if self.normalize_mode == "valid":
            if isinstance(valid, torch.Tensor):
                return global_mean(total, valid, min_count=1.0)
            return total / max(valid, 1.0)
        if self.normalize_mode == "full":
            return total / picked.shape[0]
        if self.normalize_mode == "batch_size":
            return total / input.shape[0]
        return total


class CategoricalCrossEntropy(AbstractCriterion):
    """``-sum(target · log(clip(p, 1e-8, 1)))`` a row, probabilities
    against one-hot targets."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        loss = -(target * torch.log(input.clamp(1e-8, 1.0))).sum(-1)
        return loss.mean() if self.size_average else loss.sum()


class TimeDistributedMaskCriterion(AbstractCriterion):
    """A class-index criterion (``ClassNLLCriterion`` or
    ``CrossEntropyCriterion``) at every step of (N, T, C) input, skipping
    the steps whose target is ``padding_value``: the mean runs over the
    other steps only."""

    size_average = True

    def __init__(self, criterion: AbstractCriterion, padding_value: int = 0):
        if isinstance(criterion, CrossEntropyCriterion):
            self._logits = True
        elif isinstance(criterion, ClassNLLCriterion):
            self._logits = not criterion.logprob_as_input
        else:
            raise TypeError(
                "TimeDistributedMaskCriterion supports class-index criterions "
                f"(ClassNLL/CrossEntropy), got {type(criterion).__name__}")
        inner = criterion.inner if isinstance(criterion,
                                              CrossEntropyCriterion) \
            else criterion
        self.one_based = inner.one_based
        self.padding_value = padding_value

    def apply(self, input, target):
        logp = input.reshape(-1, input.shape[-1])
        if self._logits:
            logp = F.log_softmax(logp.float(), dim=-1)
        raw = target.reshape(-1)
        keep = raw != self.padding_value
        mask = keep.to(logp.dtype)
        idx = raw.long() - (1 if self.one_based else 0)
        idx = torch.where(keep, idx, torch.zeros_like(idx))
        picked = -logp.gather(1, idx[:, None])[:, 0]
        return global_mean((picked * mask).sum(), mask.sum(), min_count=1.0)


class SmoothL1CriterionWithWeights(AbstractCriterion):
    """Fast R-CNN's box regression loss: target ``Table(t, inside_w,
    outside_w)`` (or a bare t), ``sum(outside_w · smoothL1(inside_w ·
    (x - t)))`` with the Huber knee at ``1/sigma²``, over ``num`` when
    positive."""

    size_average = False

    def __init__(self, sigma: float = 1.0, num: int = 0):
        self.sigma2 = sigma * sigma
        self.num = num

    def apply(self, input, target):
        if isinstance(target, Table):
            t, iw, ow = target.values()
        elif isinstance(target, (tuple, list)) and len(target) == 3:
            t, iw, ow = target
        else:
            t, iw, ow = target, None, None
        d = input - t
        if iw is not None:
            d = d * iw
        ad = d.abs()
        loss = torch.where(ad < 1.0 / self.sigma2,
                           0.5 * self.sigma2 * d.square(),
                           ad - 0.5 / self.sigma2)
        if ow is not None:
            loss = loss * ow
        total = loss.sum()
        return total / self.num if self.num > 0 else total


class TransformerCriterion(AbstractCriterion):
    """An inner criterion on transformed input and/or target (the
    perceptual loss): each transform runs in eval mode on its detached
    parameters, so it does not train through the loss."""

    def __init__(self, criterion: AbstractCriterion,
                 input_transformer=None, target_transformer=None):
        self.criterion = criterion
        self.input_transformer = input_transformer
        self.target_transformer = target_transformer

    @property
    def size_average(self) -> bool:
        return bool(getattr(self.criterion, "size_average", True))

    @staticmethod
    def _run(module, x):
        if module is None:
            return x
        params = {n: p.detach() for n, p in module.named_parameters()}
        with evaluating(module):
            return functional_call(module, params, (x,))

    def apply(self, input, target):
        return self.criterion.apply(self._run(self.input_transformer, input),
                                    self._run(self.target_transformer,
                                              target))
