"""Loss criterions on the language model's path.

Counterpart of ``bigdl_tpu/nn/criterion.py`` for ``ClassNLLCriterion``,
``CrossEntropyCriterion``, ``ParallelCriterion`` and
``TimeDistributedCriterion``. A criterion is
a function ``apply(input, target) -> scalar`` in torch ops, differentiated
by autograd together with the model. Targets are 0-based class indices
unless ``one_based=True`` (the reference's Torch labels).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.utils.table import Table


class AbstractCriterion:
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


class ClassNLLCriterion(AbstractCriterion):
    """Negative log-likelihood over log-probabilities (pairs with
    LogSoftMax). ``weights`` scales each class; with ``size_average`` the
    weighted sum is divided by the sum of the picked weights."""

    def __init__(self, weights=None, size_average: bool = True,
                 logprob_as_input: bool = True, one_based: bool = False):
        self.weights = (None if weights is None
                        else torch.as_tensor(weights, dtype=torch.float32))
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
            w = self.weights.to(picked.device)[idx]
            loss = -(picked * w)
            return loss.sum() / w.sum() if self.size_average else loss.sum()
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
