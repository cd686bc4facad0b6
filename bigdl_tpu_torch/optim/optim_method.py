"""Optimization methods: SGD and Adam.

Counterpart of ``bigdl_tpu/optim/optim_method.py`` (``OptimMethod``,
``decayed_lr``, ``SGD``, ``Adam``). JAX's methods are pure transforms
``update(params, grads, state, step) -> (new_params, new_state)``; here
``update`` writes the new values into the parameter and slot tensors in
place under ``torch.no_grad()`` (a copy of every parameter per step would
double the update's memory traffic). The arithmetic follows JAX: ``step``
is 0-based, the default decay is ``lr / (1 + step · decay)``, and Adam's
bias corrections use ``t = step + 1``.

Learning-rate schedules (``optim/schedules.py``) and per-layer LR
multipliers are not ported yet (ROADMAP Queue A.1).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def decayed_lr(learningrate: float, learningrate_decay: float,
               step: int) -> float:
    """The reference's default decay: ``lr / (1 + step * decay)``."""
    return learningrate / (1.0 + step * learningrate_decay)


class OptimMethod:
    def init_state(self, params: Sequence[torch.Tensor]) -> dict:
        """Slots for ``params`` (lists of tensors shaped like them)."""
        return {}

    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: dict, step: int) -> None:
        """Step ``params`` and ``state`` in place; ``step`` is 0-based."""
        raise NotImplementedError

    def get_learning_rate(self, step: int) -> float:
        return 0.0

    def __repr__(self):
        return type(self).__name__


class SGD(OptimMethod):
    """SGD with momentum, dampening, nesterov and weight decay, at the
    reference's default decayed learning rate."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, weightdecay: float = 0.0,
                 momentum: float = 0.0, dampening: Optional[float] = None,
                 nesterov: bool = False, learningrate_schedule=None,
                 layer_lr_mults: Optional[dict] = None):
        if learningrate_schedule is not None or layer_lr_mults:
            raise NotImplementedError(
                "learning-rate schedules and layer_lr_mults are not ported "
                "yet (optim/schedules.py): ROADMAP Queue A.1")
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.weightdecay = weightdecay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError("nesterov requires momentum > 0 and "
                             "dampening = 0")

    def get_learning_rate(self, step: int) -> float:
        return decayed_lr(self.learningrate, self.learningrate_decay, step)

    def init_state(self, params):
        if self.momentum > 0:
            return {"v": [torch.zeros_like(p) for p in params]}
        return {}

    def update(self, params, grads, state, step):
        lr = self.get_learning_rate(step)
        wd, mu, damp = self.weightdecay, self.momentum, self.dampening
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, grads)):
                if wd > 0:
                    g = g + wd * p
                if mu > 0:
                    v = state["v"][i]
                    v.mul_(mu).add_(g, alpha=1.0 - damp)
                    g = g + mu * v if self.nesterov else v
                p.sub_(g, alpha=lr)


class Adam(OptimMethod):
    """Adam with the reference's default decayed learning rate."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def get_learning_rate(self, step: int) -> float:
        return decayed_lr(self.learningrate, self.learningrate_decay, step)

    def init_state(self, params):
        return {"m": [torch.zeros_like(p) for p in params],
                "v": [torch.zeros_like(p) for p in params]}

    def update(self, params, grads, state, step):
        t = step + 1
        lr = self.get_learning_rate(step)
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, state["m"], state["v"]):
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                # p - lr · (m / bc1) / (sqrt(v / bc2) + eps)
                denom = (v / bc2).sqrt_().add_(eps)
                p.addcdiv_(m / bc1, denom, value=-lr)
