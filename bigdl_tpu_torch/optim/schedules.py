"""Learning-rate schedules for :class:`~bigdl_tpu_torch.optim.SGD`.

Counterpart of ``bigdl_tpu/optim/schedules.py``: ``Default``, ``Step``,
``MultiStep``, ``Poly``, ``Exponential``, ``NaturalExp``, ``Warmup``,
``SequentialSchedule`` and ``Plateau``. A schedule maps
``(base_lr, step) -> lr`` with the 0-based step, on the host (the port's
update takes its learning rate as a Python number, so there is no trace to
keep the step inside). ``Plateau`` is the one stateful schedule: it reacts
to a monitored metric, and SGD keeps its current rate in the optimizer
state (``state["clr"]``). The trainer hook that feeds it after validation
comes with validation (ROADMAP Queue A.1.6); call :meth:`Plateau.on_metric`
directly until then.
"""

from __future__ import annotations

import math
from typing import Sequence


class LearningRateSchedule:
    """Maps (base_lr, 0-based iteration) to a learning rate."""

    stateful = False

    def __call__(self, base_lr: float, step: float) -> float:
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


class Default(LearningRateSchedule):
    """``clr = lr / (1 + step * decay)``, the reference SGD default."""

    def __init__(self, learningrate_decay: float = 0.0):
        self.learningrate_decay = learningrate_decay

    def __call__(self, base_lr, step):
        return base_lr / (1.0 + step * self.learningrate_decay)


class Step(LearningRateSchedule):
    """``clr = lr * gamma ^ floor(step / step_size)``."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def __call__(self, base_lr, step):
        return base_lr * self.gamma ** math.floor(step / self.step_size)


class MultiStep(LearningRateSchedule):
    """``clr = lr * gamma ^ (number of milestones passed)``."""

    def __init__(self, step_sizes: Sequence[int], gamma: float):
        self.step_sizes = tuple(step_sizes)
        self.gamma = gamma

    def __call__(self, base_lr, step):
        return base_lr * self.gamma ** sum(step >= m for m in self.step_sizes)


class Poly(LearningRateSchedule):
    """``clr = lr * (1 - step/max_iteration) ^ power``; 0 beyond
    ``max_iteration``."""

    def __init__(self, power: float, max_iteration: int):
        self.power = power
        self.max_iteration = max_iteration

    def __call__(self, base_lr, step):
        frac = min(max(step / self.max_iteration, 0.0), 1.0)
        return base_lr * (1.0 - frac) ** self.power


class Exponential(LearningRateSchedule):
    """``clr = lr * decay_rate ^ (step / decay_step)``, the exponent floored
    when ``stair_case``."""

    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False):
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.stair_case = stair_case

    def __call__(self, base_lr, step):
        exponent = step / self.decay_step
        if self.stair_case:
            exponent = math.floor(exponent)
        return base_lr * self.decay_rate ** exponent


class NaturalExp(LearningRateSchedule):
    """``clr = lr * exp(-decay_rate * step / decay_step)``, the quotient
    floored when ``stair_case``."""

    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False):
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.stair_case = stair_case

    def __call__(self, base_lr, step):
        exponent = step / self.decay_step
        if self.stair_case:
            exponent = math.floor(exponent)
        return base_lr * math.exp(-self.decay_rate * exponent)


class Warmup(LearningRateSchedule):
    """``clr = lr + delta * step``: a linear ramp, used inside
    :class:`SequentialSchedule`."""

    def __init__(self, delta: float):
        self.delta = delta

    def __call__(self, base_lr, step):
        return base_lr + self.delta * step


class SequentialSchedule(LearningRateSchedule):
    """Chain of ``(schedule, duration_iterations)`` stages. Each stage sees
    a stage-local step counting from 0; the last stage runs on forever."""

    def __init__(self):
        self.stages: list = []

    def add(self, schedule: LearningRateSchedule,
            max_iteration: int) -> "SequentialSchedule":
        self.stages.append((schedule, int(max_iteration)))
        return self

    def __call__(self, base_lr, step):
        if not self.stages:
            return base_lr
        lr, offset = None, 0
        for sched, dur in self.stages:
            local = step - offset
            if lr is None or local >= 0:
                lr = sched(base_lr, max(local, 0))
            offset += dur
        return lr


class Plateau(LearningRateSchedule):
    """Reduce the rate when a monitored metric stops improving (stateful,
    on the host). Mirrors the reference's ``SGD.Plateau(monitor, factor,
    patience, mode, epsilon, cooldown, minLr)`` with Keras'
    ``ReduceLROnPlateau`` cooldown: the counter is decremented first, so the
    round on which the cooldown ends counts toward patience."""

    stateful = True

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min", epsilon: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        if factor >= 1.0:
            raise ValueError("Plateau factor must be < 1.0")
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.current_lr: float = None   # set by SGD from its learningrate
        self._best: float = None
        self._wait = 0
        self._cooldown_left = 0

    def reset(self, base_lr: float) -> None:
        self.current_lr = base_lr
        self._best = None
        self._wait = 0
        self._cooldown_left = 0

    def state_dict(self) -> dict:
        return {"current_lr": self.current_lr, "best": self._best,
                "wait": self._wait, "cooldown_left": self._cooldown_left}

    def load_state_dict(self, d: dict) -> None:
        self.current_lr = d["current_lr"]
        self._best = d["best"]
        self._wait = d["wait"]
        self._cooldown_left = d["cooldown_left"]

    def _improved(self, value: float) -> bool:
        if self._best is None:
            return True
        if self.mode == "min":
            return value < self._best - self.epsilon
        return value > self._best + self.epsilon

    def on_metric(self, value: float) -> float:
        """Record a monitored value; return the (maybe reduced) rate."""
        if self.current_lr is None:
            raise RuntimeError("Plateau.reset(base_lr) must be called before "
                               "on_metric")
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._wait = 0
        if self._improved(value):
            self._best = value
            self._wait = 0
        elif self._cooldown_left <= 0:
            self._wait += 1
            if self._wait > self.patience:
                self.current_lr = max(self.current_lr * self.factor,
                                      self.min_lr)
                self._cooldown_left = self.cooldown
                self._wait = 0
        return self.current_lr

    def __call__(self, base_lr, step):
        return self.current_lr if self.current_lr is not None else base_lr
