"""Triggers: composable stop/fire conditions.

Counterpart of ``bigdl_tpu/optim/trigger.py``: ``everyEpoch``,
``severalIteration(n)``, ``maxEpoch(n)``, ``maxIteration(n)``, ``minLoss``,
``maxScore``, ``and``/``or``. A trigger is evaluated against the trainer's
state table (keys: "epoch" 1-based, "neval" 1-based iteration counter,
"loss", "score", "epoch_finished" bool set at epoch boundaries).
``next_fire_in`` answers the fused-dispatch boundary query of the JAX
trainer; the port's trainer runs one step at a time and does not ask it.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional


class Trigger:
    """``scope`` says when side-effect triggers are evaluated: 'iteration'
    (inside the batch loop), 'epoch' (at epoch boundaries), or 'any'.

    ``steps_fn`` (optional): given the trainer state with ``neval`` = the
    iteration about to run, how many iterations may run before this
    trigger must be evaluated again. Data-dependent triggers (minLoss,
    maxScore) leave it unset, read as "could fire after any iteration".
    """

    #: next_fire_in value meaning "cannot fire inside the batch loop at all"
    NEVER_IN_LOOP = sys.maxsize

    def __init__(self, fn: Callable[[dict], bool], name: str = "trigger",
                 scope: str = "any",
                 steps_fn: Optional[Callable[[dict], int]] = None):
        self._fn = fn
        self._name = name
        self.scope = scope
        self._steps_fn = steps_fn

    def __call__(self, state: dict) -> bool:
        return bool(self._fn(state))

    def next_fire_in(self, state: dict) -> int:
        """Iterations (>= 1) that may run, starting at ``state['neval']``,
        before this trigger could first fire."""
        if self._steps_fn is None:
            return 1
        return max(1, int(self._steps_fn(state)))

    def __repr__(self):
        return f"Trigger({self._name})"

    # factories ------------------------------------------------------------
    @staticmethod
    def every_epoch() -> "Trigger":
        return Trigger(lambda s: s.get("epoch_finished", False), "everyEpoch",
                       scope="epoch",
                       steps_fn=lambda s: Trigger.NEVER_IN_LOOP)

    @staticmethod
    def several_iteration(interval: int) -> "Trigger":
        # fires at iterations i with i % interval == 0; from neval=cur the
        # first such i is cur + ((-cur) % interval)
        return Trigger(lambda s: s.get("neval", 0) % interval == 0,
                       f"severalIteration({interval})", scope="iteration",
                       steps_fn=lambda s: (-s.get("neval", 0)) % interval + 1)

    @staticmethod
    def max_epoch(n: int) -> "Trigger":
        return Trigger(lambda s: s.get("epoch", 1) > n, f"maxEpoch({n})",
                       steps_fn=lambda s: Trigger.NEVER_IN_LOOP)

    @staticmethod
    def max_iteration(n: int) -> "Trigger":
        # checked at loop top with neval starting at 1 → runs exactly n
        # iterations
        return Trigger(lambda s: s.get("neval", 0) > n, f"maxIteration({n})",
                       steps_fn=lambda s: n - s.get("neval", 0) + 1)

    @staticmethod
    def min_loss(value: float) -> "Trigger":
        return Trigger(lambda s: s.get("loss", float("inf")) < value,
                       f"minLoss({value})")

    @staticmethod
    def max_score(value: float) -> "Trigger":
        return Trigger(lambda s: s.get("score", float("-inf")) > value,
                       f"maxScore({value})")

    @staticmethod
    def and_(*triggers: "Trigger") -> "Trigger":
        # fires only when ALL children fire: not before the latest
        # first-possible-fire among them
        return Trigger(lambda s: all(t(s) for t in triggers), "and",
                       steps_fn=lambda s: max(
                           (t.next_fire_in(s) for t in triggers), default=1))

    @staticmethod
    def or_(*triggers: "Trigger") -> "Trigger":
        # fires as soon as ANY child fires: the earliest child bound wins
        return Trigger(lambda s: any(t(s) for t in triggers), "or",
                       steps_fn=lambda s: min(
                           (t.next_fire_in(s) for t in triggers), default=1))
