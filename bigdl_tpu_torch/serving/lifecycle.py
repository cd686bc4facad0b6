"""The train -> eval -> promote -> serve lifecycle, every handoff guarded.

Counterpart of ``bigdl_tpu/serving/lifecycle.py``. The
:class:`PromotionController` drives one serving target through:

1. **Gate**: a registry ``candidate`` version is scored (the port's
   ``Evaluator`` on ``eval_model``, or an ``eval_fn``) against a
   :class:`PromotionCriterion` (a threshold and/or no regression against
   the served version; a non-finite metric always rejects). A failed or
   crashed evaluation quarantines the candidate (registry status
   ``rejected``), never the trainer.
2. **Swap**: an accepted version swaps into the live engine (or a
   ``SnapshotServer`` tenant) with no dropped request
   (:meth:`~bigdl_tpu_torch.serving.engine.ServingEngine.swap_weights`).
   ``eval_model`` is a module of the controller's own: loading a candidate
   into it (in place, then the previous weights back) never touches an
   engine, which serves a private copy.
3. **Rollback**: after a swap the watch window polls the SLO monitor and
   a quality probe (real requests through the engine; a non-finite logit
   or any engine error fails it). A breach swaps the previous version back
   through the same path, bounded by the rollback budget; served tokens are
   then the previous version's, bit for bit.

Fault sites ``promote_eval``, ``promote_swap`` and ``promote_rollback``
(``utils/faults.py``) fire where JAX's do. Knobs: ``BIGDL_PROMOTE_WATCH_S``
(the window, default 5), ``BIGDL_PROMOTE_POLL_S`` (default 0.2),
``BIGDL_PROMOTE_ROLLBACK_BUDGET`` (default 3),
``BIGDL_PROMOTE_MIN_METRIC``, and the registry's ``BIGDL_REGISTRY_DIR`` /
``BIGDL_REGISTRY_KEEP``.
"""

from __future__ import annotations

import logging
import math
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch import convert
from bigdl_tpu_torch.obs import exporter as obs_exporter
from bigdl_tpu_torch.serving.engine import NonFiniteLogitsError, ServingEngine
from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils.faults import fault_point
from bigdl_tpu_torch.utils.model_registry import ModelRegistry
from bigdl_tpu_torch.utils.robustness import events

logger = logging.getLogger("bigdl_tpu_torch.lifecycle")


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


def _on_device(params, device):
    """``params`` with every leaf copied to ``device`` when that is a card,
    on the calling thread (the copies release the GIL). The engine's loop
    then swaps in device copies: the host leaves of a version (about 200 MB
    for the full-width LM) copied on the loop held it past its watchdog's
    limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return params

    def leaf(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        with warnings.catch_warnings():
            # a loaded version's arrays are read-only views of the file's
            # bytes, and they are only read here
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(np.asarray(a)).to(device)
    return convert.map_tree(leaf, params)


class PromotionCriterion:
    """Accept/reject rule for the gate.

    ``min_metric``: absolute floor (``mode="max"``, e.g. accuracy) or
    ceiling (``mode="min"``, e.g. loss) the candidate must clear
    (``BIGDL_PROMOTE_MIN_METRIC`` when unset and the env knob is set).
    ``no_regression``: the candidate must not be worse than the
    currently-served version's metric by more than ``margin``.
    A non-finite candidate metric ALWAYS rejects, whatever the rules say.
    """

    def __init__(self, min_metric: Optional[float] = None,
                 no_regression: bool = True, margin: float = 0.0,
                 mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        if min_metric is None:
            raw = os.environ.get("BIGDL_PROMOTE_MIN_METRIC", "").strip()
            min_metric = float(raw) if raw else None
        self.min_metric = min_metric
        self.no_regression = bool(no_regression)
        self.margin = float(margin)
        self.mode = mode

    def accept(self, candidate: float,
               current: Optional[float]) -> tuple[bool, str]:
        """(accepted, reason)."""
        sign = 1.0 if self.mode == "max" else -1.0
        if candidate is None or not math.isfinite(candidate):
            return False, f"non-finite candidate metric {candidate!r}"
        if self.min_metric is not None \
                and sign * candidate < sign * self.min_metric:
            return False, (f"metric {candidate:.6g} misses the "
                           f"{self.mode}-threshold {self.min_metric:.6g}")
        if self.no_regression and current is not None \
                and math.isfinite(current) \
                and sign * candidate < sign * (current - sign * self.margin):
            return False, (f"regression vs served: candidate "
                           f"{candidate:.6g} worse than {current:.6g} "
                           f"(margin {self.margin:.6g})")
        return True, f"metric {candidate:.6g} ok"


class PromotionResult:
    """Outcome of one :meth:`PromotionController.promote` call."""

    __slots__ = ("version", "promoted", "reason", "metric", "swap",
                 "rolled_back")

    def __init__(self, version, promoted, reason, metric=None, swap=None,
                 rolled_back=False):
        self.version = version
        self.promoted = promoted
        self.reason = reason
        self.metric = metric
        self.swap = swap            # engine SwapResult when promoted
        self.rolled_back = rolled_back

    def __repr__(self):
        state = "promoted" if self.promoted else "rejected"
        if self.rolled_back:
            state = "rolled_back"
        return (f"PromotionResult(v{self.version} {state}: {self.reason})")


class PromotionController:
    """Drives gate → swap → watch → (rollback) for one serving target.

    ``registry``: the :class:`~bigdl_tpu_torch.utils.model_registry.ModelRegistry`
    the trainer publishes into.
    ``engine``: the live :class:`ServingEngine` — or pass ``server=`` (a
    ``SnapshotServer``) + ``tenant=`` to drive one tenant of a multi-tenant
    deployment through its in-place swap path.
    ``eval_fn``: ``params -> float`` scoring callable. When omitted, the
    port's ``Evaluator`` is used: ``eval_model`` (a module whose weights
    are replaced in place by the candidate's for the evaluation, then put
    back), ``eval_dataset`` and ``eval_methods`` as for ``Evaluator.test``;
    the first method's value is the gate metric.
    ``criterion``: a :class:`PromotionCriterion` (default: no-regression
    only).
    ``slo_monitor``: an :class:`~bigdl_tpu_torch.obs.slo.SLOMonitor` polled inside
    the watch window (optional — the quality probe still runs without one).
    ``probe_prompts``: token sequences served as quality probes during the
    watch window; a probe failing with non-finite logits (or any engine
    error) triggers rollback.
    """

    def __init__(self, registry: ModelRegistry,
                 engine: Optional[ServingEngine] = None,
                 server=None, tenant: Optional[str] = None,
                 eval_fn=None, eval_model=None, eval_dataset=None,
                 eval_methods=None, eval_batch_size: Optional[int] = None,
                 criterion: Optional[PromotionCriterion] = None,
                 slo_monitor=None, probe_prompts=None,
                 probe_max_new: int = 4,
                 watch_window_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 rollback_budget: Optional[int] = None,
                 swap_timeout: float = 60.0):
        if engine is None:
            if server is None or tenant is None:
                raise ValueError(
                    "pass engine=, or server= + tenant= for a "
                    "SnapshotServer deployment")
            engine = server.engine(tenant)
        self.registry = registry
        self.engine = engine
        self.server = server
        self.tenant = tenant
        self.eval_fn = eval_fn
        self.eval_model = eval_model
        self.eval_dataset = eval_dataset
        self.eval_methods = eval_methods
        self.eval_batch_size = eval_batch_size
        self.criterion = criterion or PromotionCriterion()
        self.slo_monitor = slo_monitor
        self.probe_prompts = [np.asarray(p, np.int32).reshape(-1)
                              for p in (probe_prompts or [])]
        self.probe_max_new = int(probe_max_new)
        self.watch_window_s = (watch_window_s if watch_window_s is not None
                               else _env_float("BIGDL_PROMOTE_WATCH_S", 5.0))
        self.poll_s = (poll_s if poll_s is not None
                       else _env_float("BIGDL_PROMOTE_POLL_S", 0.2))
        self.rollback_budget = (
            rollback_budget if rollback_budget is not None
            else int(_env_float("BIGDL_PROMOTE_ROLLBACK_BUDGET", 3)))
        self.swap_timeout = float(swap_timeout)
        self.rollbacks = 0
        # the construction-time snapshot (version 0, never registered) —
        # the rollback target until the first promotion supersedes it
        self._served_version = engine.model_version
        self._served_metric: Optional[float] = None
        self._prev: Optional[tuple] = None   # (version, params, metric)
        self._publish()

    # --------------------------------------------------------------- gate
    def evaluate(self, version: int) -> float:
        """Score one registry version. The ``promote_eval`` fault site fires
        here: ``error`` crashes the eval (the caller quarantines),
        ``nonfinite`` poisons the metric to NaN (the criterion rejects),
        ``stall`` delays the gate."""
        params = self.registry.resolve_params(version)
        action = fault_point(faults.SITE_PROMOTE_EVAL)
        if action == "nonfinite":
            return float("nan")
        if self.eval_fn is not None:
            return float(self.eval_fn(params))
        if self.eval_model is None or self.eval_dataset is None \
                or not self.eval_methods:
            raise ValueError(
                "no gate configured: pass eval_fn=, or eval_model= + "
                "eval_dataset= + eval_methods=")
        from bigdl_tpu_torch.optim.evaluator import Evaluator
        model = self.eval_model
        saved = convert.nest(model, {n: p.detach().clone()
                                     for n, p in model.named_parameters()})
        device = next(model.parameters()).device
        try:
            convert.load_jax_params(model, _on_device(params, device))
            pairs = Evaluator(model, device=device).test(
                self.eval_dataset, self.eval_methods,
                batch_size=self.eval_batch_size)
            value, _count = pairs[0][0].result()
            return float(value)
        finally:
            convert.load_jax_params(model, saved)

    def gate(self, version: int) -> tuple[bool, Optional[float], str]:
        """Run the gate for ``version``: evaluate, apply the criterion, and
        quarantine on rejection or eval crash. Returns
        ``(accepted, metric, reason)``."""
        try:
            metric = self.evaluate(version)
        except Exception as e:  # noqa: BLE001 — quarantine, never the trainer
            reason = f"eval crashed: {type(e).__name__}: {e}"
            self._reject(version, None, reason)
            return False, None, reason
        ok, reason = self.criterion.accept(metric, self._served_metric)
        if not ok:
            self._reject(version, metric, reason)
        return ok, metric, reason

    def _reject(self, version: int, metric, reason: str) -> None:
        self.registry.set_status(version, "rejected", reason=reason,
                                 metric=metric)
        events.record("promotion_rejected", version=int(version),
                      metric=metric, reason=reason)
        logger.warning("promotion: v%d rejected (%s)", version, reason)
        self._publish()

    # --------------------------------------------------------------- swap
    def _swap(self, params, version: int):
        if self.server is not None and self.tenant is not None:
            return self.server.update_tenant(
                self.tenant, params, version=version,
                timeout=self.swap_timeout)
        return self.engine.swap_weights(params, version=version,
                                        timeout=self.swap_timeout)

    def promote(self, version: int, gate: bool = True,
                watch: Optional[bool] = None) -> PromotionResult:
        """Run the lifecycle for one registry version: gate (unless
        ``gate=False`` — the scripted-bad-promotion drill), zero-downtime
        swap, then the watch window (``watch=False`` skips it; the default
        watches whenever a window length is configured). Returns a
        :class:`PromotionResult`; a watch-window breach comes back with
        ``rolled_back=True`` and the previous version serving again."""
        metric = None
        if gate:
            ok, metric, reason = self.gate(version)
            if not ok:
                return PromotionResult(version, False, reason, metric)
        else:
            reason = "gate bypassed"
        params = _on_device(self.registry.resolve_params(version),
                            self.engine.device)
        prev = (self._served_version, self.engine.params_snapshot,
                self._served_metric)
        swap = self._swap(params, version)
        self._prev = prev
        self._served_version = version
        self._served_metric = metric
        self.registry.set_status(version, "promoted", metric=metric)
        events.record("promotion_promoted", version=int(version),
                      metric=metric, requeued=swap.requeued,
                      previous=prev[0])
        logger.info("promotion: v%d serving (%s; %d in-flight re-prefilled)",
                    version, reason, swap.requeued)
        self._publish()
        result = PromotionResult(version, True, reason, metric, swap)
        if watch is None:
            watch = self.watch_window_s > 0
        if watch:
            rolled = self.watch()
            result.rolled_back = rolled
        return result

    # -------------------------------------------------------------- watch
    def _probe(self) -> Optional[str]:
        """One quality-probe round: serve each probe prompt through the
        live engine. Returns a failure reason, or None when clean."""
        for prompt in self.probe_prompts:
            try:
                h = self.engine.submit(prompt, self.probe_max_new)
                h.result(timeout=self.swap_timeout)
            except NonFiniteLogitsError as e:
                return f"probe non-finite: {e}"
            except Exception as e:  # noqa: BLE001 — any probe failure counts
                return f"probe failed: {type(e).__name__}: {e}"
        return None

    def watch(self, window_s: Optional[float] = None,
              poll_s: Optional[float] = None) -> bool:
        """Arm the post-swap watch window: poll the SLO monitor and the
        quality probes until the window closes. A breach rolls the previous
        version back in and returns True; a clean window returns False."""
        window_s = self.watch_window_s if window_s is None else window_s
        poll_s = self.poll_s if poll_s is None else poll_s
        deadline = time.perf_counter() + window_s
        while True:   # always at least one round, however short the window
            breaches = (self.slo_monitor.check()
                        if self.slo_monitor is not None else [])
            probe_err = self._probe()
            if breaches or probe_err:
                reason = (probe_err if probe_err
                          else f"slo breach: {breaches}")
                logger.error("promotion: watch window tripped on v%d (%s); "
                             "rolling back", self._served_version, reason)
                self.rollback(reason)
                return True
            if time.perf_counter() >= deadline:
                break
            time.sleep(poll_s)
        events.record("promotion_watch_clear",
                      version=int(self._served_version),
                      window_s=window_s)
        self._publish()
        return False

    # ----------------------------------------------------------- rollback
    def rollback(self, reason: str = "manual") -> bool:
        """Swap the previously-served version back through the same
        zero-downtime path, bounded by the rollback budget. The
        ``promote_rollback`` fault site fires per attempt — an ``error``
        there consumes one budget unit and the next attempt proceeds.
        Returns True once the previous version serves again."""
        if self._prev is None:
            raise RuntimeError("nothing to roll back to: no promotion "
                               "has happened through this controller")
        bad_version = self._served_version
        prev_version, prev_params, prev_metric = self._prev
        last_err: Optional[BaseException] = None
        while self.rollbacks < self.rollback_budget:
            self.rollbacks += 1
            try:
                fault_point(faults.SITE_PROMOTE_ROLLBACK)
                swap = self._swap(prev_params, prev_version)
            except Exception as e:  # noqa: BLE001 — budget-bounded retry
                last_err = e
                logger.error("promotion: rollback attempt %d/%d failed: %s",
                             self.rollbacks, self.rollback_budget, e)
                continue
            self._served_version = prev_version
            self._served_metric = prev_metric
            self._prev = None
            self.registry.set_status(bad_version, "rolled_back",
                                     reason=reason)
            events.record("promotion_rollback", version=int(bad_version),
                          restored=int(prev_version), reason=reason,
                          requeued=swap.requeued)
            logger.warning("promotion: rolled back v%d → v%d (%s)",
                           bad_version, prev_version, reason)
            self._publish()
            return True
        events.record("promotion_rollback_exhausted",
                      version=int(bad_version),
                      budget=self.rollback_budget,
                      error=str(last_err) if last_err else None)
        logger.error("promotion: rollback budget (%d) exhausted; v%d keeps "
                     "serving", self.rollback_budget, bad_version)
        if last_err is not None:
            raise last_err
        return False

    # --------------------------------------------------- continuous loop
    def step(self) -> Optional[PromotionResult]:
        """One scan of the continuous lifecycle: gate + promote the newest
        registry ``candidate`` version above the served one, if any.
        Returns the :class:`PromotionResult`, or None when there was
        nothing new — safe to call from a trainer callback or a cron-style
        loop."""
        for v in reversed(self.registry.versions()):
            if v <= self._served_version:
                break
            if self.registry.status(v).get("status") == "candidate":
                return self.promote(v)
        return None

    # --------------------------------------------------------------- obs
    @property
    def served_version(self) -> int:
        return self._served_version

    def state(self) -> dict:
        return {"served_version": self._served_version,
                "served_metric": self._served_metric,
                "rollbacks": self.rollbacks,
                "rollback_budget": self.rollback_budget,
                "watch_window_s": self.watch_window_s,
                "tenant": self.tenant}

    def _publish(self) -> None:
        """Keep /statusz current: the controller's own state plus the
        registry's version table — one scrape shows what every tenant
        serves and what is waiting at the gate."""
        obs_exporter.publish_status("promotion", self.state())
        obs_exporter.publish_status("registry", self.registry.state())
