"""Deterministic fault injection: scripted failures at named sites.

Counterpart of ``bigdl_tpu/utils/faults.py`` for the trainer's sites. An
instrumented site calls :func:`fault_point` or :func:`check_fault`, and an
active **fault plan** makes a hit of the site fail in a scripted way, so
every recovery path of the trainer can be fired in a test.

========================  ====================================================
site                      where it fires
========================  ====================================================
``nonfinite_loss``        the trainer's loss fetch: poisons the fetched loss
                          to NaN at iteration N (matched by ``index``)
``sigterm``               the trainer's step boundary: delivers SIGTERM to
                          the process at iteration N (matched by ``index``)
``ckpt_write``            the background checkpoint writer: ``torn`` leaves a
                          half-written final file, ``error`` fails the write,
                          ``kill`` SIGKILLs the process mid-write
========================  ====================================================

The serving, feed, cache, fleet and observability sites of the JAX module
come with the modules that run them (ROADMAP Queue A.3.2 for serving);
naming one in a plan raises ``ValueError`` here.

A plan is a ``;``-separated list of entries ``site@N`` or ``site@N=action``,
the same syntax as the JAX package's, so one plan string means the same in
both. ``N`` is 1-based: the training iteration for the index-matched sites
(``nonfinite_loss``, ``sigterm``), else the Nth hit of the site in this
process. Each entry fires once. Actions default per site (``nan`` for
nonfinite_loss, ``sigterm`` for sigterm, ``torn`` for ckpt_write).

Activate a plan with the :func:`inject_faults` context manager (in-process
tests) or the ``BIGDL_FAULT_PLAN`` environment variable (parsed once per
distinct value). Every fired entry is recorded as a ``fault_injected``
robustness event.
"""

from __future__ import annotations

import logging
import os
import threading
from contextlib import contextmanager
from typing import Optional

from bigdl_tpu_torch.utils.robustness import events

logger = logging.getLogger(__name__)

# ------------------------------------------------------------------ sites
SITE_NONFINITE_LOSS = "nonfinite_loss"
SITE_SIGTERM = "sigterm"
SITE_CKPT_WRITE = "ckpt_write"

#: sites whose plan entries match the caller-supplied ``index`` (training
#: iteration) instead of the site's hit counter
_INDEX_MATCHED = frozenset({SITE_NONFINITE_LOSS, SITE_SIGTERM})

_DEFAULT_ACTION = {
    SITE_NONFINITE_LOSS: "nan",
    SITE_SIGTERM: "sigterm",
    SITE_CKPT_WRITE: "torn",
}

_KNOWN_ACTIONS = frozenset({"error", "nan", "sigterm", "torn", "kill"})


class FaultError(RuntimeError):
    """An injected failure (scripted by the active fault plan)."""


class _Entry:
    __slots__ = ("site", "at", "action", "fired")

    def __init__(self, site: str, at: int, action: str):
        self.site = site
        self.at = at
        self.action = action
        self.fired = False

    def __repr__(self):
        return f"{self.site}@{self.at}={self.action}"


class FaultPlan:
    """Parsed plan: per-site entries + hit counters. Thread-safe (the loop
    pools and the prefetch producer hit sites concurrently)."""

    def __init__(self, entries: list[_Entry], spec: str = ""):
        self.spec = spec
        self._entries: dict[str, list[_Entry]] = {}
        for e in entries:
            self._entries.setdefault(e.site, []).append(e)
        self._hits: dict[str, int] = {}
        self._lock = threading.Lock()

    def poll(self, site: str, index: Optional[int]) -> Optional[str]:
        """Advance the site's hit counter and return the action of a firing
        entry, or None. An entry fires at most once."""
        with self._lock:
            entries = self._entries.get(site)
            if site in _INDEX_MATCHED:
                n = index
                if n is None:
                    return None
            else:
                n = self._hits.get(site, 0) + 1
                self._hits[site] = n
            if not entries:
                return None
            for e in entries:
                if not e.fired and e.at == n:
                    e.fired = True
                    return e.action
        return None

    def unfired(self) -> list:
        """Entries that never fired (test bookkeeping: a plan that did not
        fully fire usually means a site was never reached)."""
        with self._lock:
            return [repr(e) for es in self._entries.values()
                    for e in es if not e.fired]


def parse_plan(spec: str) -> FaultPlan:
    """Parse ``"site@N[=action][;...]"`` into a :class:`FaultPlan`."""
    entries = []
    for raw in spec.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        if "@" not in raw:
            raise ValueError(
                f"BIGDL_FAULT_PLAN entry {raw!r} must look like "
                f"'site@N' or 'site@N=action'")
        site, _, tail = raw.partition("@")
        site = site.strip()
        if site not in _DEFAULT_ACTION:
            raise ValueError(
                f"unknown fault site {site!r}; known sites: "
                f"{sorted(_DEFAULT_ACTION)}")
        at_s, _, action = tail.partition("=")
        try:
            at = int(at_s)
            if at < 1:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"fault entry {raw!r}: N must be a positive integer") from None
        action = action.strip() or _DEFAULT_ACTION[site]
        if action not in _KNOWN_ACTIONS:
            raise ValueError(
                f"fault entry {raw!r}: unknown action {action!r}; one of "
                f"{sorted(_KNOWN_ACTIONS)}")
        entries.append(_Entry(site, at, action))
    return FaultPlan(entries, spec)


# ------------------------------------------------------------ active plan
_ACTIVE: Optional[FaultPlan] = None
_ENV_SPEC: Optional[str] = None
_ENV_PLAN: Optional[FaultPlan] = None
_PLAN_LOCK = threading.Lock()


def active_plan() -> Optional[FaultPlan]:
    """The installed plan: an :func:`inject_faults` context wins over
    ``BIGDL_FAULT_PLAN``; the env plan is parsed once per distinct value and
    keeps its hit counters for the life of the process."""
    global _ENV_SPEC, _ENV_PLAN
    if _ACTIVE is not None:
        return _ACTIVE
    spec = os.environ.get("BIGDL_FAULT_PLAN")
    if not spec:
        return None
    if spec != _ENV_SPEC:
        with _PLAN_LOCK:
            if spec != _ENV_SPEC:
                _ENV_PLAN = parse_plan(spec)
                _ENV_SPEC = spec
    return _ENV_PLAN


@contextmanager
def inject_faults(plan: "FaultPlan | str"):
    """Install ``plan`` (a :class:`FaultPlan` or a spec string) for the
    duration of the block. Yields the plan so tests can assert on
    :meth:`FaultPlan.unfired`."""
    global _ACTIVE
    if isinstance(plan, str):
        plan = parse_plan(plan)
    with _PLAN_LOCK:
        prev, _ACTIVE = _ACTIVE, plan
    try:
        yield plan
    finally:
        with _PLAN_LOCK:
            _ACTIVE = prev


def check_fault(site: str, index: Optional[int] = None) -> Optional[str]:
    """Non-raising poll: returns the firing entry's action (caller implements
    it — used for ``nonfinite_loss`` poisoning and ``ckpt_write`` tearing) or
    None. Records a ``fault_injected`` event when an entry fires."""
    plan = active_plan()
    if plan is None:
        return None
    action = plan.poll(site, index)
    if action is not None:
        events.record("fault_injected", site=site, action=action,
                      index=index)
        logger.warning("fault plan fired: site=%s action=%s index=%r",
                       site, action, index)
    return action


def fault_point(site: str, index: Optional[int] = None) -> Optional[str]:
    """Raising poll for instrumented sites: ``error`` raises
    :class:`FaultError`, ``sigterm``/``kill`` deliver the signal to this
    process; anything else is returned for the caller to implement."""
    action = check_fault(site, index)
    if action is None:
        return None
    if action == "error":
        raise FaultError(f"injected fault at site {site!r}")
    if action in ("sigterm", "kill"):
        import signal
        os.kill(os.getpid(),
                signal.SIGTERM if action == "sigterm" else signal.SIGKILL)
    return action
