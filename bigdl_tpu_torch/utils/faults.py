"""Deterministic fault injection: scripted failures at named sites.

Counterpart of ``bigdl_tpu/utils/faults.py`` for the trainer's, the
feed's and the serving stack's sites. An
instrumented site calls :func:`fault_point` or :func:`check_fault`, and an
active **fault plan** makes a hit of the site fail in a scripted way, so
every recovery path can be fired in a test.

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
``ckpt_d2h``              the elastic checkpoint's device-to-host snapshot,
                          on the loop thread (``error``: nothing durable
                          yet, so the failure surfaces)
``ckpt_async``            the elastic checkpoint's writer thread: ``torn``
                          writes the shards and withholds the manifest (a
                          crash between snapshot and commit), ``stall``
                          delays the write ``BIGDL_FAULT_STALL_S`` seconds,
                          ``error`` fails it
``stall``                 the trainer's step boundary: sleeps
                          ``BIGDL_FAULT_STALL_S`` seconds at iteration N
                          (matched by ``index``)
``host_down``             the trainer's step boundary: SIGKILLs the process
                          at iteration N (matched by ``index``), a host lost
                          mid-epoch
``decode``                a record decode of an on-disk source
                          (``dataset/recordio.py``, ``dataset/streaming.py``):
                          ``error`` fails that record, and the corrupt-sample
                          policy decides
``cache_read``            a read of the decoded-sample cache
                          (``dataset/sample_cache.py``): any action models a
                          corrupt read, so the cache is quarantined and the
                          epoch decodes live from that record on
``cache_write``           a write into the cache being built: the build is
                          abandoned with a ``cache_write_failed`` event, and
                          training goes on uncached
``transform_worker``      a parallel transform worker (``dataset/parallel.py``):
                          ``death`` raises :class:`WorkerDeathError`, which
                          the worker pool's crash budget absorbs
``h2d``                   the trainer's host-to-device placement of a batch
                          or window, in the feed's producer (``error``)
``serve_prefill``         the serving engine's prefill of one request
                          (``serving/engine.py`` ``_admit``): ``error`` fails
                          that request; the other slots keep decoding
``serve_decode``          the serving engine's decode tick, after the
                          program: ``nonfinite`` poisons the lowest active
                          slot's flag (its request fails, its row is wiped),
                          ``error`` kills the engine thread
``serve_thread``          the serving engine's loop, once an iteration:
                          ``death`` kills the engine thread, so the
                          supervisor respawns it and re-prefills
``serve_stall``           the serving engine's decode tick, before the
                          program: ``stall`` sleeps ``BIGDL_FAULT_STALL_S``
                          seconds (default 2), a wedged loop for the hang
                          watchdog
``serve_page_alloc``      the paged cache's allocator
                          (``serving/paged_cache.py``): the allocation
                          reports exhaustion
``slo_breach``            the SLO monitor's check (``obs/slo.py``): a
                          synthetic breach, flipping the engines to
                          ``degraded`` until the next clean check
``router_dispatch``       the fleet router, before it hands a request to the
                          replica it picked (``serving/fleet.py``): ``error``
                          fails that attempt and the next replica is tried
``replica_down``          the fleet router's dispatch: kills the replica it
                          was about to pick (``shutdown(wait=False)``)
``promote_eval``          the promotion gate's evaluation
                          (``serving/lifecycle.py``): ``error`` crashes it,
                          ``nonfinite`` makes the metric NaN
``promote_swap``          the serving engine's weight swap, at the step
                          boundary: ``error`` fails it, the old weights
                          keep serving
``promote_rollback``      the promotion controller's rollback, before each
                          attempt: ``error`` spends one unit of its budget
========================  ====================================================

The spool and profilez sites of the JAX module come with the modules that
run them (ROADMAP Queue A.6, item 4); naming one in a plan raises
``ValueError`` saying so.

A plan is a ``;``-separated list of entries ``site@N`` or ``site@N=action``,
the same syntax as the JAX package's, so one plan string means the same in
both. ``N`` is 1-based: the training iteration for the index-matched sites
(``nonfinite_loss``, ``sigterm``, ``stall``, ``host_down``), else the Nth
hit of the site in this
process. Each entry fires once. Actions default per site as in JAX
(``nan`` for nonfinite_loss, ``sigterm`` for sigterm, ``torn`` for
ckpt_write, ``death`` for transform_worker, serve_thread and replica_down,
``stall`` for serve_stall and stall, ``kill`` for host_down, ``torn`` for
ckpt_async, ``error`` for the rest).

Activate a plan with the :func:`inject_faults` context manager (in-process
tests) or the ``BIGDL_FAULT_PLAN`` environment variable (parsed once per
distinct value). Every fired entry is recorded as a ``fault_injected``
robustness event.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

from bigdl_tpu_torch.utils.robustness import events

logger = logging.getLogger(__name__)

# ------------------------------------------------------------------ sites
SITE_NONFINITE_LOSS = "nonfinite_loss"
SITE_SIGTERM = "sigterm"
SITE_CKPT_WRITE = "ckpt_write"
SITE_DECODE = "decode"
SITE_TRANSFORM_WORKER = "transform_worker"
SITE_H2D = "h2d"
SITE_SERVE_PREFILL = "serve_prefill"
SITE_SERVE_DECODE = "serve_decode"
SITE_SERVE_THREAD = "serve_thread"
SITE_SERVE_STALL = "serve_stall"
SITE_PAGE_ALLOC = "serve_page_alloc"
SITE_SLO_BREACH = "slo_breach"
SITE_ROUTER_DISPATCH = "router_dispatch"
SITE_REPLICA_DOWN = "replica_down"
SITE_PROMOTE_EVAL = "promote_eval"
SITE_PROMOTE_SWAP = "promote_swap"
SITE_PROMOTE_ROLLBACK = "promote_rollback"
SITE_CACHE_READ = "cache_read"
SITE_CACHE_WRITE = "cache_write"
SITE_CKPT_D2H = "ckpt_d2h"
SITE_CKPT_ASYNC = "ckpt_async"
SITE_STALL = "stall"
SITE_HOST_DOWN = "host_down"

#: the JAX module's sites whose modules are not ported yet
_NOT_PORTED = {"obs_spool_write": "the cluster spool (obs/cluster.py)",
               "profilez_capture": "the endpoint's /profilez"}

#: sites whose plan entries match the caller-supplied ``index`` (training
#: iteration) instead of the site's hit counter
_INDEX_MATCHED = frozenset({SITE_NONFINITE_LOSS, SITE_SIGTERM, SITE_STALL,
                            SITE_HOST_DOWN})

_DEFAULT_ACTION = {
    SITE_NONFINITE_LOSS: "nan",
    SITE_SIGTERM: "sigterm",
    SITE_CKPT_WRITE: "torn",
    SITE_DECODE: "error",
    SITE_TRANSFORM_WORKER: "death",
    SITE_H2D: "error",
    SITE_SERVE_PREFILL: "error",
    SITE_SERVE_DECODE: "error",
    SITE_SERVE_THREAD: "death",
    SITE_SERVE_STALL: "stall",
    SITE_PAGE_ALLOC: "error",
    SITE_SLO_BREACH: "error",
    SITE_ROUTER_DISPATCH: "error",
    SITE_REPLICA_DOWN: "death",
    SITE_PROMOTE_EVAL: "error",
    SITE_PROMOTE_SWAP: "error",
    SITE_PROMOTE_ROLLBACK: "error",
    SITE_CACHE_READ: "error",
    SITE_CACHE_WRITE: "error",
    SITE_CKPT_D2H: "error",
    SITE_CKPT_ASYNC: "torn",
    SITE_STALL: "stall",
    SITE_HOST_DOWN: "kill",
}

_KNOWN_ACTIONS = frozenset({"error", "death", "nan", "sigterm", "torn",
                            "kill", "stall", "nonfinite"})


class FaultError(RuntimeError):
    """An injected failure (scripted by the active fault plan)."""


class WorkerDeathError(FaultError):
    """Simulated death of a transform worker — handled by the parallel
    engine's crash budget, never by the corrupt-sample policy."""


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
        if site in _NOT_PORTED:
            raise ValueError(
                f"fault site {site!r} belongs to {_NOT_PORTED[site]}, which "
                f"is not ported yet (ROADMAP Queue A.6, item 4)")
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


#: how a ``stall`` action waits: ``time.sleep``; a test replaces it to
#: advance an injected clock instead of the wall clock
stall_sleep = time.sleep

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
    :class:`FaultError`, ``death`` raises :class:`WorkerDeathError`,
    ``sigterm``/``kill`` deliver the signal to this process, ``stall``
    blocks the calling thread ``BIGDL_FAULT_STALL_S`` seconds (default 2)
    through :data:`stall_sleep`; anything else is returned for the caller
    to implement."""
    action = check_fault(site, index)
    if action is None:
        return None
    if action == "error":
        raise FaultError(f"injected fault at site {site!r}")
    if action == "death":
        raise WorkerDeathError(f"injected worker death at site {site!r}")
    if action in ("sigterm", "kill"):
        import signal
        os.kill(os.getpid(),
                signal.SIGTERM if action == "sigterm" else signal.SIGKILL)
    if action == "stall":
        stall_sleep(float(os.environ.get("BIGDL_FAULT_STALL_S", "2")))
    return action
