"""Fleet router: N serving-engine replicas behind one submit surface.

Counterpart of ``bigdl_tpu/serving/fleet.py``:

- **Least-loaded dispatch**: healthy replicas ranked by ``(memory-starved,
  queue_depth + active_slots, est_wait_ms, name)`` from their ``stats()``.
- **Retry elsewhere**: ``EngineOverloaded`` and ``EngineShutdown`` (shed,
  drain, a replica dead with its crash budget spent) move a request to the
  next-best replica, with its ``trace_id`` and the remaining share of its
  fleet deadline; a request is never lost while a replica is healthy.
- **Scripted churn**: fault sites ``router_dispatch`` (fail one dispatch
  attempt) and ``replica_down`` (kill the replica about to be picked).
- **Disaggregated prefill/decode** (``phases=`` / ``BIGDL_FLEET_PHASE``):
  a ``prefill`` replica runs a prompt's prefill (``prefill_export``) and
  the target ``decode`` replica pools it (``seed_prefix``), so its
  admission is an exact prefix hit and runs no prefill; ``mixed`` (the
  default) does both. Any handoff failure falls back to plain dispatch;
  a handoff's time (export and seed) goes to ``serving/handoff_ms``.

:meth:`FleetRouter.replicate` builds N engines over one module; each
serves a private copy of its weights and captures its own programs, so a
swap on one replica leaves the others serving their weights. The
handoff's states are copies queued on the device's default stream, which
every replica's thread runs on, so the decode replica's reads are ordered
after them.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Optional

from bigdl_tpu_torch.obs import access_log as obs_access_log
from bigdl_tpu_torch.obs import exporter as obs_exporter
from bigdl_tpu_torch.obs.registry import registry
from bigdl_tpu_torch.serving.engine import (
    EngineOverloaded, EngineShutdown, RequestTimeout, ServingEngine,
    _env_int,
)
from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils.faults import check_fault, fault_point
from bigdl_tpu_torch.utils.robustness import events

#: replica health states the router will dispatch to
_DISPATCHABLE = ("starting", "ready", "degraded")

#: replica roles under disaggregated serving (BIGDL_FLEET_PHASE)
_PHASES = ("prefill", "decode", "mixed")


class FleetExhausted(RuntimeError):
    """No healthy replica could take (or finish) the request: every
    dispatch candidate was down, draining, or overloaded. Carries the
    per-replica errors of the final dispatch round."""

    def __init__(self, msg: str, errors: Optional[dict] = None):
        super().__init__(msg)
        self.errors = errors or {}


class FleetHandle:
    """Client-side future for one FLEET request. Wraps the current
    replica's :class:`RequestHandle` and transparently re-dispatches to
    another replica when the holding replica sheds, drains, or dies —
    ``result()`` only raises once no healthy replica remains (or the
    error is non-retryable: bad request, missed deadline, poisoned
    logits)."""

    def __init__(self, router: "FleetRouter", prompt, max_new_tokens: int,
                 request_id, deadline_s: Optional[float]):
        self._router = router
        self._prompt = prompt
        self._max_new_tokens = max_new_tokens
        self.request_id = request_id
        #: minted ONCE; every resubmission reuses it, so the trace survives
        #: retry elsewhere
        self.trace_id = uuid.uuid4().hex[:16]
        self._deadline_t: Optional[float] = (
            time.perf_counter() + deadline_s
            if deadline_s is not None else None)
        self._lock = threading.Lock()
        self._handle = None          # current replica's RequestHandle
        self._replica: Optional[str] = None
        self.attempts = 0

    @property
    def replica(self) -> Optional[str]:
        """Name of the replica currently holding the request."""
        return self._replica

    def _bind(self, replica: str, handle) -> None:
        self._replica = replica
        self._handle = handle
        self.attempts += 1

    def remaining_deadline_ms(self) -> Optional[float]:
        """Milliseconds left of the fleet-level deadline (None = none) —
        each hop resubmits with the REMAINING budget, not the original."""
        if self._deadline_t is None:
            return None
        return max(0.0, (self._deadline_t - time.perf_counter()) * 1e3)

    def done(self) -> bool:
        h = self._handle
        return h is not None and h.done()

    def result(self, timeout: Optional[float] = None):
        """Block for the completed request, following it across replicas.
        Raises :class:`TimeoutError` if ``timeout`` (the WAIT budget, not
        the request deadline) expires first."""
        wait_t = (time.perf_counter() + timeout
                  if timeout is not None else None)
        while True:
            h = self._handle
            try:
                if wait_t is None:
                    return h.result()
                return h.result(max(0.0, wait_t - time.perf_counter()))
            except TimeoutError:
                raise
            except Exception as e:  # noqa: BLE001 — classified below
                if not self._router._retryable(self._replica, e):
                    raise
                # retry elsewhere: raises the ORIGINAL error when no
                # healthy replica remains — never a silent loss
                self._router._redispatch(self, cause=e)


class FleetRouter:
    """Least-loaded request router over a registry of serving replicas.

    ``replicas``: ``{name: ServingEngine}`` (the SnapshotServer registry
    shape) or a sequence of engines (named by their ``.name``). All
    replicas must serve the same snapshot for fleet routing to be
    transparent; that is the caller's contract (use :meth:`replicate`).
    ``max_retries``: total re-dispatches one request may consume, a backstop
    against pathological flapping (default ``4 × len(replicas)``).
    ``phases``: optional ``{name: "prefill"|"decode"|"mixed"}`` replica
    roles for disaggregated serving (missing names default to ``mixed``);
    at least one replica must be decode-capable (``decode`` or
    ``mixed``)."""

    def __init__(self, replicas, name: str = "fleet",
                 max_retries: Optional[int] = None,
                 phases: Optional[dict] = None):
        if not isinstance(replicas, dict):
            replicas = {e.name: e for e in replicas}
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        if len(set(replicas)) != len(replicas):
            raise ValueError("replica names must be unique")
        self.name = name
        self._engines: dict[str, ServingEngine] = dict(replicas)
        self._phases: dict[str, str] = {nm: "mixed" for nm in replicas}
        if phases:
            for nm, ph in phases.items():
                if nm not in self._engines:
                    raise ValueError(
                        f"phases names unknown replica {nm!r}")
                if ph not in _PHASES:
                    raise ValueError(
                        f"phase must be one of {_PHASES}, got {ph!r} "
                        f"for replica {nm!r} (BIGDL_FLEET_PHASE)")
                self._phases[nm] = ph
        if not any(ph in ("decode", "mixed")
                   for ph in self._phases.values()):
            raise ValueError(
                "a fleet needs at least one decode-capable replica "
                "(phase 'decode' or 'mixed'); all-prefill fleets can "
                "never finish a request")
        self._lock = threading.Lock()
        self._dispatched = 0
        self._retries = 0
        self._replica_downs = 0
        self._rejected = 0
        self._handoffs = 0
        self._handoff_failures = 0
        self.max_retries = (max_retries if max_retries is not None
                            else 4 * len(replicas))
        obs_exporter.register_fleet(self)

    # -------------------------------------------------------- construction
    @classmethod
    def replicate(cls, model, max_len: int, replicas: Optional[int] = None,
                  name: str = "fleet", phases=None,
                  **engine_kwargs) -> "FleetRouter":
        """Build a fleet of ``replicas`` engines over one model
        (``BIGDL_FLEET_REPLICAS``, default 2), each serving a private copy
        of its weights. ``engine_kwargs`` pass through to every
        :class:`ServingEngine` (slots, buckets, draft_model, prefix_pool,
        overload, device, ...).

        ``phases`` (or BIGDL_FLEET_PHASE, a comma list) assigns replica
        roles positionally — ``"prefill,decode"`` makes replica 0 the
        prefill tier and replica 1 the decode tier; a single value
        broadcasts to every replica. Decode-phase replicas need a prefix
        pool to absorb handoffs — pass ``prefix_pool=`` (it is harmless on
        the prefill tier)."""
        if replicas is None:
            replicas = _env_int("BIGDL_FLEET_REPLICAS", 2)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if phases is None:
            spec = os.environ.get("BIGDL_FLEET_PHASE", "")
            phases = [p.strip() for p in spec.split(",") if p.strip()] \
                if spec else None
        phase_map = None
        if phases is not None:
            if isinstance(phases, str):
                phases = [p.strip() for p in phases.split(",") if p.strip()]
            phases = list(phases)
            if len(phases) == 1:
                phases = phases * replicas
            if len(phases) != replicas:
                raise ValueError(
                    f"phases lists {len(phases)} roles for {replicas} "
                    f"replicas (BIGDL_FLEET_PHASE)")
            phase_map = {f"{name}-r{i}": phases[i]
                         for i in range(replicas)}
        engines = {
            f"{name}-r{i}": ServingEngine(
                model, max_len=max_len, name=f"{name}-r{i}",
                **engine_kwargs)
            for i in range(replicas)}
        return cls(engines, name=name, phases=phase_map)

    # ------------------------------------------------------------- registry
    @property
    def replicas(self) -> dict:
        """Live ``{name: engine}`` registry view (copy)."""
        return dict(self._engines)

    def engine(self, name: str) -> ServingEngine:
        return self._engines[name]

    def phase(self, name: str) -> str:
        """The replica's serving role: ``prefill``, ``decode``, or
        ``mixed``."""
        return self._phases[name]

    def add_replica(self, name: str, engine: ServingEngine,
                    phase: str = "mixed") -> None:
        """Grow the fleet mid-flight — the next dispatch round sees it."""
        if phase not in _PHASES:
            raise ValueError(f"phase must be one of {_PHASES}, got {phase!r}")
        with self._lock:
            if name in self._engines:
                raise ValueError(f"replica {name!r} already registered")
            self._engines[name] = engine
            self._phases[name] = phase

    def remove_replica(self, name: str, drain: bool = True) -> None:
        """Take a replica out of rotation; ``drain=True`` lets its
        in-flight sequences finish (queued-but-unadmitted requests fail
        with ``EngineShutdown`` and re-route via their FleetHandles)."""
        with self._lock:
            eng = self._engines.pop(name)
            self._phases.pop(name, None)
        eng.shutdown(wait=False, drain=drain)

    # ------------------------------------------------------------- dispatch
    def _healthy(self) -> list[str]:
        return [n for n, e in self._engines.items()
                if e.stats()["health"] in _DISPATCHABLE]

    def _rank(self, exclude: Optional[str] = None) -> list[tuple]:
        """Dispatch order: healthy DECODE-CAPABLE replicas (phase
        ``decode`` or ``mixed``) by ``(memory-starved, queue_depth +
        active_slots, est_wait_ms, name)`` — a replica whose
        ``free_page_ratio`` hit 0 (no free page in paged mode, no free
        slot in legacy) ranks after every replica with headroom no matter
        how short its queue looks (the queue-depth triple saturates and
        cannot tell a draining replica from a memory-starved one), then
        fewest waiting sequences first, EWMA wait estimate as tiebreak,
        name for determinism. Healthy PREFILL-phase replicas rank strictly
        after every decode-capable one (a prefill engine serves end to
        end, slower) — they are the retry-elsewhere tail, so a decode
        replica dying MID-dispatch still leaves the candidate list a
        healthy target and phase churn never strands a request a mixed
        fleet would have served."""
        order, fallback = [], []
        for nm, eng in list(self._engines.items()):
            if nm == exclude:
                continue
            st = eng.stats()
            if st["health"] not in _DISPATCHABLE:
                continue
            starved = st.get("free_page_ratio", 1.0) <= 0.0
            entry = ((starved, st["queue_depth"] + st["active_slots"],
                      st["est_wait_ms"], nm), nm, eng)
            if self._phases.get(nm, "mixed") in ("decode", "mixed"):
                order.append(entry)
            else:
                fallback.append(entry)
        order.sort(key=lambda t: t[0])
        fallback.sort(key=lambda t: t[0])
        return [(nm, eng) for _, nm, eng in order + fallback]

    def _rank_prefill(self) -> list[tuple]:
        """Healthy prefill-phase replicas by export load ``(prefill
        in-flight + backlog, name)`` — the handoff's source ranking."""
        order = []
        for nm, eng in list(self._engines.items()):
            if self._phases.get(nm, "mixed") != "prefill":
                continue
            st = eng.stats()
            if st["health"] not in _DISPATCHABLE:
                continue
            order.append(((st.get("prefill_inflight", 0)
                           + st["queue_depth"], nm), nm, eng))
        order.sort(key=lambda t: t[0])
        return [(nm, eng) for _, nm, eng in order]

    def _maybe_handoff(self, fh: FleetHandle) -> Optional[str]:
        """Disaggregated prefill→decode handoff: run the prompt's prefill
        on the least-busy prefill replica and seed the result into the
        best decode target's prefix pool, returning that target's name so
        dispatch prefers it (admission there is an exact pool hit — no
        prefill program runs on the decode tier, and the tokens are
        bitwise the colocated engine's). Returns None (plain dispatch)
        when the fleet has no prefill tier, no seedable decode target, or
        ANY handoff step fails — degraded latency, never a lost
        request."""
        sources = self._rank_prefill()
        if not sources:
            return None
        targets = [(nm, eng) for nm, eng in self._rank()
                   if self._phases.get(nm, "mixed") != "prefill"
                   and eng._prefix is not None]
        if not targets:
            return None
        src_nm, src = sources[0]
        dst_nm, dst = targets[0]
        t0 = time.perf_counter()
        try:
            tok, states = src.prefill_export(fh._prompt)
            dst.seed_prefix(fh._prompt, states, tok)
        except Exception as e:  # noqa: BLE001 — handoff is best-effort
            self._handoff_failures += 1
            registry.counter("fleet/handoff_failures").inc()
            events.record("fleet_handoff_failed", fleet=self.name,
                          request_id=fh.request_id, trace_id=fh.trace_id,
                          prefill=src_nm, decode=dst_nm,
                          error=f"{type(e).__name__}: {e}")
            return None
        ms = (time.perf_counter() - t0) * 1e3
        self._handoffs += 1
        registry.counter("fleet/handoffs").inc()
        registry.histogram("serving/handoff_ms").observe(ms)
        events.record("fleet_handoff", fleet=self.name,
                      request_id=fh.request_id, trace_id=fh.trace_id,
                      prefill=src_nm, decode=dst_nm, duration_ms=round(ms, 3),
                      prompt_len=int(fh._prompt.size)
                      if hasattr(fh._prompt, "size") else len(fh._prompt))
        return dst_nm

    def _kill_replica(self, name: str, engine: ServingEngine) -> None:
        """The ``replica_down`` fault fired for this pick: crash the
        replica abruptly (no drain — queued AND in-flight futures fail
        fast) so every request it held must re-route. The zero-lost test
        drives exactly this path."""
        self._replica_downs += 1
        registry.counter("fleet/replica_down").inc()
        events.record("fleet_replica_down", fleet=self.name, replica=name,
                      in_flight=engine.stats()["active_slots"])
        engine.shutdown(wait=False)

    def _log_rejection(self, fh: FleetHandle) -> None:
        """A router-rejected request never reaches an engine, so the access
        log would otherwise lose it — record it here with the fleet as the
        tenant (free when ``BIGDL_ACCESS_LOG`` is unset)."""
        obs_access_log.log_request(
            trace_id=fh.trace_id, tenant=self.name, phase="route",
            prompt_tokens=int(fh._prompt.shape[0]),
            output_tokens=0, ttft_ms=None, e2e_ms=None, flops=None,
            outcome="rejected")

    def _dispatch(self, fh: FleetHandle, exclude: Optional[str] = None,
                  prefer: Optional[str] = None) -> None:
        """Submit ``fh`` to the best healthy replica, walking down the
        ranking on per-replica rejection. ``prefer`` (the handoff's seeded
        decode target) is tried first — its prefix pool already holds this
        prompt. Raises the last per-replica error (or
        :class:`FleetExhausted`) only when NO candidate took it."""
        deadline_ms = fh.remaining_deadline_ms()
        if deadline_ms is not None and deadline_ms <= 0.0:
            self._rejected += 1
            self._log_rejection(fh)
            raise RequestTimeout(
                f"fleet {self.name!r}: request {fh.request_id} deadline "
                f"expired before a replica could take it "
                f"[trace {fh.trace_id}]")
        errors: dict[str, BaseException] = {}
        candidates = self._rank(exclude)
        if prefer is not None:
            candidates.sort(key=lambda t: t[0] != prefer)   # stable
        for nm, eng in candidates:
            if check_fault(faults.SITE_REPLICA_DOWN) is not None:
                self._kill_replica(nm, eng)
                continue
            try:
                fault_point(faults.SITE_ROUTER_DISPATCH)
                handle = eng.submit(
                    fh._prompt, fh._max_new_tokens,
                    request_id=fh.request_id,
                    deadline_ms=fh.remaining_deadline_ms(),
                    trace_id=fh.trace_id)
            except (EngineOverloaded, EngineShutdown,
                    faults.FaultError) as e:
                errors[nm] = e
                continue
            fh._bind(nm, handle)
            self._dispatched += 1
            registry.counter("fleet/dispatch").inc()
            return
        self._rejected += 1
        registry.counter("fleet/rejected").inc()
        self._log_rejection(fh)
        events.record("fleet_exhausted", fleet=self.name,
                      request_id=fh.request_id, trace_id=fh.trace_id,
                      tried=[nm for nm, _ in candidates],
                      errors={nm: type(e).__name__
                              for nm, e in errors.items()})
        overloads = [e for e in errors.values()
                     if isinstance(e, EngineOverloaded)]
        if overloads and len(overloads) == len(errors) and errors:
            raise overloads[-1]   # fleet-level shed: back off and retry
        raise FleetExhausted(
            f"fleet {self.name!r}: no healthy replica for request "
            f"{fh.request_id} (tried {len(candidates)}) "
            f"[trace {fh.trace_id}]", errors)

    def _retryable(self, replica: Optional[str],
                   err: BaseException) -> bool:
        """A failed RESULT moves elsewhere when the replica shut down /
        died (shed, drain, crash budget exhausted — the engine fails
        outstanding handles with its real failure once the supervisor
        gives up, so any error from a dead replica re-routes). Bad
        requests, missed deadlines, and poisoned logits stay failed —
        another replica would do no better."""
        if isinstance(err, (ValueError, RequestTimeout)):
            return False
        if isinstance(err, (EngineShutdown, EngineOverloaded)):
            return True
        eng = self._engines.get(replica) if replica else None
        return eng is not None and eng.stats()["health"] == "dead"

    def _redispatch(self, fh: FleetHandle, cause: BaseException) -> None:
        """Move a request whose replica failed it. Serialized per handle;
        raises ``cause`` when the fleet is exhausted or the retry backstop
        trips — the caller sees the REAL error, never a bare retry
        counter."""
        with fh._lock:
            if fh.attempts > self.max_retries:
                raise cause
            self._retries += 1
            registry.counter("fleet/retry").inc()
            events.record("fleet_retry", fleet=self.name,
                          request_id=fh.request_id, trace_id=fh.trace_id,
                          from_replica=fh.replica,
                          cause=type(cause).__name__)
            try:
                self._dispatch(fh, exclude=fh.replica)
            except (FleetExhausted, EngineOverloaded, RequestTimeout):
                raise cause

    # -------------------------------------------------------------- clients
    def submit(self, prompt, max_new_tokens: int, request_id=None,
               deadline_ms: Optional[float] = None) -> FleetHandle:
        """Dispatch one request to the least-loaded healthy replica.
        Returns a :class:`FleetHandle` that follows the request across
        replicas. Raises ``ValueError`` for never-servable requests,
        ``EngineOverloaded`` when EVERY healthy replica shed it, and
        :class:`FleetExhausted` when none is healthy. ``deadline_ms`` is a
        FLEET-level absolute budget: each hop gets the remaining time."""
        if request_id is None:
            with self._lock:
                request_id = f"{self.name}-{self._dispatched}"
        fh = FleetHandle(self, prompt, max_new_tokens, request_id,
                         deadline_ms / 1000.0
                         if deadline_ms and deadline_ms > 0 else None)
        prefer = self._maybe_handoff(fh)
        self._dispatch(fh, prefer=prefer)
        return fh

    # ------------------------------------------------------------ lifecycle
    def stats(self) -> dict:
        """Router ledger + every replica's ``stats()`` under its name —
        the ``/metrics`` exporter renders these as ``{replica=...}``
        gauges."""
        reps = {}
        for nm, eng in self._engines.items():
            st = eng.stats()
            st["phase"] = self._phases.get(nm, "mixed")
            reps[nm] = st
        return {
            "name": self.name,
            "replicas": reps,
            "healthy_replicas": sum(
                1 for s in reps.values() if s["health"] in _DISPATCHABLE),
            "dispatched": self._dispatched,
            "retries": self._retries,
            "replica_downs": self._replica_downs,
            "rejected": self._rejected,
            "phases": dict(self._phases),
            "handoffs": self._handoffs,
            "handoff_failures": self._handoff_failures,
        }

    def shutdown(self, wait: bool = True, drain: bool = False) -> None:
        """Bring every replica down (drain semantics per engine)."""
        errs = []
        for eng in self._engines.values():
            try:
                eng.shutdown(wait=wait, drain=drain)
            except Exception as e:  # noqa: BLE001 — shut all down first
                errs.append(e)
        if errs:
            raise errs[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
