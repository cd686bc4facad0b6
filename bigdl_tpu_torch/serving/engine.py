"""Online serving engine: continuous batching over the KV-cached decode.

Counterpart of the core of ``bigdl_tpu/serving/engine.py``:

- **Admission**: clients ``submit()`` from any thread into a bounded
  ``ClosableQueue``; one engine thread owns the model, the caches and the
  device.
- **Prefill**: a request's context runs as one batch-1 chunk, right-padded
  to the smallest bucket of the prefill grid, through the cached path into
  the engine's one batch-1 cache; the logits at the last true position give
  the first token (TTFT ends there). The filled batch-1 cache is copied
  into a free row of the decode grid at the TRUE context length.
- **Decode tick**: one cached step over the whole slot grid (free rows ride
  along with a dummy token and are ignored), greedy argmax per row, and a
  per-row finiteness flag: a row with non-finite logits fails its own
  request and is wiped, the others never notice.
- **Paged KV cache** (``pages=`` / ``BIGDL_KV_PAGES``, ``page_tokens=`` /
  ``BIGDL_KV_PAGE``; ``serving/paged_cache.py``): the decode grid's rows
  become a shared page pool with per-slot page tables, so resident
  sequences are bounded by pooled TOKENS, not ``slots × max_len``. The host
  allocates pages as rows grow and copies its table into the device's
  before a tick; an exhausted pool is backpressure: admission waits, and
  the youngest sequence is preempted and re-prefilled later from its prompt
  and the tokens it already emitted, so the oldest always progresses.
  ``BIGDL_KV_PAGED=0`` forces the slot grid.
- **Prefix pool** (``prefix_pool=`` / ``BIGDL_PREFIX_POOL``,
  ``prefix_chunk=``; ``serving/prefix_cache.py``): a prompt that starts with
  a pooled prefix is seeded from it and prefills only the remainder,
  through the same bucket programs from the prefix's depth; an exact hit
  runs no prefill. ``prefill_export`` and ``seed_prefix`` hand a prefill
  from one engine to another's pool.
- **Speculative decoding** (``draft_model=``, ``spec_tokens=`` /
  ``BIGDL_SPEC_TOKENS``; ``serving/speculative.py``): each tick drafts k
  tokens per row with the draft model, verifies them in one k+1 chunk of
  the target and emits 1..k+1 tokens a row, plain greedy's tokens. The
  draft keeps a slot grid of its own beside the target's grid or pool.
- **Deadlines and overload** (``deadline_ms=`` / ``BIGDL_SERVE_DEADLINE_MS``,
  ``overload=`` / ``BIGDL_SERVE_OVERLOAD``): a request whose deadline
  passes fails with :class:`RequestTimeout`, while queued or mid-decode
  (its row and pages are recycled at once); ``block`` backpressures
  ``submit`` on the bounded queue, ``shed`` raises
  :class:`EngineOverloaded` (queue depth, wait estimate, decode rate, free
  pages), ``degrade`` halves ``max_new_tokens`` under pressure.
- **Programs**: each path runs as a program of ``utils/programs.py``, keyed
  as JAX keys its compiled programs: one prefill per bucket
  (``serve_prefill``, or ``serve_prefill_spec`` with a draft), one decode
  tick (``serve_decode``, ``serve_decode_paged`` or ``serve_spec_step``),
  one assign (``serve_assign``, ``_paged``, ``_spec``, ``_paged_spec``): a
  CUDA graph captured at the first use of its key and replayed after that.
  A prefill takes its start depth as an input (0 cold, c seeded), so a
  seeded remainder replays its bucket's program. ``stats()
  ["compiled_programs"]`` counts the keys used against
  ``program_grid_bound = len(buckets) + 2``. The fault paths stay eager,
  outside the bound, as in JAX: wiping a poisoned row (``reset_page_slot``
  when paged) and the prefill of a re-admitted context longer than the
  largest bucket.
- **Finish and recycling**: a row that emits ``eos_id`` or reaches
  ``max_new_tokens`` completes its handle and is handed to the next waiting
  request mid-flight.

- **Own weights**: the engine serves a private copy of the model (and of
  the draft), taken at construction as JAX takes ``model.get_params()``:
  engines over one module never share parameter storage, so a swap on one
  leaves the others serving. The captured programs read that copy's
  tensors, so everything that replaces them copies in place.
- **Crash recovery** (``crash_budget=`` / ``BIGDL_SERVE_CRASH_BUDGET``,
  default 2): a supervisor thread owns the decode loop's thread and
  respawns it when it dies; every in-flight request goes back to the front
  of the pending list and re-prefills from its prompt plus the tokens it
  emitted. The decode grids, the draft's grid and the page pool are zeroed
  in place and the allocator reset, so the respawned loop replays the
  programs it had. Once the budget is spent the engine is ``dead`` and
  every handle fails.
- **Hot weight swaps** (:meth:`ServingEngine.swap_weights`): at a decode
  step boundary a JAX-layout tree (``get_params()``'s, numpy or tensors)
  is checked against the served weights (paths, shapes), copied in place
  with each leaf cast to the dtype of the weight it replaces, and every
  in-flight request re-prefills on the new weights; the prefix pool is
  cleared. A failure leaves the old weights serving. No program is added.
- **Drain and health** (``shutdown(drain=True)``, ``drain_s=`` /
  ``BIGDL_SERVE_DRAIN_S``, :meth:`ServingEngine.install_signal_drain` for
  SIGTERM): queued requests fail with :class:`EngineShutdown`, in-flight
  ones finish until the drain deadline. ``stats()["health"]`` is
  ``starting``, ``ready``, ``degraded`` (backlog pressure, a respawn, an
  SLO breach), ``draining`` or ``dead``, also the ``serving/health``
  gauge. ``shutdown(wait=True)`` raises :class:`EngineShutdownTimeout`
  with the thread's stack when the thread outlives its timeout.
- **Observability**: the hang watchdog (``watchdog=`` or
  ``BIGDL_WATCHDOG_S``) heartbeats after each tick's host read and is
  disarmed while the engine is idle; a program's first capture on the card
  disarms it and re-arms it after (a capture is compilation, not a hang,
  and its time stays out of the median). Latencies go to the
  ``serving/ttft_ms``, ``tpot_ms``, ``queue_wait_ms`` and ``e2e_ms``
  histograms; after a crash or a swap that requeued work, the time from
  the loop's death (or the swap's start) to the first token after it to
  ``serving/resume_first_token_ms``, and the requeued requests' summed
  re-prefills to ``serving/reprefill_ms``; each finished request to the access log
  (``BIGDL_ACCESS_LOG``), the slowest ``BIGDL_TRACE_SAMPLE`` share of
  requests' spans to the trace log; the engine registers with the metrics
  endpoint and the SLO monitor at start. ``admit_wait_ms`` /
  ``BIGDL_SERVE_ADMIT_WAIT_MS`` makes an idle engine wait that long for
  more arrivals before its first prefill.

Fault sites (``utils/faults.py``) sit where JAX's do, outside any
captured program: ``serve_thread`` at the top of each loop iteration,
``serve_prefill`` before a prefill, ``serve_stall`` before a tick's
program and ``serve_decode`` after its host read, ``promote_swap`` at the
start of a swap.

The engine thread runs the models in eval mode (JAX applies them with
``training=False``). The model may be any cached-decode-capable
``TransformerLM``. Batched output equals per-request ``greedy_generate``
because of the chunked-prefill == full-forward invariant and per-row
positions. The engine's MFU accounting (``obs/mfu.py``; the access log's
``flops``) waits for ROADMAP Queue A.6.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import threading
import time
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch import convert
from bigdl_tpu_torch.nn.abstractnn import evaluating
from bigdl_tpu_torch.nn.incremental import (
    _map_leaves, assign_cache_slot, install_decode_cache, reset_decode_slot,
    restart_decode_cache,
)
from bigdl_tpu_torch.obs import access_log as obs_access_log
from bigdl_tpu_torch.obs import exporter as obs_exporter
from bigdl_tpu_torch.obs import slo as obs_slo
from bigdl_tpu_torch.obs import trace
from bigdl_tpu_torch.obs import watchdog as obs_watchdog
from bigdl_tpu_torch.obs.registry import registry
from bigdl_tpu_torch.serving import paged_cache
from bigdl_tpu_torch.serving.paged_cache import TRASH_PAGE, PageAllocator
from bigdl_tpu_torch.serving.prefix_cache import PrefixPool
from bigdl_tpu_torch.serving.request import (
    FINISH_EOS, FINISH_LENGTH, Request, RequestHandle,
)
from bigdl_tpu_torch.serving.scheduler import (
    SlotScheduler, default_buckets, pick_bucket, pick_seed_bucket,
)
from bigdl_tpu_torch.serving.speculative import (
    build_spec_prefill, build_spec_step,
)
from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils.device import require_on
from bigdl_tpu_torch.utils.faults import FaultError, check_fault, fault_point
from bigdl_tpu_torch.utils.programs import ProgramCache
from bigdl_tpu_torch.utils.queues import CLOSED, EMPTY, ClosableQueue
from bigdl_tpu_torch.utils.robustness import events

logger = logging.getLogger("bigdl_tpu_torch.serving")

_OVERLOAD_MODES = ("block", "shed", "degrade")

#: stats()["health"] states, published as the serving/health gauge
_HEALTH_CODE = {"starting": 0, "ready": 1, "degraded": 2, "draining": 3,
                "dead": 4}


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _parse_buckets(spec: str) -> tuple:
    return tuple(int(x) for x in spec.replace(" ", "").split(",") if x)


def _private_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` with parameter and buffer storage of its own
    (generators stay shared: they are the module's sources, not its
    state)."""
    memo = {id(v): v for m in model.modules() for v in vars(m).values()
            if isinstance(v, torch.Generator)}
    return copy.deepcopy(model, memo)


class EngineShutdown(RuntimeError):
    """The engine stopped before the request finished (or was submitted):
    shut down, draining, or dead with its crash budget spent."""


class EngineShutdownTimeout(RuntimeError):
    """``shutdown(wait=True)`` gave up on the engine thread, which is left
    running; the message carries its stack and open spans. Also raised by
    a weight swap the engine did not service in time."""


class NonFiniteLogitsError(RuntimeError):
    """A request's logits went non-finite; only that request fails."""


class RequestTimeout(RuntimeError):
    """The request's deadline passed before it finished, while queued or
    mid-decode; its row and pages were recycled at once."""


class EngineOverloaded(RuntimeError):
    """``submit`` rejected under ``overload="shed"``: the backlog is at
    capacity, the decode-rate estimate says the request cannot meet its
    deadline, or (paged) the pool cannot back its context now. Carries the
    load figures ``stats()`` publishes: ``queue_depth``, ``est_wait_s`` (and
    ``est_wait_ms``), ``decode_rate`` and, for a paged engine,
    ``pages_free`` (None unpaged)."""

    def __init__(self, msg: str, queue_depth: int, est_wait_s: float,
                 decode_rate: float = 0.0,
                 pages_free: Optional[int] = None):
        super().__init__(msg)
        self.queue_depth = queue_depth
        self.est_wait_s = est_wait_s
        self.est_wait_ms = est_wait_s * 1e3
        self.decode_rate = decode_rate
        self.pages_free = pages_free


class _Wake:
    """Queue sentinel that wakes an idle loop without carrying work (a
    pending swap is serviced at the loop's top)."""

    def __repr__(self):
        return "<WAKE>"


_WAKE = _Wake()


class SwapResult:
    """What :meth:`ServingEngine.swap_weights` returns: the installed
    version, each in-flight request's count of tokens emitted at the swap
    (tokens before are the old weights', tokens after the new weights'
    continuation of that prefix), the requests re-prefilled and the time
    the engine was paused."""

    __slots__ = ("version", "in_flight", "requeued", "duration_s")

    def __init__(self, version, in_flight, requeued, duration_s):
        self.version = version
        self.in_flight = in_flight      # {request_id: n_generated_at_swap}
        self.requeued = requeued
        self.duration_s = duration_s


class _Resume:
    """A crash's or a swap's mark, kept until its requeued requests have
    re-prefilled: when the loop died or the swap began, whether a token
    has come since, the requests still to re-prefill (by identity) and the
    time their re-prefills took."""

    __slots__ = ("t0", "first", "left", "reprefill_s")

    def __init__(self, t0: float, requeued):
        self.t0 = t0
        self.first = True
        self.left = {id(r) for r in requeued}
        self.reprefill_s = 0.0


class _SwapCommand:
    __slots__ = ("params", "version", "done", "error", "result")

    def __init__(self, params, version):
        self.params = params
        self.version = version
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.result: Optional[SwapResult] = None


class ServingEngine:
    """Continuous-batching request server over one model snapshot.

    ``model``: a causal LM of cached-decode-capable modules (a
    ``TransformerLM``); the engine serves a private copy of it.
    ``max_len``: per-slot cache length; every request needs ``prompt_len +
    max_new_tokens (+ spec_tokens with a draft) <= max_len``. ``slots``:
    rows of the decode grid (``BIGDL_SERVE_SLOTS``, 8). ``buckets``:
    prefill length grid (``BIGDL_SERVE_BUCKETS``, default
    ``default_buckets(max_len)``). ``eos_id``: optional stop token.
    ``admit_wait_ms``: an idle engine's wait for more arrivals
    (``BIGDL_SERVE_ADMIT_WAIT_MS``, 0). ``queue_depth``: the admission
    queue's bound (``BIGDL_SERVE_QUEUE_DEPTH``, 256). ``deadline_ms``:
    default per-request deadline (0 or unset: none). ``overload``:
    ``"block"``, ``"shed"`` or ``"degrade"``. ``crash_budget``: respawns of
    the engine thread before it gives up (``BIGDL_SERVE_CRASH_BUDGET``, 2).
    ``drain_s``: ``shutdown(drain=True)``'s default deadline
    (``BIGDL_SERVE_DRAIN_S``, 30). ``watchdog``: a
    :class:`~bigdl_tpu_torch.obs.watchdog.HangWatchdog` (default: from
    ``BIGDL_WATCHDOG_S``, usually none). ``draft_model``/``spec_tokens``:
    speculative decoding (default k = 4). ``prefix_pool``/``prefix_chunk``:
    entries of the prefix pool (0: off) and its key alignment (16).
    ``pages``/``page_tokens``: the paged cache's pool size (0: the slot
    grid) and page size (16; must divide ``max_len``). ``device``: where
    the models live, default ``"cuda"``. Unset arguments read the
    environment variables JAX's engine reads. ``clock`` (an attribute) is
    the time source of requests' deadlines and latencies and of the drain
    deadline, ``time.perf_counter``; a test may replace it.
    """

    def __init__(self, model: torch.nn.Module, max_len: int,
                 slots: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None,
                 admit_wait_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, name: str = "serve",
                 device=None, deadline_ms: Optional[float] = None,
                 overload: Optional[str] = None,
                 crash_budget: Optional[int] = None,
                 drain_s: Optional[float] = None,
                 watchdog: Optional[obs_watchdog.HangWatchdog] = None,
                 draft_model=None,
                 spec_tokens: Optional[int] = None,
                 prefix_pool: Optional[int] = None,
                 prefix_chunk: Optional[int] = None,
                 pages: Optional[int] = None,
                 page_tokens: Optional[int] = None):
        self.device = require_on(model, device)
        if slots is None:
            slots = _env_int("BIGDL_SERVE_SLOTS", 8)
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if buckets is None:
            spec = os.environ.get("BIGDL_SERVE_BUCKETS", "")
            buckets = (_parse_buckets(spec) if spec
                       else default_buckets(max_len))
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] < 1 or buckets[-1] > max_len:
            raise ValueError(f"buckets must be within [1, max_len={max_len}]"
                             f", got {buckets}")
        if admit_wait_ms is None:
            admit_wait_ms = float(os.environ.get(
                "BIGDL_SERVE_ADMIT_WAIT_MS", 0))
        if queue_depth is None:
            queue_depth = _env_int("BIGDL_SERVE_QUEUE_DEPTH", 256)
        if deadline_ms is None:
            deadline_ms = float(os.environ.get("BIGDL_SERVE_DEADLINE_MS", 0))
        if overload is None:
            overload = os.environ.get("BIGDL_SERVE_OVERLOAD", "block")
        if overload not in _OVERLOAD_MODES:
            raise ValueError(f"overload must be one of {_OVERLOAD_MODES}, "
                             f"got {overload!r} (BIGDL_SERVE_OVERLOAD)")
        if crash_budget is None:
            crash_budget = _env_int("BIGDL_SERVE_CRASH_BUDGET", 2)
        if drain_s is None:
            drain_s = float(os.environ.get("BIGDL_SERVE_DRAIN_S", 30))
        if draft_model is not None:
            require_on(draft_model, device)
            if spec_tokens is None:
                spec_tokens = _env_int("BIGDL_SPEC_TOKENS", 4)
            if spec_tokens < 1:
                raise ValueError(f"spec_tokens must be >= 1 with a draft "
                                 f"model, got {spec_tokens}")
        if prefix_pool is None:
            prefix_pool = _env_int("BIGDL_PREFIX_POOL", 0)
        if prefix_chunk is None:
            prefix_chunk = _env_int("BIGDL_PREFIX_CHUNK", 16)
        if pages is None:
            pages = _env_int("BIGDL_KV_PAGES", 0)
        if page_tokens is None:
            page_tokens = _env_int("BIGDL_KV_PAGE", 16)
        if _env_int("BIGDL_KV_PAGED", 1) == 0:   # the rollback switch
            pages = 0
        self.name = name
        self.max_len = int(max_len)
        self.slots = int(slots)
        self.buckets = buckets
        self.eos_id = eos_id
        self.admit_wait_s = admit_wait_ms / 1e3
        self.queue_depth = int(queue_depth)
        self.default_deadline_s = (deadline_ms / 1e3 if deadline_ms > 0
                                   else None)
        self.overload = overload
        self.crash_budget = int(crash_budget)
        self.drain_s = float(drain_s)
        self.paged = pages > 0
        self.pages = int(pages) if self.paged else 0
        self.page_tokens = int(page_tokens)
        self._page_w = (paged_cache.logical_pages(max_len, page_tokens)
                        if self.paged else 0)
        self.clock = time.perf_counter
        # the engine's own weights (JAX's model.get_params() snapshot)
        self._model = _private_copy(model)
        self._draft = (_private_copy(draft_model)
                       if draft_model is not None else None)
        self._spec = int(spec_tokens) if draft_model is not None else 0
        self._dtype = dtype
        self._dtype_name = str(dtype).replace("torch.", "")
        model = self._model
        draft_model = self._draft
        pin = self.device.type == "cuda"
        if self.paged:
            self._dec_state = paged_cache.install_paged_cache(
                model, self.slots, self.max_len, self.pages,
                self.page_tokens, dtype)
            self._allocator = PageAllocator(self.pages)
            # the host's table, copied into the device's before a tick
            # when allocation changed it (pinned: the copy is async)
            self._table_host = torch.full(
                (self.slots, self._page_w), TRASH_PAGE, dtype=torch.long,
                pin_memory=pin)
            self._page_table = self._table_host.numpy()
        else:
            self._dec_state = install_decode_cache(model, self.slots,
                                                   self.max_len, dtype)
            self._allocator = None
        self._slot_pages: list[list[int]] = [[] for _ in range(self.slots)]
        self._table_dirty = False
        self._page_evictions = 0
        # the prefill programs' batch-1 caches (restarted by each prefill)
        self._prefill_state = install_decode_cache(model, 1, self.max_len,
                                                   dtype)
        if draft_model is not None:
            self._dec_state_d = install_decode_cache(
                draft_model, self.slots, self.max_len, dtype)
            self._prefill_state_d = install_decode_cache(
                draft_model, 1, self.max_len, dtype)
            self._spec_prefill = build_spec_prefill(model, draft_model)
            self._spec_step = build_spec_step(model, draft_model, self._spec)
        self._prefix = (PrefixPool(prefix_pool, prefix_chunk,
                                   page=self.page_tokens if self.paged
                                   else None)
                        if prefix_pool > 0 else None)
        self._programs = ProgramCache(self.device)
        # host side of a tick's token copy: pinned on the card, so the copy
        # is asynchronous
        self._tok_host = torch.zeros((self.slots, 1), dtype=torch.long,
                                     pin_memory=pin)
        self._queue = ClosableQueue(self.queue_depth)
        self._sched = SlotScheduler(self.slots)
        self._pending: list[Request] = []
        self._lock = threading.Lock()      # submit-side counters
        self._start_lock = threading.Lock()
        # held by the engine thread while it admits, ticks and swaps, by
        # recovery and by prefill_export: they share the engine's caches
        self._device_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None   # the supervisor
        self._worker: Optional[threading.Thread] = None   # the decode loop
        self._stop = threading.Event()
        self._drain = threading.Event()
        self._drain_deadline = 0.0
        self._failure: Optional[BaseException] = None
        self._died_t = 0.0                 # when the loop thread last died
        self._resume: Optional[_Resume] = None
        self._submitted = 0
        self._submit_lock = threading.Lock()
        self._prefill_inflight = 0         # prefill_export calls running
        self._completed = 0
        self._backlog = 0                  # submitted, not yet in a slot
        self._respawns = 0
        self._prefills = 0
        self._prefill_buckets: Counter = Counter()
        self._decode_ticks = 0
        self._decode_tokens = 0
        self._decode_s = 0.0
        self._prefill_s = 0.0
        self._poisoned = 0
        self._peak_active = 0
        self._timeouts = 0
        self._shed = 0
        self._degraded_admits = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._rate_tps = 0.0               # EWMA decode tokens/s (all rows)
        self._tok_per_req = 0.0            # EWMA generated tokens a request
        self._captured = False             # a program captured this tick
        self._watchdog = (watchdog if watchdog is not None
                          else obs_watchdog.from_env())
        self._health = "starting"
        self._slo_degraded = False         # set by obs.slo.SLOMonitor
        # the slowest BIGDL_TRACE_SAMPLE share of requests persists its
        # spans (>= 1: all, 0: none)
        self._trace_sample = float(
            os.environ.get("BIGDL_TRACE_SAMPLE", "0.05"))
        # the weight-swap plane: the served version (0: the construction
        # snapshot) and the one-deep mailbox the loop services
        self._model_version = 0
        self._swap_pending: Optional[_SwapCommand] = None
        self._swap_lock = threading.Lock()
        registry.gauge("serving/health").set(_HEALTH_CODE["starting"])
        if self.paged:
            registry.gauge("serve/page_evictions").set(0)
            self._publish_page_gauges()

    # ------------------------------------------------------------- clients
    def submit(self, prompt, max_new_tokens: int, request_id=None,
               deadline_ms: Optional[float] = None,
               trace_id: Optional[str] = None) -> RequestHandle:
        """Enqueue one request and return its handle at once. Raises
        ``ValueError`` for a request that can never fit (cache length,
        bucket grid, page pool), ``EngineShutdown`` once the engine is shut
        down or draining and ``EngineOverloaded`` under ``overload="shed"``
        pressure. ``deadline_ms`` overrides the engine's default (0: none);
        ``trace_id`` reuses a caller's trace id (the fleet router's retry
        elsewhere)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens + self._spec > self.max_len:
            # a verify chunk writes k+1 positions past the depth, and the
            # cached step clamps an overflowing write onto earlier rows
            spec = f" + spec_tokens {self._spec}" if self._spec else ""
            raise ValueError(
                f"prompt_len {prompt.size} + max_new_tokens "
                f"{max_new_tokens}{spec} exceeds the engine's cache length "
                f"max_len={self.max_len}")
        if pick_bucket(prompt.size, self.buckets) is None:
            raise ValueError(f"prompt_len {prompt.size} exceeds the largest "
                             f"prefill bucket {self.buckets[-1]}")
        if self.paged:
            # the deepest write's page (a spec round's verify chunk reaches
            # k further): a request needing more than the whole pool can
            # never run, even alone
            peak = ((prompt.size + max(max_new_tokens - 2, 0) + self._spec)
                    // self.page_tokens + 1)
            if peak > self.pages:
                raise ValueError(
                    f"prompt_len {prompt.size} + max_new_tokens "
                    f"{max_new_tokens} needs {peak} pages of "
                    f"{self.page_tokens} tokens, but the pool holds only "
                    f"{self.pages} (BIGDL_KV_PAGES)")
        if deadline_ms is None:
            deadline_s = self.default_deadline_s
        else:
            deadline_s = deadline_ms / 1e3 if deadline_ms > 0 else None
        need = self._pages_needed(int(prompt.size)) if self.paged else 0
        if self.overload == "shed":
            depth, est = self._backlog, self.estimated_wait_s()
            if depth >= self.queue_depth or (
                    deadline_s is not None and est > deadline_s):
                self._reject_overloaded(depth, est)
            if self.paged and self._allocator.free_count < need:
                self._reject_overloaded(
                    depth, est, pages_free=self._allocator.free_count)
        elif self.overload == "degrade":
            if self._backlog >= self.slots or (
                    self.paged and self._allocator.free_count < need):
                halved = max(1, max_new_tokens // 2)
                if halved < max_new_tokens:
                    with self._lock:
                        self._degraded_admits += 1
                    registry.counter("serving/degraded_admits").inc()
                    events.record("serving_degraded", engine=self.name,
                                  max_new_tokens=halved,
                                  requested=max_new_tokens,
                                  backlog=self._backlog)
                    max_new_tokens = halved
        self.start()
        put = self._queue.try_put if self.overload == "shed" \
            else self._queue.put
        # as in JAX, a request counts as submitted once it is queued, and
        # a default id is the count before it; the submit lock keeps
        # concurrent callers' ids distinct (the engine thread never takes
        # it)
        with self._submit_lock:
            if request_id is None:
                request_id = self._submitted
            req = Request(request_id, prompt, max_new_tokens,
                          deadline_s=deadline_s, trace_id=trace_id,
                          clock=self.clock)
            with self._lock:
                self._backlog += 1
            if not put(req):
                self._backlog_dec()
                if self._queue.closed:
                    raise EngineShutdown(
                        f"engine {self.name!r} is shut down")
                self._reject_overloaded(self._backlog,
                                        self.estimated_wait_s())
            with self._lock:
                self._submitted += 1
        registry.counter("serving/requests").inc()
        return req.handle

    def _reject_overloaded(self, depth: int, est: float,
                           pages_free: Optional[int] = None) -> None:
        with self._lock:
            self._shed += 1
        registry.counter("serving/shed").inc()
        events.record("serving_shed", engine=self.name, queue_depth=depth,
                      est_wait_s=round(est, 4), pages_free=pages_free)
        why = (f"page pool exhausted ({pages_free} pages free)"
               if pages_free is not None else
               f"backlog {depth} (queue_depth {self.queue_depth})")
        raise EngineOverloaded(
            f"engine {self.name!r} overloaded: {why}, estimated wait "
            f"{est * 1e3:.0f} ms", queue_depth=depth, est_wait_s=est,
            decode_rate=self._rate_tps, pages_free=pages_free)

    def _backlog_dec(self) -> None:
        with self._lock:
            self._backlog = max(0, self._backlog - 1)

    def estimated_wait_s(self) -> float:
        """The backlog's drain estimate from the decode-rate EWMA: backlog ×
        mean tokens a request ÷ tokens/s; 0 before any rate sample, so shed
        never fires on the deadline rule before the engine has served."""
        if self._rate_tps <= 0.0:
            return 0.0
        tpr = self._tok_per_req if self._tok_per_req > 0 else 1.0
        return self._backlog * tpr / self._rate_tps

    def prefill_export(self, prompt) -> tuple:
        """Prefill ``prompt`` through its bucket program on this engine and
        return ``(next_token, states)``: copies of the filled batch-1
        cache(s), one per model, the payload :meth:`seed_prefix` of another
        engine over the same weights absorbs. No slot is claimed and the
        decode grid is untouched; it waits for the engine thread's current
        admission or tick. The copies are queued on the device's default
        stream, which every engine's thread runs on, so another engine's
        use of them is ordered after them (engines on streams of their own
        would need an event)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        lb = pick_bucket(prompt.size, self.buckets)
        if lb is None:
            raise ValueError(
                f"prompt_len {prompt.size} exceeds the largest prefill "
                f"bucket {self.buckets[-1]} on engine {self.name!r}")
        with self._lock:
            self._prefill_inflight += 1
        try:
            with self._device_lock, torch.no_grad(), self._eval(), \
                    trace.span("serve/prefill_export", {"bucket": lb}):
                nxt, ok = self._run_prefill(lb, prompt, 0)
                if not ok:
                    raise NonFiniteLogitsError(
                        f"non-finite logits in prefill_export on engine "
                        f"{self.name!r}")
                states = tuple(_clone_state(s)
                               for s in self._prefill_states())
        finally:
            with self._lock:
                self._prefill_inflight -= 1
        return nxt, states

    def seed_prefix(self, prompt, states, next_token: int) -> None:
        """Pool a prefill handoff (:meth:`prefill_export`'s ``states``)
        under ``prompt``: the next ``submit`` of that prompt is an exact
        hit and runs no prefill. Needs a prefix pool."""
        if self._prefix is None:
            raise ValueError(
                f"engine {self.name!r} has no prefix pool (prefix_pool=0 /"
                f" BIGDL_PREFIX_POOL unset)")
        want = 2 if self._spec else 1
        if len(states) != want:
            raise ValueError(
                f"engine {self.name!r} expects {want} cache state(s) per "
                f"handoff, got {len(states)}: both engines must agree on "
                f"speculative decoding")
        self._prefix.insert(np.asarray(prompt, np.int32).reshape(-1),
                            tuple(states), int(next_token))

    def start(self) -> "ServingEngine":
        """Start the supervisor and the engine thread (idempotent;
        ``submit`` calls it); registers the engine with the metrics
        endpoint, the SLO monitor and the watchdog's dumps."""
        with self._start_lock:
            if self._thread is None:
                if self._stop.is_set() or self._drain.is_set():
                    raise EngineShutdown(
                        f"engine {self.name!r} is shut down")
                if self._watchdog is not None:
                    self._watchdog.start()
                obs_exporter.start_from_env()
                obs_slo.start_from_env()
                obs_exporter.register_engine(self)
                obs_watchdog.add_context_provider(self._watchdog_context)
                self._thread = threading.Thread(
                    target=self._supervise, name=f"bigdl-serve-{self.name}",
                    daemon=True)
                self._thread.start()
        return self

    def install_signal_drain(self) -> "ServingEngine":
        """SIGTERM -> ``shutdown(drain=True, wait=False)``, then the handler
        that was installed before (the trainer's preemption handler keeps
        working). Call from the main thread."""
        import signal

        prev = signal.getsignal(signal.SIGTERM)

        def _handler(signum, frame):
            logger.warning("SIGTERM: draining serving engine %r", self.name)
            self.shutdown(drain=True, wait=False)
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, _handler)
        return self

    def shutdown(self, wait: bool = True, timeout: float = 30.0,
                 drain: bool = False,
                 drain_timeout: Optional[float] = None) -> None:
        """Stop accepting requests and bring the engine down.

        ``drain=False``: every unfinished request fails with
        :class:`EngineShutdown`. ``drain=True``: queued requests fail at
        once, in-flight ones finish up to ``drain_timeout`` seconds of the
        engine's clock (default ``drain_s``) and fail after it. ``wait``
        joins the engine thread and raises :class:`EngineShutdownTimeout`,
        with its stack and open spans, if it is alive after ``timeout``
        seconds (plus the drain's)."""
        if drain and not self._stop.is_set() and not self._drain.is_set():
            if drain_timeout is None:
                drain_timeout = self.drain_s
            self._drain_deadline = self.clock() + drain_timeout
            self._drain.set()
            self._set_health("draining")
            # the queue keeps its items on close: a submit racing it is
            # found and failed by the drain loop
            self._queue.close()
            events.record("serving_drain", engine=self.name,
                          in_flight=self._sched.active_count,
                          timeout_s=drain_timeout)
            if self._thread is None:   # never started: nothing to drain
                self._stop.set()
                self._set_health("dead")
        else:
            self._stop.set()
            self._queue.close()
            if self._thread is None:
                # never started: no supervisor will end it, so a fleet
                # router sees it dead here
                self._set_health("dead")
        t = self._thread
        if wait and t is not None and t is not threading.current_thread() \
                and t is not self._worker:
            budget = timeout + (drain_timeout if drain and drain_timeout
                                else 0.0)
            t.join(timeout=budget)
            if t.is_alive():
                msg = self._leak_report(budget)
                logger.error("%s", msg)
                events.record("serving_shutdown_timeout", engine=self.name,
                              timeout_s=budget)
                raise EngineShutdownTimeout(msg)

    def _leak_report(self, budget: float) -> str:
        stacks = obs_watchdog.HangWatchdog.thread_stacks()
        lines = [f"engine {self.name!r} thread still alive {budget:.1f}s "
                 f"after shutdown — LEAKED"]
        for label, entries in trace.open_spans().items():
            chain = " > ".join(f"{e['name']} ({e['age_ms']:.0f}ms)"
                               for e in entries)
            lines.append(f"open spans [{label}]: {chain}")
        for label, stack in stacks.items():
            if label.startswith("bigdl-serve"):
                lines.append(f"--- thread {label} ---")
                lines.append(stack.rstrip())
        return "\n".join(lines)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    def stats(self) -> dict:
        """The engine's ledger, under JAX's keys with JAX's rounding
        (``bigdl_tpu/serving/engine.py`` ``stats``), plus the port's own
        (``device``, ``peak_active_slots``, ``prefills``,
        ``prefills_by_bucket``, ``prefill_seconds``, ``decode_ticks``,
        ``decode_tokens``, ``decode_seconds``, ``running``). ``queued``
        counts the pending list too. ``prefix_bytes`` counts the pool's
        cache leaves as they are held: the positions are int64 here (int32
        in JAX, 4 more bytes a position leaf), the dtype the port's index
        ops take."""
        pool = self._prefix.stats() if self._prefix is not None else {}
        alloc = self._allocator
        rate = self._rate_tps
        est = self.estimated_wait_s()
        return {
            "name": self.name,
            "device": str(self.device),
            "slots": self.slots,
            "buckets": self.buckets,
            "max_len": self.max_len,
            "compiled_programs": len(self._programs.keys),
            "program_grid_bound": len(self.buckets) + 2,
            "submitted": self._submitted,
            "completed": self._completed,
            "active_slots": self._sched.active_count,
            "peak_active_slots": self._peak_active,
            "queued": self._queue.qsize() + len(self._pending),
            "slot_recycles": self._sched.recycles,
            "prefills": self._prefills,
            "prefills_by_bucket": dict(self._prefill_buckets),
            "prefill_seconds": self._prefill_s,
            "decode_ticks": self._decode_ticks,
            "decode_tokens": self._decode_tokens,
            "decode_seconds": self._decode_s,
            "poisoned_slots": self._poisoned,
            # health and recovery
            "health": self._health,
            "model_version": self._model_version,
            "respawns": self._respawns,
            "slo_degraded": self._slo_degraded,
            # deadlines and overload
            "overload": self.overload,
            "backlog": self._backlog,
            "timeouts": self._timeouts,
            "shed": self._shed,
            "degraded_admits": self._degraded_admits,
            "decode_tps": round(rate, 3),
            "est_wait_s": round(est, 6),
            # the load triple (queue depth, rate, wait), JAX's names
            "queue_depth": self._backlog,
            "decode_rate": round(rate, 3),
            "est_wait_ms": round(est * 1e3, 3),
            # speculative decoding (0 without a draft)
            "spec_tokens": self._spec,
            "spec_proposed": self._spec_proposed,
            "spec_accepted": self._spec_accepted,
            "spec_acceptance": (round(self._spec_accepted
                                      / self._spec_proposed, 4)
                                if self._spec_proposed else 0.0),
            # the prefix pool (0 when off)
            "prefix_entries": pool.get("entries", 0),
            "prefix_hits": pool.get("hits", 0),
            "prefix_misses": pool.get("misses", 0),
            "prefix_evictions": pool.get("evictions", 0),
            "prefix_tokens_saved": pool.get("tokens_saved", 0),
            "prefix_bytes": pool.get("bytes", 0),
            # the paged cache (paged False and 0s for the slot grid, whose
            # free ratio is of slots)
            "paged": self.paged,
            "pages_total": self.pages,
            "page_tokens": self.page_tokens if self.paged else 0,
            "pages_used": alloc.used_count if self.paged else 0,
            "pages_free": alloc.free_count if self.paged else 0,
            "free_page_ratio": round(
                alloc.free_count / self.pages if self.paged
                else (self.slots - self._sched.active_count) / self.slots, 4),
            "page_evictions": self._page_evictions,
            "prefill_inflight": self._prefill_inflight,
            "running": self._thread is not None and self._thread.is_alive(),
        }

    # --------------------------------------------------------------- health
    def _set_health(self, state: str) -> None:
        if state == self._health:
            return
        self._health = state
        registry.gauge("serving/health").set(_HEALTH_CODE[state])
        trace.event("serving_health", engine=self.name, health=state)

    def _update_health(self) -> None:
        if self._drain.is_set() or self._stop.is_set():
            return
        pressure = self._backlog >= self.slots
        self._set_health(
            "degraded" if (pressure or self._respawns
                           or self._slo_degraded) else "ready")

    def set_slo_degraded(self, flag: bool) -> None:
        """The SLO monitor's hook (``obs/slo.py``): a breach holds health at
        ``degraded`` until the rules recover. Safe from any thread."""
        flag = bool(flag)
        if flag == self._slo_degraded:
            return
        self._slo_degraded = flag
        if self._thread is not None:
            self._update_health()

    def _watchdog_context(self) -> dict:
        """A stall dump's context: the trace ids and progress of every
        in-flight request."""
        now = self.clock()
        inflight = []
        for slot in self._sched.active_slots():
            r = slot.request
            inflight.append({
                "trace_id": r.trace_id, "request_id": r.request_id,
                "slot": slot.index, "generated": len(r.generated),
                "age_ms": round((now - r.submit_t) * 1e3, 1)})
        return {"engine": self.name, "health": self._health,
                "in_flight": inflight}

    # ----------------------------------------------------------- supervisor
    def _supervise(self) -> None:
        """Own the decode loop's thread: respawn it after an abnormal death
        while the crash budget lasts, recovering the in-flight requests
        first; fail every outstanding handle at the end."""
        budget = self.crash_budget
        try:
            while True:
                w = threading.Thread(
                    target=self._thread_main,
                    name=f"bigdl-serve-{self.name}-loop", daemon=True)
                self._worker = w
                w.start()
                w.join()
                err = self._failure
                if err is None or self._stop.is_set():
                    break
                if budget <= 0:
                    logger.error(
                        "engine %r thread died (%s: %s) with the crash "
                        "budget spent; failing the outstanding requests",
                        self.name, type(err).__name__, err)
                    events.record("serving_crash_budget_exhausted",
                                  engine=self.name,
                                  error=f"{type(err).__name__}: {err}")
                    break
                budget -= 1
                self._respawns += 1
                registry.counter("serving/thread_respawns").inc()
                events.record("serving_thread_respawn", engine=self.name,
                              error=f"{type(err).__name__}: {err}",
                              budget_left=budget)
                logger.warning(
                    "engine %r thread died (%s: %s); respawning (%d "
                    "respawns, budget left %d)", self.name,
                    type(err).__name__, err, self._respawns, budget)
                self._recover()
                self._failure = None
        finally:
            self._stop.set()
            self._abort_outstanding()
            self._set_health("dead")
            obs_watchdog.remove_context_provider(self._watchdog_context)
            if self._watchdog is not None:
                self._watchdog.stop()

    def _thread_main(self) -> None:
        try:
            with torch.no_grad(), self._eval():
                self._loop()
        except Exception as e:  # noqa: BLE001 — fail handles, not silence
            self._died_t = time.perf_counter()
            self._failure = e
            trace.event("serving_engine_failure", engine=self.name,
                        error=f"{type(e).__name__}: {e}")

    def _recover(self) -> None:
        """After a loop's death: every in-flight request to the front of
        the pending list (it re-prefills from its prompt and emitted
        tokens), the device state zeroed in place."""
        with self._device_lock:
            evicted = self._sched.reset()
            self._reset_device_state()
            self._pending[:0] = evicted
            if self._pending:
                self._resume = _Resume(self._died_t, evicted)
        registry.gauge("serving/active_slots").set(0)
        events.record("serving_recovered", engine=self.name,
                      requeued=len(evicted), pending=len(self._pending),
                      since_death_ms=round(
                          (time.perf_counter() - self._died_t) * 1e3, 3))

    def _reset_device_state(self) -> None:
        """Zero the decode grid (or page pool, its table at trash), the
        draft's grid and the paging bookkeeping IN PLACE: the captured
        programs read these tensors, so new ones would leave every replay
        on the old."""
        def zero(key, leaf):
            leaf.zero_()

        _map_leaves(zero, self._dec_state)
        if self._spec:
            _map_leaves(zero, self._dec_state_d)
        if self.paged:
            self._allocator.reset()
            self._slot_pages = [[] for _ in range(self.slots)]
            self._page_table[:] = TRASH_PAGE    # the device's is zeroed
            self._table_dirty = False
            self._publish_page_gauges()

    # ------------------------------------------------------------ hot swap
    def swap_weights(self, params, version: int = 0,
                     timeout: float = 60.0) -> SwapResult:
        """Install a new weight snapshot with no dropped request, from any
        thread. ``params`` is a tree laid out as JAX's ``get_params()``
        (numpy arrays or tensors). At the next decode-step boundary the
        engine thread checks it against the served weights (the same paths
        and shapes, else ``ValueError`` and the old weights keep serving),
        copies it into them in place, each leaf cast to its weight's dtype,
        zeroes the decode grid, clears the prefix pool and re-prefills
        every in-flight request from its prompt and emitted tokens. The
        programs replay over the same tensors: ``compiled_programs`` does
        not grow. Returns a :class:`SwapResult`; raises what made the swap
        fail (an injected ``promote_swap`` fault too)."""
        if self._stop.is_set() or self._drain.is_set():
            raise EngineShutdown(
                f"engine {self.name!r} is shut down or draining; cannot "
                f"swap weights")
        cmd = _SwapCommand(params, int(version))
        with self._swap_lock:
            if self._swap_pending is not None:
                raise RuntimeError(f"engine {self.name!r}: a weight swap is "
                                   f"already in progress")
            if self._thread is None:
                # never started: no loop, nothing in flight; the caller's
                # thread swaps
                with self._start_lock:
                    if self._thread is None:
                        with self._device_lock:
                            self._execute_swap(cmd)
                        if cmd.error is not None:
                            raise cmd.error
                        return cmd.result
            self._swap_pending = cmd
        self._queue.try_put(_WAKE)   # wakes an idle gather (a full queue
        #                              means the loop is awake anyway)
        if not cmd.done.wait(timeout):
            with self._swap_lock:
                if self._swap_pending is cmd:   # never reached the loop
                    self._swap_pending = None
            raise EngineShutdownTimeout(
                f"engine {self.name!r}: weight swap not serviced within "
                f"{timeout:.1f}s")
        if cmd.error is not None:
            raise cmd.error
        return cmd.result

    def _execute_swap(self, cmd: _SwapCommand) -> None:
        """The swap, at a decode-step boundary on the engine thread (on
        the caller's for a never-started engine), under the device lock.
        A failure before the copy leaves the old weights serving."""
        t0 = time.perf_counter()
        try:
            fault_point(faults.SITE_PROMOTE_SWAP)
            try:   # checks every path and shape before it writes one
                convert.load_jax_params(self._model, cmd.params)
            except KeyError as e:
                raise ValueError(
                    f"engine {self.name!r}: candidate params tree does not "
                    f"match the serving snapshot: {e}") from None
            in_flight = {s.request.request_id: len(s.request.generated)
                         for s in self._sched.active_slots()}
            evicted = self._sched.reset()
            # the rows' keys and values were computed under the old weights
            self._reset_device_state()
            if self._prefix is not None:
                self._prefix.clear()
            self._pending[:0] = evicted
            if self._pending:
                self._resume = _Resume(t0, evicted)
            registry.gauge("serving/active_slots").set(0)
            self._model_version = cmd.version
            registry.gauge("serve/model_version").set(cmd.version)
            dt = time.perf_counter() - t0
            events.record("serving_weight_swap", engine=self.name,
                          version=cmd.version, requeued=len(evicted),
                          duration_ms=round(dt * 1e3, 3))
            logger.info("engine %r: weight swap to v%d (%d in-flight "
                        "re-prefilled, %.1f ms)", self.name, cmd.version,
                        len(evicted), dt * 1e3)
            cmd.result = SwapResult(cmd.version, in_flight, len(evicted),
                                    dt)
        except Exception as e:  # noqa: BLE001 — fail the waiter, not us
            events.record("serving_swap_failed", engine=self.name,
                          version=cmd.version,
                          error=f"{type(e).__name__}: {e}")
            logger.error("engine %r: weight swap to v%d failed: %s — old "
                         "weights keep serving", self.name, cmd.version, e)
            cmd.error = e
        finally:
            cmd.done.set()

    def _service_swap(self) -> None:
        with self._swap_lock:
            cmd, self._swap_pending = self._swap_pending, None
        if cmd is not None:
            self._execute_swap(cmd)

    @property
    def model_version(self) -> int:
        return self._model_version

    @property
    def params_snapshot(self) -> dict:
        """A copy of the served weights as JAX lays out ``get_params()``
        (tensors on the engine's device): what a rollback swaps back."""
        with self._device_lock, torch.no_grad():
            return convert.nest(self._model, {
                n: p.detach().clone()
                for n, p in self._model.named_parameters()})

    # -------------------------------------------------------- engine thread
    def _eval(self):
        stack = contextlib.ExitStack()
        stack.enter_context(evaluating(self._model))
        if self._draft is not None:
            stack.enter_context(evaluating(self._draft))
        return stack

    def _loop(self) -> None:
        self._set_health("degraded" if self._respawns else "ready")
        wd = self._watchdog
        while not self._stop.is_set():
            fault_point(faults.SITE_SERVE_THREAD)
            # a step boundary: a pending swap first; the in-flight rows go
            # to the pending list and re-prefill below
            if self._swap_pending is not None:
                with self._device_lock:
                    self._service_swap()
            closed = self._gather()
            if self._drain.is_set():
                self._drain_loop()
                return
            with self._device_lock:
                self._expire_pending(self.clock())
                while self._pending and self._sched.has_free() \
                        and not self._stop.is_set():
                    req = self._pending.pop(0)
                    if not self._admit(req):
                        # the page pool cannot back it now: it waits at the
                        # head while decode frees pages
                        self._pending.insert(0, req)
                        break
                self._peak_active = max(self._peak_active,
                                        self._sched.active_count)
                self._update_health()
                if self._sched.any_active() and not self._stop.is_set():
                    self._tick()
                    self._expire_slots()
                elif closed:
                    break
            if wd is not None and not self._sched.any_active():
                wd.disarm()

    def _gather(self) -> bool:
        """Pull arrivals into the pending list; block only when idle (then
        linger ``admit_wait_s`` for more). Returns True once the queue is
        closed and drained."""
        pending = self._pending
        if self._sched.any_active() or pending:
            while True:
                item = self._queue.get(timeout=0)
                if item is EMPTY or item is CLOSED:
                    return item is CLOSED
                if item is not _WAKE:
                    pending.append(item)
        item = self._queue.get()
        if item is CLOSED:
            return True
        if item is _WAKE:
            return False   # a swap's wake-up: back to the loop's top
        pending.append(item)
        if self.admit_wait_s > 0:
            deadline = time.perf_counter() + self.admit_wait_s
            while len(pending) < self.slots:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                nxt = self._queue.get(timeout=remaining)
                if nxt is EMPTY or nxt is _WAKE:
                    break
                if nxt is CLOSED:
                    return True
                pending.append(nxt)
        return False

    def _drain_loop(self) -> None:
        """The graceful drain: fail everything not in a slot (it never
        started: retryable elsewhere), then tick the in-flight rows until
        they finish or the drain deadline passes; the supervisor fails
        what is left."""
        err = EngineShutdown(
            f"engine {self.name!r} is draining; request was not in flight")
        for req in self._pending:
            req.handle._fail(err)
            self._access_log(req, "aborted")
            if req.admit_t is None:
                self._backlog_dec()
        self._pending.clear()
        while True:
            item = self._queue.get(timeout=0)
            if item is EMPTY or item is CLOSED:
                break
            if item is not _WAKE:
                item.handle._fail(err)
                self._access_log(item, "aborted")
                self._backlog_dec()
        while self._sched.any_active() and not self._stop.is_set():
            if self.clock() >= self._drain_deadline:
                events.record("serving_drain_deadline", engine=self.name,
                              aborted=self._sched.active_count)
                logger.warning("engine %r drain deadline passed with %d "
                               "sequences in flight; aborting them",
                               self.name, self._sched.active_count)
                break
            with self._device_lock:
                self._tick()
                self._expire_slots()
        if not self._sched.any_active():
            events.record("serving_drain_complete", engine=self.name)
        self._stop.set()

    # -------------------------------------------------------------- paging
    def _publish_page_gauges(self) -> None:
        registry.gauge("serve/pages_used").set(self._allocator.used_count)
        registry.gauge("serve/pages_free").set(self._allocator.free_count)

    def _pages_needed(self, depth: int) -> int:
        """Pages a sequence at ``depth`` needs resident: its content and
        the page its next write (position ``depth``) lands in."""
        return depth // self.page_tokens + 1

    def _free_slot_pages(self, index: int) -> None:
        """Give a slot's pages back and point its table row at trash (on
        finish, timeout, preemption, failure). The freed pages' content is
        masked for the next owner and overwritten as it decodes."""
        if not self.paged or not self._slot_pages[index]:
            return
        self._allocator.free(self._slot_pages[index])
        self._slot_pages[index] = []
        self._page_table[index, :] = TRASH_PAGE
        self._table_dirty = True
        self._publish_page_gauges()

    def _sync_page_table(self) -> None:
        """Copy the host's table into the device's before a tick whenever
        allocation changed it: a freed row's stale entries would let its
        dummy writes land in pages handed to someone else."""
        if self._table_dirty:
            paged_cache.with_page_table(self._dec_state, self._table_host)
            self._table_dirty = False

    def _ensure_pages(self) -> None:
        """Grow every active sequence's pages to cover this tick's writes
        (through the verify chunk's last with a draft), oldest admission
        first. On exhaustion the YOUNGEST active sequence is preempted, so
        the oldest always progresses and a full pool cannot deadlock."""
        active = sorted(self._sched.active_slots(),
                        key=lambda s: (s.request.admit_t or 0.0, s.index))
        for slot in active:
            while slot.request is not None and \
                    self._pages_needed(slot.depth + self._spec) \
                    > len(self._slot_pages[slot.index]):
                got = self._allocator.alloc(1)
                if got is not None:
                    self._slot_pages[slot.index].extend(got)
                    self._page_table[
                        slot.index,
                        len(self._slot_pages[slot.index]) - 1] = got[0]
                    self._table_dirty = True
                    continue
                victim = max((s for s in active if s.request is not None),
                             key=lambda s: (s.request.admit_t or 0.0,
                                            s.index))
                self._preempt(victim)
                if victim is slot:
                    break
        self._publish_page_gauges()

    def _preempt(self, slot) -> None:
        """Evict one sequence to free its pages: it goes back to the head
        of the pending list with its handle and emitted tokens, and
        re-admits by prefilling its prompt plus those tokens."""
        req = slot.request
        self._page_evictions += 1
        registry.gauge("serve/page_evictions").set(self._page_evictions)
        events.record("serving_page_preempt", engine=self.name,
                      request_id=req.request_id, trace_id=req.trace_id,
                      slot=slot.index,
                      pages_freed=len(self._slot_pages[slot.index]),
                      generated=len(req.generated))
        logger.warning(
            "engine %r: page pool exhausted; preempting request %r "
            "(slot %d, %d pages)", self.name, req.request_id, slot.index,
            len(self._slot_pages[slot.index]))
        self._free_slot_pages(slot.index)
        self._sched.release(slot)
        self._pending.insert(0, req)

    # ------------------------------------------------------------ programs
    def _call(self, prog):
        """Run a program. A first call on the card captures: the watchdog
        is disarmed for it and re-armed after (a capture is compilation,
        not a hang, and stays out of the median), and the tick that saw it
        records no duration."""
        wd = self._watchdog
        if wd is None or prog.captured or self.device.type != "cuda":
            return prog()
        self._captured = True
        wd.disarm()
        try:
            return prog()
        finally:
            wd.heartbeat()

    def _grid(self) -> tuple:
        """The decode grid's part of a program key: slots and max_len, and
        the pool's pages and page size when paged."""
        return (self.slots, self.max_len) + (
            (self.pages, self.page_tokens) if self.paged else ())

    def _prefill_states(self) -> tuple:
        return ((self._prefill_state, self._prefill_state_d) if self._spec
                else (self._prefill_state,))

    def _prefill_build(self, lb: int):
        """``(run, inputs)`` of a length-``lb`` prefill: restart the batch-1
        cache(s) at the start depth, run one right-padded (1, lb) chunk
        through them and return the greedy token and the all-finite flag
        at the chunk's true last position, a (2, 1) long tensor. Input: lb
        token ids, the chunk's true length, the start depth."""
        def run(args):
            start = args[lb + 1:lb + 2]
            tokens = args[None, :lb]
            for state in self._prefill_states():
                restart_decode_cache(state, start)
            if self._spec:
                logp = self._spec_prefill(self._prefill_state,
                                          self._prefill_state_d, tokens)
            else:
                logp, _ = self._model.run(tokens, self._prefill_state)
            return _argmax_and_finite(
                logp[0].index_select(0, args[lb:lb + 1] - 1))

        return run, (torch.zeros(lb + 2, dtype=torch.long,
                                 device=self.device),)

    def _prefill_program(self, lb: int):
        """``("serve_prefill", lb, max_len, dtype)`` (``serve_prefill_spec``
        with a draft, whose cache it fills too)."""
        kind = "serve_prefill_spec" if self._spec else "serve_prefill"
        return self._programs.get_or_capture(
            (kind, lb, self.max_len, self._dtype_name),
            lambda: self._prefill_build(lb))

    def _run_prefill(self, lb: int, tokens: np.ndarray,
                     start: int) -> tuple[int, bool]:
        """Prefill ``tokens`` from depth ``start`` through bucket ``lb``'s
        program; a length off the grid (a re-admitted context longer than
        the largest bucket) runs the same function eagerly, outside the
        ledger. Returns the next token and the finiteness flag."""
        n = int(tokens.size)
        args = np.zeros(lb + 2, np.int64)
        args[:n] = tokens
        args[lb], args[lb + 1] = n, start
        if lb in self.buckets:
            prog = self._prefill_program(lb)
            prog.inputs[0].copy_(torch.from_numpy(args))
            out = self._call(prog)
        else:
            run, (inp,) = self._prefill_build(lb)
            inp.copy_(torch.from_numpy(args))
            out = run(inp)
        nxt, ok = out.cpu().numpy()
        self._prefills += 1
        self._prefill_buckets[lb] += 1
        return int(nxt[0]), bool(ok[0])

    def _decode_program(self):
        """The tick: ``("serve_decode", slots, max_len, dtype)``, over the
        page pool ``("serve_decode_paged", slots, max_len, pages,
        page_tokens, dtype)``: one cached step of the grid on (slots, 1)
        tokens, returning the greedy tokens over the per-row all-finite
        flags, (2, slots) long. With a draft, ``("serve_spec_step", slots,
        max_len[, pages, page_tokens], k, dtype)``: one speculative round,
        returning
        ``[props (k) | greedy (k+1) | n_acc | ok]`` a row, (slots, 2k+3)."""
        if self._spec:
            key = ("serve_spec_step",) + self._grid() + (self._spec,
                                                         self._dtype_name)
        else:
            key = ("serve_decode_paged" if self.paged else "serve_decode",
                   ) + self._grid() + (self._dtype_name,)

        def build():
            def run(tok):
                if self._spec:
                    props, greedy, n_acc, ok = self._spec_step(
                        self._dec_state, self._dec_state_d, tok[:, 0])
                    return torch.cat([props, greedy, n_acc[:, None],
                                      ok[:, None].long()], dim=1)
                logp, _ = self._model.run(tok, self._dec_state)
                return _argmax_and_finite(logp[:, 0])

            return run, (torch.zeros((self.slots, 1), dtype=torch.long,
                                     device=self.device),)

        return self._programs.get_or_capture(key, build)

    def _assign_program(self):
        """``("serve_assign", slots, max_len, dtype)`` and its ``_paged``,
        ``_spec`` and ``_paged_spec`` forms: copy the prefilled batch-1
        cache(s) into a decode row at the true context length (page by
        page into the pool when paged). Input: the slot, the length, then
        (paged) the row's W physical pages."""
        kind = "serve_assign" + ("_paged" if self.paged else "") \
            + ("_spec" if self._spec else "")
        key = (kind,) + self._grid() + (self._dtype_name,)

        def build():
            def run(args):
                slot, pos = args[0:1], args[1:2]
                if self.paged:
                    paged_cache.assign_cache_pages(
                        self._dec_state, self._prefill_state, args[2:],
                        slot, pos)
                else:
                    assign_cache_slot(self._dec_state, self._prefill_state,
                                      slot, pos=pos)
                if self._spec:
                    assign_cache_slot(self._dec_state_d,
                                      self._prefill_state_d, slot, pos=pos)

            return run, (torch.zeros(2 + self._page_w, dtype=torch.long,
                                     device=self.device),)

        return self._programs.get_or_capture(key, build)

    # ----------------------------------------------------------- admission
    def _prefill_ctx(self, ctx: np.ndarray, hit) -> tuple[int, bool]:
        """Fill the batch-1 cache(s) with ``ctx`` the cheapest way and
        return the next token and the finiteness flag: an exact prefix
        hit copies the pooled state and runs no program; a partial hit
        copies it and prefills the remainder from its depth through the
        bucket :func:`pick_seed_bucket` gives; a miss prefills the whole
        context. A finite result is pooled."""
        clen = int(ctx.size)
        if hit is not None:
            entry, c = hit
            registry.counter("serving/prefix_hits").inc()
            registry.counter("serving/prefix_tokens_saved").inc(c)
            PrefixPool.seeded(entry, c, out=self._prefill_states())
            if c == clen:
                return entry.next_token, True
            lb = pick_seed_bucket(clen - c, self.buckets, c, self.max_len)
            nxt, ok = self._run_prefill(lb, ctx[c:], c)
        else:
            lb = pick_bucket(clen, self.buckets) or self.max_len
            nxt, ok = self._run_prefill(lb, ctx, 0)
        if ok and self._prefix is not None:
            self._prefix.insert(ctx, self._prefill_states(), nxt)
        return nxt, ok

    def _admit(self, req: Request) -> bool:
        """Prefill ``req``'s context (its prompt, plus the tokens it emitted
        before a preemption, a crash or a swap) into a free slot; its next
        token falls out of the prefill. Returns False only when the page
        pool cannot back the context now (the request is untouched)."""
        ctx = req.prompt
        if req.generated:
            ctx = np.concatenate([ctx, np.asarray(req.generated, np.int32)])
        clen = int(ctx.size)
        pages = []
        if self.paged:
            # content pages only: the page of the first decode write is
            # _ensure_pages's, so the peak matches submit's check
            need = (clen - 1) // self.page_tokens + 1
            pages = self._allocator.alloc(need)
            if pages is None:
                events.record("serving_page_backpressure",
                              engine=self.name, request_id=req.request_id,
                              trace_id=req.trace_id, pages_needed=need,
                              pages_free=self._allocator.free_count)
                return False
        t0 = time.perf_counter()
        recycles = self._sched.recycles
        slot = self._sched.admit(req)
        if self._sched.recycles > recycles:
            registry.counter("serving/slot_recycles").inc()
        slot.depth = clen
        if self.paged:
            self._slot_pages[slot.index] = pages
            self._page_table[slot.index, :] = TRASH_PAGE
            self._page_table[slot.index, :len(pages)] = pages
            self._table_dirty = True
            self._publish_page_gauges()
        if req.admit_t is None:
            req.admit_t = self.clock()
            self._backlog_dec()
            registry.histogram("serving/queue_wait_ms").observe(
                (req.admit_t - req.submit_t) * 1e3)
        hit = (self._prefix.lookup(ctx, self.buckets, self.max_len)
               if self._prefix is not None else None)
        try:
            fault_point(faults.SITE_SERVE_PREFILL)
            with trace.span("serve/prefill",
                            {"slot": slot.index, "trace_id": req.trace_id,
                             "prefix_hit": hit[1] if hit else 0}):
                nxt, ok = self._prefill_ctx(ctx, hit)
        except FaultError as e:
            # this request fails; the decode grid was never touched
            events.record("serving_prefill_failed", engine=self.name,
                          request_id=req.request_id, trace_id=req.trace_id,
                          error=str(e))
            logger.error("engine %r: request %r failed in prefill: %s",
                         self.name, req.request_id, e)
            req.handle._fail(e)
            self._free_slot_pages(slot.index)
            self._sched.release(slot)
            if self._resume is not None:
                self._resume.left.discard(id(req))
            return True
        self._prefill_s += time.perf_counter() - t0
        if not ok:
            self._fail_slot(slot, "prefill")
            return True
        args = np.zeros(2 + self._page_w, np.int64)
        args[0], args[1] = slot.index, clen
        args[2:2 + len(pages)] = pages
        assign = self._assign_program()
        assign.inputs[0].copy_(torch.from_numpy(args))
        self._call(assign)
        if req.first_token_t is None:
            req.first_token_t = self.clock()
            registry.histogram("serving/ttft_ms").observe(
                (req.first_token_t - req.submit_t) * 1e3)
        self._emit(slot, nxt)
        if self._resume is not None:
            self._resumed(req, t0)
        registry.gauge("serving/active_slots").set(self._sched.active_count)
        return True

    def _resumed(self, req: Request, t_admit: float) -> None:
        """An admission's token after a crash or a swap: the first one's
        time since the mark goes to ``serving/resume_first_token_ms``; a
        requeued request's admission (prefill, assign, emit) adds to its
        re-prefill time, observed in ``serving/reprefill_ms`` once every
        requeued request is back in a slot."""
        r, now = self._resume, time.perf_counter()
        if r.first:
            r.first = False
            registry.histogram("serving/resume_first_token_ms").observe(
                (now - r.t0) * 1e3)
        if id(req) in r.left:
            r.left.discard(id(req))
            r.reprefill_s += now - t_admit
            if not r.left:
                registry.histogram("serving/reprefill_ms").observe(
                    r.reprefill_s * 1e3)
        if not r.left:
            self._resume = None

    # -------------------------------------------------------------- decode
    def _tick(self) -> None:
        """One decode step (or speculative round) over the whole grid. Its
        host-clock time ends with the results on the host, so it covers the
        device work."""
        t0 = time.perf_counter()
        if self.paged:
            self._ensure_pages()
            if not self._sched.any_active():
                return
            self._sync_page_table()
        active = self._sched.active_slots()
        tok = self._tok_host.numpy()
        tok[:] = 0
        for slot in active:
            tok[slot.index, 0] = slot.last_token
        fault_point(faults.SITE_SERVE_STALL)   # a "stall" sleeps here
        decode = self._decode_program()
        decode.inputs[0].copy_(self._tok_host, non_blocking=True)
        self._captured = False
        with trace.span("serve/decode_step", {"active": len(active)}):
            out = self._call(decode).cpu().numpy()
        k = self._spec
        action = check_fault(faults.SITE_SERVE_DECODE)
        if action == "nonfinite" and active:
            # poison the lowest active row's flag: its request alone fails
            out = out.copy()
            if k:
                out[active[0].index, -1] = 0
            else:
                out[1, active[0].index] = 0
        elif action is not None and action != "nonfinite":
            raise FaultError(
                f"injected fault at site {faults.SITE_SERVE_DECODE!r}")
        dt = time.perf_counter() - t0
        self._decode_ticks += 1
        self._decode_s += dt
        if self._watchdog is not None:
            self._watchdog.heartbeat(None if self._captured else dt)
        emitted = 0
        for slot in active:
            if k:
                props, greedy = out[slot.index, :k], out[slot.index, k:2 * k + 1]
                j, ok = int(out[slot.index, 2 * k + 1]), out[slot.index, -1]
            else:
                ok = out[1, slot.index]
            if not ok:
                self._poison(slot)
                continue
            if not k:
                slot.depth += 1
                emitted += 1
                self._emit(slot, int(out[0, slot.index]))
                continue
            # the device's depth advanced k+1 and rewound k-j
            slot.depth += j + 1
            self._spec_proposed += k
            self._spec_accepted += j
            # tokens past a finish (eos, length) are dropped: plain decode
            # stops there too
            for t in [int(x) for x in props[:j]] + [int(greedy[j])]:
                emitted += 1
                if self._emit(slot, t):
                    break
        self._decode_tokens += emitted
        # the rate counts as JAX's: every active row, n_acc + 1 a row in a
        # speculative tick, finished or poisoned rows too
        counted = (sum(int(out[s.index, 2 * k + 1]) + 1 for s in active)
                   if k else len(active))
        if dt > 0 and counted:
            inst = counted / dt
            self._rate_tps = (inst if self._rate_tps == 0.0
                              else 0.8 * self._rate_tps + 0.2 * inst)
        registry.gauge("serving/active_slots").set(self._sched.active_count)

    def _emit(self, slot, token: int) -> bool:
        """Append ``token`` to the slot's request; True when it finished."""
        req = slot.request
        req.generated.append(token)
        if self.eos_id is not None and token == self.eos_id:
            self._finish(slot, FINISH_EOS)
        elif len(req.generated) >= req.max_new_tokens:
            self._finish(slot, FINISH_LENGTH)
        else:
            slot.last_token = token
            return False
        return True

    def _finish(self, slot, reason: str) -> None:
        req = slot.request
        result = req.complete(reason)
        self._completed += 1
        registry.counter("serving/completed").inc()
        registry.histogram("serving/e2e_ms").observe(result.latency_s * 1e3)
        tpot = result.time_per_token_s()
        if tpot is not None:
            registry.histogram("serving/tpot_ms").observe(tpot * 1e3)
        n = result.n_generated
        self._tok_per_req = (float(n) if self._tok_per_req == 0.0
                             else 0.8 * self._tok_per_req + 0.2 * n)
        self._maybe_persist_trace(req, result)
        self._access_log(req, "ok", e2e_s=result.latency_s)
        self._free_slot_pages(slot.index)
        self._sched.release(slot)

    def _poison(self, slot) -> None:
        """A row's logits went non-finite in a tick: wipe the row (paged:
        zero its pages, a NaN would survive a 0 weight) and the draft's
        row, eagerly, then fail the request."""
        if self.paged:
            paged_cache.reset_page_slot(
                self._dec_state, self._slot_pages[slot.index], slot.index)
        else:
            reset_decode_slot(self._dec_state, slot.index)
        if self._spec:
            reset_decode_slot(self._dec_state_d, slot.index)
        self._fail_slot(slot, "decode")

    def _fail_slot(self, slot, phase: str) -> None:
        req = slot.request
        self._poisoned += 1
        registry.counter("serving/poisoned_slots").inc()
        events.record("serving_poisoned_slot", engine=self.name,
                      request_id=req.request_id, trace_id=req.trace_id,
                      phase=phase, slot=slot.index)
        logger.error("engine %r: non-finite logits in %s of request %r "
                     "(slot %d)", self.name, phase, req.request_id,
                     slot.index)
        req.handle._fail(NonFiniteLogitsError(
            f"non-finite logits in {phase} of request {req.request_id} "
            f"(slot {slot.index}) [trace {req.trace_id}]"))
        self._access_log(req, "poisoned")
        self._free_slot_pages(slot.index)
        self._sched.release(slot)

    # ----------------------------------------------------------- the logs
    def _access_log(self, req: Request, outcome: str,
                    e2e_s: Optional[float] = None) -> None:
        """One access-log record for a finished request (free when
        ``BIGDL_ACCESS_LOG`` is unset); ``flops`` is None until the MFU
        accounting is ported."""
        obs_access_log.log_request(
            trace_id=req.trace_id, tenant=self.name,
            phase="decode" if req.admit_t is not None else "queue",
            prompt_tokens=req.prompt_len, output_tokens=len(req.generated),
            ttft_ms=(round((req.first_token_t - req.submit_t) * 1e3, 3)
                     if req.first_token_t is not None else None),
            e2e_ms=round((e2e_s if e2e_s is not None
                          else self.clock() - req.submit_t) * 1e3, 3),
            flops=None, outcome=outcome)

    def _maybe_persist_trace(self, req: Request, result) -> None:
        """Tail sampling: write the request's spans to the JSONL log only
        when it lands in the slowest ``BIGDL_TRACE_SAMPLE`` share of the
        ``serving/e2e_ms`` window (>= 1: every request)."""
        if trace.jsonl_path() is None:
            return
        frac = self._trace_sample
        if frac <= 0:
            return
        e2e_ms = result.latency_s * 1e3
        if frac < 1.0:
            q = max(0.0, min(100.0, 100.0 * (1.0 - frac)))
            thr = registry.histogram("serving/e2e_ms").percentiles(
                (q,)).get(q)
            if thr is not None and e2e_ms < thr:
                return
        t0 = req.submit_t

        def ms(a, b):
            return round((b - a) * 1e3, 3)

        spans = []
        if req.admit_t is not None:
            spans.append({"name": "serve/queue", "start_ms": 0.0,
                          "dur_ms": ms(t0, req.admit_t)})
        if req.admit_t is not None and req.first_token_t is not None:
            spans.append({"name": "serve/prefill",
                          "start_ms": ms(t0, req.admit_t),
                          "dur_ms": ms(req.admit_t, req.first_token_t)})
        if req.first_token_t is not None:
            spans.append({"name": "serve/decode",
                          "start_ms": ms(t0, req.first_token_t),
                          "dur_ms": ms(req.first_token_t,
                                       t0 + result.latency_s)})
        trace.event("request_trace", trace_id=req.trace_id,
                    request_id=req.request_id, engine=self.name,
                    e2e_ms=round(e2e_ms, 3), n_generated=result.n_generated,
                    finish=result.finish_reason, spans=spans)

    # ----------------------------------------------------------- deadlines
    def _timeout(self, req: Request, in_slot: bool) -> None:
        self._timeouts += 1
        registry.counter("serving/timeouts").inc()
        events.record("serving_timeout", engine=self.name,
                      request_id=req.request_id, trace_id=req.trace_id,
                      in_slot=in_slot, generated=len(req.generated))
        req.handle._fail(RequestTimeout(
            f"request {req.request_id} missed its deadline "
            f"({'mid-decode' if in_slot else 'while queued'}, "
            f"{len(req.generated)} tokens generated) [trace {req.trace_id}]"))
        self._access_log(req, "timeout")
        if req.admit_t is None:
            self._backlog_dec()

    def _expire_pending(self, now: float) -> None:
        keep = []
        for req in self._pending:
            if req.expired(now):
                self._timeout(req, in_slot=False)
            else:
                keep.append(req)
        self._pending[:] = keep

    def _expire_slots(self) -> None:
        """Recycle the rows whose request's deadline passed mid-decode, now,
        instead of decoding for a request nobody waits for."""
        now = self.clock()
        for slot in self._sched.active_slots():
            if slot.request.expired(now):
                self._timeout(slot.request, in_slot=True)
                self._free_slot_pages(slot.index)
                self._sched.release(slot)

    def _abort_outstanding(self) -> None:
        err = self._failure or EngineShutdown(
            f"engine {self.name!r} shut down before the request finished")
        for slot in self._sched.active_slots():
            slot.request.handle._fail(err)
            self._access_log(slot.request, "aborted")
            self._free_slot_pages(slot.index)
            self._sched.release(slot)
        for req in self._pending:
            req.handle._fail(err)
            self._access_log(req, "aborted")
            if req.admit_t is None:
                self._backlog_dec()
        self._pending.clear()
        self._queue.close()
        while True:   # requests that raced the close are still queued
            item = self._queue.get(timeout=0)
            if item is EMPTY or item is CLOSED:
                break
            if item is not _WAKE:
                item.handle._fail(err)
                self._backlog_dec()
        # a swap whose waiter still blocks fails now: its loop is gone
        with self._swap_lock:
            cmd, self._swap_pending = self._swap_pending, None
        if cmd is not None:
            cmd.error = err
            cmd.done.set()


def _clone_state(state: dict) -> dict:
    return {k: _clone_state(v) if isinstance(v, dict) else v.clone()
            for k, v in state.items()}


def _argmax_and_finite(rows: torch.Tensor) -> torch.Tensor:
    """Greedy token over the all-finite flag of each (V,) row of ``rows``
    (R, V), as one (2, R) long tensor on the rows' device."""
    return torch.stack([rows.argmax(dim=-1),
                        torch.isfinite(rows).all(dim=-1).long()])
