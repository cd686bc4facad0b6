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

The engine thread runs the models in eval mode (JAX applies them with
``training=False``). The model may be any cached-decode-capable
``TransformerLM``. Batched output equals per-request ``greedy_generate``
because of the chunked-prefill == full-forward invariant and per-row
positions. Crash recovery, weight swaps, drain, health, the watchdog and
the metrics export are not ported yet.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.nn.abstractnn import evaluating
from bigdl_tpu_torch.nn.incremental import (
    assign_cache_slot, install_decode_cache, reset_decode_slot,
    restart_decode_cache,
)
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
from bigdl_tpu_torch.utils.device import require_on
from bigdl_tpu_torch.utils.programs import ProgramCache
from bigdl_tpu_torch.utils.queues import CLOSED, EMPTY, ClosableQueue

logger = logging.getLogger("bigdl_tpu_torch.serving")

_OVERLOAD_MODES = ("block", "shed", "degrade")


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


class EngineShutdown(RuntimeError):
    """The engine stopped before the request finished (or was submitted)."""


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


class ServingEngine:
    """Continuous-batching request server over one model.

    ``model``: a causal LM of cached-decode-capable modules (a
    ``TransformerLM``). ``max_len``: per-slot cache length; every request
    needs ``prompt_len + max_new_tokens (+ spec_tokens with a draft) <=
    max_len``. ``slots``: rows of the decode grid. ``buckets``: prefill
    length grid (default ``default_buckets(max_len)``). ``eos_id``: optional
    stop token. ``deadline_ms``: default per-request deadline (0 or unset:
    none). ``overload``: ``"block"``, ``"shed"`` or ``"degrade"``.
    ``draft_model``/``spec_tokens``: speculative decoding (default k = 4).
    ``prefix_pool``/``prefix_chunk``: entries of the prefix pool (0: off)
    and its key alignment (16). ``pages``/``page_tokens``: the paged cache's
    pool size (0: the slot grid) and page size (16; must divide
    ``max_len``). ``device``: where the models live, default ``"cuda"``.
    Unset arguments read the environment variables JAX's engine reads.
    ``clock`` (an attribute) is the time source of requests' deadlines and
    latencies, ``time.perf_counter``; a test may replace it.
    """

    def __init__(self, model: torch.nn.Module, max_len: int, slots: int = 8,
                 buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, queue_depth: int = 256,
                 dtype: torch.dtype = torch.float32, name: str = "serve",
                 device=None, deadline_ms: Optional[float] = None,
                 overload: Optional[str] = None, draft_model=None,
                 spec_tokens: Optional[int] = None,
                 prefix_pool: Optional[int] = None,
                 prefix_chunk: Optional[int] = None,
                 pages: Optional[int] = None,
                 page_tokens: Optional[int] = None):
        self.device = require_on(model, device)
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        buckets = tuple(sorted({int(b) for b in (
            buckets if buckets is not None else default_buckets(max_len))}))
        if not buckets or buckets[0] < 1 or buckets[-1] > max_len:
            raise ValueError(f"buckets must be within [1, max_len={max_len}]"
                             f", got {buckets}")
        if deadline_ms is None:
            deadline_ms = float(os.environ.get("BIGDL_SERVE_DEADLINE_MS", 0))
        if overload is None:
            overload = os.environ.get("BIGDL_SERVE_OVERLOAD", "block")
        if overload not in _OVERLOAD_MODES:
            raise ValueError(f"overload must be one of {_OVERLOAD_MODES}, "
                             f"got {overload!r} (BIGDL_SERVE_OVERLOAD)")
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
        self.queue_depth = int(queue_depth)
        self.default_deadline_s = (deadline_ms / 1e3 if deadline_ms > 0
                                   else None)
        self.overload = overload
        self.paged = pages > 0
        self.pages = int(pages) if self.paged else 0
        self.page_tokens = int(page_tokens)
        self._page_w = (paged_cache.logical_pages(max_len, page_tokens)
                        if self.paged else 0)
        self.clock = time.perf_counter
        self._model = model
        self._draft = draft_model
        self._spec = int(spec_tokens) if draft_model is not None else 0
        self._dtype = dtype
        self._dtype_name = str(dtype).replace("torch.", "")
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
        self._lock = threading.Lock()      # submit-side counters + start
        # held by the engine thread while it admits and ticks, and by
        # prefill_export: the programs share the engine's caches
        self._device_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._failure: Optional[BaseException] = None
        self._submitted = 0
        self._submit_lock = threading.Lock()
        self._prefill_inflight = 0         # prefill_export calls running
        self._completed = 0
        self._backlog = 0                  # submitted, not yet in a slot
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

    # ------------------------------------------------------------- clients
    def submit(self, prompt, max_new_tokens: int, request_id=None,
               deadline_ms: Optional[float] = None,
               trace_id: Optional[str] = None) -> RequestHandle:
        """Enqueue one request and return its handle at once. Raises
        ``ValueError`` for a request that can never fit (cache length,
        bucket grid, page pool), ``EngineShutdown`` once the engine is shut
        down and ``EngineOverloaded`` under ``overload="shed"`` pressure.
        ``deadline_ms`` overrides the engine's default (0: none);
        ``trace_id`` reuses a caller's trace id."""
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
        return req.handle

    def _reject_overloaded(self, depth: int, est: float,
                           pages_free: Optional[int] = None) -> None:
        with self._lock:
            self._shed += 1
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
        admission or tick."""
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
            with self._device_lock, torch.no_grad(), self._eval():
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
        """Start the engine thread (idempotent; ``submit`` calls it)."""
        with self._lock:
            if self._stop.is_set():
                raise EngineShutdown(f"engine {self.name!r} is shut down")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._thread_main, name=f"bigdl-serve-{self.name}",
                    daemon=True)
                self._thread.start()
        return self

    def shutdown(self, wait: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting requests; unfinished ones fail with
        ``EngineShutdown``. ``wait`` joins the engine thread and raises if
        it is still alive after ``timeout`` seconds."""
        self._stop.set()
        self._queue.close()
        t = self._thread
        if wait and t is not None and t is not threading.current_thread():
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError(f"engine {self.name!r} thread still alive "
                                   f"{timeout}s after shutdown")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    def stats(self) -> dict:
        """The engine's ledger, under JAX's keys with JAX's rounding
        (``bigdl_tpu/serving/engine.py`` ``stats``), less the health keys
        of ROADMAP Queue A.3.2 (``health``, ``respawns``, ``model_version``,
        ``slo_degraded``), plus the port's own (``device``,
        ``peak_active_slots``, ``prefills``, ``prefills_by_bucket``,
        ``prefill_seconds``, ``decode_ticks``, ``decode_tokens``,
        ``decode_seconds``, ``running``). ``prefix_bytes`` counts the
        pool's cache leaves as they are held: the positions are int64 here
        (int32 in JAX, 4 more bytes a position leaf), the dtype the port's
        index ops take."""
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

    # -------------------------------------------------------- engine thread
    def _eval(self):
        stack = contextlib.ExitStack()
        stack.enter_context(evaluating(self._model))
        if self._draft is not None:
            stack.enter_context(evaluating(self._draft))
        return stack

    def _thread_main(self) -> None:
        try:
            with torch.no_grad(), self._eval():
                self._loop()
        except Exception as e:  # noqa: BLE001 — fail the handles, not silence
            self._failure = e
            logger.exception("engine %r thread failed", self.name)
        finally:
            self._stop.set()
            self._queue.close()
            self._abort_outstanding()

    def _loop(self) -> None:
        while not self._stop.is_set():
            closed = self._gather()
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
                if self._sched.any_active() and not self._stop.is_set():
                    self._tick()
                    self._expire_slots()
                elif closed:
                    break

    def _gather(self) -> bool:
        """Pull arrivals into the pending list; block only when idle.
        Returns True once the queue is closed and drained."""
        if self._sched.any_active() or self._pending:
            while True:
                item = self._queue.get(timeout=0)
                if item is EMPTY or item is CLOSED:
                    return item is CLOSED
                self._pending.append(item)
        item = self._queue.get()
        if item is CLOSED:
            return True
        self._pending.append(item)
        return False

    # -------------------------------------------------------------- paging
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

    def _preempt(self, slot) -> None:
        """Evict one sequence to free its pages: it goes back to the head
        of the pending list with its handle and emitted tokens, and
        re-admits by prefilling its prompt plus those tokens."""
        req = slot.request
        self._page_evictions += 1
        logger.warning(
            "engine %r: page pool exhausted; preempting request %r "
            "(slot %d, %d pages)", self.name, req.request_id, slot.index,
            len(self._slot_pages[slot.index]))
        self._free_slot_pages(slot.index)
        self._sched.release(slot)
        self._pending.insert(0, req)

    # ------------------------------------------------------------ programs
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
            out = prog()
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
        before a preemption) into a free slot; its next token falls out of
        the prefill. Returns False only when the page pool cannot back the
        context now (the request is untouched)."""
        ctx = req.prompt
        if req.generated:
            ctx = np.concatenate([ctx, np.asarray(req.generated, np.int32)])
        clen = int(ctx.size)
        pages = []
        if self.paged:
            # content pages only: the page of the first decode write is
            # _ensure_pages's, so the peak matches submit's check
            pages = self._allocator.alloc((clen - 1) // self.page_tokens + 1)
            if pages is None:
                return False
        t0 = time.perf_counter()
        slot = self._sched.admit(req)
        slot.depth = clen
        if self.paged:
            self._slot_pages[slot.index] = pages
            self._page_table[slot.index, :] = TRASH_PAGE
            self._page_table[slot.index, :len(pages)] = pages
            self._table_dirty = True
        if req.admit_t is None:
            req.admit_t = self.clock()
            self._backlog_dec()
        hit = (self._prefix.lookup(ctx, self.buckets, self.max_len)
               if self._prefix is not None else None)
        nxt, ok = self._prefill_ctx(ctx, hit)
        self._prefill_s += time.perf_counter() - t0
        if not ok:
            self._fail_slot(slot, "prefill")
            return True
        args = np.zeros(2 + self._page_w, np.int64)
        args[0], args[1] = slot.index, clen
        args[2:2 + len(pages)] = pages
        assign = self._assign_program()
        assign.inputs[0].copy_(torch.from_numpy(args))
        assign()
        if req.first_token_t is None:
            req.first_token_t = self.clock()
        self._emit(slot, nxt)
        return True

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
        decode = self._decode_program()
        decode.inputs[0].copy_(self._tok_host, non_blocking=True)
        out = decode().cpu().numpy()
        dt = time.perf_counter() - t0
        self._decode_ticks += 1
        self._decode_s += dt
        emitted = 0
        k = self._spec
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
        n = len(slot.request.generated)
        slot.request.complete(reason)
        self._completed += 1
        self._tok_per_req = (float(n) if self._tok_per_req == 0.0
                             else 0.8 * self._tok_per_req + 0.2 * n)
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
        logger.error("engine %r: non-finite logits in %s of request %r "
                     "(slot %d)", self.name, phase, req.request_id,
                     slot.index)
        req.handle._fail(NonFiniteLogitsError(
            f"non-finite logits in {phase} of request {req.request_id} "
            f"(slot {slot.index}) [trace {req.trace_id}]"))
        self._free_slot_pages(slot.index)
        self._sched.release(slot)

    # ----------------------------------------------------------- deadlines
    def _timeout(self, req: Request, in_slot: bool) -> None:
        self._timeouts += 1
        req.handle._fail(RequestTimeout(
            f"request {req.request_id} missed its deadline "
            f"({'mid-decode' if in_slot else 'while queued'}, "
            f"{len(req.generated)} tokens generated) [trace {req.trace_id}]"))
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
            self._free_slot_pages(slot.index)
            self._sched.release(slot)
        for req in self._pending:
            req.handle._fail(err)
            if req.admit_t is None:
                self._backlog_dec()
        self._pending.clear()
        while True:   # requests that raced the close are still queued
            item = self._queue.get(timeout=0)
            if item is EMPTY or item is CLOSED:
                break
            item.handle._fail(err)
            self._backlog_dec()


def _clone_state(state: dict) -> dict:
    return {k: _clone_state(v) if isinstance(v, dict) else v.clone()
            for k, v in state.items()}


def _argmax_and_finite(rows: torch.Tensor) -> torch.Tensor:
    """Greedy token over the all-finite flag of each (V,) row of ``rows``
    (R, V), as one (2, R) long tensor on the rows' device."""
    return torch.stack([rows.argmax(dim=-1),
                        torch.isfinite(rows).all(dim=-1).long()])
