"""Online serving engine: continuous batching over the KV-cached decode.

Counterpart of the core of ``bigdl_tpu/serving/engine.py``:

- **Admission**: clients ``submit()`` from any thread into a bounded
  ``ClosableQueue``; one engine thread owns the model, the cache and the
  device.
- **Prefill**: a request's prompt runs as one batch-1 chunk, right-padded to
  the smallest bucket of the prefill grid, through the cached path into
  the engine's one batch-1 cache; the logits at the last true position give
  the first token (TTFT ends there). The filled batch-1 cache is copied
  into a free slot of the decode grid at the TRUE prompt length.
- **Decode tick**: one cached step over the whole slot grid (free rows ride
  along with a dummy token and are ignored), greedy argmax per row, and a
  per-row finiteness flag: a row with non-finite logits fails its own
  request and is wiped, the others never notice.
- **Programs**: each of those runs as a program of
  ``utils/programs.py``, keyed as JAX keys its compiled programs
  (``("serve_prefill", bucket, max_len, dtype)`` for each bucket,
  ``("serve_decode", slots, max_len, dtype)``, ``("serve_assign", slots,
  max_len, dtype)``): a CUDA graph captured at the first use of its key and
  replayed after that, with the greedy token and the finiteness flags
  computed inside it. A tick copies its tokens to the card once and its
  results back once. ``stats()["compiled_programs"]`` counts the keys used
  against ``program_grid_bound = len(buckets) + 2``. Wiping a poisoned row
  is the fault path and stays eager, outside the bound, as in JAX.
- **Finish and recycling**: a row that emits ``eos_id`` or reaches
  ``max_new_tokens`` completes its handle and is handed to the next waiting
  request mid-flight.

Batched output equals per-request ``greedy_generate`` because of the
chunked-prefill == full-forward invariant and per-row positions. Paging,
the prefix pool, speculative decoding, deadlines, overload control, crash
recovery, weight swaps and the metrics export are not ported yet.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.nn.incremental import (
    assign_cache_slot, install_decode_cache, reset_decode_slot,
    zero_decode_cache,
)
from bigdl_tpu_torch.serving.request import (
    FINISH_EOS, FINISH_LENGTH, Request, RequestHandle,
)
from bigdl_tpu_torch.serving.scheduler import (
    SlotScheduler, default_buckets, pick_bucket,
)
from bigdl_tpu_torch.utils.device import require_on
from bigdl_tpu_torch.utils.programs import ProgramCache
from bigdl_tpu_torch.utils.queues import CLOSED, EMPTY, ClosableQueue

logger = logging.getLogger("bigdl_tpu_torch.serving")


class EngineShutdown(RuntimeError):
    """The engine stopped before the request finished (or was submitted)."""


class NonFiniteLogitsError(RuntimeError):
    """A request's logits went non-finite; only that request fails."""


class ServingEngine:
    """Continuous-batching request server over one model.

    ``model``: a causal LM of cached-decode-capable modules (a
    ``TransformerLM``). ``max_len``: per-slot cache length; every request
    needs ``prompt_len + max_new_tokens <= max_len``. ``slots``: rows of the
    decode grid. ``buckets``: prefill length grid (default
    ``default_buckets(max_len)``). ``eos_id``: optional stop token.
    ``device``: where the model lives, default ``"cuda"``.
    """

    def __init__(self, model: torch.nn.Module, max_len: int, slots: int = 8,
                 buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, queue_depth: int = 256,
                 dtype: torch.dtype = torch.float32, name: str = "serve",
                 device=None):
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
        self.name = name
        self.max_len = int(max_len)
        self.slots = int(slots)
        self.buckets = buckets
        self.eos_id = eos_id
        self._model = model
        self._dtype = dtype
        self._dec_state = install_decode_cache(model, self.slots,
                                               self.max_len, dtype)
        # the prefill programs' one batch-1 cache (zeroed by each prefill)
        self._prefill_state = install_decode_cache(model, 1, self.max_len,
                                                   dtype)
        self._programs = ProgramCache(self.device)
        self._dtype_name = str(dtype).replace("torch.", "")
        # host side of a tick's two copies: pinned on the card, so the
        # token copy is asynchronous
        self._tok_host = torch.zeros(
            (self.slots, 1), dtype=torch.long,
            pin_memory=self.device.type == "cuda")
        self._queue = ClosableQueue(queue_depth)
        self._sched = SlotScheduler(self.slots)
        self._pending: list[Request] = []
        self._lock = threading.Lock()      # submit-side counters + start
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._failure: Optional[BaseException] = None
        self._submitted = 0
        self._completed = 0
        self._prefills = 0
        self._decode_ticks = 0
        self._decode_tokens = 0
        self._decode_s = 0.0
        self._prefill_s = 0.0
        self._poisoned = 0

    # ------------------------------------------------------------- clients
    def submit(self, prompt, max_new_tokens: int,
               request_id=None) -> RequestHandle:
        """Enqueue one request and return its handle at once. Raises
        ``ValueError`` for a request that can never fit and
        ``EngineShutdown`` once the engine is shut down."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt_len {prompt.size} + max_new_tokens "
                f"{max_new_tokens} exceeds the engine's cache length "
                f"max_len={self.max_len}")
        if pick_bucket(prompt.size, self.buckets) is None:
            raise ValueError(f"prompt_len {prompt.size} exceeds the largest "
                             f"prefill bucket {self.buckets[-1]}")
        with self._lock:
            if request_id is None:
                request_id = self._submitted
            self._submitted += 1
        req = Request(request_id, prompt, max_new_tokens)
        self.start()
        if not self._queue.put(req):
            raise EngineShutdown(f"engine {self.name!r} is shut down")
        return req.handle

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
            "queued": self._queue.qsize() + len(self._pending),
            "slot_recycles": self._sched.recycles,
            "prefills": self._prefills,
            "prefill_seconds": self._prefill_s,
            "decode_ticks": self._decode_ticks,
            "decode_tokens": self._decode_tokens,
            "decode_seconds": self._decode_s,
            "poisoned_slots": self._poisoned,
            "running": self._thread is not None and self._thread.is_alive(),
        }

    # -------------------------------------------------------- engine thread
    def _thread_main(self) -> None:
        try:
            with torch.no_grad():
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
            while self._pending and self._sched.has_free() \
                    and not self._stop.is_set():
                self._admit(self._pending.pop(0))
            if self._sched.any_active() and not self._stop.is_set():
                self._tick()
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

    # ------------------------------------------------------------ programs
    def _prefill_program(self, lb: int):
        """``("serve_prefill", lb, max_len, dtype)``: zero the batch-1
        cache, run one right-padded (1, lb) chunk through it, and return the
        greedy token and the all-finite flag at the true last position, a
        (2, 1) long tensor. Input: lb token ids, then the true length."""
        key = ("serve_prefill", lb, self.max_len, self._dtype_name)

        def build():
            def run(args):
                state = zero_decode_cache(self._prefill_state)
                logp, _ = self._model.run(args[None, :lb], state)
                return _argmax_and_finite(
                    logp[0].index_select(0, args[lb:] - 1))

            return run, (torch.zeros(lb + 1, dtype=torch.long,
                                     device=self.device),)

        return self._programs.get_or_capture(key, build)

    def _decode_program(self):
        """``("serve_decode", slots, max_len, dtype)``: one cached step of
        the slot grid on (slots, 1) tokens; returns the greedy tokens over
        the per-row all-finite flags, a (2, slots) long tensor."""
        key = ("serve_decode", self.slots, self.max_len, self._dtype_name)

        def build():
            def run(tok):
                logp, _ = self._model.run(tok, self._dec_state)
                return _argmax_and_finite(logp[:, 0])

            return run, (torch.zeros((self.slots, 1), dtype=torch.long,
                                     device=self.device),)

        return self._programs.get_or_capture(key, build)

    def _assign_program(self):
        """``("serve_assign", slots, max_len, dtype)``: copy the prefilled
        batch-1 cache into a decode row at the true prompt length. Input:
        the slot, then the length."""
        key = ("serve_assign", self.slots, self.max_len, self._dtype_name)

        def build():
            def run(args):
                assign_cache_slot(self._dec_state, self._prefill_state,
                                  args[0:1], pos=args[1:2])

            return run, (torch.zeros(2, dtype=torch.long,
                                     device=self.device),)

        return self._programs.get_or_capture(key, build)

    def _admit(self, req: Request) -> None:
        """Prefill ``req`` into a free slot; its first token falls out of
        the prefill logits."""
        t0 = time.perf_counter()
        clen = req.prompt_len
        lb = pick_bucket(clen, self.buckets)
        slot = self._sched.admit(req)
        req.admit_t = time.perf_counter()
        args = np.zeros(lb + 1, np.int64)
        args[:clen] = req.prompt
        args[lb] = clen
        prefill = self._prefill_program(lb)
        prefill.inputs[0].copy_(torch.from_numpy(args))
        nxt, ok = prefill().cpu().numpy()
        self._prefills += 1
        self._prefill_s += time.perf_counter() - t0
        if not ok[0]:
            self._fail_slot(slot, "prefill")
            return
        assign = self._assign_program()
        assign.inputs[0].copy_(torch.tensor([slot.index, clen]))
        assign()
        req.first_token_t = time.perf_counter()
        self._emit(slot, int(nxt[0]))

    def _tick(self) -> None:
        """One decode step over the whole slot grid. Its host-clock time
        ends with the tokens on the host, so it covers the device work."""
        t0 = time.perf_counter()
        active = self._sched.active_slots()
        tok = self._tok_host.numpy()
        tok[:] = 0
        for slot in active:
            tok[slot.index, 0] = slot.last_token
        decode = self._decode_program()
        decode.inputs[0].copy_(self._tok_host, non_blocking=True)
        nxt, ok = decode().cpu().numpy()
        ok = ok.astype(bool)
        self._decode_ticks += 1
        self._decode_s += time.perf_counter() - t0
        self._decode_tokens += int(ok[[s.index for s in active]].sum())
        for slot in active:
            if not ok[slot.index]:
                reset_decode_slot(self._dec_state, slot.index)
                self._fail_slot(slot, "decode")
            else:
                self._emit(slot, int(nxt[slot.index]))

    def _emit(self, slot, token: int) -> None:
        req = slot.request
        req.generated.append(token)
        if self.eos_id is not None and token == self.eos_id:
            self._finish(slot, FINISH_EOS)
        elif len(req.generated) >= req.max_new_tokens:
            self._finish(slot, FINISH_LENGTH)
        else:
            slot.last_token = token

    def _finish(self, slot, reason: str) -> None:
        slot.request.complete(reason)
        self._completed += 1
        self._sched.release(slot)

    def _fail_slot(self, slot, phase: str) -> None:
        req = slot.request
        self._poisoned += 1
        logger.error("engine %r: non-finite logits in %s of request %r "
                     "(slot %d)", self.name, phase, req.request_id,
                     slot.index)
        req.handle._fail(NonFiniteLogitsError(
            f"non-finite logits in {phase} of request {req.request_id} "
            f"(slot {slot.index})"))
        self._sched.release(slot)

    def _abort_outstanding(self) -> None:
        err = self._failure or EngineShutdown(
            f"engine {self.name!r} shut down before the request finished")
        for slot in self._sched.active_slots():
            slot.request.handle._fail(err)
            self._sched.release(slot)
        for req in self._pending:
            req.handle._fail(err)
        self._pending.clear()
        while True:   # requests that raced the close are still queued
            item = self._queue.get(timeout=0)
            if item is EMPTY or item is CLOSED:
                break
            item.handle._fail(err)


def _argmax_and_finite(rows: torch.Tensor) -> torch.Tensor:
    """Greedy token over the all-finite flag of each (V,) row of ``rows``
    (R, V), as one (2, R) long tensor on the rows' device."""
    return torch.stack([rows.argmax(dim=-1),
                        torch.isfinite(rows).all(dim=-1).long()])
