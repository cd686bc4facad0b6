"""Request objects of the serving engine.

Counterpart of ``bigdl_tpu/serving/request.py``. ``submit()`` returns a
:class:`RequestHandle` at once; the engine thread appends tokens as they
decode and completes the handle when the sequence finishes (EOS or length
cap) or fails it when the engine shuts down. Handles are the only
cross-thread surface: clients never touch slots, caches or the device.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

FINISH_EOS = "eos"          # the model emitted the engine's eos_id
FINISH_LENGTH = "length"    # max_new_tokens generated


class CompletedRequest:
    """Immutable result of one served request."""

    __slots__ = ("request_id", "tokens", "prompt_len", "n_generated",
                 "finish_reason", "queue_wait_s", "ttft_s", "latency_s")

    def __init__(self, request_id, tokens, prompt_len, n_generated,
                 finish_reason, queue_wait_s, ttft_s, latency_s):
        self.request_id = request_id
        #: prompt + generated tokens, np.int32 (prompt_len + n_generated,)
        self.tokens = tokens
        self.prompt_len = prompt_len
        self.n_generated = n_generated
        self.finish_reason = finish_reason
        #: submit → admitted to a slot
        self.queue_wait_s = queue_wait_s
        #: submit → first generated token (prefill included)
        self.ttft_s = ttft_s
        #: submit → finished
        self.latency_s = latency_s

    @property
    def generated(self) -> np.ndarray:
        return self.tokens[self.prompt_len:]

    def __repr__(self):
        return (f"CompletedRequest(id={self.request_id}, "
                f"prompt={self.prompt_len}, generated={self.n_generated}, "
                f"finish={self.finish_reason})")


class RequestHandle:
    """Client-side future of one request."""

    def __init__(self, request: "Request"):
        self._request = request
        self._done = threading.Event()
        self._result: Optional[CompletedRequest] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> CompletedRequest:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self._request.request_id} not finished within "
                f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def _complete(self, result: CompletedRequest) -> None:
        self._result = result
        self._done.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._done.set()


class Request:
    """Engine-internal request record; after submission only the engine
    thread touches it."""

    __slots__ = ("request_id", "prompt", "max_new_tokens", "submit_t",
                 "admit_t", "first_token_t", "generated", "handle")

    def __init__(self, request_id, prompt: np.ndarray, max_new_tokens: int):
        self.request_id = request_id
        self.prompt = prompt                      # np.int32 (prompt_len,)
        self.max_new_tokens = int(max_new_tokens)
        self.submit_t = time.perf_counter()
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.generated: list[int] = []
        self.handle = RequestHandle(self)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def complete(self, finish_reason: str) -> CompletedRequest:
        now = time.perf_counter()
        tokens = np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])
        result = CompletedRequest(
            request_id=self.request_id, tokens=tokens,
            prompt_len=self.prompt_len, n_generated=len(self.generated),
            finish_reason=finish_reason,
            queue_wait_s=(self.admit_t - self.submit_t
                          if self.admit_t is not None else None),
            ttft_s=(self.first_token_t - self.submit_t
                    if self.first_token_t is not None else None),
            latency_s=now - self.submit_t)
        self.handle._complete(result)
        return result
