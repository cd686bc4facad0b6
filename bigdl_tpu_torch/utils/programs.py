"""Captured programs: the port's counterpart of JAX's compiled-program cache.

JAX runs each hot path as one compiled program, cached under a key
(``ServingEngine._fn``, ``bigdl_tpu/serving/engine.py:564``; the trainer's
step and window programs): one program per prefill bucket, one decode
program, one slot-assign program, one training step. The port captures each
such path as a CUDA graph (``torch.cuda.CUDAGraph``) under the same key:
captured at the first use of its key, replayed after that.

A :class:`Program` owns static input buffers. Its caller writes the
inputs of a call into them, calls the program, and reads the outputs
before the next call. On the card the first call runs the function once
eagerly on a side stream (the warm-up, a real run whose results it
returns: it builds the kernels' library, fills lazy state such as the
optimizer's slots, and may allocate), then captures it; every later call
replays the graph. On the CPU every call runs the function eagerly, so
the tests run the same code and count the same keys.

A graph freezes what it saw at capture: the addresses of every tensor it
reads or writes, and every Python number. So a program's function reads
its inputs from the static buffers and its step-dependent numbers from
device tensors, updates state in place, and makes no host read. Nothing
falls back: a capture that fails raises :class:`ProgramCaptureError` with
the key, and a program on the card never runs eagerly after its capture.

Launch counts (``kernels.launch_counts``) stay those of the kernels that
ran: the capture's launches are recorded, not counted
(``kernels/_cuda.py`` ``recording_launches``), and each replay counts the
record again.

JAX caches programs on the model, and engines over one model share them,
because a jitted function takes its state as an argument. A graph binds
the buffers it was captured with, the engine's decode cache or the
trainer's slots, so here a :class:`ProgramCache` belongs to the engine or
trainer that owns those buffers.
"""

from __future__ import annotations

from typing import Callable, Hashable, Sequence

import torch

from bigdl_tpu_torch.kernels import _cuda


class ProgramCaptureError(RuntimeError):
    """Capturing a program's CUDA graph failed; the message names its key."""


class Program:
    """One path as a replayable program: ``fn(*inputs)`` over the static
    tensors ``inputs``. Call it after writing the inputs; it returns the
    outputs, valid until the next call."""

    def __init__(self, key: Hashable, fn: Callable,
                 inputs: Sequence[torch.Tensor], device, pool=None,
                 generators: Sequence[torch.Generator] = ()):
        self.key = key
        # CUDA generators other than the default one that ``fn`` draws
        # from: registered with the graph, so each replay draws anew
        self.generators = tuple(generators)
        self.inputs = tuple(inputs)
        self.device = torch.device(device)
        self.replays = 0
        self._fn = fn
        self._pool = pool
        self._graph = None
        self._outputs = None
        self._launches: dict = {}

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self):
        if self.device.type != "cuda":
            return self._fn(*self.inputs)
        if self._graph is None:
            return self._warm_up_and_capture()
        self._graph.replay()
        _cuda.replay_launches(self._launches)
        self.replays += 1
        return self._outputs

    def _warm_up_and_capture(self):
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = self._fn(*self.inputs)
            main.wait_stream(side)
            for t in _tensors(out):     # freed only after main's use
                t.record_stream(main)
            # the warm-up's freed blocks stay cached outside the graph's
            # pool: give them back before the capture allocates its own (a
            # full-width vision step needs tens of GB in each)
            main.synchronize()
            torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            capture = torch.cuda.Stream()
            # a capture that fails leaves the device's default generator
            # marked as capturing; its state is put back from this copy
            gen = torch.cuda.default_generators[torch.cuda.current_device()]
            gen_state = gen.clone_state()
            for g in self.generators:
                graph.register_generator_state(g)
            try:
                with _cuda.recording_launches(capture.cuda_stream) as rec, \
                        torch.cuda.graph(graph, pool=self._pool,
                                         stream=capture,
                                         capture_error_mode="thread_local"):
                    self._outputs = self._fn(*self.inputs)
            except Exception as e:
                gen.graphsafe_set_state(gen_state)
                raise ProgramCaptureError(
                    f"capturing program {self.key!r} failed: "
                    f"{type(e).__name__}: {e}") from e
            main.wait_stream(capture)
        self._graph = graph
        self._launches = rec
        return out


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


class ProgramCache:
    """The programs of one owner by key, and the keys it used: the ledger
    behind a serving engine's ``stats()["compiled_programs"]``. Programs of
    one cache never run at once, so on the card they share one memory pool
    (``torch.cuda.graph_pool_handle()``)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._programs: dict = {}
        self._used: dict = {}       # keys in first-use order
        self._pool = None

    def get_or_capture(self, key: Hashable,
                       build: Callable[[], tuple]) -> Program:
        """The program of ``key``. At the first use of the key, ``build()``
        returns ``(fn, inputs)``: the function and its static input
        tensors; the program is captured at its first call."""
        prog = self._programs.get(key)
        if prog is None:
            fn, inputs = build()
            if self.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            prog = Program(key, fn, inputs, self.device, self._pool)
            self._programs[key] = prog
        self._used.setdefault(key, None)
        return prog

    def drop(self, key: Hashable) -> None:
        """Forget the program of ``key`` and its use; its graph and outputs
        go with the last reference to it."""
        self._programs.pop(key, None)
        self._used.pop(key, None)

    @property
    def keys(self) -> list:
        """The keys used, in order of first use."""
        return list(self._used)
