"""Normalization layers: LayerNorm, RMSNorm and Dropout.

Counterpart of ``bigdl_tpu/nn/normalization.py``:

- ``LayerNorm``: weight ones, bias zeros, eps 1e-5; every call goes through
  ``kernels.fused_layer_norm`` (the kernel on CUDA tensors, its plain
  version on CPU tensors);
- ``RMSNorm``: weight ones, eps 1e-6, JAX's rounding: the mean of squares
  in fp32, ``rsqrt(ms + eps)`` cast to the input's dtype, then
  ``input * that * weight`` (plain torch ops: it is jnp in JAX);
- ``Dropout``: inverted dropout in training mode, identity in eval mode or
  at p = 0. The mask is ``uniform < 1 - p`` drawn from ``generator`` (the
  default generator of the input's device when None). Under a captured
  training step (``utils/programs.py``) every replay draws a fresh mask:
  the default CUDA generator is tracked by the capture, and the trainer
  registers an explicit CUDA generator with the graph
  (:func:`dropout_generators`). Under rematerialisation
  (``nn.Remat``, ``set_remat``) the recomputation must see the masks of
  the forward, as JAX's explicit keys give it: the checkpoint's contexts
  (:func:`checkpoint_contexts`) keep each mask the forward drew and hand
  it back to the recomputation, so no generator state is read or restored
  (which a capture forbids).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch

from bigdl_tpu_torch.kernels import fused_layer_norm
from bigdl_tpu_torch.nn.abstractnn import TensorModule


class LayerNorm(TensorModule):
    def __init__(self, n_output: int, eps: float = 1e-5):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(n_output))
        self.bias = torch.nn.Parameter(torch.zeros(n_output))

    def run(self, input, state=None):
        return fused_layer_norm(input, self.weight, self.bias, self.eps), state

    def extra_repr(self):
        return f"{self.n_output}, eps={self.eps}"


class RMSNorm(TensorModule):
    """Root-mean-square norm over the last axis (no centering, no bias)."""

    def __init__(self, n_output: int, eps: float = 1e-6):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(n_output))

    def run(self, input, state=None):
        ms = input.float().square().mean(dim=-1, keepdim=True)
        out = input * torch.rsqrt(ms + self.eps).to(input.dtype)
        return out * self.weight, state

    def extra_repr(self):
        return f"{self.n_output}, eps={self.eps}"


# the mask tapes of the checkpoints now running on this thread, innermost
# last: ("record", masks) while a checkpointed forward runs, ("replay",
# masks) while its recomputation runs
_TAPES = threading.local()


def _tapes() -> list:
    if not hasattr(_TAPES, "stack"):
        _TAPES.stack = []
    return _TAPES.stack


@contextlib.contextmanager
def _tape(mode: str, masks: list):
    stack = _tapes()
    stack.append((mode, masks))
    try:
        yield
    finally:
        stack.pop()


def _draw_mask(draw: Callable[[], torch.Tensor]) -> torch.Tensor:
    """A dropout mask: handed back by the innermost recomputation, or
    drawn; recorded by every checkpointed forward inside that."""
    stack = _tapes()
    start, mask = 0, None
    for i in range(len(stack) - 1, -1, -1):
        mode, masks = stack[i]
        if mode == "replay":
            mask, start = masks.pop(0), i + 1
            break
    if mask is None:
        mask = draw()
    for mode, masks in stack[start:]:
        masks.append(mask)
    return mask


def checkpoint_contexts(inner: Optional[Callable[[], tuple]] = None
                        ) -> tuple:
    """A ``context_fn`` for ``torch.utils.checkpoint``: the forward's
    context records the dropout masks drawn under it, the recomputation's
    hands them back in order. ``inner`` is another ``context_fn`` whose
    contexts are entered too (the selective policy of remat "dots")."""
    masks: list = []
    fwd, rec = inner() if inner is not None else (
        contextlib.nullcontext(), contextlib.nullcontext())
    return (_joined(fwd, _tape("record", masks)),
            _joined(rec, _tape("replay", masks)))


@contextlib.contextmanager
def _joined(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


class Dropout(TensorModule):
    """Inverted dropout (reference ``nn.Dropout``): in training mode each
    element is kept with probability ``1 - p`` and, with ``scale``, divided
    by it."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_p(init_p)
        self.p = init_p
        self.scale = scale
        self.generator = generator

    def set_p(self, p: float) -> "Dropout":
        _check_p(p)
        self.p = p
        return self

    def run(self, input, state=None):
        if not self.training or self.p == 0.0:
            return input, state
        keep = 1.0 - self.p
        mask = _draw_mask(lambda: torch.rand(
            input.shape, generator=self.generator,
            device=input.device) < keep)
        out = input.masked_fill(~mask, 0.0)
        if self.scale:
            out = out / keep
        return out, state

    def extra_repr(self):
        return f"p={self.p}"


def _check_p(p: float) -> None:
    if not 0.0 <= p < 1.0:
        raise ValueError("dropout probability must be in [0, 1)")


def dropout_generators(model: torch.nn.Module) -> list:
    """The explicit CUDA generators of ``model``'s Dropout layers, which a
    captured program must register with its graph."""
    gens = []
    for m in model.modules():
        g = m.generator if isinstance(m, Dropout) else None
        if g is not None and g.device.type == "cuda" and \
                all(g is not h for h in gens):
            gens.append(g)
    return gens
