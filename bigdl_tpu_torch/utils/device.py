"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and a missing card raises instead of quietly running
on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    return dev


def require_on(module: torch.nn.Module, device=None) -> torch.device:
    """Resolve ``device`` and check that ``module`` lives there."""
    dev = resolve_device(device)
    have = next(module.parameters()).device
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"the model lives on {have}, not on {dev}: move it "
                         f"or pass device={str(have)!r}")
    return have


def wait_for_stream(t: torch.Tensor) -> None:
    """Wait for the current stream's queued work before a host read of
    ``t``, with an event when ``t`` lies on the card: a blocking copy to
    pageable host memory (``tolist``, ``cpu``) holds up the CUDA calls of
    every other thread, the feed producer's copies among them, for as long
    as it waits; an event's wait does not."""
    if t.is_cuda:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
