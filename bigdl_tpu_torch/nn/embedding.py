"""Embedding lookup.

Counterpart of ``bigdl_tpu/nn/embedding.py``: ``LookupTable`` maps ids to
the rows of a (n_index, n_output) weight drawn from N(0, 1) by default. Ids
are 1-based (Torch's convention) unless ``zero_based=True``, as in JAX; the
language model passes ``zero_based=True``. ``padding_value`` masks the
embedding of that id to zeros, with JAX's rule: in 1-based mode
``padding_value=0`` means no padding row (ids start at 1).

``max_norm`` (with ``norm_type``) is JAX's functional renorm
(``_renorm``, ``bigdl_tpu/nn/embedding.py:132``): each gathered row is
scaled by ``min(1, max_norm / (‖row‖ + 1e-7))``, the gradient flows
through the scale, and the weight itself is never changed. The renorm is
row-local, so the port scales the gathered rows, not the whole table
(``F.embedding(max_norm=)`` renormalizes the weight in place, a different
result). ``should_scale_grad_by_freq`` is accepted and unused, as in JAX.

``HashBucketEmbedding`` hashes arbitrary non-negative ids into
``n_buckets`` rows with JAX's murmur3 finalizer (``:184-193``), always
zero-based. JAX multiplies in ``uint32`` with wraparound; torch's
``uint32`` lacks CUDA arithmetic, so the port computes in ``int64`` and
keeps the low 32 bits after each product: the same bucket for every id in
[0, 2^32).

The lookup is split into ``_ids`` (ids to 0-based rows), ``_renorm_rows``
and ``_mask_padding`` so that ``parallel/embedding.ShardedEmbedding`` runs
the same arithmetic on its deduplicated rows.

``BIGDL_CHECK_IDS=1`` guards the ids (JAX's ``:45-63``, ``:98-110``): an id
outside ``[0, n_index)`` after the base adjustment raises JAX's
``IndexError`` naming the table's size and the ids' span. Inside
:func:`checkify_ids_scope` (the trainer's checked step,
``set_check_numerics``) the guard reads nothing back: it records a device
flag with the ids' span (:func:`ids_flags`), which the trainer fetches with
the step's loss and raises on after the step (the ids clamped into the
table meanwhile, as JAX's gather clamps); a captured program outside
that scope is not checked, as JAX's traced guard outside checkify is not.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.initialization import InitializationMethod, RandomNormal

_MASK32 = 0xFFFFFFFF

_IDS_CHECK_SCOPE = threading.local()


@contextlib.contextmanager
def checkify_ids_scope():
    """While active (per thread), the ``BIGDL_CHECK_IDS=1`` guard records a
    device flag a lookup instead of reading the ids back; yields the list
    the flags go to (``(table, bad, min, max)``, tensors on the ids'
    device)."""
    prev = getattr(_IDS_CHECK_SCOPE, "active", None)
    _IDS_CHECK_SCOPE.active = flags = []
    try:
        yield flags
    finally:
        _IDS_CHECK_SCOPE.active = prev


def _ids_scope_active() -> bool:
    return getattr(_IDS_CHECK_SCOPE, "active", None) is not None


def check_ids_enabled() -> bool:
    return os.environ.get("BIGDL_CHECK_IDS", "0") == "1"


def ids_error(table: str, n_index: int, mn: int, mx: int) -> IndexError:
    """JAX's eager out-of-range error."""
    return IndexError(
        f"{table}: ids out of range — after base adjustment indices "
        f"span [{mn}, {mx}] but the table has {n_index} rows (valid range "
        f"[0, {n_index})). A jitted gather would silently clamp these "
        "(BIGDL_CHECK_IDS=1 caught it).")


def ids_flags(flags: list, like: torch.Tensor) -> torch.Tensor:
    """The recorded flags of a checked step as one fp32 vector ``[bad,
    which, min, max]``: ``which`` the position in ``flags`` of the first
    lookup whose ids were out of range (zeros when none was), without a
    host read."""
    out = torch.zeros(4, dtype=torch.float32, device=like.device)
    for k in reversed(range(len(flags))):
        _, _, bad, mn, mx = flags[k]
        row = torch.stack([bad.float(), torch.full_like(
            mn, k, dtype=torch.float32), mn.float(), mx.float()])
        out = torch.where(bad, row, out)
    return out


def ids_check_error(flags: list, vec) -> IndexError:
    """JAX's error of the checked step (its ``checkify`` message) from a
    fetched :func:`ids_flags` vector."""
    table, n, _, _, _ = flags[int(vec[1])]
    return IndexError(
        f"{table}: id out of range [0, {n}) after base adjustment "
        f"(min={int(vec[2])}, max={int(vec[3])})")


class LookupTable(TensorModule):
    def __init__(self, n_index: int, n_output: int,
                 padding_value: Optional[float] = None,
                 max_norm: float = math.inf, norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False,
                 w_init: Optional[InitializationMethod] = None,
                 zero_based: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.should_scale_grad_by_freq = should_scale_grad_by_freq
        self.zero_based = zero_based
        w_init = w_init or RandomNormal(0.0, 1.0)
        self.weight = torch.nn.Parameter(w_init.init(
            (n_index, n_output), fan_in=n_index, fan_out=n_output,
            generator=generator))

    def _ids(self, input) -> torch.Tensor:
        """Raw ids -> 0-based int64 row indices (guarded when enabled)."""
        idx = input.long()
        idx = idx if self.zero_based else idx - 1
        if check_ids_enabled():
            idx = self._guard_ids(idx)
        return idx

    def _guard_ids(self, idx: torch.Tensor) -> torch.Tensor:
        """``idx`` checked: raises eagerly; inside the checked step records
        the flag and clamps the ids into the table (JAX's gather clamps), so
        the step completes and the trainer raises after it."""
        if idx.numel() == 0:
            return idx
        if _ids_scope_active():
            mn, mx = idx.min(), idx.max()
            _IDS_CHECK_SCOPE.active.append(
                (repr(self), self.n_index, (mn < 0) | (mx >= self.n_index),
                 mn, mx))
            return idx.clamp(0, self.n_index - 1)
        if idx.is_cuda and torch.cuda.is_current_stream_capturing():
            return idx
        mn, mx = int(idx.min()), int(idx.max())
        if mn < 0 or mx >= self.n_index:
            raise ids_error(repr(self), self.n_index, mn, mx)
        return idx

    def _pad_index(self) -> Optional[int]:
        """The padding row as a 0-based index, or None when masking is
        off."""
        if self.padding_value is None:
            return None
        p = int(self.padding_value)
        if not self.zero_based:
            return None if p == 0 else p - 1
        return p

    def _renorm_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """JAX's max-norm renorm of gathered rows (each by its own norm)."""
        if self.max_norm == math.inf:
            return rows
        norms = rows.abs().pow(self.norm_type).sum(
            -1, keepdim=True).pow(1.0 / self.norm_type)
        scale = (self.max_norm / (norms + 1e-7)).clamp(max=1.0)
        return rows * scale

    def _mask_padding(self, out: torch.Tensor, idx) -> torch.Tensor:
        pad = self._pad_index()
        if pad is None:
            return out
        return out.masked_fill((idx == pad)[..., None], 0.0)

    def run(self, input, state=None):
        idx = self._ids(input)
        out = self._renorm_rows(F.embedding(idx, self.weight))
        return self._mask_padding(out, idx), state

    def extra_repr(self):
        return f"{self.n_index} -> {self.n_output}"


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h · c mod 2^32`` for ``h`` in [0, 2^32) (int64) and a 32-bit
    constant, without an int64 overflow: c's two 16-bit halves, each
    partial product below 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK32


class HashBucketEmbedding(LookupTable):
    """Embedding over hashed ids: any non-negative integer id is mixed by
    the murmur3 finalizer and mapped into ``n_buckets`` rows (the hashing
    trick for out-of-vocabulary users and items). Always zero-based."""

    def __init__(self, n_buckets: int, n_output: int,
                 w_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_buckets, n_output, w_init=w_init, zero_based=True,
                         generator=generator)

    def _ids(self, input) -> torch.Tensor:
        h = input.long() & _MASK32
        h = h ^ (h >> 16)
        h = _mul32(h, 0x85EBCA6B)
        h = h ^ (h >> 13)
        h = _mul32(h, 0xC2B2AE35)
        return (h ^ (h >> 16)) % self.n_index

    def extra_repr(self):
        return f"{self.n_index} buckets -> {self.n_output}"
