"""Greedy NMS: the two CUDA launches and their plain versions.

Counterpart of ``nms_mask`` in ``bigdl_tpu/nn/detection.py:56-79``:
``pairwise_iou`` of the score-sorted boxes, then the greedy
``lax.fori_loop``. The kernels (``csrc/nms.cu``) replace no Pallas kernel:
in PyTorch the loop would be about four launches a step, thousands a call,
so a whole batch of rows (every class of every image of a call) goes to
two launches:

- ``bigdl_nms_mask_words`` computes the suppression bits across the card:
  ``words`` (rows, K, W) int64, ``W = ceil(K / 64)``, bit ``b`` of
  ``words[r, j, w]`` set iff ``i = 64 w + b`` has ``j < i < K``, ``j`` and
  ``i`` both alive and ``pairwise_iou(boxes, boxes)[r, j, i] > threshold``.
  The (rows, K, K) IoU tensor is never formed, and no IoU of a dead
  candidate is computed.
- ``bigdl_nms_sweep_words`` runs the greedy pass over the words, one warp
  a row: candidate i survives iff it is alive and no earlier survivor j
  has bit i set in ``words[r, j]``.

:func:`nms_keep` takes the sorted boxes ``(rows, K, 4)`` fp32, the alive
flags ``(rows, K)`` bool and the threshold, and returns the keep flags
``(rows, K)`` bool. It launches both kernels for CUDA tensors (or raises)
and runs :func:`nms_keep_reference`, JAX's IoU and loop body, for CPU
tensors only. Only fp32 boxes reach it on the port's paths: the priors and
anchors are fp32 constants, and torch promotes bf16 deltas decoded
against them to fp32.

:func:`pairwise_iou` is the port's one IoU formula: ``nn.detection``
imports it, and the words kernel computes it operation by operation.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.kernels import _cuda

mask_launches = _cuda.LaunchCounter("nms_mask_words")
launches = _cuda.LaunchCounter("nms_sweep")

#: candidates a row the kernels take (``kMaxK`` in ``csrc/nms.cu`` guards
#: the C entries)
MAX_K = 32768
_BITS = 64


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU matrix of corner-form boxes: (..., A, 4) × (..., B, 4) →
    (..., A, B), JAX's arithmetic element by element."""
    ax1, ay1, ax2, ay2 = (v[..., :, None] for v in boxes_a.unbind(-1))
    bx1, by1, bx2, by2 = (v[..., None, :] for v in boxes_b.unbind(-1))
    ix1 = torch.maximum(ax1, bx1)
    iy1 = torch.maximum(ay1, by1)
    ix2 = torch.minimum(ax2, bx2)
    iy2 = torch.minimum(ay2, by2)
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    area_a = (ax2 - ax1).clamp(min=0) * (ay2 - ay1).clamp(min=0)
    area_b = (bx2 - bx1).clamp(min=0) * (by2 - by1).clamp(min=0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def words_per_row(k: int) -> int:
    return -(-k // _BITS)


def nms_sweep_reference(iou: torch.Tensor, alive: torch.Tensor,
                        threshold: float) -> torch.Tensor:
    """JAX's greedy loop over a batch of rows: candidate i survives iff it
    is alive and no earlier survivor j < i has ``iou[j, i] > threshold``."""
    keep = alive.clone()
    for i in range(1, iou.shape[-1]):
        sup = (keep[:, :i] & (iou[:, :i, i] > threshold)).any(dim=1)
        keep[:, i] &= ~sup
    return keep


def nms_keep_reference(boxes: torch.Tensor, alive: torch.Tensor,
                       threshold: float) -> torch.Tensor:
    """The keep flags as JAX computes them: the IoU matrix of the sorted
    boxes (in their dtype, then fp32), then the greedy loop."""
    return nms_sweep_reference(pairwise_iou(boxes, boxes).float(), alive,
                               threshold)


def nms_mask_words_reference(boxes: torch.Tensor, alive: torch.Tensor,
                             threshold: float) -> torch.Tensor:
    """The suppression words of ``boxes`` (rows, K, 4) and their alive
    flags (rows, K): the bits of ``pairwise_iou(boxes, boxes) > threshold``
    above the diagonal between alive candidates, 64 to a little-endian
    int64 word, the last word of a row zero-padded."""
    rows, k = boxes.shape[:2]
    w = words_per_row(k)
    idx = torch.arange(k, device=boxes.device)
    bits = (pairwise_iou(boxes, boxes).float() > threshold) \
        & (idx[None, :] > idx[:, None]) & alive[:, :, None] & alive[:, None]
    bits = torch.nn.functional.pad(bits, (0, w * _BITS - k)) \
        .reshape(rows, k, w, _BITS)
    words = torch.zeros((rows, k, w), dtype=torch.int64, device=boxes.device)
    for b in range(_BITS):
        words |= bits[..., b].to(torch.int64) << b
    return words


def nms_sweep_words_reference(words: torch.Tensor,
                              alive: torch.Tensor) -> torch.Tensor:
    """The greedy loop over suppression words: candidate i survives iff it
    is alive and no earlier survivor j < i has bit i set in ``words[j]``."""
    rows, k = alive.shape
    bits = torch.empty((rows, k, words.shape[-1] * _BITS), dtype=torch.bool,
                       device=words.device)
    for b in range(_BITS):
        bits[..., b::_BITS] = (words >> b) & 1
    return nms_sweep_reference(bits[..., :k].float(), alive, 0.5)


def _check_boxes(boxes: torch.Tensor, name: str, card: bool) -> None:
    """Boxes (rows, K, 4): fp32 and K <= MAX_K for the kernels (``card``),
    any floating dtype for the plain version (JAX computes in the boxes'
    dtype)."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"{name} takes boxes (rows, K, 4), got "
                         f"{tuple(boxes.shape)}")
    if not boxes.is_floating_point() or (
            card and boxes.dtype != torch.float32):
        raise ValueError(f"{name} takes float32 boxes, got {boxes.dtype}")
    if card and boxes.shape[1] > MAX_K:
        raise ValueError(f"{name} takes at most {MAX_K} candidates a row, "
                         f"got {boxes.shape[1]}")


def _check_alive(alive: torch.Tensor, rows: int, k: int, name: str) -> None:
    if tuple(alive.shape) != (rows, k):
        raise ValueError(f"{name} takes alive (rows, K) = {(rows, k)}, got "
                         f"{tuple(alive.shape)}")
    if alive.dtype != torch.bool:
        raise ValueError(f"{name} takes bool alive, got {alive.dtype}")


def _on_card(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if not (tensors[0].is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")


def nms_mask_words_cuda(boxes: torch.Tensor, alive: torch.Tensor,
                        threshold: float) -> torch.Tensor:
    """Launch ``bigdl_nms_mask_words`` on CUDA boxes (rows, K, 4) fp32 and
    their alive flags (rows, K) bool: the suppression words
    (rows, K, ceil(K/64)) int64."""
    _check_boxes(boxes, "nms_mask_words_cuda", True)
    _check_alive(alive, *boxes.shape[:2], "nms_mask_words_cuda")
    _on_card("nms_mask_words_cuda", boxes, alive)
    rows, k = boxes.shape[:2]
    boxes, alive = boxes.contiguous(), alive.contiguous()
    if boxes.data_ptr() % 16:   # the kernel reads a box as one float4
        boxes = boxes.clone()
    words = torch.empty((rows, k, words_per_row(k)), dtype=torch.int64,
                        device=boxes.device)
    if words.numel() == 0:
        return words
    stream = _cuda.stream_handle(boxes)
    with torch.cuda.device(boxes.device):
        code = _cuda.library().lib.bigdl_nms_mask_words(
            boxes.data_ptr(), alive.data_ptr(), words.data_ptr(), rows, k,
            float(threshold), stream)
    _cuda.check(code, "nms_mask_words")
    mask_launches.add("float32", stream)
    return words


def nms_sweep_words_cuda(words: torch.Tensor,
                         alive: torch.Tensor) -> torch.Tensor:
    """Launch ``bigdl_nms_sweep_words`` on CUDA words and alive flags: the
    keep flags (rows, K) bool."""
    if words.dim() != 3 or alive.dim() != 2:
        raise ValueError(f"nms_sweep_words_cuda takes words (rows, K, "
                         f"ceil(K/64)) and alive (rows, K), got "
                         f"{tuple(words.shape)} and {tuple(alive.shape)}")
    rows, k = words.shape[:2]
    if words.shape[2] != words_per_row(k) or words.dtype != torch.int64:
        raise ValueError(f"nms_sweep_words_cuda takes int64 words (rows, K, "
                         f"ceil(K/64)) for K = {k}, got {words.dtype} "
                         f"{tuple(words.shape)}")
    _check_alive(alive, rows, k, "nms_sweep_words_cuda")
    _on_card("nms_sweep_words_cuda", words, alive)
    words, alive = words.contiguous(), alive.contiguous()
    keep = torch.empty_like(alive)
    if keep.numel() == 0:
        return keep
    stream = _cuda.stream_handle(words)
    with torch.cuda.device(words.device):
        code = _cuda.library().lib.bigdl_nms_sweep_words(
            words.data_ptr(), alive.data_ptr(), keep.data_ptr(),
            rows, k, stream)
    _cuda.check(code, "nms_sweep")
    launches.add("float32", stream)
    return keep


def nms_keep_cuda(boxes: torch.Tensor, alive: torch.Tensor,
                  threshold: float) -> torch.Tensor:
    """The keep flags of the sorted boxes on the card: the words, then the
    sweep (two launches, each checking its inputs)."""
    return nms_sweep_words_cuda(nms_mask_words_cuda(boxes, alive, threshold),
                                alive)


def nms_keep(boxes: torch.Tensor, alive: torch.Tensor,
             threshold: float) -> torch.Tensor:
    """The greedy keep flags of score-sorted boxes (rows, K, 4) fp32 and
    their alive flags (rows, K) bool: the kernels on the card, the plain
    version on the CPU."""
    if boxes.is_cuda:
        return nms_keep_cuda(boxes, alive, threshold)
    if boxes.device.type != "cpu":
        raise ValueError(f"nms_keep runs on CUDA or CPU tensors, got "
                         f"{boxes.device}")
    _check_boxes(boxes, "nms_keep", False)
    _check_alive(alive, *boxes.shape[:2], "nms_keep")
    return nms_keep_reference(boxes, alive, threshold)
