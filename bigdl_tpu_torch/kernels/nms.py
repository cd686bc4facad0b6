"""Greedy NMS: the CUDA sweep kernel and its plain version.

Counterpart of the greedy pass of ``bigdl_tpu/nn/detection.py:56-79``
(``nms_mask``'s ``lax.fori_loop``). The kernel (``csrc/nms.cu``,
``bigdl_nms_sweep``) replaces no Pallas kernel: in PyTorch the loop would
be about four launches a step, thousands a call, so it is one launch for
a whole batch of rows (every class of every image of a call).
:func:`nms_sweep` takes the score-sorted IoU matrices ``(rows, K, K)``
fp32, the alive flags ``(rows, K)`` bool and the threshold, and returns
the keep flags ``(rows, K)`` bool. It launches the kernel for CUDA
tensors (or raises) and runs :func:`nms_sweep_reference`, JAX's loop
body, for CPU tensors only.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.kernels import _cuda

launches = _cuda.LaunchCounter("nms_sweep")


def nms_sweep_reference(iou: torch.Tensor, alive: torch.Tensor,
                        threshold: float) -> torch.Tensor:
    """JAX's greedy loop over a batch of rows: candidate i survives iff it
    is alive and no earlier survivor j < i has ``iou[j, i] > threshold``."""
    keep = alive.clone()
    for i in range(1, iou.shape[-1]):
        sup = (keep[:, :i] & (iou[:, :i, i] > threshold)).any(dim=1)
        keep[:, i] &= ~sup
    return keep


def _check(iou: torch.Tensor, alive: torch.Tensor) -> None:
    if iou.dim() != 3 or iou.shape[1] != iou.shape[2] \
            or tuple(alive.shape) != tuple(iou.shape[:2]):
        raise ValueError(f"nms_sweep takes iou (rows, K, K) and alive "
                         f"(rows, K), got {tuple(iou.shape)} and "
                         f"{tuple(alive.shape)}")
    if iou.dtype != torch.float32 or alive.dtype != torch.bool:
        raise ValueError(f"nms_sweep takes float32 iou and bool alive, got "
                         f"{iou.dtype} and {alive.dtype}")


def nms_sweep_cuda(iou: torch.Tensor, alive: torch.Tensor,
                   threshold: float) -> torch.Tensor:
    """Launch ``bigdl_nms_sweep`` on CUDA tensors: one CTA a row."""
    _check(iou, alive)
    if not (iou.is_cuda and alive.device == iou.device):
        raise ValueError(f"nms_sweep_cuda needs CUDA tensors on one device, "
                         f"got {iou.device} and {alive.device}")
    iou, alive = iou.contiguous(), alive.contiguous()
    keep = torch.empty_like(alive)
    lib = _cuda.library().lib
    stream = _cuda.stream_handle(iou)
    with torch.cuda.device(iou.device):
        code = lib.bigdl_nms_sweep(iou.data_ptr(), alive.data_ptr(),
                                   keep.data_ptr(), iou.shape[0],
                                   iou.shape[1], float(threshold), stream)
    _cuda.check(code, "nms_sweep")
    launches.add("float32", stream)
    return keep


def nms_sweep(iou: torch.Tensor, alive: torch.Tensor,
              threshold: float) -> torch.Tensor:
    """The keep flags of the greedy sweep: the kernel on the card, the
    plain version on the CPU."""
    if iou.is_cuda:
        return nms_sweep_cuda(iou, alive, threshold)
    if iou.device.type != "cpu":
        raise ValueError(f"nms_sweep runs on CUDA or CPU tensors, got "
                         f"{iou.device}")
    _check(iou, alive)
    return nms_sweep_reference(iou, alive, threshold)
