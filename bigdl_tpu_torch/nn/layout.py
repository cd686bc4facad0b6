"""Image data layout policy: NCHW (the reference's default) or NHWC.

Counterpart of ``bigdl_tpu/nn/layout.py``, with the same names, the same
``BIGDL_IMAGE_FORMAT`` variable and the same rule: an explicit
``set_image_format`` wins, else the variable, else NCHW. The format is read
when a layer runs, so set it before building and running a model.

Activations keep JAX's logical shape in both formats: under NHWC a spatial
activation is (N, H, W, C), as JAX's is, so a parity test feeds both
packages the same array. Convolution weights stay OIHW in both (parameter
layouts never see the activation layout). The spatial layers hand PyTorch's
NCHW operators :func:`to_nchw` of an NHWC activation, a permuted view with
no copy: an NCHW-shaped tensor in ``channels_last`` memory, on which cuDNN
runs its channels-last kernels; :func:`from_nchw` permutes the result back.

Layers honouring the format: ``SpatialConvolution``,
``SpatialBatchNormalization``, ``SpatialMaxPooling``,
``SpatialAveragePooling``, ``ImageNormalize`` and the ResNet glue (type-A
shortcut, global average pool, space-to-depth stem).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

_FORMAT: Optional[str] = None

_VALID = ("NCHW", "NHWC")


def image_format() -> str:
    """Current image format: explicit ``set_image_format`` wins, else
    ``BIGDL_IMAGE_FORMAT`` (default NCHW)."""
    if _FORMAT is not None:
        return _FORMAT
    fmt = os.environ.get("BIGDL_IMAGE_FORMAT", "NCHW").upper()
    return fmt if fmt in _VALID else "NCHW"


def set_image_format(fmt: Optional[str]) -> None:
    """Set the process-wide image format (``None``: back to the variable or
    the default)."""
    global _FORMAT
    if fmt is not None:
        fmt = fmt.upper()
        if fmt not in _VALID:
            raise ValueError(f"image format must be one of {_VALID}, got "
                             f"{fmt!r}")
    _FORMAT = fmt


def is_nhwc() -> bool:
    return image_format() == "NHWC"


def channel_axis(ndim: int = 4) -> int:
    """Axis holding channels for a spatial tensor of ``ndim`` dims (4 =
    NCHW/NHWC, 3 = unbatched CHW/HWC)."""
    return ndim - 3 if not is_nhwc() else ndim - 1


def spatial_axes(ndim: int = 4) -> tuple[int, int]:
    """(H, W) axes for a spatial tensor of ``ndim`` dims."""
    if is_nhwc():
        return ndim - 3, ndim - 2
    return ndim - 2, ndim - 1


def bias_shape(n: int, ndim: int = 4) -> tuple[int, ...]:
    """Broadcast shape for a per-channel (n,) vector against a spatial
    tensor."""
    shape = [1] * ndim
    shape[channel_axis(ndim)] = n
    return tuple(shape)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """A 4-D activation as PyTorch's NCHW operators take it: itself under
    NCHW, a permuted view (channels-last memory, no copy) under NHWC."""
    return x.permute(0, 3, 1, 2) if is_nhwc() else x


def from_nchw(y: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_nchw` for an operator's NCHW-shaped
    result."""
    return y.permute(0, 2, 3, 1) if is_nhwc() else y


def pad_spatial(x: torch.Tensor, ph: tuple, pw: tuple,
                value: float = 0.0) -> torch.Tensor:
    """Pad a 4-D activation's spatial axes by (lo, hi) ``ph`` and ``pw``, in
    its own layout (an NHWC activation stays channels-last)."""
    if not any(ph + pw):
        return x
    spatial = (pw[0], pw[1], ph[0], ph[1])
    return F.pad(x, (0, 0) + spatial if is_nhwc() else spatial, value=value)
