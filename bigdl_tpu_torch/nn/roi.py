"""Region-of-interest pooling.

Counterpart of ``bigdl_tpu/nn/roi.py``: RoiAlign semantics on a fixed
budget of bilinear sample points a bin, JAX's sampling points and clipping.
JAX's ``vmap`` over ROIs is one batched gather here: the feature maps
flattened to ``(N·H·W, C)`` rows, the four corners of every sample point of
every ROI gathered at once. ``mode='avg'`` is RoiAlign, ``'max'`` the max
over a bin's sample points.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.abstractnn import AbstractModule
from bigdl_tpu_torch.utils.table import Table


class RoiPooling(AbstractModule):
    """Input: Table ``(features (N, C, H, W), rois (R, 5))``, rows
    ``[batch_idx, x1, y1, x2, y2]`` in image coordinates (``spatial_scale``
    maps them onto the feature map). Output ``(R, C, pooled_h,
    pooled_w)``."""

    def __init__(self, pooled_h: int, pooled_w: int,
                 spatial_scale: float = 1.0, sampling_ratio: int = 2,
                 mode: str = "avg"):
        super().__init__()
        if mode not in ("avg", "max"):
            raise ValueError("mode must be 'avg' or 'max'")
        self.pooled_h, self.pooled_w = pooled_h, pooled_w
        self.spatial_scale = spatial_scale
        self.sampling_ratio = sampling_ratio
        self.mode = mode

    def _axis(self, lo, extent, pooled: int, limit: int):
        """Sample coordinates (R, pooled·ns) along one axis, clipped to the
        map, with their floor, upper neighbour and fraction."""
        ns = self.sampling_ratio
        i = torch.arange(pooled * ns, device=lo.device)
        b = torch.clamp(extent, min=1e-6) / pooled
        frac = (((i % ns) + 0.5) / ns).to(torch.float32)
        pos = lo[:, None] + (i // ns) * b[:, None] + frac * b[:, None]
        pos = torch.clamp(pos, 0.0, limit - 1.0)
        p0 = torch.floor(pos).to(torch.int64)
        return p0, torch.clamp(p0 + 1, max=limit - 1), pos - p0

    def run(self, input, state=None):
        xs = input.values() if isinstance(input, Table) else list(input)
        feats, rois = xs[0], xs[1]
        n, c, h, w = feats.shape
        ph, pw, ns = self.pooled_h, self.pooled_w, self.sampling_ratio
        r = rois.to(torch.float32)
        b = r[:, 0].to(torch.int64)
        x1, y1, x2, y2 = (r[:, 1:] * self.spatial_scale).unbind(-1)
        y0, y1i, wy = self._axis(y1, y2 - y1, ph, h)
        x0, x1i, wx = self._axis(x1, x2 - x1, pw, w)
        rows = feats.permute(0, 2, 3, 1).reshape(n * h * w, c)
        base = (b * (h * w))[:, None, None]

        def g(yy, xx):     # (R, ph·ns, pw·ns, C)
            return rows[base + yy[:, :, None] * w + xx[:, None, :]]

        wy, wx = wy[:, :, None, None], wx[:, None, :, None]
        samp = ((1 - wy) * (1 - wx) * g(y0, x0)
                + (1 - wy) * wx * g(y0, x1i)
                + wy * (1 - wx) * g(y1i, x0)
                + wy * wx * g(y1i, x1i))
        samp = samp.reshape(-1, ph, ns, pw, ns, c)
        out = samp.mean(dim=(2, 4)) if self.mode == "avg" \
            else samp.amax(dim=(2, 4))
        return out.permute(0, 3, 1, 2), state

    def extra_repr(self):
        return (f"{self.pooled_h}x{self.pooled_w}, "
                f"scale={self.spatial_scale}, {self.mode}")
