"""Object-detection layers: the SSD and Faster R-CNN heads.

Counterpart of ``bigdl_tpu/nn/detection.py``. JAX keeps every
data-dependent count as a static budget with a validity mask, and so does
the port: no call reads a tensor on the host, so the whole post-processing
chain can be captured into one CUDA graph.

- Priors and anchors depend only on the feature map's shape: numpy at the
  first call, kept on each device after that (:class:`_Constants`, the
  device copy made once, outside any capture after the warm-up run).
- ``jnp.argsort`` is stable and ``lax.top_k`` puts the lower index first
  among equal values; ``torch.topk`` on the card promises neither, so every
  order that can reach an output is ``torch.sort(..., stable=True)``.
- ``jnp.nonzero(keep, size=n, fill_value=-1)`` is a cumsum and a scatter
  (``torch.nonzero`` reads the count on the host).
- ``jax.vmap`` over classes and images is a batch dimension written out:
  :func:`nms_mask` takes leading batch dimensions, so all of a call's rows
  (every class of every image) go to one launch of each NMS kernel
  (``kernels/nms.py``, ``csrc/nms.cu``). ``pairwise_iou`` is defined
  beside those kernels, whose suppression words compute it op by op, and
  is imported here.
- ``-inf`` padding and ``isfinite`` masks pass through unchanged.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.kernels.nms import nms_keep, pairwise_iou
from bigdl_tpu_torch.nn import layout
from bigdl_tpu_torch.nn.abstractnn import AbstractModule
from bigdl_tpu_torch.nn.criterion import _OnDevice
from bigdl_tpu_torch.utils.table import Table


class _Constants:
    """Constant arrays by key, each made once in numpy and copied to a
    device once (``nn/criterion._OnDevice``)."""

    def __init__(self):
        self._by_key: dict = {}

    def get(self, key, make, device) -> torch.Tensor:
        c = self._by_key.get(key)
        if c is None:
            c = self._by_key[key] = _OnDevice(make())
        return c.on(device)


def _unregistered(owner: torch.nn.Module, name: str, value) -> None:
    """Keep a helper module off the parameter tree (JAX holds it as a
    plain attribute, outside ``modules``)."""
    object.__setattr__(owner, name, value)


# --------------------------------------------------------------------- utils

def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` per batch row: x (..., K, D), idx (..., M)."""
    return x.gather(-2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def sort_desc(x: torch.Tensor, k: Optional[int] = None):
    """``lax.top_k`` along the last axis: values descending, the lower index
    first among equal values (a stable sort), the first ``k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return (vals, idx) if k is None else (vals[..., :k], idx[..., :k])


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: Optional[torch.Tensor] = None):
    """Greedy NMS over fixed-size candidate lists.

    ``boxes`` (..., K, 4), ``scores`` (..., K): any leading batch
    dimensions, every row one list. Returns ``(order, keep)``: ``order``
    (..., K) the score-descending candidate indices (``jnp.argsort(-s)``:
    stable) and ``keep`` (..., K) bool aligned with it. ``valid`` masks
    padding candidates out before sorting. On the card, the sorted boxes
    go to the NMS kernels (``kernels.nms.nms_keep``: the suppression words,
    then the sweep; two launches for all rows, no (..., K, K) IoU tensor).
    """
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, -math.inf))
    order = torch.sort(-scores, dim=-1, stable=True).indices
    sb = _gather_rows(boxes, order)
    alive = torch.isfinite(scores.gather(-1, order))
    lead, k = order.shape[:-1], order.shape[-1]
    keep = nms_keep(sb.reshape(-1, k, 4), alive.reshape(-1, k),
                    float(iou_threshold))
    return order, keep.reshape(*lead, k)


def _centers(b: torch.Tensor):
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return w, h, (b[..., 0] + b[..., 2]) * 0.5, (b[..., 1] + b[..., 3]) * 0.5


def decode_ssd(priors: torch.Tensor, variances: torch.Tensor,
               deltas: torch.Tensor) -> torch.Tensor:
    """Caffe/SSD decode: corner-form priors (…, P, 4) and variance-scaled
    center-size deltas (…, P, 4) → corner-form boxes (…, P, 4)."""
    pw, ph, pcx, pcy = _centers(priors)
    dx, dy, dw, dh = deltas.unbind(-1)
    vx, vy, vw, vh = variances.unbind(-1)
    cx = pcx + dx * vx * pw
    cy = pcy + dy * vy * ph
    w = pw * torch.exp(dw * vw)
    h = ph * torch.exp(dh * vh)
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5,
                        cy + h * 0.5], dim=-1)


def encode_ssd(priors: torch.Tensor, variances: torch.Tensor,
               boxes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`decode_ssd`: the training targets of
    ``MultiBoxCriterion``."""
    pw, ph, pcx, pcy = _centers(priors)
    bw = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-8)
    bh = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-8)
    bcx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    bcy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    dx = (bcx - pcx) / pw / variances[..., 0]
    dy = (bcy - pcy) / ph / variances[..., 1]
    dw = torch.log(bw / pw) / variances[..., 2]
    dh = torch.log(bh / ph) / variances[..., 3]
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_rcnn(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Faster R-CNN decode (unit variances, the +1 width convention)."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + aw * 0.5
    acy = anchors[..., 1] + ah * 0.5
    cx = acx + deltas[..., 0] * aw
    cy = acy + deltas[..., 1] * ah
    w = aw * torch.exp(deltas[..., 2])
    h = ah * torch.exp(deltas[..., 3])
    return torch.stack([cx - w * 0.5, cy - h * 0.5,
                        cx + w * 0.5 - 1.0, cy + h * 0.5 - 1.0], dim=-1)


def _generate_base_anchors(base_size: float, ratios: Sequence[float],
                           scales: Sequence[float]) -> np.ndarray:
    """py-faster-rcnn's base anchors: (len(ratios)·len(scales), 4) corner
    boxes centred on the base box (JAX's numpy, line for line)."""
    w = h = float(base_size)
    cx = (w - 1.0) * 0.5
    cy = (h - 1.0) * 0.5
    out = []
    for r in ratios:
        size = w * h
        ws = round(math.sqrt(size / r))
        hs = round(ws * r)
        for s in scales:
            sw, sh = ws * s, hs * s
            out.append([cx - (sw - 1) * 0.5, cy - (sh - 1) * 0.5,
                        cx + (sw - 1) * 0.5, cy + (sh - 1) * 0.5])
    return np.array(out, dtype=np.float32)


def clip_boxes(boxes: torch.Tensor, img_h, img_w) -> torch.Tensor:
    """``jnp.clip`` of each corner to the image: x to [0, w-1], y to
    [0, h-1] (``img_h``/``img_w`` 0-d tensors)."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    xmax, ymax = img_w - 1, img_h - 1
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([torch.minimum(torch.maximum(x1, zero), xmax),
                        torch.minimum(torch.maximum(y1, zero), ymax),
                        torch.minimum(torch.maximum(x2, zero), xmax),
                        torch.minimum(torch.maximum(y2, zero), ymax)], dim=-1)


# -------------------------------------------------------------------- layers

class NormalizeScale(AbstractModule):
    """Channelwise Lp normalisation with a learned per-channel scale (SSD's
    conv4_3 trick); the channel axis follows ``nn/layout.py`` for 4-D
    input, else the last. ``weight[c]`` starts at ``scale``."""

    def __init__(self, p: float = 2.0, eps: float = 1e-10, scale: float = 20.0,
                 size: Optional[int] = None, w_regularizer=None):
        super().__init__()
        self.p, self.eps, self.scale = float(p), float(eps), float(scale)
        self.size = size
        self.w_regularizer = w_regularizer
        self.weight = (torch.nn.Parameter(torch.full((int(size),), self.scale))
                       if size is not None else None)

    def reset(self):
        if self.weight is not None:
            with torch.no_grad():
                self.weight.fill_(self.scale)

    def run(self, input, state=None):
        ca = layout.channel_axis(input.dim()) if input.dim() == 4 else -1
        if self.p == 2.0:
            norm = torch.sqrt(input.square().sum(ca, keepdim=True) + self.eps)
        else:
            norm = torch.pow(input.abs().pow(self.p).sum(ca, keepdim=True)
                             + self.eps, 1.0 / self.p)
        out = input / norm
        if self.weight is not None:
            shape = [1] * input.dim()
            shape[ca] = self.weight.shape[0]
            out = out * self.weight.reshape(shape)
        else:
            out = out * self.scale
        return out, state

    def extra_repr(self):
        return f"p={self.p}, scale={self.scale}, size={self.size}"


class PriorBox(AbstractModule):
    """SSD default boxes over a feature map: ``(1, 2, H·W·num_priors·4)``,
    row 0 the normalised corner-form priors, row 1 the variances (Caffe's
    layout). A constant of the map's shape, on the map's device."""

    def __init__(self, min_sizes: Sequence[float],
                 max_sizes: Optional[Sequence[float]] = None,
                 aspect_ratios: Sequence[float] = (),
                 flip: bool = True, clip: bool = False,
                 variances: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 step: float = 0.0, offset: float = 0.5,
                 img_h: int = 0, img_w: int = 0):
        super().__init__()
        self.min_sizes = [float(s) for s in min_sizes]
        self.max_sizes = [float(s) for s in (max_sizes or [])]
        if self.max_sizes and len(self.max_sizes) != len(self.min_sizes):
            raise ValueError("max_sizes must pair 1:1 with min_sizes")
        ars = [1.0]
        for ar in aspect_ratios:
            if any(abs(ar - a) < 1e-6 for a in ars):
                continue
            ars.append(float(ar))
            if flip:
                ars.append(1.0 / float(ar))
        self.aspect_ratios = ars
        self.clip = clip
        self.variances = [float(v) for v in variances]
        self.step = float(step)
        self.offset = float(offset)
        self.img_h, self.img_w = int(img_h), int(img_w)
        _unregistered(self, "_consts", _Constants())

    @property
    def num_priors(self) -> int:
        return len(self.min_sizes) * len(self.aspect_ratios) \
            + len(self.max_sizes)

    def _compute(self, layer_h: int, layer_w: int) -> np.ndarray:
        img_h, img_w = self.img_h, self.img_w
        if img_h <= 0 or img_w <= 0:
            raise ValueError("PriorBox needs img_h/img_w (network input size)")
        step_h = step_w = self.step
        if step_h <= 0:
            step_h = img_h / layer_h
            step_w = img_w / layer_w
        priors = []
        for y in range(layer_h):
            for x in range(layer_w):
                cx = (x + self.offset) * step_w
                cy = (y + self.offset) * step_h
                for i, ms in enumerate(self.min_sizes):
                    for j, ar in enumerate(self.aspect_ratios):
                        bw = ms * math.sqrt(ar)
                        bh = ms / math.sqrt(ar)
                        priors.append([(cx - bw / 2) / img_w,
                                       (cy - bh / 2) / img_h,
                                       (cx + bw / 2) / img_w,
                                       (cy + bh / 2) / img_h])
                        if j == 0 and self.max_sizes:
                            s = math.sqrt(ms * self.max_sizes[i])
                            priors.append([(cx - s / 2) / img_w,
                                           (cy - s / 2) / img_h,
                                           (cx + s / 2) / img_w,
                                           (cy + s / 2) / img_h])
        arr = np.array(priors, dtype=np.float32)
        if self.clip:
            arr = np.clip(arr, 0.0, 1.0)
        return arr

    def _wire(self, layer_h: int, layer_w: int) -> np.ndarray:
        priors = self._compute(layer_h, layer_w).reshape(-1)
        var = np.tile(np.array(self.variances, np.float32),
                      priors.shape[0] // 4)
        return np.stack([priors, var])[None]             # (1, 2, P*4)

    def run(self, input, state=None):
        if input.dim() != 4:
            raise ValueError("PriorBox expects a 4-D feature map")
        hax, wax = layout.spatial_axes(4)
        h, w = int(input.shape[hax]), int(input.shape[wax])
        return self._consts.get((h, w), lambda: self._wire(h, w),
                                input.device), state

    def extra_repr(self):
        return (f"min={self.min_sizes}, max={self.max_sizes}, "
                f"ars={self.aspect_ratios}, num_priors={self.num_priors}")


class Anchor(AbstractModule):
    """RPN anchors: every base anchor shifted over the feature grid,
    ``(h·w·A, 4)`` image-space corner boxes, row-major over (y, x, a)."""

    def __init__(self, ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 scales: Sequence[float] = (8.0, 16.0, 32.0),
                 base_size: float = 16.0):
        super().__init__()
        self.ratios = [float(r) for r in ratios]
        self.scales = [float(s) for s in scales]
        self.base_size = float(base_size)
        self._base = _generate_base_anchors(base_size, self.ratios,
                                            self.scales)
        _unregistered(self, "_consts", _Constants())

    @property
    def num_anchors(self) -> int:
        return len(self.ratios) * len(self.scales)

    def generate(self, height: int, width: int,
                 stride: Optional[float] = None) -> np.ndarray:
        stride = float(stride if stride is not None else self.base_size)
        sx = np.arange(width, dtype=np.float32) * stride
        sy = np.arange(height, dtype=np.float32) * stride
        shifts = np.stack(np.meshgrid(sx, sy), axis=-1).reshape(-1, 2)
        shifts4 = np.concatenate([shifts, shifts], axis=1)
        return (self._base[None, :, :] + shifts4[:, None, :]).reshape(-1, 4)

    def on_device(self, height: int, width: int, stride: Optional[float],
                  device) -> torch.Tensor:
        """:meth:`generate` as a tensor kept on ``device``."""
        return self._consts.get((height, width, stride),
                                lambda: self.generate(height, width, stride),
                                device)

    def run(self, input, state=None):
        hax, wax = layout.spatial_axes(4)
        h, w = int(input.shape[hax]), int(input.shape[wax])
        return self.on_device(h, w, None, input.device), state

    def extra_repr(self):
        return (f"ratios={self.ratios}, scales={self.scales}, "
                f"base={self.base_size}")


def nonzero_static(keep: torch.Tensor, n_out: int) -> torch.Tensor:
    """``jnp.nonzero(keep, size=n_out, fill_value=-1)[0]`` of a 1-D mask
    without a host read: the positions of its first ``n_out`` True entries
    in order, padded with -1 (a cumsum and a scatter)."""
    k = keep.shape[0]
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    slot = torch.where(keep & (rank < n_out), rank,
                       torch.full_like(rank, n_out))   # n_out: dropped
    out = torch.full((n_out + 1,), -1, dtype=torch.int64, device=keep.device)
    out.scatter_(0, slot, torch.arange(k, device=keep.device))
    return out[:n_out]


class Proposal(AbstractModule):
    """RPN proposals: decode the deltas onto the anchor grid, clip to the
    image, drop boxes under the minimum size, keep the ``pre_nms_topn``
    best, greedy NMS, emit the first ``post_nms_topn`` survivors.

    Input: Table ``(scores (1, 2A, H, W), deltas (1, 4A, H, W), im_info
    (1, ≥3) = [img_h, img_w, scale…])``. Output: Table ``(rois
    (post_nms_topn, 5), valid (post_nms_topn,))``, rows ``[0, x1, y1, x2,
    y2]``, the padding rows zero and invalid."""

    def __init__(self, pre_nms_topn: int = 6000, post_nms_topn: int = 300,
                 ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 scales: Sequence[float] = (8.0, 16.0, 32.0),
                 rpn_min_size: float = 16.0, nms_thresh: float = 0.7,
                 feat_stride: float = 16.0):
        super().__init__()
        self.pre_nms_topn = int(pre_nms_topn)
        self.post_nms_topn = int(post_nms_topn)
        _unregistered(self, "anchor", Anchor(ratios, scales,
                                             base_size=feat_stride))
        self.rpn_min_size = float(rpn_min_size)
        self.nms_thresh = float(nms_thresh)
        self.feat_stride = float(feat_stride)

    def run(self, input, state=None):
        xs = input.values() if isinstance(input, Table) else list(input)
        scores, deltas, im_info = xs[0], xs[1], xs[2]
        if layout.is_nhwc():
            # the RPN wire format is channel-first (Caffe's)
            scores = scores.permute(0, 3, 1, 2)
            deltas = deltas.permute(0, 3, 1, 2)
        if scores.shape[0] != 1:
            raise ValueError(
                f"Proposal is single-image (reference contract): got batch "
                f"{scores.shape[0]}; loop over images instead")
        a = self.anchor.num_anchors
        h, w = int(scores.shape[2]), int(scores.shape[3])
        anchors = self.anchor.on_device(h, w, self.feat_stride, scores.device)
        fg = scores[0, a:].permute(1, 2, 0).reshape(-1)
        d = deltas[0].reshape(a, 4, h, w).permute(2, 3, 0, 1).reshape(-1, 4)
        boxes = decode_rcnn(anchors, d)
        info = im_info.reshape(-1)
        boxes = clip_boxes(boxes, info[0], info[1])
        scale = info[2] if im_info.numel() > 2 else 1.0
        min_sz = self.rpn_min_size * scale
        ok = ((boxes[:, 2] - boxes[:, 0] + 1 >= min_sz)
              & (boxes[:, 3] - boxes[:, 1] + 1 >= min_sz))
        fg = torch.where(ok, fg, torch.full_like(fg, -math.inf))
        k = min(self.pre_nms_topn, boxes.shape[0])
        top_scores, top_idx = sort_desc(fg, k)
        cand = boxes[top_idx]
        order, keep = nms_mask(cand, top_scores, self.nms_thresh,
                               valid=torch.isfinite(top_scores))
        n_out = self.post_nms_topn
        surv_pos = nonzero_static(keep, n_out)
        valid = surv_pos >= 0
        sel = order[surv_pos.clamp(min=0)]
        rois_boxes = torch.where(valid[:, None], cand[sel],
                                 torch.zeros((), dtype=cand.dtype,
                                             device=cand.device))
        rois = torch.cat([torch.zeros_like(rois_boxes[:, :1]), rois_boxes],
                         dim=1)
        return Table(rois, valid), state

    def extra_repr(self):
        return (f"pre={self.pre_nms_topn}, post={self.post_nms_topn}, "
                f"nms={self.nms_thresh}")


class DetectionOutputSSD(AbstractModule):
    """SSD post-processing: decode the locations against the priors, a
    score threshold and greedy NMS a class, then the global top-k.

    Input: Table ``(loc (N, P·4), conf (N, P·n_classes), priors (1, 2,
    P·4))``; output ``(N, keep_topk, 6)`` rows ``[label, score, xmin, ymin,
    xmax, ymax]``, padding rows label -1 and score 0. Every (image, class)
    row goes to one NMS launch."""

    def __init__(self, n_classes: int, share_location: bool = True,
                 bg_label: int = 0, nms_thresh: float = 0.45,
                 nms_topk: int = 400, keep_topk: int = 200,
                 conf_thresh: float = 0.01, conf_post_process: bool = True):
        super().__init__()
        if not share_location:
            raise NotImplementedError(
                "per-class location predictions (share_location=False) are "
                "not supported; every public SSD topology shares locations")
        self.n_classes = int(n_classes)
        self.bg_label = int(bg_label)
        self.nms_thresh = float(nms_thresh)
        self.nms_topk = int(nms_topk)
        self.keep_topk = int(keep_topk)
        self.conf_thresh = float(conf_thresh)
        self.conf_post_process = bool(conf_post_process)

    def run(self, input, state=None):
        xs = input.values() if isinstance(input, Table) else list(input)
        loc, conf, priors = xs[0], xs[1], xs[2]
        n = loc.shape[0]
        p = loc.shape[1] // 4
        pri = priors.reshape(2, -1, 4)
        conf = conf.reshape(n, p, self.n_classes)
        if self.conf_post_process:
            conf = torch.softmax(conf, dim=-1)
        dev = loc.device
        cls = torch.arange(self.n_classes - 1, device=dev)
        cls = cls + (cls >= self.bg_label).to(cls.dtype)   # every class but bg
        k = min(self.nms_topk, p)
        boxes = decode_ssd(pri[0], pri[1], loc.reshape(n, p, 4))  # (N, P, 4)
        scores = conf.index_select(2, cls).transpose(1, 2)      # (N, C', P)
        s = torch.where(scores >= self.conf_thresh, scores,
                        torch.full_like(scores, -math.inf))
        top_s, top_i = sort_desc(s, k)                          # (N, C', k)
        c1 = cls.shape[0]
        cand = _gather_rows(boxes[:, None].expand(n, c1, p, 4), top_i)
        order, keep = nms_mask(cand, top_s, self.nms_thresh,
                               valid=torch.isfinite(top_s))
        sel = torch.where(keep, top_s.gather(-1, order),
                          torch.full_like(top_s, -math.inf))
        cboxes = _gather_rows(cand, order)
        flat_s = sel.reshape(n, -1)
        flat_b = cboxes.reshape(n, -1, 4)
        flat_l = cls.to(torch.float32)[:, None].expand(c1, k).reshape(-1)
        kk = min(self.keep_topk, flat_s.shape[1])
        top2_s, top2_i = sort_desc(flat_s, kk)                  # (N, kk)
        good = torch.isfinite(top2_s)
        zero = torch.zeros((), dtype=flat_b.dtype, device=dev)
        rows = torch.cat([
            torch.where(good, flat_l[top2_i],
                        torch.full_like(top2_s, -1.0))[..., None],
            torch.where(good, top2_s, zero)[..., None],
            torch.where(good[..., None], _gather_rows(flat_b, top2_i), zero)],
            dim=-1)
        if kk < self.keep_topk:
            pad = torch.zeros((n, self.keep_topk - kk, 6), dtype=rows.dtype,
                              device=dev)
            pad[..., 0] = -1.0
            rows = torch.cat([rows, pad], dim=1)
        return rows, state

    def extra_repr(self):
        return (f"classes={self.n_classes}, nms={self.nms_thresh}, "
                f"keep={self.keep_topk}")
