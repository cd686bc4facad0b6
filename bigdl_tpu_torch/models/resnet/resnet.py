"""ResNet family: CIFAR-10 (depth 6n+2) and ImageNet (18/34/50/101/152).

Counterpart of ``bigdl_tpu/models/resnet/resnet.py``, built from the same
layers in the same order, so its parameter and state paths equal the JAX
``get_params()``/``get_state()`` paths (``convert.load_jax_params``,
``load_jax_state``): ``ResNet(class_num, opt)`` with ``depth``,
``shortcutType`` (A: zero-padded identity, B: projection on a shape change,
C: projection always), ``dataSet`` (CIFAR-10 or ImageNet),
``zeroInitResidual`` and ``conv1SpaceToDepth`` (the ImageNet stem as a 4×4
stride-1 convolution over the 2×2 space-to-depth input); basic blocks
(2 × 3×3) or bottlenecks (1×1 → 3×3 → 1×1, expansion 4); MSRA-initialised
convolutions without bias, each followed by batch norm. Every spatial layer
follows ``nn/layout.py``.

As the port's other models, the weights are drawn on the CPU from
``generator`` and the model is moved to ``device`` (default the card).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn import layout
from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.convolution import conv2d
from bigdl_tpu_torch.nn.initialization import MsraFiller, Zeros
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.table import Table


class _ShortcutA(TensorModule):
    """Type-A shortcut: subsample spatially by the stride, zero-pad the
    extra channels (no parameters)."""

    def __init__(self, n_in: int, n_out: int, stride: int):
        super().__init__()
        self.n_in, self.n_out, self.stride = n_in, n_out, stride

    def run(self, input, state=None):
        x = input
        nhwc = layout.is_nhwc()
        if self.stride != 1:
            s = self.stride
            x = x[:, ::s, ::s, :] if nhwc else x[:, :, ::s, ::s]
        if self.n_out > self.n_in:
            pad = self.n_out - self.n_in
            x = F.pad(x, (0, pad) if nhwc else (0, 0, 0, 0, 0, pad))
        return x, state


def conv_bn(n_in: int, n_out: int, k: int, stride: int = 1, pad: int = 0,
            relu: bool = True, zero_bn_gamma: bool = False,
            generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """conv (MSRA init, no bias: the BN supplies the shift) → BN (→ ReLU)."""
    seq = (nn.Sequential()
           .add(nn.SpatialConvolution(n_in, n_out, k, k, stride, stride, pad,
                                      pad, with_bias=False,
                                      w_init=MsraFiller(),
                                      generator=generator))
           .add(nn.SpatialBatchNormalization(
               n_out, init_weight=Zeros() if zero_bn_gamma else None,
               generator=generator)))
    if relu:
        seq.add(nn.ReLU())
    return seq


def _shortcut(n_in: int, n_out: int, stride: int, shortcut_type: str,
              generator) -> nn.AbstractModule:
    use_conv = (shortcut_type == "C"
                or (shortcut_type == "B" and (n_in != n_out or stride != 1)))
    if use_conv:
        return (nn.Sequential()
                .add(nn.SpatialConvolution(n_in, n_out, 1, 1, stride, stride,
                                           with_bias=False,
                                           w_init=MsraFiller(),
                                           generator=generator))
                .add(nn.SpatialBatchNormalization(n_out,
                                                  generator=generator)))
    if n_in != n_out or stride != 1:
        return _ShortcutA(n_in, n_out, stride)
    return nn.Identity()


def basic_block(n_in: int, n_out: int, stride: int, shortcut_type: str,
                zero_init_residual: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> nn.Sequential:
    """Two 3×3 convs and the shortcut (ResNet-18/34 and every CIFAR
    depth)."""
    branch = (nn.Sequential()
              .add(conv_bn(n_in, n_out, 3, stride, 1, generator=generator))
              .add(conv_bn(n_out, n_out, 3, 1, 1, relu=False,
                           zero_bn_gamma=zero_init_residual,
                           generator=generator)))
    return (nn.Sequential()
            .add(nn.ConcatTable().add(branch).add(
                _shortcut(n_in, n_out, stride, shortcut_type, generator)))
            .add(nn.CAddTable())
            .add(nn.ReLU()))


def bottleneck(n_in: int, n_mid: int, stride: int, shortcut_type: str,
               zero_init_residual: bool = False,
               generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """1×1 → 3×3 → 1×1 with expansion 4 (ResNet-50/101/152)."""
    n_out = n_mid * 4
    branch = (nn.Sequential()
              .add(conv_bn(n_in, n_mid, 1, generator=generator))
              .add(conv_bn(n_mid, n_mid, 3, stride, 1, generator=generator))
              .add(conv_bn(n_mid, n_out, 1, relu=False,
                           zero_bn_gamma=zero_init_residual,
                           generator=generator)))
    return (nn.Sequential()
            .add(nn.ConcatTable().add(branch).add(
                _shortcut(n_in, n_out, stride, shortcut_type, generator)))
            .add(nn.CAddTable())
            .add(nn.ReLU()))


class _Conv1SpaceToDepth(TensorModule):
    """The ImageNet stem (7×7, stride 2, pad 3, no bias) in space-to-depth
    form: the input is rearranged 2×2 → channels on the card and the
    convolution becomes 4×4, stride 1, over 12 channels, pads (2, 1).

    The weight is the (64, 12, 4, 4) tensor, initialised as the
    rearrangement of an MSRA 7×7×3 stem (:meth:`transform_7x7`); the taps
    with no 7×7 pre-image start at zero, so at init the output equals the
    plain stem's."""

    def __init__(self, n_out: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_out = n_out
        # the plain stem's fan-in and fan-out, so the init matches it
        w7 = MsraFiller().init((n_out, 3, 7, 7), fan_in=3 * 7 * 7,
                               fan_out=n_out * 7 * 7, generator=generator)
        self.weight = torch.nn.Parameter(torch.from_numpy(
            self.transform_7x7(w7.numpy())))

    @staticmethod
    def transform_7x7(w7: np.ndarray) -> np.ndarray:
        """(O, 3, 7, 7) stem weights → the equivalent (O, 12, 4, 4) s2d
        weights. Output position o reads input p = 2o + k − 3 (k in 0..6);
        with p = 2m + r (r the parity) the s2d tap is m − o + 2 in 0..3 and
        the s2d channel ``rh·6 + rw·3 + c``, the order of the reshape in
        :meth:`run`."""
        o, c_in = w7.shape[0], w7.shape[1]
        w4 = np.zeros((o, 4 * c_in, 4, 4), w7.dtype)
        for kh in range(7):
            rh, mh = (kh - 3) % 2, ((kh - 3) - (kh - 3) % 2) // 2 + 2
            for kw in range(7):
                rw, mw = (kw - 3) % 2, ((kw - 3) - (kw - 3) % 2) // 2 + 2
                for c in range(c_in):
                    w4[:, rh * 2 * c_in + rw * c_in + c, mh, mw] = \
                        w7[:, c, kh, kw]
        return w4

    def run(self, input, state=None):
        x = input
        if layout.is_nhwc():
            n, h, w, c = x.shape
            xs = x.reshape(n, h // 2, 2, w // 2, 2, c) \
                  .permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
        else:
            n, c, h, w = x.shape
            xs = x.reshape(n, c, h // 2, 2, w // 2, 2) \
                  .permute(0, 3, 5, 1, 2, 4).reshape(n, 4 * c, h // 2, w // 2)
        return conv2d(xs, self.weight, None, (1, 1), ((2, 1), (2, 1))), state


class _GlobalAvgPool(TensorModule):
    """Mean over the spatial axes (accumulated in fp32 for bf16 input, as
    ``jnp.mean`` does, and returned in the input's dtype)."""

    def run(self, input, state=None):
        return input.mean(dim=layout.spatial_axes(input.dim())), state


# depth -> (block kind, blocks a stage) for the ImageNet variants
_IMAGENET_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def ResNet(class_num: int, opt=None, *,
           generator: Optional[torch.Generator] = None,
           device=None) -> nn.Sequential:
    """The reference's ``ResNet(classNum, T(opts))`` factory."""
    opt = dict(opt.items()) if isinstance(opt, Table) else dict(opt or {})
    dev = resolve_device(device)
    depth = int(opt.get("depth", 18))
    dataset = opt.get("dataSet", opt.get("dataset", "CIFAR-10"))
    shortcut = opt.get("shortcutType", "B" if dataset == "ImageNet" else "A")
    zero_init_residual = bool(opt.get("zeroInitResidual", False))
    g = generator

    model = nn.Sequential()
    if dataset == "ImageNet":
        if depth not in _IMAGENET_CFG:
            raise ValueError(f"ImageNet depth must be one of "
                             f"{sorted(_IMAGENET_CFG)}, got {depth}")
        kind, counts = _IMAGENET_CFG[depth]
        if opt.get("conv1SpaceToDepth"):
            model.add(nn.Sequential()
                      .add(_Conv1SpaceToDepth(64, generator=g))
                      .add(nn.SpatialBatchNormalization(64, generator=g))
                      .add(nn.ReLU()))
        else:
            model.add(conv_bn(3, 64, 7, 2, 3, generator=g))
        model.add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1))
        n_in = 64
        for stage, n_blocks in enumerate(counts):
            n_mid = 64 * (2 ** stage)
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                if kind == "bottleneck":
                    model.add(bottleneck(n_in, n_mid, stride, shortcut,
                                         zero_init_residual, generator=g))
                    n_in = n_mid * 4
                else:
                    model.add(basic_block(n_in, n_mid, stride, shortcut,
                                          zero_init_residual, generator=g))
                    n_in = n_mid
        model.add(_GlobalAvgPool())
        model.add(nn.Linear(n_in, class_num, w_init=MsraFiller(),
                            generator=g))
    else:
        if (depth - 2) % 6:
            raise ValueError(f"CIFAR depth must be 6n+2, got {depth}")
        n = (depth - 2) // 6
        model.add(conv_bn(3, 16, 3, 1, 1, generator=g))
        n_in = 16
        for stage, n_out in enumerate([16, 32, 64]):
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                model.add(basic_block(n_in, n_out, stride, shortcut,
                                      zero_init_residual, generator=g))
                n_in = n_out
        model.add(_GlobalAvgPool())
        model.add(nn.Linear(64, class_num, w_init=MsraFiller(), generator=g))
    model.add(nn.LogSoftMax())
    return model.to(dev)


def ResNet50(class_num: int = 1000, shortcut_type: str = "B", *,
             generator: Optional[torch.Generator] = None,
             device=None) -> nn.Sequential:
    """The flagship model of the repo's benchmarks (BASELINE.md config 2)."""
    return ResNet(class_num, {"depth": 50, "dataSet": "ImageNet",
                              "shortcutType": shortcut_type},
                  generator=generator, device=device)


from bigdl_tpu_torch.utils.serializer import register as _register  # noqa: E402

for _cls in (_ShortcutA, _Conv1SpaceToDepth, _GlobalAvgPool):
    _register(_cls)
