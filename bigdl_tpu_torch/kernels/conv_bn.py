"""Conv → batch norm → ReLU as one module, with the BN folded into the
convolution at inference.

Counterpart of ``bigdl_tpu/kernels/conv_bn.py``, an XLA-level fusion and
not a Pallas kernel, so a torch module here, not a CUDA kernel.
:class:`FusedConvBNReLU` owns a ``SpatialConvolution`` and a
``SpatialBatchNormalization`` (children ``"0"`` and ``"1"``, so parameter
and state paths are JAX's):

- training, and eval with folding off: the wrapped modules' own ``run`` in
  sequence, the same ops in the same order, so the fused module equals the
  unfused stack bit for bit in fp32;
- eval with folding (``BIGDL_CONVBN_FOLD``, default on): the running
  statistics fold into the convolution, ``w' = w·s`` and
  ``b' = b·s + (β − μ·s)`` with ``s = γ·rsqrt(σ² + ε)``, and the triple runs
  as one convolution with bias (and ReLU); equal within float tolerance
  (the order of operations changes).

``nn/graph.py`` ``fuse_conv_bn`` rewrites a model's adjacent triples into
these modules; the trainer applies it when ``BIGDL_CONVBN_FUSE=1``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import layout
from bigdl_tpu_torch.nn.abstractnn import Container, child_state


def fold_bn_scale_shift(weight, bias, running_mean, running_var, eps: float):
    """Per-channel (scale, shift) equal to an eval-mode batch norm,
    ``bn(y) == y·scale + shift``, in fp32; ``weight`` None for a BN without
    affine parameters."""
    inv = torch.rsqrt(running_var.float() + eps)
    if weight is not None:
        scale = weight.float() * inv
        shift = bias.float() - running_mean.float() * scale
    else:
        scale = inv
        shift = -running_mean.float() * scale
    return scale, shift


def fold_bn_into_conv(weight, bias, scale, shift):
    """Fold a per-output-channel (scale, shift) into OIHW conv weights:
    ``(w·s, b·s + shift)`` with ``w·s`` in the weight's dtype and the bias
    in fp32 (``bias`` may be None)."""
    w = weight.float() * scale[:, None, None, None]
    b = shift if bias is None else bias.float() * scale + shift
    return w.to(weight.dtype), b


def fold_enabled() -> bool:
    """The inference folding knob ``BIGDL_CONVBN_FOLD`` (default on); it
    acts only inside a fused module."""
    return os.environ.get("BIGDL_CONVBN_FOLD", "1") != "0"


class FusedConvBNReLU(Container):
    """``SpatialConvolution → SpatialBatchNormalization (→ ReLU)`` as one
    module; ``fold_inference=None`` defers to ``BIGDL_CONVBN_FOLD``. The
    training path is never folded."""

    def __init__(self, conv, bn, relu: bool = False,
                 fold_inference: Optional[bool] = None):
        super().__init__(conv, bn)
        self.with_relu = bool(relu)
        self.fold_inference = fold_inference

    @property
    def conv(self):
        return self[0]

    @property
    def bn(self):
        return self[1]

    def _folds(self) -> bool:
        if self.fold_inference is not None:
            return bool(self.fold_inference)
        return fold_enabled()

    def run(self, input, state=None):
        if not self.training and self._folds():
            out = self._run_folded(input)
        else:
            out, _ = self.conv.run(input, child_state(state, "0"))
            out, _ = self.bn.run(out, child_state(state, "1"))
        if self.with_relu:
            out = F.relu(out)
        return out, state

    def _run_folded(self, input):
        bn, conv = self.bn, self.conv
        scale, shift = fold_bn_scale_shift(bn.weight, bn.bias,
                                           bn.running_mean, bn.running_var,
                                           bn.eps)
        w, b = fold_bn_into_conv(conv.weight, conv.bias, scale, shift)
        if conv.bias is not None:
            return conv.conv(input, w, b.to(w.dtype))
        out = conv.conv(input, w, None)
        return out + b.to(out.dtype).reshape(
            layout.bias_shape(bn.n_output, out.dim()))

    def extra_repr(self):
        return "relu" if self.with_relu else ""


from bigdl_tpu_torch.utils.serializer import register as _register  # noqa: E402

_register(FusedConvBNReLU)
