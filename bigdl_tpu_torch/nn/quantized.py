"""Int8 quantized inference: ``module.quantize()``.

Counterpart of ``bigdl_tpu/nn/quantized.py``. Weights are quantized per
output channel (symmetric, scale = max|w| / 127, in numpy as JAX does, so
``weight_q`` and ``w_scale`` equal JAX's bit for bit); activations per
tensor. Three modes, as in JAX:

- ``"dynamic"``: the activation's scale is its absmax over the whole
  tensor, reduced on the device at every call (no host read);
- ``"weight_only"``: the int8 weight is dequantized into the input's dtype
  at use and the product runs in that dtype;
- ``"static"``: the activation's scale comes from ``x_absmax``, a buffer
  (JAX's state key) that :func:`calibrate` fills with the running absmax
  of the layer's own inputs. Serving before calibration raises.

JAX computes the int8 product outside any Pallas kernel (``lax.dot_general``
and ``conv_general_dilated`` with ``preferred_element_type=int32``). Here it
is :func:`int8_matmul`, ``torch._int_mm`` (cuBLASLt's int8 × int8 → int32
on the card) with zero padding to its shape rules; a convolution is an
im2col of the int8 input (strided views, one copy) into the same product,
and a 1×1 convolution of stride 1 a plain product. Integer accumulation is
exact, so the int32 accumulators equal JAX's whenever the int8 operands
do. The epilogue keeps JAX's order: ``acc * (s_x * w_scale) + bias``.

Quantized modules are inference-only: ``run`` in training mode raises, as
JAX's ``apply(training=True)`` does. The parameters (``weight_q``,
``w_scale``, ``bias``) need no gradient. JAX's branch for the TF-imported
``TFConv2D``/``TFMatMul`` adapters waits for the TF importers (ROADMAP
Queue A.6): :func:`quantize_module` leaves such a module unquantized only
because the port has no such module to meet.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import (
    AbstractModule, Container, TensorModule, evaluating,
)

_MODES = ("dynamic", "weight_only", "static")


def _quantize_weight(w, channel_axis: int = 0):
    """Symmetric per-output-channel int8: (w_int8, scale fp32 per channel),
    both numpy, JAX's arithmetic."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != channel_axis)
    absmax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    w_q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return w_q, np.squeeze(scale, axis=reduce_axes).astype(np.float32)


def _quantize_activation(x: torch.Tensor):
    """Dynamic per-tensor symmetric int8 of an activation: (x_q, scale),
    the absmax reduced on the device."""
    absmax = x.abs().amax()
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax)).float()
    return _round_to_int8(x, scale), scale


def _round_to_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # x / scale in fp32 (JAX promotes a bf16 x against the fp32 scale)
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def _pad_to(n: int, multiple: int, least: int = 0) -> int:
    return max(-(-n // multiple) * multiple, least)


def int8_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a @ b_t.T`` of int8 ``a`` (M, K) and ``b_t`` (N, K), accumulated
    in int32: ``torch._int_mm``. On the card, cuBLASLt's int8 product takes
    ``a`` with more than 16 rows and K and N multiples of 8 (torch 2.11,
    CUDA 12.8, H100: smaller or unaligned shapes raise), so every operand
    is zero-padded to those rules there; zeros add nothing to an integer
    sum, so the result is exact. The CPU takes any shape and pads nothing
    unless ``pad=True`` is forced through :func:`_padded_int_mm`."""
    return _padded_int_mm(a, b_t, pad=a.is_cuda)


def _padded_int_mm(a: torch.Tensor, b_t: torch.Tensor,
                   pad: bool) -> torch.Tensor:
    m, k = a.shape
    n = b_t.shape[0]
    if pad:
        mp, kp, np_ = _pad_to(m, 1, 17), _pad_to(k, 8), _pad_to(n, 8)
        if (mp, kp) != (m, k):
            a = F.pad(a, (0, kp - k, 0, mp - m))
        if (np_, kp) != (n, k):
            b_t = F.pad(b_t, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return out[:m, :n] if pad else out


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: tuple, pads: tuple,
            dilation: tuple = (1, 1)) -> tuple:
    """(N, C, H, W) → ((N·OH·OW, C·kh·kw) patches in (c, i, j) order, OH,
    OW), any dtype: zero padding, then strided views and one copy."""
    (ph0, ph1), (pw0, pw1) = pads
    if ph0 or ph1 or pw0 or pw1:
        x = F.pad(x, (pw0, pw1, ph0, ph1))
    dh, dw = dilation
    ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    p = x.unfold(2, ekh, stride[0]).unfold(3, ekw, stride[1])
    p = p[..., ::dh, ::dw]                       # (N, C, OH, OW, kh, kw)
    n, c, oh, ow = p.shape[:4]
    return p.permute(0, 2, 3, 1, 4, 5).reshape(n * oh * ow, c * kh * kw), \
        oh, ow


def int8_conv2d(x_q: torch.Tensor, w_q: torch.Tensor, stride: tuple,
                pads: tuple, dilation: tuple = (1, 1),
                groups: int = 1) -> torch.Tensor:
    """int32 accumulators of an int8 NCHW convolution, as (N, OH, OW, O)
    (channels innermost; the caller's epilogue permutes the result to
    NCHW): im2col into :func:`int8_matmul`, one product a group."""
    n = x_q.shape[0]
    o, cg, kh, kw = w_q.shape
    plain = (kh == kw == 1 and stride == (1, 1) and dilation == (1, 1)
             and not any(pads[0] + pads[1]))
    outs = []
    for g in range(groups):
        xg = x_q[:, g * cg:(g + 1) * cg] if groups > 1 else x_q
        wg = w_q[g * (o // groups):(g + 1) * (o // groups)]
        if plain:
            oh, ow = xg.shape[2:]
            cols = xg.permute(0, 2, 3, 1).reshape(n * oh * ow, cg)
        else:
            cols, oh, ow = _im2col(xg, kh, kw, stride, pads, dilation)
        outs.append(int8_matmul(cols, wg.reshape(wg.shape[0], -1)))
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.reshape(n, oh, ow, o)


def _frozen(t: torch.Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(t, requires_grad=False)


class _QuantizedBase(TensorModule):
    calibrating: bool = False
    _calibrated: bool = False

    def _init_quantized(self, mode: str) -> None:
        if mode not in _MODES:
            raise ValueError(f"mode must be {'|'.join(_MODES)}, got {mode!r}")
        self.mode = mode
        if mode == "static":
            self.register_buffer("x_absmax", torch.zeros((), dtype=torch.float32))

    def _set_float_params(self, m) -> None:
        w_q, scale = _quantize_weight(m.weight)
        dev = m.weight.device
        self.weight_q = _frozen(torch.from_numpy(w_q).to(dev))
        self.w_scale = _frozen(torch.from_numpy(scale).to(dev))
        self.bias = (_frozen(m.bias.detach().clone()) if m.bias is not None
                     else None)
        self.name = m.name

    def state_loaded(self) -> None:
        """Re-arm the serve path after ``x_absmax`` was loaded from a
        calibrated checkpoint (``convert.load_jax_state`` calls this; JAX's
        ``set_state``). Reads the buffer on the host: not for a capture."""
        absmax = getattr(self, "x_absmax", None)
        if absmax is not None and float(absmax) > 0:
            self._calibrated = True

    def _check_inference(self) -> None:
        if self.training:
            raise RuntimeError(
                f"{type(self).__name__} is inference-only; quantize() after "
                f"training, not before")

    def _quantize_input(self, x: torch.Tensor):
        """(x_q int8, s_x) for the dynamic and static modes; under
        calibration the running absmax is updated in place first."""
        if self.mode != "static":
            return _quantize_activation(x)
        if not (self.calibrating or self._calibrated):
            # absmax 0 would quantize with scale 1.0: refuse loudly
            raise RuntimeError(
                f"{type(self).__name__}(mode='static') serving before "
                f"calibration — run nn.calibrate(model, batches) first")
        if self.calibrating:
            with torch.no_grad():
                self.x_absmax.copy_(torch.maximum(
                    self.x_absmax, x.abs().amax().float()))
        absmax = self.x_absmax
        s_x = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
        return _round_to_int8(x, s_x), s_x

    def _dequantized_weight(self, dtype, ndim: int) -> torch.Tensor:
        shape = (-1,) + (1,) * (ndim - 1)
        return self.weight_q.to(dtype) * self.w_scale.reshape(shape).to(dtype)


class QuantizedLinear(_QuantizedBase):
    """Int8 Linear: ``y = (x_q @ w_q^T) * (s_x * s_w) + b``."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, mode: str = "dynamic"):
        super().__init__()
        self._init_quantized(mode)
        self.input_size = input_size
        self.output_size = output_size
        self.weight_q = _frozen(torch.zeros((output_size, input_size),
                                            dtype=torch.int8))
        self.w_scale = _frozen(torch.ones(output_size))
        self.bias = _frozen(torch.zeros(output_size)) if with_bias else None

    @property
    def with_bias(self) -> bool:
        return self.bias is not None

    @classmethod
    def from_float(cls, m, mode: str = "dynamic") -> "QuantizedLinear":
        q = cls(m.input_size, m.output_size, with_bias=m.with_bias, mode=mode)
        q._set_float_params(m)
        return q.to(m.weight.device).train(m.training)

    def run(self, input, state=None):
        self._check_inference()
        x = input
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        elif x.dim() == 1:
            x = x[None]
        if self.mode == "weight_only":
            w = self._dequantized_weight(x.dtype, 2)
            out = (x @ w.t()).float()
        else:
            x_q, s_x = self._quantize_input(x)
            acc = int8_matmul(x_q, self.weight_q)
            out = acc.float() * (s_x * self.w_scale[None, :])
        if self.bias is not None:
            out = out + self.bias[None, :]
        return (out[0] if input.dim() == 1 else out), state

    def extra_repr(self):
        return f"{self.input_size} -> {self.output_size}, int8, {self.mode}"


class _QuantizedConv(_QuantizedBase):
    """The shared call of the two int8 convolutions: NCHW in and out."""

    def _conv_args(self, x) -> tuple:
        """(stride, pads, dilation, groups) for an NCHW input ``x``."""
        raise NotImplementedError

    def run(self, input, state=None):
        self._check_inference()
        x = input[None] if input.dim() == 3 else input
        stride, pads, dilation, groups = self._conv_args(x)
        if self.mode == "weight_only":
            w = self._dequantized_weight(x.dtype, 4)
            (ph0, ph1), (pw0, pw1) = pads
            if ph0 != ph1 or pw0 != pw1:
                x = F.pad(x, (pw0, pw1, ph0, ph1))
                ph0 = pw0 = 0
            out = F.conv2d(x, w, None, stride, (ph0, pw0), dilation,
                           groups).float()
            if self.bias is not None:
                out = out + self.bias[None, :, None, None]
        else:
            x_q, s_x = self._quantize_input(x)
            acc = int8_conv2d(x_q, self.weight_q, stride, pads, dilation,
                              groups)                  # (N, OH, OW, O)
            out = acc.float() * (s_x * self.w_scale)
            if self.bias is not None:
                out = out + self.bias
            out = out.permute(0, 3, 1, 2)
        return (out[0] if input.dim() == 3 else out), state


class QuantizedSpatialConvolution(_QuantizedConv):
    """Int8 convolution: int8 × int8 → int32 and the fp32 epilogue."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, with_bias: bool = True,
                 mode: str = "dynamic"):
        super().__init__()
        self._init_quantized(mode)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.weight_q = _frozen(torch.zeros(
            (n_output_plane, n_input_plane // n_group, kernel_h, kernel_w),
            dtype=torch.int8))
        self.w_scale = _frozen(torch.ones(n_output_plane))
        self.bias = _frozen(torch.zeros(n_output_plane)) if with_bias \
            else None

    @property
    def with_bias(self) -> bool:
        return self.bias is not None

    @classmethod
    def from_float(cls, m, mode: str = "dynamic"):
        q = cls(m.n_input_plane, m.n_output_plane, m.kernel_w, m.kernel_h,
                m.stride_w, m.stride_h, m.pad_w, m.pad_h, m.n_group,
                with_bias=m.with_bias, mode=mode)
        q._set_float_params(m)
        return q.to(m.weight.device).train(m.training)

    def _conv_args(self, x):
        from bigdl_tpu_torch.nn.convolution import same_pad
        if self.pad_w == -1 or self.pad_h == -1:
            pads = (same_pad(x.shape[2], self.kernel_h, self.stride_h),
                    same_pad(x.shape[3], self.kernel_w, self.stride_w))
        else:
            pads = ((self.pad_h, self.pad_h), (self.pad_w, self.pad_w))
        return (self.stride_h, self.stride_w), pads, (1, 1), self.n_group

    def extra_repr(self):
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kernel_w}x{self.kernel_h}, int8, {self.mode}")


class QuantizedSpatialDilatedConvolution(_QuantizedConv):
    """Int8 atrous convolution: the same product with ``rhs_dilation``."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 dilation_w: int = 1, dilation_h: int = 1,
                 with_bias: bool = True, mode: str = "dynamic"):
        super().__init__()
        self._init_quantized(mode)
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.kw, self.kh, self.dw, self.dh = kw, kh, dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.dilation_w, self.dilation_h = dilation_w, dilation_h
        self.weight_q = _frozen(torch.zeros(
            (n_output_plane, n_input_plane, kh, kw), dtype=torch.int8))
        self.w_scale = _frozen(torch.ones(n_output_plane))
        self.bias = _frozen(torch.zeros(n_output_plane)) if with_bias \
            else None

    @property
    def with_bias(self) -> bool:
        return self.bias is not None

    @classmethod
    def from_float(cls, m, mode: str = "dynamic"):
        q = cls(m.n_input_plane, m.n_output_plane, m.kw, m.kh, m.dw, m.dh,
                m.pad_w, m.pad_h, m.dilation_w, m.dilation_h,
                with_bias=m.bias is not None, mode=mode)
        q._set_float_params(m)
        return q.to(m.weight.device).train(m.training)

    def _conv_args(self, x):
        return ((self.dh, self.dw),
                ((self.pad_h, self.pad_h), (self.pad_w, self.pad_w)),
                (self.dilation_h, self.dilation_w), 1)

    def extra_repr(self):
        return (f"{self.n_input_plane} -> {self.n_output_plane}, "
                f"{self.kw}x{self.kh}, dilation={self.dilation_w}x"
                f"{self.dilation_h}, int8, {self.mode}")


def _quantized_leaf(m, mode: str):
    """The int8 module of an exact Linear or (dilated) convolution, else
    None: subclasses may change what the call computes."""
    from bigdl_tpu_torch.nn.convolution import (
        SpatialConvolution, SpatialDilatedConvolution,
    )
    from bigdl_tpu_torch.nn.linear import Linear
    if type(m) is Linear:
        return QuantizedLinear.from_float(m, mode)
    if type(m) is SpatialConvolution:
        return QuantizedSpatialConvolution.from_float(m, mode)
    if type(m) is SpatialDilatedConvolution:
        return QuantizedSpatialDilatedConvolution.from_float(m, mode)
    return None


def _convert(m, mode: str):
    """Replace the quantizable children of ``m`` (a copy) in place, down
    through containers; a graph's nodes follow their modules."""
    from bigdl_tpu_torch.nn.graph import Graph
    if not isinstance(m, Container):
        return
    for name, child in list(m._modules.items()):
        q = _quantized_leaf(child, mode)
        if q is None:
            _convert(child, mode)
            continue
        m._modules[name] = q
        if isinstance(m, Graph):
            for n in m.exec_nodes:
                if n.module is child:
                    n.module = q


def quantize_module(m: AbstractModule, mode: str = "dynamic") -> AbstractModule:
    """Deep-convert a copy of ``m``: its Linear, SpatialConvolution and
    SpatialDilatedConvolution leaves (exact types) become int8 modules,
    everything else is copied unchanged; ``m`` is not modified."""
    if mode not in _MODES:
        raise ValueError(f"mode must be dynamic|weight_only|static, got {mode!r}")
    q = _quantized_leaf(m, mode)
    if q is not None:
        return q
    # generators stay shared: they are sources, not state
    memo = {id(v): v for x in m.modules() for v in vars(x).values()
            if isinstance(v, torch.Generator)}
    out = copy.deepcopy(m, memo)
    _convert(out, mode)
    return out


def calibrate(qmodule: AbstractModule, inputs) -> AbstractModule:
    """Calibrate a ``mode="static"`` model: run ``inputs`` (tensors, arrays
    or MiniBatch-like objects with ``.input``) through it in eval mode
    while each static layer keeps the running absmax of its own inputs in
    ``x_absmax``. Returns the model."""
    leaves = [q for q in qmodule.modules()
              if isinstance(q, _QuantizedBase) and q.mode == "static"]
    if not leaves:
        raise ValueError(
            'calibrate() expects a model quantized with mode="static"')
    device = leaves[0].weight_q.device
    for q in leaves:
        q.calibrating = True
    try:
        with torch.no_grad(), evaluating(qmodule):
            for x in inputs:
                x = getattr(x, "input", x)
                if not isinstance(x, torch.Tensor):
                    x = torch.as_tensor(np.asarray(x))
                qmodule.run(x.to(device), None)
    finally:
        for q in leaves:
            q.calibrating = False
            q._calibrated = True
    return qmodule
