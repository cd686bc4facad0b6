"""Keras-1.2-style shape-inferring layers over the port's ``nn``.

Counterpart of ``bigdl_tpu/nn/keras/layers.py``: a ``KerasLayer`` is a
builder. ``build(input_shape)`` (the batch axis left out) returns the
concrete module of ``bigdl_tpu_torch.nn``, and ``compute_output_shape``
carries the shape on, so a ``Sequential`` or a functional ``Model``
(``topology.py``) infers every weight's shape from its first layer's
``input_shape``. The layout is channels-first (NCHW), as in JAX
(``:9-11``). Modules are built on the CPU with the default generator; the
model moves them to its device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from bigdl_tpu_torch import nn as N


def _resolve_init(init):
    """Keras-1.2 init strings → InitializationMethods; objects/None pass
    through (None lets each native layer keep its default)."""
    if init is None or not isinstance(init, str):
        return init
    from bigdl_tpu_torch.nn.initialization import (
        MsraFiller, Ones, RandomNormal, RandomUniform, Xavier, Zeros,
    )
    table = {
        "glorot_uniform": Xavier, "glorot_normal": Xavier,
        "he_normal": MsraFiller, "he_uniform": MsraFiller,
        "uniform": RandomUniform, "normal": RandomNormal,
        "zero": Zeros, "one": Ones,
    }
    if init not in table:
        raise ValueError(f"unknown keras init {init!r}; have {sorted(table)}")
    return table[init]()


def _act(name: Optional[str]):
    if name is None or name == "linear":
        return None
    table = {
        "relu": N.ReLU, "tanh": N.Tanh, "sigmoid": N.Sigmoid,
        "hard_sigmoid": N.HardSigmoid, "softmax": N.SoftMax,
        "softplus": N.SoftPlus, "softsign": N.SoftSign, "elu": N.ELU,
        "gelu": N.GELU, "swish": N.Swish, "log_softmax": N.LogSoftMax,
    }
    if name not in table:
        raise ValueError(f"unknown activation {name!r}")
    return table[name]()


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class KerasLayer:
    """Shape-inferring builder for one nn module."""

    def __init__(self, input_shape: Optional[Sequence[int]] = None,
                 name: Optional[str] = None):
        self.input_shape = tuple(input_shape) if input_shape is not None else None
        self.name = name or f"{type(self).__name__.lower()}_{id(self) % 100000}"

    def build(self, input_shape: tuple) -> "N.AbstractModule":
        raise NotImplementedError

    def compute_output_shape(self, input_shape: tuple) -> tuple:
        raise NotImplementedError

    def _with_activation(self, module, activation: Optional[str]):
        act = _act(activation)
        if act is None:
            return module
        return N.Sequential().add(module).add(act)

    # functional API: layer(node) → new node with propagated shape
    def __call__(self, node):
        from bigdl_tpu_torch.nn.keras.topology import KerasNode, merge_nodes
        if isinstance(node, (list, tuple)):
            node = merge_nodes(node)
        if not isinstance(node, KerasNode):
            raise TypeError("functional call expects Input()/layer output node(s)")
        module = self.build(node.shape)
        from bigdl_tpu_torch.nn.graph import make_node
        return KerasNode(make_node(module, [node.node]),
                         self.compute_output_shape(node.shape))


class Dense(KerasLayer):
    def __init__(self, output_dim: int, activation: Optional[str] = None,
                 bias: bool = True, init=None, W_regularizer=None,
                 b_regularizer=None, **kw):
        super().__init__(**kw)
        self.output_dim = output_dim
        self.activation = activation
        self.bias = bias
        self.init = init
        self.W_regularizer = W_regularizer
        self.b_regularizer = b_regularizer

    def build(self, input_shape):
        if len(input_shape) != 1:
            raise ValueError(
                f"Dense expects 1-D (features,) input shape, got {input_shape}; "
                "add Flatten() first")
        lin = N.Linear(input_shape[0], self.output_dim, with_bias=self.bias,
                       w_init=_resolve_init(self.init),
                       w_regularizer=self.W_regularizer,
                       b_regularizer=self.b_regularizer)
        return self._with_activation(lin, self.activation)

    def compute_output_shape(self, input_shape):
        return (self.output_dim,)


class Activation(KerasLayer):
    def __init__(self, activation: str, **kw):
        super().__init__(**kw)
        self.activation = activation

    def build(self, input_shape):
        act = _act(self.activation)
        return act if act is not None else N.Identity()

    def compute_output_shape(self, input_shape):
        return input_shape


class Dropout(KerasLayer):
    def __init__(self, p: float, **kw):
        super().__init__(**kw)
        self.p = p

    def build(self, input_shape):
        return N.Dropout(self.p)

    def compute_output_shape(self, input_shape):
        return input_shape


class Flatten(KerasLayer):
    def build(self, input_shape):
        return N.Reshape([int(math.prod(input_shape))])

    def compute_output_shape(self, input_shape):
        return (int(math.prod(input_shape)),)


class Reshape(KerasLayer):
    def __init__(self, target_shape: Sequence[int], **kw):
        super().__init__(**kw)
        self.target_shape = tuple(target_shape)

    def build(self, input_shape):
        return N.Reshape(list(self.target_shape))

    def compute_output_shape(self, input_shape):
        if math.prod(self.target_shape) != math.prod(input_shape):
            raise ValueError(
                f"cannot reshape {input_shape} into {self.target_shape}")
        return self.target_shape


class Convolution2D(KerasLayer):
    """2-D conv on (channels, h, w). ``border_mode``: 'valid' or 'same'."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation: Optional[str] = None, border_mode: str = "valid",
                 subsample=(1, 1), bias: bool = True, init=None,
                 W_regularizer=None, b_regularizer=None, **kw):
        super().__init__(**kw)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid|same, got {border_mode!r}")
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.border_mode = border_mode
        self.subsample = _pair(subsample)
        self.bias = bias
        self.init = init
        self.W_regularizer = W_regularizer
        self.b_regularizer = b_regularizer

    def build(self, input_shape):
        c = input_shape[0]
        kh, kw = self.nb_row, self.nb_col
        pre_pad = None
        pw = ph = 0
        if self.border_mode == "same":
            if kh % 2 == 1 and kw % 2 == 1:
                pw, ph = (kw - 1) // 2, (kh - 1) // 2  # symmetric pad suffices
            else:
                # even kernel: SAME needs asymmetric (k-1)//2 / k//2 padding,
                # which the conv's symmetric pad can't express — pad explicitly.
                # Total pad k-1 yields out = ceil(in/stride) for every stride.
                pre_pad = N.SpatialZeroPadding((kw - 1) // 2, kw // 2,
                                               (kh - 1) // 2, kh // 2)
        conv = N.SpatialConvolution(
            c, self.nb_filter, kw, kh,
            self.subsample[1], self.subsample[0], pw, ph,
            with_bias=self.bias, w_init=_resolve_init(self.init),
            w_regularizer=self.W_regularizer,
            b_regularizer=self.b_regularizer)
        if pre_pad is not None:
            conv = N.Sequential().add(pre_pad).add(conv)
        return self._with_activation(conv, self.activation)

    def compute_output_shape(self, input_shape):
        _, h, w = input_shape
        sh, sw = self.subsample
        if self.border_mode == "same":
            oh = (h + sh - 1) // sh
            ow = (w + sw - 1) // sw
        else:
            oh = (h - self.nb_row) // sh + 1
            ow = (w - self.nb_col) // sw + 1
        return (self.nb_filter, oh, ow)


class _Pooling2D(KerasLayer):
    _op = None

    def __init__(self, pool_size=(2, 2), strides=None, border_mode: str = "valid",
                 **kw):
        super().__init__(**kw)
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool_size
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid|same, got {border_mode!r}")
        self.border_mode = border_mode

    def build(self, input_shape):
        if self.border_mode == "same":
            # SAME = ceil(h/s) per dimension; the pooling primitive computes the exact
            # asymmetric lo/hi padding itself (pad_mode="same"), which is correct for
            # odd, even, and mixed pool sizes alike — no ceil-mode double counting.
            return self._op(self.pool_size[1], self.pool_size[0],
                            self.strides[1], self.strides[0], pad_mode="same")
        return self._op(self.pool_size[1], self.pool_size[0],
                        self.strides[1], self.strides[0], 0, 0)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        sh, sw = self.strides
        if self.border_mode == "same":
            return (c, (h + sh - 1) // sh, (w + sw - 1) // sw)
        return (c, (h - self.pool_size[0]) // sh + 1,
                (w - self.pool_size[1]) // sw + 1)


class MaxPooling2D(_Pooling2D):
    @property
    def _op(self):
        return N.SpatialMaxPooling


class AveragePooling2D(_Pooling2D):
    @property
    def _op(self):
        return N.SpatialAveragePooling


class GlobalAveragePooling2D(KerasLayer):
    def build(self, input_shape):
        c, h, w = input_shape
        return N.Sequential().add(N.SpatialAveragePooling(w, h)) \
                             .add(N.Reshape([c]))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class ZeroPadding2D(KerasLayer):
    def __init__(self, padding=(1, 1), **kw):
        super().__init__(**kw)
        self.padding = _pair(padding)

    def build(self, input_shape):
        ph, pw = self.padding
        return N.SpatialZeroPadding(pw, pw, ph, ph)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        return (c, h + 2 * self.padding[0], w + 2 * self.padding[1])


class BatchNormalization(KerasLayer):
    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99, **kw):
        super().__init__(**kw)
        self.epsilon = epsilon
        self.momentum = momentum

    def build(self, input_shape):
        # our BatchNormalization momentum is the update fraction (Torch style),
        # Keras momentum is the retain fraction
        mom = 1.0 - self.momentum
        if len(input_shape) == 3:
            return N.SpatialBatchNormalization(input_shape[0], eps=self.epsilon,
                                               momentum=mom)
        return N.BatchNormalization(input_shape[0], eps=self.epsilon, momentum=mom)

    def compute_output_shape(self, input_shape):
        return input_shape


class Embedding(KerasLayer):
    """(batch, seq) int indices → (batch, seq, output_dim). 0-based indices."""

    def __init__(self, input_dim: int, output_dim: int, init=None, **kw):
        super().__init__(**kw)
        self.input_dim, self.output_dim = input_dim, output_dim
        self.init = init

    def build(self, input_shape):
        return N.LookupTable(self.input_dim, self.output_dim, w_init=_resolve_init(self.init),
                             zero_based=True)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape) + (self.output_dim,)


class _RecurrentLayer(KerasLayer):
    _cell = None

    def __init__(self, output_dim: int, return_sequences: bool = False,
                 go_backwards: bool = False, **kw):
        super().__init__(**kw)
        self.output_dim = output_dim
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards

    def _make_cell(self, input_size):
        return self._cell(input_size, self.output_dim)

    def _check_input_shape(self, input_shape):
        if len(input_shape) != 2:
            raise ValueError(
                f"recurrent layers expect (time, features) input, got {input_shape}")

    def build(self, input_shape):
        self._check_input_shape(input_shape)
        seq = N.Sequential()
        if self.go_backwards:
            seq.add(_ReverseTime())
        seq.add(N.Recurrent(self._make_cell(input_shape[1])))
        if not self.return_sequences:
            seq.add(N.Select(2, -1))  # last timestep (1-based dims)
        return seq

    def compute_output_shape(self, input_shape):
        if self.return_sequences:
            return (input_shape[0], self.output_dim)
        return (self.output_dim,)


class _ReverseTime(N.TensorModule):
    """Flip the time axis of (batch, time, feature)."""

    def run(self, input, state=None):
        return input.flip(1), state


class LSTM(_RecurrentLayer):
    @property
    def _cell(self):
        return N.LSTM


class GRU(_RecurrentLayer):
    @property
    def _cell(self):
        return N.GRU


class SimpleRNN(_RecurrentLayer):
    @property
    def _cell(self):
        return N.RnnCell


class Convolution1D(KerasLayer):
    """1-D conv on (steps, features) — keras-1.2 ``Convolution1D``, over
    the native NWC TemporalConvolution."""

    def __init__(self, nb_filter: int, filter_length: int,
                 activation: Optional[str] = None, border_mode: str = "valid",
                 subsample_length: int = 1, bias: bool = True, init=None, **kw):
        super().__init__(**kw)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid|same, got {border_mode!r}")
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.activation = activation
        self.border_mode = border_mode
        self.subsample_length = subsample_length
        self.bias = bias
        self.init = init

    def build(self, input_shape):
        steps, features = input_shape
        conv = N.TemporalConvolution(features, self.nb_filter,
                                     self.filter_length,
                                     self.subsample_length,
                                     with_bias=self.bias, w_init=_resolve_init(self.init))
        if self.border_mode == "same":
            # exact TF/keras SAME split (shared helper — convolution.py)
            from bigdl_tpu_torch.nn.convolution import same_pad
            k, s = self.filter_length, self.subsample_length
            left, right = same_pad(steps, k, s)
            needed = left + right
            seq = N.Sequential()
            if left:
                seq.add(N.Padding(1, -left, num_input_dims=2))
            if needed - left:
                seq.add(N.Padding(1, needed - left, num_input_dims=2))
            conv = seq.add(conv)
        return self._with_activation(conv, self.activation)

    def compute_output_shape(self, input_shape):
        steps, _ = input_shape
        k, s = self.filter_length, self.subsample_length
        if self.border_mode == "same":
            return ((steps + s - 1) // s, self.nb_filter)
        return ((steps - k) // s + 1, self.nb_filter)


class _Pooling1D(KerasLayer):
    def __init__(self, pool_length: int = 2, stride: Optional[int] = None,
                 **kw):
        super().__init__(**kw)
        self.pool_length = pool_length
        self.stride = stride if stride is not None else pool_length

    def compute_output_shape(self, input_shape):
        steps, f = input_shape
        return ((steps - self.pool_length) // self.stride + 1, f)


class MaxPooling1D(_Pooling1D):
    def build(self, input_shape):
        return N.TemporalMaxPooling(self.pool_length, self.stride)


class GlobalMaxPooling1D(KerasLayer):
    def build(self, input_shape):
        return N.Sequential().add(N.TemporalMaxPooling(-1)).add(
            N.Reshape([input_shape[1]]))

    def compute_output_shape(self, input_shape):
        return (input_shape[1],)


class GlobalMaxPooling2D(KerasLayer):
    def build(self, input_shape):
        c, h, w = input_shape
        return N.Sequential().add(N.SpatialMaxPooling(w, h)) \
                             .add(N.Reshape([c]))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class LayerNormalization(KerasLayer):
    """LayerNorm over the trailing feature axis (the port's LayerNorm
    kernel on the card)."""

    def __init__(self, epsilon: float = 1e-5, **kw):
        super().__init__(**kw)
        self.epsilon = epsilon

    def build(self, input_shape):
        return N.LayerNorm(input_shape[-1], eps=self.epsilon)

    def compute_output_shape(self, input_shape):
        return input_shape


# --------------------------------------------------------------- round-3 batch
class Permute(KerasLayer):
    """Permute the non-batch dims (keras 1-based ``dims``)."""

    def __init__(self, dims, **kw):
        super().__init__(**kw)
        self.dims = tuple(int(d) for d in dims)

    def build(self, input_shape):
        # nn.Transpose swaps pairs; express an arbitrary permutation as a
        # sequence of (1-based, batch-counted) swaps via cycle decomposition
        perm = [0] + [d for d in self.dims]              # with batch dim
        swaps, cur = [], list(range(len(perm)))
        for i in range(len(perm)):
            while cur[i] != perm[i]:
                j = cur.index(perm[i])
                swaps.append((i + 1, j + 1))
                cur[i], cur[j] = cur[j], cur[i]
        return N.Transpose(swaps)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape[d - 1] for d in self.dims)


class RepeatVector(KerasLayer):
    """(features,) → (n, features) per sample (keras ``RepeatVector``)."""

    def __init__(self, n: int, **kw):
        super().__init__(**kw)
        self.n = n

    def build(self, input_shape):
        return N.Replicate(self.n, dim=1, n_input_dims=1)

    def compute_output_shape(self, input_shape):
        return (self.n,) + tuple(input_shape)


class Masking(KerasLayer):
    def __init__(self, mask_value: float = 0.0, **kw):
        super().__init__(**kw)
        self.mask_value = mask_value

    def build(self, input_shape):
        return N.Masking(self.mask_value)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class Highway(KerasLayer):
    def __init__(self, activation: Optional[str] = None, bias: bool = True, **kw):
        super().__init__(**kw)
        self.activation = activation
        self.bias = bias

    def build(self, input_shape):
        return N.Highway(input_shape[-1], with_bias=self.bias,
                         activation=_act(self.activation))

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class MaxoutDense(KerasLayer):
    def __init__(self, output_dim: int, nb_feature: int = 4, bias: bool = True,
                 **kw):
        super().__init__(**kw)
        self.output_dim = output_dim
        self.nb_feature = nb_feature
        self.bias = bias

    def build(self, input_shape):
        return N.Maxout(input_shape[-1], self.output_dim, self.nb_feature,
                        with_bias=self.bias)

    def compute_output_shape(self, input_shape):
        return (self.output_dim,)


class _UpSamplingBase(KerasLayer):
    def __init__(self, size, **kw):
        super().__init__(**kw)
        self.size = size


class UpSampling1D(_UpSamplingBase):
    def __init__(self, length: int = 2, **kw):
        super().__init__(length, **kw)

    def build(self, input_shape):
        return N.UpSampling1D(self.size)

    def compute_output_shape(self, input_shape):
        t, f = input_shape
        return (t * self.size, f)


class UpSampling2D(_UpSamplingBase):
    def __init__(self, size=(2, 2), **kw):
        super().__init__(_pair(size), **kw)

    def build(self, input_shape):
        return N.UpSampling2D(self.size)

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        return (c, h * self.size[0], w * self.size[1])


class UpSampling3D(_UpSamplingBase):
    def __init__(self, size=(2, 2, 2), **kw):
        super().__init__(tuple(size), **kw)

    def build(self, input_shape):
        return N.UpSampling3D(self.size)

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        return (c, d * self.size[0], h * self.size[1], w * self.size[2])


class ZeroPadding1D(KerasLayer):
    def __init__(self, padding: int = 1, **kw):
        super().__init__(**kw)
        self.padding = padding

    def build(self, input_shape):
        seq = N.Sequential()
        seq.add(N.Padding(1, -self.padding, num_input_dims=2))
        seq.add(N.Padding(1, self.padding, num_input_dims=2))
        return seq

    def compute_output_shape(self, input_shape):
        t, f = input_shape
        return (t + 2 * self.padding, f)


class ZeroPadding3D(KerasLayer):
    def __init__(self, padding=(1, 1, 1), **kw):
        super().__init__(**kw)
        self.padding = tuple(padding)

    def build(self, input_shape):
        pd, ph, pw = self.padding
        seq = N.Sequential()
        for dim, p in ((2, pd), (3, ph), (4, pw)):
            if p:
                seq.add(N.Padding(dim, -p, num_input_dims=4))
                seq.add(N.Padding(dim, p, num_input_dims=4))
        return seq

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        pd, ph, pw = self.padding
        return (c, d + 2 * pd, h + 2 * ph, w + 2 * pw)


class Cropping1D(KerasLayer):
    def __init__(self, cropping=(1, 1), **kw):
        super().__init__(**kw)
        self.cropping = _pair(cropping)

    def build(self, input_shape):
        t, _ = input_shape
        a, b = self.cropping
        return N.Narrow(2, a + 1, t - a - b)

    def compute_output_shape(self, input_shape):
        t, f = input_shape
        return (t - sum(self.cropping), f)


class Cropping2D(KerasLayer):
    def __init__(self, cropping=((0, 0), (0, 0)), **kw):
        super().__init__(**kw)
        self.cropping = (tuple(cropping[0]), tuple(cropping[1]))

    def build(self, input_shape):
        return N.Cropping2D(self.cropping[0], self.cropping[1])

    def compute_output_shape(self, input_shape):
        c, h, w = input_shape
        (t, b), (l, r) = self.cropping
        return (c, h - t - b, w - l - r)


class Cropping3D(KerasLayer):
    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), **kw):
        super().__init__(**kw)
        self.cropping = tuple(tuple(c) for c in cropping)

    def build(self, input_shape):
        return N.Cropping3D(*self.cropping)

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        (a0, a1), (b0, b1), (c0, c1) = self.cropping
        return (c, d - a0 - a1, h - b0 - b1, w - c0 - c1)


class AveragePooling1D(_Pooling1D):
    def build(self, input_shape):
        return N.TemporalAveragePooling(self.pool_length, self.stride)


class GlobalAveragePooling1D(KerasLayer):
    def build(self, input_shape):
        return N.Sequential().add(N.TemporalAveragePooling(-1)).add(
            N.Reshape([input_shape[1]]))

    def compute_output_shape(self, input_shape):
        return (input_shape[1],)


class _Pooling3D(KerasLayer):
    def __init__(self, pool_size=(2, 2, 2), strides=None, **kw):
        super().__init__(**kw)
        self.pool_size = tuple(pool_size)
        self.strides = tuple(strides) if strides is not None else self.pool_size

    def compute_output_shape(self, input_shape):
        c, d, h, w = input_shape
        kd, kh, kw_ = self.pool_size
        sd, sh, sw = self.strides
        return (c, (d - kd) // sd + 1, (h - kh) // sh + 1, (w - kw_) // sw + 1)


class MaxPooling3D(_Pooling3D):
    def build(self, input_shape):
        kd, kh, kw_ = self.pool_size
        sd, sh, sw = self.strides
        return N.VolumetricMaxPooling(kd, kw_, kh, sd, sw, sh)


class AveragePooling3D(_Pooling3D):
    def build(self, input_shape):
        kd, kh, kw_ = self.pool_size
        sd, sh, sw = self.strides
        return N.VolumetricAveragePooling(kd, kw_, kh, sd, sw, sh)


class Convolution3D(KerasLayer):
    def __init__(self, nb_filter: int, kernel_dim1: int, kernel_dim2: int,
                 kernel_dim3: int, activation: Optional[str] = None,
                 subsample=(1, 1, 1), border_mode: str = "valid",
                 bias: bool = True, **kw):
        super().__init__(**kw)
        if border_mode != "valid":
            raise ValueError("Convolution3D supports border_mode='valid' only")
        self.nb_filter = nb_filter
        self.kernel = (kernel_dim1, kernel_dim2, kernel_dim3)
        self.activation = activation
        self.subsample = tuple(subsample)
        self.bias = bias

    def build(self, input_shape):
        c = input_shape[0]
        kd, kh, kw_ = self.kernel
        sd, sh, sw = self.subsample
        conv = N.VolumetricConvolution(c, self.nb_filter, kd, kw_, kh,
                                       sd, sw, sh, with_bias=self.bias)
        return self._with_activation(conv, self.activation)

    def compute_output_shape(self, input_shape):
        _, d, h, w = input_shape
        kd, kh, kw_ = self.kernel
        sd, sh, sw = self.subsample
        return (self.nb_filter, (d - kd) // sd + 1, (h - kh) // sh + 1,
                (w - kw_) // sw + 1)


class Deconvolution2D(KerasLayer):
    """Transposed conv (keras-1.2 ``Deconvolution2D``) over NCHW."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 subsample=(1, 1), activation: Optional[str] = None,
                 bias: bool = True, **kw):
        super().__init__(**kw)
        self.nb_filter = nb_filter
        self.nb_row, self.nb_col = nb_row, nb_col
        self.subsample = _pair(subsample)
        self.activation = activation
        self.bias = bias

    def build(self, input_shape):
        c = input_shape[0]
        deconv = N.SpatialFullConvolution(
            c, self.nb_filter, self.nb_col, self.nb_row,
            self.subsample[1], self.subsample[0], no_bias=not self.bias)
        return self._with_activation(deconv, self.activation)

    def compute_output_shape(self, input_shape):
        _, h, w = input_shape
        sh, sw = self.subsample
        return (self.nb_filter, (h - 1) * sh + self.nb_row,
                (w - 1) * sw + self.nb_col)


class AtrousConvolution2D(KerasLayer):
    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 atrous_rate=(1, 1), activation: Optional[str] = None,
                 bias: bool = True, **kw):
        super().__init__(**kw)
        self.nb_filter = nb_filter
        self.nb_row, self.nb_col = nb_row, nb_col
        self.atrous_rate = _pair(atrous_rate)
        self.activation = activation
        self.bias = bias

    def build(self, input_shape):
        c = input_shape[0]
        conv = N.SpatialDilatedConvolution(
            c, self.nb_filter, self.nb_col, self.nb_row, 1, 1, 0, 0,
            self.atrous_rate[1], self.atrous_rate[0], with_bias=self.bias)
        return self._with_activation(conv, self.activation)

    def compute_output_shape(self, input_shape):
        _, h, w = input_shape
        eff_h = self.nb_row + (self.nb_row - 1) * (self.atrous_rate[0] - 1)
        eff_w = self.nb_col + (self.nb_col - 1) * (self.atrous_rate[1] - 1)
        return (self.nb_filter, h - eff_h + 1, w - eff_w + 1)


class SeparableConvolution2D(KerasLayer):
    """Depthwise (grouped) conv + 1x1 pointwise (keras
    ``SeparableConvolution2D``)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 depth_multiplier: int = 1, activation: Optional[str] = None,
                 subsample=(1, 1), border_mode: str = "valid",
                 bias: bool = True, **kw):
        super().__init__(**kw)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid|same, got {border_mode!r}")
        self.nb_filter = nb_filter
        self.nb_row, self.nb_col = nb_row, nb_col
        self.depth_multiplier = depth_multiplier
        self.activation = activation
        self.subsample = _pair(subsample)
        self.border_mode = border_mode
        self.bias = bias

    def build(self, input_shape):
        c = input_shape[0]
        pad = -1 if self.border_mode == "same" else 0
        depthwise = N.SpatialConvolution(
            c, c * self.depth_multiplier, self.nb_col, self.nb_row,
            self.subsample[1], self.subsample[0], pad, pad,
            n_group=c, with_bias=False)
        pointwise = N.SpatialConvolution(
            c * self.depth_multiplier, self.nb_filter, 1, 1,
            with_bias=self.bias)
        seq = N.Sequential().add(depthwise).add(pointwise)
        return self._with_activation(seq, self.activation)

    def compute_output_shape(self, input_shape):
        _, h, w = input_shape
        sh, sw = self.subsample
        if self.border_mode == "same":
            oh, ow = -(-h // sh), -(-w // sw)
        else:
            oh = (h - self.nb_row) // sh + 1
            ow = (w - self.nb_col) // sw + 1
        return (self.nb_filter, oh, ow)


class LocallyConnected1D(KerasLayer):
    def __init__(self, nb_filter: int, filter_length: int,
                 subsample_length: int = 1, activation: Optional[str] = None,
                 bias: bool = True, **kw):
        super().__init__(**kw)
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.subsample_length = subsample_length
        self.activation = activation
        self.bias = bias

    def build(self, input_shape):
        t, f = input_shape
        m = N.LocallyConnected1D(t, f, self.nb_filter, self.filter_length,
                                 self.subsample_length, with_bias=self.bias)
        return self._with_activation(m, self.activation)

    def compute_output_shape(self, input_shape):
        t, _ = input_shape
        return ((t - self.filter_length) // self.subsample_length + 1,
                self.nb_filter)


class LocallyConnected2D(KerasLayer):
    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 subsample=(1, 1), activation: Optional[str] = None,
                 bias: bool = True, **kw):
        super().__init__(**kw)
        self.nb_filter = nb_filter
        self.nb_row, self.nb_col = nb_row, nb_col
        self.subsample = _pair(subsample)
        self.activation = activation
        self.bias = bias

    def build(self, input_shape):
        c, h, w = input_shape
        m = N.LocallyConnected2D(c, w, h, self.nb_filter, self.nb_col,
                                 self.nb_row, self.subsample[1],
                                 self.subsample[0], with_bias=self.bias)
        return self._with_activation(m, self.activation)

    def compute_output_shape(self, input_shape):
        _, h, w = input_shape
        sh, sw = self.subsample
        return (self.nb_filter, (h - self.nb_row) // sh + 1,
                (w - self.nb_col) // sw + 1)


class SpatialDropout1D(KerasLayer):
    def __init__(self, p: float = 0.5, **kw):
        super().__init__(**kw)
        self.p = p

    def build(self, input_shape):
        return N.SpatialDropout1D(self.p)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class SpatialDropout2D(SpatialDropout1D):
    def build(self, input_shape):
        return N.SpatialDropout2D(self.p)


class SpatialDropout3D(SpatialDropout1D):
    def build(self, input_shape):
        return N.SpatialDropout3D(self.p)


class GaussianDropout(KerasLayer):
    def __init__(self, p: float = 0.5, **kw):
        super().__init__(**kw)
        self.p = p

    def build(self, input_shape):
        return N.GaussianDropout(self.p)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class GaussianNoise(KerasLayer):
    def __init__(self, sigma: float = 0.1, **kw):
        super().__init__(**kw)
        self.sigma = sigma

    def build(self, input_shape):
        return N.GaussianNoise(self.sigma)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class LeakyReLU(KerasLayer):
    def __init__(self, alpha: float = 0.3, **kw):
        super().__init__(**kw)
        self.alpha = alpha

    def build(self, input_shape):
        return N.LeakyReLU(self.alpha)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class ELU(KerasLayer):
    def __init__(self, alpha: float = 1.0, **kw):
        super().__init__(**kw)
        self.alpha = alpha

    def build(self, input_shape):
        return N.ELU(self.alpha)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class ThresholdedReLU(KerasLayer):
    def __init__(self, theta: float = 1.0, **kw):
        super().__init__(**kw)
        self.theta = theta

    def build(self, input_shape):
        return N.Threshold(self.theta, 0.0)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class PReLU(KerasLayer):
    """Learnable leaky slope. Slope layout by input rank: (features,) →
    per-feature; (C, H, W[, ...]) → per-channel (nn.PReLU broadcasts on the
    channel axis); temporal (steps, features) → ONE shared slope — the native
    PReLU has no per-last-axis broadcast, and a per-timestep slope would be
    silently wrong semantics."""

    def build(self, input_shape):
        if len(input_shape) == 1:
            return N.PReLU(input_shape[0])   # (N, F): per-feature on axis -1
        if len(input_shape) >= 3:
            return N.PReLU(input_shape[0])   # NCHW-style: per-channel
        return N.PReLU(0)                    # (steps, features): shared scalar

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class TimeDistributed(KerasLayer):
    """Apply an inner keras layer at every timestep of (time, ...) input."""

    def __init__(self, layer: KerasLayer, **kw):
        super().__init__(**kw)
        self.layer = layer

    def build(self, input_shape):
        return N.TimeDistributed(self.layer.build(tuple(input_shape[1:])))

    def compute_output_shape(self, input_shape):
        inner = self.layer.compute_output_shape(tuple(input_shape[1:]))
        return (input_shape[0],) + tuple(inner)


class Bidirectional(KerasLayer):
    """Wrap a recurrent keras layer with a backward clone (merge: concat/sum)."""

    def __init__(self, layer: "_RecurrentLayer", merge_mode: str = "concat",
                 **kw):
        super().__init__(**kw)
        if merge_mode not in ("concat", "sum"):
            raise ValueError("merge_mode must be 'concat' or 'sum'")
        if not isinstance(layer, _RecurrentLayer):
            raise TypeError("Bidirectional wraps a recurrent keras layer")
        if layer.go_backwards:
            raise ValueError(
                "Bidirectional already runs both directions; go_backwards on "
                "the wrapped layer has no keras-consistent meaning here")
        self.layer = layer
        self.merge_mode = merge_mode

    def build(self, input_shape):
        cell = self.layer._make_cell(input_shape[1])
        merge = "concat" if self.merge_mode == "concat" else "add"
        if self.layer.return_sequences:
            # BiRecurrent re-reverses the backward outputs so step t aligns
            return N.Sequential().add(N.BiRecurrent(cell, merge=merge))
        # return_sequences=False: keras semantics = [fwd FULL-sequence summary,
        # bwd FULL-sequence summary]. BiRecurrent's re-reversed stream puts the
        # backward summary at t=0, so Select(-1) would grab a one-step state;
        # run the two directions explicitly and take each one's LAST output.
        bwd_cell = self.layer._make_cell(input_shape[1])
        concat = N.ConcatTable()
        concat.add(N.Sequential().add(N.Recurrent(cell)).add(N.Select(2, -1)))
        concat.add(N.Sequential().add(_ReverseTime())
                   .add(N.Recurrent(bwd_cell)).add(N.Select(2, -1)))
        joiner = N.JoinTable(1, n_input_dims=1) if merge == "concat" \
            else N.CAddTable()
        return N.Sequential().add(concat).add(joiner)

    def compute_output_shape(self, input_shape):
        width = self.layer.output_dim * (2 if self.merge_mode == "concat" else 1)
        if self.layer.return_sequences:
            return (input_shape[0], width)
        return (width,)


class SReLU(KerasLayer):
    """S-shaped ReLU with four learnable parameter tensors (keras-1.2
    ``SReLU``); ``shared_axes`` shares parameters across those (1-based,
    non-batch) axes."""

    def __init__(self, shared_axes=None, **kw):
        super().__init__(**kw)
        self.shared_axes = shared_axes

    def build(self, input_shape):
        return N.SReLU(shape=tuple(input_shape),
                       shared_axes=self.shared_axes)

    def compute_output_shape(self, input_shape):
        return tuple(input_shape)


class GlobalAveragePooling3D(KerasLayer):
    def build(self, input_shape):
        c, t, h, w = input_shape
        return N.Sequential() \
            .add(N.VolumetricAveragePooling(t, w, h)) \
            .add(N.Reshape([c]))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class GlobalMaxPooling3D(KerasLayer):
    def build(self, input_shape):
        c, t, h, w = input_shape
        return N.Sequential() \
            .add(N.VolumetricMaxPooling(t, w, h)) \
            .add(N.Reshape([c]))

    def compute_output_shape(self, input_shape):
        return (input_shape[0],)


class ConvLSTM2D(_RecurrentLayer):
    """Convolutional LSTM over (time, channels, rows, cols) input (keras-1.2
    ``ConvLSTM2D``) over the peephole ConvLSTM cell unrolled by
    ``nn.Recurrent``, with the recurrent layers' go_backwards and
    return_sequences."""

    def __init__(self, nb_filter: int, nb_kernel: int = 3,
                 return_sequences: bool = False, go_backwards: bool = False,
                 with_peephole: bool = True, **kw):
        super().__init__(nb_filter, return_sequences=return_sequences,
                         go_backwards=go_backwards, **kw)
        self.nb_kernel = nb_kernel
        self.with_peephole = with_peephole

    def _make_cell(self, input_size):
        return N.ConvLSTMPeephole(
            input_size, self.output_dim, self.nb_kernel, self.nb_kernel,
            with_peephole=self.with_peephole)

    def _check_input_shape(self, input_shape):
        if len(input_shape) != 4:
            raise ValueError(
                f"ConvLSTM2D expects (time, channels, rows, cols) input, "
                f"got {input_shape}")

    def compute_output_shape(self, input_shape):
        t, _, h, w = input_shape
        if self.return_sequences:
            return (t, self.output_dim, h, w)
        return (self.output_dim, h, w)


class Merge(KerasLayer):
    """The keras-1 ``Merge`` LAYER (reference ``keras.Merge``; the functional
    form is :func:`~bigdl_tpu_torch.nn.keras.merge`): combines several inputs by
    ``mode`` (concat|sum|mul|ave|max|dot|cos).

    Two idioms:
    - functional: ``Merge(mode="sum")([node_a, node_b])``;
    - Sequential-first-layer: ``Merge(layers=[branch_a, branch_b],
      mode="concat")`` where each branch is a KerasLayer with a declared
      ``input_shape`` — the built module is a ``ParallelTable`` of the
      branches feeding the merge, consuming a Table of inputs.
    """

    @staticmethod
    def _branch_spec(i, l):
        """(input_shape, output_shape, build_thunk) for a branch — a
        KerasLayer with declared input_shape, or a built keras Sequential/
        Model (which knows its own shapes)."""
        if hasattr(l, "_module") and hasattr(l, "_input_shape"):
            shape = l._input_shape()
            if shape is None:
                raise ValueError(f"Merge branch {i}: empty Sequential")
            return shape, l.output_shape, (lambda: l._module())
        if getattr(l, "input_shape", None) is None:
            raise ValueError(
                f"Merge branch {i} needs a declared input_shape (or pass a "
                f"built keras Sequential/Model)")
        return (l.input_shape, l.compute_output_shape(l.input_shape),
                (lambda: l.build(l.input_shape)))

    def __init__(self, layers=None, mode: str = "sum", concat_axis: int = 1,
                 **kw):
        super().__init__(**kw)
        self.layers = list(layers) if layers is not None else None
        self.mode = mode
        self.concat_axis = concat_axis
        if self.layers is not None:
            if len(self.layers) < 2:
                raise ValueError(
                    f"Merge needs at least 2 branches, got {len(self.layers)}")
            specs = [self._branch_spec(i, l)
                     for i, l in enumerate(self.layers)]
            self.input_shape = tuple(s[0] for s in specs)

    def __call__(self, node):
        from bigdl_tpu_torch.nn.keras.topology import merge_nodes
        if self.layers is not None:
            raise ValueError(
                "functional Merge takes the nodes directly — drop `layers`")
        if not isinstance(node, (list, tuple)):
            raise TypeError("Merge expects a LIST of nodes")
        return merge_nodes(list(node), self.mode, self.concat_axis)

    def build(self, input_shape):
        from bigdl_tpu_torch.nn.keras.topology import _merge_module
        if self.layers is not None:
            specs = [self._branch_spec(i, l)
                     for i, l in enumerate(self.layers)]
            inner, _ = _merge_module(self.mode, [s[1] for s in specs],
                                     self.concat_axis)
            par = N.ParallelTable()
            for _, _, build in specs:
                par.add(build())
            return N.Sequential().add(par).add(inner)
        # bare Table input: input_shape is a tuple of per-input shapes
        if not input_shape or not isinstance(input_shape[0], (tuple, list)):
            raise ValueError(
                f"Merge without `layers` needs multiple inputs (a tuple of "
                f"shapes), got {input_shape}")
        inner, _ = _merge_module(self.mode, list(input_shape),
                                 self.concat_axis)
        return inner

    def compute_output_shape(self, input_shape):
        from bigdl_tpu_torch.nn.keras.topology import _merge_module
        if self.layers is not None:
            shapes = [self._branch_spec(i, l)[1]
                      for i, l in enumerate(self.layers)]
        else:
            shapes = list(input_shape)
        _, shape = _merge_module(self.mode, shapes, self.concat_axis)
        return shape
