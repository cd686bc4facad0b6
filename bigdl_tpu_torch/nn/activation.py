"""Element-wise activations.

Counterpart of ``bigdl_tpu/nn/activation.py``, every layer of it.
``jax.nn.gelu`` defaults to the tanh approximation, so GELU here is
``F.gelu(x, approximate="tanh")``; Swish is ``jax.nn.silu`` (``x *
sigmoid(x)``), the gate of the SwiGLU MLP. LogSoftMax, SoftMax and SoftMin
are fp32 islands: they compute and return fp32 whatever the input dtype,
as the JAX layers do. ``PReLU``'s slopes follow the channel axis of
``nn/layout.py`` for spatial input; ``SReLU`` keeps JAX's four parameters
(``t_left``, ``a_left``, ``t_right``, ``a_right``). JAX's ``jnp.where``
chooses a branch per element, so its gradient flows through the chosen
branch only, as ``torch.where``'s does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import layout
from bigdl_tpu_torch.nn.abstractnn import TensorModule


class GELU(TensorModule):
    def run(self, input, state=None):
        return F.gelu(input, approximate="tanh"), state


class Swish(TensorModule):
    def run(self, input, state=None):
        return F.silu(input), state


class LogSoftMax(TensorModule):
    """Log-softmax over the last axis, an fp32 island."""

    def run(self, input, state=None):
        return F.log_softmax(input.float(), dim=-1), state


class SoftMax(TensorModule):
    """Softmax over the last axis, an fp32 island."""

    def run(self, input, state=None):
        return F.softmax(input.float(), dim=-1), state


class SoftMin(TensorModule):
    """Softmax of the negated input over the last axis, an fp32 island."""

    def run(self, input, state=None):
        return F.softmax(-input.float(), dim=-1), state


class ReLU(TensorModule):
    def __init__(self, ip: bool = False):   # in place: not used, as in JAX
        super().__init__()

    def run(self, input, state=None):
        return F.relu(input), state


class ReLU6(TensorModule):
    def run(self, input, state=None):
        return input.clamp(0.0, 6.0), state


class Tanh(TensorModule):
    def run(self, input, state=None):
        return torch.tanh(input), state


class Sigmoid(TensorModule):
    def run(self, input, state=None):
        return torch.sigmoid(input), state


class HardTanh(TensorModule):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0):
        super().__init__()
        self.min_value, self.max_value = min_value, max_value

    def run(self, input, state=None):
        return input.clamp(self.min_value, self.max_value), state


class HardSigmoid(TensorModule):
    def run(self, input, state=None):
        return (0.2 * input + 0.5).clamp(0.0, 1.0), state


class ELU(TensorModule):
    def __init__(self, alpha: float = 1.0, inplace: bool = False):
        super().__init__()
        self.alpha = alpha

    def run(self, input, state=None):
        return F.elu(input, self.alpha), state


class SoftPlus(TensorModule):
    """``softplus(beta * x) / beta``; ``jax.nn.softplus`` has no linear
    cut-over, so neither has this one."""

    def __init__(self, beta: float = 1.0):
        super().__init__()
        self.beta = beta

    def run(self, input, state=None):
        return torch.logaddexp(self.beta * input,
                               torch.zeros((), dtype=input.dtype,
                                           device=input.device)) \
            / self.beta, state


class SoftSign(TensorModule):
    def run(self, input, state=None):
        return input / (1.0 + input.abs()), state


class LeakyReLU(TensorModule):
    def __init__(self, negval: float = 0.01, inplace: bool = False):
        super().__init__()
        self.negval = negval

    def run(self, input, state=None):
        return torch.where(input >= 0, input, self.negval * input), state


class PReLU(TensorModule):
    """A learned leaky slope, 0.25 at init; ``n_output_plane=0`` shares one
    slope, else one a channel (the layout's channel axis for spatial
    input, the last axis for (N, C))."""

    def __init__(self, n_output_plane: int = 0):
        super().__init__()
        self.n_output_plane = n_output_plane
        self.weight = torch.nn.Parameter(
            torch.full((max(n_output_plane, 1),), 0.25))

    def run(self, input, state=None):
        w = self.weight
        if self.n_output_plane > 0 and input.dim() >= 3:
            w = w.reshape(layout.bias_shape(self.n_output_plane, input.dim()))
        return torch.where(input > 0, input, w * input), state


class Exp(TensorModule):
    def run(self, input, state=None):
        return torch.exp(input), state


class Log(TensorModule):
    def run(self, input, state=None):
        return torch.log(input), state


class Sqrt(TensorModule):
    def run(self, input, state=None):
        return torch.sqrt(input), state


class Square(TensorModule):
    def run(self, input, state=None):
        return input.square(), state


class Abs(TensorModule):
    def run(self, input, state=None):
        return input.abs(), state


class Clamp(TensorModule):
    def __init__(self, min_value: float, max_value: float):
        super().__init__()
        self.min_value, self.max_value = float(min_value), float(max_value)

    def run(self, input, state=None):
        return input.clamp(self.min_value, self.max_value), state


class Power(TensorModule):
    """``(shift + scale * x) ** power``."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0):
        super().__init__()
        self.power, self.scale, self.shift = power, scale, shift

    def run(self, input, state=None):
        return torch.pow(self.shift + self.scale * input, self.power), state


class MulConstant(TensorModule):
    def __init__(self, constant: float, inplace: bool = False):
        super().__init__()
        self.constant = constant

    def run(self, input, state=None):
        return input * self.constant, state


class AddConstant(TensorModule):
    def __init__(self, constant: float, inplace: bool = False):
        super().__init__()
        self.constant = constant

    def run(self, input, state=None):
        return input + self.constant, state


class BinaryThreshold(TensorModule):
    """1 where the input exceeds ``th``, else 0, in the input's dtype (no
    gradient, as JAX's cast of a comparison has none)."""

    def __init__(self, th: float = 1e-6, ip: bool = False):
        super().__init__()
        self.th = th

    def run(self, input, state=None):
        return (input > self.th).to(input.dtype), state


class LogSigmoid(TensorModule):
    def run(self, input, state=None):
        return F.logsigmoid(input), state


class TanhShrink(TensorModule):
    """``x - tanh(x)``."""

    def run(self, input, state=None):
        return input - torch.tanh(input), state


class SReLU(TensorModule):
    """S-shaped ReLU with four learned tensors of ``shape`` (the non-batch
    axes; ``shared_axes``, 1-based over them, get size 1):

        y = t_r + a_r (x - t_r)   for x >= t_r
        y = x                     for t_l < x < t_r
        y = t_l + a_l (x - t_l)   for x <= t_l
    """

    def __init__(self, shape=(1,), shared_axes=None):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        self.shared_axes = tuple(shared_axes) if shared_axes else None
        shape = list(self.shape)
        for ax in self.shared_axes or ():
            shape[ax - 1] = 1
        self.t_left = torch.nn.Parameter(torch.zeros(shape))
        self.a_left = torch.nn.Parameter(torch.zeros(shape))
        self.t_right = torch.nn.Parameter(torch.ones(shape))
        self.a_right = torch.nn.Parameter(torch.ones(shape))

    def run(self, input, state=None):
        t_l, a_l, t_r, a_r = self.t_left, self.a_left, self.t_right, \
            self.a_right
        y = torch.where(input >= t_r, t_r + a_r * (input - t_r), input)
        return torch.where(input <= t_l, t_l + a_l * (input - t_l), y), state
