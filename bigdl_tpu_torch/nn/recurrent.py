"""Recurrent layers: the cells, ``Recurrent``, ``BiRecurrent``,
``TimeDistributed``, ``Masking``, ``RecurrentDecoder``, ``MultiRNNCell`` and
the convolutional LSTMs.

Counterpart of ``bigdl_tpu/nn/recurrent.py``, with JAX's design:

- a cell computes one timestep, ``cell_apply(x_t, hidden) -> (out_t,
  new_hidden)``, ``hidden`` a tuple of tensors; ``run`` takes JAX's
  ``Table(x_t, *hidden)`` and returns ``Table(out_t, *new_hidden)``;
- gate layouts: i|f|g|o for the LSTMs, r|z|n for the GRU, as
  ``torch.nn.LSTM``/``GRU`` lay them out; parameter keys ``w_ih``,
  ``w_hh``, ``b_ih``, ``b_hh`` (plus the peepholes ``w_ci``/``w_cf``/
  ``w_co``), so ``convert.load_jax_params`` moves them by path;
- the input projection is hoisted (``Cell.input_proj``): ``Recurrent``
  computes ``x @ w_ih.T + b_ih`` for all timesteps as one (N·T, F) x (F, G)
  product before the time loop, which then holds only the (N, H) x (H, G)
  recurrent half;
- the hidden state starts at zero on every forward (no state is carried
  across windows). JAX's zeros are fp32 (the ConvLSTMs' take the input's
  dtype), so under the bf16 policy the recurrent half, the carried state and
  the layer's output are fp32 after step 0, as JAX promotes them: the
  products go through ``precision.promote`` (``torch.matmul`` refuses mixed
  operands).

JAX's time loop is ``lax.scan``; here it is a Python loop over T whose
outputs are stacked, all torch ops, so a captured training step
(``utils/programs.py``) holds the whole unrolled recurrence as one graph.
No library recurrent kernel (``torch.nn.LSTM``/``GRU``, cuDNN) is used. The
cells draw no random numbers (JAX's ignore their ``rng``): dropout goes
between layers.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.abstractnn import (
    AbstractModule, Container, TensorModule, child_state,
)
from bigdl_tpu_torch.nn.initialization import InitializationMethod, RandomUniform
from bigdl_tpu_torch.nn.precision import promote
from bigdl_tpu_torch.utils.table import T, Table


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` with JAX's promotion of mixed operands."""
    x, w = promote(x, w)
    return torch.matmul(x, w.t())


class Cell(TensorModule):
    """Base recurrent cell: one timestep ``(x_t, hidden) -> (out_t,
    new_hidden)``."""

    input_size: int
    hidden_size: int

    def init_hidden(self, batch_size: int, device=None) -> tuple:
        raise NotImplementedError

    def init_hidden_from(self, x0: torch.Tensor) -> tuple:
        """Zero hidden state for the step-0 input ``x0`` (the ConvLSTMs
        shape it from the feature map)."""
        return self.init_hidden(x0.shape[0], x0.device)

    def cell_apply(self, x, hidden):
        raise NotImplementedError

    def input_proj(self, x_seq):
        """(N, T, F) -> the input half of every step's gates, or None (no
        hoisting: the loop runs ``cell_apply``)."""
        return None

    def cell_apply_from_proj(self, gi, hidden):
        raise NotImplementedError

    def reset(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw the parameters anew (``BiRecurrent``'s backward clone)."""
        raise NotImplementedError

    def run(self, input, state=None):
        xs = input.values() if isinstance(input, Table) else list(input)
        out, new_hidden = self.cell_apply(xs[0], tuple(xs[1:]))
        return T(out, *new_hidden), state


class _GateCell(Cell):
    """Cells whose gates split as ``x @ w_ih.T + b_ih`` (the input half,
    hoistable) plus a recurrent half; parameters ``w_ih`` (G, in), ``w_hh``
    (G, H), ``b_ih`` and ``b_hh`` (G,) with G = ``gates`` x H, each drawn
    from ``w_init`` with fan_in H, as in JAX."""

    gates = 1

    def __init__(self, input_size: int, hidden_size: int,
                 w_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.w_init = w_init or RandomUniform()
        self.reset(generator)

    def _param(self, shape, generator) -> torch.nn.Parameter:
        return torch.nn.Parameter(self.w_init.init(
            shape, fan_in=self.hidden_size, fan_out=shape[0],
            generator=generator))

    def reset(self, generator=None) -> None:
        g, h = self.gates * self.hidden_size, self.hidden_size
        self.w_ih = self._param((g, self.input_size), generator)
        self.w_hh = self._param((g, h), generator)
        self.b_ih = self._param((g,), generator)
        self.b_hh = self._param((g,), generator)

    def init_hidden(self, batch_size, device=None):
        return (torch.zeros((batch_size, self.hidden_size),
                            dtype=torch.float32, device=device),)

    def cell_apply(self, x, hidden):
        return self.cell_apply_from_proj(self.input_proj(x), hidden)

    def input_proj(self, x_seq):
        x, w, b = promote(x_seq, self.w_ih, self.b_ih)
        return torch.matmul(x, w.t()) + b

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class RnnCell(_GateCell):
    """Vanilla RNN cell: ``h' = act(W_x x + b_x + W_h h + b_h)``."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation: Callable = torch.tanh,
                 w_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_size, hidden_size, w_init, generator)
        self.activation = activation

    def cell_apply_from_proj(self, gi, hidden):
        (h,) = hidden
        new_h = self.activation(gi + _mm(h, self.w_hh) + self.b_hh)
        return new_h, (new_h,)


class LSTM(_GateCell):
    """LSTM cell; the four gates as one (4H) product, i|f|g|o."""

    gates = 4

    def init_hidden(self, batch_size, device=None):
        z = torch.zeros((batch_size, self.hidden_size), dtype=torch.float32,
                        device=device)
        return (z, z)

    def cell_apply_from_proj(self, gi, hidden):
        h, c = hidden
        gates = gi + _mm(h, self.w_hh) + self.b_hh
        i_g, f_g, g_g, o_g = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f_g) * c + torch.sigmoid(i_g) * torch.tanh(g_g)
        new_h = torch.sigmoid(o_g) * torch.tanh(new_c)
        return new_h, (new_h, new_c)


class LSTMPeephole(LSTM):
    """LSTM with peepholes from the cell state into the i, f and o gates
    (``w_ci``, ``w_cf``, ``w_co``, each (H,))."""

    def reset(self, generator=None) -> None:
        super().reset(generator)
        h = self.hidden_size
        self.w_ci = self._param((h,), generator)
        self.w_cf = self._param((h,), generator)
        self.w_co = self._param((h,), generator)

    def cell_apply_from_proj(self, gi, hidden):
        h, c = hidden
        gates = gi + _mm(h, self.w_hh) + self.b_hh
        i_g, f_g, g_g, o_g = gates.chunk(4, dim=-1)
        i_g = torch.sigmoid(i_g + c * self.w_ci)
        f_g = torch.sigmoid(f_g + c * self.w_cf)
        new_c = f_g * c + i_g * torch.tanh(g_g)
        o_g = torch.sigmoid(o_g + new_c * self.w_co)
        new_h = o_g * torch.tanh(new_c)
        return new_h, (new_h, new_c)


class GRU(_GateCell):
    """GRU cell, r|z|n as ``torch.nn.GRU``."""

    gates = 3

    def cell_apply_from_proj(self, gi, hidden):
        (h,) = hidden
        gh = _mm(h, self.w_hh) + self.b_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        new_h = (1.0 - z) * n + z * h
        return new_h, (new_h,)


def _scan_cell(cell: Cell, x: torch.Tensor) -> torch.Tensor:
    """``cell`` over the time axis of (N, T, ...) ``x``: the (N, T, ...)
    output sequence. The input projection is hoisted out of the loop when
    the cell supports it."""
    proj = cell.input_proj(x)
    hidden = cell.init_hidden_from(x[:, 0])
    outs = []
    for t in range(x.shape[1]):
        if proj is not None:
            out, hidden = cell.cell_apply_from_proj(proj[:, t], hidden)
        else:
            out, hidden = cell.cell_apply(x[:, t], hidden)
        outs.append(out)
    return torch.stack(outs, dim=1)


def _check_cell(owner: str, holds: int, module) -> None:
    if holds:
        raise ValueError(f"{owner} holds exactly one cell")
    if not isinstance(module, Cell):
        raise TypeError(f"{owner} requires a Cell (RnnCell/LSTM/GRU/...)")


class Recurrent(Container):
    """Unroll one cell over the time axis of (batch, time, feature) input;
    the output is the whole (batch, time, hidden) sequence."""

    def __init__(self, cell: Optional[Cell] = None):
        super().__init__(*([cell] if cell is not None else []))

    def add(self, module: AbstractModule) -> "Recurrent":
        _check_cell(type(self).__name__, len(self._modules), module)
        return super().add(module)

    @property
    def cell(self) -> Cell:
        return self[0]

    def run(self, input, state=None):
        return _scan_cell(self.cell, input), state


class BiRecurrent(Container):
    """Bidirectional recurrence: the given cell forward and an independent
    clone (its own parameters, drawn anew) over reversed time, whose output
    is reversed back; ``merge`` "concat" (the feature axis) or "add"."""

    def __init__(self, cell: Optional[Cell] = None, merge: str = "concat",
                 generator: Optional[torch.Generator] = None):
        if merge not in ("concat", "add"):
            raise ValueError("merge must be 'concat' or 'add'")
        super().__init__()
        self.merge = merge
        self._generator = generator
        if cell is not None:
            self.add(cell)

    def add(self, module: AbstractModule) -> "BiRecurrent":
        _check_cell(type(self).__name__, len(self._modules), module)
        bwd = copy.deepcopy(module)
        bwd.reset(self._generator)
        super().add(module)
        return super().add(bwd)

    def run(self, input, state=None):
        out_f = _scan_cell(self[0], input)
        out_b = _scan_cell(self[1], input.flip(1)).flip(1)
        if self.merge == "concat":
            return torch.cat([out_f, out_b], dim=-1), state
        return out_f + out_b, state

    def extra_repr(self):
        return f"merge={self.merge}"


class TimeDistributed(Container):
    """Apply the wrapped module at every timestep of (N, T, ...) input:
    time folded into the batch, one large product on (N*T, ...) instead of
    T small ones."""

    def __init__(self, module: AbstractModule):
        super().__init__(module)

    def run(self, input, state=None):
        n, t = input.shape[0], input.shape[1]
        x = input.reshape((n * t,) + tuple(input.shape[2:]))
        out, s = self[0].run(x, child_state(state, "0"))
        out = out.reshape((n, t) + tuple(out.shape[1:]))
        return out, (None if state is None or s is None else {"0": s})


class Masking(TensorModule):
    """Zero the timesteps whose features all equal ``mask_value``."""

    def __init__(self, mask_value: float = 0.0):
        super().__init__()
        self.mask_value = mask_value

    def run(self, input, state=None):
        keep = (input != self.mask_value).any(dim=-1, keepdim=True)
        return torch.where(keep, input, 0.0), state


class RecurrentDecoder(Recurrent):
    """Decoder recurrence: the cell's output at step t is its input at step
    t+1; the (N, F) input (or (N, 1, F)) seeds step 0. Output (N,
    output_length, F); the cell's input and hidden sizes must match."""

    def __init__(self, output_length: int, cell: Optional[Cell] = None):
        super().__init__(cell)
        if output_length < 1:
            raise ValueError("output_length must be >= 1")
        self.output_length = output_length

    def run(self, input, state=None):
        cell = self.cell
        x = input[:, 0] if input.dim() == 3 else input
        hidden = cell.init_hidden_from(x)
        outs = []
        for _ in range(self.output_length):
            x, hidden = cell.cell_apply(x, hidden)
            outs.append(x)
        return torch.stack(outs, dim=1), state

    def extra_repr(self):
        return f"output_length={self.output_length}"


class ConvLSTMPeephole(Cell):
    """Convolutional LSTM cell with optional peepholes: NCHW hidden and cell
    maps; the four gates from two SAME-padded stride-1 convolutions
    (input -> 4C, ``w_ih``; hidden -> 4C, ``w_hh``) plus ``bias``, the
    peepholes per-channel products. The zero state takes the input's
    dtype, as in JAX."""

    spatial = 2

    def __init__(self, input_size: int, output_size: int, kernel_i: int = 3,
                 kernel_c: int = 3, stride: int = 1,
                 w_init: Optional[InitializationMethod] = None,
                 with_peephole: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stride != 1:
            raise ValueError(
                "ConvLSTMPeephole feedback requires stride 1 (hidden and input "
                "maps must stay the same spatial size)")
        self.input_size, self.hidden_size = input_size, output_size
        self.output_size = output_size
        self.kernel_i, self.kernel_c = kernel_i, kernel_c
        self.with_peephole = with_peephole
        self.w_init = w_init or RandomUniform()
        self.reset(generator)

    def reset(self, generator=None) -> None:
        ci, co, d = self.input_size, self.output_size, self.spatial
        ki, kc = (self.kernel_i,) * d, (self.kernel_c,) * d

        def draw(shape, fan_in):
            return torch.nn.Parameter(self.w_init.init(
                shape, fan_in=fan_in, fan_out=shape[0], generator=generator))

        self.w_ih = draw((4 * co, ci) + ki, ci * self.kernel_i ** d)
        self.w_hh = draw((4 * co, co) + kc, co * self.kernel_c ** d)
        self.bias = torch.nn.Parameter(torch.zeros(4 * co))
        if self.with_peephole:
            self.w_ci = draw((co,), co)
            self.w_cf = draw((co,), co)
            self.w_co = draw((co,), co)

    def init_hidden(self, batch_size, device=None):
        raise TypeError("ConvLSTMPeephole hidden shape depends on the input "
                        "feature map; Recurrent derives it via init_hidden_from")

    def init_hidden_from(self, x0):
        z = x0.new_zeros((x0.shape[0], self.output_size) + tuple(x0.shape[2:]))
        return (z, z)

    def cell_apply(self, x, hidden):
        h, c = hidden
        conv = F.conv2d if self.spatial == 2 else F.conv3d
        per_channel = (1, -1) + (1,) * self.spatial
        gates = (conv(x, self.w_ih, padding="same")
                 + conv(h, self.w_hh, padding="same")
                 + self.bias.reshape(per_channel))
        i_g, f_g, g_g, o_g = gates.chunk(4, dim=1)
        if self.with_peephole:
            i_g = i_g + c * self.w_ci.reshape(per_channel)
            f_g = f_g + c * self.w_cf.reshape(per_channel)
        new_c = torch.sigmoid(f_g) * c + torch.sigmoid(i_g) * torch.tanh(g_g)
        if self.with_peephole:
            o_g = o_g + new_c * self.w_co.reshape(per_channel)
        new_h = torch.sigmoid(o_g) * torch.tanh(new_c)
        return new_h, (new_h, new_c)

    def extra_repr(self):
        return (f"{self.input_size}, {self.output_size}, {self.kernel_i}, "
                f"{self.kernel_c}")


class ConvLSTMPeephole3D(ConvLSTMPeephole):
    """The volumetric cell: NCDHW maps, SAME-padded 3-D convolutions."""

    spatial = 3


class MultiRNNCell(Cell):
    """A stack of cells run as one cell a timestep: cell i's output feeds
    cell i+1, the hidden state is the tuple of the cells' hiddens. The
    cells are its children ``"0"``, ``"1"``, ..., so their parameters nest
    as JAX nests them."""

    def __init__(self, cells: Sequence[Cell]):
        super().__init__()
        cells = list(cells)
        if not cells:
            raise ValueError("MultiRNNCell needs at least one cell")
        for i, c in enumerate(cells):
            if not isinstance(c, Cell):
                raise TypeError(f"MultiRNNCell stacks Cells, got "
                                f"{type(c).__name__}")
            self.add_module(str(i), c)
        self.input_size = cells[0].input_size
        self.hidden_size = cells[-1].hidden_size
        self.output_size = getattr(cells[-1], "output_size",
                                   cells[-1].hidden_size)

    @property
    def cells(self) -> list:
        return list(self._modules.values())

    def reset(self, generator=None) -> None:
        for c in self.cells:
            c.reset(generator)

    def init_hidden(self, batch_size, device=None):
        return tuple(c.init_hidden(batch_size, device) for c in self.cells)

    def init_hidden_from(self, x0):
        hiddens, cur = [], x0
        for c in self.cells:
            hiddens.append(c.init_hidden_from(cur))
            cur = hiddens[-1][0]    # a cell's output is shaped as its h
        return tuple(hiddens)

    def cell_apply(self, x, hidden):
        new_hiddens = []
        out = x
        for c, h in zip(self.cells, hidden):
            out, nh = c.cell_apply(out, h)
            new_hiddens.append(nh)
        return out, tuple(new_hiddens)

    def run(self, input, state=None):
        """JAX's ``Table`` API: ``Table(x, *flat_hidden)``, the flat hidden
        regrouped by each cell's hidden arity (no hidden: zeros), and
        ``Table(out, *flat_new_hidden)`` back."""
        xs = list(input.values()) if isinstance(input, Table) else [input]
        x, flat = xs[0], xs[1:]
        if flat:
            hidden, i = [], 0
            for c in self.cells:
                n = len(c.init_hidden_from(x if not hidden else hidden[-1][0]))
                hidden.append(tuple(flat[i:i + n]))
                i += n
            if i != len(flat):
                raise ValueError(f"MultiRNNCell expected {i} hidden tensors, "
                                 f"got {len(flat)}")
            hidden = tuple(hidden)
        else:
            hidden = self.init_hidden_from(x)
        out, new_h = self.cell_apply(x, hidden)
        return T(out, *[a for h in new_h for a in h]), state
