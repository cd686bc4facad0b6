"""Graph plumbing layers of the reference's TensorFlow package.

Counterpart of ``bigdl_tpu/nn/tf_utils.py``: ``Const`` (a stored
constant, kept as a buffer so that it lives on the module's device and a
captured program copies nothing from the host), ``Fill`` (a static shape
filled with a scalar tensor's value), ``Shape`` (the input's shape as an
integer tensor on the input's device, made there: no host read and no
copy; int64, PyTorch's index type, where JAX's is int32), ``StrideSlice``
(0-based ``(dim, start, stop, step)`` specs; a negative step flips the
axis first, as Python slicing does) and ``SplitAndSelect``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.utils.table import Table


class Const(TensorModule):
    """Emits its constant whatever the input (the input only places the
    node in a graph)."""

    def __init__(self, value):
        super().__init__()
        self.value = np.asarray(value)
        self.register_buffer("const", torch.from_numpy(self.value.copy()),
                             persistent=False)

    def run(self, input, state=None):
        return self.const, state

    def extra_repr(self):
        return f"shape={tuple(self.value.shape)}"


class Fill(TensorModule):
    """``Table(shape, value)``: the static ``shape`` filled with ``value``
    (a tensor, which stays on its device). The shape is static in JAX (a
    trace-time constant): give it as a host array or sequence, since
    reading a device tensor's values is a host read, which a captured
    program cannot make."""

    def run(self, input, state=None):
        xs = input.values() if isinstance(input, Table) else list(input)
        if len(xs) != 2:
            raise ValueError("Fill expects Table(shape, value)")
        shape, value = xs
        shape = tuple(int(s) for s in (shape.tolist() if isinstance(
            shape, torch.Tensor) else np.asarray(shape)))
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(value)
        return value.reshape(()).expand(shape).clone(), state


class Shape(TensorModule):
    """The input's shape as an int64 vector on the input's device."""

    def run(self, input, state=None):
        out = torch.empty(input.dim(), dtype=torch.int64, device=input.device)
        for i, n in enumerate(input.shape):
            out[i].fill_(n)     # a fill on the device, no copy from the host
        return out, state


class StrideSlice(TensorModule):
    """Strided slices by ``(dim, start, stop, step)`` specs, dims 0-based
    over the whole input (the batch axis included); other axes whole."""

    def __init__(self, specs: Sequence[Sequence[int]]):
        super().__init__()
        self.specs = [tuple(int(v) for v in s) for s in specs]
        for s in self.specs:
            if len(s) != 4:
                raise ValueError(
                    f"each spec is (dim, start, stop, step), got {s}")
            if s[3] == 0:
                raise ValueError("slice step must be nonzero")

    def run(self, input, state=None):
        out = input
        for dim, start, stop, step in self.specs:
            if not 0 <= dim < input.dim():
                raise ValueError(f"StrideSlice dim {dim} out of range for "
                                 f"rank {input.dim()}")
            n = input.shape[dim]
            idx = range(n)[slice(start, stop, step)]
            first = idx.start
            if step < 0:    # torch slices take positive steps: flip first
                out, first = out.flip(dim), n - 1 - idx.start
            out = out[(slice(None),) * dim + (slice(
                first, first + len(idx) * abs(step), abs(step)),)]
        return out, state


class SplitAndSelect(TensorModule):
    """Chunk ``index`` (0-based) of ``num_split`` equal chunks along
    ``dim``."""

    def __init__(self, dim: int, index: int, num_split: int):
        super().__init__()
        self.dim, self.index, self.num_split = int(dim), int(index), \
            int(num_split)
        if not 0 <= self.index < self.num_split:
            raise ValueError(
                f"index {index} out of range for {num_split} splits")

    def run(self, input, state=None):
        n = input.shape[self.dim]
        if n % self.num_split:
            raise ValueError(f"dim {self.dim} size {n} not divisible by "
                             f"{self.num_split}")
        size = n // self.num_split
        return input.narrow(self.dim, self.index * size, size), state


from bigdl_tpu_torch.utils.serializer import register as _register  # noqa: E402

for _cls in (Const, Fill, Shape, StrideSlice, SplitAndSelect):
    _register(_cls)
