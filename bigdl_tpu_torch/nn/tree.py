"""Tree-structured recurrence: ``BinaryTreeLSTM``.

Counterpart of ``bigdl_tpu/nn/tree.py:31-99``: the constituency TreeLSTM
with a forget gate per child. Every tree is an array program: nodes are
indexed with the root at 0 and children at larger indices (-1 for none),
and the loop sweeps the node index from high to low, so both children of a
node are done before it. Each step gathers its children's (h, c) from the
state arrays with the index clamped, zeroes a missing child with
``torch.where`` (``:69-74``), and writes its own: trees of any shape batch
together at one padded node count, and nothing in the loop reads the host,
so a captured training step holds it.

JAX writes the node's state in place (``dynamic_update_index_in_dim``,
``:89-90``); autograd keeps the state arrays a step reads, so here each
step builds the next arrays out of place from static slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.abstractnn import AbstractModule
from bigdl_tpu_torch.nn.initialization import (
    InitializationMethod, RandomUniform, Zeros,
)
from bigdl_tpu_torch.utils.table import Table


def _put(arr: torch.Tensor, idx: int, row: torch.Tensor) -> torch.Tensor:
    """``arr`` (N, nodes, H) with node ``idx`` replaced by ``row`` (N, H),
    out of place."""
    return torch.cat([arr[:, :idx], row[:, None], arr[:, idx + 1:]], dim=1)


class BinaryTreeLSTM(AbstractModule):
    """Input: ``Table(x (N, nodes, D), children (N, nodes, 2) int)``,
    ``children[b, i] = (left, right)`` node indices (> i) or -1. Output: the
    per-node hidden states (N, nodes, H); the root's is ``out[:, 0]``. Gate
    layout [i, o, u, f_l, f_r]; parameters ``w_x`` (D, 5H), ``u_l`` and
    ``u_r`` (H, 5H), ``bias`` (5H,), JAX's keys and layout."""

    def __init__(self, input_size: int, hidden_size: int,
                 w_init: Optional[InitializationMethod] = None,
                 b_init: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        w_init = w_init or RandomUniform()
        b_init = b_init or Zeros()
        d, h = input_size, hidden_size

        def mk(shape, fan_in):
            return torch.nn.Parameter(w_init.init(
                shape, fan_in=fan_in, fan_out=shape[-1], generator=generator))

        self.w_x = mk((d, 5 * h), d)
        self.u_l = mk((h, 5 * h), h)
        self.u_r = mk((h, 5 * h), h)
        self.bias = torch.nn.Parameter(b_init.init(
            (5 * h,), fan_in=d, fan_out=5 * h, generator=generator))

    def run(self, input, state=None):
        xs = input.values() if isinstance(input, Table) else list(input)
        x, children = xs[0], xs[1].long()
        n, nodes, _ = x.shape
        h_dim = self.hidden_size
        present = (children >= 0)[..., None]                # (N, nodes, 2, 1)
        safe = children.clamp(0, nodes - 1)[..., None].expand(
            n, nodes, 2, h_dim)
        h_all = x.new_zeros((n, nodes, h_dim))
        c_all = x.new_zeros((n, nodes, h_dim))
        for idx in range(nodes - 1, -1, -1):      # children before parents
            def gather(arr):
                picked = arr.gather(1, safe[:, idx])        # (N, 2, H)
                return torch.where(present[:, idx], picked, 0.0)

            hc, cc = gather(h_all), gather(c_all)
            gates = (x[:, idx] @ self.w_x + hc[:, 0] @ self.u_l
                     + hc[:, 1] @ self.u_r + self.bias)
            i_g, o_g, u_g, fl_g, fr_g = gates.chunk(5, dim=-1)
            c_new = (torch.sigmoid(i_g) * torch.tanh(u_g)
                     + torch.sigmoid(fl_g) * cc[:, 0]
                     + torch.sigmoid(fr_g) * cc[:, 1])
            h_new = torch.sigmoid(o_g) * torch.tanh(c_new)
            h_all = _put(h_all, idx, h_new)
            c_all = _put(c_all, idx, c_new)
        return h_all, state

    def extra_repr(self):
        return f"{self.input_size} -> {self.hidden_size}"
