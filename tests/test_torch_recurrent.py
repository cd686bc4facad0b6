"""The port's recurrent layers against the JAX package, on the CPU.

Same weights (moved across by path with ``convert.load_jax_params``), same
numpy inputs made from a seed, small sizes (widths <= 32, T <= 8). Each
case compares the output and the gradients of a weighted sum of it with
respect to every parameter and the input (``jax.grad`` against autograd):

- each cell (``RnnCell``, ``LSTM``, ``LSTMPeephole``, ``GRU``) in
  ``Recurrent``; ``BiRecurrent`` (``concat`` and ``add``);
  ``RecurrentDecoder`` with an (N, F) and an (N, 1, F) seed;
  ``MultiRNNCell`` in ``Recurrent`` and through its ``Table`` API;
  ``Masking``; ``ConvLSTMPeephole`` and ``ConvLSTMPeephole3D`` (an even
  hidden kernel, so SAME pads unevenly; with and without peepholes);
- the bf16 policy's promotion: an LSTM with bf16 parameters and input
  carries JAX's fp32 zero state, so its output is fp32, as JAX's is;
- ``BinaryTreeLSTM`` on a batch of trees of different shapes, one padded.

Tolerances: fp32 outputs within 1e-5 (absolute and relative), gradients
within 1e-4 relative (Frobenius norm of the difference over the norm of
JAX's); bf16 outputs and gradients within 2e-2 relative of JAX's bf16 run
(the same casts in both; bf16 rounds at 2^-9 relative, here through 8
steps of the recurrence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.treelstm.train import random_tree
from bigdl_tpu.nn.tree import BinaryTreeLSTM as JBinaryTreeLSTM
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.utils.table import T

N, STEPS, F_IN, HID = 3, 6, 5, 7


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _pair(build, seed=3):
    """The JAX module and the port's, its weights carried across."""
    JaxRNG.set_seed(seed)
    jm = build(jnn)
    tm = build(nn)
    tree = jax.device_get(jm.get_params())
    assert sorted(flatten_tree(tree)) == sorted(
        n for n, _ in tm.named_parameters())
    load_jax_params(tm, tree)
    return jm, tm


def _check(jm, tm, x, *, fwd_tol=1e-5, grad_tol=1e-4, wrap=None):
    """Output and gradients (every parameter and the input) of
    ``sum(out * w)`` for ``w`` drawn from a seed."""
    wrap = wrap or (lambda a: a)
    want = jm.apply(jm.get_params(), jm.get_state(), wrap(jnp.asarray(x)))[0]
    w = _x(*want.shape, seed=11)

    def jloss(p, xx):
        return (jm.apply(p, jm.get_state(), wrap(xx))[0] * w).sum()

    gp, gx = jax.grad(jloss, argnums=(0, 1))(jm.get_params(), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(wrap(xt))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=fwd_tol, atol=fwd_tol)
    (got * torch.from_numpy(w)).sum().backward()
    assert _rel(xt.grad.numpy(), gx) <= grad_tol
    gp = flatten_tree(jax.device_get(gp))
    for n, p in tm.named_parameters():
        assert _rel(p.grad.numpy(), gp[n]) <= grad_tol, n


CELLS = {
    "RnnCell": lambda pkg: pkg.RnnCell(F_IN, HID),
    "LSTM": lambda pkg: pkg.LSTM(F_IN, HID),
    "LSTMPeephole": lambda pkg: pkg.LSTMPeephole(F_IN, HID),
    "GRU": lambda pkg: pkg.GRU(F_IN, HID),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_in_recurrent_matches_jax(cell):
    jm, tm = _pair(lambda pkg: pkg.Recurrent(CELLS[cell](pkg)))
    _check(jm, tm, _x(N, STEPS, F_IN))
    # one step through the cell's Table API: (out, *new hidden)
    x0, h0 = _x(N, F_IN, seed=1), _x(N, HID, seed=2)
    hidden = (h0, _x(N, HID, seed=4)) if "LSTM" in cell else (h0,)
    want = jm[0].apply(jm[0].get_params(), {},
                       JT(jnp.asarray(x0), *map(jnp.asarray, hidden)))[0]
    got = tm[0](T(torch.from_numpy(x0), *map(torch.from_numpy, hidden)))
    assert len(got) == len(want) == 1 + len(hidden)
    for a, b in zip(got.values(), want.values()):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("merge", ["concat", "add"])
def test_birecurrent_matches_jax(merge):
    jm, tm = _pair(lambda pkg: pkg.BiRecurrent(pkg.LSTM(F_IN, HID), merge))
    assert [n for n, _ in tm.named_parameters()][:1] == ["0.w_ih"]
    # the backward cell's parameters are its own (drawn anew)
    assert not torch.equal(tm[0].w_ih, tm[1].w_ih)
    _check(jm, tm, _x(N, STEPS, F_IN))
    out = tm(torch.from_numpy(_x(N, STEPS, F_IN)))
    assert out.shape == (N, STEPS, HID * (2 if merge == "concat" else 1))


@pytest.mark.parametrize("seed_shape", [(N, HID), (N, 1, HID)],
                         ids=["NF", "N1F"])
def test_recurrent_decoder_matches_jax(seed_shape):
    jm, tm = _pair(lambda pkg: pkg.RecurrentDecoder(5, pkg.LSTM(HID, HID)))
    _check(jm, tm, _x(*seed_shape))
    assert tm(torch.from_numpy(_x(*seed_shape))).shape == (N, 5, HID)


def _multi(pkg):
    return pkg.MultiRNNCell([pkg.LSTM(F_IN, HID), pkg.GRU(HID, HID),
                             pkg.RnnCell(HID, 4)])


def test_multi_rnn_cell_in_recurrent_and_its_table_api_match_jax():
    jm, tm = _pair(lambda pkg: pkg.Recurrent(_multi(pkg)))
    assert "0.1.w_hh" in dict(tm.named_parameters())     # nested per cell
    _check(jm, tm, _x(N, STEPS, F_IN))
    jc, tc = jm[0], tm[0]
    x0 = _x(N, F_IN, seed=5)
    flat = [_x(N, HID, seed=6), _x(N, HID, seed=7), _x(N, HID, seed=8),
            _x(N, 4, seed=9)]
    for hidden in ([], flat):          # zeros, and a given flat hidden
        want = jc.apply(jc.get_params(), jc.get_state(),
                        JT(jnp.asarray(x0), *map(jnp.asarray, hidden)))[0]
        got = tc(T(torch.from_numpy(x0), *map(torch.from_numpy, hidden)))
        assert len(got) == len(want) == 5
        for a, b in zip(got.values(), want.values()):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="expected 4 hidden tensors"):
        tc(T(torch.from_numpy(x0), *map(torch.from_numpy, flat[:3])))


def test_masking_matches_jax():
    x = _x(N, STEPS, F_IN)
    x[0, 2] = 0.0
    x[2, 4:] = 0.0
    jm, tm = jnn.Masking(0.0), nn.Masking(0.0)
    _check(jm, tm, x)


@pytest.mark.parametrize("dims,peephole", [(2, True), (2, False),
                                           (3, True)],
                         ids=["2d", "2d-no-peephole", "3d"])
def test_conv_lstm_matches_jax(dims, peephole):
    def build(pkg):
        cls = pkg.ConvLSTMPeephole if dims == 2 else pkg.ConvLSTMPeephole3D
        return pkg.Recurrent(cls(2, 3, kernel_i=3, kernel_c=2,
                                 with_peephole=peephole))
    jm, tm = _pair(build)
    spatial = (6, 6) if dims == 2 else (4, 4, 4)
    _check(jm, tm, _x(2, 3, 2, *spatial))


def test_lstm_bf16_promotes_as_jax():
    """bf16 parameters and input, fp32 zero state (JAX's): the recurrent
    half and the output are fp32 in both packages; output and gradients of
    the fp32 masters within 2e-2 relative of JAX's."""
    jm, tm = _pair(lambda pkg: pkg.Recurrent(pkg.LSTM(F_IN, HID)))
    x = _x(N, STEPS, F_IN)
    w = _x(N, STEPS, HID, seed=11)
    bf = jnp.bfloat16

    def jloss(p):
        p = jax.tree_util.tree_map(lambda a: a.astype(bf), p)
        out = jm.apply(p, {}, jnp.asarray(x, bf))[0]
        return (out.astype(jnp.float32) * w).sum(), out

    (_, want), gp = jax.value_and_grad(jloss, has_aux=True)(jm.get_params())
    masters = dict(tm.named_parameters())
    got = functional_call(tm, {n: p.to(torch.bfloat16)
                               for n, p in masters.items()},
                          (torch.from_numpy(x).to(torch.bfloat16),))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert _rel(got.detach().numpy(), np.asarray(want)) <= 2e-2
    (got.float() * torch.from_numpy(w)).sum().backward()
    gp = flatten_tree(jax.device_get(gp))
    for n, p in masters.items():
        assert p.grad.dtype == torch.float32
        assert _rel(p.grad.numpy(), np.asarray(gp[n], np.float32)) <= 2e-2, n


def _trees():
    """Children of three trees of 4 leaves (7 nodes) of different shapes
    and of a 3-leaf tree padded to 7 nodes (nodes 5 and 6 unused)."""
    rng = np.random.default_rng(2)
    shapes = set()
    kids = []
    while len(kids) < 3:
        c, _ = random_tree(4, rng)
        if c.tobytes() not in shapes:
            shapes.add(c.tobytes())
            kids.append(c)
    small, _ = random_tree(3, rng)
    kids.append(np.concatenate([small, np.full((2, 2), -1, np.int32)]))
    return np.stack(kids)


def test_binary_tree_lstm_matches_jax():
    children = _trees()
    x = _x(len(children), 7, 6)
    jm, tm = _pair(lambda pkg: (pkg.BinaryTreeLSTM(6, 8) if pkg is nn
                                else JBinaryTreeLSTM(6, 8)))
    assert {"w_x", "u_l", "u_r", "bias"} == {n for n, _ in
                                             tm.named_parameters()}
    _check(jm, tm, x, wrap=lambda xx: (JT(xx, jnp.asarray(children))
                                       if isinstance(xx, jax.Array)
                                       else T(xx, torch.from_numpy(children))))
