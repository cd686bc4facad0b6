"""The TransformerLM option modules of the port against the JAX package, on
the CPU: Swish and CMulTable (the SwiGLU pieces), RMSNorm, LookupTable's
id base and padding row, Dropout, ``cast_floating`` through a ``Table``,
and ``convert.load_jax_params`` on every new parameter layout (the
TransformerLM options', and the recurrent and text layers').

Inputs are made with numpy from a seed and handed to both packages; module
weights move across by path. Tolerances: fp32 outputs within 1e-5 absolute
and relative; RMSNorm under bf16 within 2e-2 (JAX rounds the rsqrt to bf16
before the product, and so does the port: a few bf16 ulps of 2^-8).
Dropout masks cannot equal ``jax.random.bernoulli``'s, so its keep
fraction, scale, determinism under one seed and eval identity are tested,
and that the recomputation under remat sees the forward's masks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.models.transformerlm import TransformerLM
from bigdl_tpu_torch.utils.table import T

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_swish_and_cmul_table_match_jax():
    a, b = _x(3, 5, 8), _x(3, 5, 8, seed=1)
    want_s = np.asarray(jnn.Swish().forward(jnp.asarray(a)))
    got_s = tnn.Swish().forward(torch.from_numpy(a))
    np.testing.assert_allclose(got_s.numpy(), want_s, **TOL)
    want_m = np.asarray(jnn.CMulTable().forward(
        JT(jnp.asarray(a), jnp.asarray(b))))
    got_m = tnn.CMulTable().forward(T(torch.from_numpy(a),
                                      torch.from_numpy(b)))
    np.testing.assert_allclose(got_m.numpy(), want_m, **TOL)


@pytest.mark.parametrize("dtype,weight_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
def test_rms_norm_matches_jax(dtype, weight_dtype):
    """The result's dtype follows JAX's promotion (bf16 input with an fp32
    weight gives fp32; the bf16 policy casts the weight too)."""
    x = _x(4, 7, 32) * 3.0
    w = 1.0 + 0.1 * _x(32, seed=2)
    jparams = {"weight": jnp.asarray(w).astype(weight_dtype)}
    want = jnn.RMSNorm(32).apply(jparams, {},
                                 jnp.asarray(x).astype(dtype))[0]
    tm = tnn.RMSNorm(32)
    load_jax_params(tm, {"weight": w})
    tm.to(getattr(torch, weight_dtype))
    got = tm.forward(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(got.dtype) == f"torch.{want.dtype}"
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("zero_based,padding", [
    (False, None), (False, 0), (False, 3), (True, None), (True, 0),
    (True, 5)])
def test_lookup_table_ids_and_padding_match_jax(zero_based, padding):
    """The default (1-based) layer reads id i from row i - 1, as JAX's does;
    the padding row is masked to zeros by JAX's ``_pad_index`` rule."""
    JaxRNG.set_seed(4)
    jm = jnn.LookupTable(10, 6, padding_value=padding,
                         zero_based=zero_based)
    ids = np.random.default_rng(3).integers(0, 10, (3, 9)).astype(np.int32)
    if not zero_based:
        ids = ids + 1
    want = np.asarray(jm.forward(jnp.asarray(ids)))
    tm = tnn.LookupTable(10, 6, padding_value=padding, zero_based=zero_based)
    load_jax_params(tm, jm.get_params())
    got = tm.forward(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), want)


def test_lookup_table_defaults_to_one_based_ids():
    """``LookupTable(n, d)`` with its default arguments equals JAX's layer
    on 1-based ids (the port used to read them 0-based)."""
    JaxRNG.set_seed(5)
    jm = jnn.LookupTable(8, 4)
    ids = np.array([[1, 2, 8], [8, 3, 1]], np.int32)
    tm = tnn.LookupTable(8, 4)
    load_jax_params(tm, jm.get_params())
    np.testing.assert_array_equal(
        tm.forward(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jm.forward(jnp.asarray(ids))))


def test_cast_floating_maps_through_a_table():
    from bigdl_tpu.nn.precision import cast_floating as jax_cast_floating
    h, w = _x(2, 3, 4), _x(5, 4, seed=1)
    ids = np.arange(3, dtype=np.int32)
    want = jax_cast_floating(JT(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(ids)), jnp.bfloat16)
    got = tnn.cast_floating(T(torch.from_numpy(h), torch.from_numpy(w),
                              torch.from_numpy(ids)), torch.bfloat16)
    assert [v.dtype for v in got.values()] == [
        torch.bfloat16, torch.bfloat16, torch.int32]
    assert [str(v.dtype) for v in want.values()] == [
        "bfloat16", "bfloat16", "int32"]
    for a, b in zip(got.values(), want.values()):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


# ---------------------------------------------------------------- dropout
def test_dropout_keeps_the_fraction_and_scales():
    x = torch.ones(200_000)
    d = tnn.Dropout(0.3, generator=torch.Generator().manual_seed(0))
    y = d.forward(x)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.7) < 5e-3
    np.testing.assert_allclose(y[y != 0].numpy(), 1.0 / 0.7, rtol=1e-6)
    unscaled = tnn.Dropout(0.3, scale=False,
                           generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(unscaled.forward(x).numpy() != 0,
                                  y.numpy() != 0)


def test_dropout_is_deterministic_under_a_seed_and_draws_anew():
    x = torch.from_numpy(_x(64, 32))
    a = tnn.Dropout(0.5, generator=torch.Generator().manual_seed(7))
    b = tnn.Dropout(0.5, generator=torch.Generator().manual_seed(7))
    first = a.forward(x)
    torch.testing.assert_close(first, b.forward(x), rtol=0, atol=0)
    assert not torch.equal(first, a.forward(x))      # a second draw
    torch.manual_seed(11)
    c = tnn.Dropout(0.5).forward(x)
    torch.manual_seed(11)
    torch.testing.assert_close(c, tnn.Dropout(0.5).forward(x), rtol=0,
                               atol=0)


@pytest.mark.parametrize("p", [0.0, 0.4])
def test_dropout_is_the_identity_in_eval_mode_and_at_zero(p):
    x = torch.from_numpy(_x(8, 16))
    d = tnn.Dropout(p)
    assert torch.equal(d.evaluate().forward(x), x)
    d.train()
    if p == 0.0:
        assert torch.equal(d.forward(x), x)
    d.set_p(0.0)
    assert torch.equal(d.forward(x), x)
    with pytest.raises(ValueError):
        d.set_p(1.0)
    with pytest.raises(ValueError):
        tnn.Dropout(-0.1)


def test_dropout_under_remat_recomputes_with_the_forward_masks():
    """The recomputation of a ``Remat`` block reuses the masks the forward
    drew, so its gradients equal the plain block's with the same masks."""
    def block(remat):
        g = torch.Generator().manual_seed(0)
        inner = (tnn.Sequential()
                 .add(tnn.TimeDistributed(tnn.Linear(8, 8, generator=g)))
                 .add(tnn.Dropout(0.5, generator=torch.Generator()
                                  .manual_seed(3)))
                 .add(tnn.Swish())
                 .add(tnn.Dropout(0.5, generator=torch.Generator()
                                  .manual_seed(4))))
        return tnn.Remat(inner) if remat else inner

    x = torch.from_numpy(_x(2, 5, 8))
    grads = []
    for remat in (False, True):
        m = block(remat)
        loss = m.forward(x).square().sum()
        grads.append(torch.autograd.grad(loss, list(m.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------- parameter layouts
@pytest.mark.parametrize("opts", [
    dict(num_kv_heads=2),
    dict(num_kv_heads=1, position="rope"),
    dict(norm="rms", mlp_kind="swiglu"),
    dict(fused_head=True),
    dict(remat=True, num_kv_heads=2, norm="rms", fused_head=True),
    dict(dropout=0.1, position="rope", mlp_kind="swiglu"),
], ids=["gqa", "mqa-rope", "rms-swiglu", "fused-head", "remat-llama",
        "dropout"])
def test_load_jax_params_carries_every_layout(opts):
    """The port's parameter paths equal the JAX tree's for each option
    (``q_weight``/``kv_weight`` and their biases, RMSNorm's ``weight``,
    the head's ``weight``/``bias``, the ``"0"`` level under remat), and
    every leaf arrives."""
    JaxRNG.set_seed(6)
    jlm = JaxTransformerLM(50, embed_dim=32, num_heads=4, num_layers=2,
                           max_len=16, **opts)
    tlm = TransformerLM(50, 32, 4, 2, 16, device="cpu", **opts)
    tree = flatten_tree(jlm.get_params())
    assert sorted(tree) == sorted(n for n, _ in tlm.named_parameters())
    load_jax_params(tlm, jlm.get_params())
    for n, p in tlm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(tree[n]))


def _recurrent_layouts():
    from bigdl_tpu.nn.tree import BinaryTreeLSTM as JBinaryTreeLSTM

    def tree(pkg):
        return (JBinaryTreeLSTM(6, 8) if pkg is jnn
                else pkg.BinaryTreeLSTM(6, 8))
    return {
        "birecurrent": lambda pkg: pkg.BiRecurrent(pkg.LSTMPeephole(5, 6)),
        "multi-rnn-cell": lambda pkg: pkg.Recurrent(pkg.MultiRNNCell(
            [pkg.LSTM(5, 6), pkg.GRU(6, 6), pkg.RnnCell(6, 4)])),
        "bi-multi": lambda pkg: pkg.BiRecurrent(pkg.MultiRNNCell(
            [pkg.GRU(5, 6), pkg.LSTM(6, 6)]), merge="add"),
        "conv-lstm": lambda pkg: pkg.Recurrent(pkg.ConvLSTMPeephole(2, 3)),
        "conv-lstm-3d": lambda pkg: pkg.Recurrent(
            pkg.ConvLSTMPeephole3D(2, 3, with_peephole=False)),
        "decoder": lambda pkg: pkg.RecurrentDecoder(3, pkg.LSTM(4, 4)),
        "tree": tree,
        "temporal": lambda pkg: pkg.Sequential().add(
            pkg.TemporalConvolution(4, 5, 3)).add(pkg.Linear(5, 2)),
    }


@pytest.mark.parametrize("layout", sorted(_recurrent_layouts()))
def test_load_jax_params_carries_the_recurrent_layouts(layout):
    """The recurrent and text layers' parameter paths equal the JAX
    tree's (a cell under ``"0"``, ``BiRecurrent``'s ``"0"``/``"1"``,
    ``MultiRNNCell``'s ``"0"``, ``"1"``, ... nesting, the peepholes, the
    tree's ``w_x``/``u_l``/``u_r``, the temporal convolution's (kw, in,
    out) weight), and every leaf arrives."""
    build = _recurrent_layouts()[layout]
    JaxRNG.set_seed(7)
    jm, tm = build(jnn), build(tnn)
    tree = flatten_tree(jm.get_params())
    assert sorted(tree) == sorted(n for n, _ in tm.named_parameters())
    load_jax_params(tm, jm.get_params())
    for n, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(tree[n]))
