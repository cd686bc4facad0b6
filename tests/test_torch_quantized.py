"""The port's int8 quantization against the JAX package, on the CPU.

- ``_quantize_weight``'s ``w_q`` and scales, and ``_quantize_activation``'s
  ``x_q`` and scale (fp32 and bf16 input), bit for bit;
- the int32 accumulators of the Linear product and of the convolutions
  (stride, padding, dilation, groups) equal JAX's ``preferred_element_type``
  products, and the zero padding around ``torch._int_mm`` is exact;
- ``QuantizedLinear``, ``QuantizedSpatialConvolution`` and
  ``QuantizedSpatialDilatedConvolution`` in the three modes: outputs within
  1e-5 of the largest entry of JAX's, ``calibrate`` giving JAX's
  ``x_absmax``, a static module serving before calibration raising as JAX's;
- ``quantize_module`` through ``Sequential``, ``Graph`` and
  ``TimeDistributed``: JAX's quantized parameter tree loads by path and the
  outputs agree; ``load_jax_state`` carries ``x_absmax`` and re-arms;
- a ``weight_only`` and a ``static`` tenant of a small LM behind
  ``SnapshotServer`` serve their own greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.nn import quantized as jq
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models.transformerlm import TransformerLM
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.serving import SnapshotServer

MODES = ("dynamic", "weight_only", "static")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _pair(jmod, tmod):
    """The port module with the JAX module's parameters."""
    convert.load_jax_params(tmod, _np(jmod.get_params()))
    return tmod


def _close_to_max(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


def test_weight_and_activation_quantization_bitwise():
    w = _rand(0, 6, 3, 3, 3)
    w[2] = 0.0                                    # an all-zero channel
    jw, js = jq._quantize_weight(w)
    tw, ts = tq._quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(ts, js)
    x = _rand(1, 4, 7, scale=3.0)
    jx, jsc = jq._quantize_activation(jnp.asarray(x))
    tx, tsc = tq._quantize_activation(torch.from_numpy(x))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert float(tsc) == float(jsc)
    xb = torch.from_numpy(x).bfloat16()
    jxb, jsb = jq._quantize_activation(jnp.asarray(xb.float().numpy(),
                                                   jnp.bfloat16))
    txb, tsb = tq._quantize_activation(xb)
    np.testing.assert_array_equal(txb.numpy(), np.asarray(jxb))
    assert float(tsb) == float(jsb)
    z = torch.zeros(3, 4)
    assert float(tq._quantize_activation(z)[1]) == 1.0


def test_int32_accumulators_equal_jax():
    r = np.random.default_rng(2)
    a = r.integers(-127, 128, (19, 37)).astype(np.int8)
    b = r.integers(-127, 128, (11, 37)).astype(np.int8)
    want = lax.dot_general(jnp.asarray(a), jnp.asarray(b),
                           (((1,), (1,)), ((), ())),
                           preferred_element_type=jnp.int32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(tq.int8_matmul(ta, tb).numpy(),
                                  np.asarray(want))
    # the card's padding to > 16 rows and K, N multiples of 8 is exact
    for m in (1, 8, 19):
        got = tq._padded_int_mm(ta[:m], tb, pad=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:m])
    x = r.integers(-127, 128, (2, 4, 9, 10)).astype(np.int8)
    for w_shape, stride, pads, dil, groups in (
            ((6, 4, 3, 3), (1, 1), ((1, 1), (1, 1)), (1, 1), 1),
            ((6, 4, 7, 7), (2, 2), ((3, 3), (3, 3)), (1, 1), 1),
            ((6, 4, 1, 1), (1, 1), ((0, 0), (0, 0)), (1, 1), 1),
            ((6, 2, 3, 3), (2, 1), ((0, 1), (1, 0)), (1, 1), 2),
            ((5, 4, 3, 2), (1, 1), ((2, 2), (1, 1)), (2, 3), 1)):
        w = r.integers(-127, 128, w_shape).astype(np.int8)
        want = lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), window_strides=stride,
            padding=list(pads), rhs_dilation=dil,
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            feature_group_count=groups, preferred_element_type=jnp.int32)
        got = tq.int8_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                             stride, pads, dil, groups)
        np.testing.assert_array_equal(got.permute(0, 3, 1, 2).numpy(),
                                      np.asarray(want))


def _float_modules(kind):
    """(JAX float module, port float module with its weights, input)."""
    JaxRNG.set_seed(3)
    if kind == "linear":
        j = jnn.Linear(12, 7)
        t = nn.Linear(12, 7)
        x = _rand(4, 5, 12)
    elif kind == "conv":
        j = jnn.SpatialConvolution(3, 6, 3, 3, 2, 2, 1, 1)
        t = nn.SpatialConvolution(3, 6, 3, 3, 2, 2, 1, 1)
        x = _rand(4, 2, 3, 9, 9)
    else:
        j = jnn.SpatialDilatedConvolution(3, 5, 3, 3, 1, 1, 2, 2, 2, 2)
        t = nn.SpatialDilatedConvolution(3, 5, 3, 3, 1, 1, 2, 2, 2, 2)
        x = _rand(4, 2, 3, 9, 9)
    return j, _pair(j, t), x


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["linear", "conv", "dilated"])
def test_quantized_modules_match_jax(kind, mode):
    j, t, x = _float_modules(kind)
    jqm = j.quantize(mode).evaluate()
    tqm = t.quantize(mode).evaluate()
    jp, tp = _np(jqm.get_params()), dict(tqm.named_parameters())
    assert set(jp) == set(tp)
    for k in jp:
        assert tp[k].dtype == torch.from_numpy(np.array(jp[k])).dtype
        np.testing.assert_array_equal(tp[k].detach().numpy(), jp[k])
    if mode == "static":
        with pytest.raises(RuntimeError, match="before calibration"):
            jqm.forward(jnp.asarray(x))
        with pytest.raises(RuntimeError, match="before calibration"):
            tqm.forward(torch.from_numpy(x))
        jq.calibrate(jqm, [jnp.asarray(x)])
        tq.calibrate(tqm, [x, 0.5 * x])     # the running absmax: x's
        assert float(tqm.x_absmax) == float(jqm.get_state()["x_absmax"])
    want = np.asarray(jqm.forward(jnp.asarray(x)))
    got = tqm.forward(torch.from_numpy(x)).numpy()
    _close_to_max(got, want)
    t.train()
    with pytest.raises(RuntimeError, match="inference-only"):
        t.quantize(mode).forward(torch.from_numpy(x))


def _jax_stack():
    JaxRNG.set_seed(5)
    inp = jnn.Input()
    conv = jnn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1).inputs(inp)
    relu = jnn.ReLU().inputs(conv)
    flat = jnn.Reshape([4 * 6 * 6]).inputs(relu)
    lin = jnn.Linear(4 * 6 * 6, 5).inputs(flat)
    g = jnn.Graph([inp], [lin])
    return jnn.Sequential().add(g).add(jnn.Reshape([1, 5])).add(
        jnn.TimeDistributed(jnn.Linear(5, 3)))


def _torch_stack():
    inp = nn.Input()
    conv = nn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1).inputs(inp)
    relu = nn.ReLU().inputs(conv)
    flat = nn.Reshape([4 * 6 * 6]).inputs(relu)
    lin = nn.Linear(4 * 6 * 6, 5).inputs(flat)
    g = nn.Graph([inp], [lin])
    return nn.Sequential().add(g).add(nn.Reshape([1, 5])).add(
        nn.TimeDistributed(nn.Linear(5, 3)))


@pytest.mark.parametrize("mode", MODES)
def test_quantize_module_walks_containers(mode):
    j = _jax_stack()
    t = _pair(j, _torch_stack())
    x = _rand(6, 3, 2, 6, 6)
    jqm, tqm = j.quantize(mode).evaluate(), t.quantize(mode).evaluate()
    kinds = [type(m).__name__ for m in tqm.modules()
             if type(m).__name__.startswith("Quantized")]
    assert kinds == ["QuantizedSpatialConvolution", "QuantizedLinear",
                     "QuantizedLinear"]
    assert all(type(m) is not nn.Linear for m in tqm.modules())
    assert isinstance(t[0][0], nn.SpatialConvolution)     # t untouched
    fresh = _torch_stack().quantize(mode).evaluate()
    convert.load_jax_params(fresh, _np(jqm.get_params()))
    if mode == "static":
        jq.calibrate(jqm, [jnp.asarray(x)])
        tq.calibrate(tqm, [x])
        convert.load_jax_state(fresh, _np(jqm.get_state()))
        assert fresh[0][0]._calibrated
    want = np.asarray(jqm.forward(jnp.asarray(x)))
    for m in (tqm, fresh):
        _close_to_max(m.forward(torch.from_numpy(x)).numpy(), want)


@pytest.fixture(scope="module")
def lm_pair():
    JaxRNG.set_seed(21)
    jlm = JaxTransformerLM(64, embed_dim=32, num_heads=4, num_layers=2,
                           max_len=64).evaluate()
    tlm = TransformerLM(64, 32, 4, 2, 64, device="cpu")
    convert.load_jax_params(tlm, _np(jlm.get_params()))
    return jlm, tlm.evaluate()


def test_quantized_lm_tree_matches_jax(lm_pair):
    jlm, tlm = lm_pair
    for mode in ("weight_only", "static"):
        jtree = convert.flatten_tree(_np(jlm.quantize(mode).get_params()))
        tqm = tlm.quantize(mode)
        got = {k: v.detach().numpy() for k, v in tqm.named_parameters()}
        assert set(got) == set(jtree)
        for k, v in jtree.items():
            np.testing.assert_array_equal(got[k], v)


def test_int8_tenants_serve_their_own_greedy_tokens(lm_pair):
    _, tlm = lm_pair
    prompt = np.random.default_rng(7).integers(0, 64, 6).astype(np.int32)
    static = tlm.quantize("static").evaluate()
    tq.calibrate(static, [torch.from_numpy(prompt[None].astype(np.int64))])
    tenants = {"fp32": tlm, "w8": tlm.quantize("weight_only").evaluate(),
               "static": static}
    srv = SnapshotServer(tenants, max_len=64, slots=2, buckets=(16,),
                         device="cpu")
    try:
        out = {name: srv.submit(name, prompt, 6).result(120).tokens
               for name in tenants}
    finally:
        srv.shutdown()
    for name, m in tenants.items():
        want = nn.greedy_generate(m, prompt[None], 6, device="cpu")[0]
        np.testing.assert_array_equal(out[name], want.numpy())
