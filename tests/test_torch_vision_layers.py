"""The port's vision layers against the JAX package, on the CPU.

Every layer of the vision slice (``nn/layout.py``, the initialisers, ReLU,
Tanh, Reshape, View, ImageNormalize, SpatialConvolution, the two poolings,
BatchNormalization and SpatialBatchNormalization, ``FusedConvBNReLU`` and
``fuse_conv_bn``) gets the same numpy input as its JAX counterpart, with
the same parameters and state moved across by path
(``convert.load_jax_params``/``load_jax_state``), in NCHW and in NHWC and
in training and eval mode. Gradients are held against ``jax.grad`` of the
same weighted sum. Tolerances: fp32 outputs within 1e-5 and gradients
within 1e-4 (the same formulas, sums in another order; convolutions are
oneDNN here and XLA there); bf16 outputs within 2e-2 relative to their
scale (a few bf16 ulps). Both packages' image formats and engines are reset
after each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.kernels.conv_bn import FusedConvBNReLU as JaxFused
from bigdl_tpu.nn import layout as jlayout
from bigdl_tpu.nn.graph import fuse_conv_bn as jax_fuse_conv_bn
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params, load_jax_state
from bigdl_tpu_torch.kernels.conv_bn import (
    FusedConvBNReLU, fold_bn_into_conv, fold_bn_scale_shift,
)
from bigdl_tpu_torch.nn import layout as tlayout
from bigdl_tpu_torch.utils import engine as torch_engine

FORMATS = ["NCHW", "NHWC"]
ATOL, GRAD_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _reset():
    yield
    jlayout.set_image_format(None)
    tlayout.set_image_format(None)
    jax_engine.Engine.reset()
    torch_engine.Engine.reset()


def _fmt(fmt):
    jlayout.set_image_format(fmt)
    tlayout.set_image_format(fmt)


def _image(shape_nchw, seed=0, fmt="NCHW"):
    x = np.random.default_rng(seed).normal(size=shape_nchw).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(np.moveaxis(x, -3, -1))
    return x


def _port(jm, tm):
    load_jax_params(tm, jm.get_params())
    load_jax_state(tm, jm.get_state())
    return tm


def _compare(jm, tm, x, training, grads=True, atol=ATOL, rtol=1e-7):
    """Forward (and the gradients of sum(out * r)) of both layers on ``x``;
    returns JAX's new state."""
    params, state = jm.get_params(), jm.get_state()
    tm.train(training)

    def fwd(p, xj):
        return jm.apply(p, state, xj, training=training, rng=None)

    out, new_state = jax.jit(fwd)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(grads)
    got = tm(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=atol)
    if not grads:
        return new_state
    r = np.random.default_rng(7).normal(size=np.shape(out)).astype(np.float32)
    gp, gx = jax.jit(jax.grad(lambda p, xj: jnp.sum(fwd(p, xj)[0] * r),
                              argnums=(0, 1)))(params, jnp.asarray(x))
    (got * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               atol=GRAD_ATOL, rtol=rtol)
    for name, g in flatten_tree(jax.device_get(gp)).items():
        np.testing.assert_allclose(
            dict(tm.named_parameters())[name].grad.numpy(), np.asarray(g),
            atol=GRAD_ATOL, err_msg=name)
    return new_state


# ---------------------------------------------------------------- layout
@pytest.mark.parametrize("fmt", FORMATS)
def test_layout_helpers_match_jax(fmt):
    _fmt(fmt)
    assert tlayout.image_format() == jlayout.image_format() == fmt
    assert tlayout.is_nhwc() == jlayout.is_nhwc()
    for ndim in (3, 4):
        assert tlayout.channel_axis(ndim) == jlayout.channel_axis(ndim)
        assert tlayout.spatial_axes(ndim) == jlayout.spatial_axes(ndim)
        assert tlayout.bias_shape(5, ndim) == jlayout.bias_shape(5, ndim)
    x = torch.arange(24.0).reshape(1, 2, 3, 4)
    assert torch.equal(tlayout.from_nchw(tlayout.to_nchw(x)), x)


def test_image_format_reads_the_variable(monkeypatch):
    monkeypatch.setenv("BIGDL_IMAGE_FORMAT", "nhwc")
    assert tlayout.image_format() == jlayout.image_format() == "NHWC"
    monkeypatch.setenv("BIGDL_IMAGE_FORMAT", "bogus")
    assert tlayout.image_format() == "NCHW"
    tlayout.set_image_format("nchw")
    assert tlayout.image_format() == "NCHW"
    with pytest.raises(ValueError):
        tlayout.set_image_format("CHWN")


# ---------------------------------------------------------- initialisers
def test_initialisers_follow_jax_fans():
    g = torch.Generator().manual_seed(0)
    conv = tnn.SpatialConvolution(16, 64, 3, 3, w_init=tnn.MsraFiller(),
                                  with_bias=False, generator=g)
    # JAX's conv fan_out includes the taps: std sqrt(2 / (64·9))
    std = float(conv.weight.detach().std())
    assert abs(std / np.sqrt(2.0 / (64 * 9)) - 1) < 0.05
    avg = tnn.MsraFiller(variance_norm_average=True).init(
        (4000,), fan_in=100, fan_out=300, generator=g)
    assert abs(float(avg.std()) / np.sqrt(2.0 / 200) - 1) < 0.05
    u = tnn.RandomUniform(0.0, 1.0).init((4000,), 1, 1, generator=g)
    assert 0.0 <= float(u.min()) and float(u.max()) <= 1.0
    assert abs(float(u.mean()) - 0.5) < 0.03
    assert torch.equal(tnn.Zeros().init((3,), 1, 1), torch.zeros(3))
    assert torch.equal(tnn.Ones().init((3,), 1, 1), torch.ones(3))
    bn = tnn.BatchNormalization(4000, generator=g)
    assert 0.0 <= float(bn.weight.min()) and float(bn.weight.max()) <= 1.0
    assert float(bn.bias.abs().max()) == 0.0
    assert torch.equal(bn.running_mean, torch.zeros(4000))
    assert torch.equal(bn.running_var, torch.ones(4000))


# ------------------------------------------------- activations and shapes
@pytest.mark.parametrize("name", ["ReLU", "Tanh"])
def test_activations_match_jax(name):
    x = _image((2, 3, 4, 5), seed=1)
    _compare(getattr(jnn, name)(), getattr(tnn, name)(), x, training=True)


@pytest.mark.parametrize("cls", ["Reshape", "View"])
@pytest.mark.parametrize("shape,size,batch_mode", [
    ((4, 784), [1, 28, 28], None),       # batched: 784 = 1·28·28
    ((1, 192), [192], None),             # batch of one
    ((12, 4, 4), [192], None),           # unbatched: 12·4·4 = 192
    ((2, 12, 4, 4), [192], None),
    ((6, 4), [3, 8], False),
])
def test_reshape_and_view_match_jax(cls, shape, size, batch_mode):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    jm = getattr(jnn, cls)(size, batch_mode=batch_mode)
    tm = getattr(tnn, cls)(size, batch_mode=batch_mode)
    want, _ = jm.apply({}, {}, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------- ImageNormalize
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_image_normalize_matches_jax(fmt, dtype):
    _fmt(fmt)
    shape = (2, 5, 6, 3) if fmt == "NHWC" else (2, 3, 5, 6)
    r = np.random.default_rng(3)
    x = (r.integers(0, 256, size=shape).astype(np.uint8) if dtype == "uint8"
         else r.uniform(size=shape).astype(np.float32))
    kw = {} if dtype == "uint8" else dict(scale=1.0)
    want, _ = jnn.ImageNormalize(**kw).apply({}, {}, jnp.asarray(x))
    got = tnn.ImageNormalize(**kw)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_image_normalize_runs_in_the_compute_dtype():
    """Under the bf16 policy a uint8 feed is cast to bf16 (JAX
    ``misc.py:736-738``); one channel, LeNet's mean and std, 3-D input."""
    jax_engine.Engine.init(seed=1, compute_dtype=jnp.bfloat16)
    torch_engine.Engine.init(compute_dtype=torch.bfloat16)
    for mean, std, shape in (((0.485, 0.456, 0.406), (0.229, 0.224, 0.225),
                              (2, 3, 4, 4)),
                             ((0.1307,), (0.3081,), (1, 28, 28))):
        x = np.random.default_rng(4).integers(0, 256, size=shape).astype(
            np.uint8)
        want, _ = jnn.ImageNormalize(mean, std).apply({}, {}, jnp.asarray(x))
        got = tnn.ImageNormalize(mean, std)(torch.from_numpy(x))
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=2e-2,
                                   atol=2e-2)
    with pytest.raises(ValueError, match="pair up"):
        tnn.ImageNormalize((0.5, 0.5), (0.5,))


# ----------------------------------------------------------- convolution
_CONV_CASES = {
    "3x3-s1-p1": dict(args=(3, 8, 3, 3, 1, 1, 1, 1), hw=(9, 9)),
    "5x5-valid": dict(args=(1, 6, 5, 5), hw=(12, 12)),
    "3x3-s2-p1": dict(args=(4, 6, 3, 3, 2, 2, 1, 1), hw=(11, 10)),
    "same-s2": dict(args=(3, 5, 3, 3, 2, 2, -1, -1), hw=(7, 8)),
    "same-4x2": dict(args=(3, 5, 4, 2, 1, 1, -1, -1), hw=(6, 7)),
    "groups": dict(args=(8, 8, 3, 3, 1, 1, 1, 1), kw=dict(n_group=4),
                   hw=(6, 6)),
    "no-bias": dict(args=(3, 4, 1, 1), kw=dict(with_bias=False), hw=(5, 5)),
    "rect-stride": dict(args=(2, 3, 3, 2, 2, 1, 0, 1), hw=(8, 9)),
}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", sorted(_CONV_CASES))
def test_spatial_convolution_matches_jax(case, fmt):
    _fmt(fmt)
    c = _CONV_CASES[case]
    JaxRNG.set_seed(len(case))
    jm = jnn.SpatialConvolution(*c["args"], **c.get("kw", {}))
    tm = _port(jm, tnn.SpatialConvolution(*c["args"], **c.get("kw", {})))
    x = _image((2, c["args"][0]) + c["hw"], seed=5, fmt=fmt)
    _compare(jm, tm, x, training=True)


@pytest.mark.parametrize("fmt", FORMATS)
def test_convolution_unbatched_and_without_input_gradient(fmt):
    _fmt(fmt)
    JaxRNG.set_seed(2)
    jm = jnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1)
    tm = _port(jm, tnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1))
    _compare(jm, tm, _image((3, 6, 5), seed=6, fmt=fmt), training=False)
    frozen = _port(jm, tnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1,
                                              propagate_back=False))
    x = torch.from_numpy(_image((2, 3, 6, 5), seed=6, fmt=fmt))
    x.requires_grad_(True)
    frozen(x * 2.0).sum().backward()
    assert x.grad is None or float(x.grad.abs().max()) == 0.0
    assert float(frozen.weight.grad.abs().max()) > 0.0
    with pytest.raises(ValueError, match="groups"):
        tnn.SpatialConvolution(3, 4, 3, 3, n_group=2)


# --------------------------------------------------------------- pooling
_POOL_CASES = {
    "max-2x2": ("SpatialMaxPooling", (2, 2, 2, 2), {}, (8, 8)),
    "max-3x3-s2-p1": ("SpatialMaxPooling", (3, 3, 2, 2, 1, 1), {}, (9, 10)),
    "max-ceil": ("SpatialMaxPooling", (2, 2, 2, 2), dict(ceil_mode=True),
                 (7, 9)),
    "max-ceil-p1": ("SpatialMaxPooling", (3, 3, 2, 2, 1, 1),
                    dict(ceil_mode=True), (11, 11)),
    "max-wide-pad": ("SpatialMaxPooling", (2, 2, 1, 1, 1, 1), {}, (5, 5)),
    "max-same": ("SpatialMaxPooling", (3, 3, 2, 2),
                 dict(pad_mode="same"), (7, 8)),
    "max-stride>k": ("SpatialMaxPooling", (2, 2, 3, 3), dict(ceil_mode=True),
                     (8, 7)),
    "avg-2x2": ("SpatialAveragePooling", (2, 2, 2, 2), {}, (8, 8)),
    "avg-pad-counted": ("SpatialAveragePooling", (3, 3, 2, 2, 1, 1), {},
                        (9, 9)),
    "avg-pad-not-counted": ("SpatialAveragePooling", (3, 3, 2, 2, 1, 1),
                            dict(count_include_pad=False), (9, 10)),
    "avg-ceil": ("SpatialAveragePooling", (3, 3, 2, 2),
                 dict(ceil_mode=True), (8, 8)),
    "avg-same": ("SpatialAveragePooling", (3, 3, 2, 2),
                 dict(pad_mode="same"), (7, 8)),
    "avg-sum": ("SpatialAveragePooling", (2, 2, 2, 2), dict(divide=False),
                (6, 6)),
    "avg-global": ("SpatialAveragePooling", (1, 1),
                   dict(global_pooling=True), (5, 7)),
}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", sorted(_POOL_CASES))
def test_pooling_matches_jax(case, fmt):
    _fmt(fmt)
    cls, args, kw, hw = _POOL_CASES[case]
    jm, tm = getattr(jnn, cls)(*args, **kw), getattr(tnn, cls)(*args, **kw)
    _compare(jm, tm, _image((2, 3) + hw, seed=8, fmt=fmt), training=True)


@pytest.mark.parametrize("cls", ["SpatialMaxPooling", "SpatialAveragePooling"])
def test_pooling_unbatched_ceil_toggle_and_bf16(cls):
    jm = getattr(jnn, cls)(3, 3, 2, 2).ceil()
    tm = getattr(tnn, cls)(3, 3, 2, 2).ceil()
    assert tm.ceil_mode and not getattr(tnn, cls)(2, 2).floor().ceil_mode
    _compare(jm, tm, _image((3, 8, 8), seed=9), training=False)
    x = _image((2, 3, 8, 9), seed=10)
    want, _ = jm.apply({}, {}, jnp.asarray(x, jnp.bfloat16))
    got = tm(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)
    with pytest.raises(ValueError, match="pad_mode"):
        getattr(tnn, cls)(2, 2, pad_mode="valid")


# ------------------------------------------------------------ batch norm
def _bn_pair(cls, n, seed, **kw):
    JaxRNG.set_seed(seed)
    jm = getattr(jnn, cls)(n, **kw)
    tm = _port(jm, getattr(tnn, cls)(n, **kw))
    if jm.get_state():
        # running statistics away from their (0, 1) init
        r = np.random.default_rng(seed)
        state = {"running_mean": jnp.asarray(r.normal(size=n), jnp.float32),
                 "running_var": jnp.asarray(r.uniform(0.5, 2.0, size=n),
                                            jnp.float32)}
        jm.set_state(state)
        load_jax_state(tm, state)
    return jm, tm


def _check_running(tm, new_state):
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(new_state[k]), atol=1e-6,
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("fmt", FORMATS)
def test_spatial_batch_norm_matches_jax(fmt, training, affine, two_pass,
                                        monkeypatch):
    """Output, gradients and the running statistics after the call (the
    unbiased n/(n-1) update), single-pass and two-pass statistics."""
    if two_pass:
        monkeypatch.setenv("BIGDL_BN_TWO_PASS", "1")
    _fmt(fmt)
    jm, tm = _bn_pair("SpatialBatchNormalization", 5, 11, affine=affine)
    # an offset mean makes E[x^2] - E[x]^2 lose digits, as it does in JAX
    x = _image((4, 5, 6, 7), seed=12, fmt=fmt) * 2.0 + 3.0
    new_state = _compare(jm, tm, x, training)
    _check_running(tm, new_state)


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_2d_matches_jax(training):
    jm, tm = _bn_pair("BatchNormalization", 6, 13, eps=1e-3, momentum=0.3)
    x = np.random.default_rng(14).normal(size=(8, 6)).astype(np.float32)
    _check_running(tm, _compare(jm, tm, x, training))


def test_batch_norm_bf16_is_an_fp32_island():
    """bf16 input: statistics and normalisation in fp32, the output cast
    back to bf16, the running statistics fp32 (``normalization.py:103-133``);
    the parameters bf16, as the mixed step casts them."""
    _fmt("NHWC")
    jm, tm = _bn_pair("SpatialBatchNormalization", 4, 15)
    x = _image((3, 4, 5, 5), seed=16, fmt="NHWC") + 1.0
    params = {k: v.astype(jnp.bfloat16) for k, v in jm.get_params().items()}
    want, st = jm.apply(params, jm.get_state(), jnp.asarray(x, jnp.bfloat16),
                        training=True)
    with torch.no_grad():
        tm.weight.data = tm.weight.data.bfloat16()
        tm.bias.data = tm.bias.data.bfloat16()
    got = tm(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert tm.running_mean.dtype == tm.running_var.dtype == torch.float32
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)
    _check_running(tm, st)


def test_batch_norm_constant_channel_and_sync():
    """A constant channel: the variance is 0 up to rounding (clamped at 0,
    the gradient through the clamp as JAX takes it) and the channel is
    normalised by 1/sqrt(eps) = 316, which magnifies the summation-order
    differences of its input gradient 316 times: held to 1e-3 relative.
    sync=True outside a data-parallel step raises, as JAX's pmean over
    an unbound axis does."""
    jm, tm = _bn_pair("SpatialBatchNormalization", 2, 17)
    x = _image((2, 2, 3, 3), seed=18)
    x[:, 1] = 0.75
    _compare(jm, tm, x, training=True, rtol=1e-3)
    with pytest.raises(NameError, match="unbound axis name"):
        tnn.SpatialBatchNormalization(4, sync=True).train()(
            torch.ones(2, 4, 3, 3))


# ---------------------------------------------- conv-BN fusion and folding
def _conv_bn(relu, with_bias, seed=19):
    JaxRNG.set_seed(seed)
    jconv = jnn.SpatialConvolution(3, 6, 3, 3, 1, 1, 1, 1,
                                   with_bias=with_bias)
    jbn = jnn.SpatialBatchNormalization(6)
    jseq = jnn.Sequential().add(jconv).add(jbn)
    tseq = tnn.Sequential().add(tnn.SpatialConvolution(
        3, 6, 3, 3, 1, 1, 1, 1, with_bias=with_bias)).add(
        tnn.SpatialBatchNormalization(6))
    if relu:
        jseq.add(jnn.ReLU())
        tseq.add(tnn.ReLU())
    _port(jseq, tseq)
    state = {"running_mean": jnp.asarray(np.linspace(-1, 1, 6), jnp.float32),
             "running_var": jnp.asarray(np.linspace(0.5, 2, 6), jnp.float32)}
    jbn.set_state(state)
    load_jax_state(tseq[1], state)
    return jseq, tseq


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_conv_bn_training_is_bitwise_the_unfused_stack(with_bias,
                                                              relu, fmt):
    _fmt(fmt)
    _, tseq = _conv_bn(relu, with_bias)
    fused = tseq[0].fuse_bn(tseq[1], relu=relu)
    x = torch.from_numpy(_image((2, 3, 8, 8), seed=20, fmt=fmt))
    ref_state = [b.clone() for b in tseq[1].buffers()]
    want = tseq(x)
    for b, s in zip(tseq[1].buffers(), ref_state):
        b.copy_(s)
    got = fused(x)
    assert torch.equal(got, want)
    assert [k for k, _ in fused.named_parameters()] == [
        "0.weight"] + (["0.bias"] if with_bias else []) + [
        "1.weight", "1.bias"]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_conv_bn_folded_eval_matches_jax(with_bias, relu, fmt):
    """Eval mode: the BN folded into the convolution, against JAX's fused
    module and the port's unfused stack (1e-5); folding off runs the stack
    itself."""
    _fmt(fmt)
    jseq, tseq = _conv_bn(relu, with_bias)
    jfused = JaxFused(jseq.modules[0], jseq.modules[1], relu=relu)
    tfused = tseq[0].fuse_bn(tseq[1], relu=relu).evaluate()
    x = _image((2, 3, 8, 8), seed=21, fmt=fmt)
    want, _ = jfused.apply(jfused.get_params(), jfused.get_state(),
                           jnp.asarray(x), training=False)
    with torch.no_grad():
        got = tfused(torch.from_numpy(x))
        plain = tseq.evaluate()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    unfolded = FusedConvBNReLU(tseq[0], tseq[1], relu=relu,
                               fold_inference=False).evaluate()
    with torch.no_grad():
        assert torch.equal(unfolded(torch.from_numpy(x)), plain)


def test_fold_helpers_match_jax():
    from bigdl_tpu.kernels import conv_bn as jconv_bn
    r = np.random.default_rng(22)
    w, b = r.normal(size=(4, 3, 3, 3)), r.normal(size=4)
    gamma, beta = r.uniform(size=4), r.normal(size=4)
    mean, var = r.normal(size=4), r.uniform(0.5, 2, size=4)
    f32 = [a.astype(np.float32) for a in (w, b, gamma, beta, mean, var)]
    w, b, gamma, beta, mean, var = f32
    for affine in (True, False):
        js, jsh = jconv_bn.fold_bn_scale_shift(
            {"weight": gamma, "bias": beta} if affine else {},
            {"running_mean": mean, "running_var": var}, 1e-5)
        ts, tsh = fold_bn_scale_shift(
            torch.from_numpy(gamma) if affine else None,
            torch.from_numpy(beta) if affine else None,
            torch.from_numpy(mean), torch.from_numpy(var), 1e-5)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
        np.testing.assert_allclose(tsh.numpy(), np.asarray(jsh), atol=1e-6)
        for bias in (b, None):
            jw, jb = jconv_bn.fold_bn_into_conv(w, bias, js, jsh)
            tw, tb = fold_bn_into_conv(
                torch.from_numpy(w),
                None if bias is None else torch.from_numpy(bias), ts, tsh)
            np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
            np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)


def test_fuse_conv_bn_pass_matches_jax_paths():
    """The pass over a CIFAR ResNet-8 fuses the chains JAX's pass fuses,
    and the fused model's parameter and state paths equal JAX's."""
    from bigdl_tpu.models.resnet import ResNet as JaxResNet

    from bigdl_tpu_torch.models.resnet import ResNet
    JaxRNG.set_seed(23)
    jm = jax_fuse_conv_bn(JaxResNet(10, {"depth": 8,
                                         "shortcutType": "B"}))
    tm = tnn.fuse_conv_bn(ResNet(10, {"depth": 8, "shortcutType": "B"},
                                 device="cpu"))
    n_fused = sum(isinstance(m, FusedConvBNReLU) for m in tm.modules())
    assert n_fused == 9      # stem, 2 per block, 2 projection shortcuts
    load_jax_params(tm, jm.get_params())
    load_jax_state(tm, jm.get_state())
    assert tnn.fuse_conv_bn(tm) is tm
    assert sum(isinstance(m, FusedConvBNReLU) for m in tm.modules()) == 9
