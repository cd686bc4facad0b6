"""The port's ResNet against the JAX package's, on the CPU.

Same weights and batch-norm state (moved across by path), same numpy
inputs. Checked:

- ``_Conv1SpaceToDepth``: ``transform_7x7`` equals JAX's, and at init the
  s2d stem's output equals the plain 7x7 stride-2 stem's (1e-5), in NCHW
  and NHWC, as JAX's ``tests/test_layout_nhwc.py`` pins it;
- ResNet-20 (CIFAR, batch 4, 32x32): one SGD step (0.1, momentum 0.9,
  weight decay 1e-4) through the port's ``LocalOptimizer`` against JAX's
  step function: the loss, every gradient, the update and the running
  statistics after the step. The loss and the running statistics are
  smooth functions of the weights and agree within 1e-5 in fp32. The
  gradients are not: a ReLU gate whose input lies within rounding of 0
  (over seeds 4-29 the smallest |pre-ReLU| of a 4x32x32 batch is 2e-9 to
  5e-7) can be open in one package and shut in the other, which moves the
  gradients below it by up to ~1% of a tensor (measured: 0.6% on this
  batch). So fp32 gradients and updates are held to 3e-2 relative per
  tensor (Frobenius) and 2e-3 over the whole model. Under the bf16 policy
  rounding alone moves JAX's own gradient 22-28% (relative, whole model)
  from its fp32 gradient at this size (batch norm over 4 images, hundreds
  of flipped gates): the port's bf16 gradient is held to be within 1.25x
  that distance of JAX's fp32 gradient and within 1.5x of JAX's bf16
  gradient (two independent roundings), its update likewise, the loss
  within 1e-2 and the running statistics within 1e-2 relative;
- ResNet-50 (ImageNet, batch 2, 64x64): the forward in training and eval
  mode, NCHW and NHWC, with and without the s2d stem, and the running
  statistics after the training forward. Eval within 1e-4; training mode
  within 5e-3 in log-probability: at 64x64 the last stage's batch
  statistics are over 8 values a channel, so train-mode BN amplifies the
  convolutions' summation-order differences (the eval forward of the same
  weights agrees to 1e-6);
- ResNet-50 (s2d, NHWC, behind ``ImageNormalize``, one (2, 224, 224, 3)
  uint8 batch): the bf16-vs-fp32 gradient gap is JAX's own, and the port's
  bf16 gradient is held to JAX's where rounding does not swamp it (see the
  test's docstring);
- the factory's options: shortcut types A, B and C, ``zeroInitResidual``,
  the depth checks, ``ResNet50``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu.models.resnet.resnet import _Conv1SpaceToDepth as JaxS2D
from bigdl_tpu.nn import layout as jlayout
from bigdl_tpu.nn.precision import cast_floating as jax_cast
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params, load_jax_state
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models.resnet import ResNet, ResNet50
from bigdl_tpu_torch.models.resnet.resnet import _Conv1SpaceToDepth
from bigdl_tpu_torch.nn import layout as tlayout
from bigdl_tpu_torch.utils import engine as torch_engine


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


def _image(shape_nchw, seed, fmt):
    x = np.random.default_rng(seed).normal(size=shape_nchw).astype(np.float32)
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1)) if fmt == "NHWC" \
        else x


def _pair(opt, seed=3):
    JaxRNG.set_seed(seed)
    jm = JaxResNet(10 if opt.get("dataSet") != "ImageNet" else 1000, opt)
    tm = ResNet(10 if opt.get("dataSet") != "ImageNet" else 1000, opt,
                device="cpu")
    load_jax_params(tm, jm.get_params())
    load_jax_state(tm, jm.get_state())
    return jm, tm


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------- the s2d stem
def test_transform_7x7_matches_jax():
    w7 = np.random.default_rng(0).normal(size=(8, 3, 7, 7)).astype(
        np.float32)
    np.testing.assert_array_equal(_Conv1SpaceToDepth.transform_7x7(w7),
                                  JaxS2D.transform_7x7(w7))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_s2d_stem_equals_the_plain_stem_at_init(fmt):
    _fmt(fmt)
    g = torch.Generator().manual_seed(1)
    conv = tnn.SpatialConvolution(3, 16, 7, 7, 2, 2, 3, 3, with_bias=False,
                                  generator=g)
    s2d = _Conv1SpaceToDepth(16, generator=g)
    with torch.no_grad():
        s2d.weight.copy_(torch.from_numpy(_Conv1SpaceToDepth.transform_7x7(
            conv.weight.numpy())))
    x = torch.from_numpy(_image((2, 3, 32, 32), 0, fmt))
    with torch.no_grad():
        ref, out = conv(x), s2d(x)
    assert ref.shape == out.shape
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
    # and against JAX's stem on the same weights
    jstem = JaxS2D(16)
    jstem.set_params({"weight": jnp.asarray(s2d.weight.detach().numpy())})
    want, _ = jstem.apply(jstem.get_params(), {}, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
    # a fresh stem: the taps with no 7x7 pre-image start at zero
    w = _Conv1SpaceToDepth(4, generator=g).weight.detach().numpy()
    assert int((w == 0).sum()) == 4 * (12 * 16 - 3 * 49)


# ------------------------------------------------- ResNet-20: one SGD step
def _jax_one_step(jm, x, y, mixed):
    """JAX's gradients (of the loss as its step computes it), and the
    loss, parameters and state after one step of its step function."""
    crit = jnn.ClassNLLCriterion()
    params, mstate = jm.get_params(), jm.get_state()
    grads = jax.jit(jax.grad(
        lambda p: _jax_loss(jm, p, mstate, x, y, mixed)))(params)
    method = _sgd(joptim)
    opt = joptim.LocalOptimizer(jm, JDataSet.array([]), crit)
    opt.set_optim_method(method)
    step = jax.jit(opt._make_step_fn())
    new_p, new_ms, _, loss = step(params, mstate, method.init_state(params),
                                  jnp.asarray(0, jnp.int32), jnp.asarray(x),
                                  jnp.asarray(y), jax.random.PRNGKey(0))
    return (float(loss), flatten_tree(jax.device_get(grads)),
            flatten_tree(jax.device_get(new_p)),
            flatten_tree(jax.device_get(new_ms)))


def _jax_loss(jm, p, ms, x, y, mixed):
    xx = jnp.asarray(x)
    if mixed:
        p, xx = jax_cast(p, jnp.bfloat16), jax_cast(xx, jnp.bfloat16)
    out, _ = jm.apply(p, ms, xx, training=True)
    if mixed:
        out = jax_cast(out, jnp.float32)
    return jnn.ClassNLLCriterion().apply(out, jnp.asarray(y))


def _sgd(pkg):
    return pkg.SGD(learningrate=0.1, momentum=0.9, dampening=0.0,
                   weightdecay=1e-4)


def _flat(tensors) -> np.ndarray:
    return np.concatenate([np.asarray(t, np.float64).ravel()
                           for t in tensors])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet20_one_sgd_step_matches_jax(dtype):
    mixed = dtype == "bfloat16"
    jax_engine.Engine.init(seed=3, compute_dtype=jnp.bfloat16 if mixed
                           else jnp.float32)
    torch_engine.Engine.init(compute_dtype=getattr(torch, dtype))
    jm, tm = _pair({"depth": 20})
    r = np.random.default_rng(4)
    x = r.normal(size=(4, 3, 32, 32)).astype(np.float32)
    y = r.integers(0, 10, size=4).astype(np.int32)
    want_loss, want_g, want_p, want_s = _jax_one_step(jm, x, y, mixed)

    opt = (toptim.LocalOptimizer(tm, DataSet.array([]),
                                 tnn.ClassNLLCriterion(), device="cpu")
           .set_optim_method(_sgd(toptim)))
    named = dict(tm.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    loss, grads = opt._value_and_grad(list(named.values()),
                                      torch.from_numpy(x), torch.from_numpy(y))
    load_jax_state(tm, jm.get_state())       # that forward moved them
    got_loss = opt.train_step(torch.from_numpy(x), torch.from_numpy(y))
    got_g = _flat(g.numpy() for g in grads)
    ref_g = _flat(want_g[n] for n in named)
    got_u = _flat((p.detach() - before[n]).numpy()
                  for n, p in named.items())
    ref_u = _flat(want_p[n] - before[n].numpy() for n in named)
    bufs = dict(tm.named_buffers())
    assert set(want_s) == set(bufs)
    if mixed:
        flat32 = jax.jit(jax.grad(lambda p: _jax_loss(
            jm, p, jm.get_state(), x, y, False)))(jm.get_params())
        flat32 = flatten_tree(jax.device_get(flat32))
        fp32_g = _flat(flat32[n] for n in named)
        bf16_noise = _rel(ref_g, fp32_g)
        assert 0.05 < bf16_noise < 0.5
        # as close to the fp32 gradient as JAX's bf16 gradient is, and no
        # farther from JAX's bf16 gradient than two such roundings apart
        assert _rel(got_g, fp32_g) < 1.25 * bf16_noise
        assert _rel(got_g, ref_g) < 1.5 * bf16_noise
        assert _rel(got_u, ref_u) < 1.5 * bf16_noise
        loss_tol, state_tol = 1e-2, 1e-2
    else:
        for (name, _), g in zip(named.items(), grads):
            assert _rel(g.numpy(), want_g[name]) < 3e-2, name
        for name, p in named.items():
            assert _rel(p.detach().numpy() - before[name].numpy(),
                        want_p[name] - before[name].numpy()) < 3e-2, name
        assert _rel(got_g, ref_g) < 2e-3
        assert _rel(got_u, ref_u) < 2e-3
        loss_tol, state_tol = 1e-5, 1e-5
    assert float(loss) == pytest.approx(want_loss, rel=loss_tol)
    assert got_loss == pytest.approx(want_loss, rel=loss_tol)
    for name, s in want_s.items():
        np.testing.assert_allclose(bufs[name].numpy(), np.asarray(s),
                                   atol=state_tol, rtol=state_tol,
                                   err_msg=name)
        assert bufs[name].dtype == torch.float32


# ------------------------------------------------- ResNet-50 at 64x64
def _jax_train_and_eval(jm, x):
    """JAX's training-mode output and state and its eval-mode output, as
    one compiled program."""
    def both(p, s, xj):
        out, new_s = jm.apply(p, s, xj, training=True)
        return out, new_s, jm.apply(p, s, xj, training=False)[0]

    return jax.jit(both)(jm.get_params(), jm.get_state(), jnp.asarray(x))


@pytest.mark.parametrize("s2d", [True, False])
def test_resnet50_forward_matches_jax(s2d):
    opt = {"depth": 50, "dataSet": "ImageNet", "conv1SpaceToDepth": s2d}
    jm, tm = _pair(opt, seed=5)
    for fmt in ("NCHW", "NHWC"):
        _fmt(fmt)
        x = _image((2, 3, 64, 64), 6, fmt)
        want_train, new_state, want_eval = _jax_train_and_eval(jm, x)
        for training, want in ((True, want_train), (False, want_eval)):
            load_jax_state(tm, jm.get_state())
            tm.train(training)
            with torch.no_grad():
                got = tm(torch.from_numpy(x))
            assert tuple(got.shape) == (2, 1000)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=5e-3 if training else 1e-4,
                                       err_msg=f"{fmt} training={training}")
            if training:
                bufs = dict(tm.named_buffers())
                for name, s in flatten_tree(jax.device_get(
                        new_state)).items():
                    np.testing.assert_allclose(
                        bufs[name].numpy(), np.asarray(s), atol=5e-3,
                        rtol=5e-3, err_msg=name)


# ------------------------------- ResNet-50 at 224x224: the bf16 gradient
S2D50 = {"depth": 50, "dataSet": "ImageNet", "conv1SpaceToDepth": True}
DAMPED_GAMMA = 0.05


def _residual_gammas() -> set:
    """The paths (behind ``ImageNormalize``) of the BN gammas that
    ``zeroInitResidual`` zeroes: each residual branch's last BN."""
    fresh = ResNet(1000, dict(S2D50, zeroInitResidual=True), device="cpu")
    return {"1." + n for n, p in fresh.named_parameters()
            if n.endswith(".weight") and p.dim() == 1 and not bool(p.any())}


def _with(tree: dict, names: set, value: float, prefix: str = "") -> dict:
    """``tree`` with the leaves at ``names`` filled with ``value``."""
    return {k: _with(v, names, value, f"{prefix}{k}.") if isinstance(v, dict)
            else (jnp.full_like(v, value) if f"{prefix}{k}" in names else v)
            for k, v in tree.items()}


def _groups(names) -> dict:
    """The whole model, and each child of the ResNet with parameters."""
    out = {"all": list(names)}
    for n in names:
        out.setdefault("block " + n.split(".")[1], []).append(n)
    return out


def _rel_over(a: dict, b: dict, names) -> float:
    num = sum(float(np.sum((np.asarray(a[n], np.float64) - b[n]) ** 2))
              for n in names)
    den = sum(float(np.sum(np.asarray(b[n], np.float64) ** 2)) for n in names)
    return float(np.sqrt(num / max(den, 1e-300)))


def test_resnet50_bf16_gradient_gap_is_jaxs():
    """``ImageNormalize -> ResNet-50`` (s2d, NHWC) on one (2, 224, 224, 3)
    uint8 batch, the shape of ``chip_smoke.py``'s one-step check: the
    gradient of the loss in fp32 and under the bf16 policy, in JAX and in
    the port, on the same weights.

    At init JAX's own bf16 gradient is more than 100% (relative, whole
    model; 128% measured) from its fp32 gradient: the backward amplifies
    the rounding of the head's gradient (~8%) block by block. The port's
    bf16-vs-fp32 gap must be JAX's within 10%. Where rounding does not
    swamp the signal the port's bf16 gradient is held to JAX's, within
    1.5x JAX's own bf16-vs-fp32 gap of JAX's fp32 gradient and of JAX's
    bf16 gradient (the port rounds at every op's output, XLA keeps fp32
    inside its fusions, so the port's own gap is ~10% larger than JAX's and
    the two bf16 gradients are about one gap apart; measured 1.01-1.22x):
    the classifier at init; with each residual branch's last BN gamma at
    0.05 (the parameters ``zeroInitResidual`` zeroes), which tames the
    backward, every block and the whole model, and every tensor alone
    within 2x (one tensor's distances spread more: measured up to 1.38x and
    1.44x; a BN gamma's gap can be 2%, so an error of 10% in the gammas'
    gradient alone shows). Each of those JAX gaps must be under 0.5, so
    every limit sits below the 1.0 a zero gradient reads.
    There the fp32 gradients agree within 3e-2 per block and 1e-2 over the
    model (ReLU gates flip; measured 7.6e-3 and 4.7e-3)."""
    _fmt("NHWC")
    JaxRNG.set_seed(11)
    jm = jnn.Sequential().add(jnn.ImageNormalize()).add(
        JaxResNet(1000, S2D50))
    tm = tnn.Sequential().add(tnn.ImageNormalize()).add(
        ResNet(1000, S2D50, device="cpu"))
    load_jax_state(tm, jm.get_state())
    r = np.random.default_rng(12)
    x = r.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    y = r.integers(0, 1000, 2).astype(np.int32)
    ms = jm.get_state()

    grad_fns = {m: jax.jit(jax.grad(
        lambda p, m=m: _jax_loss(jm, p, ms, x, y, m))) for m in (False, True)}

    def jax_grads(params, mixed):
        jax_engine.Engine.init(seed=3, compute_dtype=jnp.bfloat16 if mixed
                               else jnp.float32)
        try:
            return flatten_tree(jax.device_get(grad_fns[mixed](params)))
        finally:
            jax_engine.Engine.reset()

    def port_grads(dtype):
        torch_engine.Engine.init(compute_dtype=dtype)
        try:
            opt = toptim.LocalOptimizer(tm, DataSet.array([]),
                                        tnn.ClassNLLCriterion(), device="cpu")
            names, ps = zip(*tm.named_parameters())
            _, g = opt._loss_and_grads(list(ps), torch.from_numpy(x),
                                       torch.from_numpy(y).long())
            return {n: t.numpy() for n, t in zip(names, g)}
        finally:
            torch_engine.Engine.reset()
            load_jax_state(tm, ms)

    damped = _residual_gammas()
    assert len(damped) == 16                 # one a bottleneck
    fc = [n for n, _ in tm.named_parameters() if n.startswith("1.19.")]
    for weights in ("init", "damped"):
        params = jm.get_params() if weights == "init" else _with(
            jm.get_params(), damped, DAMPED_GAMMA)
        load_jax_params(tm, params)
        j32, j16 = jax_grads(params, False), jax_grads(params, True)
        t32, t16 = port_grads(torch.float32), port_grads(torch.bfloat16)
        groups = _groups(list(t32))
        if weights == "init":
            gap = _rel_over(j16, j32, groups["all"])
            assert gap > 1.0
            assert _rel_over(t16, t32, groups["all"]) == pytest.approx(
                gap, rel=0.1)
            held = {"classifier": fc}
        else:
            held = groups
            assert _rel_over(t32, j32, groups["all"]) < 1e-2
            for g, names in groups.items():
                assert _rel_over(t32, j32, names) < 3e-2, g
        for g, names in held.items():
            gap = _rel_over(j16, j32, names)
            assert gap < 0.5, (weights, g)
            assert _rel_over(t16, j32, names) < 1.5 * gap, (weights, g)
            assert _rel_over(t16, j16, names) < 1.5 * gap, (weights, g)
        if weights == "damped":
            for n in groups["all"]:
                gap = _rel_over(j16, j32, [n])
                assert gap < 0.5, n
                assert _rel_over(t16, j32, [n]) < 2 * gap, n
                assert _rel_over(t16, j16, [n]) < 2 * gap, n


# -------------------------------------------------------- factory options
@pytest.mark.parametrize("shortcut", ["A", "B", "C"])
def test_shortcut_types_and_zero_init_residual_match_jax(shortcut):
    opt = {"depth": 8, "shortcutType": shortcut, "zeroInitResidual": True}
    jm, tm = _pair(opt, seed=7)
    assert sorted(flatten_tree(jm.get_params())) == sorted(
        n for n, _ in tm.named_parameters())
    x = _image((2, 3, 16, 16), 8, "NCHW")
    want, _ = jax.jit(lambda p, s, xj: jm.apply(p, s, xj, training=True))(
        jm.get_params(), jm.get_state(), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the last BN of every residual branch starts at gamma 0
    fresh = ResNet(10, opt, device="cpu")
    gammas = [m.weight for m in fresh.modules()
              if isinstance(m, tnn.SpatialBatchNormalization)]
    assert sum(float(g.detach().abs().max()) == 0.0 for g in gammas) == 3


def test_factory_checks_and_resnet50():
    with pytest.raises(ValueError, match="6n\\+2"):
        ResNet(10, {"depth": 21}, device="cpu")
    with pytest.raises(ValueError, match="ImageNet depth"):
        ResNet(10, {"depth": 42, "dataSet": "ImageNet"}, device="cpu")
    m = ResNet50(device="cpu")
    n = sum(p.numel() for p in m.parameters())
    JaxRNG.set_seed(1)
    jn = sum(int(np.prod(np.shape(v))) for v in flatten_tree(
        jnn.Sequential().add(JaxResNet(1000, {"depth": 50,
                                              "dataSet": "ImageNet"}))
        .get_params()).values())
    assert n == jn == 25557032
