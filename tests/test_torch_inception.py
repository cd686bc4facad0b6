"""The port's Inception slice against the JAX package, on the CPU.

Same weights (moved across by path with ``convert.load_jax_params``), same
numpy inputs:

- ``Concat`` (NCHW and NHWC: dimension 2 is the channel axis of either;
  ``literal_dim``) and ``SpatialCrossMapLRN`` (sizes 5 and 4: Torch's
  asymmetric window; NCHW and NHWC), forward and the input gradient
  against ``jax.grad``, within 1e-5;
- a two-output ``Graph`` with a node of two predecessors: its outputs and
  parameter paths;
- ``ParallelCriterion`` with and without ``repeat_target``, and its
  ``size_average`` rule;
- ``Inception_v1`` with its aux heads at batch 2, 224x224: the three
  log-probability outputs and the weighted loss within 1e-4, and one
  SGD step through the port's ``LocalOptimizer`` (the three-output Table
  into ``ParallelCriterion`` inside the step program) against JAX's
  gradients: every parameter after the step within 1e-4, the whole
  model's update within 2e-3 relative (a ReLU gate within rounding of 0
  can differ between the packages, as ``tests/test_torch_resnet.py``
  measures);
- ``Inception_v2_NoAuxClassifier``'s eval forward within 1e-4, and
  ``fuse_conv_bn`` on an ``Inception_v2`` ``Graph`` (folded eval forward)
  against JAX's pass on the same weights and statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.inception import Inception_v1 as JInception_v1
from bigdl_tpu.models.inception import Inception_v2 as JInception_v2
from bigdl_tpu.models.inception import (
    Inception_v2_NoAuxClassifier as JInception_v2_NoAux,
)
from bigdl_tpu.nn import layout as jlayout
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params, load_jax_state
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.models.inception import (
    Inception_v1, Inception_v2, Inception_v2_NoAuxClassifier,
)
from bigdl_tpu_torch.nn import layout as tlayout
from bigdl_tpu_torch.optim import SGD, LocalOptimizer
from bigdl_tpu_torch.utils import engine as torch_engine
from bigdl_tpu_torch.utils.table import T


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


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _port_of(jm, tm):
    load_jax_params(tm, jax.device_get(jm.get_params()))
    load_jax_state(tm, jax.device_get(jm.get_state()))
    return tm


# ------------------------------------------------------------ the layers
def _concat_pair(pkg, literal_dim=False):
    c = pkg.Concat(2, literal_dim=literal_dim)
    c.add(pkg.SpatialConvolution(4, 3, 1, 1))
    c.add(pkg.Sequential().add(pkg.SpatialConvolution(4, 2, 3, 3, 1, 1, 1, 1))
          .add(pkg.ReLU()))
    c.add(pkg.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil())
    return c


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_concat_matches_jax(fmt):
    _fmt(fmt)
    JaxRNG.set_seed(1)
    jm = _concat_pair(jnn)
    tm = _port_of(jm, _concat_pair(nn))
    x = _x((2, 4, 6, 6) if fmt == "NCHW" else (2, 6, 6, 4))
    want, _ = jm.apply(jm.get_params(), jm.get_state(), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt)
    assert got.shape == want.shape == ((2, 9, 6, 6) if fmt == "NCHW"
                                       else (2, 6, 6, 9))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    gx = jax.grad(lambda xx: jm.apply(jm.get_params(), jm.get_state(),
                                      xx)[0].sum())(jnp.asarray(x))
    got.sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5)
    # literal_dim: the second axis as it is, whatever the layout
    lit = nn.Concat(2, literal_dim=True).add(nn.Identity()).add(nn.Identity())
    assert lit(torch.from_numpy(x)).shape[1] == 2 * x.shape[1]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("size", [5, 4])
def test_lrn_matches_jax(size, fmt):
    _fmt(fmt)
    jm = jnn.SpatialCrossMapLRN(size, 0.0001, 0.75, 2.0)
    tm = nn.SpatialCrossMapLRN(size, 0.0001, 0.75, 2.0)
    x = _x((2, 7, 5, 5) if fmt == "NCHW" else (2, 5, 5, 7), 3) * 30
    want, _ = jm.apply({}, {}, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    w = _x(x.shape, 4)
    gx = jax.grad(lambda xx: (jm.apply({}, {}, xx)[0] * w).sum())(
        jnp.asarray(x))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5,
                               rtol=1e-5)


def _graph(pkg):
    inp = pkg.Input()
    h = pkg.Linear(6, 5).inputs(inp)
    a = pkg.ReLU().inputs(h)
    out1 = pkg.Linear(5, 3).inputs(a)
    b = pkg.Linear(6, 5).inputs(inp)
    joined = pkg.CAddTable().inputs(h, b)
    out2 = pkg.Linear(5, 2).inputs(joined)
    return pkg.Graph(inp, [out1, out2])


def test_two_output_graph_matches_jax():
    JaxRNG.set_seed(2)
    jm = _graph(jnn)
    tm = _graph(nn)
    assert set(dict(tm.named_parameters())) == set(flatten_tree(
        jax.device_get(jm.get_params())))
    _port_of(jm, tm)
    x = _x((4, 6), 5)
    want, _ = jm.apply(jm.get_params(), jm.get_state(), jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, w in zip(got.values(), want.values()):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-6)
    with pytest.raises(ValueError, match="cycle|not connected"):
        nn.Graph(nn.Input(), nn.Linear(2, 2).inputs(nn.Input()))


@pytest.mark.parametrize("repeat", [True, False])
def test_parallel_criterion_matches_jax(repeat):
    def crit(pkg):
        return (pkg.ParallelCriterion(repeat_target=repeat)
                .add(pkg.ClassNLLCriterion(), 1.0)
                .add(pkg.ClassNLLCriterion(size_average=False), 0.3))

    r = np.random.default_rng(6)
    logp = [np.log(r.dirichlet(np.ones(5), 4)).astype(np.float32)
            for _ in range(2)]
    ys = [r.integers(0, 5, 4).astype(np.int32) for _ in range(2)]
    jt = ys[0] if repeat else JT(*[jnp.asarray(y) for y in ys])
    tt = torch.from_numpy(ys[0]) if repeat else T(
        *[torch.from_numpy(y) for y in ys])
    want = crit(jnn).apply(JT(*[jnp.asarray(v) for v in logp]),
                           jnp.asarray(jt) if repeat else jt)
    got = crit(nn).apply(T(*[torch.from_numpy(v) for v in logp]), tt)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert crit(nn).size_average is crit(jnn).size_average is False
    assert nn.ParallelCriterion().add(nn.ClassNLLCriterion()).size_average


# ----------------------------------------------------------- Inception
def _inception_criterion(pkg):
    return (pkg.ParallelCriterion(repeat_target=True)
            .add(pkg.ClassNLLCriterion(), 1.0)
            .add(pkg.ClassNLLCriterion(), 0.3)
            .add(pkg.ClassNLLCriterion(), 0.3))


def test_inception_v1_forward_and_sgd_step_match_jax():
    jax_engine.Engine.init(seed=7)
    jm = JInception_v1(10, has_dropout=False)
    tm = _port_of(jm, Inception_v1(10, has_dropout=False, device="cpu"))
    x = _x((2, 3, 224, 224), 8)
    y = np.array([3, 7], np.int32)
    params = jm.get_params()
    crit = _inception_criterion(jnn)

    def loss(p):
        out, _ = jm.apply(p, jm.get_state(), jnp.asarray(x), training=True)
        return crit.apply(out, jnp.asarray(y)), out

    (want_loss, want_out), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    got_out = tm(torch.from_numpy(x))
    assert len(got_out) == 3
    for g, w in zip(got_out.values(), want_out.values()):
        assert g.shape == (2, 10)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-4)
    lr = 0.01
    opt = (LocalOptimizer(tm, DataSet.array([]), _inception_criterion(nn),
                          device="cpu")
           .set_optim_method(SGD(learningrate=lr)))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    got_loss = opt.train_step(torch.from_numpy(x), torch.from_numpy(y))
    assert got_loss == pytest.approx(float(want_loss), abs=1e-4)
    want_g = flatten_tree(jax.device_get(grads))
    got_u, want_u = [], []
    for n, p in tm.named_parameters():
        want_p = before[n].numpy() - lr * want_g[n]
        np.testing.assert_allclose(p.detach().numpy(), want_p, atol=1e-4,
                                   err_msg=n)
        got_u.append((p.detach() - before[n]).numpy().ravel())
        want_u.append(-lr * want_g[n].ravel())
    assert _rel(np.concatenate(got_u), np.concatenate(want_u)) < 2e-3


def test_inception_v2_forward_and_fused_graph_match_jax():
    from bigdl_tpu.nn.graph import fuse_conv_bn as jfuse_conv_bn
    jax_engine.Engine.init(seed=9)
    x = _x((1, 3, 224, 224), 10)
    jm = JInception_v2_NoAux(10)
    tm = _port_of(jm, Inception_v2_NoAuxClassifier(10, device="cpu"))
    want, _ = jax.jit(lambda p, s, xx: jm.apply(p, s, xx, training=False))(
        jm.get_params(), jm.get_state(), jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # fuse_conv_bn over the Graph: the folded eval forward of both packages
    jg = JInception_v2(10)
    tg = _port_of(jg, Inception_v2(10, device="cpu"))
    r = np.random.default_rng(11)
    state = jax.tree_util.tree_map(
        lambda s: jnp.asarray(r.uniform(0.5, 1.5, s.shape), s.dtype),
        jg.get_state())
    jg.set_state(state)
    load_jax_state(tg, jax.device_get(state))
    jf = jfuse_conv_bn(jg)
    tf = nn.fuse_conv_bn(tg)
    assert isinstance(tf, nn.Graph)
    want, _ = jax.jit(lambda p, s, xx: jf.apply(p, s, xx, training=False))(
        jf.get_params(), jf.get_state(), jnp.asarray(x))
    with torch.no_grad():
        got = tf.eval()(torch.from_numpy(x))
    for g, w in zip(got.values(), want.values()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
