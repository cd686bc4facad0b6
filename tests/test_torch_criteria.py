"""The port's criteria against the JAX package, on the CPU.

Same numpy inputs and targets made from a seed, small sizes (batch <= 4,
classes <= 8). Each case of ``CASES`` compares the loss (within 1e-5,
absolute and relative) and its gradient with respect to every floating
input (within 1e-4 relative, ``jax.grad`` against autograd). Inputs are
continuous draws: no hinge sits at its kink, no probability at a clip
bound. The fp32 islands (``SoftmaxWithCriterion``,
``TimeDistributedMaskCriterion`` on logits) take bf16 input and match
JAX's bf16 run. The criteria that compose others or modules
(``TimeDistributedMaskCriterion``, ``MultiCriterion``,
``TransformerCriterion``, ``ClassSimplexCriterion``) each drive one Adam
step of ``LocalOptimizer`` against JAX's step function: the loss within
1e-5 and the parameters within 1e-5.
"""

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.utils import engine as torch_engine
from bigdl_tpu_torch.utils.table import T


@pytest.fixture(autouse=True)
def _one_thread_and_reset():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax_engine.Engine.reset()
    torch_engine.Engine.reset()


def _x(*shape, seed=0, lo=None, hi=None):
    r = np.random.default_rng(seed)
    if lo is not None:
        return r.uniform(lo, hi, size=shape).astype(np.float32)
    return r.normal(size=shape).astype(np.float32)


def _sign(*shape, seed=5):
    return np.where(_x(*shape, seed=seed) > 0, 1.0, -1.0).astype(np.float32)


def _labels(n, c, seed=6, low=0):
    return np.random.default_rng(seed).integers(low, c + low, n).astype(
        np.int32)


def _probs(*shape, seed=0):
    p = _x(*shape, seed=seed, lo=0.1, hi=1.0)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _compiled(fn, *args):
    """``fn(*args)`` as one compiled program (eager JAX compiles op by op),
    compiled without XLA's expensive CPU passes: these tiny programs
    spend far longer compiling than running."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@dataclass
class Case:
    build: Callable          # pkg -> criterion
    input: Callable          # () -> array or list of arrays (a Table)
    target: Callable         # () -> array or list of arrays (a Table)


N, K = 4, 6
MULTI_LABELS = np.array([[2, 0, -1, 4, -1, -1], [5, -1, -1, -1, -1, -1],
                         [1, 3, 4, -1, -1, -1], [0, 1, 2, 3, 4, 5]], np.int32)
# one-based: the sentinel is 0, and labels after it are ignored
MULTI_LABELS_1 = np.array([[3, 1, 0, 5, 0, 0], [6, 0, 0, 0, 0, 0],
                           [2, 4, 5, 0, 0, 0], [1, 2, 0, 4, 5, 6]], np.int32)
SEG = np.array([[[1, 0, 3], [2, 255, 1], [0, 0, 2]],
                [[3, 3, 1], [255, 2, 0], [1, 2, 3]]], np.int32)
TIMES = np.array([[3, 1, 0, 0, 0], [2, 6, 4, 5, 0]], np.int32)

CASES = {
    "MSECriterion": Case(lambda p: p.MSECriterion(), lambda: _x(N, K),
                         lambda: _x(N, K, seed=1)),
    "MSECriterion-sum": Case(lambda p: p.MSECriterion(False),
                             lambda: _x(N, K), lambda: _x(N, K, seed=1)),
    "AbsCriterion": Case(lambda p: p.AbsCriterion(), lambda: _x(N, K),
                         lambda: _x(N, K, seed=1)),
    "BCECriterion": Case(lambda p: p.BCECriterion(),
                         lambda: _x(N, K, lo=0.05, hi=0.95),
                         lambda: (_x(N, K, seed=1) > 0).astype(np.float32)),
    "BCECriterion-weights": Case(
        lambda p: p.BCECriterion(_x(K, seed=3, lo=0.5, hi=2.0), False),
        lambda: _x(N, K, lo=0.05, hi=0.95), lambda: _x(N, K, seed=1, lo=0,
                                                       hi=1)),
    "BCECriterionWithLogits": Case(lambda p: p.BCECriterionWithLogits(),
                                   lambda: 3 * _x(N, K),
                                   lambda: _x(N, K, seed=1, lo=0, hi=1)),
    "SmoothL1Criterion": Case(lambda p: p.SmoothL1Criterion(),
                              lambda: 2 * _x(N, K), lambda: _x(N, K, seed=1)),
    "MarginCriterion": Case(lambda p: p.MarginCriterion(0.7),
                            lambda: _x(N, K), lambda: _sign(N, K)),
    "MarginCriterion-squared": Case(
        lambda p: p.MarginCriterion(1.0, False, squared=True),
        lambda: _x(N, K), lambda: _sign(N, K)),
    "HingeEmbeddingCriterion": Case(lambda p: p.HingeEmbeddingCriterion(0.8),
                                    lambda: _x(N, K, lo=0, hi=2),
                                    lambda: _sign(N, K)),
    "DistKLDivCriterion": Case(
        lambda p: p.DistKLDivCriterion(), lambda: np.log(_probs(N, K)),
        lambda: np.where(_x(N, K, seed=2) > 1.0, 0.0,
                         _probs(N, K, seed=1)).astype(np.float32)),
    "MultiLabelSoftMarginCriterion": Case(
        lambda p: p.MultiLabelSoftMarginCriterion(_x(K, seed=3, lo=0.5,
                                                     hi=2.0)),
        lambda: _x(N, K), lambda: (_x(N, K, seed=1) > 0).astype(np.float32)),
    "CosineEmbeddingCriterion": Case(
        lambda p: p.CosineEmbeddingCriterion(0.2),
        lambda: [_x(N, K), _x(N, K, seed=1)], lambda: _sign(N)),
    "MarginRankingCriterion": Case(
        lambda p: p.MarginRankingCriterion(0.5),
        lambda: [_x(N), _x(N, seed=1)], lambda: _sign(N)),
    "MultiMarginCriterion": Case(lambda p: p.MultiMarginCriterion(),
                                 lambda: _x(N, K), lambda: _labels(N, K)),
    "MultiMarginCriterion-p2-weights": Case(
        lambda p: p.MultiMarginCriterion(2, _x(K, seed=3, lo=0.5, hi=2.0),
                                         0.5, False, one_based=True),
        lambda: _x(N, K), lambda: _labels(N, K, low=1)),
    "MultiLabelMarginCriterion": Case(lambda p: p.MultiLabelMarginCriterion(),
                                      lambda: _x(N, K), lambda: MULTI_LABELS),
    "MultiLabelMarginCriterion-one-based": Case(
        lambda p: p.MultiLabelMarginCriterion(False, one_based=True),
        lambda: _x(N, K), lambda: MULTI_LABELS_1),
    "SoftMarginCriterion": Case(lambda p: p.SoftMarginCriterion(),
                                lambda: 3 * _x(N, K), lambda: _sign(N, K)),
    "CosineDistanceCriterion": Case(lambda p: p.CosineDistanceCriterion(),
                                    lambda: _x(N, K),
                                    lambda: _x(N, K, seed=1)),
    "L1HingeEmbeddingCriterion": Case(
        lambda p: p.L1HingeEmbeddingCriterion(4.0),
        lambda: [_x(N, K), _x(N, K, seed=1)], lambda: _sign(N)),
    "PoissonCriterion": Case(lambda p: p.PoissonCriterion(),
                             lambda: _x(N, K, lo=0.1, hi=3.0),
                             lambda: _x(N, K, seed=1, lo=0, hi=4)),
    "CosineProximityCriterion": Case(lambda p: p.CosineProximityCriterion(),
                                     lambda: _x(N, K),
                                     lambda: _x(N, K, seed=1)),
    "MeanAbsolutePercentageCriterion": Case(
        lambda p: p.MeanAbsolutePercentageCriterion(), lambda: _x(N, K),
        lambda: _x(N, K, seed=1, lo=0.5, hi=2.0)),
    "MeanSquaredLogarithmicCriterion": Case(
        lambda p: p.MeanSquaredLogarithmicCriterion(),
        lambda: _x(N, K, lo=0.1, hi=3.0), lambda: _x(N, K, seed=1, lo=0,
                                                     hi=3.0)),
    "KullbackLeiblerDivergenceCriterion": Case(
        lambda p: p.KullbackLeiblerDivergenceCriterion(),
        lambda: _probs(N, K), lambda: _probs(N, K, seed=1)),
    "ClassSimplexCriterion": Case(lambda p: p.ClassSimplexCriterion(K),
                                  lambda: _x(N, K), lambda: _labels(N, K)),
    "MultiCriterion": Case(
        lambda p: p.MultiCriterion().add(p.MSECriterion(), 0.5)
        .add(p.AbsCriterion(), 2.0), lambda: _x(N, K),
        lambda: _x(N, K, seed=1)),
    "L1Cost": Case(lambda p: p.L1Cost(), lambda: _x(N, K),
                   lambda: _x(N, K, seed=1)),
    "KLDCriterion": Case(lambda p: p.KLDCriterion(),
                         lambda: [_x(N, K), 0.5 * _x(N, K, seed=1)],
                         lambda: _x(N, K, seed=2)),
    "GaussianCriterion": Case(lambda p: p.GaussianCriterion(),
                              lambda: [_x(N, K), 0.5 * _x(N, K, seed=1)],
                              lambda: _x(N, K, seed=2)),
    "DiceCoefficientCriterion": Case(
        lambda p: p.DiceCoefficientCriterion(epsilon=0.5),
        lambda: _x(N, 2, 3, lo=0, hi=1),
        lambda: (_x(N, 2, 3, seed=1) > 0).astype(np.float32)),
    "SoftmaxWithCriterion": Case(lambda p: p.SoftmaxWithCriterion(),
                                 lambda: _x(N, K), lambda: _labels(N, K)),
    "SoftmaxWithCriterion-spatial-ignore": Case(
        lambda p: p.SoftmaxWithCriterion(255, "valid"),
        lambda: _x(2, 4, 3, 3), lambda: SEG),
    "SoftmaxWithCriterion-batch-one-based": Case(
        lambda p: p.SoftmaxWithCriterion(2, "batch_size", one_based=True),
        lambda: _x(2, 4, 3, 3), lambda: np.where(SEG == 255, 2, SEG + 1)),
    "SoftmaxWithCriterion-full": Case(
        lambda p: p.SoftmaxWithCriterion(normalize_mode="full"),
        lambda: _x(2, 4, 3, 3), lambda: np.where(SEG == 255, 0, SEG)),
    "SoftmaxWithCriterion-none": Case(
        lambda p: p.SoftmaxWithCriterion(normalize_mode="none"),
        lambda: _x(N, K), lambda: _labels(N, K)),
    "CategoricalCrossEntropy": Case(
        lambda p: p.CategoricalCrossEntropy(), lambda: _probs(N, K),
        lambda: np.eye(K, dtype=np.float32)[_labels(N, K)]),
    "TimeDistributedMaskCriterion": Case(
        lambda p: p.TimeDistributedMaskCriterion(
            p.ClassNLLCriterion(one_based=True), 0),
        lambda: np.log(_probs(2, 5, K)), lambda: TIMES),
    "TimeDistributedMaskCriterion-logits": Case(
        lambda p: p.TimeDistributedMaskCriterion(p.CrossEntropyCriterion(),
                                                 padding_value=5),
        lambda: _x(2, 5, K), lambda: np.where(TIMES == 6, 1, TIMES)),
    "SmoothL1CriterionWithWeights": Case(
        lambda p: p.SmoothL1CriterionWithWeights(2.0, 3),
        lambda: _x(N, K), lambda: [_x(N, K, seed=1),
                                   _x(N, K, seed=2, lo=0, hi=2),
                                   _x(N, K, seed=3, lo=0, hi=2)]),
    "SmoothL1CriterionWithWeights-bare": Case(
        lambda p: p.SmoothL1CriterionWithWeights(), lambda: 2 * _x(N, K),
        lambda: _x(N, K, seed=1)),
    "TransformerCriterion": Case(
        lambda p: p.TransformerCriterion(p.MSECriterion(), p.Tanh(), p.Tanh()),
        lambda: _x(N, K), lambda: _x(N, K, seed=1)),
}


def _wrap(spec, make, leaf):
    return make(*[leaf(a) for a in spec]) if isinstance(spec, list) \
        else leaf(spec)


def _loss_and_grads(case: Case, bf16: bool = False):
    """(JAX's loss, its input gradients, the port's loss, its input
    gradients)."""
    jc, tc = case.build(jnn), case.build(nn)
    inp, tgt = case.input(), case.target()
    inputs = inp if isinstance(inp, list) else [inp]
    jdt = jnp.bfloat16 if bf16 else jnp.float32

    def jloss(xs):
        return jc.apply(_wrap(inp, JT, lambda _: xs.pop(0)) if isinstance(
            inp, list) else xs[0], _wrap(tgt, JT, jnp.asarray))

    want, gx = _compiled(jax.value_and_grad(lambda xs: jloss(list(xs))),
                         [jnp.asarray(a, jdt) for a in inputs])
    ts = [torch.from_numpy(a).to(torch.bfloat16 if bf16 else torch.float32)
          .requires_grad_() for a in inputs]
    it = iter(ts)
    got = tc.apply(_wrap(inp, T, lambda _: next(it)),
                   _wrap(tgt, T, torch.from_numpy))
    grads = torch.autograd.grad(got, ts)
    return want, gx, got, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_criterion_matches_jax(name):
    want, gx, got, grads = _loss_and_grads(CASES[name])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    for g, w in zip(grads, gx):
        assert _rel(g.numpy(), w) <= 1e-4


@pytest.mark.parametrize("name", ["SoftmaxWithCriterion-spatial-ignore",
                                  "TimeDistributedMaskCriterion-logits"])
def test_fp32_island_criterion_on_bf16_input(name):
    want, gx, got, grads = _loss_and_grads(CASES[name], bf16=True)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for g, w in zip(grads, gx):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float().numpy(), np.asarray(w, np.float32)) <= 1e-2


STEP_CASES = {
    "TimeDistributedMaskCriterion": (
        lambda p: p.TimeDistributed(p.Linear(5, K)),
        lambda p: p.TimeDistributedMaskCriterion(p.CrossEntropyCriterion(),
                                                 padding_value=0),
        _x(2, 5, 5), np.where(TIMES == 6, 1, TIMES)),
    "MultiCriterion": (
        lambda p: p.Linear(5, K),
        lambda p: p.MultiCriterion().add(p.MSECriterion(), 0.5)
        .add(p.SmoothL1Criterion(), 2.0), _x(N, 5), _x(N, K, seed=1)),
    "TransformerCriterion": (
        lambda p: p.Linear(5, K),
        lambda p: p.TransformerCriterion(p.MSECriterion(),
                                         p.Linear(K, 3), None),
        _x(N, 5), _x(N, 3, seed=1)),
    "ClassSimplexCriterion": (
        lambda p: p.Linear(5, K), lambda p: p.ClassSimplexCriterion(K),
        _x(N, 5), _labels(N, K)),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_composite_criterion_trains_like_jax(name):
    build, crit, x, y = STEP_CASES[name]
    JaxRNG.set_seed(11)
    jm, jc = build(jnn), crit(jnn)
    tm, tc = build(nn), crit(nn)
    load_jax_params(tm, jax.device_get(jm.get_params()))
    if name == "TransformerCriterion":   # the frozen transform's weights
        load_jax_params(tc.input_transformer, jax.device_get(
            jc.input_transformer.get_params()))
    jopt = joptim.LocalOptimizer(jm, JDataSet.array([]), jc)
    jopt.set_optim_method(joptim.Adam(learningrate=0.01))
    step = jax.jit(jopt._make_step_fn())
    params, _, _, jloss = step(
        jm.get_params(), jm.get_state(),
        jopt.optim_method.init_state(jm.get_params()),
        jnp.asarray(0, jnp.int32), jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(0))
    topt = (toptim.LocalOptimizer(tm, DataSet.array([]), tc, device="cpu")
            .set_optim_method(toptim.Adam(learningrate=0.01)))
    loss = topt.train_step(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    flat = flatten_tree(jax.device_get(params))
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat[n], rtol=1e-5,
                                   atol=1e-6)
    if name == "TransformerCriterion":   # the transform did not train
        for p in tc.input_transformer.parameters():
            assert p.grad is None
