"""``Evaluator`` and ``Predictor`` of the port against the JAX package's,
on the CPU.

LeNet-5 with the same weights in both packages, 30 samples in batches of 4
(the last padded to 4 with 2 valid): ``Evaluator.test`` with
``fuse_steps`` 1 and 3 (two windows of 3 and two single batches) gives
JAX's Top-1 and loss (counts equal, values within 1e-5), and a method
without a device fold (its outputs fetched, each batch scored on the host
against its own labels) JAX's value within 1e-5; ``Predictor.predict``
gives JAX's log-probs
within 1e-5 with the padding rows dropped, and ``predict_class`` JAX's
classes; raw numpy arrays are batched as JAX batches them.
"""

import jax
import numpy as np
import pytest

from bigdl_tpu import Engine as JEngine
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.dataset.sample import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.models.lenet.lenet5 import LeNet5 as JLeNet5
from bigdl_tpu.optim import Evaluator as JEvaluator
from bigdl_tpu.optim import Predictor as JPredictor
from bigdl_tpu.optim import validation as jval
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.optim import Evaluator, Predictor
from bigdl_tpu_torch.optim import validation as tval
from bigdl_tpu_torch.utils import engine as torch_engine

N, BATCH = 30, 4


@pytest.fixture(scope="module")
def models():
    JEngine.init(seed=0)
    JaxRNG.set_seed(6)
    jm = JLeNet5(10)
    tm = LeNet5(10, device="cpu")
    load_jax_params(tm, jax.device_get(jm.get_params()))
    yield jm.evaluate(), tm
    JEngine.reset()
    torch_engine.Engine.reset()


def _data():
    r = np.random.default_rng(2)
    return (r.normal(size=(N, 28, 28)).astype(np.float32),
            r.integers(0, 10, N).astype(np.int32))


def _sets():
    xs, ys = _data()
    return (JDataSet.array(JSample(x, y) for x, y in zip(xs, ys))
            >> JSampleToMiniBatch(BATCH),
            DataSet.array(Sample(x, y) for x, y in zip(xs, ys))
            >> SampleToMiniBatch(BATCH))


@pytest.mark.parametrize("fuse", [1, 3])
def test_evaluator_matches_jax(models, fuse):
    jm, tm = models
    jds, tds = _sets()
    want = JEvaluator(jm).test(
        jds, [jval.Top1Accuracy(), jval.Loss(),
              jval.Loss(jnn.ClassNLLCriterion(size_average=False))],
        fuse_steps=fuse)
    ev = Evaluator(tm, device="cpu")
    host = tval.Loss(tnn.ClassNLLCriterion(size_average=False))
    got = ev.test(tds, [tval.Top1Accuracy(), tval.Loss(), host],
                  fuse_steps=fuse)
    assert ev.last_stats["batches"] == 8 and ev.last_stats["samples"] == N
    assert ev.last_stats["fused_windows"] == (2 if fuse == 3 else 0)
    for (g, _), (w, _) in zip(got, want):
        assert g.result()[1] == w.result()[1] == N
        assert g.result()[0] == pytest.approx(w.result()[0], rel=1e-5)
    # a method without a device fold: the outputs came to the host, each
    # scored against its own batch's labels
    assert ev.last_stats["fetch_bytes"] > N * 10 * 4
    with pytest.raises(ValueError, match="methods is required"):
        ev.test(tds, [])


@pytest.mark.parametrize("fuse", [1, 3])
def test_predictor_matches_jax(models, fuse):
    jm, tm = models
    jds, tds = _sets()
    want = JPredictor(jm).predict(jds, fuse_steps=fuse)
    got = Predictor(tm, device="cpu").predict(tds, fuse_steps=fuse)
    assert got.shape == want.shape == (N, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    xs, _ = _data()
    classes = Predictor(tm, device="cpu").predict_class(xs, batch_size=8)
    np.testing.assert_array_equal(
        classes, JPredictor(jm).predict_class(xs, batch_size=8))
    assert classes.dtype == np.int32 and classes.shape == (N,)
    with pytest.raises(ValueError, match="batch_size"):
        Predictor(tm, device="cpu").predict(xs)


def test_eval_fuse_steps_knob(monkeypatch):
    from bigdl_tpu_torch.optim.evaluator import eval_fuse_steps
    assert eval_fuse_steps() == 8
    monkeypatch.setenv("BIGDL_EVAL_FUSE_STEPS", "3")
    assert eval_fuse_steps() == 3 and eval_fuse_steps(2) == 2
    for bad in (0, -1, "x"):
        with pytest.raises(ValueError):
            eval_fuse_steps(bad)
