"""Failure handling of the port's trainer, on the CPU.

- A NaN loss (the ``nonfinite_loss`` fault site) rolls back to the last
  good checkpoint and the run ends bitwise on the uninterrupted run's
  parameters; ``BIGDL_MAX_NAN_ROLLBACKS`` caps the rollbacks; without a
  checkpoint the error is raised at once.
- Other failures (a failed checkpoint write, raised at the next join)
  retry from the last checkpoint within ``failure_retry_times``
  (``BIGDL_FAILURE_RETRY_TIMES``, with ``BIGDL_FAILURE_RETRY_INTERVAL=0``).
- No poisoned checkpoint (JAX's ``tests/test_check_numerics.py``
  ``test_no_poisoned_checkpoint``): a diverging run with a checkpoint
  every iteration leaves only finite files.
- ``set_check_numerics``: where JAX's sanitizer raises with "nan", the
  port raises with "nan" too and names the op that generated it
  (``aten.log``, as JAX names ``log``); an update that overflows is caught
  by the flag, not the loss guard; on a clean run the losses and
  parameters are those of the unchecked run, bit for bit.

Bitwise comparisons run on one CPU thread (see
``tests/test_torch_preemption.py``).
"""

import os

import numpy as np
import pytest
import torch

from bigdl_tpu import Engine as JEngine
from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.dataset.sample import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.convert import flatten_tree
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.nn.abstractnn import TensorModule
from bigdl_tpu_torch.nn.criterion import AbstractCriterion
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.optim.optimizer import NonFiniteLossError
from bigdl_tpu_torch.utils import engine as torch_engine
from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils import file as ckpt_file
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from bigdl_tpu_torch.utils.robustness import events


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.setenv("BIGDL_FAILURE_RETRY_INTERVAL", "0")
    torch_engine.Engine.reset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    JEngine.reset()
    torch_engine.Engine.reset()


class Log(TensorModule):
    """``log`` of the input, as JAX's ``nn.Log``: NaN on a negative."""

    def run(self, input, state=None):
        return torch.log(input), state


class MSE(AbstractCriterion):
    """Mean squared error, as JAX's ``nn.MSECriterion``."""

    def apply(self, input, target):
        return ((input - target) ** 2).mean()


def _samples(n=32, dim=4, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(dim,)).astype(np.float32),
             np.int32(rng.integers(0, classes))) for _ in range(n)]


def _model(log=False):
    torch.manual_seed(0)
    m = nn.Sequential().add(nn.Linear(4, 3))
    if log:
        m.add(Log())
    return m.add(nn.LogSoftMax())


def _opt(model, ckpt=None, n_iter=10, every=2, lr=0.1):
    RandomGenerator.set_seed(1)
    data = DataSet.array(Sample(x, y) for x, y in _samples()) \
        >> SampleToMiniBatch(8)
    opt = (LocalOptimizer(model, data, nn.ClassNLLCriterion(), device="cpu")
           .set_optim_method(SGD(learningrate=lr, momentum=0.9))
           .set_end_when(Trigger.max_iteration(n_iter)))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), Trigger.several_iteration(every))
    return opt


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _bitwise(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------- NaN rollback
def test_nan_rollback_is_bitwise(tmp_path):
    ref = _params(_opt(_model()).optimize())
    snap = events.snapshot()
    opt = _opt(_model(), tmp_path)
    with faults.inject_faults("nonfinite_loss@5") as plan:
        opt.optimize()
    assert plan.unfired() == []
    assert events.deltas(snap).get("nan_rollback") == 1
    assert opt.state["nan_rollbacks"] == 1 and opt.state["neval"] == 11
    assert _bitwise(ref, _params(opt.model))


def test_nan_rollbacks_are_capped(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_MAX_NAN_ROLLBACKS", "2")
    opt = _opt(_model(), tmp_path)
    snap = events.snapshot()
    with faults.inject_faults(";".join(["nonfinite_loss@5"] * 3)), \
            pytest.raises(NonFiniteLossError) as ei:
        opt.optimize()
    assert ei.value.iteration == 5
    assert events.deltas(snap).get("nan_rollback") == 2
    assert opt.state["nan_rollbacks"] == 3


def test_nan_without_checkpoint_raises_at_once():
    opt = _opt(_model())
    with faults.inject_faults("nonfinite_loss@3"), \
            pytest.raises(NonFiniteLossError, match="iteration 3"):
        opt.optimize()


# -------------------------------------------------------- retry budget
def test_failed_write_retries_from_the_last_checkpoint(tmp_path):
    ref = _params(_opt(_model()).optimize())
    snap = events.snapshot()
    opt = _opt(_model(), tmp_path)
    # the 2nd write (version 4) fails; the next save's join raises it
    with faults.inject_faults("ckpt_write@2=error"):
        opt.optimize()
    assert events.deltas(snap).get("retry_rollback") == 1
    assert _bitwise(ref, _params(opt.model))


def test_retry_budget(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_FAILURE_RETRY_TIMES", "0")
    opt = _opt(_model(), tmp_path)
    with faults.inject_faults("ckpt_write@2=error"), \
            pytest.raises(RuntimeError, match="checkpoint write failed"):
        opt.optimize()
    assert torch_engine.Engine.config().failure_retry_times == 0
    assert torch_engine.Engine.config().failure_retry_interval == 0.0


def test_retry_settings_default_to_jax_values(monkeypatch):
    monkeypatch.delenv("BIGDL_FAILURE_RETRY_INTERVAL")
    monkeypatch.delenv("BIGDL_FAILURE_RETRY_TIMES", raising=False)
    torch_engine.Engine.reset()
    JEngine.reset()
    JEngine.init()
    jcfg, cfg = JEngine.config(), torch_engine.Engine.config()
    assert cfg.failure_retry_times == jcfg.failure_retry_times == 5
    assert cfg.failure_retry_interval == jcfg.failure_retry_interval == 15.0


# ------------------------------------------------ no poisoned checkpoint
def test_no_poisoned_checkpoint(tmp_path, monkeypatch):
    """JAX's case: a regression at learning rate 1e12 blows up; with a
    checkpoint every iteration, every file on disk holds finite
    parameters."""
    monkeypatch.setenv("BIGDL_FAILURE_RETRY_TIMES", "0")
    rng = np.random.default_rng(0)
    data = DataSet.array(
        Sample(rng.normal(size=(4,)).astype(np.float32),
               rng.normal(size=(1,)).astype(np.float32))
        for _ in range(32)) >> SampleToMiniBatch(8)
    torch.manual_seed(0)
    opt = (LocalOptimizer(nn.Sequential().add(nn.Linear(4, 1)), data, MSE(),
                          device="cpu")
           .set_optim_method(SGD(learningrate=1e12))
           .set_check_numerics(True)
           .set_checkpoint(str(tmp_path), Trigger.several_iteration(1))
           .set_end_when(Trigger.max_iteration(8)))
    with pytest.raises(NonFiniteLossError, match="(?i)nan"):
        opt.optimize()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pkl")]
    assert files
    for f in files:
        payload = ckpt_file.load(str(tmp_path / f))
        for name, leaf in flatten_tree(payload["params"]).items():
            assert np.isfinite(leaf).all(), (f, name)


# ------------------------------------------------------- check numerics
def _jax_log_model_raises():
    JEngine.init(seed=0)
    data = JDataSet.array(JSample(x, y) for x, y in _samples()) \
        >> JSampleToMiniBatch(8)
    model = (jnn.Sequential().add(jnn.Linear(4, 3)).add(jnn.Log())
             .add(jnn.LogSoftMax()))
    opt = (JLocalOptimizer(model, data, jnn.ClassNLLCriterion())
           .set_optim_method(JSGD(learningrate=0.1))
           .set_check_numerics(True)
           .set_end_when(JTrigger.max_iteration(4)))
    with pytest.raises(Exception, match="(?i)nan") as ei:
        opt.optimize()
    return str(ei.value)


def test_check_numerics_raises_with_nan_where_jax_does():
    _jax_log_model_raises()
    opt = _opt(_model(log=True), n_iter=4).set_check_numerics(True)
    with pytest.raises(NonFiniteLossError, match="(?i)nan") as ei:
        opt.optimize()
    assert ei.value.iteration == 1
    assert "generated by aten.log." in str(ei.value)


def test_check_numerics_flags_a_nan_update():
    """Inputs of 1e3 and a rate of 1e38: the first update overflows while
    the first loss is finite; the flag (the parameters), not the loss
    guard, stops the run at iteration 1, naming the update's op."""
    RandomGenerator.set_seed(1)
    data = DataSet.array(Sample(1e3 * x, y) for x, y in _samples()) \
        >> SampleToMiniBatch(8)
    opt = (LocalOptimizer(_model(), data, nn.ClassNLLCriterion(),
                          device="cpu")
           .set_optim_method(SGD(learningrate=1e38))
           .set_check_numerics(True)
           .set_end_when(Trigger.max_iteration(4)))
    losses = []
    run_steps = opt._run_steps
    opt._run_steps = lambda steps: losses.extend(run_steps(steps))
    with pytest.raises(NonFiniteLossError, match="(?i)nan") as ei:
        opt.optimize()
    assert ei.value.iteration == 1 and losses == []
    assert "generated by aten.addcmul_" in str(ei.value)


def test_check_numerics_is_bitwise_neutral():
    runs = []
    for check in (False, True):
        opt = _opt(_model(), n_iter=8).set_check_numerics(check)
        losses = []
        run_steps = opt._run_steps
        opt._run_steps = lambda steps: losses.extend(run_steps(steps)) or \
            losses[-len(steps):]
        opt.set_fuse_steps(4).optimize()
        runs.append((losses, _params(opt.model)))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 8
    assert _bitwise(runs[0][1], runs[1][1])
