"""Summaries, Plateau's trainer hook and profiling of the port, on the CPU.

- Event files: the port's CRC32C on the known vectors of JAX's own test;
  files the port writes read by JAX's ``read_events`` and the reverse,
  byte for byte the same records.
- A training run (a linear classifier, validation every 2 iterations,
  ``Parameters`` histograms every 2) writes the same tags at the same
  steps as JAX's run of the same weights and data: Loss and LearningRate
  at each iteration's own step, Throughput from the third, the histograms,
  and
  ValFetchBytes, ValWaitMs and the method's score; Loss, LearningRate and
  the score within 1e-5 relative. At ``set_fuse_steps(4)`` the port writes
  the same Loss points as at fuse 1.
- Plateau's hook: fed the same metric sequence, the port's trainer and
  JAX's lower the rate at the same points (monitor "score", a method's
  name, "loss"), composite and flat-update slots included, and a trained
  run with ``Plateau("Top1Accuracy")`` gives JAX's learning-rate
  trajectory.
- ``set_profile`` writes a Chrome trace of the asked iterations.
"""

import json
import os

import jax
import numpy as np
import pytest

from bigdl_tpu import Engine as JEngine
from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.dataset.sample import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim import schedules as jschedules
from bigdl_tpu.optim import validation as jval
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.visualization import TrainSummary as JTrainSummary
from bigdl_tpu.visualization import ValidationSummary as JValidationSummary
from bigdl_tpu.visualization import tensorboard as jtb
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Plateau, Trigger
from bigdl_tpu_torch.optim import validation as tval
from bigdl_tpu_torch.utils import engine as torch_engine
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from bigdl_tpu_torch.visualization import (
    TrainSummary, ValidationSummary, read_events,
)
from bigdl_tpu_torch.visualization import tensorboard as ttb

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reset():
    yield
    JEngine.reset()
    torch_engine.Engine.reset()


# ------------------------------------------------------------ event files
def test_crc32c_known_vectors():
    for data, want in ((b"\x00" * 32, 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43),
                       (bytes(range(32)), 0x46DD794E),
                       (b"123456789", 0xE3069283)):
        assert ttb._crc32c(data) == jtb._crc32c(data) == want


def _write(mod, d):
    w = mod.EventWriter(str(d))
    w.add_scalar("Loss", 1.25, 3)
    w.add_histogram("0/weight", np.arange(12, dtype=np.float32), 3)
    w.add_scalar("Loss", 0.5, 4)
    w.close()
    (name,) = [f for f in os.listdir(d) if ".tfevents." in f]
    return os.path.join(str(d), name)


def _records(events):
    return [(e["step"], e["values"]) for e in events]


def test_event_files_read_across_packages(tmp_path):
    ours = _write(ttb, tmp_path / "port")
    theirs = _write(jtb, tmp_path / "jax")
    assert _records(jtb.read_events(ours)) == _records(read_events(ours))
    assert _records(read_events(theirs)) == _records(jtb.read_events(theirs))
    assert _records(read_events(ours)) == _records(read_events(theirs))
    scalars = [(s, v) for s, vals in _records(read_events(ours))
               for t, v in vals if t == "Loss"]
    assert scalars == [(3, 1.25), (4, 0.5)]


# -------------------------------------------------------- training run
def _samples(n=64, dim=8, classes=3):
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(dim,)).astype(np.float32),
             np.int32(rng.integers(0, classes))) for _ in range(n)]


def _jax_model():
    JEngine.init(seed=0)
    JaxRNG.set_seed(4)
    return jnn.Sequential().add(jnn.Linear(8, 3)).add(jnn.LogSoftMax())


def _port_model(jm):
    m = nn.Sequential().add(nn.Linear(8, 3)).add(nn.LogSoftMax())
    load_jax_params(m, jax.device_get(jm.get_params()))
    return m


def _run_jax(jm, d, method, val_every=2, n_iter=8, val=None):
    data = JDataSet.array(JSample(x, y) for x, y in _samples()) \
        >> JSampleToMiniBatch(16)
    ts = JTrainSummary(str(d), "run")
    ts.set_summary_trigger("Parameters", JTrigger.several_iteration(2))
    vs = JValidationSummary(str(d), "run")
    opt = (JLocalOptimizer(jm, data, jnn.ClassNLLCriterion())
           .set_optim_method(method)
           .set_end_when(JTrigger.max_iteration(n_iter))
           .set_validation(JTrigger.several_iteration(val_every), data,
                           [val or jval.Top1Accuracy()])
           .set_train_summary(ts).set_val_summary(vs))
    JaxRNG.set_seed(21)
    opt.optimize()
    ts.close(), vs.close()
    return ts, vs


def _run_port(tm, d, method, val_every=2, n_iter=8, val=None, fuse=1):
    data = DataSet.array(Sample(x, y) for x, y in _samples()) \
        >> SampleToMiniBatch(16)
    ts = TrainSummary(str(d), "run")
    ts.set_summary_trigger("Parameters", Trigger.several_iteration(2))
    vs = ValidationSummary(str(d), "run")
    opt = (LocalOptimizer(tm, data, nn.ClassNLLCriterion(), device="cpu")
           .set_optim_method(method).set_fuse_steps(fuse)
           .set_end_when(Trigger.max_iteration(n_iter))
           .set_validation(Trigger.several_iteration(val_every), data,
                           [val or tval.Top1Accuracy()])
           .set_train_summary(ts).set_val_summary(vs))
    RandomGenerator.set_seed(21)
    opt.optimize()
    ts.close(), vs.close()
    return ts, vs


def _points(summary) -> dict:
    """tag -> {step: value (None for a histogram)}; JAX's feed-stage
    curves (``FeedStage/*``) come with the feed, not ported yet."""
    out: dict = {}
    for f in os.listdir(summary.dir):
        if ".tfevents." not in f:
            continue
        for ev in read_events(os.path.join(summary.dir, f)):
            for tag, v in ev["values"]:
                if not tag.startswith("FeedStage/"):
                    out.setdefault(tag, {})[ev["step"]] = v
    return out


def test_training_run_writes_jax_tags_at_jax_steps(tmp_path):
    jm = _jax_model()
    tm = _port_model(jm)
    jts, jvs = _run_jax(jm, tmp_path / "jax", JSGD(learningrate=0.1))
    tts, tvs = _run_port(tm, tmp_path / "port", SGD(learningrate=0.1))
    for ours, theirs in ((_points(tts), _points(jts)),
                         (_points(tvs), _points(jvs))):
        assert set(ours) == set(theirs)
        for tag in theirs:
            if tag == "Throughput":
                continue
            assert sorted(ours[tag]) == sorted(theirs[tag]), tag
            if tag in ("Loss", "LearningRate", "Top1Accuracy"):
                for step, v in theirs[tag].items():
                    assert ours[tag][step] == pytest.approx(v, rel=RTOL)
    # Throughput: from iteration 3 (the first window holds the warm-up and
    # the second starts the clock); JAX writes it from 3 too when its
    # second step has finished by its fetch (its CPU dispatch is
    # asynchronous), else from 4
    assert sorted(_points(tts)["Throughput"]) == list(range(3, 9))
    assert set(_points(jts)["Throughput"]) <= set(range(3, 9))
    assert sorted(_points(tts)["Loss"]) == list(range(1, 9))
    assert {"0/weight", "0/bias", "ValFetchBytes", "ValWaitMs"} <= \
        set(_points(tts)) | set(_points(tvs))
    # fused windows write the same per-iteration points
    fused, _ = _run_port(_port_model(jm), tmp_path / "fused",
                         SGD(learningrate=0.1), fuse=4)
    assert _points(fused)["Loss"].keys() == _points(tts)["Loss"].keys()


# ------------------------------------------------------------ Plateau
def _plateau_pair(monitor):
    kw = dict(factor=0.5, patience=1, mode="max" if monitor != "loss"
              else "min", epsilon=1e-4, cooldown=1, min_lr=1e-3)
    return jschedules.Plateau(monitor, **kw), Plateau(monitor, **kw)


@pytest.mark.parametrize("monitor", ["score", "Top1Accuracy", "loss"])
@pytest.mark.parametrize("layout", ["plain", "composite", "flat"])
def test_plateau_hook_matches_jax(monitor, layout):
    values = [0.5, 0.6, 0.6, 0.59, 0.6, 0.61, 0.61, 0.61, 0.7, 0.7, 0.7]
    jsched, tsched = _plateau_pair(monitor)
    jm = _jax_model()
    tm = _port_model(jm)
    jopt = (JLocalOptimizer(jm, JDataSet.array([]), jnn.ClassNLLCriterion())
            .set_optim_method(JSGD(learningrate=0.1,
                                   learningrate_schedule=jsched)))
    topt = (LocalOptimizer(tm, DataSet.array([]), nn.ClassNLLCriterion(),
                           device="cpu")
            .set_optim_method(SGD(learningrate=0.1,
                                  learningrate_schedule=tsched)))
    if layout == "composite":
        tm[0].set_name("lin")
        topt.set_optim_methods({"lin": SGD(learningrate=0.2)})
    topt.set_flat_update(layout == "flat")
    topt._prepare_step()
    jostate = {"clr": jax.numpy.asarray(0.1, jax.numpy.float32)}
    owner = topt._ostate["default"] if layout == "composite" else (
        topt._ostate["slots"] if layout == "flat" else topt._ostate)
    got, want = [], []
    for v in values:
        key = {"score": "score", "loss": "loss"}.get(monitor)
        state = ({key: v} if key else {"scores": {monitor: v}})
        topt.state.update(state)
        topt._update_stateful_schedule()
        jopt._update_stateful_schedule(jostate, dict(state))
        got.append(owner["clr"])
        want.append(float(jostate["clr"]))
    assert got == pytest.approx(want, rel=1e-7)
    assert len(set(want)) > 2          # the rate did fall, more than once


def test_plateau_lowers_the_rate_as_jax_does_in_training(tmp_path,
                                                         monkeypatch):
    """Validation every iteration, ``Plateau("Top1Accuracy")``: the rate
    after each validation is JAX's. (JAX writes an iteration's
    LearningRate when its loss is fetched, which may come after that
    iteration's validation; the port writes the rate the step ran with,
    so its point at k + 1 is the rate after validation k.)"""
    jm = _jax_model()
    tm = _port_model(jm)
    jsched, tsched = _plateau_pair("Top1Accuracy")
    jsched.patience = tsched.patience = 0
    want, got = [], []
    jhook = JLocalOptimizer._update_stateful_schedule
    thook = LocalOptimizer._update_stateful_schedule

    def jax_recorded(self, ostate, state):
        jhook(self, ostate, state)
        want.append(float(ostate["clr"]))

    def port_recorded(self):
        thook(self)
        got.append(self._ostate["clr"])

    monkeypatch.setattr(JLocalOptimizer, "_update_stateful_schedule",
                        jax_recorded)
    monkeypatch.setattr(LocalOptimizer, "_update_stateful_schedule",
                        port_recorded)
    _run_jax(jm, tmp_path / "jax",
             JSGD(learningrate=2.0, learningrate_schedule=jsched),
             val_every=1, n_iter=10)
    tts, _ = _run_port(tm, tmp_path / "port",
                       SGD(learningrate=2.0, learningrate_schedule=tsched),
                       val_every=1, n_iter=10)
    assert len(got) == len(want) == 10
    assert got == pytest.approx(want, rel=RTOL)
    assert len(set(want)) > 2     # Plateau fired, more than once
    lr = _points(tts)["LearningRate"]
    assert [lr[k + 1] for k in range(1, 10)] == pytest.approx(got[:-1],
                                                              rel=RTOL)


# ------------------------------------------------------------ profiling
def test_set_profile_writes_a_chrome_trace(tmp_path):
    jm = _jax_model()
    data = DataSet.array(Sample(x, y) for x, y in _samples()) \
        >> SampleToMiniBatch(16)
    opt = (LocalOptimizer(_port_model(jm), data, nn.ClassNLLCriterion(),
                          device="cpu")
           .set_optim_method(SGD(learningrate=0.1)).set_fuse_steps(4)
           .set_end_when(Trigger.max_iteration(8))
           .set_profile(str(tmp_path), start_iter=3, n_iters=2))
    windows = []
    run_steps = opt._run_steps
    opt._run_steps = lambda steps: windows.append(len(steps)) or \
        run_steps(steps)
    opt.optimize()
    assert os.listdir(tmp_path) == ["trace.iter3-4.json"]
    trace = json.load(open(tmp_path / "trace.iter3-4.json"))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("addmm" in n for n in names)
    # step by step while profiling, fused windows before and after
    assert windows == [1, 1, 1, 1, 4]
    assert opt.profile_dir is None
