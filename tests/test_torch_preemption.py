"""Preemption and resume of the port's trainer, on the CPU.

- JAX's ``test_sigterm_then_auto_resume_is_bitwise``
  (``tests/test_faults.py``) on the port: LeNet-5, a checkpoint every 3
  iterations, ``sigterm@6`` mid-epoch 2; a fresh optimizer resumes with
  ``resume="auto"`` and ends bitwise on the uninterrupted run's parameters.
  The same plan on JAX's trainer gives the same ``iteration``, the same
  checkpoint files and the same event counts.
- A fused run (``set_fuse_steps(4)``, windows clipped at the checkpoint
  trigger): the stop comes at the end of the window holding the signal,
  and the resume is bitwise.
- A CIFAR ResNet with batch norm: the running statistics (``mstate``)
  resume bitwise too.
- The previous SIGTERM handler is back after the stop; without a
  checkpoint path the stop still raises, with ``checkpoint_path`` None.

The bitwise comparisons run on one CPU thread: the CPU's multi-threaded
convolution and matrix kernels split their sums by thread, so two runs in
one process may differ in the last bit (on the card the runs are
deterministic, ``chip_smoke.py`` phase 11).
"""

import os
import signal

import numpy as np
import pytest
import torch

from bigdl_tpu import Engine as JEngine
from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.dataset.sample import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.models.lenet.lenet5 import LeNet5 as JLeNet5
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim.optimizer import TrainingPreempted as JTrainingPreempted
from bigdl_tpu.utils import faults as jfaults
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.utils.robustness import events as jevents
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.resnet import ResNet
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.optim.optimizer import TrainingPreempted
from bigdl_tpu_torch.utils import engine as torch_engine
from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from bigdl_tpu_torch.utils.robustness import events


@pytest.fixture(autouse=True)
def _reset():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    JEngine.reset()
    torch_engine.Engine.reset()


def _samples(n=32, shape=(28, 28), classes=10):
    rng = np.random.default_rng(0)
    return [(rng.normal(size=shape).astype(np.float32),
             np.int32(rng.integers(0, classes))) for _ in range(n)]


def _opt(model, ckpt=None, n_iter=8, fuse=1, every=3, samples=None):
    RandomGenerator.set_seed(1)
    data = DataSet.array(Sample(x, y) for x, y in samples or _samples()) \
        >> SampleToMiniBatch(8)
    opt = (LocalOptimizer(model, data, nn.ClassNLLCriterion(), device="cpu")
           .set_optim_method(SGD(learningrate=0.05, momentum=0.9))
           .set_end_when(Trigger.max_iteration(n_iter))
           .set_fuse_steps(fuse))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), Trigger.several_iteration(every))
    return opt


def _lenet():
    return LeNet5(10, generator=torch.Generator().manual_seed(7),
                  device="cpu")


def _tensors(model) -> dict:
    return {n: t.detach().clone() for n, t in
            list(model.named_parameters()) + list(model.named_buffers())}


def _bitwise(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _preempt(opt, plan):
    with pytest.raises(TrainingPreempted) as ei:
        with faults.inject_faults(plan):
            opt.optimize()
    return ei.value


def test_sigterm_then_auto_resume_is_bitwise(tmp_path):
    ref = _tensors(_opt(_lenet()).optimize())
    snap = events.snapshot()
    stopped = _preempt(_opt(_lenet(), tmp_path), "sigterm@6")
    assert stopped.checkpoint_path == str(tmp_path)
    assert stopped.iteration == 7
    assert events.deltas(snap) == {"fault_injected": 1, "preemption": 1}
    opt2 = _opt(_lenet(), tmp_path)
    resumed = opt2.optimize(resume="auto")
    assert opt2.state["neval"] == 9
    assert _bitwise(ref, _tensors(resumed))
    assert events.deltas(snap).get("resume") == 1


def test_preemption_matches_jax(tmp_path):
    """The same plan on both trainers: the same ``iteration``, checkpoint
    path, files on disk and event counts."""
    stopped = _preempt(_opt(_lenet(), tmp_path / "port"), "sigterm@6")
    port_files = sorted(os.listdir(tmp_path / "port"))

    JEngine.init(seed=7)
    JaxRNG.set_seed(1)
    jdata = JDataSet.array(JSample(x, y) for x, y in _samples()) \
        >> JSampleToMiniBatch(8)
    jopt = (JLocalOptimizer(JLeNet5(10), jdata, jnn.ClassNLLCriterion())
            .set_optim_method(JSGD(learningrate=0.05, momentum=0.9))
            .set_end_when(JTrigger.max_iteration(8))
            .set_checkpoint(str(tmp_path / "jax"),
                            JTrigger.several_iteration(3)))
    snap = jevents.snapshot()
    with pytest.raises(JTrainingPreempted) as ei:
        with jfaults.inject_faults("sigterm@6"):
            jopt.optimize()
    assert ei.value.iteration == stopped.iteration == 7
    assert ei.value.checkpoint_path == str(tmp_path / "jax")
    assert jevents.deltas(snap) == {"fault_injected": 1, "preemption": 1}
    assert sorted(os.listdir(tmp_path / "jax")) == port_files == [
        "checkpoint.3.pkl", "checkpoint.6.pkl", "checkpoint.7.pkl"]


def test_fused_window_stops_at_its_end_and_resumes_bitwise(tmp_path):
    ref = _tensors(_opt(_lenet(), n_iter=12, fuse=4).optimize())
    windows = []
    opt = _opt(_lenet(), tmp_path, n_iter=12, fuse=4, every=4)
    run_steps = opt._run_steps
    opt._run_steps = lambda steps: windows.append(len(steps)) or \
        run_steps(steps)
    stopped = _preempt(opt, "sigterm@6")
    assert windows == [4, 4] and stopped.iteration == 9
    opt2 = _opt(_lenet(), tmp_path, n_iter=12, fuse=4, every=4)
    assert _bitwise(ref, _tensors(opt2.optimize(resume="auto")))


def test_resnet_running_statistics_resume_bitwise(tmp_path):
    def resnet():
        return ResNet(10, {"depth": 8, "shortcutType": "B"},
                      generator=torch.Generator().manual_seed(3),
                      device="cpu")

    samples = _samples(n=16, shape=(3, 16, 16))
    ref_model = resnet()
    _opt(ref_model, n_iter=6, samples=samples).optimize()
    ref = _tensors(ref_model)
    assert any("running_mean" in k for k in ref)
    stopped = _preempt(_opt(resnet(), tmp_path, n_iter=6, samples=samples),
                       "sigterm@4")
    assert stopped.iteration == 5
    model = resnet()
    _opt(model, tmp_path, n_iter=6, samples=samples).optimize(resume="auto")
    assert _bitwise(ref, _tensors(model))


def test_handler_restored_and_no_checkpoint_path():
    before = signal.getsignal(signal.SIGTERM)
    stopped = _preempt(_opt(_lenet(), n_iter=6), "sigterm@2")
    assert stopped.checkpoint_path is None and stopped.iteration == 3
    assert signal.getsignal(signal.SIGTERM) is before
