"""The feed's host-to-device path on the GPU (``dataset/h2d.py``): the
pinned ring, the copy stream, a ring slot recycled only after its copy's
event, and the evaluator's batches held until its host fold has read
them.

Marked ``gpu``: they skip where there is no CUDA device (pinned memory and
CUDA streams have no CPU form). This file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda_feed.py

A slow consumer holds each placed batch while the producer refills the
ring: a slot overwritten before its copy completed, or a device buffer
handed out again while the compute stream still read it, would show as a
batch whose values are not its own.
"""

import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import native, nn
from bigdl_tpu_torch.dataset import (
    DataSet, MiniBatch, PrefetchingFeed, Sample, SampleToMiniBatch,
)
from bigdl_tpu_torch.dataset.h2d import HostToDevice
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.utils.programs import capture_guard

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned memory and CUDA streams "
                    "have no CPU form")
    return torch.device("cuda")


def _samples(n, shape=(64, 64, 3), dtype=np.uint8):
    # sample i is filled with i: every batch's rows are known
    return [Sample(np.full(shape, i % 251, dtype), np.int32(i % 5))
            for i in range(n)]


def test_ring_is_pinned_and_copies_on_a_stream_of_its_own(cuda):
    assert native.native_available()
    stm = SampleToMiniBatch(8, ring_depth=2).pin()
    h2d = HostToDevice(cuda)
    batch = next(stm.apply(iter(_samples(8))))
    assert batch.pinned and torch.from_numpy(batch.input).is_pinned()
    placed = h2d.put(batch)
    assert placed.event.query()          # the producer waited for it
    assert h2d._stream != torch.cuda.current_stream()
    inp, target = placed.ready()
    assert inp.is_cuda and torch.equal(
        inp[:, 0, 0, 0].cpu(), torch.arange(8, dtype=torch.uint8))
    assert batch._ring_slot is None      # recycled after the copy
    # a plain array goes through a pinned staging buffer
    plain = MiniBatch(np.ones((4, 5), np.float32), np.zeros(4, np.int32))
    assert torch.equal(h2d.put(plain).ready()[0].cpu(), torch.ones(4, 5))
    stacked = h2d.put_stacked([plain, plain])
    assert stacked.ready()[0].shape == (2, 4, 5)


def test_slow_consumer_sees_every_batch_as_its_own(cuda):
    stm = SampleToMiniBatch(16, ring_depth=2).pin()
    ds = DataSet.array(_samples(16 * 12)) >> stm
    h2d = HostToDevice(cuda)
    side = torch.cuda.Stream()
    feed = PrefetchingFeed(lambda: ds.data(train=False), h2d.put, depth=2)
    seen = []
    with feed:
        for batch, placed in feed:
            inp, target = placed.ready()
            # a long kernel queue on the compute stream reads the batch
            # after the producer has moved on to refill the ring
            acc = inp.float()
            for _ in range(200):
                acc = acc * 1.0
            time.sleep(0.01)
            seen.append((target.cpu(), acc[:, 0, 0, 0].cpu()))
            del inp, acc
            with torch.cuda.stream(side):
                torch.empty(16 * 64 * 64 * 3, dtype=torch.uint8,
                            device=cuda).fill_(255)
    for k, (target, first_px) in enumerate(seen):
        ids = torch.arange(16 * k, 16 * k + 16)
        assert torch.equal(target.long(), ids % 5)
        assert torch.equal(first_px, (ids % 251).float())


def test_trainer_feed_recycles_after_the_copy_and_guards_captures(cuda):
    stm = SampleToMiniBatch(8)
    data = DataSet.array(_samples(64, (12,), np.float32)) >> stm
    model = (nn.Sequential().add(nn.Linear(12, 8)).add(nn.ReLU())
             .add(nn.Linear(8, 5)).add(nn.LogSoftMax()).to(cuda))
    captures, live = [], []
    from bigdl_tpu_torch.utils import programs
    orig = programs.Program._warm_up_and_capture

    def spy(self):
        live.append(any(t.name.startswith("bigdl-prefetch")
                        for t in threading.enumerate()))
        captures.append(self.key[0])
        return orig(self)

    programs.Program._warm_up_and_capture = spy
    try:
        opt = (LocalOptimizer(model, data, nn.ClassNLLCriterion())
               .set_optim_method(SGD(learningrate=0.1))
               .set_end_when(Trigger.max_iteration(20)).set_prefetch(2))
        opt.optimize()
    finally:
        programs.Program._warm_up_and_capture = orig
    assert stm.pinned and captures == ["train_step"] and live == [True]
    assert np.isfinite(opt.state["loss"])
    assert set(opt.feed_stage_ms) >= {"stack", "h2d"}
    # the guard is free again once the run is over
    assert capture_guard().acquire(blocking=False)
    capture_guard().release()


def test_eval_host_fold_reads_each_batch_s_own_labels(cuda):
    """A method without a device fold scores each batch against its own
    labels: the evaluator's batches go back to the pinned ring only after
    the host fold has read them (a ring of 2 under windows of 3)."""
    from bigdl_tpu_torch.optim import Evaluator
    from bigdl_tpu_torch.optim import validation as val
    r = np.random.default_rng(3)
    xs = r.normal(size=(30, 12)).astype(np.float32)
    ys = r.integers(0, 5, 30).astype(np.int32)
    torch.manual_seed(0)
    model = (nn.Sequential().add(nn.Linear(12, 5)).add(nn.LogSoftMax()))
    got = {}
    for where, stm in (("cpu", SampleToMiniBatch(4, ring_depth=0)),
                       ("cuda", SampleToMiniBatch(4, ring_depth=2).pin())):
        ds = DataSet.array(Sample(x, y) for x, y in zip(xs, ys)) >> stm
        methods = [val.Loss(nn.ClassNLLCriterion(size_average=False)),
                   val.Loss()]
        res = Evaluator(model.to(where), device=where).test(
            ds, methods, fuse_steps=3)
        got[where] = [r.result() for r, _ in res]
    assert got["cuda"][0][1] == got["cuda"][1][1] == 30
    for (g, n), (w, m) in zip(got["cuda"], got["cpu"]):
        assert n == m and g == pytest.approx(w, rel=1e-5)
