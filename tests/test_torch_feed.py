"""The port's host feed against JAX's, on the CPU.

- ``PrefetchingFeed``: train and eval grouping (full windows, the ragged
  tail) equal to JAX's at depth 0 and 2; a producer exception re-raised
  with its type and the producer's traceback as ``__cause__``; ``close()``
  mid-epoch leaves no producer thread;
- the batch ring: batches equal JAX's ``SampleToMiniBatch``; a slot a
  consumer holds is never written before it is recycled, and comes back
  after; the CPU placement (``dataset/h2d.py``) never aliases the ring;
  ``HostToDevice.place`` stacks a full window of one shape once, places
  anything else batch by batch, and returns ring slots only when asked;
- ``native.pack_batch`` and ``gather_rows`` equal JAX's;
- ``fuse_chain``/``plan_stages`` with a seeded per-sample random transform:
  4 workers bitwise equal to 1 and to JAX's output; a worker death absorbed
  by the crash budget;
- ``run_guarded`` under each ``BIGDL_BAD_SAMPLE_POLICY``, with JAX's
  results and counters;
- the trainer: ``set_prefetch(2)`` bitwise equal to ``set_prefetch(0)`` at
  fuse 1 and fuse 4 (windows clipped by a checkpoint trigger), a mid-epoch
  preemption and resume with the producer running bitwise equal to the
  uninterrupted run, the device batch cache on and off, an ``h2d`` fault
  of the producer surfacing in ``optimize()``, and the ``FeedStage/*``
  summary keys equal to JAX's.

Bitwise trainer comparisons run on one CPU thread (see
``tests/test_torch_preemption.py``).
"""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu import Engine as JEngine
from bigdl_tpu import nn as jnn
from bigdl_tpu import native as jnative
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import parallel as jparallel
from bigdl_tpu.dataset import resilience as jresilience
from bigdl_tpu.dataset import transformer as jtransformer
from bigdl_tpu.dataset.prefetch import PrefetchingFeed as JPrefetchingFeed
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.dataset.sample import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.visualization import TrainSummary as JTrainSummary
from bigdl_tpu_torch import native, nn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.dataset import (
    DataSet, MiniBatch, Sample, SampleToMiniBatch, parallel, resilience,
    transformer,
)
from bigdl_tpu_torch.dataset.h2d import HostToDevice, ready_groups
from bigdl_tpu_torch.dataset.prefetch import PrefetchingFeed, ProducerTraceback
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.optim.optimizer import TrainingPreempted
from bigdl_tpu_torch.utils import engine as torch_engine
from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from bigdl_tpu_torch.visualization import TrainSummary
from bigdl_tpu_torch.visualization.tensorboard import read_events


@pytest.fixture(autouse=True)
def _reset():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    JEngine.reset()
    torch_engine.Engine.reset()


def _producers() -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith("bigdl-prefetch")]


# ----------------------------------------------------------------- feed
@pytest.mark.parametrize("window", [1, 3])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("depth", [0, 2])
def test_feed_grouping_matches_jax(depth, train, window):
    items = list(range(8))

    def groups(cls):
        feed = cls(lambda: iter(items), lambda b: b, depth=depth,
                   window=window, train=train)
        with feed:
            out = [batch for batch, _ in feed]
        return out, feed.position()

    got, pos = groups(PrefetchingFeed)
    want, jpos = groups(JPrefetchingFeed)
    assert got == want and pos == jpos
    if window == 3:
        assert [len(g) for g in got] == ([3, 3, 2] if train
                                         else [3, 3, 1, 1])
    assert not _producers()


def test_producer_exception_carries_its_cause():
    def bad():
        yield 1
        raise ValueError("boom")

    def raised(cls):
        with pytest.raises(ValueError, match="boom") as info:
            for _ in cls(bad, lambda b: b, depth=2):
                pass
        return info.value

    got, want = raised(PrefetchingFeed), raised(JPrefetchingFeed)
    assert type(got) is type(want)
    assert isinstance(got.__cause__, ProducerTraceback)
    assert "in bad" in str(got.__cause__) and "boom" in str(got.__cause__)
    assert not _producers()


def test_close_mid_epoch_leaves_no_thread():
    def slow():
        for i in range(100):
            time.sleep(0.002)
            yield i

    feed = PrefetchingFeed(slow, lambda b: b, depth=2)
    taken = []
    with feed:
        for batch, _ in feed:
            taken.append(batch)
            if len(taken) == 3:
                break
    assert taken == [0, 1, 2] and feed.position()["delivered"] == 3
    assert not _producers()


# ----------------------------------------------------------------- ring
def _samples(n=10, shape=(3, 4), seed=0):
    r = np.random.default_rng(seed)
    return [(r.normal(size=shape).astype(np.float32), np.int32(i % 5))
            for i in range(n)]


def test_ring_batches_match_jax_and_slots_wait_for_release():
    samples = _samples()
    want = list(JSampleToMiniBatch(4, ring_depth=2).apply(
        JSample(x, y) for x, y in samples))
    stm = SampleToMiniBatch(4, ring_depth=2)
    got = list(stm.apply(Sample(x, y) for x, y in samples))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.input, w.input)
        np.testing.assert_array_equal(g.target, w.target)
        assert g.valid == w.valid
    # a held slot: the ring runs dry and stacks fresh; the held batch is
    # never written until it is recycled, then its buffer comes back
    stm = SampleToMiniBatch(4, ring_depth=2)
    it = stm.apply(Sample(x, y) for x, y in samples * 3)
    first = next(it)
    held = first.input.copy()
    second = next(it)
    third = next(it)               # ring of 2 is dry: a fresh array
    assert third._ring_slot is None and second._ring_slot is not None
    np.testing.assert_array_equal(first.input, held)
    buf = first.input
    first.recycle()
    fourth = next(it)
    assert fourth.input is buf and not np.array_equal(buf, held)
    # the CPU placement owns its bytes: a recycled slot's reuse leaves it
    placed = HostToDevice("cpu").put(fourth)
    snapshot = placed.inp.clone()
    fifth = next(it)
    assert fifth.input is buf
    assert torch.equal(placed.inp, snapshot)
    assert not stm.pinned and not fourth.pinned


@pytest.mark.parametrize("case", ["batch", "full", "partial", "ragged"])
@pytest.mark.parametrize("recycle", [True, False])
def test_place_groups_a_feed_item_and_recycles_on_request(case, recycle):
    stm = SampleToMiniBatch(2, ring_depth=8)
    batches = list(stm.apply(Sample(x, y) for x, y in _samples(6)))
    odd = MiniBatch(np.zeros((2, 5), np.float32), np.zeros(2, np.int32))
    item = {"batch": batches[0], "full": batches, "partial": batches[:2],
            "ragged": batches[:2] + [odd]}[case]
    placed = HostToDevice("cpu").place(item, 3, recycle=recycle)
    groups = ready_groups(item, placed)
    # a full window of one shape is stacked once; anything else (a
    # partial tail, a window whose shapes differ) goes batch by batch
    assert [len(g) for g, _ in groups] == {
        "batch": [1], "full": [3], "partial": [1, 1],
        "ragged": [1, 1, 1]}[case]
    for group, (inp, target) in groups:
        want = [np.asarray(b.input) for b in group]
        np.testing.assert_array_equal(
            inp.numpy(), np.stack(want) if len(group) > 1 else want[0])
    ring = [b for b in (item if isinstance(item, list) else [item])
            if b is not odd]
    assert all((b._ring_slot is None) == recycle for b in ring)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int64])
def test_pack_batch_and_gather_rows_match_jax(dtype):
    assert native.native_available()
    r = np.random.default_rng(3)
    arrays = [(r.normal(size=(5, 7)) * 50).astype(dtype) for _ in range(6)]
    np.testing.assert_array_equal(native.pack_batch(arrays),
                                  jnative.pack_batch(arrays))
    src = np.stack(arrays)
    idx = np.array([5, 0, 3, 3, 1])
    np.testing.assert_array_equal(native.gather_rows(src, idx),
                                  jnative.gather_rows(src, idx))
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([-1]))


# ------------------------------------------------------------- parallel
def _noisy(current_sample_index):
    """A per-sample random transform: noise from (seed, sample index)."""
    def fn(s):
        rng = np.random.default_rng((7, current_sample_index()))
        x = s.feature[0] + rng.normal(size=s.feature[0].shape).astype(
            np.float32)
        return type(s)(x, s.label[0])
    return fn


def _scaled(s):
    return type(s)(s.feature[0] * 2, s.label[0])


def _port_batches(workers, monkeypatch):
    monkeypatch.setenv("BIGDL_DATA_WORKERS", str(workers))
    ds = (DataSet.array(Sample(x, y) for x, y in _samples(13))
          >> transformer.MapTransformer(_noisy(
              transformer.current_sample_index))
          >> transformer.MapTransformer(_scaled) >> SampleToMiniBatch(4))
    return [(b.input.copy(), b.target.copy()) for b in ds.data(train=True)]


def test_parallel_workers_are_bitwise_one_and_jax(monkeypatch):
    chain = [transformer.MapTransformer(_scaled),
             transformer.MapTransformer(_scaled), SampleToMiniBatch(4),
             transformer.MapTransformer(lambda b: b)]
    jchain = [jtransformer.MapTransformer(_scaled),
              jtransformer.MapTransformer(_scaled), JSampleToMiniBatch(4),
              jtransformer.MapTransformer(lambda b: b)]
    got = [type(s).__name__ for s in parallel.plan_stages(chain, 4)]
    want = [type(s).__name__ for s in jparallel.plan_stages(jchain, 4)]
    assert got == want == ["ParallelTransformer", "SampleToMiniBatch",
                           "ParallelTransformer"]
    assert len(parallel.plan_stages(chain, 4)[0].inner.stages) == 2
    one = _port_batches(1, monkeypatch)
    four = _port_batches(4, monkeypatch)
    jds = (JDataSet.array(JSample(x, y) for x, y in _samples(13))
           >> jtransformer.MapTransformer(_noisy(
               jtransformer.current_sample_index))
           >> jtransformer.MapTransformer(_scaled) >> JSampleToMiniBatch(4))
    jax_out = [(np.asarray(b.input), np.asarray(b.target))
               for b in jds.data(train=True)]
    assert len(one) == len(four) == len(jax_out) == 4
    for a, b, c in zip(one, four, jax_out):
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)


def test_worker_death_is_absorbed_as_jax(monkeypatch):
    monkeypatch.setenv("BIGDL_WORKER_CRASH_BUDGET", "2")
    monkeypatch.setenv("BIGDL_DATA_WORKERS", "2")
    with faults.inject_faults("transform_worker@3") as plan:
        got = _port_batches(2, monkeypatch)
    assert not plan.unfired()
    np.testing.assert_array_equal(got[0][0], _port_batches(1, monkeypatch)[
        0][0])
    with faults.inject_faults(";".join(f"transform_worker@{i}"
                                       for i in (1, 2, 3))):
        with pytest.raises(faults.WorkerDeathError):
            _port_batches(2, monkeypatch)


@pytest.mark.parametrize("policy", ["raise", "skip", "retry"])
def test_run_guarded_policies_match_jax(policy, monkeypatch):
    monkeypatch.setenv("BIGDL_BAD_SAMPLE_POLICY", policy)
    monkeypatch.setenv("BIGDL_RETRY_BACKOFF_MS", "0")
    monkeypatch.setenv("BIGDL_SAMPLE_RETRIES", "2")

    def outcome(mod):
        mod.reset_counters()
        calls = []

        def flaky(x):
            calls.append(x)
            if len(calls) < 2:
                raise OSError("transient")
            return x * 3

        def broken(x):
            raise OSError("corrupt")

        res = []
        for fn in (flaky, broken):
            try:
                r = mod.run_guarded("decode", fn, 5)
                res.append("SKIPPED" if r is mod.SKIPPED else r)
            except OSError as e:
                res.append(str(e))
        return res, mod.stage_counters()

    got, want = outcome(resilience), outcome(jresilience)
    assert got == want
    assert got[0] == {"raise": (["transient", "corrupt"], {}),
                      "skip": (["SKIPPED", "SKIPPED"],
                               {"decode": {"skipped": 2}}),
                      "retry": ([15, "corrupt"],
                                {"decode": {"retried": 3}})}[policy][0]


# -------------------------------------------------------------- trainer
class _Model:
    """The same small MLP in both packages, JAX's weights in the port."""

    @staticmethod
    def jax():
        JaxRNG.set_seed(3)
        return (jnn.Sequential().add(jnn.View([12])).add(jnn.Linear(12, 8))
                .add(jnn.ReLU()).add(jnn.Linear(8, 5)).add(jnn.LogSoftMax()))

    @staticmethod
    def port(jm=None):
        import jax
        jm = jm or _Model.jax()
        tm = (nn.Sequential().add(nn.View([12])).add(nn.Linear(12, 8))
              .add(nn.ReLU()).add(nn.Linear(8, 5)).add(nn.LogSoftMax()))
        load_jax_params(tm, jax.device_get(jm.get_params()))
        return tm


def _trainer(depth, fuse=1, n_iter=9, ckpt=None, data=None):
    RandomGenerator.set_seed(4)
    data = data or (DataSet.array(Sample(x, y) for x, y in _samples(24))
                    >> SampleToMiniBatch(4))
    opt = (LocalOptimizer(_Model.port(), data, nn.ClassNLLCriterion(),
                          device="cpu")
           .set_optim_method(SGD(learningrate=0.1, momentum=0.9))
           .set_end_when(Trigger.max_iteration(n_iter))
           .set_fuse_steps(fuse).set_prefetch(depth))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), Trigger.several_iteration(3))
    losses = []
    run = opt._run_steps

    def recorded(steps):
        out = run(steps)
        losses.extend(out)
        return out

    opt._run_steps = recorded
    return opt, losses


def _params(opt):
    return {n: p.detach().clone() for n, p in opt.model.named_parameters()}


@pytest.mark.parametrize("fuse", [1, 4])
def test_prefetch_is_bitwise_the_synchronous_feed(fuse, tmp_path):
    runs = []
    for depth in (2, 0):
        opt, losses = _trainer(depth, fuse, ckpt=tmp_path / f"d{depth}")
        opt.optimize()
        runs.append((losses, _params(opt), dict(opt.state)))
    (l2, p2, s2), (l0, p0, s0) = runs
    assert len(l2) == 9 and l2 == l0 and s2 == s0
    assert all(torch.equal(p2[n], p0[n]) for n in p0)
    assert not _producers()


def test_resume_with_a_live_producer_is_bitwise(tmp_path):
    ref, ref_losses = _trainer(2, n_iter=12)
    ref.optimize()
    opt, losses = _trainer(2, n_iter=12, ckpt=tmp_path)
    with faults.inject_faults("sigterm@8"):
        with pytest.raises(TrainingPreempted) as info:
            opt.optimize()
    assert info.value.iteration == 9
    assert signal.getsignal(signal.SIGTERM) is not None
    resumed, more = _trainer(2, n_iter=12, ckpt=tmp_path)
    resumed.optimize(resume="auto")
    assert losses + more == ref_losses
    p, q = _params(resumed), _params(ref)
    assert all(torch.equal(p[n], q[n]) for n in q)
    assert not _producers()


def test_device_cache_and_h2d_fault(monkeypatch):
    batches = [MiniBatch(np.random.default_rng(i).normal(
        size=(4, 3, 4)).astype(np.float32), np.arange(4, dtype=np.int32))
        for i in range(3)]
    runs = []
    for cache in ("1", "0"):
        monkeypatch.setenv("BIGDL_DEVICE_CACHE", cache)
        opt, losses = _trainer(2, n_iter=7, data=DataSet.array(batches))
        opt.optimize()
        held = opt._device_batch_cache
        assert (held is not None and len(held) == 3) == (cache == "1")
        runs.append((losses, _params(opt)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][n], runs[1][1][n]) for n in runs[0][1])
    # a failed placement in the producer reaches optimize(), which has no
    # checkpoint to retry from
    monkeypatch.setenv("BIGDL_DEVICE_CACHE", "0")
    opt, _ = _trainer(2, n_iter=7, data=DataSet.array(batches))
    with faults.inject_faults("h2d@2"), pytest.raises(faults.FaultError):
        opt.optimize()
    assert not _producers()


def test_feed_stage_summaries_match_jax_keys(tmp_path):
    def tags(summary):
        out = set()
        for f in os.listdir(summary.dir):
            if ".tfevents." in f:
                for ev in read_events(os.path.join(summary.dir, f)):
                    out |= {t for t, _ in ev["values"]
                            if t.startswith("FeedStage/")}
        return out

    JEngine.init()
    jm = _Model.jax()
    jds = (JDataSet.array(JSample(x, y) for x, y in _samples(24))
           >> JSampleToMiniBatch(4))
    jts = JTrainSummary(str(tmp_path / "jax"), "run")
    JaxRNG.set_seed(4)
    (JLocalOptimizer(jm, jds, jnn.ClassNLLCriterion())
     .set_optim_method(JSGD(learningrate=0.1))
     .set_end_when(JTrigger.max_iteration(4)).set_train_summary(jts)
     .optimize())
    jts.close()
    opt, _ = _trainer(2, n_iter=4)
    ts = TrainSummary(str(tmp_path / "port"), "run")
    opt.model = _Model.port(jm)
    opt.set_train_summary(ts).optimize()
    ts.close()
    assert tags(ts) == tags(jts) == {"FeedStage/stack_ms", "FeedStage/h2d_ms"}
    assert set(opt.feed_stage_ms) == {"stack", "h2d"}
