"""The port's ranking metrics and ranking engine against the JAX package,
on the CPU.

- ``HitRatio``, ``NDCG`` and ``MAE``: host folds and device folds (the
  port's ``device_fold`` / ``finalize`` in torch against JAX's in jnp) on
  the same scores, padded tails masked; the refusals of misaligned batches
  and of groups without a positive; ``run_device_eval`` of a NeuralCF over
  grouped batches against the host loop;
- ``MeanAveragePrecision``: mAP over batches of detections and padded
  ground truth equal to JAX's;
- ``RankingEngine``: one program, every request's order a stable
  descending sort of the eager model's scores and JAX's order wherever
  JAX's neighbouring scores differ by more than 1e-4 (ties keep the
  submission order, as JAX's), the registry's ``ranking/*`` metrics and
  ``stats()`` keyed as JAX's, the shutdown refusal.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import optim as joptim
from bigdl_tpu.models.ncf import NeuralCF as JNeuralCF
from bigdl_tpu.obs.registry import registry as jregistry
from bigdl_tpu.serving.ranking import RankingEngine as JRankingEngine
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import optim
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.models.ncf import NeuralCF
from bigdl_tpu_torch.obs.registry import registry
from bigdl_tpu_torch.optim.evaluator import run_device_eval
from bigdl_tpu_torch.serving import EngineShutdown, RankingEngine
from bigdl_tpu_torch.utils import engine as torch_engine


@pytest.fixture(autouse=True)
def _one_thread_and_reset():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    registry.reset()
    yield
    torch.set_num_threads(threads)
    registry.reset()
    jax_engine.Engine.reset()
    torch_engine.Engine.reset()


def _groups(rows, group, seed=0, ties=False):
    """Scores (rows·group, 2) with the positive at a random place in each
    group (labels 1 there, 0 elsewhere)."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(rows * group, 2)).astype(np.float32)
    if ties:
        scores[::3, 1] = scores[1::3, 1][:len(scores[::3])]
    labels = np.zeros(rows * group, np.int32)
    labels[np.arange(rows) * group + rng.integers(0, group, rows)] = 1
    return scores, labels


def _fold_both(jm, tm, out, target, valid):
    n = len(target)
    mask = np.arange(n) < valid
    jpart = jm.device_fold(jnp.asarray(out), jnp.asarray(target),
                           jnp.asarray(mask))
    tpart = tm.device_fold(torch.from_numpy(out), torch.from_numpy(target),
                           torch.from_numpy(mask))
    return (jm.finalize(tuple(np.asarray(p) for p in jpart)),
            tm.finalize(tuple(float(p) for p in tpart)))


@pytest.mark.parametrize("name", ["HitRatio", "NDCG"])
@pytest.mark.parametrize("k,neg", [(10, 20), (3, 4)])
def test_ranking_metrics_fold_as_jax(name, k, neg):
    group = neg + 1
    jm, tm = getattr(joptim, name)(k, neg), getattr(optim, name)(k, neg)
    for seed, ties in ((0, False), (1, True)):
        out, target = _groups(6, group, seed, ties)
        # the host fold reads a score a candidate
        want = jm.apply(out[:, 1], target).result()
        got = tm.apply(out[:, 1], target).result()
        assert got[1] == want[1] == 6
        assert got[0] == pytest.approx(want[0], rel=1e-12)
        for valid in (6 * group, 4 * group + 2):
            jr, tr = _fold_both(jm, tm, out, target, valid)
            assert tr.result()[1] == jr.result()[1]
            assert tr.result()[0] == pytest.approx(jr.result()[0], rel=1e-6)
    with pytest.raises(ValueError, match="multiple of"):
        tm.apply(out[:-1, 1], target[:-1])
    with pytest.raises(ValueError, match="multiple of"):
        tm.device_fold(torch.from_numpy(out[:-1]),
                       torch.from_numpy(target[:-1]),
                       torch.ones(len(target) - 1, dtype=torch.bool))
    empty = np.zeros_like(target)
    with pytest.raises(ValueError, match="no positive"):
        tm.apply(out[:, 1], empty)
    part = tm.device_fold(torch.from_numpy(out), torch.from_numpy(empty),
                          torch.ones(len(empty), dtype=torch.bool))
    with pytest.raises(ValueError, match="no positive"):
        tm.finalize(tuple(float(p) for p in part))


def test_mae_folds_as_jax():
    rng = np.random.default_rng(2)
    out = rng.normal(size=(10, 3)).astype(np.float32)
    target = rng.normal(size=(10, 3)).astype(np.float32)
    jm, tm = joptim.MAE(), optim.MAE()
    for valid in (10, 7):
        want = jm.apply(out, target, valid).result()
        got = tm.apply(out, target, valid).result()
        assert got[1] == want[1]
        assert got[0] == pytest.approx(want[0], rel=1e-12)
        jr, tr = _fold_both(jm, tm, out, target, valid)
        assert tr.result()[1] == jr.result()[1] == valid
        assert tr.result()[0] == pytest.approx(jr.result()[0], rel=1e-6)


def test_mean_average_precision_matches_jax():
    rng = np.random.default_rng(3)

    def batch(n_img, k, g):
        gt = np.zeros((n_img, g, 5), np.float32)
        det = np.zeros((n_img, k, 6), np.float32)
        for i in range(n_img):
            for j in range(rng.integers(1, g + 1)):
                x0, y0 = rng.uniform(0, 0.6, 2)
                gt[i, j] = [rng.integers(1, 4), x0, y0, x0 + 0.3, y0 + 0.3]
            for j in range(k):
                src = gt[i, rng.integers(0, g)]
                jitter = rng.normal(scale=0.05, size=4)
                label = src[0] if src[0] > 0 else rng.integers(0, 4)
                det[i, j] = [label, rng.uniform(), *(src[1:] + jitter)]
        return det, gt

    (d1, g1), (d2, g2) = batch(3, 5, 3), batch(2, 5, 3)
    jm, tm = joptim.MeanAveragePrecision(), optim.MeanAveragePrecision()
    want = jm.apply(d1, g1) + jm.apply(d2, g2, valid=1)
    got = tm.apply(torch.from_numpy(d1), torch.from_numpy(g1)) \
        + tm.apply(d2, g2, valid=1)
    assert got.result()[1] == want.result()[1] == 4
    assert got.result()[0] == pytest.approx(want.result()[0], rel=1e-12)
    assert 0 < got.result()[0] <= 1
    assert not tm.has_device_fold()


def _ncf_pair(sharded=True):
    JaxRNG.set_seed(8)
    jm = JNeuralCF(30, 25, sharded=sharded)
    tm = NeuralCF(30, 25, sharded=sharded, device="cpu")
    load_jax_params(tm, jax.device_get(jm.get_params()))
    jm.evaluate()
    return jm, tm


def test_run_device_eval_of_ncf_matches_the_host_loop():
    _, tm = _ncf_pair()
    rng = np.random.default_rng(4)
    group, batches = 11, []
    for b in range(3):
        x = np.stack([np.repeat(rng.integers(1, 31, 4), group),
                      rng.integers(1, 26, 4 * group)], 1).astype(np.int32)
        y = np.zeros(4 * group, np.int32)
        y[np.arange(4) * group + rng.integers(0, group, 4)] = 1
        batches.append(MiniBatch(x, y))
    hr, ndcg = optim.HitRatio(5, 10), optim.NDCG(5, 10)
    (hr_res, ndcg_res), _ = run_device_eval(tm, DataSet.array(batches),
                                            [hr, ndcg], device="cpu")
    host_hr = host_ndcg = None
    tm.eval()
    with torch.no_grad():
        for b in batches:
            s = tm(torch.from_numpy(b.input))[:, -1].numpy()
            r1, r2 = hr.apply(s, b.target), ndcg.apply(s, b.target)
            host_hr = r1 if host_hr is None else host_hr + r1
            host_ndcg = r2 if host_ndcg is None else host_ndcg + r2
    assert hr_res.result()[1] == host_hr.result()[1] == 12
    assert hr_res.result()[0] == pytest.approx(host_hr.result()[0])
    assert ndcg_res.result()[0] == pytest.approx(host_ndcg.result()[0])


def _requests(n, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cands = rng.integers(1, 26, rng.integers(1, 13))
        if i % 4 == 0 and len(cands) > 1:
            cands[-1] = cands[0]         # an exact tie: submission order
        out.append((int(rng.integers(1, 31)), cands.astype(np.int32)))
    return out


def test_ranking_engine_orders_as_jax():
    jm, tm = _ncf_pair()
    reqs = _requests(24)
    with JRankingEngine(jm, max_candidates=12, max_batch=4) as jeng:
        jres = [jeng.submit(u, c) for u, c in reqs]
        jres = [h.result(60) for h in jres]
        jstats = jeng.stats()
    jsnap = jregistry.snapshot()
    with RankingEngine(tm, max_candidates=12, max_batch=4) as eng:
        handles = []
        # several clients at once: the worker coalesces them
        lock = threading.Lock()

        def client(part):
            for u, c in part:
                h = eng.submit(u, c)
                with lock:
                    handles.append(((u, tuple(c)), h))

        threads = [threading.Thread(target=client, args=(reqs[i::3],))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        got = {key: h.result(60) for key, h in handles}
        stats = eng.stats()
        assert eng._program.key == ("ranking", 4, 12)
    assert sorted(stats) == sorted(jstats)
    assert stats["compiled_programs"] == jstats["compiled_programs"] == 1
    assert stats["requests"] == jstats["requests"] == 24
    for (u, c), jr in zip(reqs, jres):
        r = got[(u, tuple(c))]
        with torch.no_grad():
            pairs = torch.from_numpy(np.stack([np.full(len(c), u), c], 1))
            eager = tm(pairs)[:, -1].numpy()
        order = np.argsort(-eager, kind="stable")
        np.testing.assert_array_equal(r.item_ids, c[order])
        np.testing.assert_allclose(r.scores, eager[order], rtol=1e-6,
                                   atol=1e-6)
        assert np.all(np.diff(r.scores) <= 0)
        np.testing.assert_allclose(r.scores, jr.scores, rtol=1e-5, atol=1e-5)
        # JAX's order where its neighbours are apart by more than 1e-4
        gaps = np.abs(np.diff(jr.scores)) > 1e-4
        split = np.concatenate([[True], gaps])
        assert [set(g) for g in np.split(r.item_ids, np.flatnonzero(split)[1:])] \
            == [set(g) for g in np.split(jr.item_ids,
                                         np.flatnonzero(split)[1:])]
        assert r.topk(3).tolist() == r.item_ids[:3].tolist()
    snap = registry.snapshot()
    assert snap["counters"]["ranking/requests"] \
        == jsnap["counters"]["ranking/requests"] == 24
    assert snap["histograms"]["ranking/latency_ms"]["count"] == 24
    assert snap["histograms"]["ranking/batch_fill"]["count"] == stats["ticks"]
    assert 0 < snap["histograms"]["ranking/batch_fill"]["max"] <= 1
    with pytest.raises(EngineShutdown):
        eng.submit(1, [1, 2])
    with pytest.raises(ValueError, match="candidate ids"):
        RankingEngine(tm, max_candidates=2).submit(1, [1, 2, 3])
