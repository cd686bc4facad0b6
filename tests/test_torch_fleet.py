"""The port's fleet router, on the CPU, against ``bigdl_tpu/``.

Replicas built by ``FleetRouter.replicate`` over one module each serve a
private copy of its weights. The tests hold the router to JAX's contract:
routing changes where a request decodes, never what; a disaggregated
``phases="prefill,decode"`` fleet serves one colocated engine's tokens
through prefix-pool handoffs, and falls back to plain dispatch when a
handoff fails; a replica killed mid-traffic (by hand or by the
``replica_down`` site) loses no request, and the trace id survives the
hop; ``/healthz`` reports a fleet with a dead replica and a healthy peer
as ``degraded``, not 503, as JAX's exporter does.
"""

import time

import numpy as np
import pytest

from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.obs import exporter as jexporter
from bigdl_tpu.serving import FleetRouter as JaxFleetRouter
from bigdl_tpu.utils.random_generator import RandomGenerator
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.transformerlm import TransformerLM
from bigdl_tpu_torch.obs import exporter
from bigdl_tpu_torch.obs.registry import registry
from bigdl_tpu_torch.serving import (
    FleetExhausted, FleetRouter, ServingEngine,
)
from bigdl_tpu_torch.utils import faults

VOCAB, E, HEADS, MAX_LEN = 64, 32, 4, 64
BUCKETS = (16, 32, 64)


@pytest.fixture(scope="module")
def pair():
    RandomGenerator.set_seed(19)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS, num_layers=2,
                           max_len=MAX_LEN).evaluate()
    tlm = TransformerLM(VOCAB, E, HEADS, 2, MAX_LEN, device="cpu")
    convert.load_jax_params(tlm, jlm.get_params())
    return jlm, tlm


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _solo(tlm, p, m):
    return tnn.greedy_generate(tlm, np.asarray(p)[None], m,
                               device="cpu")[0].numpy()


def _fleet(tlm, **kw):
    return FleetRouter.replicate(tlm, MAX_LEN, **dict(dict(
        replicas=2, buckets=BUCKETS, device="cpu"), **kw))


def _wait(cond, what, bound=60.0):
    end = time.perf_counter() + bound
    while not cond():
        if time.perf_counter() > end:
            raise AssertionError(f"never reached: {what}")
        time.sleep(0.002)


def test_fleet_tokens_equal_solo_and_dispatch_spreads(pair):
    _, tlm = pair
    prompts = [_prompt(300 + i, 3 + 5 * i) for i in range(6)]
    with _fleet(tlm, replicas=3) as fleet:
        hs = [fleet.submit(p, 10) for p in prompts]
        got = [h.result(120).tokens for h in hs]
        st = fleet.stats()
    assert st["dispatched"] == 6 and st["healthy_replicas"] == 3
    assert sorted(st["replicas"]) == ["fleet-r0", "fleet-r1", "fleet-r2"]
    assert len({h.replica for h in hs}) > 1
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _solo(tlm, p, 10))


def test_disaggregated_tokens_equal_one_colocated_engine(pair):
    """``phases="prefill,decode"``: every prompt is prefilled on r0 and
    admitted on r1 as an exact pool hit (r1 runs no prefill program), and
    the tokens are those of one colocated engine (prompts of at least one
    prefix chunk, 16 tokens: a shorter one is not pooled, in JAX as
    here)."""
    _, tlm = pair
    prompts = [_prompt(310 + i, 17 + 7 * i) for i in range(4)]
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS,
                       device="cpu") as solo:
        want = [solo.submit(p, 9).result(120).tokens for p in prompts]
    with _fleet(tlm, phases="prefill,decode", prefix_pool=8) as fleet:
        got = [fleet.submit(p, 9).result(120).tokens for p in prompts]
        st = fleet.stats()
    dec = st["replicas"]["fleet-r1"]
    assert st["phases"] == {"fleet-r0": "prefill", "fleet-r1": "decode"}
    assert st["handoffs"] == 4 and st["handoff_failures"] == 0
    assert dec["prefix_hits"] == 4 and dec["prefills"] == 0
    assert st["replicas"]["fleet-r0"]["prefills"] == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_each_handoff_is_timed(pair):
    """A handoff's export and seed go to ``serving/handoff_ms``, one
    observation each."""
    _, tlm = pair

    def count():
        h = registry.snapshot()["histograms"].get("serving/handoff_ms")
        return h["count"] if h else 0

    before = count()
    with _fleet(tlm, phases="prefill,decode", prefix_pool=8) as fleet:
        for i in range(2):
            fleet.submit(_prompt(330 + i, 20), 4).result(120)
        st = fleet.stats()
    assert st["handoffs"] == 2 and count() - before == 2


def test_handoff_failure_falls_back_to_plain_dispatch(pair, monkeypatch):
    _, tlm = pair
    p = _prompt(320, 9)
    with _fleet(tlm, phases="prefill,decode", prefix_pool=8) as fleet:
        def broken(prompt):
            raise RuntimeError("export failed")

        monkeypatch.setattr(fleet.engine("fleet-r0"), "prefill_export",
                            broken)
        got = fleet.submit(p, 8).result(120).tokens
        st = fleet.stats()
    assert st["handoffs"] == 0 and st["handoff_failures"] == 1
    np.testing.assert_array_equal(got, _solo(tlm, p, 8))


def test_replica_killed_mid_flight_loses_no_request(pair):
    """Both replicas' single rows held, a third request queued behind one:
    that replica is killed; its held and queued requests re-route to the
    survivor with their trace ids and solo greedy's tokens."""
    _, tlm = pair
    prompts = [_prompt(330 + i, 4) for i in range(3)]
    with _fleet(tlm, slots=1) as fleet:
        heads = [fleet.submit(p, 12) for p in prompts[:2]]
        assert heads[0].replica != heads[1].replica
        for h in heads:
            _wait(lambda h=h: fleet.engine(h.replica).stats()[
                "active_slots"] == 1, "a held row")
        victim = fleet.submit(prompts[2], 12)
        doomed = victim.replica
        traces = [h.trace_id for h in heads] + [victim.trace_id]
        fleet.engine(doomed).shutdown(wait=False)
        results = [h.result(120) for h in heads + [victim]]
        st = fleet.stats()
    assert st["retries"] >= 1
    for r, p, t in zip(results, prompts, traces):
        np.testing.assert_array_equal(r.tokens, _solo(tlm, p, 12))
        assert r.trace_id == t
    retried = [h for h in heads + [victim] if h.attempts > 1]
    assert retried and all(h.replica != doomed for h in retried)


def test_scripted_replica_down_and_dispatch_faults(pair):
    """``router_dispatch@1`` fails the first attempt (the request goes to
    the next replica) and ``replica_down@3`` kills the replica the second
    request was about to take: every request completes with solo greedy's
    tokens."""
    _, tlm = pair
    prompts = [_prompt(340 + i, 4 + i) for i in range(6)]
    with faults.inject_faults("router_dispatch@1;replica_down@3") as plan:
        with _fleet(tlm) as fleet:
            got = [fleet.submit(p, 8).result(120).tokens for p in prompts]
            assert plan.unfired() == []
            _wait(lambda: fleet.stats()["healthy_replicas"] == 1,
                  "one healthy replica")
            st = fleet.stats()
    assert st["replica_downs"] == 1 and st["dispatched"] == 6
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _solo(tlm, p, 8))


def test_add_remove_replica_and_exhaustion(pair):
    _, tlm = pair
    p = _prompt(350, 5)
    fleet = _fleet(tlm, replicas=1)
    extra = ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS,
                          device="cpu", name="extra")
    fleet.add_replica("extra", extra)
    with pytest.raises(ValueError):
        fleet.add_replica("extra", extra)
    fleet.remove_replica("fleet-r0", drain=True)
    assert list(fleet.replicas) == ["extra"]
    h = fleet.submit(p, 6)
    np.testing.assert_array_equal(h.result(120).tokens, _solo(tlm, p, 6))
    assert h.replica == "extra"
    with pytest.raises(ValueError):
        fleet.submit(_prompt(351, 8), 400)   # never servable: not retried
    fleet.shutdown()
    _wait(lambda: fleet.stats()["healthy_replicas"] == 0, "all dead")
    with pytest.raises(FleetExhausted):
        fleet.submit(p, 4)
    assert fleet.stats()["rejected"] == 1 and fleet.stats()["retries"] == 0


def test_swap_on_one_replica_leaves_the_other(pair):
    jlm, tlm = pair
    r = np.random.default_rng(5)
    tree = convert.map_tree(lambda a: (np.asarray(a) + r.normal(
        0, 0.5, np.shape(a))).astype(np.float32), jlm.get_params())
    p = _prompt(360, 7)
    with _fleet(tlm) as fleet:
        fleet.engine("fleet-r0").swap_weights(tree, version=2)
        a = fleet.engine("fleet-r0").submit(p, 8).result(120).tokens
        b = fleet.engine("fleet-r1").submit(p, 8).result(120).tokens
    np.testing.assert_array_equal(b, _solo(tlm, p, 8))
    v2 = convert.load_jax_params(
        TransformerLM(VOCAB, E, HEADS, 2, MAX_LEN, device="cpu"), tree)
    np.testing.assert_array_equal(a, _solo(v2, p, 8))


def _dead_replica_healthz(xp, make_fleet):
    """A fleet of two never-started replicas, one shut down, and a dead
    lone engine registered beside it: the codes and states /healthz gives,
    with and without the lone one."""
    xp.reset()
    fleet = make_fleet()
    fleet.engine("fleet-r0").shutdown()
    first = xp.render_healthz()
    xp.register_engine(fleet.engine("fleet-r0"))
    covered = xp.render_healthz()
    fleet.engine("fleet-r1").shutdown()
    dead = xp.render_healthz()
    text = xp.render_metrics()
    xp.reset()
    out = []
    for code, payload in (first, covered, dead):
        fb = payload["fleets"]["fleet"]
        out.append((code, payload["status"], fb["healthy_replicas"],
                    sorted(fb["replicas"].items())))
    return out, xp.parse_metrics(text)


def test_healthz_of_a_fleet_with_a_dead_replica_matches_jax(pair):
    """/healthz and the fleet rows of /metrics, port against JAX: a dead
    replica with a healthy peer is ``degraded`` (200), registered or not;
    with both dead the process answers 503."""
    jlm, tlm = pair
    ours, ometrics = _dead_replica_healthz(
        exporter, lambda: _fleet(tlm))
    theirs, jmetrics = _dead_replica_healthz(
        jexporter, lambda: JaxFleetRouter.replicate(
            jlm, MAX_LEN, replicas=2, buckets=BUCKETS))
    assert ours == theirs
    assert [o[:2] for o in ours] == [(200, "degraded"), (200, "degraded"),
                                     (503, "dead")]
    fleet_keys = {k for k in jmetrics if k.startswith("bigdl_fleet")
                  and "{" in k}
    assert fleet_keys and fleet_keys == {
        k for k in ometrics if k.startswith("bigdl_fleet") and "{" in k}
    for k in fleet_keys:
        if "health" in k or "healthy" in k or "dispatched" in k:
            assert ometrics[k] == jmetrics[k], k
