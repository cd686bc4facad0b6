"""Crash recovery, drain, health, the hang watchdog and hot weight swaps of
the port's ``ServingEngine``, on the CPU, against the JAX engine.

Where the outcome does not hang on timing the two engines run the same
fault plan on the same weights (``convert.load_jax_params``) and are
compared directly: tokens and ``stats()``. Where timing decides when a
crash or a swap lands, both are held to the same invariant: the tokens
before it verbatim, the tokens after equal to solo greedy decoding on the
weights then served. Deadlines, drain timeouts and watchdog limits run on
injected clocks and the stall on an event (``faults.stall_sleep``), never
on wall-clock margins; threads are joined with a bound.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest

from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.utils import faults as jfaults
from bigdl_tpu.utils.random_generator import RandomGenerator
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models.transformerlm import TransformerLM
from bigdl_tpu_torch.obs.registry import registry
from bigdl_tpu_torch.obs.watchdog import HangWatchdog
from bigdl_tpu_torch.serving import (
    EngineShutdown, EngineShutdownTimeout, NonFiniteLogitsError,
    ServingEngine,
)
from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils.faults import FaultError, inject_faults
from bigdl_tpu_torch.utils.programs import capture_guard
from bigdl_tpu_torch.utils.robustness import events

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


@pytest.fixture(scope="module")
def v2(pair):
    """A second tree of the same shapes: v1 plus gaussian noise (a uniform
    scale would leave LayerNorm's outputs, and so the tokens, as they
    were)."""
    r = np.random.default_rng(7)
    tree = convert.map_tree(
        lambda a: (np.asarray(a) + r.normal(0, 0.5, np.shape(a))
                   ).astype(np.float32), pair[0].get_params())
    tlm = TransformerLM(VOCAB, E, HEADS, 2, MAX_LEN, device="cpu")
    convert.load_jax_params(tlm, tree)
    return tree, tlm


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _solo(tlm, p, m):
    return tnn.greedy_generate(tlm, np.asarray(p)[None], m,
                               device="cpu")[0].numpy()


def _engine(tlm, **kw):
    return ServingEngine(tlm, MAX_LEN, **dict(dict(
        slots=2, buckets=BUCKETS, device="cpu"), **kw))


def _wait(cond, what, bound=60.0):
    end = time.perf_counter() + bound
    while not cond():
        if time.perf_counter() > end:
            raise AssertionError(f"never reached: {what}")
        time.sleep(0.002)


def _no_serving_threads():
    return not any(t.name.startswith("bigdl-serve") and t.is_alive()
                   for t in threading.enumerate())


# ----------------------------------------------------------- crash recovery
def test_crash_under_one_request_plan_matches_jax(pair):
    """``serve_thread@2`` kills the loop after its first tick, with the
    request mid-decode: in both packages the supervisor respawns it once,
    the request re-prefills from its prompt and emitted tokens and ends
    with solo greedy's tokens, and the ledgers agree."""
    jlm, tlm = pair
    p = _prompt(3, 9)
    out = []
    for make, fl in ((lambda: _engine(tlm), faults),
                     (lambda: JaxServingEngine(jlm, MAX_LEN, slots=2,
                                               buckets=BUCKETS), jfaults)):
        with fl.inject_faults("serve_thread@2") as plan:
            eng = make()
            tokens = eng.submit(p, 8).result(120).tokens
            st = eng.stats()
            eng.shutdown()
            assert plan.unfired() == []
        out.append((np.asarray(tokens), st))
    (got, st), (want, jst) = out
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _solo(tlm, p, 8))
    for key in ("respawns", "health", "completed", "submitted",
                "compiled_programs", "model_version", "slot_recycles"):
        assert st[key] == jst[key], key
    assert st["respawns"] == 1 and st["health"] == "degraded"


def test_crash_budget_spent_leaves_engine_dead_like_jax(pair, monkeypatch):
    """Three deaths against a budget of two: both engines give up, the
    handle raises the real ``WorkerDeathError``, health is ``dead`` and a
    later submit raises ``EngineShutdown``.

    The loop dies at the top of its first iteration, request or not, and
    ``submit`` starts the thread before it queues the request: a submitter
    descheduled in between (a loaded host) would find all three deaths
    done and the engine shut, and ``submit`` itself would raise
    ``EngineShutdown``. Both engines have that window, so on both legs the
    loop's ``serve_thread`` fault point waits until the request is queued
    (the engine modules' ``fault_point`` is wrapped; no engine changes)."""
    jlm, tlm = pair
    from bigdl_tpu.serving import engine as jengine
    from bigdl_tpu.serving.engine import EngineShutdown as JaxShutdown
    from bigdl_tpu_torch.serving import engine as tengine
    spec = "serve_thread@1;serve_thread@2;serve_thread@3"
    seen = []
    for make, fl, shut, mod in (
            (lambda: _engine(tlm, crash_budget=2), faults, EngineShutdown,
             tengine),
            (lambda: JaxServingEngine(jlm, MAX_LEN, slots=2, buckets=BUCKETS,
                                      crash_budget=2), jfaults,
             JaxShutdown, jengine)):
        queued = threading.Event()

        def gated(site, index=None, _real=mod.fault_point, _fl=fl,
                  _queued=queued):
            if site == _fl.SITE_SERVE_THREAD:
                assert _queued.wait(60), "the request was never queued"
            return _real(site, index)

        monkeypatch.setattr(mod, "fault_point", gated)
        with fl.inject_faults(spec) as plan:
            eng = make()
            h = eng.submit(_prompt(4, 5), 6)
            queued.set()
            with pytest.raises(fl.WorkerDeathError):
                h.result(120)
            assert plan.unfired() == []
        eng.shutdown()
        with pytest.raises(shut):
            eng.submit(_prompt(5, 4), 2)
        st = eng.stats()
        seen.append((st["respawns"], st["health"], st["completed"]))
    assert seen[0] == seen[1] == (2, "dead", 0)


def test_crash_keeps_programs_and_releases_locks(pair):
    """A warm engine crashes mid-traffic (``serve_decode@2=error``): the
    ledger and the very program objects survive (the respawned loop
    replays, it captures nothing), every request ends with solo greedy's
    tokens, and nothing the dead thread held stays held."""
    _, tlm = pair
    prompts = [_prompt(10 + i, n) for i, n in enumerate((5, 20, 40))]
    c0 = events.counts()
    with _engine(tlm, slots=3) as eng:
        for p in prompts:   # warm every bucket the traffic uses
            eng.submit(p, 2).result(120)
        keys = eng.stats()["compiled_programs"]
        progs = dict(eng._programs._programs)
        with inject_faults("serve_decode@2=error") as plan:
            hs = [eng.submit(p, 10) for p in prompts]
            got = [h.result(120).tokens for h in hs]
            assert plan.unfired() == []
        st = eng.stats()
        assert st["respawns"] == 1 and st["compiled_programs"] == keys
        assert eng._programs._programs == progs
        assert all(eng._programs._programs[k] is progs[k] for k in progs)
        for lock in (eng._device_lock, eng._swap_lock, capture_guard()):
            # the respawned loop may still be in its last iteration, under
            # the device lock, as the last token arrives: wait for it to
            # let go (a lock the dead thread kept is never released)
            _wait(lambda: lock.acquire(blocking=False), f"{lock} released")
            lock.release()
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _solo(tlm, p, 10))
    d = events.deltas(c0)
    assert d.get("serving_thread_respawn") == 1
    assert d.get("serving_recovered") == 1


def _observations(name):
    h = registry.snapshot()["histograms"].get(name)
    return (h["count"], h["min"]) if h else (0, None)


def test_crash_times_the_first_token_and_the_reprefills(pair, v2):
    """A crash with requests in flight (``serve_decode@2=error``) records
    one ``serving/resume_first_token_ms`` (from the loop's death to the
    first token after it) and one ``serving/reprefill_ms`` (the requeued
    requests' admissions); a swap with nothing in flight or queued records
    neither."""
    _, tlm = pair
    names = ("serving/resume_first_token_ms", "serving/reprefill_ms")
    prompts = [_prompt(15 + i, n) for i, n in enumerate((6, 19))]
    with _engine(tlm) as eng:
        before = [_observations(n)[0] for n in names]
        with inject_faults("serve_decode@2=error") as plan:
            got = [h.result(120).tokens
                   for h in [eng.submit(p, 8) for p in prompts]]
            assert plan.unfired() == []
        after = [_observations(n) for n in names]
        assert eng.stats()["respawns"] == 1
        assert [n - b for (n, _), b in zip(after, before)] == [1, 1]
        assert all(lo >= 0 for _, lo in after)
        res = eng.swap_weights(v2[0], version=2)
        assert res.requeued == 0
        assert [_observations(n)[0] for n in names] == [n for n, _ in after]
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _solo(tlm, p, 8))


def test_crash_on_paged_engine_zeroes_pool_in_place(pair):
    """A crash on a paged engine resets the allocator and zeroes the pool
    and the shared table in place (the same tensor objects), and the
    re-prefilled requests end with solo greedy's tokens."""
    _, tlm = pair
    prompts = [_prompt(20 + i, n) for i, n in enumerate((9, 17))]
    with _engine(tlm, pages=12, page_tokens=8) as eng:
        leaves = []
        convert.map_tree(leaves.append, eng._dec_state)
        with inject_faults("serve_thread@3") as plan:
            hs = [eng.submit(p, 12) for p in prompts]
            got = [h.result(120).tokens for h in hs]
            assert plan.unfired() == []
        after = []
        convert.map_tree(after.append, eng._dec_state)
        st = eng.stats()
    assert all(a is b for a, b in zip(leaves, after))
    assert st["respawns"] == 1 and st["pages_used"] == 0
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _solo(tlm, p, 12))


def test_nonfinite_fails_one_request_the_others_unchanged(pair):
    """``serve_decode@2=nonfinite`` fails exactly the lowest active row's
    request; its neighbours and the next request in the wiped row are solo
    greedy's."""
    _, tlm = pair
    prompts = [_prompt(30 + i, 4) for i in range(3)]
    extra = _prompt(39, 5)
    with inject_faults("serve_decode@2=nonfinite") as plan:
        with _engine(tlm, slots=3) as eng:
            hs = [eng.submit(p, 8) for p in prompts]
            with pytest.raises(NonFiniteLogitsError):
                hs[0].result(120)
            for h, p in zip(hs[1:], prompts[1:]):
                np.testing.assert_array_equal(h.result(120).tokens,
                                              _solo(tlm, p, 8))
            np.testing.assert_array_equal(
                eng.submit(extra, 6).result(120).tokens, _solo(tlm, extra, 6))
            assert eng.stats()["poisoned_slots"] == 1
        assert plan.unfired() == []


def test_prefill_fault_fails_only_that_request(pair):
    _, tlm = pair
    good = _prompt(41, 4)
    with inject_faults("serve_prefill@1") as plan:
        with _engine(tlm) as eng:
            with pytest.raises(FaultError):
                eng.submit(_prompt(40, 4), 6).result(120)
            np.testing.assert_array_equal(
                eng.submit(good, 6).result(120).tokens, _solo(tlm, good, 6))
            assert eng.stats()["respawns"] == 0
        assert plan.unfired() == []


@pytest.mark.parametrize("at", [1, 3], ids=["admission", "mid_decode"])
def test_page_alloc_fault_is_backpressure_not_a_crash(pair, at):
    """``serve_page_alloc@N`` reports exhaustion: at admission the request
    waits and is admitted on the next pass, mid-decode the youngest is
    preempted and re-prefilled; both end with solo greedy's tokens."""
    _, tlm = pair
    prompts = [_prompt(50, 17), _prompt(51, 17)]
    with inject_faults(f"serve_page_alloc@{at}") as plan:
        with _engine(tlm, buckets=(8, 32), pages=8, page_tokens=16) as eng:
            hs = [eng.submit(p, 17) for p in prompts]
            got = [h.result(120).tokens for h in hs]
            st = eng.stats()
        assert plan.unfired() == []
    assert st["respawns"] == 0 and st["pages_used"] == 0
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _solo(tlm, p, 17))


# ------------------------------------------------------ drain and shutdown
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_drain_finishes_in_flight_and_fails_queued(pair, monkeypatch):
    """``shutdown(drain=True)`` with two rows in flight and one request
    queued (a backlog under the slot count, so health is not degraded by
    pressure): the rows finish with solo greedy's tokens, the queued one
    fails with ``EngineShutdown``, and health goes ready -> draining ->
    dead. The loop waits for both rows before its first prefill
    (``admit_wait_ms``) and is held in its first tick (``serve_stall`` on
    an event) while the drain starts."""
    _, tlm = pair
    prompts = [_prompt(60 + i, 6) for i in range(3)]
    release = threading.Event()
    monkeypatch.setattr(faults, "stall_sleep", lambda s: release.wait(60))
    seen = []
    with inject_faults("serve_stall@1") as plan:
        eng = _engine(tlm, admit_wait_ms=60_000)
        hs = [eng.submit(p, 12) for p in prompts]
        _wait(lambda: plan.unfired() == [], "the first tick")
        assert eng.stats()["active_slots"] == 2
        seen.append(eng.stats()["health"])
        eng.shutdown(drain=True, wait=False)
        seen.append(eng.stats()["health"])
        release.set()
        eng._thread.join(60)     # a second shutdown() would end the drain
    seen.append(eng.stats()["health"])
    assert seen == ["ready", "draining", "dead"]
    for h, p in zip(hs[:2], prompts[:2]):
        np.testing.assert_array_equal(h.result(5).tokens, _solo(tlm, p, 12))
    for h in hs[2:]:
        with pytest.raises(EngineShutdown, match="draining"):
            h.result(5)
    with pytest.raises(EngineShutdown):
        eng.submit(prompts[0], 2)
    assert _no_serving_threads()


def test_drain_deadline_on_the_engine_clock_aborts_in_flight(pair,
                                                            monkeypatch):
    """The drain deadline reads the engine's clock: once it has passed,
    the rows still in flight fail with ``EngineShutdown``. The loop is
    held in its second tick (``serve_stall`` on an event) while the drain
    starts and the clock moves."""
    _, tlm = pair
    release = threading.Event()
    monkeypatch.setattr(faults, "stall_sleep", lambda s: release.wait(60))
    with inject_faults("serve_stall@2") as plan:
        eng = _engine(tlm)
        clock = eng.clock = _Clock()
        h = eng.submit(_prompt(70, 6), 40)
        _wait(lambda: plan.unfired() == [], "the second tick")
        eng.shutdown(drain=True, wait=False, drain_timeout=5.0)
        clock.t = 10.0
        release.set()
        eng.shutdown(wait=True, timeout=60)
    with pytest.raises(EngineShutdown):
        h.result(5)
    assert eng.stats()["health"] == "dead"


def test_sigterm_drains_and_chains_the_previous_handler(pair):
    """``install_signal_drain`` turns SIGTERM into a drain and then calls
    the handler installed before it (the trainer's, for one)."""
    _, tlm = pair
    original = signal.getsignal(signal.SIGTERM)
    calls = []
    signal.signal(signal.SIGTERM, lambda s, f: calls.append(s))
    eng = _engine(tlm)
    try:
        eng.submit(_prompt(71, 5), 4).result(120)
        eng.install_signal_drain()
        os.kill(os.getpid(), signal.SIGTERM)
        _wait(lambda: calls, "the chained handler")
        eng.shutdown(wait=True, timeout=60)
    finally:
        signal.signal(signal.SIGTERM, original)
    assert calls == [signal.SIGTERM]
    assert eng.stats()["health"] == "dead"


def test_wedged_shutdown_raises_timeout_then_joins(pair, monkeypatch):
    """A loop stuck in ``serve_stall`` (on an event here) outlives
    ``shutdown(timeout=0.2)``: ``EngineShutdownTimeout`` names the thread;
    once the stall ends the next shutdown joins and the handle fails."""
    _, tlm = pair
    release = threading.Event()
    monkeypatch.setattr(faults, "stall_sleep", lambda s: release.wait(60))
    with inject_faults("serve_stall@1") as plan:
        eng = _engine(tlm)
        h = eng.submit(_prompt(72, 4), 8)
        _wait(lambda: plan.unfired() == [], "the stall")
        with pytest.raises(EngineShutdownTimeout, match="alive"):
            eng.shutdown(wait=True, timeout=0.2)
        release.set()
        eng.shutdown(wait=True, timeout=60)
    with pytest.raises(EngineShutdown):
        h.result(5)
    assert _no_serving_threads()


# ---------------------------------------------------------------- watchdog
def test_stall_trips_exactly_one_watchdog_dump_naming_the_loop(pair,
                                                               monkeypatch):
    """The watchdog's clock is injected and the stall advances it by
    ``BIGDL_FAULT_STALL_S`` and checks: one dump, holding the engine
    loop's stack; later heartbeats re-arm it and nothing else fires."""
    _, tlm = pair
    clock = _Clock()
    dumps = []
    wd = HangWatchdog(hard_s=0.2, poll_s=0.01, sink=dumps.append,
                      clock=clock)
    monkeypatch.setenv("BIGDL_FAULT_STALL_S", "2")

    def stall(s):
        clock.t += s
        wd.check()

    monkeypatch.setattr(faults, "stall_sleep", stall)
    with inject_faults("serve_stall@3") as plan:
        with _engine(tlm, watchdog=wd) as eng:
            r = eng.submit(_prompt(73, 4), 8).result(120)
            assert plan.unfired() == []
        assert not wd.armed   # disarmed while idle
    assert r.n_generated == 8
    assert wd.dumps == 1 and len(dumps) == 1
    assert "bigdl-serve-serve-loop" in dumps[0]
    assert "in-flight [serve]" in dumps[0]


def test_watchdog_limit_is_factor_times_median_floored():
    clock = _Clock()
    wd = HangWatchdog(hard_s=None, factor=10.0, clock=clock)
    assert wd.limit() is None
    for _ in range(5):
        wd.heartbeat(0.001)
    assert wd.limit() == 0.25          # 10 x 1 ms, floored at 0.25 s
    for _ in range(10):
        wd.heartbeat(0.1)
    assert wd.limit() == pytest.approx(1.0)
    clock.t += 0.9
    assert not wd.check()
    clock.t += 0.2
    assert wd.check() and not wd.check()   # once a stall
    wd.heartbeat()
    wd.disarm()
    clock.t += 100
    assert not wd.check() and wd.dumps == 1


# ------------------------------------------------------------- health/SLO
def test_health_follows_respawn_and_slo_flag(pair):
    _, tlm = pair
    eng = _engine(tlm)
    assert eng.stats()["health"] == "starting"
    eng.submit(_prompt(74, 4), 3).result(120)
    assert eng.stats()["health"] == "ready"
    eng.set_slo_degraded(True)
    assert eng.stats()["health"] == "degraded"
    assert eng.stats()["slo_degraded"] is True
    eng.set_slo_degraded(False)
    assert eng.stats()["health"] == "ready"
    eng.shutdown()
    assert eng.stats()["health"] == "dead"
    never = _engine(tlm)
    never.shutdown()
    assert never.stats()["health"] == "dead"


# ------------------------------------------------------------- weight swap
def test_swap_on_a_never_started_engine_matches_jax(pair, v2):
    """The caller's thread swaps a never-started engine: version 2, nothing
    re-prefilled, and the next request serves v2's tokens in both
    packages."""
    jlm, tlm = pair
    tree, tlm2 = v2
    p = _prompt(80, 7)
    eng = _engine(tlm)
    jeng = JaxServingEngine(jlm, MAX_LEN, slots=2, buckets=BUCKETS)
    try:
        res, jres = eng.swap_weights(tree, version=2), \
            jeng.swap_weights(tree, version=2)
        assert (res.version, res.in_flight, res.requeued) == \
            (jres.version, jres.in_flight, jres.requeued) == (2, {}, 0)
        got = eng.submit(p, 8).result(120).tokens
        want = jeng.submit(p, 8).result(120).tokens
        st, jst = eng.stats(), jeng.stats()
    finally:
        eng.shutdown()
        jeng.shutdown()
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, _solo(tlm2, p, 8))
    assert not np.array_equal(got, _solo(tlm, p, 8))
    assert st["model_version"] == jst["model_version"] == 2
    assert st["compiled_programs"] == jst["compiled_programs"]


def test_failed_swaps_leave_the_old_weights_like_jax(pair, v2):
    """``promote_swap@1`` and a tree with a wrong path or shape each fail
    the swap in both packages; v1 keeps serving at version 0."""
    jlm, tlm = pair
    tree, _ = v2
    p = _prompt(81, 6)
    bad_path = dict(tree, extra={"weight": np.zeros(3, np.float32)})
    bad_shape = convert.map_tree(lambda a: a, tree)
    first = next(iter(convert.flatten_tree(bad_shape)))
    node = bad_shape
    for part in first.split(".")[:-1]:
        node = node[part]
    node[first.split(".")[-1]] = np.zeros((1, 1), np.float32)
    outcomes = []
    for eng, fl in ((_engine(tlm), faults),
                    (JaxServingEngine(jlm, MAX_LEN, slots=2,
                                      buckets=BUCKETS), jfaults)):
        eng.submit(p, 2).result(120)     # started: the loop services it
        with fl.inject_faults("promote_swap@1") as plan:
            with pytest.raises(fl.FaultError):
                eng.swap_weights(tree, version=2)
            assert plan.unfired() == []
        for bad in (bad_path, bad_shape):
            with pytest.raises(ValueError):
                eng.swap_weights(bad, version=3)
        outcomes.append((np.asarray(eng.submit(p, 8).result(120).tokens),
                         eng.stats()["model_version"]))
        eng.shutdown()
    np.testing.assert_array_equal(outcomes[0][0], outcomes[1][0])
    np.testing.assert_array_equal(outcomes[0][0], _solo(tlm, p, 8))
    assert outcomes[0][1] == outcomes[1][1] == 0


def _swap_under_traffic(eng, tree, prompts, n_new):
    """Submit every prompt, wait until all hold a row and two ticks ran,
    swap, and return the results and the swap's split points."""
    hs = [eng.submit(p, n_new) for p in prompts]
    _wait(lambda: eng.stats()["active_slots"] == len(prompts)
          and eng.stats()["decode_ticks"] >= 2
          if "decode_ticks" in eng.stats() else
          eng.stats()["active_slots"] == len(prompts), "rows in flight")
    res = eng.swap_weights(tree, version=2)
    return [h.result(120) for h in hs], res


def _hold_split_invariant(results, res, prompts, old, new, n_new):
    for r, p in zip(results, prompts):
        k = res.in_flight[r.request_id]
        toks = np.asarray(r.tokens)
        np.testing.assert_array_equal(toks[:len(p) + k], _solo(old, p, k))
        np.testing.assert_array_equal(
            toks, _solo(new, toks[:len(p) + k], n_new - k))


def test_swap_under_traffic_keeps_prefix_and_serves_new_weights(pair, v2):
    """Swapped mid-decode, in both packages: each request's tokens before
    the swap are v1's verbatim and the rest are greedy on v2 from that
    prefix; the port's ledger does not grow, the prefix pool is cleared,
    and another engine over the same module still serves v1."""
    jlm, tlm = pair
    tree, tlm2 = v2
    prompts = [_prompt(90 + i, 17 + 3 * i) for i in range(3)]
    n_new = 24
    with _engine(tlm, slots=3, prefix_pool=4) as eng, \
            _engine(tlm, slots=3) as other:
        eng.submit(prompts[0], 2).result(120)
        keys = eng.stats()["compiled_programs"]
        assert eng.stats()["prefix_entries"] >= 1
        results, res = _swap_under_traffic(eng, tree, prompts, n_new)
        st = eng.stats()
        kept = [other.submit(p, 8).result(120).tokens for p in prompts]
    assert res.requeued == 3 and set(res.in_flight) == {0 + 1, 2, 3}
    assert all(0 < k < n_new for k in res.in_flight.values())
    _hold_split_invariant(results, res, prompts, tlm, tlm2, n_new)
    assert st["compiled_programs"] == keys and st["model_version"] == 2
    for p, g in zip(prompts, kept):
        np.testing.assert_array_equal(g, _solo(tlm, p, 8))
    jeng = JaxServingEngine(jlm, MAX_LEN, slots=3, buckets=BUCKETS)
    try:
        jres_results, jres = _swap_under_traffic(jeng, tree, prompts, n_new)
    finally:
        jeng.shutdown()
    assert jres.requeued == 3
    _hold_split_invariant(jres_results, jres, prompts, tlm, tlm2, n_new)


def test_swap_on_a_speculative_paged_engine(pair, v2):
    """A self-drafting paged engine swaps its target's weights; the draft
    keeps v1 (as JAX's), and every token after the swap is still greedy on
    the target's new weights."""
    _, tlm = pair
    tree, tlm2 = v2
    prompts = [_prompt(100 + i, 5 + 4 * i) for i in range(2)]
    with _engine(tlm, draft_model=tlm, spec_tokens=2, pages=12,
                 page_tokens=8) as eng:
        results, res = _swap_under_traffic(eng, tree, prompts, 16)
        st = eng.stats()
    _hold_split_invariant(results, res, prompts, tlm, tlm2, 16)
    assert st["compiled_programs"] <= st["program_grid_bound"]


# ------------------------------------------------------ admit wait, traces
def test_admit_wait_gathers_a_batch_before_the_first_prefill(pair,
                                                             monkeypatch):
    """``admit_wait_ms`` (``BIGDL_SERVE_ADMIT_WAIT_MS``): an idle engine's
    gather takes the first arrival, then waits for more up to the slot
    count; a full batch or a swap's wake-up ends the wait at once."""
    from bigdl_tpu_torch.serving.engine import _WAKE
    from bigdl_tpu_torch.serving.request import Request
    _, tlm = pair
    monkeypatch.setenv("BIGDL_SERVE_ADMIT_WAIT_MS", "60000")
    eng = _engine(tlm)
    assert eng.admit_wait_s == 60.0
    reqs = [Request(i, _prompt(110 + i, 4), 3) for i in range(3)]
    for r in reqs:
        eng._queue.put(r)
    assert eng._gather() is False and eng._pending == reqs[:2]
    eng._pending.clear()
    eng._queue.put(_WAKE)
    assert eng._gather() is False and eng._pending == reqs[2:]
    eng.shutdown()


def test_slowest_requests_persist_their_spans(pair, tmp_path):
    """Tail sampling: with ``BIGDL_TRACE_SAMPLE`` at 1 every finished
    request writes its queue, prefill and decode spans to the JSONL log
    under its trace id."""
    from bigdl_tpu_torch.obs import trace
    _, tlm = pair
    path = str(tmp_path / "events.jsonl")
    trace.configure(jsonl=path)
    try:
        with _engine(tlm) as eng:
            eng._trace_sample = 1.0
            r = eng.submit(_prompt(120, 5), 4).result(120)
        events_ = [e for e in trace.read_events(path)
                   if e["kind"] == "request_trace"]
    finally:
        trace.reset()
    assert [e["trace_id"] for e in events_] == [r.trace_id]
    assert [sp["name"] for sp in events_[0]["spans"]] == [
        "serve/queue", "serve/prefill", "serve/decode"]
    assert events_[0]["n_generated"] == 4

