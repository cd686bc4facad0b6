"""Deadlines and overload control of the port's ``ServingEngine``, on the
CPU, against the JAX engine's semantics.

Deadlines run on an injected clock (the engine's ``clock`` attribute), not
on wall-clock margins: the clock jumps 10 s once the engine has reached the
point the test is about, so each outcome is fixed by the engine's own
order of work. Shed and degrade hold part of the page pool by hand, which
both engines read at submit; the JAX engine compiles nothing here.
"""

import threading

import numpy as np
import pytest

from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.serving.engine import EngineOverloaded as JaxEngineOverloaded
from bigdl_tpu.utils.random_generator import RandomGenerator
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models.transformerlm import TransformerLM
from bigdl_tpu_torch.serving import (
    EngineOverloaded, EngineShutdown, RequestTimeout, ServingEngine,
)

VOCAB, E, HEADS, MAX_LEN = 64, 32, 4, 64
BUCKETS = (16, 32, 64)


@pytest.fixture(scope="module")
def pair():
    RandomGenerator.set_seed(19)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS, num_layers=2,
                           max_len=MAX_LEN).evaluate()
    tlm = TransformerLM(VOCAB, E, HEADS, 2, MAX_LEN, device="cpu")
    load_jax_params(tlm, jlm.get_params())
    return jlm, tlm


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _solo(tlm, p, m):
    return tnn.greedy_generate(tlm, p[None], m, device="cpu")[0].numpy()


def test_deadline_passes_while_queued_behind_a_full_grid(pair):
    """One slot, A decoding without a deadline, B queued with a 1 s
    deadline: the clock jumps 10 s once A holds the row and B waits, so B
    fails with ``RequestTimeout`` before it is ever admitted; A's tokens
    are solo decode's."""
    _, tlm = pair
    pa, pb = _prompt(1, 6), _prompt(2, 9)
    with ServingEngine(tlm, MAX_LEN, slots=1, buckets=BUCKETS,
                       device="cpu") as eng:
        eng.clock = lambda: 10.0 if eng._prefills >= 1 and (
            eng._pending or eng._queue.qsize()) else 0.0
        ha = eng.submit(pa, 40)
        hb = eng.submit(pb, 5, deadline_ms=1000)
        with pytest.raises(RequestTimeout, match="while queued"):
            hb.result(120)
        got = ha.result(120).tokens
        st = eng.stats()
    np.testing.assert_array_equal(got, _solo(tlm, pa, 40))
    assert hb._request.admit_t is None
    assert st["timeouts"] == 1 and st["completed"] == 1
    assert st["prefills"] == 1 and st["queue_depth"] == 0


@pytest.mark.parametrize("paged", [False, True])
def test_deadline_passes_mid_decode_and_recycles_the_row(pair, paged):
    """Two slots: A without a deadline, B with 1 s; the clock jumps 10 s
    once B is admitted, so B fails mid-decode after its first tokens. Its
    row (and pages) go back at once: C takes the row while A decodes, and
    A's and C's tokens are solo decode's."""
    _, tlm = pair
    pa, pb, pc = _prompt(3, 7), _prompt(4, 12), _prompt(5, 20)
    kw = dict(pages=8, page_tokens=16) if paged else {}
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS, device="cpu",
                       **kw) as eng:
        eng.clock = lambda: 10.0 if eng._prefills >= 2 else 0.0
        ha = eng.submit(pa, 30)
        hb = eng.submit(pb, 30, deadline_ms=1000)
        with pytest.raises(RequestTimeout, match="mid-decode"):
            hb.result(120)
        hc = eng.submit(pc, 8)
        got_a, got_c = ha.result(120).tokens, hc.result(120).tokens
        st = eng.stats()
    assert 1 <= len(hb._request.generated) < 30
    np.testing.assert_array_equal(got_a, _solo(tlm, pa, 30))
    np.testing.assert_array_equal(got_c, _solo(tlm, pc, 8))
    assert st["timeouts"] == 1 and st["completed"] == 2
    assert st["slot_recycles"] >= 1 and st["pages_used"] == 0


def test_default_deadline_from_the_environment(pair, monkeypatch):
    """``BIGDL_SERVE_DEADLINE_MS`` sets the engine's default; a request's
    ``deadline_ms=0`` opts out of it."""
    _, tlm = pair
    monkeypatch.setenv("BIGDL_SERVE_DEADLINE_MS", "500")
    with ServingEngine(tlm, MAX_LEN, slots=1, buckets=BUCKETS,
                       device="cpu") as eng:
        assert eng.default_deadline_s == 0.5
        eng.clock = lambda: 0.0
        h = eng.submit(_prompt(6, 5), 3)
        h0 = eng.submit(_prompt(7, 5), 3, deadline_ms=0)
        assert h._request.deadline_t == 0.5
        assert h0._request.deadline_t is None
        h.result(120), h0.result(120)


def _held(engine, n):
    """Take ``n`` pages of ``engine``'s pool by hand (the pool is busy)."""
    return engine._allocator.alloc(n)


def test_shed_raises_jax_fields(pair):
    """Shed on a held pool, in both packages, with the same pool and
    request: ``EngineOverloaded`` with the same figures; a shed on a full
    backlog too."""
    jlm, tlm = pair
    p = _prompt(8, 30)                     # needs 2 pages of 16 now
    errors = []
    for Engine, Overloaded, dev in (
            (ServingEngine, EngineOverloaded, dict(device="cpu")),
            (JaxServingEngine, JaxEngineOverloaded, {})):
        eng = Engine(tlm if Engine is ServingEngine else jlm, MAX_LEN,
                     slots=2, buckets=BUCKETS, pages=4, page_tokens=16,
                     overload="shed", **dev)
        try:
            _held(eng, 3)
            with pytest.raises(Overloaded) as ei:
                eng.submit(p, 8)
            errors.append(ei.value)
            assert eng.stats()["shed"] == 1
        finally:
            eng.shutdown()
    ours, theirs = errors
    for field in ("queue_depth", "est_wait_s", "est_wait_ms", "decode_rate",
                  "pages_free"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.pages_free == 1 and "page pool exhausted" in str(ours)
    with ServingEngine(tlm, MAX_LEN, slots=1, buckets=BUCKETS, device="cpu",
                       overload="shed", queue_depth=1) as eng:
        with eng._device_lock:             # the engine admits nothing
            eng.submit(p, 4)
            with pytest.raises(EngineOverloaded) as ei:
                eng.submit(p, 4)
        assert ei.value.pages_free is None and ei.value.queue_depth == 1


def test_degrade_halves_max_new_tokens_as_jax_does(pair):
    """Degrade on a held pool: the request is admitted with half its
    ``max_new_tokens`` in both packages, and the port serves solo decode's
    first half once the pages come back."""
    jlm, tlm = pair
    p = _prompt(9, 30)
    halves = []
    jeng = JaxServingEngine(jlm, MAX_LEN, slots=2, buckets=BUCKETS, pages=4,
                            page_tokens=16, overload="degrade")
    try:
        _held(jeng, 3)
        halves.append(jeng.submit(p, 9)._request.max_new_tokens)
        assert jeng.stats()["degraded_admits"] == 1
    finally:
        jeng.shutdown()
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS, pages=4,
                       page_tokens=16, overload="degrade",
                       device="cpu") as eng:
        held = _held(eng, 3)
        h = eng.submit(p, 9)
        halves.append(h._request.max_new_tokens)
        assert eng.stats()["degraded_admits"] == 1
        eng._allocator.free(held)
        got = h.result(120)
        full = eng.submit(p, 9).result(120)     # no pressure: not halved
    assert halves == [4, 4] and got.n_generated == 4
    np.testing.assert_array_equal(got.tokens, _solo(tlm, p, 4))
    assert full.n_generated == 9


def test_shutdown_fails_queued_requests_and_clears_the_backlog(pair):
    _, tlm = pair
    eng = ServingEngine(tlm, MAX_LEN, slots=1, buckets=BUCKETS, pages=4,
                        page_tokens=16, device="cpu")
    held = _held(eng, 4)                   # nothing can be admitted
    hs = [eng.submit(_prompt(10 + i, 5), 3) for i in range(3)]
    done = threading.Event()
    t = threading.Thread(target=lambda: (eng.shutdown(), done.set()))
    t.start()
    t.join(60)
    assert done.is_set()
    for h in hs:
        with pytest.raises(EngineShutdown):
            h.result(1)
    assert eng.stats()["queue_depth"] == 0 and len(held) == 4
    with pytest.raises(EngineShutdown):
        eng.submit(_prompt(20, 5), 3)


def test_overload_mode_is_checked(pair, monkeypatch):
    _, tlm = pair
    with pytest.raises(ValueError, match="overload"):
        ServingEngine(tlm, MAX_LEN, overload="drop", device="cpu")
    monkeypatch.setenv("BIGDL_SERVE_OVERLOAD", "degrade")
    with ServingEngine(tlm, MAX_LEN, device="cpu") as eng:
        assert eng.overload == "degrade"
        assert eng.estimated_wait_s() == 0.0
