"""``ServingEngine.stats()`` of the port against the JAX engine's, on the CPU.

Both engines serve the same requests on the same weights (a small
``TransformerLM``), on the slot grid and paged, without a draft and with
the target as its own draft (``spec_tokens=2``):

- the key set is JAX's, the health keys (``HEALTH_KEYS``) included, plus
  the port's own (``PORT_KEYS``);
- the rounding is JAX's (``decode_rate``, ``decode_tps`` and
  ``est_wait_ms`` to 3 places, ``est_wait_s`` to 6, ``spec_acceptance``
  and ``free_page_ratio`` to 4) and the counts after the drain equal;
- ``submitted`` counts a request once it is queued: 1 in both after a
  submit to a shut-down engine, 0 after a shed, and the next default
  request id is 0 in both.
"""

import numpy as np
import pytest

from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.serving.engine import EngineOverloaded as JaxEngineOverloaded
from bigdl_tpu.serving.engine import EngineShutdown as JaxEngineShutdown
from bigdl_tpu.utils.random_generator import RandomGenerator
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models.transformerlm import TransformerLM
from bigdl_tpu_torch.serving import (
    EngineOverloaded, EngineShutdown, ServingEngine,
)

VOCAB, E, HEADS, MAX_LEN = 64, 32, 4, 64
BUCKETS = (16, 32, 64)
#: JAX's health and recovery keys
HEALTH_KEYS = {"health", "respawns", "model_version", "slo_degraded"}
#: the port's keys that JAX's stats() lacks
PORT_KEYS = {"device", "peak_active_slots", "prefills", "prefills_by_bucket",
             "prefill_seconds", "decode_ticks", "decode_tokens",
             "decode_seconds", "running"}
ROUNDING = {"decode_rate": 3, "decode_tps": 3, "est_wait_ms": 3,
            "est_wait_s": 6, "spec_acceptance": 4, "free_page_ratio": 4}
EQUAL_AFTER_DRAIN = ("submitted", "completed", "shed", "timeouts",
                     "backlog", "queue_depth", "queued", "active_slots",
                     "spec_tokens", "spec_proposed", "spec_accepted",
                     "spec_acceptance", "paged", "pages_total",
                     "page_tokens", "pages_used", "pages_free",
                     "free_page_ratio", "prefill_inflight", "slots",
                     "max_len", "program_grid_bound", "overload",
                     "health", "respawns", "model_version", "slo_degraded")


@pytest.fixture(scope="module")
def pair():
    RandomGenerator.set_seed(19)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS, num_layers=2,
                           max_len=MAX_LEN).evaluate()
    tlm = TransformerLM(VOCAB, E, HEADS, 2, MAX_LEN, device="cpu")
    load_jax_params(tlm, jlm.get_params())
    return jlm, tlm


def _prompts():
    r = np.random.default_rng(0)
    return [r.integers(0, VOCAB, n).astype(np.int32) for n in (5, 11, 17)]


def _engines(pair, **kw):
    jlm, tlm = pair
    draft = kw.pop("draft", False)
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if draft:
        jkw.update(draft_model=jlm, spec_tokens=2)
        tkw.update(draft_model=tlm, spec_tokens=2)
    return (ServingEngine(tlm, MAX_LEN, buckets=BUCKETS, **tkw),
            JaxServingEngine(jlm, MAX_LEN, buckets=BUCKETS, **jkw))


def _serve(eng):
    handles = [eng.submit(p, 6) for p in _prompts()]
    for h in handles:
        h.result(300)
    return eng.stats()


@pytest.mark.parametrize("draft", [False, True], ids=["plain", "self_draft"])
@pytest.mark.parametrize("paged", [False, True], ids=["grid", "paged"])
def test_stats_hold_jax_keys_rounding_and_counts(pair, paged, draft):
    kw = dict(slots=2, draft=draft)
    if paged:
        kw.update(pages=12, page_tokens=8)
    ours, theirs = _engines(pair, **kw)
    try:
        got, want = _serve(ours), _serve(theirs)
    finally:
        ours.shutdown()
        theirs.shutdown()
    assert HEALTH_KEYS <= set(want) and HEALTH_KEYS <= set(got)
    assert set(got) - PORT_KEYS == set(want)
    assert "acceptance_rate" not in got
    for key, places in ROUNDING.items():
        assert got[key] == round(got[key], places), key
        assert want[key] == round(want[key], places), key
    for key in EQUAL_AFTER_DRAIN:
        assert got[key] == want[key], key
    assert got["submitted"] == got["completed"] == 3
    assert got["health"] == "ready" and got["respawns"] == 0
    if draft:
        assert got["spec_acceptance"] == want["spec_acceptance"] == 1.0
    assert got["decode_rate"] == got["decode_tps"] > 0


def test_submitted_after_a_submit_to_a_shut_down_engine(pair):
    p = _prompts()[0]
    counts = []
    for eng, shut in zip(_engines(pair, slots=2),
                         (EngineShutdown, JaxEngineShutdown)):
        eng.submit(p, 3).result(300)
        eng.shutdown()
        with pytest.raises(shut):
            eng.submit(p, 3)
        counts.append(eng.stats()["submitted"])
    assert counts == [1, 1]


def test_a_shed_submit_does_not_count(pair):
    """A held pool sheds the first submit in both engines; ``submitted``
    stays 0 and the next request's default id is 0 in both."""
    p = _prompts()[1]
    ids = []
    for eng, over in zip(_engines(pair, slots=2, pages=4, page_tokens=16,
                                  overload="shed"),
                         (EngineOverloaded, JaxEngineOverloaded)):
        try:
            held = eng._allocator.alloc(4)
            with pytest.raises(over):
                eng.submit(p, 4)
            st = eng.stats()
            assert st["submitted"] == 0 and st["shed"] == 1
            eng._allocator.free(held)
            h = eng.submit(p, 4)
            ids.append(h._request.request_id)
            h.result(300)
            assert eng.stats()["submitted"] == 1
        finally:
            eng.shutdown()
    assert ids == [0, 0]
