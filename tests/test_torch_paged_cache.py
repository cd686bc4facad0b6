"""The port's paged KV cache (``serving/paged_cache.py``, the paged step of
``nn/attention.py`` and the paged ``ServingEngine``) against the JAX
package, on the CPU.

One tiny model, its weights copied into both packages by path; one JAX
paged engine serves the module's scripted traffic once. Tolerances: the
paged decode step's outputs and the pool pages it writes within 1e-6 of
JAX's (both fp32, the same pool and table; the trash page, where several
rows may write, is left out); served tokens bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.serving.paged_cache import PageAllocator as JaxPageAllocator
from bigdl_tpu.serving.paged_cache import logical_pages as jax_logical_pages
from bigdl_tpu.utils.random_generator import RandomGenerator
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models.transformerlm import TransformerLM
from bigdl_tpu_torch.serving import (
    TRASH_PAGE, EngineOverloaded, PageAllocator, ServingEngine,
    install_paged_cache, logical_pages,
)
from bigdl_tpu_torch.serving.paged_cache import (
    assign_cache_pages, is_paged_state, reset_page_slot, with_page_table,
)

VOCAB, E, HEADS, MAX_LEN = 64, 32, 4, 64
BUCKETS = (16, 32, 64)
PROMPTS = [3, 7, 12, 17, 25, 5, 30, 9, 14, 21]
NEWS = [6, 8, 4, 10, 6, 12, 5, 8, 6, 4]


@pytest.fixture(scope="module")
def pair():
    RandomGenerator.set_seed(11)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS, num_layers=2,
                           max_len=MAX_LEN).evaluate()
    tlm = TransformerLM(VOCAB, E, HEADS, 2, MAX_LEN, device="cpu")
    load_jax_params(tlm, jlm.get_params())
    return jlm, tlm


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _traffic():
    return [(_prompt(100 + i, n), m) for i, (n, m) in
            enumerate(zip(PROMPTS, NEWS))]


@pytest.fixture(scope="module")
def jax_paged_tokens(pair):
    """The module's one JAX engine: paged, 4 slots, 12 pages of 16."""
    jlm, _ = pair
    with JaxServingEngine(jlm, MAX_LEN, slots=4, buckets=BUCKETS, pages=12,
                          page_tokens=16) as eng:
        hs = [eng.submit(p, m) for p, m in _traffic()]
        return [np.asarray(h.result(120).tokens) for h in hs]


def _attention_leaves(state):
    """The first attention layer's dict and every layer's dict."""
    nodes = []

    def walk(node):
        if "page_k" in node or "cache_k" in node:
            nodes.append(node)
            return
        for v in node.values():
            if isinstance(v, dict):
                walk(v)

    walk(state)
    return nodes


def _solo(tlm, p, m):
    return tnn.greedy_generate(tlm, p[None], m, device="cpu")[0].numpy()


def test_page_allocator_matches_jax_on_a_storm():
    """A seeded alloc/free storm through both allocators: the same grants
    (lowest ids first, all or nothing), the same refusals, the same
    counts; then double and out-of-range frees raise in both."""
    rng = np.random.default_rng(7)
    ours, theirs = PageAllocator(32), JaxPageAllocator(32)
    held = []
    for _ in range(600):
        if rng.random() < 0.55:
            n = int(rng.integers(0, 6))
            got = ours.alloc(n)
            assert got == theirs.alloc(n)
            if got:
                held.append(got)
        elif held:
            grp = held.pop(int(rng.integers(len(held))))
            ours.free(grp)
            theirs.free(grp)
        assert (ours.free_count, ours.used_count, ours.alloc_failures) == (
            theirs.free_count, theirs.used_count, theirs.alloc_failures)
        flat = [p for grp in held for p in grp]
        assert len(flat) == len(set(flat)) and TRASH_PAGE not in flat
    for grp in held:
        ours.free(grp)
    assert ours.alloc(32) == list(range(1, 33))
    for alloc in (ours, theirs):
        alloc.reset()
        pages = alloc.alloc(2)
        alloc.free(pages)
        for bad in (pages, [99], [-1]):
            with pytest.raises(ValueError):
                alloc.free(bad)


@pytest.mark.parametrize("max_len,page_tokens", [
    (48, 16), (64, 16), (64, 1), (50, 16), (64, 0), (16, 32)])
def test_logical_pages_validation_matches_jax(max_len, page_tokens):
    try:
        want = jax_logical_pages(max_len, page_tokens)
    except ValueError:
        with pytest.raises(ValueError):
            logical_pages(max_len, page_tokens)
    else:
        assert logical_pages(max_len, page_tokens) == want


def test_paged_tokens_match_the_grid_jax_and_solo(pair, jax_paged_tokens):
    """Scripted mixed-length traffic through the port's paged engine and
    its slot grid: tokens bitwise equal to each other, to JAX's paged
    engine and to solo ``greedy_generate``; the ledger within its bound;
    the pool drained."""
    _, tlm = pair
    reqs = _traffic()

    def serve(**kw):
        with ServingEngine(tlm, MAX_LEN, slots=4, buckets=BUCKETS,
                           device="cpu", **kw) as eng:
            out = [h.result(120).tokens for h in
                   [eng.submit(p, m) for p, m in reqs]]
            return out, dict(eng.stats(), keys=eng._programs.keys)

    grid, _ = serve()
    paged, st = serve(pages=12, page_tokens=16)
    for (p, m), g, pg, j in zip(reqs, grid, paged, jax_paged_tokens):
        np.testing.assert_array_equal(pg, g)
        np.testing.assert_array_equal(pg, j)
        np.testing.assert_array_equal(pg, _solo(tlm, p, m))
    assert st["paged"] is True and st["pages_total"] == 12
    assert st["compiled_programs"] <= st["program_grid_bound"]
    assert {k[0] for k in st["keys"]} >= {"serve_decode_paged",
                                           "serve_assign_paged"}
    assert st["pages_used"] == 0 and st["free_page_ratio"] == 1.0
    assert st["peak_active_slots"] == 4


def test_exhaustion_preempts_the_youngest_and_completes(pair):
    """Four pages, two 17-token prompts with 17 new tokens: both admit on
    two pages, the first to need a third preempts the younger, which
    re-prefills its prompt and emitted tokens; both equal solo decode."""
    _, tlm = pair
    p1, p2 = _prompt(201, 17), _prompt(202, 17)
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS, pages=4,
                       page_tokens=16, device="cpu") as eng:
        h1, h2 = eng.submit(p1, 17), eng.submit(p2, 17)
        r1, r2 = h1.result(120), h2.result(120)
        st = eng.stats()
    assert st["page_evictions"] >= 1
    np.testing.assert_array_equal(r1.tokens, _solo(tlm, p1, 17))
    np.testing.assert_array_equal(r2.tokens, _solo(tlm, p2, 17))
    assert st["pages_used"] == 0 and st["completed"] == 2


def test_oversized_request_refused_at_submit(pair):
    _, tlm = pair
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS, pages=2,
                       page_tokens=16, device="cpu") as eng:
        with pytest.raises(ValueError, match="pages"):
            eng.submit(_prompt(203, 20), 20)      # needs 3 of 2 pages
        assert eng.stats()["submitted"] == 0


def test_shed_reports_pages_free(pair):
    """``overload="shed"`` with the pool held: a request whose context the
    free pages cannot back raises ``EngineOverloaded`` with
    ``pages_free``; once the pages come back it is served."""
    _, tlm = pair
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS, pages=4,
                       page_tokens=16, overload="shed", device="cpu") as eng:
        held = eng._allocator.alloc(3)          # the pool is busy
        p = _prompt(204, 30)                    # needs 2 pages now
        with pytest.raises(EngineOverloaded) as ei:
            eng.submit(p, 8)
        assert ei.value.pages_free == 1 and ei.value.queue_depth == 0
        assert eng.stats()["shed"] == 1
        eng._allocator.free(held)
        got = eng.submit(p, 8).result(120).tokens
    np.testing.assert_array_equal(got, _solo(tlm, p, 8))


def test_kv_paged_zero_forces_the_grid(pair, monkeypatch):
    _, tlm = pair
    monkeypatch.setenv("BIGDL_KV_PAGED", "0")
    monkeypatch.setenv("BIGDL_KV_PAGES", "12")
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS,
                       device="cpu") as eng:
        st = eng.stats()
        assert st["paged"] is False and st["pages_total"] == 0
        p = _prompt(206, 9)
        got = eng.submit(p, 6).result(120).tokens
        assert not is_paged_state(eng._dec_state)
    np.testing.assert_array_equal(got, _solo(tlm, p, 6))
    monkeypatch.delenv("BIGDL_KV_PAGED")
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS,
                       device="cpu") as eng:
        assert eng.stats()["paged"] is True and eng.pages == 12


def test_slot_primitives_refuse_a_paged_state(pair):
    _, tlm = pair
    state = install_paged_cache(tlm, 2, MAX_LEN, 4, 16)
    src = tnn.install_decode_cache(tlm, 1, MAX_LEN)
    grid = tnn.install_decode_cache(tlm, 2, MAX_LEN)
    with pytest.raises(ValueError, match="PAGED"):
        tnn.reset_decode_slot(state, 0)
    with pytest.raises(ValueError, match="PAGED"):
        tnn.assign_cache_slot(state, src, 0, pos=3)
    with pytest.raises(ValueError, match="paged cache"):
        reset_page_slot(grid, [1], 0)
    with pytest.raises(ValueError, match="unpaged"):
        assign_cache_pages(grid, src, [0, 0, 0, 0], 0, 3)


def test_assign_and_reset_pages(pair):
    """A prefilled batch-1 cache scattered page by page: the gathered rows
    of the slot read back the source's rows, the table row and positions
    are set; the reset zeroes exactly those pages and points the row at
    trash. The table is one tensor for every layer, rewritten in place."""
    _, tlm = pair
    state = install_paged_cache(tlm, 3, MAX_LEN, 6, 16)
    tables = [n["page_table"] for n in _attention_leaves(state)]
    assert len(tables) == 2 and tables[0] is tables[1]
    src = tnn.install_decode_cache(tlm, 1, MAX_LEN)
    with torch.no_grad():
        tlm.run(torch.from_numpy(_prompt(5, 20)[None].astype(np.int64)), src)
    pages = torch.tensor([3, 5, 0, 0])
    assign_cache_pages(state, src, pages, 1, 20)
    attn, srcn = _attention_leaves(state)[0], _attention_leaves(src)[0]
    got = attn["page_k"][attn["page_table"][1]].transpose(0, 1).reshape(
        srcn["cache_k"].shape[1:])
    torch.testing.assert_close(got[:, :32], srcn["cache_k"][0, :, :32],
                               rtol=0, atol=0)
    assert attn["page_table"][1].tolist() == [3, 5, 0, 0]
    assert attn["pos"].tolist() == [0, 20, 0]
    host = torch.zeros((3, 4), dtype=torch.long)
    host[1] = pages
    with_page_table(state, host)
    assert tables[0].data_ptr() == attn["page_table"].data_ptr()
    reset_page_slot(state, [3, 5], 1)
    assert not attn["page_k"][[3, 5]].any()
    assert attn["page_table"][1].tolist() == [0, 0, 0, 0]
    assert attn["pos"].tolist() == [0, 0, 0]


_STEP_CASES = {
    "mha": {},
    "gqa2-rope-window": dict(num_kv_heads=2, rope=True, window=20),
}


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("case", sorted(_STEP_CASES))
def test_paged_decode_step_matches_jax(case, t):
    """One ``_paged_decode_step`` on the same pool, table and positions in
    both packages: 3 live rows (one near the window's end, so the chunk's
    start clamps) and a free row on the trash page. Outputs and the
    written pages within 1e-6; the positions advance by t."""
    RandomGenerator.set_seed(3)
    opts = _STEP_CASES[case]
    jm = jnn.MultiHeadAttention(E, HEADS, causal=True, **opts)
    tm = tnn.MultiHeadAttention(E, HEADS, causal=True, **opts)
    load_jax_params(tm, jm.get_params())
    rng = np.random.default_rng(4)
    kv, hd, ptok, pages = tm.kv_heads, E // HEADS, 8, 14
    w = MAX_LEN // ptok
    pool_k = rng.normal(size=(pages + 1, kv, ptok, hd)).astype(np.float32)
    pool_v = rng.normal(size=(pages + 1, kv, ptok, hd)).astype(np.float32)
    table = np.zeros((4, w), np.int64)
    table[0, :2] = [4, 2]
    table[1, :3] = [1, 7, 3]
    table[2, :] = [5, 6, 8, 9, 10, 11, 12, 13]
    pos = np.array([11, 17, MAX_LEN - 2, 30], np.int64)   # row 3 is free
    x = rng.normal(size=(4, t, E)).astype(np.float32)
    jstate = {"page_k": jnp.asarray(pool_k), "page_v": jnp.asarray(pool_v),
              "page_table": jnp.asarray(table, jnp.int32),
              "pos": jnp.asarray(pos, jnp.int32)}
    want, jout = jm.apply(jm.get_params(), jstate, jnp.asarray(x))
    tstate = {"page_k": torch.from_numpy(pool_k.copy()),
              "page_v": torch.from_numpy(pool_v.copy()),
              "page_table": torch.from_numpy(table),
              "pos": torch.from_numpy(pos.copy())}
    with torch.no_grad():
        got, tout = tm.run(torch.from_numpy(x), tstate)
    live = [0, 1, 2]
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=1e-6, atol=1e-6)
    for key in ("page_k", "page_v"):
        assert tout[key] is tstate[key]          # written in place
        np.testing.assert_allclose(tout[key].numpy()[1:],
                                   np.asarray(jout[key])[1:],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tout["pos"].numpy(),
                                  np.asarray(jout["pos"]))


def test_idle_slot_past_max_len_keeps_rows_finite():
    """ROADMAP Queue C's reproduction of JAX's trash-page poisoning:
    ``TransformerLM(64, 32, 4, 2, max_len=64)`` at seed 19, three slots
    over 7 pages of 8 tokens, six prompts of 5, 17, 9, 30, 3 and 12 tokens
    from ``default_rng(0)``, 20 new tokens each. An idle slot's position
    runs past ``max_len``; the port's position embedding clamps its index
    (``models/transformerlm/transformerlm.py``), so no NaN reaches the
    shared trash page and all six equal solo ``greedy_generate`` (JAX's
    engine fails request 5 with ``NonFiniteLogitsError``)."""
    RandomGenerator.set_seed(19)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS, num_layers=2,
                           max_len=MAX_LEN)
    tlm = TransformerLM(VOCAB, E, HEADS, 2, MAX_LEN, device="cpu")
    load_jax_params(tlm, jlm.get_params())
    r = np.random.default_rng(0)
    prompts = [r.integers(0, VOCAB, n).astype(np.int32)
               for n in (5, 17, 9, 30, 3, 12)]
    with ServingEngine(tlm, MAX_LEN, slots=3, buckets=(16, 32, 64),
                       pages=7, page_tokens=8, device="cpu") as eng:
        handles = [eng.submit(p, 20) for p in prompts]
        got = [h.result(300).tokens for h in handles]
        st = eng.stats()
    for p, g in zip(prompts, got):
        np.testing.assert_array_equal(g, _solo(tlm, p, 20))
    assert st["poisoned_slots"] == 0 and st["completed"] == 6
