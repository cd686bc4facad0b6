"""The port's prefix pool (``serving/prefix_cache.py``) and its engine path
against the JAX package, on the CPU.

One tiny model, its weights copied into both packages by path; one JAX
pooled engine serves the module's shared-prefix traffic once. Tokens are
compared bitwise; the pools' keys, LRU order and counters exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.serving.prefix_cache import PrefixPool as JaxPrefixPool
from bigdl_tpu.serving.scheduler import (
    pick_seed_bucket as jax_pick_seed_bucket,
)
from bigdl_tpu.utils.random_generator import RandomGenerator
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models.transformerlm import TransformerLM
from bigdl_tpu_torch.serving import PrefixPool, ServingEngine, pick_seed_bucket

VOCAB, E, HEADS, MAX_LEN = 64, 32, 4, 64
BUCKETS = (8, 16, 32, 64)


@pytest.fixture(scope="module")
def pair():
    RandomGenerator.set_seed(13)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS, num_layers=2,
                           max_len=MAX_LEN).evaluate()
    tlm = TransformerLM(VOCAB, E, HEADS, 2, MAX_LEN, device="cpu")
    load_jax_params(tlm, jlm.get_params())
    return jlm, tlm


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _traffic():
    """A 24-token shared prefix alone, four requests of prefix + a 3..20
    token tail (each a partial hit at the prefix's boundary, 24), an exact
    repeat of the second, and one unrelated prompt."""
    base = _prompt(300, 24)
    tails = [np.concatenate([base, _prompt(301 + i, n)])
             for i, n in enumerate((3, 9, 14, 20))]
    return [(base, 6)] + [(t, 5) for t in tails] + [(tails[1], 5),
                                                     (_prompt(309, 11), 4)]


def _serve(engine, reqs):
    """Sequentially, so each lookup sees every earlier insert."""
    return [np.asarray(engine.submit(p, m).result(120).tokens)
            for p, m in reqs]


@pytest.fixture(scope="module")
def jax_pooled(pair):
    jlm, _ = pair
    with JaxServingEngine(jlm, MAX_LEN, slots=2, buckets=BUCKETS,
                          prefix_pool=8, prefix_chunk=8) as eng:
        return _serve(eng, _traffic()), eng.stats()


@pytest.mark.parametrize("paged", [False, True])
def test_hits_match_the_cold_engine_and_jax(pair, jax_pooled, paged):
    """Exact and partial hits give the cold engine's and JAX's pooled
    engine's tokens; the pool's counters equal JAX's; the exact repeat runs
    no prefill; the ledger holds the cold engine's keys and no more."""
    _, tlm = pair
    want, jst = jax_pooled
    reqs = _traffic()
    kw = dict(pages=12, page_tokens=16) if paged else {}
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS, device="cpu",
                       **kw) as cold:
        cold_tokens = _serve(cold, reqs)
        cold_keys = cold._programs.keys
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS, device="cpu",
                       prefix_pool=8, prefix_chunk=8, **kw) as eng:
        got = _serve(eng, reqs[:5])
        before = eng.stats()
        got += _serve(eng, reqs[5:])
        st = eng.stats()
        keys = eng._programs.keys
    for g, c, w in zip(got, cold_tokens, want):
        np.testing.assert_array_equal(g, c)
        np.testing.assert_array_equal(g, w)
    for k in ("prefix_hits", "prefix_misses", "prefix_evictions",
              "prefix_tokens_saved", "prefix_entries"):
        assert st[k] == jst[k], k
    assert st["prefix_hits"] == 5 and st["prefix_tokens_saved"] == 4 * 24 + 33
    # the repeat (an exact hit) ran no prefill; the unrelated prompt one
    assert st["prefills"] == before["prefills"] + 1
    # the tails' remainders replay bucket programs from depth 24: no key
    # but the cold engine's kinds, within the bound
    assert {k[0] for k in keys} == {k[0] for k in cold_keys}
    assert st["compiled_programs"] <= st["program_grid_bound"]
    assert st["prefix_bytes"] > 0


def _dummy_states(n, paged_rows=64):
    """A batch-1 cache of one layer in each package, rows ``paged_rows``."""
    k = np.random.default_rng(n).normal(size=(1, 1, paged_rows, 2))
    ours = ({"cache_k": torch.from_numpy(k.astype(np.float32)),
             "pos": torch.tensor([n])},)
    theirs = ({"cache_k": jnp.asarray(k, jnp.float32),
               "pos": jnp.asarray([n], jnp.int32)},)
    return ours, theirs


def test_lru_order_and_counters_match_jax():
    """A seeded run of inserts and lookups against two pools of capacity 3:
    the same hits at the same depths, the same LRU order of entries, the
    same evictions. Every context has a tail of its own, so none is a
    whole pooled context's chunk-aligned prefix (where the pools part:
    ``test_exact_hit_takes_the_entry_of_that_length``)."""
    ours, theirs = PrefixPool(3, chunk=4), JaxPrefixPool(3, chunk=4)
    rng = np.random.default_rng(5)
    heads = [_prompt(400 + i, 8) for i in range(5)]
    for step in range(60):
        ctx = np.concatenate([heads[int(rng.integers(5))],
                              _prompt(500 + step, int(rng.integers(1, 9)))])
        if rng.random() < 0.5:
            a, b = _dummy_states(len(ctx))
            ours.insert(ctx, a, step)
            theirs.insert(ctx, b, step)
        else:
            got = ours.lookup(ctx, (4, 8, 16), 32)
            want = theirs.lookup(ctx, (4, 8, 16), 32)
            assert (got is None) == (want is None)
            if got is not None:
                assert got[1] == want[1]
                np.testing.assert_array_equal(got[0].tokens, want[0].tokens)
                assert got[0].next_token == want[0].next_token
        assert [e.tokens.tolist() for e in ours._entries.values()] == [
            e.tokens.tolist() for e in theirs._entries.values()]
        assert (ours.hits, ours.misses, ours.evictions,
                ours.tokens_saved) == (theirs.hits, theirs.misses,
                                       theirs.evictions, theirs.tokens_saved)
    assert ours.evictions > 0 and ours.hits > 0


def test_exact_hit_takes_the_entry_of_that_length(pair):
    """A prompt pooled alone and again inside a longer pooled context, the
    longer one newest at the prompt's chunk boundary: a repeat of the
    prompt is an exact hit on its own entry (the longer entry's next token
    follows another context) and serves solo decode's tokens. JAX's pool
    answers it with the longer entry (``bigdl_tpu/serving/prefix_cache.py``
    ``lookup``) and serves that context's continuation."""
    _, tlm = pair
    base = _prompt(950, 24)
    reqs = [(base, 6), (np.concatenate([base, _prompt(951, 7)]), 6),
            (base, 6)]
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS, device="cpu",
                       prefix_pool=4, prefix_chunk=8) as eng:
        got = _serve(eng, reqs)
        st = eng.stats()
    for (p, m), g in zip(reqs, got):
        want = tnn.greedy_generate(tlm, p[None], m, device="cpu")[0]
        np.testing.assert_array_equal(g, want.numpy())
    assert st["prefix_hits"] == 2 and st["prefills"] == 2
    pool = PrefixPool(4, chunk=8)
    a, _ = _dummy_states(8)
    pool.insert(base, a, 1)
    pool.insert(reqs[1][0], a, 2)
    entry, c = pool.lookup(base, BUCKETS, MAX_LEN)
    assert (c, entry.next_token, len(entry)) == (24, 1, 24)
    pool = PrefixPool(4, chunk=8)
    pool.insert(reqs[1][0], a, 2)            # only the longer context
    entry, c = pool.lookup(base, BUCKETS, MAX_LEN)
    assert (c, len(entry)) == (16, 31)       # a partial hit, not exact


def test_longest_boundary_wins():
    """Entries at 8 and at 16 tokens of one stream: a context sharing 20
    tokens seeds at 16; one sharing 12 at 8, from the newest entry
    registered at that boundary; in both packages."""
    stream = _prompt(600, 32)
    for pool in (PrefixPool(4, chunk=8), JaxPrefixPool(4, chunk=8)):
        a, b = _dummy_states(8)
        states = a if isinstance(pool, PrefixPool) else b
        pool.insert(stream[:8], states, 1)
        pool.insert(stream[:16], states, 2)
        ctx = np.concatenate([stream[:20], _prompt(601, 3)])
        entry, c = pool.lookup(ctx, (8, 16), 64)
        assert (c, entry.next_token) == (16, 2)
        ctx = np.concatenate([stream[:12], _prompt(602, 3)])
        entry, c = pool.lookup(ctx, (8, 16), 64)
        assert (c, entry.next_token) == (8, 2)


@pytest.mark.parametrize("n,base,max_len", [
    (5, 0, 64), (9, 24, 64), (9, 40, 64), (30, 30, 64), (17, 16, 48),
    (1, 63, 64), (40, 0, 32)])
def test_pick_seed_bucket_matches_jax(n, base, max_len):
    assert pick_seed_bucket(n, BUCKETS, base, max_len) == \
        jax_pick_seed_bucket(n, BUCKETS, base, max_len)


def test_a_hit_needs_a_seedable_bucket():
    """A remainder whose bucket would run past the window from the pooled
    depth is no hit: both pools fall back to a shorter prefix, then miss."""
    stream = _prompt(700, 60)
    for pool in (PrefixPool(4, chunk=8), JaxPrefixPool(4, chunk=8)):
        a, b = _dummy_states(8)
        pool.insert(stream[:48], a if isinstance(pool, PrefixPool) else b, 3)
        # remainder 12 from depth 48: the 16 bucket ends at 64 > 56
        assert pool.lookup(stream[:60], (16, 32), 56) is None
        # with room (max_len 64) it is a hit at 48
        assert pool.lookup(stream[:60], (16, 32), 64)[1] == 48
        assert (pool.hits, pool.misses) == (1, 1)


def test_seeded_restores_the_full_window(pair):
    """A pooled 20-token prefill is kept as its first 32 rows (two pages of
    16); ``seeded`` gives back (1, kv, 64, d) rows, the kept rows equal and
    zeros after, every position leaf at c, as new tensors or in place."""
    _, tlm = pair
    state = tnn.install_decode_cache(tlm, 1, MAX_LEN)
    with torch.no_grad():
        tlm.run(torch.from_numpy(_prompt(800, 20)[None].astype(np.int64)),
                state)
    pool = PrefixPool(2, chunk=8, page=16)
    pool.insert(_prompt(800, 20), (state,), 7)
    entry = pool.lookup(_prompt(800, 20), BUCKETS, MAX_LEN)[0]
    assert entry.full_len == MAX_LEN
    kept = []

    def leaves(tree, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                leaves(v, out)
            else:
                out.append((k, v))
        return out

    leaves(entry.states[0], kept)
    assert all(v.shape[2] == 32 for k, v in kept if k.startswith("cache"))
    fresh = PrefixPool.seeded(entry, 16)
    target = tnn.install_decode_cache(tlm, 1, MAX_LEN)
    tnn.reset_decode_slot(target, 0)
    inplace = PrefixPool.seeded(entry, 16, out=(target,))
    assert inplace[0] is target
    for seeded in (fresh, inplace):
        got = leaves(seeded[0], [])
        want = leaves(state, [])
        for (k, g), (_, w) in zip(got, want):
            if k.startswith("cache"):
                assert g.shape == w.shape
                assert torch.equal(g[:, :, :32], w[:, :, :32])
                assert not g[:, :, 32:].any()
            else:
                assert g.tolist() == [16]


def test_prefill_export_then_seed_prefix_resumes_bitwise(pair):
    """A prefill run on one engine and handed to another's pool: the
    second engine's request is an exact hit, runs no prefill, and decodes
    solo ``greedy_generate``'s tokens."""
    _, tlm = pair
    prompt = _prompt(900, 21)
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS,
                       device="cpu") as a:
        nxt, states = a.prefill_export(prompt)
        assert a.stats()["prefills"] == 1 and a.stats()["active_slots"] == 0
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS, device="cpu",
                       prefix_pool=4, prefix_chunk=8) as b:
        b.seed_prefix(prompt, states, nxt)
        got = b.submit(prompt, 7).result(120).tokens
        st = b.stats()
    want = tnn.greedy_generate(tlm, prompt[None], 7, device="cpu")[0]
    np.testing.assert_array_equal(got, want.numpy())
    assert st["prefills"] == 0 and st["prefix_hits"] == 1
    assert got[len(prompt)] == nxt
    with ServingEngine(tlm, MAX_LEN, device="cpu") as c:
        with pytest.raises(ValueError, match="no prefix pool"):
            c.seed_prefix(prompt, states, nxt)
