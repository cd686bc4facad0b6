"""The port's speculative decoding (``serving/speculative.py`` and the
engine's draft path) against the JAX package, on the CPU.

A tiny target and a half-width, one-layer draft, their weights copied into
both packages by path. The target drafting for itself pins acceptance at
1; the small draft's proposals almost never match (acceptance near 0).
Tokens are compared bitwise at any acceptance; acceptance counts exactly.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.serving import SpeculativeDecoder as JaxSpeculativeDecoder
from bigdl_tpu.utils.random_generator import RandomGenerator
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models.transformerlm import TransformerLM
from bigdl_tpu_torch.serving import ServingEngine, SpeculativeDecoder

VOCAB, E, HEADS, MAX_LEN, K = 64, 32, 4, 64, 3
BUCKETS = (16, 32, 64)


@pytest.fixture(scope="module")
def models():
    RandomGenerator.set_seed(17)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS, num_layers=2,
                           max_len=MAX_LEN).evaluate()
    jdraft = JaxTransformerLM(VOCAB, embed_dim=E // 2, num_heads=HEADS // 2,
                              num_layers=1, max_len=MAX_LEN).evaluate()
    tlm = TransformerLM(VOCAB, E, HEADS, 2, MAX_LEN, device="cpu")
    tdraft = TransformerLM(VOCAB, E // 2, HEADS // 2, 1, MAX_LEN,
                           device="cpu")
    load_jax_params(tlm, jlm.get_params())
    load_jax_params(tdraft, jdraft.get_params())
    return {"jax": (jlm, jdraft), "torch": (tlm, tdraft)}


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _traffic():
    return [(_prompt(50 + i, n), m) for i, (n, m) in
            enumerate(zip((3, 20, 9, 31, 14, 6), (9, 5, 12, 7, 10, 8)))]


@pytest.fixture(scope="module")
def jax_spec_engine(models):
    """The module's one JAX engine: the small draft, k = 3, three slots."""
    jlm, jdraft = models["jax"]
    with JaxServingEngine(jlm, MAX_LEN, slots=3, buckets=BUCKETS,
                          draft_model=jdraft, spec_tokens=K) as eng:
        hs = [eng.submit(p, m) for p, m in _traffic()]
        return [np.asarray(h.result(120).tokens) for h in hs], eng.stats()


@pytest.mark.parametrize("draft", ["self", "small"])
def test_decoder_matches_greedy_and_jax_acceptance(models, draft):
    """``SpeculativeDecoder`` on a (4, 8) batch, 20 new tokens: plain
    greedy's tokens, the JAX decoder's tokens, and its counts of rounds,
    proposals and acceptances: 1.0 with the self-draft, near 0 with the
    small one."""
    (jlm, jdraft), (tlm, tdraft) = models["jax"], models["torch"]
    prompt = np.random.default_rng(3).integers(0, VOCAB, (4, 8))
    ours = SpeculativeDecoder(tlm, tlm if draft == "self" else tdraft,
                              spec_tokens=4, device="cpu")
    theirs = JaxSpeculativeDecoder(jlm, jlm if draft == "self" else jdraft,
                                   spec_tokens=4)
    got = ours.generate(prompt, 20)
    np.testing.assert_array_equal(got, theirs.generate(prompt, 20))
    want = tnn.greedy_generate(tlm, prompt, 20, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert ours.stats() == theirs.stats()
    rate = ours.stats()["acceptance_rate"]
    assert rate == 1.0 if draft == "self" else rate < 0.2


def test_eos_inside_an_accepted_block(models):
    """With the self-draft every block is accepted whole; an ``eos_id``
    that greedy emits mid-block stops its row there, the rest of the row
    0, as JAX's decoder does."""
    (jlm, _), (tlm, _) = models["jax"], models["torch"]
    prompt = np.random.default_rng(4).integers(0, VOCAB, (2, 6))
    plain = tnn.greedy_generate(tlm, prompt, 16, device="cpu").numpy()
    eos = int(plain[0, 6 + 6])          # row 0's 7th token: inside block 2
    first = int(np.nonzero(plain[0, 6:] == eos)[0][0])
    got = SpeculativeDecoder(tlm, tlm, spec_tokens=4,
                             device="cpu").generate(prompt, 16, eos_id=eos)
    want = JaxSpeculativeDecoder(jlm, jlm, spec_tokens=4).generate(
        prompt, 16, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :7 + first], plain[0, :7 + first])
    assert not got[0, 7 + first:].any()


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("draft", ["self", "small"])
def test_engine_with_a_draft_serves_plain_tokens(models, jax_spec_engine,
                                                 draft, paged):
    """The engine with a draft, on the slot grid and paged, serves the
    engine without one's tokens bitwise; with the small draft also JAX's
    engine's tokens and acceptance counts. The spec prefill and the spec
    step take the prefill's and the tick's places in the ledger."""
    tlm, tdraft = models["torch"]
    reqs = _traffic()
    kw = dict(pages=16, page_tokens=16) if paged else {}

    def serve(**extra):
        with ServingEngine(tlm, MAX_LEN, slots=3, buckets=BUCKETS,
                           device="cpu", **kw, **extra) as eng:
            out = [h.result(120).tokens for h in
                   [eng.submit(p, m) for p, m in reqs]]
            return out, eng.stats(), eng._programs.keys

    plain, _, _ = serve()
    got, st, keys = serve(draft_model=tlm if draft == "self" else tdraft,
                          spec_tokens=K)
    for p, g in zip(plain, got):
        np.testing.assert_array_equal(g, p)
    assert st["compiled_programs"] <= st["program_grid_bound"]
    assert {k[0] for k in keys} == {
        "serve_prefill_spec", "serve_spec_step",
        "serve_assign_paged_spec" if paged else "serve_assign_spec"}
    if draft == "self":
        assert st["spec_acceptance"] == 1.0
    else:
        want, jst = jax_spec_engine
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert (st["spec_proposed"], st["spec_accepted"]) == (
            jst["spec_proposed"], jst["spec_accepted"])
    assert st["decode_tokens"] == sum(m for _, m in reqs) - len(reqs)
    assert st["pages_used"] == 0


def test_spec_headroom_refused_at_submit(models):
    """A verify chunk writes k + 1 positions past the depth, so a request
    needs ``prompt + max_new_tokens + k <= max_len``."""
    tlm, tdraft = models["torch"]
    with ServingEngine(tlm, MAX_LEN, slots=2, buckets=BUCKETS, device="cpu",
                       draft_model=tdraft, spec_tokens=K) as eng:
        with pytest.raises(ValueError, match="spec_tokens 3"):
            eng.submit(_prompt(60, 40), MAX_LEN - 40 - K + 1)
        p = _prompt(61, 40)
        got = eng.submit(p, MAX_LEN - 40 - K).result(120).tokens
    want = tnn.greedy_generate(tlm, p[None], MAX_LEN - 40 - K, device="cpu")
    np.testing.assert_array_equal(got, want[0].numpy())


def test_engine_without_cuda_refuses_a_cpu_draft(models, monkeypatch):
    """Both models must live where the engine runs."""
    tlm, tdraft = models["torch"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tlm, MAX_LEN, draft_model=tdraft)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpeculativeDecoder(tlm, tdraft)
