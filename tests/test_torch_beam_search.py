"""Beam search of the port against the JAX package, on the CPU:
``SequenceBeamSearch`` (the static padded block, a full forward a step),
``beam_generate`` (the KV-cached form, cache rows gathered after their
parent beams in place), ``greedy_decode`` and sampled ``generate``.

Models are small llama-style and GPT-style TransformerLMs with weights
moved across by path; prompts come from a numpy seed; the EOS cases take
the greedy continuation's third token as EOS, so the finished pool fills
in the first prompt row. Sequences equal JAX's, scores within 1e-5
(absolute and relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.nn.incremental import beam_generate as jax_beam_generate
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models.transformerlm import TransformerLM

VOCAB, E, HEADS = 50, 32, 4
TOL = dict(rtol=1e-5, atol=1e-5)
LLAMA = dict(num_kv_heads=2, position="rope", norm="rms", mlp_kind="swiglu",
             fused_head=True)


def _pair(opts, seed=9):
    JaxRNG.set_seed(seed)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS, num_layers=2,
                           max_len=32, **opts).evaluate()
    tlm = TransformerLM(VOCAB, E, HEADS, 2, 32, device="cpu", **opts)
    load_jax_params(tlm, jlm.get_params())
    return jlm, tlm


def _prompt(n=2, t0=6, seed=10):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, t0)).astype(
        np.int32)


_SEARCHES = {
    "beam3-no-eos": dict(beam=3, eos=False, alpha=0.6),
    "beam2-eos": dict(beam=2, eos=True, alpha=0.6, pad=1),
    "beam4-alpha0": dict(beam=4, eos=True, alpha=0.0),
}


def _eos_for(jlm, prompt, case):
    """An EOS id that the beams meet: the greedy continuation's third
    token, so the finished pool fills; -1 (none) without EOS."""
    if not case["eos"]:
        return -1
    seq = np.asarray(jnn.greedy_generate(jlm, jnp.asarray(prompt), 3))
    return int(seq[0, -1])


@pytest.mark.parametrize("model", ["llama", "gpt"])
@pytest.mark.parametrize("case", sorted(_SEARCHES))
def test_sequence_beam_search_matches_jax(model, case):
    c = _SEARCHES[case]
    jlm, tlm = _pair(LLAMA if model == "llama" else {})
    prompt = _prompt()
    eos = _eos_for(jlm, prompt, c)
    want = jnn.SequenceBeamSearch(jlm, c["beam"], eos, 8, c["alpha"],
                                  c.get("pad", 0)).evaluate().forward(
        jnp.asarray(prompt))
    tbs = tnn.SequenceBeamSearch(tlm, c["beam"], eos, 8, c["alpha"],
                                 c.get("pad", 0))
    got = tbs.forward(prompt)
    assert got[1].dtype == torch.int32
    assert tuple(got[1].shape) == (2, c["beam"], 14)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)
    assert tlm.training       # the decoder's mode is given back


@pytest.mark.parametrize("case", sorted(_SEARCHES))
def test_beam_generate_matches_jax_and_the_static_search(case):
    c = _SEARCHES[case]
    jlm, tlm = _pair(LLAMA)
    prompt = _prompt(t0=5, seed=11)
    eos = _eos_for(jlm, prompt, c)
    want = jax_beam_generate(jlm, jnp.asarray(prompt), 9, c["beam"], eos,
                             c["alpha"], c.get("pad", 0))
    seqs, scores = tnn.beam_generate(tlm, prompt, 9, c["beam"], eos,
                                     c["alpha"], c.get("pad", 0),
                                     device="cpu")
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[1]), **TOL)
    static = tnn.SequenceBeamSearch(tlm, c["beam"], eos, 9, c["alpha"],
                                    c.get("pad", 0)).forward(prompt)
    np.testing.assert_array_equal(seqs.numpy(), static[1].numpy())
    np.testing.assert_allclose(scores.numpy(), static[2].numpy(), **TOL)


def test_beam_generate_reorders_the_cache_in_place(monkeypatch):
    """Every cached step of every layer reads and writes the K/V tensors
    ``install_decode_cache`` made (kv-head rows), while the beams
    reorder: the gather after the parents is in place."""
    _, tlm = _pair(LLAMA)
    seen = []
    decode_step = tnn.MultiHeadAttention._decode_step

    def spy(self, state, q, k, v):
        seen.append((state["cache_k"].data_ptr(),
                     state["cache_v"].data_ptr(),
                     tuple(state["cache_k"].shape)))
        return decode_step(self, state, q, k, v)

    monkeypatch.setattr(tnn.MultiHeadAttention, "_decode_step", spy)
    tnn.beam_generate(tlm, _prompt(t0=4), 6, 3, device="cpu")
    assert len(seen) == 2 * 9                 # 2 layers, 4 + 6 - 1 steps
    assert set(seen[0::2]) == {seen[0]} and set(seen[1::2]) == {seen[1]}
    assert seen[0][2] == (2 * 3, 2, 10, E // HEADS)     # kv-head rows


def test_greedy_decode_matches_jax_and_greedy_generate():
    jlm, tlm = _pair(LLAMA)
    prompt = _prompt(seed=12)
    want = jnn.greedy_decode(jlm, jnp.asarray(prompt), 7)
    seqs, scores = tnn.greedy_decode(tlm, prompt, 7, device="cpu")
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_array_equal(
        seqs.numpy(), tnn.greedy_generate(tlm, prompt, 7,
                                          device="cpu").numpy())


def test_sampled_generate_is_seeded_and_keeps_the_prompt():
    _, tlm = _pair(LLAMA)
    prompt = _prompt(seed=13)
    draws = [tnn.generate(tlm, prompt, 10, sample=True, temperature=0.8,
                          top_k=5, generator=torch.Generator()
                          .manual_seed(s), device="cpu") for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    for d in draws:
        np.testing.assert_array_equal(d[:, :6].numpy(), prompt)
    with pytest.raises(ValueError):
        tnn.generate(tlm, prompt, 2, sample=True, top_k=0, device="cpu")
