"""The port's TransformerLM against the JAX model, on the CPU.

The JAX model's ``get_params()`` tree is copied into the port by path
(``convert.load_jax_params``); both see the same token ids. Log-probs agree
to rtol 1e-4 / atol 1e-5 in fp32 and greedy tokens agree exactly (the
seeded weights leave no near-ties at this size).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.utils.random_generator import RandomGenerator
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.models.transformerlm import TransformerLM

VOCAB, E, HEADS, LAYERS, MAX_LEN = 64, 32, 4, 2, 64


@pytest.fixture(scope="module")
def pair():
    RandomGenerator.set_seed(3)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS,
                           num_layers=LAYERS, max_len=MAX_LEN).evaluate()
    tlm = TransformerLM(VOCAB, E, HEADS, LAYERS, MAX_LEN, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    load_jax_params(tlm, jlm.get_params())
    return jlm, tlm


def test_parameter_paths_equal_the_jax_tree(pair):
    jlm, tlm = pair
    assert sorted(flatten_tree(jlm.get_params())) == \
        sorted(n for n, _ in tlm.named_parameters())


def test_log_probs_match_jax(pair):
    jlm, tlm = pair
    ids = np.random.default_rng(0).integers(0, VOCAB, (2, 20)).astype(np.int32)
    want = np.asarray(jlm.forward(jnp.asarray(ids)))
    with torch.no_grad():
        got = tlm(torch.from_numpy(ids))
    assert got.shape == (2, 20, VOCAB) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_greedy_generate_matches_jax(pair):
    jlm, tlm = pair
    prompt = np.random.default_rng(1).integers(0, VOCAB, (2, 7)).astype(
        np.int32)
    want = np.asarray(jnn.greedy_generate(jlm, jnp.asarray(prompt), 12))
    got = tnn.greedy_generate(tlm, prompt, 12, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_prefill_equals_full_forward(pair):
    """The invariant the serving engine rests on: a cached chunk's
    log-probs are the full forward's."""
    _, tlm = pair
    ids = torch.from_numpy(
        np.random.default_rng(2).integers(0, VOCAB, (1, 23)))
    with torch.no_grad():
        full = tlm(ids)
        state = tnn.install_decode_cache(tlm, 1, MAX_LEN)
        head, state = tlm.run(ids[:, :16], state)
        tail, state = tlm.run(ids[:, 16:], state)
    np.testing.assert_allclose(torch.cat([head, tail], 1).numpy(),
                               full.numpy(), rtol=1e-4, atol=1e-5)
    assert state["1"]["pos_idx"].tolist() == [23]


def test_load_jax_params_refuses_mismatched_trees(pair):
    jlm, tlm = pair
    tree = jlm.get_params()
    missing = {k: v for k, v in tree.items() if k != "0"}
    with pytest.raises(KeyError):
        load_jax_params(tlm, missing)
    extra = dict(tree, extra={"weight": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        load_jax_params(tlm, extra)
    bad = dict(tree, **{"0": {"weight": np.zeros((VOCAB, E + 1),
                                                 np.float32)}})
    with pytest.raises(ValueError):
        load_jax_params(tlm, bad)


def test_decode_cache_longer_than_the_position_table_is_refused(pair):
    _, tlm = pair
    with pytest.raises(ValueError):
        tnn.install_decode_cache(tlm, 1, MAX_LEN + 1)
