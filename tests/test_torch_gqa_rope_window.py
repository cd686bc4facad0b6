"""Grouped-query heads, RoPE and the sliding window of the port's
``MultiHeadAttention`` against the JAX package, on the CPU.

Inputs are made with numpy from a seed; weights move across by path. The
JAX side runs as its own tests run it: the flash call falls back to the
plain fused attention off-TPU, and the port's flash wrapper takes its
plain version on CPU tensors. Tolerances: fp32 outputs within 1e-5
absolute and relative (per module and for the cached decode's log-probs);
decoded tokens equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.nn.attention import rope_rotate as jax_rope_rotate
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models.transformerlm import TransformerLM

TOL = dict(rtol=1e-5, atol=1e-5)
E, HEADS, VOCAB = 32, 4, 50


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("positions", ["t", "bt"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_rotate_matches_jax(positions, dtype):
    x = _x(3, 4, 11, 16)
    r = np.random.default_rng(1)
    pos = (np.arange(11) + 5 if positions == "t"
           else r.integers(0, 300, (3, 11))).astype(np.int32)
    want = jax_rope_rotate(jnp.asarray(x).astype(dtype), jnp.asarray(pos))
    got = tnn.rope_rotate(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(pos))
    assert str(got.dtype) == f"torch.{want.dtype}"
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _attention_pair(seed=2, **opts):
    JaxRNG.set_seed(seed)
    jm = jnn.MultiHeadAttention(E, HEADS, causal=True, **opts)
    tm = tnn.MultiHeadAttention(E, HEADS, causal=True, **opts)
    load_jax_params(tm, jm.get_params())
    return jm, tm


_CASES = {
    "gqa2": dict(num_kv_heads=2),
    "mqa": dict(num_kv_heads=1),
    "gqa2-rope": dict(num_kv_heads=2, rope=True),
    "rope": dict(rope=True),
    "window": dict(window=5),
    "gqa2-rope-window": dict(num_kv_heads=2, rope=True, window=4),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_full_sequence_attention_matches_jax(case):
    jm, tm = _attention_pair(**_CASES[case])
    x = _x(2, 13, E, seed=3)
    want = np.asarray(jm.forward(jnp.asarray(x)))
    got = tm.forward(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_attention_gradients_match_jax(case):
    """The backward through the KV expansion sums each KV head's gradient
    over its query group, as ``jnp.repeat``'s transpose does."""
    import jax

    jm, tm = _attention_pair(**_CASES[case])
    x = _x(2, 9, E, seed=4)
    g = _x(2, 9, E, seed=5)

    def jloss(params):
        out, _ = jm.apply(params, jm.get_state(), jnp.asarray(x),
                          training=True, rng=None)
        return (out * jnp.asarray(g)).sum()

    want = jax.grad(jloss)(jm.get_params())
    loss = (tm.forward(torch.from_numpy(x)) * torch.from_numpy(g)).sum()
    names, params = zip(*tm.named_parameters())
    for n, got in zip(names, torch.autograd.grad(loss, params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want[n]),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def test_expand_kv_follows_jnp_repeat():
    _, tm = _attention_pair(num_kv_heads=2)
    kv = torch.arange(2 * 2 * 3 * 8, dtype=torch.float32).reshape(2, 2, 3, 8)
    want = np.repeat(kv.numpy(), HEADS // 2, axis=1)
    np.testing.assert_array_equal(tm._expand_kv(kv).numpy(), want)


@pytest.mark.parametrize("case", ["gqa2-rope-window", "mqa", "rope"])
def test_cached_decode_equals_jax_and_the_full_forward(case):
    """Per-row cached steps (every row at its own depth, JAX's per-slot
    cache) against JAX's and against the full-sequence forward: the cache
    holds kv-head rows, RoPE turns each new position by its absolute
    index, and the window masks the decode too."""
    from bigdl_tpu.nn.incremental import install_decode_cache as jax_install

    jm, tm = _attention_pair(**_CASES[case])
    x = _x(3, 10, E, seed=6)
    jstate = jax_install(jm, 3, 16, per_slot=True)
    tstate = tnn.install_decode_cache(tm, 3, 16)
    kv = tm.kv_heads
    assert tuple(tstate["cache_k"].shape) == (3, kv, 16, E // HEADS)
    outs = []
    with torch.no_grad():
        for c0, c1 in ((0, 4), (4, 5), (5, 10)):
            want, jstate = jm.apply(jm.get_params(), jstate,
                                    jnp.asarray(x[:, c0:c1]))
            got, tstate = tm.run(torch.from_numpy(x[:, c0:c1]), tstate)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            outs.append(got)
        full = tm.forward(torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **TOL)
    assert tstate["pos"].tolist() == [10, 10, 10]


def _llama_pair(window=None, seed=7):
    opts = dict(num_kv_heads=2, position="rope", norm="rms",
                mlp_kind="swiglu")
    JaxRNG.set_seed(seed)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS,
                           num_layers=2, max_len=32, **opts).evaluate()
    tlm = TransformerLM(VOCAB, E, HEADS, 2, 32, device="cpu", **opts)
    load_jax_params(tlm, jlm.get_params())
    if window is not None:    # TransformerLM takes no window: set it
        from bigdl_tpu.nn.incremental import iter_modules
        for m in [*iter_modules(jlm), *tlm.modules()]:
            if isinstance(m, (jnn.MultiHeadAttention,
                              tnn.MultiHeadAttention)):
                m.window = window
    return jlm, tlm


@pytest.mark.parametrize("window", [None, 6])
def test_greedy_decode_with_rope_gqa_and_window_matches_jax(window):
    """A rope + GQA (+ window) language model: the cached decode's
    log-probs equal JAX's within 1e-5 and its greedy tokens equal JAX's."""
    from bigdl_tpu.nn.incremental import install_decode_cache as jax_install

    jlm, tlm = _llama_pair(window)
    prompt = np.random.default_rng(8).integers(0, VOCAB, (2, 5)).astype(
        np.int32)
    want = np.asarray(jnn.greedy_generate(jlm, jnp.asarray(prompt), 14))
    got = tnn.greedy_generate(tlm, prompt, 14, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    # the log-probs of every cached step
    jstate = jax_install(jlm, 2, 19, per_slot=True)
    tstate = tnn.install_decode_cache(tlm, 2, 19)
    assert not any("pos_idx" in str(k) for k in _keys(tstate))
    with torch.no_grad():
        for i in range(18):
            tok = want[:, i:i + 1]
            jlp, jstate = jlm.apply(jlm.get_params(), jstate,
                                    jnp.asarray(tok))
            tlp, tstate = tlm.run(torch.tensor(tok, dtype=torch.long),
                                  tstate)
            np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **TOL)


def _keys(tree, prefix=""):
    for k, v in tree.items():
        yield prefix + k
        if isinstance(v, dict):
            yield from _keys(v, prefix + k + ".")


def test_attention_options_are_checked_as_in_jax():
    with pytest.raises(ValueError, match="divisor"):
        tnn.MultiHeadAttention(E, HEADS, causal=True, num_kv_heads=3)
    with pytest.raises(ValueError, match="causal"):
        tnn.MultiHeadAttention(E, HEADS, window=4)
    with pytest.raises(ValueError, match=">= 1"):
        tnn.MultiHeadAttention(E, HEADS, causal=True, window=0)
    with pytest.raises(ValueError, match="even head_dim"):
        tnn.MultiHeadAttention(12, 4, causal=True, rope=True)
