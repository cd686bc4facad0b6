"""The port's MultiHeadAttention against the JAX layer, on the CPU.

Same numpy weights in both (biases random, not the zero init), same numpy
inputs. Covers the full-sequence call through ``_attend`` (the flash path,
which on CPU tensors runs its plain version, and ``attention_impl="full"``)
and the per-slot KV-cached step: a chunked prefill at row-specific depths
followed by single-token decode steps. fp32, rtol 1e-4 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.convert import load_jax_params

E, H = 32, 4


def _pair(attention_impl, seed=0):
    r = np.random.default_rng(seed)
    params = {
        "qkv_weight": r.normal(0, 0.2, (3 * E, E)).astype(np.float32),
        "qkv_bias": r.normal(0, 0.1, (3 * E,)).astype(np.float32),
        "out_weight": r.normal(0, 0.2, (E, E)).astype(np.float32),
        "out_bias": r.normal(0, 0.1, (E,)).astype(np.float32),
    }
    jm = jnn.MultiHeadAttention(E, H, causal=True,
                                attention_impl=attention_impl)
    jm.set_params({k: jnp.asarray(v) for k, v in params.items()})
    tm = tnn.MultiHeadAttention(E, H, causal=True,
                                attention_impl=attention_impl)
    load_jax_params(tm, params)
    return jm, tm, params


@pytest.mark.parametrize("impl", ["auto", "flash", "full"])
def test_full_sequence_matches_jax(impl):
    jm, tm, params = _pair(impl)
    x = np.random.default_rng(1).normal(size=(2, 19, E)).astype(np.float32)
    want, _ = jm.apply({k: jnp.asarray(v) for k, v in params.items()}, {},
                       jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_cached_per_slot_steps_match_jax():
    jm, tm, params = _pair("auto", seed=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    b, lmax = 3, 24
    jstate = jnn.install_decode_cache(jm, b, lmax, per_slot=True)
    jnn.clear_decode_cache(jm)
    tstate = tnn.install_decode_cache(tm, b, lmax)
    depth = np.array([0, 3, 7], np.int32)          # every row at its own depth
    jstate["pos"] = jnp.asarray(depth)
    tstate["pos"] = torch.from_numpy(depth.astype(np.int64))
    r = np.random.default_rng(3)
    for t in (5, 1, 1, 2):                        # chunked prefill, then decode
        x = r.normal(size=(b, t, E)).astype(np.float32)
        want, jstate = jm.apply(jp, jstate, jnp.asarray(x))
        with torch.no_grad():
            got, tstate = tm.run(torch.from_numpy(x), tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tstate["pos"].numpy(),
                                  np.asarray(jstate["pos"]))
    np.testing.assert_allclose(tstate["cache_k"].numpy(),
                               np.asarray(jstate["cache_k"]),
                               rtol=1e-4, atol=1e-5)


def test_cached_write_clamps_like_dynamic_update_slice():
    """An idle row whose position ran past the cache stays in bounds."""
    jm, tm, params = _pair("auto", seed=4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jnn.install_decode_cache(jm, 2, 8, per_slot=True)
    jnn.clear_decode_cache(jm)
    tstate = tnn.install_decode_cache(tm, 2, 8)
    jstate["pos"] = jnp.asarray(np.array([2, 11], np.int32))
    tstate["pos"] = torch.tensor([2, 11])
    x = np.random.default_rng(5).normal(size=(2, 1, E)).astype(np.float32)
    want, jstate = jm.apply(jp, jstate, jnp.asarray(x))
    with torch.no_grad():
        got, tstate = tm.run(torch.from_numpy(x), tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tstate["cache_v"].numpy(),
                               np.asarray(jstate["cache_v"]),
                               rtol=1e-4, atol=1e-5)


def test_constructor_rejects_unported_options():
    with pytest.raises(ValueError):
        tnn.MultiHeadAttention(E, H, attention_impl="ring")
    with pytest.raises(ValueError):
        tnn.MultiHeadAttention(E, 5)
