"""The port's kernel modules against the JAX package, on the CPU.

The same numpy inputs (``np.random.default_rng``) go through the JAX
function and its port. On the CPU the port's dispatchers run the kernels'
plain versions (a CUDA kernel has no interpret mode; the CUDA kernels are
held against these plain versions on the GPU by
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``); the JAX side
runs its Pallas kernels in interpret mode, as ``tests/test_pallas_kernels.py``
does. Tolerances: rtol 1e-4 / atol 1e-5 in fp32 (sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.kernels import fused_layer_norm as jax_fused_layer_norm
from bigdl_tpu.kernels.flash_attention import (
    _fa_fwd, _reference_attention, flash_attention as jax_flash_attention,
)
from bigdl_tpu_torch import kernels


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape", [(16, 64), (2, 6, 32), (7, 48)])
def test_layer_norm_matches_jax_pallas(shape):
    r = _rng(sum(shape))
    x = (2 * r.normal(size=shape) + 0.5).astype(np.float32)
    h = shape[-1]
    g = (np.abs(r.normal(size=h)) + 0.5).astype(np.float32)
    b = r.normal(size=h).astype(np.float32)
    want = np.asarray(jax_fused_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                           jnp.asarray(b), 1e-5, True))
    got = kernels.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.from_numpy(b), 1e-5)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_layer_norm_bf16_keeps_dtype_and_fp32_statistics():
    r = _rng(5)
    x = torch.from_numpy(r.normal(size=(4, 96)).astype(np.float32))
    g, b = torch.ones(96), torch.zeros(96)
    out = kernels.fused_layer_norm(x.bfloat16(), g, b)
    assert out.dtype == torch.bfloat16
    ref = kernels.layer_norm_reference(x.bfloat16().float(), g, b)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax_pallas(causal):
    r = _rng(11 + causal)
    q, k, v = (r.normal(size=(2, 2, 64, 16)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(jax_flash_attention(jq, jk, jv, causal, True))
    _, res = _fa_fwd(jq, jk, jv, causal, True)
    want_lse = np.asarray(res[4]).reshape(2, 2, 64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = kernels.flash_attention(tq, tk, tv, causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    o3, lse = kernels.flash_attention_fwd(tq.reshape(4, 64, 16),
                                          tk.reshape(4, 64, 16),
                                          tv.reshape(4, 64, 16), causal)
    np.testing.assert_allclose(lse.reshape(2, 2, 64).numpy(), want_lse,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t", [37, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ragged_t_matches_jax_reference(t, causal):
    """JAX falls back to O(T^2) here; the port masks the ragged tile."""
    r = _rng(t)
    q, k, v = (r.normal(size=(1, 3, t, 32)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(_reference_attention(*map(jnp.asarray, (q, k, v)),
                                           causal))
    got = kernels.flash_attention(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_cpu_dispatch_counts_no_launch():
    before = kernels.launch_counts()
    x = torch.ones(2, 8)
    kernels.fused_layer_norm(x, torch.ones(8), torch.zeros(8))
    kernels.flash_attention(x[None, None], x[None, None], x[None, None])
    assert kernels.launch_counts() == before


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.ones(2, 64)
    with pytest.raises(ValueError):
        kernels.layer_norm_cuda(x, torch.ones(64), torch.zeros(64))
    q = torch.ones(2, 4, 64)
    with pytest.raises(ValueError):
        kernels.flash_attention_cuda(q, q, q, True)
