"""Gradients of the port's flash attention and LayerNorm against the JAX
package, on the CPU.

The same numpy inputs (``np.random.default_rng``) go through both. On the
JAX side ``jax.grad`` of ``flash_attention(..., force_pallas=True)`` runs
the Pallas forward and the two Pallas backward kernels in interpret mode,
as ``tests/test_pallas_kernels.py`` does; at odd T, where JAX falls back to
its O(T^2) reference, the port is held to ``jax.vjp`` of
``_reference_attention``. On the port's side the CPU tensors take the
plain versions (``flash_attention_bwd_reference``, and through
``FlashAttention`` under ``torch.autograd.grad``); the CUDA kernels are held
against these plain versions on the GPU by ``tests/test_torch_cuda_kernels.py``
and ``chip_smoke.py``. Tolerances: rtol 1e-4 / atol 1e-5 in fp32 (sums in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.kernels import fused_layer_norm as jax_fused_layer_norm
from bigdl_tpu.kernels.flash_attention import (
    _reference_attention, flash_attention as jax_flash_attention,
)
from bigdl_tpu_torch import kernels

RTOL, ATOL = 1e-4, 1e-5


def _inputs(shape, seed, q_mul=1.0):
    r = np.random.default_rng(seed)
    q, k, v, w = (r.normal(size=shape).astype(np.float32) for _ in range(4))
    return (q_mul * q).astype(np.float32), k, v, w


def _jax_grads(fn, q, k, v, w):
    """Gradients of sum(fn(q, k, v) * w) — the output gradient is w."""
    return jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * w),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _port_plain_grads(q, k, v, w, causal):
    b, h, t, d = q.shape
    q3, k3, v3, w3 = (torch.from_numpy(x).reshape(b * h, t, d)
                      for x in (q, k, v, w))
    o, lse = kernels.flash_attention_fwd(q3, k3, v3, causal)
    grads = kernels.flash_attention_bwd(q3, k3, v3, o, lse, w3, causal)
    return [g.reshape(b, h, t, d).numpy() for g in grads]


def _port_autograd_grads(q, k, v, w, causal):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = kernels.flash_attention(tq, tk, tv, causal)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    return [g.numpy() for g in grads]


def _assert_all_close(got, want):
    for name, g, x in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, np.asarray(x), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(2, 2, 32, 16), (1, 2, 64, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("route", ["plain", "autograd"])
def test_flash_grads_match_jax_pallas(shape, causal, route):
    q, k, v, w = _inputs(shape, sum(shape) + causal)
    want = _jax_grads(lambda a, b, c: jax_flash_attention(a, b, c, causal,
                                                          True), q, k, v, w)
    port = _port_plain_grads if route == "plain" else _port_autograd_grads
    _assert_all_close(port(q, k, v, w, causal), want)


@pytest.mark.parametrize("route", ["plain", "autograd"])
def test_flash_grads_large_scores_stay_finite(route):
    """q × 30 puts scores near 1e2: p must come from the saved lse, never
    from an overflowing exp."""
    q, k, v, w = _inputs((1, 2, 32, 16), 4, q_mul=30.0)
    want = _jax_grads(lambda a, b, c: jax_flash_attention(a, b, c, True,
                                                          True), q, k, v, w)
    port = _port_plain_grads if route == "plain" else _port_autograd_grads
    got = port(q, k, v, w, True)
    assert all(np.isfinite(g).all() for g in got)
    # dk = Σ ds·q grows with q (|dk| ~ 30 here): hold each gradient to
    # 1e-5 of its own largest entry, rtol 1e-4
    for g, x in zip(got, want):
        x = np.asarray(x)
        np.testing.assert_allclose(g, x, rtol=RTOL,
                                   atol=ATOL * float(np.abs(x).max()))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grads_odd_t_match_jax_reference(causal):
    """JAX falls back to the reference VJP at T = 15; the port masks."""
    q, k, v, w = _inputs((1, 2, 15, 16), 15 + causal)
    want = _jax_grads(lambda a, b, c: _reference_attention(a, b, c, causal),
                      q, k, v, w)
    _assert_all_close(_port_plain_grads(q, k, v, w, causal), want)
    _assert_all_close(_port_autograd_grads(q, k, v, w, causal), want)


def test_flash_backward_keeps_the_input_dtype():
    r = np.random.default_rng(2)
    q, k, v, do = (torch.from_numpy(r.normal(size=(2, 9, 32))
                                    .astype(np.float32)).bfloat16()
                   for _ in range(4))
    o, lse = kernels.flash_attention_fwd(q, k, v, True)
    grads = kernels.flash_attention_bwd(q, k, v, o, lse, do, True)
    assert all(g.dtype == torch.bfloat16 and g.shape == q.shape
               for g in grads)


@pytest.mark.parametrize("shape", [(16, 64), (2, 6, 32), (7, 48)])
def test_layer_norm_grads_match_jax(shape):
    r = np.random.default_rng(sum(shape) + 1)
    x = (2 * r.normal(size=shape) + 0.5).astype(np.float32)
    h = shape[-1]
    g = (np.abs(r.normal(size=h)) + 0.5).astype(np.float32)
    b = r.normal(size=h).astype(np.float32)
    ct = r.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(lambda xx, gg, bb: jax_fused_layer_norm(xx, gg, bb, 1e-5,
                                                            True),
                     *map(jnp.asarray, (x, g, b)))
    want = vjp(jnp.asarray(ct))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    out = kernels.fused_layer_norm(tx, tg, tb, 1e-5)
    got = torch.autograd.grad(out, (tx, tg, tb), torch.from_numpy(ct))
    for name, a, e in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    closed = kernels.layer_norm_backward(torch.from_numpy(x),
                                         torch.from_numpy(g), 1e-5,
                                         torch.from_numpy(ct))
    for a, e in zip(closed, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=RTOL,
                                   atol=ATOL)


def test_cpu_backward_counts_no_launch():
    before = kernels.launch_counts()
    x = torch.ones(1, 1, 8, 32, requires_grad=True)
    kernels.flash_attention(x, x, x, True).sum().backward()
    kernels.fused_layer_norm(x, torch.ones(32, requires_grad=True),
                             torch.zeros(32)).sum().backward()
    assert x.grad is not None
    assert kernels.launch_counts() == before
    assert "layer_norm_bwd" in before


def test_backward_cuda_wrappers_refuse_cpu_tensors():
    q = torch.ones(2, 4, 64)
    lse = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        kernels.flash_attention_bwd_cuda(q, q, q, q, lse, q, True)
    with pytest.raises(ValueError):
        kernels.flash_attention_bwd_dq_cuda(q, q, q, q, lse, lse, True)
    with pytest.raises(ValueError):
        kernels.flash_attention_bwd_dkv_cuda(q, q, q, q, lse, lse, True)
