"""The arithmetic of the flash forward kernel, emulated on the CPU.

``bigdl_tpu_torch/kernels/csrc/flash_attention.cu`` runs both products on
the tensor cores. This file repeats in torch what it computes, in the same
order: key tiles of 64 (bf16) or 32 (fp32) keys from the first, the online
softmax in log2 units (scores times ``log2(e)/sqrt(d)``, one ``exp2`` per
score, masked keys at -inf), then

- bf16 inputs: fp32 scores, P rounded to bf16 before P·V, fp32 row sums;
- fp32 inputs: 3xTF32, every operand split with the kernel's bit mask into
  ``big`` (low 13 mantissa bits cleared) and ``small = tf32(x - big)``
  (round to nearest, ties away), each product
  ``a_big·b_big + a_big·b_small + a_small·b_big``.

The emulation is held against JAX's plain attention
(``bigdl_tpu/kernels/flash_attention.py`` ``_reference_attention``, and the
logsumexp of the same scores) at the tolerances the card is held to: fp32
2e-4, bf16 2e-2, and for scores near 1e3 the lse within
2e-3 + 2e-5·|lse|. bf16 inputs go to JAX as their exact fp32 values, so the
comparison tests the kernel's algorithm and roundings, not JAX's bf16
einsum. One-pass TF32 misses the fp32 tolerance at large scores, which is
why the kernel takes three passes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.kernels.flash_attention import _reference_attention

LOG2E = 1.4426950408889634


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().numpy().view(np.uint32)


def _from_bits(b: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(b.astype(np.uint32).view(np.float32))


def tf32_big(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared (the kernel's bit mask)."""
    return _from_bits(_bits(x) & np.uint32(0xFFFFE000))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    b = _bits(x).astype(np.uint64)
    sign, mag = b & 0x80000000, b & 0x7FFFFFFF
    mag = (mag + 0x1000) & ~np.uint64(0x1FFF)
    return _from_bits((sign | mag) & 0xFFFFFFFF)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32_big(x)
    return big, tf32_round(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (ab, as_), (bb, bs) = split(a), split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_round(a) @ tf32_round(b)


def emulate(q, k, v, causal: bool, mode: str):
    """(O, lse) as the kernel computes them; q, k, v (bh, T, d) fp32 holding
    the inputs' values. mode: "bf16", "3xtf32" or "1xtf32"."""
    bn = 64 if mode == "bf16" else 32
    mm = {"bf16": torch.matmul, "3xtf32": mm_3xtf32,
          "1xtf32": mm_1xtf32}[mode]
    bh, t, d = q.shape
    scale_log2 = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    m = torch.full((bh, t), -math.inf)
    l = torch.zeros(bh, t)
    acc = torch.zeros(bh, t, d)
    rows = torch.arange(t)
    for n0 in range(0, t, bn):
        kt, vt = k[:, n0:n0 + bn], v[:, n0:n0 + bn]
        x = mm(q, kt.transpose(1, 2)) * scale_log2
        if causal:
            keys = torch.arange(n0, n0 + kt.shape[1])
            x = x.masked_fill(keys[None, :] > rows[:, None], -math.inf)
        mx = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(x - mx[..., None])
        l = l * alpha + p.sum(-1)
        pv_p = p.bfloat16().float() if mode == "bf16" else p
        acc = acc * alpha[..., None] + mm(pv_p, vt)
        m = mx
    denom = l.clamp(min=1e-37)
    return acc / denom[..., None], m * math.log(2.0) + torch.log(denom)


def jax_reference(q, k, v, causal: bool):
    """JAX's plain attention and the logsumexp of its scaled scores."""
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o = _reference_attention(jq, jk, jv, causal)
    s = jnp.einsum("...qd,...kd->...qk", jq, jk) / jnp.sqrt(
        jnp.asarray(q.shape[-1], jnp.float32))
    if causal:
        t = q.shape[-2]
        s = jnp.where(jnp.tril(jnp.ones((t, t), bool)), s, -jnp.inf)
    return np.asarray(o), np.asarray(jax.nn.logsumexp(s, axis=-1))


def _inputs(seed, bh, t, d, dtype, qk_mul=1.0):
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=(bh, t, d)).astype(np.float32) for _ in range(3))
    q, k = qk_mul * q, qk_mul * k
    # the values the kernel sees: bf16 inputs rounded once, then exact
    return [torch.from_numpy(x).to(dtype).float().numpy() for x in (q, k, v)]


def _check(mode, q, k, v, causal, atol, rtol, lse_tol):
    o, lse = emulate(*map(torch.from_numpy, (q, k, v)), causal, mode)
    if mode == "bf16":
        o = o.bfloat16().float()       # the kernel stores O in bf16
    want_o, want_lse = jax_reference(q, k, v, causal)
    np.testing.assert_allclose(o.numpy(), want_o, atol=atol, rtol=rtol)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=lse_tol[0],
                               rtol=lse_tol[1])


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 65, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", ["3xtf32", "bf16"])
def test_kernel_arithmetic_matches_jax_reference(d, t, causal, mode):
    dtype = torch.float32 if mode == "3xtf32" else torch.bfloat16
    q, k, v = _inputs(d * 1000 + t, 2, t, d, dtype)
    tol = (2e-4, 2e-4) if mode == "3xtf32" else (2e-2, 0.0)
    _check(mode, q, k, v, causal, *tol, lse_tol=tol)


@pytest.mark.parametrize("mode", ["3xtf32", "bf16"])
def test_large_scores_hold_the_lse_tolerance(mode):
    """Scores near 1e3 (q, k times 30): lse within 2e-3 + 2e-5·|lse|. O is
    held to 2e-3 in fp32: there the scores carry ~1e-3 of fp32 rounding
    into p, and two fp32 implementations of plain attention (torch's and
    JAX's, on these inputs) already differ by 8.6e-4 in O."""
    dtype = torch.float32 if mode == "3xtf32" else torch.bfloat16
    q, k, v = _inputs(7, 2, 130, 64, dtype, qk_mul=30.0)
    tol = (2e-3, 2e-4) if mode == "3xtf32" else (2e-2, 0.0)
    _check(mode, q, k, v, True, *tol, lse_tol=(2e-3, 2e-5))


def test_one_pass_tf32_misses_the_fp32_tolerance_at_large_scores():
    q, k, v = _inputs(7, 2, 130, 64, torch.float32, qk_mul=30.0)
    o, lse = emulate(*map(torch.from_numpy, (q, k, v)), True, "1xtf32")
    want_o, want_lse = jax_reference(q, k, v, True)
    lse_err = np.abs(lse.numpy() - want_lse) - 2e-5 * np.abs(want_lse)
    o_err = np.abs(o.numpy() - want_o) - 2e-4 * np.abs(want_o)
    assert lse_err.max() > 2e-3 or o_err.max() > 2e-4
    # ... by far: scores carry ~2^-11 of their size in error
    assert lse_err.max() > 2e-2


def test_split_is_exact_in_tf32_pieces():
    r = np.random.default_rng(3)
    x = torch.from_numpy((r.normal(size=4096) * 10.0 ** r.integers(
        -20, 20, 4096)).astype(np.float32))
    big, small = split(x)
    for part in (big, small):
        assert (_bits(part) & 0x1FFF == 0).all()   # nothing below tf32
    rel = ((big.double() + small.double() - x.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -21
