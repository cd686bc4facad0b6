"""The arithmetic of the flash backward kernels, emulated on the CPU.

``bigdl_tpu_torch/kernels/csrc/flash_attention_bwd.cu`` runs every product
of both kernels on the tensor cores. This file repeats in torch what they
compute, in the same order: streamed tiles of 64 or 32 rows (bf16, d = 128
takes 32) or 32 or 16 rows (fp32, d = 128 takes 16) from the first, the
ragged last tile zero-padded; per tile S = R0·X0ᵀ and dP = R1·X1ᵀ,
``P = exp2(S·log2(e)/sqrt(d) − lse·log2(e))`` (0 past T and above the
diagonal), ``dS = P∘(dP − D)``, then ``dQ += dS·K`` (dq kernel, keys
streamed) or ``dV += P·dO`` and ``dK += dS·Q`` (dk/dv kernel, queries
streamed), with dQ and dK scaled by 1/sqrt(d) at the end, and

- bf16 inputs: S and dP in fp32, P and dS rounded to bf16 before the
  second products, the results rounded to bf16;
- fp32 inputs: 3xTF32 for all four products, every operand split with the
  kernels' bit mask into ``big`` (low 13 mantissa bits cleared) and
  ``small = tf32(x - big)``, each product
  ``a_big·b_big + a_big·b_small + a_small·b_big``; the second products'
  contraction index (keys or queries) permuted inside each group of 8 on
  both sides, as the kernels store the transposed tiles.

The emulation is held against JAX's backward: ``jax.vjp`` of
``flash_attention(..., force_pallas=True)``, which runs the Pallas forward
and the two Pallas backward kernels in interpret mode at T = 200 and falls
back to the vjp of ``_reference_attention`` at T = 1 and 65, on the same
numpy inputs (bf16 inputs go to JAX as their exact fp32 values, so the
comparison tests the kernels' algorithm and roundings). lse, O and
``D = rowsum(dO∘O)`` come from the port's plain forward, as the wrapper
computes D; O is rounded to bf16 for bf16 inputs, as the forward kernel
stores it. Tolerances are the card's: fp32 2e-4·(max|want| + 1) with
rtol 2e-4, bf16 2e-2·(max|want| + 1) with rtol 2e-2, and for scores near
1e3 (q × 30) fp32 2e-3, as ``tests/test_torch_cuda_kernels.py`` holds the
kernels there. One-pass TF32 misses the fp32 tolerance at those scores.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.kernels.flash_attention import flash_attention as jax_flash
from bigdl_tpu_torch import kernels

LOG2E = 1.4426950408889634
# logical position p of a group of 8 holds row GROUP[p] of the group
GROUP = (0, 2, 4, 6, 1, 3, 5, 7)


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().numpy().view(np.uint32)


def _from_bits(b: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(b.astype(np.uint32).view(np.float32))


def tf32_big(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared (the kernels' bit mask)."""
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


def permutation(n: int) -> torch.Tensor:
    """The order in which a transposed tile stores a contraction index of
    n (a multiple of 8) rows."""
    return torch.tensor([8 * (i // 8) + GROUP[i % 8] for i in range(n)])


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b as the tensor cores compute it: fp32 products of the inputs'
    values ("bf16"), three TF32 products ("3xtf32") or one ("1xtf32")."""
    if mode == "3xtf32":
        (ab, as_), (bb, bs) = split(a), split(b)
        return as_ @ bb + ab @ bs + ab @ bb
    if mode == "1xtf32":
        return tf32_round(a) @ tf32_round(b)
    return a @ b


def second_product(a: torch.Tensor, b: torch.Tensor, mode: str):
    """a @ b over the streamed index, permuted in groups of 8 on both
    sides as the fp32 kernels store it; bf16 rounds a (P or dS) first."""
    if mode == "bf16":
        return a.bfloat16().float() @ b
    perm = permutation(a.shape[-1])
    return matmul(a[..., perm], b[..., perm, :], mode)


def tile_rows(mode: str, d: int) -> int:
    if mode == "bf16":
        return 32 if d == 128 else 64
    return 16 if d == 128 else 32


def emulate(q, k, v, do, lse, delta, causal: bool, mode: str):
    """(dq, dk, dv) in fp32 as the two kernels compute them; q, k, v, do
    (bh, T, d) fp32 holding the inputs' values, lse and delta (bh, T)."""
    bh, t, d = q.shape
    bn = tile_rows(mode, d)
    pad = -t % bn
    padded = [torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (q, k, v, do)]
    qp, kp, vp, dop = padded
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    scale_log2 = torch.tensor(LOG2E / math.sqrt(d), dtype=torch.float32)
    lse2 = torch.nn.functional.pad(lse * LOG2E, (0, pad))
    dd = torch.nn.functional.pad(delta, (0, pad))
    rows = torch.arange(t)
    dq, dk, dv = (torch.zeros(bh, t, d) for _ in range(3))
    for n0 in range(0, t + pad, bn):
        cols = torch.arange(n0, n0 + bn)
        # dq kernel: keys n0.. streamed against every query row
        kt, vt = kp[:, n0:n0 + bn], vp[:, n0:n0 + bn]
        s = matmul(q, kt.transpose(1, 2), mode)
        dp = matmul(do, vt.transpose(1, 2), mode)
        p = torch.exp2(s * scale_log2 - lse2[:, :t, None])
        dead = (cols[None, :] >= t) | (causal & (cols[None, :] > rows[:, None]))
        p = p.masked_fill(dead, 0.0)
        ds = p * (dp - dd[:, :t, None])
        dq += second_product(ds, kt, mode)
        # dk/dv kernel: queries n0.. streamed against every key row
        qt, dot = qp[:, n0:n0 + bn], dop[:, n0:n0 + bn]
        st = matmul(k, qt.transpose(1, 2), mode)
        dpt = matmul(v, dot.transpose(1, 2), mode)
        pt = torch.exp2(st * scale_log2 - lse2[:, None, n0:n0 + bn])
        dead = (cols[None, :] >= t) | (causal & (rows[:, None] > cols[None, :]))
        pt = pt.masked_fill(dead, 0.0)
        dst = pt * (dpt - dd[:, None, n0:n0 + bn])
        dv += second_product(pt, dot, mode)
        dk += second_product(dst, qt, mode)
    return dq * scale, dk * scale, dv


def _inputs(seed, bh, t, d, dtype, q_mul=1.0):
    """q, k, v, dO as numpy fp32 holding the values the kernels see (bf16
    inputs rounded once)."""
    r = np.random.default_rng(seed)
    q, k, v, do = (r.normal(size=(bh, t, d)).astype(np.float32)
                   for _ in range(4))
    q = (q_mul * q).astype(np.float32)
    return [torch.from_numpy(x).to(dtype).float().numpy()
            for x in (q, k, v, do)]


def _jax_grads(q, k, v, do, causal):
    """dq, dk, dv of JAX's flash attention (Pallas kernels in interpret
    mode where T allows them) with output gradient dO."""
    shape = (1,) + q.shape
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal, True),
                     *(jnp.asarray(x.reshape(shape)) for x in (q, k, v)))
    return [np.asarray(g).reshape(q.shape)
            for g in vjp(jnp.asarray(do.reshape(shape)))]


def _emulated(q, k, v, do, causal, mode, dtype):
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = kernels.flash_attention_reference(tq, tk, tv, causal)
    o = o.to(dtype).float()          # the forward kernel stores O in dtype
    delta = (tdo * o).sum(-1)
    grads = emulate(tq, tk, tv, tdo, lse, delta, causal, mode)
    return [g.to(dtype).float().numpy() for g in grads]


def _check(got, want, tol):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(
            g, w, rtol=tol, atol=tol * (float(np.abs(w).max()) + 1.0),
            err_msg=name)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 65, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode", ["3xtf32", "bf16"])
def test_kernel_arithmetic_matches_jax_backward(d, t, causal, mode):
    dtype = torch.float32 if mode == "3xtf32" else torch.bfloat16
    q, k, v, do = _inputs(d * 1000 + t + causal, 2, t, d, dtype)
    got = _emulated(q, k, v, do, causal, mode, dtype)
    _check(got, _jax_grads(q, k, v, do, causal),
           2e-4 if mode == "3xtf32" else 2e-2)


@pytest.mark.parametrize("mode", ["3xtf32", "bf16"])
def test_large_scores_hold_the_tolerance(mode):
    """Scores near 1e3 (q × 30): p comes from the saved lse and stays in
    [0, 1]; the gradients hold the card's large-score tolerance."""
    dtype = torch.float32 if mode == "3xtf32" else torch.bfloat16
    q, k, v, do = _inputs(8, 2, 130, 64, dtype, q_mul=30.0)
    got = _emulated(q, k, v, do, True, mode, dtype)
    _check(got, _jax_grads(q, k, v, do, True),
           2e-3 if mode == "3xtf32" else 2e-2)


def test_one_pass_tf32_misses_the_fp32_tolerance_at_large_scores():
    q, k, v, do = _inputs(8, 2, 130, 64, torch.float32, q_mul=30.0)
    got = _emulated(q, k, v, do, True, "1xtf32", torch.float32)
    want = _jax_grads(q, k, v, do, True)
    worst = max(float((np.abs(g - w) - 2e-3 * np.abs(w)).max()
                      / (np.abs(w).max() + 1.0))
                for g, w in zip(got, want))
    assert worst > 2e-3


@pytest.mark.parametrize("n", [16, 32, 64])
def test_the_group_permutation_matches_the_tf32_fragment(n):
    """Accumulator column 2t (2t+1) of a k-step must land where the tf32
    A fragment reads column t (t+4): the stored order is a bijection that
    maps logical position t to row 2t and t+4 to 2t+1."""
    perm = permutation(n)
    assert sorted(perm.tolist()) == list(range(n))
    for j in range(n // 8):
        for lane_t in range(4):
            assert perm[8 * j + lane_t] == 8 * j + 2 * lane_t
            assert perm[8 * j + lane_t + 4] == 8 * j + 2 * lane_t + 1
