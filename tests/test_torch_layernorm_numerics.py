"""The arithmetic of the LayerNorm backward kernel, emulated on the CPU.

``bigdl_tpu_torch/kernels/csrc/layernorm.cu`` launches the plan that
``layer_norm_bwd_plan`` (``bigdl_tpu_torch/kernels/layernorm.py``) chooses,
and this file emulates that same plan: one warp per row for H <= 1024
(lane l holds the chunks l + 32·j of 4 fp32 or 8 bf16 elements, or of 1
element when H or the pointers do not allow 128-bit loads), one CTA of 1024
threads per row for wider rows (thread t holds the columns t + 1024·j).
This file repeats in torch what the backward kernel computes, in its order:

- each thread sums its values in chunk order, a warp adds its lanes with
  the xor butterfly (16, 8, 4, 2, 1), a CTA adds its warps in warp order;
- mean, the mean of squared deviations (zero past the row), inv, then
  ``Σ gx`` and ``Σ gx·xhat`` the same way, and
  ``dx = inv·(gx − mean(gx) − xhat·mean(gx·xhat))``;
- dgamma and dbeta: warp w of CTA b takes rows b·8 + w, then every
  ``ctas``·8 rows (one CTA per row, striding by ``ctas``, for wide rows);
  each thread adds g·xhat and g for its columns in row order, the CTA adds
  its 8 warps in warp order into one partial row, and the column sum takes
  the partial rows b ≡ k (mod 8) in order for each k, then adds the 8
  sums in order.

The kernel contracts some products and sums into fused multiply-adds; the
emulation rounds each operation apart, so it follows the kernel's order but
not its last bits.

The emulation is held against JAX's backward: ``jax.vjp`` of
``fused_layer_norm(..., force_pallas=True)``, whose forward runs the Pallas
kernel in interpret mode and whose backward is ``_fln_bwd``, on the same
numpy inputs, at rtol 1e-4 / atol 1e-5 in fp32. At a bf16 input JAX's
``_reference_layer_norm`` computes in bf16
(``bigdl_tpu/kernels/layernorm.py:24-28``) while the kernel computes in fp32
from the bf16 values, so the bf16 case is held to JAX's fp32 backward on
the bf16-rounded inputs: dx, rounded to bf16 by the kernel, within atol
2e-2 (a few bf16 ulps at unit scale), dgamma and dbeta (fp32) within
rtol 1e-4 / atol 1e-5. It is also held to the port's plain
``layer_norm_backward`` (fp32 statistics, dx rounded to bf16) at atol 2e-2.

With bf16 gamma and beta (the mixed-precision step casts them with x) the
kernels convert them to fp32 on load, as the Pallas kernel promotes its
bf16 ``g_ref``, and round dgamma and dbeta once to bf16 at the end. The
port's plain forward is held to JAX's Pallas forward in interpret mode on
the same bf16 operands at atol 2e-2 (a bf16 ulp at unit scale is 2^-8);
the emulated backward to JAX's fp32 backward on the bf16-rounded operands,
rounded to bf16 (dx atol 2e-2, dgamma and dbeta within rtol 2^-7, one bf16
ulp), and to JAX's own bf16 VJP, which sums in bf16, within
2e-2·(max|want| + 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.kernels import fused_layer_norm as jax_fused_layer_norm
from bigdl_tpu_torch import kernels
from bigdl_tpu_torch.kernels.layernorm import (
    BwdPlan, layer_norm_bwd_plan, layer_norm_grad,
)

RTOL, ATOL = 1e-4, 1e-5
EPS = 1e-5
H100_SMS = 132        # the card's SM count, an input of the plan


def thread_values(a: torch.Tensor, threads: int, nv: int,
                  vec: int) -> torch.Tensor:
    """(rows, threads, nv·vec): thread t's values of each row in the order
    it holds them (chunk t + threads·j, element e), zero past the row."""
    n, h = a.shape
    padded = torch.zeros(n, threads * nv * vec, dtype=a.dtype)
    padded[:, :h] = a
    return (padded.view(n, nv, threads, vec).permute(0, 2, 1, 3)
            .reshape(n, threads, nv * vec))


def from_thread_values(v: torch.Tensor, h: int, nv: int,
                       vec: int) -> torch.Tensor:
    n, threads, _ = v.shape
    return (v.view(n, threads, nv, vec).permute(0, 2, 1, 3)
            .reshape(n, -1)[:, :h])


def row_sum(v: torch.Tensor) -> torch.Tensor:
    """(rows, threads, k) -> (rows,): each thread's values in order, the
    warp's butterfly, then the warps in order."""
    s = v[:, :, 0].clone()
    for k in range(1, v.shape[2]):
        s = s + v[:, :, k]
    n, threads = s.shape
    lanes = s.view(n, threads // 32, 32)
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, :, idx ^ o]
    total = lanes[:, 0, 0]
    for w in range(1, threads // 32):
        total = total + lanes[:, w, 0]
    return total


def emulate_backward(x: torch.Tensor, gamma: torch.Tensor, g: torch.Tensor,
                     plan: BwdPlan):
    """(dx, dgamma, dbeta) in the kernel's order of operations under
    ``plan``."""
    n, h = x.shape
    threads, vec = plan.threads, plan.vec
    # the loop path's threads hold columns t + threads·j, j < nv
    nv = plan.chunks or -(-h // threads)
    xv = thread_values(x.float(), threads, nv, vec)
    gv = thread_values(g.float(), threads, nv, vec)
    gam = thread_values(gamma[None].float(), threads, nv, vec)
    live = thread_values(torch.ones(1, h), threads, nv, vec) > 0
    mean = row_sum(xv) / h
    d = torch.where(live, xv - mean[:, None, None], torch.zeros(()))
    inv = torch.rsqrt(row_sum(d * d) / h + EPS)
    xh = (xv - mean[:, None, None]) * inv[:, None, None]
    gx = gv * gam
    ma = row_sum(gx) / h
    mb = row_sum(gx * xh) / h
    dxv = inv[:, None, None] * (gx - ma[:, None, None]
                                - xh * mb[:, None, None])
    dx = from_thread_values(dxv, h, nv, vec).to(x.dtype)

    # per-row contributions to each column, in the threads' layout
    pg = from_thread_values(gv * xh, h, nv, vec)
    pb = from_thread_values(gv, h, nv, vec)
    ctas, warps = plan.ctas, plan.rows_per_cta
    stride = ctas * warps
    k_rows = -(-n // stride)
    partial = []
    for part in (pg, pb):
        padded = torch.zeros(k_rows * stride, h)
        padded[:n] = part
        acc = padded.view(k_rows, ctas, warps, h)
        run = acc[0].clone()
        for k in range(1, k_rows):
            run = run + acc[k]
        cta = run[:, 0].clone()
        for w in range(1, warps):
            cta = cta + run[:, w]
        partial.append(cta)
    ws = torch.cat(partial, dim=1)                       # (ctas, 2h)
    sums = []
    for k in range(plan.reduce_warps):
        s = torch.zeros(2 * h)
        for b in range(k, ctas, plan.reduce_warps):
            s = s + ws[b]
        sums.append(s)
    out = sums[0]
    for k in range(1, plan.reduce_warps):
        out = out + sums[k]
    return dx, out[:h], out[h:]


def _inputs(n, h, seed):
    r = np.random.default_rng(seed)
    x = (2 * r.normal(size=(n, h)) + 0.5).astype(np.float32)
    gamma = (1 + 0.1 * r.normal(size=h)).astype(np.float32)
    beta = (0.1 * r.normal(size=h)).astype(np.float32)
    ct = r.normal(size=(n, h)).astype(np.float32)
    return x, gamma, beta, ct


def _jax_backward(x, gamma, beta, ct):
    _, vjp = jax.vjp(lambda a, b, c: jax_fused_layer_norm(a, b, c, EPS, True),
                     *map(jnp.asarray, (x, gamma, beta)))
    return [np.asarray(a) for a in vjp(jnp.asarray(ct))]


SHAPES = [(512, 512), (300, 1000), (7, 31), (4, 4096)]


@pytest.mark.parametrize("n,h", SHAPES)
@pytest.mark.parametrize("vectors", [True, False])
@pytest.mark.parametrize("ctas", ["h100", 3])
def test_emulated_backward_matches_jax(n, h, vectors, ctas):
    x, gamma, beta, ct = _inputs(n, h, n + h)
    vec = 4 if vectors and h % 4 == 0 else 1
    plan = layer_norm_bwd_plan(n, h, vec, H100_SMS)
    if ctas != "h100":
        plan = plan._replace(ctas=ctas)
    got = emulate_backward(torch.from_numpy(x), torch.from_numpy(gamma),
                           torch.from_numpy(ct), plan)
    want = _jax_backward(x, gamma, beta, ct)
    for name, a, e in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a.numpy(), e, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def _bf16_case(n, h):
    x, gamma, beta, ct = _inputs(n, h, n * h)
    xb = torch.from_numpy(x).bfloat16()
    gb = torch.from_numpy(ct).bfloat16()
    tg = torch.from_numpy(gamma)
    plan = layer_norm_bwd_plan(n, h, 8 if h % 8 == 0 else 1, H100_SMS)
    got = emulate_backward(xb, tg, gb, plan)
    assert got[0].dtype == torch.bfloat16
    return xb, gb, tg, beta, got


@pytest.mark.parametrize("n,h", SHAPES)
def test_emulated_backward_bf16_matches_jax(n, h):
    """JAX's fp32 backward on the bf16-rounded inputs."""
    xb, gb, tg, beta, got = _bf16_case(n, h)
    want = _jax_backward(xb.float().numpy(), tg.numpy(), beta,
                         gb.float().numpy())
    np.testing.assert_allclose(got[0].float().numpy(), want[0], rtol=0.0,
                               atol=2e-2, err_msg="dx")
    for name, a, e in zip(("dgamma", "dbeta"), got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), e, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("n,h", SHAPES)
def test_emulated_backward_bf16_matches_plain(n, h):
    xb, gb, tg, _, got = _bf16_case(n, h)
    want = kernels.layer_norm_backward(xb, tg, EPS, gb)
    for a, e in zip(got, want):
        torch.testing.assert_close(a.float(), e.float(), atol=2e-2, rtol=0.0)


def _bf16_params_case(n, h):
    x, gamma, beta, ct = _inputs(n, h, n * h + 1)
    return [torch.from_numpy(a).bfloat16() for a in (x, gamma, beta, ct)]


def _jnp_bf16(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("n,h", SHAPES)
def test_forward_bf16_params_matches_jax(n, h):
    xb, gb, bb, _ = _bf16_params_case(n, h)
    want = jax_fused_layer_norm(*map(_jnp_bf16, (xb, gb, bb)), EPS, True)
    got = kernels.layer_norm_reference(xb, gb, bb, EPS)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0.0,
                               atol=2e-2)


@pytest.mark.parametrize("n,h", SHAPES)
def test_emulated_backward_bf16_params_matches_jax(n, h):
    xb, gb, bb, cb = _bf16_params_case(n, h)
    plan = layer_norm_bwd_plan(n, h, 8 if h % 8 == 0 else 1, H100_SMS)
    dx, dgamma, dbeta = emulate_backward(xb, gb, cb, plan)
    got = [dx, dgamma.to(gb.dtype), dbeta.to(gb.dtype)]
    assert got[0].dtype == torch.bfloat16
    want = _jax_backward(*(t.float().numpy() for t in (xb, gb, bb, cb)))
    np.testing.assert_allclose(got[0].float().numpy(), want[0], rtol=0.0,
                               atol=2e-2, err_msg="dx")
    for name, a, e in zip(("dgamma", "dbeta"), got[1:], want[1:]):
        e = torch.from_numpy(e.copy()).bfloat16().float().numpy()
        np.testing.assert_allclose(a.float().numpy(), e, rtol=2 ** -7,
                                   atol=1e-6, err_msg=name)
    _, vjp = jax.vjp(lambda a, b, c: jax_fused_layer_norm(a, b, c, EPS, True),
                     *map(_jnp_bf16, (xb, gb, bb)))
    for name, a, e in zip(("dx", "dgamma", "dbeta"), got,
                          vjp(_jnp_bf16(cb))):
        e = np.asarray(e, np.float32)
        np.testing.assert_allclose(a.float().numpy(), e, rtol=0.0,
                                   atol=2e-2 * (np.abs(e).max() + 1),
                                   err_msg=f"{name} vs JAX's bf16 VJP")


@pytest.mark.parametrize("n,h", SHAPES)
def test_plain_backward_rounds_bf16_params_as_the_kernel(n, h):
    """The plain backward returns dgamma and dbeta in gamma's dtype, the
    fp32 sums rounded once, as the kernel does."""
    xb, gb, _, cb = _bf16_params_case(n, h)
    dx, dgamma, dbeta = kernels.layer_norm_backward(xb, gb, EPS, cb)
    assert dx.dtype == dgamma.dtype == dbeta.dtype == torch.bfloat16
    plan = layer_norm_bwd_plan(n, h, 8 if h % 8 == 0 else 1, H100_SMS)
    want = emulate_backward(xb, gb, cb, plan)
    torch.testing.assert_close(dx.float(), want[0].float(), atol=2e-2,
                               rtol=0.0)
    for a, e in zip((dgamma, dbeta), want[1:]):
        torch.testing.assert_close(a.float(), e.to(gb.dtype).float(),
                                   rtol=2 ** -7, atol=1e-6)


def test_plan_matches_the_kernel_paths():
    """The main path's row (H = 512) is one warp holding 4 float4 chunks a
    lane (2 chunks of 8 bf16); rows wider than 1024 loop, one CTA of 1024
    threads a row with scalar loads."""
    assert layer_norm_bwd_plan(8192, 512, 4, H100_SMS) == \
        BwdPlan(264, 8, 32, 4, 4, 8)
    assert layer_norm_bwd_plan(8192, 512, 8, H100_SMS).chunks == 2
    assert layer_norm_bwd_plan(7, 31, 1, H100_SMS) == BwdPlan(1, 8, 32, 1, 2, 8)
    assert layer_norm_bwd_plan(300, 1000, 1, H100_SMS).chunks == 32
    assert layer_norm_bwd_plan(300, 1024, 4, H100_SMS).chunks == 8
    assert layer_norm_bwd_plan(4, 4096, 4, H100_SMS) == \
        BwdPlan(4, 1, 1024, 1, 0, 8)
    assert layer_norm_bwd_plan(3, 8193, 1, H100_SMS) == \
        BwdPlan(3, 1, 1024, 1, 0, 8)


def test_bwd_ctas_is_about_two_an_sm():
    assert layer_norm_bwd_plan(8192, 512, 4, H100_SMS).ctas == 264
    assert layer_norm_bwd_plan(8, 512, 4, H100_SMS).ctas == 1
    assert layer_norm_bwd_plan(40, 4096, 1, H100_SMS).ctas == 40
    assert layer_norm_bwd_plan(0, 512, 4, H100_SMS).ctas == 1


def test_bwd_cuda_wrapper_refuses_cpu_tensors_and_wrong_inputs():
    x = torch.ones(4, 64)
    gamma = torch.ones(64)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.layer_norm_bwd_cuda(x, gamma, x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernels.layer_norm_bwd_cuda(x.half(), gamma, x.half())
    with pytest.raises(ValueError, match="g must be"):
        kernels.layer_norm_bwd_cuda(x, gamma, x.bfloat16())
    with pytest.raises(ValueError, match="g must be"):
        kernels.layer_norm_bwd_cuda(x, gamma, x[:2])
    with pytest.raises(ValueError, match="gamma must be"):
        kernels.layer_norm_bwd_cuda(x, gamma[:8], x)
    with pytest.raises(ValueError, match="gamma must be"):
        kernels.layer_norm_bwd_cuda(x, gamma.double(), x)
    with pytest.raises(ValueError, match=r"\(N, H\)"):
        kernels.layer_norm_bwd_cuda(x[None], gamma, x[None])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.layer_norm_bwd_cuda(torch.ones(64, 4).t(), torch.ones(64),
                                    torch.ones(64, 4).t())


def test_cpu_grad_dispatch_is_the_plain_version():
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.normal(size=(3, 5, 32)).astype(np.float32))
    g = torch.from_numpy(r.normal(size=(3, 5, 32)).astype(np.float32))
    gamma = torch.ones(32)
    before = kernels.launch_counts()
    got = layer_norm_grad(x, gamma, EPS, g)
    want = kernels.layer_norm_backward(x, gamma, EPS, g)
    assert kernels.launch_counts() == before
    for a, e in zip(got, want):
        assert torch.equal(a, e)
