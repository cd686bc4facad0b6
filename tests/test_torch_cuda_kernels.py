"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``gpu``: they skip where there is no CUDA device (a CUDA kernel has
no interpret mode). This file imports neither JAX nor the JAX package, so
it runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_kernels.py

Tolerances: fp32 outputs within 2e-4 (LayerNorm 1e-5; the LayerNorm
backward's dgamma and dbeta, sums over all rows, 1e-5 of their largest
entry) of the plain version, whose sums run in another order (the flash
kernels' fp32 route is 3xTF32 on the tensor cores, ~2^-21 relative a
product); bf16 outputs within 2e-2, a few bf16 ulps at unit scale.
"""

import pytest
import torch

from bigdl_tpu_torch import kernels

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, atol, rtol):
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("n,h", [(1, 512), (7, 31), (300, 512), (33, 1000),
                                 (4, 4096), (2, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_matches_plain(cuda, n, h, dtype):
    g = torch.Generator(device=cuda).manual_seed(n * 1000 + h)
    x = (3 * torch.randn(n, h, generator=g, device=cuda) + 1).to(dtype)
    gamma = 1 + 0.1 * torch.randn(h, generator=g, device=cuda)
    beta = 0.1 * torch.randn(h, generator=g, device=cuda)
    before = kernels.launch_counts()["layer_norm_fwd"]
    got = kernels.layer_norm_cuda(x, gamma, beta, 1e-5)
    assert kernels.launch_counts()["layer_norm_fwd"] == before + 1
    want = kernels.layer_norm_reference(x, gamma, beta, 1e-5)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        _close(got, want, 1e-5, 1e-5)
    else:
        _close(got, want, 2e-2, 0.0)


def _ln_bwd_inputs(g, n, h, dtype, device="cuda"):
    x = (3 * torch.randn(n, h, generator=g, device=device) + 1).to(dtype)
    dy = torch.randn(n, h, generator=g, device=device).to(dtype)
    gamma = 1 + 0.1 * torch.randn(h, generator=g, device=device)
    return x, gamma, dy


def _close_ln_bwd(got, want, dtype):
    """dx within rtol 1e-4 / atol 1e-5 (fp32) or 2e-2 (bf16, a few ulps of
    the bf16 result); dgamma and dbeta are fp32 sums over all N rows, taken
    in another order than the plain version's, so their atol scales with
    their largest entry: 1e-5·(max|want| + 1), rtol 1e-4."""
    dx, dgamma, dbeta = got
    assert dx.dtype == dtype and dx.shape == want[0].shape
    assert dgamma.dtype == dbeta.dtype == torch.float32
    if dtype == torch.float32:
        _close(dx, want[0], 1e-5, 1e-4)
    else:
        _close(dx, want[0], 2e-2, 0.0)
    for x, w in zip((dgamma, dbeta), want[1:]):
        _close(x, w, 1e-5 * (float(w.abs().max()) + 1.0), 1e-4)


@pytest.mark.parametrize("n,h", [(1, 512), (7, 31), (300, 512), (33, 1000),
                                 (4, 4096), (2, 1), (8192, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_bwd_matches_plain(cuda, n, h, dtype):
    g = torch.Generator(device=cuda).manual_seed(n * 1000 + h + 5)
    x, gamma, dy = _ln_bwd_inputs(g, n, h, dtype)
    before = kernels.launch_counts()["layer_norm_bwd"]
    got = kernels.layer_norm_bwd_cuda(x, gamma, dy, 1e-5)
    assert kernels.launch_counts()["layer_norm_bwd"] == before + 1
    want = kernels.layer_norm_backward(x, gamma, 1e-5, dy)
    _close_ln_bwd(got, want, dtype)


@pytest.mark.parametrize("n,h", [(3, 8193), (2, 12288)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_rows_wider_than_the_registers(cuda, n, h, dtype):
    """H far beyond the warp path's 1024: the kernels loop over the row in
    global memory, one CTA of 1024 threads a row."""
    g = torch.Generator(device=cuda).manual_seed(h)
    x, gamma, dy = _ln_bwd_inputs(g, n, h, dtype)
    beta = 0.1 * torch.randn(h, generator=g, device=cuda)
    got = kernels.layer_norm_cuda(x, gamma, beta, 1e-5)
    want = kernels.layer_norm_reference(x, gamma, beta, 1e-5)
    _close(got, want, *((1e-5, 1e-5) if dtype == torch.float32
                        else (2e-2, 0.0)))
    _close_ln_bwd(kernels.layer_norm_bwd_cuda(x, gamma, dy, 1e-5),
                  kernels.layer_norm_backward(x, gamma, 1e-5, dy), dtype)


@pytest.mark.parametrize("h", [512, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_unaligned_rows(cuda, h, dtype):
    """Rows that start off a 16-byte boundary take the scalar loads."""
    g = torch.Generator(device=cuda).manual_seed(h + 1)
    n = 5
    flat_x, flat_dy = (torch.randn(n * h + 1, generator=g, device=cuda)
                       .to(dtype) for _ in range(2))
    x, dy = flat_x[1:].view(n, h), flat_dy[1:].view(n, h)
    gamma = 1 + 0.1 * torch.randn(h, generator=g, device=cuda)
    beta = 0.1 * torch.randn(h, generator=g, device=cuda)
    tol = (1e-5, 1e-5) if dtype == torch.float32 else (2e-2, 0.0)
    _close(kernels.layer_norm_cuda(x, gamma, beta, 1e-5),
           kernels.layer_norm_reference(x, gamma, beta, 1e-5), *tol)
    _close_ln_bwd(kernels.layer_norm_bwd_cuda(x, gamma, dy, 1e-5),
                  kernels.layer_norm_backward(x, gamma, 1e-5, dy), dtype)


@pytest.mark.parametrize("n,h", [(8192, 512), (300, 1000), (40, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_bwd_is_deterministic(cuda, n, h, dtype):
    """dgamma and dbeta are summed in a fixed order, without float atomics:
    two calls agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(n + h)
    args = _ln_bwd_inputs(g, n, h, dtype)
    first = kernels.layer_norm_bwd_cuda(*args, 1e-5)
    second = kernels.layer_norm_bwd_cuda(*args, 1e-5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _bf16_params(g, h, device="cuda"):
    gamma = (1 + 0.1 * torch.randn(h, generator=g, device=device)).bfloat16()
    beta = (0.1 * torch.randn(h, generator=g, device=device)).bfloat16()
    return gamma, beta


@pytest.mark.parametrize("n,h", [(1, 512), (7, 31), (300, 512), (33, 1000),
                                 (4, 4096), (2048, 512), (8192, 512)])
def test_layer_norm_bf16_params_match_plain(cuda, n, h):
    """bf16 x with bf16 gamma and beta, as the mixed-precision step gives
    them: the forward within 2e-2 of the plain version; the backward's dx
    within 2e-2 and dgamma, dbeta in bf16, fp32 sums rounded once, within
    one bf16 ulp (rtol 2^-7) of the plain sums rounded the same way."""
    g = torch.Generator(device=cuda).manual_seed(n * 1000 + h + 7)
    x, _, dy = _ln_bwd_inputs(g, n, h, torch.bfloat16)
    gamma, beta = _bf16_params(g, h)
    before = kernels.launch_counts_by_dtype()
    got = kernels.layer_norm_cuda(x, gamma, beta, 1e-5)
    assert got.dtype == torch.bfloat16
    _close(got, kernels.layer_norm_reference(x, gamma, beta, 1e-5), 2e-2, 0.0)
    dx, dgamma, dbeta = kernels.layer_norm_bwd_cuda(x, gamma, dy, 1e-5)
    after = kernels.launch_counts_by_dtype()
    for name in ("layer_norm_fwd", "layer_norm_bwd"):
        key = "bfloat16/bfloat16"
        assert after[name].get(key, 0) == before[name].get(key, 0) + 1
    want = kernels.layer_norm_backward(x, gamma, 1e-5, dy)
    assert dgamma.dtype == dbeta.dtype == torch.bfloat16
    assert want[1].dtype == torch.bfloat16
    _close(dx, want[0], 2e-2, 0.0)
    for a, w in zip((dgamma, dbeta), want[1:]):
        _close(a, w, 1e-5 * (float(w.float().abs().max()) + 1.0), 2 ** -7)


@pytest.mark.parametrize("n,h", [(8192, 512), (300, 1000), (3, 8193)])
def test_layer_norm_bwd_bf16_params_is_deterministic(cuda, n, h):
    g = torch.Generator(device=cuda).manual_seed(n + h + 3)
    x, _, dy = _ln_bwd_inputs(g, n, h, torch.bfloat16)
    gamma, _ = _bf16_params(g, h)
    first = kernels.layer_norm_bwd_cuda(x, gamma, dy, 1e-5)
    second = kernels.layer_norm_bwd_cuda(x, gamma, dy, 1e-5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_layer_norm_bf16_params_unaligned_rows(cuda):
    g = torch.Generator(device=cuda).manual_seed(77)
    n, h = 5, 512
    flat_x, flat_dy = (torch.randn(n * h + 1, generator=g, device=cuda)
                       .bfloat16() for _ in range(2))
    x, dy = flat_x[1:].view(n, h), flat_dy[1:].view(n, h)
    gamma, beta = _bf16_params(g, h)
    _close(kernels.layer_norm_cuda(x, gamma, beta, 1e-5),
           kernels.layer_norm_reference(x, gamma, beta, 1e-5), 2e-2, 0.0)
    got = kernels.layer_norm_bwd_cuda(x, gamma, dy, 1e-5)
    want = kernels.layer_norm_backward(x, gamma, 1e-5, dy)
    _close(got[0], want[0], 2e-2, 0.0)
    for a, w in zip(got[1:], want[1:]):
        _close(a, w, 1e-5 * (float(w.float().abs().max()) + 1.0), 2 ** -7)


def test_layer_norm_refuses_params_in_another_dtype(cuda):
    """gamma and beta are fp32 or in x's dtype, one dtype for both."""
    x = torch.randn(4, 64, device=cuda)
    gb, bb = torch.ones(64, device=cuda).bfloat16(), \
        torch.zeros(64, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="gamma must be"):
        kernels.layer_norm_cuda(x, gb, bb)
    with pytest.raises(ValueError, match="gamma must be"):
        kernels.layer_norm_bwd_cuda(x, gb, x)
    with pytest.raises(ValueError, match="beta must be"):
        kernels.layer_norm_cuda(x.bfloat16(), gb, bb.float())


def test_layer_norm_bwd_refuses_a_plan_it_cannot_run(cuda):
    """The backward launches the plan ``layer_norm_bwd_plan`` gives it and
    returns an error for one its kernels were not built for."""
    import ctypes

    from bigdl_tpu_torch.kernels import _cuda
    from bigdl_tpu_torch.kernels.layernorm import layer_norm_bwd_plan

    n, h = 64, 512
    x, gamma, dy = _ln_bwd_inputs(torch.Generator(device=cuda).manual_seed(5),
                                  n, h, torch.float32)
    dx = torch.empty_like(x)
    dgb = torch.empty(2, h, device=cuda)
    ws = torch.empty(1024, 2 * h, device=cuda)
    lib = _cuda.library().lib
    good = layer_norm_bwd_plan(n, h, 4, 132)

    def launch(plan):
        code = lib.bigdl_layer_norm_bwd(
            x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
            dgb.data_ptr(), ws.data_ptr(), n, h, 1e-5, 0, 0,
            (ctypes.c_int * len(plan))(*plan), _cuda.stream_handle(x))
        torch.cuda.synchronize()
        return code

    assert launch(good) == 0
    for bad in (good._replace(chunks=3), good._replace(chunks=2),
                good._replace(rows_per_cta=4), good._replace(vec=2),
                good._replace(ctas=0), good._replace(chunks=0),
                good._replace(threads=64), good._replace(reduce_warps=4)):
        assert launch(bad) != 0, bad


def test_layer_norm_autograd_launches_the_backward_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(2, 9, 512, generator=g, device=cuda).requires_grad_()
    gamma = (1 + 0.1 * torch.randn(512, generator=g, device=cuda)) \
        .requires_grad_()
    beta = torch.zeros(512, device=cuda, requires_grad=True)
    w = torch.randn(2, 9, 512, generator=g, device=cuda)
    before = kernels.launch_counts()
    (kernels.fused_layer_norm(x, gamma, beta) * w).sum().backward()
    after = kernels.launch_counts()
    assert after["layer_norm_fwd"] == before["layer_norm_fwd"] + 1
    assert after["layer_norm_bwd"] == before["layer_norm_bwd"] + 1
    want = kernels.layer_norm_backward(x.detach(), gamma.detach(), 1e-5, w)
    _close_ln_bwd((x.grad, gamma.grad, beta.grad), want, torch.float32)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 7, 64, 65, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_matches_plain(cuda, d, t, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(d * 1000 + t)
    q, k, v = (torch.randn(3, t, d, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = kernels.launch_counts()["flash_attention_fwd"]
    o, lse = kernels.flash_attention_cuda(q, k, v, causal)
    assert kernels.launch_counts()["flash_attention_fwd"] == before + 1
    o_ref, lse_ref = kernels.flash_attention_reference(q, k, v, causal)
    assert o.dtype == dtype and lse.dtype == torch.float32
    tol = (2e-4, 2e-4) if dtype == torch.float32 else (2e-2, 0.0)
    _close(o, o_ref, *tol)
    _close(lse, lse_ref, *tol)


def test_flash_large_scores_stay_finite(cuda):
    """Scores near 1e3 overflow a naive exp; the running max keeps O exact."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = 30 * torch.randn(2, 130, 64, generator=g, device=cuda)
    k = 30 * torch.randn(2, 130, 64, generator=g, device=cuda)
    v = torch.randn(2, 130, 64, generator=g, device=cuda)
    o, lse = kernels.flash_attention_cuda(q, k, v, True)
    o_ref, lse_ref = kernels.flash_attention_reference(q, k, v, True)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    _close(o, o_ref, 2e-4, 2e-4)
    _close(lse, lse_ref, 2e-3, 2e-5)


def test_flash_large_scores_bf16(cuda):
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k = (30 * torch.randn(2, 130, 64, generator=g, device=cuda)
            for _ in range(2))
    v = torch.randn(2, 130, 64, generator=g, device=cuda)
    q, k, v = (x.bfloat16() for x in (q, k, v))
    o, lse = kernels.flash_attention_cuda(q, k, v, True)
    o_ref, lse_ref = kernels.flash_attention_reference(q, k, v, True)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    _close(o, o_ref, 2e-2, 0.0)
    _close(lse, lse_ref, 2e-3, 2e-5)


def _flash_case(seed, bh, t, d, causal, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(bh, t, d, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    o, lse = kernels.flash_attention_cuda(q, k, v, causal)
    o_ref, lse_ref = kernels.flash_attention_reference(q, k, v, causal)
    tol = (2e-4, 2e-4) if dtype == torch.float32 else (2e-2, 0.0)
    _close(o, o_ref, *tol)
    _close(lse, lse_ref, *tol)


@pytest.mark.parametrize("t", [63, 127, 129, 1000])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_ragged_t_across_heads(cuda, t, causal, dtype):
    """T off the key tiles (64 bf16, 32 fp32) and the query tiles: a tail
    tile that read the next head's rows would show in heads 0-2."""
    _flash_case(t, 4, t, 64, causal, dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_head_dim_128_long(cuda, causal, dtype):
    _flash_case(128, 3, 1024, 128, causal, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_two_warpgroup_ragged_causal(cuda, dtype):
    """Enough heads for 128-row, two-warpgroup CTAs, and T = 300 not a
    multiple of 128: the last CTA's second warpgroup holds only rows past
    T, and its first warpgroup the causal tail."""
    from bigdl_tpu_torch.kernels.flash_attention import forward_launch_plan

    plan = forward_launch_plan(140, 300, 64, dtype)
    assert plan["warpgroups"] == 2 and plan["threads"] == 288
    _flash_case(300, 140, 300, 64, True, dtype)


def _flash_bwd_inputs(g, bh, t, d, causal, dtype, q_mul=1.0):
    q, k, v, do = (torch.randn(bh, t, d, generator=g, device="cuda")
                   for _ in range(4))
    q = q_mul * q
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    o, lse = kernels.flash_attention_reference(q, k, v, causal)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 7, 64, 65, 200])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_matches_plain(cuda, d, t, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(d * 1000 + t + 7)
    args = _flash_bwd_inputs(g, 3, t, d, causal, dtype)
    before = kernels.launch_counts()
    got = kernels.flash_attention_bwd_cuda(*args, causal)
    after = kernels.launch_counts()
    assert after["flash_attention_bwd_dq"] == \
        before["flash_attention_bwd_dq"] + 1
    assert after["flash_attention_bwd_dkv"] == \
        before["flash_attention_bwd_dkv"] + 1
    want = kernels.flash_attention_bwd_reference(*args, causal)
    # fp32: sums over T keys in another order; bf16: a few ulps of the
    # bf16 result at the gradients' scale
    for x, w in zip(got, want):
        assert x.dtype == dtype and x.shape == args[0].shape
        scale = float(w.float().abs().max()) + 1.0
        if dtype == torch.float32:
            _close(x, w, 2e-4 * scale, 2e-4)
        else:
            _close(x, w, 2e-2 * scale, 2e-2)


def test_flash_bwd_large_scores_stay_finite(cuda):
    g = torch.Generator(device=cuda).manual_seed(8)
    args = _flash_bwd_inputs(g, 2, 130, 64, True, torch.float32, q_mul=30.0)
    got = kernels.flash_attention_bwd_cuda(*args, True)
    want = kernels.flash_attention_bwd_reference(*args, True)
    for x, w in zip(got, want):
        assert torch.isfinite(x).all()
        # scores near 1e3 carry ~1e-4 relative error into p in fp32
        _close(x, w, 2e-3 * (float(w.abs().max()) + 1.0), 2e-3)


def _flash_bwd_case(seed, bh, t, d, causal, dtype, q_mul=1.0, tol=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    args = _flash_bwd_inputs(g, bh, t, d, causal, dtype, q_mul)
    got = kernels.flash_attention_bwd_cuda(*args, causal)
    want = kernels.flash_attention_bwd_reference(*args, causal)
    if tol is None:
        tol = 2e-4 if dtype == torch.float32 else 2e-2
    for x, w in zip(got, want):
        assert torch.isfinite(x.float()).all()
        _close(x, w, tol * (float(w.float().abs().max()) + 1.0), tol)


@pytest.mark.parametrize("t", [63, 127, 129, 1000])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_ragged_t_across_heads(cuda, t, causal, dtype):
    """T off the streamed tiles (16-64 rows) and the resident ones (64 or
    128): a tail tile that read the next head's rows, or a query past T
    that kept a non-zero p, would show in heads 0-2."""
    _flash_bwd_case(t + 11, 4, t, 64, causal, dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_head_dim_128_long(cuda, causal, dtype):
    _flash_bwd_case(129, 3, 1024, 128, causal, dtype)


def test_flash_bwd_large_scores_bf16(cuda):
    """Scores near 1e3 in bf16: p from the saved lse stays in [0, 1]."""
    _flash_bwd_case(8, 2, 130, 64, True, torch.bfloat16, q_mul=30.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_two_warpgroup_ragged_causal(cuda, dtype):
    """Enough heads for 128-row, two-warpgroup CTAs in both kernels, and
    T = 300 not a multiple of 128: the last CTA's second warpgroup holds
    only rows past T."""
    for dkv in (False, True):
        plan = kernels.backward_launch_plan(140, 300, 64, dtype, dkv)
        assert plan["warpgroups"] == 2 and plan["threads"] == 288
    _flash_bwd_case(300, 140, 300, 64, True, dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_is_deterministic(cuda, causal, dtype):
    """Every output tile is owned by one CTA and summed in a fixed order:
    two calls on the same inputs agree bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(21)
    args = _flash_bwd_inputs(g, 140, 300, 64, causal, dtype)
    first = kernels.flash_attention_bwd_cuda(*args, causal)
    second = kernels.flash_attention_bwd_cuda(*args, causal)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_autograd_matches_plain_autograd(cuda):
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(2, 4, 100, 64, generator=g, device=cuda)
               .requires_grad_() for _ in range(3))
    w = torch.randn(2, 4, 100, 64, generator=g, device=cuda)
    got = torch.autograd.grad((kernels.flash_attention(q, k, v, True) * w)
                              .sum(), (q, k, v))
    ref = kernels.flash_attention_reference(q, k, v, True)[0]
    want = torch.autograd.grad((ref * w).sum(), (q, k, v))
    for x, y in zip(got, want):
        _close(x, y, 2e-4, 2e-4)


def test_dispatchers_launch_the_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 5, 64, generator=g, device=cuda)
    before = kernels.launch_counts()
    with torch.no_grad():
        kernels.fused_layer_norm(x, torch.ones(64, device=cuda),
                                 torch.zeros(64, device=cuda))
        kernels.flash_attention(x[:, None], x[:, None], x[:, None], True)
    after = kernels.launch_counts()
    assert after["layer_norm_fwd"] == before["layer_norm_fwd"] + 1
    assert after["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert after["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"]
    # a backward pass launches the LN forward and backward, the flash
    # forward and both flash backward kernels once each
    xg = x.clone().requires_grad_()
    gamma = torch.ones(64, device=cuda, requires_grad=True)
    h = kernels.fused_layer_norm(xg, gamma, torch.zeros(64, device=cuda))
    kernels.flash_attention(h[:, None], h[:, None], h[:, None], True) \
        .sum().backward()
    assert xg.grad is not None and gamma.grad is not None
    end = kernels.launch_counts()
    for name in ("layer_norm_fwd", "layer_norm_bwd", "flash_attention_fwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert end[name] == after[name] + 1, name


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(4, 64, device=cuda)
    g, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError):
        kernels.layer_norm_cuda(x.half(), g, b)
    with pytest.raises(ValueError):
        kernels.layer_norm_cuda(x.t(), g[:4], b[:4])
    with pytest.raises(ValueError):
        kernels.layer_norm_cuda(x, g.double(), b)
    with pytest.raises(ValueError):
        kernels.layer_norm_bwd_cuda(x.half(), g, x.half())
    with pytest.raises(ValueError):
        kernels.layer_norm_bwd_cuda(x, g, x.bfloat16())
    with pytest.raises(ValueError):
        kernels.layer_norm_bwd_cuda(x, g[:4], x)
    with pytest.raises(ValueError):
        kernels.layer_norm_bwd_cuda(x.t(), g[:4], x.t())
    q = torch.randn(2, 8, 48, device=cuda)
    with pytest.raises(ValueError):
        kernels.flash_attention_cuda(q, q, q)
    q = torch.randn(2, 8, 64, device=cuda)
    with pytest.raises(ValueError):
        kernels.flash_attention_cuda(q, q[:, :4], q[:, :4])
    lse = torch.zeros(2, 8, device=cuda)
    with pytest.raises(ValueError):
        kernels.flash_attention_bwd_cuda(q, q, q, q, lse[:, :4], q)
    with pytest.raises(ValueError):
        kernels.flash_attention_bwd_cuda(q, q, q, q, lse, q.bfloat16())


def test_small_model_and_engine_on_the_card(cuda):
    """A small TransformerLM on the card (both kernels) equals the same
    weights on the CPU (plain versions), and served tokens equal solo
    ``greedy_generate`` on the card."""
    import numpy as np

    from bigdl_tpu_torch.models.transformerlm import TransformerLM
    from bigdl_tpu_torch.nn import greedy_generate
    from bigdl_tpu_torch.serving import ServingEngine

    def build(device):   # head dim 32, the smallest the flash kernel takes
        return TransformerLM(64, 128, 4, 2, 64, device=device,
                             generator=torch.Generator().manual_seed(0))

    lm, ref = build("cuda"), build("cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 37)))
    before = kernels.launch_counts()
    with torch.no_grad():
        got, want = lm(ids.cuda()).cpu(), ref(ids)
    after = kernels.launch_counts()
    assert after["layer_norm_fwd"] == before["layer_norm_fwd"] + 5
    assert after["flash_attention_fwd"] == before["flash_attention_fwd"] + 2
    _close(got, want, 1e-4, 1e-4)
    prompts = [np.arange(n) % 64 for n in (3, 20, 9)]
    with ServingEngine(lm, 64, slots=2) as eng:
        results = [h.result(120) for h in [eng.submit(p, 6) for p in prompts]]
    for p, r in zip(prompts, results):
        solo = greedy_generate(lm, p[None], 6)[0].cpu().numpy()
        np.testing.assert_array_equal(r.tokens, solo)


def test_small_model_trains_on_the_card(cuda):
    """Two LocalOptimizer steps of a small TransformerLM on the card (all
    four kernels) equal the same steps on the CPU (plain versions)."""
    import numpy as np

    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models.transformerlm import (
        TransformerLM, lm_criterion,
    )
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer

    r = np.random.default_rng(1)
    batches = [(torch.from_numpy(r.integers(0, 64, (2, 40))),
                torch.from_numpy(r.integers(0, 64, (2, 40))))
               for _ in range(2)]
    runs = []
    before = kernels.launch_counts()
    for device in ("cuda", "cpu"):
        lm = TransformerLM(64, 128, 4, 2, 64, device=device,
                           generator=torch.Generator().manual_seed(0))
        opt = (LocalOptimizer(lm, DataSet.array([]), lm_criterion(),
                              device=device)
               .set_optim_method(SGD(learningrate=0.1, momentum=0.9)))
        losses = [opt.train_step(x.to(device), y.to(device))
                  for x, y in batches]
        runs.append((losses, [p.detach().cpu() for p in lm.parameters()]))
    after = kernels.launch_counts()
    # 2 steps: 5 LNs, 2 attention layers (forward and backward) a step
    assert after["layer_norm_fwd"] == before["layer_norm_fwd"] + 10
    assert after["layer_norm_bwd"] == before["layer_norm_bwd"] + 10
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 4, name
    (losses, params), (ref_losses, ref_params) = runs
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for p, q in zip(params, ref_params):
        _close(p, q, 1e-4, 1e-4)


def _small_lm_run(device, configure, steps=2, remat=False):
    import numpy as np

    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.models.transformerlm import (
        TransformerLM, lm_criterion,
    )
    from bigdl_tpu_torch.optim import LocalOptimizer

    r = np.random.default_rng(1)
    batches = [(torch.from_numpy(r.integers(0, 64, (2, 40))),
                torch.from_numpy(r.integers(0, 64, (2, 40))))
               for _ in range(steps)]
    lm = TransformerLM(64, 128, 4, 2, 64, device=device, remat=remat,
                       generator=torch.Generator().manual_seed(0))
    opt = configure(LocalOptimizer(lm, DataSet.array([]), lm_criterion(),
                                   device=device))
    losses = [opt.train_step(x.to(device), y.to(device)) for x, y in batches]
    return losses, [p.detach().cpu() for p in lm.parameters()]


def test_small_model_trains_in_bf16_on_the_card(cuda):
    """Two bf16 mixed-precision steps (``Engine.init(compute_dtype=
    torch.bfloat16)``) on the card launch all five kernels in bf16, with
    bf16 gamma and beta in both LayerNorm kernels, keep fp32 masters, and
    agree with the same steps on the CPU (plain versions, bf16 casts)
    within rtol 2e-2 in loss and atol 2e-2 in parameters."""
    import numpy as np

    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.utils.engine import Engine

    def configure(opt):
        return opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))

    Engine.init(compute_dtype=torch.bfloat16)
    try:
        kernels.reset_launch_counts()
        losses, params = _small_lm_run("cuda", configure)
        counts = kernels.launch_counts_by_dtype()
        ref_losses, ref_params = _small_lm_run("cpu", configure)
    finally:
        Engine.reset()
    assert counts["layer_norm_fwd"] == {"bfloat16/bfloat16": 10}
    assert counts["layer_norm_bwd"] == {"bfloat16/bfloat16": 10}
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert counts[name] == {"bfloat16": 4}, name
    assert all(p.dtype == torch.float32 for p in params)
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-2)
    for p, q in zip(params, ref_params):
        _close(p, q, 2e-2, 0.0)


@pytest.mark.parametrize("mode", ["dots", "full"])
def test_remat_on_the_card_recomputes_through_the_kernels(cuda, mode):
    """``set_remat`` on the card: the forward kernels run again in the
    backward (LayerNorm and flash forward twice a step) and the step's
    result equals the step without remat within 1e-5."""
    import numpy as np

    from bigdl_tpu_torch.optim import SGD

    def configure(remat):
        return lambda opt: opt.set_optim_method(
            SGD(learningrate=0.1)).set_remat(remat)

    want_losses, want = _small_lm_run("cuda", configure("none"))
    before = kernels.launch_counts()
    losses, got = _small_lm_run("cuda", configure(mode))
    after = kernels.launch_counts()
    assert after["layer_norm_fwd"] - before["layer_norm_fwd"] == 20
    assert after["layer_norm_bwd"] - before["layer_norm_bwd"] == 10
    assert after["flash_attention_fwd"] - before["flash_attention_fwd"] == 8
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for p, q in zip(got, want):
        _close(p, q, 1e-5, 1e-5)


@pytest.mark.parametrize("method", ["sgd", "adam"])
def test_flat_update_on_the_card_is_bitwise_the_per_leaf_update(cuda,
                                                                 method):
    from bigdl_tpu_torch.optim import SGD, Adam

    def configure(flat):
        make = {"sgd": lambda: SGD(learningrate=0.1, momentum=0.9,
                                   weightdecay=0.01),
                "adam": lambda: Adam(learningrate=0.01)}[method]
        return lambda opt: opt.set_optim_method(make()).set_flat_update(flat)

    want_losses, want = _small_lm_run("cuda", configure(False), steps=3)
    losses, got = _small_lm_run("cuda", configure(True), steps=3)
    assert losses == want_losses
    for p, q in zip(got, want):
        assert torch.equal(p, q)
