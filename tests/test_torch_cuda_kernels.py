"""The port's CUDA kernels against their plain versions, on the GPU.

Marked ``gpu``: they skip where there is no CUDA device (a CUDA kernel has
no interpret mode). This file imports neither JAX nor the JAX package, so
it runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_kernels.py

Tolerances: fp32 outputs within 2e-4 (LayerNorm 1e-5) of the plain
version, whose sums run in another order; bf16 outputs within 2e-2, a few
bf16 ulps at unit scale.
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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(4, 64, device=cuda)
    g, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError):
        kernels.layer_norm_cuda(x.half(), g, b)
    with pytest.raises(ValueError):
        kernels.layer_norm_cuda(x.t(), g[:4], b[:4])
    with pytest.raises(ValueError):
        kernels.layer_norm_cuda(x, g.double(), b)
    q = torch.randn(2, 8, 48, device=cuda)
    with pytest.raises(ValueError):
        kernels.flash_attention_cuda(q, q, q)
    q = torch.randn(2, 8, 64, device=cuda)
    with pytest.raises(ValueError):
        kernels.flash_attention_cuda(q, q[:, :4], q[:, :4])
    with pytest.raises(NotImplementedError):
        kernels.flash_attention_cuda(q.requires_grad_(), q, q)


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
