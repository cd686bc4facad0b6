"""The port's captured programs (``utils/programs.py``) on the GPU: the
serving engine's prefill, decode and assign programs and the training
step, each replayed against the same work run eagerly.

Marked ``gpu``: they skip where there is no CUDA device (a CUDA graph has
no CPU form). This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda_graphs.py

Small models (2 layers, width 64, head dim 32) keep the captures short.
Tolerances: a replay runs the kernels the eager call runs, on the same
inputs, so decode log-probs agree within 1e-5 and tokens exactly; the
training windows hold the one-step check's tolerances of ``chip_smoke.py``
(fp32: losses 1e-4 relative, parameters 1e-3 relative Frobenius; bf16:
1e-2 and 5e-2).
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import kernels
from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.models.transformerlm import TransformerLM, lm_criterion
from bigdl_tpu_torch.nn import greedy_generate, install_decode_cache
from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger
from bigdl_tpu_torch.optim.optim_method import hyper_tensor
from bigdl_tpu_torch.serving import ServingEngine
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.programs import Program, ProgramCaptureError

pytestmark = pytest.mark.gpu

VOCAB, E, HEADS, LAYERS, MAX_LEN = 64, 64, 2, 2, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU form")
    return torch.device("cuda")


def _lm(remat=False):
    return TransformerLM(VOCAB, E, HEADS, LAYERS, MAX_LEN, remat=remat,
                         generator=torch.Generator().manual_seed(0),
                         device="cuda")


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def test_served_tokens_and_replayed_programs_equal_eager(cuda):
    """Three buckets served through replayed programs give solo
    ``greedy_generate``'s tokens; then one more replay of a prefill bucket
    and of the decode tick equal the same model calls run eagerly, their
    caches included."""
    lm = _lm().evaluate()
    r = np.random.default_rng(0)
    reqs = [(r.integers(0, VOCAB, n), 6) for n in (5, 20, 40, 9)]
    with ServingEngine(lm, MAX_LEN, slots=2) as eng:
        results = [h.result(120) for h in
                   [eng.submit(p, m) for p, m in reqs]]
        stats = eng.stats()
    for (p, m), res in zip(reqs, results):
        want = greedy_generate(lm, p[None], m)[0].cpu().numpy()
        np.testing.assert_array_equal(res.tokens, want)
    assert stats["compiled_programs"] == 5 == stats["program_grid_bound"]
    progs = eng._programs._programs
    assert all(p.captured for p in progs.values())
    assert progs[("serve_decode", 2, MAX_LEN, "float32")].replays > 0

    with torch.no_grad():
        # a prefill bucket: 12 tokens right-padded to 16
        prefill = eng._prefill_program(16)
        args = torch.zeros(17, dtype=torch.long)
        args[:12] = torch.from_numpy(r.integers(0, VOCAB, 12))
        args[16] = 12
        prefill.inputs[0].copy_(args)
        got = prefill().cpu()
        state = install_decode_cache(lm, 1, MAX_LEN)
        logp, _ = lm.run(args[None, :16].cuda(), state)
        assert got[:, 0].tolist() == [int(logp[0, 11].argmax()), 1]
        for a, b in zip(_leaves(eng._prefill_state), _leaves(state)):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
        # the decode tick
        decode = eng._decode_program()
        before = kernels.launch_counts()
        ref = _copy(eng._dec_state)
        tok = torch.tensor([[7], [9]])
        decode.inputs[0].copy_(tok)
        got = decode().cpu()
        replayed = {k: v - before[k]
                    for k, v in kernels.launch_counts().items()}
        before = kernels.launch_counts()
        logp, _ = lm.run(tok.cuda(), ref)
        eager = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        assert got[0].tolist() == logp[:, 0].argmax(-1).tolist()
        assert got[1].tolist() == [1, 1]
        assert replayed == eager and eager["layer_norm_fwd"] == 2 * LAYERS + 1
        for a, b in zip(_leaves(eng._dec_state), _leaves(ref)):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def _batches(n, batch=2, t=MAX_LEN, seed=1):
    r = np.random.default_rng(seed)
    return [MiniBatch(r.integers(0, VOCAB, (batch, t)).astype(np.int32),
                      r.integers(0, VOCAB, (batch, t)).astype(np.int32))
            for _ in range(n)]


# options of the step that ride inside its program: (remat blocks,
# trainer settings)
_VARIANTS = {
    "plain": (False, lambda opt: opt),
    "remat": (True, lambda opt: opt),
    "accumulation-flat-clip": (False, lambda opt: opt
                               .set_gradient_accumulation(2)
                               .set_flat_update(True)
                               .set_gradient_clipping_by_l2_norm(1.0)),
}


def _optimizer(lm, ds, variant):
    opt = LocalOptimizer(lm, ds, lm_criterion()) \
        .set_optim_method(Adam(learningrate=1e-3))
    return _VARIANTS[variant][1](opt)


def _eager_steps(batches, variant):
    """The same steps run eagerly: the trainer's step function called
    directly, as its program would replay it."""
    lm = _lm(_VARIANTS[variant][0])
    opt = _optimizer(lm, DataSet.array([]), variant)
    named, scales, mask = opt._prepare_step()
    step = opt._make_step_fn(named, scales, mask)
    before = kernels.launch_counts()
    losses = [float(step(torch.from_numpy(b.input).cuda(),
                         torch.from_numpy(b.target).cuda(),
                         hyper_tensor(opt._method.hyper(k, opt._ostate),
                                      list(named.values()))))
              for k, b in enumerate(batches)]
    counts = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    return losses, dict(lm.named_parameters()), counts


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_training_window_equals_eager_steps(cuda, dtype, variant):
    """Two windows of 4 (the first holds the warm-up and the capture, the
    second is replays only) against 8 eager steps: losses, parameters and
    every kernel's launches."""
    remat = _VARIANTS[variant][0]
    Engine.init(compute_dtype=dtype)
    try:
        batches = _batches(8)
        ds = DataSet.array(batches)
        ds.shuffle = lambda: None
        lm = _lm(remat)
        opt = (_optimizer(lm, ds, variant)
               .set_fuse_steps(4).set_end_when(Trigger.max_iteration(8)))
        losses, windows = [], []
        run_steps = opt._run_steps

        def recorded(steps):
            windows.append(len(steps))
            out = run_steps(steps)
            losses.extend(out)
            return out

        opt._run_steps = recorded
        before = kernels.launch_counts()
        opt.optimize()
        counts = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        want_losses, want_params, want_counts = _eager_steps(batches,
                                                             variant)
    finally:
        Engine.reset()
    assert windows == [4, 4]
    assert opt._step_program.captured and opt._step_program.replays == 7
    loss_tol, param_tol = (1e-4, 1e-3) if dtype == torch.float32 \
        else (1e-2, 5e-2)
    np.testing.assert_allclose(losses, want_losses, rtol=loss_tol)
    for name, p in lm.named_parameters():
        w = want_params[name].detach()
        assert float((p.detach() - w).norm()) <= \
            param_tol * float(w.norm()) + 1e-12, name
    assert counts == want_counts
    runs = 2 if remat else 1                 # forward kernels a step
    calls = 2 if variant.startswith("accumulation") else 1   # microbatches
    assert counts["layer_norm_bwd"] == 8 * calls * (2 * LAYERS + 1)
    assert counts["layer_norm_fwd"] == 8 * calls * (2 * LAYERS * runs + 1)
    assert counts["flash_attention_fwd"] == 8 * calls * LAYERS * runs
    assert counts["flash_attention_bwd_dq"] == \
        counts["flash_attention_bwd_dkv"] == 8 * calls * LAYERS


def test_step_is_captured_again_when_the_frozen_mask_changes(cuda):
    lm = _lm()
    opt = LocalOptimizer(lm, DataSet.array([]), lm_criterion()) \
        .set_optim_method(Adam(learningrate=1e-3))
    (b,) = _batches(1)
    x, y = torch.from_numpy(b.input).cuda(), torch.from_numpy(b.target).cuda()
    opt.train_step(x, y)
    opt.train_step(x, y)
    first = opt._step_program
    assert first.captured and first.replays == 1
    lm[2].freeze()
    frozen = {n: p.detach().clone() for n, p in lm.named_parameters()
              if n.startswith("2.")}
    opt.train_step(x, y)
    second = opt._step_program
    assert second is not first and second.key != first.key
    assert second.captured and second.replays == 0
    opt.train_step(x, y)
    assert second.replays == 1 and opt.state["neval"] == 5
    for n, p in lm.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n


def test_a_failed_capture_raises_with_its_key(cuda):
    """A host read cannot be captured: the warm-up runs, the capture
    raises, naming the program's key; nothing runs eagerly in its place."""
    x = torch.ones(4, device="cuda")
    prog = Program(("host_read", 4), lambda t: t * float(t.sum()), (x,),
                   "cuda")
    with pytest.raises(ProgramCaptureError, match="host_read"):
        prog()
    assert not prog.captured
    torch.cuda.synchronize()
    assert float((x * 2).sum()) == 8.0      # the card still works
    # and so does the default generator, which the capture had marked
    assert torch.randn(4, device="cuda").isfinite().all()
