"""The port's captured programs (``utils/programs.py``) on the GPU: the
serving engine's prefill, decode and assign programs and the training
step (the llama-style model with the fused head among its variants, and a
CIFAR ResNet-20 whose batch-norm statistics ride in the program, and the
PTB LSTM LM whose unrolled recurrence is one program), each
replayed against the same work run eagerly, and dropout drawing fresh
masks at every replay; a failed capture captured again at the next call;
the serving engine's graphs replayed, not captured again, across a crash
and a weight swap; a LoRA step and the seq2seq Transformer's step (``-k
"lora or seq2seq"``), and an adapted engine's swap of adapter leaves;
NeuralCF's sparse embedding step and the deduplicated lookup with no host
sync (``-k recsys``); the SSD's training step, Mask R-CNN's forward with no
host sync, and an int8 LM's serving programs in each mode (``-k "detection
or quantized"``).

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
from bigdl_tpu_torch.models.resnet import ResNet
from bigdl_tpu_torch.models.transformerlm import TransformerLM, lm_criterion
from bigdl_tpu_torch.nn import (
    ClassNLLCriterion, Dropout, greedy_generate, install_decode_cache, layout,
)
from bigdl_tpu_torch.nn.normalization import dropout_generators
from bigdl_tpu_torch.optim import SGD, Adam, LocalOptimizer, Trigger
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


LLAMA = dict(num_kv_heads=1, position="rope", norm="rms", mlp_kind="swiglu",
             fused_head=True)


def _lm(remat=False, **opts):
    return TransformerLM(VOCAB, E, HEADS, LAYERS, MAX_LEN, remat=remat,
                         generator=torch.Generator().manual_seed(0),
                         device="cuda", **opts)


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
        # a prefill bucket: 12 tokens right-padded to 16, from depth 0
        prefill = eng._prefill_program(16)
        args = torch.zeros(18, dtype=torch.long)
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


@pytest.mark.parametrize("draft", [False, True])
def test_paged_pooled_speculative_serving_replays(cuda, draft):
    """The paged engine with a prefix pool (and with the model drafting
    for itself, k = 3) serves cold, seeded and exact-hit requests through
    replayed programs: solo ``greedy_generate``'s tokens, acceptance 1 with
    the self-draft, the ledger within its bound, the pool drained."""
    lm = _lm().evaluate()
    r = np.random.default_rng(2)
    base = r.integers(0, VOCAB, 24)
    reqs = [base, np.concatenate([base, r.integers(0, VOCAB, 7)]), base,
            r.integers(0, VOCAB, 37)]
    kw = dict(draft_model=lm, spec_tokens=3) if draft else {}
    with ServingEngine(lm, MAX_LEN, slots=2, pages=8, prefix_pool=4,
                       prefix_chunk=8, **kw) as eng:
        results = [eng.submit(p, 6).result(120) for p in reqs]
        stats = eng.stats()
        progs = eng._programs._programs
    for p, res in zip(reqs, results):
        want = greedy_generate(lm, p[None], 6)[0].cpu().numpy()
        np.testing.assert_array_equal(res.tokens, want)
    assert stats["prefix_hits"] == 2 and stats["prefills"] == 3
    assert stats["compiled_programs"] <= stats["program_grid_bound"]
    assert stats["pages_used"] == 0
    assert all(p.captured for p in progs.values())
    assert sum(p.replays for p in progs.values()) > 0
    if draft:
        assert stats["spec_acceptance"] == 1.0


def _batches(n, batch=2, t=MAX_LEN, seed=1):
    r = np.random.default_rng(seed)
    return [MiniBatch(r.integers(0, VOCAB, (batch, t)).astype(np.int32),
                      r.integers(0, VOCAB, (batch, t)).astype(np.int32))
            for _ in range(n)]


# options of the step that ride inside its program: (model options,
# trainer settings)
_VARIANTS = {
    "plain": ({}, lambda opt: opt),
    "remat": (dict(remat=True), lambda opt: opt),
    "accumulation-flat-clip": ({}, lambda opt: opt
                               .set_gradient_accumulation(2)
                               .set_flat_update(True)
                               .set_gradient_clipping_by_l2_norm(1.0)),
    # multi-query heads, RoPE, RMSNorm + SwiGLU and the fused head, whose
    # chunked loss runs inside the program
    "llama-fused-head": (LLAMA, lambda opt: opt),
}


def _optimizer(lm, ds, variant):
    fused = _VARIANTS[variant][0].get("fused_head", False)
    opt = LocalOptimizer(lm, ds, lm_criterion(fused, chunk_size=24)) \
        .set_optim_method(Adam(learningrate=1e-3))
    return _VARIANTS[variant][1](opt)


def _eager_steps(batches, variant):
    """The same steps run eagerly: the trainer's step function called
    directly, as its program would replay it."""
    lm = _lm(**_VARIANTS[variant][0])
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
    opts = _VARIANTS[variant][0]
    remat, rms = opts.get("remat", False), opts.get("norm") == "rms"
    Engine.init(compute_dtype=dtype)
    try:
        batches = _batches(8)
        ds = DataSet.array(batches)
        ds.shuffle = lambda: None
        lm = _lm(**opts)
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
    norms = 0 if rms else 1                  # RMSNorm is plain torch
    assert counts["layer_norm_bwd"] == 8 * calls * (2 * LAYERS + 1) * norms
    assert counts["layer_norm_fwd"] == \
        8 * calls * (2 * LAYERS * runs + 1) * norms
    assert counts["flash_attention_fwd"] == 8 * calls * LAYERS * runs
    assert counts["flash_attention_bwd_dq"] == \
        counts["flash_attention_bwd_dkv"] == 8 * calls * LAYERS


@pytest.mark.parametrize("sync", ["allreduce", "zero1", "fsdp"])
def test_distributed_step_at_world_1_is_captured_and_equals_local(cuda,
                                                                  sync):
    """DistriOptimizer over a one-rank NCCL group: its step (the
    collectives inside) is captured once and replayed, and 4 steps give
    LocalOptimizer's losses and parameters bit for bit."""
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    batches = _batches(4)

    def run(cls, **kw):
        ds = DataSet.array(batches)
        ds.shuffle = lambda: None
        lm = _lm()
        opt = (cls(lm, ds, lm_criterion(), **kw)
               .set_optim_method(Adam(learningrate=1e-3))
               .set_end_when(Trigger.max_iteration(4)))
        losses = []
        run_steps = opt._run_steps

        def recorded(steps):
            out = run_steps(steps)
            losses.extend(out)
            return out

        opt._run_steps = recorded
        opt.optimize()
        return opt, losses, {n: p.detach().clone()
                             for n, p in lm.named_parameters()}

    Engine.init(backend="nccl")
    try:
        before = kernels.launch_counts()
        dopt, dlosses, dparams = run(DistriOptimizer, parameter_sync=sync)
        counts = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        lopt, llosses, lparams = run(LocalOptimizer)
    finally:
        Engine.shutdown_distributed()
        Engine.reset()
    assert dopt.step_mode == "captured"
    assert dopt._step_program.captured and dopt._step_program.replays == 3
    assert dlosses == llosses
    for n, p in lparams.items():
        assert torch.equal(dparams[n], p), n
    for name in ("layer_norm_fwd", "layer_norm_bwd", "flash_attention_fwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert counts[name] > 0, name


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


def test_a_failed_capture_is_captured_again_at_the_next_call(cuda):
    """A capture that failed leaves no graph behind: the next call warms
    up and captures anew, and replays after that."""
    x = torch.ones(4, device="cuda")
    fail = [True]

    def fn(t):
        if fail[0] and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the loop died mid-capture")
        return t * 3

    prog = Program(("dies_once", 4), fn, (x,), "cuda")
    with pytest.raises(ProgramCaptureError, match="dies_once"):
        prog()
    assert not prog.captured
    fail[0] = False
    assert prog().sum().item() == 12.0 and prog.captured
    x.fill_(2.0)
    assert prog().sum().item() == 24.0 and prog.replays == 1


def test_crash_and_swap_replay_the_captured_programs(cuda):
    """On the card, a crash (``serve_decode@2=error``) and a weight swap
    keep every captured graph: the same program objects and graphs replay
    (the grid is zeroed and the weights copied in place), the ledger does
    not grow, and the tokens are solo greedy's on the weights served."""
    from bigdl_tpu_torch import convert
    from bigdl_tpu_torch.utils.faults import inject_faults
    lm = _lm().evaluate()
    lm2 = TransformerLM(VOCAB, E, HEADS, LAYERS, MAX_LEN,
                        generator=torch.Generator().manual_seed(1),
                        device="cuda").evaluate()
    tree2 = convert.nest(lm2, {n: p.detach().cpu().numpy()
                               for n, p in lm2.named_parameters()})
    r = np.random.default_rng(1)
    reqs = [r.integers(0, VOCAB, n) for n in (5, 20, 40)]
    with ServingEngine(lm, MAX_LEN, slots=3) as eng:
        for p in reqs:
            eng.submit(p, 2).result(120)
        progs = dict(eng._programs._programs)
        graphs = {k: p._graph for k, p in progs.items()}
        keys = eng.stats()["compiled_programs"]
        with inject_faults("serve_decode@2=error") as plan:
            got = [h.result(120).tokens
                   for h in [eng.submit(p, 8) for p in reqs]]
        assert plan.unfired() == [] and eng.stats()["respawns"] == 1
        eng.swap_weights(tree2, version=2)
        got2 = [h.result(120).tokens
                for h in [eng.submit(p, 8) for p in reqs]]
        assert eng.stats()["compiled_programs"] == keys
        assert eng._programs._programs == progs
        assert all(p._graph is graphs[k] for k, p in progs.items())
    for p, a, b in zip(reqs, got, got2):
        np.testing.assert_array_equal(
            a, greedy_generate(lm, p[None], 8)[0].cpu().numpy())
        np.testing.assert_array_equal(
            b, greedy_generate(lm2, p[None], 8)[0].cpu().numpy())


@pytest.mark.parametrize("explicit", [False, True],
                         ids=["default-generator", "explicit-generator"])
def test_replays_draw_fresh_dropout_masks(cuda, explicit):
    """A training-mode forward with dropout as a program: each replay draws
    new masks (the default CUDA generator is tracked by the capture; an
    explicit one is registered with the graph), and the trainer's replayed
    steps on one batch give different losses."""
    lm = _lm(dropout=0.1, **LLAMA)
    gen = None
    if explicit:
        gen = torch.Generator(device="cuda").manual_seed(5)
        for m in lm.modules():
            if isinstance(m, Dropout):
                m.generator = gen
    x = torch.from_numpy(_batches(1)[0].input).cuda()
    with torch.no_grad():
        prog = Program(("dropout_forward", explicit),
                       lambda t: lm(t)[1], (x,), "cuda",   # the hidden
                       generators=dropout_generators(lm))
        assert prog.generators == ((gen,) if explicit else ())
        prog()                               # warm-up, then capture
        first, second = prog().clone(), prog().clone()
    assert first.isfinite().all() and second.isfinite().all()
    assert not torch.equal(first, second)
    (b,) = _batches(1)
    opt = LocalOptimizer(lm, DataSet.array([]), lm_criterion(True, 24)) \
        .set_optim_method(Adam(learningrate=0.0))
    inp, target = (torch.from_numpy(a).cuda() for a in (b.input, b.target))
    losses = [opt.train_step(inp, target) for _ in range(3)]
    assert opt._step_program.replays == 2
    assert len(set(losses)) == 3 and all(np.isfinite(losses))


def _resnet_steps(batches, replayed: bool):
    """Four SGD steps of a CIFAR ResNet-20 from one seed: through the
    trainer's captured program (the first step warms up and captures, the
    rest replay), or its step function called eagerly. Returns the losses
    and the running statistics after each step."""
    model = ResNet(10, {"depth": 20}, generator=torch.Generator().manual_seed(
        0), device="cuda")
    opt = LocalOptimizer(model, DataSet.array([]), ClassNLLCriterion()) \
        .set_optim_method(SGD(learningrate=0.1, momentum=0.9, dampening=0.0,
                              weightdecay=1e-4))
    if not replayed:
        named, scales, mask = opt._prepare_step()
        step = opt._make_step_fn(named, scales, mask)
    losses, stats = [], []
    for k, (x, y) in enumerate(batches):
        if replayed:
            losses.append(opt.train_step(x, y))
        else:
            losses.append(float(step(x, y, hyper_tensor(
                opt._method.hyper(k, opt._ostate), list(named.values())))))
        stats.append({n: b.clone() for n, b in model.named_buffers()})
    if replayed:
        assert opt._step_program.captured
        assert opt._step_program.replays == len(batches) - 1
    return losses, stats, model


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnet_step_replays_equal_eager_with_statistics(cuda, dtype, fmt):
    """A ResNet-20 step replayed against the same steps run eagerly, with
    cuDNN's deterministic algorithms (its autotuned backward algorithms may
    sum with atomics): losses, parameters and the running statistics after
    every step, bit for bit; the statistics stay fp32 under bf16."""
    r = np.random.default_rng(2)
    shape = (8, 32, 32, 3) if fmt == "NHWC" else (8, 3, 32, 32)
    batches = [(torch.from_numpy(r.normal(size=shape).astype(np.float32))
                .cuda(), torch.from_numpy(r.integers(0, 10, 8)).cuda())
               for _ in range(4)]
    deterministic = torch.backends.cudnn.deterministic
    layout.set_image_format(fmt)
    Engine.init(compute_dtype=dtype)
    try:
        torch.backends.cudnn.deterministic = True
        got, got_stats, model = _resnet_steps(batches, replayed=True)
        want, want_stats, ref = _resnet_steps(batches, replayed=False)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        layout.set_image_format(None)
        Engine.reset()
    assert got == want
    for step, (a, b) in enumerate(zip(got_stats, want_stats)):
        for name in a:
            assert a[name].dtype == torch.float32
            assert torch.equal(a[name], b[name]), (step, name)
    assert step == 3 and not torch.equal(got_stats[0]["0.1.running_mean"],
                                         got_stats[1]["0.1.running_mean"])
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), name


def _ptb_steps(batches, replayed: bool):
    """Three steps of the PTB main's training (``SGD(1.0)``, clip-norm 5)
    on a small ``PTBModel`` from one seed, through the captured program or
    its step function called eagerly: the losses and the model."""
    from bigdl_tpu_torch.models.rnn import PTBModel
    from bigdl_tpu_torch.nn import TimeDistributedCriterion
    model = PTBModel(200, 32, num_layers=2,
                     generator=torch.Generator().manual_seed(0),
                     device="cuda")
    crit = TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)
    opt = (LocalOptimizer(model, DataSet.array([]), crit)
           .set_optim_method(SGD(learningrate=1.0))
           .set_gradient_clipping_by_l2_norm(5.0))
    if replayed:
        losses = [opt.train_step(x, y) for x, y in batches]
        assert opt._step_program.captured
        assert opt._step_program.replays == len(batches) - 1
        return losses, model
    named, scales, mask = opt._prepare_step()
    step = opt._make_step_fn(named, scales, mask)
    return [float(step(x, y, hyper_tensor(opt._method.hyper(k, opt._ostate),
                                          list(named.values()))))
            for k, (x, y) in enumerate(batches)], model


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ptb_lstm_step_replays_equal_eager(cuda, dtype):
    """The PTB LSTM's whole step (the unrolled recurrence of both layers,
    forward and backward, the clip and the update) as one captured
    program, replayed against the same steps run eagerly: losses and
    parameters bit for bit, the parameters fp32 masters under bf16 too."""
    r = np.random.default_rng(3)
    batches = [tuple(torch.from_numpy(r.integers(0, 200, (8, 12))).cuda()
                     for _ in range(2)) for _ in range(3)]
    Engine.init(compute_dtype=dtype)
    try:
        got, model = _ptb_steps(batches, replayed=True)
        want, ref = _ptb_steps(batches, replayed=False)
    finally:
        Engine.reset()
    assert got == want and all(np.isfinite(got))
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        assert p.dtype == torch.float32
        assert torch.equal(p, q), name


def _replayed(model, crit, method, batches):
    """The trainer's step over ``batches`` (inputs on the card) through its
    captured program: the losses."""
    opt = LocalOptimizer(model, DataSet.array([]), crit) \
        .set_optim_method(method())
    got = [opt.train_step(x, y) for x, y in batches]
    assert opt._step_program.captured
    assert opt._step_program.replays == len(batches) - 1
    return got


def _eager(model, crit, method, batches):
    """The same steps through the step function called eagerly."""
    opt = LocalOptimizer(model, DataSet.array([]), crit) \
        .set_optim_method(method())
    named, scales, mask = opt._prepare_step()
    step = opt._make_step_fn(named, scales, mask)
    return [float(step(x, y, hyper_tensor(opt._method.hyper(k, opt._ostate),
                                          list(named.values()))))
            for k, (x, y) in enumerate(batches)]


def _lora_lm():
    from bigdl_tpu_torch.nn import apply_lora
    lm = _lm()
    apply_lora(lm, rank=4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():           # trained adapters: B away from 0
        for n, p in lm.named_parameters():
            if "lora" in n and n.endswith("_b"):
                p.normal_(0.0, 0.02, generator=torch.Generator(
                    "cuda").manual_seed(len(n)))
    return lm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_step_replays_equal_eager(cuda, dtype):
    """A LoRA step (every attention and Linear adapted, the rest frozen):
    replayed bit for bit against the same steps run eagerly, the frozen
    base untouched, and all five kernels launched."""
    batches = [(torch.from_numpy(b.input).cuda(),
                torch.from_numpy(b.target).cuda()) for b in _batches(3)]

    def sgd():
        return SGD(learningrate=0.01, momentum=0.9, dampening=0.0)

    Engine.init(compute_dtype=dtype)
    try:
        lm = _lora_lm()
        base = {n: p.detach().clone() for n, p in lm.named_parameters()}
        kernels.reset_launch_counts()
        got = _replayed(lm, lm_criterion(), sgd, batches)
        counts = kernels.launch_counts()
        ref = _lora_lm()
        want = _eager(ref, lm_criterion(), sgd, batches)
    finally:
        Engine.reset()
    assert got == want and all(np.isfinite(got))
    scales = lm.grad_scales()
    for (name, p), q in zip(lm.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(p, base[name]) == (scales[name] == 0.0), name
    assert all(n > 0 for k, n in counts.items()
               if k not in ("nms_mask_words", "nms_sweep")), counts


def _seq2seq(gen_seed=0):
    from bigdl_tpu_torch.models.transformer import Transformer
    return Transformer(VOCAB, VOCAB, E, HEADS, 1, 1, max_len=MAX_LEN,
                       generator=torch.Generator().manual_seed(gen_seed),
                       device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seq2seq_step_replays_equal_eager(cuda, dtype):
    """The seq2seq Transformer's step on a two-tensor input (source, and
    the decoder's input one longer): replayed bit for bit against eager
    steps; the encoder launches the flash kernels non-causal, the decoder
    causal at a ragged length."""
    from bigdl_tpu_torch.models.transformer import train as s2s
    r = np.random.default_rng(4)
    batches = [((torch.from_numpy(r.integers(0, VOCAB, (2, 32))).cuda(),
                 torch.from_numpy(r.integers(0, VOCAB, (2, 33))).cuda()),
                torch.from_numpy(r.integers(0, VOCAB, (2, 33))).cuda())
               for _ in range(3)]

    def adam():
        return Adam(learningrate=1e-3)

    Engine.init(compute_dtype=dtype)
    try:
        model = _seq2seq()
        kernels.reset_launch_counts()
        got = _replayed(model, s2s.criterion(), adam, batches)
        variants = kernels.launch_counts_by_variant()
        ref = _seq2seq()
        want = _eager(ref, s2s.criterion(), adam, batches)
    finally:
        Engine.reset()
    assert got == want and all(np.isfinite(got))
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), name
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert variants[name].get("full", 0) > 0, (name, variants)
        assert variants[name].get("causal", 0) > 0, (name, variants)


def test_lora_engine_swap_of_adapter_leaves_keeps_programs(cuda):
    """An engine serving an adapted LM: a swap that writes new adapter
    leaves reaches the captured programs without capturing again, and the
    tokens are then solo greedy's on the swapped weights."""
    from bigdl_tpu_torch import convert
    lm = _lora_lm().evaluate()
    tuned = _lora_lm().evaluate()
    with torch.no_grad():
        for n, p in tuned.named_parameters():
            if "lora" in n:
                p.add_(0.05 * torch.randn(p.shape, device="cuda",
                                          generator=torch.Generator(
                                              "cuda").manual_seed(7)))
    tree = convert.nest(tuned, {n: p.detach().cpu().numpy()
                                for n, p in tuned.named_parameters()})
    r = np.random.default_rng(2)
    reqs = [r.integers(0, VOCAB, n) for n in (5, 20, 40)]
    with ServingEngine(lm, MAX_LEN, slots=3) as eng:
        for p in reqs:
            eng.submit(p, 2).result(120)
        progs = dict(eng._programs._programs)
        keys = eng.stats()["compiled_programs"]
        eng.swap_weights(tree, version=2)
        got = [h.result(120).tokens
               for h in [eng.submit(p, 8) for p in reqs]]
        assert eng.stats()["compiled_programs"] == keys
        assert eng._programs._programs == progs
    for p, a in zip(reqs, got):
        np.testing.assert_array_equal(
            a, greedy_generate(tuned, p[None], 8)[0].cpu().numpy())


def _ncf(sharded=True):
    from bigdl_tpu_torch.models.ncf import NeuralCF
    return NeuralCF(500, 300, user_embed=32, item_embed=32,
                    hidden_layers=(64, 32), mf_embed=16, sharded=sharded,
                    generator=torch.Generator().manual_seed(0),
                    device="cuda")


def _ncf_batches(n=4, rows=1024):
    g = torch.Generator().manual_seed(3)
    return [(torch.stack([torch.randint(1, 501, (rows,), generator=g),
                          torch.randint(1, 301, (rows,), generator=g)],
                         1).int().cuda(),
             torch.randint(0, 2, (rows,), generator=g).int().cuda())
            for _ in range(n)]


def test_recsys_sparse_step_replays_equal_eager(cuda):
    """NeuralCF's sparse step (ShardedEmbedding tables, Adam): the captured
    program replayed bit for bit against the same steps run eagerly, the
    tables' slots included, and none of the five kernels launched."""
    batches = _ncf_batches()
    model = _ncf()
    kernels.reset_launch_counts()
    opt = LocalOptimizer(model, DataSet.array([]), ClassNLLCriterion()) \
        .set_optim_method(Adam(learningrate=0.01))
    got = [opt.train_step(x, y) for x, y in batches]
    assert opt._step_program.captured
    assert opt._step_program.replays == len(batches) - 1
    assert type(opt._method).__name__ == "SparseEmbeddingUpdate"
    ref = _ncf()
    ropt = LocalOptimizer(ref, DataSet.array([]), ClassNLLCriterion()) \
        .set_optim_method(Adam(learningrate=0.01))
    named, scales, mask = ropt._prepare_step()
    step = ropt._make_step_fn(named, scales, mask, batches[0][0])
    want = [float(step(x, y, hyper_tensor(
        ropt._method.hyper(k, ropt._ostate), list(named.values()))))
        for k, (x, y) in enumerate(batches)]
    assert got == want and all(np.isfinite(got))
    for (n, p), q in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), n
    for key, slots in opt._ostate["embed"].items():
        for name, s in slots.items():
            assert torch.equal(s[0], ropt._ostate["embed"][key][name][0])
    assert not any(kernels.launch_counts().values())


def test_recsys_dedup_and_sharded_lookup_capture_without_host_sync(cuda):
    """``dedup_ids`` and a ShardedEmbedding forward and backward run under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host sync) and capture
    as a program whose replay equals the eager run on new ids."""
    from bigdl_tpu_torch.nn import LookupTable
    from bigdl_tpu_torch.parallel.embedding import ShardedEmbedding, dedup_ids
    table = ShardedEmbedding(LookupTable(1000, 16, max_norm=2.0)).cuda()
    ids = torch.randint(1, 1001, (64, 8), device="cuda")

    def fn(x):
        uids, inv = dedup_ids(x - 1, 1000)
        out = table(x)
        (grad,) = torch.autograd.grad((out * out).sum(), [table.table.weight])
        return uids, inv, out.detach(), grad

    fn(ids)                       # warm-up: lazy CUDA state, no capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = fn(ids)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    prog = Program(("dedup",), fn, (ids.clone(),), "cuda")
    prog()
    new = torch.randint(1, 1001, (64, 8), device="cuda")
    prog.inputs[0].copy_(new)
    got = [t.clone() for t in prog()]
    want = fn(new)
    assert prog.captured
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    uids, inv = got[0], got[1]
    assert torch.equal(uids[inv], new.reshape(-1).long() - 1)
    assert eager[0].shape == (512,)


def _ssd_batches(n_batches=3, batch=4, img=32):
    from bigdl_tpu_torch.models.ssd.train import make_dataset
    rng = np.random.RandomState(4)
    out = []
    for _ in range(n_batches):
        s = make_dataset(batch, img, rng)
        out.append((torch.from_numpy(np.stack([x.feature[0] for x in s]))
                    .cuda(),
                    torch.from_numpy(np.stack([x.label[0] for x in s]))
                    .cuda()))
    return out


def _ssd():
    from bigdl_tpu_torch.models.ssd import SSD
    return SSD(3, img_size=32, base_channels=(8, 16, 16),
               aspect_ratios=(2.0,), generator=torch.Generator().manual_seed(1),
               device="cuda")


def test_detection_ssd_step_replays_equal_eager(cuda):
    """The SSD's training step (the MultiBox matching, the mining's stable
    sort and the loss with its gradient) as one captured program, replayed
    against the same steps run eagerly: losses and parameters bit for
    bit (cuDNN deterministic)."""
    from bigdl_tpu_torch.nn import MultiBoxCriterion
    batches = _ssd_batches()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model, ref = _ssd(), _ssd()
    crit = MultiBoxCriterion(n_classes=3)
    got = _replayed(model, crit, lambda: Adam(learningrate=1e-3), batches)
    want = _eager(ref, crit, lambda: Adam(learningrate=1e-3), batches)
    assert got == want and all(np.isfinite(got))
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), name


def _nms_counts() -> tuple:
    counts = kernels.launch_counts()
    return counts["nms_mask_words"], counts["nms_sweep"]


def test_detection_maskrcnn_forward_captures_and_replays_bitwise(cuda):
    """Mask R-CNN's whole forward (the RPN's three NMS calls, the class
    rows' one, the poolers) runs with no host sync and captures as one
    program whose replay on a new image equals its eager run, with four
    launches of each NMS kernel an image."""
    from bigdl_tpu_torch.models.maskrcnn import MaskRCNN
    model = MaskRCNN(5, image_size=(64, 64), out_channels=8,
                     post_nms_topn=30, max_per_image=10,
                     generator=torch.Generator().manual_seed(3),
                     device="cuda").evaluate()

    def fn(x):
        with torch.no_grad():
            return tuple(model(x).values())

    x = torch.randn(1, 3, 64, 64, device="cuda")
    fn(x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        before = _nms_counts()
        fn(x)
        assert _nms_counts() == tuple(n + 4 for n in before)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    prog = Program(("maskrcnn",), fn, (x.clone(),), "cuda")
    prog()
    new = torch.randn(1, 3, 64, 64, device="cuda")
    prog.inputs[0].copy_(new)
    before = _nms_counts()
    got = [t.clone() for t in prog()]
    assert prog.captured and _nms_counts() == tuple(n + 4 for n in before)
    for g, w in zip(got, fn(new)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["weight_only", "static", "dynamic"])
def test_quantized_lm_decode_programs_capture(cuda, mode):
    """A ``quantize(mode)`` LM behind the engine: its prefill and decode
    programs capture (the int8 products through ``torch._int_mm``) and
    serve the model's own greedy tokens (one request at a time: the
    dynamic mode's scale spans the whole slot grid)."""
    from bigdl_tpu_torch.nn import calibrate
    lm = _lm().evaluate()
    q = lm.quantize(mode).evaluate()
    r = np.random.default_rng(1)
    p = r.integers(0, VOCAB, 12)
    if mode == "static":
        calibrate(q, [torch.from_numpy(p[None]).cuda()])
    with ServingEngine(q, MAX_LEN, slots=2) as eng:
        res = eng.submit(p, 6).result(120)
        stats = eng.stats()
    want = greedy_generate(q, p[None], 6)[0].cpu().numpy()
    np.testing.assert_array_equal(res.tokens, want)
    progs = eng._programs._programs
    assert stats["compiled_programs"] >= 2
    assert all(pr.captured for pr in progs.values())


def test_elastic_fsdp_step_gathers_a_layer_at_a_time_captured(cuda):
    """fsdp at world 1 on NCCL holds its blocks between steps and gathers
    each layer's weights around its run: the step is still one captured
    program, and 4 steps are LocalOptimizer's bit for bit."""
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    batches = _batches(4)

    def run(cls, **kw):
        ds = DataSet.array(batches)
        ds.shuffle = lambda: None
        lm = _lm()
        opt = (cls(lm, ds, lm_criterion(), **kw)
               .set_optim_method(Adam(learningrate=1e-3))
               .set_end_when(Trigger.max_iteration(4)))
        losses, peaks = [], []
        run_steps = opt._run_steps

        def recorded(steps):
            out = run_steps(steps)
            losses.extend(out)
            if hasattr(opt, "fsdp_bytes"):
                peaks.append(opt.fsdp_bytes()["gathered_peak"])
            return out

        opt._run_steps = recorded
        opt.optimize()
        return opt, losses, peaks, {n: p.detach().clone()
                                    for n, p in lm.named_parameters()}

    Engine.init(backend="nccl")
    try:
        dopt, dlosses, peaks, dparams = run(DistriOptimizer,
                                            parameter_sync="fsdp")
        _, llosses, _, lparams = run(LocalOptimizer)
    finally:
        Engine.shutdown_distributed()
        Engine.reset()
    assert dopt._step_program.captured and dopt._step_program.replays == 3
    assert 0 < max(peaks) < sum(p.numel() * 4 for p in lparams.values())
    assert dlosses == llosses
    for n, p in lparams.items():
        assert torch.equal(dparams[n], p), n


def test_elastic_save_under_a_captured_step_resumes_bitwise(cuda, tmp_path):
    """zero1 at world 1 on NCCL with elastic saves every 2 steps of a
    captured step: versions 2 and 4 commit, and a resume from version 2
    takes steps 3 and 4 bit for bit."""
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    from bigdl_tpu_torch.utils import elastic_ckpt
    import shutil
    batches = _batches(4)

    def run(n, seed=0):
        ds = DataSet.array(batches)
        ds.shuffle = lambda: None
        torch.manual_seed(seed)
        lm = _lm()
        opt = (DistriOptimizer(lm, ds, lm_criterion(),
                               parameter_sync="zero1")
               .set_optim_method(Adam(learningrate=1e-3))
               .set_end_when(Trigger.max_iteration(n)))
        opt.set_checkpoint(str(tmp_path), Trigger.several_iteration(2),
                           backend="elastic")
        losses = []
        run_steps = opt._run_steps

        def recorded(steps):
            out = run_steps(steps)
            losses.extend(out)
            return out

        opt._run_steps = recorded
        opt.optimize(resume="auto")
        opt._join_checkpoint_writer()
        return opt, losses, {n: p.detach().clone()
                             for n, p in lm.named_parameters()}

    Engine.init(backend="nccl")
    try:
        opt, losses, params = run(4)
        assert opt._step_program.captured
        assert elastic_ckpt.complete_versions(str(tmp_path)) == [2, 4]
        shutil.rmtree(tmp_path / "elastic.4")
        _, again, params2 = run(4, seed=1)
    finally:
        Engine.shutdown_distributed()
        Engine.reset()
    assert again == losses[2:]
    for n, p in params.items():
        assert torch.equal(params2[n], p), n
