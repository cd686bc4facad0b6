"""LoRA in the port (``nn/lora.py``, ``MultiHeadAttention``'s adapters,
the LM main's ``--lora``, serving a LoRA registry artifact) against
``bigdl_tpu/`` on the CPU.

Weights move from JAX by path (``convert.load_jax_params``); the adapters'
``B`` are perturbed away from their zero init so that every adapter path
carries signal. Tolerances: forwards and merged weights within 1e-6
(fp32, the same formula); one training step's loss within 1e-5 relative
and every adapter gradient within 1e-4 relative (Frobenius) of JAX's
``jax.grad``; the frozen base bitwise unchanged by the step.

The registry repair is pinned here: on ``TransformerLM(64, 32, 4, 2)`` at
rank 4, JAX's ``lora_delta`` keeps 10 of the 18 adapter leaves (it drops
the attention's ``lora_<weight>_a``/``_b``), the port's all 18.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.models.transformerlm import lm_criterion as jax_lm_criterion
from bigdl_tpu.utils import model_registry as jax_registry
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models.transformerlm import TransformerLM, lm_criterion
from bigdl_tpu_torch.models.transformerlm import train as lm_main
from bigdl_tpu_torch.serving import (
    PromotionController, PromotionCriterion, ServingEngine,
)
from bigdl_tpu_torch.utils import file as port_file
from bigdl_tpu_torch.utils.model_registry import ModelRegistry, lora_delta
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

VOCAB, E, HEADS, LAYERS, T, RANK = 64, 32, 4, 2, 16, 4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the models here are small, and the suite's
    workers share the host's cores (more threads only contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_adapters(tree, seed, scale=0.05):
    """``tree`` with gaussian noise on every adapter leaf (a trained
    adapter: B away from 0)."""
    r = np.random.default_rng(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else (
            np.asarray(v) + r.normal(0, scale, np.shape(v)).astype(np.float32)
            if k.startswith("lora") else np.asarray(v))
            for k, v in node.items()}
    return walk(tree)


def _pair(seed=3, rank=RANK):
    """A JAX TransformerLM adapted at ``rank`` with perturbed adapters, and
    the port's adapted LM holding the same weights."""
    JaxRNG.set_seed(seed)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS,
                           num_layers=LAYERS, max_len=T)
    n_jax = jnn.apply_lora(jlm, rank=rank)
    jlm.set_params(jax.tree_util.tree_map(
        jnp.asarray, _perturb_adapters(_host(jlm.get_params()), seed)))
    tlm = TransformerLM(VOCAB, E, HEADS, LAYERS, T, device="cpu")
    n_port = tnn.apply_lora(tlm, rank=rank)
    convert.load_jax_params(tlm, _host(jlm.get_params()))
    return jlm, tlm, n_jax, n_port


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(
        np.int32)


def _paths(tree):
    return sorted(convert.flatten_tree(tree))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------ the layers
def _jax_attention(gqa):
    return jnn.MultiHeadAttention(16, 4, causal=True,
                                  num_kv_heads=2 if gqa else None)


def _port_attention(gqa):
    return tnn.MultiHeadAttention(16, 4, causal=True,
                                  num_kv_heads=2 if gqa else None)


@pytest.mark.parametrize("kind", ["linear", "attention", "attention_gqa"])
def test_adapters_equal_jax_at_init_and_after_add_lora(kind):
    JaxRNG.set_seed(11)
    r = np.random.default_rng(11)
    if kind == "linear":
        jbase, tbase = jnn.Linear(8, 6), tnn.Linear(8, 6)
        xs = [r.normal(size=(3, 8)), r.normal(size=(8,)),
              r.normal(size=(2, 2, 4))]           # 2-D, 1-D, flattened
    else:
        jbase, tbase = (_jax_attention(kind.endswith("gqa")),
                        _port_attention(kind.endswith("gqa")))
        xs = [r.normal(size=(2, 5, 16))]
    xs = [x.astype(np.float32) for x in xs]
    convert.load_jax_params(tbase, _host(jbase.get_params()))
    plain = [tbase(torch.from_numpy(x)).detach().numpy() for x in xs]
    if kind == "linear":
        jm = jnn.LoRALinear.from_linear(jbase, rank=2, alpha=3.0)
        tm = tnn.LoRALinear.from_linear(tbase, rank=2, alpha=3.0)
    else:
        jm, tm = jbase.add_lora(2, alpha=3.0), tbase.add_lora(2, alpha=3.0)
    assert _paths(_host(jm.get_params())) == sorted(
        n for n, _ in tm.named_parameters())
    # B = 0 at init: the adapted layer is its base
    for x, want in zip(xs, plain):
        np.testing.assert_array_equal(tm(torch.from_numpy(x)).detach()
                                      .numpy(), want)
    jm.set_params(jax.tree_util.tree_map(
        jnp.asarray, _perturb_adapters(_host(jm.get_params()), 12, 0.3)))
    convert.load_jax_params(tm, _host(jm.get_params()))
    jm.evaluate()
    for x in xs:
        want = np.asarray(jm.forward(jnp.asarray(x)))
        got = tm(torch.from_numpy(x)).detach().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6)
    jsc = {".".join(k.key for k in p): v for p, v in
           jax.tree_util.tree_leaves_with_path(jm.grad_scales())}
    assert tm.grad_scales() == jsc


def _graph(pkg):
    inp = pkg.Input()
    h = pkg.Linear(6, 5).inputs(inp)
    out = pkg.Linear(5, 3).inputs(pkg.ReLU().inputs(h))
    return pkg.Graph([inp], [out])


def _mlp(pkg):
    return (pkg.Sequential().add(pkg.Linear(8, 16)).add(pkg.ReLU())
            .add(pkg.TimeDistributed(pkg.Linear(16, 4))))


_MODELS = {
    "lm": (lambda: JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS,
                                    num_layers=LAYERS, max_len=T),
           lambda: TransformerLM(VOCAB, E, HEADS, LAYERS, T, device="cpu")),
    "graph": (lambda: _graph(jnn), lambda: _graph(tnn)),
    "mlp_timedistributed": (lambda: _mlp(jnn), lambda: _mlp(tnn)),
    "attention_root": (lambda: _jax_attention(False),
                       lambda: _port_attention(False)),
}


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_apply_lora_count_paths_and_scales_equal_jax(name):
    JaxRNG.set_seed(7)
    jm, tm = (make() for make in _MODELS[name])
    n_jax, n_port = jnn.apply_lora(jm, rank=2), tnn.apply_lora(tm, rank=2)
    assert n_port == n_jax
    assert _paths(_host(jm.get_params())) == sorted(
        n for n, _ in tm.named_parameters())
    jsc = {".".join(k.key for k in p): v for p, v in
           jax.tree_util.tree_leaves_with_path(jm.grad_scales())}
    assert tm.grad_scales() == jsc
    # what JAX leaves alone stays (the LoRALinear is not re-adapted; an
    # adapted attention keeps its adapters)
    with pytest.raises(ValueError, match="no nn.Linear"):
        jnn.apply_lora(jm, rank=2)
    with pytest.raises(ValueError, match="no nn.Linear"):
        tnn.apply_lora(tm, rank=2)


@pytest.mark.parametrize("case", ["no_linear", "bare_linear", "bare_lora",
                                  "reset_and_merge"])
def test_refusals_reset_and_merge_like_jax(case):
    if case == "no_linear":
        m = tnn.Sequential().add(tnn.SpatialConvolution(1, 2, 3, 3))
        with pytest.raises(ValueError, match="no nn.Linear"):
            tnn.apply_lora(m, rank=2)
        assert not m[0].is_frozen()          # a refusal mutates nothing
    elif case == "bare_linear":
        with pytest.raises(ValueError, match="from_linear"):
            tnn.apply_lora(tnn.Linear(4, 4), rank=2)
    elif case == "bare_lora":
        lora = tnn.LoRALinear.from_linear(tnn.Linear(4, 4), rank=2)
        with pytest.raises(ValueError, match="to_linear"):
            tnn.merge_lora(lora)
        with pytest.raises(ValueError, match="rank"):
            tnn.MultiHeadAttention(16, 4).add_lora(0)
    else:
        m = tnn.MultiHeadAttention(16, 4, causal=True, lora_rank=2)
        assert m.lora_rank == 2 and m.lora_alpha == 2.0
        with pytest.raises(ValueError, match="already"):
            m.add_lora(2)
        m.reset(torch.Generator().manual_seed(0))   # adapters survive
        names = {n for n, _ in m.named_parameters()}
        assert {"lora_qkv_weight_a", "lora_out_weight_b"} <= names
        assert not m.lora_qkv_weight_b.any()
        assert tnn.merge_lora(m) == 1
        assert not any(n.startswith("lora") for n, _ in m.named_parameters())
        assert set(m.grad_scales()) == {n for n, _ in m.named_parameters()}


def test_merge_lora_gives_jax_merged_weights_and_the_adapted_forward():
    jlm, tlm, n_jax, n_port = _pair(seed=5)
    x = _ids(5, (2, T))
    tlm.eval()
    adapted = tlm(torch.from_numpy(x)).detach().numpy()
    assert jnn.merge_lora(jlm) == n_jax
    assert tnn.merge_lora(tlm) == n_port
    want = convert.flatten_tree(_host(jlm.get_params()))
    got = {n: p.detach().numpy() for n, p in tlm.named_parameters()}
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=1e-6, err_msg=n)
    assert not any(isinstance(m, tnn.LoRALinear) for m in tlm.modules())
    np.testing.assert_allclose(tlm(torch.from_numpy(x)).detach().numpy(),
                               adapted, atol=1e-5)


# -------------------------------------------------------------- training
def test_one_step_loss_adapter_grads_and_frozen_base_equal_jax():
    jlm, tlm, _, _ = _pair(seed=8)
    x, y = _ids(8, (4, T)), _ids(9, (4, T))
    params = jlm.get_params()
    crit = jax_lm_criterion()

    def jax_loss(p):
        out, _ = jlm.apply(p, jlm.get_state(), jnp.asarray(x),
                           training=True, rng=None)
        return crit.apply(out, jnp.asarray(y))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    want_grads = convert.flatten_tree(_host(want_grads))
    before = {n: p.detach().clone() for n, p in tlm.named_parameters()}
    opt = toptim.LocalOptimizer(tlm, DataSet.array([]), lm_criterion(),
                                device="cpu").set_optim_method(
        toptim.SGD(learningrate=0.1))
    named, scales, mask = opt._prepare_step()
    frozen = frozenset(n for n in named if scales[n] == 0.0)
    train = [n for n in named if n not in frozen]
    assert train and all("lora" in n for n in train)
    loss, grads = opt._loss_and_grads([named[n] for n in train],
                                      torch.from_numpy(x),
                                      torch.from_numpy(y), frozen)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    for n, g in zip(train, grads):
        assert _rel(g.numpy(), want_grads[n]) <= 1e-4, n
    step_loss = opt.train_step(torch.from_numpy(x), torch.from_numpy(y))
    assert step_loss == pytest.approx(float(want_loss), rel=1e-5)
    for n, p in tlm.named_parameters():
        if n in frozen:
            assert torch.equal(p, before[n]), n
        else:
            assert not torch.equal(p, before[n]), n
    # the frozen leaves' slots are 0-size, JAX's trimmed layout
    assert mask is not None and mask.count(True) == len(train)


def test_frozen_backward_is_not_computed():
    """The base's weight-gradient products are never computed: the
    backward of a LoRA step (rank 1) costs the input gradients and the
    adapters' products, well under a full fine-tune's backward, which
    also forms every weight's gradient (a frozen base whose gradient were
    computed and then dropped would cost more than the full backward)."""
    e, vocab = 64, 256

    def backward_flops(lora):
        torch.manual_seed(0)
        m = TransformerLM(vocab, e, HEADS, 1, T, device="cpu")
        if lora:
            tnn.apply_lora(m, rank=1)
        opt = toptim.LocalOptimizer(m, DataSet.array([]), lm_criterion(),
                                    device="cpu")
        named, scales, _ = opt._prepare_step()
        frozen = frozenset(n for n in named if scales[n] == 0.0)
        r = np.random.default_rng(1)
        loss = opt._loss(frozen, torch.from_numpy(r.integers(0, vocab, (4, T))),
                         torch.from_numpy(r.integers(0, vocab, (4, T))))
        with FlopCounterMode(display=False) as fc:
            torch.autograd.grad(loss, [named[n] for n in named
                                       if n not in frozen])
        return fc.get_total_flops()

    full, lora = backward_flops(False), backward_flops(True)
    assert lora < 0.7 * full, (lora, full)


def _lm_pairs(n):
    x = _ids(21, (n, T))
    return [(x[i], np.roll(x[i], -1)) for i in range(n)]


def test_lora_checkpoint_holds_jax_layout_and_resumes(tmp_path):
    """The port's checkpoint of a LoRA run holds JAX's layout: its slots
    are shaped as JAX's ``init_state_trimmed`` makes them for the same
    adapted model (0-size for every frozen leaf); a fresh model resumed
    from iteration 2 ends bitwise where the uninterrupted run ended."""
    jlm, tlm, _, _ = _pair(seed=13)
    init = _host(jlm.get_params())
    pairs = _lm_pairs(8)

    def run(model, resume=None):
        data = (DataSet.array(Sample(a, b) for a, b in pairs)
                >> SampleToMiniBatch(4))
        opt = (toptim.LocalOptimizer(model, data, lm_criterion(),
                                     device="cpu")
               .set_optim_method(toptim.SGD(learningrate=0.1, momentum=0.9,
                                            dampening=0.0))
               .set_end_when(toptim.Trigger.max_iteration(4))
               .set_checkpoint(str(tmp_path),
                               toptim.Trigger.several_iteration(2)))
        opt.optimize(resume=resume)
        return opt

    RandomGenerator.set_seed(21)
    done = run(tlm)
    payload = port_file.load(str(tmp_path / "checkpoint.2.pkl"))
    trainable = jax.tree_util.tree_map(lambda s: s != 0.0,
                                       jlm.grad_scales())
    want = joptim.SGD(learningrate=0.1, momentum=0.9).init_state_trimmed(
        jlm.get_params(), trainable)
    shapes = jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), want)
    assert jax.tree_util.tree_map(lambda a: tuple(np.shape(a)),
                                  payload["ostate"]) == shapes
    frozen = [n for n, v in tlm.grad_scales().items() if v == 0.0]
    assert frozen and all(
        np.size(convert.flatten_tree(payload["ostate"]["v"])[n]) == 0
        for n in frozen)
    (tmp_path / "checkpoint.4.pkl").unlink()
    resumed = TransformerLM(VOCAB, E, HEADS, LAYERS, T, device="cpu")
    tnn.apply_lora(resumed, rank=RANK)
    convert.load_jax_params(resumed, init)
    RandomGenerator.set_seed(21)
    again = run(resumed, resume="auto")
    assert again.state["loss"] == done.state["loss"]
    for (n, p), q in zip(tlm.named_parameters(), resumed.parameters()):
        assert torch.equal(p, q), n


def test_lm_main_lora_trains_two_steps(capsys):
    assert not hasattr(lm_main, "UNPORTED_FLAGS")
    loss = lm_main.main(["--device", "cpu", "-b", "4", "--seq-len", "16",
                         "--max-iteration", "2", "--lora", "2",
                         "--synthetic-tokens", "2000"])
    out = capsys.readouterr().out
    assert np.isfinite(loss)
    assert "WARNING: --lora without --model-snapshot" in out
    assert "LoRA: adapted 7 modules at rank 2" in out
    # --distributed is ported (DistriOptimizer): nothing is refused
    assert lm_main.build_parser().parse_args(["--distributed"]).distributed


# --------------------------------------------------------------- serving
def test_lora_delta_keeps_the_attention_adapters_jax_drops():
    jlm, tlm, _, _ = _pair(seed=3)
    jax_delta = jax_registry.lora_delta(jlm.get_params())
    port_delta = lora_delta(convert.nest(tlm, dict(tlm.named_parameters())))
    assert (len(jax_delta), len(port_delta)) == (10, 18)
    dropped = sorted(set(port_delta) - set(jax_delta))
    assert len(dropped) == 8 and all(
        p.rsplit("/", 1)[-1] in ("lora_qkv_weight_a", "lora_qkv_weight_b",
                                 "lora_out_weight_a", "lora_out_weight_b")
        for p in dropped)
    assert set(jax_delta) < set(port_delta)


def _solo(m, prompt, n):
    return tnn.greedy_generate(m, np.asarray(prompt)[None], n,
                               device="cpu")[0].numpy()


def test_lora_artifact_promotes_into_an_adapted_engine(tmp_path):
    """A base (the adapted LM at init) and a LoRA artifact of its trained
    adapters: the artifact resolves through its base, promotes into an
    engine serving the adapted LM with its programs kept, and the engine
    then serves the fine-tuned model's tokens, as does the merged model."""
    torch.manual_seed(0)
    base = TransformerLM(VOCAB, E, HEADS, LAYERS, 64, device="cpu")
    tnn.apply_lora(base, rank=RANK, generator=torch.Generator().manual_seed(1))
    base_tree = convert.nest(base, dict(base.named_parameters()))
    tuned_tree = _perturb_adapters(convert.map_tree(
        lambda t: t.detach().numpy(), base_tree), 4, 0.2)
    tuned = TransformerLM(VOCAB, E, HEADS, LAYERS, 64, device="cpu")
    tnn.apply_lora(tuned, rank=RANK)
    convert.load_jax_params(tuned, tuned_tree)
    prompts = [_ids(30 + i, 5 + 3 * i) for i in range(3)]
    want = [_solo(tuned, p, 8) for p in prompts]
    assert any(not np.array_equal(_solo(base, p, 8), w)
               for p, w in zip(prompts, want)), "the adapters change nothing"

    reg = ModelRegistry(str(tmp_path), keep=10)
    vb = reg.publish(base_tree)
    vl = reg.publish_lora(lora_delta(tuned_tree), base_version=vb)
    eng = ServingEngine(base, 64, slots=2, buckets=(16, 32, 64),
                        device="cpu")
    try:
        for p in prompts:                        # capture every program
            eng.submit(p, 8).result(120)
        programs = eng.stats()["compiled_programs"]
        ctrl = PromotionController(
            reg, engine=eng, eval_fn=lambda params: 1.0, watch_window_s=0.0,
            criterion=PromotionCriterion(min_metric=0.5))
        res = ctrl.promote(vl, watch=False)
        assert res.promoted and eng.model_version == vl
        got = [eng.submit(p, 8).result(120).tokens for p in prompts]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), w)
        assert eng.stats()["compiled_programs"] == programs
        # a tree without the adapters does not match the adapted engine
        plain = convert.nest(TransformerLM(VOCAB, E, HEADS, LAYERS, 64,
                                           device="cpu"), {
            n: p.detach() for n, p in TransformerLM(
                VOCAB, E, HEADS, LAYERS, 64, device="cpu").named_parameters()})
        with pytest.raises(ValueError, match="does not match"):
            eng.swap_weights(plain, version=99)
    finally:
        eng.shutdown()
    tnn.merge_lora(tuned)
    merged = ServingEngine(tuned, 64, slots=2, buckets=(16, 32, 64),
                           device="cpu")
    try:
        for p, w in zip(prompts, want):
            np.testing.assert_array_equal(
                np.asarray(merged.submit(p, 8).result(120).tokens), w)
    finally:
        merged.shutdown()
