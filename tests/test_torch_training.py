"""The port's training slice against the JAX package, on the CPU.

Criterions, optimizer methods, the host data path, and a 2-layer
TransformerLM trained by the port's ``LocalOptimizer`` against JAX's step
function (``Optimizer._make_step_fn``, called in a loop on the same
batches) and against JAX's ``optimize()``. Inputs are made with numpy and
handed to both; the model's parameters move across by path
(``convert.load_jax_params``). On the CPU the port's kernel dispatchers run
the plain versions. Tolerances: criterions and single updates within 1e-6
(fp32, the same formula); 5-step trajectories within rtol 1e-4 in loss and
atol 1e-4 in parameters (sums of a whole model's backward in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.dataset.text import (
    ptb_windows as jax_ptb_windows, synthetic_ptb as jax_synthetic_ptb,
)
from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.models.transformerlm import lm_criterion as jax_lm_criterion
from bigdl_tpu.utils.engine import Engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.dataset import (
    DataSet, MiniBatch, Sample, SampleToMiniBatch, ptb_windows,
    synthetic_ptb,
)
from bigdl_tpu_torch.models.transformerlm import TransformerLM, lm_criterion
from bigdl_tpu_torch.models.transformerlm import train as train_main
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

VOCAB, E, HEADS, LAYERS, T, BATCH = 64, 32, 2, 2, 16, 4


# ------------------------------------------------------------- criterions
_NLL_CASES = {
    "mean": dict(),
    "sum": dict(size_average=False),
    "weighted-mean": dict(weights="w"),
    "weighted-sum": dict(weights="w", size_average=False),
    "probs": dict(logprob_as_input=False),
    "one-based": dict(one_based=True),
}


@pytest.mark.parametrize("case", sorted(_NLL_CASES))
def test_class_nll_matches_jax(case):
    r = np.random.default_rng(len(case))
    logits = r.normal(size=(6, 5)).astype(np.float32)
    logp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    kw = dict(_NLL_CASES[case])
    if kw.get("weights") == "w":
        kw["weights"] = r.uniform(0.5, 2.0, size=5).astype(np.float32)
    target = r.integers(0, 5, size=6)
    if kw.get("one_based"):
        target = target + 1
    x = np.exp(logp) if kw.get("logprob_as_input") is False else logp
    want = jnn.ClassNLLCriterion(**kw).apply(jnp.asarray(x),
                                             jnp.asarray(target))
    got = tnn.ClassNLLCriterion(**kw).apply(torch.from_numpy(x),
                                            torch.from_numpy(target))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


@pytest.mark.parametrize("inner_avg", [True, False])
@pytest.mark.parametrize("time_avg", [True, False])
def test_time_distributed_criterion_matches_jax(inner_avg, time_avg):
    r = np.random.default_rng(2 * inner_avg + time_avg)
    logp = np.array(jax.nn.log_softmax(
        jnp.asarray(r.normal(size=(3, 7, 11)).astype(np.float32)), axis=-1))
    target = r.integers(0, 11, size=(3, 7))
    want = jnn.TimeDistributedCriterion(
        jnn.ClassNLLCriterion(size_average=inner_avg),
        size_average=time_avg).apply(jnp.asarray(logp), jnp.asarray(target))
    crit = tnn.TimeDistributedCriterion(
        tnn.ClassNLLCriterion(size_average=inner_avg), size_average=time_avg)
    got = crit.apply(torch.from_numpy(logp), torch.from_numpy(target))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    assert crit.size_average == inner_avg


def test_cross_entropy_and_lm_criterion_match_jax():
    r = np.random.default_rng(9)
    logits = r.normal(size=(2, 5, 13)).astype(np.float32)
    target = r.integers(0, 13, size=(2, 5))
    want = jnn.CrossEntropyCriterion().apply(
        jnp.asarray(logits.reshape(10, 13)), jnp.asarray(target.reshape(10)))
    got = tnn.CrossEntropyCriterion().apply(
        torch.from_numpy(logits.reshape(10, 13)),
        torch.from_numpy(target.reshape(10)))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    logp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    want = jax_lm_criterion().apply(jnp.asarray(logp), jnp.asarray(target))
    got = lm_criterion().apply(torch.from_numpy(logp),
                               torch.from_numpy(target))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    fused = lm_criterion(fused_head=True)
    assert isinstance(fused, tnn.ChunkedSoftmaxCrossEntropy)
    assert fused.chunk_size == jax_lm_criterion(fused_head=True).chunk_size


# ---------------------------------------------------------- optim methods
_METHODS = {
    "sgd": dict(cls="SGD", learningrate=0.1),
    "sgd-decay": dict(cls="SGD", learningrate=0.1, learningrate_decay=0.5),
    "sgd-momentum": dict(cls="SGD", learningrate=0.1, momentum=0.9),
    "sgd-damped": dict(cls="SGD", learningrate=0.1, momentum=0.9,
                       dampening=0.3),
    "sgd-nesterov": dict(cls="SGD", learningrate=0.1, momentum=0.9,
                         dampening=0.0, nesterov=True),
    "sgd-weightdecay": dict(cls="SGD", learningrate=0.1, momentum=0.5,
                            weightdecay=0.01),
    "adam": dict(cls="Adam", learningrate=0.01),
    "adam-decay": dict(cls="Adam", learningrate=0.01, learningrate_decay=0.1,
                       beta1=0.8, beta2=0.99),
}


@pytest.mark.parametrize("case", sorted(_METHODS))
def test_optim_method_updates_match_jax(case):
    kw = dict(_METHODS[case])
    cls = kw.pop("cls")
    r = np.random.default_rng(len(case))
    shapes = [(3, 4), (5,)]
    params = [r.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[r.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    jm, tm = getattr(joptim, cls)(**kw), getattr(toptim, cls)(**kw)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    js = jm.init_state(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = tm.init_state(tp)
    for step, gs in enumerate(grads):
        jp, js = jm.update(jp, {str(i): jnp.asarray(g)
                                for i, g in enumerate(gs)}, js,
                           jnp.asarray(step, jnp.int32))
        tm.update(tp, [torch.from_numpy(g) for g in gs], ts, step)
        for i, p in enumerate(tp):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[str(i)]),
                                       atol=1e-6)
    assert tm.get_learning_rate(2) == pytest.approx(
        jm.get_learning_rate(2), rel=1e-6)


def test_unported_method_options_name_their_roadmap_item():
    """SGD's learningrate_schedule and layer_lr_mults, which raised until
    ROADMAP Queue A.1.4 was ported, now step as JAX's do (3 updates within
    1e-6); nesterov without dampening 0 still raises."""
    r = np.random.default_rng(11)
    params = [r.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    grads = [[r.normal(size=p.shape).astype(np.float32) for p in params]
             for _ in range(3)]
    for kw in (dict(learningrate_schedule="step"),
               dict(layer_lr_mults={"['1']": 0.1})):
        jkw = {k: (joptim.Step(1, 0.5) if v == "step" else v)
               for k, v in kw.items()}
        tkw = {k: (toptim.Step(1, 0.5) if v == "step" else v)
               for k, v in kw.items()}
        jm = joptim.SGD(learningrate=0.1, momentum=0.9, **jkw)
        tm = toptim.SGD(learningrate=0.1, momentum=0.9, **tkw)
        jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
        js = jm.init_state(jp)
        tp = [torch.from_numpy(p.copy()) for p in params]
        ts = tm.init_state(tp)
        for step, gs in enumerate(grads):
            jp, js = jm.update(jp, {str(i): jnp.asarray(g)
                                    for i, g in enumerate(gs)}, js,
                               jnp.asarray(step, jnp.int32))
            tm.update(tp, [torch.from_numpy(g) for g in gs], ts, step)
        for i, p in enumerate(tp):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[str(i)]),
                                       atol=1e-6, err_msg=str(kw))
    with pytest.raises(ValueError):
        toptim.SGD(momentum=0.9, nesterov=True)


# ------------------------------------------------------------ data path
def test_text_stream_and_windows_match_jax():
    np.testing.assert_array_equal(synthetic_ptb(500, 50, seed=3),
                                  jax_synthetic_ptb(500, 50, seed=3))
    ids = synthetic_ptb(101, 20)
    for a, b in zip(ptb_windows(ids, 7), jax_ptb_windows(ids, 7)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pad_last", [True, False])
def test_shuffled_batches_match_jax(pad_last):
    r = np.random.default_rng(0)
    xs = r.integers(0, 9, size=(10, 3)).astype(np.int32)
    ys = np.arange(10, dtype=np.int32)
    ours = (DataSet.array(Sample(x, y) for x, y in zip(xs, ys))
            >> SampleToMiniBatch(4, pad_last=pad_last))
    theirs = (JDataSet.array(JSample(x, y) for x, y in zip(xs, ys))
              >> JSampleToMiniBatch(4, pad_last=pad_last, ring_depth=0))
    RandomGenerator.set_seed(5)
    JaxRNG.set_seed(5)
    for _ in range(2):   # shuffles compose across epochs
        ours.shuffle()
        theirs.shuffle()
        got = list(ours.data(train=True))
        want = list(theirs.data(train=True))
        assert [b.valid for b in got] == [b.valid for b in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.input, b.input)
            np.testing.assert_array_equal(a.target, b.target)
    assert len(got) == (3 if pad_last else 2)
    assert isinstance(got[0], MiniBatch) and got[0].size() == 4


# ------------------------------------------------------------- trainers
def _models(seed=3):
    JaxRNG.set_seed(seed)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS,
                           num_layers=LAYERS, max_len=T)
    tlm = TransformerLM(VOCAB, E, HEADS, LAYERS, T, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    load_jax_params(tlm, jlm.get_params())
    return jlm, tlm


def _batches(n, seed=1, batch=BATCH):
    r = np.random.default_rng(seed)
    return [(r.integers(0, VOCAB, size=(batch, T)).astype(np.int32),
             r.integers(0, VOCAB, size=(batch, T)).astype(np.int32))
            for _ in range(n)]


def _jax_trajectory(jlm, method, batches):
    opt = joptim.LocalOptimizer(jlm, JDataSet.array([]), jax_lm_criterion())
    opt.set_optim_method(method)
    step = jax.jit(opt._make_step_fn())
    params, mstate = jlm.get_params(), jlm.get_state()
    ostate = method.init_state(params)
    losses = []
    for i, (x, y) in enumerate(batches):
        params, mstate, ostate, loss = step(
            params, mstate, ostate, jnp.asarray(i, jnp.int32),
            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("method", ["adam", "sgd-momentum"])
def test_five_steps_match_jax_step_function(method):
    Engine.init(seed=3)
    jlm, tlm = _models()
    make = {"adam": lambda m: m.Adam(learningrate=1e-3),
            "sgd-momentum": lambda m: m.SGD(learningrate=0.01,
                                            momentum=0.9)}[method]
    batches = _batches(5)
    want_losses, want_params = _jax_trajectory(jlm, make(joptim), batches)
    opt = toptim.LocalOptimizer(tlm, DataSet.array([]), lm_criterion(),
                                device="cpu").set_optim_method(make(toptim))
    losses = [opt.train_step(torch.from_numpy(x), torch.from_numpy(y))
              for x, y in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert opt.state["neval"] == 6 and opt.state["loss"] == losses[-1]
    flat = flatten_tree(jax.device_get(want_params))
    for name, p in tlm.named_parameters():
        got, want = p.detach().numpy(), np.asarray(flat[name])
        if name.endswith("qkv_bias"):
            # the key bias has a zero gradient in exact arithmetic (softmax
            # is shift-invariant along a row), so both sides step it by
            # roundoff; Adam's m/sqrt(v) turns that noise into steps of up
            # to lr each: held to 5 steps of 2·lr, the q and v biases to 1e-4
            key = slice(E, 2 * E)
            np.testing.assert_allclose(got[key], want[key], atol=5 * 2e-3)
            got, want = np.delete(got, key), np.delete(want, key)
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)


def test_gradient_accumulation_matches_the_full_batch():
    _, full = _models()
    _, micro = _models()
    (x, y), = _batches(1, seed=4, batch=8)
    losses = []
    for lm, n in ((full, 1), (micro, 2)):
        opt = (toptim.LocalOptimizer(lm, DataSet.array([]), lm_criterion(),
                                     device="cpu")
               .set_optim_method(toptim.SGD(learningrate=0.5))
               .set_gradient_accumulation(n))
        losses.append(opt.train_step(torch.from_numpy(x),
                                     torch.from_numpy(y)))
    assert losses[0] == pytest.approx(losses[1], abs=1e-5)
    for (name, a), b in zip(full.named_parameters(), micro.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="not divisible"):
        (toptim.LocalOptimizer(micro, DataSet.array([]), lm_criterion(),
                               device="cpu").set_gradient_accumulation(3)
         .train_step(torch.from_numpy(x), torch.from_numpy(y)))


@pytest.mark.parametrize("clip", ["constant", "l2"])
def test_gradient_clipping_matches_jax(clip):
    Engine.init(seed=1)
    r = np.random.default_rng(6)
    grads = [r.normal(size=s).astype(np.float32) for s in ((4, 3), (7,))]
    jopt = joptim.LocalOptimizer(jnn.Linear(2, 2), JDataSet.array([]),
                                 jnn.MSECriterion())
    topt = toptim.LocalOptimizer(tnn.Linear(2, 2), DataSet.array([]),
                                 lm_criterion(), device="cpu")
    for opt in (jopt, topt):
        if clip == "constant":
            opt.set_constant_gradient_clipping(-0.5, 0.7)
        else:
            opt.set_gradient_clipping_by_l2_norm(1.5)
    want = jopt._clip_grads([jnp.asarray(g) for g in grads])
    got = topt._clip_grads([torch.from_numpy(g) for g in grads])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def _lm_samples(n_windows):
    ids = synthetic_ptb(n_windows * T + 1, vocab_size=VOCAB)
    return list(zip(*ptb_windows(ids, T)))


def test_optimize_matches_jax_final_loss():
    """Same weights, same seed, same data: both loops shuffle the same
    epoch orders and end on the same loss (6 steps over 2 epochs)."""
    Engine.init(seed=11)
    jlm, tlm = _models(seed=11)
    pairs = _lm_samples(3 * BATCH)
    jds = (JDataSet.array(JSample(x, y) for x, y in pairs)
           >> JSampleToMiniBatch(BATCH))
    tds = (DataSet.array(Sample(x, y) for x, y in pairs)
           >> SampleToMiniBatch(BATCH))
    jopt = (joptim.LocalOptimizer(jlm, jds, jax_lm_criterion())
            .set_optim_method(joptim.Adam(learningrate=1e-2))
            .set_end_when(joptim.Trigger.max_iteration(6)))
    topt = (toptim.LocalOptimizer(tlm, tds, lm_criterion(), device="cpu")
            .set_optim_method(toptim.Adam(learningrate=1e-2))
            .set_end_when(toptim.Trigger.max_iteration(6)))
    JaxRNG.set_seed(21)
    RandomGenerator.set_seed(21)
    jopt.optimize()
    assert topt.optimize() is tlm
    assert topt.state["neval"] == jopt.state["neval"] == 7
    assert topt.state["epoch"] == jopt.state["epoch"] == 2
    np.testing.assert_allclose(topt.state["loss"], jopt.state["loss"],
                               rtol=1e-4)


def test_optimize_stops_on_epochs_and_rejects_empty_data():
    _, tlm = _models()
    ds = (DataSet.array(Sample(x, y) for x, y in _lm_samples(2 * BATCH))
          >> SampleToMiniBatch(BATCH))
    opt = (toptim.Optimizer(tlm, ds, lm_criterion(), device="cpu")
           .set_end_when(toptim.Trigger.max_epoch(2)))
    assert isinstance(opt, toptim.LocalOptimizer)
    opt.optimize()
    assert opt.state["neval"] == 5 and opt.state["epoch"] == 3
    assert opt.state["epoch_finished"]
    empty = toptim.LocalOptimizer(tlm, DataSet.array([]), lm_criterion(),
                                  device="cpu")
    with pytest.raises(RuntimeError, match="no batches"):
        empty.optimize()


def test_non_finite_loss_raises():
    _, tlm = _models()
    with torch.no_grad():
        tlm[0].weight.fill_(float("nan"))
    opt = toptim.LocalOptimizer(tlm, DataSet.array([]), lm_criterion(),
                                device="cpu")
    (x, y), = _batches(1)
    with pytest.raises(toptim.NonFiniteLossError) as info:
        opt.train_step(torch.from_numpy(x), torch.from_numpy(y))
    assert info.value.iteration == 1


@pytest.mark.parametrize("name,args,fires", [
    ("max_iteration", (3,), [{"neval": 3}, {"neval": 4}]),
    ("max_epoch", (2,), [{"epoch": 2}, {"epoch": 3}]),
    ("several_iteration", (4,), [{"neval": 3}, {"neval": 8}]),
    ("every_epoch", (), [{"epoch_finished": False},
                         {"epoch_finished": True}]),
    ("min_loss", (0.5,), [{"loss": 0.6}, {"loss": 0.4}]),
    ("max_score", (0.9,), [{"score": 0.8}, {"score": 0.95}]),
])
def test_triggers_match_jax(name, args, fires):
    ours = getattr(toptim.Trigger, name)(*args)
    theirs = getattr(joptim.Trigger, name)(*args)
    for state in fires:
        assert ours(state) == theirs(state)
        assert ours.next_fire_in(state) == theirs.next_fire_in(state)
    assert [ours(s) for s in fires] == [False, True]
    always = toptim.Trigger(lambda s: True, "always")
    assert not toptim.Trigger.and_(ours, always)(fires[0])
    assert toptim.Trigger.and_(ours, always)(fires[1])
    assert toptim.Trigger.or_(ours, always)(fires[0])


def test_train_main_runs_on_the_cpu_and_refuses_unported_flags(capsys):
    loss = train_main.main(["--device", "cpu", "-b", "4", "--seq-len", "16",
                            "--embed-dim", "32", "--num-heads", "2",
                            "--vocab-size", "64", "--max-iteration", "3",
                            "--synthetic-tokens", "2000"])
    assert np.isfinite(loss)
    assert "final loss:" in capsys.readouterr().out
    for flag in (["-f", "corpus.txt"], ["--lora=4"], ["--save", "m.bin"],
                 ["--model-snapshot", "m.bin"], ["--distributed"]):
        with pytest.raises(SystemExit, match="ROADMAP Queue"):
            train_main.main(["--device", "cpu", *flag])
