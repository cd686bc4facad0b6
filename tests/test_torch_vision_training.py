"""Training and validation of the port's vision models against the JAX
package, on the CPU.

- The step's module state: a CIFAR ResNet-8 (batch 4, 16x16) trained three
  steps by the port's ``LocalOptimizer.train_step`` and by JAX's step
  function (``Optimizer._make_step_fn``), plain, under
  ``set_remat("full")`` and under ``set_gradient_accumulation(2)``: losses,
  the running statistics after every step (JAX's ``mstate`` trajectory) and
  the parameters after the last. fp32; losses within 1e-5 relative, running
  statistics and parameters within 1e-4 (three steps of a ReLU network:
  see ``test_torch_resnet.py`` for why gradients are not held tighter).
- Batch norm updates its statistics exactly once a (micro)batch under
  remat (``set_remat`` and ``nn.Remat``), accumulation and the fused
  window, counted.
- ``optimize()`` at fuse 1 and at ``set_fuse_steps(4)`` against JAX's
  ``optimize()`` with the same seeds (the same epoch orders): the final
  loss (1e-4 relative), state and parameters (1e-4); the port's two runs
  equal each other exactly (on the CPU the window runs the same ops).
- Validation: ``Top1Accuracy``, ``Top5Accuracy`` and ``Loss`` against JAX's
  ``apply`` on tied scores and with a ``valid`` count (equal; Loss within
  1e-6), each device fold equal to its host fold; ``run_device_eval``
  against JAX's ``run_device_eval`` over a padded last batch; validation
  inside ``optimize()``, its trigger clipping the fused windows.
- LeNet-5 and VggForCifar10: forward (training and eval) against JAX's, and
  the three training mains on the CPU; ``load_jax_state``'s errors;
  ``BIGDL_CONVBN_FUSE=1``.
"""

import logging

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
from bigdl_tpu.dataset import cifar as jcifar
from bigdl_tpu.dataset import mnist as jmnist
from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
from bigdl_tpu.models.resnet import ResNet as JaxResNet
from bigdl_tpu.models.vgg import VggForCifar10 as JaxVgg
from bigdl_tpu.nn import layout as jlayout
from bigdl_tpu.optim import validation as jval
from bigdl_tpu.optim.evaluator import run_device_eval as jax_run_device_eval
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params, load_jax_state
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.dataset import cifar, mnist
from bigdl_tpu_torch.kernels.conv_bn import FusedConvBNReLU
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.lenet import train as lenet_main
from bigdl_tpu_torch.models.resnet import ResNet
from bigdl_tpu_torch.models.resnet import train as resnet_main
from bigdl_tpu_torch.models.vgg import VggForCifar10
from bigdl_tpu_torch.models.vgg import train as vgg_main
from bigdl_tpu_torch.nn import layout as tlayout
from bigdl_tpu_torch.nn.normalization import BatchNormalization
from bigdl_tpu_torch.optim import validation as tval
from bigdl_tpu_torch.optim.evaluator import run_device_eval
from bigdl_tpu_torch.utils import engine as torch_engine
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

RESNET8 = {"depth": 8, "shortcutType": "B"}
N_BN = 9          # stem, two in each of 3 blocks, two projection shortcuts


@pytest.fixture(autouse=True)
def _reset():
    yield
    jlayout.set_image_format(None)
    tlayout.set_image_format(None)
    jax_engine.Engine.reset()
    torch_engine.Engine.reset()


def _pair(seed=3, opt=RESNET8):
    JaxRNG.set_seed(seed)
    jm = JaxResNet(10, opt)
    tm = ResNet(10, opt, device="cpu")
    load_jax_params(tm, jm.get_params())
    load_jax_state(tm, jm.get_state())
    return jm, tm


def _batches(n, seed=1, batch=4, hw=16):
    r = np.random.default_rng(seed)
    return [(r.normal(size=(batch, 3, hw, hw)).astype(np.float32),
             r.integers(0, 10, size=batch).astype(np.int32))
            for _ in range(n)]


def _sgd(pkg):
    return pkg.SGD(learningrate=0.05, momentum=0.9, dampening=0.0,
                   weightdecay=1e-4)


def _check_state(tm, jax_state, tol=1e-4):
    bufs = dict(tm.named_buffers())
    flat = flatten_tree(jax.device_get(jax_state))
    assert set(flat) == set(bufs)
    for name, s in flat.items():
        np.testing.assert_allclose(bufs[name].numpy(), np.asarray(s),
                                   atol=tol, rtol=tol, err_msg=name)


def _check_params(tm, jax_params, tol=1e-4):
    flat = flatten_tree(jax.device_get(jax_params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(flat[name]),
                                   atol=tol, err_msg=name)


class _CountUpdates:
    """Counts batch norm's running-statistics updates."""

    def __init__(self, monkeypatch):
        self.n = 0
        orig = BatchNormalization._update_running

        def counted(bn, *a):
            self.n += 1
            return orig(bn, *a)

        monkeypatch.setattr(BatchNormalization, "_update_running", counted)


# ------------------------------------------------------ the step's state
@pytest.mark.parametrize("mode", ["plain", "remat-full", "accumulation-2"])
def test_mstate_trajectory_matches_jax(mode, monkeypatch):
    jax_engine.Engine.init(seed=3)
    jm, tm = _pair()
    jopt = joptim.LocalOptimizer(jm, JDataSet.array([]),
                                 jnn.ClassNLLCriterion())
    topt = toptim.LocalOptimizer(tm, DataSet.array([]),
                                 tnn.ClassNLLCriterion(), device="cpu")
    for opt, pkg in ((jopt, joptim), (topt, toptim)):
        opt.set_optim_method(_sgd(pkg))
        if mode == "remat-full":
            opt.set_remat("full")
        elif mode == "accumulation-2":
            opt.set_gradient_accumulation(2)
    method = jopt.optim_method
    step = jax.jit(jopt._make_step_fn())
    params, mstate = jm.get_params(), jm.get_state()
    ostate = method.init_state(params)
    counter = _CountUpdates(monkeypatch)
    for i, (x, y) in enumerate(_batches(3)):
        params, mstate, ostate, loss = step(
            params, mstate, ostate, jnp.asarray(i, jnp.int32),
            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        got = topt.train_step(torch.from_numpy(x), torch.from_numpy(y))
        assert got == pytest.approx(float(loss), rel=1e-5)
        _check_state(tm, mstate)
    _check_params(tm, params)
    micro = 2 if mode == "accumulation-2" else 1
    assert counter.n == 3 * N_BN * micro


def test_remat_container_updates_statistics_once(monkeypatch):
    """A block under ``nn.Remat`` inside a step under ``set_remat("full")``:
    its recomputations (nested) update nothing; the trajectory equals the
    plain model's."""
    _, plain = _pair()
    _, remat = _pair()
    # wrap the model's second child, a residual block: its paths gain the
    # "0" level of the Remat
    remat._modules["1"] = tnn.Remat(remat._modules["1"])
    assert "1.0.0.0.0.0.weight" in dict(remat.named_parameters())
    counter = _CountUpdates(monkeypatch)
    losses = []
    for model, mode in ((plain, "none"), (remat, "full")):
        opt = (toptim.LocalOptimizer(model, DataSet.array([]),
                                     tnn.ClassNLLCriterion(), device="cpu")
               .set_optim_method(_sgd(toptim)).set_remat(mode))
        losses.append([opt.train_step(torch.from_numpy(x),
                                      torch.from_numpy(y))
                       for x, y in _batches(2)])
    assert counter.n == 2 * 2 * N_BN
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    for (name, a), b in zip(plain.named_buffers(), remat.buffers()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6, msg=name)


def test_optimize_at_fuse_1_and_4_matches_jax(monkeypatch):
    """8 steps over two epochs of 4 batches: JAX's loop, and the port's at
    fuse 1 and at ``set_fuse_steps(4)``; same seeds, same epoch orders.
    (JAX's fused window is its per-step loop's trajectory, pinned by its
    own tests.)"""
    jax_engine.Engine.init(seed=11)
    jm, _ = _pair(seed=11)
    pairs = [(x[i], y[i]) for x, y in _batches(4, seed=5) for i in range(4)]
    jds = (JDataSet.array(JSample(x, y) for x, y in pairs)
           >> JSampleToMiniBatch(4))
    jopt = (joptim.LocalOptimizer(jm, jds, jnn.ClassNLLCriterion())
            .set_optim_method(_sgd(joptim))
            .set_end_when(joptim.Trigger.max_iteration(8)))
    JaxRNG.set_seed(21)
    jopt.optimize()
    for fuse in (1, 4):
        _, tm = _pair(seed=11)
        tds = (DataSet.array(Sample(x, y) for x, y in pairs)
               >> SampleToMiniBatch(4))
        topt = (toptim.LocalOptimizer(tm, tds, tnn.ClassNLLCriterion(),
                                      device="cpu")
                .set_optim_method(_sgd(toptim)).set_fuse_steps(fuse)
                .set_end_when(toptim.Trigger.max_iteration(8)))
        RandomGenerator.set_seed(21)
        counter = _CountUpdates(monkeypatch)
        topt.optimize()
        assert counter.n == 8 * N_BN
        assert topt.state["neval"] == jopt.state["neval"] == 9
        assert topt.state["loss"] == pytest.approx(jopt.state["loss"],
                                                   rel=1e-4)
        _check_state(tm, jm.get_state())
        _check_params(tm, jm.get_params())


def test_fused_window_equals_per_step_run():
    """On the CPU the window runs the same ops as the per-step loop: the
    same losses, parameters and statistics, bit for bit."""
    runs = []
    for fuse in (1, 4):
        _, tm = _pair(seed=2)
        ds = (DataSet.array(Sample(x[i], y[i]) for x, y in _batches(
            2, seed=6) for i in range(4)) >> SampleToMiniBatch(4))
        opt = (toptim.LocalOptimizer(tm, ds, tnn.ClassNLLCriterion(),
                                     device="cpu")
               .set_optim_method(_sgd(toptim)).set_fuse_steps(fuse)
               .set_end_when(toptim.Trigger.max_iteration(4)))
        RandomGenerator.set_seed(3)
        opt.optimize()
        runs.append((opt.state["loss"], tm.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


# ----------------------------------------------------------- validation
def _scores(seed=0, n=12, c=7):
    r = np.random.default_rng(seed)
    out = r.integers(0, 4, size=(n, c)).astype(np.float32)   # many ties
    t = r.integers(0, c, size=n).astype(np.int32)
    return out, t


@pytest.mark.parametrize("name", ["Top1Accuracy", "Top5Accuracy"])
@pytest.mark.parametrize("valid", [None, 12, 9, 1])
@pytest.mark.parametrize("one_based", [False, True])
def test_topk_accuracy_matches_jax_on_ties(name, valid, one_based):
    out, t = _scores(seed=len(name) + (valid or 0))
    if one_based:
        t = t + 1
    want = getattr(jval, name)(one_based).apply(out, t, valid)
    m = getattr(tval, name)(one_based)
    got = m.apply(torch.from_numpy(out), torch.from_numpy(t), valid)
    assert got.result() == want.result()
    mask = torch.arange(len(t)) < (valid if valid is not None else len(t))
    dev = m.finalize(tuple(float(v) for v in m.device_fold(
        torch.from_numpy(out), torch.from_numpy(t), mask)))
    assert dev.result() == want.result()


@pytest.mark.parametrize("valid", [None, 5])
def test_loss_method_matches_jax(valid):
    r = np.random.default_rng(4)
    logp = np.array(jax.nn.log_softmax(jnp.asarray(
        r.normal(size=(8, 5)).astype(np.float32))))
    t = r.integers(0, 5, size=8).astype(np.int32)
    want = jval.Loss().apply(logp, t, valid)
    m = tval.Loss()
    got = m.apply(torch.from_numpy(logp), torch.from_numpy(t), valid)
    assert got.count == want.count
    assert got.result()[0] == pytest.approx(want.result()[0], abs=1e-6)
    assert m.has_device_fold()
    mask = torch.arange(8) < (valid or 8)
    dev = m.finalize(tuple(float(v) for v in m.device_fold(
        torch.from_numpy(logp), torch.from_numpy(t), mask)))
    assert dev.result()[0] == pytest.approx(want.result()[0], abs=1e-6)
    assert not tval.Loss(tnn.ClassNLLCriterion(weights=np.ones(5))
                         ).has_device_fold()
    assert not tval.Loss(tnn.ClassNLLCriterion(size_average=False)
                         ).has_device_fold()
    total = got + tval.LossResult(1.0, 1)
    assert total.count == got.count + 1
    acc = tval.AccuracyResult(3, 4) + tval.AccuracyResult(1, 4)
    assert acc.result() == (0.5, 8)


def _eval_sets(n=10, batch=4):
    r = np.random.default_rng(9)
    xs = r.normal(size=(n, 3, 16, 16)).astype(np.float32)
    ys = r.integers(0, 10, size=n).astype(np.int32)
    jds = (JDataSet.array(JSample(x, y) for x, y in zip(xs, ys))
           >> JSampleToMiniBatch(batch))
    tds = (DataSet.array(Sample(x, y) for x, y in zip(xs, ys))
           >> SampleToMiniBatch(batch))
    return jds, tds


def test_run_device_eval_matches_jax_over_a_padded_batch():
    jax_engine.Engine.init(seed=3)
    jm, tm = _pair()
    # running statistics away from their init, so eval mode reads them
    state = jax.tree_util.tree_map(lambda a: a * 0.5 + 0.1, jm.get_state())
    jm.set_state(state)
    load_jax_state(tm, state)
    jds, tds = _eval_sets()
    methods = ("Top1Accuracy", "Top5Accuracy", "Loss")
    want, _ = jax_run_device_eval(jm, jm.get_params(), jm.get_state(), jds,
                                  [getattr(jval, m)() for m in methods])
    tm.train()
    got, stats = run_device_eval(tm, tds, [getattr(tval, m)()
                                           for m in methods], device="cpu")
    assert tm.training                      # the mode is given back
    assert stats["batches"] == 3 and stats["samples"] == 10
    for m, a, b in zip(methods, got, want):
        assert a.result()[1] == b.result()[1] == 10
        assert a.result()[0] == pytest.approx(b.result()[0], abs=1e-5), m
    # a method without a device fold gets the outputs on the host
    host = tval.Loss(tnn.ClassNLLCriterion(size_average=False))
    got2, stats2 = run_device_eval(tm, tds, [host], device="cpu")
    assert stats2["fetch_bytes"] == 3 * 4 * 10 * 4
    with pytest.raises(ValueError, match="empty"):
        run_device_eval(tm, DataSet.array([]), [tval.Top1Accuracy()],
                        device="cpu")


def test_eval_programs_stay_bounded_with_fresh_methods_each_pass():
    """Fresh method objects every pass make a new program key each time;
    the cache keeps at most ``_EVAL_CACHE_MAX`` (JAX's bound, 8), drops the
    oldest program with the methods it pinned, and every pass still counts
    right."""
    from bigdl_tpu_torch.optim.evaluator import _EVAL_CACHE_MAX
    _, tm = _pair()
    _, tds = _eval_sets()
    first = None
    for i in range(2 * _EVAL_CACHE_MAX + 3):
        methods = [tval.Top1Accuracy()]
        (res,), _ = run_device_eval(tm, tds, methods, device="cpu")
        first = res.result() if first is None else first
        assert res.result() == first
        cache, pinned = tm._eval_programs, tm._eval_methods
        assert len(cache.keys) == len(pinned) == min(i + 1, _EVAL_CACHE_MAX)
        assert list(pinned) == cache.keys    # oldest first, the same keys
        assert any(ms[0] is methods[0] for ms in pinned.values())
    # the same objects again reuse their program
    keys = cache.keys
    run_device_eval(tm, tds, methods, device="cpu")
    assert tm._eval_programs.keys == keys


def test_validation_in_optimize_clips_windows_and_records_scores(caplog):
    _, tm = _pair()
    _, tds = _eval_sets()
    pairs = [(x[i], y[i]) for x, y in _batches(4, seed=5) for i in range(4)]
    ds = DataSet.array(Sample(x, y) for x, y in pairs) >> SampleToMiniBatch(4)
    opt = (toptim.LocalOptimizer(tm, ds, tnn.ClassNLLCriterion(),
                                 device="cpu")
           .set_optim_method(_sgd(toptim)).set_fuse_steps(4)
           .set_end_when(toptim.Trigger.max_iteration(7))
           .set_validation(toptim.Trigger.several_iteration(3), tds,
                           [tval.Top1Accuracy(), tval.Loss()]))
    assert opt._fusible_steps({"neval": 1}) == 3
    caplog.set_level(logging.INFO, logger="bigdl_tpu_torch.optim.optimizer")
    opt.optimize()
    passes = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("Validation pass")]
    assert len(passes) == 2                 # after iterations 3 and 6
    assert set(opt.state["scores"]) == {"Top1Accuracy", "Loss"}
    assert opt.state["score"] == opt.state["scores"]["Top1Accuracy"]
    assert tm.training


# ------------------------------------------------------ LeNet-5 and VGG
def _jit_apply(jm, training):
    params, state = jm.get_params(), jm.get_state()
    return jax.jit(lambda x: jm.apply(params, state, x, training=training))


@pytest.mark.parametrize("training", [True, False])
def test_lenet5_matches_jax(training):
    JaxRNG.set_seed(12)
    jm = JaxLeNet5(10)
    tm = LeNet5(10, device="cpu")
    load_jax_params(tm, jm.get_params())
    x = np.random.default_rng(13).normal(size=(3, 784)).astype(np.float32)
    want, _ = _jit_apply(jm, training)(jnp.asarray(x))
    tm.train(training)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_vgg_for_cifar10_matches_jax():
    """Without dropout (the packages draw different masks), in training
    mode (both batch norms on the batch, and their statistics after) and
    in eval mode."""
    JaxRNG.set_seed(14)
    jm = JaxVgg(10, has_dropout=False)
    tm = VggForCifar10(10, has_dropout=False, device="cpu")
    load_jax_params(tm, jm.get_params())
    load_jax_state(tm, jm.get_state())
    x = np.random.default_rng(15).normal(size=(4, 3, 32, 32)).astype(
        np.float32)

    def both(p, s, xj):
        out, new_s = jm.apply(p, s, xj, training=True)
        return out, new_s, jm.apply(p, s, xj, training=False)[0]

    want_train, st, want_eval = jax.jit(both)(jm.get_params(), jm.get_state(),
                                              jnp.asarray(x))
    with torch.no_grad():
        got_eval = tm.evaluate()(torch.from_numpy(x))
        got_train = tm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(want_eval),
                               atol=1e-5)
    # at 1x1 the last stages' statistics are over 4 values a channel
    np.testing.assert_allclose(got_train.numpy(), np.asarray(want_train),
                               atol=1e-3)
    _check_state(tm, st, tol=1e-3)
    assert sum(isinstance(m, tnn.Dropout) for m in VggForCifar10(
        device="cpu").modules()) == 2


def test_synthetic_datasets_match_jax():
    np.testing.assert_array_equal(cifar.synthetic_cifar10(20, seed=3)[0],
                                  jcifar.synthetic_cifar10(20, seed=3)[0])
    imgs, labels = mnist.load_mnist(None, "test", synthetic_size=30)
    jimgs, jlabels = jmnist.load_mnist(None, "test", synthetic_size=30)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labels, jlabels)
    a, b = mnist.to_samples(imgs, labels)[3], jmnist.to_samples(
        jimgs, jlabels)[3]
    np.testing.assert_array_equal(a.feature[0], b.feature[0])
    tr, te = cifar.train_val_sets(None, 8, synthetic_size=40)
    jtr, jte = jcifar.train_val_sets(None, 8, synthetic_size=40)
    for ours, theirs in ((tr, jtr), (te, jte)):
        for p, q in zip(ours.data(train=False), theirs.data(train=False)):
            np.testing.assert_array_equal(p.input, q.input)
            np.testing.assert_array_equal(p.target, q.target)
    with pytest.raises(NotImplementedError, match="A.4"):
        cifar.load_cifar10("/data/cifar")


@pytest.mark.parametrize("main,args", [
    (lenet_main, ["--synthetic-size", "256", "-b", "32"]),
    (resnet_main, ["--depth", "8", "--synthetic-size", "128", "-b", "16"]),
    (vgg_main, ["--synthetic-size", "64", "-b", "16"]),
])
def test_training_mains_run_on_the_cpu(main, args, capsys):
    opt = main.main(["--device", "cpu", *args])
    assert np.isfinite(opt.state["loss"])
    assert 0.0 <= opt.state["score"] <= 1.0
    assert "final loss:" in capsys.readouterr().out


@pytest.mark.parametrize("main,flag", [
    (resnet_main, ["--dataset", "ImageNet"]),
    (resnet_main, ["--dataset=ImageNet"]),
    (resnet_main, ["-f", "/data"]),
    (resnet_main, ["--checkpoint", "ck"]),
    (resnet_main, ["--summary-dir", "s"]),
    (resnet_main, ["--distributed"]),
    (lenet_main, ["--model-snapshot", "m"]),
    (lenet_main, ["--state-snapshot", "s"]),
    (lenet_main, ["--overwrite-checkpoint"]),
    (vgg_main, ["--folder", "/data"]),
])
def test_training_mains_refuse_unported_flags(main, flag):
    with pytest.raises(SystemExit, match="ROADMAP Queue"):
        main.main(["--device", "cpu", *flag])


# ----------------------------------------------- state loading, fusion
def test_load_jax_state_checks_paths_and_shapes():
    jm, tm = _pair()
    state = jm.get_state()
    flat = flatten_tree(state)
    assert len(flat) == 2 * N_BN
    assert all(k.endswith(("running_mean", "running_var")) for k in flat)
    missing = {k: v for k, v in state.items() if k != "0"}
    with pytest.raises(KeyError, match="state paths differ"):
        load_jax_state(tm, missing)
    extra = dict(state, extra={"running_mean": np.zeros(3)})
    with pytest.raises(KeyError, match="not in the module"):
        load_jax_state(tm, extra)
    before = tm.state_dict()["0.1.running_mean"].clone()
    bad = jax.tree_util.tree_map(lambda a: a, state)
    bad["0"]["1"] = {"running_mean": np.zeros(5, np.float32),
                     "running_var": np.ones(16, np.float32)}
    with pytest.raises(ValueError, match="tree shape"):
        load_jax_state(tm, bad)
    assert torch.equal(tm.state_dict()["0.1.running_mean"], before)
    # non-persistent buffers (ImageNormalize's constants) are not state
    seq = tnn.Sequential().add(tnn.ImageNormalize()).add(tm)
    load_jax_state(seq, {"0": {}, "1": state})


def test_convbn_fuse_knob_in_optimize(monkeypatch):
    """``BIGDL_CONVBN_FUSE=1`` fuses the model before the first step; the
    fused model trains as the unfused one, bit for bit in fp32."""
    losses = []
    models = []
    for knob in ("0", "1"):
        monkeypatch.setenv("BIGDL_CONVBN_FUSE", knob)
        _, tm = _pair(seed=4)
        ds = (DataSet.array(Sample(x[i], y[i]) for x, y in _batches(
            1, seed=7) for i in range(4)) >> SampleToMiniBatch(4))
        opt = (toptim.LocalOptimizer(tm, ds, tnn.ClassNLLCriterion(),
                                     device="cpu")
               .set_optim_method(_sgd(toptim))
               .set_end_when(toptim.Trigger.max_iteration(2)))
        RandomGenerator.set_seed(1)
        opt.optimize()
        losses.append(opt.state["loss"])
        models.append(opt.model)
    assert sum(isinstance(m, FusedConvBNReLU)
               for m in models[1].modules()) == N_BN
    assert losses[0] == losses[1]
