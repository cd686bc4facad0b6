"""The rest of the single-device optimizer surface of the port against the
JAX package, on the CPU: learning-rate schedules, the optim-method family,
per-submodule methods, per-layer rate multipliers, freeze and gradient
scales with trimmed slots, regularizers, remat and the flat update.

Inputs are made with numpy from a seed and handed to both packages; model
weights move across by path (``convert.load_jax_params``). Tolerances:
schedule rates within rtol 1e-6 (JAX computes them in fp32, the port in
Python floats); a method's five updates of a small params dict within atol
1e-5 (the same fp32 formula); trainer trajectories of a 2-layer TransformerLM
within rtol 1e-4 in loss and atol 1e-4 in parameters (a whole model's
backward summed in another order), as ``test_torch_training.py`` holds
them. Remat and the flat update are held to the port's own plain step bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.kernels.fused_update import flat_supported as jax_flat_supported
from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.models.transformerlm import lm_criterion as jax_lm_criterion
from bigdl_tpu.optim import schedules as jsched
from bigdl_tpu.optim.optim_method import CompositeOptimMethod as JComposite
from bigdl_tpu.utils.engine import Engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.kernels import layernorm as ln_module
from bigdl_tpu_torch.kernels.fused_update import (
    FlatParamUpdate, flat_supported,
)
from bigdl_tpu_torch.models.transformerlm import TransformerLM, lm_criterion
from bigdl_tpu_torch.optim import schedules as tsched
from bigdl_tpu_torch.optim.optim_method import hyper_tensor

VOCAB, E, HEADS, LAYERS, T, BATCH = 64, 32, 2, 2, 16, 4


# -------------------------------------------------------------- schedules
def _sequential(mod):
    return (mod.SequentialSchedule().add(mod.Warmup(0.01), 4)
            .add(mod.Step(3, 0.5), 5).add(mod.Poly(2.0, 20), 100))


_SCHEDULES = {
    "default": lambda m: m.Default(0.1),
    "step": lambda m: m.Step(3, 0.5),
    "multistep": lambda m: m.MultiStep([2, 5, 9], 0.3),
    "poly": lambda m: m.Poly(0.5, 10),
    "exponential": lambda m: m.Exponential(4, 0.7),
    "exponential-stair": lambda m: m.Exponential(4, 0.7, stair_case=True),
    "naturalexp": lambda m: m.NaturalExp(3, 0.2),
    "naturalexp-stair": lambda m: m.NaturalExp(3, 0.2, stair_case=True),
    "warmup": lambda m: m.Warmup(0.05),
    "sequential": _sequential,
    "sequential-empty": lambda m: m.SequentialSchedule(),
}


@pytest.mark.parametrize("case", sorted(_SCHEDULES))
def test_schedule_rates_match_jax(case):
    ours, theirs = _SCHEDULES[case](tsched), _SCHEDULES[case](jsched)
    got = [ours(0.2, step) for step in range(16)]
    want = [float(theirs(0.2, jnp.asarray(step, jnp.float32)))
            for step in range(16)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_plateau_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.5, 0.6, 0.7, 0.8, 0.9]
    for mode in ("min", "max"):
        kw = dict(factor=0.5, patience=1, mode=mode, cooldown=1,
                  min_lr=0.01)
        ours, theirs = tsched.Plateau(**kw), jsched.Plateau(**kw)
        ours.reset(0.1)
        theirs.reset(0.1)
        assert [ours.on_metric(v) for v in metrics] == \
            [theirs.on_metric(v) for v in metrics]
        assert ours.state_dict() == theirs.state_dict()
    with pytest.raises(ValueError):
        tsched.Plateau(factor=1.0)
    with pytest.raises(RuntimeError):
        tsched.Plateau().on_metric(1.0)


def test_sgd_carries_a_stateful_schedule_in_its_state():
    """SGD with Plateau: the current rate is ``state["clr"]``, the rate the
    update uses, as JAX keeps it; lowering it between steps (the trainer's
    hook after validation, ROADMAP Queue A.1.6) takes effect at once."""
    ours = toptim.SGD(learningrate=0.5, learningrate_schedule=tsched.Plateau())
    theirs = joptim.SGD(learningrate=0.5,
                        learningrate_schedule=jsched.Plateau())
    p = np.ones(3, np.float32)
    tp, jp = [torch.from_numpy(p.copy())], {"0": jnp.asarray(p)}
    ts, js = ours.init_state(tp), theirs.init_state(jp)
    assert ts["clr"] == float(js["clr"]) == 0.5
    assert ours.get_learning_rate(0) == theirs.get_learning_rate(0) == 0.5
    ts["clr"] = 0.25
    js["clr"] = jnp.asarray(0.25, jnp.float32)
    g = np.full(3, 2.0, np.float32)
    ours.update(tp, [torch.from_numpy(g)], ts, 0)
    jp, js = theirs.update(jp, {"0": jnp.asarray(g)}, js,
                           jnp.asarray(0, jnp.int32))
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp["0"]), atol=1e-7)
    with pytest.raises(ValueError, match="stateful"):
        toptim.LarsSGD(learningrate_schedule=tsched.Plateau())


# ----------------------------------------------------- the method family
_METHODS = {
    "adamw": lambda m, s: m.AdamW(learningrate=0.01, weightdecay=0.1),
    "adamw-no-decay": lambda m, s: m.AdamW(learningrate=0.01, weightdecay=0),
    "adagrad": lambda m, s: m.Adagrad(learningrate=0.1,
                                      learningrate_decay=0.1,
                                      weightdecay=0.01),
    "adadelta": lambda m, s: m.Adadelta(decayrate=0.8, learningrate=0.5),
    "adamax": lambda m, s: m.Adamax(learningrate=0.01),
    "rmsprop": lambda m, s: m.RMSprop(learningrate=0.01,
                                      learningrate_decay=0.05),
    "ftrl": lambda m, s: m.Ftrl(learningrate=0.1,
                                l1_regularization_strength=0.01,
                                l2_regularization_strength=0.02,
                                l2_shrinkage_regularization_strength=0.01),
    "lars": lambda m, s: m.LarsSGD(learningrate=0.1, weightdecay=0.01,
                                   learningrate_schedule=s.Step(2, 0.5)),
    "lars-decay": lambda m, s: m.LarsSGD(learningrate=0.1,
                                         learningrate_decay=0.2),
    "lbfgs": lambda m, s: m.LBFGS(history=3, learningrate=0.5),
    "sgd-poly": lambda m, s: m.SGD(learningrate=0.1, momentum=0.9,
                                   learningrate_schedule=s.Poly(1.0, 4)),
    "sgd-mults": lambda m, s: m.SGD(learningrate=0.1, momentum=0.5,
                                    layer_lr_mults={"['1']": 0.1,
                                                    "['2']": 3.0}),
}


@pytest.mark.parametrize("case", sorted(_METHODS))
def test_method_five_steps_match_jax(case):
    r = np.random.default_rng(len(case))
    shapes = [(3, 4), (5,), (2, 2)]
    params = [r.normal(size=s).astype(np.float32) for s in shapes]
    # a quadratic bowl, so L-BFGS's curvature pairs are accepted
    jm, tm = _METHODS[case](joptim, jsched), _METHODS[case](toptim, tsched)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    tp = {str(i): torch.from_numpy(p.copy()) for i, p in enumerate(params)}
    js, ts = jm.init_state(jp), tm.init_state(tp)
    for step in range(5):
        grads = {k: 2.0 * v.numpy() + 0.1 * np.float32(step)
                 for k, v in tp.items()}
        jp, js = jm.update(jp, {k: jnp.asarray(g) for k, g in grads.items()},
                           js, jnp.asarray(step, jnp.int32))
        tm.update(tp, {k: torch.from_numpy(g) for k, g in grads.items()},
                  ts, step)
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-5, err_msg=f"step {step} {k}")
    assert tm.get_learning_rate(3) == pytest.approx(jm.get_learning_rate(3),
                                                    rel=1e-6)
    assert flat_supported(tm) == jax_flat_supported(jm)


class _NoHostReads(TorchDispatchMode):
    """Fails on any read of a tensor's value by the host (``float(t)``,
    ``bool(t)``, ``t.item()`` all reach ``aten._local_scalar_dense``): a
    captured step could not replay it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("the update read a tensor on the host")
        return func(*args, **(kwargs or {}))


_DEVICE_SCALAR = {
    "sgd-poly": _METHODS["sgd-poly"],
    "adam": lambda m, s: m.Adam(learningrate=0.01, learningrate_decay=0.1),
    "adamax": _METHODS["adamax"],
    "lbfgs": _METHODS["lbfgs"],
}


@pytest.mark.parametrize("case", sorted(_DEVICE_SCALAR))
def test_device_scalar_updates_match_jax(case):
    """The trainer's form of the update: the step's numbers computed on the
    host (``hyper``), written into ONE fp32 tensor that is rewritten before
    every step, as before a replay, and read by ``update_with``; five
    steps against JAX within the method test's atol 1e-5, with no host
    read inside the update."""
    r = np.random.default_rng(len(case) + 7)
    shapes = [(3, 4), (5,), (2, 2)]
    params = [r.normal(size=s).astype(np.float32) for s in shapes]
    jm = _DEVICE_SCALAR[case](joptim, jsched)
    tm = _DEVICE_SCALAR[case](toptim, tsched)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    tp = {str(i): torch.from_numpy(p.copy()) for i, p in enumerate(params)}
    js, ts = jm.init_state(jp), tm.init_state(tp)
    h = torch.zeros(len(tm.hyper(0, ts)), dtype=torch.float32)
    for step in range(5):
        grads = {k: 2.0 * v.numpy() + 0.1 * np.float32(step)
                 for k, v in tp.items()}
        jp, js = jm.update(jp, {k: jnp.asarray(g) for k, g in grads.items()},
                           js, jnp.asarray(step, jnp.int32))
        h.copy_(torch.tensor(tm.hyper(step, ts), dtype=torch.float32))
        with _NoHostReads():
            tm.update_with(tp, {k: torch.from_numpy(g)
                                for k, g in grads.items()}, ts, h)
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-5, err_msg=f"step {step} {k}")
    if case == "lbfgs":   # its bookkeeping stays on the device, as in JAX
        for key in ("pos", "hist_len", "count"):
            assert isinstance(ts[key], torch.Tensor)
            assert int(ts[key]) == int(js[key]), key


@pytest.mark.parametrize("case", sorted(set(_METHODS) | {"adam", "sgd"}))
def test_updates_make_no_host_read(case):
    make = {**_METHODS, "adam": _DEVICE_SCALAR["adam"],
            "sgd": lambda m, s: m.SGD(learningrate=0.1, momentum=0.9,
                                      nesterov=True, dampening=0.0,
                                      weightdecay=0.01)}[case]
    tm = make(toptim, tsched)
    r = np.random.default_rng(1)
    tp = [torch.from_numpy(r.normal(size=s).astype(np.float32))
          for s in ((4, 3), (3,))]
    ts = tm.init_state(tp)
    for step in range(3):
        h = hyper_tensor(tm.hyper(step, ts), tp)
        assert h.shape == (len(tm.hyper(0, ts)),)
        with _NoHostReads():
            tm.update_with(tp, [2.0 * p + 0.1 for p in tp], ts, h)
    assert all(bool(p.isfinite().all()) for p in tp)


# ------------------------------------------------------- trainer helpers
def _models(seed=3, remat=False):
    Engine.init(seed=seed)
    JaxRNG.set_seed(seed)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS,
                           num_layers=LAYERS, max_len=T, remat=remat)
    tlm = TransformerLM(VOCAB, E, HEADS, LAYERS, T, device="cpu",
                        remat=remat,
                        generator=torch.Generator().manual_seed(0))
    load_jax_params(tlm, jlm.get_params())
    return jlm, tlm


def _batches(n, seed=1, batch=BATCH):
    r = np.random.default_rng(seed)
    return [(r.integers(0, VOCAB, size=(batch, T)).astype(np.int32),
             r.integers(0, VOCAB, size=(batch, T)).astype(np.int32))
            for _ in range(n)]


def _jax_run(jlm, configure, batches):
    """JAX's step function in a loop, slots trimmed as its trainer trims
    them; returns the losses, the parameters and the slots."""
    opt = joptim.LocalOptimizer(jlm, JDataSet.array([]), jax_lm_criterion())
    configure(opt)
    step = jax.jit(opt._make_step_fn())
    params, mstate = jlm.get_params(), jlm.get_state()
    ostate = opt._effective_method().init_state_trimmed(
        params, opt._trainable_mask())
    losses = []
    for i, (x, y) in enumerate(batches):
        params, mstate, ostate, loss = step(
            params, mstate, ostate, jnp.asarray(i, jnp.int32),
            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses, flatten_tree(jax.device_get(params)), ostate


def _torch_run(tlm, configure, batches):
    opt = toptim.LocalOptimizer(tlm, DataSet.array([]), lm_criterion(),
                                device="cpu")
    configure(opt)
    losses = [opt.train_step(torch.from_numpy(x), torch.from_numpy(y))
              for x, y in batches]
    return losses, opt


def _assert_params_close(tlm, want, skip_key_bias=False):
    for name, p in tlm.named_parameters():
        got, w = p.detach().numpy(), np.asarray(want[name])
        if skip_key_bias and name.endswith("qkv_bias"):
            # the key bias's gradient is 0 in exact arithmetic; Adam steps
            # its roundoff by up to lr (see test_torch_training.py)
            got, w = np.delete(got, slice(E, 2 * E)), \
                np.delete(w, slice(E, 2 * E))
        np.testing.assert_allclose(got, w, atol=1e-4, err_msg=name)


# ------------------------------------------- composite and layer multipliers
def test_set_optim_methods_routes_submodules_as_jax():
    """decoder → Adam, block2 → SGD with momentum, pos → SGD at rate 0
    (left exactly as it was), everything else → the default SGD."""
    jlm, tlm = _models()
    pos_before = tlm[1].pos.detach().clone()
    batches = _batches(3)

    def configure(mod):
        def go(opt):
            opt.set_optim_method(mod.SGD(learningrate=0.05))
            opt.set_optim_methods({"decoder": mod.Adam(learningrate=0.01),
                                   "block2": mod.SGD(learningrate=0.1,
                                                     momentum=0.9)})
            opt.set_optim_methods({"pos": mod.SGD(learningrate=0.0)})
        return go

    want_losses, want, _ = _jax_run(jlm, configure(joptim), batches)
    losses, opt = _torch_run(tlm, configure(toptim), batches)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_params_close(tlm, want)
    method = opt.optim_method
    assert isinstance(method, toptim.CompositeOptimMethod)
    assert [(n, p) for n, p, _ in method.groups] == \
        [("decoder", ("5",)), ("block2", ("3",)), ("pos", ("1",))]
    assert torch.equal(tlm[1].pos, pos_before)
    assert set(opt._ostate) == {"g0:decoder", "g1:block2", "g2:pos",
                                "default"}
    assert not jax_flat_supported(JComposite([], joptim.SGD()))
    assert not flat_supported(method)
    with pytest.raises(ValueError, match="not found"):
        opt.set_optim_methods({"no-such-module": toptim.SGD()})


def test_layer_lr_mults_in_training_match_jax():
    jlm, tlm = _models()
    batches = _batches(3)
    mults = {"['5']": 0.0, "['2']": 0.5}

    def configure(mod):
        return lambda opt: opt.set_optim_method(mod.SGD(
            learningrate=0.1, momentum=0.9, layer_lr_mults=mults))

    decoder_before = tlm[5][0].weight.detach().clone()
    want_losses, want, _ = _jax_run(jlm, configure(joptim), batches)
    losses, _ = _torch_run(tlm, configure(toptim), batches)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_params_close(tlm, want)
    assert torch.equal(tlm[5][0].weight, decoder_before)


# ------------------------------------------------- freeze and grad scales
def test_freeze_and_scales_match_jax_with_trimmed_slots():
    """block1 frozen, the decoder's weight gradient scaled by 0.5 and its
    bias by 2 (``set_scale_w``/``set_scale_b`` on its TimeDistributed, which
    reaches the Linear), Adam for 3 steps: trajectories match JAX, frozen
    parameters stay bit for bit, no gradient is computed for them, and
    their Adam slots are 0-size in both packages."""
    jlm, tlm = _models()
    for lm in (jlm, tlm):
        lm[2].freeze()
        lm[5].set_scale_w(0.5).set_scale_b(2.0)
    assert tlm.grad_scales() == flatten_tree(jlm.grad_scales())
    frozen = {n: p.detach().clone() for n, p in tlm.named_parameters()
              if n.startswith("2.")}
    hooked = []
    for n, p in tlm.named_parameters():
        if n in frozen:
            p.register_hook(lambda g, n=n: hooked.append(n))
    batches = _batches(3)

    def configure(mod):
        return lambda opt: opt.set_optim_method(mod.Adam(learningrate=0.01))

    want_losses, want, jstate = _jax_run(jlm, configure(joptim), batches)
    losses, opt = _torch_run(tlm, configure(toptim), batches)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_params_close(tlm, want, skip_key_bias=True)
    assert not hooked
    for n, p in tlm.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    jm = flatten_tree(jax.device_get(jstate["m"]))
    for (n, _), m in zip(tlm.named_parameters(), opt._ostate["m"]):
        assert m.numel() == np.asarray(jm[n]).size, n
        assert (m.numel() == 0) == (n in frozen), n
    tlm[2].unfreeze()
    assert not tlm[2][0].is_frozen() and all(
        v != 0.0 for v in tlm.grad_scales().values())


def test_freeze_all_but_the_head():
    """``model.freeze(); head.unfreeze()`` trains the head only, as JAX's
    container freeze propagates and the child's unfreeze wins."""
    jlm, tlm = _models()
    for lm in (jlm, tlm):
        lm.freeze()
        lm[5].unfreeze()
    assert tlm.grad_scales() == flatten_tree(jlm.grad_scales())
    before = {n: p.detach().clone() for n, p in tlm.named_parameters()}
    _torch_run(tlm, lambda o: o.set_optim_method(toptim.SGD(0.1)),
               _batches(1))
    for n, p in tlm.named_parameters():
        assert torch.equal(p, before[n]) != n.startswith("5."), n


# ----------------------------------------------------------- regularizers
@pytest.mark.parametrize("kind", ["l1", "l2", "l1l2"])
def test_regularizer_penalties_match_jax(kind):
    w = np.random.default_rng(4).normal(size=(6, 5)).astype(np.float32)
    make = {"l1": lambda m: m.L1Regularizer(0.03),
            "l2": lambda m: m.L2Regularizer(0.05),
            "l1l2": lambda m: m.L1L2Regularizer(0.03, 0.05)}[kind]
    got = make(toptim).penalty(torch.from_numpy(w).bfloat16())
    want = make(joptim).penalty(jnp.asarray(w).astype(jnp.bfloat16))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_regularized_training_matches_jax():
    """L2 on the decoder's weight, L1 on its bias, L1L2 on block1's first
    MLP Linear: the penalty joins the loss in both packages."""
    jlm, tlm = _models()
    for lm, mod in ((jlm, joptim), (tlm, toptim)):
        dec = lm[5][0]
        dec.w_regularizer = mod.L2Regularizer(0.01)
        dec.b_regularizer = mod.L1Regularizer(0.01)
        lm[2][1][0][1][1][0].w_regularizer = mod.L1L2Regularizer(0.001, 0.01)
    assert tlm.has_regularizers() and jlm.has_regularizers()
    pen = float(tlm.regularizer_penalty().detach())
    assert pen == pytest.approx(float(jlm.regularizer_penalty(
        jlm.get_params())), rel=1e-5)
    batches = _batches(3)

    def configure(mod):
        return lambda opt: opt.set_optim_method(mod.SGD(learningrate=0.1))

    want_losses, want, _ = _jax_run(jlm, configure(joptim), batches)
    losses, _ = _torch_run(tlm, configure(toptim), batches)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_params_close(tlm, want)


# ------------------------------------------------------------------ remat
@pytest.mark.parametrize("mode", ["dots", "full"])
def test_remat_gives_the_plain_step_bit_for_bit(mode, monkeypatch):
    """``set_remat`` recomputes the forward in the backward; the loss and
    the updated parameters equal the step without remat bit for bit, and
    the LayerNorm forward runs again in the recomputation."""
    _, plain_lm = _models()
    _, remat_lm = _models()
    batches = _batches(2)
    configure = (lambda opt: opt.set_optim_method(
        toptim.SGD(learningrate=0.1, momentum=0.9)))
    want, _ = _torch_run(plain_lm, configure, batches)
    calls = []
    plain_fwd = ln_module.layer_norm_reference

    def counted(*a):
        calls.append(1)
        return plain_fwd(*a)

    monkeypatch.setattr(ln_module, "layer_norm_reference", counted)
    got, _ = _torch_run(remat_lm, lambda o: configure(o.set_remat(mode)),
                        batches)
    assert got == want
    for (n, a), b in zip(remat_lm.named_parameters(),
                         plain_lm.parameters()):
        assert torch.equal(a, b), n
    assert len(calls) == 2 * 2 * (2 * LAYERS + 1)   # forward + recompute
    with pytest.raises(ValueError, match="remat mode"):
        toptim.LocalOptimizer(remat_lm, DataSet.array([]), lm_criterion(),
                              device="cpu").set_remat("some")


@pytest.mark.parametrize("mode", ["dots", "full"])
def test_remat_modes_match_jax(mode):
    """``set_remat(mode)`` in both packages (JAX: ``jax.checkpoint`` with
    ``checkpoint_dots`` or no policy) trains the same trajectory."""
    jlm, tlm = _models()
    batches = _batches(3)

    def configure(mod):
        return lambda opt: opt.set_optim_method(
            mod.SGD(learningrate=0.1, momentum=0.9)).set_remat(mode)

    want_losses, want, _ = _jax_run(jlm, configure(joptim), batches)
    losses, opt = _torch_run(tlm, configure(toptim), batches)
    assert opt.remat == mode
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_params_close(tlm, want)


def test_remat_transformer_lm_matches_jax():
    """``TransformerLM(remat=True)`` wraps each block in ``Remat`` in both
    packages (the same parameter paths, one level deeper) and trains as
    JAX's."""
    jlm, tlm = _models(remat=True)
    names = [n for n, _ in tlm.named_parameters()]
    assert sorted(names) == sorted(flatten_tree(jax.device_get(
        jlm.get_params())))
    assert any(n.startswith("2.0.0.") for n in names)
    batches = _batches(3)

    def configure(mod):
        return lambda opt: opt.set_optim_method(mod.SGD(learningrate=0.1,
                                                        momentum=0.9))

    want_losses, want, _ = _jax_run(jlm, configure(joptim), batches)
    losses, _ = _torch_run(tlm, configure(toptim), batches)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_params_close(tlm, want)
    with torch.no_grad():   # no autograd: the block runs plainly
        out = tlm(torch.from_numpy(batches[0][0]))
    assert out.shape == (BATCH, T, VOCAB)


def test_remat_blocks_recompute_on_the_step_parameters():
    """``Remat`` blocks recompute on the parameters the forward used: under
    the bf16 policy (cast parameters) with block1 frozen (detached ones),
    ``TransformerLM(remat=True)`` steps bit for bit as without remat."""
    from bigdl_tpu_torch.utils.engine import Engine as TorchEngine

    TorchEngine.init(compute_dtype=torch.bfloat16)
    try:
        runs = []
        for remat in (False, True):
            _, tlm = _models(remat=remat)
            tlm[2].freeze()
            losses, _ = _torch_run(tlm, lambda o: o.set_optim_method(
                toptim.SGD(learningrate=0.1, momentum=0.9)), _batches(2))
            runs.append((losses, [p.detach() for p in tlm.parameters()]))
    finally:
        TorchEngine.reset()
    (want, plain), (got, remat) = runs
    assert got == want
    for a, b in zip(remat, plain):
        assert torch.equal(a, b)


# ------------------------------------------------------------ flat update
_FLAT = {
    "sgd": lambda: toptim.SGD(learningrate=0.1),
    "sgd-momentum-wd": lambda: toptim.SGD(learningrate=0.1, momentum=0.9,
                                          weightdecay=0.01),
    "sgd-nesterov": lambda: toptim.SGD(learningrate=0.1, momentum=0.9,
                                       dampening=0.0, nesterov=True),
    "sgd-schedule": lambda: toptim.SGD(
        learningrate=0.1, learningrate_schedule=tsched.Exponential(2, 0.5)),
    "adam": lambda: toptim.Adam(learningrate=0.01),
    "adamw": lambda: toptim.AdamW(learningrate=0.01),
    "adagrad": lambda: toptim.Adagrad(learningrate=0.05, weightdecay=0.01),
    "adadelta": lambda: toptim.Adadelta(),
    "adamax": lambda: toptim.Adamax(),
    "rmsprop": lambda: toptim.RMSprop(learningrate=0.01),
    "ftrl": lambda: toptim.Ftrl(learningrate=0.05,
                                l1_regularization_strength=0.001),
}


@pytest.mark.parametrize("case", sorted(_FLAT))
def test_flat_update_is_bitwise_the_per_leaf_update(case):
    """Four steps with ``set_flat_update(True)`` (every parameter a view of
    one flat fp32 buffer, one update over it) give bit for bit the
    parameters of the per-leaf update. JAX pins the same property for its
    ``FlatParamUpdate`` in ``tests/test_kernels.py``."""
    _, per_leaf = _models()
    _, flat = _models()
    batches = _batches(4)
    want, _ = _torch_run(per_leaf, lambda o: o.set_optim_method(_FLAT[case]()),
                         batches)
    got, opt = _torch_run(flat, lambda o: o.set_optim_method(
        _FLAT[case]()).set_flat_update(True), batches)
    assert isinstance(opt._method, FlatParamUpdate)
    buf, = opt._ostate["flat"]
    assert buf.numel() == sum(p.numel() for p in flat.parameters())
    assert got == want
    for (n, a), b in zip(flat.named_parameters(), per_leaf.parameters()):
        assert torch.equal(a, b), n
        assert a.untyped_storage().data_ptr() == \
            buf.untyped_storage().data_ptr()


def test_flat_update_with_frozen_parameters():
    """Frozen parameters stay out of the flat buffer and out of the
    slots; the result is still the per-leaf one bit for bit."""
    _, per_leaf = _models()
    _, flat = _models()
    for lm in (per_leaf, flat):
        lm[3].freeze()
    batches = _batches(3)
    _torch_run(per_leaf, lambda o: o.set_optim_method(toptim.Adam(0.01)),
               batches)
    _, opt = _torch_run(flat, lambda o: o.set_optim_method(
        toptim.Adam(0.01)).set_flat_update(True), batches)
    frozen = sum(p.numel() for n, p in flat.named_parameters()
                 if n.startswith("3."))
    assert opt._ostate["flat"][0].numel() == \
        sum(p.numel() for p in flat.parameters()) - frozen
    for (n, a), b in zip(flat.named_parameters(), per_leaf.parameters()):
        assert torch.equal(a, b), n


def test_flat_update_keeps_per_leaf_methods_per_leaf():
    _, tlm = _models()
    for method in (toptim.LarsSGD(), toptim.LBFGS(),
                   toptim.SGD(layer_lr_mults={"['5']": 0.5})):
        opt = toptim.LocalOptimizer(tlm, DataSet.array([]), lm_criterion(),
                                    device="cpu").set_optim_method(method)
        opt.set_flat_update(True)
        assert opt._effective_method() is method
        assert not flat_supported(method)
