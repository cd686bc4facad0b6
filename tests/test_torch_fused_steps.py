"""Fused multi-step windows (``set_fuse_steps`` / ``BIGDL_FUSE_STEPS``) of
the port's trainer against the JAX trainer's, on the CPU.

A 2-layer TransformerLM of width 32 trains 10 iterations with
``set_fuse_steps(4)``, ended by ``max_iteration(10)``, beside a
``several_iteration(3)`` trigger, in both packages on the same weights and
batches (no shuffle). The port's loop evaluates only ``end_when``, at the
top of an iteration, so the ``several_iteration(3)`` trigger rides inside
it as a probe that records the iteration whose step has just run (at loop
top ``neval - 1``) and never stops the run; its schedule is the trigger's
own ``next_fire_in``, which clips the windows. The port runs windows of 3,
3, 3 and 1 steps; JAX, whose windows are all-or-nothing, runs these
iterations one at a time. Losses, parameters, the final state and the
probe's iterations must agree: losses within rtol 1e-4 and parameters
within atol 1e-4 of JAX (a whole model's backward summed in another order,
as ``tests/test_torch_training.py`` holds them), and bit for bit with the
port's own per-step run. A non-finite loss at the 3rd step of a fused
window raises ``NonFiniteLossError`` with the iteration JAX's
``_guard_loss`` names.
"""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.models.transformerlm import lm_criterion as jax_lm_criterion
from bigdl_tpu.optim import schedules as jsched
from bigdl_tpu.optim.optimizer import NonFiniteLossError as JNonFiniteLossError
from bigdl_tpu.utils.engine import Engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.dataset import DataSet, MiniBatch
from bigdl_tpu_torch.models.transformerlm import TransformerLM, lm_criterion
from bigdl_tpu_torch.models.transformerlm import train as train_main
from bigdl_tpu_torch.optim import schedules as tsched

VOCAB, E, HEADS, LAYERS, T, BATCH = 64, 32, 4, 2, 16, 4
ITERS, FUSE, EVERY = 10, 4, 3


def _lm_batches(n=12, seed=5):
    r = np.random.default_rng(seed)
    return [(r.integers(0, VOCAB, (BATCH, T)).astype(np.int32),
             r.integers(0, VOCAB, (BATCH, T)).astype(np.int32))
            for _ in range(n)]


def _method(optim, schedules):
    """SGD with momentum at a Poly-decayed rate: a different rate at every
    step, read by the update from its device tensor."""
    return optim.SGD(learningrate=0.1, momentum=0.9,
                     learningrate_schedule=schedules.Poly(1.0, 20))


def _unshuffled(ds):
    ds.shuffle = lambda: None
    return ds


def _probe(mod, fired: list):
    """``end_when`` stand-in for an after-step trigger: records the
    iteration whose step has just run when ``several_iteration(EVERY)``
    fires there, never stops the run, and clips windows by that trigger's
    schedule."""
    inner = mod.Trigger.several_iteration(EVERY)

    def fn(state):
        done = state["neval"] - 1
        if done >= 1 and inner({"neval": done}):
            fired.append(done)
        return False

    return mod.Trigger(fn, "probe", steps_fn=inner.next_fire_in)


class _LossSummary:
    """The part of a JAX train summary that receives per-iteration losses."""

    def __init__(self):
        self.losses = {}

    def add_scalar(self, tag, value, it):
        if tag == "Loss":
            self.losses[it] = float(value)


def _jax_run(fuse, batches):
    Engine.reset()
    Engine.init(seed=3)
    JaxRNG.set_seed(3)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS,
                           num_layers=LAYERS, max_len=T)
    # a host copy: the JAX step donates the parameters' buffers
    params0 = jax.tree_util.tree_map(np.array, jlm.get_params())
    fired, summary = [], _LossSummary()
    ds = _unshuffled(JDataSet.array([JMiniBatch(x, y) for x, y in batches]))
    opt = (joptim.LocalOptimizer(jlm, ds, jax_lm_criterion())
           .set_optim_method(_method(joptim, jsched))
           .set_fuse_steps(fuse)
           .set_end_when(joptim.Trigger.or_(
               joptim.Trigger.max_iteration(ITERS), _probe(joptim, fired))))
    opt.set_train_summary(summary)
    opt.optimize()
    return (params0, flatten_tree(jlm.get_params()), dict(opt.state),
            [summary.losses[i] for i in sorted(summary.losses)], fired)


def _torch_run(fuse, batches, params0):
    tlm = TransformerLM(VOCAB, E, HEADS, LAYERS, T, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    load_jax_params(tlm, params0)
    fired, losses, windows = [], [], []
    ds = _unshuffled(DataSet.array([MiniBatch(x, y) for x, y in batches]))
    opt = (toptim.LocalOptimizer(tlm, ds, lm_criterion(), device="cpu")
           .set_optim_method(_method(toptim, tsched))
           .set_fuse_steps(fuse)
           .set_end_when(toptim.Trigger.or_(
               toptim.Trigger.max_iteration(ITERS), _probe(toptim, fired))))
    run_steps = opt._run_steps

    def recorded(steps):
        windows.append(len(steps))
        out = run_steps(steps)
        losses.extend(out)
        return out

    opt._run_steps = recorded
    opt.optimize()
    return tlm, dict(opt.state), losses, fired, windows


@pytest.fixture(scope="module")
def runs():
    batches = _lm_batches()
    params0, jparams, jstate, jlosses, jfired = _jax_run(FUSE, batches)
    fused = _torch_run(FUSE, batches, params0)
    per_step = _torch_run(1, batches, params0)
    return (jparams, jstate, jlosses, jfired), fused, per_step


def test_fused_windows_match_jax(runs):
    (jparams, jstate, jlosses, jfired), (tlm, state, losses, fired,
                                         windows), _ = runs
    assert windows == [3, 3, 3, 1]          # clipped by the probe, then 10
    assert len(losses) == len(jlosses) == ITERS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for name, p in tlm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[name]), atol=1e-4,
                                   err_msg=name)
    assert state["neval"] == jstate["neval"] == ITERS + 1
    assert state["epoch"] == jstate["epoch"] == 1
    np.testing.assert_allclose(state["loss"], jstate["loss"], rtol=1e-4)
    assert fired == jfired == [3, 6, 9]


def test_fused_windows_equal_the_per_step_run(runs):
    _, (tlm, state, losses, fired, windows), \
        (tlm1, state1, losses1, fired1, windows1) = runs
    assert windows1 == [1] * ITERS
    assert losses == losses1 and state == state1 and fired == fired1
    for (name, p), p1 in zip(tlm.named_parameters(), tlm1.parameters()):
        assert torch.equal(p, p1), name


def test_partial_trailing_window_runs_step_by_step():
    """7 batches an epoch, K=4: a window of 4, then the epoch's last 3 one
    at a time; the next epoch's window is clipped to the 3 iterations left
    before ``max_iteration(10)``."""
    batches = _lm_batches(7)
    tlm = TransformerLM(VOCAB, E, HEADS, LAYERS, T, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    ds = _unshuffled(DataSet.array([MiniBatch(x, y) for x, y in batches]))
    opt = (toptim.LocalOptimizer(tlm, ds, lm_criterion(), device="cpu")
           .set_fuse_steps(4)
           .set_end_when(toptim.Trigger.max_iteration(ITERS)))
    windows = []
    run_steps = opt._run_steps
    opt._run_steps = lambda steps: windows.append(len(steps)) or \
        run_steps(steps)
    opt.optimize()
    assert windows == [4, 1, 1, 1, 3]
    assert opt.state["neval"] == ITERS + 1 and opt.state["epoch"] == 2


def _linear_batches(nan_at: int, n=8, seed=2):
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = r.normal(size=(8, 6)).astype(np.float32)
        if i == nan_at:
            x[0, 0] = np.nan
        out.append((x, r.integers(0, 3, 8).astype(np.int32)))
    return out


def test_non_finite_loss_in_a_window_raises_with_jax_iteration():
    """Iterations 5–8 run as one fused window in both packages (JAX runs
    its first window step by step); the 7th batch holds a NaN, so the loss
    of the window's 3rd step is NaN, found when the window's losses are
    fetched."""
    batches = _linear_batches(nan_at=6)
    Engine.reset()
    Engine.init(seed=4)
    jmodel = jnn.Sequential().add(jnn.Linear(6, 3)).add(jnn.LogSoftMax())
    jds = _unshuffled(JDataSet.array([JMiniBatch(x, y) for x, y in batches]))
    jopt = (joptim.LocalOptimizer(jmodel, jds, jnn.ClassNLLCriterion())
            .set_optim_method(joptim.SGD(learningrate=0.1))
            .set_fuse_steps(FUSE)
            .set_end_when(joptim.Trigger.max_iteration(8)))
    with pytest.raises(JNonFiniteLossError) as want:
        jopt.optimize()

    tmodel = tnn.Sequential().add(tnn.Linear(6, 3)).add(tnn.LogSoftMax())
    tds = _unshuffled(DataSet.array([MiniBatch(x, y) for x, y in batches]))
    topt = (toptim.LocalOptimizer(tmodel, tds, tnn.ClassNLLCriterion(),
                                  device="cpu")
            .set_optim_method(toptim.SGD(learningrate=0.1))
            .set_fuse_steps(FUSE)
            .set_end_when(toptim.Trigger.max_iteration(8)))
    windows = []
    run_steps = topt._run_steps
    topt._run_steps = lambda steps: windows.append(len(steps)) or \
        run_steps(steps)
    with pytest.raises(toptim.NonFiniteLossError) as got:
        topt.optimize()
    assert windows == [4, 4]
    assert got.value.iteration == want.value.iteration == 7
    assert "iteration 7" in str(got.value)


def test_fuse_steps_knob(monkeypatch):
    tlm = TransformerLM(VOCAB, E, HEADS, LAYERS, T, device="cpu")
    ds = DataSet.array([])
    assert toptim.LocalOptimizer(tlm, ds, lm_criterion(),
                                 device="cpu").fuse_steps == 1
    monkeypatch.setenv("BIGDL_FUSE_STEPS", "3")
    opt = toptim.LocalOptimizer(tlm, ds, lm_criterion(), device="cpu")
    assert opt.fuse_steps == 3
    assert opt.set_fuse_steps(8) is opt and opt.fuse_steps == 8
    for bad in (0, -1, 1.5):
        with pytest.raises(ValueError):
            opt.set_fuse_steps(bad)


def test_train_main_reads_fuse_steps_from_the_environment(monkeypatch):
    """The training main takes no flag for it: ``BIGDL_FUSE_STEPS``
    reaches its optimizer, and the fused run ends on the per-step run's
    loss, bit for bit on the CPU."""
    argv = ["--device", "cpu", "-b", "4", "--seq-len", "16",
            "--embed-dim", "32", "--num-heads", "2", "--vocab-size", "64",
            "--max-iteration", "5", "--synthetic-tokens", "2000"]
    monkeypatch.delenv("BIGDL_FUSE_STEPS", raising=False)
    per_step = train_main.main(argv)
    monkeypatch.setenv("BIGDL_FUSE_STEPS", "2")
    windows = []
    run_steps = toptim.LocalOptimizer._run_steps

    def recorded(self, steps):
        windows.append(len(steps))
        return run_steps(self, steps)

    monkeypatch.setattr(toptim.LocalOptimizer, "_run_steps", recorded)
    assert train_main.main(argv) == per_step
    assert windows == [2, 2, 1]
