"""The distributed trainer's configurations JAX runs and the port used to
refuse, against JAX (4 gloo ranks spawned once for the file,
``tests/torch_ranks.py``, JAX on the conftest's CPU devices), and the
repairs of the mains' seed and datasets:

- LarsSGD and LBFGS under ``zero1`` and ``fsdp`` at data 4 (a ``(4,)``
  mesh) and data 2 (a ``(2, 2)`` ``data x model`` mesh without tensor
  parallelism) against JAX's DistriOptimizer on 4 and 2 devices
  (``zero1``: JAX's ``fsdp`` is the same GSPMD program, bit for bit): the
  losses of 3 steps within 1e-5 relative, the parameters within 2e-5;
- fsdp's bytes a rank holds: parameters and slots between steps are the
  unsplit leaves plus 1/N of the rest, to the byte, and the gathered
  weights alive at once during a step are at most one layer's;
- bf16 GPipe (the LM leg's two stages on a data 2 x pipe 2 mesh, 2
  steps): every module of each rank's stage computes in bf16 (fp32 in
  the fp32 run); the loss within 2e-5 relative of JAX's bf16 GPipe and of
  the port's fp32 run (readings 8.8e-6 and 8.6e-6; a frozen run is
  3.9e-5 from JAX's); each parameter departs from the fp32 run's by at
  most 2% of that run's update (reading 0.42%; a stage that does not
  update departs by 100%); the readings: ``tests/torch_gpipe_readings.py``;
- ``BIGDL_CHECK_IDS``: JAX's out-of-range error eagerly and after a
  checked step, the step's programs unchanged without it;
- under ``BIGDL_SEED=7`` a main's first-epoch batch order is JAX's main's;
  the mains' datasets carry ``distributed`` as JAX's do, so the
  ``Optimizer`` factory builds a ``DistriOptimizer`` for them.
"""

import numpy as np
import pytest
import torch

import torch_ranks
from bigdl_tpu_torch import dryrun as tdry
from test_torch_distributed import _flat, _flat_tree, close, in_parallel

RTOL, PTOL = 1e-5, 2e-5
# bf16 GPipe: the loss (relative) and each parameter's gap to the fp32
# run as a share of that run's update
BF16_LOSS, BF16_UPDATE = 2e-5, 2e-2


def _samples():
    rng = np.random.default_rng(11)
    return [(rng.normal(size=(8,)).astype(np.float32),
             np.int32(rng.integers(0, 3))) for _ in range(32)]


def _jax_mlp():
    from bigdl_tpu import nn
    from bigdl_tpu.utils.random_generator import RandomGenerator
    RandomGenerator.set_seed(13)
    return nn.Sequential().add(nn.Linear(8, 16)).add(nn.ReLU()) \
        .add(nn.Linear(16, 3)).add(nn.LogSoftMax())


def _jax_method(name):
    from bigdl_tpu.optim.optim_method import LBFGS, LarsSGD
    return (LarsSGD(learningrate=0.1, weightdecay=1e-3) if name == "lars"
            else LBFGS(history=4, learningrate=0.5))


def _jax_run(name, sync, d, init):
    """JAX's DistriOptimizer on ``d`` devices: 3 steps' losses and the
    parameters."""
    from bigdl_tpu.dataset import DataSet
    from bigdl_tpu.dataset.sample import Sample, SampleToMiniBatch
    from bigdl_tpu.nn import ClassNLLCriterion
    from bigdl_tpu.optim import Trigger
    from bigdl_tpu.optim.distri_optimizer import DistriOptimizer
    from bigdl_tpu.optim.optimizer import Optimizer
    from bigdl_tpu.utils.engine import Engine
    from bigdl_tpu.utils.random_generator import RandomGenerator
    Engine.reset()
    Engine.init(core_number=d)
    model = _jax_mlp()
    model.set_params(init)
    RandomGenerator.set_seed(5)
    data = DataSet.array([Sample(x, y) for x, y in _samples()],
                         distributed=True) >> SampleToMiniBatch(16)
    opt = (DistriOptimizer(model, data, ClassNLLCriterion(),
                           parameter_sync=sync)
           .set_optim_method(_jax_method(name))
           .set_end_when(Trigger.max_iteration(3)))
    seen, guard = [], Optimizer._guard_loss

    def record(self, it, v):
        seen.append(float(v))
        return guard(self, it, v)

    Optimizer._guard_loss = record
    try:
        opt.optimize()
    finally:
        Optimizer._guard_loss = guard
    import jax
    return {"losses": seen, "params": _flat(jax.device_get(
        model.get_params()))}


def _jax_gpipe(init, samples, dtype="bfloat16", lr=0.05):
    """JAX's GPipe of the LM leg's 2 stages on (data 2, pipe 2), 2 steps,
    in ``dtype`` (bf16 by default) with SGD at ``lr``: the last loss."""
    import jax.numpy as jnp
    from bigdl_tpu import nn
    from bigdl_tpu.dataset import DataSet
    from bigdl_tpu.dataset.sample import Sample, SampleToMiniBatch
    from bigdl_tpu.optim import SGD, DistriOptimizer, Trigger
    from bigdl_tpu.utils.engine import Engine
    from bigdl_tpu.utils.random_generator import RandomGenerator
    from test_torch_distributed import jax_model
    model = jax_model("pp", 2)
    model.set_params(init)
    Engine.reset()
    Engine.init(core_number=4, mesh_shape=(2, 2), mesh_axes=("data",
                                                             "pipe"),
                compute_dtype=getattr(jnp, dtype))
    RandomGenerator.set_seed(5)
    data = DataSet.array([Sample(x, y) for x, y in samples],
                         distributed=True) >> SampleToMiniBatch(8)
    opt = (DistriOptimizer(model, data, nn.TimeDistributedCriterion(
        nn.ClassNLLCriterion(), size_average=True))
           .set_optim_method(SGD(learningrate=lr, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_iteration(2)))
    opt.optimize()
    loss = float(opt.state["loss"])
    Engine.reset()
    return loss


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("configs")
    from test_torch_distributed import jax_model
    init = _flat_tree(_jax_mlp().get_params())
    pp_init = _flat_tree(jax_model("pp", 2).get_params())
    pp_samples = tdry.leg_samples("pp", 4)
    spec = {"samples": _samples(), "init": init, "pp_init": pp_init,
            "pp_samples": pp_samples}
    jobs = [lambda n=n, d=d: ((n, d), _jax_run(n, "zero1", d, init))
            for n in ("lars", "lbfgs") for d in (4, 2)]
    jobs.append(lambda: ("gpipe", _jax_gpipe(pp_init, pp_samples)))
    got, res = in_parallel(
        lambda: tdry.spawn(torch_ranks.configs_file, 4, (spec,),
                           backend="cpu", timeout=300, workdir=str(tmp)),
        jobs)
    return got, dict(res)


@pytest.mark.parametrize("d", [4, 2])
@pytest.mark.parametrize("sync", ["zero1", "fsdp"])
@pytest.mark.parametrize("name", ["lars", "lbfgs"])
def test_non_elementwise_methods_under_zero(runs, name, sync, d):
    got, want = runs
    w = want[(name, d)]
    for rank in got:
        r = rank[f"{name}/{sync}/{d}"]
        np.testing.assert_allclose(r["losses"], w["losses"], rtol=RTOL,
                                   atol=1e-7)
        for k, a in w["params"].items():
            close(r["params"][k], a, PTOL, k)


@pytest.mark.parametrize("d", [4, 2])
def test_fsdp_holds_a_block_and_gathers_a_layer(runs, d):
    """Linear(8, 16) and Linear(16, 3): at data ``d`` the first layer's
    weight and bias split (16 rows), the second layer's (3 rows) stay
    whole. LBFGS's history (4 rows of the flat vector) holds the same
    blocks."""
    got, _ = runs
    split = (16 * 8 + 16) * 4            # bytes of the split leaves
    whole = (3 * 16 + 3) * 4
    held = whole + split // d
    layer = split                        # the first layer, gathered
    for rank in got:
        for name, slots in (("lars", held), ("lbfgs", 4 * 2 * held
                                             + 2 * held + 4 * 4 + 3 * 8)):
            for b in rank[f"{name}/fsdp/{d}"]["bytes"]:
                assert b["params"] == held
                assert b["gathered_peak"] == layer
                assert b["slots"] == slots


def test_bf16_gpipe_against_jax(runs):
    got, want = runs
    bf, fp = got[0]["gpipe/torch.bfloat16"], got[0]["gpipe/torch.float32"]
    assert np.isfinite(bf["loss"])
    for r in got:
        assert r["gpipe/torch.bfloat16"]["computed"] == ["torch.bfloat16"]
        assert r["gpipe/torch.float32"]["computed"] == ["torch.float32"]
        assert r["gpipe/torch.bfloat16"]["loss"] == bf["loss"]
    close(bf["loss"], want["gpipe"], BF16_LOSS, "bf16 loss vs JAX's")
    close(bf["loss"], fp["loss"], BF16_LOSS, "bf16 loss vs fp32")
    for k, a in fp["params"].items():
        update = np.max(np.abs(a - fp["init"][k]))
        gap = np.max(np.abs(bf["params"][k] - a))
        assert update > 0 and gap <= BF16_UPDATE * update, (k, gap, update)


# ------------------------------------------------------------ the ids guard
def _lm_opt(ids, check=True):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.sample import Sample, SampleToMiniBatch
    from bigdl_tpu_torch.optim import LocalOptimizer, SGD, Trigger
    torch.manual_seed(0)
    model = (nn.Sequential().add(nn.LookupTable(10, 4, zero_based=True))
             .add(nn.Select(2, -1)).add(nn.Linear(4, 3))
             .add(nn.LogSoftMax()))
    data = DataSet.array([Sample(np.asarray(x, np.int64), np.int32(0))
                          for x in ids]) >> SampleToMiniBatch(2)
    opt = (LocalOptimizer(model, data, nn.ClassNLLCriterion(), device="cpu")
           .set_optim_method(SGD(learningrate=0.1))
           .set_end_when(Trigger.max_iteration(2)))
    return opt.set_check_numerics(check)


def test_ids_guard_eager_as_jax(monkeypatch):
    from bigdl_tpu import nn as jnn
    from bigdl_tpu_torch import nn
    monkeypatch.setenv("BIGDL_CHECK_IDS", "1")
    t, j = nn.LookupTable(10, 4), jnn.LookupTable(10, 4)
    t.run(torch.tensor([[1, 10]]))                # 1-based: in range
    for bad in ([[0, 3]], [[4, 11]]):
        with pytest.raises(IndexError) as te:
            t.run(torch.tensor(bad))
        with pytest.raises(IndexError) as je:
            j.forward(np.asarray(bad))
        tail = lambda e: str(e.value).split(": ", 1)[1]
        assert tail(te) == tail(je)
        assert "10 rows" in str(te.value)
    monkeypatch.delenv("BIGDL_CHECK_IDS")
    with pytest.raises(IndexError, match="index out of range in self"):
        t.run(torch.tensor([[0, 3]]))             # unchecked: the gather's


def test_ids_guard_in_a_checked_step(monkeypatch):
    """Inside the checked step the guard adds a device flag; the trainer
    raises JAX's checkify message after the step that saw it."""
    ok, bad = [[1, 2]] * 4, [[1, 2], [3, 12], [1, 2], [1, 2]]
    monkeypatch.setenv("BIGDL_CHECK_IDS", "1")
    opt = _lm_opt(ok)
    opt.optimize()
    assert opt.state["neval"] == 3
    opt = _lm_opt(bad)
    with pytest.raises(IndexError, match=r"id out of range \[0, 10\) after "
                       r"base adjustment \(min=1, max=12\)"):
        opt.optimize()
    # off: the step and its program key are the unchecked ones
    monkeypatch.delenv("BIGDL_CHECK_IDS")
    opt = _lm_opt(ok)
    opt.optimize()
    key = opt._step_program.key
    monkeypatch.setenv("BIGDL_CHECK_IDS", "1")
    opt2 = _lm_opt(ok, check=False)
    opt2.optimize()
    assert opt2._step_program.key[6] is False and key[6] is False


# ------------------------------------------------------ the mains' repairs
class _Shuffled(Exception):
    pass


def _first_order(pkg: str, main: str, argv: list) -> list:
    """The epoch order a main's trainer shuffles first (it stops there).
    JAX's main builds its model from ``RandomGenerator``, the port's from
    a generator of its own: JAX's is built beforehand (as in
    ``test_torch_distributed_mains.py``) so that the shuffle's draws are
    the first of both."""
    import importlib
    if pkg == "jax":
        from bigdl_tpu.models import lenet
        built = lenet.LeNet5(10)
        ctor, lenet.LeNet5 = lenet.LeNet5, lambda *a, **k: built
        try:
            return _first_order("jax-built", main, argv)
        finally:
            lenet.LeNet5 = ctor
    pkg = "jax" if pkg == "jax-built" else pkg
    base = importlib.import_module(
        f"{'bigdl_tpu' if pkg == 'jax' else 'bigdl_tpu_torch'}"
        f".dataset.dataset")
    cls = base.LocalDataSet
    orig = cls.shuffle

    def shuffle(self):
        orig(self)
        raise _Shuffled(np.array(self._order, copy=True))

    cls.shuffle = shuffle
    try:
        m = importlib.import_module(
            f"{'bigdl_tpu' if pkg == 'jax' else 'bigdl_tpu_torch'}"
            f".models.{main}.train")
        with pytest.raises(_Shuffled) as e:
            m.main(argv)
        return e.value.args[0].tolist()
    finally:
        cls.shuffle = orig


def test_a_main_shuffles_as_jax_under_bigdl_seed(monkeypatch):
    from bigdl_tpu.utils.engine import Engine as JEngine
    from bigdl_tpu_torch.utils.engine import Engine
    monkeypatch.setenv("BIGDL_SEED", "7")
    argv = ["-b", "16", "--synthetic-size", "64"]
    JEngine.reset()
    Engine.reset()
    want = _first_order("jax", "lenet", argv)
    got = _first_order("torch", "lenet", argv + ["--device", "cpu"])
    assert got == want
    # the old fixed seed 0 shuffled otherwise
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    Engine.reset()
    assert Engine.is_initialized() is False
    RandomGenerator.set_seed(0)
    Engine.init()
    assert _first_order("torch", "lenet", argv + ["--device", "cpu"]) \
        != want
    Engine.reset()


MARKED = {
    "vgg": ["--synthetic-size", "8", "-b", "8"],
    "resnet": ["--depth", "8", "--synthetic-size", "16", "-b", "8"],
    "resnet-imagenet": ["--dataset", "ImageNet", "--depth", "18",
                        "--classes", "4", "--synthetic-size", "32", "-b",
                        "8"],
    "inception": ["-b", "2", "--classes", "3", "--synthetic-size", "2",
                  "--image-size", "224", "--max-iteration", "1"],
    "lenet": ["-b", "16", "--synthetic-size", "32"],
    "rnn": ["-b", "8", "--vocab-size", "40", "--hidden-size", "8",
            "--num-layers", "1", "--bptt", "8"],
}


class _Built(Exception):
    pass


@pytest.mark.parametrize("main", sorted(MARKED))
def test_the_mains_datasets_are_marked_distributed(main):
    """Every train and validation set a main hands its trainer under
    ``--distributed`` answers ``is_distributed()``, and the ``Optimizer``
    factory builds a ``DistriOptimizer`` from it, as JAX's does (one
    process, a world of 1 over gloo)."""
    import importlib
    from bigdl_tpu_torch.dataset.dataset import is_distributed
    from bigdl_tpu_torch.optim.distri_optimizer import DistriOptimizer
    from bigdl_tpu_torch.optim.optimizer import Optimizer
    from bigdl_tpu_torch.utils.engine import Engine
    seen = {}
    init, setval = Optimizer.__init__, Optimizer.set_validation

    def record_init(self, model, dataset, criterion, device=None):
        seen["train"] = dataset
        init(self, model, dataset, criterion, device)

    def record_val(self, trigger, dataset, methods, *a, **k):
        seen["val"] = dataset
        raise _Built

    Optimizer.__init__, Optimizer.set_validation = record_init, record_val
    name = main.split("-")[0]
    try:
        Engine.reset()
        m = importlib.import_module(f"bigdl_tpu_torch.models.{name}.train")
        with pytest.raises((_Built, StopIteration, RuntimeError)):
            if name == "inception":    # no validation set: stop at optimize
                DistriOptimizer.optimize = _raise_built
            m.main(MARKED[main] + ["--device", "cpu", "--distributed"])
    finally:
        Optimizer.__init__, Optimizer.set_validation = init, setval
        if "optimize" in DistriOptimizer.__dict__:
            del DistriOptimizer.optimize
        Engine.shutdown_distributed(timeout=10)
        Engine.reset()
    for ds in seen.values():
        assert is_distributed(ds)
        assert type(Optimizer(torch.nn.Linear(1, 1), ds,
                              None)).__name__ == "DistriOptimizer"


def _raise_built(self, *a, **k):
    raise _Built
