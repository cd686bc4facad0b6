"""The port's data-parallel trainer against JAX's, 4 gloo ranks on the CPU.

The JAX side runs in this process on a 4-device CPU mesh
(``tests/conftest.py``); the port side runs 4 ranks spawned once for the
file (``bigdl_tpu_torch.dryrun.spawn``, ``tests/torch_ranks.py``), each
starting from JAX's weights (``convert.load_jax_params``) on JAX's data:

- ``dryrun_multichip(4)``'s data-parallel legs (``allreduce``, ``zero1``,
  ``fsdp``) after 2 SGD-momentum steps: loss and every parameter;
- batch norm's running statistics and parameters after a data-parallel
  step, ``sync=False`` and ``sync=True``, against JAX's global-batch step;
- a masked criterion whose count differs per rank: the global mean;
- the three criteria that divide by a count of valid rows, with one
  rank's block or every block all padding (ranks 0 and 1 as a group of
  2), and on one process: JAX's clamped mean (0 where nothing counts);
- ZeRO-1 and FSDP checkpoints written at world 4 by rank 0: resumed by
  ``LocalOptimizer`` at world 1 and by JAX's trainer, which take the same
  next step from it;
- dropout draws each rank's own masks (JAX's masks never matched: parity
  runs use dropout 0);
- ``adapt_spec`` and ``zero1_state_sharding`` decisions leaf for leaf,
  the ``Engine`` mesh's refusals, ``sync=True`` outside a step.

Tolerance: fp32 with reductions ordered unlike XLA's, 1e-5 relative
(2e-5 for the parameters after two momentum steps) with an absolute floor
of 1e-6.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import dryrun as tdry

N = 4
RTOL, PTOL = 1e-5, 2e-5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jax_model(leg, n=N, schedule="gpipe"):
    """JAX's model of a dryrun leg (``bigdl_tpu/dryrun.py``)."""
    from bigdl_tpu import nn
    from bigdl_tpu.utils.random_generator import RandomGenerator
    RandomGenerator.set_seed(11)
    if leg == "dp":
        from bigdl_tpu.models.lenet import LeNet5
        return LeNet5(10)
    if leg == "tp":
        return (nn.Sequential().add(nn.Linear(16, 8)).add(nn.ReLU())
                .add(nn.Linear(8, 4)).add(nn.LogSoftMax()))
    if leg == "ep":
        from bigdl_tpu.parallel import MoE
        return (nn.Sequential().add(MoE(8, 16, n_experts=4, router="top2",
                                        z_loss_weight=1e-3))
                .add(nn.Linear(8, 3)).add(nn.LogSoftMax()))
    if leg == "pp":
        from bigdl_tpu.models.transformerlm.transformerlm import (
            PositionEmbedding, TransformerBlock)
        from bigdl_tpu.parallel import GPipe
        pp = 4 if n % 4 == 0 else 2
        embed = (nn.Sequential().add(nn.LookupTable(32, 16, zero_based=True))
                 .add(PositionEmbedding(8, 16)))
        blocks = [TransformerBlock(16, num_heads=2, dropout=0.0)
                  for _ in range(pp - 2)]
        head = (nn.Sequential().add(nn.LayerNorm(16))
                .add(nn.TimeDistributed(nn.Linear(16, 32)))
                .add(nn.TimeDistributed(nn.LogSoftMax())))
        return GPipe(stages=[embed] + blocks + [head], n_microbatches=2,
                     schedule=schedule)
    return (nn.Sequential()
            .add(nn.MultiHeadAttention(8, 2, causal=True,
                                       attention_impl="ring"))
            .add(nn.Select(2, -1)).add(nn.Linear(8, 4)).add(nn.LogSoftMax()))


def jax_train(model, samples, batch, crit, mesh, sync="allreduce", iters=2,
              lr=0.05, momentum=0.9, tp_rules=None, aux=None, ckpt=None,
              val=None):
    """JAX's DistriOptimizer on ``mesh`` = (shape, axes) of the first
    ``prod(shape)`` CPU devices; returns the optimizer."""
    from bigdl_tpu.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu.dataset.sample import Sample
    from bigdl_tpu.optim import SGD, DistriOptimizer, Trigger
    from bigdl_tpu.utils.engine import Engine
    shape, axes = mesh
    Engine.reset()
    Engine.init(core_number=int(np.prod(shape)), mesh_shape=shape,
                mesh_axes=axes)
    data = DataSet.array([Sample(x, y) for x, y in samples],
                         distributed=True) >> SampleToMiniBatch(batch)
    opt = (DistriOptimizer(model, data, crit, parameter_sync=sync)
           .set_optim_method(SGD(learningrate=lr, momentum=momentum,
                                 dampening=0.0))
           .set_end_when(Trigger.max_iteration(iters)))
    if tp_rules is not None:
        opt.set_tensor_parallel(tp_rules)
    if aux is not None:
        opt.set_aux_loss_weight(aux)
    if ckpt is not None:
        opt.set_checkpoint(ckpt, Trigger.several_iteration(iters))
    if val is not None:
        from bigdl_tpu.optim import Loss, Top1Accuracy
        opt.set_validation(
            Trigger.several_iteration(iters),
            DataSet.array([Sample(x, y) for x, y in val])
            >> SampleToMiniBatch(batch), [Top1Accuracy(), Loss()])
    opt.optimize()
    return opt


def in_parallel(port, jax_runs):
    """Run ``port()`` (the spawned ranks) on a thread while this process
    runs ``jax_runs`` (callables); returns (port's result, their
    results)."""
    import threading
    box = {}

    def target():
        try:
            box["out"] = port()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e

    t = threading.Thread(target=target)
    t.start()
    try:
        res = [f() for f in jax_runs]
    finally:
        t.join()
    if "err" in box:
        raise box["err"]
    return box["out"], res


def jax_leg(leg, variant, n=N, iters=2):
    """(init params, samples, a callable running JAX's leg) of a dryrun
    leg."""
    model = jax_model(leg, n, schedule=variant or "gpipe")
    init = _flat_tree(model.get_params())
    samples = tdry.leg_samples(leg, n)
    return init, samples, lambda: _jax_leg_run(model, leg, variant, samples,
                                               n, iters)


def _jax_leg_run(model, leg, variant, samples, n, iters):
    from bigdl_tpu import nn
    batch = {"dp": 4 * n, "tp": 2 * n, "ep": 2 * n, "pp": 2 * n,
             "sp": 4}[leg]
    crit = (nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                        size_average=True) if leg == "pp"
            else nn.ClassNLLCriterion())
    sync = variant if leg == "dp" else ("zero1" if leg in ("tp", "ep")
                                        else "allreduce")
    rules = aux = None
    if leg == "tp":
        from bigdl_tpu.parallel import megatron_mlp_rules
        rules = megatron_mlp_rules("0", "2")
    if leg == "ep":
        from bigdl_tpu.parallel import expert_parallel_rules
        rules, aux = expert_parallel_rules("0"), 0.01
    opt = jax_train(model, samples, batch, crit, tdry.leg_mesh(leg, n),
                    sync=sync, iters=iters, tp_rules=rules, aux=aux)
    out = {"loss": float(opt.state["loss"]),
           "params": _flat(jax_device_get(model.get_params()))}
    if leg == "ep":
        st = model.modules[0].get_state()
        out["dropped_fraction"] = float(np.asarray(st["dropped_fraction"]))
        out["aux_loss"] = float(np.asarray(st["aux_loss"]))
    return out


def jax_device_get(tree):
    import jax
    return jax.device_get(tree)


def _flat_tree(tree):
    """A JAX params tree as nested dicts of numpy arrays."""
    import jax
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale + 1e-6, f"{what}: {err:.3e} against {scale}"


def same_params(got: dict, want: dict, rtol=PTOL):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        close(got[k], want[k], rtol, k)


DP_LEGS = [("dp", s) for s in ("allreduce", "zero1", "fsdp")]


def _bn_samples():
    rng = np.random.default_rng(5)
    return [((rng.normal(size=(3, 4, 4)) * 2 + np.arange(3)[:, None, None]
              * (1 + i % 4)).astype(np.float32), np.int32(rng.integers(0, 2)))
            for i in range(16)]


def _ign_samples():
    rng = np.random.default_rng(6)
    # label 0 is the padding value: rank blocks hold 0, 1, 2, 3 of them
    labels = [0, 1, 2, 3, 0, 0, 4, 1, 0, 0, 0, 2, 0, 0, 0, 0,
              3, 4, 1, 2, 3, 4, 1, 2, 0, 3, 4, 1, 0, 0, 2, 3]
    return [(rng.normal(size=(6,)).astype(np.float32), np.int32(lab))
            for lab in labels]


PAD_KINDS = ("mask", "softmax", "chunked")


def _padding_case(kind, valid, seed):
    """(xs, ys, head) of two rank blocks of 4 rows; ``valid[r]`` says
    whether rank r's block holds valid labels (else only padding)."""
    rng = np.random.default_rng(seed)
    width = 6 if kind == "chunked" else 5
    xs = rng.normal(size=(2, 4, width)).astype(np.float32)
    if kind == "mask":
        xs = xs - np.log(np.exp(xs).sum(-1, keepdims=True))
    pad = {"mask": 0, "softmax": 255, "chunked": -1}[kind]
    lo = 1 if kind == "mask" else 0
    ys = np.where(np.asarray(valid)[:, None],
                  rng.integers(lo, 5, size=(2, 4)), pad).astype(np.int32)
    head = None
    if kind == "chunked":
        head = (rng.normal(size=(5, 6)).astype(np.float32),
                rng.normal(size=(5,)).astype(np.float32))
    return xs, ys, head


def padding_cases():
    """Each criterion with rank 0's block all padding (``one``) and with
    both blocks all padding (``all``)."""
    return {f"{kind}/{case}": (kind,) + _padding_case(
        kind, valid, seed=len(case) + PAD_KINDS.index(kind))
        for kind in PAD_KINDS
        for case, valid in (("one", (False, True)), ("all", (False, False)))}


def jax_padding(kind, x, y, head):
    """JAX's loss of ``padding_criterion(kind)`` and its gradient in
    ``x``."""
    import jax
    import jax.numpy as jnp
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.utils.table import Table as JTable
    import torch_ranks
    crit = torch_ranks.padding_criterion(kind, jnn)

    def f(x):
        inp = x if head is None else JTable(x, *map(jnp.asarray, head))
        return crit.apply(inp, jnp.asarray(y))

    loss, grad = jax.jit(jax.value_and_grad(f))(jnp.asarray(x))
    return float(loss), np.asarray(grad)


def _ckpt_samples():
    rng = np.random.default_rng(7)
    return [(rng.normal(size=(8,)).astype(np.float32),
             np.int32(rng.integers(0, 3))) for _ in range(16)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from bigdl_tpu import nn as jnn
    tmp = tmp_path_factory.mktemp("dist")
    legs, jruns = {}, []
    for leg, variant in DP_LEGS:
        init, samples, run = jax_leg(leg, variant)
        legs[f"{leg}/{variant}"] = (leg, variant, init, samples, 2)
        jruns.append(run)
    from bigdl_tpu.utils.random_generator import RandomGenerator
    RandomGenerator.set_seed(3)
    jbn = (jnn.Sequential().add(jnn.SpatialBatchNormalization(3))
           .add(jnn.Reshape([48])).add(jnn.Linear(48, 2))
           .add(jnn.LogSoftMax()))
    jign = jnn.Sequential().add(jnn.Linear(6, 5)).add(jnn.LogSoftMax())
    jck = (jnn.Sequential().add(jnn.Linear(8, 12)).add(jnn.Tanh())
           .add(jnn.Linear(12, 3)).add(jnn.LogSoftMax()))
    spec = {"legs": legs, "bn_init": _flat_tree(jbn.get_params()),
            "bn_samples": _bn_samples(),
            "ign_init": _flat_tree(jign.get_params()),
            "ign_samples": _ign_samples(), "padding": padding_cases(),
            "ckpt_init": _flat_tree(jck.get_params()),
            "ckpt_samples": _ckpt_samples(), "ckpt_dir": str(tmp)}

    def bn():
        jax_train(jbn, _bn_samples(), 16, jnn.ClassNLLCriterion(),
                  ((N,), ("data",)), iters=1, lr=0.1, momentum=0.0)
        return {"state": _flat(jax_device_get(jbn.get_state())),
                "params": _flat(jax_device_get(jbn.get_params()))}

    def ignored():
        opt = jax_train(jign, _ign_samples(), 8,
                        jnn.TimeDistributedMaskCriterion(
                            jnn.ClassNLLCriterion(), padding_value=0),
                        ((N,), ("data",)), iters=1, lr=0.1, momentum=0.0)
        return {"loss": float(opt.state["loss"]),
                "params": _flat(jax_device_get(jign.get_params()))}

    def padding():
        """JAX on each padding case's global batch, and on rank 0's block
        alone (the local case)."""
        out = {}
        for key, (kind, xs, ys, head) in spec["padding"].items():
            out[key] = jax_padding(kind, xs.reshape(8, -1), ys.reshape(8),
                                   head)
            if key.endswith("/all"):
                out[key + "/local"] = jax_padding(kind, xs[0], ys[0], head)
        return out

    def ckpt():
        opt = jax_train(jck, _ckpt_samples(), 8, jnn.ClassNLLCriterion(),
                        ((N,), ("data",)), sync="zero1", iters=2,
                        val=_ckpt_samples()[:12])
        return {"loss": float(opt.state["loss"]),
                "scores": {k: float(v) for k, v in
                           opt.state["scores"].items()},
                "params": _flat(jax_device_get(jck.get_params()))}

    import torch_ranks
    got, res = in_parallel(
        lambda: tdry.spawn(torch_ranks.distributed_file, N, (spec,),
                           backend="cpu", timeout=300, workdir=str(tmp)),
        jruns + [bn, ignored, padding, ckpt])
    want = {f"{leg}/{variant}": r for (leg, variant), r in zip(DP_LEGS, res)}
    want.update(bn=res[-4], ignored=res[-3], padding=res[-2], ckpt=res[-1])
    got[0]["padding_by_rank"] = {
        k: [got[0]["padding"][k], got[1]["padding"][k]]
        for k in got[0]["padding"]}
    return got[0], want, spec


@pytest.mark.parametrize("leg,variant", DP_LEGS)
def test_dryrun_dp_legs_match_jax(runs, leg, variant):
    got, want, _ = runs
    g, w = got["legs"][f"{leg}/{variant}"], want[f"{leg}/{variant}"]
    close(g["loss"], w["loss"], RTOL, "loss")
    same_params(g["params"], w["params"])
    assert g["step_mode"].startswith("eager")      # gloo: the explicit rule


@pytest.mark.parametrize("sync", [False, True])
def test_batch_norm_statistics_are_the_global_batch(runs, sync):
    got, want, _ = runs
    g = got[f"bn_sync={sync}"]
    close(g["mean"], want["bn"]["state"]["0.running_mean"], RTOL, "mean")
    close(g["var"], want["bn"]["state"]["0.running_var"], RTOL, "var")
    same_params(g["params"], want["bn"]["params"])


def test_sync_batch_norm_outside_a_step_raises_as_jax():
    """JAX's ``sync=True`` pmeans over an axis only ``shard_map`` binds:
    eager and under its DistriOptimizer's jit it raises ``NameError``;
    the port raises the same outside a data-parallel step."""
    import jax.numpy as jnp
    from bigdl_tpu import nn as jnn
    from bigdl_tpu_torch import nn as tnn
    bn = jnn.SpatialBatchNormalization(3, sync=True)
    with pytest.raises(NameError, match="unbound axis name"):
        bn.apply(bn.get_params(), bn.get_state(), jnp.ones((2, 3, 2, 2)),
                 training=True)
    with pytest.raises(NameError, match="unbound axis name"):
        tnn.SpatialBatchNormalization(3, sync=True).train()(
            torch.ones(2, 3, 2, 2))


def test_masked_criterion_takes_the_global_count(runs):
    got, want, _ = runs
    close(got["ignored"]["loss"], want["ignored"]["loss"], RTOL, "loss")
    same_params(got["ignored"]["params"], want["ignored"]["params"])


@pytest.mark.parametrize("case", ["one", "all"])
@pytest.mark.parametrize("kind", PAD_KINDS)
def test_padded_batches_take_the_global_count_clamped_as_jax(runs, kind,
                                                            case):
    """Over a data group of 2, one rank's block or both all padding: the
    ranks' average loss is JAX's on the global batch (0 where nothing
    counts, not 0/0), and a rank's input gradient is D times JAX's on its
    block (the trainer averages the ranks' gradients)."""
    got, want, _ = runs
    loss, grad = want["padding"][f"{kind}/{case}"]
    ranks = got["padding_by_rank"][f"{kind}/{case}"]
    close(np.mean([l for l, _ in ranks]), loss, RTOL, "loss")
    for r, (_, g) in enumerate(ranks):
        close(g / 2, grad[4 * r:4 * r + 4], RTOL, f"rank {r} gradient")
    if case == "all":
        assert loss == 0.0 and not np.any(grad)


@pytest.mark.parametrize("kind", PAD_KINDS)
def test_all_padding_batch_gives_jax_zero_locally(runs, kind):
    """One process, no data group: a batch of padding only gives JAX's 0
    loss and 0 gradient."""
    import torch_ranks
    _, want, spec = runs
    _, xs, ys, head = spec["padding"][f"{kind}/all"]
    x = torch.from_numpy(xs[0]).requires_grad_(True)
    loss = torch_ranks.padding_loss(kind, x, ys[0], head)
    loss.backward()
    wloss, grad = want["padding"][f"{kind}/all/local"]
    assert float(loss.detach()) == wloss == 0.0
    np.testing.assert_array_equal(x.grad.numpy(), grad)


@pytest.mark.parametrize("sync", ["zero1", "fsdp"])
def test_zero_checkpoint_resumes_at_world_1_and_jax_reads_it(runs, sync):
    from bigdl_tpu.optim.optimizer import Optimizer as JOptimizer
    from bigdl_tpu_torch import convert, nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.sample import Sample, SampleToMiniBatch
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    got, want, spec = runs
    g = got[f"ckpt_{sync}"]
    assert g["shards"] == ["0.bias", "0.weight"]   # 12 rows split, 3 not
    close(g["loss"], want["ckpt"]["loss"], RTOL, "loss")
    same_params(g["params"], want["ckpt"]["params"])
    # the validation every rank runs whole: JAX's scores
    assert set(g["scores"]) == set(want["ckpt"]["scores"])
    for k, v in want["ckpt"]["scores"].items():
        close(g["scores"][k], v, RTOL, k)
    path = os.path.join(spec["ckpt_dir"], sync)
    files = sorted(os.listdir(path))
    assert files == ["checkpoint.2.pkl"], files
    # the port's trainer at world 1 resumes it and continues
    m = (nn.Sequential().add(nn.Linear(8, 12)).add(nn.Tanh())
         .add(nn.Linear(12, 3)).add(nn.LogSoftMax()))
    data = DataSet.array([Sample(x, y) for x, y in spec["ckpt_samples"]]) \
        >> SampleToMiniBatch(8)
    opt = (LocalOptimizer(m, data, nn.ClassNLLCriterion(), device="cpu")
           .set_optim_method(SGD(learningrate=0.05, momentum=0.9,
                                 dampening=0.0))
           .set_checkpoint(path, Trigger.several_iteration(100))
           .set_end_when(Trigger.max_iteration(3)))
    opt._load_latest_checkpoint()
    for n, p in m.named_parameters():
        close(p.detach().numpy(), g["params"][n], 0.0, n)
    v = opt._ostate["v"]
    assert [tuple(t.shape) for t in v] == [(12, 8), (12,), (3, 12), (3,)]
    opt.optimize()
    assert opt.state["neval"] == 4
    # JAX's reader takes the file (its trainer's resume path) and takes the
    # same third step from it
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.dataset import DataSet as JDataSet, SampleToMiniBatch as JS
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu.optim import SGD as JSGD, Trigger as JTrigger
    from bigdl_tpu.utils.engine import Engine as JEngine
    JEngine.reset()
    JEngine.init(core_number=1)
    jm = (jnn.Sequential().add(jnn.Linear(8, 12)).add(jnn.Tanh())
          .add(jnn.Linear(12, 3)).add(jnn.LogSoftMax()))
    jdata = JDataSet.array([JSample(x, y) for x, y in
                            spec["ckpt_samples"]]) >> JS(8)
    jopt = (JOptimizer(jm, jdata, jnn.ClassNLLCriterion())
            .set_optim_method(JSGD(learningrate=0.05, momentum=0.9,
                                   dampening=0.0))
            .set_checkpoint(path, JTrigger.several_iteration(100))
            .set_end_when(JTrigger.max_iteration(3)))
    jopt._load_latest_checkpoint()
    jparams = _flat(jax_device_get(jm.get_params()))
    for n, p in g["params"].items():
        close(jparams[n], p, 0.0, n)
    jv = _flat(jopt._resume_ostate["v"])
    assert set(jv) == {"0.weight", "0.bias", "2.weight", "2.bias"}
    jopt.optimize()
    close(opt.state["loss"], jopt.state["loss"], RTOL, "step 3's loss")


def test_fused_windows_equal_per_step_runs(runs):
    """``set_fuse_steps(2)`` under zero1 over 4 ranks: the per-step run's
    loss and weights, bitwise."""
    (l1, p1), (l2, p2) = runs[0]["fused"][1], runs[0]["fused"][2]
    assert l1 == l2
    for n in p1:
        assert np.array_equal(p1[n], p2[n]), n


def test_dropout_draws_each_ranks_own_masks(runs):
    masks = runs[0]["dropout_masks"]
    assert masks.shape == (N, 64)
    assert len({m.tobytes() for m in masks}) == N


def test_sharding_decisions_match_jax():
    import jax
    from jax.sharding import Mesh, PartitionSpec as JP
    from bigdl_tpu.parallel import sharding as js
    from bigdl_tpu_torch.parallel import sharding as ts
    jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                 ("data", "model"))

    class FakeMesh:
        shape = {"data": 2, "model": 2}

    tree = {"a": np.zeros((4, 3)), "b": np.zeros((3,)), "c": np.zeros((1, 2)),
            "d": {"e": np.zeros((2,)), "f": np.zeros(())}}
    jz = js.zero1_state_sharding(jmesh, tree)
    tz = ts.zero1_state_sharding(FakeMesh, tree)
    for k in ("a", "b", "c"):
        assert tuple(tz[k].spec) == tuple(jz[k].spec), k
    for k in ("e", "f"):
        assert tuple(tz["d"][k].spec) == tuple(jz["d"][k].spec), k
    for spec in [None, ("data",), ("model", None), (None, "model"),
                 (("data", "model"),), ("seq",), ("data", "model")]:
        for shape in [(4, 6), (3, 2), (8,), (2, 4)]:
            want = tuple(js.adapt_spec(spec, jmesh, shape))
            got = tuple(ts.adapt_spec(spec, FakeMesh, shape))
            assert got == want, (spec, shape)
    sh = js.shard_leading_axis(jmesh, (4, 2))
    assert ts.spec_to_tuple(ts.shard_leading_axis(FakeMesh, (4, 2))) == \
        js.spec_to_tuple(sh)
    assert ts.spec_to_tuple(None) is js.spec_to_tuple(None) is None
    assert JP is not None


def test_engine_mesh_refusals_and_defaults(monkeypatch):
    from bigdl_tpu_torch.utils.engine import Engine
    Engine.reset()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Engine.init()
    with pytest.raises(RuntimeError, match="backend='cpu'"):
        Engine.mesh()
    Engine.reset()
    with pytest.raises(ValueError, match="needs 4 devices"):
        Engine.init(backend="cpu", mesh_shape=(2, 2))
    Engine.reset()
    Engine.init(backend="cpu")
    mesh = Engine.mesh()
    assert mesh.shape == {"data": 1} and Engine.device() == \
        torch.device("cpu")
    assert Engine.devices() == [0] and Engine.device_count() == 1
    Engine.reset()
    assert Engine.mesh_if_up() is None
    pickle.dumps(Engine.config())
