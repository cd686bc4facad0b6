"""The port's recsys path against the JAX package, on the CPU.

- ``LookupTable``'s ``max_norm`` (norm types 2 and 1.5): the output and the
  gradients of ``sum(out * w)`` within 1e-5 / 1e-4 relative of JAX's, the
  weight untouched by the forward;
- ``HashBucketEmbedding``: the bucket of ids 0, 1, 2^31, 2^32 - 1 and a
  sample of random 32-bit ids equal to JAX's, and its lookup;
- the five layers of ``nn/sparse.py`` (outputs and gradients, as above);
- ``dedup_ids``: JAX's ``(uids, inv)`` exactly, duplicates included, the
  sentinel at the tail; ``ShardedEmbedding``'s forward in every mode
  bitwise the wrapped ``LookupTable``'s; the deterministic segment sum
  against ``index_add_``;
- the sparse step: 5 steps of Adam and of SGD with momentum on a table
  behind ``ShardedEmbedding``, the touched rows within 2e-6 relative of
  JAX's sparse trajectory and of the port's own dense one (a constant,
  duplicate-free id set, where lazy and dense coincide), untouched rows
  and their slots bitwise unchanged; with duplicate ids, within 2e-6 of
  JAX's sparse trajectory; JAX's eligibility rules; a window of 4 fused
  steps bitwise 4 single steps;
- a sparse checkpoint of the port in JAX's ``{"dense", "embed"}`` layout
  (JAX's slot tree's paths and shapes), resumed bitwise by the port and
  continued by JAX within 1e-5;
- NeuralCF (sharded, hashed) and Wide & Deep: forward and 3 steps against
  JAX's step function from the same weights;
- both mains on the CPU (their flags and defaults JAX's, ``--distributed``
  refused naming ROADMAP A.6);
- the name diff of ``nn/sparse.py``, ``parallel/embedding.py`` (but the two
  mesh rule functions, ROADMAP A.6), ``HashBucketEmbedding`` and the
  models, exported as JAX exports them.
"""

import ast
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu import parallel as jparallel
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.dataset.sample import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.models.ncf import NeuralCF as JNeuralCF
from bigdl_tpu.models.ncf import train as jncf_main
from bigdl_tpu.models.widedeep import WideAndDeep as JWideAndDeep
from bigdl_tpu.models.widedeep import train as jwd_main
from bigdl_tpu.nn.sparse import (
    DenseToSparse as JDenseToSparse, LookupTableSparse as JLookupTableSparse,
    SparseEmbeddingSum as JSparseEmbeddingSum,
    SparseJoinTable as JSparseJoinTable, SparseLinear as JSparseLinear,
)
from bigdl_tpu.parallel.embedding import ShardedEmbedding as JSharded
from bigdl_tpu.parallel.embedding import dedup_ids as jdedup_ids
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch import optim
from bigdl_tpu_torch import parallel
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models import ncf, widedeep
from bigdl_tpu_torch.models.ncf import NeuralCF
from bigdl_tpu_torch.models.ncf import train as ncf_main
from bigdl_tpu_torch.models.widedeep import WideAndDeep
from bigdl_tpu_torch.models.widedeep import train as wd_main
from bigdl_tpu_torch.parallel.embedding import (
    ShardedEmbedding, build_sparse_plan, dedup_ids, segment_sum,
)
from bigdl_tpu_torch.utils import engine as torch_engine
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from bigdl_tpu_torch.utils.table import T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPARSE_RTOL = 2e-6     # touched rows, relative to the table's largest entry


@pytest.fixture(autouse=True)
def _one_thread_and_reset():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax_engine.Engine.reset()
    torch_engine.Engine.reset()


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _compiled(fn, *args):
    """``fn(*args)`` compiled once, without XLA's expensive CPU passes."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


def _check_layer(jm, tm, jinp, tinp, floats=()):
    """Output within 1e-5 and the gradients of ``sum(out * w)`` (every
    parameter, and the float inputs at positions ``floats`` of the input
    lists) within 1e-4 relative of JAX's."""
    load_jax_params(tm, jax.device_get(jm.get_params()))

    def leaves(out):
        return [out] if hasattr(out, "shape") else list(out.values())

    def jloss(p, fl):
        xs = list(jinp)
        for i, f in zip(floats, fl):
            xs[i] = f
        x = JT(*xs) if len(xs) > 1 else xs[0]
        outs = leaves(jm.apply(p, jm.get_state(), x)[0])
        return sum((o * _x(*o.shape, seed=9 + k)).sum() for k, o in
                   enumerate(outs) if jnp.issubdtype(o.dtype, jnp.floating)
                   ), outs

    (_, want), (gp, gx) = _compiled(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True), jm.get_params(),
        [jnp.asarray(jinp[i]) for i in floats])
    ts = [torch.from_numpy(np.asarray(a).copy()) for a in tinp]
    for i in floats:
        ts[i].requires_grad_()
    got = leaves(tm(T(*ts) if len(ts) > 1 else ts[0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    loss = sum((g * torch.from_numpy(_x(*g.shape, seed=9 + k))).sum()
               for k, g in enumerate(got) if g.is_floating_point())
    params = [p for _, p in tm.named_parameters()]
    grads = torch.autograd.grad(loss, params + [ts[i] for i in floats])
    gp = flatten_tree(jax.device_get(gp))
    for (n, _), g in zip(tm.named_parameters(), grads):
        assert _rel(g.numpy(), gp[n]) <= 1e-4, n
    for g, w in zip(grads[len(params):], gx):
        assert _rel(g.numpy(), w) <= 1e-4


# ------------------------------------------------------------ embeddings
@pytest.mark.parametrize("norm_type", [2.0, 1.5])
def test_lookup_table_max_norm_matches_jax(norm_type):
    JaxRNG.set_seed(1)
    jm = jnn.LookupTable(12, 5, max_norm=1.5, norm_type=norm_type)
    tm = nn.LookupTable(12, 5, max_norm=1.5, norm_type=norm_type)
    ids = np.array([[1, 3, 3], [12, 7, 1]], np.int32)
    _check_layer(jm, tm, [ids], [ids])
    w = np.asarray(jm.get_params()["weight"])
    assert np.array_equal(tm.weight.detach().numpy(), w)   # never renormed


def test_hash_bucket_embedding_matches_jax_buckets():
    ids = np.concatenate([
        np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint64),
        np.random.default_rng(0).integers(0, 2 ** 32, 64, dtype=np.uint64)])
    for buckets in (4096, 1000003, 2 ** 31 - 1):
        # the id map reads only n_index: no table of 2^31 rows is made
        table = SimpleNamespace(n_index=buckets)
        want = np.asarray(jnn.HashBucketEmbedding._ids(
            table, jnp.asarray(ids.astype(np.uint32))))
        got = nn.HashBucketEmbedding._ids(
            table, torch.from_numpy(ids.astype(np.int64))).numpy()
        np.testing.assert_array_equal(got, want)
    JaxRNG.set_seed(2)
    jm, tm = jnn.HashBucketEmbedding(97, 4), nn.HashBucketEmbedding(97, 4)
    raw = np.array([[5, 123456789], [2 ** 31 + 7, 0]], np.int64)
    _check_layer(jm, tm, [raw.astype(np.int32)], [raw])


# ---------------------------------------------------------- sparse layers
def _padded_ids(n, k, bound, seed):
    ids = np.random.default_rng(seed).integers(0, bound, (n, k))
    ids[:, -1] = -1
    ids[0, 1:] = -1
    return ids.astype(np.int32)


@pytest.mark.parametrize("values", [False, True])
def test_sparse_linear_and_embedding_bags_match_jax(values):
    ids = _padded_ids(3, 4, 10, 1)
    vals = np.abs(_x(3, 4, seed=2)) + 0.1
    inp = [ids, vals] if values else [ids]
    floats = (1,) if values else ()
    JaxRNG.set_seed(3)
    _check_layer(JSparseLinear(10, 3), nn.SparseLinear(10, 3), inp, inp,
                 floats)
    for combiner in ("mean", "sum"):
        _check_layer(JSparseEmbeddingSum(10, 4, combiner=combiner),
                     nn.SparseEmbeddingSum(10, 4, combiner=combiner),
                     inp, inp, floats)
    for combiner in ("sum", "mean", "sqrtn"):
        _check_layer(JLookupTableSparse(10, 4, combiner=combiner),
                     nn.LookupTableSparse(10, 4, combiner=combiner),
                     inp, inp, floats)


def test_dense_to_sparse_and_sparse_join_table_match_jax():
    x = np.zeros((3, 8), np.float32)
    x[0, [1, 5]] = [2.0, -3.0]
    x[1, [0, 2, 4, 7]] = [1.0, 1.0, -0.5, 1.0]     # ties beyond k
    x[2, 6] = 0.25
    jids, jvals = JDenseToSparse(3).apply({}, {}, jnp.asarray(x))[0].values()
    ids, vals = nn.DenseToSparse(3)(torch.from_numpy(x)).values()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    a, b = _padded_ids(2, 3, 5, 4), _padded_ids(2, 2, 7, 5)
    vb = _x(2, 2, seed=6)
    jout = JSparseJoinTable([0, 5]).apply(
        {}, {}, [JT(jnp.asarray(a)), JT(jnp.asarray(b), jnp.asarray(vb))])[0]
    out = nn.SparseJoinTable([0, 5])(
        [T(torch.from_numpy(a)), T(torch.from_numpy(b), torch.from_numpy(vb))])
    for g, w in zip(out.values(), jout.values()):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ dedup
@pytest.mark.parametrize("ids", [
    [7, 2, 7, 7, 2, 9], [3] * 8, list(range(9, -1, -1)), [0], [5, 5, 1]])
def test_dedup_ids_equals_jax(ids):
    a = np.asarray(ids, np.int32)
    juids, jinv = _compiled(lambda x: jdedup_ids(x, 100), jnp.asarray(a))
    uids, inv = dedup_ids(torch.from_numpy(a), 100)
    np.testing.assert_array_equal(uids.numpy(), np.asarray(juids))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert np.array_equal(uids.numpy()[inv.numpy()], a)


def test_segment_sum_matches_index_add():
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 13, 257))
    _, inv = dedup_ids(ids, 13)
    g = torch.from_numpy(_x(257, 3, seed=1)).double()
    want = torch.zeros(257, 3, dtype=torch.float64).index_add_(0, inv, g)
    got = segment_sum(g, inv, 257)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("mode", ["plain", "dedup", "sparse"])
@pytest.mark.parametrize("table", ["one_based", "max_norm_padded", "hash"])
def test_sharded_forward_is_bitwise_the_tables(mode, table):
    torch.manual_seed(0)
    make = {"one_based": lambda: nn.LookupTable(20, 4),
            "max_norm_padded": lambda: nn.LookupTable(
                20, 4, padding_value=3, max_norm=0.8),
            "hash": lambda: nn.HashBucketEmbedding(20, 4)}[table]
    t = make()
    sh = ShardedEmbedding(make(), dedup=(mode == "dedup"))
    sh.table.load_state_dict(t.state_dict())
    ids = torch.from_numpy(np.random.default_rng(1).integers(1, 21, (4, 6)))
    if mode == "sparse":
        sh._sparse = {"delta": None}
    got = sh(ids)
    assert torch.equal(got, t(ids))
    if mode == "sparse":
        assert sh._sparse["uids"].shape == (24,)


def test_sharded_forward_matches_jax():
    JaxRNG.set_seed(4)
    jm = JSharded(jnn.LookupTable(20, 4, max_norm=1.0))
    tm = ShardedEmbedding(nn.LookupTable(20, 4, max_norm=1.0))
    ids = np.random.default_rng(1).integers(1, 21, (3, 5)).astype(np.int32)
    assert [n for n, _ in tm.named_parameters()] == ["table.weight"]
    _check_layer(jm, tm, [ids], [ids])


# ------------------------------------------------------------ sparse step
METHODS = {
    "adam": lambda pkg: pkg.Adam(learningrate=0.05),
    "sgd-momentum": lambda pkg: pkg.SGD(learningrate=0.05, momentum=0.9,
                                        dampening=0.0),
}


def _jax_train(model, method, ids, target, steps=5):
    opt = joptim.LocalOptimizer(model, JDataSet.array([JMiniBatch(ids,
                                                                  target)]),
                                jnn.MSECriterion())
    opt.set_optim_method(method)
    opt.log_every = 10 ** 9
    opt.set_end_when(joptim.Trigger.max_iteration(steps))
    opt.optimize()
    return opt


def _port_train(model, method, ids, target, steps=5, sparse=True):
    opt = (optim.LocalOptimizer(model, DataSet.array([]), nn.MSECriterion(),
                                device="cpu")
           .set_optim_method(method).set_sparse_embeddings(sparse))
    for _ in range(steps):
        opt.train_step(torch.from_numpy(ids), torch.from_numpy(target))
    return opt


def _table_pair(V, D, seed=3):
    JaxRNG.set_seed(seed)
    jt = JSharded(jnn.LookupTable(V, D))
    w0 = np.asarray(jt.get_params()["table"]["weight"])

    def port(sharded=True):
        inner = nn.LookupTable(V, D)
        with torch.no_grad():
            inner.weight.copy_(torch.from_numpy(w0.copy()))
        return ShardedEmbedding(inner) if sharded else inner

    return jt, w0, port


@pytest.mark.parametrize("method", sorted(METHODS))
def test_sparse_trajectory_matches_jax_and_dense(method):
    V, D, B = 50, 8, 32
    rng = np.random.default_rng(3)
    ids = rng.permutation(np.arange(2, 2 + B, dtype=np.int32))
    target = rng.normal(size=(B, D)).astype(np.float32)
    touched = np.unique(ids) - 1
    untouched = np.setdiff1d(np.arange(V), touched)
    jt, w0, port = _table_pair(V, D)
    _jax_train(jt, METHODS[method](joptim), ids, target)
    w_jax = np.asarray(jt.get_params()["table"]["weight"])
    sparse, dense = port(), port(sharded=False)
    opt = _port_train(sparse, METHODS[method](optim), ids, target)
    assert type(opt._method).__name__ == "SparseEmbeddingUpdate"
    dopt = _port_train(dense, METHODS[method](optim), ids, target,
                       sparse=False)
    ws = sparse.table.weight.detach().numpy()
    wd = dense.weight.detach().numpy()
    scale = np.abs(w_jax[touched]).max()
    assert np.abs(ws[touched] - w_jax[touched]).max() <= SPARSE_RTOL * scale
    assert np.abs(ws[touched] - wd[touched]).max() <= SPARSE_RTOL * scale
    assert not np.array_equal(ws[touched], w0[touched])
    assert np.array_equal(ws[untouched], w0[untouched])
    for slot in opt._ostate["embed"]["."].values():
        assert not slot[0][untouched].any()           # never stepped
        assert slot[0][touched].any()
    # the dense run's slots equal the sparse run's on the touched rows
    for k, slot in opt._ostate["embed"]["."].items():
        np.testing.assert_allclose(slot[0][touched].numpy(),
                                   dopt._ostate[k][0][touched].numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_sparse_trajectory_with_duplicates_matches_jax():
    V, D, B = 50, 8, 32
    rng = np.random.default_rng(3)
    ids = rng.choice(np.arange(2, 12, dtype=np.int32), size=B)
    target = rng.normal(size=(B, D)).astype(np.float32)
    touched = np.unique(ids) - 1
    jt, w0, port = _table_pair(V, D)
    _jax_train(jt, joptim.Adagrad(learningrate=0.05), ids, target)
    w_jax = np.asarray(jt.get_params()["table"]["weight"])
    sparse = port()
    _port_train(sparse, optim.Adagrad(learningrate=0.05), ids, target)
    ws = sparse.table.weight.detach().numpy()
    scale = np.abs(w_jax[touched]).max()
    assert np.abs(ws[touched] - w_jax[touched]).max() <= SPARSE_RTOL * scale
    untouched = np.setdiff1d(np.arange(V), touched)
    assert np.array_equal(ws[untouched], w0[untouched])


def test_sparse_plan_follows_jax_rules():
    model = nn.Sequential().add(ShardedEmbedding(nn.LookupTable(10, 4)))
    plan, reason = build_sparse_plan(model, optim.Adam())
    assert plan is not None and reason is None
    assert [e.key for e in plan.entries] == ["0"]
    assert plan.weight_names() == {"0.table.weight"}
    for method in (optim.LBFGS(), optim.SGD(layer_lr_mults={"0": 2.0}),
                   optim.SGD(learningrate_schedule=optim.Plateau())):
        assert build_sparse_plan(model, method)[0] is None
    assert build_sparse_plan(nn.Sequential().add(nn.LookupTable(10, 4)),
                             optim.Adam()) == (None, None)
    model[0].set_scale_w(0.5)
    assert build_sparse_plan(model, optim.Adam())[0] is None
    opt = optim.LocalOptimizer(
        nn.Sequential().add(ShardedEmbedding(nn.LookupTable(10, 4))),
        DataSet.array([]), nn.MSECriterion(), device="cpu")
    assert opt._sparse_plan() is not None
    assert opt.set_gradient_accumulation(2)._sparse_plan() is None
    opt.set_gradient_accumulation(1)
    assert opt.set_sparse_embeddings(False)._sparse_plan() is None
    assert opt.set_sparse_embeddings(True)._sparse_plan() is not None


def test_fused_window_of_sparse_steps_is_bitwise_single_steps():
    rng = np.random.default_rng(5)
    batches = [(rng.integers(1, 40, (16, 3)).astype(np.int32),
                rng.normal(size=(16, 3, 4)).astype(np.float32))
               for _ in range(4)]
    runs = []
    for fuse in (1, 4):
        torch.manual_seed(0)
        model = ShardedEmbedding(nn.LookupTable(40, 4))
        from bigdl_tpu_torch.dataset import MiniBatch
        opt = (optim.LocalOptimizer(
            model, DataSet.array([MiniBatch(x, y) for x, y in batches]),
            nn.MSECriterion(), device="cpu")
            .set_optim_method(optim.Adam(learningrate=0.01))
            .set_end_when(optim.Trigger.max_iteration(4))
            .set_fuse_steps(fuse))
        RandomGenerator.set_seed(1)
        opt.optimize()
        runs.append((opt.state["loss"], model.table.weight.detach().clone(),
                     [s[0].clone() for s in
                      opt._ostate["embed"]["."].values()]))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))


class _NoHostReads(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a program read a tensor on the host")
        return func(*args, **(kwargs or {}))


def test_sparse_step_program_reads_nothing_on_the_host(monkeypatch):
    """The sparse step (dedup, segment sum, row update) as its program
    runs it: no op reads a tensor back to the host (a capture would
    fail on the card)."""
    from bigdl_tpu_torch.utils import programs
    call = programs.Program.__call__
    keys = []

    def guarded(self):
        keys.append(self.key[0])
        with _NoHostReads():
            return call(self)

    monkeypatch.setattr(programs.Program, "__call__", guarded)
    model = nn.Sequential().add(ShardedEmbedding(nn.LookupTable(
        40, 4, max_norm=1.0)))
    opt = (optim.LocalOptimizer(model, DataSet.array([]),
                                nn.MSECriterion(), device="cpu")
           .set_optim_method(optim.Adam(learningrate=0.01)))
    rng = np.random.default_rng(8)
    for _ in range(2):
        opt.train_step(torch.from_numpy(rng.integers(1, 41, (16, 3))),
                       torch.from_numpy(_x(16, 3, 4, seed=9)))
    assert keys == ["train_step"] * 2
    assert type(opt._method).__name__ == "SparseEmbeddingUpdate"


# ------------------------------------------------------------ checkpoints
def _ncf_samples(n=64, users=30, items=20, seed=0):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, users + 1, n), rng.integers(1, items + 1,
                                                              n)], 1)
    y = rng.integers(0, 2, n)
    return [(a.astype(np.int32), np.int32(b)) for a, b in zip(x, y)]


def _port_ckpt_run(model, samples, path, iters, resume=None):
    data = (DataSet.array([Sample(a, b) for a, b in samples])
            >> SampleToMiniBatch(16))
    opt = (optim.LocalOptimizer(model, data, nn.ClassNLLCriterion(),
                                device="cpu")
           .set_optim_method(optim.Adam(learningrate=0.01))
           .set_end_when(optim.Trigger.max_iteration(iters))
           .set_checkpoint(str(path), optim.Trigger.several_iteration(2)))
    opt.optimize(resume=resume)
    return opt


def test_sparse_checkpoint_has_jax_layout_and_resumes(tmp_path):
    jax_engine.Engine.init(seed=5)
    JaxRNG.set_seed(5)
    jm = JNeuralCF(30, 20, sharded=True)
    init = jax.device_get(jm.get_params())

    def port_model():
        m = NeuralCF(30, 20, sharded=True, device="cpu")
        load_jax_params(m, init)
        return m

    samples = _ncf_samples()
    model = port_model()
    RandomGenerator.set_seed(11)
    _port_ckpt_run(model, samples, tmp_path / "a", 4)
    assert sorted(os.listdir(tmp_path / "a")) == [
        "checkpoint.2.pkl", "checkpoint.4.pkl"]
    with open(tmp_path / "a" / "checkpoint.2.pkl", "rb") as f:
        raw = f.read()
    from bigdl_tpu_torch.utils import file as port_file
    payload = port_file.loads(raw)
    # JAX's slot tree of this model: same paths and shapes
    jopt = joptim.LocalOptimizer(jm, JDataSet.array([]),
                                 jnn.ClassNLLCriterion())
    jopt.set_optim_method(joptim.Adam(learningrate=0.01))
    jmethod = jopt._effective_method()
    assert type(jmethod).__name__ == "SparseEmbeddingUpdate"
    want = jax.eval_shape(lambda p: jmethod.init_state_trimmed(p, None),
                          jm.get_params())
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = jax.tree_util.tree_flatten_with_path(payload["ostate"])[0]
    assert [(jax.tree_util.keystr(p), tuple(a.shape))
            for p, a in want_leaves] == [
        (jax.tree_util.keystr(p), tuple(np.shape(a)))
        for p, a in got_leaves]
    assert sorted(payload["ostate"]) == ["dense", "embed"]
    assert sorted(payload["ostate"]["embed"]) == ["2", "3", "4", "5"]
    # the port resumes checkpoint.2 bitwise
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "checkpoint.2.pkl").write_bytes(raw)
    resumed = port_model()
    _port_ckpt_run(resumed, samples, tmp_path / "b", 4, resume="auto")
    for (n, p), (_, q) in zip(model.named_parameters(),
                              resumed.named_parameters()):
        assert torch.equal(p, q), n
    # JAX continues the port's checkpoint.2 to the same weights
    (tmp_path / "c").mkdir()
    (tmp_path / "c" / "checkpoint.2.pkl").write_bytes(raw)
    jds = (JDataSet.array([JSample(a, b) for a, b in samples])
           >> JSampleToMiniBatch(16))
    JaxRNG.set_seed(5)
    jm2 = JNeuralCF(30, 20, sharded=True)
    jopt2 = (joptim.LocalOptimizer(jm2, jds, jnn.ClassNLLCriterion())
             .set_optim_method(joptim.Adam(learningrate=0.01))
             .set_end_when(joptim.Trigger.max_iteration(4))
             .set_checkpoint(str(tmp_path / "c"),
                             joptim.Trigger.several_iteration(2)))
    jopt2.optimize(resume="auto")
    assert jopt2._sparse_plan() is not None
    want = flatten_tree(jax.device_get(jm2.get_params()))
    for n, p in model.named_parameters():
        assert _rel(p.detach().numpy(), want[n]) <= 1e-5, n


# ------------------------------------------------------ models against JAX
def _jax_steps(jm, crit, method, batches):
    jopt = joptim.LocalOptimizer(jm, JDataSet.array([]), crit)
    jopt.set_optim_method(method)
    params, mstate = jm.get_params(), jm.get_state()
    meth = jopt._effective_method()
    ostate = meth.init_state_trimmed(params, jopt._trainable_mask())
    args = [(jnp.asarray(i, jnp.int32), jax.tree_util.tree_map(jnp.asarray, x),
             jnp.asarray(y)) for i, (x, y) in enumerate(batches)]
    step = jax.jit(jopt._make_step_fn()).lower(
        params, mstate, ostate, *args[0], jax.random.PRNGKey(0)).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    losses = []
    for i, x, y in args:
        params, mstate, ostate, loss = step(params, mstate, ostate, i, x, y,
                                            jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses, params, jopt


def _ncf_batches(n, users, items, raw=False, seed=0):
    rng = np.random.default_rng(seed)
    hi = (2 ** 31 - 1) if raw else None
    out = []
    for _ in range(3):
        if raw:
            x = rng.integers(0, hi, (n, 2))
        else:
            x = np.stack([rng.integers(1, users + 1, n),
                          rng.integers(1, items + 1, n)], 1)
        out.append((x.astype(np.int32), rng.integers(0, 2, n).astype(
            np.int32)))
    return out


@pytest.mark.parametrize("variant", ["sharded", "hashed", "plain"])
def test_ncf_forward_and_three_steps_match_jax(variant):
    kw = {"sharded": dict(sharded=True), "hashed": dict(hash_buckets=64),
          "plain": {}}[variant]
    jax_engine.Engine.init(seed=1)
    JaxRNG.set_seed(6)
    jm = JNeuralCF(40, 30, **kw)
    tm = NeuralCF(40, 30, device="cpu", **kw)
    load_jax_params(tm, jax.device_get(jm.get_params()))
    batches = _ncf_batches(32, 40, 30, raw=variant == "hashed")
    x0 = batches[0][0]
    want = _compiled(lambda p, x: jm.apply(p, jm.get_state(), x)[0],
                     jm.get_params(), jnp.asarray(x0))
    np.testing.assert_allclose(tm(torch.from_numpy(x0)).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)
    jlosses, jparams, jopt = _jax_steps(jm, jnn.ClassNLLCriterion(),
                                        joptim.Adam(learningrate=0.01),
                                        batches)
    topt = (optim.LocalOptimizer(tm, DataSet.array([]),
                                 nn.ClassNLLCriterion(), device="cpu")
            .set_optim_method(optim.Adam(learningrate=0.01)))
    losses = [topt.train_step(torch.from_numpy(x), torch.from_numpy(y))
              for x, y in batches]
    assert (topt._ostate_plan is not None) == (variant == "sharded")
    assert (jopt._sparse_plan() is not None) == (variant == "sharded")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-6)
    flat = flatten_tree(jax.device_get(jparams))
    for n, p in tm.named_parameters():
        assert _rel(p.detach().numpy(), flat[n]) <= 1e-4, n


def test_wide_and_deep_forward_and_three_steps_match_jax():
    jax_engine.Engine.init(seed=1)
    JaxRNG.set_seed(7)
    jm = JWideAndDeep(60, 30, 5)
    tm = WideAndDeep(60, 30, 5, device="cpu")
    load_jax_params(tm, jax.device_get(jm.get_params()))
    rng = np.random.default_rng(2)
    batches = [((_padded_ids(16, 4, 60, 10 + i), _padded_ids(16, 6, 30,
                                                             20 + i),
                 _x(16, 5, seed=30 + i)),
                rng.integers(0, 2, 16).astype(np.int32)) for i in range(3)]
    x0 = batches[0][0]
    want = _compiled(lambda p, x: jm.apply(p, jm.get_state(), x)[0],
                     jm.get_params(), tuple(jnp.asarray(a) for a in x0))
    got = tm(tuple(torch.from_numpy(a) for a in x0))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    jlosses, jparams, _ = _jax_steps(jm, jnn.ClassNLLCriterion(),
                                     joptim.Adam(learningrate=0.01), batches)
    topt = (optim.LocalOptimizer(tm, DataSet.array([]),
                                 nn.ClassNLLCriterion(), device="cpu")
            .set_optim_method(optim.Adam(learningrate=0.01)))
    losses = [topt.train_step(tuple(torch.from_numpy(a) for a in x),
                              torch.from_numpy(y)) for x, y in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-6)
    flat = flatten_tree(jax.device_get(jparams))
    for n, p in tm.named_parameters():
        assert _rel(p.detach().numpy(), flat[n]) <= 1e-4, n


# ------------------------------------------------------------------ mains
def test_data_helpers_draw_as_jax():
    u, i, uc, ic = ncf_main.synthetic_interactions(30, 20, 200)
    ju, ji, juc, jic = jncf_main.synthetic_interactions(30, 20, 200)
    for a, b in ((u, ju), (i, ji), (uc, juc), (ic, jic)):
        np.testing.assert_array_equal(a, b)
    got = ncf_main.build_eval_batches(u[:5], i[:5], 20, 4, batch_groups=2)
    want = jncf_main.build_eval_batches(ju[:5], ji[:5], 20, 4,
                                        batch_groups=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.input, w.input)
        np.testing.assert_array_equal(g.target, w.target)
    s = wd_main.synthetic_tabular(20, 50, 30, 4, 3, 5)
    js = jwd_main.synthetic_tabular(20, 50, 30, 4, 3, 5)
    for a, b in zip(s, js):
        for fa, fb in zip(a.feature + a.label, b.feature + b.label):
            np.testing.assert_array_equal(fa, fb)


@pytest.mark.parametrize("main,jmain", [(ncf_main, jncf_main),
                                        (wd_main, jwd_main)],
                         ids=["ncf", "widedeep"])
def test_mains_have_jax_flags_and_refuse_distributed(main, jmain):
    ours = {a.dest: a.default for a in main.build_parser()._actions}
    for a in jmain.build_parser()._actions:
        if a.dest in ("help", "distributed"):
            continue
        assert ours[a.dest] == a.default, a.dest
    assert ours["device"] == "cuda"
    # --distributed is ported (DistriOptimizer)
    assert not hasattr(main, "UNPORTED_FLAGS")
    assert ours["distributed"] is False


@pytest.mark.parametrize("extra", [["--sharded"], ["--hash-buckets", "4096"]],
                         ids=["sharded", "hashed"])
def test_ncf_main_beats_uniform_on_the_cpu(extra, capsys):
    hr, ndcg = ncf_main.main(["--device", "cpu", "--interactions", "2048",
                              "--max-epoch", "2", "-b", "128"] + extra)
    out = capsys.readouterr().out
    assert "HitRatio@10" in out and "NDCG@10" in out
    assert hr > 10 / 21 and 0 < ndcg <= 1


def test_widedeep_main_beats_the_prior_on_the_cpu(capsys):
    acc = wd_main.main(["--device", "cpu", "--examples", "2048",
                        "--max-epoch", "3"])
    held_out = [int(s.label[0]) for s in wd_main.synthetic_tabular(
        2048, 500, 200, 8, 4, 6)[int(0.9 * 2048):]]
    prior = max(np.mean(held_out), 1 - np.mean(held_out))
    assert acc > prior + 0.05
    assert "Top1Accuracy" in capsys.readouterr().out


# --------------------------------------------------------------- the names
def _defined(path) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.ClassDef, ast.FunctionDef))
            and not n.name.startswith("_")}


A6 = {"embedding_parallel_rules", "model_embedding_rules"}


@pytest.mark.parametrize("rel", [
    "nn/sparse.py", "parallel/embedding.py", "nn/embedding.py",
    "models/ncf/ncf.py", "models/ncf/train.py",
    "models/widedeep/widedeep.py", "models/widedeep/train.py"])
def test_every_public_definition_is_ported(rel):
    want = _defined(os.path.join(ROOT, "bigdl_tpu", rel))
    got = _defined(os.path.join(ROOT, "bigdl_tpu_torch", rel))
    # JAX's BIGDL_CHECK_IDS guard (checkify) is not part of this slice
    missing = want - got - A6 - {"checkify_ids_scope", "check_ids_enabled"}
    assert sorted(missing) == []


def test_exports_follow_jax():
    for name in ("HashBucketEmbedding", "SparseLinear", "SparseEmbeddingSum",
                 "DenseToSparse", "SparseJoinTable", "LookupTableSparse"):
        assert name in nn.__all__ and hasattr(jnn, name)
    # the port's parallel package exports everything JAX's does
    jexports = {n for n in dir(jparallel) if not n.startswith("_")} - {
        "embedding", "moe", "pipeline", "ring_attention", "sharding",
        "tensor_parallel"}
    assert {"ShardedEmbedding", "SparseEmbeddingUpdate", "build_sparse_plan",
            "dedup_ids", "find_sharded_embeddings"} <= jexports
    assert jexports <= set(parallel.__all__), sorted(
        jexports - set(parallel.__all__))
    assert ncf.__all__ == ["NeuralCF"] and widedeep.__all__ == [
        "WideAndDeep"]
