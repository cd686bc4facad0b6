"""The port's elastic checkpoint (``bigdl_tpu_torch/utils/elastic_ckpt.py``)
against JAX's (``bigdl_tpu/utils/elastic_ckpt.py``, ``tests/test_elastic.py``).

- the format: each of JAX's format cases run against the port; the blocks
  eight ranks of a (2, 4) ``data x model`` mesh write, their leaf keys,
  shapes, dtypes and specs, equal to JAX's snapshot of the same tree on
  the conftest's 8 CPU devices; each package assembles the other's
  version bitwise; the manifest names JAX's marker class without the port
  importing JAX;
- the trainer: the async writer's stall and hard barrier, the sync mode,
  the ``ckpt_d2h``/``ckpt_async`` fault sites, the torn manifest, keep-last-N
  beside another writer's version in flight, ``BIGDL_ELASTIC_RESUME=0``, the
  model registry's publication, and local resumes across the packages;
- across meshes (4 gloo ranks spawned once, then 2): JAX's (2, 4) zero1
  version resumed by the port at 4, 2 and 1 ranks, the leaves bitwise and
  the continued losses within 1e-5 of JAX's continued run; the port's
  tensor-parallel (2, 2) version resumed by JAX on 8 and 4 devices and by
  the port on a mesh without ``model``, and the pickle backend's; a
  pipelined (2 stages x data 2) version resumed on one process;
- the host-loss drill: ``host_down`` SIGKILLs rank 1 of 2; rank 0's watcher
  re-executes it at world 1, which resumes from the last complete version
  with its leaves bitwise; a fresh resume from that version gives the same
  losses.

Tolerance: continued losses within 1e-5 relative (fp32, reductions
ordered unlike XLA's); restored leaves bitwise.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

import torch_ranks
from bigdl_tpu_torch import dryrun as tdry
from bigdl_tpu_torch.utils import elastic_ckpt
from bigdl_tpu_torch.utils import file as ckpt_file
from bigdl_tpu_torch.utils.elastic_ckpt import (
    ElasticCheckpointError, PlacedLeaf,
)

RTOL = 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _mesh(shape, axes, rank=0):
    """A stand-in for the port's ``Mesh`` of ``shape`` at ``rank`` (the
    block arithmetic reads only these fields)."""
    return types.SimpleNamespace(
        axis_names=tuple(axes), shape=dict(zip(axes, shape)),
        devices=np.arange(int(np.prod(shape))).reshape(shape), rank=rank)


def _arrays():
    rng = np.random.default_rng(7)
    return {"w": rng.normal(size=(8, 4)).astype(np.float32),
            "rows": rng.normal(size=(16, 6)).astype(np.float32),
            "bias": rng.normal(size=(3,)).astype(np.float32)}


SPECS = {"w": ("model",), "rows": ("data",), "bias": ()}


def _port_tree(arrays, rank):
    """Rank ``rank``'s view of JAX's format-test tree on a (2, 4) mesh."""
    mesh = _mesh((2, 4), ("data", "model"), rank)
    tree = {"step": 7}
    for k, a in arrays.items():
        whole = PlacedLeaf(None, a.shape, SPECS[k], mesh)
        tree[k] = PlacedLeaf(torch.from_numpy(a[whole.index_of(rank)]),
                             a.shape, SPECS[k], mesh)
    return tree


def _jax_tree(arrays):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from bigdl_tpu.utils.engine import Engine
    Engine.init(backend="cpu", seed=1, mesh_shape=(2, 4),
                mesh_axes=("data", "model"))
    mesh = Engine.mesh()
    tree = {k: jax.device_put(a, NamedSharding(mesh, P(*SPECS[k])))
            for k, a in arrays.items()}
    tree["step"] = 7
    return mesh, tree


def _write_port_version(d, arrays, ranks=range(8)):
    os.makedirs(d, exist_ok=True)
    for r in ranks:
        skel, leaves, blocks = elastic_ckpt.snapshot_tree(
            _port_tree(arrays, r), process_index=r)
        elastic_ckpt.write_shard(d, r, blocks)
    return skel, leaves


# ------------------------------------------------------------ the format
def test_snapshot_keys_blocks_and_roundtrip_as_jax(tmp_path):
    from bigdl_tpu.utils import elastic_ckpt as jck
    arrays = _arrays()
    mesh, jtree = _jax_tree(arrays)
    jskel, jleaves, jblocks = jck.snapshot_tree(jtree, process_index=0)
    owned = {}
    for r in range(8):
        skel, leaves, blocks = elastic_ckpt.snapshot_tree(
            _port_tree(arrays, r), process_index=r)
        assert leaves == jleaves                 # keys, shape, dtype, spec
        for k, bl in blocks.items():
            for c, a in bl.items():
                assert c not in owned.setdefault(k, {})
                owned[k][c] = r
                np.testing.assert_array_equal(a, jblocks[k][c])
    assert {k: set(v) for k, v in owned.items()} == \
        {k: set(v) for k, v in jblocks.items()}
    wkey = next(k for k in jleaves if "'w'" in k)
    bkey = next(k for k in jleaves if "'bias'" in k)
    rkey = next(k for k in jleaves if "'rows'" in k)
    # a replicated leaf written once (rank 0), a split one once a slice,
    # each block by the lowest rank holding it
    assert set(owned[bkey].values()) == {0}
    assert sorted(owned[wkey].values()) == [0, 1, 2, 3]
    assert sorted(owned[rkey].values()) == [0, 4]

    d = str(tmp_path / "elastic.3")
    skel, leaves = _write_port_version(d, arrays)
    assert elastic_ckpt.complete_versions(str(tmp_path)) == []
    assert elastic_ckpt.partial_versions(str(tmp_path)) == ["elastic.3"]
    assert elastic_ckpt.commit_manifest(
        d, skel, leaves, elastic_ckpt.mesh_info(_mesh((2, 4), ("data",
                                                              "model"))),
        {"neval": 3}, timeout=5.0)
    assert elastic_ckpt.complete_versions(str(tmp_path)) == [3]
    out, spec_tree, manifest = elastic_ckpt.assemble(d)
    assert out["step"] == 7 and manifest["mesh"]["shape"] == (2, 4)
    for k, a in arrays.items():
        np.testing.assert_array_equal(out[k], a)
    # JAX reads the port's version, and re-places it on its mesh
    jout, jspec, _ = jck.assemble(d)
    for k, a in arrays.items():
        np.testing.assert_array_equal(np.asarray(jout[k]), a)
    placed = jck.place_tree(jout, jspec, mesh)
    assert tuple(placed["w"].sharding.spec) == ("model",)
    # the port re-places on its mesh: rank 5's block of each leaf
    back = elastic_ckpt.place_tree(out, spec_tree,
                                   _mesh((2, 4), ("data", "model"), 5))
    np.testing.assert_array_equal(back["w"].numpy(), arrays["w"][2:4])
    np.testing.assert_array_equal(back["rows"].numpy(), arrays["rows"][8:])
    # and the port reads JAX's version
    jd = str(tmp_path / "jax" / "elastic.9")
    os.makedirs(jd)
    jck.write_shard(jd, 0, jblocks)
    assert jck.commit_manifest(jd, jskel, jleaves, jck.mesh_info(mesh), {},
                               timeout=5.0)
    pout, _, pman = elastic_ckpt.assemble(jd)
    assert pman["mesh"] == {"axes": ("data", "model"), "shape": (2, 4),
                            "process_count": 1}
    for k, a in arrays.items():
        np.testing.assert_array_equal(pout[k], a)


def test_incomplete_coverage_never_commits(tmp_path):
    """A dead rank's blocks missing: the wait times out without a
    manifest, and a manifest naming too few shards is refused on load."""
    arrays = _arrays()
    d = str(tmp_path / "elastic.1")
    skel, leaves = _write_port_version(d, arrays, ranks=(0, 1))
    assert not elastic_ckpt.commit_manifest(d, skel, leaves, None, {},
                                            timeout=0.3)
    assert not os.path.exists(os.path.join(d, elastic_ckpt.MANIFEST))
    ckpt_file.save({"format": 1, "skeleton": skel, "leaves": leaves,
                    "mesh": None, "meta": {},
                    "shards": ["shard-0.data", "shard-1.data"]},
                   os.path.join(d, elastic_ckpt.MANIFEST))
    with pytest.raises(ElasticCheckpointError):
        elastic_ckpt.assemble(d)


def test_quarantine_and_listing(tmp_path):
    d = tmp_path / "elastic.5"
    d.mkdir()
    (d / "shard-0.data").write_bytes(b"torn")
    target = elastic_ckpt.quarantine(str(tmp_path), "elastic.5")
    assert target.endswith("elastic.5.corrupt")
    assert elastic_ckpt.list_versions(str(tmp_path)) == {}


def test_adapt_spec_degrades_to_replication():
    from bigdl_tpu_torch.parallel.sharding import P, adapt_spec
    mesh = _mesh((4,), ("data",))
    assert adapt_spec(("model", None), mesh, (8, 4)) == P()
    assert adapt_spec(("data",), mesh, (16,)) == P("data")
    assert adapt_spec(("data",), mesh, (6,)) == P()
    # a TP leaf of a (2, 4) save placed whole on a data-only mesh
    w = np.arange(32, dtype=np.float32).reshape(8, 4)
    out = elastic_ckpt.place_tree({"w": w}, {"w": elastic_ckpt._SpecLeaf(
        ("model",))}, _mesh((4,), ("data",), 3))
    np.testing.assert_array_equal(out["w"].numpy(), w)


def test_agree_version_two_writers_race(tmp_path):
    for v in (3, 5):
        d = tmp_path / f"elastic.{v}"
        d.mkdir()
        (d / elastic_ckpt.MANIFEST).write_bytes(b"x")
    (tmp_path / "elastic.7").mkdir()       # in flight: no manifest
    out = {}

    def run(pid):
        out[pid] = elastic_ckpt.agree_version(str(tmp_path), pid, 2,
                                              timeout=10.0)

    ts = [threading.Thread(target=run, args=(p,)) for p in (0, 1)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert out == {0: 5, 1: 5}
    assert not [n for n in os.listdir(tmp_path)
                if n.startswith("resume-claim.")]
    # a quorum that never forms times out to the local view
    assert elastic_ckpt.agree_version(str(tmp_path), 0, 2,
                                      timeout=0.3) == 5


def test_a_save_and_load_import_neither_jax_nor_its_package(tmp_path):
    """In a fresh process the port writes and reads a version whose
    manifest names JAX's marker class; neither ``jax`` nor ``bigdl_tpu``
    is imported."""
    code = f"""
import sys, torch
sys.path.insert(0, {REPO!r})
from bigdl_tpu_torch.utils import elastic_ckpt
d = {str(tmp_path / "elastic.1")!r}
import os; os.makedirs(d)
skel, leaves, blocks = elastic_ckpt.snapshot_tree(
    {{"a": torch.arange(4.0), "n": 3}})
elastic_ckpt.write_shard(d, 0, blocks)
assert elastic_ckpt.commit_manifest(d, skel, leaves, None, {{}}, timeout=5)
tree, _, _ = elastic_ckpt.assemble(d)
assert tree["a"].tolist() == [0, 1, 2, 3] and tree["n"] == 3
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bigdl_tpu")))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"
    raw = open(tmp_path / "elastic.1" / elastic_ckpt.MANIFEST, "rb").read()
    assert b"bigdl_tpu.utils.elastic_ckpt\n_LeafRef\n" in raw


def test_no_port_file_imports_jax_or_its_package():
    import ast
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "bigdl_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(open(f).read())):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    and node.level == 0 else [])
            bad += [(f, m) for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "bigdl_tpu")]
    assert bad == []


# ------------------------------------------------------------ the trainer
def _local_opt(ck, every=1, n_iter=3, pkg="torch"):
    """JAX's ``_local_opt`` in either package."""
    rng = np.random.default_rng(0)
    xs = [(rng.normal(size=(8,)).astype(np.float32),
           np.int32(rng.integers(0, 3))) for _ in range(64)]
    if pkg == "jax":
        from bigdl_tpu import nn
        from bigdl_tpu.dataset import DataSet
        from bigdl_tpu.dataset.sample import Sample, SampleToMiniBatch
        from bigdl_tpu.optim import LocalOptimizer, SGD, Trigger
        from bigdl_tpu.utils.random_generator import RandomGenerator
        kw = {}
    else:
        from bigdl_tpu_torch import nn
        from bigdl_tpu_torch.dataset import DataSet
        from bigdl_tpu_torch.dataset.sample import Sample, SampleToMiniBatch
        from bigdl_tpu_torch.optim import LocalOptimizer, SGD, Trigger
        from bigdl_tpu_torch.utils.random_generator import RandomGenerator
        kw = {"device": "cpu"}
    RandomGenerator.set_seed(3)
    torch.manual_seed(3)               # the port's initial weights
    data = DataSet.array([Sample(x, y) for x, y in xs]) \
        >> SampleToMiniBatch(16)
    model = nn.Sequential().add(nn.Linear(8, 3)).add(nn.LogSoftMax())
    opt = (LocalOptimizer(model, data, nn.ClassNLLCriterion(), **kw)
           .set_optim_method(SGD(learningrate=0.1, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_iteration(n_iter)))
    if ck is not None:
        opt.set_checkpoint(str(ck), Trigger.several_iteration(every),
                           backend="elastic")
    return opt


def _jax_losses(opt, resume=None) -> list:
    """Run JAX's optimizer, recording every iteration's loss."""
    from bigdl_tpu.optim.optimizer import Optimizer
    seen, guard = [], Optimizer._guard_loss

    def record(self, it, v):
        seen.append(float(v))
        return guard(self, it, v)

    Optimizer._guard_loss = record
    try:
        opt.optimize(resume=resume)
        opt._join_checkpoint_writer()
    finally:
        Optimizer._guard_loss = guard
    return seen


@pytest.fixture
def registry():
    from bigdl_tpu_torch.obs.registry import registry as reg
    reg.reset()
    yield reg
    reg.reset()


def test_async_overlap_and_hard_barrier(tmp_path, monkeypatch, registry):
    """``ckpt_async@1=stall``: save 1's stall is the snapshot only, save 2
    waits the writer out at the hard barrier."""
    from bigdl_tpu_torch.utils import faults
    monkeypatch.setenv("BIGDL_FAULT_STALL_S", "0.5")
    opt = _local_opt(tmp_path / "ck", every=1, n_iter=3)
    with faults.inject_faults("ckpt_async@1=stall") as plan:
        opt.optimize()
        opt._join_checkpoint_writer()
    assert plan.unfired() == []
    hist = registry.snapshot()["histograms"]
    stall = hist["ckpt/stall_ms"]
    assert stall["count"] == 3
    assert stall["min"] < 200 and stall["max"] >= 200
    assert hist["ckpt/async_write_ms"]["count"] == 3
    assert registry.snapshot()["counters"]["ckpt/bytes"] > 0
    assert elastic_ckpt.complete_versions(str(tmp_path / "ck")) == [1, 2, 3]


def test_sync_mode_blocks_the_loop(tmp_path, monkeypatch, registry):
    from bigdl_tpu_torch.utils import faults
    monkeypatch.setenv("BIGDL_FAULT_STALL_S", "0.3")
    monkeypatch.setenv("BIGDL_CKPT_ASYNC", "0")
    opt = _local_opt(tmp_path / "ck", every=1, n_iter=2)
    with faults.inject_faults("ckpt_async@1=stall") as plan:
        opt.optimize()
    assert plan.unfired() == []
    assert registry.snapshot()["histograms"]["ckpt/stall_ms"]["max"] >= 300


def test_d2h_fault_surfaces_without_a_recovery_point(tmp_path, monkeypatch):
    from bigdl_tpu_torch.utils import faults
    monkeypatch.setenv("BIGDL_FAILURE_RETRY_INTERVAL", "0")
    opt = _local_opt(tmp_path / "ck", every=2, n_iter=4)
    with faults.inject_faults("ckpt_d2h@1=error") as plan:
        with pytest.raises(faults.FaultError):
            opt.optimize()
    assert plan.unfired() == []


def test_torn_manifest_is_all_or_nothing(tmp_path):
    """``ckpt_async@2=torn``: version 4's shards land, its manifest never
    does; the loader quarantines it and resumes after iteration 2."""
    from bigdl_tpu_torch.utils import faults
    from bigdl_tpu_torch.utils.robustness import events
    ck = str(tmp_path / "ck")
    opt = _local_opt(ck, every=2, n_iter=4)
    with faults.inject_faults("ckpt_async@2=torn") as plan:
        opt.optimize()
        opt._join_checkpoint_writer()
    assert plan.unfired() == []
    assert elastic_ckpt.complete_versions(ck) == [2]
    assert elastic_ckpt.partial_versions(ck) == ["elastic.4"]
    snap = events.snapshot()
    new = _local_opt(ck, every=100, n_iter=4)
    new._load_latest_checkpoint()
    assert events.deltas(snap).get("ckpt_fallback", 0) >= 1
    assert new.state["neval"] == 3
    assert elastic_ckpt.partial_versions(ck) == []
    assert any(n.startswith("elastic.4.corrupt") for n in os.listdir(ck))


def test_keep_last_n_skips_versions_in_flight(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_CKPT_KEEP", "1")
    ck = tmp_path / "ck"
    inflight = ck / "elastic.99"
    inflight.mkdir(parents=True)
    (inflight / "shard-1.data").write_bytes(b"in-flight peer write")
    opt = _local_opt(ck, every=2, n_iter=4)
    opt.optimize()
    opt._join_checkpoint_writer()
    assert elastic_ckpt.complete_versions(str(ck)) == [4]
    assert (inflight / "shard-1.data").exists()


def test_the_new_fault_sites_parse_as_jax():
    from bigdl_tpu.utils import faults as jfaults
    from bigdl_tpu_torch.utils import faults
    for site in ("ckpt_d2h", "ckpt_async", "stall", "host_down"):
        assert faults._DEFAULT_ACTION[site] == jfaults._DEFAULT_ACTION[site]
        assert (site in faults._INDEX_MATCHED) == \
            (site in jfaults._INDEX_MATCHED)
    for site in ("obs_spool_write", "profilez_capture"):
        with pytest.raises(ValueError, match="A.6, item 4"):
            faults.parse_plan(f"{site}@1")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_local_resume_across_packages(tmp_path, writer):
    """One package writes versions 2 and 4 (JAX on its 8-device default
    mesh), the other resumes to 8; the continued losses equal the writer's
    uninterrupted run within 1e-5."""
    from bigdl_tpu.utils.engine import Engine as JEngine
    JEngine.init(seed=3)
    reader = "torch" if writer == "jax" else "jax"
    ck = tmp_path / "ck"
    opt = _local_opt(ck, every=2, n_iter=4, pkg=writer)
    if writer == "jax":
        _jax_losses(opt)
        ref = _jax_losses(_local_opt(None, n_iter=8, pkg="jax"))
    else:
        opt.optimize()
        opt._join_checkpoint_writer()
        ref = torch_ranks.record_losses(
            ref_opt := _local_opt(None, n_iter=8))
        ref_opt.optimize()
    assert elastic_ckpt.complete_versions(str(ck)) == [2, 4]
    new = _local_opt(ck, every=100, n_iter=8, pkg=reader)
    if reader == "jax":
        got = _jax_losses(new, resume="auto")
    else:
        got = torch_ranks.record_losses(new)
        new.optimize(resume="auto")
    assert len(got) == 4
    np.testing.assert_allclose(got, ref[4:], rtol=RTOL, atol=1e-7)


def test_topology_change_is_an_error_when_disabled(tmp_path, monkeypatch):
    from bigdl_tpu.utils.engine import Engine as JEngine
    JEngine.init(seed=3)
    ck = tmp_path / "ck"
    _jax_losses(_local_opt(ck, every=2, n_iter=2, pkg="jax"))
    monkeypatch.setenv("BIGDL_ELASTIC_RESUME", "0")
    new = _local_opt(ck, every=100, n_iter=4)
    with pytest.raises(RuntimeError, match="topology"):
        new._load_latest_checkpoint()


def test_the_trainer_publishes_elastic_versions(tmp_path):
    from bigdl_tpu_torch.utils.model_registry import ModelRegistry
    reg = ModelRegistry(str(tmp_path / "reg"), keep=10)
    opt = _local_opt(tmp_path / "ck", every=2, n_iter=4)
    opt.set_model_registry(reg)
    opt.optimize()
    opt._join_checkpoint_writer()
    assert reg.versions() == [2, 4]
    assert reg.status(4)["status"] == "candidate"
    tree = reg.resolve_params(4)
    np.testing.assert_array_equal(
        tree["0"]["weight"], opt.model[0].weight.detach().numpy())
    # already registered: nothing new
    assert reg.register_from_elastic(str(tmp_path / "ck"), 4) is None


def test_engine_reset_keeps_the_group_and_a_new_world_fails_loudly():
    """JAX's latch test against the port's Engine: ``reset`` keeps the
    live process group, so a re-init asking for another world raises
    naming ``shutdown_distributed``; after it, the new world comes up."""
    from bigdl_tpu_torch.utils.engine import Engine
    Engine.reset()
    try:
        Engine.init(backend="cpu")
        assert torch.distributed.is_initialized()
        Engine.reset()
        assert torch.distributed.is_initialized()
        with pytest.raises(RuntimeError, match="shutdown_distributed"):
            Engine.init(backend="cpu", coordinator_address="localhost:1",
                        node_number=2, process_id=0)
        Engine.shutdown_distributed(timeout=10)
        assert not torch.distributed.is_initialized()
        Engine.init(backend="cpu")
        assert Engine.mesh().size == 1
    finally:
        Engine.shutdown_distributed(timeout=10)
        Engine.reset()


# ------------------------------------------------------- across meshes
def _samples():
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(8,)).astype(np.float32),
             np.int32(rng.integers(0, 3))) for _ in range(64)]


def _jax_zero1(ck, n_iter, every, shape=(2, 4), axes=("data", "model"),
               tp=False):
    """JAX's ``_zero1_opt`` on a mesh of the conftest's devices (with the
    port's tensor-parallel rules when ``tp``)."""
    from bigdl_tpu import nn
    from bigdl_tpu.dataset import DataSet
    from bigdl_tpu.dataset.sample import Sample, SampleToMiniBatch
    from bigdl_tpu.optim import SGD, Trigger
    from bigdl_tpu.optim.distri_optimizer import DistriOptimizer
    from bigdl_tpu.utils.engine import Engine
    from bigdl_tpu.utils.random_generator import RandomGenerator
    Engine.reset()
    Engine.init(backend="cpu", seed=5, core_number=int(np.prod(shape)),
                mesh_shape=shape, mesh_axes=axes)
    RandomGenerator.set_seed(5)
    data = DataSet.array([Sample(x, y) for x, y in _samples()],
                         distributed=True) >> SampleToMiniBatch(16)
    model = nn.Sequential().add(nn.Linear(8, 16)).add(nn.ReLU()) \
        .add(nn.Linear(16, 3)).add(nn.LogSoftMax())
    opt = (DistriOptimizer(model, data, nn.ClassNLLCriterion(),
                           parameter_sync="zero1")
           .set_optim_method(SGD(learningrate=0.1, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_iteration(n_iter)))
    if tp:
        from bigdl_tpu.parallel import megatron_mlp_rules
        opt.set_tensor_parallel(megatron_mlp_rules("0", "2"))
    opt.set_checkpoint(str(ck), Trigger.several_iteration(every),
                       backend="elastic")
    return opt


def _pp_leg():
    from test_torch_distributed import _flat_tree, jax_model
    return _flat_tree(jax_model("pp", 2).get_params()), \
        tdry.leg_samples("pp", 4)


def _flat_params(tree) -> dict:
    from bigdl_tpu_torch import convert
    return {k.replace("/", "."): np.asarray(v)
            for k, v in convert.flatten_tree(tree).items()}


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    jck = tmp / "jax"
    jopt = _jax_zero1(jck, 4, 2)
    _jax_losses(jopt)
    jsaved, _, _ = elastic_ckpt.assemble(str(jck / "elastic.4"))
    copies = {}
    for w in (4, 2, 1):
        copies[w] = str(tmp / f"jax-at-{w}")
        shutil.copytree(jck, copies[w])
    # JAX's continued run from its own version 4, same topology
    jref = _jax_losses(_jax_zero1(jck, 8, 100), resume="auto")
    pp_init, pp_samples = _pp_leg()
    spec = {"samples": _samples(), "jax_ck": copies,
            "tp_ck": str(tmp / "tp"), "tp_pickle": str(tmp / "tp-pickle"),
            "pp_ck": str(tmp / "pp"), "pp_pickle": str(tmp / "pp-pickle"),
            "pp_init": pp_init, "pp_samples": pp_samples}
    four = tdry.spawn(torch_ranks.elastic_file, 4, (spec,), backend="cpu",
                      timeout=300, workdir=str(tmp))
    two = tdry.spawn(torch_ranks.elastic_two, 2, (spec,), backend="cpu",
                     timeout=300, workdir=str(tmp))
    return {"spec": spec, "four": four, "two": two, "jref": jref,
            "jsaved": _flat_params(jsaved["params"]), "tmp": tmp}


def _local_resume(ck, n_iter, model=None, samples=None, backend="elastic",
                  batch=16, crit=None):
    """The port's LocalOptimizer resuming ``ck`` (world 1)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.dataset.sample import Sample, SampleToMiniBatch
    from bigdl_tpu_torch.optim import LocalOptimizer, SGD, Trigger
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator
    RandomGenerator.set_seed(5)
    data = DataSet.array([Sample(x, y) for x, y in samples or _samples()]) \
        >> SampleToMiniBatch(batch)
    model = model if model is not None else torch_ranks.mlp()
    opt = (LocalOptimizer(model, data, crit or nn.ClassNLLCriterion(),
                          device="cpu")
           .set_optim_method(SGD(learningrate=0.1, momentum=0.9,
                                 dampening=0.0))
           .set_end_when(Trigger.max_iteration(n_iter)))
    opt.set_checkpoint(ck, Trigger.several_iteration(100), backend=backend)
    opt._load_latest_checkpoint()
    restored = {n: p.detach().numpy().copy()
                for n, p in model.named_parameters()}
    losses = torch_ranks.record_losses(opt)
    opt.optimize(resume="auto")
    return {"restored": restored, "losses": losses}


@pytest.mark.parametrize("world", [4, 2, 1])
def test_jax_zero1_version_resumes_in_the_port(meshes, world):
    """JAX's (2, 4) ``data x model`` zero1 version 4: the port at 4, 2 and
    1 ranks restores the leaves bitwise and continues JAX's losses."""
    if world == 4:
        got = [r["jax_at_4"] for r in meshes["four"]]
    elif world == 2:
        got = [r["jax_at_2"] for r in meshes["two"]]
    else:
        got = [_local_resume(meshes["spec"]["jax_ck"][1], 8)]
    for r in got:
        for n, a in meshes["jsaved"].items():
            np.testing.assert_array_equal(r["restored"][n], a)
        assert len(r["losses"]) == 4
        np.testing.assert_allclose(r["losses"], meshes["jref"],
                                   rtol=RTOL, atol=1e-7)
        if world > 1:
            assert r["events"].get("elastic_resume", 0) >= 1


@pytest.mark.parametrize("devices", [8, 4])
def test_port_tensor_parallel_version_resumes_in_jax(meshes, devices):
    """The port's (2, 2) tensor-parallel zero1 version 4 (4 ranks), read
    by JAX on 8 and 4 devices ((4, 2) and (2, 2) ``data x model`` meshes
    with the same rules: JAX's own step takes a restored leaf only in its
    own sharding of it): the leaves are the port's trained ones and the
    continued losses the port's uninterrupted run's within 1e-5."""
    tmp = meshes["tmp"]
    ck = tmp / f"tp-in-jax-{devices}"
    shutil.copytree(meshes["spec"]["tp_ck"], ck)
    assert elastic_ckpt.complete_versions(str(ck)) == [2, 4]
    tree, _, man = elastic_ckpt.assemble(str(ck / "elastic.4"))
    assert man["mesh"]["shape"] == (2, 2)
    specs = {k.split("]", 1)[1]: v["spec"]
             for k, v in man["leaves"].items() if "params" in k}
    assert specs["['0']['weight']"] == ("model",)
    assert specs["['2']['weight']"] == (None, "model")
    saved = _flat_params(tree["params"])
    for n, a in meshes["four"][0]["tp_params"].items():
        np.testing.assert_array_equal(saved[n], a)
    jopt = _jax_zero1(ck, 8, 100, shape=(devices // 2, 2), tp=True)
    got = _jax_losses(jopt, resume="auto")
    np.testing.assert_allclose(got, meshes["four"][0]["tp_ref"][4:],
                               rtol=RTOL, atol=1e-7)


def test_tensor_parallel_versions_resume_on_other_meshes(meshes):
    """The TP version on 4 data-parallel ranks (no ``model`` axis: its
    split leaves replicate) and the pickle backend's TP file on one
    process: leaves bitwise, losses the TP run's."""
    ref = meshes["four"][0]["tp_ref"][4:]
    want = meshes["four"][0]["tp_params"]
    for r in meshes["four"]:
        got = r["tp_at_4"]
        for n, a in want.items():
            np.testing.assert_array_equal(got["restored"][n], a)
        np.testing.assert_allclose(got["losses"], ref, rtol=RTOL, atol=1e-7)
        assert got["events"].get("elastic_resume", 0) >= 1
    local = _local_resume(meshes["spec"]["tp_pickle"], 8, backend="pickle")
    for n, a in want.items():
        np.testing.assert_array_equal(local["restored"][n], a)
    np.testing.assert_allclose(local["losses"], ref, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("backend", ["elastic", "pickle"])
def test_pipelined_version_resumes_on_one_process(meshes, backend):
    """A 2-stage GPipe on (data 2, pipe 2) checkpointed at iteration 2,
    each stage's leaves from the ranks that run it; one process resumes
    and continues the pipelined run's losses."""
    from bigdl_tpu_torch import convert, nn
    from bigdl_tpu_torch.dryrun import leg_model
    spec = meshes["spec"]
    m = leg_model("pp", 2)
    convert.load_jax_params(m, spec["pp_init"])
    ck = spec["pp_ck"] if backend == "elastic" else spec["pp_pickle"]
    got = _local_resume(ck, 4, model=m, samples=spec["pp_samples"],
                        backend=backend, batch=8,
                        crit=nn.TimeDistributedCriterion(
                            nn.ClassNLLCriterion(), size_average=True))
    np.testing.assert_allclose(got["losses"],
                               meshes["four"][0]["pp_ref"][2:],
                               rtol=RTOL, atol=1e-7)


# ------------------------------------------------------ the host-loss drill
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_host_loss_drill(tmp_path):
    """``host_down@3`` SIGKILLs rank 1 of a 2-rank zero1 run with elastic
    saves every 2 iterations; rank 0's watcher re-executes it at world 1,
    which resumes from version 2 with its leaves bitwise and trains to
    iteration 8; a fresh world-1 resume from that version gives the same
    losses."""
    worker = os.path.join(HERE, "torch_ranks.py")
    port, ck = _free_port(), str(tmp_path / "shared-ck")
    env = dict(os.environ, PYTHONPATH=REPO, BIGDL_DRILL_DIR=ck,
               BIGDL_CKPT_SYNC_TIMEOUT="5", BIGDL_CKPT_ASYNC="0",
               BIGDL_INIT_TIMEOUT="30", BIGDL_FAILURE_RETRY_TIMES="0",
               BIGDL_FAILURE_RETRY_INTERVAL="0")
    out0, out1 = str(tmp_path / "r0.json"), str(tmp_path / "r1.json")
    p1 = subprocess.Popen([sys.executable, worker, str(port), "1", out1],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, env=dict(env,
                                              BIGDL_FAULT_PLAN="host_down@3"))
    p0 = subprocess.Popen([sys.executable, worker, str(port), "0", out0],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, env=dict(env,
                                              BIGDL_DRILL_PEER=str(p1.pid)))
    try:
        s1, _ = p1.communicate(timeout=120)
        s0, _ = p0.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        p0.kill()
        p1.kill()
        pytest.fail("host-loss drill timed out")
    assert p1.returncode == -9, f"rank 1 survived:\n{s1[-3000:]}"
    assert not os.path.exists(out1)
    assert p0.returncode == 0, f"the survivor failed:\n{s0[-3000:]}"
    res = json.load(open(out0))
    assert res["mode"] == "drill_resume" and res["world"] == 1
    assert res["bitwise_equal"] is True
    assert res["elastic_resume_events"] >= 1
    assert res["neval"] >= 8
    version = res["versions_seen"][-1]
    assert res["resumed_from"] > version >= 2
    # a fresh resume from that version
    ck2 = str(tmp_path / "replay-ck")
    shutil.copytree(ck, ck2)
    for name in os.listdir(ck2):
        v = elastic_ckpt.version_of(name)
        if v is None or v > version:
            shutil.rmtree(os.path.join(ck2, name), ignore_errors=True)
    from bigdl_tpu_torch.utils.engine import Engine
    threads = torch.get_num_threads()
    torch.set_num_threads(1)           # the survivor's, for bitwise sums
    Engine.reset()
    Engine.init(backend="cpu")
    try:
        opt = torch_ranks.elastic_opt(torch_ranks._drill_samples(), ck2,
                                      n_iter=8, every=100)
        opt._load_latest_checkpoint()
        replay = {"resumed_from": int(opt.state["neval"]),
                  "losses": torch_ranks.record_losses(opt)}
        opt.optimize(resume="auto")
    finally:
        Engine.shutdown_distributed(timeout=10)
        Engine.reset()
        torch.set_num_threads(threads)
    assert replay["resumed_from"] == res["resumed_from"]
    assert replay["losses"] == res["losses"]
