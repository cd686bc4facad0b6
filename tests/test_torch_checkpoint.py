"""The port's checkpoints against the JAX package's, on the CPU.

- The file format: a file of ``bigdl_tpu_torch.utils.file.dumps`` loads
  with ``bigdl_tpu.utils.file.loads`` and the reverse; a torn or bit-flipped
  file raises ``CheckpointCorruptError`` in both; a payload naming a JAX module raises
  ``ForeignObjectError`` in the port without importing it.
- Cross-package resume: JAX trains a ``TransformerLM(64, 32, 4, 2)`` for
  8 iterations, checkpointing every 3; the port resumes JAX's
  ``checkpoint.6.pkl`` with ``resume="auto"`` and runs iterations 7 and 8.
  Its losses (read back from its ``TrainSummary``) and final parameters are
  within 1e-5 relative of JAX's uninterrupted run. Then the reverse: JAX
  resumes the port's ``checkpoint.6.pkl``. SGD with momentum and Adam (its
  bias corrections continue from step 7). Dropout 0: the JAX run's PRNG key
  has no torch counterpart and is not carried.
- The slot layouts: SGD with a Plateau schedule (``clr``), a composite
  method, frozen parameters and the flat update round-trip through JAX's
  ``ostate`` layout bitwise.
- The trainer's files: numeric version order, keep-last-N,
  ``over_write_checkpoint``, quarantine of a torn newest file with
  fallback, ``resume="auto"`` on an empty directory, every file of a
  checkpoint-every-iteration run finite; the unported backends raise.
  These mirror ``tests/test_faults.py``'s checkpoint cases.
"""

import os

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.models.transformerlm import lm_criterion as jax_lm_criterion
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils import file as jax_file
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.visualization import TrainSummary as JTrainSummary
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.convert import (
    flatten_tree, load_jax_ostate, load_jax_params, ostate_host_layout,
    ostate_tree,
)
from bigdl_tpu_torch.dataset import (
    DataSet, Sample, SampleToMiniBatch, ptb_windows, synthetic_ptb,
)
from bigdl_tpu_torch.models.transformerlm import TransformerLM, lm_criterion
from bigdl_tpu_torch.optim.optimizer import _ckpt_version
from bigdl_tpu_torch.utils import engine as torch_engine
from bigdl_tpu_torch.utils import file as port_file
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from bigdl_tpu_torch.utils.robustness import events
from bigdl_tpu_torch.visualization import TrainSummary

VOCAB, E, HEADS, LAYERS, T, BATCH = 64, 32, 4, 2, 16, 4
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reset():
    yield
    jax_engine.Engine.reset()
    torch_engine.Engine.reset()


# ------------------------------------------------------------ file format
def test_files_load_across_packages(tmp_path):
    obj = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
           "state": {"neval": 7, "loss": 1.5}, "none": None}
    for dump, load in ((port_file.dumps, jax_file.loads),
                       (jax_file.dumps, port_file.loads)):
        back = load(dump(obj))
        np.testing.assert_array_equal(back["a"], obj["a"])
        assert back["state"] == obj["state"] and back["none"] is None
    assert port_file.dumps(obj) == jax_file.dumps(obj)
    path = str(tmp_path / "x.pkl")
    port_file.save(obj, path)
    assert jax_file.load(path)["state"] == obj["state"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_torn_file_raises_in_both(writer, tmp_path):
    data = (port_file if writer == "port" else jax_file).dumps(
        {"a": np.ones(100, np.float32)})
    mid = len(data) // 2
    flipped = data[:mid] + bytes([data[mid] ^ 1]) + data[mid + 1:]
    for bad in (data[:mid], flipped):
        for mod in (port_file, jax_file):
            with pytest.raises(mod.CheckpointCorruptError):
                mod.loads(bad, "torn.pkl")


def test_foreign_object_is_named_not_imported():
    payload = jax_file.dumps({"key": JaxRNG})   # a class of bigdl_tpu
    with pytest.raises(port_file.ForeignObjectError,
                       match="bigdl_tpu.utils.random_generator"):
        port_file.loads(payload)


# ------------------------------------------------------ cross-package resume
def _pairs(n_windows):
    ids = synthetic_ptb(n_windows * T + 1, vocab_size=VOCAB)
    return list(zip(*ptb_windows(ids, T)))


def _jax_run(jlm, pairs, method, ckpt, summary_dir, resume=None):
    jds = (JDataSet.array(JSample(x, y) for x, y in pairs)
           >> JSampleToMiniBatch(BATCH))
    opt = (joptim.LocalOptimizer(jlm, jds, jax_lm_criterion())
           .set_optim_method(method)
           .set_end_when(joptim.Trigger.max_iteration(8))
           .set_checkpoint(str(ckpt), joptim.Trigger.several_iteration(3))
           .set_train_summary(JTrainSummary(str(summary_dir), "jax")))
    opt.optimize(resume=resume)
    return opt


def _port_run(tlm, pairs, method, ckpt, summary_dir, resume=None):
    tds = (DataSet.array(Sample(x, y) for x, y in pairs)
           >> SampleToMiniBatch(BATCH))
    opt = (toptim.LocalOptimizer(tlm, tds, lm_criterion(), device="cpu")
           .set_optim_method(method)
           .set_end_when(toptim.Trigger.max_iteration(8))
           .set_checkpoint(str(ckpt), toptim.Trigger.several_iteration(3))
           .set_train_summary(TrainSummary(str(summary_dir), "port")))
    opt.optimize(resume=resume)
    return opt


def _losses(summary) -> dict:
    return {step: v for step, v, _ in summary.read_scalar("Loss")}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close_params(tlm, jax_params, adam_lr=None):
    """Every parameter within RTOL (relative Frobenius). Under Adam the
    key third of each ``qkv_bias`` is held apart: the softmax does not
    depend on it, so its gradient is 0 up to rounding, which Adam scales
    to steps of up to its rate, different in each package; there the bound
    is the two steps' rate."""
    flat = flatten_tree(jax.device_get(jax_params))
    for name, p in tlm.named_parameters():
        got, want = p.detach().numpy(), np.asarray(flat[name])
        if adam_lr is not None and name.endswith("qkv_bias"):
            key = slice(E, 2 * E)
            assert np.abs(got[key] - want[key]).max() <= 2 * adam_lr, name
            got, want = np.delete(got, key), np.delete(want, key)
        assert _rel(got, want) <= RTOL, name


METHODS = {
    "sgd_momentum": lambda pkg: pkg.SGD(learningrate=0.1, momentum=0.9,
                                        dampening=0.0),
    "adam": lambda pkg: pkg.Adam(learningrate=0.01),
}


@pytest.mark.parametrize("method", sorted(METHODS))
def test_port_resumes_jax_checkpoint_and_jax_resumes_ports(method, tmp_path):
    pairs = _pairs(4 * BATCH)      # 4 batches an epoch: 6 is mid-epoch 2
    jax_engine.Engine.init(seed=5)
    JaxRNG.set_seed(5)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS,
                           num_layers=LAYERS, max_len=T)
    init = jax.device_get(jlm.get_params())

    def port_lm():
        tlm = TransformerLM(VOCAB, E, HEADS, LAYERS, T, device="cpu")
        load_jax_params(tlm, init)
        return tlm

    # JAX uninterrupted, checkpoints at 3 and 6
    JaxRNG.set_seed(21)
    jopt = _jax_run(jlm, pairs, METHODS[method](joptim), tmp_path / "jck",
                    tmp_path / "js")
    jax_losses = _losses(jopt.train_summary)
    assert sorted(os.listdir(tmp_path / "jck")) == [
        "checkpoint.3.pkl", "checkpoint.6.pkl"]
    # the port continues JAX's checkpoint.6 (the newest)
    tlm = port_lm()
    topt = _port_run(tlm, pairs, METHODS[method](toptim), tmp_path / "jck",
                     tmp_path / "ts", resume="auto")
    assert topt.state["neval"] == 9
    got = _losses(topt.train_summary)
    assert sorted(got) == [7, 8]
    for it in (7, 8):
        assert got[it] == pytest.approx(jax_losses[it], rel=RTOL)
    lr = 0.01 if method == "adam" else None
    _close_params(tlm, jlm.get_params(), lr)

    # the port uninterrupted, then JAX continues the port's checkpoint.6
    tlm = port_lm()
    RandomGenerator.set_seed(21)
    topt = _port_run(tlm, pairs, METHODS[method](toptim), tmp_path / "tck",
                     tmp_path / "ts2")
    port_losses = _losses(topt.train_summary)
    assert sorted(port_losses) == list(range(1, 9))
    for it in range(1, 9):
        assert port_losses[it] == pytest.approx(jax_losses[it], rel=1e-4)
    JaxRNG.set_seed(5)
    jlm2 = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS,
                            num_layers=LAYERS, max_len=T)
    jopt2 = _jax_run(jlm2, pairs, METHODS[method](joptim), tmp_path / "tck",
                     tmp_path / "js2", resume="auto")
    assert jopt2.state["neval"] >= 8
    got = _losses(jopt2.train_summary)
    assert sorted(got) == [7, 8]
    for it in (7, 8):
        assert got[it] == pytest.approx(port_losses[it], rel=RTOL)
    _close_params(tlm, jlm2.get_params(), lr)


# ------------------------------------------------------------ slot layouts
def _small(frozen=False):
    m = (tnn.Sequential().add(tnn.Linear(4, 5)).add(tnn.ReLU())
         .add(tnn.Linear(5, 3)).add(tnn.LogSoftMax()))
    if frozen:
        m[0].freeze()
    return m


def _data(n=16, seed=0):
    r = np.random.default_rng(seed)
    return (DataSet.array(Sample(r.normal(size=4).astype(np.float32),
                                 np.int32(r.integers(0, 3)))
                          for _ in range(n)) >> SampleToMiniBatch(4))


@pytest.mark.parametrize("case", ["plateau", "composite", "frozen", "flat"])
def test_slots_round_trip_through_the_jax_layout(case):
    torch.manual_seed(0)
    model = _small(frozen=case == "frozen")
    sched = toptim.Plateau("loss", factor=0.5, patience=0) \
        if case == "plateau" else None
    opt = toptim.LocalOptimizer(model, _data(), tnn.ClassNLLCriterion(),
                                device="cpu")
    opt.set_optim_method(toptim.SGD(learningrate=0.1, momentum=0.9,
                                    learningrate_schedule=sched))
    if case == "composite":
        model[2].set_name("head")
        opt.set_optim_methods({"head": toptim.Adam(learningrate=0.01)})
    opt.set_flat_update(case == "flat")
    opt.set_end_when(toptim.Trigger.max_iteration(3)).optimize()
    _, _, mask = opt._prepare_step()
    tree = ostate_tree(opt._method, opt._ostate, model, mask)
    host = ostate_host_layout(opt._method, jax.tree_util.tree_map(
        lambda t: t.detach().clone().numpy() if torch.is_tensor(t)
        else np.float32(t), tree))
    if case == "flat":
        assert set(host["v"]) == {"float32"}
    if case == "plateau":
        assert host["clr"] == np.float32(0.1)
    before = [t.clone() for t in _slot_tensors(opt._ostate)]
    for t in _slot_tensors(opt._ostate):
        t.fill_(7.0)
    load_jax_ostate(opt._method, opt._ostate, model, host, mask)
    after = _slot_tensors(opt._ostate)
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    with pytest.raises(KeyError):
        load_jax_ostate(opt._method, opt._ostate, model, {"w": host}, mask)


def _slot_tensors(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k, v in tree.items() if k != "flat"
                for t in _slot_tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _slot_tensors(v)]
    return []


# ------------------------------------------------------------- files
def _opt(path, n_iter=10, every=2):
    RandomGenerator.set_seed(1)
    torch.manual_seed(0)
    return (toptim.LocalOptimizer(_small(), _data(), tnn.ClassNLLCriterion(),
                                  device="cpu")
            .set_optim_method(toptim.SGD(learningrate=0.1, momentum=0.9))
            .set_end_when(toptim.Trigger.max_iteration(n_iter))
            .set_checkpoint(str(path), toptim.Trigger.several_iteration(every)))


def _versions(path):
    return sorted((p for p in os.listdir(path)
                   if _ckpt_version(p) is not None), key=_ckpt_version)


def test_numeric_version_order(tmp_path):
    assert _ckpt_version("checkpoint.9.pkl") == 9
    assert _ckpt_version("checkpoint.10.pkl") == 10
    assert _ckpt_version("checkpoint.pkl") == -1
    assert _ckpt_version("checkpoint.9.pkl.corrupt") is None
    assert _ckpt_version("checkpoint.9.pkl.tmp") is None
    opt = _opt(tmp_path, n_iter=10)
    opt.optimize()
    old = tmp_path / "checkpoint.8.pkl"
    past = os.path.getmtime(old) + 3600
    os.utime(old, (past, past))
    fresh = _opt(tmp_path)
    fresh._load_latest_checkpoint()
    assert fresh.state["neval"] == 11


def test_keep_last_n_and_overwrite(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_CKPT_KEEP", "2")
    _opt(tmp_path / "keep").optimize()
    assert _versions(tmp_path / "keep") == ["checkpoint.8.pkl",
                                            "checkpoint.10.pkl"]
    monkeypatch.delenv("BIGDL_CKPT_KEEP")
    _opt(tmp_path / "all").optimize()
    assert len(_versions(tmp_path / "all")) == 5
    opt = _opt(tmp_path / "roll").over_write_checkpoint()
    opt.optimize()
    assert os.listdir(tmp_path / "roll") == ["checkpoint.pkl"]
    assert port_file.load(str(tmp_path / "roll" / "checkpoint.pkl"))[
        "state"]["neval"] == 10


def test_corrupt_latest_quarantined_with_fallback(tmp_path):
    _opt(tmp_path).optimize()
    newest = tmp_path / "checkpoint.10.pkl"
    data = newest.read_bytes()
    newest.write_bytes(data[:len(data) // 2])
    snap = events.snapshot()
    opt = _opt(tmp_path, n_iter=12)
    opt.optimize(resume="auto")
    assert os.path.exists(str(newest) + ".corrupt")
    assert events.deltas(snap).get("ckpt_quarantined") == 1
    assert events.deltas(snap).get("resume") == 1
    assert port_file.load(str(newest))["state"]["neval"] == 10
    assert opt.state["neval"] == 13


def test_all_corrupt_raises_clear_error(tmp_path):
    (tmp_path / "checkpoint.1.pkl").write_bytes(port_file.MAGIC + b"\x01")
    with pytest.raises(RuntimeError, match="no loadable checkpoint"):
        _opt(tmp_path)._load_latest_checkpoint()


def test_resume_auto_without_checkpoint_starts_fresh(tmp_path):
    opt = _opt(tmp_path / "empty", n_iter=4)
    opt.optimize(resume="auto")
    assert opt.state["neval"] == 5
    with pytest.raises(ValueError):
        opt.optimize(resume="yes")


def test_write_failure_raises_at_the_join(tmp_path):
    from bigdl_tpu_torch.utils import faults
    opt = _opt(tmp_path, n_iter=4)
    with faults.inject_faults("ckpt_write@1=error"), \
            pytest.raises(RuntimeError, match="checkpoint write failed"):
        opt.optimize()


def test_unported_backends_raise(tmp_path, monkeypatch):
    opt = _opt(tmp_path)
    with pytest.raises(NotImplementedError, match="orbax"):
        opt.set_checkpoint(str(tmp_path), toptim.Trigger.every_epoch(),
                           backend="orbax")
    # the elastic backend is ported: asked for by name or by the variable
    opt.set_checkpoint(str(tmp_path), toptim.Trigger.every_epoch(),
                       backend="elastic")
    assert opt.checkpoint_backend == "elastic"
    monkeypatch.setenv("BIGDL_CKPT_SHARDED", "1")
    opt.set_checkpoint(str(tmp_path), toptim.Trigger.every_epoch())
    assert opt.checkpoint_backend == "elastic"
    with pytest.raises(ValueError):
        opt.set_checkpoint(str(tmp_path), toptim.Trigger.every_epoch(),
                           backend="zarr")


@pytest.mark.parametrize("name,args", [
    ("lenet", ["--synthetic-size", "64", "-b", "16",
               "--overwrite-checkpoint"]),
    ("resnet", ["--depth", "8", "--synthetic-size", "32", "-b", "16"]),
    ("vgg", ["--synthetic-size", "32", "-b", "16"]),
])
def test_vision_mains_take_checkpoint_and_summary_dir(name, args, tmp_path):
    """JAX's mains' ``--checkpoint`` (every epoch) and ``--summary-dir``
    (train and validation summaries under the model's name)."""
    import importlib
    main = importlib.import_module(f"bigdl_tpu_torch.models.{name}.train")
    assert not hasattr(main, "UNPORTED_FLAGS")
    opt = main.main(["--device", "cpu", "--max-epoch", "1", "--checkpoint",
                     str(tmp_path / "ck"), "--summary-dir",
                     str(tmp_path / "tb"), *args])
    files = os.listdir(tmp_path / "ck")
    want = ("checkpoint.pkl" if "--overwrite-checkpoint" in args
            else f"checkpoint.{opt.state['neval']}.pkl")
    assert files == [want]
    for mode in ("train", "validation"):
        assert any(".tfevents." in f for f in
                   os.listdir(tmp_path / "tb" / name / mode))
    assert opt.train_summary.read_scalar("Loss")
