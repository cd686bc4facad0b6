"""The model registry, the trainer's publication into it, the promotion
lifecycle and the snapshot server of the port, on the CPU, against
``bigdl_tpu/``.

- The registry: the same operations give the same versions, statuses and
  pruning in both packages, and a version published by either package
  resolves in the other and serves the other's tokens.
- The trainer: ``set_model_registry`` publishes each checkpoint's params
  (those of the checkpoint file), and a registry failure never reaches the
  trainer.
- The lifecycle: the gate (an ``eval_fn`` or the port's ``Evaluator``), a
  NaN candidate rejected, a crashed evaluation quarantined, a promotion
  swapped in, a drill-bypassed bad version caught by the watch window and
  rolled back with served tokens bitwise the old version's, the rollback
  budget. A drill's breach comes on the watch window's first round, so no
  outcome hangs on the window's wall-clock length.
"""

import math
import os

import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.utils.model_registry import ModelRegistry as JaxRegistry
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models.transformerlm import TransformerLM
from bigdl_tpu_torch.obs import exporter
from bigdl_tpu_torch.obs.slo import SLOMonitor
from bigdl_tpu_torch.optim.validation import Loss
from bigdl_tpu_torch.serving import (
    PromotionController, PromotionCriterion, ServingEngine, SnapshotServer,
)
from bigdl_tpu_torch.utils import file as port_file
from bigdl_tpu_torch.utils.faults import inject_faults
from bigdl_tpu_torch.utils.model_registry import (
    ModelRegistry, flatten_params, lora_delta,
)
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

VOCAB, E, HEADS, MAX_LEN = 64, 32, 4, 64
BUCKETS = (16, 32, 64)


@pytest.fixture(scope="module")
def pair():
    JaxRNG.set_seed(19)
    jlm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS, num_layers=2,
                           max_len=MAX_LEN).evaluate()
    tlm = TransformerLM(VOCAB, E, HEADS, 2, MAX_LEN, device="cpu")
    convert.load_jax_params(tlm, jlm.get_params())
    return jlm, tlm


def _perturb(tree, seed, scale=0.5):
    r = np.random.default_rng(seed)
    return convert.map_tree(
        lambda a: (np.asarray(a) + r.normal(0, scale, np.shape(a))
                   ).astype(np.float32), tree)


def _lm_of(tree):
    m = TransformerLM(VOCAB, E, HEADS, 2, MAX_LEN, device="cpu")
    return convert.load_jax_params(m, tree)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _solo(tlm, p, m):
    return tnn.greedy_generate(tlm, np.asarray(p)[None], m,
                               device="cpu")[0].numpy()


def _engine(tlm, **kw):
    return ServingEngine(tlm, MAX_LEN, **dict(dict(
        slots=2, buckets=BUCKETS, device="cpu"), **kw))


def _tree_equal(a, b):
    fa, fb = flatten_params(a), flatten_params(b)
    return set(fa) == set(fb) and all(
        np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)


T = {"layer": {"weight": np.arange(6.0, dtype=np.float32).reshape(2, 3),
               "bias": np.zeros(3, np.float32)}}


# ----------------------------------------------------------------- registry
def _registry_script(reg):
    """The same operations on either package's registry; what it saw."""
    seen = [reg.versions(), reg.latest()]
    seen.append(reg.publish(T))
    seen.append(reg.publish(_perturb(T, 1)))
    with pytest.raises(ValueError, match="already exists"):
        reg.publish(T, version=2)
    reg.set_status(2, "promoted", metric=0.9)
    with pytest.raises(ValueError, match="unknown status"):
        reg.set_status(2, "shipped")
    st = reg.status(2)
    seen += [reg.latest("promoted"), st["status"], st["metric"],
             [h["status"] for h in st["history"]], reg.status(99)["status"]]
    vb = reg.publish(T)
    reg.publish_lora({"layer/weight": np.ones((2, 3), np.float32)},
                     base_version=vb)
    for _ in range(4):
        reg.publish(T)
    seen.append(reg.versions())
    seen.append([(r["version"], r["status"], r["kind"])
                 for r in reg.state()["versions"]])
    return seen


def test_registry_states_and_pruning_match_jax(tmp_path):
    ours = _registry_script(ModelRegistry(str(tmp_path / "port"), keep=3))
    theirs = _registry_script(JaxRegistry(str(tmp_path / "jax"), keep=3))
    assert ours == theirs
    assert ours[-2] == [2, 7, 8]      # the promoted one and the newest
    assert ours[:2] == [[], None]


def test_lora_artifact_resolves_as_data(tmp_path):
    base = {"attn": {"lora_a": np.ones((4, 2), np.float32),
                     "lora_b": np.zeros((2, 4), np.float32),
                     "weight": np.eye(4, dtype=np.float32)}}
    reg = ModelRegistry(str(tmp_path), keep=10)
    vb = reg.publish(base)
    delta = {p: a + 0.25 for p, a in lora_delta(base).items()}
    assert set(delta) == {"attn/lora_a", "attn/lora_b"}
    vl = reg.publish_lora(delta, base_version=vb)
    tree = reg.resolve_params(vl)
    np.testing.assert_array_equal(tree["attn"]["lora_b"], delta["attn/lora_b"])
    np.testing.assert_array_equal(tree["attn"]["weight"], np.eye(4))
    # no elastic version under the path: nothing to publish, as in JAX
    assert reg.register_from_elastic(str(tmp_path / "ckpt")) is None


def test_a_version_crosses_packages_and_serves_the_same_tokens(pair,
                                                               tmp_path):
    """JAX publishes, the port resolves and serves it (JAX's greedy
    tokens); the port publishes a tree from its own module (torch leaves),
    JAX resolves it into a model whose greedy tokens the port serves."""
    jlm, tlm = pair
    p = _prompt(3, 9)
    jreg = JaxRegistry(str(tmp_path), keep=10)
    v_j = jreg.publish(_perturb(jlm.get_params(), 2))
    reg = ModelRegistry(str(tmp_path), keep=10)
    with _engine(tlm) as eng:
        eng.swap_weights(reg.resolve_params(v_j), version=v_j)
        got = eng.submit(p, 8).result(120).tokens
    jm = JaxTransformerLM(VOCAB, embed_dim=E, num_heads=HEADS, num_layers=2,
                          max_len=MAX_LEN).evaluate()
    jm.set_params(jreg.resolve_params(v_j))
    want = np.asarray(jnn.greedy_generate(jm, p[None], 8))[0]
    np.testing.assert_array_equal(got, want)
    # and back: the port's module tree, as the trainer publishes it
    mine = _lm_of(_perturb(jlm.get_params(), 4))
    v_p = reg.publish(convert.nest(mine, dict(mine.named_parameters())))
    jm.set_params(JaxRegistry(str(tmp_path)).resolve_params(v_p))
    want = np.asarray(jnn.greedy_generate(jm, p[None], 8))[0]
    with _engine(mine) as eng:
        np.testing.assert_array_equal(eng.submit(p, 8).result(120).tokens,
                                      want)
    assert JaxRegistry(str(tmp_path)).status(v_p)["status"] == "candidate"


# ------------------------------------------------------------------ trainer
def _small():
    return (tnn.Sequential().add(tnn.Linear(4, 5)).add(tnn.ReLU())
            .add(tnn.Linear(5, 3)).add(tnn.LogSoftMax()))


def _data(n=16, seed=0):
    r = np.random.default_rng(seed)
    return (DataSet.array(Sample(r.normal(size=4).astype(np.float32),
                                 np.int32(r.integers(0, 3)))
                          for _ in range(n)) >> SampleToMiniBatch(4))


def _opt(path, n_iter=4, every=2):
    RandomGenerator.set_seed(1)
    torch.manual_seed(0)
    return (toptim.LocalOptimizer(_small(), _data(), tnn.ClassNLLCriterion(),
                                  device="cpu")
            .set_optim_method(toptim.SGD(learningrate=0.1))
            .set_end_when(toptim.Trigger.max_iteration(n_iter))
            .set_checkpoint(str(path), toptim.Trigger.several_iteration(every)))


def test_trainer_publishes_each_checkpoint(tmp_path):
    opt = _opt(tmp_path / "ckpt").set_model_registry(str(tmp_path / "reg"))
    opt.optimize()
    reg = ModelRegistry(str(tmp_path / "reg"))
    assert reg.versions() == [2, 4]
    for v in (2, 4):
        assert reg.status(v)["status"] == "candidate"
        payload = reg.load(v)
        assert payload["meta"] == {"source": "pickle", "neval": v}
        ckpt = port_file.load(str(tmp_path / "ckpt" / f"checkpoint.{v}.pkl"))
        assert _tree_equal(payload["params"], ckpt["params"])
    # the JAX registry reads the port trainer's versions
    assert JaxRegistry(str(tmp_path / "reg")).versions() == [2, 4]


def test_registry_dir_env_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_REGISTRY_DIR", str(tmp_path / "reg"))
    opt = _opt(tmp_path / "ckpt")
    assert opt.model_registry.path == str(tmp_path / "reg")


def test_registry_failure_never_reaches_the_trainer(tmp_path, monkeypatch):
    reg = ModelRegistry(str(tmp_path / "reg"))

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(reg, "publish", broken)
    opt = _opt(tmp_path / "ckpt").set_model_registry(reg)
    opt.optimize()   # must not raise
    assert opt.state["neval"] >= 4
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "checkpoint.2.pkl", "checkpoint.4.pkl"]
    assert reg.versions() == []


# -------------------------------------------------------------------- gate
def _ctrl(tmp_path, tlm, **kw):
    reg = ModelRegistry(str(tmp_path), keep=10)
    eng = _engine(tlm)
    kw.setdefault("eval_fn", lambda p: 0.9)
    kw.setdefault("watch_window_s", 0.0)
    return reg, eng, PromotionController(reg, engine=eng, **kw)


def test_gate_accepts_promotes_and_publishes_status(pair, tmp_path):
    jlm, tlm = pair
    reg, eng, ctrl = _ctrl(tmp_path, tlm,
                           criterion=PromotionCriterion(min_metric=0.5))
    try:
        p = _prompt(5, 7)
        v = reg.publish(_perturb(jlm.get_params(), 1))
        res = ctrl.promote(v, watch=False)
        assert res.promoted and res.metric == 0.9
        assert reg.status(v)["status"] == "promoted"
        assert ctrl.served_version == v and eng.model_version == v
        status = exporter.render_statusz()["status"]
        assert status["promotion"]["served_version"] == v
        assert status["registry"]["promoted"] == v
        np.testing.assert_array_equal(
            eng.submit(p, 8).result(120).tokens,
            _solo(_lm_of(reg.resolve_params(v)), p, 8))
        assert ctrl.step() is None            # nothing newer
        v2 = reg.publish(_perturb(jlm.get_params(), 2))
        assert ctrl.step().version == v2
    finally:
        eng.shutdown()


def test_gate_rejects_threshold_nan_and_crash(pair, tmp_path):
    """Below the threshold, a NaN metric (``promote_eval=nonfinite``) and a
    crashed evaluation (``promote_eval`` error) each reject: the candidate
    is quarantined, the served version stays, the registry still takes
    versions."""
    jlm, tlm = pair
    reg, eng, ctrl = _ctrl(tmp_path, tlm, eval_fn=lambda p: 0.2,
                           criterion=PromotionCriterion(min_metric=0.5))
    try:
        v = reg.publish(jlm.get_params())
        res = ctrl.promote(v, watch=False)
        assert not res.promoted and "threshold" in res.reason
        ctrl.eval_fn = lambda p: 0.9
        v = reg.publish(jlm.get_params())
        with inject_faults("promote_eval@1=nonfinite") as plan:
            ok, metric, reason = ctrl.gate(v)
        assert plan.unfired() == [] and not ok and math.isnan(metric)
        assert "non-finite" in reason
        v3 = reg.publish(jlm.get_params())
        with inject_faults("promote_eval@1") as plan:
            ok, metric, reason = ctrl.gate(v3)
        assert plan.unfired() == []
        assert not ok and metric is None and "eval crashed" in reason
        assert [reg.status(x)["status"] for x in reg.versions()] == \
            ["rejected"] * 3
        assert eng.model_version == 0
        assert reg.publish(jlm.get_params()) == v3 + 1
    finally:
        eng.shutdown()


def test_criterion_rules():
    c = PromotionCriterion(no_regression=True)
    assert c.accept(0.7, 0.6)[0] and not c.accept(0.5, 0.6)[0]
    assert not c.accept(float("nan"), None)[0]
    assert not c.accept(float("inf"), None)[0]
    loss = PromotionCriterion(min_metric=1.0, mode="min",
                              no_regression=False)
    assert loss.accept(0.8, None)[0] and not loss.accept(1.2, None)[0]
    margin = PromotionCriterion(no_regression=True, margin=0.1)
    assert margin.accept(0.55, 0.6)[0] and not margin.accept(0.45, 0.6)[0]


def test_evaluator_gate_scores_and_restores_the_eval_model(pair, tmp_path):
    """No ``eval_fn``: the port's ``Evaluator`` scores the candidate on the
    controller's own eval model (its loss equals the loss of a module
    loaded with the candidate), whose weights are put back after; the
    live engine never sees them."""
    _, tlm = pair
    eval_model = _small().evaluate()
    saved = {n: p.detach().clone() for n, p in eval_model.named_parameters()}
    reg = ModelRegistry(str(tmp_path), keep=10)
    cand = _perturb(convert.nest(eval_model, {
        n: p.detach().numpy() for n, p in eval_model.named_parameters()}), 3)
    v = reg.publish(cand)
    eng = _engine(tlm)
    try:
        ctrl = PromotionController(
            reg, engine=eng, eval_model=eval_model, eval_dataset=_data(),
            eval_methods=[Loss(tnn.ClassNLLCriterion())],
            criterion=PromotionCriterion(no_regression=False),
            watch_window_s=0.0)
        ok, metric, _ = ctrl.gate(v)
    finally:
        eng.shutdown()
    ref = convert.load_jax_params(_small().evaluate(), cand)
    want, _ = toptim.Evaluator(ref, device="cpu").test(
        _data(), [Loss(tnn.ClassNLLCriterion())])[0][0].result()
    assert ok and metric == pytest.approx(float(want), rel=1e-6)
    for n, p in eval_model.named_parameters():
        assert torch.equal(p, saved[n])
    assert eng.model_version == 0


# ----------------------------------------------------------------- rollback
def test_drill_bad_promotion_rolls_back_bitwise(pair, tmp_path):
    """The gate bypassed, a bad version serves; the watch window's SLO
    check breaches (``slo_breach@1``), the first rollback attempt is burned
    (``promote_rollback@1``), the second swaps v0 back: served tokens are
    the old version's bit for bit and the ledger did not grow."""
    jlm, tlm = pair
    probe = _prompt(6, 7)
    reg, eng, ctrl = _ctrl(tmp_path, tlm, slo_monitor=SLOMonitor(),
                           probe_prompts=[probe], rollback_budget=3,
                           watch_window_s=5.0, poll_s=0.01)
    try:
        pre = eng.submit(probe, 8).result(120).tokens
        programs = eng.stats()["compiled_programs"]
        v_bad = reg.publish(_perturb(jlm.get_params(), 3))
        with inject_faults("slo_breach@1;promote_rollback@1") as plan:
            res = ctrl.promote(v_bad, gate=False)
        assert plan.unfired() == []
        assert res.promoted and res.rolled_back and ctrl.rollbacks == 2
        assert reg.status(v_bad)["status"] == "rolled_back"
        assert ctrl.served_version == 0 and eng.model_version == 0
        post = eng.submit(probe, 8).result(120).tokens
        assert eng.stats()["compiled_programs"] == programs
    finally:
        eng.shutdown()
    np.testing.assert_array_equal(post, pre)
    assert not np.array_equal(
        pre, _solo(_lm_of(reg.resolve_params(v_bad)), probe, 8))


def test_nonfinite_probe_rolls_back(pair, tmp_path):
    jlm, tlm = pair
    probe = _prompt(7, 6)
    reg, eng, ctrl = _ctrl(tmp_path, tlm, probe_prompts=[probe])
    try:
        pre = eng.submit(probe, 8).result(120).tokens
        v_bad = reg.publish(convert.map_tree(
            lambda a: np.full(np.shape(a), np.nan, np.float32),
            jlm.get_params()))
        res = ctrl.promote(v_bad, gate=False, watch=True)
        assert res.rolled_back
        assert reg.status(v_bad)["status"] == "rolled_back"
        np.testing.assert_array_equal(eng.submit(probe, 8).result(120).tokens,
                                      pre)
    finally:
        eng.shutdown()


def test_rollback_budget_bounds_the_attempts(pair, tmp_path):
    jlm, tlm = pair
    reg, eng, ctrl = _ctrl(tmp_path, tlm, rollback_budget=2)
    try:
        with pytest.raises(RuntimeError, match="nothing to roll back"):
            ctrl.rollback()
        v = reg.publish(_perturb(jlm.get_params(), 3))
        ctrl.promote(v, gate=False, watch=False)
        with inject_faults("promote_rollback@1;promote_rollback@2") as plan:
            with pytest.raises(RuntimeError):
                ctrl.rollback("drill")
        assert plan.unfired() == []
        assert ctrl.rollbacks == 2 and eng.model_version == v
    finally:
        eng.shutdown()


# ------------------------------------------------------------ tenants
def test_update_tenant_leaves_the_other_tenant_serving(pair):
    """Two native tenants over one module: swapping one changes only its
    tokens, its ledger does not grow, and both are on /metrics from
    construction."""
    jlm, tlm = pair
    p = _prompt(8, 6)
    tree = _perturb(jlm.get_params(), 13)
    srv = SnapshotServer({"a": tlm, "b": tlm}, max_len=MAX_LEN, slots=2,
                         buckets=BUCKETS, device="cpu")
    try:
        assert {"a", "b"} <= {e.stats()["name"] for e in exporter.engines()}
        old = srv.submit("a", p, 8).result(120).tokens
        srv.submit("b", p, 8).result(120)
        programs = srv.engine("a").stats()["compiled_programs"]
        assert srv.update_tenant("a", tree, version=3).version == 3
        got_a = srv.submit("a", p, 8).result(120).tokens
        got_b = srv.submit("b", p, 8).result(120).tokens
        assert srv.engine("a").stats()["compiled_programs"] == programs
        assert (srv.engine("a").model_version,
                srv.engine("b").model_version) == (3, 0)
        with pytest.raises(KeyError):
            srv.update_tenant("nope", tree)
    finally:
        srv.shutdown()
    np.testing.assert_array_equal(got_a, _solo(_lm_of(tree), p, 8))
    np.testing.assert_array_equal(got_b, old)
    np.testing.assert_array_equal(old, _solo(tlm, p, 8))
