"""The port's live observability plane, on the CPU, against ``bigdl_tpu/``:
the metrics endpoint (``/metrics`` text from a registry fed the same
observations equal to JAX's, names, labels and quantiles; the tenant rows;
``/healthz`` codes; the HTTP server on an ephemeral localhost port), the
SLO monitor (its breaches against JAX's on the same observations, the
engines it degrades, the ``slo_breach`` drill), the access log and the
watchdog's arm state on ``/healthz``.

The process's registries are reset around each test: they outlive runs.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from bigdl_tpu.obs import exporter as jexporter
from bigdl_tpu.obs import slo as jslo
from bigdl_tpu.obs.registry import registry as jregistry
from bigdl_tpu.utils import faults as jfaults
from bigdl_tpu_torch.models.transformerlm import TransformerLM
from bigdl_tpu_torch.obs import access_log, exporter, slo, watchdog
from bigdl_tpu_torch.obs.registry import registry
from bigdl_tpu_torch.serving import (
    RequestTimeout, ServingEngine, SnapshotServer,
)
from bigdl_tpu_torch.utils import faults

VOCAB, MAX_LEN = 64, 64


@pytest.fixture(scope="module")
def tlm():
    return TransformerLM(VOCAB, 32, 4, 2, MAX_LEN, device="cpu")


@pytest.fixture(autouse=True)
def clean():
    for reg, xp in ((registry, exporter), (jregistry, jexporter)):
        reg.reset()
        xp.reset()
    yield
    for reg, xp in ((registry, exporter), (jregistry, jexporter)):
        reg.reset()
        xp.reset()


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _feed(reg):
    """The same observations into either package's registry."""
    r = np.random.default_rng(0)
    for name in ("serving/ttft_ms", "serving/tpot_ms", "serving/e2e_ms",
                 "serving/queue_wait_ms"):
        for v in r.gamma(2.0, 30.0, 37):
            reg.histogram(name).observe(float(v))
    for name, n in (("serving/requests", 37), ("serving/completed", 35),
                    ("serving/shed", 2), ("fleet/dispatch", 7)):
        reg.counter(name).inc(n)
    reg.gauge("serving/health").set(2)
    reg.gauge("serving/active_slots").set(3)
    reg.gauge("serve/model_version").set(4)


def test_metrics_text_equals_jax_for_the_same_observations():
    _feed(registry)
    _feed(jregistry)
    ours, theirs = exporter.render_metrics(), jexporter.render_metrics()
    assert ours == theirs
    parsed = exporter.parse_metrics(ours)
    assert parsed == jexporter.parse_metrics(theirs)
    assert parsed["bigdl_serving_requests_total"] == 37
    assert 'bigdl_serving_ttft_ms{quantile="0.99"}' in parsed
    assert parsed["bigdl_serving_ttft_ms_count"] == 37
    types = [ln for ln in ours.splitlines() if ln.startswith("# TYPE")]
    assert len(types) == len(set(types))


def test_tenant_rows_and_slo_flag(tlm):
    """Two tenants of a snapshot server are on /metrics before their first
    request, with JAX's tenant field names; a breach of the TTFT rule
    degrades both and shows in their ``slo_degraded`` rows, and a clean
    check clears it."""
    srv = SnapshotServer({"a": tlm, "b": tlm}, max_len=MAX_LEN, slots=2,
                         buckets=(16, 32, 64), device="cpu")
    try:
        parsed = exporter.parse_metrics(exporter.render_metrics())
        for t in ("a", "b"):
            assert parsed[f'bigdl_serving_tenant_health{{tenant="{t}"}}'] == 0
        fields = {k.split("{")[0][len("bigdl_serving_tenant_"):]
                  for k in parsed if k.startswith("bigdl_serving_tenant_")}
        assert set(jexporter._TENANT_FIELDS) | {"health", "slo_degraded"} \
            == fields
        srv.submit("a", _prompt(1, 5), 3).result(120)
        srv.submit("b", _prompt(2, 5), 3).result(120)
        mon = slo.SLOMonitor(ttft_p99_ms=0.001, min_count=1)
        assert [b["rule"] for b in mon.check()] == ["ttft_p99_ms"]
        assert all(srv.engine(t).stats()["health"] == "degraded"
                   for t in "ab")
        parsed = exporter.parse_metrics(exporter.render_metrics())
        assert parsed['bigdl_serving_tenant_slo_degraded{tenant="a"}'] == 1
        code, payload = exporter.render_healthz()
        assert code == 200 and payload["status"] == "degraded"
        assert payload["slo"]["active"][0]["rule"] == "ttft_p99_ms"
        registry.reset()
        assert mon.check() == [] and mon.breaches == 1
        assert all(srv.engine(t).stats()["health"] == "ready"
                   for t in "ab")
    finally:
        srv.shutdown()


@pytest.mark.parametrize("rules", [
    dict(ttft_p99_ms=50.0), dict(stall_rate=0.1), dict(min_tps=1e6),
], ids=["ttft", "stall_rate", "throughput"])
def test_slo_rules_breach_as_jax_does(rules):
    """Each rule on the same observations, both packages: the same breach
    dicts, and nothing below ``min_count`` samples."""
    out = []
    for reg, mod in ((registry, slo), (jregistry, jslo)):
        mon = mod.SLOMonitor(**rules)
        assert mon.check() == []
        for v in (10.0,) * 4 + (500.0,) * 6:
            reg.histogram("serving/ttft_ms").observe(v)
            reg.histogram("train/step_wall").observe(0.01)
        reg.counter("train/feed_stall").inc(3)
        reg.gauge("train/throughput").set(1234.5)
        out.append(mon.check())
    assert out[0] == out[1] and len(out[0]) == 1


def test_slo_breach_drill_fires_once_in_both():
    for mod, fl in ((slo, faults), (jslo, jfaults)):
        mon = mod.SLOMonitor(min_tps=1.0)
        with fl.inject_faults("slo_breach@1") as plan:
            assert [b["rule"] for b in mon.check()] == ["injected"]
        assert plan.unfired() == [] and mon.check() == []


def test_slo_from_env_is_off_without_rules(monkeypatch):
    monkeypatch.delenv("BIGDL_SLO_TTFT_MS", raising=False)
    assert slo.SLOMonitor.from_env() is None
    assert slo.start_from_env() is None


def test_healthz_codes_match_jax(tlm):
    """A dead engine answers 503, a live one 200, in both packages."""
    from bigdl_tpu.models.transformerlm import TransformerLM as JLM
    from bigdl_tpu.serving import ServingEngine as JEngine
    jlm = JLM(VOCAB, embed_dim=32, num_heads=4, num_layers=2,
              max_len=MAX_LEN)
    codes = []
    for xp, make in ((exporter, lambda: ServingEngine(
            tlm, MAX_LEN, slots=2, device="cpu", name="one")),
            (jexporter, lambda: JEngine(jlm, MAX_LEN, slots=2, name="one"))):
        eng = make()
        xp.register_engine(eng)
        live = xp.render_healthz()
        eng.shutdown()
        dead = xp.render_healthz()
        codes.append([(c, p["status"], p["engines"]["one"]["health"])
                      for c, p in (live, dead)])
    assert codes[0] == codes[1] == [(200, "ok", "starting"),
                                    (503, "dead", "dead")]


def test_endpoint_serves_metrics_healthz_statusz_over_http(tlm):
    _feed(registry)
    eng = ServingEngine(tlm, MAX_LEN, slots=2, device="cpu", name="web")
    eng.submit(_prompt(3, 5), 3).result(120)
    srv = exporter.MetricsExporter(0, host="127.0.0.1").start()
    try:
        # no proxy: the server is on this host
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

        def get(path):
            try:
                with opener.open(srv.url + path, timeout=30) as r:
                    return r.status, r.read().decode()
            except urllib.error.HTTPError as e:
                return e.code, e.read().decode()

        code, text = get("/metrics")
        parsed = exporter.parse_metrics(text)
        assert code == 200 and parsed["bigdl_serving_requests_total"] == 38
        assert parsed['bigdl_serving_tenant_completed{tenant="web"}'] == 1
        code, body = get("/healthz")
        assert code == 200 and json.loads(body)["engines"]["web"]["health"] \
            == "ready"
        code, body = get("/statusz")
        status = json.loads(body)
        assert code == 200 and status["engines"]["web"]["completed"] == 1
        assert status["mfu"] is None and status["hosts"] == {}
        code, body = get("/profilez?seconds=1")
        assert code == 501 and "A.6" in body
        assert get("/nope")[0] == 404
    finally:
        srv.stop()
        eng.shutdown()


def test_exporter_allocates_nothing_without_a_port(monkeypatch):
    monkeypatch.delenv("BIGDL_METRICS_PORT", raising=False)
    before = exporter._SERVERS_CREATED
    assert exporter.start_from_env() is None
    assert exporter._SERVERS_CREATED == before


def test_watchdog_arm_state_on_healthz():
    wd = watchdog.HangWatchdog(hard_s=5.0, poll_s=0.05, sink=lambda s: None)
    wd.start()
    try:
        assert exporter.render_healthz()[1]["watchdogs"] == [
            {"armed": False, "dumps": 0, "hard_s": 5.0}]
        wd.heartbeat(0.01)
        assert exporter.render_healthz()[1]["watchdogs"][0]["armed"]
    finally:
        wd.stop()
    assert exporter.render_healthz()[1]["watchdogs"] == []


def test_access_log_records_every_outcome(tlm, tmp_path, monkeypatch):
    """One record a finished request, JAX's fields in JAX's order: ``ok``
    with its trace id, ``timeout`` for a request whose deadline passed
    while queued (the engine's clock jumps), ``aborted`` at shutdown."""
    from bigdl_tpu.obs.access_log import FIELDS as JFIELDS
    monkeypatch.setenv("BIGDL_ACCESS_LOG", str(tmp_path))
    access_log.reset()
    try:
        eng = ServingEngine(tlm, MAX_LEN, slots=1, device="cpu", name="log")
        r = eng.submit(_prompt(4, 5), 3).result(120)
        with eng._device_lock:
            late = eng.submit(_prompt(5, 5), 3, deadline_ms=1000)
            eng.clock = lambda: late._request.submit_t + 5.0
        with pytest.raises(RequestTimeout):
            late.result(120)
        eng.shutdown()
        access_log.reset()
        lines = []
        for name in sorted(os.listdir(tmp_path)):
            with open(tmp_path / name) as f:
                lines += [json.loads(ln) for ln in f if ln.strip()]
    finally:
        access_log.reset()
    assert tuple(lines[0]) == JFIELDS == access_log.FIELDS
    assert [(x["outcome"], x["phase"]) for x in lines] == [
        ("ok", "decode"), ("timeout", "queue")]
    assert lines[0]["trace_id"] == r.trace_id
    assert lines[0]["output_tokens"] == 3 and lines[0]["flops"] is None
    # the records re-sharded into .bdlrec files come back as logged
    from bigdl_tpu_torch.dataset.streaming import StreamingDataSet
    paths, n = access_log.to_bdlrec(str(tmp_path), str(tmp_path / "out"),
                                    shards=2)
    assert n == 2 and len(paths) == 2
    back = StreamingDataSet(paths, decoder=access_log.access_record_decoder,
                            shuffle_window=0)
    assert sorted(x["trace_id"] for x in back.data(True)) == sorted(
        x["trace_id"] for x in lines)


def test_access_log_rotates_and_never_raises(tmp_path):
    log = access_log.AccessLog(str(tmp_path), rotate_mb=0.0)   # 4 KiB
    for i in range(3):
        log.log(trace_id=str(i), outcome="ok", note="x" * 5000)
    log.close()
    assert log.records == 3 and log.rotations == 3
    assert len(os.listdir(tmp_path)) == 3
    bad = access_log.AccessLog(str(tmp_path / "f" / "x"))
    os.makedirs(tmp_path / "f")
    (tmp_path / "f" / "x").write_text("a file, not a directory")
    bad.log(trace_id="y")
    assert bad.disabled


def test_trainer_rails_feed_the_slo_rules():
    """The port's trainer publishes JAX's rails: a step wall a step, the
    throughput gauge; the throughput rule then breaches as JAX's would on
    the same gauge."""
    import torch

    from bigdl_tpu_torch import nn as tnn
    from bigdl_tpu_torch import optim as toptim
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    r = np.random.default_rng(0)
    data = (DataSet.array(Sample(r.normal(size=4).astype(np.float32),
                                 np.int32(r.integers(0, 3)))
                          for _ in range(16)) >> SampleToMiniBatch(4))
    torch.manual_seed(0)
    model = (tnn.Sequential().add(tnn.Linear(4, 3))
             .add(tnn.LogSoftMax()))
    (toptim.LocalOptimizer(model, data, tnn.ClassNLLCriterion(),
                           device="cpu")
     .set_optim_method(toptim.SGD(learningrate=0.1))
     .set_end_when(toptim.Trigger.max_iteration(6)).optimize())
    snap = registry.snapshot()
    assert snap["histograms"]["train/step_wall"]["count"] == 6
    tps = snap["gauges"]["train/throughput"]
    assert tps > 0
    jregistry.gauge("train/throughput").set(tps)
    floor = tps * 10
    ours = slo.SLOMonitor(min_tps=floor).check()
    theirs = jslo.SLOMonitor(min_tps=floor).check()
    assert ours == theirs and ours[0]["rule"] == "throughput_floor"

