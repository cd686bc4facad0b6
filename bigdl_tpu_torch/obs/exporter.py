"""Live operational endpoint: /metrics, /healthz, /statusz over stdlib http.

Counterpart of ``bigdl_tpu/obs/exporter.py``. One daemon
``ThreadingHTTPServer`` serves:

- ``/metrics``: Prometheus text from one registry snapshot (counters as
  ``_total``, histograms as summaries with p50/p95/p99 ``quantile`` labels
  and ``_sum``/``_count``, gauges as they are), each registered engine's
  ``stats()`` as gauges labelled ``{tenant="<engine name>"}``, and each
  registered fleet's counters ``{fleet=...}`` and replicas' gauges
  ``{fleet=...,replica=...}``: JAX's names and labels;
- ``/healthz``: each engine's health, the watchdogs' arm state, the SLO
  state and each fleet's replicas; 503 when an engine is ``dead`` unless it
  is a replica of a fleet that still has a healthy one (the fleet is then
  ``degraded``), else 200;
- ``/statusz``: JSON of the published status blobs (the run report, the
  SLO monitor's, the promotion controller's and the registry's), every
  engine's and fleet's ``stats()``.

JAX's ``/profilez`` capture and the cluster-spool rows
(``obs/cluster.py``) wait for ROADMAP Queue A.6 with the device gauges and
the MFU accounting: ``/profilez`` answers 501 naming it, and ``/statusz``
carries ``mfu`` and ``device_memory`` as null and ``hosts`` empty.

Opt-in: :func:`start_from_env` returns None without allocating anything
when ``BIGDL_METRICS_PORT`` is unset (:data:`_SERVERS_CREATED` counts the
servers ever made); port 0 binds an ephemeral port. Registration holds
weak references: a dropped engine or fleet leaves the endpoint.
"""

from __future__ import annotations

import json
import os
import re
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from bigdl_tpu_torch.obs import watchdog as obs_watchdog
from bigdl_tpu_torch.obs.registry import registry

#: exporters ever constructed (the disabled path allocates none)
_SERVERS_CREATED = 0

_ENGINES: "weakref.WeakSet" = weakref.WeakSet()
_FLEETS: "weakref.WeakSet" = weakref.WeakSet()
_STATUS: dict = {}
_STATUS_LOCK = threading.Lock()
_ACTIVE: Optional["MetricsExporter"] = None
_ACTIVE_LOCK = threading.Lock()

#: the serving health states' codes (obs does not import serving)
_HEALTH_CODE = {"starting": 0, "ready": 1, "degraded": 2, "draining": 3,
                "dead": 4}

#: numeric ServingEngine.stats() fields exported a tenant
_TENANT_FIELDS = ("backlog", "queued", "active_slots", "submitted",
                  "completed", "timeouts", "shed", "respawns",
                  "poisoned_slots", "slot_recycles", "decode_tps",
                  "queue_depth", "decode_rate", "est_wait_ms",
                  "prefix_hits", "prefix_tokens_saved", "prefix_bytes",
                  "spec_acceptance", "model_version", "pages_used",
                  "pages_free", "free_page_ratio", "page_evictions")

#: numeric fields exported a replica under {fleet=...,replica=...}
_REPLICA_FIELDS = ("queue_depth", "active_slots", "est_wait_ms",
                   "decode_rate", "completed", "shed", "pages_free",
                   "free_page_ratio", "prefill_inflight")

#: numeric FleetRouter.stats() counters exported under {fleet=...}
_FLEET_FIELDS = ("healthy_replicas", "dispatched", "retries",
                 "replica_downs", "rejected", "handoffs",
                 "handoff_failures")

_PROFILEZ_501 = (b'{"error": "/profilez captures a device profile through '
                 b'the device telemetry of ROADMAP Queue A.6, which is not '
                 b'ported"}\n')


def register_engine(engine) -> None:
    """Expose an engine's stats() on /metrics and /healthz (weakly
    held)."""
    _ENGINES.add(engine)


def unregister_engine(engine) -> None:
    _ENGINES.discard(engine)


def engines() -> list:
    return list(_ENGINES)


def register_fleet(fleet) -> None:
    """Expose a FleetRouter's stats() on /metrics, /healthz and /statusz
    (weakly held)."""
    _FLEETS.add(fleet)


def unregister_fleet(fleet) -> None:
    _FLEETS.discard(fleet)


def fleets() -> list:
    return list(_FLEETS)


def publish_status(key: str, value) -> None:
    """Publish a JSON-able blob under /statusz."""
    with _STATUS_LOCK:
        _STATUS[key] = value


def _san(name: str) -> str:
    """A registry name as a Prometheus name: train/step_wall ->
    bigdl_train_step_wall."""
    return "bigdl_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def _stats_of(objs) -> list:
    out = []
    for o in objs:
        try:
            out.append(o.stats())
        except Exception:
            continue
    return out


def render_metrics() -> str:
    """The /metrics body."""
    snap = registry.snapshot()
    lines = []
    for name, v in sorted(snap["counters"].items()):
        m = _san(name) + "_total"
        lines.append("# TYPE %s counter" % m)
        lines.append("%s %s" % (m, _fmt(v)))
    for name, v in sorted(snap["gauges"].items()):
        m = _san(name)
        lines.append("# TYPE %s gauge" % m)
        lines.append("%s %s" % (m, _fmt(v)))
    for name, h in sorted(snap["histograms"].items()):
        m = _san(name)
        lines.append("# TYPE %s summary" % m)
        for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            if h.get(key) is not None:
                lines.append('%s{quantile="%s"} %s' % (m, q, _fmt(h[key])))
        lines.append("%s_sum %s" % (m, _fmt(h["total"])))
        lines.append("%s_count %s" % (m, _fmt(h["count"])))
    # tenants: one TYPE line a field, a labelled row a tenant under it
    per_field: dict = {}
    health_rows = []
    for st in _stats_of(engines()):
        tenant = str(st.get("name", "?"))
        for field in _TENANT_FIELDS:
            v = st.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                per_field.setdefault(field, []).append((tenant, v))
        health_rows.append((tenant, _HEALTH_CODE.get(st.get("health"), -1),
                            bool(st.get("slo_degraded"))))
    for field in sorted(per_field):
        m = "bigdl_serving_tenant_" + field
        lines.append("# TYPE %s gauge" % m)
        for tenant, v in per_field[field]:
            lines.append('%s{tenant="%s"} %s' % (m, tenant, _fmt(v)))
    if health_rows:
        lines.append("# TYPE bigdl_serving_tenant_health gauge")
        for tenant, code, _ in health_rows:
            lines.append('bigdl_serving_tenant_health{tenant="%s"} %d'
                         % (tenant, code))
        lines.append("# TYPE bigdl_serving_tenant_slo_degraded gauge")
        for tenant, _, slo in health_rows:
            lines.append('bigdl_serving_tenant_slo_degraded{tenant="%s"} %d'
                         % (tenant, 1 if slo else 0))
    fleet_rows: dict = {}
    rep_rows: dict = {}
    rep_health: list = []
    for st in _stats_of(fleets()):
        fname = str(st.get("name", "?"))
        for field in _FLEET_FIELDS:
            v = st.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                fleet_rows.setdefault(field, []).append((fname, v))
        for rname, rst in sorted(st.get("replicas", {}).items()):
            for field in _REPLICA_FIELDS:
                v = rst.get(field)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    rep_rows.setdefault(field, []).append((fname, rname, v))
            rep_health.append(
                (fname, rname, _HEALTH_CODE.get(rst.get("health"), -1)))
    for field in sorted(fleet_rows):
        m = "bigdl_fleet_" + field
        lines.append("# TYPE %s gauge" % m)
        for fname, v in fleet_rows[field]:
            lines.append('%s{fleet="%s"} %s' % (m, fname, _fmt(v)))
    for field in sorted(rep_rows):
        m = "bigdl_fleet_replica_" + field
        lines.append("# TYPE %s gauge" % m)
        for fname, rname, v in rep_rows[field]:
            lines.append('%s{fleet="%s",replica="%s"} %s'
                         % (m, fname, rname, _fmt(v)))
    if rep_health:
        lines.append("# TYPE bigdl_fleet_replica_health gauge")
        for fname, rname, code in rep_health:
            lines.append('bigdl_fleet_replica_health{fleet="%s",'
                         'replica="%s"} %d' % (fname, rname, code))
    return "\n".join(lines) + "\n"


def parse_metrics(text: str) -> dict:
    """Prometheus text -> ``{"name" or 'name{labels}': float}``, the
    inverse of :func:`render_metrics`."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        out[key] = float(val)
    return out


def render_healthz() -> "tuple[int, dict]":
    """(HTTP status, payload) of /healthz."""
    engs = {}
    for st in _stats_of(engines()):
        engs[str(st.get("name", "?"))] = {
            "health": st.get("health"),
            "backlog": st.get("backlog"),
            "active_slots": st.get("active_slots"),
            "slo_degraded": bool(st.get("slo_degraded")),
        }
    fleet_block = {}
    covered: set = set()   # replicas whose fleet still has a healthy one
    for st in _stats_of(fleets()):
        reps = {rn: rs.get("health")
                for rn, rs in st.get("replicas", {}).items()}
        healthy = int(st.get("healthy_replicas", 0))
        fleet_block[str(st.get("name", "?"))] = {
            "replicas": reps, "healthy_replicas": healthy}
        if healthy > 0:
            covered.update(reps)
    states = [(name, e["health"]) for name, e in engs.items()]
    # a replica that never started never registered itself: the fleet's
    # block is where its state shows
    fleet_states = [(rn, h) for fb in fleet_block.values()
                    for rn, h in fb["replicas"].items()]
    status, code = "ok", 200
    if any(s == "dead" and name not in covered for name, s in states):
        status, code = "dead", 503
    elif any(s in ("dead", "degraded", "draining")
             for _, s in states + fleet_states):
        status = "degraded"
    watchdogs = [{"armed": wd.armed, "dumps": wd.dumps, "hard_s": wd.hard_s}
                 for wd in obs_watchdog.active_watchdogs()]
    with _STATUS_LOCK:
        slo = _STATUS.get("slo")
    return code, {"status": status, "engines": engs, "fleets": fleet_block,
                  "watchdogs": watchdogs, "slo": slo, "pid": os.getpid()}


def render_statusz() -> dict:
    """The /statusz payload."""
    with _STATUS_LOCK:
        status = dict(_STATUS)
    engs = {str(st.get("name", "?")): st for st in _stats_of(engines())}
    fls = {str(st.get("name", "?")): st for st in _stats_of(fleets())}
    return {"run_report": status.get("run_report"),
            "slo": status.get("slo"),
            "status": status,
            "mfu": None,
            "device_memory": None,
            "hosts": {},
            "engines": engs,
            "fleets": fls}


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (http.server's API)
        try:
            if self.path.startswith("/metrics"):
                code = 200
                body = render_metrics().encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.startswith("/healthz"):
                code, payload = render_healthz()
                body = json.dumps(payload, default=str).encode("utf-8")
                ctype = "application/json"
            elif self.path.startswith("/statusz"):
                code = 200
                body = json.dumps(render_statusz(),
                                  default=str).encode("utf-8")
                ctype = "application/json"
            elif self.path.startswith("/profilez"):
                code, body, ctype = 501, _PROFILEZ_501, "application/json"
            else:
                code, body, ctype = 404, b"not found\n", "text/plain"
        except Exception as exc:   # a render never kills the server thread
            code = 500
            body = ("exporter error: %s\n" % exc).encode("utf-8")
            ctype = "text/plain"
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass   # the scraper hung up

    def log_message(self, fmt, *args):   # no stderr line a request
        pass


class MetricsExporter:
    """The endpoint's server. ``port=0`` binds an ephemeral port (read
    :attr:`port` after :meth:`start`)."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        global _SERVERS_CREATED
        _SERVERS_CREATED += 1
        self.port = int(port)
        self.host = host
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsExporter":
        if self._httpd is not None:
            return self
        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="bigdl-metrics",
            kwargs={"poll_interval": 0.2}, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None

    @property
    def url(self) -> str:
        return "http://127.0.0.1:%d" % self.port


def start_from_env() -> Optional[MetricsExporter]:
    """Start the process's endpoint once when ``BIGDL_METRICS_PORT`` is
    set; None (allocating nothing) when it is not. Idempotent."""
    raw = os.environ.get("BIGDL_METRICS_PORT", "").strip()
    if not raw:
        return None
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            return _ACTIVE
        try:
            port = int(raw)
        except ValueError:
            raise ValueError(
                "BIGDL_METRICS_PORT=%r is not an integer port" % raw)
        _ACTIVE = MetricsExporter(port).start()
        return _ACTIVE


def active() -> Optional[MetricsExporter]:
    return _ACTIVE


def reset() -> None:
    """Test isolation: stop the active server, drop registrations and
    status."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            _ACTIVE.stop()
        _ACTIVE = None
    _ENGINES.clear()
    _FLEETS.clear()
    with _STATUS_LOCK:
        _STATUS.clear()
