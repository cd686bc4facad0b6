"""Observability of the port: one rail for traces, metrics and hangs.

Copies of ``bigdl_tpu/obs``'s stdlib modules:

- :mod:`~bigdl_tpu_torch.obs.trace`: the span tracer and the JSONL event
  log (``BIGDL_TRACE``);
- :mod:`~bigdl_tpu_torch.obs.registry`: the process's counters, gauges and
  histograms (p50/p95/p99);
- :mod:`~bigdl_tpu_torch.obs.watchdog`: the hang watchdog
  (``BIGDL_WATCHDOG_S``);
- :mod:`~bigdl_tpu_torch.obs.exporter`: ``/metrics``, ``/healthz`` and
  ``/statusz`` on ``BIGDL_METRICS_PORT``;
- :mod:`~bigdl_tpu_torch.obs.slo`: the SLO monitor whose breaches flip
  serving health to ``degraded``;
- :mod:`~bigdl_tpu_torch.obs.access_log`: the request log
  (``BIGDL_ACCESS_LOG``).

JAX's ``mfu``, ``device`` and ``cluster`` (the MFU accounting, the device
memory gauges, the multi-host spools and ``/profilez``) and the end-of-run
``report`` wait for ROADMAP Queue A.6.
"""

from __future__ import annotations

import os

from bigdl_tpu_torch.obs import access_log, exporter, registry, slo, \
    trace, watchdog
from bigdl_tpu_torch.obs.registry import registry as metric_registry


def describe_config() -> str:
    """The active observability configuration, one human-readable
    block."""
    trace.configure_from_env()
    wd = os.environ.get("BIGDL_WATCHDOG_S", "")
    port = os.environ.get("BIGDL_METRICS_PORT", "").strip()
    lines = [
        "observability:",
        f"  trace      = {'on' if trace.enabled() else 'off'}"
        f" (BIGDL_TRACE={os.environ.get('BIGDL_TRACE', '')!r})",
        f"  trace dir  = {trace.trace_dir() or '-'}",
        f"  chrome out = {trace.chrome_path() or '-'}",
        f"  event log  = {trace.jsonl_path() or '-'}"
        f" (BIGDL_OBS_LOG={os.environ.get('BIGDL_OBS_LOG', '')!r})",
        f"  watchdog   = {wd + 's hard timeout' if wd else 'off'}"
        f" (BIGDL_WATCHDOG_S)",
        f"  metrics    = {'port ' + port if port else 'off'}"
        f" (BIGDL_METRICS_PORT)",
    ]
    return "\n".join(lines)


__all__ = ["trace", "registry", "watchdog", "exporter", "slo",
           "access_log", "metric_registry", "describe_config"]
