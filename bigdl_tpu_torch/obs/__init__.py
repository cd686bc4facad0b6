"""Observability of the port: the metric registry and the span tracer.

Copies of ``bigdl_tpu/obs/registry.py`` and ``bigdl_tpu/obs/trace.py``
(stdlib only). The rest of JAX's ``obs`` package (watchdog, exporter, SLO
monitor, MFU, device gauges) waits for ROADMAP Queue A.3.2.
"""
