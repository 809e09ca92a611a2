"""Diagnostics of the port: so far the Prometheus registry and exposition
(``prometheus.py``, a copy of ``sheeprl_tpu/diag/prometheus.py``) that the
serving stack's ``ServeStats`` and ``GET /metrics`` use."""
from .prometheus import Counter, Gauge, Histogram, PrometheusServer, Registry, start_http_server

__all__ = ["Counter", "Gauge", "Histogram", "PrometheusServer", "Registry", "start_http_server"]
