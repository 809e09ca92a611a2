"""Run diagnostics of the port: the consumption side of telemetry, copied
from ``sheeprl_tpu/diag/`` (it imports neither package).

* :mod:`.timeline` — streaming reader over (rotated) ``telemetry.jsonl``
  reconstructing a run's per-step timeline;
* :mod:`.findings` — rule-based detectors producing ranked
  :class:`~sheeprl_tpu_torch.diag.findings.Finding`\\ s with remediation hints;
* :mod:`.doctor` — the ``sheeprl_tpu_torch doctor run_dir=...`` CLI (text and
  ``--json`` reports over stream + resume manifest + checkpoint dir);
* :mod:`.trace` — the ``sheeprl_tpu_torch trace run_dir=...`` CLI: merges the
  per-process streams (fleet workers, serving replicas) with clock-skew
  correction and reconstructs cross-process critical paths with a
  per-stage latency table;
* :mod:`.aggregator` — the ``LiveAggregator`` the facade runs on rank 0
  (windowed rollups, binding stage, SLO burn alerts behind ``GET /live``);
* :mod:`.live` — ``sheeprl_tpu_torch top``, which watches a run live;
* :mod:`.prometheus` — the counter/gauge/histogram registry with a
  stdlib-HTTP ``/metrics`` endpoint, fed by the facade and the serving stack.
"""
from .findings import Finding, run_detectors
from .doctor import diagnose, render_text
from .prometheus import Counter, Gauge, Histogram, PrometheusServer, Registry, start_http_server
from .timeline import Timeline, iter_events, rotated_segments
from .trace import analyze, discover_streams, merge_streams

__all__ = [
    "Counter",
    "Finding",
    "Gauge",
    "Histogram",
    "PrometheusServer",
    "Registry",
    "Timeline",
    "analyze",
    "diagnose",
    "discover_streams",
    "iter_events",
    "merge_streams",
    "render_text",
    "rotated_segments",
    "run_detectors",
    "start_http_server",
]
