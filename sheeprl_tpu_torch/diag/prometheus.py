"""Live Prometheus export: a lock-light metric registry + stdlib HTTP endpoint
(a copy of ``sheeprl_tpu/diag/prometheus.py``; it imports neither package).

The telemetry JSONL stream is great post-hoc, but a fleet operator wants to
*scrape* a running job. This module provides the minimal counter / gauge /
histogram trio rendered in the Prometheus text exposition format (0.0.4) from
a plain ``ThreadingHTTPServer`` — no client library, no background
aggregation thread.

Lock discipline ("lock-light"): every metric takes one tiny lock only around
its own few-field update. Writers are expected to be the learner thread (the
``Telemetry`` facade mirrors events into the registry from the same thread
that writes the MetricAggregator) plus the occasional background emitter
(async checkpoint writer, watchdog) — contention is per-log-interval, never
per-step, so the locks are noise. Render (`Registry.render`) runs on the
HTTP thread and only snapshots under the same per-metric locks.

`Registry.observe_event` is the bridge from the JSONL schema: one schema
event in, the matching counter/gauge/histogram updates out. The same
registry class backs the policy server's latency / batch-occupancy
histograms (`serve/batcher.py`), so `GET /metrics` on a PolicyServer and on
a training run speak the same format.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "PrometheusServer",
    "start_http_server",
    "CONTENT_TYPE",
]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# default bucket ladders (upper bounds, seconds / milliseconds / fractions)
LATENCY_MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)
SECONDS_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0)
FRACTION_BUCKETS = (0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99)


def _fmt(v: float) -> str:
    """Prometheus sample value formatting (ints without trailing .0)."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _label_suffix(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in sorted(labels.items())) + "}"


class Counter:
    """Monotonically increasing value. With ``labels`` this is one labeled
    child of a metric family (several counters share a name, e.g.
    ``slo_alerts_total{rule=...}``)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None) -> None:
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {v})")
        with self._lock:
            self._value += float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> List[Tuple[str, float]]:
        return [(f"{self.name}{_label_suffix(self.labels)}", self.value)]


class Gauge:
    """Set-to-current value (optionally one labeled child of a family)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None) -> None:
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> List[Tuple[str, float]]:
        return [(f"{self.name}{_label_suffix(self.labels)}", self.value)]


class Histogram:
    """Fixed-bucket histogram with cumulative rendering and host-side
    percentile estimation (linear interpolation inside the winning bucket —
    exact enough for p50/p95/p99 dashboards; the raw buckets are what
    Prometheus itself aggregates).

    ``labels`` makes this one labeled CHILD of a metric family: several
    histograms share a name (one TYPE/HELP block) and differ only in their
    label set — e.g. ``stage_latency_ms{role="worker",stage="env_step"}``.
    Label values must come from a closed set (the lint rule rejects
    dynamically formatted span/event names for exactly this reason)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = SECONDS_BUCKETS,
        labels: Optional[Dict[str, str]] = None,
    ) -> None:
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name} needs at least one bucket bound")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0

    def _label_str(self, extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in sorted(self.labels.items())]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def observe(self, v: float) -> None:
        v = float(v)
        idx = len(self.buckets)
        for i, bound in enumerate(self.buckets):
            if v <= bound:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, p: float) -> float:
        """Estimate the p-quantile (0..1) from the bucket counts."""
        counts, _, total = self.snapshot()
        if total == 0:
            return 0.0
        target = p * total
        cum = 0
        lo = 0.0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= target:
                hi = self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
                if c == 0:
                    return hi
                frac = (target - prev_cum) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            lo = self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
        return self.buckets[-1]

    def samples(self) -> List[Tuple[str, float]]:
        counts, total_sum, total = self.snapshot()
        out: List[Tuple[str, float]] = []
        cum = 0
        for bound, c in zip(self.buckets, counts):
            cum += c
            le = 'le="' + _fmt(bound) + '"'
            out.append((f"{self.name}_bucket{self._label_str(le)}", cum))
        inf = 'le="+Inf"'
        out.append((f"{self.name}_bucket{self._label_str(inf)}", total))
        out.append((f"{self.name}_sum{self._label_str()}", total_sum))
        out.append((f"{self.name}_count{self._label_str()}", total))
        return out


class Registry:
    """Named metric registry rendering the Prometheus text format.

    get-or-create accessors are idempotent (same name → same object), so
    event-driven code can call them inline without bookkeeping.
    """

    def __init__(self, prefix: str = "sheeprl") -> None:
        self.prefix = prefix
        self._lock = threading.Lock()  # guards the name→metric map only
        self._metrics: Dict[str, Any] = {}
        self._bucket_overrides: Dict[str, Tuple[float, ...]] = {}

    def set_bucket_overrides(self, overrides: Optional[Dict[str, Sequence[float]]]) -> None:
        """Per-metric histogram bucket ladders (``diag.prometheus.buckets``):
        keyed by the metric's family name, with or without the registry
        prefix. Overrides apply at a family's FIRST creation — set them
        before any event reaches ``observe_event``. A sub-ms ``jit_step``
        and a ~50ms ``broker_put`` sharing one default ladder land in the
        same two buckets; the override gives each its own resolution."""
        self._bucket_overrides = {}
        for name, bounds in (overrides or {}).items():
            try:
                ladder = tuple(sorted(float(b) for b in bounds))
            except (TypeError, ValueError):
                continue
            if ladder:
                self._bucket_overrides[str(name)] = ladder

    def _get(self, cls: Any, name: str, help: str, labels: Optional[Dict[str, str]] = None, **kw: Any) -> Any:
        name = f"{self.prefix}_{name}" if self.prefix and not name.startswith(self.prefix) else name
        # labeled children share the family name; the registry key carries
        # the label set so each child accumulates independently
        key = name
        if labels:
            key += "{" + ",".join(f'{k}="{v}"' for k, v in sorted(labels.items())) + "}"
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, **(dict(kw, labels=labels) if labels else kw))
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {key} already registered as {type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels=labels)

    def gauge(self, name: str, help: str = "", labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels=labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = SECONDS_BUCKETS,
        labels: Optional[Dict[str, str]] = None,
    ) -> Histogram:
        override = self._bucket_overrides.get(name) or self._bucket_overrides.get(
            f"{self.prefix}_{name}" if self.prefix else name
        )
        if override is None and name.startswith(f"{self.prefix}_"):
            override = self._bucket_overrides.get(name[len(self.prefix) + 1 :])
        return self._get(
            Histogram, name, help, labels=labels, buckets=override if override else buckets
        )

    def metrics(self) -> Iterable[Any]:
        with self._lock:
            return list(self._metrics.values())

    def render(self) -> str:
        # group by family: labeled children share a name and the text
        # format wants one TYPE/HELP block with all the family's samples
        # together, regardless of child creation order
        families: Dict[str, List[Any]] = {}
        for m in self.metrics():
            families.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name, members in families.items():
            head = members[0]
            if head.help:
                lines.append(f"# HELP {name} {head.help}")
            lines.append(f"# TYPE {name} {head.kind}")
            for m in members:
                for sample_name, value in m.samples():
                    lines.append(f"{sample_name} {_fmt(value)}")
        return "\n".join(lines) + "\n"

    # -- the JSONL bridge ---------------------------------------------------
    def observe_event(self, rec: Dict[str, Any]) -> None:
        """Mirror one schema event into the live metrics. Unknown events and
        missing fields are ignored — the scrape surface must never take down
        the emitter."""
        event = rec.get("event")
        if event == "startup":
            self.gauge("up", "1 while the run is alive").set(1.0)
            self.gauge("devices", "visible accelerator devices").set(float(rec.get("devices") or 0))
        elif event == "log":
            self.gauge("step", "current policy step").set(float(rec.get("step") or 0))
            if rec.get("sps") is not None:
                self.gauge("sps", "policy env-steps per second (log interval)").set(float(rec["sps"]))
            interval_steps = float(rec.get("interval_steps") or 0)
            interval_s = float(rec.get("interval_seconds") or 0.0)
            if interval_steps > 0 and interval_s > 0:
                step_time = interval_s / interval_steps
                self.gauge("step_time_seconds", "mean seconds per policy step (log interval)").set(step_time)
                self.histogram(
                    "step_time_seconds_hist", "per-interval mean step time", SECONDS_BUCKETS
                ).observe(step_time)
            tp = rec.get("throughput") or {}
            if tp.get("mfu") is not None:
                self.gauge("mfu", "model FLOPs utilization").set(float(tp["mfu"]))
            if tp.get("grad_steps_per_s") is not None:
                self.gauge("grad_steps_per_s", "gradient steps per second").set(float(tp["grad_steps_per_s"]))
            xla = rec.get("xla") or {}
            if xla.get("compiles_in_interval"):
                self.counter("xla_compiles_total", "backend compiles observed in-run").inc(
                    float(xla["compiles_in_interval"])
                )
            # `retraces` is a run-cumulative delta against the run baseline;
            # export as a gauge so the scrape matches the JSONL semantics
            if xla.get("retraces") is not None:
                self.gauge("xla_retraces", "retraces since run start").set(float(xla["retraces"]))
            # persistent-compilation-cache accounting: run-cumulative deltas
            # in the JSONL, mirrored as monotonic *_total counters by
            # incrementing with the per-interval difference
            for key, metric in (("cache_hits", "compile_cache_hits_total"),
                                ("cache_misses", "compile_cache_misses_total")):
                if xla.get(key) is not None:
                    ctr = self.counter(metric, "persistent compilation cache " + key.replace("_", " "))
                    delta = float(xla[key]) - ctr.value
                    if delta > 0:
                        ctr.inc(delta)
        elif event == "overlap":
            self.gauge("overlap_queue_depth", "player→learner queue occupancy").set(
                float(rec.get("queue_depth") or 0)
            )
            self.gauge("overlap_queue_cap", "player→learner queue capacity").set(
                float(rec.get("queue_cap") or 0)
            )
            if rec.get("player_stall_frac") is not None:
                frac = float(rec["player_stall_frac"])
                self.gauge("overlap_player_stall_frac", "player stall fraction (interval)").set(frac)
                self.histogram(
                    "overlap_player_stall_frac_hist", "player stall fraction", FRACTION_BUCKETS
                ).observe(frac)
            if rec.get("staleness_max") is not None:
                self.gauge("overlap_staleness_max", "interval staleness high-water").set(
                    float(rec["staleness_max"])
                )
        elif event == "ckpt_async":
            action = rec.get("action")
            if action in ("enqueued", "written", "failed"):
                self.counter(f"ckpt_{action}_total", f"checkpoint writes {action}").inc()
            if rec.get("block_ms") is not None:
                self.histogram(
                    "ckpt_block_ms", "train-thread checkpoint blocking time (ms)", LATENCY_MS_BUCKETS
                ).observe(float(rec["block_ms"]))
            if rec.get("write_ms") is not None:
                self.histogram(
                    "ckpt_write_ms", "background durable-write time (ms)", LATENCY_MS_BUCKETS
                ).observe(float(rec["write_ms"]))
        elif event == "fleet":
            action = rec.get("action")
            if action == "interval":
                self.gauge("fleet_workers", "configured fleet size").set(float(rec.get("workers") or 0))
                self.gauge("fleet_alive_workers", "workers currently running").set(
                    float(rec.get("alive") or 0)
                )
                self.gauge("fleet_quarantined_workers", "workers quarantined").set(
                    float(rec.get("quarantined") or 0)
                )
                self.gauge("fleet_respawns", "cumulative worker respawns").set(
                    float(rec.get("respawns") or 0)
                )
                self.gauge("fleet_queue_depth_max", "worker→learner queue high-water").set(
                    float(rec.get("queue_depth_max") or 0)
                )
                self.gauge("fleet_dropped_steps", "env steps that never landed").set(
                    float(rec.get("dropped_steps") or 0)
                )
                if rec.get("reconnects") is not None:
                    self.gauge("fleet_reconnects", "cumulative socket reconnects").set(
                        float(rec.get("reconnects") or 0)
                    )
                if rec.get("dup_frames") is not None:
                    self.gauge(
                        "fleet_dup_frames", "replayed frames dropped by learner-side dedup"
                    ).set(float(rec.get("dup_frames") or 0))
            elif action in (
                "crash", "hang", "torn_packet", "stale_packet", "quarantine", "respawn",
                "spawn", "disconnect",
            ):
                self.counter(f"fleet_{action}_total", f"fleet worker {action} incidents").inc()
        elif event == "net":
            # socket-transport link lifecycle — the action vocabulary is a
            # closed set (literal at every emit site in fleet/net.py), so
            # the counter family stays bounded, mirroring the fleet events
            self.counter(
                f"net_{rec.get('action', 'event')}_total", "fleet socket link events"
            ).inc()
        elif event == "broker":
            # externalized session broker (gateway/brokerd.py): the action
            # vocabulary is a closed set (literal at every emit site), so
            # the sheeprl_broker_* counter family stays bounded; the
            # periodic interval snapshot mirrors as gauges instead
            action = rec.get("action")
            if action == "interval":
                self.gauge("broker_sessions", "sessions held by the broker").set(
                    float(rec.get("sessions") or 0)
                )
                self.gauge("broker_epoch", "broker fencing epoch").set(
                    float(rec.get("epoch") or 0)
                )
                self.gauge(
                    "broker_repl_lag_records", "replication lag high-water (records)"
                ).set(float(rec.get("lag") or 0))
                self.gauge(
                    "broker_fenced_writes", "zombie-primary writes rejected (cumulative)"
                ).set(float(rec.get("fenced_writes") or 0))
                if rec.get("repl_wait_p95_ms") is not None:
                    self.gauge(
                        "broker_repl_wait_p95_ms", "sync-replication ack wait p95 (ms)"
                    ).set(float(rec["repl_wait_p95_ms"]))
                if rec.get("fsync_p95_ms") is not None:
                    self.gauge(
                        "broker_wal_fsync_p95_ms", "WAL fsync p95 (ms)"
                    ).set(float(rec["fsync_p95_ms"]))
            else:
                self.counter(
                    f"broker_{action or 'event'}_total", "session-broker lifecycle events"
                ).inc()
        elif event == "flywheel":
            # data-flywheel lifecycle (sheeprl_tpu/flywheel/): the action
            # vocabulary is a closed set (literal at every emit site), so
            # the sheeprl_flywheel_* counter family stays bounded; ingest
            # passes additionally mirror their headline numbers as gauges
            action = rec.get("action")
            self.counter(
                f"flywheel_{action or 'event'}_total", "data-flywheel lifecycle events"
            ).inc()
            if action == "ingest":
                self.gauge(
                    "flywheel_ingest_samples", "samples ingested by the last pass"
                ).set(float(rec.get("samples") or 0))
                self.gauge(
                    "flywheel_ingest_samples_per_s", "ingest throughput of the last pass"
                ).set(float(rec.get("samples_per_s") or 0.0))
                self.gauge(
                    "flywheel_version_lag",
                    "serving params_version minus the freshest ingested sample's",
                ).set(float(rec.get("version_lag") or 0))
                self.gauge(
                    "flywheel_dropped_stale", "samples dropped by the staleness gate"
                ).set(float(rec.get("dropped_stale") or 0))
        elif event == "chaos":
            self.counter(
                f"chaos_{rec.get('fault', 'fault')}_total", "injected chaos faults"
            ).inc()
        elif event == "retry":
            self.counter("retries_total", "transient-op retries").inc()
        elif event == "watchdog":
            self.counter(f"watchdog_{rec.get('action', 'stall')}_total", "watchdog firings").inc()
        elif event == "preempt":
            self.counter(
                f"preempt_{rec.get('action', 'requested')}_total", "preemption lifecycle events"
            ).inc()
        elif event == "trace_span":
            # per-stage critical-path latency, labeled by role and stage —
            # the live mirror of what `sheeprl_tpu trace` reports post-hoc.
            # Label values are bounded: span names are literal at every
            # emit site (telemetry-schema-drift enforces it)
            self.histogram(
                "stage_latency_ms",
                "distributed-trace stage latency (ms) by role/stage",
                LATENCY_MS_BUCKETS,
                labels={
                    "role": str(rec.get("role") or "unknown"),
                    "stage": str(rec.get("name") or "unknown"),
                },
            ).observe(float(rec.get("dur_ms") or 0.0))
        elif event == "mem":
            # cadenced memory samples (telemetry/memory.py): per-role
            # gauges — the role vocabulary is the closed process-role set
            # (learner | worker | replica | broker), so the family stays
            # bounded even with every stream relayed in
            role = str(rec.get("role") or "unknown")
            self.gauge(
                "host_rss_bytes", "host resident set size by role", labels={"role": role}
            ).set(float(rec.get("rss_bytes") or 0))
            if rec.get("hbm_bytes_in_use") is not None:
                self.gauge(
                    "hbm_bytes_in_use", "device HBM bytes in use by role", labels={"role": role}
                ).set(float(rec["hbm_bytes_in_use"]))
            if rec.get("hbm_peak_bytes") is not None:
                self.gauge(
                    "hbm_peak_bytes", "device HBM high-water by role", labels={"role": role}
                ).set(float(rec["hbm_peak_bytes"]))
            if rec.get("live_buffer_bytes") is not None:
                self.gauge(
                    "live_buffer_bytes", "live device-array bytes by role", labels={"role": role}
                ).set(float(rec["live_buffer_bytes"]))
        elif event == "roofline":
            # roofline verdicts: attained fraction of the binding roof per
            # jitted fn. `fn` is low-cardinality by construction (train
            # step + one name per serve bucket)
            if rec.get("attained_frac") is not None:
                self.gauge(
                    "roofline_attained_frac",
                    "attained fraction of the binding roofline per jitted fn",
                    labels={"fn": str(rec.get("fn") or "unknown")},
                ).set(float(rec["attained_frac"]))
            if rec.get("intensity") is not None:
                self.gauge(
                    "roofline_intensity",
                    "arithmetic intensity (flops/byte) per jitted fn",
                    labels={"fn": str(rec.get("fn") or "unknown")},
                ).set(float(rec["intensity"]))
        elif event == "shutdown":
            self.gauge("up", "1 while the run is alive").set(0.0)
        elif event == "rotate":
            self.counter("jsonl_rotations_total", "telemetry.jsonl size-cap rotations").inc()


class PrometheusServer:
    """Stdlib ThreadingHTTPServer exposing ``GET /metrics`` for a Registry.

    With an ``aggregator`` attached (``diag/aggregator.py``) the same
    endpoint also serves ``GET /live`` — the aggregator's JSON rollup
    snapshot (per-role/per-stage windows, binding stage, active alerts) —
    and ``/metrics`` is federated: relayed roles' events were mirrored into
    the same registry, so one scrape covers the whole run."""

    def __init__(
        self,
        registry: Registry,
        host: str = "127.0.0.1",
        port: int = 9100,
        aggregator: Optional[Any] = None,
    ) -> None:
        self.registry = registry
        self.host = host
        self.aggregator = aggregator
        self._requested_port = int(port)
        self._httpd: Any = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd is not None else None

    def start(self) -> "PrometheusServer":
        if self._httpd is not None:
            return self
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        registry = self.registry
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt: str, *args: Any) -> None:  # quiet
                pass

            def do_GET(self) -> None:
                path = self.path.split("?", 1)[0]
                ctype = CONTENT_TYPE
                if path == "/live" and server.aggregator is not None:
                    import json

                    try:
                        snap = server.aggregator.snapshot()
                    except Exception as err:
                        snap = {"error": f"{type(err).__name__}: {err}"}
                    body = (json.dumps(snap, default=str) + "\n").encode()
                    ctype = "application/json"
                    self.send_response(200)
                elif path in ("/metrics", "/"):
                    body = registry.render().encode()
                    self.send_response(200)
                else:
                    body = b"not found (try /metrics or /live)\n"
                    self.send_response(404)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((self.host, self._requested_port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True, name="prometheus-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None


def start_http_server(
    registry: Registry, port: int, host: str = "127.0.0.1", aggregator: Optional[Any] = None
) -> PrometheusServer:
    """Convenience: build + start a `/metrics` (+`/live`) endpoint."""
    return PrometheusServer(registry, host=host, port=port, aggregator=aggregator).start()
