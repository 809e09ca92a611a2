"""LiveAggregator: the online half of doctor/trace — rollups, binding
stage and SLO burn alerts over a sliding window.

``doctor`` and ``trace`` answer "where did the time go" *post-mortem* by
joining per-process JSONL files. This module answers it *while the run is
still going*: the learner/gateway host's :class:`LiveAggregator` ingests
its own facade events plus every batch the telemetry relay forwards
(``telemetry/relay.py`` — fleet T_TELEM frames, replica
``POST /admin/telemetry``, brokerd HTTP relay), keeps the last
``diag.live.window_s`` seconds of events, and derives:

* per-role/per-stage rollups (SPS, MFU, queue depths, stage p50/p95,
  publish→apply lag, retraces, broker repl lag, relay drop counters);
* the current **binding stage** — the same attribution the offline
  ``sheeprl_tpu_torch trace`` verdict makes: when the cross-process stall
  detector fires over the window the binding stage is its worst WAIT
  stage, otherwise the role/stage with the largest share of window span
  time (the thing the run is actually spending its wall-clock on);
* **SLO burn alerts** — configurable rules (``diag.live.slo``) over
  snapshot metrics, breaching for at least ``burn_frac`` of the window
  before firing. Alerts are schema'd ``alert`` events written to the main
  stream (so doctor finds them post-hoc) and mirrored into Prometheus
  (``slo_alerts_total{rule=...}`` / ``slo_burn{rule=...}``).

Relayed events are validated at ingest: an event that fails
``validate_event`` is counted and quarantined (a bounded sample ring for
`/live` debugging), never fatal and never forwarded into the metrics.

The port's copy of ``sheeprl_tpu/diag/aggregator.py`` (it imports neither package).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["LiveAggregator", "binding_stage_for_events", "binding_stage_for_run"]

DEFAULT_WINDOW_S = 60.0
DEFAULT_MAX_EVENTS = 20000
DEFAULT_EVAL_S = 2.0
_QUARANTINE_KEEP = 20

# snapshot fields carried per latest-value rollup: event type -> fields
_LATEST_FIELDS = {
    "fleet": ("workers", "alive", "quarantined", "queue_depth_max", "dropped_steps", "rounds"),
    "gateway": ("requests", "acked", "p50_ms", "p95_ms", "p99_ms", "routable", "admission_shed"),
    "broker": ("sessions", "lag", "repl_wait_p95_ms", "fsync_p95_ms", "fenced_writes"),
    "overlap": ("queue_depth", "queue_cap", "player_stall_frac", "staleness_max"),
}


def _percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(p * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _sel(cfg: Any, path: str, default: Any) -> Any:
    if cfg is None:
        return default
    if hasattr(cfg, "select"):
        val = cfg.select(path, default)
        return default if val is None else val
    node: Any = cfg
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return default if node is None else node


def binding_stage_for_events(events: List[Dict[str, Any]], cfg: Any = None) -> Optional[str]:
    """Name the binding ``role/stage`` for a set of events: the offline
    verdict (`detect_cross_process_stall` worst WAIT stage) when it fires,
    else the stage holding the largest share of total span time. None when
    there are no spans to attribute."""
    from .findings import detect_cross_process_stall
    from .timeline import Timeline

    spans = [r for r in events if r.get("event") == "trace_span"]
    if not spans:
        return None
    tl = Timeline()
    for rec in spans:
        tl.add(rec)
    findings = detect_cross_process_stall(tl, cfg)
    for f in findings:
        by_stage = f.data.get("wait_ms_by_stage") or {}
        if by_stage:
            return str(max(by_stage.items(), key=lambda kv: kv[1])[0])
    totals: Dict[str, float] = {}
    for s in spans:
        key = f"{s.get('role') or '?'}/{s.get('name') or '?'}"
        totals[key] = totals.get(key, 0.0) + float(s.get("dur_ms") or 0.0)
    if not totals:
        return None
    return max(totals.items(), key=lambda kv: kv[1])[0]


def binding_stage_for_run(log_dir: Any, cfg: Any = None) -> Optional[str]:
    """Offline binding-stage verdict over a whole run directory (the value
    the bench scripts stamp into BENCH/SERVE/FLYWHEEL records): merge every
    stream the way ``sheeprl_tpu_torch trace`` does, then attribute."""
    try:
        from .trace import merge_streams

        events, streams = merge_streams(log_dir)
    except Exception:
        return None
    if not streams:
        return None
    return binding_stage_for_events(events, cfg)


class _SloRule:
    """One configured SLO rule + its burn-rate state.

    Config shape (``diag.live.slo`` list entry)::

        {name: gateway_p99, metric: gateway.p99_ms, max: 250,
         burn_frac: 0.5, severity: warning}

    ``metric`` is a dotted path into the live snapshot (``sps``,
    ``relay.dropped``, ``gateway.p99_ms``, ``stages.<role/stage>.p95_ms``,
    ...); exactly one of ``max``/``min`` bounds it. The rule breaches on an
    evaluation tick when the resolved value violates the bound; it FIRES
    once breached ticks cover ``burn_frac`` of the ticks seen inside the
    window (default 1.0 tick — fire immediately), and resolves the same
    way in reverse."""

    def __init__(self, spec: Dict[str, Any], window_s: float) -> None:
        self.name = str(spec.get("name") or spec.get("metric") or "rule")
        self.metric = str(spec.get("metric") or "")
        self.max = spec.get("max")
        self.min = spec.get("min")
        self.burn_frac = float(spec.get("burn_frac") or 0.0)
        self.severity = str(spec.get("severity") or "warning")
        self.window_s = float(spec.get("window_s") or window_s)
        self._ticks: deque = deque()  # (t, breached, value)
        self.firing = False
        self.last_value: Optional[float] = None
        self.burn = 0.0

    def threshold(self) -> Optional[float]:
        bound = self.max if self.max is not None else self.min
        return float(bound) if bound is not None else None

    def evaluate(self, value: Optional[float], now: float) -> Optional[str]:
        """Feed one tick; returns "firing"/"resolved" on a state change."""
        breached = False
        if value is not None:
            self.last_value = float(value)
            if self.max is not None and float(value) > float(self.max):
                breached = True
            if self.min is not None and float(value) < float(self.min):
                breached = True
        self._ticks.append((now, breached))
        while self._ticks and self._ticks[0][0] < now - self.window_s:
            self._ticks.popleft()
        n = len(self._ticks)
        hot = sum(1 for _, b in self._ticks if b)
        self.burn = hot / n if n else 0.0
        should_fire = n > 0 and (self.burn >= self.burn_frac if self.burn_frac > 0 else breached)
        if should_fire and not self.firing:
            self.firing = True
            return "firing"
        if not should_fire and self.firing:
            self.firing = False
            return "resolved"
        return None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "metric": self.metric,
            "max": self.max,
            "min": self.min,
            "burn_frac": self.burn_frac,
            "burn": round(self.burn, 4),
            "firing": self.firing,
            "value": self.last_value,
            "severity": self.severity,
        }


def _resolve_metric(snapshot: Dict[str, Any], path: str) -> Optional[float]:
    node: Any = snapshot
    for part in path.split("."):
        if isinstance(node, dict):
            node = node.get(part)
        else:
            return None
    if isinstance(node, bool) or not isinstance(node, (int, float)):
        return None
    return float(node)


class LiveAggregator:
    """Windowed cross-process event aggregation + SLO evaluation.

    ``emit`` (when given) receives schema'd ``alert`` events — the facade
    wires its own ``_emit`` here so alerts land on the main stream AND in
    Prometheus; ``registry`` (when given) receives every valid relayed
    event via ``observe_event`` (the /metrics federation) plus the alert
    mirror metrics."""

    def __init__(
        self,
        cfg: Any = None,
        emit: Optional[Callable[[Dict[str, Any]], None]] = None,
        registry: Any = None,
    ) -> None:
        self.window_s = float(_sel(cfg, "diag.live.window_s", DEFAULT_WINDOW_S))
        self.max_events = int(_sel(cfg, "diag.live.max_events", DEFAULT_MAX_EVENTS))
        self.eval_s = float(_sel(cfg, "diag.live.eval_s", DEFAULT_EVAL_S))
        self._cfg = cfg
        self.emit = emit
        self.registry = registry
        rules = _sel(cfg, "diag.live.slo", None) or []
        self.rules = [
            _SloRule(r, self.window_s) for r in rules if isinstance(r, dict) and r.get("metric")
        ]
        self._lock = threading.Lock()
        self._events: deque = deque()  # (t_arrival, rec)
        self._relay_stats: Dict[str, Dict[str, float]] = {}  # stream -> {sent, dropped, batches}
        self._quarantine: deque = deque(maxlen=_QUARANTINE_KEEP)
        self.ingested = 0
        self.relayed = 0
        self.invalid = 0
        self._last_eval = 0.0
        self._started = time.time()

    # -- ingestion ---------------------------------------------------------
    def ingest(self, rec: Dict[str, Any], stream: str = "main") -> None:
        """One LOCAL (already-validated) event from the facade's emit path."""
        now = time.time()
        with self._lock:
            self.ingested += 1
            if rec.get("event") == "relay":
                self._note_relay_locked(stream, rec)
            self._events.append((now, dict(rec, _stream=stream)))
            self._prune_locked(now)
        self._maybe_evaluate(now)

    def ingest_batch(self, batch: Any) -> Dict[str, int]:
        """One relayed batch ``{"role", "index", "events", "dropped"}``.
        Every event is schema-validated here — the relay crosses a process
        (possibly host) boundary, so the aggregator trusts nothing: invalid
        and unknown events are counted + quarantined, never fatal."""
        from ..telemetry.schema import validate_event

        out = {"accepted": 0, "invalid": 0}
        if not isinstance(batch, dict):
            with self._lock:
                self.invalid += 1
                self._quarantine.append(("batch is not a dict", str(type(batch).__name__)))
            return dict(out, invalid=1)
        role = str(batch.get("role") or "relay")
        index = int(batch.get("index") or 0)
        stream = f"{role}_{index:03d}"
        events = batch.get("events")
        now = time.time()
        valid: List[Dict[str, Any]] = []
        invalid: List[Tuple[str, Any]] = []
        for rec in events if isinstance(events, list) else []:
            errors = validate_event(rec)
            if errors:
                invalid.append((errors[0], rec.get("event") if isinstance(rec, dict) else rec))
            else:
                valid.append(rec)
        with self._lock:
            self.relayed += len(valid)
            self.invalid += len(invalid)
            for item in invalid:
                self._quarantine.append(item)
            dropped = batch.get("dropped")
            if isinstance(dropped, (int, float)) and not isinstance(dropped, bool):
                st = self._relay_stats.setdefault(
                    stream, {"sent": 0.0, "dropped": 0.0, "batches": 0.0}
                )
                st["dropped"] = max(st["dropped"], float(dropped))
                st["batches"] += 1
                st["sent"] += len(valid)
            for rec in valid:
                if rec.get("event") == "relay":
                    self._note_relay_locked(stream, rec)
                self._events.append((now, dict(rec, _stream=stream)))
            self._prune_locked(now)
        out["accepted"] = len(valid)
        out["invalid"] = len(invalid)
        if self.registry is not None:
            for rec in valid:
                try:
                    self.registry.observe_event(rec)
                except Exception:
                    pass
        self._maybe_evaluate(now)
        return out

    def _note_relay_locked(self, stream: str, rec: Dict[str, Any]) -> None:
        st = self._relay_stats.setdefault(stream, {"sent": 0.0, "dropped": 0.0, "batches": 0.0})
        for key in ("sent", "dropped", "batches"):
            val = rec.get(key)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                st[key] = max(st[key], float(val))

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.window_s
        while self._events and (
            self._events[0][0] < horizon or len(self._events) > self.max_events
        ):
            self._events.popleft()

    # -- rollups -----------------------------------------------------------
    def _window_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [rec for _, rec in self._events]

    def snapshot(self) -> Dict[str, Any]:
        """The `/live` JSON body: windowed rollups + binding stage + SLO
        state. Safe to call from any thread."""
        now = time.time()
        events = self._window_events()
        streams: Dict[str, int] = {}
        latest: Dict[str, Dict[str, Any]] = {}
        stage_durs: Dict[Tuple[str, str], List[float]] = {}
        lags: List[float] = []
        mem_rows: Dict[str, Dict[str, Any]] = {}
        mem_high: Dict[str, Dict[str, int]] = {}
        sps = mfu = retraces = None
        for rec in events:
            streams[rec.get("_stream", "main")] = streams.get(rec.get("_stream", "main"), 0) + 1
            event = rec.get("event")
            if event == "mem":
                # latest sample per emitting process + per-role high-waters
                role = str(rec.get("role") or "?")
                index = rec.get("index", rec.get("worker", rec.get("replica")))
                key = f"{role}_{int(index):03d}" if index is not None else role
                row: Dict[str, Any] = {"role": role}
                for f in (
                    "rss_bytes", "rss_peak_bytes", "hbm_bytes_in_use",
                    "hbm_peak_bytes", "hbm_bytes_limit", "live_buffers",
                    "live_buffer_bytes", "step", "t",
                ):
                    if rec.get(f) is not None:
                        row[f] = rec[f]
                mem_rows[key] = row
                high = mem_high.setdefault(role, {"rss_bytes": 0, "hbm_bytes": 0})
                high["rss_bytes"] = max(
                    high["rss_bytes"],
                    int(rec.get("rss_peak_bytes") or rec.get("rss_bytes") or 0),
                )
                high["hbm_bytes"] = max(
                    high["hbm_bytes"],
                    int(rec.get("hbm_peak_bytes") or rec.get("hbm_bytes_in_use") or 0),
                )
                continue
            if event == "log":
                if rec.get("sps") is not None:
                    sps = float(rec["sps"])
                tp = rec.get("throughput") or {}
                if tp.get("mfu") is not None:
                    mfu = float(tp["mfu"])
                xla = rec.get("xla") or {}
                if xla.get("retraces") is not None:
                    retraces = int(xla["retraces"])
            elif event == "trace_span":
                key = (str(rec.get("role") or "?"), str(rec.get("name") or "?"))
                stage_durs.setdefault(key, []).append(float(rec.get("dur_ms") or 0.0))
                if rec.get("name") == "param_apply":
                    lags.append(float(rec.get("dur_ms") or 0.0))
            elif event in _LATEST_FIELDS:
                row = latest.setdefault(str(event), {})
                for f in _LATEST_FIELDS[event]:
                    if rec.get(f) is not None:
                        row[f] = rec[f]
        stages: Dict[str, Dict[str, Any]] = {}
        for (role, name), durs in sorted(stage_durs.items()):
            durs.sort()
            stages[f"{role}/{name}"] = {
                "count": len(durs),
                "p50_ms": round(_percentile(durs, 0.50), 4),
                "p95_ms": round(_percentile(durs, 0.95), 4),
                "total_ms": round(sum(durs), 2),
            }
        lags.sort()
        with self._lock:
            relay = {
                "sent": sum(st["sent"] for st in self._relay_stats.values()),
                "dropped": sum(st["dropped"] for st in self._relay_stats.values()),
                "streams": {k: dict(v) for k, v in sorted(self._relay_stats.items())},
            }
            quarantine = list(self._quarantine)
        snap: Dict[str, Any] = {
            "t": round(now, 3),
            "uptime_s": round(now - self._started, 1),
            "window_s": self.window_s,
            "events_in_window": len(events),
            "streams": dict(sorted(streams.items())),
            "sps": sps,
            "mfu": mfu,
            "retraces": retraces,
            "stages": stages,
            "param_apply_lag_ms": {
                "count": len(lags),
                "p50": round(_percentile(lags, 0.50), 3),
                "p95": round(_percentile(lags, 0.95), 3),
            }
            if lags
            else None,
            "binding_stage": binding_stage_for_events(events, self._cfg),
            "memory": {
                "streams": {k: mem_rows[k] for k in sorted(mem_rows)},
                "high_water": {r: dict(mem_high[r]) for r in sorted(mem_high)},
            }
            if mem_rows
            else None,
            "relay": relay,
            "ingested": self.ingested,
            "relayed": self.relayed,
            "invalid_events": self.invalid,
            "quarantine": [
                {"error": str(e), "event": str(ev)} for e, ev in quarantine
            ],
        }
        for event, row in latest.items():
            snap[event] = row
        snap["slo"] = [r.to_dict() for r in self.rules]
        snap["alerts"] = [r.to_dict() for r in self.rules if r.firing]
        return snap

    # -- SLO evaluation ----------------------------------------------------
    def _maybe_evaluate(self, now: float) -> None:
        if not self.rules or now - self._last_eval < self.eval_s:
            return
        self._last_eval = now
        try:
            self.evaluate(now)
        except Exception:
            pass  # the control plane must never take down the data plane

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Run every SLO rule against the current snapshot; returns the
        alert events emitted on this tick (state transitions only)."""
        now = time.time() if now is None else now
        snap = self.snapshot()
        emitted: List[Dict[str, Any]] = []
        for rule in self.rules:
            value = _resolve_metric(snap, rule.metric)
            change = rule.evaluate(value, now)
            if self.registry is not None:
                try:
                    self.registry.gauge(
                        "slo_burn",
                        "SLO rule burn fraction over its window",
                        labels={"rule": rule.name},
                    ).set(rule.burn)
                except Exception:
                    pass
            if change is None:
                continue
            rec: Dict[str, Any] = {
                "event": "alert",
                "rule": rule.name,
                "state": change,
                "metric": rule.metric,
                "burn_frac": rule.burn_frac,
                "window_s": rule.window_s,
                "severity": rule.severity,
            }
            if rule.last_value is not None:
                rec["value"] = rule.last_value
            if rule.threshold() is not None:
                rec["threshold"] = rule.threshold()
            emitted.append(rec)
            if change == "firing" and self.registry is not None:
                try:
                    self.registry.counter(
                        "slo_alerts_total",
                        "SLO burn alerts raised",
                        labels={"rule": rule.name},
                    ).inc()
                except Exception:
                    pass
            if self.emit is not None:
                try:
                    self.emit(rec)
                except Exception:
                    pass
        return emitted
