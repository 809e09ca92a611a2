"""`sheeprl_tpu_torch trace run_dir=...` — merged cross-process run timelines.

The other half of distributed tracing (`telemetry/tracing.py` is the
emission half): every process of a run writes its own telemetry stream —
the learner's ``telemetry.jsonl``, each fleet worker's
``workers/worker_NNN/telemetry.jsonl``, each serving replica's
``replicas/replica_NNN/telemetry.jsonl``, the gateway's
``gateway/telemetry.jsonl`` — and this module merges them back into one
timeline:

1. **discover** every stream under the run dir (each read through
   :func:`~sheeprl_tpu_torch.diag.timeline.iter_events`, so rotation segments
   come back in order and torn lines are counted, not fatal);
2. **skew-correct** each stream by its clock-handshake offset (the
   ``clock`` event's ``offset_s``). Offsets below ``skew_min_s`` are
   treated as delivery latency, not skew — on one host the clocks are the
   same clock and "correcting" by queue latency would misalign streams
   that were already aligned;
3. **join spans on trace_id** into per-request critical paths
   (admission → route → forward → replica batch_queue → jit_step →
   export → broker put) and per-round training paths (worker env_step →
   queue_wait → learner_apply, plus the publish → param_apply lag pairs);
4. **report**: completeness (what fraction of acked requests / applied
   packets reconstructed into cross-process paths), a per-(role, stage)
   p50/p95 latency table, the top-K slowest traces with their stage
   breakdown and inter-stage gaps, and any on-demand profiler capture
   dirs announced on the streams.

``doctor`` ingests the same merged event set, so its
``cross_process_stall`` finding and this report always agree.

The port's copy of ``sheeprl_tpu/diag/trace.py`` (it imports neither package).
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .timeline import iter_events, rotated_segments

__all__ = [
    "analyze",
    "build_traces",
    "discover_streams",
    "main",
    "merge_streams",
    "missing_streams",
    "render_text",
    "stream_clock_offset",
]

DEFAULT_SKEW_MIN_S = 0.25
DEFAULT_TOP_K = 10

# roles whose spans mark the two kinds of cross-process path
_ROUND_ROLES = {"worker", "learner", "player"}
_REQUEST_ROLES = {"gateway", "replica", "client"}
# the stages that are *waits* (queue/transport/backpressure) rather than
# work — what cross_process_stall attributes a stalled path to. act_submit
# is the worker-side wait on the batched act service (submit → response):
# its learner-side work twin is act_infer, which stays a work stage
WAIT_STAGES = {"queue_wait", "batch_queue", "admission", "route", "act_submit"}
# spans that anchor completeness: one learner_apply == one applied packet,
# one gateway forward == one acked (traced) request
_ROUND_ANCHOR = "learner_apply"
_REQUEST_ANCHOR = "forward"
# publication lag pairs ride their own traces, not request/round paths
_LAG_SPANS = {"publish", "param_apply"}


def discover_streams(log_dir: Any) -> List[Tuple[str, Path]]:
    """Every telemetry stream of a run, main stream first: the per-process
    layout (``workers/worker_NNN/``, ``replicas/replica_NNN/``, plus the
    ``gateway``/``serve`` subsystem streams) needs no registry — the run
    dir IS the registry."""
    log_dir = Path(log_dir)
    out: List[Tuple[str, Path]] = []

    def add(name: str, path: Path) -> None:
        if rotated_segments(path):
            out.append((name, path))

    add("main", log_dir / "telemetry.jsonl")
    for group in ("workers", "replicas", "brokers"):
        base = log_dir / group
        if base.is_dir():
            for sub in sorted(base.iterdir()):
                add(sub.name, sub / "telemetry.jsonl")
    for extra in ("gateway", "serve", "flywheel"):
        add(extra, log_dir / extra / "telemetry.jsonl")
    return out


def missing_streams(cfg: Any, discovered: Sequence[str]) -> List[Dict[str, Any]]:
    """Discovered streams vs the roster the run config implies: a fleet of
    N workers should have N ``worker_NNN`` streams (minus slots the config
    marks remote — those are relay-only, their files live on the remote
    host), and a gateway run with R replicas should have R ``replica_NNN``
    streams. A stream that never appeared usually means a process died
    before its first write or telemetry was silently misconfigured — the
    kind of blind spot that otherwise reads as "the run looks fine"."""
    names = set(discovered)
    out: List[Dict[str, Any]] = []
    if cfg is None:
        return out
    sel = cfg.select if hasattr(cfg, "select") else (lambda p, d=None: d)
    workers = int(sel("algo.fleet.workers", 0) or 0)
    if workers > 0 and "main" in names:
        remote = {int(i) for i in (sel("fleet.net.remote_workers", None) or [])}
        for i in range(workers):
            name = f"worker_{i:03d}"
            if name in names or i in remote:
                continue
            out.append(
                {
                    "stream": name,
                    "role": "worker",
                    "why": "fleet worker stream never appeared under workers/",
                }
            )
    if "gateway" in names:
        replicas = int(sel("gateway.replicas", 0) or 0)
        for i in range(replicas):
            name = f"replica_{i:03d}"
            if name not in names:
                out.append(
                    {
                        "stream": name,
                        "role": "replica",
                        "why": "replica stream never appeared under replicas/",
                    }
                )
    return out


def stream_clock_offset(
    events: Sequence[Dict[str, Any]], skew_min_s: float = DEFAULT_SKEW_MIN_S
) -> float:
    """The stream's clock correction: the median handshake ``offset_s``
    when it exceeds the skew floor, else 0. The handshake offset is an
    UPPER bound (it includes one-way delivery latency), so small values
    mean "same clock, some latency" and must not shift the stream."""
    offs = [
        float(rec["offset_s"])
        for rec in events
        if rec.get("event") == "clock"
        and isinstance(rec.get("offset_s"), (int, float))
        and not isinstance(rec.get("offset_s"), bool)
    ]
    if not offs:
        return 0.0
    off = statistics.median(offs)
    return off if abs(off) >= float(skew_min_s) else 0.0


_T_FIELDS = ("t", "t_start", "t_end", "t_send", "t_recv")


def merge_streams(
    log_dir: Any, skew_min_s: float = DEFAULT_SKEW_MIN_S
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """All events of all streams, each stream shifted onto the main
    stream's clock. Returns ``(events, stream_meta)``; every event gains a
    ``_stream`` key so traces can say which process a span came from."""
    streams: List[Dict[str, Any]] = []
    merged: List[Dict[str, Any]] = []
    for name, path in discover_streams(log_dir):
        errors: List[str] = []
        events = list(iter_events(path, errors=errors))
        offset = stream_clock_offset(events, skew_min_s) if name != "main" else 0.0
        for rec in events:
            if offset:
                rec = dict(rec)
                for field in _T_FIELDS:
                    if isinstance(rec.get(field), (int, float)) and not isinstance(
                        rec.get(field), bool
                    ):
                        rec[field] = round(float(rec[field]) - offset, 6)
            rec["_stream"] = name
            merged.append(rec)
        streams.append(
            {
                "name": name,
                "path": str(path),
                "events": len(events),
                "parse_errors": len(errors),
                "clock_offset_s": round(offset, 6),
            }
        )
    return merged, streams


def _percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(p * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def build_traces(events: Sequence[Dict[str, Any]]) -> Dict[str, List[Dict[str, Any]]]:
    """Group ``trace_span`` events by trace_id (spans kept in t_start
    order — the critical-path order)."""
    traces: Dict[str, List[Dict[str, Any]]] = {}
    for rec in events:
        if rec.get("event") != "trace_span":
            continue
        tid = rec.get("trace_id")
        if not tid:
            continue
        traces.setdefault(str(tid), []).append(rec)
    for spans in traces.values():
        spans.sort(key=lambda s: (float(s.get("t_start") or 0.0), float(s.get("t_end") or 0.0)))
    return traces


def _trace_kind(spans: List[Dict[str, Any]]) -> str:
    names = {s.get("name") for s in spans}
    if names & _LAG_SPANS:
        return "publication"
    roles = {s.get("role") for s in spans}
    if roles & _REQUEST_ROLES:
        return "request"
    if roles & _ROUND_ROLES:
        return "round"
    return "other"


def _critical_path(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Stage list in time order with the inter-span gap (transport /
    un-instrumented time) before each stage."""
    path: List[Dict[str, Any]] = []
    prev_end: Optional[float] = None
    for s in spans:
        t0, t1 = float(s.get("t_start") or 0.0), float(s.get("t_end") or 0.0)
        entry = {
            "stage": s.get("name"),
            "role": s.get("role"),
            "stream": s.get("_stream"),
            "dur_ms": round(float(s.get("dur_ms") or 0.0), 4),
        }
        if prev_end is not None:
            entry["gap_ms"] = round(max(0.0, (t0 - prev_end)) * 1000.0, 4)
        prev_end = t1 if prev_end is None else max(prev_end, t1)
        path.append(entry)
    return path


def _profile_verdict(trace_dir: str) -> Dict[str, Any]:
    """One capture's ingested verdict: device busy/idle plus the dominant
    op, via the sheeprl_tpu_torch.prof parser. A capture that moved hosts, is
    still being written, or predates the trace-event format degrades to the
    bare path — the trace report must render regardless."""
    row: Dict[str, Any] = {"dir": trace_dir}
    try:
        from ..prof import summarize_capture

        summary = summarize_capture(trace_dir, top_k=1)
        row["device_busy_us"] = summary["device_busy_us"]
        row["device_idle_frac"] = summary["device_idle_frac"]
        if summary["ops"]:
            top = summary["ops"][0]
            row["top_op"] = top["op"]
            row["top_op_frac"] = top["frac"]
            if top.get("scope"):
                row["top_scope"] = top["scope"]
    except Exception as exc:
        row["error"] = str(exc)
    return row


def analyze(
    log_dir: Any,
    trace_id: Optional[str] = None,
    top_k: int = DEFAULT_TOP_K,
    skew_min_s: float = DEFAULT_SKEW_MIN_S,
) -> Dict[str, Any]:
    """Build the full cross-process trace report for one run directory."""
    log_dir = Path(log_dir)
    events, streams = merge_streams(log_dir, skew_min_s)
    if not streams:
        raise FileNotFoundError(
            f"No telemetry streams under {log_dir} (expected telemetry.jsonl and/or "
            "workers/*/, replicas/*/, gateway/ sub-streams)"
        )
    traces = build_traces(events)

    # -- classification + completeness --------------------------------------
    kinds: Dict[str, int] = {}
    complete: Dict[str, int] = {"round": 0, "request": 0}
    anchored: Dict[str, int] = {"round": 0, "request": 0}
    views: List[Dict[str, Any]] = []
    for tid, spans in traces.items():
        kind = _trace_kind(spans)
        kinds[kind] = kinds.get(kind, 0) + 1
        names = {s.get("name") for s in spans}
        roles = {s.get("role") for s in spans}
        is_complete = False
        if kind == "round" and _ROUND_ANCHOR in names:
            anchored["round"] += 1
            # complete = the producing side's span joined too (a fleet
            # worker's env_step, or the overlap player's)
            is_complete = "env_step" in names
            if is_complete:
                complete["round"] += 1
        elif kind == "request" and _REQUEST_ANCHOR in names:
            anchored["request"] += 1
            # complete = the replica's execution span joined the gateway's
            is_complete = "jit_step" in names or "replica" in roles
            if is_complete:
                complete["request"] += 1
        t0 = min(float(s.get("t_start") or 0.0) for s in spans)
        t1 = max(float(s.get("t_end") or 0.0) for s in spans)
        views.append(
            {
                "trace_id": tid,
                "kind": kind,
                "spans": len(spans),
                "complete": is_complete,
                "duration_ms": round((t1 - t0) * 1000.0, 4),
                "t_start": t0,
                "path": _critical_path(spans),
            }
        )

    # -- per-stage latency table --------------------------------------------
    stage_durs: Dict[Tuple[str, str], List[float]] = {}
    for spans in traces.values():
        for s in spans:
            key = (str(s.get("role") or "?"), str(s.get("name") or "?"))
            stage_durs.setdefault(key, []).append(float(s.get("dur_ms") or 0.0))
    stages: Dict[str, Dict[str, Any]] = {}
    for (role, name), durs in sorted(stage_durs.items()):
        durs.sort()
        stages[f"{role}/{name}"] = {
            "count": len(durs),
            "p50_ms": round(_percentile(durs, 0.50), 4),
            "p95_ms": round(_percentile(durs, 0.95), 4),
            "total_s": round(sum(durs) / 1000.0, 4),
        }

    # -- publication lag (publish → param_apply pairs) ----------------------
    lags = sorted(
        float(s.get("dur_ms") or 0.0)
        for spans in traces.values()
        for s in spans
        if s.get("name") == "param_apply"
    )

    # -- on-demand profiler captures ----------------------------------------
    # each capture gets an ingested one-line verdict (device busy/idle and
    # the dominant op via sheeprl_tpu_torch.prof), not just a path the reader has
    # to open in XProf to learn anything from
    profile_dirs = sorted(
        {
            str(rec.get("trace_dir"))
            for rec in events
            if rec.get("event") == "trace" and rec.get("action") == "started" and rec.get("trace_dir")
        }
    )
    profiles = [_profile_verdict(p) for p in profile_dirs]

    path_traces = [v for v in views if v["kind"] in ("round", "request")]
    slowest = sorted(path_traces, key=lambda v: -v["duration_ms"])[: max(0, int(top_k))]
    report: Dict[str, Any] = {
        "log_dir": str(log_dir),
        "streams": streams,
        "traces": len(traces),
        "kinds": dict(sorted(kinds.items())),
        "anchored": anchored,
        "complete": complete,
        "completeness": {
            kind: round(complete[kind] / anchored[kind], 4) if anchored[kind] else None
            for kind in ("round", "request")
        },
        "stages": stages,
        "param_apply_lag": {
            "count": len(lags),
            "p50_ms": round(_percentile(lags, 0.50), 4),
            "p95_ms": round(_percentile(lags, 0.95), 4),
        }
        if lags
        else None,
        "top": slowest,
        "profiles": profiles,
    }
    # roster check: the run's saved config says which streams SHOULD exist
    run_cfg = None
    if (log_dir / "config.yaml").is_file():
        try:
            from ..config import load_config_file

            run_cfg = load_config_file(log_dir / "config.yaml")
        except Exception:
            run_cfg = None
    report["missing_streams"] = missing_streams(run_cfg, [s["name"] for s in streams])
    if trace_id is not None:
        match = next((v for v in views if v["trace_id"].startswith(str(trace_id))), None)
        if match is not None:
            # a COPY: `match` may also sit in report["top"], which must not
            # grow the raw span dump
            report["trace"] = dict(match)
            report["trace"]["events"] = list(traces.get(match["trace_id"], []))
        else:
            report["trace"] = None
    return report


# -- rendering ---------------------------------------------------------------
def _fmt_path(path: List[Dict[str, Any]]) -> str:
    parts = []
    for entry in path:
        gap = entry.get("gap_ms")
        if gap is not None and gap >= 0.05:
            parts.append(f"({gap:.1f}ms gap)")
        parts.append(f"{entry['role']}/{entry['stage']} {entry['dur_ms']:.1f}ms")
    return " -> ".join(parts)


def render_text(report: Dict[str, Any]) -> str:
    lines = [f"trace report — {report['log_dir']}"]
    for s in report["streams"]:
        note = f", clock offset {s['clock_offset_s']:+.3f}s" if s["clock_offset_s"] else ""
        err = f", {s['parse_errors']} torn line(s)" if s["parse_errors"] else ""
        lines.append(f"  stream {s['name']}: {s['events']} events{note}{err}")
    for miss in report.get("missing_streams") or []:
        lines.append(f"  stream {miss['stream']}: MISSING — {miss['why']}")
    kinds = ", ".join(f"{n} {k}" for k, n in report["kinds"].items()) or "none"
    lines.append(f"  traces: {report['traces']} ({kinds})")
    for kind in ("round", "request"):
        anchored = report["anchored"][kind]
        if anchored:
            frac = report["completeness"][kind]
            lines.append(
                f"  {kind} paths: {report['complete'][kind]}/{anchored} "
                f"reconstructed cross-process ({frac:.1%})"
            )
    if report.get("stages"):
        lines.append("\n  stage latency (ms):")
        lines.append(f"    {'role/stage':<28} {'count':>7} {'p50':>9} {'p95':>9}")
        for name, row in report["stages"].items():
            lines.append(
                f"    {name:<28} {row['count']:>7} {row['p50_ms']:>9.2f} {row['p95_ms']:>9.2f}"
            )
    lag = report.get("param_apply_lag")
    if lag:
        lines.append(
            f"\n  publish→param-apply lag: p50 {lag['p50_ms']:.1f}ms "
            f"p95 {lag['p95_ms']:.1f}ms over {lag['count']} application(s)"
        )
    if report.get("top"):
        lines.append(f"\n  top {len(report['top'])} slowest traces:")
        for i, v in enumerate(report["top"], 1):
            lines.append(
                f"   {i}. {v['trace_id'][:12]} [{v['kind']}] {v['duration_ms']:.1f}ms: "
                + _fmt_path(v["path"])
            )
    if report.get("profiles"):
        lines.append("\n  profiler captures (`sheeprl_tpu_torch prof capture=<dir>` for the full table):")
        for p in report["profiles"]:
            if isinstance(p, str):  # pre-ingestion report loaded from JSON
                lines.append(f"    {p}")
                continue
            lines.append(f"    {p['dir']}")
            if p.get("error"):
                lines.append(f"      (not ingestable here: {p['error']})")
                continue
            verdict = f"      device busy {p.get('device_busy_us', 0) / 1e3:.1f}ms"
            if p.get("device_idle_frac") is not None:
                verdict += f", idle {100.0 * p['device_idle_frac']:.1f}%"
            if p.get("top_op"):
                verdict += f"; top op {p['top_op']} ({100.0 * (p.get('top_op_frac') or 0):.0f}%"
                if p.get("top_scope"):
                    verdict += f", scope {p['top_scope']}"
                verdict += ")"
            lines.append(verdict)
    trace = report.get("trace")
    if trace is not None:
        lines.append(f"\n  trace {trace['trace_id']} [{trace['kind']}] {trace['duration_ms']:.1f}ms:")
        lines.append("    " + _fmt_path(trace["path"]))
    elif "trace" in report:
        lines.append("\n  (no trace matched the requested trace_id)")
    return "\n".join(lines)


# -- CLI ---------------------------------------------------------------------
def parse_trace_argv(argv: Sequence[str]) -> Tuple[str, Dict[str, Any]]:
    import yaml

    run_dir: Optional[str] = None
    opts: Dict[str, Any] = {
        "json": False,
        "trace_id": None,
        "top_k": DEFAULT_TOP_K,
        "skew_min_s": None,
    }
    for a in argv:
        if a == "--json":
            opts["json"] = True
        elif a.startswith("run_dir="):
            run_dir = a.split("=", 1)[1]
        elif a.startswith("trace_id="):
            opts["trace_id"] = a.split("=", 1)[1]
        elif a.startswith("top_k="):
            opts["top_k"] = int(a.split("=", 1)[1])
        elif a.startswith("skew_min_s="):
            opts["skew_min_s"] = float(a.split("=", 1)[1])
        elif a.startswith("json="):
            opts["json"] = bool(yaml.safe_load(a.split("=", 1)[1]))
        elif run_dir is None and "=" not in a:
            run_dir = a
        else:
            raise ValueError(f"Unknown trace argument '{a}'")
    if run_dir is None:
        raise ValueError(
            "trace requires `run_dir=<logs/runs/.../version_N>` (a run log dir "
            "holding telemetry.jsonl and/or workers/, replicas/, gateway/ streams)"
        )
    return run_dir, opts


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    run_dir, opts = parse_trace_argv(argv)
    from .doctor import _load_diag_cfg, _resolve_log_dir

    skew_min_s = opts["skew_min_s"]
    if skew_min_s is None:
        cfg = _load_diag_cfg()
        skew_min_s = DEFAULT_SKEW_MIN_S
        if cfg is not None and hasattr(cfg, "select"):
            skew_min_s = float(cfg.select("diag.trace.skew_min_s", DEFAULT_SKEW_MIN_S) or DEFAULT_SKEW_MIN_S)
    report = analyze(
        _resolve_log_dir(Path(run_dir)),
        trace_id=opts["trace_id"],
        top_k=opts["top_k"],
        skew_min_s=skew_min_s,
    )
    if opts["json"]:
        print(json.dumps(report, indent=1, default=str))
    else:
        print(render_text(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
