"""`sheeprl_tpu_torch prof run_dir=... [capture=...]` — where the card's time goes.

Discovers every ``torch.profiler`` capture a run produced — the facade's
windowed captures under ``trace/`` (``trace_step<N>.json``),
RemoteProfiler windows on worker streams, watchdog incident dumps — parses
their Chrome-trace JSON (``capture.py``) and prints, per capture window: the
top-K kernels by device time, the device-time share per scope (the
``record_function`` ranges of the port's spans and step ranges), and the
device-idle fraction. The run's ``roofline`` events (compute- vs
memory-bound per tracked fn) are folded into the same report, so one
command answers both "which kernel" and "which resource".

``capture=<dir>`` skips discovery and reports one capture dir directly
(works without a run dir — any dir holding ``trace*.json``). The port's
copy of ``sheeprl_tpu/prof/cli.py``; only the capture glob differs.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .capture import CaptureError, find_trace_files, summarize_capture

__all__ = ["discover_captures", "main", "parse_prof_argv", "prof_report", "render_text"]

DEFAULT_TOP_K = 15


def discover_captures(log_dir: Any) -> List[str]:
    """Every capture dir of a run: the dirs announced on the telemetry
    streams (`trace` events, watchdog incident `trace_dir`s) plus a glob
    for Chrome-trace files under the run dir — announced-but-remote
    dirs that don't exist locally are skipped, local-but-unannounced ones
    (a capture from a crashed window) are still found."""
    log_dir = Path(log_dir)
    dirs: set = set()
    try:
        from ..diag.timeline import iter_events
        from ..diag.trace import discover_streams

        for _name, path in discover_streams(log_dir):
            for rec in iter_events(path):
                if rec.get("event") in ("trace", "watchdog") and rec.get("trace_dir"):
                    trace_dir = Path(str(rec["trace_dir"]))
                    if trace_dir.is_dir():
                        dirs.add(str(trace_dir.resolve()))
    except Exception:
        pass
    try:
        # <capture>/trace*.json — the capture dir (what the announce events
        # name) holds the files; resolve() so announced and globbed
        # spellings dedupe
        for path in find_trace_files(log_dir):
            dirs.add(str(path.parent.resolve()))
    except OSError:
        pass
    return sorted(d for d in dirs if find_trace_files(d))


def _collect_rooflines(log_dir: Any) -> List[Dict[str, Any]]:
    """The latest `roofline` event per fn across every stream of the run
    (later emits carry the measured attained fraction; arrival order is
    the refinement order)."""
    latest: Dict[str, Dict[str, Any]] = {}
    try:
        from ..diag.timeline import iter_events
        from ..diag.trace import discover_streams

        for _name, path in discover_streams(log_dir):
            for rec in iter_events(path):
                if rec.get("event") == "roofline" and rec.get("fn"):
                    latest[str(rec["fn"])] = rec
    except Exception:
        pass
    return [latest[fn] for fn in sorted(latest)]


def prof_report(
    run_dir: Optional[Any] = None,
    capture: Optional[Any] = None,
    top_k: int = DEFAULT_TOP_K,
) -> Dict[str, Any]:
    """The full prof report: per-capture device-time tables + the run's
    roofline verdicts. At least one of run_dir/capture is required."""
    log_dir: Optional[Path] = None
    if run_dir is not None:
        from ..diag.doctor import _resolve_log_dir

        log_dir = _resolve_log_dir(Path(run_dir))
    capture_dirs: List[str]
    if capture is not None:
        capture_dirs = [str(capture)]
    elif log_dir is not None:
        capture_dirs = discover_captures(log_dir)
    else:
        raise ValueError("prof requires run_dir=... and/or capture=...")

    captures: List[Dict[str, Any]] = []
    errors: List[str] = []
    for cap in capture_dirs:
        try:
            captures.append(summarize_capture(cap, top_k=top_k))
        except CaptureError as err:
            errors.append(str(err))

    report: Dict[str, Any] = {
        "log_dir": str(log_dir) if log_dir is not None else None,
        "captures": captures,
        "capture_errors": errors,
        "rooflines": _collect_rooflines(log_dir) if log_dir is not None else [],
    }
    return report


# -- rendering ---------------------------------------------------------------
def _us(v: float) -> str:
    if v >= 1e6:
        return f"{v / 1e6:.2f}s"
    if v >= 1e3:
        return f"{v / 1e3:.2f}ms"
    return f"{v:.1f}us"


def _steps_span(steps: List[int]) -> str:
    if not steps:
        return ""
    if len(steps) == 1:
        return f"step {steps[0]}"
    return f"steps {steps[0]}–{steps[-1]} ({len(steps)} annotated)"


def render_text(report: Dict[str, Any]) -> str:
    lines: List[str] = []
    head = report.get("log_dir") or (
        report["captures"][0]["capture_dir"] if report.get("captures") else "?"
    )
    lines.append(f"prof report — {head}")
    if not report.get("captures"):
        lines.append(
            "  no parseable profiler captures found (captures come from "
            "metric.telemetry.trace_every, RemoteProfiler windows, or watchdog "
            "incidents)"
        )
    for cap in report.get("captures", []):
        lines.append(f"\ncapture {cap['capture_dir']}")
        idle = cap.get("device_idle_frac")
        lines.append(
            f"  {cap['files']} trace file(s), device busy {_us(cap['device_busy_us'])}"
            + (f", idle {idle:.1%}" if idle is not None else "")
            + (f"; {_steps_span(cap['steps'])}" if cap.get("steps") else "")
        )
        for w in cap.get("windows", []):
            widle = w.get("device_idle_frac")
            lines.append(
                f"    window {w['host'] or w['file']}: {_us(w['window_us'])}, "
                f"{w['device_lanes']} device lane(s), busy {_us(w['device_busy_us'])}"
                + (f", idle {widle:.1%}" if widle is not None else "")
            )
        if cap.get("ops"):
            lines.append(f"  top {len(cap['ops'])} of {cap['op_kinds']} op(s) by device time:")
            lines.append(
                f"    {'op':<28} {'category':<22} {'count':>6} {'total':>10} {'share':>7}  scope"
            )
            for row in cap["ops"]:
                lines.append(
                    f"    {row['op']:<28} {row['hlo_module']:<22} {row['count']:>6} "
                    f"{_us(row['total_us']):>10} {row['frac']:>7.1%}  {row['scope'] or '-'}"
                )
        if cap.get("scopes"):
            lines.append("  device share by scope:")
            for name, row in cap["scopes"].items():
                lines.append(f"    {name:<28} {_us(row['device_us']):>10} {row['frac']:>7.1%}")
    for err in report.get("capture_errors", []):
        lines.append(f"\n  [WARN] {err}")
    rooflines = report.get("rooflines") or []
    if rooflines:
        lines.append("\nroofline verdicts (latest per tracked fn):")
        for r in rooflines:
            verdict = f"{r.get('bound', 'unknown')}-bound"
            part = (
                f"  {r['fn']}: intensity {float(r['intensity']):.2f} flop/B"
            )
            if r.get("ridge_intensity") is not None:
                part += f" (ridge {float(r['ridge_intensity']):.2f})"
            part += f" → {verdict}"
            if r.get("attained_frac") is not None:
                part += f", attained {float(r['attained_frac']):.1%} of roof"
            if r.get("basis"):
                part += f"  [{r['basis']}]"
            lines.append(part)
    elif report.get("log_dir"):
        lines.append(
            "\nno roofline events on the run's streams (rooflines are emitted by "
            "train loops / serving paths that register their lowered fns)"
        )
    return "\n".join(lines)


# -- CLI ---------------------------------------------------------------------
def parse_prof_argv(argv: Sequence[str]) -> Tuple[Optional[str], Dict[str, Any]]:
    import yaml

    run_dir: Optional[str] = None
    opts: Dict[str, Any] = {"json": False, "capture": None, "top_k": DEFAULT_TOP_K}
    for a in argv:
        if a == "--json":
            opts["json"] = True
        elif a.startswith("run_dir="):
            run_dir = a.split("=", 1)[1]
        elif a.startswith("capture="):
            opts["capture"] = a.split("=", 1)[1]
        elif a.startswith("top_k="):
            opts["top_k"] = int(a.split("=", 1)[1])
        elif a.startswith("json="):
            opts["json"] = bool(yaml.safe_load(a.split("=", 1)[1]))
        elif run_dir is None and "=" not in a:
            run_dir = a
        else:
            raise ValueError(f"Unknown prof argument '{a}'")
    if run_dir is None and opts["capture"] is None:
        raise ValueError(
            "prof requires `run_dir=<logs/runs/.../version_N>` (captures + "
            "rooflines discovered from the run's streams) and/or "
            "`capture=<dir>` (one capture dir directly)"
        )
    return run_dir, opts


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    run_dir, opts = parse_prof_argv(argv)
    report = prof_report(run_dir, capture=opts["capture"], top_k=opts["top_k"])
    if opts["json"]:
        print(json.dumps(report, indent=1, default=str))
    else:
        print(render_text(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
