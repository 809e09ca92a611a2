"""`sheeprl_tpu_torch doctor run_dir=...` — triage a run in seconds.

Reads everything a run leaves behind — the (rotated) telemetry JSONL stream,
the resume manifest and the checkpoint directory — reconstructs the timeline,
runs the rule-based detectors and prints a ranked report with remediation
hints. `--json` (or `json=true`) emits the same report as one JSON object
for dashboards/CI.

A copy of ``sheeprl_tpu/diag/doctor.py`` with one departure: the JAX
package's `bench_dir=<dir>` folds its bench regression gate over
`BENCH_*.json` (TPU runs of the JAX package) into the report; the port has no
benchmark of its own yet, so `bench_dir=` is refused with a message.

Exit code: 0 by default; with `strict=true` (CI mode) a critical finding
exits 1.
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .findings import Finding, run_detectors
from .timeline import Timeline, rotated_segments

__all__ = ["diagnose", "render_text", "main"]

_SEV_GLYPH = {"critical": "[CRIT]", "warning": "[WARN]", "info": "[info]"}


def _load_diag_cfg(cfg: Any = None) -> Any:
    """Ensure a config with a `diag` node: the caller's (run) config when it
    has one, else the packaged `configs/diag/default.yaml` defaults."""
    if cfg is not None and hasattr(cfg, "select") and cfg.select("diag") is not None:
        return cfg
    try:
        from ..config import Config, load_config_file
        from ..config.compose import CONFIG_ROOT

        node = load_config_file(CONFIG_ROOT / "diag" / "default.yaml")
        return Config({"diag": node.to_dict() if hasattr(node, "to_dict") else dict(node)})
    except Exception:
        return cfg


def _resolve_log_dir(run_dir: Path) -> Path:
    """Accept a version_N log dir, the run base dir above it, or any dir that
    directly holds a telemetry.jsonl (synthetic fixtures, copied logs)."""
    run_dir = Path(run_dir)
    if (run_dir / "telemetry.jsonl").is_file() or rotated_segments(run_dir / "telemetry.jsonl"):
        return run_dir
    try:
        from ..resilience.resume import resolve_version_dir

        return resolve_version_dir(run_dir)
    except FileNotFoundError:
        return run_dir


def _ckpt_summary(log_dir: Path) -> Dict[str, Any]:
    try:
        from ..utils.checkpoint import CheckpointManager

        ckpts = CheckpointManager(str(log_dir), enabled=False).list_checkpoints()
    except Exception:
        ckpts = []
    out: Dict[str, Any] = {"count": len(ckpts)}
    if ckpts:
        out["newest"] = str(ckpts[-1])
        try:
            out["newest_step"] = int(ckpts[-1].stem.split("_")[1])
        except (IndexError, ValueError):
            pass
    return out


def _throughput_summary(tl: Timeline) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    sps = [v for _, v in tl.sps_series()]
    if sps:
        out["sps_median"] = round(statistics.median(sps), 4)
        out["sps_last"] = round(sps[-1], 4)
        if len(sps) > 1:  # steady-state: skip the compile/warmup interval
            out["sps_steady_median"] = round(statistics.median(sps[1:]), 4)
    mfu = [v for _, v in tl.mfu_series()]
    if mfu:
        out["mfu_last"] = round(mfu[-1], 4)
    return out


def diagnose(
    run_dir: Any, cfg: Any = None, bench_dir: Optional[Any] = None
) -> Dict[str, Any]:
    """Build the full doctor report for one run directory."""
    if bench_dir is not None:
        raise ValueError(
            "doctor bench_dir=... is not available in the PyTorch port: the bench "
            "gate reads BENCH_*.json trajectories of the JAX package's TPU runs, and "
            "the port has no benchmark of its own yet"
        )
    log_dir = _resolve_log_dir(Path(run_dir))
    if cfg is None and (log_dir / "config.yaml").is_file():
        # the run's SAVED config carries any per-run diag threshold
        # overrides (the `diag` group composes into every run config)
        try:
            from ..config import load_config_file

            cfg = load_config_file(log_dir / "config.yaml")
        except Exception:
            cfg = None
    run_cfg = cfg  # the roster check needs the RUN config, not diag defaults
    cfg = _load_diag_cfg(cfg)
    stream = log_dir / "telemetry.jsonl"
    segments = rotated_segments(stream)
    if not segments:
        raise FileNotFoundError(
            f"No telemetry stream under {log_dir} (expected {stream} or rotated "
            "segments; was the run started with metric.telemetry.jsonl=True?)"
        )
    tl = Timeline.from_path(stream)
    # per-process streams (fleet workers, gateway replicas, the gateway
    # itself): fold their events into the same timeline so the trace-aware
    # detectors (cross_process_stall) see the whole run, not one process
    process_streams: List[str] = []
    from .trace import discover_streams
    from .timeline import iter_events

    for name, sub_path in discover_streams(log_dir):
        if name == "main":
            continue
        try:
            for rec in iter_events(sub_path, errors=tl.parse_errors):
                tl.add(rec)
            process_streams.append(name)
        except Exception as err:
            # an unreadable sub-stream must not cost the whole diagnosis,
            # but it must not vanish silently either
            tl.parse_errors.append(f"{name}: stream unreadable ({err})")
    findings = run_detectors(tl, cfg)

    # roster check: streams the run config promises but the run dir lacks —
    # a worker/replica that died before its first write, or telemetry
    # silently misconfigured, must not read as "the run looks fine"
    from .trace import missing_streams

    miss = missing_streams(run_cfg, ["main"] + process_streams)
    if miss:
        findings.append(
            Finding(
                code="missing_stream",
                severity="warning",
                title=f"{len(miss)} expected telemetry stream(s) never appeared",
                detail="; ".join(f"{m['stream']} ({m['why']})" for m in miss),
                remediation=(
                    "Check the process's stderr/exit status — a stream that never "
                    "opened usually means the process died before its first write. "
                    "Remote workers stream via the relay only; list their slots in "
                    "fleet.net.remote_workers so the roster expects no local file."
                ),
                data={"missing": miss},
            )
        )

    from ..resilience.resume import read_manifest

    report: Dict[str, Any] = {
        "run_dir": str(run_dir),
        "log_dir": str(log_dir),
        "stream_segments": [str(p) for p in segments],
        "process_streams": process_streams,
        "events": dict(sorted(tl.counts.items())),
        "parse_errors": len(tl.parse_errors),
        "startup": tl.startup,
        "last_step": tl.last_step,
        "clean_shutdown": tl.shutdown is not None,
        "throughput": _throughput_summary(tl),
        "compile": tl.compile_summary(),
        "manifest": read_manifest(log_dir),
        "checkpoints": _ckpt_summary(log_dir),
        "findings": [f.to_dict() for f in findings],
        "healthy": not any(f.severity == "critical" for f in findings),
    }
    return report


# -- rendering ---------------------------------------------------------------
def render_text(report: Dict[str, Any]) -> str:
    lines: List[str] = []
    startup = report.get("startup") or {}
    head = (
        f"doctor report — {report['log_dir']}\n"
        f"  algo={startup.get('algo') or '?'} platform={startup.get('platform') or '?'} "
        f"device_kind={startup.get('device_kind') or '?'} devices={startup.get('devices') or '?'}"
    )
    lines.append(head)
    tp = report.get("throughput") or {}
    lines.append(
        f"  last step {report['last_step']}; "
        + (
            f"steady SPS {tp['sps_steady_median']}"
            if "sps_steady_median" in tp
            else f"median SPS {tp.get('sps_median', 'n/a')}"
        )
        + (f"; MFU {tp['mfu_last']}" if "mfu_last" in tp else "")
        + ("; clean shutdown" if report.get("clean_shutdown") else "; NO shutdown event")
    )
    ckpt = report.get("checkpoints") or {}
    manifest = report.get("manifest") or {}
    lines.append(
        f"  checkpoints: {ckpt.get('count', 0)}"
        + (f", newest @ step {ckpt['newest_step']}" if "newest_step" in ckpt else "")
        + (f"; manifest @ step {manifest['step']}" if manifest.get("step") is not None else "; no manifest")
    )
    compile_sum = report.get("compile") or {}
    if compile_sum.get("compiles") is not None:
        part = f"  compiles: {compile_sum['compiles']}"
        if compile_sum.get("compile_seconds") is not None:
            part += f" ({compile_sum['compile_seconds']:.1f}s)"
        if compile_sum.get("cache_hits") is not None or compile_sum.get("cache_misses") is not None:
            part += (
                f"; persistent cache {int(compile_sum.get('cache_hits') or 0)} hit(s) / "
                f"{int(compile_sum.get('cache_misses') or 0)} miss(es)"
            )
        worst = list((compile_sum.get("breakdown") or {}).items())[:3]
        if worst:
            part += "; worst: " + ", ".join(
                f"{tag} {float((row or {}).get('seconds') or 0.0):.1f}s"
                f"×{int((row or {}).get('count') or 0)}"
                for tag, row in worst
            )
        lines.append(part)
    if len(report.get("stream_segments", [])) > 1:
        lines.append(f"  stream: {len(report['stream_segments'])} rotated segment(s) read in order")
    if report.get("process_streams"):
        lines.append(
            f"  {len(report['process_streams'])} per-process stream(s) merged: "
            + ", ".join(report["process_streams"])
            + "  (cross-process paths: `sheeprl_tpu_torch trace run_dir=...`)"
        )
    if report.get("parse_errors"):
        lines.append(f"  {report['parse_errors']} unparseable line(s) skipped (torn tail?)")

    findings = report.get("findings") or []
    if not findings:
        lines.append("\nNo findings — the run looks healthy.")
    else:
        lines.append(f"\n{len(findings)} finding(s), most severe first:")
        for i, f in enumerate(findings, 1):
            glyph = _SEV_GLYPH.get(f["severity"], f"[{f['severity']}]")
            lines.append(f"\n{i}. {glyph} {f['title']}  (steps {f['step_first']}–{f['step_last']})")
            lines.append(f"   {f['detail']}")
            lines.append(f"   fix: {f['remediation']}")

    lines.append("\nverdict: " + ("HEALTHY" if report.get("healthy") else "NEEDS ATTENTION"))
    return "\n".join(lines)


# -- CLI ---------------------------------------------------------------------
def parse_doctor_argv(argv: Sequence[str]) -> Tuple[str, Dict[str, Any]]:
    import yaml

    run_dir: Optional[str] = None
    opts: Dict[str, Any] = {"json": False, "strict": False, "bench_dir": None}
    for a in argv:
        if a == "--json":
            opts["json"] = True
        elif a == "--strict":
            opts["strict"] = True
        elif a.startswith("run_dir="):
            run_dir = a.split("=", 1)[1]
        elif a.startswith("json="):
            opts["json"] = bool(yaml.safe_load(a.split("=", 1)[1]))
        elif a.startswith("strict="):
            opts["strict"] = bool(yaml.safe_load(a.split("=", 1)[1]))
        elif a.startswith("bench_dir="):
            opts["bench_dir"] = a.split("=", 1)[1]
        elif run_dir is None and "=" not in a:
            run_dir = a  # bare positional path is accepted too
        else:
            raise ValueError(f"Unknown doctor argument '{a}'")
    if run_dir is None:
        raise ValueError(
            "doctor requires `run_dir=<logs/runs/.../version_N>` (a run log dir, "
            "its parent run dir, or any dir holding a telemetry.jsonl)"
        )
    return run_dir, opts


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    run_dir, opts = parse_doctor_argv(argv)
    report = diagnose(run_dir, bench_dir=opts["bench_dir"])
    if opts["json"]:
        print(json.dumps(report, indent=1, default=str))
    else:
        print(render_text(report))
    if opts["strict"] and not report.get("healthy", False):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
