"""`sheeprl_tpu_torch top` — watch a run live, in place.

The online companion of ``doctor``/``trace``: instead of a post-mortem over
the run's JSONL files, ``top`` renders the :class:`LiveAggregator`'s
current snapshot — windowed per-role/per-stage rollups, the current
**binding stage** (the same attribution the offline ``trace`` verdict
makes) and any firing SLO burn alerts — refreshing in place.

Where the snapshot comes from, in order:

1. **live endpoint** — the facade drops ``<log_dir>/live.json`` next to
   ``telemetry.jsonl`` when its Prometheus server is up; ``top`` polls the
   ``GET /live`` URL inside it. This is the real live path: it sees every
   relayed stream (fleet workers incl. remote ones, replicas, brokerd).
2. **offline fallback** — no live endpoint (run finished, or Prometheus
   export off): the run's streams are merged the way ``trace`` does and the
   tail of the window is aggregated locally. Same table, just not live.

Usage::

    sheeprl_tpu_torch top run_dir=logs/runs/... [refresh_s=2] [once=true] [json=true]

The port's copy of ``sheeprl_tpu/diag/live.py`` (it imports neither package).
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

__all__ = ["fetch_snapshot", "main", "offline_snapshot", "parse_top_argv", "render_snapshot"]

_CLEAR = "\x1b[2J\x1b[H"  # clear screen + home


def _read_live_discovery(log_dir: Path) -> Optional[Dict[str, Any]]:
    path = Path(log_dir) / "live.json"
    try:
        with open(path) as fh:
            info = json.load(fh)
        return info if isinstance(info, dict) and info.get("url") else None
    except (OSError, ValueError):
        return None


def fetch_snapshot(url: str, timeout_s: float = 3.0) -> Optional[Dict[str, Any]]:
    """One GET /live poll; None when the endpoint is unreachable."""
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            body = resp.read()
        snap = json.loads(body.decode())
        return snap if isinstance(snap, dict) else None
    except Exception:
        return None


def offline_snapshot(log_dir: Path, cfg: Any = None, window_s: Optional[float] = None) -> Dict[str, Any]:
    """Aggregate the tail of the run's merged streams into the same
    snapshot shape /live serves — the fallback when no endpoint is up."""
    from .aggregator import LiveAggregator
    from .trace import merge_streams

    agg = LiveAggregator(cfg)
    if window_s is not None:
        agg.window_s = float(window_s)
    events, _streams = merge_streams(log_dir)
    # the aggregator windows on ARRIVAL time; replay only the tail of the
    # run so a long run's early events don't blow the event cap first
    tail = [r for r in events if isinstance(r, dict)]
    t_last = max((float(r.get("t") or r.get("t_end") or 0.0) for r in tail), default=0.0)
    horizon = t_last - agg.window_s if t_last else 0.0
    for rec in tail:
        t = float(rec.get("t") or rec.get("t_end") or 0.0)
        if t and t < horizon:
            continue
        agg.ingest(rec, stream=str(rec.get("_stream") or "main"))
    snap = agg.snapshot()
    snap["source"] = "offline"
    return snap


def render_snapshot(snap: Dict[str, Any]) -> str:
    """The rollup table + binding stage + active alerts, as plain text."""
    lines = []
    src = snap.get("source") or "live"
    head = (
        f"sheeprl_tpu_torch top [{src}]  window {snap.get('window_s', '?')}s  "
        f"events {snap.get('events_in_window', 0)}"
    )
    sps = snap.get("sps")
    mfu = snap.get("mfu")
    retraces = snap.get("retraces")
    vitals = []
    if sps is not None:
        vitals.append(f"SPS {sps:,.0f}" if isinstance(sps, (int, float)) else f"SPS {sps}")
    if mfu is not None:
        vitals.append(f"MFU {100.0 * float(mfu):.1f}%")
    if retraces is not None:
        vitals.append(f"retraces {retraces}")
    lines.append(head + ("  |  " + "  ".join(vitals) if vitals else ""))

    binding = snap.get("binding_stage")
    lines.append(f"binding stage: {binding or '(no spans in window)'}")

    alerts = snap.get("alerts") or []
    if alerts:
        lines.append(f"\n{len(alerts)} ALERT(S) FIRING:")
        for a in alerts:
            lines.append(
                f"  [{a.get('severity', 'warning').upper()}] {a.get('name')}: "
                f"{a.get('metric')} = {a.get('value')} "
                f"(burn {100.0 * float(a.get('burn') or 0):.0f}% of window)"
            )
    slo = snap.get("slo") or []
    if slo and not alerts:
        lines.append(f"SLO: {len(slo)} rule(s), none firing")

    streams = snap.get("streams") or {}
    if streams:
        lines.append(
            "\nstreams: "
            + "  ".join(f"{name}:{count}" for name, count in sorted(streams.items()))
        )
    relay = snap.get("relay") or {}
    if relay.get("streams"):
        lines.append(
            f"relay: {int(relay.get('sent') or 0)} sent, "
            f"{int(relay.get('dropped') or 0)} dropped "
            f"across {len(relay['streams'])} stream(s)"
        )
    invalid = snap.get("invalid_events")
    if invalid:
        lines.append(f"quarantined: {invalid} invalid relayed event(s)")

    stages = snap.get("stages") or {}
    if stages:
        lines.append("\n  {:<28} {:>7} {:>10} {:>10} {:>12}".format(
            "stage", "count", "p50 ms", "p95 ms", "total ms"))
        for name, row in sorted(
            stages.items(), key=lambda kv: -float(kv[1].get("total_ms") or 0)
        ):
            lines.append("  {:<28} {:>7} {:>10} {:>10} {:>12}".format(
                name[:28], row.get("count", 0),
                row.get("p50_ms", 0), row.get("p95_ms", 0), row.get("total_ms", 0)))
    lag = snap.get("param_apply_lag_ms")
    if lag:
        lines.append(
            f"\npublish→apply lag: p50 {lag.get('p50')}ms  p95 {lag.get('p95')}ms "
            f"({lag.get('count')} applies)"
        )
    memory = snap.get("memory") or {}
    if memory.get("streams"):
        lines.append("\n  {:<20} {:>10} {:>10} {:>10} {:>10}".format(
            "process", "rss MiB", "rss peak", "hbm MiB", "hbm peak"))
        for name, row in sorted(memory["streams"].items()):
            def _mib(key: str) -> str:
                val = row.get(key)
                return f"{int(val) >> 20}" if val else "-"
            lines.append("  {:<20} {:>10} {:>10} {:>10} {:>10}".format(
                name[:20], _mib("rss_bytes"), _mib("rss_peak_bytes"),
                _mib("hbm_bytes_in_use"), _mib("hbm_peak_bytes")))
        high = memory.get("high_water") or {}
        if high:
            lines.append("  high-water: " + "  ".join(
                f"{role} rss={int(hw.get('rss_bytes') or 0) >> 20}MiB"
                + (f" hbm={int(hw['hbm_bytes']) >> 20}MiB" if hw.get("hbm_bytes") else "")
                for role, hw in sorted(high.items())))
    for role in ("fleet", "gateway", "broker", "overlap"):
        row = snap.get(role)
        if row:
            lines.append(f"{role}: " + "  ".join(f"{k}={v}" for k, v in sorted(row.items())))
    return "\n".join(lines)


# -- CLI ---------------------------------------------------------------------
def parse_top_argv(argv: Sequence[str]) -> Tuple[str, Dict[str, Any]]:
    import yaml

    run_dir: Optional[str] = None
    opts: Dict[str, Any] = {"refresh_s": 2.0, "once": False, "json": False}
    for a in argv:
        if a == "--json":
            opts["json"] = True
        elif a == "--once":
            opts["once"] = True
        elif a.startswith("run_dir="):
            run_dir = a.split("=", 1)[1]
        elif a.startswith("refresh_s="):
            opts["refresh_s"] = float(yaml.safe_load(a.split("=", 1)[1]))
        elif a.startswith("once="):
            opts["once"] = bool(yaml.safe_load(a.split("=", 1)[1]))
        elif a.startswith("json="):
            opts["json"] = bool(yaml.safe_load(a.split("=", 1)[1]))
        elif run_dir is None and "=" not in a:
            run_dir = a
        else:
            raise ValueError(f"Unknown top argument '{a}'")
    if run_dir is None:
        raise ValueError(
            "top requires `run_dir=<logs/runs/.../version_N>` (the dir holding "
            "telemetry.jsonl / live.json)"
        )
    return run_dir, opts


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .doctor import _load_diag_cfg, _resolve_log_dir

    argv = list(argv if argv is not None else sys.argv[1:])
    run_dir, opts = parse_top_argv(argv)
    log_dir = _resolve_log_dir(Path(run_dir))
    cfg = _load_diag_cfg(None)
    try:
        while True:
            info = _read_live_discovery(log_dir)
            snap = fetch_snapshot(str(info["url"])) if info else None
            if snap is not None:
                snap.setdefault("source", "live")
            else:
                snap = offline_snapshot(log_dir, cfg)
            if opts["json"]:
                print(json.dumps(snap, indent=1, default=str))
            else:
                if not opts["once"]:
                    sys.stdout.write(_CLEAR)
                print(render_snapshot(snap))
                sys.stdout.flush()
            if opts["once"] or opts["json"]:
                return 0
            time.sleep(max(0.2, float(opts["refresh_s"])))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
