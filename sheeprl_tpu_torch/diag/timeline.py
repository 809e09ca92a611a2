"""Flight-recorder analysis, part 1: stream `telemetry.jsonl` back into a
per-run timeline.

`iter_events` reads a (possibly rotated) JSONL stream in true chronological
order: the size-bounded `JsonlSink` rolls `telemetry.jsonl` to
`telemetry.jsonl.1`, `.2`, … (monotonic — lower index is OLDER), so a
week-long run is read `.1 → .2 → … → live file` with no special casing by
the caller. Unparseable lines are counted, not fatal: a run killed mid-write
leaves a torn last line and the doctor must still read everything before it.

`Timeline` is the reconstructed run: events bucketed by type plus the
derived per-step series the detectors in `findings.py` consume (SPS/MFU
trajectory, retrace deltas per interval with their shape-change attribution,
overlap stall accounting, checkpoint write costs, watchdog / preemption
incidents).

The port's copy of ``sheeprl_tpu/diag/timeline.py`` (it imports neither package).
"""
from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["iter_events", "rotated_segments", "Timeline"]

_ROT_RE = re.compile(r"\.(\d+)$")


def rotated_segments(path: Path) -> List[Path]:
    """All segments of a rotated JSONL stream, oldest first, live file last.

    The sink's rotation index is monotonic (`telemetry.jsonl.1` is the first
    segment ever rotated out), so numeric ascending order IS chronological
    order.
    """
    path = Path(path)
    out: List[Tuple[int, Path]] = []
    parent = path.parent if path.parent != Path("") else Path(".")
    if parent.is_dir():
        for cand in parent.glob(path.name + ".*"):
            m = _ROT_RE.search(cand.name)
            if m and cand.name == f"{path.name}.{m.group(1)}":
                out.append((int(m.group(1)), cand))
    segments = [p for _, p in sorted(out)]
    if path.is_file():
        segments.append(path)
    return segments


def _read_jsonl(fh: Any, name: str, errors: Optional[List[str]]) -> Iterator[Dict[str, Any]]:
    for i, line in enumerate(fh, 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as err:
            if errors is not None:
                errors.append(f"{name}:{i}: {err}")
            continue
        if isinstance(rec, dict):
            yield rec


def iter_events(path: Any, errors: Optional[List[str]] = None) -> Iterator[Dict[str, Any]]:
    """Yield every JSON event across all rotated segments, in order. Lines
    that fail to parse are recorded into `errors` (when given) and skipped.

    Safe against a LIVE run rotating mid-read: the live file's fd is opened
    *before* the segment listing, so if the sink renames it while earlier
    segments are being read, the held fd still reads that full segment (a
    rename never detaches an open fd) and it is read last — chronologically
    correct, since it was the newest. A rotated segment that matches the held
    fd's inode is skipped instead of being read twice. Events written to the
    fresh post-rotation live file simply fall outside this snapshot.
    """
    path = Path(path)
    live_fh = None
    live_key: Optional[Tuple[int, int]] = None
    try:
        live_fh = open(path)
        st = os.fstat(live_fh.fileno())
        live_key = (st.st_dev, st.st_ino)
    except OSError:
        live_fh = None
    try:
        for segment in rotated_segments(path):
            if segment == path:
                continue  # the live file is read from the held fd below
            try:
                fh = open(segment)
            except OSError:
                continue  # pruned between listing and open
            with fh:
                try:
                    seg_st = os.fstat(fh.fileno())
                    if live_key is not None and (seg_st.st_dev, seg_st.st_ino) == live_key:
                        continue  # our live fd, renamed after we opened it
                except OSError:
                    pass
                yield from _read_jsonl(fh, segment.name, errors)
        if live_fh is not None:
            yield from _read_jsonl(live_fh, path.name, errors)
    finally:
        if live_fh is not None:
            live_fh.close()


# the `log` fields the detectors / report actually consume — everything else
# (per-interval metrics/spans/memory dicts, the bulk of a stream's bytes) is
# dropped at ingestion so a week-long rotated stream never has to fit in
# memory as full python dicts
_LOG_KEEP = ("event", "step", "t", "sps", "interval_steps", "interval_seconds")
_LOG_XLA_KEEP = (
    "retraces",
    "retrace_attribution",
    "compile_count",
    "compile_seconds",
    "compiles_in_interval",
    "cache_hits",
    "cache_misses",
    "compile_breakdown",
)


def _slim_log(rec: Dict[str, Any]) -> Dict[str, Any]:
    slim = {k: rec[k] for k in _LOG_KEEP if k in rec}
    xla = rec.get("xla")
    if isinstance(xla, dict):
        slim["xla"] = {k: xla[k] for k in _LOG_XLA_KEEP if k in xla}
    tp = rec.get("throughput")
    if isinstance(tp, dict) and tp.get("mfu") is not None:
        slim["throughput"] = {"mfu": tp["mfu"]}
    return slim


class Timeline:
    """One run's reconstructed event timeline + derived series.

    Ingestion is streaming-friendly: high-volume ``log`` events are slimmed
    to the fields the detectors consume, every event only bumps a per-type
    counter plus the running step high-water, and nothing retains the raw
    line — ``doctor`` over a multi-GB rotated stream stays proportional to
    the number of log intervals, not the stream size.
    """

    def __init__(self, events: Optional[List[Dict[str, Any]]] = None) -> None:
        self.by_type: Dict[str, List[Dict[str, Any]]] = {}
        self.counts: Dict[str, int] = {}
        self.parse_errors: List[str] = []
        self._last_step = 0
        for rec in events or []:
            self.add(rec)

    @classmethod
    def from_path(cls, path: Any) -> "Timeline":
        tl = cls()
        for rec in iter_events(path, errors=tl.parse_errors):
            tl.add(rec)
        return tl

    def add(self, rec: Dict[str, Any]) -> None:
        event = str(rec.get("event"))
        self.counts[event] = self.counts.get(event, 0) + 1
        step = rec.get("step")
        # trace_span steps are per-process production counters (a fleet
        # worker's lifetime count runs AHEAD of the learner's acked step),
        # not the run's policy-step axis — they must not move the high-water
        if event != "trace_span" and isinstance(step, (int, float)) and not isinstance(step, bool):
            self._last_step = max(self._last_step, int(step))
        if event == "log":
            rec = _slim_log(rec)
        self.by_type.setdefault(event, []).append(rec)

    def __len__(self) -> int:
        return sum(self.counts.values())

    def of(self, event: str) -> List[Dict[str, Any]]:
        return self.by_type.get(event, [])

    # -- run identity -------------------------------------------------------
    @property
    def startup(self) -> Optional[Dict[str, Any]]:
        recs = self.of("startup")
        return recs[0] if recs else None

    @property
    def shutdown(self) -> Optional[Dict[str, Any]]:
        recs = self.of("shutdown")
        return recs[-1] if recs else None

    @property
    def last_step(self) -> int:
        return self._last_step

    # -- derived series -----------------------------------------------------
    def sps_series(self) -> List[Tuple[int, float]]:
        """(step, sps) per log interval, skipping empty intervals. A
        step-less record (the sink writes schema-invalid events rather than
        drop them) is skipped, never a crash — broken streams are exactly
        what the doctor triages."""
        out = []
        for rec in self.of("log"):
            sps = rec.get("sps")
            if sps is not None and rec.get("step") is not None and float(rec.get("interval_steps") or 0) > 0:
                out.append((int(rec["step"]), float(sps)))
        return out

    def mfu_series(self) -> List[Tuple[int, float]]:
        out = []
        for rec in self.of("log"):
            tp = rec.get("throughput") or {}
            if tp.get("mfu") is not None and rec.get("step") is not None:
                out.append((int(rec["step"]), float(tp["mfu"])))
        return out

    def retrace_intervals(self) -> List[Tuple[int, int, List[str]]]:
        """(step, retraces-so-far, new attribution strings) per log interval
        — `xla.retraces` is cumulative since run start, the attribution list
        only carries the NEW entries of that interval."""
        out = []
        for rec in self.of("log"):
            xla = rec.get("xla") or {}
            if xla.get("retraces") is None:
                continue
            out.append(
                (
                    int(rec.get("step") or 0),
                    int(xla["retraces"]),
                    list(xla.get("retrace_attribution") or []),
                )
            )
        return out

    def total_retraces(self) -> int:
        series = self.retrace_intervals()
        best = max((r for _, r, _ in series), default=0)
        shd = self.shutdown
        if shd:
            best = max(best, int((shd.get("xla") or {}).get("retraces") or 0))
        return best

    def retrace_attribution(self) -> List[str]:
        out: List[str] = []
        for _, _, attr in self.retrace_intervals():
            out.extend(attr)
        return out

    def rss_series(self, role: Optional[str] = None) -> List[Tuple[float, int]]:
        """(t, rss_bytes) from the cadenced ``mem`` stream, ordered by time.
        ``role=None`` keeps every sampler's points (single-process runs have
        exactly one role anyway); the leak detector filters per role so one
        process's growth is never masked by another's churn."""
        out = []
        for rec in self.of("mem"):
            if role is not None and rec.get("role") != role:
                continue
            if rec.get("t") is not None and rec.get("rss_bytes") is not None:
                out.append((float(rec["t"]), int(rec["rss_bytes"])))
        out.sort(key=lambda p: p[0])
        return out

    def mem_roles(self) -> List[str]:
        return sorted({str(rec.get("role") or "") for rec in self.of("mem")} - {""})

    def hbm_high_water(self) -> Tuple[int, int]:
        """(max device high-water bytes, bytes_limit) over every ``mem``
        sample — (0, 0) on CPU-only streams where the device fields are
        absent."""
        peak = limit = 0
        for rec in self.of("mem"):
            peak = max(peak, int(rec.get("hbm_peak_bytes") or rec.get("hbm_bytes_in_use") or 0))
            limit = max(limit, int(rec.get("hbm_bytes_limit") or 0))
        return peak, limit

    def compile_summary(self) -> Dict[str, Any]:
        """Run-total compile accounting from the LAST log interval (the
        xla fields are run-cumulative deltas): compile count/seconds,
        persistent-cache hits/misses, and the per-function breakdown with
        the worst offenders first."""
        last: Dict[str, Any] = {}
        for rec in self.of("log"):
            if isinstance(rec.get("xla"), dict):
                last = rec["xla"]
        out: Dict[str, Any] = {}
        for src, dst in (
            ("compile_count", "compiles"),
            ("compile_seconds", "compile_seconds"),
            ("cache_hits", "cache_hits"),
            ("cache_misses", "cache_misses"),
        ):
            if last.get(src) is not None:
                out[dst] = last[src]
        breakdown = last.get("compile_breakdown")
        if isinstance(breakdown, dict) and breakdown:
            out["breakdown"] = dict(
                sorted(
                    breakdown.items(),
                    key=lambda kv: -float((kv[1] or {}).get("seconds") or 0.0),
                )
            )
        return out

    def rooflines(self) -> Dict[str, Dict[str, Any]]:
        """Latest ``roofline`` verdict per jitted-fn name (later emits carry
        the measured call rate, so last-wins is the most informed one)."""
        out: Dict[str, Dict[str, Any]] = {}
        for rec in self.of("roofline"):
            name = rec.get("fn")
            if name:
                out[str(name)] = rec
        return out

    def overlap_stalls(self) -> List[Tuple[int, float]]:
        """(step, player_stall_frac) per overlap interval that did real work."""
        out = []
        for rec in self.of("overlap"):
            frac = rec.get("player_stall_frac")
            busy = float(rec.get("player_busy_s") or 0.0)
            stall = float(rec.get("player_stall_s") or 0.0)
            if frac is not None and (busy + stall) > 0:
                out.append((int(rec.get("step") or 0), float(frac)))
        return out

    def ckpt_blocks(self) -> List[Tuple[int, float]]:
        """(step, block_ms) — ONE entry per save. An async save emits two
        events (`enqueued` with the real train-thread block, then `written`
        with block_ms=0), a sync save only `written`; counting both sides of
        an async pair would halve the reported spike rate."""
        out = []
        for rec in self.of("ckpt_async"):
            if rec.get("block_ms") is None:
                continue
            action = rec.get("action")
            if action == "enqueued" or (action == "written" and rec.get("mode") == "sync"):
                out.append((int(rec.get("step") or 0), float(rec["block_ms"])))
        return out

    def watchdog_incidents(self) -> List[Dict[str, Any]]:
        return [rec for rec in self.of("watchdog") if rec.get("action") == "stall"]

    def preempt_events(self) -> List[Dict[str, Any]]:
        return self.of("preempt")
