"""Trace-event capture parsing: a ``torch.profiler`` Chrome trace → per-op
device time.

``torch.profiler`` (Kineto) exports one Chrome-trace JSON per capture window
(the facade's ``trace_step<N>.json``, the watchdog's and the remote
profiler's ``trace.json``). Its complete (``ph == "X"``) events fall into
these populations, told apart by their ``cat``:

* **device events** — ``kernel``, ``gpu_memcpy`` and ``gpu_memset``: ``pid``
  is the device (``args.device`` where present), ``tid`` the stream. A
  device's busy time is the union of its intervals over all its streams
  (the player mirror and the staged feed run on streams of their own, so a
  per-stream sum would count their overlap twice); per-op totals are sums.
* **scopes** — ``user_annotation`` ranges on the host threads: the port's
  spans (``telemetry/spans.py``, ``Time/train_time``, ...) and the facade's
  step ranges ``train#<N>``, folded into the scope ``train`` with step
  ``N`` (as ``StepTraceAnnotation`` gives it in the JAX package).
* **launches** — ``cuda_runtime`` / ``cuda_driver`` calls
  (``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cuLaunchKernel``,
  ``cudaMemcpyAsync``, ...), joined to their device event by
  ``args.correlation``.
* **noise** — ``cpu_op``, ``python_function``, the runtime calls, ``ac2g``
  flows, ``Trace`` markers: never device time.

Attribution: a host scope has usually closed before its kernels run on the
card, so a device event is not placed by its own time. It follows its
correlation id to the launch on the host and takes the innermost scope on
the launching thread that encloses the launch. A launch from a thread with
no scope open (autograd runs a CUDA backward on a thread of its own) takes
the innermost scope of the thread whose step range (``train#<N>``) encloses
it, or of the one other thread with a scope open there.

A capture of a CPU run has no device event. Its ops are then the ``cpu_op``
events, counted by self time (their duration less that of the ``cpu_op``
events nested directly in them on the same thread, so nested ops do not
count twice), their lanes are the host threads, and each window names the
platform ``cpu``. The two are never mixed: a file with device events reports
those alone.

Timestamps and durations are microseconds. ``.json.gz`` captures are read
too. The report's fields are those of ``sheeprl_tpu/prof/capture.py``
(``hlo_module`` holds the event's category here), and each window adds its
``platform``.
"""
from __future__ import annotations

import gzip
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "CaptureError",
    "find_trace_files",
    "parse_trace_file",
    "summarize_capture",
]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SCOPE_CAT = "user_annotation"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CPU_OP_CAT = "cpu_op"
_STEP_RANGE = re.compile(r"^(train)#(\d+)$")


class CaptureError(RuntimeError):
    """A capture dir or trace file that cannot be parsed."""


def _is_trace_name(name: str) -> bool:
    base = name[:-3] if name.endswith(".gz") else name
    return base.endswith(".json") and (base.startswith("trace") or base.endswith(".trace.json"))


def find_trace_files(capture_dir: Any) -> List[Path]:
    """Every Chrome-trace JSON under a capture dir (one per window):
    ``trace*.json`` and ``*.trace.json``, compressed or not, in
    deterministic order."""
    base = Path(capture_dir)
    if base.is_file():
        return [base]
    if not base.is_dir():
        return []
    return sorted(p for p in base.rglob("*.json*") if p.is_file() and _is_trace_name(p.name))


def _load_trace_json(path: Path) -> Dict[str, Any]:
    try:
        if str(path).endswith(".gz"):
            with gzip.open(path, "rt") as fh:
                return json.load(fh)
        with open(path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError, EOFError, UnicodeDecodeError) as err:
        raise CaptureError(f"unreadable trace file {path}: {err}") from err


def _merged_busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Total covered time of possibly-overlapping intervals."""
    if not intervals:
        return 0.0
    intervals.sort()
    busy = 0.0
    cur_start, cur_end = intervals[0]
    for start, end in intervals[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return busy + (cur_end - cur_start)


def _self_times(ops: List[Dict[str, Any]]) -> None:
    """Set each host op's ``dur`` to its self time: its duration less that of
    the ops nested directly in it on the same lane."""
    by_lane: Dict[Tuple[int, int], List[Dict[str, Any]]] = {}
    for op in ops:
        by_lane.setdefault(op["lane"], []).append(op)
    for lane_ops in by_lane.values():
        lane_ops.sort(key=lambda o: (o["ts"], -o["dur"]))
        stack: List[Dict[str, Any]] = []
        children = {}
        for op in lane_ops:
            while stack and op["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            if stack:
                children[id(stack[-1])] = children.get(id(stack[-1]), 0.0) + op["dur"]
            stack.append(op)
        for op in lane_ops:
            op["self"] = max(0.0, op["dur"] - children.get(id(op), 0.0))
    for op in ops:
        op["dur"] = op.pop("self")


def parse_trace_file(path: Any) -> Dict[str, Any]:
    """One trace file → op events, scope events and lane metadata.

    Returns ``{path, platform, processes, threads, ops, scopes, launches,
    t_min_us, t_max_us}``: ``ops`` are ``{name, hlo_module, ts, dur, lane,
    device, correlation}`` (``hlo_module`` the event's category, ``device``
    the device or host process), ``scopes`` ``{name, ts, dur, lane,
    step_num?}`` and ``launches`` correlation id → ``{ts, lane}``."""
    path = Path(path)
    doc = _load_trace_json(path)
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(events, list):
        raise CaptureError(f"{path}: no traceEvents array")

    processes: Dict[int, str] = {}
    threads: Dict[Tuple[int, int], str] = {}
    device_ops: List[Dict[str, Any]] = []
    cpu_ops: List[Dict[str, Any]] = []
    scopes: List[Dict[str, Any]] = []
    launches: Dict[int, Dict[str, Any]] = {}
    t_min: Optional[float] = None
    t_max: Optional[float] = None

    for ev in events:
        if not isinstance(ev, dict) or not ev:
            continue
        ph = ev.get("ph")
        args = ev.get("args") or {}
        if ph == "M":
            try:
                if ev.get("name") == "process_name" and "name" in args:
                    processes[int(ev.get("pid", 0))] = str(args["name"])
                elif ev.get("name") == "thread_name" and "name" in args:
                    threads[(int(ev.get("pid", 0)), int(ev.get("tid", 0)))] = str(args["name"])
            except (TypeError, ValueError):
                pass  # Kineto writes string pids for some device lanes
            continue
        if ph != "X":
            continue
        try:
            ts = float(ev["ts"])
            dur = float(ev.get("dur", 0.0))
            lane = (int(ev.get("pid", 0)), int(ev.get("tid", 0)))
        except (KeyError, TypeError, ValueError):
            continue
        t_min = ts if t_min is None else min(t_min, ts)
        t_max = ts + dur if t_max is None else max(t_max, ts + dur)
        cat = str(ev.get("cat", ""))
        name = str(ev.get("name", ""))
        if cat in DEVICE_CATS:
            device_ops.append({"name": name, "hlo_module": cat, "ts": ts, "dur": dur, "lane": lane,
                               "device": int(args.get("device", lane[0])),
                               "correlation": args.get("correlation")})
        elif cat == CPU_OP_CAT:
            cpu_ops.append({"name": name, "hlo_module": cat, "ts": ts, "dur": dur, "lane": lane,
                            "device": lane[0], "correlation": None})
        elif cat == SCOPE_CAT:
            scope: Dict[str, Any] = {"name": name, "ts": ts, "dur": dur, "lane": lane}
            step = _STEP_RANGE.match(name)
            if step is not None:
                scope["name"], scope["step_num"] = step.group(1), int(step.group(2))
            scopes.append(scope)
        elif cat in LAUNCH_CATS and args.get("correlation") is not None:
            try:
                launches[int(args["correlation"])] = {"ts": ts, "lane": lane}
            except (TypeError, ValueError):
                pass

    if device_ops:
        platform, ops = "gpu", device_ops
    else:
        platform, ops = "cpu", cpu_ops
        _self_times(ops)
    return {
        "path": str(path),
        "platform": platform,
        "processes": processes,
        "threads": threads,
        "ops": ops,
        "scopes": scopes,
        "launches": launches,
        "t_min_us": t_min or 0.0,
        "t_max_us": t_max or 0.0,
    }


def _innermost(scopes: List[Dict[str, Any]], t: float) -> Optional[Dict[str, Any]]:
    best: Optional[Dict[str, Any]] = None
    for s in scopes:
        if s["ts"] <= t <= s["ts"] + s["dur"] and (best is None or s["dur"] < best["dur"]):
            best = s
    return best


def _attribute_scope(op: Dict[str, Any], parsed: Dict[str, Any],
                     by_lane: Dict[Tuple[int, int], List[Dict[str, Any]]]) -> str:
    """The scope of one op: a host op's innermost enclosing scope on its own
    thread; a device op's through its launch (see the module docstring)."""
    if parsed["platform"] == "cpu":
        best = _innermost(by_lane.get(op["lane"], []), op["ts"])
        return best["name"] if best is not None else ""
    try:
        launch = parsed["launches"].get(int(op["correlation"]))
    except (TypeError, ValueError):
        launch = None
    if launch is None:
        return ""
    t, lane = launch["ts"], launch["lane"]
    best = _innermost(by_lane.get(lane, []), t)
    if best is not None:
        return best["name"]
    others = {}
    for other, lane_scopes in by_lane.items():
        if other[0] != lane[0] or other == lane:
            continue
        enclosing = [s for s in lane_scopes if s["ts"] <= t <= s["ts"] + s["dur"]]
        if enclosing:
            others[other] = enclosing
    stepped = [o for o, enc in others.items() if any("step_num" in s for s in enc)]
    pick = stepped if stepped else list(others)
    if len(pick) != 1:
        return ""
    return min(others[pick[0]], key=lambda s: s["dur"])["name"]


def summarize_capture(capture_dir: Any, top_k: int = 15) -> Dict[str, Any]:
    """Aggregate every trace file of one capture dir into the report the
    CLI renders: per-op device-time table (scope-attributed), per-scope
    device share, and device-busy/idle fractions per capture window."""
    files = find_trace_files(capture_dir)
    if not files:
        raise CaptureError(f"no trace*.json(.gz) under {capture_dir}")

    op_rows: Dict[Tuple[str, str], Dict[str, Any]] = {}
    scope_us: Dict[str, float] = {}
    windows: List[Dict[str, Any]] = []
    steps: set = set()
    total_busy = 0.0
    total_window = 0.0

    for path in files:
        parsed = parse_trace_file(path)
        by_lane: Dict[Tuple[int, int], List[Dict[str, Any]]] = {}
        for s in parsed["scopes"]:
            by_lane.setdefault(s["lane"], []).append(s)
            if "step_num" in s:
                steps.add(s["step_num"])
        # a device's busy time is the union over its streams; a CPU
        # capture's lanes are its host threads
        lane_of = (lambda op: op["device"]) if parsed["platform"] == "gpu" else (lambda op: op["lane"])
        lane_intervals: Dict[Any, List[Tuple[float, float]]] = {}
        for op in parsed["ops"]:
            lane_intervals.setdefault(lane_of(op), []).append((op["ts"], op["ts"] + op["dur"]))
            scope = _attribute_scope(op, parsed, by_lane)
            row = op_rows.setdefault((op["name"], op["hlo_module"]), {
                "op": op["name"], "hlo_module": op["hlo_module"], "count": 0, "total_us": 0.0, "scopes": {}})
            row["count"] += 1
            row["total_us"] += op["dur"]
            row["scopes"][scope] = row["scopes"].get(scope, 0.0) + op["dur"]
            scope_us[scope] = scope_us.get(scope, 0.0) + op["dur"]

        if parsed["platform"] == "gpu":
            busy = sum(_merged_busy_us(iv) for iv in lane_intervals.values())
        else:  # self times do not overlap on a thread
            busy = sum(op["dur"] for op in parsed["ops"])
        window = max(0.0, parsed["t_max_us"] - parsed["t_min_us"])
        lanes = max(1, len(lane_intervals))
        total_busy += busy
        total_window += window * lanes
        windows.append({
            "file": parsed["path"],
            "host": next(iter(parsed["processes"].values()), ""),
            "platform": parsed["platform"],
            "device_lanes": len(lane_intervals),
            "window_us": round(window, 3),
            "device_busy_us": round(busy, 3),
            "device_idle_frac": round(1.0 - busy / (window * lanes), 4) if window > 0 else None,
        })

    busy_total = sum(r["total_us"] for r in op_rows.values()) or 1.0
    ops = sorted(op_rows.values(), key=lambda r: -r["total_us"])
    table = []
    for row in ops[: max(0, int(top_k))]:
        dominant = max(row["scopes"].items(), key=lambda kv: kv[1])[0] if row["scopes"] else ""
        table.append({
            "op": row["op"],
            "hlo_module": row["hlo_module"],
            "count": row["count"],
            "total_us": round(row["total_us"], 3),
            "frac": round(row["total_us"] / busy_total, 4),
            "scope": dominant,
        })
    scopes_out = {
        (name or "(unscoped)"): {"device_us": round(us, 3), "frac": round(us / busy_total, 4)}
        for name, us in sorted(scope_us.items(), key=lambda kv: -kv[1])
    }
    return {
        "capture_dir": str(capture_dir),
        "files": len(files),
        "windows": windows,
        "device_busy_us": round(total_busy, 3),
        "device_idle_frac": round(1.0 - total_busy / total_window, 4) if total_window > 0 else None,
        "steps": sorted(steps),
        "ops": table,
        "op_kinds": len(op_rows),
        "scopes": scopes_out,
    }
