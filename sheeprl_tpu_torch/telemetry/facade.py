"""The ``Telemetry`` facade: one object per train loop that owns metric
aggregation, span timing, the device counters, throughput and MFU, memory
sampling and every sink (the logger, the JSONL event stream, the console
heartbeat). The port's own copy of ``sheeprl_tpu/telemetry/facade.py``.

Loops use these calls::

    telem = Telemetry.setup(cfg, log_dir, logger=logger, aggregator_keys=AGGREGATOR_KEYS, device=device)
    telem.tick(policy_step)                  # top of each iteration: a trace
                                             # range for the iteration and the
                                             # windowed profiler capture
    with telem.span("Time/train_time"): ...  # host seconds + a trace range
    telem.record_grad_steps(n)               # throughput accounting
    telem.set_model_flops(flops, precision)  # MFU in the log records
    telem.register_roofline(name, cost)      # a roofline record
    telem.log(policy_step)                   # flush one log interval
    telem.close(policy_step)                 # end-of-run summary

``telem.aggregator`` is the loop's ``MetricAggregator``. The windowed
capture (``metric.telemetry.trace_every`` / ``trace_window`` /
``trace_dir``) runs ``torch.profiler`` and writes Chrome-trace JSON
(``trace_step<N>.json``) into ``trace_dir``; ``prof run_dir=...`` reads
them. On rank 0 the live plane runs beside the stream: the
``LiveAggregator`` (``diag/aggregator.py``, ``diag.live.enabled``) sees
every event and relayed fleet batch (``ingest_relayed``) and emits its SLO
``alert`` events on the stream, and with ``metric.telemetry.prometheus_port
> 0`` a ``Registry`` mirrors the events behind ``GET /metrics`` and ``GET
/live`` (``diag/prometheus.py``), announced in ``<log_dir>/live.json``.
"""
from __future__ import annotations

import json
import os
import platform
import sys
import time
from typing import Any, Dict, Optional

import torch

from ..parallel import mesh
from ..utils.metric import MetricAggregator
from . import device as device_counters
from .memory import MemorySampler, host_rss_bytes, memory_snapshot
from .schema import SCHEMA_VERSION
from .sinks import DEFAULT_JSONL_MAX_BYTES, ConsoleHeartbeat, JsonlSink
from .spans import GLOBAL_TRACKER, PROFILER_LOCK, Span, SpanTracker, TraceRange
from .throughput import ThroughputTracker, peak_record, roofline_record

MEM_INTERVAL_S = 5.0  # the memory sampler's cadence without a diag config (diag.mem.interval_s)


def device_info(device: Optional[torch.device] = None) -> Dict[str, Any]:
    """platform (``gpu`` or ``cpu``), device kind and device count of the
    run's device."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type == "cuda":
        return {"platform": "gpu", "device_kind": torch.cuda.get_device_name(dev),
                "devices": torch.cuda.device_count()}
    return {"platform": "cpu", "device_kind": platform.processor() or platform.machine() or "cpu", "devices": 1}


class Telemetry:
    """The observability facade of one training loop."""

    def __init__(self, cfg: Any = None, log_dir: Optional[str] = None, rank: int = 0, logger: Any = None,
                 aggregator_keys: Any = None, tracker: Optional[SpanTracker] = None,
                 device: Optional[torch.device] = None) -> None:
        sel = (lambda p, d=None: cfg.select(p, d)) if cfg is not None else (lambda p, d=None: d)
        self.rank = int(rank)
        self.log_dir = log_dir
        self.logger = logger
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.enabled = bool(sel("metric.telemetry.enabled", True)) and (sel("metric.log_level", 1) or 0) > 0
        self._span_enabled = not bool(sel("metric.disable_timer", False))
        self.tracker = tracker if tracker is not None else GLOBAL_TRACKER
        self.tracker.compute(reset=True)  # an earlier run in this process may have left spans
        self.throughput = ThroughputTracker(world_size=int(sel("fabric.devices", 1) or 1))

        metrics_cfg = sel("metric.aggregator.metrics") or {}
        metrics_cfg = metrics_cfg.to_dict() if hasattr(metrics_cfg, "to_dict") else dict(metrics_cfg)
        self.aggregator = MetricAggregator({k: (metrics_cfg[k] or {}).get("kind", "mean") for k in metrics_cfg
                                            if aggregator_keys is None or k in aggregator_keys})

        self._info = device_info(self.device)
        # the run's process group (parallel/mesh.py): its backend, or "none" at world size 1 under auto
        # (a key beyond the reference's schema, which allows extra keys)
        active = mesh.active()
        self._info.update(rank=self.rank, world_size=int(sel("fabric.devices", 1) or 1),
                          backend=str(active.backend) if active is not None and active.backend else "none",
                          algo=str(sel("algo.name", "") or ""), run_name=str(sel("run_name", "") or ""),
                          rss_bytes=host_rss_bytes())
        self.jsonl: Optional[JsonlSink] = None
        if self.enabled and self.rank == 0 and log_dir and bool(sel("metric.telemetry.jsonl", True)):
            max_bytes = sel("metric.telemetry.jsonl_max_bytes")
            # the rotation marker is written inside the sink, so the registry gets it by callback
            self.jsonl = JsonlSink(os.path.join(log_dir, "telemetry.jsonl"),
                                   max_bytes=DEFAULT_JSONL_MAX_BYTES if max_bytes is None else int(max_bytes),
                                   on_rotate=lambda marker: self.prom.observe_event(marker)
                                   if self.prom is not None else None)
            # post-run callers (a benchmark script) need the stream's location
            from ..utils import run_info

            run_info.last_run["log_dir"] = str(log_dir)
        self.live: Any = None
        self.prom: Any = None
        self._prom_server: Any = None
        self._live_path: Optional[str] = None
        self._diag_cfg: Any = None
        if self.enabled and self.rank == 0:
            self._setup_live_plane(cfg, sel, log_dir)
        # the startup line is independent of log_level: a run on the host is never silent about it
        self.heartbeat = ConsoleHeartbeat(rank=self.rank, enabled=bool(sel("metric.telemetry.heartbeat", True)))
        self._dev0 = device_counters.counters()
        self._mem_sampler: Optional[MemorySampler] = None
        self._last_step = 0
        if self.enabled and self.rank == 0 and bool(self._dsel("diag.mem.enabled", True)):
            self._mem_sampler = MemorySampler(
                self._emit, role="learner", interval_s=float(self._dsel("diag.mem.interval_s", MEM_INTERVAL_S)),
                step_fn=lambda: self._last_step).start()
        self._rooflines: Dict[str, Dict[str, Any]] = {}
        self._peaks: Optional[Dict[str, Any]] = None
        self._precision = "32-true"

        self._annotate_steps = self.enabled and bool(sel("metric.telemetry.step_annotation", True))
        self._step_range: Optional[TraceRange] = None
        self.trace_every = int(sel("metric.telemetry.trace_every", 0) or 0) if self.enabled else 0
        self.trace_window = int(sel("metric.telemetry.trace_window", 256) or 256)
        self.trace_dir = str(sel("metric.telemetry.trace_dir")
                             or (os.path.join(log_dir, "trace") if log_dir else os.path.join("logs", "trace")))
        self._profiler: Optional[torch.profiler.profile] = None
        self._trace_start_step = 0
        self._last_trace_step = 0
        self._closed = False

        self.heartbeat.startup(self._info)
        self._emit({"event": "startup", "schema_version": SCHEMA_VERSION, **self._info})

    @classmethod
    def setup(cls, cfg: Any, log_dir: Optional[str], rank: int = 0, logger: Any = None,
              aggregator_keys: Any = None, device: Optional[torch.device] = None) -> "Telemetry":
        return cls(cfg, log_dir, rank, logger=logger, aggregator_keys=aggregator_keys, device=device)

    # -- the live plane ------------------------------------------------------
    def _dsel(self, path: str, default: Any = None) -> Any:
        c = self._diag_cfg
        val = c.select(path, default) if c is not None and hasattr(c, "select") else default
        return default if val is None else val

    def _setup_live_plane(self, cfg: Any, sel: Any, log_dir: Optional[str]) -> None:
        """The diag config (the run's ``diag`` group, else the packaged
        ``configs/diag/default.yaml``), the ``LiveAggregator`` and, with a
        ``prometheus_port``, the ``/metrics`` + ``/live`` endpoint. A bind
        failure prints and the run carries on without the endpoint."""
        from ..diag.doctor import _load_diag_cfg

        self._diag_cfg = _load_diag_cfg(cfg)
        if bool(self._dsel("diag.live.enabled", True)):
            try:
                from ..diag.aggregator import LiveAggregator

                self.live = LiveAggregator(self._diag_cfg, emit=None, registry=None)
            except Exception as err:
                print(f"[telemetry] live aggregator disabled: {err}", file=sys.stderr)
                self.live = None
        port = int(sel("metric.telemetry.prometheus_port", 0) or 0)
        if port > 0:
            try:
                from ..diag.prometheus import Registry, start_http_server

                self.prom = Registry()
                buckets = self._dsel("diag.prometheus.buckets")
                if buckets:
                    bd = buckets.to_dict() if hasattr(buckets, "to_dict") else buckets
                    if isinstance(bd, dict):
                        self.prom.set_bucket_overrides(bd)
                host = str(sel("metric.telemetry.prometheus_host", "127.0.0.1") or "127.0.0.1")
                self._prom_server = start_http_server(self.prom, port, host=host, aggregator=self.live)
                if log_dir:
                    self._live_path = os.path.join(log_dir, "live.json")
                    self._write_live_discovery(host, port)
            except Exception as err:
                print(f"[telemetry] prometheus export disabled: {err}", file=sys.stderr)
                self.prom = None
                self._prom_server = None
        if self.live is not None:
            # wired after the registry exists: alerts land on the main stream
            # and relayed events federate into /metrics
            self.live.emit = self._emit
            self.live.registry = self.prom

    def _write_live_discovery(self, host: str, port: int) -> None:
        """``<log_dir>/live.json``: where ``top`` finds the run's ``/live``."""
        try:
            actual = int(getattr(self._prom_server, "port", port) or port)
            with open(self._live_path, "w") as fh:
                json.dump({"url": f"http://{host}:{actual}/live", "metrics_url": f"http://{host}:{actual}/metrics",
                           "pid": os.getpid(), "t": time.time()}, fh)
        except Exception:
            self._live_path = None

    def ingest_relayed(self, batch: Dict[str, Any]) -> None:
        """One relayed telemetry batch (a fleet worker's) for the live
        aggregator. Relayed events are validated there and never written to
        this process's stream: the worker's own file is the durable copy."""
        if self.live is not None:
            try:
                self.live.ingest_batch(batch)
            except Exception:
                pass

    # -- sinks -------------------------------------------------------------
    def _emit(self, rec: Dict[str, Any]) -> None:
        if self.jsonl is not None:
            self.jsonl.write(rec)
        if self.prom is not None:
            try:  # the scrape surface never takes the emitter down
                self.prom.observe_event(rec)
            except Exception:
                pass
        if self.live is not None:
            try:
                self.live.ingest(rec)
            except Exception:
                pass

    def emit(self, rec: Dict[str, Any]) -> None:
        """Write one schema-checked event to the JSONL stream: the hook the
        engine and the resilience objects use; safe from any thread, and a
        no-op when the stream is off or closed."""
        self._emit(rec)

    # -- spans and the step range ---------------------------------------------
    def span(self, name: str) -> Span:
        return Span(name, tracker=self.tracker, enabled=self._span_enabled, annotate=self.enabled)

    def tick(self, policy_step: int) -> None:
        """The top of a loop iteration: closes the last iteration's trace
        range and opens this one's (``train#<policy_step>``), and starts or
        stops the windowed profiler capture."""
        if self._step_range is not None:
            self._step_range.__exit__(None, None, None)
            self._step_range = None
        if self._annotate_steps:
            self._step_range = TraceRange(f"train#{int(policy_step)}").__enter__()
        if self.trace_every > 0:
            self._windowed_trace(int(policy_step))

    def _windowed_trace(self, policy_step: int) -> None:
        if self._profiler is None and policy_step - self._last_trace_step >= self.trace_every:
            if not PROFILER_LOCK.acquire(blocking=False):
                return  # another capture (the watchdog's) is running: this window waits
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            try:
                prof.start()
            except BaseException:
                PROFILER_LOCK.release()
                raise
            self._profiler = prof
            self._trace_start_step = policy_step
            self._emit({"event": "trace", "step": policy_step, "action": "started", "trace_dir": self.trace_dir})
        elif self._profiler is not None and policy_step - self._trace_start_step >= self.trace_window:
            self._stop_trace()
            # the gap counts from the stop, so captures never run back to back
            self._last_trace_step = policy_step
            self._emit({"event": "trace", "step": policy_step, "action": "stopped", "trace_dir": self.trace_dir})

    def _stop_trace(self) -> None:
        prof, self._profiler = self._profiler, None
        try:
            prof.stop()
        finally:
            PROFILER_LOCK.release()
        os.makedirs(self.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.trace_dir, f"trace_step{self._trace_start_step}.json"))

    # -- metrics and throughput ---------------------------------------------
    def update(self, name: str, value: Any) -> None:
        self.aggregator.update(name, value)

    def record_grad_steps(self, n: int) -> None:
        self.throughput.record_grad_steps(n)

    def _peak(self) -> Dict[str, Any]:
        if self._peaks is None:
            self._peaks = peak_record(self._info["device_kind"], self._precision, cpu=self.device.type == "cpu")
        return self._peaks

    def set_model_flops(self, flops: Optional[float], precision: str = "32-true") -> None:
        """Register the model FLOPs of one gradient step (``model_cost``) and
        the arithmetic they run in (``fabric.precision``): the log records
        carry MFU from then on."""
        if flops is None:
            return
        self._precision, self._peaks = str(precision), None
        self.throughput.set_model_flops(flops, self._peak()["peak_flops"], 1)

    def register_roofline(self, name: str, cost: Dict[str, float], role: str = "learner",
                          track_grad_rate: bool = False) -> Optional[Dict[str, Any]]:
        """Emit the roofline record of a function from its cost
        ({flops, bytes_accessed} a call). With ``track_grad_rate`` it is
        emitted again at each log interval with the measured gradient-step
        rate as ``calls_per_s`` (the attained share of the roof). Returns the
        record, or None without both axes or a peak table row."""
        if not self.enabled:
            return None
        rec = self._roofline(name, cost, role, None)
        if rec is not None:
            self._rooflines[str(name)] = {"cost": dict(cost), "role": str(role), "track": bool(track_grad_rate)}
            self._emit(rec)
        return rec

    def _roofline(self, name: str, cost: Dict[str, float], role: str, calls_per_s: Optional[float]):
        peaks = self._peak()
        return roofline_record(name, cost, peak_flops=peaks["peak_flops"],
                               peak_bytes_per_s=peaks["peak_bytes_per_s"], calls_per_s=calls_per_s,
                               device_kind=self._info["device_kind"], basis=peaks["peak_bytes_per_s_basis"],
                               role=role)

    def device_health(self) -> Dict[str, Any]:
        """The device counters since setup: host-to-device copies, kernel
        builds and the LN-GRU kernels' launches."""
        return device_counters.delta(device_counters.counters(), self._dev0)

    # -- the log interval ----------------------------------------------------
    def log(self, policy_step: int, extra_metrics: Optional[Dict[str, Any]] = None,
            fields: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Flush one log interval: drain the spans and the aggregator,
        compute SPS, gradient steps/s and MFU, snapshot the device counters
        and memory, and write every sink. ``fields`` are extra keys of the
        ``log`` record (the player mirror's statistics). Always drains; writes
        only when enabled."""
        spans = self.tracker.compute(reset=True)
        metrics = self.aggregator.compute()
        self.aggregator.reset()
        tp = self.throughput.mark(int(policy_step))
        if not self.enabled:
            return {}
        if extra_metrics:
            metrics = {**metrics, **{k: float(v) for k, v in extra_metrics.items()}}
        interval_steps = tp.pop("interval_steps", 0)
        interval_s = tp.pop("interval_seconds", 0.0)
        memory = memory_snapshot(self.device if self.device.type == "cuda" else None)
        self._last_step = int(policy_step)

        scalars: Dict[str, float] = dict(metrics)
        scalars["Time/sps"] = tp["sps"]
        if tp.get("grad_steps_per_s"):
            scalars["Time/grad_steps_per_s"] = tp["grad_steps_per_s"]
        if tp.get("replay_ratio") is not None:
            scalars["Time/replay_ratio"] = tp["replay_ratio"]
        if tp.get("mfu") is not None:
            scalars["Time/mfu"] = tp["mfu"]
        scalars.update(spans)
        if spans.get("Time/train_time") and interval_steps > 0:
            scalars["Time/sps_train"] = interval_steps / spans["Time/train_time"]
        if spans.get("Time/env_interaction_time") and interval_steps > 0:
            scalars["Time/sps_env_interaction"] = interval_steps / spans["Time/env_interaction_time"]
        for key, val in memory.items():
            scalars[f"Memory/{key}"] = float(val)
        if self.logger is not None and self.rank == 0:
            self.logger.log_metrics(scalars, int(policy_step))

        rec: Dict[str, Any] = {
            "event": "log",
            "step": int(policy_step),
            "t": round(time.time(), 3),
            "sps": round(tp["sps"], 4),
            "interval_steps": int(interval_steps),
            "interval_seconds": round(interval_s, 4),
            "metrics": {k: round(float(v), 6) for k, v in metrics.items()},
            "spans": {k: round(v, 6) for k, v in spans.items()},
            "throughput": {k: float(v) for k, v in tp.items()},
            "memory": memory,
            "device": self.device_health(),
            **(fields or {}),
        }
        self._emit(rec)
        rate = float(tp.get("grad_steps_per_s") or 0.0)
        if rate > 0:  # the tracked rooflines at this interval's gradient-step rate
            for name, info in self._rooflines.items():
                if info["track"]:
                    again = self._roofline(name, info["cost"], info["role"], rate)
                    if again is not None:
                        again["step"] = int(policy_step)
                        self._emit(again)
        if self.rank == 0:
            self.heartbeat.log(int(policy_step), {**tp, "memory": memory})
        return rec

    # -- shutdown ------------------------------------------------------------
    def close(self, policy_step: int = 0) -> None:
        if self._closed:
            return
        self._closed = True
        if self._step_range is not None:
            self._step_range.__exit__(None, None, None)
            self._step_range = None
        if self._profiler is not None:
            self._stop_trace()
        if self._mem_sampler is not None:
            self._mem_sampler.stop()  # the closing sample pins the run's high-water marks
            self._mem_sampler = None
        if self.enabled:
            self._emit({"event": "shutdown", "step": int(policy_step), "spans": self.tracker.compute(),
                        "total_grad_steps": self.throughput.total_grad_steps, "device": self.device_health()})
        if self.jsonl is not None:
            self.jsonl.close()
            self.jsonl = None
        if self._prom_server is not None:
            self._prom_server.stop()
            self._prom_server = None
            self.prom = None
        if self._live_path is not None:
            try:
                os.remove(self._live_path)  # the endpoint just went away
            except OSError:
                pass
            self._live_path = None
        self.live = None
