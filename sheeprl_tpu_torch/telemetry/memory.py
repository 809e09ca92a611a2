"""Host and device memory: RSS, the CUDA caching allocator's statistics,
and the cadenced ``MemorySampler`` that turns them into ``mem`` events (the
port's own copy of ``sheeprl_tpu/telemetry/memory.py``).

Host RSS comes from ``/proc/self/status`` (``resource.getrusage`` where
that is missing) and is in every ``mem`` event. The device fields come
from ``torch.cuda.memory_stats`` (allocated bytes now and at their peak,
reserved bytes) and ``torch.cuda.mem_get_info`` (the card's total, the
limit); they are absent on the CPU, as in the reference. The reference's
live-buffer census (``jax.live_arrays``) has no counterpart here: the
allocator's counts stand in for it.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

__all__ = ["MemorySampler", "device_memory_stats", "host_rss_bytes", "host_rss_peak_bytes", "memory_snapshot",
           "start_sampler"]


def _proc_status_kib(field: str) -> Optional[int]:
    """One ``VmRSS:``-style field of /proc/self/status in KiB, or None."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    return None


def _rusage_peak_bytes() -> int:
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return int(ru) * (1 if ru > 1 << 32 else 1024)  # KiB on Linux, bytes on macOS


def host_rss_bytes() -> int:
    """This process's resident set size in bytes."""
    kib = _proc_status_kib("VmRSS")
    return kib * 1024 if kib is not None else _rusage_peak_bytes()


def host_rss_peak_bytes() -> int:
    """The kernel's RSS high-water mark (VmHWM) in bytes."""
    kib = _proc_status_kib("VmHWM")
    return kib * 1024 if kib is not None else _rusage_peak_bytes()


def device_memory_stats(device: Any = None) -> Dict[str, int]:
    """``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved`` and
    ``bytes_limit`` of a CUDA device (the current one by default); {} where
    there is no card, or in a process that has not touched it (a broker: the
    query would open a context on the card)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": int(total),
    }


def memory_snapshot(device: Any = None) -> Dict[str, int]:
    """One host + device observation: ``rss_bytes`` (and
    ``rss_peak_bytes``) always, the ``hbm_*`` fields where there is a card."""
    out: Dict[str, int] = {"rss_bytes": host_rss_bytes()}
    peak = host_rss_peak_bytes()
    if peak:
        out["rss_peak_bytes"] = peak
    dev = device_memory_stats(device)
    if dev:
        out["hbm_bytes_in_use"] = dev["bytes_in_use"]
        out["hbm_peak_bytes"] = dev["peak_bytes_in_use"]
        out["hbm_bytes_reserved"] = dev["bytes_reserved"]
        out["hbm_bytes_limit"] = dev["bytes_limit"]
    return out


class MemorySampler:
    """A daemon thread that emits one ``mem`` event every ``interval_s`` on
    the owning stream (``emit``); ``stop`` joins it and takes a closing
    sample, so the stream ends on the run's high-water marks.
    ``sample_once`` is the synchronous form."""

    def __init__(self, emit: Callable[[Dict[str, Any]], None], role: str, index: Optional[int] = None,
                 interval_s: float = 5.0, step_fn: Optional[Callable[[], int]] = None) -> None:
        self.emit = emit
        self.role = str(role)
        self.index = index
        self.interval_s = max(0.05, float(interval_s))
        self._step_fn = step_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rss_high_water = 0
        self.hbm_high_water = 0

    def sample_once(self) -> Dict[str, Any]:
        snap = memory_snapshot()
        self.rss_high_water = max(self.rss_high_water, snap["rss_bytes"])
        self.hbm_high_water = max(self.hbm_high_water, snap.get("hbm_bytes_in_use", 0))
        rec: Dict[str, Any] = {"event": "mem", "role": self.role, "t": round(time.time(), 3)}
        rec.update(snap)
        if self.index is not None:
            rec["index"] = int(self.index)
        if self._step_fn is not None:
            rec["step"] = int(self._step_fn())
        self.emit(rec)
        return rec

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    def start(self) -> "MemorySampler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name=f"mem-sampler-{self.role}", daemon=True)
            self._thread.start()
        return self

    def stop(self, final_sample: bool = True) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        if final_sample:
            self.sample_once()


def start_sampler(cfg: Any, emit: Callable[[Dict[str, Any]], None], role: str, index: Optional[int] = None,
                  step_fn: Optional[Callable[[], int]] = None) -> Optional[MemorySampler]:
    """Config-gated sampler construction (``diag.mem.*``): a STARTED
    sampler, or None when sampling is disabled. ``cfg`` may be a run config,
    a diag config or None (the code defaults) — what a gateway replica or
    brokerd process has at hand."""
    sel = cfg.select if cfg is not None and hasattr(cfg, "select") else (lambda p, d=None: d)
    if not bool(sel("diag.mem.enabled", True)):
        return None
    return MemorySampler(emit, role, index=index, interval_s=float(sel("diag.mem.interval_s", 5.0) or 5.0),
                         step_fn=step_fn).start()
