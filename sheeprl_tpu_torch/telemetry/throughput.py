"""Throughput accounting: SPS, gradient steps/s, replay ratio, model FLOPs,
MFU and the roofline record (the port's own copy of
``sheeprl_tpu/telemetry/throughput.py``, with its own peak table).

The model FLOPs and bytes of one train step come from running it once under
a dispatch mode that counts each operation by the formulas of
``torch.utils.flop_counter.FlopCounterMode`` and adds the bytes of its
tensors (each input read once, each output written once), where the
reference reads XLA's cost analysis; the LN-GRU kernels, which PyTorch's
dispatcher does not see, report their own (``ops.ln_gru.set_work_sink``).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils._pytree import tree_leaves

from ..ops import ln_gru

# Peaks of one card, by a substring of ``torch.cuda.get_device_name()``
# (lowercase; the longest match wins): dense operations per second by the
# arithmetic a train step computes in, and device-memory bytes per second.
PEAKS: Dict[str, Dict[str, Any]] = {
    "h100 80gb hbm3": {
        "f32": 67e12,  # without the tensor cores (fabric.precision=32-true turns TF32 off)
        "tf32": 495e12,
        "bf16": 989e12,
        "bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, H100 SXM: FP32 67 TFLOPS, TF32 Tensor Core 495, "
                  "BF16 Tensor Core 989 (dense, without sparsity), GPU memory bandwidth 3.35 TB/s",
    },
}
# the arithmetic of each fabric.precision's matrix products
PRECISION_ARITHMETIC = {"32-true": "f32", "bf16-mixed": "bf16", "bf16-true": "bf16"}


def _lookup(device_name: str) -> Optional[Dict[str, Any]]:
    name = (device_name or "").lower()
    for key in sorted(PEAKS, key=len, reverse=True):
        if key in name:
            return PEAKS[key]
    return None


def measured_cpu_peak_flops() -> float:
    """FLOP/s of a 1024³ f32 matrix product on the host (best of 5): the MFU
    denominator of a run on the CPU, labelled as measured."""
    n = 1024
    x = torch.ones(n, n)
    x @ x

    def one() -> float:
        t0 = time.perf_counter()
        x @ x
        return time.perf_counter() - t0

    return 2 * n**3 / min(one() for _ in range(5))


def peak_record(device_name: str, precision: str = "32-true", cpu: bool = False) -> Dict[str, Any]:
    """``peak_flops`` and ``peak_bytes_per_s`` with their bases: the peak
    table's row for the card (the precision's arithmetic), a measured host
    product on the CPU (no bandwidth), or None on a card the table lacks."""
    arith = PRECISION_ARITHMETIC.get(str(precision), "f32")
    row = _lookup(device_name)
    if row is not None:
        return {"peak_flops": row[arith], "peak_flops_basis": f"vendor {arith} peak ({row['source']})",
                "peak_bytes_per_s": row["bytes_per_s"], "peak_bytes_per_s_basis": f"vendor ({row['source']})"}
    if cpu:
        return {"peak_flops": measured_cpu_peak_flops(),
                "peak_flops_basis": "measured 1024^3 f32 matmul on cpu (not vendor peak)",
                "peak_bytes_per_s": None, "peak_bytes_per_s_basis": "cpu: no bandwidth peak; roofline omitted"}
    return {"peak_flops": None, "peak_flops_basis": f"unknown device {device_name!r}; mfu omitted",
            "peak_bytes_per_s": None, "peak_bytes_per_s_basis": f"unknown device {device_name!r}; roofline omitted"}


def mfu(flops_per_step: float, steps_per_sec: float, peak_flops: float, n_devices: int = 1) -> float:
    """Model FLOPs utilization: the step's operations times its rate over
    the devices' peak."""
    return flops_per_step * steps_per_sec / (peak_flops * max(1, n_devices))


class _CostCounter(TorchDispatchMode):
    """Operations and bytes of every operation dispatched on this thread (and
    in the backward it starts): operations by the formulas of
    ``torch.utils.flop_counter.FlopCounterMode`` (its ``flop_registry``),
    bytes as the operation's tensor arguments and results (views move
    nothing and are left out). FlopCounterMode itself also tracks modules
    with global hooks, which would see the player thread's forwards too; this
    mode is thread-local."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view:
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def model_cost(fn: Callable[[], Any]) -> Tuple[Any, Dict[str, float]]:
    """Run ``fn()`` once, counting its operations and bytes: returns (its
    result, {"flops", "bytes_accessed"}). The LN-GRU kernels' work, which the
    dispatcher does not see, is what their launches report meanwhile."""
    kernels = [0, 0]

    def add(flops: int, nbytes: int) -> None:
        kernels[0] += flops
        kernels[1] += nbytes

    ln_gru.set_work_sink(add)
    try:
        with _CostCounter() as counter:
            out = fn()
    finally:
        ln_gru.set_work_sink(None)
    return out, {"flops": float(counter.flops + kernels[0]), "bytes_accessed": float(counter.bytes + kernels[1])}


def roofline_record(fn: str, cost: Dict[str, float], peak_flops: Optional[float] = None,
                    peak_bytes_per_s: Optional[float] = None, calls_per_s: Optional[float] = None,
                    n_devices: int = 1, device_kind: str = "", basis: str = "",
                    role: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """One ``roofline`` event for a function, or None when its cost lacks
    either axis. Intensity = flops / bytes_accessed; the ridge is peak_flops
    / peak_bytes_per_s (below it the function is bound by memory, above it
    by compute). With a measured ``calls_per_s``, ``attained_frac`` is the
    share of the binding roof it reached."""
    flops = float(cost.get("flops") or 0.0)
    nbytes = float(cost.get("bytes_accessed") or 0.0)
    if flops <= 0.0 or nbytes <= 0.0:
        return None
    intensity = flops / nbytes
    rec: Dict[str, Any] = {"event": "roofline", "fn": str(fn), "flops": flops, "bytes_accessed": nbytes,
                           "intensity": round(intensity, 6), "bound": "unknown", "t": round(time.time(), 3)}
    if device_kind:
        rec["device_kind"] = str(device_kind)
    if basis:
        rec["basis"] = str(basis)
    if role:
        rec["role"] = str(role)
    if peak_flops:
        rec["peak_flops"] = float(peak_flops)
    if peak_bytes_per_s:
        rec["peak_bytes_per_s"] = float(peak_bytes_per_s)
    if peak_flops and peak_bytes_per_s:
        ridge = float(peak_flops) / float(peak_bytes_per_s)
        rec["ridge_intensity"] = round(ridge, 6)
        rec["bound"] = "memory" if intensity < ridge else "compute"
        if calls_per_s and calls_per_s > 0:
            attained = flops * float(calls_per_s) / max(1, int(n_devices))
            rec["calls_per_s"] = round(float(calls_per_s), 6)
            rec["attained_flops_per_s"] = round(attained, 2)
            roof = min(float(peak_flops), float(peak_bytes_per_s) * intensity)
            rec["attained_frac"] = round(attained / roof, 6)
    return rec


class ThroughputTracker:
    """Interval accounting for one train loop: policy steps, gradient steps
    and wall time between ``mark`` calls give SPS, gradient steps/s and the
    replay ratio, and MFU once the loop registered its model FLOPs."""

    def __init__(self, start_step: int = 0, world_size: int = 1) -> None:
        self._lock = threading.Lock()
        self._last_step = int(start_step)
        self._last_time = time.perf_counter()
        self._grad_steps = 0
        self._total_grad_steps = 0
        self.world_size = max(1, int(world_size))
        self.model_flops_per_step: Optional[float] = None
        self.peak_flops: Optional[float] = None
        self.n_devices = 1

    def record_grad_steps(self, n: int) -> None:
        with self._lock:
            self._grad_steps += int(n)
            self._total_grad_steps += int(n)

    def set_model_flops(self, flops: Optional[float], peak: Optional[float] = None, n_devices: int = 1) -> None:
        with self._lock:
            self.model_flops_per_step = flops
            if peak is not None:
                self.peak_flops = peak
            self.n_devices = max(1, int(n_devices))

    def mark(self, policy_step: int) -> Dict[str, float]:
        """Close the interval that ends at ``policy_step``."""
        now = time.perf_counter()
        with self._lock:
            dt = max(now - self._last_time, 1e-9)
            dsteps = int(policy_step) - self._last_step
            grads, self._grad_steps = self._grad_steps, 0
            self._last_step, self._last_time = int(policy_step), now
            flops, peak, ndev = self.model_flops_per_step, self.peak_flops, self.n_devices
        out: Dict[str, float] = {"sps": dsteps / dt, "grad_steps_per_s": grads / dt, "interval_steps": dsteps,
                                 "interval_seconds": dt}
        if dsteps > 0:
            out["replay_ratio"] = grads * self.world_size / dsteps
        if flops and peak:
            out["mfu"] = mfu(flops, grads / dt, peak, ndev)
        return out

    @property
    def total_grad_steps(self) -> int:
        with self._lock:
            return self._total_grad_steps
