"""The heartbeat watchdog's incident trace on the card: the watchdog fires
while CUDA work runs on the training thread, and the incident's
``torch.profiler`` capture (taken on the watchdog's own thread) holds that
work's CUDA kernel events. Marked ``cuda``: it skips without an NVIDIA GPU.
This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:
pytest tests/test_torch_watchdog_cuda.py --noconftest"""
import json
import time
from pathlib import Path

import pytest
import torch

from sheeprl_tpu_torch.resilience.preemption import clear_preemption, preemption_requested
from sheeprl_tpu_torch.resilience.supervisor import HeartbeatWatchdog


class _Events:
    def __init__(self):
        self.events = []

    def emit(self, rec):
        self.events.append(rec)


@pytest.mark.cuda
def test_watchdog_incident_trace_holds_cuda_kernels(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the trace's CUDA activity)")
    clear_preemption()
    telem = _Events()
    x = torch.randn(1024, 1024, device="cuda")
    torch.cuda.synchronize()
    dog = HeartbeatWatchdog(stall_s=0.2, action="preempt", telem=telem, trace_dir=str(tmp_path / "wd"), trace_s=0.5,
                            poll_s=0.02).start()
    try:
        dog.beat(1)
        deadline = time.monotonic() + 30.0
        while not preemption_requested() and time.monotonic() < deadline:
            x = torch.tanh(x @ x)  # the training thread's CUDA work while the step does not advance
            torch.cuda.synchronize()
        assert preemption_requested()
    finally:
        dog.stop()
        clear_preemption()
    stall = next(e for e in telem.events if e["action"] == "stall")
    assert "trace_error" not in stall, stall
    trace = Path(stall["trace_dir"]) / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels, sorted({e.get("cat") for e in events})
    assert any("gemm" in e["name"].lower() or "tanh" in e["name"].lower() for e in kernels), \
        sorted({e["name"] for e in kernels})[:10]
