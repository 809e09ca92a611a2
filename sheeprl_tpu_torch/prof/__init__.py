"""Device-level profile consumption (`sheeprl_tpu_torch prof`).

The emission side already exists: the facade's windowed ``torch.profiler``
captures, the watchdog's incident dumps and the fleet's RemoteProfiler
windows, each a Chrome-trace JSON. This package is the consumption side:
parse those traces, aggregate device-lane activity (CUDA kernels, copies
and sets; a CPU run's ops) into per-op device time, join each kernel to the
``record_function`` scope that launched it, and report top ops, per-scope
device share and device-idle fraction per capture window — next to the
run's roofline verdicts. The public API is ``sheeprl_tpu/prof``'s.
"""
from .capture import (
    CaptureError,
    find_trace_files,
    parse_trace_file,
    summarize_capture,
)

__all__ = [
    "CaptureError",
    "find_trace_files",
    "parse_trace_file",
    "summarize_capture",
]
