"""Post-run facts for in-process callers.

The port's copy of ``sheeprl_tpu/utils/run_info.py``. ``wall_cap_reached``
(utils/utils.py) records where a wall-capped run actually stopped —
``policy_step`` short of ``total_steps``, plus a ``wall_capped`` flag; the
RunGuard records a preemption's ``preempted``; the telemetry facade the
run's ``log_dir``. A run that completes normally records no stop (callers
fall back to the configured step count). A benchmark script reads this to
compute SPS over the steps that really ran; the CLI never needs it.
"""
from __future__ import annotations

import time
from typing import Any, Dict

last_run: Dict[str, Any] = {}


def mark_steady(policy_step: int, sync: Any = None) -> None:
    """Record the end of the FIRST completed training burst: the kernels'
    build, cuDNN's algorithm search and the allocator's growth happen inside
    that burst, so the steady-state window for SPS starts here. Called once
    per run from each training loop; a benchmark script derives
    ``steady_state_sps`` = (final_step - steady_step) / (t_end - steady_t)
    from it.

    ``sync``: loops whose train launches are asynchronous pass a thunk that
    waits for the device (``device_sync``); it runs only on the first call,
    so the stamp lands after the burst's device execution (not just its
    launch) at zero steady-state cost."""
    if "steady_step" not in last_run:
        if sync is not None:
            sync()
        last_run["steady_step"] = int(policy_step)
        last_run["steady_t"] = time.perf_counter()


def device_sync(device: Any) -> Any:
    """``mark_steady``'s ``sync`` for a learner on ``device``: the card's
    ``torch.cuda.synchronize``, or None on the CPU, where nothing runs
    asynchronously."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    return lambda: torch.cuda.synchronize(device)
