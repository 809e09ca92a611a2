"""Device-side health counters (the counterpart of
``sheeprl_tpu/telemetry/xla.py``, named for what it counts here):

* host-to-device copies of the replay feed (``TRANSFER_COUNTER``): the
  staged prefetcher's batch copies, which also serve its synchronous take,
  and the device ring's row syncs and index copies
  (``data/prefetch.py``, ``data/device_ring.py``);
* the LN-GRU kernels' builds and their seconds (``ops.ln_gru.build``'s);
* the LN-GRU kernels' launches so far (``ops.ln_gru``'s counts).

Eager PyTorch compiles and traces nothing, so the reference's compile and
retrace fields (``compile_count``, ``retraces``, ...) stay absent from the
port's records; its schema marks them optional.
"""
from __future__ import annotations

import threading
from typing import Any, Dict

from ..ops import ln_gru


class _Counter:
    """Named, monotonic, thread-safe totals."""

    def __init__(self, *names: str) -> None:
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {n: 0 for n in names}

    def add(self, **amounts: float) -> None:
        with self._lock:
            for k, v in amounts.items():
                self._totals[k] += v

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._totals)


TRANSFER_COUNTER = _Counter("h2d_calls", "h2d_bytes")


def record_h2d(*tensors: Any) -> None:
    """One host-to-device copy call of these tensors (or numpy arrays)."""
    TRANSFER_COUNTER.add(h2d_calls=1, h2d_bytes=sum(int(t.numel() * t.element_size()) if hasattr(t, "element_size")
                                                    else int(t.nbytes) for t in tensors))


def counters() -> Dict[str, Any]:
    """Every counter's total so far, and the LN-GRU kernels' builds and
    launch counts."""
    out: Dict[str, Any] = {**TRANSFER_COUNTER.snapshot(), "kernel_builds": ln_gru.build.builds,
                           "kernel_build_seconds": ln_gru.build.seconds}
    out["ln_gru_launches"] = {k.__name__: int(k.launches) for k in ln_gru.KERNELS}
    return out


def delta(now: Dict[str, Any], base: Dict[str, Any]) -> Dict[str, Any]:
    """``now`` less ``base``, key by key (nested dicts too)."""
    return {k: delta(v, base.get(k, {})) if isinstance(v, dict) else v - base.get(k, 0) for k, v in now.items()}
