"""Admission control: token-bucket rate limiting + queue-depth shedding (the
port's counterpart of ``sheeprl_tpu/gateway/admission.py``).

Today's PolicyServer already fails fast with a bare 503 when its own queue
saturates; a multi-replica gateway needs the decision *earlier* (before a
request is forwarded anywhere) and *smarter*:

* a **token bucket** caps the sustained request rate with a configurable
  burst — absorbs spikes, sheds sustained overload;
* a **depth gate** bounds in-flight requests across the whole fleet (a
  proxy for queue depth: every admitted request holds one slot until its
  replica answers);
* **priority-aware shedding**: traffic marked low-priority (by the client,
  or deterministic-eval traffic by configuration) is shed FIRST — both its
  depth gate and its token reserve trip at ``low_priority_frac`` of the
  full limits, so interactive traffic keeps flowing while eval sweeps soak
  up only true spare capacity;
* every shed carries a **jittered** ``Retry-After`` (the same
  `jittered_retry_after` helper the MicroBatcher's Backpressure uses), so
  shed clients never come back as one synchronized wave.

All state is a few counters behind one lock — admission must cost nothing
compared to a policy step.
"""
from __future__ import annotations

import threading
import time

from ..serve.batcher import jittered_retry_after

__all__ = ["Shed", "AdmissionController"]


class Shed(RuntimeError):
    """The gateway refused the request; retry after ``retry_after_s``."""

    def __init__(self, reason: str, retry_after_s: float, priority: str) -> None:
        super().__init__(
            f"request shed ({reason}, priority={priority}); retry after {retry_after_s:.2f}s"
        )
        self.reason = str(reason)
        self.retry_after_s = float(retry_after_s)
        self.priority = str(priority)


class AdmissionController:
    """Token bucket + in-flight depth gate with priority-aware thresholds.

    ``admit(priority)`` either returns (one in-flight slot held — release
    with ``release()``) or raises :class:`Shed`. ``rate_per_s=0`` disables
    the bucket; ``max_inflight=0`` disables the depth gate.
    """

    def __init__(
        self,
        rate_per_s: float = 0.0,
        burst: int = 256,
        max_inflight: int = 512,
        low_priority_frac: float = 0.8,
        retry_after_s: float = 0.25,
        jitter: float = 0.5,
    ) -> None:
        self.rate_per_s = max(0.0, float(rate_per_s))
        self.burst = max(1, int(burst))
        self.max_inflight = max(0, int(max_inflight))
        self.low_priority_frac = min(1.0, max(0.0, float(low_priority_frac)))
        self.retry_after_s = float(retry_after_s)
        self.jitter = float(jitter)
        self._lock = threading.Lock()
        self._tokens = float(self.burst)
        self._refill_t = time.monotonic()
        self.inflight = 0
        self.admitted = 0
        self.shed = 0
        self.shed_low = 0

    # -- internals ----------------------------------------------------------
    def _refill_locked(self, now: float) -> None:
        if self.rate_per_s <= 0:
            return
        self._tokens = min(
            float(self.burst), self._tokens + (now - self._refill_t) * self.rate_per_s
        )
        self._refill_t = now

    def _shed_locked(self, reason: str, priority: str, base_s: float) -> Shed:
        self.shed += 1
        if priority == "low":
            self.shed_low += 1
        return Shed(reason, jittered_retry_after(base_s, self.jitter), priority)

    # -- client API ---------------------------------------------------------
    def admit(self, priority: str = "normal") -> None:
        """Take one in-flight slot + one token, or raise :class:`Shed`.

        Low-priority traffic is tested against ``low_priority_frac`` of both
        limits, so it is the first to go as load rises and the last to come
        back."""
        low = priority == "low"
        with self._lock:
            now = time.monotonic()
            self._refill_locked(now)
            if self.max_inflight > 0:
                depth_cap = self.max_inflight * (self.low_priority_frac if low else 1.0)
                if self.inflight >= depth_cap:
                    # base the hint on how overloaded the fleet is: one
                    # "drain unit" per full depth of backlog over the cap
                    overload = 1.0 + max(0.0, self.inflight - depth_cap) / max(1.0, depth_cap)
                    raise self._shed_locked("inflight limit", priority, self.retry_after_s * overload)
            if self.rate_per_s > 0:
                # low priority only runs on true spare capacity: it needs the
                # bucket to stay above the (1 - frac) reserve kept for
                # interactive traffic
                reserve = (1.0 - self.low_priority_frac) * self.burst if low else 0.0
                if self._tokens < 1.0 + reserve:
                    deficit = (1.0 + reserve) - self._tokens
                    raise self._shed_locked(
                        "rate limit", priority, deficit / self.rate_per_s
                    )
                self._tokens -= 1.0
            self.inflight += 1
            self.admitted += 1

    def release(self) -> None:
        with self._lock:
            self.inflight = max(0, self.inflight - 1)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "inflight": self.inflight,
                "admitted": self.admitted,
                "shed": self.shed,
                "shed_low": self.shed_low,
                "tokens": round(self._tokens, 2),
            }
