"""Micro-batching request queue with deadline flush and backpressure (the
port's counterpart of ``sheeprl_tpu/serve/batcher.py``).

Concurrent single-observation requests are coalesced into one policy batch:
the flush thread waits until either the largest compiled bucket is full or
``max_wait_ms`` has passed since the oldest pending request, then takes the
longest same-``deterministic`` run from the head of the queue (FIFO — a flag
flip ends the batch rather than reordering requests), pads it to the bucket
shape and steps the policy once. Results are scattered back to the waiting
callers.

Saturation is explicit: when ``max_pending`` requests are already queued,
``submit`` fails fast with :class:`Backpressure` carrying a ``retry_after_s``
estimate (queue depth × recent per-batch latency / batch width) instead of
letting latency grow without bound — the HTTP layer maps it to
``503 Retry-After``.

`ServeStats` tracks queue depth, batch occupancy, latency percentiles and
reject/error counts; `MicroBatcher` periodically emits them as ``serve``
events on the shared telemetry JSONL stream.
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from .policy import InferencePolicy, SessionExpired


def jittered_retry_after(base_s: float, jitter: float = 0.5, floor_s: float = 0.05) -> float:
    """Spread a Retry-After estimate upward by up to ``jitter`` of itself.

    A constant Retry-After synchronizes every shed client into one retry
    wave that saturates the queue all over again; jittering upward keeps the
    estimate honest as a *minimum* while de-correlating the herd. Shared by
    the MicroBatcher's :class:`Backpressure` and the gateway's admission
    controller — one shedding policy across the serving tier."""
    base_s = max(float(floor_s), float(base_s))
    return base_s * (1.0 + random.uniform(0.0, max(0.0, float(jitter))))


class Backpressure(RuntimeError):
    """The request queue is full; retry after ``retry_after_s`` seconds."""

    def __init__(self, retry_after_s: float, depth: int) -> None:
        super().__init__(
            f"serving queue saturated ({depth} pending); retry after {retry_after_s:.2f}s"
        )
        self.retry_after_s = float(retry_after_s)
        self.depth = int(depth)


class _Request:
    __slots__ = (
        "obs",
        "deterministic",
        "session",
        "event",
        "result",
        "error",
        "t_submit",
        "t_batch_start",
        "t_batch_end",
    )

    def __init__(self, obs: Any, deterministic: bool, session: Optional[str]) -> None:
        self.obs = obs
        self.deterministic = bool(deterministic)
        self.session = session
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.monotonic()
        # stage boundaries for the per-request latency breakdown (tracing):
        # submit → batch_start is batcher-queue wait, batch_start →
        # batch_end is the coalesced device step, batch_end → completion is
        # the scatter/export back to this caller
        self.t_batch_start = 0.0
        self.t_batch_end = 0.0


class ServeStats:
    """Thread-safe serving counters backed by a Prometheus registry.

    Every update lands in a :class:`~sheeprl_tpu_torch.diag.prometheus.Registry`
    (latency / batch-occupancy histograms, request counters) — the registry
    `PolicyServer`'s ``GET /metrics`` renders, and the SAME histogram the
    p50/p95/p99 in the ``/stats`` snapshot are estimated from (bucket
    interpolation), so the two surfaces always agree."""

    def __init__(self, registry: Any = None) -> None:
        from ..diag.prometheus import FRACTION_BUCKETS, LATENCY_MS_BUCKETS, Registry

        self._lock = threading.Lock()
        self.requests = 0
        self.completed = 0
        self.rejected = 0
        self.errors = 0
        self.evictions = 0
        self.expired = 0
        self.batches = 0
        self.batched_items = 0
        self._occupancy_sum = 0.0
        self._pad_waste_sum = 0.0
        self._batch_seconds_sum = 0.0
        self.registry = registry if registry is not None else Registry(prefix="sheeprl_serve")
        self._m_requests = self.registry.counter("requests_total", "act requests submitted")
        self._m_rejected = self.registry.counter("rejected_total", "requests rejected (backpressure)")
        self._m_completed = self.registry.counter("completed_total", "requests served")
        self._m_errors = self.registry.counter("errors_total", "requests failed")
        self._m_latency = self.registry.histogram(
            "latency_ms", "submit→result latency (ms)", LATENCY_MS_BUCKETS
        )
        self._m_occupancy = self.registry.histogram(
            "batch_occupancy", "batch fill fraction of its compiled bucket", FRACTION_BUCKETS
        )
        # the complement seen from the device's side: rows of each dispatched
        # bucket that were zero-padding — the batching-efficiency knob
        # (serve.buckets / max_wait_ms) made directly observable
        self._m_pad_waste = self.registry.histogram(
            "pad_waste", "padded row fraction of each dispatched bucket", FRACTION_BUCKETS
        )
        self._m_batch_size = self.registry.histogram(
            "batch_size", "coalesced batch width", (1, 2, 4, 8, 16, 32, 64, 128)
        )

    def record_submit(self) -> None:
        with self._lock:
            self.requests += 1
        self._m_requests.inc()

    def record_reject(self) -> None:
        with self._lock:
            self.rejected += 1
        self._m_rejected.inc()

    def record_eviction(self) -> None:
        with self._lock:
            self.evictions += 1
        self.registry.counter("session_evictions_total", "live sessions LRU-evicted").inc()

    def record_expired(self) -> None:
        with self._lock:
            self.expired += 1
        self.registry.counter("session_expired_total", "requests answered 410 session_expired").inc()

    def record_batch(self, n: int, bucket: int, seconds: float) -> None:
        waste = (max(0, bucket - n)) / max(1, bucket)
        with self._lock:
            self.batches += 1
            self.batched_items += n
            self._occupancy_sum += n / max(1, bucket)
            self._pad_waste_sum += waste
            self._batch_seconds_sum += seconds
        self._m_occupancy.observe(n / max(1, bucket))
        self._m_pad_waste.observe(waste)
        self._m_batch_size.observe(n)

    def record_done(self, latency_s: float, error: bool = False) -> None:
        with self._lock:
            if error:
                self.errors += 1
            else:
                self.completed += 1
        (self._m_errors if error else self._m_completed).inc()
        self._m_latency.observe(latency_s * 1000.0)

    def avg_batch_seconds(self) -> float:
        with self._lock:
            return self._batch_seconds_sum / self.batches if self.batches else 0.0

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = {
                "requests": self.requests,
                "completed": self.completed,
                "rejected": self.rejected,
                "errors": self.errors,
                "evictions": self.evictions,
                "expired": self.expired,
                "batches": self.batches,
                "batch_occupancy": round(self._occupancy_sum / self.batches, 4)
                if self.batches
                else 0.0,
                "pad_waste": round(self._pad_waste_sum / self.batches, 4)
                if self.batches
                else 0.0,
                "avg_batch_size": round(self.batched_items / self.batches, 4)
                if self.batches
                else 0.0,
            }
        for name, p in (("p50_ms", 0.50), ("p95_ms", 0.95), ("p99_ms", 0.99)):
            out[name] = round(self._m_latency.percentile(p), 3)
        return out


class MicroBatcher:
    """Coalesces concurrent `submit` calls into bucket-shaped policy batches."""

    def __init__(
        self,
        policy: InferencePolicy,
        max_wait_ms: float = 5.0,
        max_pending: int = 256,
        request_timeout_s: float = 30.0,
        sink: Any = None,
        log_every_s: float = 10.0,
    ) -> None:
        self.policy = policy
        self.max_wait_s = max(0.0, float(max_wait_ms) / 1000.0)
        self.max_pending = int(max_pending)
        self.request_timeout_s = float(request_timeout_s)
        self.stats = ServeStats()
        self._sink = sink
        self._log_every_s = float(log_every_s)
        self._last_log = time.monotonic()
        self._pending: Deque[_Request] = deque()
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # count + report live-session evictions (LRU overflow): the store
        # fires per evicted id, the stats counter and an immediate `session`
        # telemetry event make the loss observable instead of silent
        sessions = getattr(policy, "sessions", None)
        if sessions is not None and hasattr(sessions, "on_evict"):
            sessions.on_evict = self._on_session_evict

    def _on_session_evict(self, sid: str) -> None:
        self.stats.record_eviction()
        if self._sink is not None:
            try:
                self._sink.write(
                    {"event": "session", "action": "evicted", "session_id": str(sid)}
                )
            except Exception:
                pass

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "MicroBatcher":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._flush_loop, daemon=True, name="microbatcher")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # fail whatever is still queued so no caller hangs on shutdown
        with self._cv:
            leftovers = list(self._pending)
            self._pending.clear()
        for req in leftovers:
            req.error = RuntimeError("serving shut down")
            req.event.set()

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._pending)

    # -- client API --------------------------------------------------------
    def submit(
        self,
        raw_obs: Dict[str, Any],
        deterministic: bool = False,
        session: Optional[str] = None,
        timeout_s: Optional[float] = None,
        timing_out: Optional[Dict[str, Any]] = None,
    ) -> Any:
        """Enqueue one observation; block until its action row is ready.

        Raises :class:`Backpressure` when the queue is saturated,
        :class:`SessionExpired` when the session's state was LRU-evicted
        (the caller must re-hydrate or restart the session) and
        ``TimeoutError`` when the request is not served within the timeout.

        With ``timing_out`` (a dict the caller owns), the per-stage latency
        breakdown is filled in on success: ``batch_queue_ms`` /
        ``jit_step_ms`` / ``export_ms`` plus the raw monotonic boundaries
        under ``"mono"`` (the HTTP layer converts those into wall-clock
        trace spans).
        """
        self.start()
        # expired sessions fail BEFORE batching: silently re-initializing an
        # evicted latent would corrupt the session's trajectory
        if session is not None:
            check = getattr(self.policy, "session_expired", None)
            if check is not None and check(session):
                self.stats.record_expired()
                raise SessionExpired(session)
        prepared = self.policy.prepare(raw_obs, 1)
        # reject malformed obs here, where only THIS caller pays: inside a
        # coalesced batch it would fail every rider (or retrace a new shape)
        validate = getattr(self.policy, "validate_prepared", None)
        if validate is not None:
            validate(prepared, 1)
        req = _Request(prepared, deterministic, session)
        with self._cv:
            if len(self._pending) >= self.max_pending:
                self.stats.record_reject()
                retry = self._retry_after_locked()
                raise Backpressure(retry, len(self._pending))
            self._pending.append(req)
            self.stats.record_submit()
            self._cv.notify_all()
        timeout = timeout_s if timeout_s is not None else self.request_timeout_s
        if not req.event.wait(timeout):
            # abandoned requests must not keep consuming device batches or
            # inflating the backpressure estimate
            with self._cv:
                try:
                    self._pending.remove(req)
                except ValueError:
                    pass  # already taken into a running batch
            raise TimeoutError(f"policy request not served within {timeout}s")
        if req.error is not None:
            raise req.error
        if timing_out is not None and req.t_batch_start > 0.0:
            done = time.monotonic()
            timing_out["batch_queue_ms"] = round((req.t_batch_start - req.t_submit) * 1000.0, 4)
            timing_out["jit_step_ms"] = round((req.t_batch_end - req.t_batch_start) * 1000.0, 4)
            timing_out["export_ms"] = round((done - req.t_batch_end) * 1000.0, 4)
            timing_out["mono"] = (req.t_submit, req.t_batch_start, req.t_batch_end, done)
        return req.result

    def _retry_after_locked(self) -> float:
        per_batch = self.stats.avg_batch_seconds() or self.max_wait_s or 0.05
        width = self.policy.buckets[-1]
        # jittered so a burst of shed clients doesn't retry as one
        # thundering herd at the same instant
        return jittered_retry_after(len(self._pending) / max(1, width) * per_batch)

    # -- the flush loop ----------------------------------------------------
    def _take_batch_locked(self) -> List[_Request]:
        """Longest same-deterministic run from the queue head, ≤ max bucket."""
        max_n = self.policy.buckets[-1]
        batch: List[_Request] = []
        while self._pending and len(batch) < max_n:
            if batch and self._pending[0].deterministic != batch[0].deterministic:
                break
            batch.append(self._pending.popleft())
        return batch

    def _flush_loop(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                while not self._pending and not self._stop.is_set():
                    self._cv.wait(timeout=0.1)
                if self._stop.is_set():
                    return
                # deadline flush: give the batch max_wait_s from the OLDEST
                # request to fill the widest bucket, then go with what's there
                deadline = self._pending[0].t_submit + self.max_wait_s
                while (
                    len(self._pending) < self.policy.buckets[-1]
                    and not self._stop.is_set()
                    and time.monotonic() < deadline
                ):
                    self._cv.wait(timeout=max(0.0, deadline - time.monotonic()))
                batch = self._take_batch_locked()
            if batch:
                self._run_batch(batch)
            self._maybe_emit()

    def _run_batch(self, batch: List[_Request]) -> None:
        import numpy as np

        from .policy import tree_map

        n = len(batch)
        t0 = time.monotonic()
        expired: List[int] = []
        for req in batch:
            req.t_batch_start = t0
        try:
            obs = tree_map(lambda *xs: np.concatenate(xs, axis=0), *[r.obs for r in batch])
            actions = self.policy.act_batch(
                obs,
                n,
                deterministic=batch[0].deterministic,
                sessions=[r.session for r in batch],
                expired_out=expired,
            )
        except BaseException as e:  # a bad request must not kill the server
            now = time.monotonic()
            for req in batch:
                req.error = e
                self.stats.record_done(now - req.t_submit, error=True)
                req.event.set()
            return
        t_exec_end = time.monotonic()
        dt = t_exec_end - t0
        for req in batch:
            req.t_batch_end = t_exec_end
        from .policy import _bucket_for

        self.stats.record_batch(n, _bucket_for(n, self.policy.buckets), dt)
        now = time.monotonic()
        expired_set = set(expired)
        for i, req in enumerate(batch):
            if i in expired_set:
                # the session's latent fell off the LRU between submit's
                # expiry check and the batch gather: the row ran on a
                # throwaway initial state — failing only this rider keeps
                # the 410 re-hydrate protocol honest under churn
                req.error = SessionExpired(str(req.session))
                self.stats.record_expired()
                self.stats.record_done(now - req.t_submit, error=True)
            else:
                req.result = actions[i : i + 1]
                self.stats.record_done(now - req.t_submit)
            req.event.set()

    # -- telemetry ---------------------------------------------------------
    def serve_record(self) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "event": "serve",
            "t": round(time.time(), 3),
            "queue_depth": self.queue_depth,
            "retraces": self.policy.retraces_since_warmup(),
            "reloads": self.policy.reload_count,
            "params_version": self.policy.params_version,
            "sessions": len(self.policy.sessions),
        }
        rec.update(self.stats.snapshot())
        return rec

    def _maybe_emit(self) -> None:
        if self._sink is None or self._log_every_s <= 0:
            return
        now = time.monotonic()
        if now - self._last_log < self._log_every_s:
            return
        self._last_log = now
        try:
            self._sink.write(self.serve_record())
        except Exception:
            pass
