"""The Gateway: sticky-session request routing over the replica fleet (the
port's counterpart of ``sheeprl_tpu/gateway/gateway.py``).

The request-routing plane (this file) is deliberately model-free: it never
decodes an observation or a latent — it admits, routes, forwards JSON, and
keeps the session broker authoritative. The model-execution plane is the
replica PolicyServers behind it (``replica.py``).

Routing rules:

* **sticky sessions** — a ``session_id`` is pinned to one replica
  incarnation (recurrent policies keep their latent cached there). The pin
  breaks only when the replica stops being routable (death, quarantine,
  gateway-observed transport error) — then the session MIGRATES: the router
  picks a survivor and the forwarded request carries the broker's latent
  blob so the survivor resumes from the last acked step. Pins commit on the
  ACK, not on the routing decision: a placement whose forward then failed
  must not be trusted as warm by the next request.
* **freshness-aware placement** — new (and migrating) sessions go to the
  routable replica with the highest ``params_version`` (the /healthz
  freshness fields), ties broken by assigned-session load; draining
  replicas (rolling reload) accept no new sessions.
* **failover without acked loss** — the gateway acknowledges a request only
  AFTER the replica answered and the broker absorbed the updated latent. A
  transport error mid-flight means no ack and no broker advance, so the
  retry on a survivor replays from the last acked state: the client's acked
  trajectory never skips or duplicates a step.
* **admission first** — the AdmissionController sheds (with jittered
  Retry-After) before any replica sees the request; deterministic-eval
  traffic can be marked/classified low-priority and is shed first.

Replica-side idempotency (the documented first-request in-doubt window,
now narrowed to a race): every session request gets ONE ``request_id``,
reused verbatim across the gateway's forward retries. A replica remembers
the last ``(request_id, response)`` per session, so a retried forward whose
first attempt COMPLETED — the step ran but the response was lost to a
timeout or a dropped connection — is answered from the replay cache instead
of stepping the session a second time. This is exactly the case the
acked-state replay could not heal for a session's very FIRST request (no
acked state exists yet to replay from), and the same shield covers the
external-broker first-request in-doubt put: the retried forward replays the
ORIGINAL response body, so the gateway puts (idempotently, by client_seq)
and acks the same post-step state the hidden execution produced. The replay
cache is checked BEFORE any inbound state import — importing the pre-step
rehydration blob and then replaying the post-step body would rewind the
replica's cache out from under the acked trajectory. Residual window: the
cache is populated at COMPLETION, so a retry that arrives while the first
attempt is still mid-step misses it and the session steps twice — that now
requires a single policy step to outlast ``forward_timeout_s`` AND the
retry to land before it finishes, strictly narrower than before (any
post-timeout completion used to be unhealable).

Endpoints mirror the single-replica PolicyServer so clients cannot tell the
difference: ``POST /v1/act``, ``GET /healthz`` (fleet view), ``GET /stats``
(the ``gateway`` telemetry record), ``GET /metrics`` (Prometheus).
"""
from __future__ import annotations

import json
import random
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ..serve.batcher import jittered_retry_after
from ..telemetry import tracing
from .admission import AdmissionController, Shed
from .broker import SessionBroker
from .broker_client import BrokerUnavailable
from .replica import ReplicaHandle, ReplicaManager

__all__ = ["Gateway", "GatewayStats", "NoReplicasAvailable", "Router"]


class NoReplicasAvailable(RuntimeError):
    """No routable replica right now (fleet starting, respawning or gone)."""


class GatewayStats:
    """Thread-safe gateway counters backed by a Prometheus registry —
    the `gateway` analogue of ServeStats."""

    def __init__(self) -> None:
        from ..diag.prometheus import LATENCY_MS_BUCKETS, Registry

        self._lock = threading.Lock()
        self.requests = 0
        self.acked = 0
        self.errors = 0
        self.failovers = 0
        self.migrations = 0
        self.rehydrates = 0
        self.expired = 0
        self.lost = 0
        self.retries = 0
        self.broker_unavailable = 0
        self.registry = Registry(prefix="sheeprl_gateway")
        self._m_requests = self.registry.counter("requests_total", "act requests received")
        self._m_acked = self.registry.counter("acked_total", "requests acknowledged (200)")
        self._m_shed = self.registry.counter("shed_total", "requests shed by admission control")
        self._m_shed_low = self.registry.counter("shed_low_total", "low-priority requests shed")
        self._m_errors = self.registry.counter("errors_total", "requests failed")
        self._m_failovers = self.registry.counter("failovers_total", "replica transport failovers")
        self._m_migrations = self.registry.counter("migrations_total", "sessions migrated to a survivor")
        self._m_rehydrates = self.registry.counter("rehydrates_total", "broker state re-hydrations sent")
        self._m_expired = self.registry.counter("expired_total", "410 session_expired seen from replicas")
        self._m_lost = self.registry.counter("lost_total", "stateful sessions with no recoverable latent")
        self._m_broker_unavailable = self.registry.counter(
            "broker_unavailable_total", "requests shed because a broker op missed its deadline"
        )
        self._m_latency = self.registry.histogram(
            "latency_ms", "gateway end-to-end act latency (ms)", LATENCY_MS_BUCKETS
        )

    def record_request(self) -> None:
        with self._lock:
            self.requests += 1
        self._m_requests.inc()

    def record_shed(self, low: bool) -> None:
        self._m_shed.inc()
        if low:
            self._m_shed_low.inc()

    def record_outcome(self, latency_s: float, acked: bool) -> None:
        with self._lock:
            if acked:
                self.acked += 1
            else:
                self.errors += 1
        (self._m_acked if acked else self._m_errors).inc()
        self._m_latency.observe(latency_s * 1000.0)

    def record_failover(self) -> None:
        with self._lock:
            self.failovers += 1
            self.retries += 1
        self._m_failovers.inc()

    def record_migration(self) -> None:
        with self._lock:
            self.migrations += 1
        self._m_migrations.inc()

    def record_rehydrate(self) -> None:
        with self._lock:
            self.rehydrates += 1
        self._m_rehydrates.inc()

    def record_expired(self) -> None:
        with self._lock:
            self.expired += 1
            self.retries += 1
        self._m_expired.inc()

    def record_lost(self) -> None:
        with self._lock:
            self.lost += 1
        self._m_lost.inc()

    def record_broker_unavailable(self) -> None:
        with self._lock:
            self.broker_unavailable += 1
        self._m_broker_unavailable.inc()

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = {
                "requests": self.requests,
                "acked": self.acked,
                "errors": self.errors,
                "failovers": self.failovers,
                "migrations": self.migrations,
                "rehydrates": self.rehydrates,
                "expired": self.expired,
                "lost": self.lost,
                "retries": self.retries,
                "broker_unavailable": self.broker_unavailable,
            }
        for name, p in (("p50_ms", 0.50), ("p95_ms", 0.95), ("p99_ms", 0.99)):
            out[name] = round(self._m_latency.percentile(p), 3)
        return out


class Router:
    """Sticky session → replica-incarnation pinning with freshness-aware
    placement for new and migrating sessions.

    A pin asserts "this replica incarnation holds the session's latent in
    its cache", and ONLY a successful forward establishes that: ``route``
    never writes pins — the gateway calls :meth:`confirm` on the 200 path.
    A placement whose forward then fails (replica died between routing and
    connecting, fleet momentarily gone) must not move the pin, or the next
    request would be routed as warm to a replica that never saw the session
    and silently restart its latent.

    Pins are LRU-bounded (``max_pins``): per-user session ids must not leak
    gateway memory forever. Losing a pin is harmless — the session's next
    request re-places it with the broker's state attached."""

    def __init__(self, manager: ReplicaManager, max_pins: int = 1_000_000) -> None:
        from collections import OrderedDict

        self.manager = manager
        self.max_pins = int(max_pins)
        self._lock = threading.Lock()
        # sid -> (replica_id, incarnation, stateful, acked_version, suspect);
        # a respawned replica has a fresh (empty) cache, so the incarnation
        # is part of the pin; `stateful` records whether any ack ever
        # carried a latent blob — what distinguishes a recoverable migration
        # from a lost session; `acked_version` is the broker version of the
        # last ACKED put (what a rehydrate must ask for — the broker may be
        # one in-doubt, never-acked put ahead); `suspect` marks a pin whose
        # broker put was abandoned mid-op: the replica cache holds an
        # unacked step, so the next request MUST rehydrate from the acked
        # version instead of trusting the cache
        self._pins: "OrderedDict[str, Tuple[int, int, bool, int, bool]]" = OrderedDict()
        self._rr = 0  # round-robin cursor for sessionless traffic
        self._load: Dict[int, int] = {}  # replica_id -> pinned-session count

    def _pick(self, candidates: List[ReplicaHandle]) -> ReplicaHandle:
        # freshest params first (max params_version), then least loaded
        best_version = max(h.params_version for h in candidates)
        fresh = [h for h in candidates if h.params_version == best_version]
        with self._lock:
            return min(fresh, key=lambda h: (self._load.get(h.replica_id, 0), h.replica_id))

    def route(self, sid: Optional[str]) -> Tuple[ReplicaHandle, bool, bool]:
        """Pick the replica for this request. Returns ``(handle,
        needs_state, migrated)`` — ``needs_state`` is True when the
        replica's cache cannot be assumed to hold the session (unconfirmed
        placement or migration) so the gateway must attach the broker's
        latent; ``migrated`` is True when an EXISTING session is being
        placed away from its previous replica/incarnation. Raises
        :class:`NoReplicasAvailable`."""
        candidates = self.manager.routable()
        if sid is None:
            if not candidates:
                raise NoReplicasAvailable("no routable replica")
            with self._lock:
                self._rr += 1
                return candidates[self._rr % len(candidates)], False, False
        with self._lock:
            pin = self._pins.get(sid)
            if pin is not None:
                self._pins.move_to_end(sid)
        if pin is not None:
            for handle in candidates:
                if (handle.replica_id, handle.incarnation) == pin[:2]:
                    # a suspect pin stays where it is, but its cache holds
                    # an UNACKED step: force a rehydrate from the acked state
                    return handle, bool(pin[4]), False
        # new session, or its replica died/respawned/drained: (re)place it
        placeable = self.manager.routable(include_draining=False) or candidates
        if not placeable:
            raise NoReplicasAvailable("no routable replica")
        return self._pick(placeable), True, pin is not None

    def confirm(
        self,
        sid: str,
        handle: ReplicaHandle,
        stateful: bool = False,
        version: Optional[int] = None,
    ) -> None:
        """Commit the pin after a successful forward: ``handle``'s cache now
        provably holds the session's latest latent. ``stateful`` marks acks
        whose response carried a latent blob (sticky once set);
        ``version`` is the broker version that ack produced (carried so a
        later rehydrate can ask for exactly the acked state). Confirming
        clears any ``suspect`` mark — the ack resolved the in-doubt put."""
        with self._lock:
            old = self._pins.get(sid)
            new = (
                handle.replica_id,
                handle.incarnation,
                bool(stateful) or (old is not None and old[2]),
                int(version) if version is not None else (old[3] if old is not None else 0),
                False,
            )
            self._pins[sid] = new
            self._pins.move_to_end(sid)
            if old is not None and old[0] != handle.replica_id:
                self._load[old[0]] = max(0, self._load.get(old[0], 0) - 1)
            if old is None or old[0] != handle.replica_id:
                self._load[handle.replica_id] = self._load.get(handle.replica_id, 0) + 1
            while len(self._pins) > self.max_pins:
                _, evicted = self._pins.popitem(last=False)
                self._load[evicted[0]] = max(0, self._load.get(evicted[0], 0) - 1)

    def session_stateful(self, sid: str) -> bool:
        """True when some ack for this session carried a latent blob — i.e.
        migrating it WITHOUT state would lose acked trajectory."""
        with self._lock:
            pin = self._pins.get(sid)
            return pin is not None and pin[2]

    def acked_version(self, sid: str) -> int:
        """The broker version of this session's last ACKED put (0 when
        unknown — a fresh/evicted pin): what a rehydrate asks the broker
        for, so an in-doubt put one version ahead is never served as if it
        had been acked."""
        with self._lock:
            pin = self._pins.get(sid)
            return pin[3] if pin is not None else 0

    def mark_suspect(self, sid: str) -> None:
        """The broker put for this session's latest forward was abandoned
        mid-op (broker unavailable): the replica cache now holds an UNACKED
        step and the broker may or may not have absorbed it. Until an ack
        resolves it, every route must rehydrate from the acked version."""
        with self._lock:
            pin = self._pins.get(sid)
            if pin is not None:
                self._pins[sid] = pin[:4] + (True,)

    def unpin(self, sid: str) -> None:
        with self._lock:
            old = self._pins.pop(sid, None)
            if old is not None:
                self._load[old[0]] = max(0, self._load.get(old[0], 0) - 1)

    def pinned_sessions(self) -> int:
        with self._lock:
            return len(self._pins)


class Gateway:
    """Serving-cluster front door: admission → sticky routing → failover."""

    def __init__(
        self,
        manager: ReplicaManager,
        broker: Any = None,  # SessionBroker | WalStore | BrokerClient
        admission: Optional[AdmissionController] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        forward_timeout_s: float = 30.0,
        max_attempts: int = 3,
        shed_deterministic: bool = True,
        max_pins: int = 1_000_000,
        sink: Any = None,
        log_every_s: float = 10.0,
        trace_sample: float = 0.0,
    ) -> None:
        self.manager = manager
        self.broker = broker if broker is not None else SessionBroker()
        self.admission = admission if admission is not None else AdmissionController()
        self.router = Router(manager, max_pins=max_pins)
        self.stats = GatewayStats()
        self.host = str(host)
        self._requested_port = int(port)
        self.forward_timeout_s = float(forward_timeout_s)
        self.max_attempts = max(1, int(max_attempts))
        self.shed_deterministic = bool(shed_deterministic)
        self._sink = sink
        # attachment point for a diag.aggregator.LiveAggregator (wired by
        # build_cluster): receives relayed replica/broker batches via
        # POST /admin/telemetry and serves GET /live snapshots
        self.live: Any = None
        self._log_every_s = float(log_every_s)
        # a request is traced when the client sent a traceparent; on top of
        # that, trace_sample self-originates a trace for that fraction of
        # un-instrumented traffic (0 = only client-initiated traces)
        self.trace_sample = max(0.0, min(1.0, float(trace_sample)))
        self._last_log = time.monotonic()
        self._conn_local = threading.local()  # per-thread replica keep-alives
        self._httpd: Any = None
        self._http_thread: Optional[threading.Thread] = None

    # -- transport (a method so tests can stub it) --------------------------
    def _post(self, url: str, body: Dict[str, Any], timeout_s: float) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """POST JSON; returns (status, parsed body, headers). HTTP error
        statuses are returned, transport failures raise OSError.

        Connections are kept alive and reused per (thread, replica) — the
        replicas speak HTTP/1.1, and a fresh TCP connect per forward would
        pile up TIME_WAIT sockets (ephemeral-port exhaustion reads as
        spurious transport failovers under sustained load). A request whose
        SEND fails on a REUSED connection retries once on a fresh one (a
        stale keep-alive, nothing was delivered — safe to resend). A
        failure AFTER the send is never silently resent: the step may have
        executed, so it surfaces as OSError and the failover layer replays
        from the last ACKED broker state instead of double-stepping."""
        import http.client
        from urllib.parse import urlsplit

        parts = urlsplit(url)
        key = (parts.hostname, parts.port)
        pool = getattr(self._conn_local, "conns", None)
        if pool is None:
            pool = self._conn_local.conns = {}
        payload = json.dumps(body).encode()
        headers = {"Content-Type": "application/json"}
        # the gateway→replica hop carries the W3C header too (body field
        # covers stubbed transports; the header is what standard tooling
        # and the replica's HTTP layer look for). Derived from the body so
        # the test-stubbed `_post(url, body, timeout)` signature holds.
        if body.get("traceparent"):
            headers["traceparent"] = str(body["traceparent"])
        last_err: Optional[BaseException] = None
        for fresh in (False, True):
            conn = None if fresh else pool.pop(key, None)
            reused = conn is not None
            if conn is None:
                conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=timeout_s)
            elif conn.sock is not None:
                conn.sock.settimeout(timeout_s)
            try:
                conn.request("POST", parts.path or "/", payload, headers)
            except (http.client.HTTPException, OSError) as e:
                conn.close()
                last_err = e
                if reused:
                    continue  # stale keep-alive, nothing delivered: resend fresh
                raise OSError(f"replica unreachable: {e}") from e
            try:
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, OSError) as e:
                conn.close()
                # the request was delivered — it may have executed, so this
                # must NOT be resent here: the failover layer replays it
                # from the last acked state
                raise OSError(f"replica unreachable: {e}") from e
            if resp.will_close:
                conn.close()
            else:
                pool[key] = conn
            try:
                parsed = json.loads(data or b"{}")
            except ValueError:
                parsed = {}
            return resp.status, parsed, dict(resp.getheaders())
        raise OSError(f"replica unreachable: {last_err}") from last_err

    # -- the act path --------------------------------------------------------
    def classify_priority(self, payload: Dict[str, Any]) -> str:
        explicit = payload.get("priority")
        if explicit in ("low", "normal", "high"):
            return str(explicit)
        if self.shed_deterministic and bool(payload.get("deterministic", False)):
            return "low"  # deterministic-eval sweeps yield to live traffic
        return "normal"

    def handle_act(self, payload: Dict[str, Any]) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """Admit, route, forward, absorb the latent, ack. Returns
        ``(status, body, headers)`` ready for the HTTP layer (or in-process
        callers: the bench and the tests drive this directly too).

        A ``traceparent`` in the payload (the HTTP layer copies the header
        in) makes the request traced: the gateway stamps its own stage
        spans (admission → route → forward → broker put), forwards the
        context to the replica, and returns the merged per-stage timing in
        the response body."""
        t0 = time.monotonic()
        self.stats.record_request()
        parent = tracing.parse_traceparent(payload.get("traceparent"))
        if parent is None and self.trace_sample > 0 and random.random() < self.trace_sample:
            parent = (tracing.new_trace_id(), tracing.new_span_id())
        trace: Optional[Dict[str, Any]] = None
        if parent is not None:
            trace = {
                "ctx": tracing.child_context(parent),
                "t0": t0,
                "t0_wall": time.time(),
                "stages": {},
            }
        priority = self.classify_priority(payload)
        t_adm0 = time.monotonic()
        try:
            self.admission.admit(priority)
        except Shed as e:
            self.stats.record_shed(low=priority == "low")
            self._maybe_emit()
            return (
                503,
                {"error": str(e), "reason": e.reason, "retry_after_s": round(e.retry_after_s, 3)},
                {"Retry-After": f"{max(1, int(round(e.retry_after_s)))}"},
            )
        if trace is not None:
            trace["stages"]["admission"] = (t_adm0, time.monotonic())
        try:
            return self._forward_with_failover(payload, t0, trace)
        finally:
            self.admission.release()
            self._maybe_emit()

    def _forward_with_failover(
        self, payload: Dict[str, Any], t0: float, trace: Optional[Dict[str, Any]] = None
    ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        sid = payload.get("session_id")
        sid = str(sid) if sid is not None else None
        # replica-side idempotency key: ONE id per client request, reused
        # verbatim across every forward retry. A retried forward whose first
        # attempt actually executed (the response was lost to a timeout or a
        # dropped connection) is answered from the replica's replay cache
        # instead of stepping the session a second time — this closes the
        # first-request in-doubt window the failover replay alone could not
        # (no acked state exists yet to replay from).
        request_id = uuid.uuid4().hex if sid is not None else None
        force_state = False
        last_err: Optional[str] = None
        for attempt in range(self.max_attempts):
            t_route0 = time.monotonic()
            try:
                handle, needs_state, migrated = self.router.route(sid)
            except NoReplicasAvailable:
                # the fleet is respawning: tell the client when to come back
                retry = jittered_retry_after(max(self.manager.backoff_s, 0.25))
                self.stats.record_outcome(time.monotonic() - t0, acked=False)
                return (
                    503,
                    {"error": "no replica available", "retry_after_s": round(retry, 3)},
                    {"Retry-After": f"{max(1, int(round(retry)))}"},
                )
            if trace is not None:
                trace["stages"]["route"] = (t_route0, time.monotonic())
            body = {
                "obs": payload.get("obs"),
                "deterministic": bool(payload.get("deterministic", False)),
            }
            # flywheel capture passthrough: client-reported reward/done for
            # the session's previous step ride to the replica's capture hook
            for extra in ("reward", "done"):
                if extra in payload:
                    body[extra] = payload[extra]
            if trace is not None:
                # the replica hop continues THIS trace: its stage spans land
                # on the replica's own stream with the same trace_id
                body["traceparent"] = tracing.make_traceparent(
                    trace["ctx"].trace_id, trace["ctx"].span_id
                )
            if sid is not None:
                body["session_id"] = sid
                body["request_id"] = request_id
                body["return_state"] = True
                if attempt:
                    # a retry: an earlier attempt may have stepped and been
                    # captured on a replica that died before answering; the
                    # capture reader keeps only the trace's latest attempt
                    body["attempt"] = attempt
                if needs_state or force_state:
                    try:
                        # ask for the state AT the last acked version: the
                        # broker may be one in-doubt (applied-but-unacked)
                        # put ahead, and serving that state would skip an
                        # acked step on the client's trajectory
                        entry = self.broker.get(
                            sid, at_version=self.router.acked_version(sid)
                        )
                    except BrokerUnavailable as e:
                        # the broker missed its op deadline BEFORE any step
                        # ran: degrade to shed — a slow broker must cost the
                        # client a bounded 503, never a pinned request thread
                        return self._broker_shed(t0, "get", e)
                    if entry is not None:
                        body["session_state"] = entry[1]
                        self.stats.record_rehydrate()
                    elif self.router.session_stateful(sid):
                        # the latent is gone everywhere: the replica cache is
                        # unreachable/evicted AND the broker dropped its copy.
                        # Silently re-initializing would corrupt the acked
                        # trajectory — report the loss, and unpin so a later
                        # request under this id starts a FRESH session (HTTP
                        # Gone semantics) instead of 410ing forever
                        self.router.unpin(sid)
                        self.stats.record_lost()
                        self.stats.record_outcome(time.monotonic() - t0, acked=False)
                        return (
                            410,
                            {"error": "session_lost", "session_id": sid},
                            {},
                        )
            t_fwd0 = time.monotonic()
            try:
                status, resp, headers = self._post(
                    f"{handle.url}/v1/act", body, self.forward_timeout_s
                )
            except OSError as e:
                # transport death mid-flight: nothing was acked, the broker
                # did not advance — fail over and replay from the last acked
                # state on a survivor
                last_err = repr(e)
                self.manager.report_failure(handle.replica_id, e)
                self.stats.record_failover()
                force_state = True
                continue
            if status == 410:
                # the replica LRU-evicted this session: re-hydrate from the
                # broker and retry (same replica unless it died meanwhile)
                self.stats.record_expired()
                force_state = True
                last_err = "session_expired"
                continue
            if status == 200:
                if trace is not None:
                    trace["stages"]["forward"] = (t_fwd0, time.monotonic())
                blob = resp.pop("session_state", None)
                if sid is not None:
                    if blob is not None:
                        t_put0 = time.monotonic()
                        try:
                            resp["session_version"] = self.broker.put(sid, blob)
                        except BrokerUnavailable as e:
                            # the replica DID step but the put's outcome is
                            # unknown (it may have been applied with the ack
                            # lost) — acking would break the ack-after-
                            # broker-put contract. Mark the pin suspect: the
                            # next request rehydrates the replica from the
                            # last ACKED version (rewinding the cache's
                            # unacked step, and refusing the broker's newest
                            # if the in-doubt put did land). Shed this one.
                            self.router.mark_suspect(sid)
                            return self._broker_shed(t0, "put", e)
                        if trace is not None:
                            trace["stages"]["broker_put"] = (t_put0, time.monotonic())
                    # the ack — not the routing decision — is what proves the
                    # replica's cache holds the session now; the version
                    # rides along so a later rehydrate can name the acked
                    # state exactly
                    self.router.confirm(
                        sid,
                        handle,
                        stateful=blob is not None,
                        version=resp.get("session_version"),
                    )
                    if migrated:
                        self.stats.record_migration()
                resp["replica"] = handle.replica_id
                if trace is not None:
                    self._finish_trace(trace, resp, handle.replica_id, sid)
                self.stats.record_outcome(time.monotonic() - t0, acked=True)
                return 200, resp, {}
            # non-retryable upstream answer (400 bad obs, 503 backpressure,
            # 504 deadline): pass it through verbatim, Retry-After included
            self.stats.record_outcome(time.monotonic() - t0, acked=False)
            out_headers = {}
            if "Retry-After" in headers:
                out_headers["Retry-After"] = headers["Retry-After"]
            resp.setdefault("replica", handle.replica_id)
            return status, resp, out_headers
        self.stats.record_outcome(time.monotonic() - t0, acked=False)
        return (
            502,
            {"error": f"all {self.max_attempts} forward attempts failed", "last_error": last_err},
            {},
        )

    def _broker_shed(
        self, t0: float, op: str, err: BaseException
    ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        """A broker op missed ``gateway.broker.op_timeout_s``: answer 503
        with a jittered Retry-After (the broker client already burned the
        op deadline, so the thread was bounded end to end)."""
        self.stats.record_broker_unavailable()
        self.stats.record_outcome(time.monotonic() - t0, acked=False)
        retry = jittered_retry_after(0.5)
        return (
            503,
            {
                "error": f"session broker unavailable ({op}): {err}",
                "reason": "broker_unavailable",
                "retry_after_s": round(retry, 3),
            },
            {"Retry-After": f"{max(1, int(round(retry)))}"},
        )

    def _finish_trace(
        self,
        trace: Dict[str, Any],
        resp: Dict[str, Any],
        replica_id: int,
        sid: Optional[str],
    ) -> None:
        """Close out a traced ack: merge the replica's timing under the
        gateway's stage breakdown in the response body, and emit one
        ``trace_span`` per gateway stage (sink + Prometheus mirror)."""
        ctx = trace["ctx"]
        anchor = trace["t0_wall"] - trace["t0"]  # wall == mono + anchor
        timing: Dict[str, Any] = {}
        replica_timing = resp.pop("timing", None)
        for name, (a, b) in trace["stages"].items():
            timing[f"{name}_ms"] = round((b - a) * 1000.0, 4)
            rec = tracing.span_record(
                name,
                "gateway",
                tracing.TraceContext(ctx.trace_id, tracing.new_span_id(), ctx.span_id),
                a + anchor,
                b + anchor,
                replica=int(replica_id),
            )
            if sid is not None:
                rec["session_id"] = sid
            self._trace_emit(rec)
        if replica_timing:
            timing["replica"] = replica_timing
        resp["timing"] = timing
        resp["trace_id"] = ctx.trace_id

    def _trace_emit(self, rec: Dict[str, Any]) -> None:
        # the span goes to both surfaces: the JSONL stream diag/trace.py
        # merges, and the live registry's role/stage-labeled histograms
        if self._sink is not None:
            try:
                self._sink.write(rec)
            except Exception:
                pass
        try:
            self.stats.registry.observe_event(rec)
        except Exception:
            pass

    # -- fleet views ---------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        routable = self.manager.routable()
        versions = [h.params_version for h in routable if h.params_version >= 0]
        return {
            "status": "ok" if routable else "degraded",
            "replicas": self.manager.num_replicas,
            "routable": len(routable),
            "alive": self.manager.alive_count(),
            "quarantined": self.manager.quarantined_ids(),
            "params_version_min": min(versions) if versions else -1,
            "params_version_max": max(versions) if versions else -1,
            "sessions": self.router.pinned_sessions(),
            "broker_sessions": len(self.broker),
        }

    def gateway_record(self) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "event": "gateway",
            "t": round(time.time(), 3),
            "replicas": self.manager.num_replicas,
            "routable": len(self.manager.routable()),
            "quarantined": len(self.manager.quarantined_ids()),
            "respawns": self.manager.total_respawns,
            "sessions": self.router.pinned_sessions(),
            "broker_sessions": len(self.broker),
        }
        rec.update(self.stats.snapshot())
        rec.update({f"admission_{k}": v for k, v in self.admission.snapshot().items()})
        return rec

    def metrics_text(self) -> str:
        registry = self.stats.registry
        registry.gauge("inflight", "admitted requests in flight").set(
            float(self.admission.snapshot()["inflight"])
        )
        registry.gauge("replicas_routable", "replicas accepting traffic").set(
            float(len(self.manager.routable()))
        )
        registry.gauge("replicas_quarantined", "replicas quarantined").set(
            float(len(self.manager.quarantined_ids()))
        )
        registry.gauge("sessions_pinned", "sticky sessions pinned").set(
            float(self.router.pinned_sessions())
        )
        registry.gauge("broker_sessions", "sessions held by the broker").set(
            float(len(self.broker))
        )
        return registry.render()

    def ingest_telemetry(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One relayed batch (``POST /admin/telemetry`` body) into the
        attached aggregator; returns the accept/invalid counts the sender
        sees. Without an aggregator the batch is acknowledged and dropped —
        the sender's local stream is authoritative either way."""
        if self.live is None:
            return {"accepted": 0, "invalid": 0, "aggregator": False}
        out = self.live.ingest_batch(batch)
        return dict(out, aggregator=True) if isinstance(out, dict) else {"aggregator": True}

    def _feed_live(self, rec: Dict[str, Any]) -> None:
        if self.live is not None:
            try:
                self.live.ingest(rec, stream="gateway")
            except Exception:
                pass

    def _maybe_emit(self) -> None:
        if self._sink is None or self._log_every_s <= 0:
            return
        now = time.monotonic()
        if now - self._last_log < self._log_every_s:
            return
        self._last_log = now
        try:
            rec = self.gateway_record()
            self._sink.write(rec)
            self._feed_live(rec)
        except Exception:
            pass

    # -- HTTP lifecycle ------------------------------------------------------
    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd is not None else None

    def start(self) -> "Gateway":
        if self._httpd is None:
            from http.server import ThreadingHTTPServer

            class _HTTPServer(ThreadingHTTPServer):
                # the listen backlog: at the default 5, a burst of clients
                # connecting at once loses SYNs and waits a second to retry
                request_queue_size = 128

            self._httpd = _HTTPServer((self.host, self._requested_port), _make_handler(self))
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True, name="gateway-http"
            )
            self._http_thread.start()
        return self

    def serve_forever(self) -> None:
        self.start()
        try:
            while True:
                threading.Event().wait(3600)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._http_thread = None
        if self._sink is not None:
            try:
                rec = self.gateway_record()
                self._sink.write(rec)
                self._feed_live(rec)
            except Exception:
                pass


def _make_handler(gw: "Gateway"):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # a reply is two writes (headers, then the body): without TCP_NODELAY
        # the body waits for the client's delayed ACK of the headers
        disable_nagle_algorithm = True

        def log_message(self, fmt: str, *args: Any) -> None:  # quiet
            pass

        def _reply(self, code: int, payload: Dict[str, Any], headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:
            if self.path == "/healthz":
                self._reply(200, gw.health())
            elif self.path == "/stats":
                self._reply(200, gw.gateway_record())
            elif self.path == "/metrics":
                from ..diag.prometheus import CONTENT_TYPE

                body = gw.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/live":
                if gw.live is None:
                    self._reply(404, {"error": "no live aggregator attached"})
                else:
                    self._reply(200, gw.live.snapshot())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self) -> None:
            if self.path == "/admin/rolling_reload":
                self._reply(200, {"results": gw.manager.rolling_reload()})
                return
            if self.path == "/admin/telemetry":
                # in-band telemetry relay ingest: replicas (and brokerd) POST
                # {"role","index","events",...} batches here; each event is
                # schema-validated by the aggregator — invalid ones are
                # counted and quarantined, never fatal
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    batch = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(batch, dict):
                        raise ValueError("body must be a JSON batch object")
                except (ValueError, json.JSONDecodeError) as e:
                    self._reply(400, {"error": str(e)})
                    return
                try:
                    self._reply(200, gw.ingest_telemetry(batch))
                except Exception as e:  # ingest must never 500 the relay hop
                    self._reply(200, {"accepted": 0, "invalid": 0, "error": str(e)})
                return
            if self.path == "/admin/profile":
                # on-demand remote profiling fan-out: open a windowed
                # torch.profiler capture on one replica (default: the first
                # routable). {"replica": id?, "duration_s": 2.0?}
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    payload = payload if isinstance(payload, dict) else {}
                except (ValueError, json.JSONDecodeError):
                    payload = {}
                try:
                    rid = payload.get("replica")
                    rid = int(rid) if rid is not None else None
                    duration_s = float(payload.get("duration_s") or 2.0)
                    if rid is not None and not 0 <= rid < gw.manager.num_replicas:
                        raise ValueError(f"replica {rid} out of range")
                except (TypeError, ValueError) as e:
                    self._reply(400, {"error": str(e)})
                    return
                out = gw.manager.request_profile(rid, duration_s)
                self._reply(200 if "error" not in out else 503, out)
                return
            if self.path not in ("/v1/act", "/act"):
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            # the client→gateway hop's W3C header: copied into the payload
            # so the in-process act path (and the bench driving it
            # directly) sees one trace-context field either way
            header_tp = self.headers.get("traceparent")
            if header_tp and not payload.get("traceparent"):
                payload["traceparent"] = header_tp
            try:
                status, body, headers = gw.handle_act(payload)
            except Exception as e:  # the routing plane must never 500 raw
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(status, body, headers)

    return Handler
