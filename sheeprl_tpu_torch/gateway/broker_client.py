"""BrokerClient: the gateway's side of the externalized session broker (the
port's counterpart of ``sheeprl_tpu/gateway/broker_client.py``).

A :class:`~sheeprl_tpu_torch.gateway.broker.SessionBroker` drop-in (``put`` /
``get`` / ``version`` / ``drop`` / ``len``) that speaks the brokerd wire
protocol (`brokerd.py` — the fleet's dual-CRC frames) instead of touching a
dict. The robustness contract, because the gateway's request threads sit
directly behind it:

* **per-op deadlines** — every operation runs under ``op_timeout_s``; when
  the budget is spent :class:`BrokerUnavailable` is raised and the gateway
  degrades to shed (503 + Retry-After) instead of pinning a request thread
  on a sick broker.
* **reconnect with jittered backoff** — a dropped/timed-out link is rebuilt
  with ``with_retries`` semantics, bounded by the op deadline.
* **idempotent versioned PUTs** — each PUT carries this client's monotonic
  ``client_seq``; a reconnect replays the SAME op with the SAME seq and the
  broker's dedup map answers with the originally assigned version without
  re-applying — at-least-once on the wire, exactly-once in the store.
* **failover** — endpoints are a list (primary first, standby second). A
  ``NOT_PRIMARY`` answer or a dead link rotates to the next endpoint; the
  client accepts a broker only when it claims ``primary`` at an epoch >=
  the highest epoch this client has ever seen (client-side fencing: a
  zombie primary that still answers is refused once the standby's
  promotion has been observed).

One connection, ops serialized under a lock: broker ops are sub-millisecond
header-sized exchanges, so serialization is simpler than a pool and never
reorders a session's PUTs.
"""
from __future__ import annotations

import random
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..fleet.net import StreamDecoder, _emit
from .brokerd import (
    B_HELLO_ACK,
    B_REFUSE,
    B_RESP,
    Q_DROP,
    Q_GET,
    Q_PUT,
    Q_STAT,
    R_CLIENT,
    ST_MISS,
    ST_NOT_PRIMARY,
    ST_OK,
    _B_HELLO_ACK_T,
    _configure,
    _send_deadline,
    decode_resp,
    encode_hello,
    encode_req,
)

__all__ = ["BrokerClient", "BrokerUnavailable"]

# sentinel: _op must allocate the PUT idempotency seq itself, inside the
# lock hold that performs the exchange (see _op's docstring for why)
_ALLOC = -2

# __len__ refreshes its cached session count at most this often
_LEN_REFRESH_S = 2.0


class BrokerUnavailable(RuntimeError):
    """No broker answered inside the op deadline (all endpoints down
    or refusing) — the gateway's cue to shed, not to wait."""


class BrokerClient:
    """Session-broker surface over TCP with deadlines, replay and failover."""

    def __init__(
        self,
        endpoints: List[Tuple[str, int]],
        token: str,
        client_id: Optional[str] = None,
        op_timeout_s: float = 2.0,
        connect_timeout_s: float = 2.0,
        io_timeout_s: float = 0.25,
        backoff_s: float = 0.05,
        max_backoff_s: float = 0.5,
        jitter: float = 0.5,
        emit: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> None:
        if not endpoints:
            raise ValueError("BrokerClient needs at least one (host, port) endpoint")
        self.endpoints = [(str(h), int(p)) for h, p in endpoints]
        self.token = str(token)
        if client_id is None:
            import uuid

            # restart-unique: the broker's dedup map is DURABLE (WAL +
            # snapshot), so a restarted gateway reusing an old client id
            # with a reset _put_seq would have every fresh PUT swallowed as
            # a "replay" of the old client's high-water. A uuid per client
            # instance can never collide with a persisted predecessor.
            client_id = f"gw-{uuid.uuid4().hex}"
        self.client_id = str(client_id).encode("ascii", "replace")[:32]
        self.op_timeout_s = float(op_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.emit = emit
        self._lock = threading.RLock()
        self._sock: Optional[socket.socket] = None
        self._decoder = StreamDecoder()
        self._ep_idx = 0
        self._req_id = 0
        self._put_seq = 0  # per-client monotonic: the idempotency token
        self._ops = 0
        self._max_epoch = 0
        self._reconnects = 0
        self._failovers = 0
        self._rng = random.Random(0xB40C ^ len(self.client_id))
        self._closed = False
        # the broker is trusted infrastructure and the evictions counter is
        # part of the SessionBroker surface — served from STAT on demand
        self.evictions = 0
        self._last_sessions = 0  # last known count, the __len__ fallback
        self._last_stat_t = -1e9  # when __len__ last attempted a refresh

    # -- connection management (all under _lock) -----------------------------
    def _connect_locked(self, deadline: float) -> bool:
        """Try each endpoint once (starting at the current cursor) until one
        accepts this client as a primary at a non-regressing epoch."""
        for _ in range(len(self.endpoints)):
            host, port = self.endpoints[self._ep_idx]
            budget = min(self.connect_timeout_s, max(0.05, deadline - time.monotonic()))
            try:
                sock = socket.create_connection((host, port), timeout=budget)
            except OSError:
                self._ep_idx = (self._ep_idx + 1) % len(self.endpoints)
                continue
            _configure(sock, self.io_timeout_s)
            try:
                _send_deadline(
                    sock,
                    encode_hello(R_CLIENT, self._max_epoch, 0, self.token, self.client_id),
                    budget,
                )
                ack = self._read_hello_ack(sock, deadline)
            except OSError:
                ack = None
            if ack is None:
                try:
                    sock.close()
                except OSError:
                    pass
                self._ep_idx = (self._ep_idx + 1) % len(self.endpoints)
                continue
            role, epoch, _seq = ack
            if role != 1 or epoch < self._max_epoch:
                # not a primary, or a zombie claiming an epoch this client
                # has already seen superseded: client-side fencing
                try:
                    sock.close()
                except OSError:
                    pass
                self._ep_idx = (self._ep_idx + 1) % len(self.endpoints)
                continue
            self._max_epoch = max(self._max_epoch, epoch)
            self._sock = sock
            self._decoder = StreamDecoder()
            return True
        return False

    def _read_hello_ack(
        self, sock: socket.socket, deadline: float
    ) -> Optional[Tuple[int, int, int]]:
        decoder = StreamDecoder()
        while time.monotonic() < deadline:
            try:
                data = sock.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                return None
            if not data:
                return None
            for ftype, payload in decoder.feed(data):
                if ftype == B_HELLO_ACK and len(payload) == _B_HELLO_ACK_T.size:
                    role, epoch, seq = _B_HELLO_ACK_T.unpack(payload)
                    return role, epoch, seq
                if ftype == B_REFUSE:
                    return None
        return None

    def _drop_conn_locked(self, reason: str) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._reconnects += 1
            _emit(
                self.emit,
                {
                    "event": "broker",
                    "action": "client_reconnect",
                    "epoch": int(self._max_epoch),
                    "detail": str(reason)[:200],
                },
            )

    # -- the op engine -------------------------------------------------------
    def _op(
        self,
        op: int,
        sid: bytes,
        blob: bytes = b"",
        client_seq: int = -1,
        timeout_s: Optional[float] = None,
    ) -> Tuple[int, int, int, bytes]:
        """One request/response exchange under the op deadline, replaying
        across reconnects/failovers. Returns (status, epoch, version, blob);
        raises :class:`BrokerUnavailable` when the deadline is spent.

        A PUT's idempotency seq (``client_seq == _ALLOC``) is allocated
        HERE, inside the same lock hold that performs the exchange — the
        broker's dedup check is ``seq <= last seen``, which is only sound
        if allocation order equals wire order. Allocating in a separate
        lock acquisition lets two gateway threads swap order between
        allocation and send, and the lower seq's put would be silently
        swallowed as a "replay" (its blob never stored — latent corruption
        that only surfaces at the next rehydrate)."""
        budget = self.op_timeout_s if timeout_s is None else float(timeout_s)
        deadline = time.monotonic() + budget
        attempt = 0
        with self._lock:
            if self._closed:
                raise BrokerUnavailable("broker client closed")
            if client_seq == _ALLOC:
                self._put_seq += 1
                client_seq = self._put_seq
            self._ops += 1
            while True:
                if time.monotonic() >= deadline:
                    raise BrokerUnavailable(
                        f"broker op missed its {budget:.2f}s deadline "
                        f"(attempt {attempt})"
                    )
                if self._sock is None and not self._connect_locked(deadline):
                    attempt += 1
                    delay = min(self.max_backoff_s, self.backoff_s * (2 ** max(0, attempt - 1)))
                    delay *= max(0.0, 1.0 + self._rng.uniform(-self.jitter, self.jitter))
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise BrokerUnavailable(
                            f"no broker endpoint reachable inside {budget:.2f}s"
                        )
                    time.sleep(min(max(0.01, delay), remaining))
                    continue
                self._req_id += 1
                req_id = self._req_id
                wire = encode_req(req_id, op, client_seq, sid, blob)
                try:
                    _send_deadline(
                        self._sock, wire, max(0.05, deadline - time.monotonic())
                    )
                    resp = self._await_resp_locked(req_id, deadline)
                except OSError as err:
                    # the link died mid-op: reconnect and REPLAY — for PUTs
                    # the unchanged client_seq makes the replay exactly-once
                    self._drop_conn_locked(f"op failed: {err}")
                    attempt += 1
                    continue
                if resp is None:
                    self._drop_conn_locked("response deadline")
                    attempt += 1
                    continue
                status, epoch, version, out_blob = resp
                self._max_epoch = max(self._max_epoch, epoch)
                if status == ST_NOT_PRIMARY:
                    # a standby (or a fenced zombie): rotate to the next
                    # endpoint — the promoted broker is the one that answers
                    self._failovers += 1
                    self._drop_conn_locked("not primary")
                    self._ep_idx = (self._ep_idx + 1) % len(self.endpoints)
                    _emit(
                        self.emit,
                        {
                            "event": "broker",
                            "action": "client_failover",
                            "epoch": int(self._max_epoch),
                        },
                    )
                    attempt += 1
                    continue
                return status, epoch, version, out_blob

    def _await_resp_locked(
        self, req_id: int, deadline: float
    ) -> Optional[Tuple[int, int, int, bytes]]:
        sock = self._sock
        if sock is None:
            return None
        while time.monotonic() < deadline:
            try:
                data = sock.recv(262144)
            except socket.timeout:
                continue
            if not data:
                raise OSError("broker closed the connection")
            for ftype, payload in self._decoder.feed(data):
                if ftype != B_RESP:
                    continue
                rid, status, epoch, version, blob = decode_resp(payload)
                if rid != req_id:
                    continue  # a stale answer to a deadline-abandoned op
                return status, epoch, version, blob
        return None

    # -- SessionBroker surface -----------------------------------------------
    def put(self, sid: str, blob: str) -> int:
        """Absorb one acked step's latent; returns the broker-assigned
        version. Raises :class:`BrokerUnavailable` past the op deadline."""
        status, _epoch, version, _ = self._op(
            Q_PUT, str(sid).encode("utf-8"), str(blob).encode("ascii"), client_seq=_ALLOC
        )
        if status != ST_OK:
            raise BrokerUnavailable(f"broker PUT answered status {status}")
        return version

    def get(self, sid: str, at_version: int = 0) -> Optional[Tuple[int, str]]:
        """Newest ``(version, blob)``, or the state AT ``at_version`` when
        the broker still holds it (two-deep history) — the gateway passes
        its last ACKED version so an in-doubt PUT a dying primary applied
        but never acked can't leak into the acked trajectory."""
        status, _epoch, version, blob = self._op(
            Q_GET, str(sid).encode("utf-8"), client_seq=max(0, int(at_version))
        )
        if status == ST_MISS:
            return None
        if status != ST_OK:
            raise BrokerUnavailable(f"broker GET answered status {status}")
        return version, blob.decode("ascii")

    def version(self, sid: str) -> int:
        entry = self.get(sid)
        return entry[0] if entry is not None else 0

    def drop(self, sid: str) -> None:
        status, _epoch, _version, _ = self._op(Q_DROP, str(sid).encode("utf-8"))
        if status != ST_OK:
            raise BrokerUnavailable(f"broker DROP answered status {status}")

    def stat(self, timeout_s: Optional[float] = None) -> Dict[str, Any]:
        import pickle

        status, _epoch, _version, blob = self._op(Q_STAT, b"", timeout_s=timeout_s)
        if status != ST_OK:
            raise BrokerUnavailable(f"broker STAT answered status {status}")
        stats = pickle.loads(blob)
        with self._lock:
            self.evictions = int(stats.get("evictions", self.evictions))
            self._last_sessions = int(stats.get("sessions", self._last_sessions))
        return stats

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "reconnects": self._reconnects,
                "failovers": self._failovers,
                "max_epoch": self._max_epoch,
                "ops": self._ops,
            }

    def __len__(self) -> int:
        # health/metrics surfaces poll this ON THE REQUEST/HEALTH PATH: a
        # sick broker must degrade the number without stalling the caller
        # or queueing real PUTs behind the client lock. The count is served
        # from cache and refreshed by an inline short-deadline STAT at most
        # once per _LEN_REFRESH_S — during an outage the lock is only ever
        # held for one bounded attempt per window, not per probe
        now = time.monotonic()
        with self._lock:
            fresh = now - self._last_stat_t < _LEN_REFRESH_S
            cached = self._last_sessions
        if fresh:
            return cached
        try:
            count = int(self.stat(timeout_s=min(0.25, self.op_timeout_s)).get("sessions", 0))
        except BrokerUnavailable:
            count = cached
        with self._lock:
            self._last_stat_t = now  # failures wait out the window too
        return count

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
