"""brokerd: the externalized, replicated session-broker daemon (the port's
counterpart of ``sheeprl_tpu/gateway/brokerd.py``; its frames are the
reference's, byte for byte).

The gateway's :class:`~sheeprl_tpu_torch.gateway.broker.SessionBroker` is an
in-process dict — every sticky session's source of truth dies with the one
gateway process, and a second gateway can never start (the ROADMAP's
"millions-of-users ingress plane" prerequisite). This daemon externalizes
it: a standalone process speaking the fleet's length-prefixed dual-CRC
frame protocol (`fleet/net.py` — the framing is IMPORTED, not re-invented)
over TCP, with the :class:`~sheeprl_tpu_torch.gateway.wal.WalStore` underneath
for durability. Binary end-to-end: the gateway→broker hop moves struct
headers and raw blob bytes, no JSON/base64 re-wrapping.

Topology and failure model:

* **primary** — owns the store; serves client PUT/GET/DROP/STAT; appends
  every mutation to its WAL per the configured durability mode
  (memory/wal/fsync decides when the PUT is acked) and streams the same
  records to attached standbys. With ``sync_replication`` (default) a PUT
  is acked only after the standby's cumulative ack covers it — the
  property that makes a SIGKILLed primary lose zero acked requests
  *while a standby is attached and keeping up*. This is SEMI-sync, the
  availability-biased trade: a standby that stops acking past
  ``repl_timeout_s`` is dropped (emitting ``repl_timeout``) and writes
  are then acked UN-REPLICATED until it re-attaches and catches up via
  ``records_since``/full-state bootstrap — the same documented window as
  running with no standby at all. A primary SIGKILLed inside that window
  loses the since-the-drop acks on failover; doctor's ``broker_failover``
  finding names the runbook step (re-attach a standby promptly) and
  ``broker_lag`` watches the wait p95 that precedes a drop. Shedding
  every write while the standby is gone would be the durability-biased
  alternative — rejected here because a dead standby must not turn the
  whole serving plane into 503s.
* **standby** — tails the primary's WAL stream into its OWN WalStore (its
  durability is real, not a mirror of a promise), acks cumulatively, and
  watches the primary's heartbeats. When the lease (last heartbeat +
  ``lease_s``) expires it PROMOTES itself: bumps the fencing epoch through
  a durable PROMOTE record and starts serving as primary.
* **fencing** — every replicated record carries the epoch that wrote it.
  A promoted standby answers any lower-epoch replication push with
  ``FENCED`` (the zombie-primary's late write is rejected and counted,
  never applied), and the fenced zombie DEMOTES itself — every client op
  it still receives is answered ``NOT_PRIMARY`` so clients fail over.
  Clients enforce the token monotonically too: a broker claiming primary
  at an epoch below the client's high-water is refused client-side.

Like the fleet listener, the HELLO is a FIXED struct — it arrives from an
unauthenticated peer and must be parseable without executing anything;
pickled payloads (the standby bootstrap snapshot) flow only on connections
that already passed the shared-token check, and only broker→broker.

Run it: ``sheeprl_tpu_torch brokerd gateway.broker.listen_port=7070 ...`` (or
``python -m sheeprl_tpu_torch.gateway.brokerd``); chip_smoke.py and the tests spawn
it via :func:`spawn_brokerd` (spawn-ctx process, port reported through a
queue — the replica idiom).
"""
from __future__ import annotations

import pickle
import socket
import struct
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..fleet.net import StreamDecoder, _emit, _send_deadline, encode_frame
from .wal import WalError, WalStore

__all__ = [
    "BrokerServer",
    "brokerd_entry",
    "spawn_brokerd",
    "run_brokerd_from_cfg",
    "main",
]

# broker wire frame types (disjoint from fleet's 1..11 so a misdirected
# frame is an immediate protocol error, not a confusion)
B_HELLO = 20
B_HELLO_ACK = 21
B_REFUSE = 22
B_REQ = 23
B_RESP = 24
B_REPL = 25
B_REPL_ACK = 26
B_HB = 27
B_SNAP = 28
B_FENCED = 29

# HELLO roles
R_CLIENT = 1
R_STANDBY = 2

# client ops
Q_PUT = 1
Q_GET = 2
Q_DROP = 3
Q_STAT = 4

# response statuses
ST_OK = 0
ST_MISS = 1
ST_NOT_PRIMARY = 2
ST_ERR = 3

_B_HELLO_T = struct.Struct(">BIQ64s32s")  # role, epoch, have_seq, token, client_id
_B_HELLO_ACK_T = struct.Struct(">BIQ")  # role(1=primary,2=standby,3=demoted), epoch, seq
_B_HB_T = struct.Struct(">IQ")  # epoch, seq
_B_REPL_ACK_T = struct.Struct(">Q")  # cumulative applied seq
_B_FENCED_T = struct.Struct(">I")  # the fencing epoch
_B_REFUSE_T = struct.Struct(">B")  # fatal?
_REQ_T = struct.Struct(">QBqH")  # req_id, op, client_seq, sid_len (+ sid + blob)
_RESP_T = struct.Struct(">QBIQ")  # req_id, status, epoch, version (+ blob)

_ROLE_CODE = {"primary": 1, "standby": 2, "demoted": 3}


def _configure(sock: socket.socket, io_timeout_s: float) -> None:
    """Deadline + keepalive on every broker socket (accepted connections do
    not inherit the listener's timeout). The chunked-send helper
    (`_send_deadline`) is fleet/net.py's."""
    sock.settimeout(max(0.05, float(io_timeout_s)))
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


def encode_req(req_id: int, op: int, client_seq: int, sid: bytes, blob: bytes = b"") -> bytes:
    return encode_frame(
        B_REQ, _REQ_T.pack(int(req_id), int(op) & 0xFF, int(client_seq), len(sid)) + sid + blob
    )


def decode_req(payload: bytes) -> Tuple[int, int, int, bytes, bytes]:
    req_id, op, client_seq, sid_len = _REQ_T.unpack_from(payload)
    sid = payload[_REQ_T.size: _REQ_T.size + sid_len]
    blob = payload[_REQ_T.size + sid_len:]
    return req_id, op, client_seq, sid, blob


def encode_resp(req_id: int, status: int, epoch: int, version: int, blob: bytes = b"") -> bytes:
    return encode_frame(
        B_RESP, _RESP_T.pack(int(req_id), int(status) & 0xFF, int(epoch), int(version)) + blob
    )


def decode_resp(payload: bytes) -> Tuple[int, int, int, int, bytes]:
    req_id, status, epoch, version = _RESP_T.unpack_from(payload)
    return req_id, status, epoch, version, payload[_RESP_T.size:]


def encode_hello(role: int, epoch: int, have_seq: int, token: str, client_id: bytes) -> bytes:
    return encode_frame(
        B_HELLO,
        _B_HELLO_T.pack(
            int(role) & 0xFF,
            int(epoch),
            int(have_seq),
            token.encode("ascii", "replace")[:64],
            bytes(client_id)[:32],
        ),
    )


class _StandbyLink:
    """Primary-side state for one attached standby: its connection, write
    lock and cumulative acked seq (the sync-replication wait target)."""

    def __init__(self, conn: socket.socket, write_timeout_s: float) -> None:
        self.conn = conn
        self.write_timeout_s = float(write_timeout_s)
        self.wlock = threading.Lock()
        self.cond = threading.Condition()
        self.acked_seq = -1
        self.alive = True

    def send(self, wire: bytes) -> bool:
        try:
            with self.wlock:
                _send_deadline(self.conn, wire, self.write_timeout_s)
            return True
        except OSError:
            self.mark_dead()
            return False

    def note_ack(self, seq: int) -> None:
        with self.cond:
            if seq > self.acked_seq:
                self.acked_seq = seq
            self.cond.notify_all()

    def wait_acked(self, seq: int, timeout_s: float) -> bool:
        deadline = time.monotonic() + float(timeout_s)
        with self.cond:
            while self.alive and self.acked_seq < seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self.cond.wait(timeout=min(remaining, 0.05))
            return self.alive and self.acked_seq >= seq

    def mark_dead(self) -> None:
        with self.cond:
            self.alive = False
            self.cond.notify_all()
        try:
            self.conn.close()
        except OSError:
            pass


class BrokerServer:
    """One broker daemon: a :class:`WalStore` behind a framed TCP endpoint,
    in one of two roles (``primary`` serves, ``standby`` tails + promotes).
    All shared state is guarded by ``_lock``; replication ordering by
    ``_repl_lock`` (appends and catch-up sends serialize there so a standby
    never observes records out of order)."""

    def __init__(
        self,
        store: WalStore,
        token: str,
        host: str = "127.0.0.1",
        port: int = 0,
        role: str = "primary",
        peer: Optional[Tuple[str, int]] = None,
        lease_s: float = 2.0,
        hb_s: float = 0.25,
        sync_replication: bool = True,
        repl_timeout_s: float = 2.0,
        connect_timeout_s: float = 5.0,
        io_timeout_s: float = 0.5,
        write_timeout_s: float = 5.0,
        hello_timeout_s: float = 5.0,
        log_every_s: float = 10.0,
        emit: Optional[Callable[[Dict[str, Any]], None]] = None,
        chaos: Any = None,
    ) -> None:
        if role not in ("primary", "standby"):
            raise ValueError(f"unknown broker role '{role}' (primary|standby)")
        if role == "standby" and peer is None:
            raise ValueError("a standby needs peer=(host, port) of its primary")
        self.store = store
        self.token = str(token)
        self.host = str(host)
        self.role = role
        self.peer = peer
        self.lease_s = float(lease_s)
        self.hb_s = float(hb_s)
        self.sync_replication = bool(sync_replication)
        self.repl_timeout_s = float(repl_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self.write_timeout_s = float(write_timeout_s)
        self.hello_timeout_s = float(hello_timeout_s)
        self.log_every_s = float(log_every_s)
        self.emit = emit
        self.chaos = chaos
        self._lock = threading.RLock()
        self._repl_lock = threading.Lock()
        self._standbys: List[_StandbyLink] = []
        self._client_conns: List[socket.socket] = []
        self._closed = threading.Event()
        self._zombie = False  # chaos: stop heartbeating, keep serving
        self._last_hb = time.monotonic()  # standby: primary liveness clock
        self._synced = False  # standby: promoted only after a real sync
        self._puts = 0
        self._gets = 0
        self._fenced_writes = 0
        self._repl_lag_high = 0
        self._repl_wait_ms: List[float] = []
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.settimeout(max(0.05, self.io_timeout_s))
        self._srv.bind((self.host, int(port)))
        self._srv.listen(64)
        self.port = int(self._srv.getsockname()[1])
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="brokerd-accept", daemon=True
        )
        self._accept_thread.start()
        self._house_thread = threading.Thread(
            target=self._housekeeping_loop, name="brokerd-house", daemon=True
        )
        self._house_thread.start()
        self._tail_thread: Optional[threading.Thread] = None
        if self.role == "standby":
            self._tail_thread = threading.Thread(
                target=self._tail_loop, name="brokerd-tail", daemon=True
            )
            self._tail_thread.start()
        _emit(
            self.emit,
            {
                "event": "broker",
                "action": "listen",
                "role": self.role,
                "epoch": int(self.store.epoch),
                "seq": int(self.store.seq),
                "detail": f"{self.host}:{self.port}",
            },
        )

    # -- role surface --------------------------------------------------------
    def current_role(self) -> str:
        with self._lock:
            return self.role

    def is_primary(self) -> bool:
        return self.current_role() == "primary"

    # -- accept + per-connection readers ------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            _configure(conn, self.io_timeout_s)
            threading.Thread(
                target=self._handshake, args=(conn,), name="brokerd-hello", daemon=True
            ).start()

    def _handshake(self, conn: socket.socket) -> None:
        decoder = StreamDecoder()
        deadline = time.monotonic() + self.hello_timeout_s
        hello: Optional[Tuple[int, int, int, str, bytes]] = None
        try:
            while time.monotonic() < deadline and hello is None:
                try:
                    data = conn.recv(65536)
                except socket.timeout:
                    continue
                if not data:
                    raise OSError("closed before HELLO")
                for ftype, payload in decoder.feed(data):
                    if ftype == B_HELLO and len(payload) == _B_HELLO_T.size:
                        # fixed struct, NEVER pickle: unauthenticated peer
                        role, epoch, have_seq, tok, cid = _B_HELLO_T.unpack(payload)
                        hello = (
                            role,
                            epoch,
                            have_seq,
                            tok.rstrip(b"\0").decode("ascii", "replace"),
                            cid.rstrip(b"\0"),
                        )
                        break
        except OSError:
            try:
                conn.close()
            except OSError:
                pass
            return
        if hello is None:
            self._refuse(conn, "no HELLO inside deadline", fatal=False)
            return
        role, peer_epoch, have_seq, tok, client_id = hello
        if tok != self.token:
            self._refuse(conn, "bad token")
            return
        if role == R_STANDBY and peer_epoch > self.store.epoch:
            # a standby ahead of us in epochs means WE are the superseded
            # zombie — demote before accepting anything
            self._demote(peer_epoch)
        with self._lock:
            my_role = self.role
        ack = encode_frame(
            B_HELLO_ACK,
            _B_HELLO_ACK_T.pack(
                _ROLE_CODE.get(my_role, 3), int(self.store.epoch), int(self.store.seq)
            ),
        )
        try:
            _send_deadline(conn, ack, self.write_timeout_s)
        except OSError:
            try:
                conn.close()
            except OSError:
                pass
            return
        _emit(
            self.emit,
            {
                "event": "broker",
                "action": "accept",
                "role": my_role,
                "epoch": int(self.store.epoch),
                "detail": "standby" if role == R_STANDBY else f"client {client_id!r}",
            },
        )
        if role == R_STANDBY:
            self._attach_standby(conn, have_seq)
        else:
            self._client_loop(conn, decoder, client_id)

    def _refuse(self, conn: socket.socket, reason: str, fatal: bool = True) -> None:
        _emit(self.emit, {"event": "broker", "action": "refuse", "detail": reason})
        try:
            _send_deadline(
                conn, encode_frame(B_REFUSE, _B_REFUSE_T.pack(1 if fatal else 0)),
                self.write_timeout_s,
            )
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass

    # -- client plane --------------------------------------------------------
    def _client_loop(self, conn: socket.socket, decoder: StreamDecoder, client_id: bytes) -> None:
        with self._lock:
            self._client_conns.append(conn)
        try:
            self._client_loop_inner(conn, decoder, client_id)
        finally:
            with self._lock:
                if conn in self._client_conns:
                    self._client_conns.remove(conn)

    def _client_loop_inner(
        self, conn: socket.socket, decoder: StreamDecoder, client_id: bytes
    ) -> None:
        while not self._closed.is_set():
            try:
                data = conn.recv(262144)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            for ftype, payload in decoder.feed(data):
                if ftype != B_REQ:
                    continue
                try:
                    wire = self._serve_req(payload, client_id)
                except Exception as err:  # a bad request must not kill the loop
                    try:
                        req_id = _REQ_T.unpack_from(payload)[0]
                    except struct.error:
                        continue
                    wire = encode_resp(req_id, ST_ERR, self.store.epoch, 0, repr(err).encode()[:200])
                try:
                    _send_deadline(conn, wire, self.write_timeout_s)
                except OSError:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
        try:
            conn.close()
        except OSError:
            pass

    def _serve_req(self, payload: bytes, client_id: bytes) -> bytes:
        req_id, op, client_seq, sid, blob = decode_req(payload)
        with self._lock:
            role = self.role
        if role != "primary" and op != Q_STAT:
            # a standby (or fenced zombie) must not serve: the client fails
            # over to whoever holds the newest epoch
            return encode_resp(req_id, ST_NOT_PRIMARY, self.store.epoch, 0)
        if op == Q_PUT:
            version = self._apply_put(sid, blob, client_id, client_seq)
            if version < 0:
                self._count_fenced_write()
                return encode_resp(req_id, ST_NOT_PRIMARY, self.store.epoch, 0)
            with self._lock:
                self._puts += 1
            return encode_resp(req_id, ST_OK, self.store.epoch, version)
        if op == Q_GET:
            with self._lock:
                self._gets += 1
            # a GET's client_seq field carries the requested version (0 =
            # newest): the gateway's rehydrate-at-acked-version read
            entry = self.store.get(sid, at_version=max(0, client_seq))
            if entry is None:
                return encode_resp(req_id, ST_MISS, self.store.epoch, 0)
            return encode_resp(req_id, ST_OK, self.store.epoch, entry[0], entry[1])
        if op == Q_DROP:
            self._replicated_drop(sid)
            return encode_resp(req_id, ST_OK, self.store.epoch, 0)
        if op == Q_STAT:
            stats = dict(self.store.stats())
            with self._lock:
                stats.update(
                    role=self.role,
                    puts=self._puts,
                    gets=self._gets,
                    fenced_writes=self._fenced_writes,
                    standbys=len([s for s in self._standbys if s.alive]),
                    repl_lag_high=self._repl_lag_high,
                )
            return encode_resp(
                req_id, ST_OK, self.store.epoch, 0,
                pickle.dumps(stats, protocol=pickle.HIGHEST_PROTOCOL),
            )
        return encode_resp(req_id, ST_ERR, self.store.epoch, 0, b"unknown op")

    def _count_fenced_write(self) -> None:
        with self._lock:
            self._fenced_writes += 1

    # -- replication (primary side) -----------------------------------------
    def _apply_put(self, sid: bytes, blob: bytes, client_id: bytes, client_seq: int) -> int:
        """Apply + replicate one PUT. Returns the version, or -1 when this
        node was fenced mid-op (demoted: the write must not be acked)."""
        chaos = self.chaos
        with self._repl_lock:
            with self._lock:
                if self.role != "primary":
                    return -1
            seq_before = self.store.seq
            version = self.store.put(sid, blob, client_id=client_id, client_seq=client_seq)
            if chaos is not None and chaos.broker_zombies(self.store.seq):
                with self._lock:
                    if not self._zombie:
                        self._zombie = True
                        _emit(
                            self.emit,
                            {
                                "event": "broker",
                                "action": "zombie",
                                "role": self.role,
                                "epoch": int(self.store.epoch),
                                "seq": int(self.store.seq),
                                "detail": "chaos: heartbeats stopped, still serving",
                            },
                        )
            new = self.store.records_since(seq_before)
            links = self._live_standbys()
            if new is None:
                # compaction ate the tail mid-put: bootstrap standbys fresh
                state = self.store.encoded_state()
                for link in links:
                    link.send(encode_frame(B_SNAP, state))
            else:
                for seq, rec_payload in new:
                    wire = encode_frame(B_REPL, rec_payload)
                    for link in links:
                        link.send(wire)
            # THIS put's replication target, captured before releasing the
            # lock: reading store.seq afterwards would make this ack wait on
            # other threads' later records and could falsely drop a standby
            # that is keeping up with ours
            target = self.store.seq
        waited = False
        t0 = time.monotonic()
        for link in links:
            if not link.alive:
                continue
            if self.sync_replication:
                waited = True
                if not link.wait_acked(target, self.repl_timeout_s):
                    # a standby that cannot keep up must not wedge the
                    # serving plane: drop it (it reconnects and catches up)
                    link.mark_dead()
                    _emit(
                        self.emit,
                        {
                            "event": "broker",
                            "action": "repl_timeout",
                            "role": "primary",
                            "epoch": int(self.store.epoch),
                            "seq": int(target),
                            "detail": f"standby ack stalled past {self.repl_timeout_s:.1f}s",
                        },
                    )
            with link.cond:
                lag = max(0, target - link.acked_seq)
            with self._lock:
                self._repl_lag_high = max(self._repl_lag_high, lag)
        if waited:
            with self._lock:
                self._repl_wait_ms.append((time.monotonic() - t0) * 1000.0)
                del self._repl_wait_ms[:-512]
        with self._lock:
            if self.role != "primary" or self._closed.is_set():
                return -1  # fenced/closed while replicating: the ack must not go out
        return version

    def _replicated_drop(self, sid: bytes) -> None:
        with self._repl_lock:
            seq_before = self.store.seq
            self.store.drop(sid)
            new = self.store.records_since(seq_before)
            if new:
                for _seq, rec_payload in new:
                    wire = encode_frame(B_REPL, rec_payload)
                    for link in self._live_standbys():
                        link.send(wire)

    def _live_standbys(self) -> List[_StandbyLink]:
        with self._lock:
            self._standbys = [s for s in self._standbys if s.alive]
            return list(self._standbys)

    def _attach_standby(self, conn: socket.socket, have_seq: int) -> None:
        link = _StandbyLink(conn, self.write_timeout_s)
        with self._repl_lock:
            # catch-up under the replication lock so live pushes can never
            # interleave ahead of the backlog
            backlog = self.store.records_since(have_seq)
            if backlog is None:
                ok = link.send(encode_frame(B_SNAP, self.store.encoded_state()))
            else:
                ok = True
                for _seq, rec_payload in backlog:
                    if not link.send(encode_frame(B_REPL, rec_payload)):
                        ok = False
                        break
            if ok:
                with self._lock:
                    self._standbys.append(link)
        if not ok:
            link.mark_dead()
            return
        _emit(
            self.emit,
            {
                "event": "broker",
                "action": "standby_attach",
                "role": "primary",
                "epoch": int(self.store.epoch),
                "seq": int(self.store.seq),
                "count": 0 if backlog is None else len(backlog),
            },
        )
        # reader: cumulative REPL_ACKs + the FENCED verdict of a promoted
        # standby (the zombie-primary demotion path)
        decoder = StreamDecoder()
        while not self._closed.is_set() and link.alive:
            try:
                data = conn.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if not data:
                break
            for ftype, payload in decoder.feed(data):
                if ftype == B_REPL_ACK and len(payload) == _B_REPL_ACK_T.size:
                    link.note_ack(_B_REPL_ACK_T.unpack(payload)[0])
                elif ftype == B_FENCED and len(payload) == _B_FENCED_T.size:
                    (fence_epoch,) = _B_FENCED_T.unpack(payload)
                    self._demote(fence_epoch)
        link.mark_dead()
        _emit(
            self.emit,
            {
                "event": "broker",
                "action": "standby_detach",
                "role": self.current_role(),
                "epoch": int(self.store.epoch),
            },
        )

    def _demote(self, fence_epoch: int) -> None:
        """Fenced by a higher epoch: this node was a zombie primary. Stop
        acking writes — clients get NOT_PRIMARY and fail over."""
        with self._lock:
            if self.role == "demoted":
                return
            self.role = "demoted"
            links = list(self._standbys)
        # wake any _apply_put parked on a replication ack: its final role
        # check turns the in-flight write into NOT_PRIMARY instead of an ack
        for link in links:
            link.mark_dead()
        _emit(
            self.emit,
            {
                "event": "broker",
                "action": "demote",
                "role": "demoted",
                "epoch": int(fence_epoch),
                "seq": int(self.store.seq),
                "detail": f"fenced by epoch {fence_epoch}",
            },
        )

    # -- standby plane -------------------------------------------------------
    def _tail_loop(self) -> None:
        backoff = 0.1
        while not self._closed.is_set():
            with self._lock:
                if self.role != "standby":
                    return
                synced = self._synced
            if synced and time.monotonic() - self._last_hb > self.lease_s:
                self._promote()
                return
            sock = self._tail_connect()
            if sock is None:
                time.sleep(min(backoff, 1.0))
                backoff = min(backoff * 2, 1.0)
                continue
            backoff = 0.1
            self._tail_read(sock)

    def _tail_connect(self) -> Optional[socket.socket]:
        assert self.peer is not None
        try:
            sock = socket.create_connection(self.peer, timeout=self.connect_timeout_s)
        except OSError:
            return None
        _configure(sock, self.io_timeout_s)
        try:
            _send_deadline(
                sock,
                encode_hello(R_STANDBY, self.store.epoch, self.store.seq, self.token, b"standby"),
                self.write_timeout_s,
            )
        except OSError:
            try:
                sock.close()
            except OSError:
                pass
            return None
        return sock

    def _tail_read(self, sock: socket.socket) -> None:
        decoder = StreamDecoder()
        try:
            while not self._closed.is_set():
                with self._lock:
                    promoted = self.role != "standby"
                if not promoted and self._synced and time.monotonic() - self._last_hb > self.lease_s:
                    self._promote()
                    promoted = True
                # after promotion the link to the old primary is kept OPEN on
                # purpose: its late replication pushes must be answered with
                # FENCED (the zombie-primary rejection), not a silent close —
                # _tail_frame's epoch check does exactly that once the epoch
                # has been bumped
                try:
                    data = sock.recv(262144)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not data:
                    return
                for ftype, payload in decoder.feed(data):
                    if not self._tail_frame(sock, ftype, payload):
                        return
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _tail_frame(self, sock: socket.socket, ftype: int, payload: bytes) -> bool:
        if ftype == B_HELLO_ACK and len(payload) == _B_HELLO_ACK_T.size:
            _role, epoch, _seq = _B_HELLO_ACK_T.unpack(payload)
            if epoch < self.store.epoch:
                # a lower-epoch "primary" is a zombie: never follow it
                return False
            # NOT synced yet: the bootstrap (snapshot/backlog) is still in
            # flight, and heartbeats only start once it completes — marking
            # synced here would arm the promotion lease against a transfer
            # that can legitimately outlast it, promoting a standby with
            # EMPTY state while the primary is alive and mid-send
            self._last_hb = time.monotonic()
            _emit(
                self.emit,
                {
                    "event": "broker",
                    "action": "tail_attach",
                    "role": "standby",
                    "epoch": int(epoch),
                    "seq": int(self.store.seq),
                },
            )
        elif ftype == B_SNAP:
            from .wal import StaleEpoch

            try:
                self.store.load_state(payload)
            except StaleEpoch:
                # a zombie's bootstrap push: snapshots obey the same fencing
                # rule as records — reject, tell the sender, keep our state.
                # This is the fencing design WORKING (the `fenced` event
                # below covers it), not a sync failure
                self._reject_zombie_record(sock, -1)
                return True
            except WalError as err:
                _emit(
                    self.emit,
                    {"event": "broker", "action": "sync_failed", "detail": str(err)[:200]},
                )
                return False
            with self._lock:
                self._synced = True
            self._last_hb = time.monotonic()
            self._ack(sock)
        elif ftype == B_REPL:
            from .wal import decode_record

            try:
                rec_epoch = decode_record(payload)["epoch"]
            except (WalError, struct.error):
                return False
            if rec_epoch < self.store.epoch:
                # fencing: a record written by a lower epoch arrives AFTER
                # this node promoted — the zombie's late write is rejected,
                # counted, and the zombie is told so
                self._reject_zombie_record(sock, rec_epoch)
                return True
            try:
                self.store.apply_wire(payload)
            except WalError as err:
                # a gap means frames were lost: resync from scratch
                _emit(
                    self.emit,
                    {"event": "broker", "action": "sync_failed", "detail": str(err)[:200]},
                )
                return False
            with self._lock:
                self._synced = True
            self._last_hb = time.monotonic()
            self._ack(sock)
        elif ftype == B_HB and len(payload) == _B_HB_T.size:
            epoch, _seq = _B_HB_T.unpack(payload)
            if epoch >= self.store.epoch:
                # the first heartbeat is also what marks the tail SYNCED:
                # heartbeats only flow once the primary finished this
                # standby's catch-up, so the promotion lease is never armed
                # against an in-flight bootstrap
                with self._lock:
                    self._synced = True
                self._last_hb = time.monotonic()
        elif ftype == B_REFUSE:
            return False
        return True

    def _reject_zombie_record(self, sock: socket.socket, rec_epoch: int) -> None:
        with self._lock:
            self._fenced_writes += 1
        _emit(
            self.emit,
            {
                "event": "broker",
                "action": "fenced",
                "role": self.current_role(),
                "epoch": int(self.store.epoch),
                "detail": f"rejected zombie write from epoch {rec_epoch}",
            },
        )
        try:
            _send_deadline(
                sock,
                encode_frame(B_FENCED, _B_FENCED_T.pack(int(self.store.epoch))),
                self.io_timeout_s,
            )
        except OSError:
            pass

    def _ack(self, sock: socket.socket) -> None:
        try:
            _send_deadline(
                sock,
                encode_frame(B_REPL_ACK, _B_REPL_ACK_T.pack(int(self.store.seq))),
                self.io_timeout_s,
            )
        except OSError:
            pass

    def _promote(self) -> None:
        with self._lock:
            if self.role != "standby":
                return
            overdue = time.monotonic() - self._last_hb
            self.role = "primary"
        epoch = self.store.bump_epoch()
        _emit(
            self.emit,
            {
                "event": "broker",
                "action": "promote",
                "role": "primary",
                "epoch": int(epoch),
                "seq": int(self.store.seq),
                "promotion_s": round(overdue, 3),
                "detail": f"lease expired after {overdue:.2f}s without a heartbeat",
            },
        )

    # -- housekeeping --------------------------------------------------------
    def _housekeeping_loop(self) -> None:
        last_log = time.monotonic()
        while not self._closed.wait(self.hb_s):
            with self._lock:
                role = self.role
                zombie = self._zombie
            if role == "primary" and not zombie:
                wire = encode_frame(
                    B_HB, _B_HB_T.pack(int(self.store.epoch), int(self.store.seq))
                )
                for link in self._live_standbys():
                    link.send(wire)
            now = time.monotonic()
            if self.log_every_s > 0 and now - last_log >= self.log_every_s:
                last_log = now
                self._emit_interval()

    def _emit_interval(self) -> None:
        with self._lock:
            waits = sorted(self._repl_wait_ms)
            rec = {
                "event": "broker",
                "action": "interval",
                "role": self.role,
                "epoch": int(self.store.epoch),
                "seq": int(self.store.seq),
                "sessions": len(self.store),
                "puts": self._puts,
                "gets": self._gets,
                "fenced_writes": self._fenced_writes,
                "standbys": len([s for s in self._standbys if s.alive]),
                "lag": int(self._repl_lag_high),
            }
        if waits:
            rec["repl_wait_p95_ms"] = round(
                waits[min(len(waits) - 1, int(round(0.95 * (len(waits) - 1))))], 3
            )
        rec["fsync_p95_ms"] = round(self.store.fsync_p95_ms(), 3)
        _emit(self.emit, rec)

    def close(self) -> None:
        """Hard stop: no in-flight request may be served (or acked) against
        a closing daemon — the connections are severed FIRST, so a client
        whose op was mid-exchange reconnects and replays idempotently
        against whoever serves next (the standby, once promoted)."""
        self._closed.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._client_conns)
            self._client_conns.clear()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        for link in self._live_standbys():
            link.mark_dead()
        self._emit_interval()
        self.store.close()


# -- process entrypoints ------------------------------------------------------
def _server_from_spec(spec: Dict[str, Any]) -> BrokerServer:
    emit = None
    if spec.get("telemetry_dir"):
        from ..telemetry.tracing import open_process_stream

        sink = open_process_stream(
            spec["telemetry_dir"], "broker", int(spec.get("broker_id", 0)),
            incarnation=int(spec.get("incarnation", 0)),
        )
        # in-band telemetry relay: with a relay_url (the gateway's
        # POST /admin/telemetry) the broker's stream — repl lag, fsync p95,
        # failover events — also shows up in the live plane
        if spec.get("relay_url"):
            from ..telemetry.relay import RelaySink, TeeSink, http_post_sender

            tee = TeeSink(sink)
            tee.attach_relay(
                RelaySink(
                    http_post_sender(str(spec["relay_url"])),
                    role="broker",
                    index=int(spec.get("broker_id", 0)),
                    sample=float(spec.get("relay_sample", 1.0)),
                    flush_s=float(spec.get("relay_flush_s", 2.0)),
                )
            )
            sink = tee
        emit = sink.write
    chaos = None
    if spec.get("chaos"):
        from ..resilience.chaos import ChaosInjector

        chaos = ChaosInjector(int(spec.get("broker_id", 0)), **dict(spec["chaos"]))
    store = WalStore(
        wal_dir=spec.get("wal_dir"),
        max_sessions=int(spec.get("max_sessions", 1_000_000)),
        durability=str(spec.get("durability", "wal")),
        compact_bytes=int(spec.get("compact_bytes", 64 * 1024 * 1024)),
        text=False,
        emit=emit,
    )
    peer = spec.get("peer")
    return BrokerServer(
        store,
        token=str(spec.get("token", "")),
        host=str(spec.get("host", "127.0.0.1")),
        port=int(spec.get("port", 0)),
        role=str(spec.get("role", "primary")),
        peer=tuple(peer) if peer else None,
        lease_s=float(spec.get("lease_s", 2.0)),
        hb_s=float(spec.get("hb_s", 0.25)),
        sync_replication=bool(spec.get("sync_replication", True)),
        repl_timeout_s=float(spec.get("repl_timeout_s", 2.0)),
        io_timeout_s=float(spec.get("io_timeout_s", 0.5)),
        write_timeout_s=float(spec.get("write_timeout_s", 5.0)),
        log_every_s=float(spec.get("log_every_s", 10.0)),
        emit=emit,
        chaos=chaos,
    )


def brokerd_entry(spec: Dict[str, Any], port_q: Any) -> None:
    """Child-process main: build the daemon, report the bound port, serve
    until SIGTERM (the replica_entry idiom)."""
    import signal

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        server = _server_from_spec(spec)
    except Exception as e:
        print(f"[brokerd] failed to start: {e!r}", file=sys.stderr, flush=True)
        raise
    port_q.put((str(spec.get("role", "primary")), server.port))
    mem_sampler = None
    if server.emit is not None:
        # broker RSS timeline on its own stream (and relayed, when in-band
        # relay is configured) — the broker is the process whose host-side
        # growth (WAL buffers, session maps) no device metric would show
        from ..telemetry.memory import start_sampler

        mem_sampler = start_sampler(None, server.emit, "broker", int(spec.get("broker_id", 0)))
    try:
        while not stop.wait(0.2):
            pass
    finally:
        if mem_sampler is not None:
            try:
                mem_sampler.stop()
            except Exception:
                pass
        server.close()


def spawn_brokerd(spec: Dict[str, Any], timeout_s: float = 30.0) -> Tuple[Any, int]:
    """Spawn one brokerd as a real process (spawn ctx — SIGKILLable by pid,
    which is exactly what the failover bench does to it); returns
    ``(process, bound_port)``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port_q = ctx.Queue()
    proc = ctx.Process(target=brokerd_entry, args=(spec, port_q), daemon=True)
    proc.start()
    try:
        _role, port = port_q.get(timeout=timeout_s)
    except Exception:
        proc.terminate()
        raise RuntimeError(f"brokerd ({spec.get('role')}) did not report a port in {timeout_s}s")
    return proc, int(port)


def run_brokerd_from_cfg(cfg: Any, block: bool = True) -> BrokerServer:
    """The ``sheeprl_tpu_torch brokerd`` workhorse: gateway.broker.* config → one
    daemon process serving until interrupted."""
    sel = cfg.select if hasattr(cfg, "select") else (lambda p, d=None: d)
    peer = sel("gateway.broker.peer", None)
    if isinstance(peer, str) and peer:
        host, _, port = peer.rpartition(":")
        peer = (host or "127.0.0.1", int(port))
    spec = {
        "host": str(sel("gateway.broker.listen_host", "127.0.0.1")),
        "port": int(sel("gateway.broker.listen_port", 7070)),
        "role": str(sel("gateway.broker.role", "primary")),
        "peer": peer,
        "token": str(sel("gateway.broker.token", "sheeprl-broker")),
        "wal_dir": sel("gateway.broker.wal_dir", None),
        "durability": str(sel("gateway.broker.durability", "wal")),
        "max_sessions": int(sel("gateway.broker.max_sessions", 1_000_000)),
        "compact_bytes": int(sel("gateway.broker.compact_bytes", 64 * 1024 * 1024)),
        "lease_s": float(sel("gateway.broker.lease_s", 2.0)),
        "hb_s": float(sel("gateway.broker.hb_s", 0.25)),
        "sync_replication": bool(sel("gateway.broker.sync_replication", True)),
        "repl_timeout_s": float(sel("gateway.broker.repl_timeout_s", 2.0)),
        "telemetry_dir": sel("gateway.broker.telemetry_dir", None),
        "relay_url": sel("gateway.broker.relay_url", None),
        "relay_sample": float(sel("gateway.broker.relay_sample", 1.0)),
        "relay_flush_s": float(sel("gateway.broker.relay_flush_s", 2.0)),
    }
    server = _server_from_spec(spec)
    print(
        f"[brokerd] {spec['role']} on {server.host}:{server.port} "
        f"(durability={spec['durability']}, wal_dir={spec['wal_dir'] or 'memory-only'})",
        flush=True,
    )
    if block:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            server.close()
    return server


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m sheeprl_tpu_torch.gateway.brokerd [gateway.broker.*=...]``"""
    from ..cli import brokerd as cli_brokerd

    cli_brokerd(list(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
