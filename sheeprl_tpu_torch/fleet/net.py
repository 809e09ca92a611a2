"""Socket transport for the actor fleet (the port's own copy of
``sheeprl_tpu/fleet/net.py``; its frames are byte for byte the JAX
package's).

Packets are framed wire-shaped — ``(worker_id, incarnation, seq, crc32,
payload)`` with the CRC over the pickled payload (``fleet/protocol.py``). This
module carries the same frames as **length-prefixed byte streams over TCP**,
behind the :class:`~sheeprl_tpu_torch.fleet.protocol.WorkerChannel` surface,
so ``FleetEngine``'s round merge and the Ratio ledger are untouched. A
network link can do things an ``mp.Queue`` never does — partition, corrupt,
stall half-open, replay — so robustness IS the spec:

* **framing + resync** — every wire frame is ``MAGIC | type | length |
  header-CRC | payload-CRC | payload``. A torn read (truncation, byte
  corruption in flight) fails a CRC; the decoder then scans forward to the
  next valid magic+length+CRC boundary — the CRC decides what survives, as
  it does for the mp transport's salvage — so one corrupted frame never
  poisons the clean frames behind it.
* **timeouts everywhere** — connect, accept, read and write all run under
  explicit deadlines; large writes are chunked so a half-open peer (accepts,
  never reads) trips the write deadline instead of wedging a thread.
* **heartbeats** — workers push their liveness counter as tiny ``HB``
  frames at a fixed cadence, *including while parked on backpressure* (the
  same stamped-while-parked semantics as the mp path), so learner-side
  hang detection keeps working and backpressure never looks like a hang.
  ``SO_KEEPALIVE`` rides along for dead-peer detection below the app.
* **credit-based backpressure** — the learner grants an absolute window
  ``(ack, window)``; a worker may have at most ``window`` unacked packets
  in flight. That reproduces the bounded ``mp.Queue`` semantics
  end-to-end: a worker that runs ahead parks on ``put`` (heartbeating),
  never free-runs unboundedly.
* **reconnect + replay + dedup** — the worker side reconnects with
  jittered exponential backoff and replays every unacked frame; the learner
  side dedups by ``(incarnation, seq)`` so a replayed packet is dropped
  exactly once and counted — a reconnect can never double-feed the ledger.
  Frames lost to an in-stream resync are re-requested (``RESEND``) so
  per-worker FIFO order — the round contract — survives corruption.
* **pull-based params** — publications do not push a multi-MB blob per
  worker: the learner announces ``(version)``, workers PULL the newest
  snapshot on connect or on lag. The ``CTRL_CLOCK`` handshake and
  ``CTRL_PROFILE`` ops ride the same connection as opaque ctrl frames.
* **batched acting** — under ``fleet.act_mode=inference`` a worker's act
  requests ride ``T_ACT`` frames to the learner's ActService and come back
  as ``T_ACT_RESP`` on the same link (re-sent while unanswered; the service
  answers a re-send from its idempotency cache).

Every link transition emits a schema'd ``net`` telemetry event (learner
events on the run stream, worker events on the worker's own stream).
"""
from __future__ import annotations

import pickle
import queue as _q
import random
import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "FleetListener",
    "LearnerChannel",
    "NetConfig",
    "NetStats",
    "StreamDecoder",
    "WorkerSocketChannel",
    "encode_frame",
    "encode_data_frame",
    "encode_hello",
    "decode_data_payload",
]

MAGIC = b"SFL1"
_HDR = struct.Struct(">BII")  # type, payload_len, payload_crc32
_HCRC = struct.Struct(">I")  # crc32 over (type, payload_len) — a corrupted
# length field must be caught BEFORE the decoder trusts it and waits on a
# gigabyte that never comes
_DATA_HDR = struct.Struct(">qqqqqI")  # worker_id, incarnation, seq, env_steps, version, crc

# wire frame types
T_HELLO = 1
T_HELLO_ACK = 2
T_REFUSE = 3
T_DATA = 4
T_HB = 5
T_CREDIT = 6
T_RESEND = 7
T_CTRL = 8
T_PUB = 9
T_PULL = 10
T_PARAMS = 11
T_TELEM = 12  # worker→learner relayed telemetry batch (best-effort, unacked)
T_ACT = 13  # worker→learner batched-inference act request (pickled dict)
T_ACT_RESP = 14  # learner→worker act response (pickled dict)

# learner-side cap on buffered (not-yet-drained) relay batches per link
_TELEM_BUFFER_BATCHES = 64

# HELLO is a FIXED struct, never pickle: it arrives from an unauthenticated
# peer (fleet.net.host=0.0.0.0 is the documented multi-host setup) and must
# be parseable without executing anything. Every pickled frame type flows
# only AFTER the token check fences the connection.
_HELLO_T = struct.Struct(">qq64s")  # worker_id, incarnation, token (padded)
_HB_T = struct.Struct(">qq")  # heartbeat counter, applied param version
_CREDIT_T = struct.Struct(">qq")  # ack (last in-order seq), window
_RESEND_T = struct.Struct(">q")  # resend from seq
_PUB_T = struct.Struct(">q")  # announced publication version
_PULL_T = struct.Struct(">q")  # requested (newest-known) version


class NetConfig:
    """Transport knobs (``fleet.net.*``), one plain picklable object so the
    worker spec can carry it into the child process."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        connect_timeout_s: float = 5.0,
        io_timeout_s: float = 0.5,
        write_timeout_s: float = 5.0,
        hello_timeout_s: float = 5.0,
        keepalive_s: float = 0.1,
        backoff_s: float = 0.2,
        max_backoff_s: float = 5.0,
        jitter: float = 0.5,
        reconnect_grace_s: float = 30.0,
        stall_reconnect_s: float = 5.0,
        max_frame_mb: float = 256.0,
    ) -> None:
        self.host = str(host)
        self.port = int(port)
        self.connect_timeout_s = float(connect_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self.write_timeout_s = float(write_timeout_s)
        self.hello_timeout_s = float(hello_timeout_s)
        self.keepalive_s = float(keepalive_s)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.reconnect_grace_s = float(reconnect_grace_s)
        self.stall_reconnect_s = float(stall_reconnect_s)
        self.max_frame_bytes = int(float(max_frame_mb) * 1024 * 1024)

    @classmethod
    def from_cfg(cls, cfg: Any) -> "NetConfig":
        sel = cfg.select if hasattr(cfg, "select") else (lambda p, d=None: d)

        def opt(key: str, default: Any) -> Any:
            v = sel(f"fleet.net.{key}", None)
            return default if v is None else v

        return cls(
            host=str(opt("host", "127.0.0.1")),
            port=int(opt("port", 0)),
            connect_timeout_s=float(opt("connect_timeout_s", 5.0)),
            io_timeout_s=float(opt("io_timeout_s", 0.5)),
            write_timeout_s=float(opt("write_timeout_s", 5.0)),
            hello_timeout_s=float(opt("hello_timeout_s", 5.0)),
            keepalive_s=float(opt("keepalive_s", 0.1)),
            backoff_s=float(opt("backoff_s", 0.2)),
            max_backoff_s=float(opt("max_backoff_s", 5.0)),
            jitter=float(opt("jitter", 0.5)),
            reconnect_grace_s=float(opt("reconnect_grace_s", 30.0)),
            stall_reconnect_s=float(opt("stall_reconnect_s", 5.0)),
            max_frame_mb=float(opt("max_frame_mb", 256.0)),
        )


class NetStats:
    """Fleet-wide link counters, shared by every learner-side channel (they
    outlive individual connections/incarnations so the engine's interval
    snapshot and the drain event can report run totals)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reconnects = 0
        self.dup_frames = 0
        self.resyncs = 0
        self.corrupt_frames = 0
        self.gap_resends = 0
        self.write_timeouts = 0

    def bump(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + int(n))

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "reconnects": self.reconnects,
                "dup_frames": self.dup_frames,
                "resyncs": self.resyncs,
                "corrupt_frames": self.corrupt_frames,
                "gap_resends": self.gap_resends,
                "write_timeouts": self.write_timeouts,
            }


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------
def encode_frame(ftype: int, payload: bytes) -> bytes:
    """One wire frame: ``MAGIC | type u8 | len u32 | hcrc u32 | pcrc u32 |
    payload``. Two CRCs: ``hcrc`` over (type, len) so a corrupted length is
    rejected before it is trusted, ``pcrc`` over the payload so flipped
    payload bytes are rejected before they are decoded."""
    hdr = _HDR.pack(ftype & 0xFF, len(payload), zlib.crc32(payload))
    return MAGIC + hdr + _HCRC.pack(zlib.crc32(hdr[:5])) + payload


_PREFIX_LEN = len(MAGIC) + _HDR.size + _HCRC.size


def encode_hello(worker_id: int, incarnation: int, token: str) -> bytes:
    """The HELLO wire frame (fixed struct — see ``_HELLO_T``)."""
    return encode_frame(
        T_HELLO,
        _HELLO_T.pack(int(worker_id), int(incarnation), token.encode("ascii", "replace")[:64]),
    )


def encode_data_frame(frame: Tuple[int, int, int, int, int, int, bytes]) -> bytes:
    """A protocol.encode_packet tuple → DATA wire bytes. The scalar header
    stays outside the blob (same reason as the mp frame: a torn payload must
    still be accountable to the right worker), and the packet's own CRC
    rides along so the learner re-validates the frame's own CRC."""
    worker_id, incarnation, seq, env_steps, version, crc, blob = frame
    payload = _DATA_HDR.pack(
        int(worker_id), int(incarnation), int(seq), int(env_steps), int(version), crc & 0xFFFFFFFF
    ) + blob
    return encode_frame(T_DATA, payload)


def decode_data_payload(payload: bytes) -> Tuple[int, int, int, int, int, int, bytes]:
    """DATA payload → the protocol frame tuple ``decode_packet`` eats."""
    worker_id, incarnation, seq, env_steps, version, crc = _DATA_HDR.unpack_from(payload)
    return (worker_id, incarnation, seq, env_steps, version, crc, payload[_DATA_HDR.size:])


class StreamDecoder:
    """Incremental frame parser with torn-read resync.

    ``feed(bytes)`` returns every complete valid ``(type, payload)`` frame.
    On any validation failure (bad magic, corrupted header, payload CRC
    mismatch, insane length) the decoder advances one byte past the failed
    magic candidate and scans forward for the next ``MAGIC`` — the CRC
    decides where the stream really resumes. Counters record what was lost
    so the learner can emit the ``net`` resync/corrupt events."""

    def __init__(self, max_frame_bytes: int = 256 * 1024 * 1024) -> None:
        self.max_frame_bytes = int(max_frame_bytes)
        self._buf = bytearray()
        self.resyncs = 0
        self.corrupt_frames = 0
        self.skipped_bytes = 0

    def feed(self, data: bytes) -> List[Tuple[int, bytes]]:
        self._buf.extend(data)
        out: List[Tuple[int, bytes]] = []
        while True:
            buf = self._buf
            if len(buf) < _PREFIX_LEN:
                break  # partial prefix: wait for more bytes (a torn tail is
                # resolved by the resync scan once a full prefix lands)
            if bytes(buf[: len(MAGIC)]) != MAGIC:
                self._resync()
                continue
            hdr = bytes(buf[len(MAGIC): len(MAGIC) + _HDR.size])
            (hcrc,) = _HCRC.unpack_from(buf, len(MAGIC) + _HDR.size)
            if zlib.crc32(hdr[:5]) != hcrc:
                self.corrupt_frames += 1
                self._resync()
                continue
            ftype, plen, pcrc = _HDR.unpack(hdr)
            if plen > self.max_frame_bytes:
                self.corrupt_frames += 1
                self._resync()
                continue
            if len(buf) < _PREFIX_LEN + plen:
                break  # whole frame not here yet
            payload = bytes(buf[_PREFIX_LEN: _PREFIX_LEN + plen])
            if zlib.crc32(payload) != pcrc:
                self.corrupt_frames += 1
                self._resync()
                continue
            del buf[: _PREFIX_LEN + plen]
            out.append((ftype, payload))
        return out

    def _resync(self) -> None:
        """Drop the failed byte(s) and scan to the next magic candidate."""
        self.resyncs += 1
        buf = self._buf
        idx = buf.find(MAGIC, 1)
        if idx < 0:
            # keep a magic-length tail: the next feed may complete a magic
            # that straddles the boundary
            keep = len(MAGIC) - 1
            self.skipped_bytes += max(0, len(buf) - keep)
            del buf[: max(0, len(buf) - keep)]
        else:
            self.skipped_bytes += idx
            del buf[:idx]

    def reset(self) -> None:
        self._buf.clear()


# ---------------------------------------------------------------------------
# low-level socket helpers (every op under an explicit deadline)
# ---------------------------------------------------------------------------
def _configure(sock: socket.socket, io_timeout_s: float) -> None:
    sock.settimeout(max(0.05, float(io_timeout_s)))
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


class _WriteTimeout(OSError):
    """A chunked send missed its overall deadline (half-open peer)."""


def _send_deadline(sock: socket.socket, data: bytes, deadline_s: float) -> None:
    """Resumable chunked sendall with an overall deadline: ``socket.send``
    reports partial progress, so a per-chunk timeout never tears the stream
    — either the whole frame lands or :class:`_WriteTimeout` is raised."""
    view = memoryview(data)
    deadline = time.monotonic() + float(deadline_s)
    while view:
        try:
            sent = sock.send(view[: 256 * 1024])
        except socket.timeout as err:
            if time.monotonic() >= deadline:
                raise _WriteTimeout(f"write stalled past {deadline_s:.1f}s") from err
            continue
        if sent == 0:
            raise OSError("connection closed mid-write")
        view = view[sent:]
        if time.monotonic() >= deadline and view:
            raise _WriteTimeout(f"write stalled past {deadline_s:.1f}s")


class _Cell:
    """A shared mutable scalar mimicking ``mp.Value`` (``.value``); plain
    attribute assignment is atomic under the GIL, matching the lock-free
    ``mp.Value`` the mp transport uses."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0) -> None:
        self.value = value


def _emit(emit: Optional[Callable[[Dict[str, Any]], None]], rec: Dict[str, Any]) -> None:
    if emit is not None:
        try:
            # wall-clock stamp: link events are bursty (reconnect storms),
            # so a reader of the stream can window them by time
            rec.setdefault("t", round(time.time(), 3))
            emit(rec)
        except Exception:
            pass


# ---------------------------------------------------------------------------
# learner side
# ---------------------------------------------------------------------------
class _CtrlProxy:
    """Learner-side ``channel.ctrl`` shim: translates the supervisor's
    ctrl-queue puts into wire ops, so the supervisor code is byte-for-byte
    the same over both transports. ``CTRL_PARAMS`` becomes a stored snapshot
    + a tiny PUB announce (workers pull), everything else is an opaque ctrl
    frame."""

    __slots__ = ("_chan",)

    def __init__(self, chan: "LearnerChannel") -> None:
        self._chan = chan

    def put(self, msg: Tuple[Any, ...]) -> None:
        self._chan.ctrl_put(msg)


class _DataProxy:
    """Learner-side ``channel.data`` shim (depth introspection only)."""

    __slots__ = ("_chan",)

    def __init__(self, chan: "LearnerChannel") -> None:
        self._chan = chan

    def qsize(self) -> int:
        return self._chan.pending()


class _StopProxy:
    """Learner-side ``channel.stop``: ``set()`` pushes a CTRL_STOP frame to
    the worker (mirroring the shared ``mp.Event``)."""

    __slots__ = ("_chan",)

    def __init__(self, chan: "LearnerChannel") -> None:
        self._chan = chan

    def set(self) -> None:
        self._chan.send_stop()

    def is_set(self) -> bool:
        return self._chan.stopped


class LearnerChannel:
    """One worker slot's learner-side link state: a ``WorkerChannel``
    drop-in (``data``/``ctrl``/``heartbeat``/``param_version``/``stop`` +
    ``drain_data``/``close``) backed by a TCP connection the listener
    attaches/re-attaches as the worker connects, drops and reconnects."""

    def __init__(
        self,
        worker_id: int,
        incarnation: int,
        queue_depth: int,
        net: NetConfig,
        stats: NetStats,
        emit: Optional[Callable[[Dict[str, Any]], None]] = None,
        spec: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.worker_id = int(worker_id)
        self.incarnation = int(incarnation)
        self.queue_depth = max(1, int(queue_depth))
        self.net = net
        self.stats = stats
        self.emit = emit
        self.spec = spec  # delivered in HELLO_ACK to remotely-attached workers
        self.heartbeat = _Cell(0)
        self.param_version = _Cell(0)
        self.data = _DataProxy(self)
        self.ctrl = _CtrlProxy(self)
        self.stop = _StopProxy(self)
        self.stopped = False
        self._lock = threading.RLock()
        self._wlock = threading.Lock()  # serializes frame writes: two
        # threads interleaving chunked sends on one socket would tear the
        # stream (reader CREDIT replies vs supervisor PUB/CTRL pushes)
        self._recv: deque = deque()  # decoded protocol frame tuples, in order
        self._rx_seq = -1  # last in-order DATA seq accepted
        self._conn: Optional[socket.socket] = None
        self._conn_gen = 0
        self._attached_once = False
        self._disconnected_at: Optional[float] = time.monotonic()
        self._latest_pub: Optional[Tuple[Any, ...]] = None  # (ver, blob, t, trace)
        self._last_resend_req = 0.0
        self._closed = False
        self.dup_frames = 0
        # relayed telemetry batches (T_TELEM): bounded — the live window is
        # advisory, a slow aggregator drops the oldest batch, never the link
        self._telem: deque = deque()
        self.telem_dropped = 0
        # set by FleetListener.set_act_handler: callable(chan, req) that
        # routes T_ACT requests into the learner's ActService
        self.act_handler: Optional[Callable[["LearnerChannel", Dict[str, Any]], None]] = None

    # -- link state --------------------------------------------------------
    def attach(self, conn: socket.socket) -> int:
        """Adopt a (re)connected socket; returns the connection generation
        the reader thread must hold (a stale reader exits when the gen
        moves on)."""
        with self._lock:
            old, self._conn = self._conn, conn
            self._conn_gen += 1
            gen = self._conn_gen
            self._disconnected_at = None
            reconnect = self._attached_once
            self._attached_once = True
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        if reconnect:
            self.stats.bump("reconnects")
        _emit(
            self.emit,
            {
                "event": "net",
                "action": "reconnect" if reconnect else "accept",
                "worker": self.worker_id,
                "incarnation": self.incarnation,
                "seq": self._rx_seq,
            },
        )
        # greet: current window/ack (the worker resumes or replays from
        # here), the newest publication version (pull-on-connect), and the
        # run spec for remotely-attached workers
        hello_ack = {
            "ack": self._rx_seq,
            "window": self._window(),
            "incarnation": self.incarnation,
            "pub_version": self._latest_pub[0] if self._latest_pub else 0,
            "spec": self.spec,
        }
        self._send(T_HELLO_ACK, pickle.dumps(hello_ack, protocol=pickle.HIGHEST_PROTOCOL))
        return gen

    def detach(self, gen: int, reason: str) -> None:
        """Reader-thread exit path: only the CURRENT generation detaches
        (a reader superseded by a reconnect must not clobber the new link)."""
        with self._lock:
            if gen != self._conn_gen or self._conn is None:
                return
            conn, self._conn = self._conn, None
            self._disconnected_at = time.monotonic()
        try:
            conn.close()
        except OSError:
            pass
        if not self._closed:
            _emit(
                self.emit,
                {
                    "event": "net",
                    "action": "disconnect",
                    "worker": self.worker_id,
                    "incarnation": self.incarnation,
                    "detail": str(reason)[:200],
                },
            )

    def connected(self) -> bool:
        with self._lock:
            return self._conn is not None

    def ever_connected(self) -> bool:
        with self._lock:
            return self._attached_once

    def disconnected_for(self) -> float:
        """Seconds the link has been down (0 while connected) — the
        supervisor's reconnect-grace clock."""
        with self._lock:
            if self._conn is not None or self._closed:
                return 0.0
            return time.monotonic() - (self._disconnected_at or time.monotonic())

    # -- wire input (listener reader thread) -------------------------------
    def on_frame(self, ftype: int, payload: bytes) -> None:
        if ftype == T_DATA:
            self._on_data(payload)
        elif ftype == T_HB:
            hb, applied = _HB_T.unpack(payload)
            if hb > self.heartbeat.value:
                self.heartbeat.value = hb
            if applied > self.param_version.value:
                self.param_version.value = applied
            # every heartbeat is answered with the current (ack, window):
            # credit delivery is self-healing even across lost CREDITs —
            # a parked worker heartbeats, so it always re-learns its window
            self._send_credit()
        elif ftype == T_TELEM:
            # best-effort, out-of-band of the DATA seq space: a torn or
            # unparseable batch is counted and dropped (the worker's local
            # file still has the events), never a link error
            try:
                batch = pickle.loads(payload)
            except Exception:
                self.telem_dropped += 1
                return
            with self._lock:
                if len(self._telem) >= _TELEM_BUFFER_BATCHES:
                    self._telem.popleft()
                    self.telem_dropped += 1
                self._telem.append(batch)
        elif ftype == T_PULL:
            with self._lock:
                pub = self._latest_pub
            if pub is not None:
                self._send(
                    T_PARAMS, pickle.dumps(pub, protocol=pickle.HIGHEST_PROTOCOL)
                )
                _emit(
                    self.emit,
                    {
                        "event": "net",
                        "action": "pull",
                        "worker": self.worker_id,
                        "incarnation": self.incarnation,
                        "version": int(pub[0]),
                    },
                )
        elif ftype == T_ACT:
            # pickled only AFTER the token handshake fenced this connection
            # (same trust boundary as T_TELEM/T_CTRL)
            try:
                req = pickle.loads(payload)
            except Exception:
                self.stats.bump("corrupt_frames")
                return
            handler = self.act_handler
            if handler is None:
                self.send_act_resp({"req_id": int(req.get("req_id", 0)) if isinstance(req, dict) else 0,
                                    "error": "no act service attached (fleet.act_mode=worker?)"})
                return
            try:
                handler(self, req)
            except Exception as err:
                self.send_act_resp({"req_id": int(req.get("req_id", 0)), "error": repr(err)})

    def _on_data(self, payload: bytes) -> None:
        try:
            frame = decode_data_payload(payload)
        except struct.error:
            self.stats.bump("corrupt_frames")
            return
        _wid, inc, seq = frame[0], frame[1], frame[2]
        with self._lock:
            if inc != self.incarnation:
                return  # a stale incarnation's ghost: never merged
            if seq <= self._rx_seq:
                # reconnect replay of a frame this side already accepted:
                # dropped exactly once and counted — the dedup that keeps a
                # replay from double-feeding the ledger
                self.dup_frames += 1
                dup = True
                gap = False
            elif seq > self._rx_seq + 1:
                # a frame was lost to an in-stream resync: FIFO order is the
                # round contract, so the out-of-order frame is dropped and
                # the missing range re-requested instead of buffered
                dup = False
                gap = True
            else:
                self._recv.append(frame)
                self._rx_seq = seq
                dup = gap = False
        if dup:
            self.stats.bump("dup_frames")
            _emit(
                self.emit,
                {
                    "event": "net",
                    "action": "dup_frame",
                    "worker": self.worker_id,
                    "incarnation": self.incarnation,
                    "seq": int(seq),
                },
            )
            self._send_credit()
        elif gap:
            now = time.monotonic()
            with self._lock:
                due = now - self._last_resend_req > max(0.05, self.net.io_timeout_s / 2)
                if due:
                    self._last_resend_req = now
                expected = self._rx_seq + 1
            if due:
                self.stats.bump("gap_resends")
                _emit(
                    self.emit,
                    {
                        "event": "net",
                        "action": "gap_resend",
                        "worker": self.worker_id,
                        "incarnation": self.incarnation,
                        "seq": int(expected),
                        "detail": f"got seq {seq}, expected {expected}",
                    },
                )
                self._send(T_RESEND, _RESEND_T.pack(expected))

    def note_resync(self, resyncs: int, corrupt: int, skipped: int) -> None:
        """Reader-thread report of decoder-level damage on this link."""
        if resyncs:
            self.stats.bump("resyncs", resyncs)
        if corrupt:
            self.stats.bump("corrupt_frames", corrupt)
        _emit(
            self.emit,
            {
                "event": "net",
                "action": "resync",
                "worker": self.worker_id,
                "incarnation": self.incarnation,
                "count": int(resyncs),
                "bytes": int(skipped),
                "detail": f"{corrupt} corrupt frame(s) dropped",
            },
        )

    # -- wire output -------------------------------------------------------
    def _send(self, ftype: int, payload: bytes, deadline_s: Optional[float] = None) -> bool:
        """Send one frame. ``deadline_s`` overrides the write budget for
        frames sent from latency-sensitive threads: the engine's round-merge
        poll sends CREDITs from :meth:`drain_data`, and a sick (half-open)
        peer must cost that thread at most ``io_timeout_s`` — the link is
        then detached and cycled rather than blocking the merge for the full
        ``write_timeout_s``. A torn partial write is fine: detaching discards
        the stream anyway (fresh connection, fresh decoder)."""
        with self._lock:
            conn = self._conn
            gen = self._conn_gen
        if conn is None:
            return False
        try:
            with self._wlock:
                _send_deadline(
                    conn,
                    encode_frame(ftype, payload),
                    self.net.write_timeout_s if deadline_s is None else deadline_s,
                )
            return True
        except _WriteTimeout as err:
            self.stats.bump("write_timeouts")
            _emit(
                self.emit,
                {
                    "event": "net",
                    "action": "write_timeout",
                    "worker": self.worker_id,
                    "incarnation": self.incarnation,
                    "detail": str(err),
                },
            )
            self.detach(gen, f"write timeout: {err}")
            return False
        except OSError as err:
            self.detach(gen, f"send failed: {err}")
            return False

    def _window(self) -> int:
        return max(0, self.queue_depth - len(self._recv))

    def _send_credit(self) -> None:
        with self._lock:
            ack = self._rx_seq
            window = self._window()
        # tight deadline: credits are sent from the learner's merge poll
        self._send(T_CREDIT, _CREDIT_T.pack(ack, window), deadline_s=self.net.io_timeout_s)

    # -- WorkerChannel surface (supervisor/engine side) --------------------
    def ctrl_put(self, msg: Tuple[Any, ...]) -> None:
        from .protocol import CTRL_PARAMS, CTRL_STOP

        if msg and msg[0] == CTRL_PARAMS:
            with self._lock:
                self._latest_pub = tuple(msg[1:])
            # announces/ctrl are tiny and sent from the learner thread:
            # bound them like credits so a sick peer can't stall training
            self._send(T_PUB, _PUB_T.pack(int(msg[1])), deadline_s=self.net.io_timeout_s)
        elif msg and msg[0] == CTRL_STOP:
            self.send_stop()
        else:
            self._send(
                T_CTRL,
                pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL),
                deadline_s=self.net.io_timeout_s,
            )

    def send_stop(self) -> None:
        from .protocol import CTRL_STOP

        self.stopped = True
        self._send(T_CTRL, pickle.dumps((CTRL_STOP,), protocol=pickle.HIGHEST_PROTOCOL))

    def send_act_resp(self, resp: Dict[str, Any]) -> bool:
        """Answer one act request (called from the ActService's flush thread;
        ``_wlock`` inside ``_send`` serializes it against CREDIT/PUB writes).
        A response lost to a dead link is recovered by the worker's re-send
        hitting the service's idempotency cache — never stepped twice."""
        return self._send(T_ACT_RESP, pickle.dumps(resp, protocol=pickle.HIGHEST_PROTOCOL),
                          deadline_s=self.net.write_timeout_s)

    def pending(self) -> int:
        return len(self._recv)

    def drain_data(self, limit: int = 1024) -> List[Any]:
        out: List[Any] = []
        for _ in range(max(0, int(limit))):
            try:
                out.append(self._recv.popleft())
            except IndexError:
                break
        if out:
            # room freed learner-side → grow the worker's window
            self._send_credit()
        return out

    def drain_telem(self, limit: int = 64) -> List[Any]:
        """Pop every buffered relay batch (supervisor/engine poll path)."""
        out: List[Any] = []
        with self._lock:
            for _ in range(max(0, int(limit))):
                try:
                    out.append(self._telem.popleft())
                except IndexError:
                    break
        return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conn, self._conn = self._conn, None
            self._conn_gen += 1
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass


class FleetListener:
    """The learner's TCP endpoint: accepts worker connections, validates the
    HELLO (shared run token, known worker id, expected incarnation) and
    attaches each connection to its :class:`LearnerChannel`. One reader
    thread per live connection feeds the channel's decoder; a superseded
    reader (the worker reconnected) exits on its stale generation."""

    def __init__(
        self,
        net: NetConfig,
        token: str,
        stats: Optional[NetStats] = None,
        emit: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> None:
        self.net = net
        self.token = str(token)
        self.stats = stats or NetStats()
        self.emit = emit
        self._lock = threading.Lock()
        self._channels: Dict[int, LearnerChannel] = {}
        self._act_handler: Optional[Callable[[LearnerChannel, Dict[str, Any]], None]] = None
        self._closed = threading.Event()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.settimeout(max(0.05, net.io_timeout_s))
        self._srv.bind((net.host, net.port))
        self._srv.listen(64)
        self.port = int(self._srv.getsockname()[1])
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-net-accept", daemon=True
        )
        self._accept_thread.start()
        _emit(self.emit, {"event": "net", "action": "listen", "detail": f"{net.host}:{self.port}"})

    @property
    def address(self) -> Tuple[str, int]:
        return (self.net.host, self.port)

    # -- registry (supervisor thread) --------------------------------------
    def register(
        self,
        worker_id: int,
        incarnation: int,
        queue_depth: int,
        spec: Optional[Dict[str, Any]] = None,
    ) -> LearnerChannel:
        chan = LearnerChannel(
            worker_id, incarnation, queue_depth, self.net, self.stats, self.emit, spec
        )
        with self._lock:
            chan.act_handler = self._act_handler
            old = self._channels.get(int(worker_id))
            self._channels[int(worker_id)] = chan
        if old is not None:
            old.close()
        return chan

    def set_act_handler(self, fn: Optional[Callable[[LearnerChannel, Dict[str, Any]], None]]) -> None:
        """Install the ActService's wire handler on every current channel and
        on every channel a later (re)register creates."""
        with self._lock:
            self._act_handler = fn
            channels = list(self._channels.values())
        for chan in channels:
            chan.act_handler = fn

    def unregister(self, worker_id: int) -> None:
        with self._lock:
            chan = self._channels.pop(int(worker_id), None)
        if chan is not None:
            chan.close()

    # -- accept + per-connection reader ------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            _configure(conn, self.net.io_timeout_s)
            threading.Thread(
                target=self._handshake, args=(conn,), name="fleet-net-hello", daemon=True
            ).start()

    def _handshake(self, conn: socket.socket) -> None:
        decoder = StreamDecoder(self.net.max_frame_bytes)
        deadline = time.monotonic() + self.net.hello_timeout_s
        hello: Optional[Tuple[int, int, str]] = None
        try:
            while time.monotonic() < deadline and hello is None:
                try:
                    data = conn.recv(65536)
                except socket.timeout:
                    continue
                if not data:
                    raise OSError("closed before HELLO")
                for ftype, payload in decoder.feed(data):
                    if ftype == T_HELLO and len(payload) == _HELLO_T.size:
                        # fixed struct, NEVER pickle: this payload comes from
                        # an unauthenticated peer
                        wid, inc, tok = _HELLO_T.unpack(payload)
                        hello = (wid, inc, tok.rstrip(b"\0").decode("ascii", "replace"))
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
        if hello[2] != self.token:
            self._refuse(conn, "bad token")
            return
        worker_id = int(hello[0])
        with self._lock:
            chan = self._channels.get(worker_id)
        if chan is None:
            self._refuse(conn, f"unknown or quarantined worker {worker_id}")
            return
        inc = int(hello[1])
        if inc >= 0 and inc != chan.incarnation:
            self._refuse(conn, f"stale incarnation {inc} (expected {chan.incarnation})")
            return
        gen = chan.attach(conn)
        self._reader(chan, conn, gen, decoder)

    def _refuse(self, conn: socket.socket, reason: str, fatal: bool = True) -> None:
        _emit(self.emit, {"event": "net", "action": "refuse", "detail": reason})
        try:
            _send_deadline(
                conn,
                # fatal = this identity will never be accepted (bad token,
                # quarantined/unknown slot, stale incarnation): the worker
                # must stop retrying instead of hammering the listener
                encode_frame(T_REFUSE, pickle.dumps({"reason": reason, "fatal": fatal})),
                self.net.write_timeout_s,
            )
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass

    def _reader(
        self, chan: LearnerChannel, conn: socket.socket, gen: int, decoder: StreamDecoder
    ) -> None:
        last_damage = (0, 0)
        while not self._closed.is_set():
            try:
                data = conn.recv(262144)
            except socket.timeout:
                continue
            except OSError as err:
                chan.detach(gen, f"recv failed: {err}")
                return
            if not data:
                chan.detach(gen, "peer closed")
                return
            for ftype, payload in decoder.feed(data):
                chan.on_frame(ftype, payload)
            damage = (decoder.resyncs, decoder.corrupt_frames)
            if damage != last_damage:
                chan.note_resync(
                    damage[0] - last_damage[0],
                    damage[1] - last_damage[1],
                    decoder.skipped_bytes,
                )
                last_damage = damage
        chan.detach(gen, "listener closed")

    def close(self) -> None:
        self._closed.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            channels = list(self._channels.values())
            self._channels.clear()
        for chan in channels:
            chan.close()
        # a closed socket does not wake a blocked accept: the loop sees the
        # flag at its next poll, within io_timeout_s
        self._accept_thread.join(timeout=max(0.05, self.net.io_timeout_s) + 1.0)


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------
class _HBCell:
    """Worker-side ``channel.heartbeat``: assignment pushes a keepalive HB
    frame (rate-limited) so liveness flows even while parked on
    backpressure — the stamped-while-parked contract over a wire."""

    __slots__ = ("_chan", "_value")

    def __init__(self, chan: "WorkerSocketChannel") -> None:
        self._chan = chan
        self._value = 0

    @property
    def value(self) -> int:
        return self._value

    @value.setter
    def value(self, v: int) -> None:
        self._value = int(v)
        self._chan.maybe_send_hb(int(v))


class _PVCell:
    """Worker-side ``channel.param_version``: stamping an applied version
    flushes an immediate HB so the learner's republish nudge sees it."""

    __slots__ = ("_chan", "_value")

    def __init__(self, chan: "WorkerSocketChannel") -> None:
        self._chan = chan
        self._value = 0

    @property
    def value(self) -> int:
        return self._value

    @value.setter
    def value(self, v: int) -> None:
        self._value = int(v)
        self._chan.note_applied(int(v))


class _WorkerCtrl:
    __slots__ = ("_chan",)

    def __init__(self, chan: "WorkerSocketChannel") -> None:
        self._chan = chan

    def get_nowait(self) -> Tuple[Any, ...]:
        return self._chan.ctrl_get_nowait()


class _WorkerData:
    __slots__ = ("_chan",)

    def __init__(self, chan: "WorkerSocketChannel") -> None:
        self._chan = chan

    def put(self, frame: Any, timeout: Optional[float] = None) -> None:
        self._chan.data_put(frame, timeout)


class WorkerSocketChannel:
    """Worker-process side of the link: a ``WorkerChannel`` drop-in whose
    ``data.put`` speaks credit-gated DATA frames and whose link thread owns
    connect → HELLO → replay-unacked → read, reconnecting with jittered
    exponential backoff whenever the link drops."""

    def __init__(
        self,
        host: str,
        port: int,
        worker_id: int,
        incarnation: int,
        token: str,
        net: Optional[NetConfig] = None,
        chaos: Any = None,
        emit: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> None:
        self.host = str(host)
        self.port = int(port)
        self.worker_id = int(worker_id)
        self.incarnation = int(incarnation)
        self.token = str(token)
        self.net = net or NetConfig()
        self.chaos = chaos
        self.emit = emit
        self.stop = threading.Event()
        self.heartbeat = _HBCell(self)
        self.param_version = _PVCell(self)
        self.ctrl = _WorkerCtrl(self)
        self.data = _WorkerData(self)
        self.spec: Optional[Dict[str, Any]] = None  # remote attach: learner-sent
        self._ctrl_q: deque = deque()
        self._cond = threading.Condition()
        # guarded by _cond: link + flow-control state
        self._sock: Optional[socket.socket] = None
        self._connected = False
        self._last_ack = -1
        self._window = 0
        self._unacked: Dict[int, bytes] = {}  # seq -> CLEAN wire bytes
        self._resend_from: Optional[int] = None
        self._partition_until = 0.0
        self._half_open_until = 0.0
        self._pulled = 0  # newest version already requested
        self._announced = 0
        # req_id -> response for in-flight act requests (guarded by _cond);
        # bounded by the one-request-at-a-time act protocol
        self._act_resps: Dict[int, Dict[str, Any]] = {}
        self._closed = False
        self._attempt = 0
        self._park_since: Optional[float] = None
        self._wlock = threading.Lock()
        self._hb_last = 0.0
        self._hello_ack = threading.Event()
        self._rng = random.Random(0x5F1E7 ^ (self.worker_id * 7919) ^ self.incarnation)
        self._link_thread = threading.Thread(
            target=self._link_loop, name=f"fleet-net-link-{worker_id}", daemon=True
        )
        self._link_thread.start()

    # -- link thread -------------------------------------------------------
    def _link_loop(self) -> None:
        while not self._closed and not self.stop.is_set():
            with self._cond:
                hold = max(0.0, self._partition_until - time.monotonic())
            if hold > 0:
                time.sleep(min(hold, 0.2))
                continue
            sock = self._connect_once()
            if sock is None:
                # with_retries semantics applied to a link: jittered
                # exponential backoff between attempts
                with self._cond:
                    self._attempt += 1
                    n = self._attempt
                delay = min(self.net.max_backoff_s, self.net.backoff_s * (2 ** max(0, n - 1)))
                delay *= max(0.0, 1.0 + self._rng.uniform(-self.net.jitter, self.net.jitter))
                _emit(  # lint: ok[hot-loop-emit] once per reconnect attempt, backoff-bounded
                    self.emit,
                    {
                        "event": "net",
                        "action": "connect_backoff",
                        "worker": self.worker_id,
                        "incarnation": self.incarnation,
                        "count": n,
                        "detail": f"retry in {delay:.2f}s",
                    },
                )
                time.sleep(max(0.01, delay))
                continue
            with self._cond:
                self._attempt = 0
            self._read_loop(sock)

    def _connect_once(self) -> Optional[socket.socket]:
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.net.connect_timeout_s
            )
        except OSError:
            return None
        _configure(sock, self.net.io_timeout_s)
        try:
            _send_deadline(
                sock,
                encode_hello(self.worker_id, self.incarnation, self.token),
                self.net.write_timeout_s,
            )
        except OSError:
            try:
                sock.close()
            except OSError:
                pass
            return None
        # the HELLO_ACK arrives on the read loop; mark pending so data_put
        # keeps parking until the window is granted
        self._hello_ack.clear()
        return sock

    def _read_loop(self, sock: socket.socket) -> None:
        decoder = StreamDecoder(self.net.max_frame_bytes)
        with self._cond:
            self._sock = sock
        reason = "closed"
        try:
            while not self._closed and not self.stop.is_set():
                with self._cond:
                    half_open = time.monotonic() < self._half_open_until
                    partition_due = self._partition_until > time.monotonic()
                if partition_due:
                    reason = "chaos partition"
                    break
                if half_open:
                    # chaos half-open: the peer stays connected but this side
                    # stops reading — credits/ctrl pile up unread and the
                    # learner's writes eventually trip their deadline
                    time.sleep(0.05)
                    continue
                try:
                    data = sock.recv(262144)
                except socket.timeout:
                    continue
                except OSError as err:
                    reason = f"recv failed: {err}"
                    break
                if not data:
                    reason = "peer closed"
                    break
                for ftype, payload in decoder.feed(data):
                    self._on_frame(ftype, payload)
        finally:
            self._drop_link(sock, reason)

    def _drop_link(self, sock: socket.socket, reason: str) -> None:
        with self._cond:
            was_current = self._sock is sock
            if was_current:
                self._sock = None
                self._connected = False
            # a PULL answered after this drop is lost with the link: forget
            # in-flight requests so the on-connect announce re-pulls (the
            # applied version still guards against redundant fetches)
            self._pulled = 0
            self._cond.notify_all()
        try:
            sock.close()
        except OSError:
            pass
        # only the call that actually tore down the link reports it — the
        # reader noticing the socket a failed send already closed must not
        # double-count the same outage
        if was_current and not self._closed and not self.stop.is_set():
            _emit(
                self.emit,
                {
                    "event": "net",
                    "action": "disconnect",
                    "worker": self.worker_id,
                    "incarnation": self.incarnation,
                    "detail": str(reason)[:200],
                },
            )

    def _on_frame(self, ftype: int, payload: bytes) -> None:
        from .protocol import CTRL_PARAMS, CTRL_STOP

        if ftype == T_HELLO_ACK:
            ack_msg = pickle.loads(payload)
            with self._cond:
                self._last_ack = int(ack_msg.get("ack", -1))
                self._window = int(ack_msg.get("window", 0))
                inc = int(ack_msg.get("incarnation", self.incarnation))
                self.incarnation = inc
                self._connected = True
                self.spec = ack_msg.get("spec") or self.spec
                for seq in [s for s in self._unacked if s <= self._last_ack]:
                    self._unacked.pop(seq, None)
                replay = [self._unacked[s] for s in sorted(self._unacked)]
                self._cond.notify_all()
            self._hello_ack.set()
            _emit(
                self.emit,
                {
                    "event": "net",
                    "action": "connect",
                    "worker": self.worker_id,
                    "incarnation": self.incarnation,
                    "seq": int(self._last_ack),
                    "count": len(replay),
                },
            )
            # replay every unacked frame in seq order: the learner dedups
            # anything it already accepted — at-least-once on the wire,
            # exactly-once into the round merge
            for wire in replay:
                if not self._send_wire(wire):
                    break
            pub = int(ack_msg.get("pub_version", 0))
            self._maybe_pull(pub)
        elif ftype == T_CREDIT:
            ack, window = _CREDIT_T.unpack(payload)
            with self._cond:
                if ack > self._last_ack:
                    self._last_ack = int(ack)
                    for seq in [s for s in self._unacked if s <= ack]:
                        self._unacked.pop(seq, None)
                self._window = int(window)
                self._cond.notify_all()
        elif ftype == T_RESEND:
            (from_seq,) = _RESEND_T.unpack(payload)
            with self._cond:
                replay = [
                    self._unacked[s] for s in sorted(self._unacked) if s >= from_seq
                ]
            _emit(
                self.emit,
                {
                    "event": "net",
                    "action": "resend",
                    "worker": self.worker_id,
                    "incarnation": self.incarnation,
                    "seq": int(from_seq),
                    "count": len(replay),
                },
            )
            for wire in replay:
                if not self._send_wire(wire):
                    break
        elif ftype == T_PUB:
            (version,) = _PUB_T.unpack(payload)
            self._maybe_pull(int(version))
        elif ftype == T_ACT_RESP:
            try:
                resp = pickle.loads(payload)
            except Exception:
                return
            with self._cond:
                self._act_resps[int(resp.get("req_id", 0))] = resp
                # keep only the newest few: an abandoned request's late
                # response must not pin memory forever
                while len(self._act_resps) > 4:
                    self._act_resps.pop(next(iter(self._act_resps)))
                self._cond.notify_all()
        elif ftype == T_PARAMS:
            pub = pickle.loads(payload)  # (version, blob, t_pub, trace)
            self._ctrl_q.append((CTRL_PARAMS,) + tuple(pub))
        elif ftype == T_CTRL:
            msg = pickle.loads(payload)
            if msg and msg[0] == CTRL_STOP:
                self.stop.set()
                with self._cond:
                    self._cond.notify_all()
            self._ctrl_q.append(tuple(msg))
        elif ftype == T_REFUSE:
            info = pickle.loads(payload)
            reason = str(info.get("reason", ""))
            _emit(
                self.emit,
                {
                    "event": "net",
                    "action": "refused",
                    "worker": self.worker_id,
                    "incarnation": self.incarnation,
                    "detail": reason,
                },
            )
            if info.get("fatal", True):
                # this identity will never be accepted again: stop retrying
                self.stop.set()
                with self._cond:
                    self._cond.notify_all()

    def _maybe_pull(self, version: int) -> None:
        """Pull the newest publication when the learner knows a version this
        worker has neither applied nor already requested — the on-connect /
        on-lag fetch of the parameter-server shape."""
        with self._cond:
            if version <= max(self._pulled, self.param_version.value):
                return
            self._pulled = version
        self._send(T_PULL, _PULL_T.pack(int(version)))

    # -- wire output -------------------------------------------------------
    def _send(self, ftype: int, payload: bytes) -> bool:
        return self._send_wire(encode_frame(ftype, payload))

    def _send_wire(self, wire: bytes) -> bool:
        with self._cond:
            sock = self._sock
        if sock is None:
            return False
        with self._wlock:
            try:
                _send_deadline(sock, wire, self.net.write_timeout_s)
                return True
            except OSError:
                self._drop_link(sock, "send failed")
                return False

    def maybe_send_hb(self, hb: int) -> None:
        now = time.monotonic()
        if now - self._hb_last < self.net.keepalive_s:
            return
        self._hb_last = now
        self._send(T_HB, _HB_T.pack(int(hb), int(self.param_version.value)))

    def note_applied(self, version: int) -> None:
        self._hb_last = time.monotonic()
        self._send(T_HB, _HB_T.pack(int(self.heartbeat.value), int(version)))

    # -- WorkerChannel surface (worker loop thread) ------------------------
    def act_request(self, req: Dict[str, Any], timeout_s: float = 30.0, beat: Optional[Any] = None) -> Dict[str, Any]:
        """Ship one act request (T_ACT) and block for its T_ACT_RESP,
        pulsing ``beat`` every poll slice so the wait never reads as a hang.
        Re-sent once a second while unanswered — across a reconnect the
        replayed request hits the service's idempotency cache, recovering a
        response the dead link swallowed without stepping latents twice."""
        rid = int(req.get("req_id", 0))
        deadline = time.monotonic() + float(timeout_s)
        resend_at = 0.0
        while True:
            now = time.monotonic()
            if now >= deadline:
                with self._cond:
                    self._act_resps.pop(rid, None)
                raise TimeoutError(f"act request {rid} not answered within {timeout_s}s")
            if self.stop.is_set() or self._closed:
                from .protocol import ChannelStopped

                raise ChannelStopped(f"act request {rid}: channel stopped")
            if now >= resend_at:
                resend_at = now + 1.0
                with self._cond:
                    # the incarnation may have been corrected by HELLO_ACK
                    # (remote attach): stamp it at send time
                    req["incarnation"] = int(self.incarnation)
                self._send(T_ACT, pickle.dumps(req, protocol=pickle.HIGHEST_PROTOCOL))
            if beat is not None:
                beat()
            with self._cond:
                resp = self._act_resps.pop(rid, None)
                if resp is None:
                    self._cond.wait(timeout=min(0.1, max(0.0, deadline - now)))
                    resp = self._act_resps.pop(rid, None)
            if resp is not None:
                return resp

    def ctrl_get_nowait(self) -> Tuple[Any, ...]:
        try:
            return self._ctrl_q.popleft()
        except IndexError:
            raise _q.Empty from None

    def telem_put(self, batch: Any) -> bool:
        """Relay one telemetry batch upstream (T_TELEM). Best-effort and
        bounded: rides the ordinary deadline-bounded frame write, returns
        False (caller counts the drop) when the link is down or the write
        times out — never blocks the worker loop on the relay."""
        try:
            return self._send(
                T_TELEM, pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
            )
        except Exception:
            return False

    def data_put(self, frame: Any, timeout: Optional[float] = None) -> None:
        """Credit-gated transmit of one protocol frame tuple. Blocks (up to
        ``timeout``) for link + window, raising ``queue.Full`` on expiry so
        the worker loop keeps heartbeating exactly as over ``mp.Queue``. A
        link that stays connected but never grants credit past
        ``stall_reconnect_s`` (a half-open peer) is cycled."""
        seq = int(frame[2])
        chaos = self.chaos
        if chaos is not None and chaos.net_partitions(seq):
            self.force_partition(chaos.net_partition_s, seq)
        deadline = time.monotonic() + (float(timeout) if timeout else 0.0)
        with self._cond:
            while True:
                if self.stop.is_set() or self._closed:
                    raise _q.Full
                # the window gate IS the backpressure: ack advances on every
                # receipt, so a >0 window must be required or a worker could
                # stream one-past-ack forever while the learner buffers
                if (
                    self._connected
                    and self._window > 0
                    and seq <= self._last_ack + self._window
                ):
                    sock = self._sock
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._maybe_cycle_stalled_locked()
                    raise _q.Full
                self._cond.wait(timeout=min(remaining, 0.1))
        wire = encode_data_frame(tuple(frame))
        tx = wire
        if chaos is not None:
            chaos.net_delay()
            tx = chaos.net_corrupt_wire(wire, seq)
        if sock is None:
            raise _q.Full
        with self._wlock:
            try:
                _send_deadline(sock, tx, self.net.write_timeout_s)
            except OSError:
                self._drop_link(sock, "send failed")
                raise _q.Full from None
        with self._cond:
            # the CLEAN bytes are what a replay retransmits — a chaos-torn
            # first transmission is recovered from here via RESEND
            self._unacked[seq] = wire
            self._park_since = None
        if chaos is not None and chaos.net_resets(seq):
            _emit(
                self.emit,
                {
                    "event": "net",
                    "action": "chaos_reset",
                    "worker": self.worker_id,
                    "incarnation": self.incarnation,
                    "seq": seq,
                },
            )
            self._drop_link(sock, "chaos connection reset")
        if chaos is not None and chaos.net_half_opens(seq):
            with self._cond:
                self._half_open_until = time.monotonic() + chaos.net_half_open_s

    def _maybe_cycle_stalled_locked(self) -> None:
        """Called with ``_cond`` held when a put timed out: a connected link
        that grants no credit for ``stall_reconnect_s`` is treated as sick
        (half-open peer / lost credits) and cycled — reconnect + replay is
        cheaper than a silent stall."""
        now = time.monotonic()
        if self._park_since is None:
            self._park_since = now
            return
        if self._connected and now - self._park_since >= self.net.stall_reconnect_s:
            self._park_since = None
            sock, self._sock = self._sock, None
            self._connected = False
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

    def force_partition(self, seconds: float, seq: int = -1) -> None:
        """Sever the link and refuse to reconnect for ``seconds`` (the chaos
        partition fault; also usable from tests)."""
        _emit(
            self.emit,
            {
                "event": "net",
                "action": "partition",
                "worker": self.worker_id,
                "incarnation": self.incarnation,
                "seq": int(seq),
                "detail": f"{seconds:.2f}s",
            },
        )
        with self._cond:
            self._partition_until = time.monotonic() + float(seconds)
            sock, self._sock = self._sock, None
            self._connected = False
            self._cond.notify_all()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        with self._cond:
            self._closed = True
            sock, self._sock = self._sock, None
            self._connected = False
            self._cond.notify_all()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
