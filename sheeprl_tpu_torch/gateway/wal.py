"""Write-ahead-logged session store: the durability layer under the broker
(the port's counterpart of ``sheeprl_tpu/gateway/wal.py``; the on-disk
format is the same, so a WAL written by either package recovers in the
other).

`broker.py`'s in-memory LRU dies with its process — fine while the broker
lives inside the one gateway, fatal once the broker is the EXTERNAL source
of truth for every gateway's sticky sessions (`brokerd.py`). This module is
the durable store both the daemon and the (optional) WAL-backed in-process
broker share:

* **append-only WAL, CRC per record** — every applied op (PUT / DROP /
  PROMOTE) is one framed record: ``MAGIC | len | payload-crc | header-crc |
  payload``. Unlike the fleet's :class:`~sheeprl_tpu_torch.fleet.net.StreamDecoder`
  the WAL reader never resync-scans: a WAL is a local file where the first
  damaged byte defines the end of the valid prefix — recovery truncates
  there (**torn-tail truncation**, counted as ``wal_torn_tail``) so state is
  always *prefix-exact*: exactly the ops up to the last fully-durable
  record, never a hole with clean records applied after it.
* **durability modes** — ``memory`` (acked from RAM; lost with the
  process), ``wal`` (acked after ``write+flush`` — survives SIGKILL, not
  power loss), ``fsync`` (acked after ``os.fsync`` — survives power loss).
  The mode decides when :meth:`put` RETURNS, which is when the daemon acks.
* **snapshot + compaction** — when the live WAL outgrows
  ``compact_bytes``, the in-memory state is written as a CRC-framed
  snapshot generation and a fresh WAL begins; older generations are
  deleted. Sessions that had already been LRU-evicted from memory are
  dropped at compaction (*compacted away* — the only way a once-acked
  session truly disappears).
* **LRU-evicted-but-durable rehydration** — evicting a session from the
  bounded in-memory map no longer forgets it: an index remembers its last
  PUT record's byte range in the live WAL, and :meth:`get` re-reads and
  re-validates that record on demand (``wal_rehydrate``). 410
  ``session_lost`` is thereby reserved for never-seen or compacted-away
  sessions.
* **idempotent PUTs** — a PUT may carry ``(client_id, client_seq)``; the
  store remembers each client's newest applied seq (persisted through WAL
  and snapshot) and answers a replayed PUT with the originally assigned
  version WITHOUT re-applying — the exactly-once half of the client's
  at-least-once reconnect replay.
* **replication surface** — every applied op is also retained as wire
  payload bytes in an in-memory tail (bounded by compaction), so a primary
  can stream ``records_since(seq)`` to a standby and a standby can
  :meth:`apply_wire` them into its OWN WAL; ``encoded_state`` bootstraps a
  standby too far behind the tail. ``epoch`` is the fencing token: a
  promotion bumps it through a PROMOTE record so it is as durable as the
  data it fences.
"""
from __future__ import annotations

import os
import pickle
import struct
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..fleet.net import _emit  # the shared swallow-and-timestamp telemetry helper

__all__ = ["StaleEpoch", "WalStore", "WalError", "encode_record", "decode_record"]

MAGIC = b"SBW1"
_HDR = struct.Struct(">II")  # payload_len, payload_crc32
_HCRC = struct.Struct(">I")  # crc32 over the header — a corrupted length
# must be rejected before recovery trusts it and mis-frames the whole tail
_PREFIX_LEN = len(MAGIC) + _HDR.size + _HCRC.size

# record payload: seq, epoch, op, version, client_seq, cid_len, sid_len, blob_len
_REC_T = struct.Struct(">QIBQqHHI")

OP_PUT = 1
OP_DROP = 2
OP_PROMOTE = 3

_SNAP_TMP = "snapshot.tmp"

# replication-tail bound for stores WITHOUT a WAL file (wal_dir=None):
# compaction is what clears the tail on durable stores, and it never runs
# in memory mode — without a cap a long-running memory broker would retain
# every blob ever PUT
_MEMORY_TAIL_MAX = 4096


class WalError(RuntimeError):
    """A WAL/snapshot invariant failed (bad record requested, gap in a
    replication stream, undecodable snapshot)."""


class StaleEpoch(WalError):
    """A replicated state blob carries an epoch BEHIND this store's — the
    sender is a fenced zombie and its state must not be adopted."""


def encode_record(
    seq: int,
    epoch: int,
    op: int,
    version: int,
    client_seq: int,
    client_id: bytes,
    sid: bytes,
    blob: bytes,
) -> bytes:
    """One WAL record's PAYLOAD bytes (the framing CRCs wrap these)."""
    return (
        _REC_T.pack(
            int(seq), int(epoch), int(op) & 0xFF, int(version), int(client_seq),
            len(client_id), len(sid), len(blob),
        )
        + client_id + sid + blob
    )


def decode_record(payload: bytes) -> Dict[str, Any]:
    seq, epoch, op, version, client_seq, cid_len, sid_len, blob_len = _REC_T.unpack_from(payload)
    base = _REC_T.size
    if len(payload) != base + cid_len + sid_len + blob_len:
        raise WalError(f"record payload length mismatch (seq {seq})")
    cid = payload[base: base + cid_len]
    sid = payload[base + cid_len: base + cid_len + sid_len]
    blob = payload[base + cid_len + sid_len:]
    return {
        "seq": seq, "epoch": epoch, "op": op, "version": version,
        "client_seq": client_seq, "client_id": cid, "sid": sid, "blob": blob,
    }


def frame_record(payload: bytes) -> bytes:
    hdr = _HDR.pack(len(payload), zlib.crc32(payload))
    return MAGIC + hdr + _HCRC.pack(zlib.crc32(hdr)) + payload


def read_frames(data: bytes) -> Tuple[List[bytes], int, bool]:
    """Parse ``data`` as consecutive WAL frames. Returns ``(payloads,
    valid_bytes, torn)``: the valid record payloads, the byte offset of the
    end of the last valid record, and whether anything (partial or corrupt)
    followed it. NO resync: the first damage ends the valid prefix."""
    out: List[bytes] = []
    off = 0
    n = len(data)
    while True:
        if off == n:
            return out, off, False
        if n - off < _PREFIX_LEN:
            return out, off, True  # partial prefix: torn tail
        if data[off: off + len(MAGIC)] != MAGIC:
            return out, off, True
        hdr = data[off + len(MAGIC): off + len(MAGIC) + _HDR.size]
        (hcrc,) = _HCRC.unpack_from(data, off + len(MAGIC) + _HDR.size)
        if zlib.crc32(hdr) != hcrc:
            return out, off, True
        plen, pcrc = _HDR.unpack(hdr)
        if n - off < _PREFIX_LEN + plen:
            return out, off, True  # record body truncated mid-write
        payload = data[off + _PREFIX_LEN: off + _PREFIX_LEN + plen]
        if zlib.crc32(payload) != pcrc:
            return out, off, True
        out.append(payload)
        off += _PREFIX_LEN + plen


class WalStore:
    """The broker's session map with a WAL underneath — a
    :class:`~sheeprl_tpu_torch.gateway.broker.SessionBroker` drop-in (``put`` /
    ``get`` / ``version`` / ``drop`` / ``len``) that is durable, idempotent
    and replicable. ``wal_dir=None`` runs memory-only (durability
    ``memory`` enforced): the replication tail still works, recovery does
    not. ``text=True`` speaks ``str`` blobs (the gateway's base64 codec
    strings); the daemon runs ``text=False`` and moves raw bytes."""

    def __init__(
        self,
        wal_dir: Optional[Any] = None,
        max_sessions: int = 1_000_000,
        durability: str = "wal",
        compact_bytes: int = 64 * 1024 * 1024,
        text: bool = True,
        emit: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> None:
        if durability not in ("memory", "wal", "fsync"):
            raise ValueError(f"unknown durability mode '{durability}' (memory|wal|fsync)")
        self.wal_dir = None if wal_dir is None else str(wal_dir)
        self.max_sessions = int(max_sessions)
        self.durability = durability if self.wal_dir is not None else "memory"
        self.compact_bytes = int(compact_bytes)
        self.text = bool(text)
        self.emit = emit
        self._lock = threading.RLock()
        # sid -> (version, blob); bounded LRU — the WORKING SET, not the truth
        self._mem: "OrderedDict[bytes, Tuple[int, bytes]]" = OrderedDict()
        # sid -> (version - 1, previous blob): two-deep history so a reader
        # can ask for the state AT ITS LAST ACKED VERSION. The one consumer
        # is the gateway's rehydrate-after-in-doubt-put path: a PUT that was
        # applied but whose ack was lost with a dying primary leaves the
        # newest version one UNACKED step ahead — serving it would skip an
        # acked step on the client's trajectory. Process-lifetime only (not
        # snapshotted; rebuilt by WAL replay and replication apply)
        self._prev: Dict[bytes, Tuple[int, bytes]] = {}
        # sid -> (version, wal_offset, frame_len): LRU-evicted but still
        # readable from the live WAL generation (cleared at compaction)
        self._evicted: Dict[bytes, Tuple[int, int, int]] = {}
        self._loc: Dict[bytes, Tuple[int, int]] = {}  # sid -> newest PUT frame range
        self._dedup: Dict[bytes, Tuple[int, int]] = {}  # client_id -> (client_seq, version)
        self._tail: "deque[Tuple[int, bytes]]" = deque()  # (seq, payload) since snapshot
        self.seq = 0  # last applied WAL seq
        self.epoch = 1  # fencing token; bumped by promotion
        self.gen = 0  # snapshot generation
        self._wal_fh: Optional[Any] = None
        self._wal_bytes = 0
        # counters (all mutated under _lock)
        self.evictions = 0
        self.rehydrates = 0
        self.torn_tails = 0
        self.compactions = 0
        self.dedup_hits = 0
        self._fsync_ms: "deque[float]" = deque(maxlen=512)
        if self.wal_dir is not None:
            os.makedirs(self.wal_dir, exist_ok=True)
            self._recover_locked()
            if self._wal_fh is None:
                self._open_wal_locked()

    # -- paths ---------------------------------------------------------------
    def _snap_path(self, gen: int) -> str:
        return os.path.join(self.wal_dir or "", f"snapshot_{gen:06d}.bin")

    def _wal_path(self, gen: int) -> str:
        return os.path.join(self.wal_dir or "", f"wal_{gen:06d}.log")

    # -- recovery ------------------------------------------------------------
    def _recover_locked(self) -> None:
        """Newest valid snapshot generation + its WAL's valid prefix; the
        torn tail (if any) is truncated in place so the file and the
        recovered state agree byte for byte."""
        gens = sorted(
            int(name.split("_")[1].split(".")[0])
            for name in os.listdir(self.wal_dir or ".")
            if name.startswith("snapshot_") and name.endswith(".bin")
        )
        for gen in reversed(gens):
            if self._load_snapshot_locked(gen):
                self.gen = gen
                break
        else:
            self.gen = 0
        wal_path = self._wal_path(self.gen)
        if os.path.exists(wal_path):
            snap_seq = self.seq
            with open(wal_path, "rb") as fh:
                data = fh.read()
            payloads, valid, torn = read_frames(data)
            for payload in payloads:
                rec = decode_record(payload)
                if rec["seq"] <= snap_seq:
                    continue  # pre-snapshot leftovers in a reused gen
                self._apply_locked(rec, payload, offset=None)
            if torn:
                self.torn_tails += 1
                with open(wal_path, "ab") as fh:
                    fh.truncate(valid)
                _emit(
                    self.emit,
                    {
                        "event": "broker",
                        "action": "wal_torn_tail",
                        "seq": int(self.seq),
                        "bytes": int(len(data) - valid),
                        "detail": f"truncated {len(data) - valid} torn byte(s) at offset {valid}",
                    },
                )
            # rebuild the rehydrate/loc indices against the REPLAYED offsets:
            # offsets were unknown during _apply_locked, so walk the frames
            # (last PUT per sid wins — exactly the newest-record invariant
            # the live indices maintain)
            off = 0
            for payload in payloads:
                rec = decode_record(payload)
                flen = _PREFIX_LEN + len(payload)
                if rec["seq"] > snap_seq and rec["op"] == OP_PUT:
                    sid = rec["sid"]
                    if sid in self._mem:
                        self._loc[sid] = (off, flen)
                    elif sid in self._evicted:
                        self._evicted[sid] = (rec["version"], off, flen)
                off += flen
            # evicted entries whose offset stayed -1 are snapshot-resident
            # (evicted during replay, no WAL record of their own): kept —
            # _rehydrate_locked reads them back out of the snapshot
            self._wal_fh = open(wal_path, "ab")
            self._wal_bytes = os.path.getsize(wal_path)

    def _load_snapshot_locked(self, gen: int) -> bool:
        try:
            with open(self._snap_path(gen), "rb") as fh:
                data = fh.read()
            payloads, _, torn = read_frames(data)
            if len(payloads) != 1 or torn:
                return False
            snap = pickle.loads(payloads[0])
        except (OSError, pickle.UnpicklingError, WalError, EOFError):
            return False
        self._mem = OrderedDict((bytes(s), (int(v), bytes(b))) for s, v, b in snap["entries"])
        self._dedup = {bytes(c): (int(cs), int(v)) for c, (cs, v) in snap["dedup"].items()}
        self.seq = int(snap["seq"])
        self.epoch = int(snap["epoch"])
        return True

    def _open_wal_locked(self) -> None:
        self._wal_fh = open(self._wal_path(self.gen), "ab")
        self._wal_bytes = os.path.getsize(self._wal_path(self.gen))

    # -- the apply core (every mutation, local or replicated, lands here) ----
    def _apply_locked(
        self, rec: Dict[str, Any], payload: bytes, offset: Optional[int]
    ) -> None:
        """Mutate in-memory state for one decoded record. ``offset`` is the
        record's frame offset in the live WAL when known (fresh appends),
        None during recovery replay (indices are rebuilt afterwards)."""
        op = rec["op"]
        sid = rec["sid"]
        if op == OP_PUT:
            old = self._mem.pop(sid, None)
            if old is not None:
                self._prev[sid] = (old[0], old[1])
            else:
                self._prev.pop(sid, None)
            self._mem[sid] = (rec["version"], rec["blob"])
            self._evicted.pop(sid, None)
            if offset is not None:
                self._loc[sid] = (offset, _PREFIX_LEN + len(payload))
            while len(self._mem) > self.max_sessions:
                ev_sid, (ev_ver, _ev_blob) = self._mem.popitem(last=False)
                self.evictions += 1
                self._prev.pop(ev_sid, None)
                loc = self._loc.pop(ev_sid, None)
                if self.durability != "memory":
                    # durable but no longer resident: remember where its
                    # newest record lives so a later get() can rehydrate
                    # (offset -1 during recovery replay — rebuilt afterwards)
                    self._evicted[ev_sid] = (
                        (ev_ver, loc[0], loc[1]) if loc is not None else (ev_ver, -1, 0)
                    )
            if rec["client_seq"] >= 0 and rec["client_id"]:
                self._dedup[rec["client_id"]] = (rec["client_seq"], rec["version"])
        elif op == OP_DROP:
            self._mem.pop(sid, None)
            self._prev.pop(sid, None)
            self._evicted.pop(sid, None)
            self._loc.pop(sid, None)
        elif op == OP_PROMOTE:
            pass  # epoch tracking below covers it
        self.seq = rec["seq"]
        self.epoch = max(self.epoch, rec["epoch"])
        self._tail.append((rec["seq"], payload))
        if self._wal_fh is None:
            # memory-only store: compaction never runs, so the replication
            # tail must bound itself — a standby that falls further behind
            # than this gets a full-state bootstrap instead of records
            while len(self._tail) > _MEMORY_TAIL_MAX:
                self._tail.popleft()

    def _append_locked(self, payload: bytes) -> int:
        """Write one framed record per the durability mode; returns the
        frame's offset in the live WAL (or -1 in memory mode)."""
        if self._wal_fh is None:
            return -1
        wire = frame_record(payload)
        offset = self._wal_bytes
        self._wal_fh.write(wire)
        if self.durability in ("wal", "fsync"):
            self._wal_fh.flush()
        if self.durability == "fsync":
            t0 = time.monotonic()
            os.fsync(self._wal_fh.fileno())
            self._fsync_ms.append((time.monotonic() - t0) * 1000.0)
        self._wal_bytes += len(wire)
        return offset

    def _maybe_compact_locked(self) -> None:
        """Compact once the live WAL outgrows the budget. Called AFTER the
        triggering record has been applied — compacting from inside the
        append would snapshot a state that misses the record just written,
        then delete the only bytes that held it."""
        if self._wal_fh is not None and self._wal_bytes >= self.compact_bytes:
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Snapshot the resident state into the next generation and start a
        fresh WAL. Evicted-but-durable sessions do NOT survive: their only
        bytes lived in the WAL being retired (compacted away → a later get
        is an honest miss)."""
        if self.wal_dir is None:
            return
        new_gen = self.gen + 1
        snap = {
            "entries": [(s, v, b) for s, (v, b) in self._mem.items()],
            "dedup": dict(self._dedup),
            "seq": self.seq,
            "epoch": self.epoch,
        }
        tmp = os.path.join(self.wal_dir, _SNAP_TMP)
        with open(tmp, "wb") as fh:
            fh.write(frame_record(pickle.dumps(snap, protocol=pickle.HIGHEST_PROTOCOL)))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._snap_path(new_gen))
        old_gen = self.gen
        if self._wal_fh is not None:
            self._wal_fh.close()
        self.gen = new_gen
        self._open_wal_locked()
        compacted_away = len(self._evicted)
        self._evicted.clear()
        self._loc.clear()
        self._tail.clear()
        self.compactions += 1
        for path in (self._snap_path(old_gen), self._wal_path(old_gen)):
            try:
                os.remove(path)
            except OSError:
                pass
        _emit(
            self.emit,
            {
                "event": "broker",
                "action": "compact",
                "seq": int(self.seq),
                "sessions": len(self._mem),
                "count": int(compacted_away),
                "detail": f"generation {new_gen}",
            },
        )

    # -- byte/text edges -----------------------------------------------------
    def _sid_bytes(self, sid: Any) -> bytes:
        return sid if isinstance(sid, bytes) else str(sid).encode("utf-8")

    def _blob_bytes(self, blob: Any) -> bytes:
        return blob if isinstance(blob, bytes) else str(blob).encode("ascii")

    def _blob_out(self, blob: bytes) -> Any:
        return blob.decode("ascii") if self.text else blob

    # -- broker surface ------------------------------------------------------
    def put(self, sid: Any, blob: Any, client_id: bytes = b"", client_seq: int = -1) -> int:
        """Absorb one acked step's latent; returns the assigned version.
        Returns (= acks) only once the configured durability level holds.
        A replayed ``(client_id, client_seq)`` is answered from the dedup
        map without re-applying — exactly-once under reconnect replay."""
        sid_b = self._sid_bytes(sid)
        blob_b = self._blob_bytes(blob)
        with self._lock:
            if client_seq >= 0 and client_id:
                known = self._dedup.get(client_id)
                if known is not None and client_seq <= known[0]:
                    self.dedup_hits += 1
                    return known[1]
            version = self._version_locked(sid_b) + 1
            payload = encode_record(
                self.seq + 1, self.epoch, OP_PUT, version, client_seq, client_id, sid_b, blob_b
            )
            offset = self._append_locked(payload)
            self._apply_locked(decode_record(payload), payload, offset if offset >= 0 else None)
            self._maybe_compact_locked()
            return version

    def get(self, sid: Any, at_version: int = 0) -> Optional[Tuple[int, Any]]:
        """The newest ``(version, blob)`` — or, when ``at_version`` names
        the PREVIOUS version, that one: the rehydrate-at-acked-version read
        that keeps an in-doubt (applied-but-never-acked) PUT from leaking
        into the acked trajectory. Any other ``at_version`` falls back to
        newest (history is two-deep, best-effort, process-lifetime)."""
        sid_b = self._sid_bytes(sid)
        with self._lock:
            entry = self._mem.get(sid_b)
            if entry is not None:
                self._mem.move_to_end(sid_b)
                if at_version and at_version != entry[0]:
                    prev = self._prev.get(sid_b)
                    if prev is not None and prev[0] == at_version:
                        return prev[0], self._blob_out(prev[1])
                return entry[0], self._blob_out(entry[1])
            return self._rehydrate_locked(sid_b)

    def _rehydrate_locked(self, sid_b: bytes) -> Optional[Tuple[int, Any]]:
        ev = self._evicted.get(sid_b)
        if ev is None or self._wal_fh is None:
            return None
        version, offset, flen = ev
        try:
            if offset < 0:
                # the session's only bytes live in the current SNAPSHOT (it
                # was resident at compaction/recovery and has not been PUT
                # since): re-read it from there — a durable session must
                # never 410 just because it went idle across a compaction
                version, blob = self._read_snapshot_entry_locked(sid_b)
                loc = None
            else:
                self._wal_fh.flush()  # memory mode may still be buffering
                with open(self._wal_path(self.gen), "rb") as fh:
                    fh.seek(offset)
                    data = fh.read(flen)
                payloads, _, torn = read_frames(data)
                if torn or len(payloads) != 1:
                    raise WalError(f"rehydrate record unreadable at {offset}")
                rec = decode_record(payloads[0])
                if rec["sid"] != sid_b or rec["op"] != OP_PUT:
                    raise WalError("rehydrate offset points at the wrong record")
                blob = rec["blob"]
                loc = (offset, flen)
        except (OSError, WalError, KeyError, pickle.UnpicklingError) as err:
            _emit(
                self.emit,
                {
                    "event": "broker",
                    "action": "rehydrate_failed",
                    "detail": str(err)[:200],
                },
            )
            self._evicted.pop(sid_b, None)
            return None
        self._evicted.pop(sid_b, None)
        self._mem[sid_b] = (version, blob)
        if loc is not None:
            self._loc[sid_b] = loc
        self._mem.move_to_end(sid_b)
        while len(self._mem) > self.max_sessions:
            ev_sid, (ev_ver, _b) = self._mem.popitem(last=False)
            self.evictions += 1
            loc = self._loc.pop(ev_sid, None)
            if loc is not None and self.durability != "memory":
                self._evicted[ev_sid] = (ev_ver, loc[0], loc[1])
        self.rehydrates += 1
        _emit(
            self.emit,
            {
                "event": "broker",
                "action": "wal_rehydrate",
                "version": int(version),
                "seq": int(self.seq),
            },
        )
        return version, self._blob_out(blob)

    def _read_snapshot_entry_locked(self, sid_b: bytes) -> Tuple[int, bytes]:
        """One session's (version, blob) out of the current generation's
        snapshot — the rehydrate source for sessions with no live-WAL
        record. Rare path (idle-across-compaction sessions), so the whole
        snapshot re-read is acceptable."""
        with open(self._snap_path(self.gen), "rb") as fh:
            data = fh.read()
        payloads, _, torn = read_frames(data)
        if torn or len(payloads) != 1:
            raise WalError("snapshot unreadable for rehydrate")
        snap = pickle.loads(payloads[0])
        for s, v, b in snap["entries"]:
            if bytes(s) == sid_b:
                return int(v), bytes(b)
        raise WalError("session absent from the snapshot")

    def _version_locked(self, sid_b: bytes) -> int:
        entry = self._mem.get(sid_b)
        if entry is not None:
            return entry[0]
        ev = self._evicted.get(sid_b)
        return ev[0] if ev is not None else 0

    def version(self, sid: Any) -> int:
        entry = self.get(sid)
        return entry[0] if entry is not None else 0

    def drop(self, sid: Any) -> None:
        sid_b = self._sid_bytes(sid)
        with self._lock:
            if sid_b not in self._mem and sid_b not in self._evicted:
                return
            payload = encode_record(self.seq + 1, self.epoch, OP_DROP, 0, -1, b"", sid_b, b"")
            self._append_locked(payload)
            self._apply_locked(decode_record(payload), payload, None)
            self._maybe_compact_locked()

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem) + len(self._evicted)

    # -- replication surface -------------------------------------------------
    def bump_epoch(self) -> int:
        """Promotion: the new fencing token, made durable through the WAL
        before anyone is allowed to observe it."""
        with self._lock:
            new_epoch = self.epoch + 1
            payload = encode_record(self.seq + 1, new_epoch, OP_PROMOTE, 0, -1, b"", b"", b"")
            self._append_locked(payload)
            self._apply_locked(decode_record(payload), payload, None)
            self._maybe_compact_locked()
            return self.epoch

    def records_since(self, seq: int) -> Optional[List[Tuple[int, bytes]]]:
        """The retained tail after ``seq`` (for standby catch-up), or None
        when ``seq`` predates the tail (compaction ate it — the standby
        needs :meth:`encoded_state` instead)."""
        with self._lock:
            if seq < (self._tail[0][0] - 1 if self._tail else self.seq):
                return None
            return [(s, p) for s, p in self._tail if s > seq]

    def encoded_state(self) -> bytes:
        """Full-state bootstrap blob for a fresh/lagging standby (CRC-framed
        like every other broker byte stream)."""
        with self._lock:
            snap = {
                "entries": [(s, v, b) for s, (v, b) in self._mem.items()],
                "dedup": dict(self._dedup),
                "seq": self.seq,
                "epoch": self.epoch,
            }
        return frame_record(pickle.dumps(snap, protocol=pickle.HIGHEST_PROTOCOL))

    def load_state(self, data: bytes) -> None:
        """Adopt a primary's full-state blob (standby bootstrap). A blob
        whose epoch is BEHIND this store's is refused (:class:`StaleEpoch`):
        snapshots must obey the same fencing rule as records, or a zombie
        primary's bootstrap push could roll a promoted standby back."""
        payloads, _, torn = read_frames(data)
        if torn or len(payloads) != 1:
            raise WalError("state blob failed CRC validation")
        snap = pickle.loads(payloads[0])
        if int(snap["epoch"]) < self.epoch:
            raise StaleEpoch(
                f"state blob epoch {snap['epoch']} is behind local epoch {self.epoch}"
            )
        with self._lock:
            self._mem = OrderedDict(
                (bytes(s), (int(v), bytes(b))) for s, v, b in snap["entries"]
            )
            self._dedup = {bytes(c): (int(cs), int(v)) for c, (cs, v) in snap["dedup"].items()}
            self._prev.clear()
            self._evicted.clear()
            self._loc.clear()
            self._tail.clear()
            self.seq = int(snap["seq"])
            self.epoch = int(snap["epoch"])
            if self._wal_fh is not None:
                # the standby's own durability restarts from this state:
                # snapshot it as a fresh generation so recovery agrees
                self._compact_locked()

    def apply_wire(self, payload: bytes) -> Tuple[int, int]:
        """Standby-side apply of one replicated record payload. Strictly
        sequential: a gap means frames were lost and the standby must
        re-sync. Returns ``(seq, epoch)`` applied."""
        rec = decode_record(payload)
        with self._lock:
            if rec["seq"] <= self.seq:
                return self.seq, self.epoch  # replayed catch-up overlap
            if rec["seq"] != self.seq + 1:
                raise WalError(f"replication gap: got seq {rec['seq']}, have {self.seq}")
            offset = self._append_locked(payload)
            self._apply_locked(rec, payload, offset if offset >= 0 else None)
            self._maybe_compact_locked()
            return self.seq, self.epoch

    # -- stats ---------------------------------------------------------------
    def fsync_p95_ms(self) -> float:
        with self._lock:
            if not self._fsync_ms:
                return 0.0
            vals = sorted(self._fsync_ms)
            return vals[min(len(vals) - 1, int(round(0.95 * (len(vals) - 1))))]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "sessions": len(self._mem),
                "evicted_durable": len(self._evicted),
                "seq": self.seq,
                "epoch": self.epoch,
                "gen": self.gen,
                "wal_bytes": self._wal_bytes,
                "evictions": self.evictions,
                "rehydrates": self.rehydrates,
                "torn_tails": self.torn_tails,
                "compactions": self.compactions,
                "dedup_hits": self.dedup_hits,
                "durability": self.durability,
                "fsync_p95_ms": round(self.fsync_p95_ms(), 3),
            }

    def close(self) -> None:
        with self._lock:
            if self._wal_fh is not None:
                self._wal_fh.flush()
                if self.durability == "fsync":
                    os.fsync(self._wal_fh.fileno())
                self._wal_fh.close()
                self._wal_fh = None
