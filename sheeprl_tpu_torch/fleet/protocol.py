"""Wire protocol between the learner process and its env workers (the
port's own copy of ``sheeprl_tpu/fleet/protocol.py``; a frame is byte for
byte the JAX package's).

One :class:`WorkerChannel` per worker:

* ``data`` — a bounded ``mp.Queue`` carrying framed transition packets
  worker→learner. The bound IS the backpressure: a worker that runs ahead
  of the learner parks on ``put`` (stamping its heartbeat while it waits,
  so backpressure never looks like a hang).
* ``ctrl`` — an unbounded ``mp.Queue`` learner→worker for param
  publications and the stop message. Publications are versioned and the
  worker always drains to the NEWEST one (skipping versions is the whole
  point of a parameter-server actor: stale-but-bounded params, no sync).
* ``act_req`` / ``act_resp`` — the bounded queue pair of
  ``fleet.act_mode=inference``: a worker ships one act request and blocks
  on its response (``act_request``), served by the learner's
  :class:`~sheeprl_tpu_torch.fleet.act_service.ActService`.
* ``heartbeat`` — a shared ``mp.Value`` counter the worker bumps every
  loop, even while blocked on a full data queue. The supervisor feeds it
  into a per-worker :class:`~sheeprl_tpu_torch.resilience.supervisor.HeartbeatWatchdog`.
* ``param_version`` — a shared ``mp.Value`` the worker stamps with each
  publication it APPLIES. The learner's strict-round republish nudge
  consults it so only a worker genuinely missing the newest publication
  (a dropped/lost ctrl message) is re-sent the param blob — a healthy
  worker mid-rollout is never spammed with redundant copies.
* ``stop`` — a shared ``mp.Event``; set once at shutdown so a worker
  blocked anywhere can notice without a ctrl-queue race.

Packets are framed as ``(worker_id, incarnation, seq, crc32, payload_bytes)``
with the CRC computed over the pickled payload. A frame whose CRC does not
match (a torn packet — proved by the chaos layer's byte-flipper) is
*rejected*, counted, and treated as a worker fault: transitions are never
silently truncated into the replay buffer.

The frame format is deliberately **wire-shaped**: the same tuples travel
two transports behind the same channel surface (``fleet.transport``) —
this module's one-host ``mp.Queue`` channel, and the TCP byte-stream
channel in :mod:`sheeprl_tpu_torch.fleet.net` (length-prefixed frames, stream
resync on the CRC boundary, reconnect/replay with learner-side
``(incarnation, seq)`` dedup). ``encode_packet``/``decode_packet`` are the
single encode/validate pair for both: the learner re-runs the exact same
CRC check whether the frame crossed a queue or a network.
"""
from __future__ import annotations

import pickle
import time
import zlib
from typing import Any, List, NamedTuple, Optional, Tuple

__all__ = [
    "CTRL_CLOCK",
    "CTRL_PARAMS",
    "CTRL_PROFILE",
    "CTRL_STOP",
    "FleetPacket",
    "TornPacketError",
    "WorkerChannel",
    "decode_packet",
    "encode_packet",
]

CTRL_PARAMS = "params"
CTRL_STOP = "stop"
# clock-offset handshake probe: ("clock", t_send) — the worker answers by
# emitting a `clock` event on its own telemetry stream (tracing.clock_record)
CTRL_CLOCK = "clock"
# on-demand windowed profiler capture: ("profile", duration_s) — the worker
# opens a torch.profiler window into its stream dir (RemoteProfiler)
CTRL_PROFILE = "profile"


class FleetPacket(NamedTuple):
    """One decoded transition packet: ``payload`` is whatever the worker's
    program produced for one interaction slice (a ``RecordingSink`` for the
    step-based algorithms, a rollout tuple for PPO). ``trace`` is the
    ``(trace_id, span_id)`` the worker stamped on the slice's ``env_step``
    span — it rides the frame so the learner's apply span joins the same
    trace, and the cross-process round path (worker env step → queue wait →
    learner apply) can be joined from the streams."""

    worker_id: int
    incarnation: int
    seq: int
    env_steps: int
    version: int  # param publication version the worker acted with
    payload: Any
    stats: Tuple[Tuple[str, float], ...] = ()
    trace: Tuple[str, str] = ("", "")  # (trace_id, producing span_id)


class TornPacketError(RuntimeError):
    """A frame failed CRC/unpickle validation — corrupted in flight."""


class ChannelStopped(RuntimeError):
    """The channel was stopped (learner-initiated shutdown) while a worker
    was parked on it — a clean-exit signal, not a fault: ``worker_entry``
    treats it like KeyboardInterrupt so a wall-capped stop doesn't print N
    act-request tracebacks and count N worker deaths."""


def encode_packet(pkt: FleetPacket) -> Tuple[int, int, int, int, int, int, bytes]:
    """Frame a packet: the payload (+stats+trace) is pickled once here; the
    scalar header stays outside the blob so the learner can account a torn
    packet to the right worker without trusting the corrupted bytes."""
    blob = pickle.dumps((pkt.payload, pkt.stats, pkt.trace), protocol=pickle.HIGHEST_PROTOCOL)
    return (
        int(pkt.worker_id),
        int(pkt.incarnation),
        int(pkt.seq),
        int(pkt.env_steps),
        int(pkt.version),
        zlib.crc32(blob),
        blob,
    )


def decode_packet(frame: Any) -> FleetPacket:
    """Validate + decode one frame; raises :class:`TornPacketError` on any
    corruption (bad CRC, unpicklable payload, malformed frame)."""
    try:
        worker_id, incarnation, seq, env_steps, version, crc, blob = frame
    except (TypeError, ValueError) as err:
        raise TornPacketError(f"malformed frame: {err}") from err
    if zlib.crc32(blob) != crc:
        raise TornPacketError(
            f"worker {worker_id} packet seq={seq}: CRC mismatch ({len(blob)} bytes)"
        )
    try:
        obj = pickle.loads(blob)
        payload, stats = obj[0], obj[1]
        trace = tuple(obj[2]) if len(obj) > 2 else ("", "")
    except Exception as err:  # corrupted in a way the CRC happened to pass
        raise TornPacketError(f"worker {worker_id} packet seq={seq}: {err!r}") from err
    return FleetPacket(
        int(worker_id),
        int(incarnation),
        int(seq),
        int(env_steps),
        int(version),
        payload,
        stats,
        trace,
    )


class WorkerChannel:
    """The per-worker queue pair + shared liveness state. Built by the
    supervisor with a ``spawn`` multiprocessing context; a fresh channel is
    created for every incarnation so a corrupted queue never outlives the
    process that corrupted it."""

    def __init__(self, ctx: Any, queue_depth: int = 4):
        self.data = ctx.Queue(maxsize=max(1, int(queue_depth)))
        self.ctrl = ctx.Queue()
        # relayed telemetry batches (worker→learner, best-effort): small and
        # bounded — the relay is advisory, a full queue means the batch is
        # dropped worker-side (counted there), never backpressure
        self.telem = ctx.Queue(maxsize=64)
        # batched-inference acting (fleet.act_mode=inference): the worker
        # ships obs-batch requests on act_req and blocks on act_resp for its
        # actions. Bounded at 2: a worker has at most one request in flight
        # plus one idempotent re-send — anything deeper is a protocol bug,
        # and backpressure here must surface, not buffer
        self.act_req = ctx.Queue(maxsize=2)
        self.act_resp = ctx.Queue(maxsize=4)
        self.heartbeat = ctx.Value("q", 0, lock=False)
        self.param_version = ctx.Value("q", 0, lock=False)
        self.stop = ctx.Event()

    # -- worker side -------------------------------------------------------
    def act_request(self, req: Any, timeout_s: float = 30.0, beat: Optional[Any] = None) -> Any:
        """Ship one act request and block for its response, pulsing ``beat``
        every poll slice so the wait never reads as a worker hang. The
        request is re-sent once a second while unanswered (the service
        dedups by ``(worker_id, incarnation, req_id)`` — a re-send recovers
        a response lost to a restarted learner-side pump, it never steps
        latents twice). Raises ``TimeoutError`` past ``timeout_s``."""
        import queue as _q

        rid = int(req.get("req_id", 0))
        deadline = time.monotonic() + float(timeout_s)
        resend_at = 0.0
        while True:
            now = time.monotonic()
            if now >= deadline:
                raise TimeoutError(f"act request {rid} not answered within {timeout_s}s")
            if self.stop.is_set():
                raise ChannelStopped(f"act request {rid}: channel stopped")
            if now >= resend_at:
                resend_at = now + 1.0
                try:
                    self.act_req.put_nowait(req)
                except _q.Full:
                    pass  # previous send still queued: the service will get it
            if beat is not None:
                beat()
            try:
                resp = self.act_resp.get(timeout=min(0.1, max(0.0, deadline - now)))
            except _q.Empty:
                continue
            if int(resp.get("req_id", -1)) == rid:
                return resp
            # a stale response (an abandoned earlier request): drop and wait

    def telem_put(self, batch: Any) -> bool:
        """Non-blocking relay of one telemetry batch; False == dropped."""
        try:
            self.telem.put_nowait(batch)
            return True
        except Exception:
            return False

    # -- learner side ------------------------------------------------------
    def release_worker_ends(self) -> None:
        """Once the worker process has started (it holds its own copies):
        close this process's write ends of the worker→learner queues. A
        worker that dies in the middle of a put then leaves an end of file
        behind its partial message, which ends the sweep (see
        :meth:`drain_data`), instead of a read that waits forever for the
        rest of a message no one will write."""
        for q in (self.data, self.telem, self.act_req):
            try:
                q._writer.close()
            except Exception:
                pass

    def drain_data(self, limit: int = 1024) -> List[Any]:
        """Non-blocking sweep of everything currently queued. mp.Queue.get
        unpickles in THIS process, so a worker killed mid-``put`` can leave a
        truncated stream that raises (UnpicklingError et al.) — any failure
        here just ends the sweep: the frames already read survive, the
        channel is about to be torn down by the fault path anyway, and the
        learner must never die from its dead worker's garbage."""
        import queue as _q

        out: List[Any] = []
        for _ in range(limit):
            try:
                out.append(self.data.get_nowait())
            except _q.Empty:
                break
            except Exception:
                break
        return out

    def drain_telem(self, limit: int = 64) -> List[Any]:
        """Non-blocking sweep of relayed telemetry batches — the defensive
        posture of :meth:`drain_data`: any failure ends the sweep."""
        import queue as _q

        out: List[Any] = []
        for _ in range(limit):
            try:
                out.append(self.telem.get_nowait())
            except _q.Empty:
                break
            except Exception:
                break
        return out

    def close(self) -> None:
        for q in (self.data, self.ctrl, self.telem, self.act_req, self.act_resp):
            try:
                q.close()
                # do NOT join_thread(): a feeder mid-pickle on a dead queue
                # must not hang shutdown; cancel lets the process exit drop it
                q.cancel_join_thread()
            except Exception:
                pass
