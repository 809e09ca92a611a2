"""The fleet supervision tree: spawn, watch, respawn, quarantine (the port's
own copy of ``sheeprl_tpu/fleet/supervisor.py``).

Going multi-process makes worker death a *normal* event, so the supervisor
treats every failure as data, not as an exception:

* **crash** — the process exitcode flips non-None while the fleet is
  running. Whatever the dead incarnation left in its data queue is salvaged
  first (those packets were produced and framed before death — the CRC
  decides, not the death), then the worker respawns with jittered
  exponential backoff (the `with_retries` schedule, applied to a process
  instead of a call).
* **hang** — the shared heartbeat counter stops advancing. Each worker has
  its own :class:`~sheeprl_tpu_torch.resilience.supervisor.HeartbeatWatchdog`
  watching that counter; when it fires the supervisor re-checks the counter
  (a watchdog firing during a long learner burst is a false alarm if the
  counter moved) and, if genuinely wedged, SIGKILLs the process and routes
  it through the same fault path as a crash.
* **torn packet** — a frame failed CRC validation learner-side. Corrupted
  IPC means the incarnation can't be trusted: same fault path.
* **fail budget → quarantine** — more than ``max_fails`` faults inside
  ``fail_window_s`` flags the worker's env slice as poisoned: the worker is
  never respawned, its columns are excluded from new rounds, and the fleet
  degrades gracefully (the engine shrinks the round width and keeps the
  replay-ratio ledger exact over the *surviving* steps).

Every transition emits a ``fleet`` JSONL telemetry event, so the incident
timeline can be read back from the run's stream.

Workers are started with the ``spawn`` context, never ``fork``: the learner
holds a CUDA context that a forked child would inherit half-copied. Under
``worker_platform=cpu`` the card is hidden from each child before its
interpreter starts (``CUDA_VISIBLE_DEVICES=""``), so a worker can never
create a CUDA context of its own.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import random
import sys
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..resilience.chaos import chaos_from_cfg
from ..resilience.supervisor import HeartbeatWatchdog
from ..telemetry import tracing
from .net import FleetListener, NetConfig, NetStats
from .protocol import CTRL_CLOCK, CTRL_PARAMS, CTRL_PROFILE, CTRL_STOP, WorkerChannel
from .worker import worker_entry

__all__ = ["FleetSupervisor", "WorkerHandle", "worker_env"]

_WORKER_ENV = ("CUDA_VISIBLE_DEVICES",)


def worker_env(worker_platform: str) -> Dict[str, str]:
    """What a worker's interpreter starts with beyond the learner's
    environment: no visible card (``CUDA_VISIBLE_DEVICES=""``).

    ``worker_platform`` names the device the workers act on. The worker
    programs act on the host CPU, so ``cpu`` is the only value accepted."""
    if worker_platform != "cpu":
        raise ValueError(
            "fleet.worker_platform names the device the workers act on; the worker "
            f"programs act on the host CPU, so it must be 'cpu', got {worker_platform!r}"
        )
    return {"CUDA_VISIBLE_DEVICES": ""}


def _emit(telem: Any, rec: Dict[str, Any]) -> None:
    if telem is not None:
        try:
            telem.emit(rec)
        except Exception:
            pass


class WorkerHandle:
    """Supervision state for one worker slot (stable across incarnations)."""

    def __init__(self, worker_id: int):
        self.worker_id = int(worker_id)
        self.proc: Optional[mp.process.BaseProcess] = None
        self.channel: Optional[WorkerChannel] = None
        self.chaos: Optional[Any] = None
        self.watchdog: Optional[HeartbeatWatchdog] = None
        self.incarnation = 0
        self.state = "new"  # new | running | backoff | quarantined | stopped
        self.clock_probed = False  # one handshake per incarnation, post-startup
        self.spawned_at = 0.0
        self.fails: deque = deque()  # (monotonic_t, reason)
        self.respawn_at = 0.0
        self.respawns = 0
        self.salvage: List[Any] = []  # frames drained from a dead incarnation
        self.hung_stall: Optional[tuple] = None  # (hb_at_stall, stalled_s)

    @property
    def active(self) -> bool:
        """Counts toward round membership: alive now or coming back."""
        return self.state in ("running", "backoff")

    @property
    def alive(self) -> bool:
        return self.state == "running" and self.proc is not None and self.proc.is_alive()


class FleetSupervisor:
    def __init__(
        self,
        cfg: Any,
        telem: Any = None,
        *,
        program: str,
        num_workers: int,
        queue_depth: int = 4,
        hang_s: float = 60.0,
        spawn_grace_s: float = 120.0,
        backoff_s: float = 0.5,
        max_backoff_s: float = 30.0,
        jitter: float = 0.5,
        max_fails: int = 3,
        fail_window_s: float = 300.0,
        worker_platform: str = "cpu",
        seed: int = 0,
        log_dir: Optional[str] = None,
        trace: bool = True,
        transport: str = "mp",
        net: Optional[NetConfig] = None,
        remote_workers: Optional[List[int]] = None,
        shutdown_drain_s: float = 10.0,
        relay: Optional[Dict[str, Any]] = None,
    ):
        self.cfg = cfg
        self.telem = telem
        self.log_dir = str(log_dir) if log_dir else None
        self.trace = bool(trace)
        self.program = str(program)
        self.num_workers = int(num_workers)
        self.queue_depth = int(queue_depth)
        self.hang_s = float(hang_s)
        self.spawn_grace_s = float(spawn_grace_s)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.max_fails = int(max_fails)
        self.fail_window_s = float(fail_window_s)
        self.worker_platform = str(worker_platform)
        worker_env(self.worker_platform)
        self.seed = int(seed)
        self.transport = str(transport)
        if self.transport not in ("mp", "socket"):
            raise ValueError(f"fleet.transport must be 'mp' or 'socket', got {transport!r}")
        self.net = net or NetConfig()
        self.remote_workers = [int(w) for w in (remote_workers or [])]
        self.shutdown_drain_s = float(shutdown_drain_s)
        # relay knobs ride every spec (incl. the HELLO_ACK spec a remote
        # worker receives) so all incarnations tee telemetry upstream
        self.relay_cfg: Dict[str, Any] = dict(relay or {})
        # one listener + shared link counters for the whole fleet (socket
        # transport only); the token fences this run's workers from strays
        self.listener: Optional[FleetListener] = None
        self.net_stats: Optional[NetStats] = None
        self._net_token = uuid.uuid4().hex
        self._ctx = mp.get_context("spawn")
        self._cfg_dict = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
        self.handles: List[WorkerHandle] = [WorkerHandle(i) for i in range(self.num_workers)]
        self._last_params: Optional[tuple] = None  # (version, payload)
        # global env-step progress (engine-maintained): spawns seed the
        # program's lifetime counter from it so learning_starts gating
        # survives respawn and checkpoint resume instead of resetting to
        # random-action warmup mid-run
        self.progress_step = 0
        self.pub_seq = 0
        self.total_respawns = 0
        self.torn_packets = 0
        self.crashes = 0
        self.hangs = 0
        self.disconnects = 0
        self._stopping = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FleetSupervisor":
        if self.transport == "socket":
            self.net_stats = NetStats()
            self.listener = FleetListener(
                self.net,
                self._net_token,
                stats=self.net_stats,
                emit=(self.telem.emit if self.telem is not None else None),
            )
        for handle in self.handles:
            self._spawn(handle)
        return self

    def _spawn(self, handle: WorkerHandle) -> None:
        handle.chaos = chaos_from_cfg(self.cfg, handle.worker_id, run_seed=self.seed)
        if handle.chaos is not None:
            handle.chaos.incarnation = handle.incarnation
        spec = {
            "program": self.program,
            "cfg": self._cfg_dict,
            "worker_id": handle.worker_id,
            "num_workers": self.num_workers,
            "incarnation": handle.incarnation,
            "initial_lifetime": self.progress_step // self.num_workers,
            "log_dir": self.log_dir,  # the worker's own telemetry stream root
            "trace": self.trace,
            "relay": self.relay_cfg,
            "platform": self.worker_platform,
        }
        remote = handle.worker_id in self.remote_workers
        if self.transport == "socket":
            # the learner-side channel is the listener registration; the
            # child (or a remotely-started worker) dials back with the run
            # token and this incarnation
            handle.channel = self.listener.register(
                handle.worker_id,
                handle.incarnation,
                self.queue_depth,
                # a remote worker gets the whole run spec in its HELLO_ACK
                # (it connected with nothing but worker_id + token)
                spec=spec if remote else None,
            )
            spec["connect"] = {
                # children of this process always dial loopback; a 0.0.0.0
                # bind is for remote workers, not the local spawn path
                "host": "127.0.0.1" if self.net.host in ("0.0.0.0", "::") else self.net.host,
                "port": self.listener.port,
                "token": self._net_token,
                "incarnation": handle.incarnation,
                "net": self.net,
            }
        else:
            handle.channel = WorkerChannel(self._ctx, self.queue_depth)
        if remote:
            # remote slot: no local process to manage — the slot goes live
            # when the remote host attaches (spawn_grace_s bounds the wait,
            # the reconnect grace bounds later link outages)
            handle.proc = None
            handle.state = "running"
            handle.hung_stall = None
            handle.clock_probed = False
            handle.spawned_at = time.monotonic()
            self._ensure_watchdog(handle)
            handle.watchdog.beat(-1 - handle.incarnation)
            _emit(
                self.telem,
                {
                    "event": "fleet",
                    "action": "await_attach",
                    "step": 0,
                    "worker": handle.worker_id,
                    "incarnation": handle.incarnation,
                    "detail": f"remote slot listening on port {self.listener.port}",
                },
            )
            print(
                f"[fleet] remote slot {handle.worker_id} waiting — start it with:\n"
                f"[fleet]   python -m sheeprl_tpu_torch.fleet.remote "
                f"--connect <this-host>:{self.listener.port} "
                f"--worker-id {handle.worker_id} --token {self._net_token}",
                file=sys.stderr,
                flush=True,
            )
            if self._last_params is not None:
                try:
                    handle.channel.ctrl.put((CTRL_PARAMS,) + self._last_params)
                except Exception:
                    pass
            return
        # the child inherits os.environ at exec: hide the card BEFORE its
        # interpreter starts, so the worker's torch can never touch the
        # learner's device (restored at once: spawn's exec happens inside
        # start())
        saved = {k: os.environ.get(k) for k in _WORKER_ENV}
        os.environ.update(worker_env(self.worker_platform))
        try:
            handle.proc = self._ctx.Process(
                target=worker_entry,
                args=(
                    spec,
                    handle.channel if self.transport == "mp" else None,
                    handle.chaos,
                ),
                name=f"fleet-worker-{handle.worker_id}",
                daemon=True,
            )
            handle.proc.start()
            if self.transport == "mp":
                handle.channel.release_worker_ends()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        handle.state = "running"
        handle.hung_stall = None
        handle.clock_probed = False
        handle.spawned_at = time.monotonic()
        self._ensure_watchdog(handle)
        handle.watchdog.beat(-1 - handle.incarnation)  # fresh epoch per spawn
        _emit(
            self.telem,
            {
                "event": "fleet",
                "action": "respawn" if handle.incarnation else "spawn",
                "step": 0,
                "worker": handle.worker_id,
                "incarnation": handle.incarnation,
                "pid": handle.proc.pid,
            },
        )
        # a respawned worker starts acting with the newest snapshot at once
        if self._last_params is not None:
            try:
                handle.channel.ctrl.put((CTRL_PARAMS,) + self._last_params)
            except Exception:
                pass

    def _ensure_watchdog(self, handle: WorkerHandle) -> None:
        if handle.watchdog is None:
            handle.watchdog = HeartbeatWatchdog(
                stall_s=self.hang_s,
                action="none",
                telem=None,  # the supervisor emits the fleet-scoped event
                poll_s=max(0.05, min(1.0, self.hang_s / 5.0)),
                on_stall=self._make_on_stall(handle),
            ).start()

    def _make_on_stall(self, handle: WorkerHandle) -> Callable[[int, float], None]:
        def on_stall(hb_at_stall: int, stalled_s: float) -> None:
            handle.hung_stall = (hb_at_stall, stalled_s)

        return on_stall

    # -- param publication -------------------------------------------------
    def publish(self, params_np: Any) -> int:
        """Push a versioned param snapshot to every live worker (the fleet
        half of the ParamMirror→publication path). Returns the version.

        The snapshot is pickled ONCE here and the same bytes blob is put on
        every ctrl queue — N queue feeders re-pickling a multi-MB pytree
        independently would tax the learner host N× per train burst; a
        bytes put is a memcpy. Workers unpickle on receipt.

        Each publication carries its wall-clock send time and a fresh trace
        id: the learner emits the `publish` span, every worker emits a
        `param_apply` span in the same trace — their pairing is the
        per-worker param-apply lag the trace report surfaces."""
        self.pub_seq += 1
        t_pub = time.time()
        pub_trace = tracing.new_trace_id()
        blob = pickle.dumps(params_np, protocol=pickle.HIGHEST_PROTOCOL)
        self._last_params = (self.pub_seq, blob, t_pub, pub_trace)
        for handle in self.handles:
            if handle.state != "running" or handle.channel is None:
                continue
            if handle.chaos is not None and handle.chaos.drops_publication(self.pub_seq):
                _emit(
                    self.telem,
                    {
                        "event": "chaos",
                        "fault": "dropped_publication",
                        "worker": handle.worker_id,
                        "seq": self.pub_seq,
                    },
                )
                continue
            try:
                handle.channel.ctrl.put((CTRL_PARAMS,) + self._last_params)
            except Exception:
                pass  # a dying worker's queue: the monitor will catch it
        if self.trace:
            _emit(
                self.telem,
                tracing.span_record(
                    "publish",
                    "learner",
                    tracing.TraceContext(pub_trace, tracing.new_span_id()),
                    t_pub,
                    time.time(),
                    version=self.pub_seq,
                ),
            )
        return self.pub_seq

    def resend_params(self, worker_id: int, step: int = 0) -> None:
        """Re-deliver the newest publication to one running worker — the
        recovery path for a lost/dropped ctrl message (e.g. chaos
        ``drop_publication``). Idempotent worker-side (same version, same
        bytes: a worker already past it just re-parks), but it unblocks a
        strict-mode worker parked forever on a publication that never
        arrived. Deliberately does NOT consult the chaos injector: the drop
        already happened, this is the recovery."""
        handle = self.handles[worker_id]
        if handle.state != "running" or handle.channel is None or self._last_params is None:
            return
        _emit(
            self.telem,
            {
                "event": "fleet",
                "action": "republish",
                "step": int(step),
                "worker": handle.worker_id,
                "detail": f"publication {self._last_params[0]} re-delivered",
            },
        )
        try:
            handle.channel.ctrl.put((CTRL_PARAMS,) + self._last_params)
        except Exception:
            pass

    def request_profile(self, worker_id: int, duration_s: float = 2.0) -> bool:
        """Trigger a windowed ``torch.profiler`` capture inside one worker
        process. The capture dir lands in the worker's stream dir and is
        announced there as a ``trace`` event."""
        handle = self.handles[int(worker_id)]
        if handle.state != "running" or handle.channel is None:
            return False
        try:
            handle.channel.ctrl.put((CTRL_PROFILE, float(duration_s)))
        except Exception:
            return False
        _emit(
            self.telem,
            {
                "event": "fleet",
                "action": "profile",
                "step": 0,
                "worker": handle.worker_id,
                "detail": f"windowed capture requested ({duration_s:.1f}s)",
            },
        )
        return True

    # -- monitoring --------------------------------------------------------
    def monitor(self, step: int = 0) -> None:
        """One supervision sweep (called from the learner's round wait):
        detect crashes/hangs, run due respawns, apply the fail budget."""
        now = time.monotonic()
        for handle in self.handles:
            if handle.state == "running":
                proc = handle.proc
                if proc is not None and proc.exitcode is not None and not self._stopping:
                    self.crashes += 1
                    self.fault(
                        handle, "crash", step=step, detail=f"exitcode={proc.exitcode}",
                        exitcode=int(proc.exitcode),
                    )
                    continue
                if (
                    self.transport == "socket"
                    and handle.channel is not None
                    and handle.channel.ever_connected()
                    and not self._stopping
                ):
                    # a dropped link gets a reconnect window before it is a
                    # fault: the worker side is busy retrying with jittered
                    # backoff — only a link down PAST the grace goes through
                    # the fail-budget → quarantine path
                    down_s = handle.channel.disconnected_for()
                    if down_s > self.net.reconnect_grace_s:
                        self.disconnects += 1
                        self.fault(
                            handle,
                            "disconnect",
                            step=step,
                            detail=(
                                f"link down {down_s:.1f}s > reconnect grace "
                                f"{self.net.reconnect_grace_s:.0f}s"
                            ),
                        )
                        continue
                    if down_s > 0:
                        # heartbeats ride the wire: while the link is down
                        # (but inside the grace) they CANNOT advance, so the
                        # hang watchdog must not convert an in-grace outage
                        # into a SIGKILL — the grace clock governs here
                        handle.hung_stall = None
                        continue
                if handle.channel is not None and handle.watchdog is not None:
                    hb = int(handle.channel.heartbeat.value)
                    if hb <= 0:
                        # still starting up (interpreter + torch import + env
                        # construction): the hang clock starts at the FIRST
                        # heartbeat; a worker wedged in startup is caught by
                        # the (much longer) spawn grace budget instead
                        handle.hung_stall = None
                        if now - handle.spawned_at > self.spawn_grace_s:
                            self.hangs += 1
                            self.fault(
                                handle,
                                "hang",
                                step=step,
                                detail=(
                                    f"no heartbeat within {self.spawn_grace_s:.0f}s of spawn"
                                ),
                            )
                        continue
                    if not handle.clock_probed:
                        # clock-offset handshake, sent only once the worker's
                        # loop is demonstrably running (first heartbeat): a
                        # probe queued at spawn would measure interpreter +
                        # torch startup as "skew". The worker answers with a
                        # `clock` event on its OWN stream.
                        handle.clock_probed = True
                        try:
                            handle.channel.ctrl.put((CTRL_CLOCK, time.time()))
                        except Exception:
                            pass
                    handle.watchdog.beat(hb)
                    if handle.hung_stall is not None:
                        hb_at_stall, stalled_s = handle.hung_stall
                        if hb != hb_at_stall:
                            handle.hung_stall = None  # advanced: false alarm
                        else:
                            self.hangs += 1
                            self.fault(
                                handle,
                                "hang",
                                step=step,
                                detail=f"no heartbeat for {stalled_s:.1f}s",
                            )
            elif handle.state == "backoff" and now >= handle.respawn_at:
                handle.incarnation += 1
                handle.respawns += 1
                self.total_respawns += 1
                self._spawn(handle)

    def fault(
        self,
        handle: WorkerHandle,
        reason: str,
        step: int = 0,
        detail: str = "",
        exitcode: Optional[int] = None,
    ) -> None:
        """Route one worker failure: salvage its queue, kill what's left,
        then either schedule a respawn or quarantine the slice."""
        if handle.state in ("quarantined", "stopped"):
            return
        # salvage packets the dead incarnation already framed: they were
        # produced before the fault and carry their own CRC
        if handle.channel is not None:
            handle.salvage.extend(handle.channel.drain_data())
        proc, handle.proc = handle.proc, None
        if proc is not None and proc.is_alive():
            proc.kill()
            proc.join(timeout=5.0)
        if handle.channel is not None:
            handle.channel.close()
            handle.channel = None
        if self.listener is not None:
            # a zombie reconnect from the dead incarnation must be refused
            # until the respawn re-registers the slot
            self.listener.unregister(handle.worker_id)
        handle.hung_stall = None
        now = time.monotonic()
        handle.fails.append((now, reason))
        while handle.fails and now - handle.fails[0][0] > self.fail_window_s:
            handle.fails.popleft()
        rec = {
            "event": "fleet",
            "action": reason,
            "step": int(step),
            "worker": handle.worker_id,
            "incarnation": handle.incarnation,
            "fails_in_window": len(handle.fails),
            "detail": str(detail),
        }
        if exitcode is not None:
            rec["exitcode"] = exitcode
        _emit(self.telem, rec)
        print(
            f"[fleet] worker {handle.worker_id} fault: {reason} ({detail}); "
            f"{len(handle.fails)}/{self.max_fails} in window",
            file=sys.stderr,
            flush=True,
        )
        if len(handle.fails) > self.max_fails:
            handle.state = "quarantined"
            _emit(
                self.telem,
                {
                    "event": "fleet",
                    "action": "quarantine",
                    "step": int(step),
                    "worker": handle.worker_id,
                    "fails_in_window": len(handle.fails),
                    "detail": f"fail budget exhausted ({self.max_fails} in {self.fail_window_s:.0f}s)",
                },
            )
            print(
                f"[fleet] worker {handle.worker_id} QUARANTINED "
                f"(its env slice is excluded; the fleet degrades gracefully)",
                file=sys.stderr,
                flush=True,
            )
        else:
            # with_retries schedule, applied to a process respawn
            n = len(handle.fails)
            delay = min(self.max_backoff_s, self.backoff_s * (2 ** (n - 1)))
            delay *= max(0.0, 1.0 + random.uniform(-self.jitter, self.jitter))
            handle.state = "backoff"
            handle.respawn_at = now + delay

    # -- views -------------------------------------------------------------
    def active_ids(self) -> List[int]:
        return [h.worker_id for h in self.handles if h.active]

    def alive_count(self) -> int:
        return sum(1 for h in self.handles if h.alive)

    def quarantined_ids(self) -> List[int]:
        return [h.worker_id for h in self.handles if h.state == "quarantined"]

    def drain_telem(self) -> List[Any]:
        """Sweep relayed telemetry batches off every live channel (both
        transports expose ``drain_telem``). Best-effort like everything on
        the relay path — a dead channel just contributes nothing."""
        out: List[Any] = []
        for h in self.handles:
            ch = h.channel
            if ch is None:
                continue
            drain = getattr(ch, "drain_telem", None)
            if drain is None:
                continue
            try:
                out.extend(drain())
            except Exception:
                pass
        return out

    def telem_dropped(self) -> int:
        """Learner-side relay drop count (socket buffer overflows)."""
        total = 0
        for h in self.handles:
            total += int(getattr(h.channel, "telem_dropped", 0) or 0)
        return total

    def queue_depth_max(self) -> int:
        out = 0
        for h in self.handles:
            if h.channel is not None:
                try:
                    out = max(out, h.channel.data.qsize())
                except (NotImplementedError, OSError):
                    pass
        return out

    # -- shutdown ----------------------------------------------------------
    def shutdown(self, timeout: Optional[float] = None) -> Dict[int, List[Any]]:
        """Stop every worker and return the leftover raw frames per worker
        (salvage + whatever was still queued) for the engine to drain. The
        drain budget defaults to ``fleet.shutdown_drain_s``."""
        self._stopping = True
        drain_s = self.shutdown_drain_s if timeout is None else float(timeout)
        for handle in self.handles:
            if handle.channel is not None:
                handle.channel.stop.set()
                try:
                    handle.channel.ctrl.put((CTRL_STOP,))
                except Exception:
                    pass
        leftovers: Dict[int, List[Any]] = {}
        deadline = time.monotonic() + drain_s
        for handle in self.handles:
            frames = list(handle.salvage)
            handle.salvage = []
            proc = handle.proc
            if proc is not None:
                # drain WHILE joining: a worker parked on a full data queue
                # can only exit once the queue has room
                while proc.is_alive() and time.monotonic() < deadline:
                    if handle.channel is not None:
                        frames.extend(handle.channel.drain_data())
                    proc.join(timeout=0.05)
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=5.0)
            elif handle.channel is not None and handle.state == "running":
                # remote slot: no process to join — drain what the link
                # still delivers inside the same budget
                while time.monotonic() < deadline and handle.channel.connected():
                    got = handle.channel.drain_data()
                    if not got:
                        time.sleep(0.05)
                    frames.extend(got)
            if handle.channel is not None:
                frames.extend(handle.channel.drain_data())
                handle.channel.close()
                handle.channel = None
            handle.proc = None
            if handle.watchdog is not None:
                handle.watchdog.stop()
                handle.watchdog = None
            if handle.state != "quarantined":
                handle.state = "stopped"
            leftovers[handle.worker_id] = frames
        if self.listener is not None:
            self.listener.close()
            self.listener = None
        return leftovers
