"""Replica processes + the ReplicaManager supervision tree (the port's
counterpart of ``sheeprl_tpu/gateway/replica.py``).

Each replica is one full PolicyServer (bucketed policy, MicroBatcher,
optional CheckpointReloader) in its OWN process, listening on an ephemeral
port it reports back through a spawn-context queue. The manager applies the
actor fleet's supervision semantics to serving:

* **crash** — exitcode observed, or the gateway reports a transport error
  and the process turns out dead: respawn with jittered exponential backoff;
* **hang** — `/healthz` stops answering for ``hang_s`` (startup is covered
  by the longer ``spawn_grace_s`` budget, exactly like fleet workers):
  SIGKILL + the crash path;
* **fail budget → quarantine** — more than ``max_fails`` faults inside
  ``fail_window_s``: the replica is never respawned and the fleet serves
  degraded on the survivors;
* **rolling drain for hot reload** — ``rolling_reload()`` walks the healthy
  replicas ONE at a time, forcing each one's checkpoint-reload poll via
  ``POST /admin/reload`` and waiting for it to report healthy again before
  touching the next, so a param swap never stages weights on the whole
  fleet at once.

Health polls also harvest each replica's ``params_version`` and
``reload_staleness_s`` (the new /healthz freshness fields), which the
gateway's router uses to prefer fresh replicas.

Replicas come in two modes: ``checkpoint`` (a real trained policy — the
production path) and ``synthetic`` (a tiny stateful counter core through the
SAME serve stack — what the load bench and the chaos tests drive, so fleet
mechanics are provable without training). A chaos schedule
(:class:`~sheeprl_tpu_torch.resilience.chaos.ChaosInjector` kwargs in the spec)
rides into the replica and is consulted once per act request — an injected
``os._exit`` mid-stream is indistinguishable from an OOM kill, which is the
point.

Where a replica runs is ``gateway.replica.platform``: ``cuda`` (the default)
puts every replica's policy on ``cuda:0``, all of them sharing the one card,
and a replica that finds no card fails at startup (the manager's fault path
reports it; it never carries on on the CPU); ``cpu`` starts the replica's
interpreter with ``CUDA_VISIBLE_DEVICES=""`` and forces its config to
``fabric.accelerator=cpu``.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import random
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["ReplicaHandle", "ReplicaManager", "replica_entry", "replica_device", "synthetic_counter_core"]

PLATFORMS = ("cuda", "cpu")


def replica_env(platform: str) -> Dict[str, str]:
    """What a replica's interpreter starts with beyond the gateway's
    environment: no visible card for ``cpu`` replicas, nothing for ``cuda``."""
    if platform not in PLATFORMS:
        raise ValueError(f"gateway.replica.platform must be one of {PLATFORMS}, got {platform!r}")
    return {"CUDA_VISIBLE_DEVICES": ""} if platform == "cpu" else {}


def replica_device(platform: str) -> Any:
    """The device a replica serves on: ``cuda:0`` (raises where there is no
    card) or the CPU."""
    import torch

    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("gateway.replica.platform=cuda but this replica sees no CUDA device "
                           "(set gateway.replica.platform=cpu to serve on the host)")
    return torch.device("cuda", 0)


def _pin_platform(cfg: Any, platform: str) -> None:
    """Force a checkpoint replica's run config onto its platform's device."""
    if platform == "cpu":
        cfg.set_path("fabric.accelerator", "cpu")
    else:
        cfg.set_path("fabric.accelerator", "cuda")
        if cfg.select("algo.player") is not None:
            cfg.set_path("algo.player.device", "auto")


def _emit(sink: Any, rec: Dict[str, Any]) -> None:
    if sink is not None:
        try:
            sink.write(rec)
        except Exception:
            pass


# -- replica-side (child process) --------------------------------------------
def _counter_params(state: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """``{"w": ...}`` or a flywheel checkpoint's ``{"params": {"w": ...}}``
    (what the reloader hands ``swap_params``) as the counter's module."""
    params = state["params"] if "params" in state else state
    return {"counter": {"w": params["w"]}}


def synthetic_counter_core(device: Any = "cpu"):
    """A stateful PolicyCore whose latent is a per-session step counter and
    whose action echoes the pre-step counter — session continuity (and
    therefore migration correctness) is directly observable in the actions.
    The counter lives on ``device``; the params tree is the flywheel's
    ``{"w": [1]}`` (served as the module ``counter``, unused by the act).
    Built INSIDE the replica process; nothing here crosses the spawn."""
    import numpy as np
    import torch

    from ..serve.policy import PolicyCore

    device = torch.device(device)

    def apply(params, obs, state, noise, greedy):
        (count,) = state
        return count, (count + 1.0,)

    return PolicyCore(
        apply=apply,
        extract_params=_counter_params,
        prepare=lambda raw, n: np.asarray(raw["x"], np.float32).reshape(n, -1),
        dummy_obs=lambda n: np.zeros((n, 1), np.float32),
        draw_noise=lambda generator, n: None,
        device=device,
        init_state=lambda params, n: (torch.zeros((n, 1), device=device),),
        name="synthetic_counter",
    )


def _build_replica_server(spec: Dict[str, Any]) -> Any:
    import numpy as np

    from ..serve.batcher import MicroBatcher
    from ..serve.policy import InferencePolicy
    from ..serve.server import PolicyServer

    mode = str(spec.get("mode", "synthetic"))
    platform = str(spec.get("platform", "cuda"))
    # the replica's OWN telemetry stream (replicas/replica_NNN/ under the
    # run dir): serve snapshots, trace spans of traced requests, the clock
    # handshake answers and profiler markers all land here, and
    # diag/trace.py merges it with the gateway's stream on trace_id
    sink = None
    if spec.get("telemetry_dir"):
        from ..telemetry.tracing import open_process_stream

        from ..telemetry.relay import TeeSink

        sink = TeeSink(
            open_process_stream(
                spec["telemetry_dir"],
                "replica",
                int(spec.get("replica_id", 0)),
                incarnation=int(spec.get("incarnation", 0)),
            )
        )
    reloader = None
    if mode == "checkpoint":
        import pathlib

        from ..config import Config, load_config_file
        from ..serve.reload import CheckpointReloader

        ckpt_path = pathlib.Path(spec["ckpt_path"])
        cfg = Config(spec["cfg"]) if spec.get("cfg") else load_config_file(ckpt_path.parent.parent / "config.yaml")
        _pin_platform(cfg, platform)
        replica_device(platform)  # no card under platform=cuda: fail here, loudly
        policy = InferencePolicy.from_checkpoint(
            ckpt_path, cfg=cfg, buckets=spec.get("buckets")
        )
        policy.warmup()
        hot = spec.get("hot_reload") or {}
        if bool(hot.get("enabled", True)):
            try:
                loaded_step = int(ckpt_path.stem.split("_")[1])
            except (IndexError, ValueError):
                loaded_step = -1
            reloader = CheckpointReloader(
                policy,
                ckpt_path.parent,
                poll_interval_s=float(hot.get("poll_interval_s", 2.0)),
                loaded_step=loaded_step,
            )
    elif mode == "synthetic":
        # with a ckpt_dir the synthetic fleet is hot-reloadable exactly like
        # the checkpoint fleet: the newest ckpt_<N>.ckpt seeds the params
        # (so a respawned replica serves the latest fine-tune, not version
        # 0) and a CheckpointReloader watches the dir — what lets the data
        # flywheel's rolling reload be proven without a training run
        params = {"w": np.zeros((1,), np.float32)}
        loaded_step = -1
        ckpt_dir = spec.get("ckpt_dir")
        if ckpt_dir:
            import pathlib

            from ..serve.reload import _list_checkpoints
            from ..utils.checkpoint import CheckpointManager

            ckpts = _list_checkpoints(pathlib.Path(ckpt_dir))
            if ckpts:
                loaded_step, newest = ckpts[-1]
                try:
                    params = CheckpointManager.load_for_inference(newest)["params"]
                except Exception:
                    loaded_step = -1  # torn seed file: serve the zero params
        policy = InferencePolicy(
            synthetic_counter_core(replica_device(platform)),
            params,
            buckets=spec.get("buckets") or [1, 2, 4, 8, 16],
        )
        policy.warmup()
        hot = spec.get("hot_reload") or {}
        if ckpt_dir and bool(hot.get("enabled", True)):
            from ..serve.reload import CheckpointReloader

            reloader = CheckpointReloader(
                policy,
                ckpt_dir,
                poll_interval_s=float(hot.get("poll_interval_s", 2.0)),
                loaded_step=loaded_step,
                sink=sink,
            )
    else:
        raise ValueError(f"unknown replica mode '{mode}' (checkpoint | synthetic)")
    if spec.get("max_sessions"):
        policy.sessions.max_sessions = int(spec["max_sessions"])

    batcher = MicroBatcher(
        policy,
        max_wait_ms=float(spec.get("max_wait_ms", 5.0)),
        max_pending=int(spec.get("max_pending", 256)),
        request_timeout_s=float(spec.get("request_timeout_s", 30.0)),
        sink=sink,
    )

    on_act = None
    chaos_kwargs = spec.get("chaos")
    if chaos_kwargs:
        from ..resilience.chaos import ChaosInjector

        chaos = ChaosInjector(int(spec.get("replica_id", 0)), **dict(chaos_kwargs))
        chaos.incarnation = int(spec.get("incarnation", 0))
        counter = [0]
        lock = threading.Lock()

        def on_act() -> None:
            with lock:
                counter[0] += 1
                n = counter[0]
            chaos.on_step(n)  # may os._exit — a hard mid-stream death

    capture = None
    if spec.get("capture"):
        from ..flywheel.capture import capture_writer_from_spec

        capture = capture_writer_from_spec(
            spec["capture"],
            replica_id=int(spec.get("replica_id", 0)),
            incarnation=int(spec.get("incarnation", 0)),
            telem_sink=sink,
        )

    return PolicyServer(
        policy,
        batcher,
        reloader=reloader,
        host=str(spec.get("host", "127.0.0.1")),
        port=0,  # ephemeral: the bound port is reported through the queue
        on_act=on_act,
        sink=sink,
        replica_id=int(spec.get("replica_id", 0)),
        capture=capture,
        idempotency_sessions=int(spec.get("max_sessions") or 4096),
    )


def replica_entry(spec: Dict[str, Any], port_q: Any) -> None:
    """Child-process main: build the PolicyServer, report the bound port,
    serve until SIGTERM."""
    import signal

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        server = _build_replica_server(spec)
        server.start()
    except Exception as e:  # startup failure: say why before dying
        print(
            f"[gateway] replica {spec.get('replica_id')} failed to start: {e!r}",
            file=sys.stderr,
            flush=True,
        )
        raise
    port_q.put((int(spec.get("replica_id", 0)), int(spec.get("incarnation", 0)), server.port))
    mem_sampler = None
    if server.sink is not None:
        # the replica's HBM/RSS timeline on its own stream (and through the
        # relay tee to the gateway's aggregator)
        from ..config import Config
        from ..telemetry.memory import start_sampler

        cfg = Config(spec["cfg"]) if spec.get("cfg") else None
        mem_sampler = start_sampler(cfg, server.sink.write, "replica", int(spec.get("replica_id", 0)))
    try:
        while not stop.wait(0.2):
            pass
    finally:
        if mem_sampler is not None:
            try:
                mem_sampler.stop()
            except Exception:
                pass
        server.stop()


# -- manager-side (gateway process) ------------------------------------------
class ReplicaHandle:
    """Supervision state for one replica slot (stable across incarnations)."""

    def __init__(self, replica_id: int, host: str = "127.0.0.1") -> None:
        self.replica_id = int(replica_id)
        self.host = str(host)
        self.proc: Optional[mp.process.BaseProcess] = None
        self.port: Optional[int] = None
        self.incarnation = 0
        self.state = "new"  # new | running | backoff | quarantined | stopped
        self.suspect = False  # gateway saw a transport error; awaiting verdict
        self.draining = False  # rolling reload in progress: no new sessions
        self.spawned_at = 0.0
        self.last_healthy = 0.0
        self.params_version = -1
        self.reload_staleness_s = float("inf")
        self.fails: deque = deque()  # (monotonic_t, reason)
        self.respawn_at = 0.0
        self.respawns = 0

    @property
    def url(self) -> Optional[str]:
        return f"http://{self.host}:{self.port}" if self.port is not None else None

    @property
    def routable(self) -> bool:
        """Safe to hand NEW traffic: running, port known, not under suspicion."""
        return (
            self.state == "running"
            and self.port is not None
            and not self.suspect
            and self.last_healthy > 0.0
        )


class ReplicaManager:
    """Spawn/watch/respawn/quarantine N PolicyServer replica processes."""

    def __init__(
        self,
        spec_base: Dict[str, Any],
        num_replicas: int,
        sink: Any = None,
        *,
        host: str = "127.0.0.1",
        replica_platform: str = "cuda",
        health_poll_s: float = 0.5,
        health_timeout_s: float = 2.0,
        hang_s: float = 10.0,
        spawn_grace_s: float = 120.0,
        backoff_s: float = 0.5,
        max_backoff_s: float = 30.0,
        jitter: float = 0.5,
        max_fails: int = 3,
        fail_window_s: float = 300.0,
    ) -> None:
        self.spec_base = dict(spec_base)
        self.num_replicas = int(num_replicas)
        self.sink = sink
        self.host = str(host)
        replica_env(str(replica_platform))  # an unknown platform fails before any spawn
        self.replica_platform = str(replica_platform)
        self.health_poll_s = float(health_poll_s)
        self.health_timeout_s = float(health_timeout_s)
        self.hang_s = float(hang_s)
        self.spawn_grace_s = float(spawn_grace_s)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.max_fails = int(max_fails)
        self.fail_window_s = float(fail_window_s)
        self._ctx = mp.get_context("spawn")
        self._port_q = self._ctx.Queue()
        self.handles: List[ReplicaHandle] = [
            ReplicaHandle(i, host) for i in range(self.num_replicas)
        ]
        self.crashes = 0
        self.hangs = 0
        self.total_respawns = 0
        self._stopping = False
        self._monitor_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # serializes fault bookkeeping: one death must count as ONE fault
        # even when the monitor and N request threads observe it at once
        self._fault_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        # telemetry relay target: pushed to every replica as it first turns
        # healthy (and immediately to already-healthy ones on set_relay)
        self._relay_url: Optional[str] = None
        self._relay_opts: Dict[str, Any] = {}

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ReplicaManager":
        """Spawn every replica and the monitor thread; a second call is a
        no-op (the replicas already run)."""
        if self._monitor_thread is not None:
            return self
        for handle in self.handles:
            self._spawn(handle)
        self._stop.clear()
        self._monitor_thread = threading.Thread(target=self._monitor_loop, daemon=True, name="replica-monitor")
        self._monitor_thread.start()
        return self

    def _spawn(self, handle: ReplicaHandle) -> None:
        spec = dict(
            self.spec_base,
            replica_id=handle.replica_id,
            incarnation=handle.incarnation,
            host=self.host,
            platform=self.replica_platform,
        )
        # pin the replica's device visibility BEFORE its interpreter starts
        # (restored right after start() — same dance as the fleet supervisor)
        env = replica_env(self.replica_platform)
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            handle.proc = self._ctx.Process(
                target=replica_entry,
                args=(spec, self._port_q),
                name=f"serve-replica-{handle.replica_id}",
                daemon=True,
            )
            handle.proc.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        handle.state = "running"
        handle.suspect = False
        handle.port = None
        handle.last_healthy = 0.0
        handle.spawned_at = time.monotonic()
        _emit(
            self.sink,
            {
                "event": "replica",
                "action": "respawn" if handle.incarnation else "spawn",
                "replica": handle.replica_id,
                "incarnation": handle.incarnation,
                "pid": handle.proc.pid,
            },
        )

    # -- monitoring ---------------------------------------------------------
    def _drain_ports(self) -> None:
        while True:
            try:
                rid, incarnation, port = self._port_q.get_nowait()
            except Exception:
                return
            handle = self.handles[rid]
            if handle.incarnation == incarnation and handle.state == "running":
                handle.port = int(port)
                _emit(
                    self.sink,
                    {
                        "event": "replica",
                        "action": "ready",
                        "replica": rid,
                        "incarnation": incarnation,
                        "port": int(port),
                    },
                )

    def _check_health(self, handle: ReplicaHandle) -> bool:
        if handle.url is None:
            return False
        try:
            with urllib.request.urlopen(
                f"{handle.url}/healthz", timeout=self.health_timeout_s
            ) as resp:
                body = json.loads(resp.read())
        except Exception:
            return False
        first_healthy = handle.last_healthy <= 0.0
        handle.last_healthy = time.monotonic()
        handle.suspect = False
        handle.params_version = int(body.get("params_version", -1))
        handle.reload_staleness_s = float(body.get("reload_staleness_s", float("inf")))
        if first_healthy:
            # clock-offset handshake, once per incarnation as it comes up:
            # the replica answers by emitting a `clock` event on its OWN
            # stream, which diag/trace.py uses to align the streams
            self._clock_probe(handle)
            if self._relay_url:
                self._relay_probe(handle)
        return True

    def set_relay(self, url: str, **opts: Any) -> None:
        """Point every replica's telemetry relay at ``url`` (the gateway's
        ``POST /admin/telemetry``). Replicas spawn before the gateway's HTTP
        server exists, so the URL is pushed post-hoc: immediately to every
        already-healthy replica, and to each later (re)spawn as its first
        health check passes — a respawned incarnation re-attaches without
        any caller involvement."""
        self._relay_url = str(url)
        self._relay_opts = dict(opts)
        for handle in self.handles:
            if handle.last_healthy > 0.0:
                self._relay_probe(handle)

    def _relay_probe(self, handle: ReplicaHandle) -> None:
        try:
            body = dict(self._relay_opts, url=self._relay_url)
            req = urllib.request.Request(
                f"{handle.url}/admin/relay",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=self.health_timeout_s):
                pass
        except Exception:
            pass  # best-effort: the replica's local stream is authoritative

    def _clock_probe(self, handle: ReplicaHandle) -> None:
        try:
            req = urllib.request.Request(
                f"{handle.url}/admin/clock",
                data=json.dumps({"t_send": time.time()}).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=self.health_timeout_s):
                pass
        except Exception:
            pass  # best-effort: an unsynced stream merges with offset 0

    def request_profile(
        self, replica_id: Optional[int] = None, duration_s: float = 2.0
    ) -> Dict[str, Any]:
        """Trigger a windowed ``torch.profiler`` capture on one replica
        (default: the first routable one) via ``POST /admin/profile`` —
        the serving half of the on-demand remote-profiling control plane."""
        if replica_id is None:
            routable = self.routable()
            if not routable:
                return {"error": "no routable replica"}
            handle = routable[0]
        else:
            handle = self.handles[int(replica_id)]
        if handle.url is None:
            return {"error": f"replica {handle.replica_id} has no bound port"}
        try:
            req = urllib.request.Request(
                f"{handle.url}/admin/profile",
                data=json.dumps({"duration_s": float(duration_s)}).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            # generous deadline: the first profiler window in a process
            # initializes the profiler backend (CUPTI on the card) — a
            # control-plane op, not a latency-critical one
            with urllib.request.urlopen(req, timeout=30.0) as resp:
                body = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return {"replica": handle.replica_id, "error": f"HTTP {e.code}"}
        except Exception as e:
            return {"replica": handle.replica_id, "error": repr(e)}
        body["replica"] = handle.replica_id
        return body

    def monitor_once(self) -> None:
        """One supervision sweep: collect ports, detect crashes/hangs, run
        due respawns, apply the fail budget."""
        self._drain_ports()
        now = time.monotonic()
        for handle in self.handles:
            if handle.state == "running":
                proc = handle.proc
                if proc is not None and proc.exitcode is not None and not self._stopping:
                    self.fault(handle, "crash", detail=f"exitcode={proc.exitcode}")
                    continue
                healthy = self._check_health(handle)
                if healthy:
                    continue
                if handle.last_healthy <= 0.0:
                    # still starting (interpreter + torch import + warmup):
                    # judged against the spawn grace budget, not hang_s
                    if now - handle.spawned_at > self.spawn_grace_s:
                        self.fault(
                            handle,
                            "hang",
                            detail=f"not healthy within {self.spawn_grace_s:.0f}s of spawn",
                        )
                elif now - handle.last_healthy > self.hang_s:
                    self.fault(
                        handle,
                        "hang",
                        detail=f"healthz unanswered for {now - handle.last_healthy:.1f}s",
                    )
            elif handle.state == "backoff" and now >= handle.respawn_at:
                handle.incarnation += 1
                handle.respawns += 1
                # lint: ok[thread-shared-state] respawns happen only in the monitor sweep — tests drive monitor_once synchronously with the thread stopped, never both
                self.total_respawns += 1
                self._spawn(handle)

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.health_poll_s):
            try:
                self.monitor_once()
            except Exception:
                pass

    def fault(self, handle: ReplicaHandle, reason: str, detail: str = "") -> None:
        """Route one replica failure: kill what's left, then schedule a
        respawn or quarantine the slot. Serialized + re-checked under the
        fault lock so concurrent observers of the same death (the monitor
        sweep and every request thread whose forward just failed) count it
        as one fault, not ``max_fails`` of them."""
        with self._fault_lock:
            self._fault_locked(handle, reason, detail)

    def _fault_locked(self, handle: ReplicaHandle, reason: str, detail: str) -> None:
        if handle.state != "running":
            return
        if reason == "crash":
            # counted here, not at the observation sites: the monitor sweep
            # and a request thread can both see the same death — the lock +
            # state re-check above make it one fault, and no lost updates
            self.crashes += 1
        elif reason == "hang":
            self.hangs += 1
        proc, handle.proc = handle.proc, None
        if proc is not None and proc.is_alive():
            proc.kill()
            proc.join(timeout=5.0)
        handle.port = None
        handle.suspect = False
        handle.last_healthy = 0.0
        now = time.monotonic()
        handle.fails.append((now, reason))
        while handle.fails and now - handle.fails[0][0] > self.fail_window_s:
            handle.fails.popleft()
        _emit(
            self.sink,
            {
                "event": "replica",
                "action": reason,
                "replica": handle.replica_id,
                "incarnation": handle.incarnation,
                "fails_in_window": len(handle.fails),
                "detail": str(detail),
            },
        )
        print(
            f"[gateway] replica {handle.replica_id} fault: {reason} ({detail}); "
            f"{len(handle.fails)}/{self.max_fails} in window",
            file=sys.stderr,
            flush=True,
        )
        if len(handle.fails) > self.max_fails:
            handle.state = "quarantined"
            _emit(
                self.sink,
                {
                    "event": "replica",
                    "action": "quarantine",
                    "replica": handle.replica_id,
                    "fails_in_window": len(handle.fails),
                    "detail": f"fail budget exhausted ({self.max_fails} in {self.fail_window_s:.0f}s)",
                },
            )
        else:
            n = len(handle.fails)
            delay = min(self.max_backoff_s, self.backoff_s * (2 ** (n - 1)))
            delay *= max(0.0, 1.0 + random.uniform(-self.jitter, self.jitter))
            handle.state = "backoff"
            handle.respawn_at = now + delay

    def report_failure(self, replica_id: int, err: Any = None) -> None:
        """The gateway observed a transport error talking to this replica.
        Mark it non-routable NOW (failover must not wait a poll interval);
        if the process is already dead, take the fault path immediately."""
        handle = self.handles[int(replica_id)]
        if handle.state != "running":
            return
        handle.suspect = True
        proc = handle.proc
        if proc is not None and proc.exitcode is not None and not self._stopping:
            self.fault(
                handle,
                "crash",
                detail=f"exitcode={proc.exitcode} (reported by gateway: {err!r})",
            )

    # -- views --------------------------------------------------------------
    def routable(self, include_draining: bool = True) -> List[ReplicaHandle]:
        out = [h for h in self.handles if h.routable]
        if not include_draining:
            out = [h for h in out if not h.draining]
        return out

    def alive_count(self) -> int:
        return sum(
            1
            for h in self.handles
            if h.state == "running" and h.proc is not None and h.proc.is_alive()
        )

    def quarantined_ids(self) -> List[int]:
        return [h.replica_id for h in self.handles if h.state == "quarantined"]

    def wait_routable(self, n: Optional[int] = None, timeout_s: float = 120.0) -> bool:
        """Block until ``n`` (default: all non-quarantined) replicas are
        routable; the monitor thread does the actual work."""
        want = self.num_replicas if n is None else int(n)
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            if len(self.routable()) >= max(1, want - len(self.quarantined_ids())):
                return True
            time.sleep(0.05)
        return False

    # -- rolling reload -----------------------------------------------------
    def rolling_reload(self, settle_timeout_s: float = 30.0) -> List[Dict[str, Any]]:
        """Force a checkpoint-reload poll on every healthy replica, ONE at a
        time: mark it draining (the router stops assigning new sessions),
        trigger ``/admin/reload``, wait for a healthy answer, move on. The
        fleet never has more than one replica staging weights — concurrent
        invocations (two admin POSTs) are refused, not interleaved."""
        if not self._reload_lock.acquire(blocking=False):
            return [{"error": "rolling_reload already in progress"}]
        try:
            return self._rolling_reload_locked(settle_timeout_s)
        finally:
            self._reload_lock.release()

    def _rolling_reload_locked(self, settle_timeout_s: float) -> List[Dict[str, Any]]:
        results: List[Dict[str, Any]] = []
        for handle in list(self.routable()):
            handle.draining = True
            _emit(
                self.sink,
                {"event": "replica", "action": "drain", "replica": handle.replica_id},
            )
            out: Dict[str, Any] = {"replica": handle.replica_id, "swapped": False}
            try:
                req = urllib.request.Request(
                    f"{handle.url}/admin/reload", data=b"{}", method="POST"
                )
                with urllib.request.urlopen(req, timeout=settle_timeout_s) as resp:
                    body = json.loads(resp.read())
                out["swapped"] = bool(body.get("swapped"))
                out["params_version"] = body.get("params_version")
            except Exception as e:
                out["error"] = repr(e)
            finally:
                # settle: one good healthz before the next replica drains
                deadline = time.monotonic() + settle_timeout_s
                while time.monotonic() < deadline and not self._check_health(handle):
                    time.sleep(0.1)
                handle.draining = False
            _emit(
                self.sink,
                {
                    "event": "replica",
                    "action": "reload",
                    "replica": handle.replica_id,
                    "params_version": int(out.get("params_version") or -1),
                    "detail": "swapped" if out["swapped"] else str(out.get("error", "no-op")),
                },
            )
            results.append(out)
        return results

    # -- shutdown -----------------------------------------------------------
    def shutdown(self, timeout_s: float = 10.0) -> None:
        self._stopping = True
        self._stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5.0)
            self._monitor_thread = None
        for handle in self.handles:
            proc = handle.proc
            if proc is not None and proc.is_alive():
                proc.terminate()
        deadline = time.monotonic() + float(timeout_s)
        for handle in self.handles:
            proc = handle.proc
            if proc is not None:
                proc.join(timeout=max(0.1, deadline - time.monotonic()))
                if proc.is_alive():
                    proc.kill()
                    proc.join(timeout=5.0)
            handle.proc = None
            if handle.state != "quarantined":
                handle.state = "stopped"
        self._port_q.close()
