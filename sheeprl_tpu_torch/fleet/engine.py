"""`FleetEngine` — the learner-side driver of the actor fleet (the port's own
copy of ``sheeprl_tpu/fleet/engine.py``, worker mode).

The learner stays single-threaded and authoritative: workers only *produce*
framed transition packets; every replay-buffer mutation, metric-aggregator
write and `Ratio` ledger call happens here, in deterministic order.

The ordering contract is the **round**: one packet from every active worker,
FIFO per worker, workers in id order. A full-strength round carries exactly
``num_envs`` env steps — the same quantum the serial loop (and the overlap
engine) advances per iteration — so feeding the `Ratio` controller once per
round with the true cumulative ``policy_step`` reproduces the serial
env-step:grad-step ledger *bit-identically*. A worker mid-respawn delays
its round (the queue merge waits, monitored, never parked on a dead pipe);
a **quarantined** worker shrinks the round instead: the fleet keeps
training on the surviving slice with the ledger still exact over the steps
that actually landed (graceful degradation, not silent corruption).

Two apply modes cover the repo's replay layouts:

* :meth:`apply_concat` — fixed-width buffers (`ReplayBuffer`: SAC family).
  The round's per-worker ``[T, envs_per_worker, ...]`` blocks are
  concatenated into one full-width ``[T, num_envs, ...]`` row. Under
  quarantine the missing columns are backfilled by *duplicating surviving
  workers' blocks* (real transitions, slightly over-weighted — the
  documented degraded mode) so the buffer layout and the jitted train
  shapes never change; only real steps count toward the ledger.
* :meth:`apply_sliced` — per-env sub-buffers (`EnvIndependentReplayBuffer`:
  Dreamer family). Each worker's ops are replayed against its own global
  env columns (indices offset by the worker's slice), so quarantined
  columns simply stop growing.

Publications are host arrays: :meth:`FleetEngine.publish` takes the
modules of a host ``ParamMirror`` (refreshed device-to-host into pinned
memory after the burst) and sends their state dicts as numpy arrays,
pickled once for the whole fleet — a worker never needs CUDA to load one.

``fleet.act_mode=inference`` (Sebulba) starts one learner-hosted batched
act service (:class:`~sheeprl_tpu_torch.fleet.act_service.ActService`) on
the learner's device; every publication reaches it before the broadcast.
``fleet.program=sheeprl_tpu_torch.fleet.anakin:anakin_program`` runs the
Anakin program in the workers.
"""
from __future__ import annotations

import sys
import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np

from ..parallel.mesh import FLEET_DISABLED, active
from .protocol import FleetPacket, TornPacketError, decode_packet
from .supervisor import FleetSupervisor

__all__ = ["PROGRAMS", "FleetEngine", "FleetRound", "host_arrays", "refuse_fleet"]

# the algorithms with a fleet program, as in the JAX package
PROGRAMS = {
    "dreamer_v3": "sheeprl_tpu_torch.fleet.programs:dreamer_v3_program",
    "sac": "sheeprl_tpu_torch.fleet.programs:sac_program",
    "ppo": "sheeprl_tpu_torch.fleet.programs:ppo_program",
}


def _ranks() -> int:
    """The world size of the run in progress (``parallel/mesh.py``)."""
    dist = active()
    return 1 if dist is None else dist.world_size


def _rank() -> int:
    dist = active()
    return 0 if dist is None else dist.rank


def refuse_fleet(cfg: Any, algo: str) -> None:
    """Raise for ``algo.fleet.workers > 0`` where ``algo`` has no fleet
    program (the JAX package has one for dreamer_v3, sac and ppo alone)."""
    if algo not in PROGRAMS and int(cfg.select("algo.fleet.workers", 0) or 0) > 0:
        raise NotImplementedError(f"algo.fleet.workers > 0: {algo} has no fleet program (the actor fleet runs "
                                  f"{', '.join(sorted(PROGRAMS))})")

_SLEEP_S = 0.001  # round-merge poll granularity


def _net_from_cfg(cfg: Any, opt: Any) -> Any:
    """Build the transport's NetConfig only when the socket transport is
    selected — the mp path must not pay the import."""
    if str(opt("fleet.transport", "mp")) != "socket":
        return None
    from .net import NetConfig

    return NetConfig.from_cfg(cfg)


class FleetRound(NamedTuple):
    packets: List[FleetPacket]  # one per contributing worker, id order
    worker_ids: List[int]
    env_steps: int


class FleetEngine:
    """Construct via :meth:`setup`; when ``enabled`` is False every method is
    a cheap no-op and the caller runs its serial/overlap path unchanged."""

    def __init__(
        self,
        *,
        enabled: bool = True,
        workers: int = 0,
        queue_depth: int = 4,
        hang_s: float = 60.0,
        spawn_grace_s: float = 120.0,
        backoff_s: float = 0.5,
        max_backoff_s: float = 30.0,
        jitter: float = 0.5,
        max_fails: int = 3,
        fail_window_s: float = 300.0,
        worker_platform: str = "cpu",
        stats_every_s: float = 5.0,
        shutdown_drain_s: float = 10.0,
        transport: str = "mp",
        program: Any = None,
        net: Any = None,
        remote_workers: Any = None,
        total_steps: int = 0,
        initial_step: int = 0,
        seed: int = 0,
        telem: Any = None,
        guard: Any = None,
        trace_spans: bool = True,
        relay: Any = None,
        act_mode: str = "worker",
    ) -> None:
        self.enabled = bool(enabled) and int(workers) > 0
        self.workers = int(workers)
        self.queue_depth = max(1, int(queue_depth))
        self.hang_s = float(hang_s)
        self.spawn_grace_s = float(spawn_grace_s)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self.max_fails = int(max_fails)
        self.fail_window_s = float(fail_window_s)
        self.worker_platform = str(worker_platform)
        self.stats_every_s = float(stats_every_s)
        self.shutdown_drain_s = float(shutdown_drain_s)
        self.transport = str(transport)
        self.program = program
        self.net = net
        self.remote_workers = list(remote_workers or [])
        self.total_steps = int(total_steps)
        self.telem = telem
        self.guard = guard
        self.seed = int(seed)
        self.trace_spans = bool(trace_spans)
        self.relay_cfg: Dict[str, Any] = dict(relay or {})
        self.act_mode = str(act_mode)
        self.act: Optional[Any] = None  # ActService under act_mode=inference

        self.sup: Optional[FleetSupervisor] = None
        self.num_envs = 0
        self.envs_per_worker = 0
        self.acked_steps = int(initial_step)
        self.rounds = 0
        self.dropped_steps = 0
        self.relayed_events = 0
        self.publications = 0
        self.publish_bytes = 0
        self.publish_s = 0.0
        self._pending: Dict[int, deque] = {}
        self._stats_round_wait_s = 0.0
        self._last_emit_t = time.perf_counter()
        self._stopped = False

    # -- construction ------------------------------------------------------
    @staticmethod
    def configured(cfg: Any) -> bool:
        """True when this run will use the fleet (``algo.fleet.workers > 0``
        at world size 1; on N ranks, which are processes, the fleet is off as
        the JAX package's is in more than one process, and each rank keeps
        its env loop) — the early check the algo mains use to skip building
        their own envs.
        Raises, before the run writes anything, for an unknown
        ``fleet.act_mode`` and for ``fleet.act_mode=inference`` on a program
        without an act core (PPO's strict on-policy rollouts act in the
        workers)."""
        sel = cfg.select if hasattr(cfg, "select") else (lambda p, d=None: d)
        if int(sel("algo.fleet.workers", 0) or 0) <= 0 or _ranks() > 1:
            return False
        act_mode = str(sel("fleet.act_mode", "worker") or "worker")
        if act_mode not in ("worker", "inference"):
            raise ValueError(f"fleet.act_mode must be worker | inference, got {act_mode!r}")
        if act_mode == "inference":
            from .act_core import _BUILDERS

            program = str(sel("fleet.program", None) or PROGRAMS.get(str(sel("algo.name", "")), ""))
            name = _core_name(program)
            if name not in _BUILDERS:
                raise ValueError(f"no act core for program '{name}' (batched acting supports: {sorted(_BUILDERS)})")
        return True

    @classmethod
    def setup(
        cls,
        cfg: Any,
        telem: Any = None,
        guard: Any = None,
        *,
        total_steps: int,
        initial_step: int = 0,
    ) -> "FleetEngine":
        sel = cfg.select if hasattr(cfg, "select") else (lambda p, d=None: d)
        workers = int(sel("algo.fleet.workers", 0) or 0) if cls.configured(cfg) else 0
        if int(sel("algo.fleet.workers", 0) or 0) > 0 and _ranks() > 1 and _rank() == 0:
            print(FLEET_DISABLED, file=sys.stderr, flush=True)

        def opt(path: str, default: Any) -> Any:
            # None-safe: an explicit 0 (max_fails=0 = quarantine on first
            # fault, backoff_s=0 = immediate respawn) must NOT be clobbered
            # by the default the way `sel(...) or default` would
            v = sel(path, None)
            return default if v is None else v

        return cls(
            enabled=workers > 0,
            workers=workers,
            queue_depth=int(opt("fleet.queue_depth", 4)),
            hang_s=float(opt("fleet.hang_s", 60.0)),
            spawn_grace_s=float(opt("fleet.spawn_grace_s", 120.0)),
            backoff_s=float(opt("fleet.backoff_s", 0.5)),
            max_backoff_s=float(opt("fleet.max_backoff_s", 30.0)),
            jitter=float(opt("fleet.jitter", 0.5)),
            max_fails=int(opt("fleet.max_fails", 3)),
            fail_window_s=float(opt("fleet.fail_window_s", 300.0)),
            worker_platform=str(opt("fleet.worker_platform", "cpu")),
            stats_every_s=float(opt("fleet.stats_every_s", 5.0)),
            shutdown_drain_s=float(opt("fleet.shutdown_drain_s", 10.0)),
            transport=str(opt("fleet.transport", "mp")),
            program=opt("fleet.program", None),
            net=_net_from_cfg(cfg, opt),
            remote_workers=[int(w) for w in (opt("fleet.net.remote_workers", []) or [])],
            total_steps=total_steps,
            initial_step=initial_step,
            seed=int(opt("seed", 0)),
            telem=telem,
            guard=guard,
            trace_spans=bool(opt("metric.telemetry.trace_spans", True)),
            relay={
                "enabled": bool(opt("fleet.relay.enabled", True)),
                "sample": float(opt("fleet.relay.sample", 1.0)),
                "flush_s": float(opt("fleet.relay.flush_s", 2.0)),
                "max_batch_kb": int(opt("fleet.relay.max_batch_kb", 64)),
                "max_buffer": int(opt("fleet.relay.max_buffer", 512)),
            },
            act_mode=str(opt("fleet.act_mode", "worker")),
        )

    # -- lifecycle ---------------------------------------------------------
    def start(self, program: str, num_envs: int, cfg: Any) -> "FleetEngine":
        """Spawn the workers on ``program`` (``module:function``; the
        ``fleet.program`` knob replaces it)."""
        if not self.enabled or self.sup is not None:
            return self
        program = str(self.program or program)
        num_envs = int(num_envs)
        if num_envs % self.workers != 0:
            raise ValueError(
                f"algo.fleet.workers ({self.workers}) must divide env.num_envs "
                f"({num_envs}) — each worker owns an equal env slice"
            )
        self.num_envs = num_envs
        self.envs_per_worker = num_envs // self.workers
        self.sup = FleetSupervisor(
            cfg,
            self.telem,
            program=program,
            num_workers=self.workers,
            queue_depth=self.queue_depth,
            hang_s=self.hang_s,
            spawn_grace_s=self.spawn_grace_s,
            backoff_s=self.backoff_s,
            max_backoff_s=self.max_backoff_s,
            jitter=self.jitter,
            max_fails=self.max_fails,
            fail_window_s=self.fail_window_s,
            worker_platform=self.worker_platform,
            seed=self.seed,
            transport=self.transport,
            net=self.net,
            remote_workers=self.remote_workers,
            shutdown_drain_s=self.shutdown_drain_s,
            relay=self.relay_cfg,
            # workers write their own telemetry streams under the run dir
            # (workers/worker_NNN/); the facade's log_dir is that root —
            # only when telemetry is on at all, so a metrics-off run never
            # grows stream dirs
            log_dir=(
                getattr(self.telem, "log_dir", None)
                if getattr(self.telem, "enabled", False)
                else None
            ),
            trace=self.trace_spans,
        )
        self.sup.progress_step = self.acked_steps  # resume: seed lifetimes
        self.sup.start()
        self._pending = {h.worker_id: deque() for h in self.sup.handles}
        if self.act_mode == "inference":
            # Sebulba: one learner-hosted batched act service for the whole
            # fleet on the learner's device; the workers read
            # fleet.act_mode=inference from the spawned cfg and ship obs here
            from .act_service import ActService

            self.act = ActService(cfg, _core_name(program), telem=self.telem, trace=self.trace_spans).start()
            if self.sup.listener is not None:
                self.sup.listener.set_act_handler(self.act.wire_handler)
            else:
                self.act.attach_mp(self.sup)
        return self

    def publish(self, modules: Dict[str, Any]) -> int:
        """Broadcast the state dicts of ``modules`` (``mirror.current()`` of a
        host ``ParamMirror``, whose refresh copied them device-to-host into
        pinned memory) as numpy arrays: ``host_arrays`` waits on the copy,
        the supervisor pickles once. Counts the publication's bytes and
        learner time. Returns the version."""
        if not self.enabled or self.sup is None:
            return 0
        t0 = time.perf_counter()
        params_np = host_arrays(modules)
        if self.act is not None:
            # swap the service BEFORE the broadcast that versions the ledger:
            # by the time any worker learns of publication N the service
            # already acts with N
            self.act.swap_params(params_np, self.sup.pub_seq + 1)
        version = self.sup.publish(params_np)
        self.publications += 1
        self.publish_bytes += sum(a.nbytes for sd in params_np.values() for a in sd.values())
        self.publish_s += time.perf_counter() - t0
        return version

    # -- the merge ---------------------------------------------------------
    def _should_stop(self) -> bool:
        if self._stopped:
            return True
        g = self.guard
        return g is not None and getattr(g, "preempted", False)

    def _sweep(self, step: int) -> None:
        """One monitor + drain pass: decode whatever every worker has queued
        into the per-worker FIFO (torn frames become worker faults)."""
        sup = self.sup
        faults_before = sup.crashes + sup.hangs + sup.torn_packets
        sup.monitor(step)
        # relayed telemetry rides the same sweep: batches are counted, and go
        # to a live aggregator where the facade has one (never into the
        # learner's own JSONL: the workers' local files stay the only
        # durable copy, so a merge of the streams never sees an event twice)
        ingest = getattr(self.telem, "ingest_relayed", None)
        for batch in sup.drain_telem():
            self.relayed_events += len(batch.get("events", ())) if isinstance(batch, dict) else 0
            if ingest is not None:
                try:
                    ingest(batch)
                except Exception:
                    pass
        for handle in sup.handles:
            frames: List[Any] = []
            if handle.salvage:
                frames.extend(handle.salvage)
                handle.salvage = []
            # end-to-end backpressure: only pull what the learner-side FIFO
            # has room for (queue_depth here + queue_depth in the mp queue);
            # draining freely would let a worker free-run unboundedly ahead
            room = self.queue_depth - len(self._pending[handle.worker_id])
            if handle.channel is not None and room > 0:
                frames.extend(handle.channel.drain_data(limit=room))
            for frame in frames:
                try:
                    pkt = decode_packet(frame)
                except TornPacketError as err:
                    sup.torn_packets += 1
                    # corrupted IPC: the incarnation can't be trusted. fault()
                    # emits the single `torn_packet` fleet event
                    sup.fault(handle, "torn_packet", step=step, detail=str(err))
                    continue
                self._pending[handle.worker_id].append(pkt)
        if sup.crashes + sup.hangs + sup.torn_packets != faults_before:
            # a fault just landed: snapshot the degraded liveness NOW rather
            # than waiting for the cadence — with fast respawn backoff the
            # degraded window can be shorter than stats_every_s
            self.maybe_emit(step, force=True)

    @property
    def pub_version(self) -> int:
        """The newest published param version (0 before the first publish)."""
        return self.sup.pub_seq if self.sup is not None else 0

    def _drop_stale(self, min_version: int, step: int) -> None:
        """Discard pending packets acted with params older than
        ``min_version``. The strict on-policy round protocol (PPO) needs
        this after a worker fault: a salvaged packet plus the respawned
        incarnation's re-produced rollout for the SAME publication would
        otherwise leave that worker's FIFO permanently one publication
        behind — every later round silently merging a stale rollout."""
        for wid, dq in self._pending.items():
            while dq and dq[0].version < min_version:
                pkt = dq.popleft()
                self.dropped_steps += pkt.env_steps
                if self.telem is not None:
                    try:
                        self.telem.emit(
                            {
                                "event": "fleet",
                                "action": "stale_packet",
                                "step": int(step),
                                "worker": int(wid),
                                "detail": (
                                    f"dropped rollout for publication {pkt.version} "
                                    f"(round needs >= {min_version})"
                                ),
                            }
                        )
                    except Exception:
                        pass

    def take_round(self, step: int = 0, min_version: int = 0) -> Optional[FleetRound]:
        """Block until one packet per active worker is available (monitoring
        the fleet the whole time — a dead worker respawns or quarantines
        *inside* this wait, so the merge can never deadlock on its queue).
        ``min_version > 0`` enforces the strict on-policy round protocol:
        packets acted with an older publication are dropped, never merged.
        Returns None when preempted/stopped or the whole fleet is gone."""
        if not self.enabled or self.sup is None:
            return None
        t0 = time.perf_counter()
        # strict-round liveness: a publication lost in flight (chaos
        # drop_publication, a dying queue) parks a sync-mode worker forever —
        # it heartbeats while it waits, so no hang fires. After republish_s
        # of round wait, re-deliver the newest params to running workers
        # that owe a packet (idempotent worker-side; never changes results).
        republish_s = max(1.0, self.hang_s / 8.0)
        last_nudge = t0
        try:
            while True:
                if self._should_stop():
                    return None
                self._sweep(step)
                if min_version > 0:
                    self._drop_stale(min_version, step)
                    now = time.perf_counter()
                    if now - last_nudge >= republish_s:
                        last_nudge = now
                        for h in self.sup.handles:
                            # only a worker that never APPLIED the needed
                            # publication is owed a resend — a healthy worker
                            # mid-rollout (applied it before starting the
                            # slice) must not be spammed with param blobs
                            if (
                                h.state == "running"
                                and not self._pending[h.worker_id]
                                and h.channel is not None
                                and int(h.channel.param_version.value) < min_version
                            ):
                                self.sup.resend_params(h.worker_id, step)
                active = self.sup.active_ids()
                if not active:
                    print(
                        "[fleet] every worker is quarantined/stopped — halting collection",
                        file=sys.stderr,
                    )
                    return None
                if all(self._pending[w] for w in active):
                    packets = [self._pending[w].popleft() for w in active]
                    env_steps = sum(p.env_steps for p in packets)
                    self.acked_steps += env_steps
                    self.sup.progress_step = self.acked_steps
                    self.rounds += 1
                    return FleetRound(packets, list(active), env_steps)
                time.sleep(_SLEEP_S)
        finally:
            self._stats_round_wait_s += time.perf_counter() - t0
            self.maybe_emit(step)

    def mark_applied(self, rnd: FleetRound, t_start: Optional[float] = None) -> None:
        """Emit the learner-side apply spans for a round merged OUTSIDE the
        engine's own apply modes (PPO's `merge_ppo_round`): same trace join
        as apply_concat/apply_sliced, caller-timed."""
        t1 = time.time()
        self._emit_apply_spans(rnd, t1 if t_start is None else float(t_start), t1)

    def request_profile(self, worker_id: int, duration_s: float = 2.0) -> bool:
        """Remotely open a windowed ``torch.profiler`` capture inside one
        worker (ctrl-queue op; the capture dir lands in the worker's stream
        dir)."""
        if not self.enabled or self.sup is None:
            return False
        return self.sup.request_profile(worker_id, duration_s)

    def _emit_apply_spans(self, rnd: FleetRound, t0: float, t1: float) -> None:
        """One `learner_apply` span per packet, continuing the trace the
        worker's `env_step` span opened (the packet carries its ids). The
        whole-round apply interval is attributed to each packet — per-packet
        sub-timing inside one concatenated buffer add doesn't exist."""
        if not self.trace_spans or self.telem is None:
            return
        from ..telemetry import tracing

        for p in rnd.packets:
            if not p.trace or not p.trace[0]:
                continue
            try:
                self.telem.emit(
                    tracing.span_record(
                        "learner_apply",
                        "learner",
                        tracing.TraceContext(p.trace[0], tracing.new_span_id(), p.trace[1]),
                        t0,
                        t1,
                        worker=p.worker_id,
                        seq=p.seq,
                        step=self.acked_steps,
                    )
                )
            except Exception:
                pass

    # -- apply modes -------------------------------------------------------
    def _column_blocks(self, rnd: FleetRound, op_idx: int) -> List[Dict[str, np.ndarray]]:
        """Per-worker-slot data blocks for one op position, quarantined slots
        backfilled by duplicating surviving blocks (documented degraded
        mode; only real steps were counted into ``rnd.env_steps``)."""
        by_worker = {p.worker_id: p.payload.ops[op_idx][1] for p in rnd.packets}
        present = sorted(by_worker)
        blocks: List[Dict[str, np.ndarray]] = []
        for slot in range(self.workers):
            if slot in by_worker:
                blocks.append(by_worker[slot])
            else:
                blocks.append(by_worker[present[slot % len(present)]])
        return blocks

    def apply_concat(
        self, rnd: FleetRound, rb: Any, aggregator: Any = None, validate: bool = False
    ) -> int:
        """Merge a round into one full-width add per op (fixed-width
        `ReplayBuffer` layouts — the SAC family)."""
        t_apply0 = time.time()
        op_counts = {len(p.payload.ops) for p in rnd.packets}
        if len(op_counts) != 1:
            raise RuntimeError(
                f"concat merge needs symmetric packets, got op counts {sorted(op_counts)}"
            )
        for op_idx in range(op_counts.pop()):
            kinds = {p.payload.ops[op_idx][0] for p in rnd.packets}
            if kinds != {"add"} or any(
                p.payload.ops[op_idx][2] is not None for p in rnd.packets
            ):
                raise RuntimeError(
                    "concat merge supports full-slice 'add' ops only; use "
                    "apply_sliced for per-env-indexed layouts"
                )
            blocks = self._column_blocks(rnd, op_idx)
            merged = {
                k: np.concatenate([b[k] for b in blocks], axis=1) for k in blocks[0]
            }
            rb.add(merged, validate_args=validate)
        if aggregator is not None:
            for p in rnd.packets:
                for key, value in p.payload.stats:
                    aggregator.update(key, value)
        self._emit_apply_spans(rnd, t_apply0, time.time())
        return rnd.env_steps

    def apply_sliced(self, rnd: FleetRound, rb: Any, aggregator: Any = None, validate: bool = False) -> int:
        """Replay each worker's ops against its own global env columns
        (per-env sub-buffer layouts — the Dreamer family)."""
        t_apply0 = time.time()
        epw = self.envs_per_worker
        for p in rnd.packets:
            off = p.worker_id * epw
            for op, data, idxes, val in p.payload.ops:
                if op == "add":
                    indices = (
                        list(range(off, off + epw))
                        if idxes is None
                        else [off + int(i) for i in idxes]
                    )
                    rb.add(data, indices, validate_args=val or validate)
                elif hasattr(rb, "mark_restart"):
                    rb.mark_restart(off + int(data))
            if aggregator is not None:
                for key, value in p.payload.stats:
                    aggregator.update(key, value)
        self._emit_apply_spans(rnd, t_apply0, time.time())
        return rnd.env_steps

    # -- telemetry ---------------------------------------------------------
    def maybe_emit(self, step: int = 0, force: bool = False) -> Optional[Dict[str, Any]]:
        if self.telem is None or not self.enabled or self.sup is None:
            return None
        now = time.perf_counter()
        elapsed = now - self._last_emit_t
        if not force and elapsed < self.stats_every_s:
            return None
        self._last_emit_t = now
        wait_s, self._stats_round_wait_s = self._stats_round_wait_s, 0.0
        rec = {
            "event": "fleet",
            "action": "interval",
            "step": int(step or self.acked_steps),
            "workers": int(self.workers),
            "alive": int(self.sup.alive_count()),
            "quarantined": len(self.sup.quarantined_ids()),
            "respawns": int(self.sup.total_respawns),
            "torn_packets": int(self.sup.torn_packets),
            "crashes": int(self.sup.crashes),
            "hangs": int(self.sup.hangs),
            "rounds": int(self.rounds),
            "queue_depth_max": int(self.sup.queue_depth_max()),
            "dropped_steps": int(self.dropped_steps),
            "round_wait_s": round(wait_s, 6),
            "interval_s": round(elapsed, 6),
        }
        if self.sup.net_stats is not None:
            ns = self.sup.net_stats.snapshot()
            rec["reconnects"] = int(ns["reconnects"])
            rec["dup_frames"] = int(ns["dup_frames"])
            rec["disconnects"] = int(self.sup.disconnects)
        dropped = self.sup.telem_dropped()
        if dropped:
            rec["relay_dropped"] = int(dropped)
        # the learner's publication cost and the relay's volume (undeclared
        # extras of the record)
        rec["relayed_events"] = int(self.relayed_events)
        rec["publications"] = int(self.publications)
        rec["publish_bytes"] = int(self.publish_bytes)
        rec["publish_ms"] = round(self.publish_s * 1e3, 6)
        if self.act is not None:
            rec["act_mode"] = "inference"
            rec.update(self.act.snapshot())
        try:
            self.telem.emit(rec)
        except Exception:
            pass
        return rec

    # -- shutdown ----------------------------------------------------------
    def shutdown(self, absorb: Optional[Callable[[FleetRound], int]] = None) -> int:
        """Stop the fleet and drain every COMPLETE remaining round through
        ``absorb`` so the final checkpoint sees a consistent buffer (the
        step counter matches the content exactly; an incomplete trailing
        round is dropped and counted, never half-applied). Returns the env
        steps drained."""
        if not self.enabled or self.sup is None or self._stopped:
            return 0
        self._stopped = True
        active = self.sup.active_ids()
        leftovers = self.sup.shutdown(timeout=self.shutdown_drain_s)
        if self.act is not None:
            self.act.stop()
        for wid, frames in leftovers.items():
            for frame in frames:
                try:
                    self._pending[wid].append(decode_packet(frame))
                except TornPacketError:
                    self.sup.torn_packets += 1
        drained = 0
        if absorb is not None and active:
            while all(self._pending[w] for w in active):
                packets = [self._pending[w].popleft() for w in active]
                env_steps = sum(p.env_steps for p in packets)
                rnd = FleetRound(packets, list(active), env_steps)
                drained += int(absorb(rnd) or 0)
                self.acked_steps += env_steps
                self.rounds += 1
        # trailing PARTIAL rounds can't be applied (the round contract needs
        # one packet per active worker) — they are dropped, but COUNTED: the
        # drain event carries both the packet count and their env steps so
        # "the drain discarded work" is an auditable number, never silent
        leftover_packets = sum(len(dq) for dq in self._pending.values())
        leftover_steps = sum(
            p.env_steps for dq in self._pending.values() for p in dq
        )
        self.dropped_steps += leftover_steps
        for dq in self._pending.values():
            dq.clear()
        if self.telem is not None:
            try:
                self.telem.emit(
                    {
                        "event": "fleet",
                        "action": "drain",
                        "step": int(self.acked_steps),
                        "workers": int(self.workers),
                        "quarantined": len(self.sup.quarantined_ids()),
                        "respawns": int(self.sup.total_respawns),
                        "env_steps": int(drained),
                        "drain_dropped": int(leftover_packets),
                        "dropped_steps": int(leftover_steps),
                    }
                )
            except Exception:
                pass
        self.maybe_emit(force=True)
        return drained


def _core_name(program: str) -> str:
    """The act core of a program path: ``...:sac_program`` → ``sac``."""
    name = str(program).rsplit(":", 1)[-1]
    return name[: -len("_program")] if name.endswith("_program") else name


def host_arrays(modules: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """Module name → state dict as numpy arrays. The tensors must be on the
    host: a publication never pickles a CUDA tensor (a worker would need
    CUDA to load it)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, module in modules.items():
        sd = module.state_dict()
        bad = [k for k, t in sd.items() if t.device.type != "cpu"]
        if bad:
            raise ValueError(f"publication of {name}: {bad[:3]} are on {sd[bad[0]].device}, not the host")
        out[name] = {k: t.detach().numpy() for k, t in sd.items()}
    return out
