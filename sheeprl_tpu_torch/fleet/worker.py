"""The env-worker process: step a slice of the vector env, stream packets
(the port's own copy of ``sheeprl_tpu/fleet/worker.py``).

Each worker is a real OS process (``spawn`` context, never ``fork``: the
learner holds a CUDA context that a forked child would inherit half-copied).
Under ``fleet.worker_platform=cpu`` the supervisor hides the card from the
child before its interpreter starts, so the worker acts on the host CPU with
its own copy of the policy and never holds a CUDA context (it checks that
``torch.cuda.is_available()`` is False). It runs torch on one thread:
N workers each with torch's default intra-op pool would thrash the host.

A worker owns:

* its **env slice**: ``num_envs / num_workers`` envs, seeded exactly like
  the same columns of the serial loop's vector env;
* its **program**: the per-algorithm acting logic
  (:mod:`sheeprl_tpu_torch.fleet.programs`), resolved by import path in the
  child so the spawn args stay picklable;
* the newest **param snapshot** published by the learner (numpy arrays,
  pickled once learner-side; versions may be skipped — the worker always
  drains to the latest);
* its **own telemetry stream** — ``workers/worker_NNN/telemetry.jsonl``
  under the run dir (role/pid/incarnation stamped in the startup
  heartbeat). Every slice writes an ``env_step`` + ``queue_wait``
  ``trace_span`` pair whose ``(trace_id, span_id)`` also rides the packet
  frame, so the learner's apply span lands in the SAME trace. Its last
  record (``fleet`` ``worker_exit``) names the top-level packages the
  process loaded and whether it initialised CUDA;
* an optional :class:`~sheeprl_tpu_torch.resilience.chaos.ChaosInjector`.

Control-plane ops beyond params/stop: ``CTRL_CLOCK`` (the clock-offset
handshake — answered with a ``clock`` event on the worker's stream) and
``CTRL_PROFILE`` (a windowed on-demand ``torch.profiler`` capture into the
worker's stream dir, closed by a per-slice deadline poll).

The loop is intentionally boring: drain ctrl → maybe inject chaos → run one
interaction slice into a ``RecordingSink`` → frame + CRC → put (stamping
the heartbeat while blocked, so learner backpressure is never mistaken for
a hang). All replay-buffer mutation happens learner-side when the packet is
applied — the worker never touches shared state.
"""
from __future__ import annotations

import importlib
import os
import pickle
import queue as _q
import sys
import time
import traceback
from typing import Any, Dict, Optional

from .protocol import (
    CTRL_CLOCK,
    CTRL_PARAMS,
    CTRL_PROFILE,
    CTRL_STOP,
    ChannelStopped,
    FleetPacket,
    WorkerChannel,
    encode_packet,
)

__all__ = ["attach_worker_relay", "fleet_worker_loop", "worker_entry"]

_PUT_POLL_S = 0.1  # heartbeat cadence while parked on a full data queue
_IDLE_POLL_S = 0.005  # param-sync wait granularity (PPO strict mode)


def attach_worker_relay(sink: Any, channel: Any, relay_cfg: Dict[str, Any], worker_id: int) -> None:
    """Bind a :class:`~sheeprl_tpu_torch.telemetry.relay.RelaySink` to the
    channel's ``telem_put`` and attach it to the worker's TeeSink. A no-op
    unless the sink is a relay-ready tee AND the channel speaks telemetry —
    the relay is strictly additive, never a reason a worker fails to start."""
    from ..telemetry.relay import RelaySink, TeeSink

    if not isinstance(sink, TeeSink) or channel is None:
        return
    put = getattr(channel, "telem_put", None)
    if put is None:
        return
    try:
        sink.attach_relay(
            RelaySink(
                put,
                role="worker",
                index=worker_id,
                sample=float(relay_cfg.get("sample", 1.0)),
                max_buffer=int(relay_cfg.get("max_buffer", 512)),
                max_batch_bytes=int(relay_cfg.get("max_batch_kb", 64)) * 1024,
                flush_s=float(relay_cfg.get("flush_s", 2.0)),
            )
        )
    except Exception:
        pass


def _resolve_program(path: str):
    module_name, _, fn_name = path.partition(":")
    if not fn_name:
        raise ValueError(f"fleet program must be 'module:function', got {path!r}")
    return getattr(importlib.import_module(module_name), fn_name)


def fleet_worker_loop(
    program: Any,
    channel: WorkerChannel,
    chaos: Optional[Any],
    worker_id: int,
    incarnation: int,
    sink: Any = None,
    profiler: Any = None,
) -> None:
    """The worker hot loop: the program's act is the only tensor work, and
    its outputs are consumed as numpy by the env."""
    from ..engine import RecordingSink
    from ..telemetry import tracing

    heartbeat = 0
    seq = 0
    lifetime_steps = 0
    version = 0  # newest publication applied
    used_version = 0  # publication the LAST slice acted with (sync mode)
    sync_mode = bool(getattr(program, "sync_params", False))

    def _beat() -> None:
        # liveness pulse: programs with long slices (a PPO rollout is
        # rollout_steps env steps in ONE program.step call) stamp this
        # between env steps so a legitimately slow slice is never
        # misdiagnosed as a hang and SIGKILLed at fleet.hang_s
        nonlocal heartbeat
        heartbeat += 1
        channel.heartbeat.value = heartbeat

    def _trace_emit(rec: Dict[str, Any]) -> None:
        if sink is not None:
            try:
                sink.write(rec)
            except Exception:
                pass

    program.beat = _beat
    # batched-inference acting (fleet.act_mode=inference): the program ships
    # obs batches through the channel's act_request and tags requests with
    # its identity so the learner-side service can key latents and dedup
    # retries per (worker_id, incarnation)
    program.trace_emit = _trace_emit
    program.act_transport = channel
    program.act_identity = (worker_id, incarnation)
    while not channel.stop.is_set():
        # ---- control: drain to the newest publication --------------------
        latest: Optional[tuple] = None
        while True:
            try:
                msg = channel.ctrl.get_nowait()
            except (_q.Empty, OSError, EOFError):
                break
            # reading a publication is progress: a backlog of large ones
            # (a DreamerV3 world model is tens of MB each) must not read as
            # a hang while the worker drains it
            _beat()
            if msg[0] == CTRL_STOP:
                return
            if msg[0] == CTRL_PARAMS:
                latest = msg
            elif msg[0] == CTRL_CLOCK:
                # the handshake answer lives on THIS worker's stream: the
                # merger reads each stream's own clock events
                _trace_emit(tracing.clock_record(msg[1], role="worker", worker=worker_id))
            elif msg[0] == CTRL_PROFILE and profiler is not None:
                profiler.start(msg[1] if len(msg) > 1 else 2.0)
        if latest is not None:
            # publications arrive as a shared pickle blob (dumped once
            # learner-side for the whole fleet); only the newest is decoded
            program.set_params(pickle.loads(latest[2]), int(latest[1]))
            version = int(latest[1])
            channel.param_version.value = version
            # param-apply lag: publish wall time → APPLIED wall time (the
            # span ends after unpickle+set_params — transport plus the
            # apply cost itself). The publication carries its own trace id,
            # so publish (learner stream) and param_apply (every worker
            # stream) join one trace.
            if len(latest) > 3 and latest[3] is not None:
                _trace_emit(
                    tracing.span_record(
                        "param_apply",
                        "worker",
                        tracing.child_context((str(latest[4]), "") if len(latest) > 4 else None),
                        latest[3],
                        time.time(),
                        version=version,
                        worker=worker_id,
                    )
                )
        if profiler is not None:
            profiler.poll()  # close an elapsed on-demand capture window
        if sync_mode and version <= used_version:
            # strict on-policy mode: one slice per publication — park until
            # the learner publishes the next params (or stops)
            heartbeat += 1
            channel.heartbeat.value = heartbeat
            time.sleep(_IDLE_POLL_S)
            continue

        # ---- chaos: may crash / hang / slow this slice --------------------
        if chaos is not None:
            chaos.on_step(lifetime_steps)

        # ---- one interaction slice ---------------------------------------
        _beat()  # the slice gets the full fleet.hang_s budget from HERE
        sink_rec = RecordingSink()
        t_step0 = time.time()
        env_steps, payload = program.step(sink_rec)
        t_step1 = time.time()
        if payload is None:
            payload = sink_rec
        used_version = version
        ctx = tracing.TraceContext(tracing.new_trace_id(), tracing.new_span_id())
        _trace_emit(
            tracing.span_record(
                "env_step", "worker", ctx, t_step0, t_step1,
                worker=worker_id, seq=seq, version=version, step=lifetime_steps,
            )
        )
        pkt = FleetPacket(
            worker_id, incarnation, seq, int(env_steps), version, payload,
            trace=(ctx.trace_id, ctx.span_id),
        )
        frame = encode_packet(pkt)
        if chaos is not None:
            frame = frame[:-1] + (chaos.corrupt(frame[-1], seq),)

        # ---- handoff (bounded queue = backpressure) -----------------------
        while not channel.stop.is_set():
            heartbeat += 1
            channel.heartbeat.value = heartbeat
            try:
                channel.data.put(frame, timeout=_PUT_POLL_S)
                break
            except _q.Full:
                continue
        t_put = time.time()
        # queue_wait: slice done → frame accepted by the bounded queue. Under
        # backpressure this is where a worker's time goes — exactly the stage
        # the cross_process_stall finding attributes.
        _trace_emit(
            tracing.span_record(
                "queue_wait",
                "worker",
                tracing.TraceContext(ctx.trace_id, tracing.new_span_id(), ctx.span_id),
                t_step1,
                t_put,
                worker=worker_id,
                seq=seq,
            )
        )
        seq += 1
        lifetime_steps += int(env_steps)
        heartbeat += 1
        channel.heartbeat.value = heartbeat


def pin_threads() -> None:
    """One torch thread for this process (intra- and inter-op)."""
    import torch

    torch.set_num_threads(1)
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:  # the pool already started: the intra-op pin is what counts
        pass


def exit_record(worker_id: int, incarnation: int, lifetime: int = 0) -> Dict[str, Any]:
    """The worker's last stream record: the top-level packages the process
    loaded and whether it initialised CUDA (a CPU worker never does)."""
    import torch

    return {
        "event": "fleet",
        "action": "worker_exit",
        "step": int(lifetime),
        "worker": int(worker_id),
        "incarnation": int(incarnation),
        "packages": sorted({m.split(".")[0] for m in list(sys.modules)}),
        "cuda_initialized": bool(torch.cuda.is_initialized()),
    }


def worker_entry(spec: Dict[str, Any], channel: Optional[WorkerChannel], chaos: Optional[Any]) -> None:
    """Process entrypoint (spawn target). ``spec`` is a plain dict:
    ``{program, cfg, worker_id, num_workers, incarnation, log_dir?, trace?,
    connect?, platform}``. With a ``connect`` block (socket transport)
    ``channel`` is None and the worker dials the learner's listener instead —
    the loop itself never knows which transport it is on."""
    worker_id = int(spec["worker_id"])
    incarnation = int(spec["incarnation"])
    platform = str(spec.get("platform", "cpu"))
    sink = None
    profiler = None
    mem_sampler = None
    program = None
    try:
        pin_threads()
        import torch

        if platform == "cpu" and torch.cuda.is_available():
            raise RuntimeError("fleet.worker_platform=cpu, yet this worker sees a CUDA device")
        from ..config import Config

        if spec.get("log_dir") and spec.get("trace", True):
            from ..telemetry.tracing import RemoteProfiler, open_process_stream

            sink = open_process_stream(
                spec["log_dir"], "worker", worker_id, incarnation=incarnation, platform=platform
            )
            profiler = RemoteProfiler(
                os.path.join(os.path.dirname(sink.path), "profile"),
                emit=sink.write,
                role="worker",
            )
        relay_cfg = spec.get("relay") or {}
        if sink is not None and relay_cfg.get("enabled", False):
            # tee wrapper first (relay attached once the channel exists):
            # the socket channel's own net events must flow through the
            # same tee so they reach the learner too
            from ..telemetry.relay import TeeSink

            sink = TeeSink(sink)
        connect = spec.get("connect")
        if channel is None and connect is not None:
            from .net import WorkerSocketChannel

            channel = WorkerSocketChannel(
                connect["host"],
                int(connect["port"]),
                worker_id,
                int(connect.get("incarnation", incarnation)),
                str(connect["token"]),
                net=connect.get("net"),
                chaos=chaos,
                emit=(sink.write if sink is not None else None),
            )
        attach_worker_relay(sink, channel, relay_cfg, worker_id)
        cfg = Config(spec["cfg"])
        if sink is not None:
            # cadenced mem events on the worker's own stream (and through
            # the relay tee, so the learner sees the fleet's RSS)
            from ..telemetry.memory import MemorySampler

            mem_sampler = MemorySampler(sink.write, "worker", index=worker_id).start()
        program = _resolve_program(str(spec["program"]))(
            cfg, worker_id, int(spec["num_workers"])
        )
        if hasattr(program, "lifetime"):
            # respawn/resume: the learning_starts gate compares lifetime
            # against global progress — starting from 0 would put a late
            # (re)spawn back into random-action warmup
            program.lifetime = int(spec.get("initial_lifetime", 0))
        if chaos is not None:
            chaos.incarnation = incarnation
        fleet_worker_loop(program, channel, chaos, worker_id, incarnation, sink, profiler)
        rc = 0
    except (KeyboardInterrupt, ChannelStopped):
        # ChannelStopped: the learner stopped the channel while this worker
        # was parked on it — a clean stop, not a death
        rc = 0
    except BaseException:
        print(
            f"[fleet] worker {worker_id} (incarnation {incarnation}) died:\n"
            + traceback.format_exc(),
            file=sys.stderr,
            flush=True,
        )
        rc = 1
    finally:
        if mem_sampler is not None:
            try:
                mem_sampler.stop()
            except Exception:
                pass
        if profiler is not None:
            try:
                profiler.stop()
            except Exception:
                pass
        if sink is not None:
            try:
                sink.write(exit_record(worker_id, incarnation, getattr(program, "lifetime", 0)))
                sink.close()
            except Exception:
                pass
        try:
            channel.close()
        except Exception:
            pass
    # hard exit: skip atexit/teardown of the inherited mp plumbing — the
    # parent owns the channels and a worker must never hang on its way out
    os._exit(rc)
