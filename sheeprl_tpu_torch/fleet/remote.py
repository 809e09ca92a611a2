"""Standalone remote env worker: attach to a running learner over TCP (the
port's own copy of ``sheeprl_tpu/fleet/remote.py``).

The supervisor normally spawns its workers as local child processes. For a
slot listed in ``fleet.net.remote_workers`` it instead *waits*: the slot is
registered with the listener and goes live when a process — typically on
another host — dials in with this entrypoint:

    python -m sheeprl_tpu_torch.fleet.remote \\
        --connect LEARNER_HOST:PORT --worker-id 3 --token RUN_TOKEN \\
        [--log-dir /local/scratch/worker3]

The remote worker needs nothing but the address, its slot id and the run
token (printed by the learner / carried in the ``net listen`` telemetry
event): it connects with ``incarnation=-1`` ("assign me") and the
HELLO_ACK delivers the full run **spec** — program path, config, slot
count, current incarnation and lifetime seed — so the remote host never
needs the experiment config shipped out of band. Everything after the
handshake is the ordinary :func:`~sheeprl_tpu_torch.fleet.worker.fleet_worker_loop`:
same packets, same heartbeats, same reconnect/replay semantics as a
locally-spawned socket worker. If the learner quarantines the slot the
HELLO is refused and this process exits.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description="SheepRL-TPU (PyTorch) remote fleet worker")
    parser.add_argument("--connect", required=True, help="learner listener HOST:PORT")
    parser.add_argument("--worker-id", required=True, type=int, help="fleet slot to claim")
    parser.add_argument("--token", required=True, help="run token (fences the fleet)")
    parser.add_argument(
        "--log-dir", default=None, help="local telemetry stream dir (default: none)"
    )
    parser.add_argument(
        "--spec-timeout-s",
        default=30.0,
        type=float,
        help="how long to wait for the learner's HELLO_ACK spec",
    )
    args = parser.parse_args(argv)
    host, _, port = args.connect.rpartition(":")
    if not host or not port.isdigit():
        parser.error(f"--connect must be HOST:PORT, got {args.connect!r}")

    # remote workers act on the host CPU exactly like locally spawned ones:
    # no card (before torch is imported) and one torch thread
    os.environ["CUDA_VISIBLE_DEVICES"] = ""

    from ..config import Config
    from ..telemetry.memory import MemorySampler
    from ..telemetry.relay import TeeSink
    from .net import WorkerSocketChannel
    from .worker import _resolve_program, attach_worker_relay, exit_record, fleet_worker_loop, pin_threads

    pin_threads()

    local = None
    if args.log_dir:
        from ..telemetry.tracing import open_process_stream

        local = open_process_stream(args.log_dir, "worker", int(args.worker_id))
    # tee even with no local file: the learner's spec says whether to relay,
    # and a log-dir-less remote worker is exactly the stream the controlling
    # host could never see before the relay existed
    sink = TeeSink(local)
    channel = WorkerSocketChannel(
        host,
        int(port),
        int(args.worker_id),
        -1,  # "assign me": the learner's HELLO_ACK carries the incarnation
        str(args.token),
        emit=sink.write,
    )
    deadline = time.monotonic() + float(args.spec_timeout_s)
    while channel.spec is None and time.monotonic() < deadline:
        if channel.stop.is_set():  # refused (quarantined slot / bad token)
            print("[fleet-remote] attach refused by learner", file=sys.stderr)
            channel.close()
            return 2
        time.sleep(0.05)
    spec = channel.spec
    if spec is None:
        print(
            f"[fleet-remote] no spec within {args.spec_timeout_s:.0f}s "
            "(is this slot in fleet.net.remote_workers?)",
            file=sys.stderr,
        )
        channel.close()
        return 3
    attach_worker_relay(sink, channel, spec.get("relay") or {}, int(args.worker_id))
    cfg = Config(spec["cfg"])
    # mem events through the tee: the remote host's RSS reaches the learner
    # even when this worker has no local log dir
    mem_sampler = MemorySampler(sink.write, "worker", index=int(args.worker_id)).start()
    program = _resolve_program(str(spec["program"]))(
        cfg, int(args.worker_id), int(spec["num_workers"])
    )
    if hasattr(program, "lifetime"):
        program.lifetime = int(spec.get("initial_lifetime", 0))
    try:
        fleet_worker_loop(
            program, channel, None, int(args.worker_id), channel.incarnation, sink
        )
    finally:
        if mem_sampler is not None:
            try:
                mem_sampler.stop()
            except Exception:
                pass
        try:
            sink.write(exit_record(int(args.worker_id), channel.incarnation, getattr(program, "lifetime", 0)))
            sink.close()  # final relay flush rides the still-open channel
        except Exception:
            pass
        channel.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
