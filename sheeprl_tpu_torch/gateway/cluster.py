"""Cluster assembly: config → ReplicaManager + SessionBroker + Gateway (the
port's counterpart of ``sheeprl_tpu/gateway/cluster.py``).

One builder for every consumer — the ``sheeprl_tpu_torch gateway`` CLI (checkpoint
replicas), the load bench and the failover tests (synthetic replicas) — so
the wiring is identical wherever the cluster runs.
"""
from __future__ import annotations

import pathlib
from typing import Any, Optional

from .admission import AdmissionController
from .broker import SessionBroker
from .gateway import Gateway
from .replica import ReplicaManager

__all__ = ["build_broker", "build_cluster", "gateway_from_checkpoint", "start_cluster"]


def build_broker(cfg: Any, sink: Any = None) -> Any:
    """The ``gateway.broker.mode`` switch — one builder for every consumer:

    * ``inproc`` (default, behavior preserved): the classic in-process
      LRU :class:`SessionBroker`; with ``gateway.broker.wal_dir`` set it is
      a WAL-backed :class:`~sheeprl_tpu_torch.gateway.wal.WalStore` instead, so
      LRU-evicted-but-durable sessions rehydrate from the log and the map
      survives a gateway restart;
    * ``external``: a :class:`~sheeprl_tpu_torch.gateway.broker_client.BrokerClient`
      against running ``sheeprl_tpu_torch brokerd`` daemon(s)
      (``gateway.broker.endpoints``, primary first then standby) — the
      topology that lets N gateways share one session plane and survive a
      SIGKILLed broker via standby promotion.
    """
    sel = cfg.select if hasattr(cfg, "select") else (lambda p, d=None: d)
    mode = str(sel("gateway.broker.mode", "inproc") or "inproc")
    max_sessions = int(sel("gateway.broker.max_sessions", 1_000_000))
    emit = sink.write if sink is not None else None
    if mode == "external":
        from .broker_client import BrokerClient

        raw = sel("gateway.broker.endpoints", None) or []
        endpoints = []
        for ep in raw:
            host, _, port = str(ep).rpartition(":")
            endpoints.append((host or "127.0.0.1", int(port)))
        if not endpoints:
            raise ValueError(
                "gateway.broker.mode=external needs gateway.broker.endpoints "
                "(['host:port', ...] — primary first, standby second)"
            )
        return BrokerClient(
            endpoints,
            token=str(sel("gateway.broker.token", "sheeprl-broker")),
            op_timeout_s=float(sel("gateway.broker.op_timeout_s", 2.0)),
            emit=emit,
        )
    if mode != "inproc":
        raise ValueError(f"unknown gateway.broker.mode '{mode}' (inproc | external)")
    wal_dir = sel("gateway.broker.wal_dir", None)
    if wal_dir:
        from .wal import WalStore

        return WalStore(
            wal_dir=wal_dir,
            max_sessions=max_sessions,
            durability=str(sel("gateway.broker.durability", "wal")),
            compact_bytes=int(sel("gateway.broker.compact_bytes", 64 * 1024 * 1024)),
            text=True,
            emit=emit,
        )
    return SessionBroker(max_sessions)


def build_cluster(
    cfg: Any,
    ckpt_path: Optional[Any] = None,
    sink: Any = None,
    start: bool = True,
    telemetry_dir: Optional[Any] = None,
) -> Gateway:
    """Build (and optionally start) the full serving cluster from the
    ``gateway`` config group. With ``ckpt_path`` the replicas serve the real
    checkpoint (the run's saved config rides into each replica process);
    without it they run the synthetic counter policy — the load-bench and
    chaos-test fleet.

    ``telemetry_dir`` is the per-process stream root: each replica writes
    its own ``replicas/replica_NNN/telemetry.jsonl`` under it (trace spans,
    clock handshake, profiler markers) and ``diag/trace.py`` merges them
    with the gateway's stream."""
    sel = cfg.select if hasattr(cfg, "select") else (lambda p, d=None: d)

    spec_base: dict = {
        "telemetry_dir": str(telemetry_dir) if telemetry_dir else None,
        "buckets": list(sel("gateway.replica.buckets", [1, 2, 4, 8, 16]) or [1, 2, 4, 8, 16]),
        "max_wait_ms": float(sel("gateway.replica.max_wait_ms", 5.0)),
        "max_pending": int(sel("gateway.replica.max_pending", 256)),
        "max_sessions": int(sel("gateway.replica.max_sessions", 4096)),
        "request_timeout_s": float(sel("gateway.replica.request_timeout_s", 30.0)),
    }
    if ckpt_path is not None:
        spec_base.update(
            mode="checkpoint",
            ckpt_path=str(pathlib.Path(ckpt_path)),
            cfg=cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg),
            hot_reload={
                "enabled": bool(sel("gateway.replica.hot_reload.enabled", True)),
                "poll_interval_s": float(sel("gateway.replica.hot_reload.poll_interval_s", 2.0)),
            },
        )
    else:
        spec_base["mode"] = "synthetic"
        # synthetic fleets become hot-reloadable (the flywheel loop) when a
        # checkpoint dir is named: replicas seed from its newest ckpt and
        # watch it exactly like checkpoint replicas watch theirs
        ckpt_dir = sel("gateway.replica.ckpt_dir", None)
        if ckpt_dir:
            spec_base["ckpt_dir"] = str(ckpt_dir)
            spec_base["hot_reload"] = {
                "enabled": bool(sel("gateway.replica.hot_reload.enabled", True)),
                "poll_interval_s": float(sel("gateway.replica.hot_reload.poll_interval_s", 2.0)),
            }
    # serve-side trajectory capture (sheeprl_tpu_torch/flywheel/): the flywheel's
    # intake rides into every replica spec; each replica writes its own
    # <dir>/replica_NNN/capture.jsonl segments
    if bool(sel("serve.capture.enabled", False)):
        capture_dir = sel("serve.capture.dir", None) or (
            str(pathlib.Path(str(telemetry_dir)) / "capture") if telemetry_dir else None
        )
        if not capture_dir:
            # capture silently writing nowhere would surface weeks later as
            # "no fresh capture samples" — refuse loudly instead
            raise ValueError(
                "serve.capture.enabled=True but no capture directory resolves: "
                "set serve.capture.dir, or enable gateway.telemetry.jsonl so "
                "<run_dir>/capture is available as the default"
            )
        spec_base["capture"] = {
            "enabled": True,
            "dir": str(capture_dir),
            "sample_frac": float(sel("serve.capture.sample_frac", 1.0)),
            "max_bytes": int(sel("serve.capture.max_bytes", 64 * 1024 * 1024)),
            "log_every_s": float(sel("serve.capture.log_every_s", 10.0)),
        }
    chaos = sel("gateway.replica.chaos")
    if chaos:
        spec_base["chaos"] = chaos.to_dict() if hasattr(chaos, "to_dict") else dict(chaos)

    manager = ReplicaManager(
        spec_base,
        num_replicas=int(sel("gateway.replicas", 2)),
        sink=sink,
        host=str(sel("gateway.http.host", "127.0.0.1")),
        replica_platform=str(sel("gateway.replica.platform", "cuda")),
        health_poll_s=float(sel("gateway.supervisor.health_poll_s", 0.5)),
        health_timeout_s=float(sel("gateway.supervisor.health_timeout_s", 2.0)),
        hang_s=float(sel("gateway.supervisor.hang_s", 10.0)),
        spawn_grace_s=float(sel("gateway.supervisor.spawn_grace_s", 120.0)),
        backoff_s=float(sel("gateway.supervisor.backoff_s", 0.5)),
        max_backoff_s=float(sel("gateway.supervisor.max_backoff_s", 30.0)),
        jitter=float(sel("gateway.supervisor.jitter", 0.5)),
        max_fails=int(sel("gateway.supervisor.max_fails", 3)),
        fail_window_s=float(sel("gateway.supervisor.fail_window_s", 300.0)),
    )
    gateway = Gateway(
        manager,
        broker=build_broker(cfg, sink=sink),
        admission=AdmissionController(
            rate_per_s=float(sel("gateway.admission.rate_per_s", 0.0) or 0.0),
            burst=int(sel("gateway.admission.burst", 256)),
            max_inflight=int(sel("gateway.admission.max_inflight", 512)),
            low_priority_frac=float(sel("gateway.admission.low_priority_frac", 0.8)),
            retry_after_s=float(sel("gateway.admission.retry_after_s", 0.25)),
            jitter=float(sel("gateway.admission.jitter", 0.5)),
        ),
        host=str(sel("gateway.http.host", "127.0.0.1")),
        port=int(sel("gateway.http.port", 8090)),
        forward_timeout_s=float(sel("gateway.forward_timeout_s", 30.0)),
        max_attempts=int(sel("gateway.max_attempts", 3)),
        shed_deterministic=bool(sel("gateway.admission.shed_deterministic", True)),
        max_pins=int(sel("gateway.router.max_pins", 1_000_000)),
        sink=sink,
        log_every_s=float(sel("gateway.telemetry.log_every_s", 10.0)),
        trace_sample=float(sel("gateway.telemetry.trace_sample", 0.0) or 0.0),
    )
    # live telemetry plane: a LiveAggregator on the gateway host ingests the
    # gateway's own records plus every batch relayed to POST /admin/telemetry
    # (replicas, brokerd) and serves GET /live snapshots + SLO burn alerts
    if bool(sel("gateway.telemetry.live", True)):
        from ..diag.aggregator import LiveAggregator
        from ..diag.doctor import _load_diag_cfg

        try:
            gateway.live = LiveAggregator(
                _load_diag_cfg(cfg),
                emit=sink.write if sink is not None else None,
                registry=gateway.stats.registry,
            )
        except Exception:
            gateway.live = None  # observability must never block serving
    if start:
        start_cluster(gateway, cfg)
    return gateway


def start_cluster(gateway: Gateway, cfg: Any) -> Gateway:
    """Start a cluster ``build_cluster(start=False)`` built: spawn its
    replicas (a no-op where ``gateway.manager.start()`` already ran, so a
    caller may spawn early and start later), wait for them to answer, open
    the gateway's HTTP endpoint and point the replicas' telemetry relay at
    it."""
    sel = cfg.select if hasattr(cfg, "select") else (lambda p, d=None: d)
    manager = gateway.manager
    manager.start()
    manager.wait_routable(timeout_s=float(sel("gateway.supervisor.spawn_grace_s", 120.0)))
    gateway.start()
    # replicas spawned before the gateway's HTTP server existed — push
    # the relay target now; later (re)spawns get it on first health
    if gateway.live is not None and bool(sel("gateway.telemetry.relay.enabled", True)):
        manager.set_relay(
            f"http://{gateway.host}:{gateway.port}/admin/telemetry",
            sample=float(sel("gateway.telemetry.relay.sample", 1.0)),
            flush_s=float(sel("gateway.telemetry.relay.flush_s", 2.0)),
            max_batch_kb=int(sel("gateway.telemetry.relay.max_batch_kb", 64)),
            max_buffer=int(sel("gateway.telemetry.relay.max_buffer", 512)),
        )
    return gateway


def gateway_from_checkpoint(ckpt_path: Any, cfg: Any, block: bool = True) -> Gateway:
    """The ``sheeprl_tpu_torch gateway`` entrypoint's workhorse: checkpoint → N
    supervised PolicyServer replicas behind one gateway, with ``gateway``
    telemetry JSONL written next to the run."""
    from ..telemetry.sinks import JsonlSink

    ckpt_path = pathlib.Path(ckpt_path)
    sel = cfg.select
    sink = None
    telemetry_dir = None
    if bool(sel("gateway.telemetry.jsonl", True)):
        run_dir = ckpt_path.parent.parent
        sink = JsonlSink(str(run_dir / "gateway" / "telemetry.jsonl"))
        telemetry_dir = run_dir  # replicas write replicas/replica_NNN/ here
    gateway = build_cluster(
        cfg, ckpt_path=ckpt_path, sink=sink, start=True, telemetry_dir=telemetry_dir
    )
    if gateway.live is not None and sink is not None:
        # discovery file for `sheeprl_tpu_torch top`: the /live URL next to the
        # gateway's telemetry.jsonl (same contract the training facade uses)
        import json as _json
        import os
        import time as _time

        try:
            with open(pathlib.Path(sink.path).parent / "live.json", "w") as fh:
                _json.dump(
                    {
                        "url": f"http://{gateway.host}:{gateway.port}/live",
                        "metrics_url": f"http://{gateway.host}:{gateway.port}/metrics",
                        "pid": os.getpid(),
                        "t": _time.time(),
                    },
                    fh,
                )
        except OSError:
            pass
    print(
        f"[gateway] {gateway.manager.num_replicas} replica(s) behind "
        f"http://{gateway.host}:{gateway.port}",
        flush=True,
    )
    if block:
        try:
            gateway.serve_forever()
        finally:
            gateway.manager.shutdown()
    return gateway
