"""The policy server: in-process client + stdlib HTTP JSON endpoint (the
port's counterpart of ``sheeprl_tpu/serve/server.py``).

``PolicyServer`` wires the serving stack together — `InferencePolicy`
(bucketed apply on the serving device), `MicroBatcher` (deadline-coalesced batches with
backpressure) and `CheckpointReloader` (hot weight swaps) — and exposes it
two ways:

* **in-process**: ``server.act(obs, deterministic, session)`` for evaluation
  loops, notebooks and tests (no sockets involved);
* **HTTP**: a ``ThreadingHTTPServer`` speaking JSON. Each connection thread
  blocks in ``MicroBatcher.submit``, which is exactly what lets concurrent
  HTTP traffic coalesce into device batches.

Endpoints:

    POST /v1/act      {"obs": {...}, "deterministic": bool, "session_id": str,
                       "session_state": b64?, "return_state": bool?,
                       "traceparent": str?}
                      -> {"actions": [[...]], "params_version": int,
                          "session_state": b64?, "trace_id": str?,
                          "timing": {batch_queue_ms, jit_step_ms, export_ms}?}
    GET  /healthz     liveness + params version + reload staleness seconds
    GET  /stats       full serve telemetry snapshot (the `serve` JSONL record,
                      incl. p50/p95/p99 latency)
    GET  /metrics     Prometheus text format (latency + batch-occupancy
                      histograms backed by diag/prometheus.py's registry)
    POST /admin/reload  force one checkpoint-reload poll (the gateway's
                      rolling-drain hook)
    POST /admin/clock   clock-offset handshake ({"t_send": wall}): answers
                      {"t_recv", "offset_s"} and emits a `clock` event on
                      the replica's stream — what lets diag/trace.py align
                      this process's spans with the gateway's
    POST /admin/profile on-demand windowed torch.profiler capture
                      ({"duration_s": 2.0}): 200 {started, trace_dir} or
                      409 while a window is already open
    POST /admin/relay   attach the in-band telemetry relay ({"url": ...}):
                      every event the replica writes is also batched to the
                      gateway's POST /admin/telemetry
    410 session_expired when a live session's latent was LRU-evicted (the
                      gateway re-hydrates it from the broker and retries)
    503 + Retry-After (jittered) when the queue is saturated (Backpressure)

A request that carries a ``traceparent`` (W3C header, or the same string as
a JSON field) gets the per-stage latency breakdown in its response AND has
its stages written as ``trace_span`` events to the replica's own telemetry
stream — the replica half of a cross-process critical path.

`serve_from_checkpoint` is the CLI entrypoint's workhorse: checkpoint →
policy (+warmup) → batcher → reloader → HTTP, with serve telemetry JSONL
written next to the run (``<run_dir>/serve/telemetry.jsonl``).
"""
from __future__ import annotations

import json
import os
import pathlib
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from .batcher import Backpressure, MicroBatcher
from .policy import InferencePolicy, SessionExpired
from .reload import CheckpointReloader
from .session_codec import StateDecodeError, decode_state, encode_state


class PolicyServer:
    """Owns the serving stack; start()/stop() manage all background threads.

    ``on_act`` is an optional hook invoked at the top of every HTTP act
    request (after parsing, before batching) — the gateway's replica wrapper
    uses it for chaos injection and synthetic latency.

    Idempotency: a session request carrying a ``request_id`` is answered
    from a per-session replay cache when the SAME id arrives again — the
    gateway stamps one id per client request and reuses it across its
    forward retries, so a retried forward whose first attempt actually
    executed (response lost to a timeout) returns the original response
    instead of stepping the session twice. One cached entry per session
    (the failover protocol only ever retries the latest request),
    LRU-bounded like every other per-session map.

    ``capture`` is an optional flywheel
    :class:`~sheeprl_tpu_torch.flywheel.capture.CaptureWriter`: every acked
    HTTP act of a sampled session is appended to the replica's capture
    segments (the data flywheel's intake), before the answer is sent, with
    the gateway's ``attempt`` when the act is a retry."""

    def __init__(
        self,
        policy: InferencePolicy,
        batcher: MicroBatcher,
        reloader: Optional[CheckpointReloader] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        http_enabled: bool = True,
        on_act: Optional[Any] = None,
        sink: Any = None,
        replica_id: int = 0,
        idempotency_sessions: int = 4096,
        capture: Any = None,
    ) -> None:
        self.policy = policy
        self.batcher = batcher
        self.reloader = reloader
        self.host = host
        self._requested_port = int(port)
        self.http_enabled = bool(http_enabled)
        self.on_act = on_act
        # the replica's own telemetry stream (trace spans, clock handshake
        # answers, profiler markers); None = tracing surfaces disabled
        self.sink = sink
        self.replica_id = int(replica_id)
        self.capture = capture
        from collections import OrderedDict

        self._idem_lock = threading.Lock()
        self._idem_max = int(idempotency_sessions)
        # sid -> (request_id, cached 200 body): the duplicate-forward shield
        self._idem: "OrderedDict[str, tuple]" = OrderedDict()
        self.idempotent_replays = 0
        from ..telemetry.tracing import RemoteProfiler

        profile_root = (
            os.path.join(os.path.dirname(getattr(sink, "path", "")), "profile")
            if sink is not None and getattr(sink, "path", None)
            else os.path.join("logs", "profile_serve")
        )
        self.profiler = RemoteProfiler(
            profile_root,
            emit=(sink.write if sink is not None else None),
            role="replica",
        )
        self._httpd: Any = None
        self._http_thread: Optional[threading.Thread] = None

    # -- in-process client -------------------------------------------------
    def act(
        self,
        obs: Dict[str, Any],
        deterministic: bool = False,
        session: Optional[str] = None,
        timeout_s: Optional[float] = None,
        timing_out: Optional[Dict[str, Any]] = None,
    ) -> np.ndarray:
        """Blocking single-observation request through the micro-batcher."""
        return self.batcher.submit(
            obs,
            deterministic=deterministic,
            session=session,
            timeout_s=timeout_s,
            timing_out=timing_out,
        )

    def stats(self) -> Dict[str, Any]:
        return self.batcher.serve_record()

    # -- request idempotency (the gateway's duplicate-forward shield) --------
    def idempotent_response(self, sid: str, request_id: str) -> Optional[Dict[str, Any]]:
        """The cached 200 body when this (session, request_id) was already
        served — the retried forward must NOT re-step the session."""
        with self._idem_lock:
            entry = self._idem.get(sid)
            if entry is not None and entry[0] == request_id:
                self._idem.move_to_end(sid)
                self.idempotent_replays += 1
                return entry[1]
        return None

    def remember_response(self, sid: str, request_id: str, body: Dict[str, Any]) -> None:
        with self._idem_lock:
            self._idem[sid] = (request_id, body)
            self._idem.move_to_end(sid)
            while len(self._idem) > self._idem_max:
                self._idem.popitem(last=False)

    def _emit_act_spans(self, ctx: Any, timing: Dict[str, Any], session: Optional[str]) -> None:
        """Write the request's stage spans (batch_queue → jit_step →
        export) to the replica's own stream. The batcher reports monotonic
        stage boundaries; they are re-anchored onto the wall clock here so
        the merger can align them with the gateway's spans."""
        if self.sink is None:
            return
        mono = timing.get("mono")
        if not mono:
            return
        from ..telemetry import tracing

        t_wall_end = time.time()
        anchor = t_wall_end - mono[3]  # wall == mono + anchor, per-request
        bounds = [m + anchor for m in mono]
        try:
            for name, (a, b) in (
                ("batch_queue", (bounds[0], bounds[1])),
                ("jit_step", (bounds[1], bounds[2])),
                ("export", (bounds[2], bounds[3])),
            ):
                rec = tracing.span_record(
                    name,
                    "replica",
                    tracing.TraceContext(ctx.trace_id, tracing.new_span_id(), ctx.span_id),
                    a,
                    b,
                    replica=self.replica_id,
                )
                if session is not None:
                    rec["session_id"] = str(session)
                self.sink.write(rec)
                # the live mirror: stage_latency_ms{role="replica",stage=...}
                # on this replica's own GET /metrics
                self.batcher.stats.registry.observe_event(rec)
        except Exception:
            pass

    def metrics_text(self) -> str:
        """Prometheus text exposition of the serving registry (latency /
        batch-occupancy histograms + request counters from ServeStats),
        with the point-in-time gauges refreshed at render."""
        registry = self.batcher.stats.registry
        registry.gauge("queue_depth", "pending act requests").set(float(self.batcher.queue_depth))
        registry.gauge("params_version", "hot-reload params version").set(
            float(self.policy.params_version)
        )
        registry.gauge("reloads", "successful hot reloads").set(float(self.policy.reload_count))
        registry.gauge("retraces", "retraces since warmup (0 is the invariant)").set(
            float(self.policy.retraces_since_warmup())
        )
        registry.gauge("sessions", "live recurrent sessions").set(float(len(self.policy.sessions)))
        registry.gauge("idempotent_replays", "duplicate forwards answered from cache").set(
            float(self.idempotent_replays)
        )
        if self.capture is not None:
            snap = self.capture.snapshot()
            registry.gauge("capture_captured", "flywheel capture records written").set(float(snap["captured"]))
            registry.gauge("capture_skipped", "acts skipped by capture sampling").set(float(snap["skipped"]))
        return registry.render()

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd is not None else None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "PolicyServer":
        self.batcher.start()
        if self.sink is not None:
            # per-bucket roofline verdicts of the warmed apply fn: bucket
            # size 1 sits deepest in memory-bound territory, the largest
            # bucket shows what full occupancy buys — written once, at start
            try:
                for rec in self.policy.roofline_records():
                    self.sink.write(rec)
            except Exception:
                pass
        if self.reloader is not None:
            self.reloader.start()
        if self.http_enabled and self._httpd is None:
            from http.server import ThreadingHTTPServer

            class _HTTPServer(ThreadingHTTPServer):
                # the listen backlog: at the default 5, a burst of clients
                # connecting at once loses SYNs and waits a second to retry
                request_queue_size = 128

            handler = _make_handler(self)
            self._httpd = _HTTPServer((self.host, self._requested_port), handler)
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True, name="policy-http"
            )
            self._http_thread.start()
        return self

    def serve_forever(self) -> None:
        """Block the calling thread until interrupted (CLI mode)."""
        self.start()
        try:
            while True:
                threading.Event().wait(3600)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._http_thread = None
        if self.reloader is not None:
            self.reloader.stop()
        self.profiler.stop()  # close a live on-demand capture window
        self.batcher.stop()
        if self.capture is not None:
            try:
                self.capture.close()
            except Exception:
                pass


def _make_handler(server: "PolicyServer"):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # a reply is two writes (headers, then the body): without TCP_NODELAY
        # the body waits for the client's delayed ACK of the headers
        disable_nagle_algorithm = True

        def log_message(self, fmt: str, *args: Any) -> None:  # quiet by default
            pass

        def _reply(self, code: int, payload: Dict[str, Any], headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:
            if self.path == "/healthz":
                # liveness + freshness: param_version and reload staleness
                # let a gateway's health-based routing prefer fresh replicas
                self._reply(
                    200,
                    {
                        "status": "ok",
                        "params_version": server.policy.params_version,
                        "reloads": server.policy.reload_count,
                        "reload_staleness_s": round(server.policy.params_staleness_s(), 3),
                        "sessions": len(server.policy.sessions),
                    },
                )
            elif self.path == "/stats":
                self._reply(200, server.stats())
            elif self.path == "/metrics":
                from ..diag.prometheus import CONTENT_TYPE

                body = server.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self) -> None:
            if self.path in ("/admin/reload",):
                self._admin_reload()
                return
            if self.path in ("/admin/clock",):
                self._admin_clock()
                return
            if self.path in ("/admin/profile",):
                self._admin_profile()
                return
            if self.path in ("/admin/relay",):
                self._admin_relay()
                return
            if self.path not in ("/v1/act", "/act"):
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
                raw_obs = payload.get("obs")
                if not isinstance(raw_obs, dict) or not raw_obs:
                    raise ValueError("body must carry a non-empty 'obs' object")
                obs = {k: np.asarray(v) for k, v in raw_obs.items()}
                deterministic = bool(payload.get("deterministic", False))
                session = payload.get("session_id")
                request_id = payload.get("request_id")
                # idempotent replay — checked BEFORE the state import: a
                # retried forward whose first attempt executed must return
                # the ORIGINAL response untouched. Importing the (acked,
                # pre-step) state first would rewind the cached latent while
                # the replayed body still carries the post-step blob — the
                # cache and the acked trajectory would diverge.
                if session is not None and request_id is not None:
                    cached = server.idempotent_response(str(session), str(request_id))
                    if cached is not None:
                        self._reply(200, cached)
                        return
                # externalized-state protocol (gateway broker): an inbound
                # blob re-hydrates the replica's session cache BEFORE the
                # step — the broker's copy wins over whatever is cached
                inbound_state = payload.get("session_state")
                if inbound_state is not None:
                    if session is None:
                        raise ValueError("'session_state' requires a 'session_id'")
                    server.policy.import_session(session, decode_state(inbound_state))
                return_state = bool(payload.get("return_state", False))
            except StateDecodeError as e:
                self._reply(400, {"error": str(e)})
                return
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            # trace context: the W3C header wins, the JSON field covers
            # clients that cannot set headers; either makes this request
            # traced (timing in the body + spans on the replica stream)
            from ..telemetry import tracing

            parent = tracing.parse_traceparent(
                self.headers.get("traceparent") or payload.get("traceparent")
            )
            ctx = tracing.child_context(parent) if parent is not None else None
            timing: Optional[Dict[str, Any]] = {} if ctx is not None else None
            if server.on_act is not None:
                server.on_act()
            try:
                actions = server.act(
                    obs, deterministic=deterministic, session=session, timing_out=timing
                )
            except SessionExpired as e:
                # the latent was LRU-evicted: tell the caller (the gateway
                # translates this into a broker re-hydrate + retry) instead
                # of silently restarting the session from the initial state
                self._reply(
                    410, {"error": "session_expired", "session_id": e.session_id}
                )
                return
            except ValueError as e:  # malformed obs (shape/dtype/structure)
                self._reply(400, {"error": str(e)})
                return
            except Backpressure as e:
                self._reply(
                    503,
                    {"error": str(e), "retry_after_s": e.retry_after_s},
                    headers={"Retry-After": f"{max(1, int(round(e.retry_after_s)))}"},
                )
                return
            except TimeoutError as e:
                self._reply(504, {"error": str(e)})
                return
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            body: Dict[str, Any] = {
                "actions": np.asarray(actions).tolist(),
                "params_version": server.policy.params_version,
            }
            if ctx is not None and timing:
                body["trace_id"] = ctx.trace_id
                server._emit_act_spans(ctx, timing, session)
                timing.pop("mono", None)
                body["timing"] = timing
            if return_state and session is not None:
                row = server.policy.export_session(session)
                if row is not None:
                    body["session_state"] = encode_state(row)
                elif getattr(getattr(server.policy, "core", None), "stateful", False):
                    # the latent was LRU-evicted between the step's scatter
                    # and this export: acking without the updated state
                    # would leave the caller's copy behind the trajectory
                    # it just acked — 410 makes it replay from its own copy
                    self._reply(
                        410, {"error": "session_expired", "session_id": session}
                    )
                    return
            if session is not None and request_id is not None:
                # the duplicate-forward shield: a retried forward with the
                # same request_id replays THIS body instead of re-stepping
                server.remember_response(str(session), str(request_id), dict(body))
            if server.capture is not None:
                # flywheel intake: the acked step becomes a training sample
                # (per-session sampling + schema'd JSONL happen inside the
                # writer; failures are counted there, never surfaced here)
                server.capture.record(
                    session,
                    raw_obs,
                    body["actions"],
                    body["params_version"],
                    trace_id=ctx.trace_id if ctx is not None else None,
                    deterministic=deterministic,
                    reward=payload.get("reward"),
                    done=payload.get("done"),
                    attempt=payload.get("attempt"),
                )
            self._reply(200, body)

        def _admin_reload(self) -> None:
            """One rolling-drain step: force a checkpoint-reload poll NOW.
            The gateway's ReplicaManager drives this one replica at a time so
            a fleet-wide param swap never stages weights everywhere at once."""
            if server.reloader is None:
                self._reply(
                    409, {"error": "no reloader attached", "params_version": server.policy.params_version}
                )
                return
            try:
                swapped = bool(server.reloader.poll_once())
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(
                200, {"swapped": swapped, "params_version": server.policy.params_version}
            )

        def _read_json(self) -> Dict[str, Any]:
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                return payload if isinstance(payload, dict) else {}
            except (ValueError, json.JSONDecodeError):
                return {}

        def _admin_clock(self) -> None:
            """Clock-offset handshake: the caller's wall-clock send stamp in,
            this process's receive stamp (and the offset upper bound) out —
            also emitted as a `clock` event on the replica's stream for the
            trace merger."""
            from ..telemetry import tracing

            payload = self._read_json()
            t_send = payload.get("t_send")
            if not isinstance(t_send, (int, float)):
                self._reply(400, {"error": "body must carry a numeric 't_send'"})
                return
            rec = tracing.clock_record(float(t_send), role="replica", replica=server.replica_id)
            if server.sink is not None:
                try:
                    server.sink.write(rec)
                except Exception:
                    pass
            self._reply(200, {"t_recv": rec["t_recv"], "offset_s": rec["offset_s"]})

        def _admin_profile(self) -> None:
            """On-demand windowed torch.profiler capture (the serving half of
            the remote-profiling control plane; the fleet half is the
            CTRL_PROFILE ctrl-queue op). One window at a time — 409 while
            a capture is already open."""
            payload = self._read_json()
            try:
                duration_s = float(payload.get("duration_s") or 2.0)
            except (TypeError, ValueError) as e:
                self._reply(400, {"error": f"bad duration_s: {e}"})
                return
            trace_dir = server.profiler.start(duration_s, use_timer=True)
            if trace_dir is None:
                self._reply(
                    409,
                    {"error": "profiler window already open (or backend cannot profile)"},
                )
                return
            self._reply(200, {"started": True, "trace_dir": trace_dir, "duration_s": duration_s})

        def _admin_relay(self) -> None:
            """Attach (or retarget) the in-band telemetry relay: from here on
            every event this replica writes locally is also batched upstream
            to the given URL (the gateway's POST /admin/telemetry). Pushed by
            the ReplicaManager once per healthy replica — best-effort, the
            local stream is authoritative either way."""
            from ..telemetry.relay import RelaySink, TeeSink, http_post_sender

            payload = self._read_json()
            url = payload.get("url")
            if not isinstance(url, str) or not url:
                self._reply(400, {"error": "body must carry a relay 'url'"})
                return
            if not isinstance(server.sink, TeeSink):
                self._reply(409, {"error": "replica sink is not relay-capable"})
                return
            try:
                relay = RelaySink(
                    http_post_sender(url),
                    role="replica",
                    index=server.replica_id,
                    sample=float(payload.get("sample", 1.0)),
                    max_buffer=int(payload.get("max_buffer", 512)),
                    max_batch_bytes=int(payload.get("max_batch_kb", 64)) * 1024,
                    flush_s=float(payload.get("flush_s", 2.0)),
                )
            except (TypeError, ValueError) as e:
                self._reply(400, {"error": f"bad relay options: {e}"})
                return
            server.sink.attach_relay(relay)
            self._reply(200, {"attached": True, "url": url})

    return Handler


def serve_from_checkpoint(ckpt_path: Any, cfg: Any, block: bool = True) -> PolicyServer:
    """Checkpoint → warmed policy → batcher (+hot reload, +HTTP): the
    ``sheeprl_tpu_torch serve`` entrypoint. With ``block=False`` (tests,
    embedding) the started server is returned instead of blocking."""
    import sys

    import torch

    from ..telemetry.sinks import JsonlSink

    ckpt_path = pathlib.Path(ckpt_path)
    sel = cfg.select
    policy = InferencePolicy.from_checkpoint(ckpt_path, cfg=cfg)
    card = torch.cuda.get_device_name(policy.device) if policy.device.type == "cuda" else "host cpu"
    print(f"[serve] policy '{policy.core.name}' on {policy.device} ({card})", file=sys.stderr, flush=True)
    if bool(sel("serve.warmup.enabled", True)):
        variants = sel("serve.warmup.greedy_variants", [True, False])
        policy.warmup(tuple(bool(v) for v in variants))

    sink = None
    if bool(sel("serve.telemetry.jsonl", True)):
        run_dir = ckpt_path.parent.parent
        sink = JsonlSink(str(run_dir / "serve" / "telemetry.jsonl"))
    batcher = MicroBatcher(
        policy,
        max_wait_ms=float(sel("serve.max_wait_ms", 5.0)),
        max_pending=int(sel("serve.max_pending", 256)),
        request_timeout_s=float(sel("serve.request_timeout_s", 30.0)),
        sink=sink,
        log_every_s=float(sel("serve.telemetry.log_every_s", 10.0)),
    )
    reloader = None
    if bool(sel("serve.hot_reload.enabled", True)):
        try:
            loaded_step = int(ckpt_path.stem.split("_")[1])
        except (IndexError, ValueError):
            loaded_step = -1
        reloader = CheckpointReloader(
            policy,
            ckpt_path.parent,
            poll_interval_s=float(sel("serve.hot_reload.poll_interval_s", 2.0)),
            loaded_step=loaded_step,
            sink=sink,
        )
    capture = None
    if bool(sel("serve.capture.enabled", False)):
        from ..flywheel.capture import capture_writer_from_spec

        run_dir = ckpt_path.parent.parent
        capture = capture_writer_from_spec(
            {
                "enabled": True,
                "dir": str(sel("serve.capture.dir", "") or (run_dir / "capture")),
                "sample_frac": float(sel("serve.capture.sample_frac", 1.0)),
                "max_bytes": int(sel("serve.capture.max_bytes", 64 * 1024 * 1024)),
                "log_every_s": float(sel("serve.capture.log_every_s", 10.0)),
            },
            replica_id=0,
            telem_sink=sink,
        )
    server = PolicyServer(
        policy,
        batcher,
        reloader=reloader,
        host=str(sel("serve.http.host", "127.0.0.1")),
        port=int(sel("serve.http.port", 8190)),
        http_enabled=bool(sel("serve.http.enabled", True)),
        sink=sink,  # traced requests write their stage spans here too
        capture=capture,
    )
    if sink is not None:
        sink.write(batcher.serve_record())  # startup snapshot (warmup state)
    if block:
        if server.http_enabled:
            server.start()
            print(f"[serve] policy '{policy.core.name}' listening on http://{server.host}:{server.port}", flush=True)
        server.serve_forever()
        return server
    return server.start()
