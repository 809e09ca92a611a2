"""`ActService` — learner-hosted batched acting for the fleet (the port's
counterpart of ``sheeprl_tpu/fleet/act_service.py``).

The Podracer **Sebulba** layout (arXiv:2104.06272): under
``fleet.act_mode=inference`` the workers stop stepping their CPU copy of the
policy and ship observation batches to one service in the learner process,
where the algorithm's :mod:`~sheeprl_tpu_torch.fleet.act_core` steps the
whole fleet's rows in one batched call on the learner's device (the card).
The serving stack's machinery is reused: the deadline-coalescing flush loop
(`serve.batcher.MicroBatcher`'s idiom), power-of-two bucket padding
(`serve.policy._bucket_for`), per-session recurrent state rows
(`serve.policy.SessionStore` keyed ``"{worker_id}/{env_slot}"``) and
`serve.batcher.ServeStats` (occupancy and pad waste).

**Noise rows, not keys.** The JAX request carries a base key and the
service recomputes per-row keys. Here each worker draws every slot's noise
from that slot's own ``torch.Generator`` (``act_core.draw_noise`` on its
CPU) and ships the rows under ``noise``; the service pads them as it pads
the observations and calls the SAME core. Row ``i`` then depends only on the
parameters, ``obs[i]``, ``state[i]`` and ``noise[i]``, whatever its bucket
or neighbours. cuBLAS picks kernels per row count, so a row served in a
padded, coalesced bucket matches the worker-hosted row to a tolerance, not
bit for bit; the ledger (counts) is the same either way.

Durability properties:

* **idempotent requests** — a worker re-sends an unanswered request; the
  service caches the last completed ``(req_id, response)`` per
  ``(worker_id, incarnation)`` and answers retries from the cache WITHOUT
  stepping recurrent latents again, and drops duplicates of a request still
  in flight.
* **latent migration on respawn** — session rows are keyed by worker id
  (not incarnation); a respawned program's first request carries a full
  reset mask, so its rows start from the initial state.
* **publication coupling** — :meth:`swap_params` is called by
  `FleetEngine.publish` with the NEXT ledger version *before* the
  supervisor broadcasts to workers, so by the time any worker learns of
  publication N the service already acts with it.
* **double-buffered parameters** — a publication becomes a NEW dict of
  device tensors, copied and synchronized on the publishing thread, then one
  reference swap; the core's modules run through
  ``torch.func.functional_call`` on whichever dict a batch took, so a batch
  in flight never sees tensors change under it.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..serve.batcher import ServeStats
from ..serve.policy import (DEFAULT_BUCKETS, SessionStore, _bucket_for, device_params, pad_rows, stack_rows,
                            to_device, to_host, tree_map)
from .act_core import ActCore, build_act_core

__all__ = ["ActService"]


class _ActJob:
    __slots__ = ("req", "reply", "t_submit")

    def __init__(self, req: Dict[str, Any], reply: Callable[[Dict[str, Any]], None]) -> None:
        self.req = req
        self.reply = reply
        self.t_submit = time.monotonic()


class _BoundCore(nn.Module):
    """The core's modules as the children of one module, so a single
    ``functional_call`` binds all of them to a publication's tensors for one
    call of the core (``forward("act", ...)`` or ``forward("init", n)``)."""

    def __init__(self, core: ActCore, handle: Any) -> None:
        super().__init__()
        self.mods = nn.ModuleDict(core.modules)
        object.__setattr__(self, "_core", core)
        object.__setattr__(self, "_handle", handle)  # what core.act takes as params

    def forward(self, kind: str, *args: Any) -> Any:
        if kind == "init":
            return self._core.init_state(self._handle, *args)
        return self._core.act(self._handle, *args)


class ActService:
    """One batched act endpoint for the whole fleet, hosted by the learner.

    Request (a plain dict — it rides both transports):
    ``{worker_id, incarnation, req_id, n, obs, noise, reset?, mask?, trace?}``
    where ``obs`` is the program's prepared obs tree with leading dim ``n``,
    ``noise`` the rows the worker's slot generators drew (``core.draw_noise``)
    and ``reset`` an optional ``bool[n]`` mask of env slots whose latent must
    start anew (dones, restarts, respawn). Response:
    ``{req_id, version, actions, actions_cat?}`` or ``{req_id, error}``.
    """

    def __init__(self, cfg: Any, program: str, telem: Any = None, trace: bool = True,
                 device: Optional[torch.device] = None) -> None:
        sel = cfg.select if hasattr(cfg, "select") else (lambda p, d=None: d)

        def opt(path: str, default: Any) -> Any:
            v = sel(path, None)
            return default if v is None else v

        self.cfg = cfg
        self.program = str(program)
        self.telem = telem
        self.trace = bool(trace)
        if device is None:
            from ..utils.utils import get_device

            device = get_device(cfg)
        self.device = torch.device(device)
        self.max_wait_s = max(0.0, float(opt("fleet.act.max_wait_ms", 5.0)) / 1000.0)
        raw = list(opt("fleet.act.buckets", None) or DEFAULT_BUCKETS)
        self.buckets: List[int] = sorted({int(b) for b in raw})
        if any(b <= 0 for b in self.buckets):
            raise ValueError(f"fleet.act.buckets must be positive, got {self.buckets}")
        self.sessions = SessionStore(int(opt("fleet.act.max_sessions", 4096)))
        from ..diag.prometheus import Registry

        self.stats = ServeStats(registry=Registry(prefix="sheeprl_fleet_act"))
        self.core: Optional[ActCore] = None
        self._bound: Optional[_BoundCore] = None
        self._params: Any = None
        self._version = 0
        self._staged: Optional[Tuple[Any, int]] = None  # publication before start()
        self._init_row: Any = None
        self._params_lock = threading.Lock()
        self._act_lock = threading.Lock()
        self._cv = threading.Condition()
        self._pending: Deque[_ActJob] = deque()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pump: Optional[threading.Thread] = None
        self._sup: Any = None
        # the flush thread's own CUDA stream: acting never queues behind the
        # train step on the learner thread's stream
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # (worker_id, incarnation) -> (req_id, response) of the LAST completed
        # request — the retry/idempotency cache (latents step exactly once)
        self._done: Dict[Tuple[int, int], Tuple[int, Dict[str, Any]]] = {}
        self._inflight: Set[Tuple[int, int, int]] = set()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ActService":
        if self.core is None:
            from ..utils.env import probe_env_spaces

            sel = self.cfg.select if hasattr(self.cfg, "select") else (lambda p, d=None: d)
            spaces = probe_env_spaces(self.cfg, int(sel("seed", 0) or 0))
            core = build_act_core(self.program, self.cfg, spaces.single_observation_space,
                                  spaces.single_action_space, device=self.device)
            # what the core's act takes as its params: the DV3 core its
            # modules by name, the SAC core its actor
            handle = core.modules if core.stateful else core.modules["actor"]
            self._bound = _BoundCore(core, handle)
            self.core = core
            if self._staged is not None:
                params_np, version = self._staged
                self._staged = None
                self.swap_params(params_np, version)
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._flush_loop, daemon=True, name="fleet-act-service")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in (self._thread, self._pump):
            if t is not None:
                t.join(timeout=5.0)
        self._thread = None
        self._pump = None
        with self._cv:
            leftovers = list(self._pending)
            self._pending.clear()
            self._inflight.clear()
        # fail whatever is still queued so no worker parks on a dead service
        for job in leftovers:
            try:
                job.reply({"req_id": int(job.req.get("req_id", 0)), "error": "act service shut down"})
            except Exception:
                pass

    def _on_stream(self) -> contextlib.ExitStack:
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.inference_mode())
        if self._stream is not None:
            ctx.enter_context(torch.cuda.stream(self._stream))
        return ctx

    def _call(self, params: Dict[str, Dict[str, torch.Tensor]], *args: Any) -> Any:
        flat = {f"mods.{m}.{k}": t for m, sd in params.items() for k, t in sd.items()}
        return functional_call(self._bound, flat, args)

    # -- param publication coupling ----------------------------------------
    def swap_params(self, params_np: Any, version: int) -> None:
        """Install one publication's acting subtree: a new dict of device
        tensors (copied and synchronized here), then one reference swap under
        the lock. Called BEFORE the supervisor broadcasts the same version, so
        no worker can act through the service with params older than the
        publication it was just told about."""
        if self.core is None:
            self._staged = (params_np, int(version))
            return
        new = device_params({name: params_np[name] for name in self.core.modules}, self.device)
        init_row = None
        if self.core.stateful:
            with self._act_lock, self._on_stream():
                init_row = to_host(self._call(new, "init", 1))
                if self._stream is not None:
                    self._stream.synchronize()
        with self._params_lock:
            self._params = new
            self._version = int(version)
            if init_row is not None:
                self._init_row = init_row

    @property
    def version(self) -> int:
        with self._params_lock:
            return self._version

    # -- transports --------------------------------------------------------
    def wire_handler(self, chan: Any, req: Dict[str, Any]) -> None:
        """Socket-transport entry: `LearnerChannel` calls this per T_ACT
        frame; the response rides back as T_ACT_RESP on the same link."""
        self.submit(req, chan.send_act_resp)

    def attach_mp(self, sup: Any) -> None:
        """mp-transport entry: a pump thread sweeps every handle's
        ``act_req`` queue and replies into the same channel's ``act_resp``
        queue (captured at dequeue time — a respawned incarnation's fresh
        channel is picked up on the next sweep, stale replies go to the dead
        queue and are never read)."""
        if self._pump is not None:
            return
        self._sup = sup
        self._pump = threading.Thread(target=self._pump_loop, daemon=True, name="fleet-act-mp-pump")
        self._pump.start()

    def _pump_loop(self) -> None:
        import queue as _q

        while not self._stop.is_set():
            got = False
            handles = list(getattr(self._sup, "handles", []) or [])
            for h in handles:
                ch = h.channel
                q = getattr(ch, "act_req", None) if ch is not None else None
                if q is None:
                    continue
                for _ in range(64):
                    try:
                        req = q.get_nowait()
                    except _q.Empty:
                        break
                    except Exception:
                        break  # a dead worker's truncated put: the monitor owns it
                    got = True
                    resp_q = ch.act_resp

                    def _reply(resp: Dict[str, Any], _rq: Any = resp_q) -> None:
                        try:
                            _rq.put_nowait(resp)
                        except Exception:
                            pass  # dead incarnation's queue: monitor owns it

                    self.submit(req, _reply)
            if not got:
                time.sleep(0.001)

    # -- submission --------------------------------------------------------
    def submit(self, req: Dict[str, Any], reply: Callable[[Dict[str, Any]], None]) -> None:
        wid = int(req.get("worker_id", -1))
        inc = int(req.get("incarnation", 0))
        rid = int(req.get("req_id", 0))
        cached: Optional[Dict[str, Any]] = None
        with self._cv:
            done = self._done.get((wid, inc))
            if done is not None and done[0] == rid:
                cached = done[1]  # a retry for a lost response: answer, don't re-step
            elif (wid, inc, rid) in self._inflight:
                return  # duplicate of an in-flight request: the original will answer
            else:
                self._inflight.add((wid, inc, rid))
                self._pending.append(_ActJob(req, reply))
                self.stats.record_submit()
                self._cv.notify_all()
        if cached is not None:
            try:
                reply(cached)
            except Exception:
                pass

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._pending)

    # -- the flush loop ----------------------------------------------------
    def _rows_pending_locked(self) -> int:
        return sum(int(job.req.get("n", 0)) for job in self._pending)

    def _take_batch_locked(self) -> List[_ActJob]:
        """Head-of-queue run of requests whose rows fit the widest bucket
        (a request wider than the bucket rides alone — padded to its own
        power of two). Requests with and without an action mask never
        coalesce: the core takes the mask tree for every row or for none."""
        max_rows = self.buckets[-1]
        batch: List[_ActJob] = []
        rows = 0
        while self._pending:
            job = self._pending[0]
            n = int(job.req.get("n", 0))
            if batch:
                if rows + n > max_rows:
                    break
                if (job.req.get("mask") is None) != (batch[0].req.get("mask") is None):
                    break
            batch.append(self._pending.popleft())
            rows += n
        return batch

    def _flush_loop(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                while not self._pending and not self._stop.is_set():
                    self._cv.wait(timeout=0.1)
                if self._stop.is_set():
                    return
                # deadline flush: max_wait_s from the OLDEST request to fill
                # the widest bucket, then act with what's there
                deadline = self._pending[0].t_submit + self.max_wait_s
                while (
                    self._rows_pending_locked() < self.buckets[-1]
                    and not self._stop.is_set()
                    and time.monotonic() < deadline
                ):
                    self._cv.wait(timeout=max(0.0, deadline - time.monotonic()))
                batch = self._take_batch_locked()
            if batch:
                self._run_batch(batch)

    def _bucket(self, total: int) -> int:
        if total <= self.buckets[-1]:
            return _bucket_for(total, self.buckets)
        # beyond the configured buckets: the next power of two
        return 1 << (int(total) - 1).bit_length()

    def _run_batch(self, jobs: List[_ActJob]) -> None:
        with self._params_lock:
            params, version, init_row = self._params, self._version, self._init_row
        core = self.core
        if params is None or core is None:
            # workers gate on learning_starts before the first publication,
            # so this is a protocol violation, not a routine state
            for job in jobs:
                self._finish(job, {"req_id": int(job.req.get("req_id", 0)),
                                   "error": "act service has no published params yet"}, error=True)
            return
        t0_wall = time.time()
        t0 = time.monotonic()
        ns = [int(job.req["n"]) for job in jobs]
        total = sum(ns)
        bucket = self._bucket(total)
        try:
            obs = pad_rows(stack_rows([job.req["obs"] for job in jobs]), total, bucket)
            noise = pad_rows(stack_rows([job.req["noise"] for job in jobs]), total, bucket)
            state = None
            if core.stateful:
                rows: List[Any] = []
                for job, n in zip(jobs, ns):
                    wid = int(job.req["worker_id"])
                    reset = job.req.get("reset")
                    for slot in range(n):
                        row = None
                        if reset is None or not bool(np.asarray(reset).reshape(-1)[slot]):
                            row = self.sessions.get(f"{wid}/{slot}")
                        rows.append(row if row is not None else init_row)
                rows.extend([init_row] * (bucket - total))
                state = stack_rows(rows)
            mask = None
            if jobs[0].req.get("mask") is not None:
                mask = stack_rows([job.req["mask"] for job in jobs])
                if bucket > total:
                    # padded mask rows repeat row 0 — their outputs are
                    # discarded, but the mask tree must keep the batch width
                    mask = tree_map(lambda x: np.concatenate([np.asarray(x)] + [np.asarray(x)[:1]] *
                                                             (bucket - total), axis=0), mask)
            with self._act_lock, self._on_stream():
                args = (obs, to_device(noise, self.device),
                        to_device(state, self.device) if state is not None else None, mask)
                actions, actions_cat, new_state = self._call(params, "act", *args)
                actions_np = actions.cpu().numpy()[:total]
                cat_np = actions_cat.cpu().numpy()[:total] if actions_cat is not None else None
                host_state = to_host(new_state) if new_state is not None else None
                if self._stream is not None:
                    self._stream.synchronize()
        except BaseException as e:  # one bad request must not kill the learner
            for job in jobs:
                self._finish(job, {"req_id": int(job.req.get("req_id", 0)), "error": repr(e)}, error=True)
            return
        dt = time.monotonic() - t0
        self.stats.record_batch(total, bucket, dt)
        t1_wall = time.time()
        off = 0
        for job, n in zip(jobs, ns):
            if host_state is not None:
                wid = int(job.req["worker_id"])
                for slot in range(n):
                    i = off + slot
                    self.sessions.put(f"{wid}/{slot}", tuple(x[i:i + 1] for x in host_state))
            resp: Dict[str, Any] = {
                "req_id": int(job.req.get("req_id", 0)),
                "version": int(version),
                "actions": actions_np[off:off + n],
            }
            if cat_np is not None:
                resp["actions_cat"] = cat_np[off:off + n]
            self._finish(job, resp)
            self._emit_span(job, t0_wall, t1_wall, n, bucket, version)
            off += n

    def _finish(self, job: _ActJob, resp: Dict[str, Any], error: bool = False) -> None:
        ident = (int(job.req.get("worker_id", -1)), int(job.req.get("incarnation", 0)))
        rid = int(job.req.get("req_id", 0))
        with self._cv:
            self._inflight.discard(ident + (rid,))
            if not error:
                self._done[ident] = (rid, resp)
        self.stats.record_done(time.monotonic() - job.t_submit, error=error)
        try:
            job.reply(resp)
        except Exception:
            pass  # a dying link's reply: the worker's retry hits the cache

    def _emit_span(self, job: _ActJob, t0: float, t1: float, n: int, bucket: int, version: int) -> None:
        """One `act_infer` span per request, joining the trace the worker's
        `act_submit` span opened."""
        if not self.trace or self.telem is None:
            return
        tr = job.req.get("trace") or ("", "")
        if not tr or not tr[0]:
            return
        from ..telemetry import tracing

        try:
            self.telem.emit(
                tracing.span_record(
                    "act_infer",
                    "learner",
                    tracing.TraceContext(str(tr[0]), tracing.new_span_id(), str(tr[1])),
                    t0,
                    t1,
                    worker=int(job.req.get("worker_id", -1)),
                    version=int(version),
                    detail=f"rows={n} bucket={bucket}",
                )
            )
        except Exception:
            pass

    # -- telemetry ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The ``act_*`` fields the engine merges into its `fleet` interval
        record."""
        s = self.stats.snapshot()
        return {
            "act_requests": int(s["requests"]),
            "act_batches": int(s["batches"]),
            "act_occupancy": float(s["batch_occupancy"]),
            "act_pad_waste": float(s.get("pad_waste", 0.0)),
            "act_sessions": len(self.sessions),
            "act_version": self.version,
        }
