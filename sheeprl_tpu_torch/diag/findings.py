"""Flight-recorder analysis, part 2: rule-based detectors → ranked Findings.

Each detector reads the reconstructed :class:`~sheeprl_tpu_torch.diag.timeline.Timeline`
and emits zero or more :class:`Finding`s — a diagnosis with a severity, the
evidence that triggered it, and a concrete remediation hint. The rules are
deliberately simple threshold checks over the derived series; they encode
the triage the humans on this repo have been doing by hand over raw JSONL
(retrace storms, overlap queue starvation, checkpoint write spikes,
within-run throughput/MFU decay, watchdog and preemption incidents).

Thresholds come from ``configs/diag/default.yaml`` so a fleet can tune them
without code changes; every detector works with the defaults when no config
is supplied.

The port's copy of ``sheeprl_tpu/diag/findings.py`` (it imports neither package):
the detectors, thresholds, codes, severities and ranking are the JAX
package's; only remediation text that named JAX machinery names the
port's instead.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .timeline import Timeline

__all__ = ["Finding", "run_detectors", "DETECTORS", "SEVERITY_ORDER"]

SEVERITY_ORDER = {"critical": 0, "warning": 1, "info": 2}


@dataclass
class Finding:
    """One diagnosis: what happened, the evidence, and what to do about it."""

    code: str
    severity: str  # critical | warning | info
    title: str
    detail: str
    remediation: str
    step_first: int = 0
    step_last: int = 0
    data: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "code": self.code,
            "severity": self.severity,
            "title": self.title,
            "detail": self.detail,
            "remediation": self.remediation,
            "step_first": int(self.step_first),
            "step_last": int(self.step_last),
            "data": self.data,
        }


def _sel(cfg: Any, path: str, default: Any) -> Any:
    if cfg is None:
        return default
    if hasattr(cfg, "select"):
        val = cfg.select(path, default)
        return default if val is None else val
    node: Any = cfg
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return default if node is None else node


# -- detectors ---------------------------------------------------------------
def detect_retrace_storm(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Recompiles after warmup: each one stalls the device for seconds and a
    storm (every step a new shape) can silently 10x a run's wall clock. The
    RetraceDetector's shape-change attribution names the function and the
    exact arg that changed shape/dtype — surface it verbatim."""
    min_retraces = int(_sel(cfg, "diag.retrace.min_retraces", 4))
    total = tl.total_retraces()
    if total < min_retraces:
        return []
    steps = [s for s, r, _ in tl.retrace_intervals() if r > 0]
    attribution = tl.retrace_attribution()
    attr_note = "; ".join(attribution[:3]) if attribution else "no attribution captured"
    return [
        Finding(
            code="retrace_storm",
            severity="critical",
            title=f"retrace storm: {total} retraces after warmup",
            detail=(
                f"{total} XLA retraces accumulated across the run "
                f"(first at step {steps[0] if steps else 0}). "
                f"Attribution: {attr_note}"
            ),
            remediation=(
                "A changing input shape/dtype rebuilds what was sized for the old one "
                "(the device ring, the staged feed's buffers, the LN-GRU kernels' launch "
                "layout) every time. Pad or bucket the offending argument to a fixed "
                "shape (see the attribution above for which one moved) and re-check "
                "with the `device` counters of the log records (kernel builds)."
            ),
            step_first=steps[0] if steps else 0,
            step_last=steps[-1] if steps else 0,
            data={"retraces": total, "attribution": attribution[:10]},
        )
    ]


def detect_overlap_starvation(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Player stall fraction high-water: the env thread spends its interval
    parked on a full queue or the staleness gate — the learner is the
    bottleneck and the overlap win is gone."""
    threshold = float(_sel(cfg, "diag.overlap.stall_frac", 0.5))
    min_events = int(_sel(cfg, "diag.overlap.min_events", 2))
    stalls = tl.overlap_stalls()
    hot = [(s, f) for s, f in stalls if f >= threshold]
    if len(hot) < min_events:
        return []
    high_step, high = max(hot, key=lambda x: x[1])
    return [
        Finding(
            code="overlap_starvation",
            severity="warning",
            title=(
                f"overlap queue starvation: player stalled {high:.0%} of an interval "
                f"({len(hot)}/{len(stalls)} intervals over {threshold:.0%})"
            ),
            detail=(
                f"player_stall_frac high-water {high:.3f} at step {high_step}; the player "
                f"spent most of those intervals blocked on the bounded queue / staleness "
                "gate instead of stepping envs."
            ),
            remediation=(
                "The learner can't keep up with collection. Raise "
                "`algo.overlap.queue_depth` (more buffering) or "
                "`algo.overlap.staleness_bound` (if the algorithm tolerates staler "
                "params), shrink the per-burst train cost (batch size, replay ratio), "
                "or accept that the device is the bottleneck — check Time/train_time "
                "vs Time/env_interaction_time spans in the same intervals."
            ),
            step_first=hot[0][0],
            step_last=hot[-1][0],
            data={"stall_frac_max": high, "intervals_over_threshold": len(hot), "intervals": len(stalls)},
        )
    ]


def detect_ckpt_spikes(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Checkpoint saves blocking the train thread: block_ms is the part the
    step loop actually pays (device→host snapshot with the async writer, the
    whole durable write when sync)."""
    threshold_ms = float(_sel(cfg, "diag.ckpt.block_ms", 1000.0))
    blocks = tl.ckpt_blocks()
    hot = [(s, b) for s, b in blocks if b >= threshold_ms]
    if not hot:
        return []
    worst_step, worst = max(hot, key=lambda x: x[1])
    modes = {rec.get("mode") for rec in tl.of("ckpt_async") if rec.get("mode")}
    sync_note = " Writes ran SYNCHRONOUSLY (mode=sync)." if modes == {"sync"} else ""
    return [
        Finding(
            code="ckpt_spike",
            severity="warning",
            title=f"checkpoint writes block the train thread ({worst:.0f} ms worst)",
            detail=(
                f"{len(hot)}/{len(blocks)} checkpoint saves blocked the train thread for "
                f">= {threshold_ms:.0f} ms (worst {worst:.0f} ms at step {worst_step})."
                + sync_note
            ),
            remediation=(
                "Enable the async writer (`resilience.async_checkpoint.enabled=True`) so "
                "the loop only pays the device→host snapshot; for big replay buffers turn "
                "on `buffer.memmap_fast_resume=True` (checkpoints reference the memmap "
                "instead of copying it); raise `checkpoint.every` if the cadence itself "
                "is too hot."
            ),
            step_first=hot[0][0],
            step_last=hot[-1][0],
            data={"block_ms_max": worst, "saves_over_threshold": len(hot), "saves": len(blocks)},
        )
    ]


def detect_throughput_degradation(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Within-run decay of steady-state SPS (and MFU): compare the early
    steady window against the latest window, after dropping the first
    interval (compile + warmup). A slow leak here is how fragmenting hosts,
    growing buffers and creeping retraces show up before anything crashes."""
    drop_frac = float(_sel(cfg, "diag.throughput.drop_frac", 0.2))
    min_intervals = int(_sel(cfg, "diag.throughput.min_intervals", 4))
    out: List[Finding] = []
    for name, series, unit in (
        ("sps", tl.sps_series(), "steps/s"),
        ("mfu", tl.mfu_series(), ""),
    ):
        if len(series) < min_intervals + 1:
            continue
        steady = series[1:]  # drop the compile/warmup interval
        window = max(1, len(steady) // 4)
        early = sorted(v for _, v in steady[:window])[len(steady[:window]) // 2]
        late_vals = sorted(v for _, v in steady[-window:])
        late = late_vals[len(late_vals) // 2]
        if early <= 0 or late >= early * (1.0 - drop_frac):
            continue
        drop = 1.0 - late / early
        out.append(
            Finding(
                code=f"{name}_degradation",
                severity="warning",
                title=f"steady-state {name.upper()} degraded {drop:.0%} within the run",
                detail=(
                    f"median {name} fell from {early:.4g}{unit and ' ' + unit} (early steady window) "
                    f"to {late:.4g}{unit and ' ' + unit} (final window) — a {drop:.0%} in-run decay, "
                    f"over threshold {drop_frac:.0%}."
                ),
                remediation=(
                    "Check the same intervals for rising kernel builds (device counters), rising "
                    "Memory/bytes_in_use (fragmentation / buffer growth), ckpt_async "
                    "block_ms spikes, and overlap player_stall_frac. If none move, the "
                    "envs themselves are slowing down (episode length drift, host "
                    "contention) — profile one window with metric.telemetry.trace_every."
                ),
                step_first=steady[0][0],
                step_last=steady[-1][0],
                data={"early": early, "late": late, "drop_frac": drop},
            )
        )
    return out


def detect_watchdog_incidents(tl: Timeline, cfg: Any = None) -> List[Finding]:
    incidents = tl.watchdog_incidents()
    if not incidents:
        return []
    escalated = [rec for rec in tl.of("watchdog") if rec.get("action") == "preempt"]
    traces = [rec.get("trace_dir") for rec in incidents if rec.get("trace_dir")]
    worst = max(float(rec.get("stalled_s") or 0.0) for rec in incidents)
    return [
        Finding(
            code="watchdog_stall",
            severity="critical" if escalated else "warning",
            title=(
                f"{len(incidents)} watchdog stall incident(s), worst {worst:.0f}s without progress"
                + (" — escalated to preemption" if escalated else "")
            ),
            detail=(
                f"The heartbeat watchdog fired {len(incidents)} time(s); per-incident "
                f"profiler traces: {traces if traces else 'none captured'}."
            ),
            remediation=(
                "Read the per-incident trace dir(s) with `sheeprl_tpu_torch prof "
                "capture=<dir>` (or open trace.json in Perfetto) to see whether the stall "
                "is device-bound (a wedged collective / remote link) or host-bound (an "
                "env hang). `resilience.watchdog.action=preempt` converts future stalls "
                "into checkpoint-and-exit so the supervisor can restart the run."
            ),
            step_first=min(int(rec.get("step") or 0) for rec in incidents),
            step_last=max(int(rec.get("step") or 0) for rec in incidents),
            data={"incidents": len(incidents), "trace_dirs": traces, "escalated": bool(escalated)},
        )
    ]


def detect_preemption(tl: Timeline, cfg: Any = None) -> List[Finding]:
    events = tl.preempt_events()
    requested = [rec for rec in events if rec.get("action") == "requested"]
    if not requested:
        return []
    checkpointed = [rec for rec in events if rec.get("action") == "checkpointed"]
    timed_out = [rec for rec in events if rec.get("action") == "flush_timeout"]
    signal = requested[0].get("signal") or "signal"
    step = int(requested[0].get("step") or 0)
    if timed_out:
        sev, outcome = "critical", "the final checkpoint flush TIMED OUT inside the grace budget"
    elif checkpointed:
        sev, outcome = "info", f"drained cleanly with a final checkpoint at step {int(checkpointed[-1].get('step') or 0)}"
    else:
        sev, outcome = "warning", "no final checkpoint event was recorded before the stream ended"
    return [
        Finding(
            code="preemption",
            severity=sev,
            title=f"run preempted ({signal}) at step {step}: {outcome}",
            detail=(
                f"Cooperative preemption requested at step {step} "
                f"(grace_s={requested[0].get('grace_s')}); {outcome}."
            ),
            remediation=(
                "Resume with `sheeprl_tpu_torch resume run_dir=<this run's version_N dir>` — "
                "the manifest points at the newest complete checkpoint. If the flush "
                "timed out, raise `resilience.preemption.grace_s` or shrink the "
                "checkpoint payload (`buffer.memmap_fast_resume=True`)."
            ),
            step_first=step,
            step_last=max(int(rec.get("step") or 0) for rec in events),
            data={
                "signal": signal,
                "checkpointed": bool(checkpointed),
                "flush_timeout": bool(timed_out),
            },
        )
    ]


def detect_worker_flap(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Fleet workers dying and respawning repeatedly: each respawn costs a
    full process spawn (interpreter + torch import + env construction) and a
    round-merge stall — a flapping worker quietly taxes every round even
    when the run 'succeeds'."""
    min_faults = int(_sel(cfg, "diag.fleet.min_faults", 2))
    faults = [
        rec for rec in tl.of("fleet") if rec.get("action") in ("crash", "hang", "torn_packet")
    ]
    if len(faults) < min_faults:
        return []
    per_worker: Dict[Any, int] = {}
    for rec in faults:
        per_worker[rec.get("worker")] = per_worker.get(rec.get("worker"), 0) + 1
    worst_worker, worst = max(per_worker.items(), key=lambda kv: kv[1])
    kinds = {rec.get("action") for rec in faults}
    chaos = bool(tl.of("chaos"))
    chaos_note = " (a chaos schedule was active — injected faults look identical by design)" if chaos else ""
    return [
        Finding(
            code="worker_flap",
            severity="warning",
            title=(
                f"fleet worker flap: {len(faults)} fault(s) across "
                f"{len(per_worker)} worker(s) ({', '.join(sorted(kinds))})"
            ),
            detail=(
                f"Worst offender: worker {worst_worker} with {worst} fault(s). Each fault "
                f"costs a respawn (process + backend startup) and delays its rounds."
                + chaos_note
            ),
            remediation=(
                "Check the worker's stderr for the crash traceback (the learner log "
                "carries `[fleet] worker N fault: ...` lines). A flaky env suite wants "
                "`env.restart_on_exception=True` inside the worker; raise "
                "`fleet.hang_s` if slow env resets are being mistaken for hangs; "
                "`fleet.max_fails`/`fleet.fail_window_s` tune when flap becomes "
                "quarantine."
            ),
            step_first=min(int(rec.get("step") or 0) for rec in faults),
            step_last=max(int(rec.get("step") or 0) for rec in faults),
            data={"faults": len(faults), "per_worker": {str(k): v for k, v in per_worker.items()}},
        )
    ]


def detect_link_flap(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Socket-transport reconnect storms (`net` events): each reconnect is a
    full link cycle — HELLO, replay of unacked frames, dedup work — and a
    worker reconnecting in a loop stalls its rounds exactly like a flapping
    process. Windowed by wall clock: ``flap_min`` reconnects by one worker
    inside ``flap_window_s`` fires the finding, naming the worker and the
    backoff knob."""
    flap_min = int(_sel(cfg, "diag.net.flap_min", 3))
    window_s = float(_sel(cfg, "diag.net.flap_window_s", 60.0))
    by_worker: Dict[Any, List[float]] = {}
    for rec in tl.of("net"):
        if rec.get("action") != "reconnect":
            continue
        by_worker.setdefault(rec.get("worker"), []).append(float(rec.get("t") or 0.0))
    flapping: Dict[Any, int] = {}
    for worker, times in by_worker.items():
        times.sort()
        best = 0
        lo = 0
        for hi in range(len(times)):
            while times[hi] - times[lo] > window_s:
                lo += 1
            best = max(best, hi - lo + 1)
        if best >= flap_min:
            flapping[worker] = best
    if not flapping:
        return []
    worst_worker, worst = max(flapping.items(), key=lambda kv: kv[1])
    total = sum(len(v) for v in by_worker.values())
    return [
        Finding(
            code="link_flap",
            severity="warning",
            title=(
                f"fleet link flap: worker {worst_worker} reconnected {worst} time(s) "
                f"inside {window_s:.0f}s"
            ),
            detail=(
                f"{total} reconnect(s) across {len(by_worker)} worker(s); each one "
                "replays every unacked frame through learner-side dedup and stalls "
                "that worker's rounds for the backoff + handshake. A storm usually "
                "means an unstable route or a peer dropping the link under load, "
                "not a worker problem."
            ),
            remediation=(
                "Check the worker-side stream for the disconnect reasons (`net` "
                "disconnect events carry them). Raise `fleet.net.backoff_s` / "
                "`fleet.net.max_backoff_s` to calm the retry storm, "
                "`fleet.net.reconnect_grace_s` if the supervisor is converting "
                "recoverable outages into disconnect faults, and "
                "`fleet.net.stall_reconnect_s` if healthy-but-slow links are being "
                "cycled as half-open."
            ),
            data={
                "reconnects": total,
                "per_worker": {str(k): len(v) for k, v in by_worker.items()},
                "worst_worker": worst_worker if worst_worker is None else int(worst_worker),
                "window_s": window_s,
            },
        )
    ]


def detect_fleet_degraded(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Intervals where fewer workers were alive than configured: the run kept
    going (that is the point of the supervision tree) but collected env
    steps slower than provisioned."""
    min_intervals = int(_sel(cfg, "diag.fleet.degraded_min_intervals", 1))
    evs = list(tl.of("fleet"))
    # the post-drain snapshot always reads alive=0 (every worker was just
    # stopped) — shutdown is not degradation, so only intervals BEFORE the
    # drain count. Conversely the engine force-emits an interval the moment
    # a fault lands, so degraded intervals are a precise signal: a healthy
    # run records none at all.
    drain_at = next(
        (i for i, rec in enumerate(evs) if rec.get("action") == "drain"), len(evs)
    )
    intervals = [rec for rec in evs[:drain_at] if rec.get("action") == "interval"]
    degraded = [
        rec
        for rec in intervals
        if (rec.get("workers") or 0) > 0 and (rec.get("alive") or 0) < rec.get("workers")
    ]
    if len(degraded) < min_intervals:
        return []
    worst = min(int(rec.get("alive") or 0) for rec in degraded)
    workers = int(degraded[0].get("workers") or 0)
    return [
        Finding(
            code="fleet_degraded",
            severity="warning",
            title=(
                f"fleet ran degraded for {len(degraded)}/{len(intervals)} interval(s) "
                f"(low-water {worst}/{workers} workers alive)"
            ),
            detail=(
                f"Alive-worker count dropped below the configured {workers} in "
                f"{len(degraded)} telemetry interval(s); env-step throughput scales "
                "with the alive count, so those intervals collected proportionally "
                "fewer steps."
            ),
            remediation=(
                "Correlate with the crash/hang/respawn incidents in the same step "
                "range (worker_flap finding). If degradation is chronic rather than "
                "a blip, shrink `fleet.backoff_s` (faster respawn) or fix the "
                "underlying env instability."
            ),
            step_first=int(degraded[0].get("step") or 0),
            step_last=int(degraded[-1].get("step") or 0),
            data={"degraded_intervals": len(degraded), "intervals": len(intervals), "low_water": worst},
        )
    ]


def detect_quarantine(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """A quarantined worker is a permanent capacity loss AND a data-shape
    change (its env slice stopped contributing) — always worth a human
    look, hence critical."""
    events = [rec for rec in tl.of("fleet") if rec.get("action") == "quarantine"]
    if not events:
        return []
    workers = sorted({rec.get("worker") for rec in events})
    return [
        Finding(
            code="quarantine",
            severity="critical",
            title=f"{len(workers)} fleet worker(s) QUARANTINED: {workers}",
            detail=(
                f"Worker(s) {workers} exhausted the fail budget "
                f"({events[0].get('detail', '')}) and were permanently excluded. The "
                "run continued degraded on the surviving slice (fixed-width replay "
                "layouts backfill the missing columns by duplicating survivors; "
                "per-env layouts stop growing those columns)."
            ),
            remediation=(
                "The env slice is likely poisoned (bad seed, corrupt asset, leaking "
                "external process). Reproduce with the worker's column seeds, or "
                "raise `fleet.max_fails` if the faults were transient infra. Resume "
                "restores the full fleet: `sheeprl_tpu_torch resume run_dir=...`."
            ),
            step_first=min(int(rec.get("step") or 0) for rec in events),
            step_last=max(int(rec.get("step") or 0) for rec in events),
            data={"workers": [int(w) for w in workers if w is not None]},
        )
    ]


def detect_replica_flap(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Serving replicas dying or hanging behind the gateway. Unlike fleet
    env workers (where flap needs repetition to matter), a single replica
    fault forces live sessions to migrate through the broker and costs a
    full respawn (interpreter + torch + warmup) of serving capacity — so the
    default threshold is ONE fault."""
    min_faults = int(_sel(cfg, "diag.gateway.min_faults", 1))
    faults = [rec for rec in tl.of("replica") if rec.get("action") in ("crash", "hang")]
    if len(faults) < min_faults:
        return []
    per_replica: Dict[Any, int] = {}
    for rec in faults:
        per_replica[rec.get("replica")] = per_replica.get(rec.get("replica"), 0) + 1
    worst_replica, worst = max(per_replica.items(), key=lambda kv: kv[1])
    kinds = {rec.get("action") for rec in faults}
    quarantined = sorted(
        {rec.get("replica") for rec in tl.of("replica") if rec.get("action") == "quarantine"}
    )
    gw = tl.of("gateway")
    failovers = int(gw[-1].get("failovers") or 0) if gw else 0
    migrations = int(gw[-1].get("migrations") or 0) if gw else 0
    return [
        Finding(
            code="replica_flap",
            severity="critical" if quarantined else "warning",
            title=(
                f"serving replica flap: {len(faults)} fault(s) across "
                f"{len(per_replica)} replica(s) ({', '.join(sorted(kinds))})"
                + (f"; {quarantined} QUARANTINED" if quarantined else "")
            ),
            detail=(
                f"Worst offender: replica {worst_replica} with {worst} fault(s). "
                f"The gateway absorbed {failovers} failover(s) and migrated "
                f"{migrations} session(s) through the broker; each respawn costs "
                "a full process + warmup before the slot serves again."
            ),
            remediation=(
                "Check the replica's stderr for the crash traceback (the gateway "
                "log carries `[gateway] replica N fault: ...` lines). Raise "
                "`gateway.supervisor.hang_s` if slow checkpoint reloads are being "
                "mistaken for hangs; `gateway.supervisor.max_fails`/`fail_window_s` "
                "tune when flap becomes quarantine. Quarantined slots need a "
                "gateway restart after the underlying cause is fixed."
            ),
            data={
                "faults": len(faults),
                "per_replica": {str(k): v for k, v in per_replica.items()},
                "quarantined": [int(q) for q in quarantined if q is not None],
                "failovers": failovers,
                "migrations": migrations,
            },
        )
    ]


def detect_broker_failover(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """A session-broker standby promoted itself: the primary's lease
    expired (SIGKILL, partition, or a zombie that stopped heartbeating).
    The system surviving is the design working — but every promotion is a
    real outage window (writes shed until the standby took over) and any
    fenced zombie writes deserve a human look, so it always surfaces."""
    promotes = [rec for rec in tl.of("broker") if rec.get("action") == "promote"]
    if not promotes:
        return []
    fenced = [rec for rec in tl.of("broker") if rec.get("action") == "fenced"]
    demotes = [rec for rec in tl.of("broker") if rec.get("action") == "demote"]
    sync_failed = [rec for rec in tl.of("broker") if rec.get("action") == "sync_failed"]
    worst_s = max(float(rec.get("promotion_s") or 0.0) for rec in promotes)
    epochs = sorted(int(rec.get("epoch") or 0) for rec in promotes)
    return [
        Finding(
            code="broker_failover",
            # always a warning: a promotion is the design working, and the
            # stream's sync_failed events are recoverable resyncs (the
            # standby bootstraps fresh), not proof of durability loss —
            # they're surfaced in the data/detail for the human to weigh
            severity="warning",
            title=(
                f"session-broker failover: {len(promotes)} standby promotion(s) "
                f"(worst took {worst_s:.2f}s past the last heartbeat)"
                + (f"; {len(fenced)} zombie write(s) FENCED" if fenced else "")
            ),
            detail=(
                f"Promotion epoch(s) {epochs}; {len(fenced)} lower-epoch replication "
                f"push(es) rejected by the fencing token and {len(demotes)} node(s) "
                f"demoted. Writes issued during the promotion window were shed "
                f"(503 broker_unavailable) and replayed idempotently — acked state "
                f"never regressed."
                + (
                    f" {len(sync_failed)} replication resync(s) occurred (a standby "
                    "restarted its tail via bootstrap) — check broker_lag if frequent."
                    if sync_failed
                    else ""
                )
            ),
            remediation=(
                "Check why the primary's lease expired (its stderr, OOM-kill, "
                "network partition). Start a NEW standby against the promoted "
                "primary (`sheeprl_tpu_torch brokerd gateway.broker.role=standby "
                "gateway.broker.peer=<promoted host:port>`) — a promoted standby "
                "runs un-replicated until one attaches. Tune "
                "`gateway.broker.lease_s` if promotions fire on healthy-but-slow "
                "heartbeats."
            ),
            data={
                "promotions": len(promotes),
                "promotion_s_worst": round(worst_s, 3),
                "epochs": epochs,
                "fenced_writes": len(fenced),
                "demotes": len(demotes),
                "sync_failed": len(sync_failed),
            },
        )
    ]


def detect_broker_lag(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Broker durability/replication falling behind the serving plane: the
    replication-lag high-water, the sync-ack wait p95 or the WAL fsync p95
    crossing its threshold. Each acked PUT pays these on the request path,
    so a slow broker IS gateway latency (and, past the op deadline, shed
    traffic)."""
    lag_records = int(_sel(cfg, "diag.broker.lag_records", 64))
    wait_ms = float(_sel(cfg, "diag.broker.repl_wait_p95_ms", 250.0))
    fsync_ms = float(_sel(cfg, "diag.broker.fsync_p95_ms", 50.0))
    intervals = [rec for rec in tl.of("broker") if rec.get("action") == "interval"]
    if not intervals:
        return []
    lag_high = max(int(rec.get("lag") or 0) for rec in intervals)
    wait_high = max(float(rec.get("repl_wait_p95_ms") or 0.0) for rec in intervals)
    fsync_high = max(float(rec.get("fsync_p95_ms") or 0.0) for rec in intervals)
    over = []
    if lag_high >= lag_records:
        over.append(f"replication lag high-water {lag_high} records (>= {lag_records})")
    if wait_high >= wait_ms:
        over.append(f"sync-ack wait p95 {wait_high:.0f} ms (>= {wait_ms:.0f})")
    if fsync_high >= fsync_ms:
        over.append(f"WAL fsync p95 {fsync_high:.1f} ms (>= {fsync_ms:.0f})")
    if not over:
        return []
    return [
        Finding(
            code="broker_lag",
            severity="warning",
            title=f"session-broker lag: {over[0]}" + (f" (+{len(over) - 1} more)" if len(over) > 1 else ""),
            detail=(
                "; ".join(over)
                + ". Every acked PUT waits for durability (and, with sync "
                "replication, the standby's ack) on the request path."
            ),
            remediation=(
                "A slow standby link wants a closer standby or "
                "`gateway.broker.sync_replication=False` (accepting the "
                "acked-loss window a SIGKILLed primary then has). High fsync "
                "p95 wants `gateway.broker.durability=wal` (SIGKILL-safe, not "
                "power-loss-safe) or faster disks. Past the op deadline the "
                "gateway sheds with `broker_unavailable` — check that counter "
                "in the gateway stats."
            ),
            data={
                "lag_high": lag_high,
                "repl_wait_p95_ms_high": round(wait_high, 3),
                "fsync_p95_ms_high": round(fsync_high, 3),
                "intervals": len(intervals),
            },
        )
    ]


def detect_gateway_shedding(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Sustained admission-control shedding: occasional sheds are the system
    working as designed; a high shed fraction means the fleet is
    under-provisioned for the offered load."""
    shed_frac = float(_sel(cfg, "diag.gateway.shed_frac", 0.05))
    snaps = tl.of("gateway")
    if not snaps:
        return []
    last = snaps[-1]
    requests = float(last.get("requests") or 0)
    shed = float(last.get("admission_shed") or 0)
    if requests <= 0 or shed / requests < shed_frac:
        return []
    frac = shed / requests
    shed_low = float(last.get("admission_shed_low") or 0)
    return [
        Finding(
            code="gateway_shedding",
            severity="warning",
            title=f"gateway shed {frac:.1%} of traffic ({int(shed)}/{int(requests)} requests)",
            detail=(
                f"Admission control rejected {int(shed)} request(s) "
                f"({int(shed_low)} low-priority) with jittered Retry-After; "
                f"p95 latency of admitted traffic: {last.get('p95_ms', 'n/a')} ms."
            ),
            remediation=(
                "Add replicas (`gateway.replicas`) or raise "
                "`gateway.admission.max_inflight`/`rate_per_s` if the replicas "
                "have headroom (check their /stats batch occupancy). If only "
                "low-priority traffic is shed, the system is protecting "
                "interactive sessions as configured — consider scheduling eval "
                "sweeps off-peak instead."
            ),
            data={
                "shed": int(shed),
                "shed_low": int(shed_low),
                "requests": int(requests),
                "shed_frac": round(frac, 4),
            },
        )
    ]


def detect_cross_process_stall(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Cross-process critical paths dominated by WAIT stages (queue /
    admission / routing) rather than work: the multi-process analogue of
    overlap_starvation. Built on the merged `trace_span` events — the same
    joins `sheeprl_tpu_torch trace` reports — so the finding names the exact
    stage (a fleet worker parked on a full data queue, a request stuck in
    the replica batcher queue) and where to look next."""
    from .trace import WAIT_STAGES, _trace_kind, build_traces

    stall_frac = float(_sel(cfg, "diag.trace.stall_frac", 0.5))
    min_traces = int(_sel(cfg, "diag.trace.min_traces", 8))
    min_stall_ms = float(_sel(cfg, "diag.trace.min_stall_ms", 1.0))
    # the same grouping `sheeprl_tpu_torch trace` reports on — the two surfaces
    # must agree on what a path is
    by_trace = build_traces(tl.of("trace_span"))
    considered = 0
    stalled = 0
    wait_totals: Dict[str, float] = {}
    for spans in by_trace.values():
        if len(spans) < 2:
            continue  # single-sided: no cross-process path to attribute
        if _trace_kind(spans) not in ("round", "request"):
            # publication (publish/param_apply) and other non-path traces
            # must not dilute the majority test below
            continue
        total = sum(float(s.get("dur_ms") or 0.0) for s in spans)
        wait = sum(
            float(s.get("dur_ms") or 0.0) for s in spans if s.get("name") in WAIT_STAGES
        )
        if total <= 0:
            continue
        considered += 1
        if wait >= min_stall_ms and wait / total >= stall_frac:
            stalled += 1
            for s in spans:
                if s.get("name") in WAIT_STAGES:
                    key = f"{s.get('role')}/{s.get('name')}"
                    wait_totals[key] = wait_totals.get(key, 0.0) + float(s.get("dur_ms") or 0.0)
    if stalled < min_traces or considered == 0 or stalled / considered < 0.5:
        return []
    worst_stage, worst_ms = max(wait_totals.items(), key=lambda kv: kv[1])
    return [
        Finding(
            code="cross_process_stall",
            severity="warning",
            title=(
                f"cross-process stall: {stalled}/{considered} traced paths spend "
                f">= {stall_frac:.0%} of their time waiting (worst stage: {worst_stage})"
            ),
            detail=(
                f"Wait stages (queue/admission/routing) dominate the reconstructed "
                f"critical paths; '{worst_stage}' alone accounts for {worst_ms:.0f} ms "
                f"across the stalled traces. Run `sheeprl_tpu_torch trace run_dir=...` for "
                f"the per-stage p50/p95 table and the top slowest traces."
            ),
            remediation=(
                "worker/queue_wait dominating means the learner is the bottleneck "
                "(raise fleet.queue_depth, shrink the train burst, or add learner "
                "throughput); replica/batch_queue means the serving fleet is "
                "under-provisioned (add gateway.replicas or widen the batch "
                "buckets); gateway/admission means offered load exceeds admission "
                "limits (scale out or raise gateway.admission.*). Capture a device "
                "view of the slow side with POST /admin/profile (replicas) or the "
                "fleet profile ctrl op."
            ),
            data={
                "stalled": stalled,
                "considered": considered,
                "stall_frac": stall_frac,
                "wait_ms_by_stage": {k: round(v, 2) for k, v in sorted(wait_totals.items())},
            },
        )
    ]


def detect_act_service_starvation(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """The batched act service (fleet.act_mode=inference) is dispatching
    mostly-empty buckets while workers spend their time parked in
    ``act_submit``: the fleet is paying full batched-inference latency for
    a fraction of the batching win. The classic cause is a coalescing
    window too short for the fleet's arrival spread (requests trickle in
    one per flush) or buckets far wider than ``workers x envs_per_worker``
    rows ever fill."""
    min_occupancy = float(_sel(cfg, "diag.act.min_occupancy", 0.5))
    min_batches = int(_sel(cfg, "diag.act.min_batches", 20))
    intervals = [
        rec
        for rec in tl.of("fleet")
        if rec.get("action") == "interval" and rec.get("act_batches") is not None
    ]
    if not intervals:
        return []
    last = intervals[-1]
    batches = int(last.get("act_batches") or 0)
    occupancy = float(last.get("act_occupancy") or 0.0)
    if batches < min_batches or occupancy >= min_occupancy:
        return []
    # starvation needs BOTH sides: empty buckets service-side AND the wait
    # actually binding worker-side — act_submit the heaviest worker stage
    stage_ms: Dict[str, float] = {}
    for s in tl.of("trace_span"):
        if s.get("role") == "worker":
            name = str(s.get("name") or "")
            stage_ms[name] = stage_ms.get(name, 0.0) + float(s.get("dur_ms") or 0.0)
    submit_ms = stage_ms.get("act_submit", 0.0)
    if submit_ms <= 0 or any(
        v > submit_ms for k, v in stage_ms.items() if k != "act_submit"
    ):
        return []
    waste = float(last.get("act_pad_waste") or 0.0)
    steps = [int(rec.get("step") or 0) for rec in intervals]
    return [
        Finding(
            code="act_service_starvation",
            severity="warning",
            title=(
                f"act service starvation: bucket occupancy {occupancy:.0%} "
                f"(< {min_occupancy:.0%}) while act_submit is the workers' "
                f"binding stage"
            ),
            detail=(
                f"{batches} act batches dispatched at {occupancy:.0%} mean "
                f"occupancy (pad waste {waste:.0%}); worker-side act_submit "
                f"accounts for {submit_ms:.0f} ms of span time — more than any "
                f"other worker stage. Workers are waiting on an inference "
                f"service that is acting on mostly-padding buckets."
            ),
            remediation=(
                "Raise fleet.act.max_wait_ms so the coalescing window spans the "
                "fleet's request arrival spread (each worker ships envs_per_worker "
                "rows per slice), or shrink fleet.act.buckets toward "
                "workers x envs_per_worker so full buckets are reachable. High "
                "act_pad_waste with healthy occupancy instead means the bucket "
                "grid is too coarse — add intermediate bucket sizes."
            ),
            step_first=min(steps),
            step_last=max(steps),
            data={
                "occupancy": occupancy,
                "pad_waste": waste,
                "batches": batches,
                "act_submit_ms": round(submit_ms, 2),
                "worker_stage_ms": {k: round(v, 2) for k, v in sorted(stage_ms.items())},
            },
        )
    ]


def detect_flywheel_staleness(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """The data flywheel is falling behind: ingest passes whose FRESHEST
    sample lags the serving ``params_version`` by at least
    ``diag.flywheel.max_lag`` versions. Experience gathered that many
    policies ago is training the next policy — the loop's latency has grown
    past the staleness the fine-tune recipe was budgeted for (and past
    ``flywheel.max_version_lag`` the samples start being dropped outright)."""
    max_lag = int(_sel(cfg, "diag.flywheel.max_lag", 3))
    ingests = [rec for rec in tl.of("flywheel") if rec.get("action") == "ingest"]
    laggy = [rec for rec in ingests if int(rec.get("version_lag") or 0) >= max_lag]
    if not laggy:
        return []
    worst = max(int(rec.get("version_lag") or 0) for rec in laggy)
    dropped = sum(int(rec.get("dropped_stale") or 0) for rec in ingests)
    return [
        Finding(
            code="flywheel_staleness",
            severity="warning",
            title=(
                f"flywheel staleness: ingested samples lag the serving "
                f"params_version by up to {worst} version(s) (>= {max_lag})"
            ),
            detail=(
                f"{len(laggy)}/{len(ingests)} ingest pass(es) over the lag threshold; "
                f"{dropped} sample(s) dropped by the recipe's max_version_lag gate. "
                "The policy being fine-tuned is learning from experience produced "
                "that many reloads ago."
            ),
            remediation=(
                "Run `sheeprl_tpu_torch flywheel` more often (or continuously) so capture "
                "backlogs don't span multiple reloads; check that capture is enabled "
                "on every replica (`serve.capture.enabled`) and that ingestion isn't "
                "skipping segments (torn_lines in the ingest summary). Raising "
                "`flywheel.max_version_lag` admits staler samples instead of "
                "dropping them — a trade, not a fix."
            ),
            data={
                "worst_lag": worst,
                "laggy_ingests": len(laggy),
                "ingests": len(ingests),
                "dropped_stale": dropped,
            },
        )
    ]


def detect_replicated_giant(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """A multi-axis mesh is paying for chips it isn't using: the run's
    ``sharding`` events (parallel/sharding.py SpecEngine decisions) show a
    parameter/optimizer-state leaf above
    ``diag.sharding.max_replicated_bytes`` left FULLY replicated even though
    the mesh has an fsdp or tp axis to shard it over. Every chip holds the
    whole leaf — exactly the single-chip HBM ceiling the mesh exists to
    break. Names the leaf path and the rule that made the call (usually a
    divisibility fallback: an odd dimension no axis divides)."""
    max_bytes = int(_sel(cfg, "diag.sharding.max_replicated_bytes", 64 * 1024 * 1024))
    leaves = [rec for rec in tl.of("sharding") if rec.get("action") == "leaf"]
    giants = [
        rec
        for rec in leaves
        if rec.get("spec") == "replicated"
        and int(rec.get("bytes") or 0) >= max_bytes
        # only a mesh with a non-trivial fsdp/tp axis COULD have sharded it
        and int(rec.get("fsdp") or 1) * int(rec.get("tp") or 1) > 1
    ]
    if not giants:
        return []
    worst = max(giants, key=lambda rec: int(rec.get("bytes") or 0))
    named = ", ".join(
        f"{rec.get('path')} ({int(rec.get('bytes') or 0) / 2**20:.1f} MiB, rule "
        f"{rec.get('rule')!r}: {rec.get('reason')})"
        for rec in giants[:3]
    )
    return [
        Finding(
            code="replicated_giant",
            severity="warning",
            title=(
                f"{len(giants)} leaf(ves) over "
                f"{max_bytes / 2**20:.0f} MiB fully replicated on a multi-axis mesh"
            ),
            detail=(
                f"Worst: {worst.get('path')} — "
                f"{int(worst.get('bytes') or 0) / 2**20:.1f} MiB on EVERY chip "
                f"(mesh dp={worst.get('dp')} fsdp={worst.get('fsdp')} tp={worst.get('tp')}). "
                f"Affected: {named}."
            ),
            remediation=(
                "Check the quoted rule/reason: a divisibility fallback means no "
                "mesh axis divides the leaf's dimensions — pick fabric.mesh.fsdp/tp "
                "sizes that divide the model's widths, or pad the layer. A "
                "'shape-fallback ... under min_shard_size' reason on a giant leaf "
                "means fabric.mesh.min_shard_size is set too high. Add a SpecRule "
                "matching the path if the default rules misclassify it "
                "(parallel/sharding.py DEFAULT_PARAM_RULES)."
            ),
            data={
                "giants": [
                    {k: rec.get(k) for k in ("path", "bytes", "rule", "reason", "group")}
                    for rec in giants[:10]
                ],
                "max_replicated_bytes": max_bytes,
            },
        )
    ]


def detect_incomplete_stream(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """No shutdown event: the process died without closing telemetry — a
    crash, OOM-kill or external SIGKILL (a clean preemption still writes
    shutdown). Torn trailing lines corroborate."""
    if tl.shutdown is not None or tl.startup is None:
        return []
    return [
        Finding(
            code="no_shutdown",
            severity="warning",
            title="stream ends without a shutdown event (process died mid-run)",
            detail=(
                f"Last recorded step {tl.last_step}; {len(tl.parse_errors)} torn/unparseable "
                "line(s) at the tail of the stream."
                if tl.parse_errors
                else f"Last recorded step {tl.last_step}; the final lines are intact, so the "
                "process was killed between log intervals."
            ),
            remediation=(
                "Check the job scheduler / kernel logs for OOM-kill or SIGKILL. "
                "`sheeprl_tpu_torch resume run_dir=...` continues from the newest complete "
                "checkpoint; `resilience.supervisor.attempts>1` auto-restarts future runs."
            ),
            step_first=tl.last_step,
            step_last=tl.last_step,
            data={"parse_errors": tl.parse_errors[:5]},
        )
    ]


def detect_slo_alerts(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """SLO burn alerts the live aggregator raised DURING the run: the
    online plane (`diag.live.slo` rules evaluated over the sliding window)
    writes schema'd ``alert`` events onto the main stream exactly so the
    post-mortem finds them — a breach that fired live must not read as
    'the run looks fine' afterwards."""
    fired = [rec for rec in tl.of("alert") if rec.get("state") == "firing"]
    if not fired:
        return []
    by_rule: Dict[str, List[Dict[str, Any]]] = {}
    for rec in fired:
        by_rule.setdefault(str(rec.get("rule") or "rule"), []).append(rec)
    worst = (
        "critical"
        if any(rec.get("severity") == "critical" for rec in fired)
        else "warning"
    )
    parts = []
    for rule, recs in sorted(by_rule.items()):
        last = recs[-1]
        bound = last.get("threshold")
        parts.append(
            f"{rule}: {last.get('metric')} = {last.get('value')}"
            + (f" vs bound {bound}" if bound is not None else "")
            + (f" ({len(recs)}x)" if len(recs) > 1 else "")
        )
    steps = [int(rec.get("step") or 0) for rec in fired]
    return [
        Finding(
            code="slo_alert",
            severity=worst,
            title=f"{len(fired)} SLO burn alert(s) fired live across {len(by_rule)} rule(s)",
            detail="; ".join(parts),
            remediation=(
                "The live aggregator's burn-rate rules (diag.live.slo) breached "
                "during the run. Inspect the window around each firing with "
                "`sheeprl_tpu_torch trace run_dir=...`, then either fix the regression "
                "the rule caught or re-tune the rule's bound/burn_frac if the "
                "expectation changed."
            ),
            step_first=min(steps),
            step_last=max(steps),
            data={"rules": sorted(by_rule), "alerts": fired[:10]},
        )
    ]


def detect_hbm_pressure(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Device high-water within a whisker of the allocator limit: the run
    survived, but any growth (longer sequence bucket, one more replica,
    larger batch) tips it into OOM. The cadenced ``mem`` samples carry the
    allocator's own ``peak_bytes_in_use``/``bytes_limit``, so the check is a
    single ratio."""
    frac = float(_sel(cfg, "diag.mem.hbm_frac", 0.92))
    peak, limit = tl.hbm_high_water()
    if not limit or peak < frac * limit:
        return []
    used_pct = 100.0 * peak / limit
    return [
        Finding(
            code="hbm_pressure",
            severity="warning",
            title=f"HBM high-water at {used_pct:.1f}% of the allocator limit",
            detail=(
                f"Device memory peaked at {peak / 2**30:.2f} GiB of the "
                f"{limit / 2**30:.2f} GiB limit (threshold {frac:.0%}). The next "
                "shape bucket, batch bump or extra live buffer OOMs."
            ),
            remediation=(
                "Free headroom before it becomes an OOM: drop tensors the step "
                "keeps alive between calls (update the carried state in place), "
                "shrink the replay slice per fetch or the device ring "
                "(buffer.device_cache), or lower the precision of the params. "
                "`sheeprl_tpu_torch prof run_dir=...` shows which kernels "
                "dominate; the live-buffer census in the mem events shows what "
                "is pinned between steps."
            ),
            step_first=0,
            step_last=tl.last_step,
            data={"hbm_peak_bytes": peak, "hbm_bytes_limit": limit, "frac": round(peak / limit, 4)},
        )
    ]


def detect_host_mem_leak(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Sustained monotonic host-RSS growth: a python-side leak (unbounded
    replay list, cached compiles, spans never flushed) that kills week-long
    runs with a host OOM long after every device metric looks healthy.
    Fires when a role's RSS series spans long enough, grows past the floor,
    and rises in (nearly) every interval — a sawtooth from GC churn stays
    quiet."""
    window_s = float(_sel(cfg, "diag.mem.leak_window_s", 120.0))
    min_growth = float(_sel(cfg, "diag.mem.leak_min_growth_mb", 64.0)) * 2**20
    min_samples = int(_sel(cfg, "diag.mem.leak_min_samples", 6))
    rise_frac = float(_sel(cfg, "diag.mem.leak_rise_frac", 0.8))
    out: List[Finding] = []
    for role in tl.mem_roles() or ([None] if tl.of("mem") else []):
        series = tl.rss_series(role)
        if len(series) < min_samples:
            continue
        span_s = series[-1][0] - series[0][0]
        growth = series[-1][1] - series[0][1]
        if span_s < window_s or growth < min_growth:
            continue
        deltas = [b2 - b1 for (_, b1), (_, b2) in zip(series, series[1:])]
        rising = sum(1 for d in deltas if d > 0) / max(1, len(deltas))
        if rising < rise_frac:
            continue
        rate_mb_h = growth / 2**20 / (span_s / 3600.0)
        out.append(
            Finding(
                code="host_mem_leak",
                severity="warning",
                title=(
                    f"host RSS grows monotonically in role '{role or 'main'}': "
                    f"+{growth / 2**20:.0f} MiB over {span_s / 60:.0f} min"
                ),
                detail=(
                    f"{series[0][1] / 2**20:.0f} → {series[-1][1] / 2**20:.0f} MiB "
                    f"({rate_mb_h:.0f} MiB/h, rising in {rising:.0%} of "
                    f"{len(deltas)} sample intervals). At this rate the host "
                    "OOM-killer ends the run, not the training loop."
                ),
                remediation=(
                    "Look for unbounded python-side accumulation: replay/rollout "
                    "lists that only append, per-step metric dicts retained by a "
                    "logger, the CUDA caching allocator's pinned host pool growing "
                    "under changing shapes, or numpy copies of device tensors kept "
                    "alive. The live-buffer census in the mem events separates "
                    "device-array leaks from pure-python ones."
                ),
                step_first=0,
                step_last=tl.last_step,
                data={
                    "role": role or "main",
                    "growth_bytes": int(growth),
                    "span_s": round(span_s, 1),
                    "rate_mb_per_h": round(rate_mb_h, 1),
                    "samples": len(series),
                },
            )
        )
    return out


def detect_memory_bound(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Roofline verdict: a tracked jitted fn whose arithmetic intensity sits
    below the device's ridge point is bandwidth-bound — more FLOPS (bigger
    chip, more chips) will not speed it up; only fusing ops, reusing
    activations or casting dtypes down will. Informational: being memory-
    bound is a property of the program, not automatically a defect."""
    if not bool(_sel(cfg, "diag.roofline.enabled", True)):
        return []
    bound_fns = {
        name: rec
        for name, rec in tl.rooflines().items()
        if rec.get("bound") == "memory"
    }
    if not bound_fns:
        return []
    parts = []
    for name, rec in sorted(bound_fns.items()):
        note = f"{name}: {float(rec.get('intensity') or 0):.1f} flop/B"
        if rec.get("ridge_intensity") is not None:
            note += f" vs ridge {float(rec['ridge_intensity']):.0f}"
        if rec.get("attained_frac") is not None:
            note += f", attaining {float(rec['attained_frac']):.0%} of roof"
        parts.append(note)
    steps = [int(rec.get("step") or 0) for rec in bound_fns.values()]
    return [
        Finding(
            code="memory_bound",
            severity="info",
            title=(
                f"{len(bound_fns)} jitted fn(s) are memory-bandwidth-bound: "
                + ", ".join(sorted(bound_fns))
            ),
            detail="; ".join(parts),
            remediation=(
                "Raise arithmetic intensity rather than chasing FLOPS: fuse "
                "elementwise chains into the consuming kernel (the port's "
                "hand-written kernels are its fusion boundaries — check "
                "`sheeprl_tpu_torch prof` for the kernels between them), keep "
                "activations in bf16, and batch small "
                "per-step ops together. If the fn is inherently bandwidth-"
                "bound (optimizers, scatters), its attained fraction of the "
                "bandwidth roof is the number to optimize."
            ),
            step_first=min(steps) if steps else 0,
            step_last=max(steps) if steps else tl.last_step,
            data={
                name: {
                    k: rec.get(k)
                    for k in ("intensity", "ridge_intensity", "attained_frac", "bound", "device_kind")
                    if rec.get(k) is not None
                }
                for name, rec in bound_fns.items()
            },
        )
    ]


DETECTORS: List[Callable[[Timeline, Any], List[Finding]]] = [
    detect_retrace_storm,
    detect_overlap_starvation,
    detect_ckpt_spikes,
    detect_throughput_degradation,
    detect_watchdog_incidents,
    detect_preemption,
    detect_worker_flap,
    detect_link_flap,
    detect_fleet_degraded,
    detect_quarantine,
    detect_replica_flap,
    detect_broker_failover,
    detect_broker_lag,
    detect_gateway_shedding,
    detect_cross_process_stall,
    detect_act_service_starvation,
    detect_flywheel_staleness,
    detect_replicated_giant,
    detect_slo_alerts,
    detect_incomplete_stream,
    detect_hbm_pressure,
    detect_host_mem_leak,
    detect_memory_bound,
]


def run_detectors(tl: Timeline, cfg: Any = None) -> List[Finding]:
    """Run every detector and return findings ranked most-severe first
    (severity, then first step)."""
    findings: List[Finding] = []
    for det in DETECTORS:
        findings.extend(det(tl, cfg))
    findings.sort(key=lambda f: (SEVERITY_ORDER.get(f.severity, 9), f.step_first))
    return findings
