"""The port's run diagnostics (sheeprl_tpu_torch/diag/) held against the JAX
package's (sheeprl_tpu/diag/) on the same streams: ``doctor``'s and
``trace``'s report JSON and the live aggregator's snapshots and ``alert``
events are the same, on synthetic streams built as the JAX package's own
tests build theirs and on streams the port writes on the CPU (a PPO run of
two iterations, a 2-worker SAC fleet). Before comparing, the port's command
names (``sheeprl_tpu_torch ...``) read as the JAX package's, and the
remediation text of the findings whose hint names the port's machinery
instead of JAX's (``ADAPTED``) is left out; everything else, titles, details,
data, severities and ranking included, must be equal. A CPU PPO run with
``metric.telemetry.prometheus_port`` answers ``/metrics`` and ``/live``
mid-run; its scrape renders what the JAX package's ``Registry`` renders for
the events the run had written by then."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import contextlib
import io
import json
import threading
import time
import urllib.request
from pathlib import Path

import pytest

import sheeprl_tpu.diag.aggregator as jax_aggregator
import sheeprl_tpu.diag.doctor as jax_doctor
import sheeprl_tpu.diag.live as jax_live
import sheeprl_tpu.diag.trace as jax_trace
from sheeprl_tpu.diag.prometheus import Registry as JaxRegistry
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.diag import Registry, aggregator, doctor, live, trace
from sheeprl_tpu_torch.telemetry.schema import validate_event, validate_jsonl
from test_diag import make_incident_run
from test_prof import _mem_run, _mem_series
from test_trace import _stall_timeline, _synthetic_run
from test_torch_fleet import COMMON, SAC

# the findings whose remediation names the port's machinery (diag/findings.py)
ADAPTED = {"retrace_storm", "sps_degradation", "mfu_degradation", "watchdog_stall", "hbm_pressure",
           "host_mem_leak", "memory_bound"}
STARTUP = {"event": "startup", "platform": "cpu", "device_kind": "cpu", "devices": 1, "rank": 0}


def _write(run: Path, events) -> Path:
    run.mkdir(parents=True, exist_ok=True)
    (run / "telemetry.jsonl").write_text("".join(json.dumps(e) + "\n" for e in events))
    return run


def _norm(report):
    """The report as the JAX package would word it: command names and the
    adapted remediation hints aside."""
    report = json.loads(json.dumps(report, default=str).replace("sheeprl_tpu_torch", "sheeprl_tpu"))
    for f in report.get("findings", []):
        if f["code"] in ADAPTED:
            f.pop("remediation")
    return report


# -- synthetic streams, built as tests/test_diag.py, test_trace.py, test_prof.py
# and test_live_telemetry.py build theirs
def _incident(tmp):
    return make_incident_run(tmp / "incident_run")


def _healthy(tmp):
    return _write(tmp / "run", [STARTUP, {"event": "log", "step": 64, "sps": 100.0, "interval_steps": 64,
                                          "interval_seconds": 0.5, "xla": {"retraces": 0}},
                                {"event": "shutdown", "step": 64}])


def _degradation(tmp):
    return _write(tmp / "run", [STARTUP] + [
        {"event": "log", "step": s, "sps": 100.0 if s <= 256 else 60.0, "interval_steps": 32,
         "interval_seconds": 0.3, "throughput": {"mfu": 0.4 if s <= 256 else 0.2}} for s in range(32, 513, 32)])


def _hbm_pressure(tmp):
    lim = 16 << 30
    return _mem_run(tmp / "red", _mem_series("learner", lambda i: 1 << 30, hbm_bytes_limit=lim,
                                             hbm_peak_bytes=int(0.95 * lim)))


def _host_mem_leak(tmp):
    base = 1 << 30
    return _mem_run(tmp / "red", _mem_series("learner", lambda i: base + i * (32 << 20))
                    + _mem_series("worker", lambda i: base, worker=0, index=0))


def _memory_bound(tmp):
    return _mem_run(tmp / "red", [{"event": "roofline", "fn": "train_step", "flops": 1e9, "bytes_accessed": 2e9,
                                   "intensity": 0.5, "bound": "memory", "ridge_intensity": 34.5,
                                   "attained_frac": 0.21, "step": 64}])


def _stepless(tmp):
    return _write(tmp / "run", [STARTUP,
                                {"event": "log", "sps": 100.0, "interval_steps": 32, "interval_seconds": 0.3},
                                {"event": "log", "step": 64, "sps": 90.0, "interval_steps": 32,
                                 "interval_seconds": 0.3},
                                {"event": "shutdown", "step": 64}])


def _fleet_skew(tmp):
    return _synthetic_run(tmp, skew_s=30.0, rounds=12)


def _stall(tmp):
    tl = _stall_timeline(wait_ms=50.0)
    return _write(tmp / "run", [STARTUP] + [r for recs in tl.by_type.values() for r in recs])


def _slo_and_watchdog(tmp):
    return _write(tmp / "run", [
        STARTUP, {"event": "log", "step": 32, "sps": 50.0, "xla": {"retraces": 0}},
        {"event": "alert", "rule": "sps_floor", "state": "firing", "metric": "sps", "value": 50.0,
         "threshold": 500.0, "severity": "critical"},
        {"event": "watchdog", "step": 40, "stalled_s": 90.0, "action": "dump", "trace_dir": str(tmp / "inc")},
        {"event": "shutdown", "step": 64}])


SYNTHETIC = {"incident": _incident, "healthy": _healthy, "degradation": _degradation,
             "hbm_pressure": _hbm_pressure, "host_mem_leak": _host_mem_leak, "memory_bound": _memory_bound,
             "stepless_logs": _stepless, "fleet_skew": _fleet_skew, "cross_process_stall": _stall,
             "slo_and_watchdog": _slo_and_watchdog}


@pytest.mark.parametrize("fixture", sorted(SYNTHETIC))
def test_doctor_and_trace_reports_match_jax_on_synthetic_streams(fixture, tmp_path):
    run = SYNTHETIC[fixture](tmp_path)
    mine, ref = doctor.diagnose(run), jax_doctor.diagnose(run)
    assert _norm(mine) == _norm(ref)
    assert mine["findings"] or fixture in ("healthy", "stepless_logs", "fleet_skew")
    assert doctor.render_text(mine).replace("sheeprl_tpu_torch", "sheeprl_tpu").split("\n")[:3] == \
        jax_doctor.render_text(ref).split("\n")[:3]
    assert _norm(trace.analyze(run)) == _norm(jax_trace.analyze(run))


def test_doctor_refuses_bench_dir(tmp_path):
    run = _healthy(tmp_path)
    with pytest.raises(ValueError, match="bench_dir"):
        doctor.main([f"run_dir={run}", f"bench_dir={tmp_path}"])
    assert doctor.parse_doctor_argv([f"run_dir={run}", "json=true", "strict=true"]) == \
        jax_doctor.parse_doctor_argv([f"run_dir={run}", "json=true", "strict=true"])


# -- the live aggregator under an injected clock
class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def _aggregator_sequence():
    """Relayed worker batches, the learner's own log/overlap/mem/trace_span
    events and an SLO rule that fires and then resolves."""
    t0 = 1_000_000.0
    seq = [(0.0, "ingest", dict(STARTUP))]
    for i in range(12):
        t = t0 + i
        seq.append((i * 1.0, "ingest", {"event": "log", "step": 32 * (i + 1), "sps": 50.0 if i < 6 else 900.0,
                                        "throughput": {"mfu": 0.3}, "t": t}))
        seq.append((i * 1.0 + 0.1, "ingest", {"event": "overlap", "step": 32 * (i + 1), "queue_depth": 1,
                                              "queue_cap": 4, "player_stall_frac": 0.2, "staleness_max": 1}))
        seq.append((i * 1.0 + 0.2, "batch", {"role": "worker", "index": i % 2, "dropped": i % 3, "events": [
            {"event": "trace_span", "name": "env_step", "role": "worker", "trace_id": f"t{i}",
             "span_id": f"w{i}", "t_start": t, "t_end": t + 0.02, "dur_ms": 20.0},
            {"event": "mem", "role": "worker", "rss_bytes": (1 << 30) + i, "t": t},
            {"event": "definitely_not_an_event"}]}))
        seq.append((i * 1.0 + 0.3, "ingest", {"event": "trace_span", "name": "learner_apply", "role": "learner",
                                              "trace_id": f"t{i}", "span_id": f"l{i}", "t_start": t + 0.02,
                                              "t_end": t + 0.03, "dur_ms": 10.0}))
    return seq


@pytest.mark.parametrize("window_s", [5.0, 60.0])
def test_aggregator_snapshots_and_alerts_match_jax(window_s, monkeypatch):
    """The same sequence under the same clock: the same ingest results,
    snapshots (a quarantined event's error less the list of event types each
    package's schema knows), alert events and rendered registry."""
    cfg = {"diag": {"live": {"window_s": window_s, "eval_s": 2.0, "slo": [
        {"name": "sps_floor", "metric": "sps", "min": 500.0, "burn_frac": 0.5, "severity": "critical"},
        {"name": "relay_loss", "metric": "relay.dropped", "max": 0}]}}}
    clock = _Clock(2_000_000.0)
    monkeypatch.setattr(time, "time", clock)
    runs = {}
    for name, mod, reg in (("port", aggregator, Registry()), ("jax", jax_aggregator, JaxRegistry())):
        clock.t = 2_000_000.0
        emitted, snaps = [], []
        agg = mod.LiveAggregator(cfg, emit=emitted.append, registry=reg)
        for dt, kind, rec in _aggregator_sequence():
            clock.t = 2_000_000.0 + dt
            out = agg.ingest(json.loads(json.dumps(rec))) if kind == "ingest" else \
                agg.ingest_batch(json.loads(json.dumps(rec)))
            snap = agg.snapshot()
            for q in snap["quarantine"]:  # the schema's error names the event types each package knows
                q["error"] = q["error"].split(" (known: ")[0]
            snaps.append((out, snap))
        runs[name] = (emitted, snaps, reg.render())
    assert runs["port"] == runs["jax"]
    alerts = runs["port"][0]
    assert {a["state"] for a in alerts} == {"firing", "resolved"} and all(validate_event(a) == [] for a in alerts)


# -- streams the port writes on the CPU
class _Scraper:
    """Polls a run's /metrics and /live while it runs; keeps every answer."""

    def __init__(self, port):
        self.base = f"http://127.0.0.1:{port}"
        self.metrics, self.live = [], []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(0.01):
            try:
                with urllib.request.urlopen(self.base + "/metrics", timeout=2) as r:
                    text = r.read().decode()
                with urllib.request.urlopen(self.base + "/live", timeout=2) as r:
                    snap = json.loads(r.read().decode())
            except OSError:
                continue
            self.metrics.append(text)
            self.live.append(snap)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _log_dir(text):
    return Path(next(l.split("=", 1)[1] for l in text.splitlines() if "] log_dir=" in l))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """A CPU PPO run of two iterations with the Prometheus endpoint up (its
    scrapes kept), and a 2-worker mp SAC fleet run."""
    root = tmp_path_factory.mktemp("port_runs")
    port = _free_port()
    out = {}
    with contextlib.chdir(root):
        buf = io.StringIO()
        with _Scraper(port) as scraper, contextlib.redirect_stdout(buf):
            cli.run(["exp=ppo", "env=dummy", "fabric.accelerator=cpu", "env.num_envs=4", "algo.rollout_steps=16",
                     "algo.per_rank_batch_size=32", "algo.update_epochs=1", "algo.total_steps=128",
                     "metric.log_every=64", "buffer.memmap=False", "algo.run_test=False",
                     f"metric.telemetry.prometheus_port={port}", "run_name=ppo"])
        out["ppo"], out["scraper"] = _log_dir(buf.getvalue()), scraper
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.run(SAC + COMMON + ["algo.total_steps=64", "algo.fleet.workers=2", "run_name=fleet_sac"])
        out["fleet"] = _log_dir(buf.getvalue())
    return out


@pytest.mark.parametrize("run", ["ppo", "fleet"])
def test_doctor_trace_and_top_match_jax_on_port_streams(run, port_runs, monkeypatch):
    log_dir = port_runs[run]
    assert validate_jsonl(log_dir / "telemetry.jsonl") == []
    mine, ref = doctor.diagnose(log_dir), jax_doctor.diagnose(log_dir)
    assert _norm(mine) == _norm(ref)
    assert mine["clean_shutdown"] and mine["healthy"]
    if run == "fleet":
        assert mine["process_streams"] == ["worker_000", "worker_001"]
    assert _norm(trace.analyze(log_dir)) == _norm(jax_trace.analyze(log_dir))
    clock = _Clock(3_000_000.0)
    monkeypatch.setattr(time, "time", clock)
    assert live.offline_snapshot(log_dir) == jax_live.offline_snapshot(log_dir)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.COMMANDS["top"]([f"run_dir={log_dir}", "once=true", "json=true"])
    assert json.loads(buf.getvalue())["source"] == "offline"


def _families(text):
    return [line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")]


def test_prometheus_scrape_mid_run_renders_what_jax_registry_renders(port_runs):
    scraper, log_dir = port_runs["scraper"], port_runs["ppo"]
    assert scraper.metrics and scraper.live, "the run's endpoint never answered"
    last = scraper.metrics[-1]
    assert "sheeprl_step " in last and "sheeprl_up 1" in last
    snap = scraper.live[-1]
    assert snap["window_s"] == 60.0 and snap["streams"]["main"] > 0
    # the JAX registry fed the stream's events one by one passes through the
    # scraped state: the same families and the same rendered values
    events = [json.loads(line) for line in open(log_dir / "telemetry.jsonl")]
    ref = JaxRegistry()
    renders = []
    for rec in events:
        ref.observe_event(rec)
        renders.append(ref.render())
    assert _families(last) in [_families(r) for r in renders]
    values = lambda t: sorted(l for l in t.splitlines() if l.startswith("sheeprl_step ") or  # noqa: E731
                              l.startswith("sheeprl_sps ") or l.startswith("sheeprl_devices "))
    assert values(last) in [values(r) for r in renders]
    assert not (log_dir / "live.json").exists()  # the discovery file goes with the endpoint
