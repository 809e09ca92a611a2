"""The port's single-run resilience (``sheeprl_tpu_torch/resilience/``),
mirroring tests/test_resilience.py on the port:

* the heartbeat watchdog fires and escalates to preempt, with an incident
  trace from ``torch.profiler`` in a directory of its own; it stays quiet
  while progress advances; a ``torch.profiler`` session already active on
  the training thread is left running and the event says why no trace was
  taken; ``resilience.watchdog.enabled=True`` builds it in the RunGuard;
* ``with_retries`` retries transient errors and re-raises config errors;
  ``vectorize`` retries a transient env-construction failure;
* ``supervise`` wires the newest checkpoint into ``checkpoint.resume_from``
  after a crash, and ``resilience.supervisor.attempts=2`` restarts a crashed
  PPO run from its checkpoint to its target;
* PPO preempted by a CountdownPoller, then ``resume run_dir=...`` to the
  target step;
* ``resume`` refuses a fingerprint mismatch unless ``force=true``, and fails
  loudly without a checkpoint.

Every wait has a deadline of a few seconds."""
import json
import time
from pathlib import Path

import pytest
import torch

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import Config
from sheeprl_tpu_torch.resilience import supervisor as sup
from sheeprl_tpu_torch.resilience.guard import RunGuard
from sheeprl_tpu_torch.resilience.preemption import clear_preemption, preemption_requested
from sheeprl_tpu_torch.resilience.resume import build_resume_config, config_fingerprint, read_manifest
from sheeprl_tpu_torch.telemetry.schema import validate_event
from sheeprl_tpu_torch.utils.checkpoint import CheckpointManager


@pytest.fixture(autouse=True)
def _clean_preemption_flag():
    clear_preemption()
    yield
    clear_preemption()


class _CapturingTelem:
    def __init__(self):
        self.events = []

    def emit(self, rec):
        assert not validate_event(rec), validate_event(rec)
        self.events.append(rec)


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------
def test_watchdog_fires_on_stall_and_escalates_to_preempt(tmp_path):
    telem = _CapturingTelem()
    dog = sup.HeartbeatWatchdog(stall_s=0.15, action="preempt", telem=telem, trace_dir=str(tmp_path / "wd"),
                                trace_s=0.1, poll_s=0.02).start()
    try:
        dog.beat(10)
        x = torch.randn(64, 64)
        deadline = time.monotonic() + 5.0
        while not preemption_requested() and time.monotonic() < deadline:
            x = torch.tanh(x @ x)  # work on this thread while the capture runs
            time.sleep(0.002)
        assert preemption_requested()
    finally:
        dog.stop()
    stall = [e for e in telem.events if e["action"] == "stall"]
    assert [e["action"] for e in telem.events] == ["stall", "preempt"]
    assert stall[0]["step"] == 10 and stall[0]["incident"] == 1
    trace = Path(stall[0]["trace_dir"]) / "trace.json"
    assert trace.parent.name.startswith("incident_001_") and trace.is_file()
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "aten::mm" in names  # the capture saw the training thread's ops


def test_watchdog_quiet_while_progress_advances():
    telem = _CapturingTelem()
    dog = sup.HeartbeatWatchdog(stall_s=0.3, action="none", telem=telem, poll_s=0.02).start()
    try:
        for step in range(10):
            dog.beat(step)
            time.sleep(0.05)
    finally:
        dog.stop()
    assert not telem.events


def test_watchdog_leaves_an_active_profiler_running(tmp_path):
    """A second torch.profiler session would end the first: with one active
    on the training thread, the incident has no trace and says why."""
    telem = _CapturingTelem()
    outer = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    outer.start()
    try:
        dog = sup.HeartbeatWatchdog(stall_s=0.1, action="none", telem=telem, trace_dir=str(tmp_path / "wd"),
                                    trace_s=0.1, poll_s=0.02).start()
        try:
            dog.beat(3)
            assert _wait_for(lambda: telem.events)
        finally:
            dog.stop()
        torch.ones(3).sum()
    finally:
        outer.stop()
    outer.export_chrome_trace(str(tmp_path / "outer.json"))
    assert "trace_dir" not in telem.events[0] and "torch.profiler" in telem.events[0]["trace_error"]
    assert not (tmp_path / "wd").exists()


def test_runguard_builds_beats_and_stops_the_watchdog(tmp_path):
    cfg = Config({"checkpoint": {"save_last": False},
                  "resilience": {"preemption": {"enabled": False},
                                 "watchdog": {"enabled": True, "stall_s": 600.0, "action": "none"}}})
    guard = RunGuard.setup(cfg, CheckpointManager(str(tmp_path), enabled=False), str(tmp_path))
    try:
        assert guard.watchdog is not None and guard.watchdog.trace_dir == f"{tmp_path}/watchdog_trace"
        assert not guard.stop_reached(7, 100)
        assert guard.watchdog._last_step == 7
    finally:
        guard.close()
    assert guard.watchdog._thread is None


# ---------------------------------------------------------------------------
# retries
# ---------------------------------------------------------------------------
def test_with_retries_retries_transient_errors():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    telem = _CapturingTelem()
    assert sup.with_retries(flaky, op="t", attempts=3, backoff_s=0.01, telem=telem) == "ok"
    assert calls["n"] == 3
    assert [e["attempt"] for e in telem.events if e["event"] == "retry"] == [1, 2]


def test_with_retries_config_errors_surface_immediately():
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise ValueError("config error")

    with pytest.raises(ValueError):
        sup.with_retries(broken, attempts=5, backoff_s=0.01)
    assert calls["n"] == 1


def test_vectorize_retries_a_transient_env_construction_failure(monkeypatch):
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils import env as env_mod

    real, calls = env_mod.SyncVectorEnv, {"n": 0}

    def flaky(thunks):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ConnectionError("the suite's daemon is not up yet")
        return real(thunks)

    monkeypatch.setattr(env_mod, "SyncVectorEnv", flaky)
    cfg = compose("config", ["exp=ppo", "env=dummy", "env.num_envs=2", "resilience.retries.backoff_s=0.01"])
    envs = env_mod.vectorize(cfg, 0, 0)
    assert calls["n"] == 2 and envs.num_envs == 2
    cfg = compose("config", ["exp=ppo", "env=dummy", "resilience.retries.enabled=False"])
    calls["n"] = 0
    with pytest.raises(ConnectionError):
        env_mod.vectorize(cfg, 0, 0)


# ---------------------------------------------------------------------------
# supervised restarts
# ---------------------------------------------------------------------------
def test_supervise_resumes_from_the_newest_checkpoint_after_a_crash():
    cfg = Config({"root_dir": "algo/env", "run_name": "sup", "checkpoint": {"resume_from": None}})
    base = Path("logs/runs/algo/env/sup")
    seen = []

    def run_fn(c):
        seen.append(c.select("checkpoint.resume_from"))
        if len(seen) == 1:
            mgr = CheckpointManager(str(base / "version_0"))
            mgr.save(8, {"x": 1})
            mgr.save(16, {"x": 2})
            CheckpointManager(str(base / "version_1")).save(4, {"x": 3})  # a newer version wins
            raise RuntimeError("crash")

    sup.supervise(run_fn, cfg, attempts=2, backoff_s=0.0, jitter=0.0)
    assert seen[0] is None and seen[1].endswith("version_1/checkpoint/ckpt_4.ckpt")
    assert sup.latest_checkpoint_under(Path("nowhere")) is None
    with pytest.raises(RuntimeError, match="always"):
        sup.supervise(lambda c: (_ for _ in ()).throw(RuntimeError("always")), cfg, attempts=2, backoff_s=0.0)


_PPO_ARGS = [
    "exp=ppo", "env=dummy", "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=16",
    "algo.per_rank_batch_size=16", "algo.update_epochs=1", "algo.total_steps=128", "buffer.memmap=False",
    "metric.log_every=32", "algo.run_test=False", "checkpoint.save_last=True",
]


def test_supervisor_restarts_a_crashed_ppo_run_from_its_checkpoint(monkeypatch):
    from sheeprl_tpu_torch.algos.ppo import ppo as ppo_mod

    real, calls = ppo_mod.Rollout.__call__, {"n": 0}

    def crash_once(self, buf):
        calls["n"] += 1
        if calls["n"] == 4:  # the first attempt dies after its checkpoint at step 96
            raise RuntimeError("scripted crash")
        return real(self, buf)

    monkeypatch.setattr(ppo_mod.Rollout, "__call__", crash_once)
    cli.run(_PPO_ARGS + ["checkpoint.every=96", "run_name=sup", "resilience.supervisor.attempts=2",
                         "resilience.supervisor.backoff_s=0.0", "algo.overlap.enabled=False"])
    base = Path("logs/runs/ppo/discrete_dummy/sup")
    first = CheckpointManager(str(base / "version_0")).list_checkpoints()
    second = CheckpointManager.load(CheckpointManager(str(base / "version_1")).list_checkpoints()[-1])
    assert [p.name for p in first] == ["ckpt_96.ckpt"]
    assert second["policy_step"] == 128 and second["update"] == 4


# ---------------------------------------------------------------------------
# preempt, then resume
# ---------------------------------------------------------------------------
def _poller_args(n: int):
    return ["resilience.preemption.poll_every_s=0.0",
            "+resilience.preemption.poller._target_=sheeprl_tpu_torch.resilience.preemption.CountdownPoller",
            f"+resilience.preemption.poller.n={n}"]


def _ckpts(d: Path):
    return CheckpointManager(str(d), enabled=False).list_checkpoints()


@pytest.mark.parametrize("overlap", [True, False], ids=["overlapped", "serial"])
def test_ppo_preempt_then_resume_reaches_target_step(overlap, capsys):
    run_name = f"preempt_{overlap}"
    cli.run(_PPO_ARGS + _poller_args(3) + [f"run_name={run_name}", "checkpoint.every=10000",
                                            f"algo.overlap.enabled={overlap}",
                                            "resilience.watchdog.enabled=True", "resilience.watchdog.stall_s=600"])
    base = Path(f"logs/runs/ppo/discrete_dummy/{run_name}")
    cks = _ckpts(base / "version_0")
    assert len(cks) == 1, cks
    st = CheckpointManager.load(cks[-1])
    assert 0 < st["policy_step"] < 128
    events = [json.loads(line) for line in open(base / "version_0" / "telemetry.jsonl")]
    assert [e["action"] for e in events if e["event"] == "preempt"] == ["requested", "checkpointed"]
    assert not [e for e in events if e["event"] == "watchdog"]
    assert read_manifest(base / "version_0")["step"] == st["policy_step"]
    capsys.readouterr()

    # the saved config replays the poller: drop it for the resumed leg
    cli.resume([f"run_dir={base}", "resilience.preemption.poller=null"])
    out = capsys.readouterr().out
    resumed = json.loads(out.split("[ppo] resumed ", 1)[1].splitlines()[0])
    assert resumed["policy_step"] == st["policy_step"] and resumed["update"] == st["update"]
    final = CheckpointManager.load(_ckpts(base / "version_1")[-1])
    assert final["policy_step"] == 128 and final["update"] == 4
    events = [json.loads(line) for line in open(base / "version_1" / "telemetry.jsonl")]
    assert any(e["event"] == "resume" for e in events)


def test_resume_rejects_fingerprint_mismatch_and_force_overrides():
    cli.run(_PPO_ARGS + _poller_args(2) + ["run_name=preempt_fp", "checkpoint.every=10000"])
    base = Path("logs/runs/ppo/discrete_dummy/preempt_fp")
    cfg, _ = build_resume_config(base)  # the saved config hashes to the manifest's fingerprint
    assert config_fingerprint(cfg) == read_manifest(base / "version_0")["fingerprint"]
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        build_resume_config(base, ["algo.gamma=0.5"])
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        cli.resume([f"run_dir={base}", "algo.gamma=0.5"])
    cfg, ckpt = build_resume_config(base, ["algo.gamma=0.5"], force=True)
    assert cfg.select("algo.gamma") == 0.5 and cfg.select("checkpoint.resume_from") == str(ckpt)
    assert str(ckpt).endswith(".ckpt")


def test_resume_without_checkpoint_fails_loudly(tmp_path):
    run_dir = tmp_path / "version_0"
    run_dir.mkdir(parents=True)
    (run_dir / "config.yaml").write_text("algo:\n  name: ppo\n")
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        build_resume_config(run_dir)
    with pytest.raises(FileNotFoundError, match="no saved config"):
        build_resume_config(tmp_path / "elsewhere")
