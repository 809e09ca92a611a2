"""The actor fleet end to end in the PyTorch port, on the CPU: the CLI's
``run`` with ``algo.fleet.workers=2`` (supervised worker processes that step
their env slices and act with a CPU copy of the policy) against the serial
loop on the same arguments.

* DreamerV3 (tiny widths, decoupled with ``pallas_gru=True``: the LN-GRU
  wrappers run their plain versions on the CPU), SAC and PPO, on the ``mp``
  transport and, for DreamerV3 and SAC, on loopback sockets: the final
  checkpoint's ledger is the serial loop's (policy step, gradient steps,
  the Ratio state, the buffer's pos and full; PPO's update counter). The
  streams of the learner and of every worker pass the port's
  ``validate_jsonl`` and the JAX package's, and the workers never
  initialised CUDA.
* A chaos crash (worker 0) plus a hang (worker 1, past ``fleet.hang_s``)
  on SAC's mp run: the ledger is still the serial loop's, the streams pass
  both validators, and the learner's holds crash, hang and respawn for
  each and no quarantine.
* A repeated crasher exhausts its fail budget and is quarantined; training
  completes on the survivor with the ledger exact over the real steps.
* A torn packet is rejected by its CRC and the worker respawned.
* A preemption (the countdown poller) drains the live workers into a
  consistent final checkpoint (one buffer row per round of two env steps),
  and ``checkpoint.resume_from`` continues a fleet run's ledger.

No run leaves a ``fleet-`` thread behind. All of it lives in one file, so
``--dist loadfile`` keeps these runs on one test worker.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import glob
import json
import threading

import pytest
import torch

from sheeprl_tpu_torch import cli

DV3 = ["exp=dreamer_v3", "algo=dreamer_v3_XS", "env=dummy", "env.id=discrete_dummy", "algo.per_rank_batch_size=2",
       "algo.per_rank_sequence_length=4", "algo.horizon=3", "algo.dense_units=8", "algo.mlp_layers=1",
       "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=8",
       "algo.world_model.recurrent_model.dense_units=8", "algo.world_model.transition_model.hidden_size=8",
       "algo.world_model.representation_model.hidden_size=8", "algo.world_model.discrete_size=4",
       "algo.world_model.stochastic_size=4", "algo.world_model.decoupled_rssm=True",
       "algo.world_model.pallas_gru=True", "env.num_envs=4", "algo.total_steps=32", "algo.learning_starts=16",
       "algo.replay_ratio=0.25", "buffer.size=64"]
SAC = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "env.num_envs=2", "algo.hidden_size=8",
       "algo.per_rank_batch_size=4", "algo.learning_starts=16", "algo.total_steps=192", "buffer.size=256"]
PPO = ["exp=ppo", "env=dummy", "env.num_envs=4", "algo.rollout_steps=16", "algo.per_rank_batch_size=32",
       "algo.update_epochs=1", "algo.total_steps=192"]
COMMON = ["fabric.accelerator=cpu", "buffer.memmap=False", "buffer.checkpoint=True", "checkpoint.every=0",
          "checkpoint.save_last=True", "algo.run_test=False", "seed=3", "fleet.backoff_s=0.05",
          "fleet.stats_every_s=0.5"]
ARGS = {"dreamer_v3": DV3, "sac": SAC, "ppo": PPO}
_SERIAL = {}  # algo -> the serial loop's ledger (shared by the tests of one algo)


def _run(algo, name, extra=()):
    cli.run(ARGS[algo] + COMMON + [f"run_name={name}", *extra])
    base = glob.glob(f"logs/runs/{algo}/*/{name}/version_0")[0]
    ckpts = sorted(glob.glob(f"{base}/checkpoint/*.ckpt"), key=lambda p: int(p.rsplit("_", 1)[1][:-5]))
    s = torch.load(ckpts[-1], map_location="cpu", weights_only=False)
    led = {"policy_step": s["policy_step"]}
    if algo == "ppo":
        led["update"] = s["update"]
    else:
        led["ratio"] = s["ratio"]
        led["grad_steps"] = s["opt_states"]["step"]
        rb = s["rb"]
        led["rb"] = [(b["pos"], b["full"]) for b in rb["buffers"]] if "buffers" in rb else (rb["pos"], rb["full"])
    return led, base


def _events(path):
    return [json.loads(line) for line in open(path)]


def _fleet_actions(base):
    return [(e["action"], e.get("worker")) for e in _events(f"{base}/telemetry.jsonl") if e["event"] == "fleet"]


def _serial(algo):
    if algo not in _SERIAL:
        _SERIAL[algo], _ = _run(algo, "serial", ["algo.overlap.enabled=False"])
    return _SERIAL[algo]


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    yield
    assert not [t.name for t in threading.enumerate() if t.name.startswith("fleet-")]


def _check_streams(base, transport="mp"):
    """The learner's stream and each worker's pass both packages'
    validators; the workers spawned, acted, never initialised CUDA; the
    learner published and drained (and, on sockets, accepted both)."""
    from sheeprl_tpu.telemetry.schema import validate_jsonl as jax_validate
    from sheeprl_tpu_torch.telemetry.schema import validate_jsonl

    streams = [f"{base}/telemetry.jsonl"] + sorted(glob.glob(f"{base}/workers/worker_*/telemetry.jsonl"))
    assert len(streams) == 3
    for path in streams:
        assert validate_jsonl(path) == [] and jax_validate(path) == [], path
    actions = _fleet_actions(base)
    assert ("spawn", 0) in actions and ("spawn", 1) in actions and ("drain", None) in actions
    interval = [e for e in _events(streams[0]) if e["event"] == "fleet" and e["action"] == "interval"][-1]
    assert interval["publications"] >= 1 and interval["publish_bytes"] > 0
    for path in streams[1:]:
        exit_rec = [e for e in _events(path) if e["event"] == "fleet" and e["action"] == "worker_exit"]
        assert exit_rec and not exit_rec[-1]["cuda_initialized"]
        assert any(e["event"] == "trace_span" and e["name"] == "env_step" for e in _events(path))
    if transport == "socket":
        accepts = [e["worker"] for e in _events(streams[0]) if e["event"] == "net" and e["action"] == "accept"]
        assert sorted(accepts) == [0, 1]


# SAC on the mp queues runs in the chaos test below
@pytest.mark.parametrize("algo,transport", [("dreamer_v3", "mp"), ("dreamer_v3", "socket"), ("sac", "socket"),
                                            ("ppo", "mp")])
def test_fleet_ledger_equals_the_serial_loops(algo, transport):
    led, base = _run(algo, f"fleet_{transport}", ["algo.fleet.workers=2", f"fleet.transport={transport}"])
    assert led == _serial(algo), (led, _serial(algo))
    assert led["policy_step"] == int(next(a for a in ARGS[algo] if a.startswith("algo.total_steps=")).split("=")[1])
    _check_streams(base, transport)


def test_chaos_crash_and_hang_ledger_equals_the_serial_loops():
    led, base = _run("sac", "chaos", ["algo.fleet.workers=2", "fleet.hang_s=1.0", "resilience.chaos.enabled=True",
                                      "resilience.chaos.crash_at_step=40", "resilience.chaos.crash_workers=[0]",
                                      "resilience.chaos.hang_at_step=60", "resilience.chaos.hang_workers=[1]",
                                      "resilience.chaos.hang_s=60.0"])
    assert led == _serial("sac")
    _check_streams(base)
    actions = _fleet_actions(base)
    for a in (("crash", 0), ("respawn", 0), ("hang", 1), ("respawn", 1)):
        assert a in actions, actions
    assert not any(a == "quarantine" for a, _ in actions)
    intervals = [e for e in _events(f"{base}/telemetry.jsonl") if e["event"] == "fleet" and e["action"] == "interval"]
    assert intervals[-1]["respawns"] == 2 and intervals[-1]["crashes"] == 1 and intervals[-1]["hangs"] == 1


def test_repeated_crasher_is_quarantined_and_the_fleet_degrades():
    led, base = _run("sac", "quarantine", ["algo.fleet.workers=2", "fleet.max_fails=1", "algo.total_steps=96",
                                           "resilience.chaos.enabled=True", "resilience.chaos.crash_at_step=10",
                                           "resilience.chaos.crash_workers=[0]", "resilience.chaos.crash_repeat=True"])
    # training completed on the survivor; one gradient step per env step past learning_starts
    assert led["policy_step"] == 96 and led["grad_steps"] == 80
    actions = _fleet_actions(base)
    assert [a for a, _ in actions].count("crash") == 2 and ("quarantine", 0) in actions


def test_torn_packet_is_detected_and_the_worker_respawned():
    led, base = _run("sac", "torn", ["algo.fleet.workers=2", "algo.total_steps=64", "fleet.max_fails=1",
                                     "resilience.chaos.enabled=True",
                                     "resilience.chaos.torn_packet_at=5", "resilience.chaos.torn_workers=[0]"])
    assert led["policy_step"] == 64  # the torn packet was discarded, not applied
    actions = [a for a, _ in _fleet_actions(base)]
    assert "torn_packet" in actions and "respawn" in actions


def test_preemption_drains_live_workers_into_a_consistent_checkpoint():
    from sheeprl_tpu_torch.resilience.preemption import preemption_requested

    led, base = _run("sac", "drain", [
        "algo.fleet.workers=2", "algo.total_steps=4096", "buffer.size=4096", "resilience.preemption.poll_every_s=0.0",
        "+resilience.preemption.poller._target_=sheeprl_tpu_torch.resilience.preemption.CountdownPoller",
        "+resilience.preemption.poller.n=20"])
    assert 0 < led["policy_step"] < 4096
    # one full-width row per round of two env steps: the step counter matches
    # the buffer exactly (a trailing partial round is dropped, never half-applied)
    assert led["rb"][0] * 2 == led["policy_step"]
    events = _events(f"{base}/telemetry.jsonl")
    assert [e["action"] for e in events if e["event"] == "preempt"] == ["requested", "checkpointed"]
    assert any(e["event"] == "fleet" and e["action"] == "drain" for e in events)
    assert not preemption_requested()


def test_resume_from_a_fleet_checkpoint_continues_the_ledger():
    """``checkpoint.resume_from`` in fleet mode: the learner takes the
    checkpoint's counters, Ratio and buffer, the workers start past
    ``learning_starts`` (their lifetime seeded from the global step), and the
    run ends on the ledger an uninterrupted run reaches."""
    first, base = _run("sac", "first", ["algo.fleet.workers=2", "algo.total_steps=64"])
    ckpt = sorted(glob.glob(f"{base}/checkpoint/*.ckpt"))[-1]
    led, _ = _run("sac", "resumed", ["algo.fleet.workers=2", "algo.total_steps=128", f"checkpoint.resume_from={ckpt}"])
    assert first["policy_step"] == 64
    assert led["policy_step"] == 128 and led["grad_steps"] == 128 - 16 and led["ratio"]["_prev"] == 128.0
    assert led["rb"] == (64, False)  # one row per round of two env steps, the resumed buffer's included
