"""The port's overlap engine, replay-ratio controller, player mirror and the
overlapped DreamerV3 loop, held against the JAX package.

* every scripted engine scenario of tests/test_overlap.py runs on both
  engines (``sheeprl_tpu.engine`` and ``sheeprl_tpu_torch.engine``) and must
  give the same sequence; a strict-freshness script gives one exact
  sequence of (payload, version, staleness);
* ``Ratio`` gives exactly the JAX package's repeats and peeks over a random
  step sequence, across a state round trip;
* ``ParamMirror``: the player's copy does not move with an in-place update
  of the learner's modules, async refresh keeps the old copy until the new
  one is ready, an unknown ``algo.player.device`` raises;
* end to end on the CPU (TINY_DV3): the overlapped and the serial CLI runs
  end with the same ledger, staleness stays within its bound, the player
  thread is gone afterwards, a player exception fails the run, a
  CountdownPoller drain leaves a consistent checkpoint, a resumed run starts
  from the file's state and reaches its target, and ``eval`` prints the
  test reward.

Every join and wait has a timeout: a stuck player fails its test.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import sheeprl_tpu.engine as jax_engine
import sheeprl_tpu_torch.engine as torch_engine
from dreamer_tiny import TINY_DV3
from sheeprl_tpu.utils.utils import Ratio as JaxRatio
from sheeprl_tpu_torch.parallel.placement import ParamMirror, player_device
from sheeprl_tpu_torch.resilience.preemption import clear_preemption, preemption_requested
from sheeprl_tpu_torch.utils.utils import Ratio

ENGINES = {"jax": jax_engine, "torch": torch_engine}
WAIT_S = 10.0


@pytest.fixture(autouse=True)
def _clean_preemption_flag():
    clear_preemption()
    yield
    clear_preemption()


def _wait_for(pred, timeout=WAIT_S):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.005)
    return pred()


# ---------------------------------------------------------------------------
# the engine's scripted scenarios, on both engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ENGINES)
def test_spsc_ring_fifo_and_bounded(name):
    r = ENGINES[name].SpscRing(3)
    assert r.capacity == 3
    assert r.try_get() is r
    assert all(r.try_put(i) for i in range(3))
    assert not r.try_put(99)
    assert len(r) == 3
    assert [r.try_get() for _ in range(3)] == [0, 1, 2]
    assert r.try_get() is r


@pytest.mark.parametrize("name", ENGINES)
def test_spsc_ring_cross_thread_ordering(name):
    r = ENGINES[name].SpscRing(8)
    n = 20_000
    got = []

    def produce():
        for i in range(n):
            while not r.try_put(i):
                time.sleep(0)

    t = threading.Thread(target=produce)
    t.start()
    deadline = time.time() + WAIT_S
    while len(got) < n and time.time() < deadline:
        item = r.try_get()
        if item is not r:
            got.append(item)
        else:
            time.sleep(0)  # yield the GIL to the producer
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    assert got == list(range(n))


class _FakeRB:
    def __init__(self):
        self.calls = []

    def add(self, data, idxes=None, validate_args=False):
        self.calls.append(("add", {k: v.copy() for k, v in data.items()}, idxes))

    def mark_restart(self, i):
        self.calls.append(("restart", i, None))


class _Agg:
    def __init__(self):
        self.updates = []

    def update(self, k, v):
        self.updates.append((k, v))


@pytest.mark.parametrize("name", ENGINES)
def test_recording_sink_preserves_order_and_snapshots_arrays(name):
    eng = ENGINES[name]
    sink = eng.RecordingSink()
    row = {"x": np.zeros((1, 2, 1), np.float32)}
    sink.add(row, validate_args=True)
    sink.mark_restart(1)
    sink.add({"x": np.ones((1, 1, 1), np.float32)}, [1])
    sink.stat("Rewards/rew_avg", 3.0)
    row["x"][:] = 7.0  # mutate after recording: the snapshot must not move
    rb, agg = _FakeRB(), _Agg()
    eng.Packet(sink, 2).apply(rb, agg)
    assert [c[0] for c in rb.calls] == ["add", "restart", "add"]
    assert rb.calls[0][1]["x"].sum() == 0.0
    assert rb.calls[2][2] == [1]
    assert agg.updates == [("Rewards/rew_avg", 3.0)]
    # the serial sink hits the buffer directly, in the same order
    rb2, agg2 = _FakeRB(), _Agg()
    direct = eng.BufferOpSink(rb2, agg2)
    direct.add({"x": np.zeros((1, 2, 1), np.float32)})
    direct.mark_restart(1)
    direct.stat("Rewards/rew_avg", 3.0)
    assert [c[0] for c in rb2.calls] == ["add", "restart"] and agg2.updates == [("Rewards/rew_avg", 3.0)]


@pytest.mark.parametrize("name", ENGINES)
def test_staleness_gate_blocks_player_until_publish(name):
    eng = ENGINES[name].OverlapEngine(enabled=True, queue_depth=8, staleness_bound=1, total_steps=10_000)
    eng.burst_started()
    eng.burst_started()  # two bursts unpublished > bound 1
    eng.start(lambda: ENGINES[name].Packet(None, 1))
    time.sleep(0.25)
    assert eng.packets_produced == 0
    eng.published()
    assert _wait_for(lambda: eng.packets_produced > 0)
    eng.shutdown(timeout=WAIT_S)


@pytest.mark.parametrize("name", ENGINES)
def test_backpressure_applies_before_acting_not_after(name):
    calls = []
    eng = ENGINES[name].OverlapEngine(enabled=True, queue_depth=1, total_steps=100)
    eng.start(lambda: (calls.append(eng._pub_seq), ENGINES[name].Packet(None, 1))[1])
    assert _wait_for(lambda: calls)
    time.sleep(0.25)
    assert len(calls) == 1  # the slot is taken: slice 2 not collected yet
    assert len(eng.take(max_packets=1)) == 1
    assert _wait_for(lambda: len(calls) >= 2)
    time.sleep(0.25)
    assert len(calls) == 2  # exactly one more slice, no run-ahead
    eng.shutdown(timeout=WAIT_S)


@pytest.mark.parametrize("name", ENGINES)
def test_engine_take_drains_fifo_and_shutdown_drains_rest(name):
    eng = ENGINES[name].OverlapEngine(enabled=True, queue_depth=4, total_steps=40)
    eng.start(lambda: ENGINES[name].Packet(None, 2))
    pkts = eng.take()
    assert pkts and all(p.env_steps == 2 for p in pkts)
    drained = []
    leftover = eng.shutdown(lambda p: drained.append(p), timeout=WAIT_S)
    assert leftover == sum(p.env_steps for p in drained)
    assert eng.acked_steps == eng.produced_steps


def _strict_script(mod):
    """Strict freshness (bound 0) and a one-slot queue: the player acts only
    after the learner took the last packet and published, so the sequence
    is exact: packet i carries version i and staleness 0."""
    counter = iter(range(1000))
    eng = mod.OverlapEngine(enabled=True, queue_depth=1, staleness_bound=0, total_steps=20)
    eng.start(lambda: mod.Packet(next(counter), 2))
    seq = []
    while True:
        pkts = eng.take(max_packets=1)
        if not pkts:
            break
        seq += [(p.payload, p.env_steps, p.version, p.staleness) for p in pkts]
        eng.published()
    eng.shutdown(timeout=WAIT_S)
    return seq, eng.acked_steps, eng.staleness_seen_max


def test_strict_script_gives_the_jax_engines_sequence():
    want = ([(i, 2, i, 0) for i in range(10)], 20, 0)
    assert _strict_script(jax_engine) == want
    assert _strict_script(torch_engine) == want


@pytest.mark.parametrize("name", ENGINES)
def test_player_exception_reraised_on_take(name):
    def boom():
        raise ValueError("player died")

    eng = ENGINES[name].OverlapEngine(enabled=True, total_steps=10)
    eng.start(boom)
    with pytest.raises(RuntimeError, match="crashed") as info:
        deadline = time.time() + WAIT_S
        while time.time() < deadline:
            eng.take()
    assert isinstance(info.value.__cause__, ValueError)
    eng.shutdown(timeout=WAIT_S)


def test_torch_engine_record_without_a_sink():
    """With telem=None the port's engine still builds its record (the loop
    prints it), with the learner's stall fraction beside the player's."""
    eng = torch_engine.OverlapEngine(enabled=True, queue_depth=2, total_steps=8)
    eng.start(lambda: torch_engine.Packet(None, 2))
    while eng.take():
        eng.published()
    eng.shutdown(timeout=WAIT_S)
    rec = eng.last_record
    assert rec["event"] == "overlap" and rec["step"] == 8 and rec["player_step"] == 8
    for k in ("player_stall_frac", "learner_stall_frac", "staleness_max", "bursts", "interval_s"):
        assert k in rec
    assert eng.maybe_emit(force=True)["event"] == "overlap"


# ---------------------------------------------------------------------------
# the replay-ratio controller
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ratio,pretrain", [(0.5, 0), (1.0, 3), (0.0625, 0), (2.0, 1)])
def test_ratio_matches_jax_across_a_state_round_trip(ratio, pretrain):
    rng = np.random.default_rng(int(ratio * 1000) + pretrain)
    steps = np.cumsum(rng.integers(1, 9, size=400)).tolist()
    mine, ref = Ratio(ratio, pretrain), JaxRatio(ratio, pretrain)
    for i, s in enumerate(steps):
        assert mine.peek(s) == ref.peek(s)
        assert mine(s) == ref(s)
        if i == 200:  # round trip both through their states
            mine = Ratio(1.0).load_state_dict(mine.state_dict())
            ref = JaxRatio(1.0).load_state_dict(ref.state_dict())
        assert mine.state_dict() == ref.state_dict()


# ---------------------------------------------------------------------------
# the player's mirror
# ---------------------------------------------------------------------------
def _modules():
    torch.manual_seed(0)
    return {"wm": torch.nn.Linear(4, 3), "actor": torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.LayerNorm(2))}


def test_mirror_copy_does_not_move_with_the_learner():
    learner = _modules()
    mirror = ParamMirror(learner, torch.device("cpu"))
    before = {k: v.clone() for k, v in mirror.current()["wm"].state_dict().items()}
    with torch.no_grad():
        learner["wm"].weight.add_(1.0)  # an optimizer step, in place
    assert torch.equal(mirror.current()["wm"].weight, before["weight"])
    mirror.refresh(learner)
    got = mirror.current()
    assert torch.equal(got["wm"].weight, learner["wm"].weight)
    with torch.no_grad():
        learner["wm"].weight.add_(1.0)  # the next burst, after the refresh
    assert torch.equal(got["wm"].weight, before["weight"] + 1.0)
    assert not got["wm"].weight.requires_grad


class _Event:
    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def test_mirror_async_keeps_the_old_copy_until_ready():
    learner = _modules()
    mirror = ParamMirror(learner, torch.device("cpu"), async_refresh=True)
    old = mirror.current()
    with torch.no_grad():
        learner["actor"][0].bias.fill_(5.0)
    mirror.refresh(learner)
    ev = mirror._ready[mirror._pending] = _Event()  # the copy has not landed yet
    assert mirror.current() is old
    assert not torch.equal(old["actor"][0].bias, learner["actor"][0].bias)
    ev.done = True
    new = mirror.current()
    assert new is not old and torch.equal(new["actor"][0].bias, learner["actor"][0].bias)
    # blocking mode takes the newest copy at once
    blocking = ParamMirror(learner, torch.device("cpu"))
    blocking.refresh(learner)
    blocking._ready[blocking._pending] = _Event()
    assert torch.equal(blocking.current()["actor"][0].bias, learner["actor"][0].bias)


def test_cli_without_a_card_raises_for_the_card(tmp_path, monkeypatch):
    """fabric.accelerator=auto and no card: the run raises, nothing falls
    back to the CPU, whatever algo.player.device says."""
    from sheeprl_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for player in ("auto", "accelerator"):
        with pytest.raises(RuntimeError, match="none is available"):
            cli.run(TINY_DV3 + ["algo.total_steps=8", f"algo.player.device={player}"])


def test_player_device_modes(monkeypatch):
    from sheeprl_tpu_torch.config import Config

    cpu = torch.device("cpu")
    cfg = lambda mode: Config({"algo": {"player": {"device": mode}}})  # noqa: E731
    assert player_device(cfg("auto"), cpu) == cpu
    assert player_device(cfg("host"), torch.device("cuda", 0)) == cpu
    assert player_device(cfg("auto"), torch.device("cuda", 0)) == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="auto | host | accelerator"):
        player_device(cfg("bogus"), cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="accelerator"):
        player_device(cfg("accelerator"), cpu)


def test_player_device_auto_is_the_host_where_the_parameters_are_sharded():
    """On a mesh whose ``params`` report shards a leaf, ``auto`` keeps the
    mirror's two whole copies off the learner's card (the JAX package's
    ``auto``); ``accelerator`` still puts them there, ``host`` on the host."""
    from sheeprl_tpu_torch.config import Config

    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    cfg = lambda mode: Config({"algo": {"player": {"device": mode}}})  # noqa: E731
    assert player_device(cfg("auto"), card, params_sharded=True) == cpu
    assert player_device(cfg("auto"), card, params_sharded=False) == card
    assert player_device(cfg("accelerator"), card, params_sharded=True) == card
    assert player_device(cfg("host"), card, params_sharded=True) == cpu


# ---------------------------------------------------------------------------
# end to end through the CLI, on the CPU
# ---------------------------------------------------------------------------
E2E = TINY_DV3 + [
    "fabric.accelerator=cpu", "env.num_envs=2", "algo.learning_starts=8", "algo.replay_ratio=0.5",
    "buffer.size=64", "metric.log_every=8", "algo.run_test=False",
]


def _run(args, capsys):
    from sheeprl_tpu_torch import cli

    cli.run(args)
    return capsys.readouterr().out


def _ckpt(out):
    from sheeprl_tpu_torch.utils.checkpoint import CheckpointManager

    log_dir = next(l.split("=", 1)[1] for l in out.splitlines() if l.startswith("[dreamer_v3] log_dir="))
    return CheckpointManager(log_dir).list_checkpoints(), log_dir


def _ledger(path):
    s = torch.load(path, weights_only=False)
    return (s["policy_step"], s["opt_states"]["step"], s["ratio"], [(b["pos"], b["full"]) for b in s["rb"]["buffers"]])


def _overlap_records(out):
    """The run's ``overlap`` events, from its telemetry stream."""
    _, log_dir = _ckpt(out)
    with open(os.path.join(log_dir, "telemetry.jsonl")) as fh:
        return [r for r in map(json.loads, fh) if r["event"] == "overlap"]


def test_cli_overlapped_and_serial_ledgers_match(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = E2E + ["algo.total_steps=32", "checkpoint.every=0"]
    out_ov = _run(args + ["run_name=ov"], capsys)
    out_se = _run(args + ["run_name=se", "algo.overlap.enabled=False"], capsys)
    (ov,), _ = _ckpt(out_ov)
    (se,), _ = _ckpt(out_se)
    assert ov.name == se.name == "ckpt_32.ckpt"
    assert _ledger(ov) == _ledger(se)
    assert _ledger(ov)[1] > 0  # it trained
    recs = _overlap_records(out_ov)
    assert recs and recs[-1]["final"] and recs[-1]["staleness_seen_max"] <= 1
    assert max(r["staleness_max"] for r in recs) <= 1
    assert not _overlap_records(out_se)
    assert not [t for t in threading.enumerate() if t.name == "overlap-player"]


def test_cli_player_exception_fails_the_run(tmp_path, monkeypatch):
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.utils import env as env_mod

    monkeypatch.chdir(tmp_path)
    calls = {"n": 0}
    step = env_mod.SyncVectorEnv.step

    def failing_step(self, actions):
        calls["n"] += 1
        if calls["n"] > 5:
            raise ValueError("env died")
        return step(self, actions)

    monkeypatch.setattr(env_mod.SyncVectorEnv, "step", failing_step)
    with pytest.raises(RuntimeError, match="overlap player thread crashed") as info:
        cli.run(E2E + ["algo.total_steps=64"])
    assert isinstance(info.value.__cause__, ValueError)
    assert not [t for t in threading.enumerate() if t.name == "overlap-player"]


def test_cli_countdown_drain_leaves_a_consistent_checkpoint(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = _run(E2E + [
        "env.id=continuous_dummy", "algo.total_steps=200", "checkpoint.every=0",
        "resilience.preemption.poll_every_s=0.0",
        "+resilience.preemption.poller._target_=sheeprl_tpu_torch.resilience.preemption.CountdownPoller",
        "+resilience.preemption.poller.n=6",
    ], capsys)
    ckpts, log_dir = _ckpt(out)
    assert len(ckpts) == 1
    st = torch.load(ckpts[-1], weights_only=False)
    assert 0 < st["policy_step"] < 200
    # the drained packets landed before the save: one row per env per step
    assert all(b["pos"] * 2 == st["policy_step"] for b in st["rb"]["buffers"])
    manifest = json.load(open(f"{log_dir}/resume_manifest.json"))
    assert manifest["step"] == st["policy_step"] and manifest["checkpoint"] == f"checkpoint/{ckpts[-1].name}"
    assert not preemption_requested()
    assert not [t for t in threading.enumerate() if t.name == "overlap-player"]


def test_cli_resume_starts_from_the_file_and_reaches_target(tmp_path, monkeypatch, capsys):
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import param_sums

    monkeypatch.chdir(tmp_path)
    out = _run(E2E + ["algo.total_steps=24", "checkpoint.every=12", "run_name=first"], capsys)
    ckpts, _ = _ckpt(out)
    mid = [p for p in ckpts if 8 < int(p.stem.split("_")[1]) < 24][-1]
    saved = torch.load(mid, weights_only=False)
    out = _run(E2E + ["algo.total_steps=40", f"checkpoint.resume_from={mid}", "run_name=second"], capsys)
    started = json.loads(next(l for l in out.splitlines() if l.startswith("[dreamer_v3] resumed "))[21:])
    assert started["policy_step"] == saved["policy_step"]
    assert started["grad_steps"] == saved["opt_states"]["step"]
    assert started["ratio"] == saved["ratio"]
    want = param_sums({k: saved[k] for k in ("wm", "actor", "critic", "target_critic")})
    assert started["param_sums"] == pytest.approx(want, rel=1e-12)
    ckpts, _ = _ckpt(out)
    assert ckpts[-1].name == "ckpt_40.ckpt"
    final = torch.load(ckpts[-1], weights_only=False)
    assert final["policy_step"] == 40 and final["opt_states"]["step"] > saved["opt_states"]["step"]


def test_cli_eval_prints_the_test_reward(tmp_path, monkeypatch, capsys):
    from sheeprl_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    out = _run(E2E + ["algo.total_steps=12", "algo.overlap.enabled=False"], capsys)
    ckpts, _ = _ckpt(out)
    cli.evaluation([f"checkpoint_path={ckpts[-1]}", "fabric.accelerator=cpu"])
    assert "Test - Reward: " in capsys.readouterr().out
