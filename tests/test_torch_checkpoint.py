"""The port's checkpoints and resilience pieces, held against the JAX
package: the seven cases of tests/test_checkpoint.py on both managers (the
same script; the round trip carries a PRNG key there and a torch generator
state here), a snapshot that a later burst does not change, the async
writer's snapshot isolation, the replay buffer's state against the JAX
buffer's, and the RunGuard's drain and wall cap."""
import numpy as np
import pytest
import torch

import jax

from dreamer_tiny import N_ACT, TINY_DV3
from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JaxEnvBuffer
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JaxSeqBuffer
from sheeprl_tpu.utils.checkpoint import CheckpointManager as JaxManager
from sheeprl_tpu_torch.data import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.resilience.ckpt_async import AsyncCheckpointWriter
from sheeprl_tpu_torch.resilience.preemption import CountdownPoller, PreemptionGuard, clear_preemption
from sheeprl_tpu_torch.utils.checkpoint import CheckpointManager, snapshot

MANAGERS = {"jax": JaxManager, "torch": CheckpointManager}


@pytest.fixture(autouse=True)
def _clean_preemption_flag():
    clear_preemption()
    yield
    clear_preemption()


def _state(name, v=1.0):
    """The same state for both managers: parameters, a counter and the
    framework's random state."""
    if name == "jax":
        return {"params": {"w": np.full((3, 3), v, np.float32)}, "policy_step": int(v), "rng": jax.random.key(int(v))}
    gen = torch.Generator().manual_seed(int(v))
    return {"params": {"w": torch.full((3, 3), v)}, "policy_step": int(v), "rng": gen.get_state()}


def _w(state):
    return np.asarray(state["params"]["w"])


def test_save_load_round_trip_with_generator_state(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep_last=None)
    gen = torch.Generator().manual_seed(2)
    torch.rand(5, generator=gen)  # not the seed's state any more
    path = ckpt.save(10, {"params": {"w": torch.full((3, 3), 2.0)}, "rng": gen.get_state()})
    assert path and path.endswith("ckpt_10.ckpt")
    loaded = CheckpointManager.load(path)
    np.testing.assert_allclose(_w(loaded), 2.0)
    again = torch.Generator()
    again.set_state(loaded["rng"])
    assert torch.equal(torch.rand(7, generator=again), torch.rand(7, generator=gen))


@pytest.mark.parametrize("name", MANAGERS)
def test_keep_last_prunes_oldest(tmp_path, name):
    ckpt = MANAGERS[name](str(tmp_path), keep_last=2)
    for step in (1, 2, 3, 4):
        ckpt.save(step, _state(name, float(step)))
    assert [p.name for p in ckpt.list_checkpoints()] == ["ckpt_3.ckpt", "ckpt_4.ckpt"]


@pytest.mark.parametrize("name", MANAGERS)
def test_checkpoints_sorted_numerically_not_lexically(tmp_path, name):
    ckpt = MANAGERS[name](str(tmp_path), keep_last=None)
    for step in (9, 100, 20):
        ckpt.save(step, _state(name))
    assert [p.name for p in ckpt.list_checkpoints()] == ["ckpt_9.ckpt", "ckpt_20.ckpt", "ckpt_100.ckpt"]


@pytest.mark.parametrize("name", MANAGERS)
def test_disabled_manager_writes_nothing(tmp_path, name):
    ckpt = MANAGERS[name](str(tmp_path), enabled=False)
    assert ckpt.save(1, _state(name)) is None
    assert not (tmp_path / "checkpoint").exists()


@pytest.mark.parametrize("name", MANAGERS)
def test_atomic_write_leaves_no_tmp_on_success(tmp_path, name):
    MANAGERS[name](str(tmp_path)).save(5, _state(name))
    assert [p for p in (tmp_path / "checkpoint").iterdir() if p.suffix != ".ckpt"] == []


@pytest.mark.parametrize("name", MANAGERS)
def test_load_for_inference_drops_optimizer_state_and_buffer(tmp_path, name):
    ckpt = MANAGERS[name](str(tmp_path))
    state = {
        **_state(name, 3.0),
        "opt_state": {"mu": np.zeros((2, 2), np.float32)},
        "opt_states": {"wm": {"nu": np.zeros((4,), np.float32)}},
        "rb": {"obs": np.zeros((128, 4), np.float32)},
    }
    path = ckpt.save(7, state)
    lean = MANAGERS[name].load_for_inference(path)
    assert set(lean) == {"params", "policy_step", "rng"}
    np.testing.assert_allclose(_w(lean), 3.0)
    assert set(MANAGERS[name].load(path)) == set(state)


@pytest.mark.parametrize("name", MANAGERS)
def test_failed_save_does_not_clobber_existing(tmp_path, name):
    ckpt = MANAGERS[name](str(tmp_path))
    ckpt.save(7, _state(name, 1.0))

    class _Unpicklable:
        def __reduce__(self):
            raise RuntimeError("no pickling")

    with pytest.raises(RuntimeError):
        ckpt.save(7, {"bad": _Unpicklable()})
    np.testing.assert_allclose(_w(MANAGERS[name].load(tmp_path / "checkpoint" / "ckpt_7.ckpt")), 1.0)
    assert [p.name for p in MANAGERS[name](str(tmp_path)).list_checkpoints()] == ["ckpt_7.ckpt"]
    if name == "torch":  # the port also removes its partial tmp file
        assert [p.name for p in (tmp_path / "checkpoint").iterdir()] == ["ckpt_7.ckpt"]


def test_snapshot_is_not_changed_by_a_later_burst():
    """The checkpoint state holds references (``state_dict()``,
    ``optimizer.state_dict()``) to tensors the next burst updates in place;
    the snapshot must hold copies."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces

    cfg = compose("config", TINY_DV3 + ["fabric.accelerator=cpu"])
    torch.manual_seed(0)
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    wm, actor, critic, target = build_agent(cfg, space, [N_ACT], False, torch.device("cpu"))
    opts = tdv3.build_optimizers(cfg, wm, actor, critic)
    train = tdv3.make_train_fn(wm, actor, critic, target, opts, cfg, False, [N_ACT])
    rng = np.random.default_rng(0)
    T, B = 4, 2

    def batch():
        return {
            "rgb": torch.from_numpy(rng.integers(0, 255, (1, T, B, 64, 64, 3), np.uint8)),
            "actions": torch.from_numpy(np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, (1, T, B))]),
            "rewards": torch.from_numpy(rng.standard_normal((1, T, B, 1)).astype(np.float32)),
            "terminated": torch.zeros(1, T, B, 1), "truncated": torch.zeros(1, T, B, 1), "is_first": torch.zeros(1, T, B, 1),
        }

    gen = torch.Generator().manual_seed(0)
    moments, _ = train(init_moments(), batch(), generator=gen)
    live = {"wm": wm.state_dict(), "opt": opts.wm.optimizer.state_dict()}
    snap = CheckpointManager("unused", enabled=False).to_host_payload(live)
    frozen = {k: v.clone() for k, v in snap["wm"].items()}
    frozen_exp_avg = snap["opt"]["state"][0]["exp_avg"].clone()
    train(moments, batch(), generator=gen)  # the next burst, in place
    assert any(not torch.equal(live["wm"][k], frozen[k]) for k in frozen)  # the live state moved
    for k, v in snap["wm"].items():
        assert torch.equal(v, frozen[k]), k
    assert torch.equal(snap["opt"]["state"][0]["exp_avg"], frozen_exp_avg)


class _Events:
    """A telemetry stand-in that keeps what it is given."""

    def __init__(self):
        self.events = []

    def emit(self, rec):
        self.events.append(rec)


def test_async_writer_writes_the_state_at_save_time(tmp_path):
    w = torch.zeros(64, 64)
    telem = _Events()
    writer = AsyncCheckpointWriter(CheckpointManager(str(tmp_path)), telem=telem)
    writer.save(3, {"w": w, "moments": (w[0], w[1]), "groups": [{"betas": (0.9, 0.999)}]})
    w.add_(1.0)  # the next burst starts at once
    assert writer.flush(timeout=30)
    writer.close(timeout=30)
    loaded = CheckpointManager.load(tmp_path / "checkpoint" / "ckpt_3.ckpt")
    assert float(loaded["w"].abs().max()) == 0.0 and float(loaded["moments"][1].abs().max()) == 0.0
    assert loaded["groups"] == [{"betas": (0.9, 0.999)}]
    lines = telem.events
    assert [(r["event"], r["action"]) for r in lines] == [("ckpt_async", "enqueued"), ("ckpt_async", "written")]
    assert lines[1]["bytes"] > 64 * 64 * 4 and lines[1]["write_ms"] >= 0 and lines[0]["snapshot_ms"] >= 0


def test_snapshot_copies_lists_and_arrays():
    t, a = torch.ones(3), np.ones(3)
    snap = snapshot({"l": [t, (t,)], "a": a, "n": 5})
    t.zero_()
    a[:] = 0
    assert float(snap["l"][0].sum()) == 3.0 and float(snap["l"][1][0].sum()) == 3.0 and snap["a"].sum() == 3.0
    assert snap["n"] == 5


def _fill(rb, n_envs, steps, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        rb.add({
            "obs": rng.standard_normal((1, n_envs, 3)).astype(np.float32),
            "truncated": np.zeros((1, n_envs, 1), np.float32),
        })


@pytest.mark.parametrize("steps", [5, 12])  # part filled, wrapped around
def test_buffer_checkpoint_state_matches_jax_and_round_trips(steps):
    """The port's buffer state holds the JAX buffer's stored rows, write
    head and truncation surgery; restored into a fresh buffer it samples the
    same rows as the buffer it was taken from."""
    n_envs, size = 2, 8
    mine = EnvIndependentReplayBuffer(size, n_envs=n_envs, obs_keys=("obs",), buffer_cls=SequentialReplayBuffer, seed=3)
    ref = JaxEnvBuffer(size, n_envs=n_envs, obs_keys=("obs",), buffer_cls=JaxSeqBuffer, seed=3)
    _fill(mine, n_envs, steps)
    _fill(ref, n_envs, steps)
    st, rst = mine.checkpoint_state_dict(), ref.checkpoint_state_dict()
    for b, rb in zip(st["buffers"], rst["buffers"]):
        assert (b["pos"], b["full"]) == (rb["pos"], rb["full"])
        n = len(b["buffer"]["obs"])
        assert n == (size if rb["full"] else rb["pos"])
        for k in ("obs", "truncated"):
            np.testing.assert_array_equal(b["buffer"][k], np.asarray(rb["buffer"][k])[:n])
        assert b["buffer"]["truncated"][(b["pos"] - 1) % size].item() == 1.0
    # the live buffer keeps its flags
    assert not any(np.any(b._buf["truncated"]) for b in mine._buffers)
    restored = EnvIndependentReplayBuffer(size, n_envs=n_envs, obs_keys=("obs",), buffer_cls=SequentialReplayBuffer, seed=99)
    restored.load_state_dict(mine.state_dict())
    a = mine.sample(4, n_samples=2, sequence_length=3)
    b = restored.sample(4, n_samples=2, sequence_length=3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="buffer.size"):
        EnvIndependentReplayBuffer(size * 2, n_envs=n_envs, obs_keys=("obs",)).load_state_dict(mine.state_dict())


def _guard_cfg(**resilience):
    from sheeprl_tpu_torch.config import Config

    base = {"preemption": {"enabled": True, "signals": ["SIGTERM"], "grace_s": 30.0, "poller": None,
                           "poll_every_s": 0.0},
            "async_checkpoint": {"enabled": True, "max_in_flight": 1}, "watchdog": {"enabled": False}}
    for k, v in resilience.items():
        base[k].update(v)
    return Config({"resilience": base, "algo": {"max_wall_time_s": -1}, "checkpoint": {"save_last": True},
                   "seed": 0})


def test_runguard_drains_on_the_poller_and_writes_the_manifest(tmp_path):
    from sheeprl_tpu_torch.resilience.guard import RunGuard

    cfg = _guard_cfg(preemption={"poller": {"_target_": "sheeprl_tpu_torch.resilience.preemption.CountdownPoller",
                                            "n": 2}})
    guard = RunGuard.setup(cfg, CheckpointManager(str(tmp_path)), log_dir=str(tmp_path))
    saved = []
    state_fn = lambda: saved.append(1) or {"w": torch.ones(2)}  # noqa: E731
    assert not guard.stop_reached(4, 100, state_fn)
    assert guard.stop_reached(6, 100, state_fn)  # second poll: preempted, final save
    assert guard.preempted and saved == [1]
    guard.close(6, state_fn)
    assert [p.name for p in guard.ckpt.list_checkpoints()] == ["ckpt_6.ckpt"]
    import json

    assert json.load(open(tmp_path / "resume_manifest.json"))["step"] == 6
    assert not guard.preempted  # the drained request is consumed


def test_runguard_wall_cap_and_watchdog_refusal(tmp_path):
    from sheeprl_tpu_torch.resilience.guard import RunGuard

    cfg = _guard_cfg()
    cfg.algo.max_wall_time_s = 1e-9
    guard = RunGuard.setup(cfg, CheckpointManager(str(tmp_path)))
    assert guard.stop_reached(8, 100, lambda: {"w": torch.ones(2)})
    guard.close()
    assert [p.name for p in guard.ckpt.list_checkpoints()] == ["ckpt_8.ckpt"]
    # the watchdog is ported: enabled, the guard builds it (tests/test_torch_resilience.py drives it)
    guard = RunGuard.setup(_guard_cfg(watchdog={"enabled": True}), CheckpointManager(str(tmp_path)), str(tmp_path))
    assert guard.watchdog is not None and guard.watchdog.trace_dir == f"{tmp_path}/watchdog_trace"
    guard.close()


def test_preemption_poller_trips_the_flag():
    guard = PreemptionGuard(poller=CountdownPoller(2), poll_every_s=0.0)
    assert not guard.poll()
    assert guard.poll()
    assert guard.requested


def test_generator_state_restores_on_its_device_type_and_reseeds_across():
    """A generator's state restores exactly on the device type it was saved
    on; a CUDA generator's state does not fit a CPU generator, which is
    seeded from the saved bytes instead, the same way every time."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _gen_state, _set_gen_state

    gen = torch.Generator().manual_seed(4)
    torch.rand(3, generator=gen)
    saved = _gen_state(gen)
    again = torch.Generator()
    _set_gen_state(again, saved, "train")
    assert torch.equal(torch.rand(5, generator=again), torch.rand(5, generator=gen))
    philox = {"device": "cuda", "state": torch.arange(16, dtype=torch.uint8)}  # a CUDA generator's 16 bytes
    a, b = torch.Generator(), torch.Generator()
    _set_gen_state(a, philox, "player")
    _set_gen_state(b, philox, "player")
    assert torch.equal(torch.rand(5, generator=a), torch.rand(5, generator=b))


def test_runguard_wait_unparks_on_preemption(tmp_path):
    import queue
    import threading

    from sheeprl_tpu_torch.resilience.guard import RunGuard
    from sheeprl_tpu_torch.resilience.preemption import PreemptionGuard

    guard = RunGuard.setup(_guard_cfg(), CheckpointManager(str(tmp_path)))
    q: "queue.Queue" = queue.Queue()
    q.put("item")
    assert guard.wait(q, poll_s=0.01) == "item"
    threading.Timer(0.1, PreemptionGuard.trigger, args=("test",)).start()
    assert guard.wait(q, poll_s=0.01) is None  # nothing will come: the request unparks it
    guard.close()
