"""The port's env path against the JAX package's: the wrappers and
``make_env`` on CartPole rendered to ``rgb_array`` and on DMC walker pixels
(the same observations step for step under the same actions), async vector
envs, env restarts with ``patch_restarted_envs`` on the crashing dummy env,
and CPU dry runs of ``exp=dreamer_v3`` (CartPole) and
``exp=dreamer_v3_dmc_walker_walk`` (DMC pixels, bf16-mixed, the memmap
buffer).

DMC renders through EGL (``MUJOCO_GL=egl``); the walker checks run in a
child process with that variable set and skip where rendering is
unavailable, as tests/test_envs.py does."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JaxRB
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JaxSeq
from sheeprl_tpu.envs import wrappers as jw
from sheeprl_tpu.envs.gym_env import make_gym_env as jax_make_gym_env
from sheeprl_tpu.utils import env as jenv
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.data import EnvIndependentReplayBuffer
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs import wrappers as tw
from sheeprl_tpu_torch.envs.gym_env import make_gym_env
from sheeprl_tpu_torch.utils import env as tenv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTIONS = [0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 1]


def _same_obs(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _lockstep(mine, ref, actions=ACTIONS, seed=3):
    """Reset both with ``seed`` and step both with ``actions``: the same
    observations, rewards and episode ends throughout."""
    o1, _ = mine.reset(seed=seed)
    o2, _ = ref.reset(seed=seed)
    _same_obs(o1, o2)
    for a in actions:
        o1, r1, te1, tr1, _ = mine.step(a)
        o2, r2, te2, tr2, _ = ref.step(a)
        _same_obs(o1, o2)
        assert (float(r1), bool(te1), bool(tr1)) == (float(r2), bool(te2), bool(tr2))
        if te1 or tr1:
            o1, _ = mine.reset(seed=seed)
            o2, _ = ref.reset(seed=seed)


def test_gym_adapter_presents_the_port_spaces():
    env = make_gym_env("CartPole-v1")
    assert isinstance(env.observation_space, spaces.Box) and env.observation_space.shape == (4,)
    assert isinstance(env.action_space, spaces.Discrete) and env.action_space.n == 2
    assert env.unwrapped.spec.id == "CartPole-v1"
    env.close()


def test_vector_wrappers_match_jax_on_cartpole():
    mine = tw.MaskVelocityWrapper(tw.ActionRepeat(make_gym_env("CartPole-v1"), 2))
    ref = jw.MaskVelocityWrapper(jw.ActionRepeat(jax_make_gym_env("CartPole-v1"), 2))
    assert mine.action_repeat == 2
    _lockstep(mine, ref)
    mine = tw.RewardAsObservationWrapper(tw.ActionsAsObservationWrapper(make_gym_env("CartPole-v1"), 3, 0, 2))
    ref = jw.RewardAsObservationWrapper(jw.ActionsAsObservationWrapper(jax_make_gym_env("CartPole-v1"), 3, 0, 2))
    assert mine.observation_space["action_stack"].shape == ref.observation_space["action_stack"].shape
    _lockstep(mine, ref)


@pytest.mark.parametrize("screen,gray", [(64, False), (32, True)])
def test_pixel_wrappers_match_jax_on_cartpole_rgb_array(screen, gray):
    """Rendered pixels, resized and turned gray, stacked with dilation. The
    JAX package's pixel wrapper renders before the first reset, which
    gymnasium 1.x refuses, so its chain is built on an env reset once."""
    mine = tenv._RenderObs(make_gym_env("CartPole-v1"), "rgb", "state")
    base = jax_make_gym_env("CartPole-v1")
    base.reset(seed=0)
    ref = jenv._RenderObs(base, "rgb", "state")
    mine = tw.FrameStack(tenv._ImageTransform(mine, ["rgb"], screen, gray), 3, ["rgb"], 2)
    ref = jw.FrameStack(jenv._ImageTransform(ref, ["rgb"], screen, gray), 3, ["rgb"], 2)
    assert mine.observation_space["rgb"].shape == ref.observation_space["rgb"].shape == (screen, screen, 3 if gray else 9)
    _lockstep(mine, ref)
    g1, g2 = tw.GrayscaleRenderWrapper(make_gym_env("CartPole-v1")), jw.GrayscaleRenderWrapper(jax_make_gym_env("CartPole-v1"))
    g1.reset(seed=1)
    g2.reset(seed=1)
    _same_obs(g1.render(), g2.render())


def test_make_env_gives_the_rendered_cartpole_of_the_jax_wrappers():
    """``exp=dreamer_v3`` (CartPole rendered to 64x64x3): the port's make_env
    against the JAX package's wrappers in the same order."""
    cfg = compose("config", ["exp=dreamer_v3", "env.num_envs=1"])
    assert cfg.env.wrapper._target_ == "sheeprl_tpu_torch.envs.gym_env.make_gym_env"
    mine = tenv.make_env(cfg, 7, 0)()
    base = jax_make_gym_env("CartPole-v1")
    base.reset(seed=0)
    ref = jenv._ImageTransform(jenv._RenderObs(base, "rgb", None), ["rgb"], 64, False)
    assert mine.observation_space["rgb"].shape == (64, 64, 3)
    _lockstep(mine, ref, seed=7)


@pytest.mark.parametrize("extra", [[], ["env.mask_velocities=True", "env.action_repeat=2"]])
def test_make_env_matches_jax_on_vector_cartpole(extra):
    """A vector-only env with an mlp key is lifted into a one-key dict
    observation, as in the JAX package's make_env."""
    args = ["exp=dreamer_v3", "env.num_envs=1", "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]", *extra]
    mine = tenv.make_env(compose("config", args), 4, 0)()
    ref = jenv.make_env(jax_compose("config", args), 4, 0)()
    assert list(mine.observation_space.keys()) == list(ref.observation_space.keys()) == ["state"]
    _lockstep(mine, ref, seed=4)


def _vector_run(envs, actions):
    obs, _ = envs.reset(seed=5)
    out = [obs]
    for a in actions:
        obs, r, te, tr, info = envs.step(a)
        out.append((obs, r, te, tr, list(tenv.episode_stats(info)), info.get("final_obs")))
    envs.close()
    return out


def test_async_vector_env_gives_the_sync_results():
    args = ["exp=dreamer_v3", "env=dummy", "env.num_envs=3", "algo.mlp_keys.encoder=[state]"]
    acts = [np.array([i % 2, 1, 0]) for i in range(9)]
    sync = _vector_run(tenv.vectorize(compose("config", args + ["env.sync_env=True"]), 5, 0), acts)
    asyn_env = tenv.vectorize(compose("config", args + ["env.sync_env=False"]), 5, 0)
    assert isinstance(asyn_env, tenv.AsyncVectorEnv)
    asyn = _vector_run(asyn_env, acts)
    ref = jenv.vectorize(jax_compose("config", args + ["env.sync_env=True"]), 5, 0)
    o_ref, _ = ref.reset(seed=5)
    _same_obs(asyn[0], o_ref)
    _same_obs(sync[0], o_ref)
    ends = 0
    for i, a in enumerate(acts):
        o_ref, r_ref, te_ref, tr_ref, i_ref = ref.step(a)
        for got in (sync[i + 1], asyn[i + 1]):
            _same_obs(got[0], o_ref)
            np.testing.assert_array_equal(got[1], r_ref)
            np.testing.assert_array_equal(got[2] | got[3], te_ref | tr_ref)
            assert got[4] == list(jenv.episode_stats(i_ref))
        ends += int("final_obs" in i_ref)
    ref.close()
    assert ends > 0


def test_restarts_patch_the_buffer_as_jax_on_the_crashing_dummy():
    """RestartOnException around each env; a crash is no episode end, and
    patch_restarted_envs turns each crashed env's last row into a truncation
    boundary, in the port as in the JAX package."""
    args = ["exp=dreamer_v3", "env=dummy", "env.id=crashing_dummy", "env.num_envs=2", "env.restart_on_exception=True",
            "algo.mlp_keys.encoder=[state]"]
    mine = tenv.vectorize(compose("config", args), 3, 0, restart_handled_by_loop=True)
    ref = jenv.vectorize(jax_compose("config", args), 3, 0, restart_handled_by_loop=True)
    assert isinstance(mine.envs[0], tw.RestartOnException)
    rb_mine = EnvIndependentReplayBuffer(16, n_envs=2, obs_keys=("state",))
    rb_ref = JaxRB(16, n_envs=2, obs_keys=("state",), buffer_cls=JaxSeq)
    mine.reset(seed=3)
    ref.reset(seed=3)
    restarts = 0
    for step in range(8):
        a = np.array([step % 2, 1])
        o1, _, te1, tr1, i1 = mine.step(a)
        o2, _, te2, tr2, i2 = ref.step(a)
        _same_obs(o1, o2)
        np.testing.assert_array_equal(te1 | tr1, te2 | tr2)
        row = {"state": o1["state"][None], "terminated": te1.astype(np.float32).reshape(1, 2, 1),
               "truncated": tr1.astype(np.float32).reshape(1, 2, 1), "is_first": np.zeros((1, 2, 1), np.float32)}
        rb_mine.add(row)
        rb_ref.add(row)
        sd1, sd2 = {"is_first": np.zeros((1, 2, 1), np.float32)}, {"is_first": np.zeros((1, 2, 1), np.float32)}
        r1 = tenv.patch_restarted_envs(i1, te1 | tr1, rb_mine, sd1)
        r2 = jenv.patch_restarted_envs(i2, te2 | tr2, rb_ref, sd2)
        assert (r1 is None) == (r2 is None)
        if r1 is not None:
            restarts += 1
            np.testing.assert_array_equal(r1, r2)
            np.testing.assert_array_equal(sd1["is_first"], sd2["is_first"])
    assert restarts >= 2
    for b1, b2 in zip(rb_mine.buffer, rb_ref.buffer):
        for k in ("terminated", "truncated", "is_first", "state"):
            np.testing.assert_array_equal(b1[k], b2[k], err_msg=k)
    mine.close()
    ref.close()


_WALKER = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
try:
    from sheeprl_tpu.config import compose as jax_compose
    from sheeprl_tpu.utils.env import make_env as jax_make_env
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.env import make_env
    args = ["exp=dreamer_v3_dmc_walker_walk", "env.num_envs=1"]
    mine = make_env(compose("config", args), 5, 0)()
    ref = jax_make_env(jax_compose("config", args), 5, 0)()
    o1, _ = mine.reset(seed=5)
    o2, _ = ref.reset(seed=5)
except Exception as err:
    print(json.dumps({"skip": f"{type(err).__name__}: {err}"}))
    sys.exit(0)
rng = np.random.default_rng(0)
same = [bool(np.array_equal(o1["rgb"], o2["rgb"]))]
for _ in range(6):
    a = rng.uniform(-1, 1, mine.action_space.shape).astype(np.float32)
    o1, r1, te1, tr1, _ = mine.step(a)
    o2, r2, te2, tr2, _ = ref.step(a)
    same.append(bool(np.array_equal(o1["rgb"], o2["rgb"])) and r1 == r2 and (te1, tr1) == (te2, tr2))
print(json.dumps({"same": same, "shape": list(o1["rgb"].shape), "dtype": str(o1["rgb"].dtype),
                  "space": list(mine.observation_space["rgb"].shape), "lit": int(o1["rgb"].max())}))
mine.close()
"""


def _egl_env():
    return dict(os.environ, PYTHONPATH=REPO, MUJOCO_GL="egl", JAX_PLATFORMS="cpu")


def test_walker_pixels_match_jax():
    proc = subprocess.run([sys.executable, "-c", _WALKER, REPO], env=_egl_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if "skip" in out:
        pytest.skip(f"dm_control rendering unavailable: {out['skip']}")
    assert out["shape"] == out["space"] == [64, 64, 3] and out["dtype"] == "uint8" and out["lit"] > 0
    assert all(out["same"]), out["same"]


def _dry_run(tmp_path, args):
    cmd = [sys.executable, "-m", "sheeprl_tpu_torch", "run", "fabric.accelerator=cpu", "dry_run=True",
           "env.num_envs=2", "algo.per_rank_sequence_length=2", "algo.per_rank_batch_size=2", *args]
    return subprocess.run(cmd, cwd=tmp_path, env=_egl_env(), capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("exp", ["dreamer_v3", "dreamer_v3_dmc_walker_walk"])
def test_cli_dry_run_of_the_presets(tmp_path, exp):
    """The presets as users launch them, cut to a batch and sequence of two:
    CartPole rendered (the gym default), and DMC walker pixels with
    bf16-mixed and the memmap buffer."""
    proc = _dry_run(tmp_path, [f"exp={exp}"])
    if exp == "dreamer_v3_dmc_walker_walk" and proc.returncode != 0 and "GL" in proc.stderr:
        pytest.skip(f"dm_control rendering unavailable: {proc.stderr[-300:]}")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "Test - Reward:" in proc.stdout, proc.stdout[-3000:]
    cfg = json.loads(json.dumps(compose("config", [f"exp={exp}"]).to_dict()))
    assert cfg["buffer"]["memmap"] is True
    run_dir = next((tmp_path / "logs" / "runs").rglob("version_0"))
    # the memmap buffer's directories (its files, owned by the buffer, go with it at the end)
    assert sorted(p.name for p in (run_dir / "memmap_buffer" / "rank_0").iterdir()) == ["env_0", "env_1"]
    if exp == "dreamer_v3_dmc_walker_walk":
        assert cfg["fabric"]["precision"] == "bf16-mixed" and cfg["env"]["action_repeat"] == 2
        stream = (run_dir / "telemetry.jsonl").read_text().splitlines()
        assert any(r["event"] == "log" and r["step"] == 8 for r in map(json.loads, stream))


def test_cli_trains_through_env_crashes_on_the_ring(tmp_path):
    """The crashing dummy env under the loop, with the device ring forced
    on the CPU: restarts patch the buffer and reach the ring through
    mark_dirty, and the run ends."""
    proc = _dry_run(tmp_path, ["exp=dreamer_v3", "env=dummy", "env.id=crashing_dummy", "env.restart_on_exception=True",
                               "algo=dreamer_v3_XS",
                               "buffer.device_cache=true", "algo.mlp_keys.encoder=[state]"])
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[prefetch] DeviceRingPrefetcher" in proc.stderr
    assert "Test - Reward:" in proc.stdout
