"""The port's gymnasium-free env stack (its own spaces, same-step-autoreset
vector env and episode statistics) against the JAX package's gymnasium
vector env on the dummy env: same observations, rewards, done flags, final
observations and episode statistics, step for step."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import numpy as np
import pytest

from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.utils.env import episode_stats as jax_episode_stats
from sheeprl_tpu.utils.env import vectorize as jax_vectorize
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.utils.env import episode_stats, vectorize

ARGS = ["exp=dreamer_v3", "env=dummy", "env.num_envs=3", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]"]


@pytest.mark.parametrize(
    "env_id,limit", [("discrete_dummy", 0), ("multidiscrete_dummy", 4), ("continuous_dummy", 3)]
)
def test_vector_env_matches_gymnasium(env_id, limit):
    """Episodes end by termination (discrete, 5 steps) or by the time limit."""
    args = ARGS + [f"env.id={env_id}", f"env.max_episode_steps={limit}"]
    ours = vectorize(compose("config", args), 5, 0)
    ref = jax_vectorize(jax_compose("config", args + ["env.sync_env=True"]), 5, 0)
    assert ours.single_observation_space["rgb"].shape == ref.single_observation_space["rgb"].shape
    assert type(ours.single_action_space).__name__ == type(ref.single_action_space).__name__
    o1, _ = ours.reset(seed=5)
    o2, _ = ref.reset(seed=5)
    n_done = 0
    for step in range(13):
        for k in o2:
            np.testing.assert_array_equal(o1[k], o2[k])
        actions = np.stack([ref.single_action_space.sample() for _ in range(3)])
        o1, r1, te1, tr1, i1 = ours.step(actions)
        o2, r2, te2, tr2, i2 = ref.step(actions)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(te1, te2)
        np.testing.assert_array_equal(tr1, tr2)
        assert list(episode_stats(i1)) == list(jax_episode_stats(i2))
        assert ("final_obs" in i1) == ("final_obs" in i2)
        if "final_obs" in i2:
            n_done += 1
            for a, b in zip(i1["final_obs"], i2["final_obs"]):
                assert (a is None) == (b is None)
                if b is not None:
                    for k in b:
                        np.testing.assert_array_equal(a[k], b[k])
    assert n_done > 0
    ours.close()
    ref.close()


def test_spaces_sample_within_bounds():
    box = spaces.Box(-1.0, 1.0, (4,), np.float32, seed=0)
    assert all(np.all(np.abs(box.sample()) <= 1.0) for _ in range(20))
    img = spaces.Box(0, 255, (2, 2, 3), np.uint8, seed=0)
    assert img.sample().dtype == np.uint8
    d = spaces.Discrete(3, seed=1)
    assert {int(d.sample()) for _ in range(50)} == {0, 1, 2}
    md = spaces.MultiDiscrete([2, 5], seed=2)
    s = np.stack([md.sample() for _ in range(50)])
    assert s.shape == (50, 2) and s[:, 0].max() == 1 and s[:, 1].max() == 4
