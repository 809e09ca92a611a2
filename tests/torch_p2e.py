"""Shared set-up of the Plan2Explore parity tests (tests/test_torch_p2e_dv3.py,
test_torch_p2e_dv2.py, test_torch_p2e_dv1.py): the JAX package's and the
port's configs at tiny widths, the agents on both sides from the same
converted parameters, the JAX optimizers and their states, the draws the
JAX exploration step makes from its keys (``k_dyn, k_img_expl, k_img_task =
split(key, 3)``) in the port's noise layout, and the comparisons of every
parameter group, Adam state and Moments.

Run as a script, it prints the largest differences those tests see (the
values their docstrings state as measured):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_p2e.py
"""
from __future__ import annotations

import functools
from importlib import import_module
from typing import Any, Dict, Sequence, Tuple

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import torch

from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.optim import clipped as jax_clipped
from sheeprl_tpu_torch import convert
from sheeprl_tpu_torch.envs import spaces
from torch_dreamer import TINY_V1, TINY_V2, _action_draws, actions_dim, jax_spaces, torch_spaces
from torch_offpolicy import adam_diff, configs, dist, max_diff, numpy_tree, t  # noqa: F401 - re-exported

N_ACT = 4
# DreamerV3 at the JAX package's tiny test widths (tests/dreamer_tiny.py),
# two MLP layers, three ensemble members and a target update every second step
TINY_DV3 = [
    "env=dummy", "env.id=discrete_dummy", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=4",
    "algo.horizon=3", "algo.dense_units=16", "algo.mlp_layers=2", "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.recurrent_model.dense_units=16",
    "algo.world_model.transition_model.hidden_size=16", "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.discrete_size=4", "algo.world_model.stochastic_size=4", "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[]", "algo.world_model.conv_impl=xla", "algo.ensembles.n=3",
    "algo.critic.per_rank_target_network_update_freq=2",
]
DV3_OBS = {"rgb": (64, 64, 3)}
# the optimizers of each variant's exploration step, and their config sections
TXS = {"wm": "world_model", "ensembles": "ensembles", "actor_task": "actor", "critic_task": "critic",
       "actor_exploration": "actor", "critic_exploration": "critic"}


def dv3_spaces():
    return (gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, DV3_OBS["rgb"], np.uint8)}),
            spaces.Dict({"rgb": spaces.Box(0, 255, DV3_OBS["rgb"], np.uint8)}))


def dv3_batch(rng: np.random.Generator, G: int, T: int, B: int) -> Dict[str, np.ndarray]:
    """A random [G, T, B, ...] DreamerV3 replay batch (an episode boundary
    and terminations inside)."""
    lead = (G, T, B)
    return {
        "rgb": rng.integers(0, 255, (*lead, *DV3_OBS["rgb"]), np.uint8),
        "actions": np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, lead)],
        "rewards": rng.standard_normal((*lead, 1)).astype(np.float32),
        "terminated": (rng.random((*lead, 1)) < 0.2).astype(np.float32),
        "truncated": np.zeros((*lead, 1), np.float32),
        "is_first": (rng.random((*lead, 1)) < 0.2).astype(np.float32),
    }


def condition_two_hot_heads(params: Dict[str, Any], seed: int = 5) -> Dict[str, Any]:
    """Bumps of logits around a middle bin on every two-hot head (the reward
    head, the task critic and each exploration critic, their targets
    copied): from their zero init a two-hot mean is f32 cancellation noise
    that no two implementations share (tests/test_torch_dreamer_v3.py)."""
    rng = np.random.default_rng(seed)

    def bump(tree, centre):
        n_in, bins = tree["out"]["kernel"].shape
        tree["out"]["kernel"] = (0.1 * rng.standard_normal((n_in, bins))).astype(np.float32)
        tree["out"]["bias"] = (-(((np.arange(bins) - centre) / 20.0) ** 2)).astype(np.float32)

    bump(params["wm"]["reward"], 140)
    bump(params["critic_task"], 127)
    params["target_critic_task"] = jax.tree.map(np.copy, params["critic_task"])
    for i, c in enumerate(params["critics_exploration"].values()):
        bump(c["critic"], 120 + 5 * i)
        c["target"] = jax.tree.map(np.copy, c["critic"])
    return params


def jax_txs(jcfg, names: Sequence[str]) -> Dict[str, Any]:
    a = jcfg.algo
    return {k: jax_clipped(jax_instantiate(getattr(a, TXS[k]).optimizer), getattr(a, TXS[k]).clip_gradients)
            for k in names}


def dv3_agents(overrides: Sequence[str] = (), seed: int = 0):
    """(jcfg, tcfg, (wm, actor, critic, ens_apply) flax modules, params as
    numpy (two-hot heads conditioned), port modules loaded with them)."""
    from sheeprl_tpu.algos.p2e_dv3.agent import build_agent as jax_build

    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent as torch_build

    jcfg, tcfg = configs("p2e_dv3_exploration", [*TINY_DV3, *overrides])
    tcfg.set_path("fabric.accelerator", "cpu")
    jo, to = dv3_spaces()
    wm, actor, critic, ens_apply, params = jax_build(dist(), jcfg, jo, [N_ACT], False, jax.random.PRNGKey(seed))
    params = condition_two_hot_heads(numpy_tree(params))
    torch.manual_seed(seed)
    mods = torch_build(tcfg, to, [N_ACT], False, torch.device("cpu"))
    convert.load_p2e_dv3(params, mods)
    return jcfg, tcfg, (wm, actor, critic, ens_apply), params, mods


def dreamer_agents(variant: str, overrides: Sequence[str], continuous: bool, seed: int = 0):
    """P2E-DV2 or DV1 (``variant`` "dv2" / "dv1") at the DreamerV1/V2 tests'
    widths (tests/torch_dreamer.py), three ensemble members: (jcfg, tcfg,
    flax (wm, actor, critic, ens_apply), params as numpy, port modules)."""
    base = TINY_V2 if variant == "dv2" else TINY_V1
    jcfg, tcfg = configs(f"p2e_{variant}_exploration", [*base, "algo.ensembles.n=3", *overrides])
    tcfg.set_path("fabric.accelerator", "cpu")
    params = jax.tree.map(np.copy, _jax_dreamer_params(variant, tuple(overrides), continuous, seed))
    jagent = import_module(f"sheeprl_tpu.algos.p2e_{variant}.agent")
    tagent = import_module(f"sheeprl_tpu_torch.algos.p2e_{variant}.agent")
    jo, _ = jax_spaces(continuous)
    wm, actor, critic, ens_apply, _ = jagent.build_agent(dist(), jcfg, jo, actions_dim(continuous), continuous,
                                                         jax.random.PRNGKey(seed))
    to, _ = torch_spaces(continuous)
    torch.manual_seed(seed)
    mods = tagent.build_agent(tcfg, to, actions_dim(continuous), continuous, torch.device("cpu"))
    convert.load_p2e(params, mods)
    return jcfg, tcfg, (wm, actor, critic, ens_apply), params, mods


@functools.lru_cache(maxsize=None)
def _jax_dreamer_params(variant: str, overrides: Tuple[str, ...], continuous: bool, seed: int):
    base = TINY_V2 if variant == "dv2" else TINY_V1
    jcfg, _ = configs(f"p2e_{variant}_exploration", [*base, "algo.ensembles.n=3", *overrides])
    jagent = import_module(f"sheeprl_tpu.algos.p2e_{variant}.agent")
    jo, _ = jax_spaces(continuous)
    *_, params = jagent.build_agent(dist(), jcfg, jo, actions_dim(continuous), continuous, jax.random.PRNGKey(seed))
    return numpy_tree(params)


def jax_dv3_rollout_noise(key, cfg, TB: int) -> Dict[str, torch.Tensor]:
    """The draws the JAX P2E-DV3 ``rollout`` makes from ``key``: ``k0, key =
    split(key)``, the first actions from ``k0``; ``split(key, horizon)``,
    each split into the prior's and the actions' key."""
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    k0, k = jax.random.split(key)
    img_z, img_a = [], []
    for ks in jax.random.split(k, int(cfg.algo.horizon)):
        k_img_s, k_a = jax.random.split(ks)
        img_z.append(jax.random.gumbel(k_img_s, (TB, S, D)))
        img_a.append(jax.random.gumbel(jax.random.split(k_a, 1)[0], (TB, N_ACT)))
    return {"act0": [t(jax.random.gumbel(jax.random.split(k0, 1)[0], (TB, N_ACT)))], "img_z": t(jnp.stack(img_z)),
            "img_a": [t(jnp.stack(img_a))]}


def jax_dv3_noise(key, cfg, T: int, B: int) -> Dict[str, Any]:
    """The P2E-DV3 exploration step's draws from ``key`` (the coupled scan's
    posterior gumbels from ``split(k_dyn, T)``)."""
    S, D = int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size)
    k_dyn, k_img_expl, k_img_task = jax.random.split(key, 3)
    post = jnp.stack([jax.random.gumbel(k, (B, S, D)) for k in jax.random.split(k_dyn, T)])
    return {"post": t(post), "exploration": jax_dv3_rollout_noise(k_img_expl, cfg, T * B),
            "task": jax_dv3_rollout_noise(k_img_task, cfg, T * B)}


def jax_dreamer_noise(key, cfg, continuous: bool, T: int, B: int, gaussian: bool) -> Dict[str, Any]:
    """The P2E-DV2 (gumbel) or DV1 (``gaussian``) exploration step's draws
    from ``key``: ``split(k_dyn, T)`` the posterior's; each rollout's
    ``split(k, horizon)``, each split into an action key and a prior key."""
    wm_cfg = cfg.algo.world_model
    S = int(wm_cfg.stochastic_size)
    state_shape = (S,) if gaussian else (S, int(wm_cfg.discrete_size))
    draw = jax.random.normal if gaussian else jax.random.gumbel
    dist_type = str(cfg.select("distribution.type") or "auto")
    TB = T * B
    k_dyn, k_img_expl, k_img_task = jax.random.split(key, 3)

    def rollout(k_img):
        img_a, img_z = [], []
        for k in jax.random.split(k_img, int(cfg.algo.horizon)):
            k_a, k_i = jax.random.split(k)
            img_a.append(_action_draws(k_a, dist_type, continuous, (TB,)))
            img_z.append(np.asarray(draw(k_i, (TB, *state_shape))))
        return {"img_a": [t(np.stack([a[j] for a in img_a])) for j in range(len(img_a[0]))],
                "img_z": t(np.stack(img_z))}

    post = np.stack([np.asarray(draw(k, (B, *state_shape))) for k in jax.random.split(k_dyn, T)])
    return {"post": t(post), "exploration": rollout(k_img_expl), "task": rollout(k_img_task)}


def moments_diff(got, want) -> float:
    """|port - JAX| of a MomentsState (low, high)."""
    return max(abs(float(got.low) - float(np.asarray(want[0]))), abs(float(got.high) - float(np.asarray(want[1]))))


def modules_diff(mods: Dict[str, torch.nn.Module], params: Dict[str, Any], atol: float) -> Dict[str, float]:
    """Every parameter group of ``mods`` against the flax tree ``params``
    (``max_diff``); the largest difference of each."""
    return {k: max_diff(m, params[k], atol, k) for k, m in mods.items()}


def optimizers_diff(optimizers, mods: Dict[str, torch.nn.Module], opt_states: Dict[str, Any], rtol: float) -> float:
    """Every optimizer's Adam state against optax's (``adam_diff``); the
    largest relative difference."""
    worst = 0.0
    for name in optimizers.names:
        opt = getattr(optimizers, name)
        if isinstance(opt, dict):
            for k, o in opt.items():
                worst = max(worst, adam_diff(o.optimizer, mods[name][k]["critic"], opt_states[name][k], rtol, (name, k)))
        else:
            worst = max(worst, adam_diff(opt.optimizer, mods[name], opt_states[name], rtol, name))
    return worst


def report(files=("test_torch_p2e_dv3.py", "test_torch_p2e_dv2.py", "test_torch_p2e_dv1.py",
                  "test_torch_ensembles.py")) -> None:
    """Run the Plan2Explore parity tests in this process and print, per test
    case, the largest absolute and relative difference its
    ``np.testing.assert_allclose`` calls compared, the largest parameter
    difference, the largest Moments difference and the largest relative
    difference of the Adam moments: the "measured" values the tests'
    docstrings state."""
    import collections
    import os
    import sys

    import pytest

    import torch_offpolicy

    helper = sys.modules[__name__]
    sys.modules.setdefault("torch_p2e", helper)  # the tests import this module by that name
    worst = collections.defaultdict(lambda: collections.defaultdict(float))
    in_adam = [False]

    def note(key, value):
        w = worst[os.environ.get("PYTEST_CURRENT_TEST", "?").rsplit(" ", 1)[0]]
        w[key] = max(w[key], float(value))

    assert_allclose = np.testing.assert_allclose

    def recording(actual, desired, rtol=1e-7, atol=0, **kw):
        a, d = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
        diff = np.abs(a - d)
        if diff.size:
            note("max_abs", diff.max())
            note("max_rel", (diff / np.maximum(np.abs(d), 1e-30)).max())
        return assert_allclose(actual, desired, rtol=rtol, atol=atol, **kw)

    check = torch_offpolicy._check

    def recording_check(got, want, tol, what, outliers=None):
        if got.numel():
            note("moments_rel_max" if in_adam[0] else "params_abs_max", (got - want).abs().max())
        return check(got, want, tol, what, outliers)

    adam, moments = helper.adam_diff, helper.moments_diff

    def recording_adam(*args, **kwargs):
        in_adam[0] = True
        try:
            return adam(*args, **kwargs)
        finally:
            in_adam[0] = False

    def recording_moments(got, want):
        d = moments(got, want)
        note("moments_abs_max", d)
        return d

    np.testing.assert_allclose = recording
    torch_offpolicy._check = recording_check
    helper.adam_diff, helper.moments_diff = recording_adam, recording_moments
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main([*(os.path.join(here, f) for f in files), "-q", "-p", "no:cacheprovider"])
    for name, w in sorted(worst.items()):
        print(name, {k: float(f"{v:.2g}") for k, v in sorted(w.items())})
    print("pytest exit", rc)


if __name__ == "__main__":
    report()
