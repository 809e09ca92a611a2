"""Shared set-up of the DreamerV1/V2 parity tests (tests/test_torch_dreamer_v2.py,
test_torch_dreamer_v1.py): the JAX package's and the port's configs at the
JAX package's CLI-test sizes (dense 8, one MLP layer, multiplier 2,
recurrent 16, stochastic 4x4), agents on both sides from the same converted
parameters, random replay batches made from a numpy seed, and the draws the
JAX train step and player make from their keys, in the port's noise
layout.

Run as a script, it prints the largest differences those tests see (the
values their docstrings state as measured):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_dreamer.py
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Sequence, Tuple

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import torch

from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.optim import clipped as jax_clipped
from sheeprl_tpu_torch.envs import spaces
from torch_offpolicy import configs, dist, jit_build, numpy_tree, t  # noqa: F401 - re-exported

IMG = (64, 64, 3)
STATE = 6
N_ACT = 3  # discrete actions
C_ACT = 2  # continuous action width
F32_EPS = float(jnp.finfo(jnp.float32).eps)
TINY = ["env=dummy", "algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
        "algo.world_model.recurrent_model.recurrent_state_size=16", "algo.world_model.transition_model.hidden_size=8",
        "algo.world_model.representation_model.hidden_size=8", "algo.per_rank_batch_size=2",
        "algo.per_rank_sequence_length=3", "algo.horizon=4", "algo.cnn_keys.encoder=[rgb]",
        "algo.mlp_keys.encoder=[state]"]
TINY_V2 = TINY + ["algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4"]
TINY_V1 = TINY + ["algo.world_model.stochastic_size=4"]


def jax_spaces(continuous: bool):
    obs = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, IMG, np.uint8),
                           "state": gym.spaces.Box(-20, 20, (STATE,), np.float32)})
    act = gym.spaces.Box(-1.0, 1.0, (C_ACT,), np.float32) if continuous else gym.spaces.Discrete(N_ACT)
    return obs, act


def torch_spaces(continuous: bool):
    obs = spaces.Dict({"rgb": spaces.Box(0, 255, IMG, np.uint8), "state": spaces.Box(-20, 20, (STATE,), np.float32)})
    act = spaces.Box(-1.0, 1.0, (C_ACT,), np.float32) if continuous else spaces.Discrete(N_ACT)
    return obs, act


def actions_dim(continuous: bool) -> List[int]:
    return [C_ACT] if continuous else [N_ACT]


# the overrides that change the parameter tree (the others share one init)
SHAPE_KEYS = ("algo.layer_norm", "algo.world_model.use_continues", "algo.world_model.encoder.cnn_channels_multiplier")


def agents(exp: str, overrides: Sequence[str], continuous: bool, conv_impl: str = "xla", seed: int = 0):
    """(jcfg, tcfg, (wm, actor, critic) flax modules, params, port modules
    (wm, actor, critic, target_critic or None)), the port's loaded with the
    JAX parameters."""
    from importlib import import_module

    from sheeprl_tpu_torch import convert

    base = TINY_V2 if exp.startswith("dreamer_v2") else TINY_V1
    jcfg, tcfg = configs(exp, [*base, f"algo.world_model.conv_impl={conv_impl}", *overrides])
    jagent = import_module(f"sheeprl_tpu.algos.{exp[:10]}.agent")
    tagent = import_module(f"sheeprl_tpu_torch.algos.{exp[:10]}.agent")
    jo, _ = jax_spaces(continuous)
    adim = actions_dim(continuous)
    wm, actor, critic, _ = jagent.build_agent(dist(), jcfg, jo, adim, continuous, None, state={})
    shape = tuple(o for o in overrides if o.startswith(SHAPE_KEYS))
    params = jax.tree.map(np.copy, _jax_params(exp, shape, continuous, seed))
    to, _ = torch_spaces(continuous)
    torch.manual_seed(seed)
    mods = tagent.build_agent(tcfg, to, adim, continuous, torch.device("cpu"))
    if mods[3] is None:
        convert.load_dreamer_v1(params, *mods[:3])
    else:
        convert.load_dreamer_v2(params, *mods)
    return jcfg, tcfg, (wm, actor, critic), params, mods


@functools.lru_cache(maxsize=None)
def _jax_params(exp: str, shape_overrides: Tuple[str, ...], continuous: bool, seed: int):
    """The JAX package's ``build_agent`` parameters of one parameter tree
    (``conv_impl`` does not change the tree), made once per test process."""
    from importlib import import_module

    base = TINY_V2 if exp.startswith("dreamer_v2") else TINY_V1
    jcfg, _ = configs(exp, [*base, *shape_overrides])
    jagent = import_module(f"sheeprl_tpu.algos.{exp[:10]}.agent")
    jo, _ = jax_spaces(continuous)
    *_, params = jit_build(lambda k: jagent.build_agent(dist(), jcfg, jo, actions_dim(continuous), continuous, k),
                           jax.random.PRNGKey(seed))
    return numpy_tree(params)


def jax_txs(jcfg) -> Dict[str, Any]:
    a = jcfg.algo
    return {"wm": jax_clipped(jax_instantiate(a.world_model.optimizer), a.world_model.clip_gradients),
            "actor": jax_clipped(jax_instantiate(a.actor.optimizer), a.actor.clip_gradients),
            "critic": jax_clipped(jax_instantiate(a.critic.optimizer), a.critic.clip_gradients)}


def obs_batch(rng: np.random.Generator, lead: Sequence[int]) -> Dict[str, np.ndarray]:
    return {"rgb": rng.integers(0, 256, (*lead, *IMG), dtype=np.uint8),
            "state": rng.standard_normal((*lead, STATE)).astype(np.float32)}


def replay_batch(rng: np.random.Generator, lead: Sequence[int], continuous: bool) -> Dict[str, np.ndarray]:
    """A random ``[*lead, ...]`` Dreamer replay batch: images uint8, a vector
    key, actions (one-hot or in [-1, 1]), rewards, ``terminated``,
    ``truncated`` and ``is_first`` (an episode boundary inside)."""
    lead = tuple(lead)
    out = obs_batch(rng, lead)
    if continuous:
        out["actions"] = rng.uniform(-1, 1, (*lead, C_ACT)).astype(np.float32)
    else:
        out["actions"] = np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, lead)]
    out["rewards"] = rng.standard_normal((*lead, 1)).astype(np.float32)
    out["terminated"] = (rng.random((*lead, 1)) < 0.2).astype(np.float32)
    out["truncated"] = np.zeros((*lead, 1), np.float32)
    out["is_first"] = (rng.random((*lead, 1)) < 0.3).astype(np.float32)
    return out


def _action_draws(key, dist_type: str, continuous: bool, lead: Sequence[int]) -> List[np.ndarray]:
    """The draws ``dv2_sample_actions`` makes from ``key``, per head."""
    lead = tuple(lead)
    if not continuous:
        return [np.asarray(jax.random.gumbel(k, (*lead, N_ACT))) for k in jax.random.split(key, 1)]
    if dist_type in ("tanh_normal", "normal"):
        return [np.asarray(jax.random.normal(key, (*lead, C_ACT)))]
    return [np.asarray(jax.random.uniform(key, (*lead, C_ACT), minval=F32_EPS, maxval=1 - F32_EPS))]


def jax_train_noise(key, cfg, continuous: bool, T: int, B: int, gaussian: bool = False) -> Dict[str, Any]:
    """The draws the JAX ``one_step`` makes from ``key`` in the layout of the
    port's ``draw_train_noise``: ``split(key, 2)`` into ``k_dyn`` and
    ``k_img``; ``split(k_dyn, T)`` the posterior draws; ``split(k_img,
    horizon)`` the imagination keys, each split into an action key and a
    prior key. ``gaussian``: DreamerV1's normal state draws, else gumbel."""
    wm_cfg = cfg.algo.world_model
    S = int(wm_cfg.stochastic_size)
    state_shape = (S,) if gaussian else (S, int(wm_cfg.discrete_size))
    draw = jax.random.normal if gaussian else jax.random.gumbel
    horizon, TB = int(cfg.algo.horizon), T * B
    dist_type = str(cfg.select("distribution.type") or "auto")
    k_dyn, k_img = jax.random.split(key, 2)
    post = np.stack([np.asarray(draw(k, (B, *state_shape))) for k in jax.random.split(k_dyn, T)])
    img_a, img_z = [], []
    for k in jax.random.split(k_img, horizon):
        k_a, k_i = jax.random.split(k)
        img_a.append(_action_draws(k_a, dist_type, continuous, (TB,)))
        img_z.append(np.asarray(draw(k_i, (TB, *state_shape))))
    return {"post": t(post), "img_a": [t(np.stack([a[j] for a in img_a])) for j in range(len(img_a[0]))],
            "img_z": t(np.stack(img_z))}


def jax_player_noise(key, cfg, continuous: bool, n: int, gaussian: bool = False) -> Dict[str, Any]:
    """The draws the JAX player step makes from ``key``: ``split(key, 4)``
    → (next key, representation, actions, exploration); each exploration
    head takes ``split(k3, heads)``, a discrete one split again into the
    random action's gumbel and the replacement uniform."""
    wm_cfg = cfg.algo.world_model
    S = int(wm_cfg.stochastic_size)
    dist_type = str(cfg.select("distribution.type") or "auto")
    _, k1, k2, k3 = jax.random.split(key, 4)
    repr_ = (jax.random.normal(k1, (n, S)) if gaussian
             else jax.random.gumbel(k1, (n, S, int(wm_cfg.discrete_size))))
    expl = []
    for k in jax.random.split(k3, 1):
        if continuous:
            expl.append((t(jax.random.normal(k, (n, C_ACT))),))
        else:
            ka, kb = jax.random.split(k)
            expl.append((t(jax.random.gumbel(ka, (n, N_ACT))), t(jax.random.uniform(kb, (n, 1)))))
    return {"repr": t(repr_), "act": [t(a) for a in _action_draws(k2, dist_type, continuous, (n,))], "expl": expl}


if __name__ == "__main__":
    import torch_offpolicy

    torch_offpolicy.report(("test_torch_dreamer_v2", "test_torch_dreamer_v1"),
                           ("cli", "compose", "selectable", "fleet", "alone"))
