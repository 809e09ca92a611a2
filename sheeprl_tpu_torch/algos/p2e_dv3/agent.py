"""Plan2Explore-DV3 agent (counterpart of ``sheeprl_tpu/algos/p2e_dv3/agent.py``).

DreamerV3's world model and task actor-critic (with its target critic), an
exploration actor, a dict of exploration critics, one for each reward
stream of ``algo.critics_exploration`` (each with its own target), and the
ensembles, which predict the next stochastic state from the latent state
and the action.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Sequence

import torch
from torch import nn

from ...models import build_ensembles
from ..dreamer_v3.agent import Actor, DV3Head, build_actor_critic
from ..dreamer_v3.agent import build_agent as dv3_build_agent

__all__ = ["Actor", "build_agent"]


def frozen_copy(module: nn.Module) -> nn.Module:
    """A target network: a copy of ``module`` that takes no gradient."""
    target = copy.deepcopy(module)
    target.requires_grad_(False)
    return target


def build_agent(cfg: Any, observation_space: Any, actions_dim: Sequence[int], is_continuous: bool,
                device: torch.device) -> Dict[str, nn.Module]:
    """The modules on ``device``, freshly initialised from the torch global
    RNG: ``wm``, ``actor_task``, ``critic_task``, ``target_critic_task``,
    ``actor_exploration``, ``critics_exploration`` (an ``nn.ModuleDict`` of
    ``{name: {critic, target}}``) and ``ensembles`` (input ``sum(actions_dim)
    + stochastic + recurrent``, output the flat stochastic state). Load
    converted weights with ``convert.load_p2e_dv3``."""
    wm_cfg = cfg.algo.world_model
    stoch_flat = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    latent_size = stoch_flat + int(wm_cfg.recurrent_model.recurrent_state_size)
    wm, actor, critic, target_critic = dv3_build_agent(cfg, observation_space, actions_dim, is_continuous, device)
    actor_exploration, _ = build_actor_critic(cfg, latent_size, actions_dim, is_continuous)
    critics = nn.ModuleDict()
    for name in (cfg.algo.critics_exploration or {}):
        c = DV3Head(latent_size, int(cfg.algo.critic.bins), int(cfg.algo.critic.mlp_layers),
                    int(cfg.algo.critic.dense_units), out_scale=0.0)
        critics[name] = nn.ModuleDict({"critic": c, "target": frozen_copy(c)})
    ens = cfg.algo.ensembles
    ensembles = build_ensembles(int(ens.n), int(sum(actions_dim)) + latent_size, stoch_flat, int(ens.mlp_layers),
                                int(ens.dense_units), str(ens.dense_act))
    return {"wm": wm, "actor_task": actor, "critic_task": critic, "target_critic_task": target_critic,
            "actor_exploration": actor_exploration.to(device), "critics_exploration": critics.to(device),
            "ensembles": ensembles.to(device)}
