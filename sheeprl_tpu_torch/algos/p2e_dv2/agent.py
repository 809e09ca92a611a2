"""Plan2Explore-DV2 agent (counterpart of ``sheeprl_tpu/algos/p2e_dv2/agent.py``).

DreamerV2's world model and task actor-critic (the critic with its
hard-copy target), an exploration actor and critic (with its own target),
and the ensembles, which predict the next discrete stochastic state from
the latent state and the action.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from ...models import build_ensembles
from ..dreamer_v2.agent import DV2Actor, build_actor_critic
from ..dreamer_v2.agent import build_agent as dv2_build_agent
from ..p2e_dv3.agent import frozen_copy

Actor = DV2Actor

__all__ = ["Actor", "build_agent"]


def build_agent(cfg: Any, observation_space: Any, actions_dim: Sequence[int], is_continuous: bool,
                device: torch.device) -> Dict[str, nn.Module]:
    """The modules on ``device``, freshly initialised from the torch global
    RNG: ``wm``, ``actor_task``, ``critic_task``, ``target_critic_task``,
    ``actor_exploration``, ``critic_exploration``,
    ``target_critic_exploration`` and ``ensembles`` (without LayerNorm, as
    the JAX package builds them, whatever ``algo.ensembles.layer_norm``
    says). Load converted weights with ``convert.load_p2e_dv2``."""
    wm_cfg = cfg.algo.world_model
    stoch_flat = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    latent_size = stoch_flat + int(wm_cfg.recurrent_model.recurrent_state_size)
    wm, actor, critic, target_critic = dv2_build_agent(cfg, observation_space, actions_dim, is_continuous, device)
    actor_exploration, critic_exploration = build_actor_critic(cfg, latent_size, actions_dim, is_continuous)
    ens = cfg.algo.ensembles
    ensembles = build_ensembles(int(ens.n), int(sum(actions_dim)) + latent_size, stoch_flat, int(ens.mlp_layers),
                                int(ens.dense_units), str(ens.dense_act))
    return {"wm": wm, "actor_task": actor, "critic_task": critic, "target_critic_task": target_critic,
            "actor_exploration": actor_exploration.to(device), "critic_exploration": critic_exploration.to(device),
            "target_critic_exploration": frozen_copy(critic_exploration).to(device),
            "ensembles": ensembles.to(device)}
