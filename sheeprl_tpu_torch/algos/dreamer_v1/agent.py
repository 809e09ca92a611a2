"""DreamerV1 agent in PyTorch (counterpart of
``sheeprl_tpu/algos/dreamer_v1/agent.py``).

DreamerV1 takes DreamerV2's encoder, decoder, heads and actor (with its
action sampling and exploration noise) and swaps the RSSM:

* the stochastic state is a diagonal Gaussian, ``std = softplus(raw) +
  min_std`` (``compute_stochastic_state``; ``noise`` a standard normal);
* the recurrent model is a Dense, the activation and flax's ``GRUCell``
  (``models.GRUCell``, with flax's parameters), not the LN-GRU;
* ``dynamic`` has no ``is_first`` reset.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...models import MLP, GRUCell, get_activation, lecun_normal_
from ...models.models import dense
from ..dreamer_v2.agent import (  # noqa: F401 - DreamerV2's pieces, as in the JAX package
    DV2Actor,
    DV2Head,
    DV2WorldModel,
    build_actor_critic,
    build_encoder_decoder,
    dv2_actor_dists,
    dv2_exploration_noise,
    dv2_sample_actions,
)

Actor = DV2Actor


def compute_stochastic_state(state_information: torch.Tensor, noise: Optional[torch.Tensor] = None,
                             min_std: float = 0.1, generator: Optional[torch.Generator] = None,
                             sample: bool = True) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The Gaussian state from concatenated (mean, raw std): ``std =
    softplus(raw) + min_std``; returns ((mean, std), mean + std·noise), or
    the mean without ``sample``."""
    mean, std = torch.chunk(state_information, 2, dim=-1)
    std = F.softplus(std) + min_std
    if not sample:
        return (mean, std), mean
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    return (mean, std), mean + std * noise


class DV1RecurrentModel(nn.Module):
    """Dense → activation → flax's GRU cell, both ``recurrent_state_size``
    wide."""

    def __init__(self, input_size: int, recurrent_state_size: int, activation: str = "elu"):
        super().__init__()
        self.act = get_activation(activation)
        self.fc = dense(input_size, recurrent_state_size, bias=True, init=lecun_normal_)
        self.gru = GRUCell(recurrent_state_size, recurrent_state_size)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.gru(h, self.act(self.fc(x)))


class _DV1StochHead(nn.Module):
    """One hidden layer and the (mean, raw std) head."""

    def __init__(self, input_size: int, hidden_size: int, stochastic_size: int, activation: str = "elu"):
        super().__init__()
        self.MLP_0 = MLP(input_size, (hidden_size,), init=lecun_normal_, activation=activation)
        self.mean_std = dense(hidden_size, 2 * stochastic_size, bias=True, init=lecun_normal_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mean_std(self.MLP_0(x))


class DV1RSSM(nn.Module):
    """The Gaussian RSSM: every method is one step; ``noise`` is a standard
    normal [B, S]."""

    def __init__(self, embed_size: int, action_size: int, stochastic_size: int = 30, recurrent_state_size: int = 200,
                 hidden_size: int = 200, representation_hidden_size: Optional[int] = None, min_std: float = 0.1,
                 dense_act: str = "elu"):
        super().__init__()
        self.stochastic_size = stochastic_size
        self.recurrent_state_size = recurrent_state_size
        self.stoch_width = stochastic_size
        self.min_std = float(min_std)
        self.recurrent_model = DV1RecurrentModel(stochastic_size + action_size, recurrent_state_size, dense_act)
        self.representation = _DV1StochHead(recurrent_state_size + embed_size,
                                            representation_hidden_size or hidden_size, stochastic_size, dense_act)
        self.transition = _DV1StochHead(recurrent_state_size, hidden_size, stochastic_size, dense_act)

    def dynamic(self, posterior, recurrent_state, action, embedded_obs, noise=None, generator=None):
        """One recurrent step; the prior's (mean, std), the posterior's and a
        posterior sample → (h, posterior, (post_mean, post_std),
        (prior_mean, prior_std))."""
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], dim=-1), recurrent_state)
        prior_ms, _ = compute_stochastic_state(self.transition(recurrent_state), min_std=self.min_std, sample=False)
        post_ms, posterior = compute_stochastic_state(
            self.representation(torch.cat([recurrent_state, embedded_obs], dim=-1)), noise, self.min_std, generator)
        return recurrent_state, posterior, post_ms, prior_ms

    def imagination(self, stochastic_state, recurrent_state, action, noise=None, generator=None):
        recurrent_state = self.recurrent_model(torch.cat([stochastic_state, action], dim=-1), recurrent_state)
        _, prior = compute_stochastic_state(self.transition(recurrent_state), noise, self.min_std, generator)
        return prior, recurrent_state

    def representation_step(self, recurrent_state, embedded_obs, noise=None, generator=None):
        _, posterior = compute_stochastic_state(
            self.representation(torch.cat([recurrent_state, embedded_obs], dim=-1)), noise, self.min_std, generator)
        return posterior


def build_agent(cfg: Any, observation_space: Any, actions_dim: Sequence[int], is_continuous: bool,
                device: torch.device):
    """(world_model, actor, critic, None) on ``device`` (DreamerV1 has no
    target critic), freshly initialised from the torch global RNG; load
    converted weights with ``convert.load_dreamer_v1``."""
    wm_cfg = cfg.algo.world_model
    dense_act = str(cfg.algo.dense_act)
    S = int(wm_cfg.stochastic_size)
    R = int(wm_cfg.recurrent_model.recurrent_state_size)
    latent_size = S + R
    encoder, decoder = build_encoder_decoder(cfg, observation_space, latent_size, layer_norm=False)
    rssm = DV1RSSM(
        embed_size=encoder.output_dim,
        action_size=int(sum(actions_dim)),
        stochastic_size=S,
        recurrent_state_size=R,
        hidden_size=int(wm_cfg.transition_model.hidden_size),
        representation_hidden_size=int(wm_cfg.representation_model.hidden_size),
        min_std=float(wm_cfg.min_std),
        dense_act=dense_act,
    )
    reward = DV2Head(latent_size, 1, int(wm_cfg.reward_model.mlp_layers), int(wm_cfg.reward_model.dense_units),
                     False, dense_act)
    cont = None
    if bool(wm_cfg.use_continues):
        cont = DV2Head(latent_size, 1, int(wm_cfg.discount_model.mlp_layers),
                       int(wm_cfg.discount_model.dense_units), False, dense_act)
    world_model = DV2WorldModel(encoder, rssm, decoder, reward, cont)
    actor, critic = build_actor_critic(cfg, latent_size, actions_dim, is_continuous, layer_norm=False)
    return world_model.to(device), actor.to(device), critic.to(device), None


__all__ = ["Actor", "DV1RSSM", "DV1RecurrentModel", "build_agent", "compute_stochastic_state", "dv2_actor_dists",
           "dv2_exploration_noise", "dv2_sample_actions"]
