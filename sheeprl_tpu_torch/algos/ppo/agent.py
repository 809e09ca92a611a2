"""The PPO actor-critic (counterpart of ``sheeprl_tpu/algos/ppo/agent.py``).

``PPOEncoder`` concatenates NatureCNN features of the pixel keys and MLP
features of the vector keys; ``PPOAgent`` puts an actor trunk with one
categorical head per discrete action dim (or mean/log_std heads for a
continuous space) and an MLP critic on top. Submodules carry the flax
tree's names (``encoder.NatureCNN_0``, ``encoder.MLP_0``, ``actor_backbone``,
``critic``, ``actor_heads_<i>``, ``fc_mean``, ``fc_logstd``) so that
``convert.load_ppo`` maps the JAX package's parameters by a path rewrite.
Layers take flax's default init (lecun normal kernels, zero biases).

``actions_and_log_probs`` samples with pre-drawn noise (one gumbel tensor
per categorical head, one standard normal tensor for the Normal heads) or
draws it from the caller's ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...distributions import Categorical, Independent, Normal, gumbel_noise
from ...envs import spaces
from ...models import MLP, NatureCNN, lecun_normal_
from ...models.models import dense

LN_EPS = 1e-5  # the JAX package's LayerNorm default


def actions_dim_of(action_space: Any) -> Tuple[List[int], bool]:
    """(per-head action dims, is_continuous) of an action space."""
    if isinstance(action_space, spaces.Box):
        return [int(np.prod(action_space.shape))], True
    if isinstance(action_space, spaces.MultiDiscrete):
        return [int(n) for n in action_space.nvec], False
    return [int(action_space.n)], False


class PPOEncoder(nn.Module):
    def __init__(
        self,
        obs_space: Any,
        cnn_keys: Sequence[str],
        mlp_keys: Sequence[str],
        cnn_features_dim: int = 512,
        mlp_features_dim: int = 64,
        dense_units: int = 64,
        mlp_layers: int = 2,
        dense_act: str = "tanh",
        layer_norm: bool = False,
    ):
        super().__init__()
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.output_dim = 0
        if self.cnn_keys:
            shape = obs_space[self.cnn_keys[0]].shape
            channels = sum(int(obs_space[k].shape[-1]) for k in self.cnn_keys)
            self.NatureCNN_0 = NatureCNN(channels, (int(shape[-3]), int(shape[-2])), cnn_features_dim)
            self.output_dim += int(cnn_features_dim)
        if self.mlp_keys:
            in_dim = sum(int(np.prod(obs_space[k].shape)) for k in self.mlp_keys)
            self.MLP_0 = MLP(in_dim, (dense_units,) * mlp_layers, norm_eps=LN_EPS if layer_norm else None,
                             init=lecun_normal_, activation=dense_act, output_dim=mlp_features_dim or None)
            self.output_dim += self.MLP_0.output_dim

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        feats = []
        if self.cnn_keys:
            feats.append(self.NatureCNN_0(torch.cat([obs[k] for k in self.cnn_keys], dim=-1)))
        if self.mlp_keys:
            feats.append(self.MLP_0(torch.cat([obs[k].float() for k in self.mlp_keys], dim=-1)))
        return torch.cat(feats, dim=-1)


class PPOAgent(nn.Module):
    """``forward(obs)`` returns ``(actor_out, value)``: ``actor_out`` is a list
    of per-dim logits for (multi)discrete spaces or ``[mean, log_std]`` for a
    continuous one, ``value`` is ``[..., 1]``."""

    def __init__(
        self,
        obs_space: Any,
        actions_dim: Sequence[int],
        is_continuous: bool,
        cnn_keys: Sequence[str] = (),
        mlp_keys: Sequence[str] = (),
        cnn_features_dim: int = 512,
        mlp_features_dim: int = 64,
        dense_units: int = 64,
        mlp_layers: int = 2,
        dense_act: str = "tanh",
        layer_norm: bool = False,
    ):
        super().__init__()
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.encoder = PPOEncoder(obs_space, cnn_keys, mlp_keys, cnn_features_dim, mlp_features_dim, dense_units,
                                  mlp_layers, dense_act, layer_norm)
        trunk = dict(norm_eps=LN_EPS if layer_norm else None, init=lecun_normal_, activation=dense_act)
        feat = self.encoder.output_dim
        self.actor_backbone = MLP(feat, (dense_units,) * mlp_layers, **trunk)
        self.critic = MLP(feat, (dense_units,) * mlp_layers, output_dim=1, **trunk)
        hid = self.actor_backbone.output_dim
        if self.is_continuous:
            self.fc_mean = dense(hid, sum(self.actions_dim), init=lecun_normal_)
            self.fc_logstd = dense(hid, sum(self.actions_dim), init=lecun_normal_)
        else:
            for i, d in enumerate(self.actions_dim):
                setattr(self, f"actor_heads_{i}", dense(hid, d, init=lecun_normal_))

    def forward(self, obs: Dict[str, torch.Tensor]) -> Tuple[List[torch.Tensor], torch.Tensor]:
        feat = self.encoder(obs)
        value = self.critic(feat)
        actor_feat = self.actor_backbone(feat)
        if self.is_continuous:
            return [self.fc_mean(actor_feat), self.fc_logstd(actor_feat)], value
        return [getattr(self, f"actor_heads_{i}")(actor_feat) for i in range(len(self.actions_dim))], value


def actions_and_log_probs(
    actor_out: List[torch.Tensor],
    is_continuous: bool,
    noise: Optional[Sequence[torch.Tensor]] = None,
    actions: Optional[torch.Tensor] = None,
    greedy: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(actions, log_prob [..., 1], entropy [..., 1])``. With ``actions``
    given, evaluates them (the update); else samples (the rollout) from
    ``noise`` — a list of one gumbel tensor per categorical head, or
    ``[eps]`` for the Normal heads — or, without it, from ``generator``;
    ``greedy`` takes the mode. Discrete actions are int64 columns, one per
    action dim."""
    if is_continuous:
        mean, log_std = actor_out
        dist = Independent(Normal(mean, torch.exp(log_std)), 1)
        if actions is None:
            actions = dist.mode if greedy else dist.rsample(noise[0] if noise is not None else None, generator)
        return actions, dist.log_prob(actions)[..., None], dist.entropy()[..., None]
    logprobs, entropies, outs = [], [], []
    for i, logits in enumerate(actor_out):
        dist = Categorical(logits)
        if actions is not None:
            act = actions[..., i].long()
        elif greedy:
            act = dist.mode
        else:
            act = dist.sample(noise[i] if noise is not None else gumbel_noise(logits.shape, generator, logits.device))
        outs.append(act)
        logprobs.append(dist.log_prob(act))
        entropies.append(dist.entropy())
    return torch.stack(outs, dim=-1), sum(logprobs)[..., None], sum(entropies)[..., None]


def build_agent(cfg: Any, obs_space: Any, action_space: Any, device: torch.device) -> PPOAgent:
    """The agent of ``cfg.algo`` for these spaces, on ``device``."""
    actions_dim, is_continuous = actions_dim_of(action_space)
    enc = cfg.algo.encoder
    agent = PPOAgent(
        obs_space,
        actions_dim,
        is_continuous,
        cnn_keys=tuple(cfg.algo.cnn_keys.encoder),
        mlp_keys=tuple(cfg.algo.mlp_keys.encoder),
        cnn_features_dim=int(enc.cnn_features_dim),
        mlp_features_dim=int(enc.mlp_features_dim),
        dense_units=int(cfg.algo.dense_units),
        mlp_layers=int(cfg.algo.mlp_layers),
        dense_act=str(cfg.algo.dense_act),
        layer_norm=bool(cfg.algo.layer_norm),
    )
    return agent.to(device)
