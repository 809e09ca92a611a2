"""The recurrent PPO agent (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/agent.py``).

Sequences are time-major ``[L, B, ...]``. The LSTM steps over fixed-length
sequences with an ``is_first`` reset mask applied inside the loop, as the
JAX package's scan does: where ``is_first`` is set the carry is zeroed
before the step. The carry is ``(c, h)``, as flax's ``OptimizedLSTMCell``
carries it.

``ResetLSTMCell.lstm`` is an ``nn.LSTMCell``: its ``weight_ih`` [4H, in]
stacks flax's input kernels ``ii, if, ig, io`` (no bias) and ``weight_hh``
[4H, H] the hidden kernels ``hi, hf, hg, ho``; flax's hidden biases go in
``bias_hh``, and ``bias_ih`` is zero and frozen (trained, it would take the
same gradient as ``bias_hh`` and double the bias's step), so the cell
computes flax's function (``convert.load_ppo_recurrent``).
Init as flax's: lecun normal input kernels, orthogonal hidden kernels,
zero biases. Submodule names follow the flax tree (``feature_extractor``,
``pre_rnn_mlp``, ``rnn``, ``post_rnn_mlp``, ``critic``, ``actor_backbone``,
``actor_head`` / ``actor_head_<i>``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch import nn

from ...models import MLP, lecun_normal_
from ...models.models import dense
from ..ppo.agent import LN_EPS, PPOEncoder, actions_and_log_probs, actions_dim_of

__all__ = ["RecurrentPPOAgent", "ResetLSTMCell", "actions_and_log_probs", "build_agent"]

Carry = Tuple[torch.Tensor, torch.Tensor]


class ResetLSTMCell(nn.Module):
    """An LSTM cell that zeroes its ``(c, h)`` carry where ``is_first`` is set."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.lstm = nn.LSTMCell(input_size, hidden_size)
        with torch.no_grad():
            for g in range(4):
                rows = slice(g * hidden_size, (g + 1) * hidden_size)
                lecun_normal_(self.lstm.weight_ih[rows])
                nn.init.orthogonal_(self.lstm.weight_hh[rows])
            self.lstm.bias_ih.zero_()
            self.lstm.bias_hh.zero_()
        self.lstm.bias_ih.requires_grad_(False)

    def forward(self, carry: Carry, x: torch.Tensor, is_first: torch.Tensor) -> Carry:
        keep = 1.0 - is_first
        c, h = carry[0] * keep, carry[1] * keep
        h, c = self.lstm(x, (h, c))
        return c, h


class RecurrentPPOAgent(nn.Module):
    """Encoder → [pre-MLP] → LSTM → [post-MLP] → actor heads and critic.
    ``forward(obs, prev_actions, is_first, carry)`` takes ``[L, B, ...]``
    inputs and ``(c, h)`` each ``[B, H]``; returns ``(actor_out, values,
    carry)``."""

    def __init__(
        self,
        obs_space: Any,
        actions_dim: Sequence[int],
        is_continuous: bool,
        cnn_keys: Sequence[str] = (),
        mlp_keys: Sequence[str] = (),
        cnn_features_dim: int = 512,
        mlp_features_dim: int = 64,
        encoder_dense_units: int = 64,
        encoder_mlp_layers: int = 1,
        dense_act: str = "relu",
        layer_norm: bool = True,
        lstm_hidden_size: int = 64,
        pre_rnn_apply: bool = False,
        pre_rnn_dense_units: int = 64,
        pre_rnn_layer_norm: bool = True,
        post_rnn_apply: bool = False,
        post_rnn_dense_units: int = 64,
        post_rnn_layer_norm: bool = True,
        actor_dense_units: int = 64,
        actor_mlp_layers: int = 1,
        actor_layer_norm: bool = True,
        critic_dense_units: int = 64,
        critic_mlp_layers: int = 1,
        critic_layer_norm: bool = True,
    ):
        super().__init__()
        self.actions_dim = tuple(int(a) for a in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.lstm_hidden_size = int(lstm_hidden_size)
        self.pre_rnn_apply, self.post_rnn_apply = bool(pre_rnn_apply), bool(post_rnn_apply)

        def mlp(in_dim, units, layers, ln, **kw):
            return MLP(in_dim, (units,) * layers, norm_eps=LN_EPS if ln else None, init=lecun_normal_,
                       activation=dense_act, **kw)

        self.feature_extractor = PPOEncoder(obs_space, cnn_keys, mlp_keys, cnn_features_dim, mlp_features_dim,
                                            encoder_dense_units, encoder_mlp_layers, dense_act, layer_norm)
        x_dim = self.feature_extractor.output_dim + sum(self.actions_dim)
        if self.pre_rnn_apply:
            self.pre_rnn_mlp = mlp(x_dim, pre_rnn_dense_units, 1, pre_rnn_layer_norm)
            x_dim = self.pre_rnn_mlp.output_dim
        self.rnn = ResetLSTMCell(x_dim, lstm_hidden_size)
        out_dim = self.lstm_hidden_size
        if self.post_rnn_apply:
            self.post_rnn_mlp = mlp(out_dim, post_rnn_dense_units, 1, post_rnn_layer_norm)
            out_dim = self.post_rnn_mlp.output_dim
        self.critic = mlp(out_dim, critic_dense_units, critic_mlp_layers, critic_layer_norm, output_dim=1)
        self.actor_backbone = mlp(out_dim, actor_dense_units, actor_mlp_layers, actor_layer_norm)
        hid = self.actor_backbone.output_dim
        if self.is_continuous:
            self.actor_head = dense(hid, 2 * sum(self.actions_dim), init=lecun_normal_)
        else:
            for i, d in enumerate(self.actions_dim):
                setattr(self, f"actor_head_{i}", dense(hid, d, init=lecun_normal_))

    def forward(self, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, is_first: torch.Tensor,
                carry: Carry) -> Tuple[List[torch.Tensor], torch.Tensor, Carry]:
        x = torch.cat([self.feature_extractor(obs), prev_actions], dim=-1)
        if self.pre_rnn_apply:
            x = self.pre_rnn_mlp(x)
        outs = []
        for t in range(x.shape[0]):
            carry = self.rnn(carry, x[t], is_first[t])
            outs.append(carry[1])
        out = torch.stack(outs, dim=0)
        if self.post_rnn_apply:
            out = self.post_rnn_mlp(out)
        values = self.critic(out)
        actor_feat = self.actor_backbone(out)
        if self.is_continuous:
            mean, log_std = torch.chunk(self.actor_head(actor_feat), 2, dim=-1)
            return [mean, log_std], values, carry
        return [getattr(self, f"actor_head_{i}")(actor_feat) for i in range(len(self.actions_dim))], values, carry

    def initial_states(self, batch: int, device: Any = None) -> Carry:
        z = torch.zeros(batch, self.lstm_hidden_size, device=device)
        return z, z.clone()


def build_agent(cfg: Any, obs_space: Any, action_space: Any, device: torch.device) -> RecurrentPPOAgent:
    """The agent of ``cfg.algo`` for these spaces, on ``device``."""
    actions_dim, is_continuous = actions_dim_of(action_space)
    algo, enc, rnn = cfg.algo, cfg.algo.encoder, cfg.algo.rnn
    mlp_layers = enc.select("mlp_layers")
    agent = RecurrentPPOAgent(
        obs_space,
        actions_dim,
        is_continuous,
        cnn_keys=tuple(algo.cnn_keys.encoder),
        mlp_keys=tuple(algo.mlp_keys.encoder),
        cnn_features_dim=int(enc.cnn_features_dim),
        mlp_features_dim=int(enc.mlp_features_dim),
        encoder_dense_units=int(enc.dense_units),
        encoder_mlp_layers=int(mlp_layers if mlp_layers is not None else algo.mlp_layers),
        dense_act=str(algo.dense_act),
        layer_norm=bool(algo.layer_norm),
        lstm_hidden_size=int(rnn.lstm.hidden_size),
        pre_rnn_apply=bool(rnn.pre_rnn_mlp.apply),
        pre_rnn_dense_units=int(rnn.pre_rnn_mlp.dense_units),
        pre_rnn_layer_norm=bool(rnn.pre_rnn_mlp.layer_norm),
        post_rnn_apply=bool(rnn.post_rnn_mlp.apply),
        post_rnn_dense_units=int(rnn.post_rnn_mlp.dense_units),
        post_rnn_layer_norm=bool(rnn.post_rnn_mlp.layer_norm),
        actor_dense_units=int(algo.actor.dense_units),
        actor_mlp_layers=int(algo.actor.mlp_layers),
        actor_layer_norm=bool(algo.actor.layer_norm),
        critic_dense_units=int(algo.critic.dense_units),
        critic_mlp_layers=int(algo.critic.mlp_layers),
        critic_layer_norm=bool(algo.critic.layer_norm),
    )
    return agent.to(device)
