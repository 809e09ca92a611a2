"""DreamerV1 training in PyTorch (counterpart of
``sheeprl_tpu/algos/dreamer_v1/dreamer_v1.py``).

One gradient step (``make_train_fn``) is the JAX package's ``one_step``:
the world model (the Gaussian dynamic scan, Normal(·, 1) decoders, the KL
with free nats, the optional continue head), then the actor, which learns
by backpropagating the λ-values through the imagination rollout on the
world model as updated this step (the world model's and the critic's
parameters get no gradient from it), then the critic. DreamerV1 has no
target critic. Every draw takes pre-drawn noise (``draw_train_noise``).

``main`` is DreamerV2's serial loop (``dreamer_v2.run_dreamer``) with the
sequential buffer, DreamerV2's player (a Gaussian state of
``stochastic_size``) and the exploration amount logged;
``evaluate_dreamer_v1`` is the ``eval`` command's entry point.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Sequence

import torch

from ...config import Config
from ...distributions import Bernoulli, Independent, Normal
from ...ops.transforms import unrolled_cumprod
from ...utils.registry import register_algorithm, register_evaluation
from ..dreamer_v2.agent import DV2Actor, DV2WorldModel, action_noise, dv2_sample_actions
from ..dreamer_v2.dreamer_v2 import (
    METRIC_KEYS,
    build_buffer,
    evaluate_dreamer,
    make_player as make_dreamer_player,
    observation_dists,
    run_dreamer,
)
from ..dreamer_v3.dreamer_v3 import DV3Optimizers, _apply_grads
from ..dreamer_v3.utils import make_precision_applies
from .agent import build_agent
from .loss import actor_loss, critic_loss, reconstruction_loss
from .utils import AGGREGATOR_KEYS, compute_lambda_values, normalize_obs


def draw_rollout_noise(cfg: Config, TB: int, actor: DV2Actor, generator, device) -> Dict[str, Any]:
    """The draws of one imagination rollout from TB states: ``img_a`` per
    action head [horizon, TB, A_i] (``agent.action_noise``) and ``img_z``
    [horizon, TB, S]."""
    S = int(cfg.algo.world_model.stochastic_size)
    horizon = int(cfg.algo.horizon)
    return {"img_a": action_noise(actor, (horizon, TB), generator, device),
            "img_z": torch.randn(horizon, TB, S, generator=generator, device=device)}


def draw_train_noise(cfg: Config, T: int, B: int, actor: DV2Actor, generator, device) -> Dict[str, Any]:
    """Every random draw of one gradient step: ``post`` [T, B, S] (posterior
    standard normals), then one rollout's (``draw_rollout_noise``)."""
    S = int(cfg.algo.world_model.stochastic_size)
    post = torch.randn(T, B, S, generator=generator, device=device)
    return {"post": post, **draw_rollout_noise(cfg, T * B, actor, generator, device)}


def make_world_model_step(wm: DV2WorldModel, optimizer, cfg: Config, apply, detach_heads: bool = False):
    """Returns ``world_model_step(batch, noise) -> (zs, hs, embedded,
    metrics)``: one world-model update on ``batch`` [T, B, ...] (the
    Gaussian dynamic scan, Normal(·, 1) decoders, the KL with free nats, the
    optional continue head); states and the encoder's output (before the
    update) come back detached. ``detach_heads``: the reward and continue
    heads read detached latents (Plan2Explore's)."""
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + tuple(cfg.algo.mlp_keys.encoder)
    wm_cfg = cfg.algo.world_model
    S = int(wm_cfg.stochastic_size)
    R = int(wm_cfg.recurrent_model.recurrent_state_size)
    gamma = float(cfg.algo.gamma)
    use_continues = bool(wm_cfg.use_continues)
    rssm = wm.rssm

    def world_model_step(batch, noise):
        T, B = batch["rewards"].shape[:2]
        batch_obs = normalize_obs({k: batch[k] for k in obs_keys}, cnn_keys)
        with apply.params(wm):
            embedded = apply(wm.embed, batch_obs)  # [T, B, E]
            a_c, e_c = apply.cast_in((batch["actions"], embedded))
            h = a_c.new_zeros(B, R)
            z = a_c.new_zeros(B, S)
            hs_l, zs_l, post_l, prior_l = [], [], [], []
            for t in range(T):
                h, z, post_ms, prior_ms = rssm.dynamic(z, h, a_c[t], e_c[t], noise=noise["post"][t])
                hs_l.append(h)
                zs_l.append(z)
                post_l.append(post_ms)
                prior_l.append(prior_ms)
            hs, zs = apply.cast_out((torch.stack(hs_l), torch.stack(zs_l)))
            post_mean, post_std, prior_mean, prior_std = apply.cast_out(
                tuple(torch.stack([ms[i] for ms in lst]) for lst in (post_l, prior_l) for i in (0, 1)))
            latents = torch.cat([zs, hs], dim=-1)
            head_in = latents.detach() if detach_heads else latents
            qo = observation_dists(apply(wm.decode, latents), cnn_keys)
            qr = Independent(Normal(apply(wm.reward, head_in), 1.0), 1)
            qc = Independent(Bernoulli(logits=apply(wm.cont, head_in)), 1) if use_continues else None
        posteriors = Independent(Normal(post_mean, post_std), 1)
        priors = Independent(Normal(prior_mean, prior_std), 1)
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
            qo, batch_obs, qr, batch["rewards"], posteriors, priors, float(wm_cfg.kl_free_nats),
            float(wm_cfg.kl_regularizer), qc, (1 - batch["terminated"]) * gamma if use_continues else None,
            float(wm_cfg.continue_scale_factor),
        )
        optimizer.zero_grad()
        rec_loss.backward()
        _apply_grads(optimizer)
        metrics = {
            "Loss/world_model_loss": rec_loss,
            "Loss/observation_loss": observation_loss,
            "Loss/reward_loss": reward_loss,
            "Loss/state_loss": state_loss,
            "Loss/continue_loss": continue_loss,
            "State/kl": kl,
            "State/post_entropy": posteriors.entropy().mean(),
            "State/prior_entropy": priors.entropy().mean(),
        }
        return zs.detach(), hs.detach(), embedded.detach(), {k: v.detach() for k, v in metrics.items()}

    return world_model_step


def make_behaviour_step(wm: DV2WorldModel, cfg: Config, apply):
    """Returns ``behaviour_step(actor, critic, actor_opt, critic_opt, zs, hs,
    noise, reward=None) -> (policy_loss, value_loss, aux)``: the actor
    learns by backpropagating the λ-values through the imagination rollout
    on the world model as updated this step (the world model's and the
    critic's parameters get no gradient from it), then the critic.
    ``reward(trajectories, actions)`` gives the imagined rewards (default:
    the world model's reward head); ``aux`` holds the detached rewards,
    values and λ-values."""
    wm_cfg = cfg.algo.world_model
    S = int(wm_cfg.stochastic_size)
    R = int(wm_cfg.recurrent_model.recurrent_state_size)
    horizon = int(cfg.algo.horizon)
    gamma = float(cfg.algo.gamma)
    lmbda = float(cfg.algo.lmbda)
    use_continues = bool(wm_cfg.use_continues)
    rssm = wm.rssm

    def rollout(actor, z, h, noise):
        """Imagination: act on the current latent, step the prior, keep the
        latent after the step and the action that led there; [H, TB, S+R]
        and [H, TB, A], differentiable in the actor."""
        latents, actions = [], []
        for i in range(horizon):
            latent = torch.cat([z, h], dim=-1)
            acts, _ = dv2_sample_actions(actor, apply(actor, latent.detach()), [n[i] for n in noise["img_a"]])
            a = torch.cat(acts, dim=-1)
            z, h = apply(rssm.imagination, z, h, a, noise=noise["img_z"][i])
            latents.append(torch.cat([z, h], dim=-1))
            actions.append(a)
        return torch.stack(latents), torch.stack(actions)

    def behaviour_step(actor, critic, actor_opt, critic_opt, zs, hs, noise, reward=None):
        TB = zs.shape[0] * zs.shape[1]
        with apply.params(wm, actor, critic):
            trajectories, imagined_actions = rollout(actor, zs.reshape(TB, S), hs.reshape(TB, R), noise)
            predicted_values = apply(critic, trajectories)
            predicted_rewards = (apply(wm.reward, trajectories) if reward is None
                                 else reward(trajectories, imagined_actions))
            if use_continues:
                continues = torch.sigmoid(apply(wm.cont, trajectories))
            else:
                continues = torch.ones_like(predicted_rewards) * gamma
            lv = compute_lambda_values(predicted_rewards, predicted_values, continues,
                                       last_values=predicted_values[-1], horizon=horizon, lmbda=lmbda)
            discount = unrolled_cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-2]], dim=0)).detach()
            policy_loss = actor_loss(discount * lv)
            # only the actor's parameters: the world model's and the critic's
            # .grad (and their optimizer states) stay untouched
            grads = torch.autograd.grad(policy_loss, actor_opt.params, allow_unused=True)
            _apply_grads(actor_opt, grads)

            qv = Independent(Normal(apply(critic, trajectories.detach()[:-1]), 1.0), 1)
            value_loss = critic_loss(qv, lv.detach(), discount[..., 0])
            critic_opt.zero_grad()
            value_loss.backward()
            _apply_grads(critic_opt)
        aux = {"rewards": predicted_rewards.detach(), "values": predicted_values.detach(), "lambda_values": lv.detach()}
        return policy_loss.detach(), value_loss.detach(), aux

    return behaviour_step


def make_train_fn(wm: DV2WorldModel, actor: DV2Actor, critic: torch.nn.Module, optimizers: DV3Optimizers,
                  cfg: Config, is_continuous: bool, actions_dim: Sequence[int]):
    """Returns ``train(batches, noise=None, generator=None) -> metrics`` (as
    DreamerV2's; ``optimizers.step`` counts the gradient steps)."""
    apply = make_precision_applies(cfg)
    world_model_step = make_world_model_step(wm, optimizers.wm, cfg, apply)
    behaviour_step = make_behaviour_step(wm, cfg, apply)

    def one_step(batch, noise):
        zs, hs, _, metrics = world_model_step(batch, noise)
        metrics["Loss/policy_loss"], metrics["Loss/value_loss"], _ = behaviour_step(
            actor, critic, optimizers.actor, optimizers.critic, zs, hs, noise)
        optimizers.step += 1
        return metrics

    def train(batches: Dict[str, torch.Tensor], noise=None, generator=None) -> Dict[str, torch.Tensor]:
        G, T, B = batches["rewards"].shape[:3]
        device = batches["rewards"].device
        steps = []
        for g in range(G):
            step_noise = noise[g] if noise is not None else draw_train_noise(cfg, T, B, actor, generator, device)
            steps.append(one_step({k: v[g] for k, v in batches.items()}, step_noise))
        return {k: torch.stack([m[k] for m in steps]) for k in METRIC_KEYS}

    return train


def make_player(wm, actor, cfg: Config, actions_dim, is_continuous: bool, num_envs: int):
    """DreamerV2's player with the Gaussian state's width."""
    return make_dreamer_player(wm, actor, cfg, actions_dim, is_continuous, num_envs,
                               stoch_width=int(cfg.algo.world_model.stochastic_size))


@register_algorithm(name="dreamer_v1")
def main(cfg: Config) -> None:
    """DreamerV1's serial training loop (``dreamer_v2.run_dreamer``): rows
    without ``is_first`` (its RSSM never resets within a sequence), the
    sequential buffer whatever ``buffer.type`` says."""
    run_dreamer(cfg, "dreamer_v1", build_agent, make_train_fn, make_player, AGGREGATOR_KEYS, is_first=False,
                buffer_fn=functools.partial(build_buffer, buffer_type="sequential"), log_expl=True)


@register_evaluation("dreamer_v1")
def evaluate_dreamer_v1(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode (``eval checkpoint_path=...``)."""
    evaluate_dreamer(cfg, state, build_agent, make_player)
