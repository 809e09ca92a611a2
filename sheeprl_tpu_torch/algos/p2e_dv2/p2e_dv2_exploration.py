"""Plan2Explore-DV2, the exploration phase, in PyTorch (counterpart of
``sheeprl_tpu/algos/p2e_dv2/p2e_dv2_exploration.py``).

One gradient step (``make_train_fn``) is the JAX package's ``one_step``, in
its order: both target critics hard-copied on the step counter (``step %
per_rank_target_network_update_freq == 0``, before the step); the world
model (DreamerV2's, its reward and continue heads on detached latents); the
ensembles (each member's Gaussian NLL of the next discrete stochastic
state); DreamerV2's behaviour update (``dreamer_v2.make_behaviour_step``)
twice: the exploration actor and critic on the ensembles' disagreement ×
``intrinsic_reward_multiplier`` (detached inputs), then the task actor and
critic on the world model's reward. Each update has its own optimizer and
gradient clip. Every draw takes pre-drawn noise (``draw_train_noise``).

``main`` is DreamerV2's serial loop (``dreamer_v2.run_serial``, with the
sequential or the episode buffer) with the player on
``actor_<algo.player.actor_type>`` and the exploration amount logged as
``Params/exploration_amount_<actor type>``; the test episode at the end and
``eval`` (``evaluate_p2e_dv2``, registered for both phases) use the task
actor.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import torch
from torch import nn

from ...config import Config
from ...distributions import Independent, Normal, gumbel_noise
from ...models import apply_ensembles
from ...utils.registry import register_algorithm, register_evaluation
from ..dreamer_v2.dreamer_v2 import (
    build_buffer,
    draw_rollout_noise,
    evaluate_dreamer,
    hard_copy_,
    make_behaviour_step,
    make_player,
    make_world_model_step,
    run_serial,
)
from ..dreamer_v2.agent import build_agent as dv2_build_agent
from ..dreamer_v3.dreamer_v3 import LoopParts, _apply_grads
from ..dreamer_v3.utils import make_precision_applies
from ..p2e_dv3.p2e_dv3_exploration import WM_KEYS, P2EOptimizers, clipped_optimizer
from .agent import build_agent

METRIC_KEYS = WM_KEYS + ("Loss/ensemble_loss", "Loss/policy_loss_exploration", "Loss/value_loss_exploration",
                         "Loss/policy_loss_task", "Loss/value_loss_task", "Rewards/intrinsic",
                         "Values_exploration/predicted_values", "Values_exploration/lambda_values")
AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Params/exploration_amount_task",
                   "Params/exploration_amount_exploration", *METRIC_KEYS}


def build_optimizers(cfg: Config, mods: Dict[str, nn.Module]) -> P2EOptimizers:
    """The six clipped optimizers of the DreamerV1/V2 exploration steps."""
    a = cfg.algo
    sections = {"wm": a.world_model, "ensembles": a.ensembles, "actor_task": a.actor, "critic_task": a.critic,
                "actor_exploration": a.actor, "critic_exploration": a.critic}
    return P2EOptimizers(**{k: clipped_optimizer(v, mods[k]) for k, v in sections.items()})


def draw_train_noise(cfg: Config, T: int, B: int, actor, generator, device,
                     rollout_noise: Callable = draw_rollout_noise, post_shape: Sequence[int] = ()) -> Dict[str, Any]:
    """Every draw of one exploration step: ``post`` (the posterior's, [T, B,
    S, D] gumbel; with ``post_shape`` [T, B, S] standard normals, as
    DreamerV1's), then the exploration rollout's (``exploration``) and the
    task rollout's (``task``), each in ``rollout_noise``'s layout."""
    wm_cfg = cfg.algo.world_model
    if post_shape:
        post = torch.randn(T, B, *post_shape, generator=generator, device=device)
    else:
        post = gumbel_noise((T, B, int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)), generator, device)
    return {"post": post, "exploration": rollout_noise(cfg, T * B, actor, generator, device),
            "task": rollout_noise(cfg, T * B, actor, generator, device)}


def make_intrinsic_reward(apply, ens: nn.Module, multiplier: float):
    """``reward(trajectories, actions)``: the ensembles' variance over their
    members, averaged over the predicted features, × ``multiplier``, on
    detached inputs."""

    @torch.no_grad()
    def reward(trajectories: torch.Tensor, imagined_actions: torch.Tensor) -> torch.Tensor:
        with apply.params(ens):
            preds = apply(lambda v: apply_ensembles(ens, v), torch.cat([trajectories, imagined_actions], dim=-1))
        return preds.var(0, unbiased=False).mean(-1, keepdim=True) * multiplier

    return reward


def ensemble_step(apply, ens: nn.Module, optimizer, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """One ensembles update: every member's Gaussian NLL (unit scale) of
    ``targets[1:]`` from ``inputs[:-1]``, averaged over time and batch and
    summed over the members. Returns the detached loss."""
    with apply.params(ens):
        out = apply(lambda v: apply_ensembles(ens, v), inputs)[:, :-1]  # [n, T-1, B, out]
        loss = -Independent(Normal(out, 1.0), 1).log_prob(targets[None, 1:]).mean((1, 2)).sum()
    optimizer.zero_grad()
    loss.backward()
    _apply_grads(optimizer)
    return loss.detach()


def make_train_fn(mods: Dict[str, nn.Module], optimizers: P2EOptimizers, cfg: Config, is_continuous: bool,
                  actions_dim: Sequence[int]):
    """Returns ``train(batches, noise=None, generator=None) -> metrics``: G
    exploration steps over ``batches`` [G, T, B, ...]; ``noise`` a list of G
    ``draw_train_noise`` dicts, else the draws come from ``generator``.
    Metrics are [G] tensors (``METRIC_KEYS``)."""
    apply = make_precision_applies(cfg)
    wm = mods["wm"]
    target_freq = int(cfg.algo.critic.per_rank_target_network_update_freq)
    world_model_step = make_world_model_step(wm, optimizers.wm, cfg, apply, detach_heads=True)
    behaviour_step = make_behaviour_step(wm, cfg, apply, actions_dim)
    intrinsic = make_intrinsic_reward(apply, mods["ensembles"], float(cfg.algo.intrinsic_reward_multiplier))

    def one_step(batch, noise):
        # the hard target copies, decided on the step counter before the step
        if optimizers.step % target_freq == 0:
            for name in ("task", "exploration"):
                hard_copy_(mods[f"target_critic_{name}"], mods[f"critic_{name}"])
        zs, hs, metrics = world_model_step(batch, noise)
        metrics["Loss/ensemble_loss"] = ensemble_step(apply, mods["ensembles"], optimizers.ensembles,
                                                      torch.cat([zs, hs, batch["actions"]], dim=-1), zs)
        terminated = batch["terminated"]
        policy_expl, value_expl, aux = behaviour_step(
            mods["actor_exploration"], mods["critic_exploration"], mods["target_critic_exploration"],
            optimizers.actor_exploration, optimizers.critic_exploration, terminated, zs, hs, noise["exploration"],
            reward=intrinsic)
        policy_task, value_task, _ = behaviour_step(
            mods["actor_task"], mods["critic_task"], mods["target_critic_task"], optimizers.actor_task,
            optimizers.critic_task, terminated, zs, hs, noise["task"])
        optimizers.step += 1
        metrics.update({"Loss/policy_loss_exploration": policy_expl, "Loss/value_loss_exploration": value_expl,
                        "Loss/policy_loss_task": policy_task, "Loss/value_loss_task": value_task,
                        "Rewards/intrinsic": aux["rewards"].mean(),
                        "Values_exploration/predicted_values": aux["values"].mean(),
                        "Values_exploration/lambda_values": aux["lambda_values"].mean()})
        return metrics

    def train(batches: Dict[str, torch.Tensor], noise=None, generator=None) -> Dict[str, torch.Tensor]:
        G, T, B = batches["rewards"].shape[:3]
        device = batches["rewards"].device
        steps = []
        for g in range(G):
            step_noise = (noise[g] if noise is not None
                          else draw_train_noise(cfg, T, B, mods["actor_task"], generator, device))
            steps.append(one_step({k: v[g] for k, v in batches.items()}, step_noise))
        return {k: torch.stack([m[k] for m in steps]) for k in METRIC_KEYS}

    return train


def exploration_setup(build: Callable, train_fn: Callable, optimizers_fn: Callable, aggregator_keys: Any):
    """The ``setup`` of ``dreamer_v2.run_serial`` for the DreamerV1/V2
    exploration phases: the agent (``build``), its optimizers
    (``optimizers_fn``), their states from a resumed checkpoint, the burst
    (``train_fn``) and the player on ``actor_<algo.player.actor_type>``."""

    def setup(cfg, device, precision, obs_space, actions_dim, is_continuous, state) -> LoopParts:
        mods = build(cfg, obs_space, actions_dim, is_continuous, device)
        for m in mods.values():
            m.to(precision.param_dtype)  # bf16-true: the parameters themselves are bf16
        optimizers = optimizers_fn(cfg, mods)
        if state:
            for k, m in mods.items():
                m.load_state_dict(state[k])
            optimizers.load_state_dict(state["opt_states"])
        train = train_fn(mods, optimizers, cfg, is_continuous, actions_dim)
        actor_type = str(cfg.algo.player.actor_type)
        if actor_type not in ("exploration", "task"):
            raise ValueError(f"algo.player.actor_type must be exploration | task, got {actor_type!r}")
        return LoopParts(mods, lambda batches, gen: train(batches, generator=gen),
                         lambda task_phase: mods[f"actor_{actor_type}"],
                         lambda: {**{k: m.state_dict() for k, m in mods.items()},
                                  "opt_states": optimizers.state_dict()},
                         mods["actor_task"], aggregator_keys)

    return setup


def expl_stat(cfg: Config) -> Callable[[bool], str]:
    """The name the exploration amount is logged as: that of the acting
    actor's type."""
    return lambda task_phase: f"Params/exploration_amount_{cfg.algo.player.actor_type}"


@register_algorithm(name="p2e_dv2_exploration")
def main(cfg: Config) -> None:
    """P2E-DV2's exploration phase (``dreamer_v2.run_serial``)."""
    run_serial(cfg, "p2e_dv2_exploration", exploration_setup(build_agent, make_train_fn, build_optimizers,
                                                             AGGREGATOR_KEYS),
               make_player, is_first=True, buffer_fn=build_buffer, expl_stat=expl_stat(cfg))


def task_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """An exploration checkpoint's task actor as ``actor`` (a finetuning
    checkpoint holds it there already)."""
    return {**state, "actor": state["actor_task"]} if "actor_task" in state else state


@register_evaluation(["p2e_dv2_exploration", "p2e_dv2_finetuning"])
def evaluate_p2e_dv2(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode with the checkpoint's world model and task actor."""
    evaluate_dreamer(cfg, task_state(state), dv2_build_agent, make_player)
