"""Plan2Explore-DV1, the exploration phase, in PyTorch (counterpart of
``sheeprl_tpu/algos/p2e_dv1/p2e_dv1_exploration.py``).

One gradient step (``make_train_fn``) is the JAX package's ``one_step``, in
its order: the world model (DreamerV1's, its reward and continue heads on
detached latents); the ensembles (each member's Gaussian NLL of the next
embedded observation, the encoder's output before the update); DreamerV1's
behaviour update (``dreamer_v1.make_behaviour_step``, no target critics)
twice: the exploration actor and critic on the ensembles' disagreement ×
``intrinsic_reward_multiplier`` (detached inputs), then the task actor and
critic on the world model's reward. Every draw takes pre-drawn noise
(``draw_train_noise``).

``main`` is DreamerV2's serial loop (``dreamer_v2.run_serial``) with
DreamerV1's rows (no ``is_first``) and the sequential buffer; the test
episode and ``eval`` (``evaluate_p2e_dv1``, registered for both phases) use
the task actor.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Sequence

import torch
from torch import nn

from ...config import Config
from ...utils.registry import register_algorithm, register_evaluation
from ..dreamer_v1.agent import build_agent as dv1_build_agent
from ..dreamer_v1.dreamer_v1 import draw_rollout_noise, make_behaviour_step, make_player, make_world_model_step
from ..dreamer_v2.dreamer_v2 import build_buffer, evaluate_dreamer, run_serial
from ..dreamer_v3.utils import make_precision_applies
from ..p2e_dv2.p2e_dv2_exploration import (
    AGGREGATOR_KEYS,
    METRIC_KEYS,
    build_optimizers,
    ensemble_step,
    expl_stat,
    exploration_setup,
    make_intrinsic_reward,
    task_state,
)
from ..p2e_dv2.p2e_dv2_exploration import draw_train_noise as p2e_draw_train_noise
from ..p2e_dv3.p2e_dv3_exploration import P2EOptimizers
from .agent import build_agent


def draw_train_noise(cfg: Config, T: int, B: int, actor, generator, device) -> Dict[str, Any]:
    """``post`` [T, B, S] (standard normals), then the exploration and task
    rollouts' draws (``dreamer_v1.draw_rollout_noise``)."""
    return p2e_draw_train_noise(cfg, T, B, actor, generator, device, rollout_noise=draw_rollout_noise,
                                post_shape=(int(cfg.algo.world_model.stochastic_size),))


def make_train_fn(mods: Dict[str, nn.Module], optimizers: P2EOptimizers, cfg: Config, is_continuous: bool,
                  actions_dim: Sequence[int]):
    """Returns ``train(batches, noise=None, generator=None) -> metrics``: G
    exploration steps over ``batches`` [G, T, B, ...] (``METRIC_KEYS``)."""
    apply = make_precision_applies(cfg)
    wm = mods["wm"]
    world_model_step = make_world_model_step(wm, optimizers.wm, cfg, apply, detach_heads=True)
    behaviour_step = make_behaviour_step(wm, cfg, apply)
    intrinsic = make_intrinsic_reward(apply, mods["ensembles"], float(cfg.algo.intrinsic_reward_multiplier))

    def one_step(batch, noise):
        zs, hs, embedded, metrics = world_model_step(batch, noise)
        metrics["Loss/ensemble_loss"] = ensemble_step(apply, mods["ensembles"], optimizers.ensembles,
                                                      torch.cat([zs, hs, batch["actions"]], dim=-1), embedded)
        policy_expl, value_expl, aux = behaviour_step(
            mods["actor_exploration"], mods["critic_exploration"], optimizers.actor_exploration,
            optimizers.critic_exploration, zs, hs, noise["exploration"], reward=intrinsic)
        policy_task, value_task, _ = behaviour_step(mods["actor_task"], mods["critic_task"], optimizers.actor_task,
                                                    optimizers.critic_task, zs, hs, noise["task"])
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


@register_algorithm(name="p2e_dv1_exploration")
def main(cfg: Config) -> None:
    """P2E-DV1's exploration phase (``dreamer_v2.run_serial`` with
    DreamerV1's rows and the sequential buffer)."""
    run_serial(cfg, "p2e_dv1_exploration", exploration_setup(build_agent, make_train_fn, build_optimizers,
                                                             AGGREGATOR_KEYS),
               make_player, is_first=False, buffer_fn=functools.partial(build_buffer, buffer_type="sequential"),
               expl_stat=expl_stat(cfg))


@register_evaluation(["p2e_dv1_exploration", "p2e_dv1_finetuning"])
def evaluate_p2e_dv1(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode with the checkpoint's world model and task actor."""
    evaluate_dreamer(cfg, task_state(state), dv1_build_agent, make_player)
