"""DroQ training in PyTorch (counterpart of ``sheeprl_tpu/algos/droq/droq.py``).

* ``make_train_fn``: G critic steps, each on its own batch with a fresh
  target-action draw, fresh dropout masks on the target and on the online
  critic, and the target EMA after every step; then ONE actor step and one
  alpha step on a batch of their own, dropout on, with the MEAN of the
  ensemble (SAC takes the min). Every draw is an argument (``draw``: the
  standard normals and the keep masks), taken from a generator when not
  given, so a test can hand in the JAX package's;
* ``main``: the serial loop (as in the JAX package) of ``sac.OffPolicyLoop``,
  sampling the critic batch of B·G rows and the actor batch of B rows
  straight from the buffer; CNN keys are dropped with the JAX package's
  warning. On N ranks (``parallel/mesh.py``) rank ``d`` steps env block
  ``d`` into its own buffer, samples its ``per_rank_batch_size`` columns of
  every step's batch (the JAX package shards axis 1 of the ``[G, B]``
  critic batch), draws its dropout masks from its own generator and takes
  the ranks' mean gradient at every optimizer step; rank 0 logs,
  checkpoints (the buffer gathered by env block), tests and registers;
* ``evaluate_droq``: the ``eval`` entry, one greedy episode.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ...config import Config
from ...data.buffers import env_block, gather_env_blocks
from ...parallel.mesh import collective
from ...parallel.mesh import current as current_distributed
from ...parallel.placement import make_param_mirror
from ...utils.env import single_env
from ...utils.logger import get_logger
from ...utils.model_manager import register_model
from ...utils.registry import register_algorithm, register_evaluation
from ..sac.agent import SACAgent, sample_actions
from ..sac.loss import critic_loss, entropy_loss, policy_loss
from ..sac.sac import (LOSS_KEYS, OffPolicyLoop, Optimizers, apply_grads, build_optimizers, ema_, evaluate_agent,
                       make_vector_interact, rank_grads, replay_buffer, start_run)
from ..sac.utils import test
from .agent import build_agent, critic_masks


def draw(agent: SACAgent, g: int, batch: int, generator: Optional[torch.Generator], device: Any) -> Dict[str, Any]:
    """A burst's draws: per critic step the target action's standard normal
    (``next``) and the target's and the online critic's keep masks; for the
    actor step its standard normal and the critic's masks."""
    act_dim = agent.actor.fc_mean.out_features
    critic = agent.critic

    def normal() -> torch.Tensor:
        return torch.randn((batch, act_dim), generator=generator, device=device)

    steps = [{"next": normal(), "target_masks": critic_masks(critic, batch, generator, device),
              "masks": critic_masks(critic, batch, generator, device)} for _ in range(g)]
    return {"critic": steps, "actor": {"noise": normal(), "masks": critic_masks(critic, batch, generator, device)}}


def make_train_fn(agent: SACAgent, optimizers: Optimizers, cfg: Config, target_entropy: float,
                  dist: Any = None) -> Callable:
    """``train(critic_batches, actor_batch, draws=None, generator=None) ->
    metrics``: ``critic_batches`` are ``[G, B, ...]``, ``actor_batch``
    ``[B, ...]`` (the keys of SAC's batches); ``draws`` are ``draw``'s. The
    metrics: the mean critic loss over the G steps and the actor and alpha
    losses, as tensors. With a ``Distributed`` the batches are this rank's
    columns and each optimizer step takes the ranks' mean gradient (one
    flattened all-reduce per optimizer step, before the step)."""

    def grads_of(loss: torch.Tensor, params) -> Any:
        return rank_grads(loss, params, dist)

    gamma = float(cfg.algo.gamma)
    tau = float(cfg.algo.tau)
    actor, critic, target = agent.actor, agent.critic, agent.target_critic
    actor_params, critic_params = list(actor.parameters()), list(critic.parameters())
    target_params = list(target.parameters())

    def critic_step(batch: Dict[str, torch.Tensor], d: Dict[str, Any]) -> torch.Tensor:
        with torch.no_grad():
            mean, log_std = actor(batch["next_observations"])
            next_actions, next_logprobs = sample_actions(actor, mean, log_std, d["next"])
            target_q = target(batch["next_observations"], next_actions, d["target_masks"])
            min_target = target_q.amin(0) - torch.exp(agent.log_alpha) * next_logprobs
            y = batch["rewards"] + (1.0 - batch["terminated"]) * gamma * min_target
        qf_loss = critic_loss(critic(batch["observations"], batch["actions"], d["masks"]), y)
        apply_grads(optimizers["critic"], critic_params, grads_of(qf_loss, critic_params))
        ema_(target_params, critic_params, tau)  # every step
        optimizers.step += 1
        return qf_loss.detach()

    def train(critic_batches: Dict[str, torch.Tensor], actor_batch: Dict[str, torch.Tensor],
              draws: Optional[Dict[str, Any]] = None,
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        g, b = critic_batches["actions"].shape[:2]
        if draws is None:
            draws = draw(agent, g, b, generator, critic_batches["actions"].device)
        qf = sum(critic_step({k: v[i] for k, v in critic_batches.items()}, draws["critic"][i]) for i in range(g)) / g

        obs = actor_batch["observations"]
        mean, log_std = actor(obs)
        actions, logprobs = sample_actions(actor, mean, log_std, draws["actor"]["noise"])
        mean_q = critic(obs, actions, draws["actor"]["masks"]).mean(0)
        a_loss = policy_loss(torch.exp(agent.log_alpha).detach(), logprobs, mean_q)
        apply_grads(optimizers["actor"], actor_params, grads_of(a_loss, actor_params))
        al_loss = entropy_loss(agent.log_alpha, logprobs.detach(), target_entropy)
        apply_grads(optimizers["alpha"], [agent.log_alpha], grads_of(al_loss, [agent.log_alpha]))
        return dict(zip(LOSS_KEYS, (qf, a_loss.detach(), al_loss.detach())))

    return train


@register_algorithm(name="droq")
def main(cfg: Config) -> None:
    """DroQ's serial training loop, with checkpoints, the RunGuard and resume;
    one greedy test episode at the end."""
    if cfg.algo.cnn_keys.encoder:
        warnings.warn("DroQ cannot use image observations; CNN keys are ignored")
        cfg.algo.cnn_keys.encoder = []
    device, seed, log_dir, state, envs = start_run(cfg, "droq")
    dist = current_distributed(cfg)
    obs_space, action_space = envs.single_observation_space, envs.single_action_space
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    act_dim = int(np.prod(action_space.shape))
    agent = build_agent(cfg, obs_space, action_space, device)
    optimizers = build_optimizers(cfg, agent)
    if state:
        agent.load_state_dict(state["agent"])
        optimizers.load_state_dict(state["opt_states"])
    train_gen = torch.Generator(device=device)
    train_gen.manual_seed(seed + dist.rank)  # N ranks: each rank's draws and dropout masks its own
    mirror, _, player_gen = make_param_mirror(cfg, device, {"actor": agent.actor}, seed + dist.rank)
    logger = get_logger(cfg, log_dir, dist.rank)
    loop = OffPolicyLoop(cfg, "droq", device=device, log_dir=log_dir, state=state, envs=envs, mirror=mirror,
                         player_gen=player_gen, train_gen=train_gen, logger=logger, params={"agent": agent})
    rb = replay_buffer(cfg, log_dir, seed, dist=dist)
    if state and cfg.buffer.checkpoint and "rb" in state:
        rb.load_state_dict(env_block(state["rb"], dist.rank, dist.world_size))
    batch_size = int(cfg.algo.per_rank_batch_size)
    train = make_train_fn(agent, optimizers, cfg, -act_dim, dist=collective(cfg))

    def to_device(sample: Dict[str, np.ndarray], lead) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v.reshape(*lead, *v.shape[2:]))).to(device)
                for k, v in sample.items()}

    def burst(g: int) -> Dict[str, torch.Tensor]:
        critic_batches = to_device(rb.sample(batch_size * g), (g, batch_size))
        actor_batch = to_device(rb.sample(batch_size), (batch_size,))
        return train(critic_batches, actor_batch, generator=train_gen)

    def algo_state() -> Dict[str, Any]:
        s = {"agent": agent.state_dict(), "opt_states": optimizers.state_dict()}
        if cfg.buffer.checkpoint:  # by env block, gathered to rank 0 on N ranks
            s["rb"] = gather_env_blocks(dist.gather_object(rb.checkpoint_state_dict()) or [{}])
        return s

    loop.run(rb, make_vector_interact(loop, lambda: mirror.current()["actor"], mlp_keys), burst,
             lambda: mirror.refresh({"actor": agent.actor}), lambda g: None, algo_state, overlap=False)
    if cfg.algo.run_test and dist.is_global_zero:
        test(agent.actor, single_env(cfg, seed), cfg, device, logger)
    if dist.is_global_zero:
        register_model(cfg, {"actor": agent.actor, "critic": agent.critic}, log_dir)
    if logger is not None:
        logger.close()


@register_evaluation("droq")
def evaluate_droq(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode with the checkpoint's actor."""
    evaluate_agent(cfg, state, build_agent, lambda agent, env, c, dev: test(agent.actor, env, c, dev))
