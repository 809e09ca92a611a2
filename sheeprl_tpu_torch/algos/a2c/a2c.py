"""A2C training in PyTorch (counterpart of ``sheeprl_tpu/algos/a2c/a2c.py``).

PPO's rollout and GAE; the update is one optimizer step on the whole
rollout (with sum reduction, the same gradient as the reference's
accumulation over minibatches), with the JAX package's RMSprop
(``optim.rmsprop``, optax's ``eps_in_sqrt`` form). The loop is serial, as
in the JAX package; checkpoints, resume, the RunGuard and the telemetry
stream as in PPO's loop.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import torch

from ...config import Config, instantiate
from ...optim import Clipped, clipped
from ...parallel.placement import make_param_mirror
from ...resilience.guard import RunGuard
from ...telemetry.facade import Telemetry
from ...utils.checkpoint import CheckpointManager, gen_state, set_gen_state
from ...utils.env import single_env
from ...utils.logger import get_logger
from ...utils.model_manager import register_model
from ...utils.registry import register_algorithm, register_evaluation
from ..ppo.agent import PPOAgent, actions_and_log_probs
from ..ppo.ppo import (Rollout, evaluate_agent, make_act_fn, make_value_fn, optimizer_step, resume_counters,
                       rollout_batch, rollout_buffer, start_run)
from ..ppo.utils import test
from .agent import build_agent
from .loss import policy_loss, value_loss

AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss"}
MODELS_TO_REGISTER = {"agent"}


def make_update_fn(agent: PPOAgent, optimizer: Clipped, cfg: Config) -> Callable:
    """``update(data) -> metrics``: one clipped optimizer step on the whole
    ``[batch, ...]`` rollout; the metrics stay tensors (no host sync)."""
    reduction = str(cfg.algo.loss_reduction)

    def update(data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        obs = {k[4:]: v for k, v in data.items() if k.startswith("obs:")}
        actor_out, new_values = agent(obs)
        _, logprobs, _ = actions_and_log_probs(actor_out, agent.is_continuous, actions=data["actions"])
        pg = policy_loss(logprobs, data["advantages"], reduction)
        vl = value_loss(new_values, data["returns"], reduction)
        optimizer_step(optimizer, pg + vl)
        return {"Loss/policy_loss": pg.detach(), "Loss/value_loss": vl.detach()}

    return update


@register_algorithm(name="a2c")
def main(cfg: Config) -> None:
    device, seed, log_dir, state, envs = start_run(cfg, "a2c")
    obs_space, action_space = envs.single_observation_space, envs.single_action_space
    num_envs = int(cfg.env.num_envs)
    obs_keys = tuple(cfg.algo.mlp_keys.encoder)

    agent = build_agent(cfg, obs_space, action_space, device)
    optimizer = clipped(instantiate(cfg.algo.optimizer, list(agent.parameters())), cfg.algo.select("max_grad_norm"))
    if state:
        agent.load_state_dict(state["agent"])
        optimizer.optimizer.load_state_dict(state["opt_state"])
    update = make_update_fn(agent, optimizer, cfg)
    mirror, pdev, player_gen = make_param_mirror(cfg, device, {"agent": agent}, seed)
    if state:
        set_gen_state(player_gen, state["generators"]["player"], "player", tag="a2c")

    logger = get_logger(cfg, log_dir)
    telem = Telemetry.setup(cfg, log_dir, logger=logger, aggregator_keys=AGGREGATOR_KEYS, device=device)
    aggregator = telem.aggregator
    guard = RunGuard.setup(cfg, CheckpointManager(log_dir, keep_last=cfg.checkpoint.keep_last), log_dir, telem=telem)
    ckpt = guard.ckpt

    rollout_steps = int(cfg.algo.rollout_steps)
    policy_steps_per_iter = num_envs * rollout_steps
    num_updates = int(cfg.algo.total_steps) // policy_steps_per_iter if not cfg.dry_run else 1
    start_iter, policy_step, last_log, last_checkpoint = resume_counters(cfg, state, agent, "a2c")

    rb = rollout_buffer(cfg, rollout_steps, num_envs, obs_keys, log_dir, "rank_0", seed)
    rollout = Rollout(cfg, envs, mirror, pdev, player_gen, agent.is_continuous, make_act_fn(), make_value_fn())
    rollout.reset(seed)
    completed_update = start_iter - 1
    update_s: List[float] = []
    t0 = time.perf_counter()

    def _ckpt_state() -> Dict[str, Any]:
        return {"agent": agent.state_dict(), "opt_state": optimizer.optimizer.state_dict(), "update": completed_update,
                "policy_step": policy_step, "last_log": last_log, "last_checkpoint": last_checkpoint,
                "generators": {"player": gen_state(player_gen)}}

    try:
        for update_iter in range(start_iter, num_updates + 1):
            telem.tick(policy_step)
            with telem.span("Time/env_interaction_time"):
                local, next_value, ep_stats = rollout(rb)
            policy_step += policy_steps_per_iter
            for ep_rew, ep_len in ep_stats:
                aggregator.update("Rewards/rew_avg", ep_rew)
                aggregator.update("Game/ep_len_avg", ep_len)
            with telem.span("Time/train_time"):
                ts = time.perf_counter()
                metrics = update(rollout_batch(local, next_value, cfg, device))
                telem.record_grad_steps(1)
                mirror.refresh({"agent": agent})  # blocking: the next rollout acts with these
                for k, v in metrics.items():
                    aggregator.update(k, float(v))
                update_s.append(time.perf_counter() - ts)
            completed_update = update_iter
            if policy_step - last_log >= int(cfg.metric.log_every) or cfg.dry_run or update_iter == num_updates:
                telem.log(policy_step, fields={"updates": completed_update, "grad_steps": completed_update,
                                               "elapsed_s": time.perf_counter() - t0,
                                               "update_ms": 1e3 * sum(update_s) / len(update_s)})
                update_s.clear()
                last_log = policy_step
            every = int(cfg.checkpoint.every)
            if (every > 0 and policy_step - last_checkpoint >= every) or cfg.dry_run or update_iter == num_updates:
                last_checkpoint = policy_step
                ckpt.save(policy_step, _ckpt_state())
            if guard.stop_reached(policy_step, int(cfg.algo.total_steps), _ckpt_state):
                break
    finally:
        guard.close(policy_step, _ckpt_state)
        envs.close()
        telem.close(policy_step)
    if cfg.algo.run_test:
        test(agent, single_env(cfg, seed), cfg, device, logger)
    register_model(cfg, {"agent": agent}, log_dir)
    if logger is not None:
        logger.close()


@register_evaluation("a2c")
def evaluate_a2c(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode with the checkpoint's agent (``eval``)."""
    evaluate_agent(cfg, state, build_agent)
