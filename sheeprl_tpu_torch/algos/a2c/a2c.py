"""A2C training in PyTorch (counterpart of ``sheeprl_tpu/algos/a2c/a2c.py``).

PPO's rollout and GAE; the update is one optimizer step on the whole
rollout (with sum reduction, the same gradient as the reference's
accumulation over minibatches), with the JAX package's RMSprop
(``optim.rmsprop``, optax's ``eps_in_sqrt`` form). The loop is serial, as
in the JAX package; checkpoints, resume, the RunGuard and the telemetry
stream as in PPO's loop.

On N ranks (``parallel/mesh.py``) rank ``d`` rolls out env block ``d`` and
computes the loss over its own rows. Under the default
``algo.loss_reduction: sum`` the JAX package's loss is the sum over the
whole rollout of all envs, so the global gradient is the SUM of the ranks'
gradients: the rank's loss is scaled by the world size, so the optimizer's
average (one flattened all-reduce, as PPO's) is that sum, then it clips
with ``max_grad_norm``; the logged losses are the global sums. Under
``mean`` the ranks' gradients and losses are averaged (equal rows a rank).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import torch

from ...config import Config, instantiate
from ...optim import Clipped, clipped
from ...parallel.mesh import collective, collective_fields, local_cfg, rank_resume, ranks_state
from ...parallel.mesh import current as current_distributed
from ...parallel.placement import make_param_mirror
from ...resilience.guard import RunGuard
from ...telemetry.facade import Telemetry
from ...utils.checkpoint import CheckpointManager, gen_state, set_gen_state
from ...utils.env import single_env
from ...utils.logger import get_logger
from ...utils.model_manager import register_model
from ...utils import run_info
from ...utils.registry import register_algorithm, register_evaluation
from ..ppo.agent import PPOAgent, actions_and_log_probs
from ..ppo.ppo import (Rollout, evaluate_agent, make_act_fn, make_value_fn, optimizer_step, resume_counters,
                       rollout_batch, rollout_buffer, start_run)
from ..ppo.utils import test
from .agent import build_agent
from .loss import policy_loss, value_loss

AGGREGATOR_KEYS = {"Rewards/rew_avg", "Game/ep_len_avg", "Loss/value_loss", "Loss/policy_loss"}
MODELS_TO_REGISTER = {"agent"}


def make_update_fn(agent: PPOAgent, optimizer: Clipped, cfg: Config, dist: Any = None) -> Callable:
    """``update(data) -> metrics``: one clipped optimizer step on the whole
    ``[batch, ...]`` rollout; the metrics stay tensors (no host sync). With
    a ``Distributed`` ``data`` is this rank's rows and the optimizer (built
    with the same ``dist``) averages the ranks' gradients; a ``sum``
    reduction scales the rank's loss by the world size, so the average is
    the global sum's gradient. The metrics are the global losses."""
    reduction = str(cfg.algo.loss_reduction)
    scale = float(dist.world_size) if dist is not None and reduction != "mean" else 1.0

    def update(data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        obs = {k[4:]: v for k, v in data.items() if k.startswith("obs:")}
        actor_out, new_values = agent(obs)
        _, logprobs, _ = actions_and_log_probs(actor_out, agent.is_continuous, actions=data["actions"])
        pg = policy_loss(logprobs, data["advantages"], reduction)
        vl = value_loss(new_values, data["returns"], reduction)
        optimizer_step(optimizer, (pg + vl) * scale if scale != 1.0 else pg + vl)
        losses = torch.stack([pg.detach(), vl.detach()])
        if dist is not None:
            losses = dist.all_reduce_sum(losses)
            if reduction == "mean":
                losses = losses / dist.world_size
        return {"Loss/policy_loss": losses[0], "Loss/value_loss": losses[1]}

    return update


def build_optimizer(cfg: Config, agent: PPOAgent, dist: Any = None) -> Clipped:
    """The clipped optimizer; with a ``Distributed`` its step averages the
    ranks' gradients."""
    return clipped(instantiate(cfg.algo.optimizer, list(agent.parameters())), cfg.algo.select("max_grad_norm"), dist)


@register_algorithm(name="a2c")
def main(cfg: Config) -> None:
    device, seed, log_dir, state, envs = start_run(cfg, "a2c")
    dist = current_distributed(cfg)
    rank = dist.rank
    obs_space, action_space = envs.single_observation_space, envs.single_action_space
    num_envs = int(cfg.env.num_envs)
    obs_keys = tuple(cfg.algo.mlp_keys.encoder)
    saved_gens = rank_resume(state, dist)

    agent = build_agent(cfg, obs_space, action_space, device)
    optimizer = build_optimizer(cfg, agent, collective(cfg))
    if state:
        agent.load_state_dict(state["agent"])
        optimizer.optimizer.load_state_dict(state["opt_state"])
    update = make_update_fn(agent, optimizer, cfg, collective(cfg))
    mirror, pdev, player_gen = make_param_mirror(cfg, device, {"agent": agent}, seed + rank)
    if state:
        set_gen_state(player_gen, saved_gens["player"], "player", tag="a2c")

    logger = get_logger(cfg, log_dir, rank)
    telem = Telemetry.setup(cfg, log_dir, rank, logger=logger, aggregator_keys=AGGREGATOR_KEYS, device=device)
    aggregator = telem.aggregator
    guard = RunGuard.setup(cfg, CheckpointManager(log_dir, keep_last=cfg.checkpoint.keep_last, enabled=rank == 0),
                           log_dir, telem=telem, dist=dist)
    ckpt = guard.ckpt

    rollout_steps = int(cfg.algo.rollout_steps)
    policy_steps_per_iter = num_envs * rollout_steps
    num_updates = int(cfg.algo.total_steps) // policy_steps_per_iter if not cfg.dry_run else 1
    start_iter, policy_step, last_log, last_checkpoint = resume_counters(cfg, state, agent, "a2c")

    # N ranks: this rank's env block, reset as the JAX package's envs lo..hi
    rollout = Rollout(local_cfg(cfg, dist), envs, mirror, pdev, player_gen, agent.is_continuous, make_act_fn(),
                      make_value_fn())
    rb = rollout_buffer(cfg, rollout_steps, rollout.num_envs, obs_keys, log_dir, f"rank_{rank}", seed)
    rollout.reset(seed + dist.local_envs(num_envs)[0])
    completed_update = start_iter - 1
    update_s: List[float] = []
    t0 = time.perf_counter()

    def _ckpt_state() -> Dict[str, Any]:
        gens = {"player": gen_state(player_gen)}
        return {"agent": agent.state_dict(), "opt_state": optimizer.optimizer.state_dict(), "update": completed_update,
                "policy_step": policy_step, "last_log": last_log, "last_checkpoint": last_checkpoint,
                "generators": gens, **ranks_state(dist, gens)}

    steady_sync = run_info.device_sync(device)  # the first update's end, for run_info.mark_steady
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
                    aggregator.update(k, float(v))  # host-sync: ok (update cadence)
                update_s.append(time.perf_counter() - ts)
                run_info.mark_steady(policy_step, sync=steady_sync)
            completed_update = update_iter
            if policy_step - last_log >= int(cfg.metric.log_every) or cfg.dry_run or update_iter == num_updates:
                dist.reduce_metrics(aggregator)  # N ranks: rank 0 logs the global metrics
                telem.log(policy_step, fields={"updates": completed_update, "grad_steps": completed_update,
                                               "elapsed_s": time.perf_counter() - t0,
                                               "update_ms": 1e3 * sum(update_s) / len(update_s),
                                               **collective_fields(dist)})
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
    if cfg.algo.run_test and rank == 0:
        test(agent, single_env(cfg, seed), cfg, device, logger)
    if rank == 0:
        register_model(cfg, {"agent": agent}, log_dir)
    if logger is not None:
        logger.close()


@register_evaluation("a2c")
def evaluate_a2c(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode with the checkpoint's agent (``eval``)."""
    evaluate_agent(cfg, state, build_agent)
