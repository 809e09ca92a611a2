"""PPO decoupled in PyTorch (counterpart of
``sheeprl_tpu/algos/ppo/ppo_decoupled.py``): a player thread and trainer ranks.

The JAX package runs the player as a thread beside its single-controller
trainer: the player owns all ``env.num_envs`` envs, acts with a
``ParamMirror`` on its player device, computes GAE and hands each rollout
to the trainer through a depth-1 queue, then waits on a second depth-1
queue for the new parameters. The port keeps that design on rank 0 and
spreads the trainer over the ranks (``parallel/mesh.py``):

* rank 0 runs the player thread and its trainer; the two meet through the
  two depth-1 queues (``data_q``: the rollout, ``params_q``: the go-ahead
  once the mirror holds the new parameters);
* rank 0's trainer broadcasts each rollout to the other ranks; every rank
  draws the same minibatch permutations and trains on its slice of each
  global minibatch of ``per_rank_batch_size × world_size`` rows, the
  gradients averaged over the ranks (PPO's ``make_update_fn``);
* a player thread that raises fails the run on every rank (the JAX
  package's ``_PlayerCrashed``): rank 0 broadcasts the failure before it
  raises;
* rank 0 logs, checkpoints, tests and registers the agent at the end.

On one card (``fabric.devices=1 algo.player.device=host``) the trainer is
rank 0 on the card and the player acts on the host CPU.
"""
from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Any, Dict

import torch

from ...config import Config, instantiate
from ...optim import clipped
from ...parallel.mesh import collective_fields, rank_resume, ranks_state, run_log_dir
from ...parallel.mesh import current as current_distributed
from ...parallel.placement import make_param_mirror
from ...parallel.precision import disable_tf32
from ...resilience.guard import RunGuard
from ...telemetry.facade import Telemetry
from ...utils.checkpoint import CheckpointManager, gen_state, set_gen_state
from ...utils.env import probe_env_spaces, single_env, vectorize
from ...utils.logger import get_logger
from ...utils.metric import MetricAggregator
from ...utils.model_manager import register_model
from ...utils import run_info
from ...utils.registry import register_algorithm
from .agent import build_agent
from .ppo import (Rollout, draw_perms, make_act_fn, make_coefs, make_update_fn, make_value_fn, resume_counters,
                  rollout_batch, rollout_buffer)
from .utils import AGGREGATOR_KEYS, test


class PlayerCrashed(RuntimeError):
    """The decoupled player thread died; every rank's run fails with it."""


def chaos_raise_at(cfg: Config) -> int:
    """``resilience.chaos.player_raise_at_step`` when chaos is on, else 0."""
    if not bool(cfg.select("resilience.chaos.enabled", False)):
        return 0
    return int(cfg.select("resilience.chaos.player_raise_at_step", 0) or 0)


def _player_loop(cfg: Config, rollout: Rollout, log_dir: str, telem: Telemetry, data_q: "queue.Queue",
                 params_q: "queue.Queue", start_iter: int, num_updates: int, policy_step: int) -> None:
    """The env-stepping half on rank 0: one rollout of all ``env.num_envs``
    envs per update, handed over with the player generator's state after it;
    then the wait for the trainer's go-ahead (None: stop)."""
    try:
        seed = int(cfg.seed)
        num_envs, steps = int(cfg.env.num_envs), int(cfg.algo.rollout_steps)
        raise_at = chaos_raise_at(cfg)
        rb = rollout_buffer(cfg, steps, num_envs, rollout.obs_keys, log_dir, "rank_0", seed)
        rollout.reset(seed)
        for update_iter in range(start_iter, num_updates + 1):
            with telem.span("Time/env_interaction_time"):
                local, next_value, ep_stats = rollout(rb)
            policy_step += num_envs * steps
            if raise_at and policy_step >= raise_at:
                raise RuntimeError(f"chaos: the player thread raises at policy step {policy_step}")
            data_q.put((update_iter, policy_step, local, next_value, ep_stats, gen_state(rollout.generator)))
            if params_q.get() is None:  # the trainer stopped
                break
        rollout.envs.close()
        try:  # nowait: the trainer may have left a rollout unconsumed
            data_q.put_nowait(None)
        except queue.Full:
            pass
    except BaseException as e:  # surfaces on the trainer: the run fails on every rank
        try:
            data_q.put(e, timeout=30)
        except queue.Full:
            pass
        raise


@register_algorithm(name="ppo_decoupled", decoupled=True)
def main(cfg: Config) -> None:
    """The decoupled PPO loop: rank 0's player thread rolls out, every rank
    trains on its share of the broadcast rollout."""
    dist = current_distributed(cfg)
    rank, world = dist.rank, dist.world_size
    device = dist.device
    disable_tf32()
    seed = int(cfg.seed)
    log_dir = run_log_dir(cfg, dist)
    if rank == 0:
        print(f"[ppo_decoupled] log_dir={log_dir}", flush=True)
    MetricAggregator.disabled = int(cfg.metric.select("log_level", 1) or 0) == 0
    state = CheckpointManager.load(cfg.checkpoint.resume_from, map_location=device) if cfg.checkpoint.resume_from \
        else None
    saved_gens = rank_resume(state, dist)
    torch.manual_seed(seed)
    spaces_ = probe_env_spaces(cfg, seed)  # the player owns the real envs
    obs_space, action_space = spaces_.single_observation_space, spaces_.single_action_space

    agent = build_agent(cfg, obs_space, action_space, device)
    optimizer = clipped(instantiate(cfg.algo.optimizer, list(agent.parameters())), cfg.algo.select("max_grad_norm"),
                        dist if dist.collective else None)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)  # the same on every rank: the minibatch permutations
    if state:
        agent.load_state_dict(state["agent"])
        optimizer.optimizer.load_state_dict(state["opt_state"])
        set_gen_state(generator, saved_gens["train"], "train", tag="ppo_decoupled")

    num_envs, rollout_steps = int(cfg.env.num_envs), int(cfg.algo.rollout_steps)
    total_batch = rollout_steps * num_envs
    mb_size = int(cfg.algo.per_rank_batch_size) * world
    if total_batch % mb_size != 0:
        raise ValueError(f"rollout_steps*num_envs ({total_batch}) must be divisible by "
                         f"per_rank_batch_size*world_size ({mb_size})")
    num_minibatches, update_epochs = total_batch // mb_size, int(cfg.algo.update_epochs)
    update = make_update_fn(agent, optimizer, cfg, num_minibatches, mb_size, dist if dist.collective else None)

    logger = get_logger(cfg, log_dir, rank)
    telem = Telemetry.setup(cfg, log_dir, rank, logger=logger, aggregator_keys=AGGREGATOR_KEYS, device=device)
    aggregator = telem.aggregator
    ckpt = CheckpointManager(log_dir, keep_last=cfg.checkpoint.keep_last, enabled=rank == 0)
    guard = RunGuard.setup(cfg, ckpt, log_dir, telem=telem, dist=dist)
    ckpt = guard.ckpt

    policy_steps_per_iter = num_envs * rollout_steps
    num_updates = int(cfg.algo.total_steps) // policy_steps_per_iter if not cfg.dry_run else 1
    start_iter, policy_step, last_log, last_checkpoint = resume_counters(cfg, state, agent, "ppo_decoupled")
    grad_steps = (start_iter - 1) * num_minibatches * update_epochs
    completed_update = start_iter - 1

    data_q: "queue.Queue" = queue.Queue(maxsize=1)
    params_q: "queue.Queue" = queue.Queue(maxsize=1)
    player = mirror = None
    player_gen_state = saved_gens["player"] if state else None
    if rank == 0:
        # the player's copy of the agent on its device (the host with
        # algo.player.device=host) and its generator
        mirror, pdev, player_gen = make_param_mirror(cfg, device, {"agent": agent}, seed)
        if state:
            set_gen_state(player_gen, saved_gens["player"], "player", tag="ppo_decoupled")
        player_gen_state = gen_state(player_gen)
        rollout = Rollout(cfg, vectorize(cfg, seed, 0, run_name=log_dir), mirror, pdev, player_gen, agent.is_continuous, make_act_fn(),
                          make_value_fn())
        player = threading.Thread(target=_player_loop, name="ppo-player", daemon=True, args=(
            cfg, rollout, log_dir, telem, data_q, params_q, start_iter, num_updates, policy_step))
        player.start()
    update_s = []
    t0 = time.perf_counter()

    def _ckpt_state() -> Dict[str, Any]:
        gens = {"train": gen_state(generator), "player": player_gen_state}
        return {"agent": agent.state_dict(), "opt_state": optimizer.optimizer.state_dict(),
                "update": completed_update, "policy_step": policy_step, "last_log": last_log,
                "last_checkpoint": last_checkpoint, "generators": gens, **ranks_state(dist, gens)}

    def next_rollout() -> Any:
        """Rank 0 takes the player's rollout (or its end, or its failure) and
        broadcasts it: ``("data", ...)``, ``("stop",)`` or ``("crash", msg)``."""
        msg = None
        if rank == 0:
            item = guard.wait(data_q)  # wakes up on preemption even if the player is dead
            if item is None:
                msg = ("stop",)
            elif isinstance(item, BaseException):
                msg = ("crash", f"{type(item).__name__}: {item}")
            else:
                msg = ("data", item)
        msg = dist.broadcast_object(msg)
        if msg[0] == "crash":
            print(f"[ppo_decoupled] rank {rank}: the player thread crashed ({msg[1]})", file=sys.stderr, flush=True)
            raise PlayerCrashed(f"rank {rank}: the player thread crashed ({msg[1]})")
        return msg[1] if msg[0] == "data" else None

    steady_sync = run_info.device_sync(device)  # the first update's end, for run_info.mark_steady
    try:
        for update_iter in range(start_iter, num_updates + 1):
            item = next_rollout()
            if item is None:
                break
            _, policy_step, local, next_value, ep_stats, player_gen_state = item
            telem.tick(policy_step)
            for ep_rew, ep_len in ep_stats if rank == 0 else ():  # the player's episodes, counted once
                aggregator.update("Rewards/rew_avg", ep_rew)
                aggregator.update("Game/ep_len_avg", ep_len)
            with telem.span("Time/train_time"):
                ts = time.perf_counter()
                data = rollout_batch(local, next_value, cfg, device)
                perms = draw_perms(generator, update_epochs, total_batch, device)
                metrics = update(data, make_coefs(cfg, update_iter, num_updates, device), perms)
                grad_steps += num_minibatches * update_epochs
                telem.record_grad_steps(num_minibatches * update_epochs)
                if mirror is not None:
                    mirror.refresh({"agent": agent})  # the next rollout acts with these
                for k, v in metrics.items():
                    aggregator.update(k, float(v))  # host-sync: ok (update cadence)
                update_s.append(time.perf_counter() - ts)
                run_info.mark_steady(policy_step, sync=steady_sync)
            completed_update = update_iter
            # logs and checkpoints while the player waits for its go-ahead
            if policy_step - last_log >= int(cfg.metric.log_every) or cfg.dry_run or update_iter == num_updates:
                dist.reduce_metrics(aggregator)
                telem.log(policy_step, fields={"updates": completed_update, "grad_steps": grad_steps,
                                               "elapsed_s": time.perf_counter() - t0,
                                               "update_ms": 1e3 * sum(update_s) / len(update_s),
                                               **({"mirror": mirror.stats()} if mirror is not None else {}),
                                               **collective_fields(dist)})
                update_s.clear()
                last_log = policy_step
            every = int(cfg.checkpoint.every)
            if (every > 0 and policy_step - last_checkpoint >= every) or cfg.dry_run or update_iter == num_updates:
                last_checkpoint = policy_step
                ckpt.save(policy_step, _ckpt_state())
            # the stop before the go-ahead: the player is still parked, so the
            # sentinel below lands on an empty queue and it exits cleanly
            if guard.stop_reached(policy_step, int(cfg.algo.total_steps), _ckpt_state):
                break
            if rank == 0:
                params_q.put(True)
    finally:
        if rank == 0:
            try:  # unblock the player whatever happened
                params_q.put_nowait(None)
            except queue.Full:
                pass
            player.join(timeout=60)
        guard.close(policy_step, _ckpt_state)
        telem.close(policy_step)
    if cfg.algo.run_test and rank == 0:
        test(agent, single_env(cfg, seed), cfg, device, logger)
    if rank == 0:
        register_model(cfg, {"agent": agent}, log_dir)
    if logger is not None:
        logger.close()
