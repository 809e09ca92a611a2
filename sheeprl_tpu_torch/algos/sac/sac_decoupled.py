"""SAC decoupled in PyTorch (counterpart of
``sheeprl_tpu/algos/sac/sac_decoupled.py``): a player thread and trainer ranks.

The JAX package's player thread owns the envs and the one replay buffer,
runs the Ratio ledger and, for each iteration that owes gradient steps,
samples the whole ``[G, B, ...]`` batch (``B = per_rank_batch_size ×
world_size``) and hands it to the trainer through a depth-1 queue, then
waits for the new actor on a second one. The port keeps that design on
rank 0 (``parallel/mesh.py``):

* rank 0's player thread steps all ``env.num_envs`` envs with a
  ``ParamMirror`` of the actor on its player device, fills the buffer and
  samples each burst's global batch;
* rank 0's trainer scatters the batch by column block along the batch axis
  (rank ``d`` gets columns ``[d·B/N, (d+1)·B/N)``, the JAX package's
  ``shard_batch_axis(1)``); every rank runs SAC's G steps on its columns
  with the ranks' mean gradients;
* a player thread that raises fails the run on every rank; rank 0 logs,
  checkpoints (the buffer included), tests and registers.

On one card (``fabric.devices=1 algo.player.device=host``) the trainer is
rank 0 on the card and the player acts on the host CPU. ``eval`` takes the
checkpoints through SAC's evaluation.
"""
from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...config import Config
from ...data import ReplayBuffer
from ...envs import spaces
from ...parallel.mesh import collective_fields, rank_resume, ranks_state, run_log_dir
from ...parallel.mesh import current as current_distributed
from ...parallel.placement import make_param_mirror
from ...parallel.precision import disable_tf32
from ...resilience.guard import RunGuard
from ...telemetry.facade import Telemetry
from ...utils.checkpoint import CheckpointManager, gen_state, set_gen_state
from ...utils.env import episode_stats, probe_env_spaces, single_env, vectorize
from ...utils.logger import get_logger
from ...utils.metric import MetricAggregator
from ...utils.model_manager import register_model
from ...utils import run_info
from ...utils.registry import register_algorithm, register_evaluation
from ...utils.utils import Ratio
from ..ppo.ppo_decoupled import PlayerCrashed, chaos_raise_at
from .agent import build_agent, sample_actions
from .sac import build_optimizers, evaluate_sac, make_train_fn, replay_buffer, transition
from .utils import AGGREGATOR_KEYS, flatten_obs, test


class _Player:
    """Rank 0's env-stepping half: the envs, the buffer and the Ratio ledger."""

    def __init__(self, cfg: Config, mirror: Any, generator: torch.Generator, rb: ReplayBuffer, ratio: Ratio,
                 policy_step: int, batch_size: int, world_size: int, guard: RunGuard, log_dir: str):
        self.cfg, self.mirror, self.generator, self.rb, self.ratio = cfg, mirror, generator, rb, ratio
        self.policy_step, self.batch_size, self.world_size, self.guard = policy_step, batch_size, world_size, guard
        self.num_envs = int(cfg.env.num_envs)
        self.total_steps = int(cfg.algo.total_steps) if not cfg.dry_run else self.num_envs
        self.learning_starts = int(cfg.algo.learning_starts) if not cfg.dry_run else 0
        self.envs = vectorize(cfg, int(cfg.seed), 0, run_name=log_dir)

    def run(self, data_q: "queue.Queue", params_q: "queue.Queue", telem: Telemetry) -> None:
        """Step, store, and hand over ``(policy_step, G, batches, ratio
        state, episode stats, player generator state)`` for each iteration
        that owes gradient steps; then wait for the go-ahead (None: stop)."""
        cfg, n, envs = self.cfg, self.num_envs, self.envs
        try:
            mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
            action_space = envs.single_action_space
            act_dim = int(np.prod(action_space.shape))
            raise_at = chaos_raise_at(cfg)
            obs, _ = envs.reset(seed=int(cfg.seed))
            obs_vec = flatten_obs(obs, mlp_keys, n)
            ep_stats: List[tuple] = []
            while self.policy_step < self.total_steps:
                # the wall cap and the preemption drain hold during warmup too
                if self.guard.stop_local(self.policy_step, self.total_steps):
                    break
                with telem.span("Time/env_interaction_time"):
                    if self.policy_step <= self.learning_starts:
                        actions = np.stack([action_space.sample() for _ in range(n)])
                    else:
                        actor = self.mirror.current()["actor"]
                        with torch.no_grad():
                            mean, log_std = actor(torch.from_numpy(obs_vec).to(self.mirror.device))
                            acts, _ = sample_actions(actor, mean, log_std, generator=self.generator)
                        actions = acts.cpu().numpy().reshape(n, act_dim)
                    next_obs, rewards, terminated, truncated, info = envs.step(actions)
                    self.policy_step += n
                    row, obs_vec = transition(obs_vec, next_obs, actions, rewards, terminated, truncated, info,
                                              mlp_keys, n)
                    self.rb.add(row, validate_args=cfg.buffer.validate_args)
                    ep_stats.extend(episode_stats(info))
                if raise_at and self.policy_step >= raise_at:
                    raise RuntimeError(f"chaos: the player thread raises at policy step {self.policy_step}")
                if self.policy_step < self.learning_starts:
                    continue
                g = self.ratio(self.policy_step / self.world_size)
                if g <= 0:
                    continue
                sample = self.rb.sample(self.batch_size * g)
                batches = {k: np.asarray(v, np.float32).reshape(g, self.batch_size, *v.shape[2:])
                           for k, v in sample.items()}
                data_q.put((self.policy_step, g, batches, self.ratio.state_dict(), ep_stats,
                            gen_state(self.generator)))
                ep_stats = []
                if params_q.get() is None:  # the trainer stopped
                    break
            envs.close()
            try:  # nowait: the trainer may have left a batch unconsumed
                data_q.put_nowait(None)
            except queue.Full:
                pass
        except BaseException as e:  # surfaces on the trainer: the run fails on every rank
            try:
                data_q.put(e, timeout=30)
            except queue.Full:
                pass
            raise


def _scatter_columns(dist: Any, batches: Optional[Dict[str, np.ndarray]], header: Dict[str, Any],
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """Rank 0's ``[G, B, ...]`` batches, column block ``d`` to rank ``d``."""
    world, out = dist.world_size, {}
    for k, (shape, dtype) in header.items():
        like = torch.empty(shape, dtype=dtype, device=device)
        chunks = None
        if dist.rank == 0:
            full = torch.from_numpy(batches[k]).to(device)
            chunks = list(full.chunk(world, dim=1))
        out[k] = dist.scatter(chunks, like)
    return out


@register_algorithm(name="sac_decoupled", decoupled=True)
def main(cfg: Config) -> None:
    """The decoupled SAC loop: rank 0's player thread steps and samples,
    every rank trains on its columns of each burst's batch."""
    dist = current_distributed(cfg)
    rank, world = dist.rank, dist.world_size
    device = dist.device
    disable_tf32()
    seed = int(cfg.seed)
    log_dir = run_log_dir(cfg, dist)
    if rank == 0:
        print(f"[sac_decoupled] log_dir={log_dir}", flush=True)
    MetricAggregator.disabled = int(cfg.metric.select("log_level", 1) or 0) == 0
    state = CheckpointManager.load(cfg.checkpoint.resume_from, map_location=device) if cfg.checkpoint.resume_from \
        else None
    saved_gens = rank_resume(state, dist)
    torch.manual_seed(seed)
    probe = probe_env_spaces(cfg, seed)  # the player owns the real envs
    obs_space, action_space = probe.single_observation_space, probe.single_action_space
    if not isinstance(action_space, spaces.Box):
        raise RuntimeError(f"sac_decoupled requires a continuous (Box) action space, got {action_space}")
    act_dim = int(np.prod(action_space.shape))
    agent = build_agent(cfg, obs_space, action_space, device)
    optimizers = build_optimizers(cfg, agent)
    train_gen = torch.Generator(device=device)
    train_gen.manual_seed(seed + rank)
    if state:
        agent.load_state_dict(state["agent"])
        optimizers.load_state_dict(state["opt_states"])
        set_gen_state(train_gen, saved_gens["train"], "train", tag="sac_decoupled")
    train = make_train_fn(agent, optimizers, cfg, -act_dim, dist=dist if dist.collective else None)
    batch_size = int(cfg.algo.per_rank_batch_size) * world

    logger = get_logger(cfg, log_dir, rank)
    telem = Telemetry.setup(cfg, log_dir, rank, logger=logger, aggregator_keys=AGGREGATOR_KEYS, device=device)
    aggregator = telem.aggregator
    ckpt = CheckpointManager(log_dir, keep_last=cfg.checkpoint.keep_last, enabled=rank == 0)
    guard = RunGuard.setup(cfg, ckpt, log_dir, telem=telem, dist=dist)
    ckpt = guard.ckpt
    policy_step = int(state["policy_step"]) if state else 0
    last_log = int(state["last_log"]) if state else 0
    last_checkpoint = int(state["last_checkpoint"]) if state else 0
    grad_steps = int(state["grad_steps"]) if state else 0
    ratio_state = state["ratio"] if state else None
    player_gen_state = saved_gens["player"] if state else None

    data_q: "queue.Queue" = queue.Queue(maxsize=1)
    params_q: "queue.Queue" = queue.Queue(maxsize=1)
    player = thread = mirror = None
    if rank == 0:
        mirror, _, player_gen = make_param_mirror(cfg, device, {"actor": agent.actor}, seed)
        if state:
            set_gen_state(player_gen, saved_gens["player"], "player", tag="sac_decoupled")
        player_gen_state = gen_state(player_gen)
        rb = replay_buffer(cfg, log_dir, seed)
        if state and cfg.buffer.checkpoint and "rb" in state:
            rb.load_state_dict(state["rb"])
        ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
        if state:
            ratio.load_state_dict(state["ratio"])
        player = _Player(cfg, mirror, player_gen, rb, ratio, policy_step, batch_size, world, guard, log_dir)
        thread = threading.Thread(target=player.run, args=(data_q, params_q, telem), name="sac-player", daemon=True)
        thread.start()
    burst_s: List[float] = []
    t0 = time.perf_counter()

    def _ckpt_state() -> Dict[str, Any]:
        gens = {"train": gen_state(train_gen), "player": player_gen_state}
        s = {"agent": agent.state_dict(), "opt_states": optimizers.state_dict(), "ratio": ratio_state,
             "policy_step": policy_step, "last_log": last_log, "last_checkpoint": last_checkpoint,
             "grad_steps": grad_steps, "generators": gens, **ranks_state(dist, gens)}
        if cfg.buffer.checkpoint and player is not None:  # the player is parked: its buffer is quiescent
            s["rb"] = player.rb.checkpoint_state_dict()
        return s

    def next_burst() -> Any:
        """Rank 0 takes the player's burst (or its end, or its failure) and
        tells every rank: ``("data", header)``, ``("stop",)`` or ``("crash",
        msg)``; the batches follow by scatter."""
        msg, item = None, None
        if rank == 0:
            item = guard.wait(data_q)  # wakes up on preemption even if the player is dead
            if item is None:
                msg = ("stop",)
            elif isinstance(item, BaseException):
                msg = ("crash", f"{type(item).__name__}: {item}")
            else:
                p_step, g, batches, r_state, ep, p_gen = item
                header = {k: ((g, v.shape[1] // world, *v.shape[2:]), torch.float32) for k, v in batches.items()}
                msg = ("data", (p_step, g, header, r_state, ep, p_gen))
        msg = dist.broadcast_object(msg)
        if msg[0] == "crash":
            print(f"[sac_decoupled] rank {rank}: the player thread crashed ({msg[1]})", file=sys.stderr, flush=True)
            raise PlayerCrashed(f"rank {rank}: the player thread crashed ({msg[1]})")
        if msg[0] == "stop":
            return None
        p_step, g, header, r_state, ep, p_gen = msg[1]
        local = _scatter_columns(dist, item[2] if item is not None else None, header, device)
        return p_step, g, local, r_state, ep, p_gen

    steady_sync = run_info.device_sync(device)  # the first burst's end, for run_info.mark_steady
    try:
        while True:
            item = next_burst()
            if item is None:
                break
            policy_step, g, batches, ratio_state, ep_stats, player_gen_state = item
            telem.tick(policy_step)
            for ep_rew, ep_len in ep_stats if rank == 0 else ():  # the player's episodes, counted once
                aggregator.update("Rewards/rew_avg", ep_rew)
                aggregator.update("Game/ep_len_avg", ep_len)
            with telem.span("Time/train_time"):
                ts = time.perf_counter()
                metrics = train(batches, generator=train_gen)
                values = torch.stack(list(metrics.values())).cpu()  # host-sync: ok (trainer-iteration cadence)
                burst_s.append(time.perf_counter() - ts)
            grad_steps += g
            telem.record_grad_steps(g)
            if mirror is not None:
                mirror.refresh({"actor": agent.actor})
            run_info.mark_steady(policy_step, sync=steady_sync)
            for k, v in zip(metrics, values.numpy()):
                aggregator.update(k, v)
            # logs and checkpoints while the player waits for its go-ahead
            if policy_step - last_log >= int(cfg.metric.log_every) or cfg.dry_run:
                dist.reduce_metrics(aggregator)
                telem.log(policy_step, extra_metrics={"Params/replay_ratio": grad_steps * world / policy_step},
                          fields={"grad_steps": grad_steps, "elapsed_s": time.perf_counter() - t0,
                                  "update_ms": 1e3 * sum(burst_s) / len(burst_s),
                                  **({"mirror": mirror.stats()} if mirror is not None else {}),
                                  **collective_fields(dist)})
                burst_s.clear()
                last_log = policy_step
            every = int(cfg.checkpoint.every)
            if (every > 0 and policy_step - last_checkpoint >= every) or cfg.dry_run:
                last_checkpoint = policy_step
                ckpt.save(policy_step, _ckpt_state())
            # the stop before the go-ahead: the final save comes after the join
            if guard.stop_reached(policy_step, int(cfg.algo.total_steps), None, save=False):
                break
            if rank == 0:
                params_q.put(True)
    finally:
        if rank == 0:
            try:  # unblock the player whatever happened
                params_q.put_nowait(None)
            except queue.Full:
                pass
            thread.join(timeout=60)
    try:
        if rank == 0:  # the steps stored after the last burst count too
            policy_step, ratio_state = player.policy_step, player.ratio.state_dict()
            player_gen_state = gen_state(player.generator)
        policy_step = dist.broadcast_object(policy_step)
        if cfg.checkpoint.save_last:  # after the join: the buffer is quiescent
            ckpt.save(policy_step, _ckpt_state())
    finally:
        guard.close(policy_step, _ckpt_state)
        telem.close(policy_step)
    if cfg.algo.run_test and rank == 0:
        test(agent.actor, single_env(cfg, seed), cfg, device, logger)
    if rank == 0:
        register_model(cfg, {"actor": agent.actor, "critic": agent.critic}, log_dir)
    if logger is not None:
        logger.close()


register_evaluation("sac_decoupled")(evaluate_sac)
