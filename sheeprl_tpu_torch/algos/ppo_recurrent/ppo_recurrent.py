"""Recurrent PPO training in PyTorch (counterpart of
``sheeprl_tpu/algos/ppo_recurrent/ppo_recurrent.py``).

* the rollout acts one step at a time, carrying the LSTM state on the
  player's device; the carry at the start of every ``per_rank_sequence_length``
  chunk is kept to seed that training sequence;
* the ``[T, N]`` rollout is cut into fixed-length sequences (``to_seq``:
  sequence-major ``[C*N, L, ...]``, sequence ``s = chunk*N + env``), reset
  inside the LSTM loop where ``is_first`` is set, as the JAX package does;
* the update: ``update_epochs`` × minibatches of sequences, the
  permutations over sequences an argument (``perms [epochs, sequences]``)
  as in PPO's update;
* the loop is serial, as in the JAX package; checkpoints, resume, the
  RunGuard and the telemetry stream as in PPO's loop.

On N ranks (``parallel/mesh.py``) rank ``d`` rolls out env block ``d``; the
ranks all-gather the iteration's rollout with its ``hx0``/``cx0`` chunk
carries, so every rank holds the JAX package's sequences over all envs
(``s = chunk*N + env``); one permutation of all sequences per epoch
(``per_rank_num_batches × world_size`` global minibatches, the same draws on
every rank) and each rank trains on its column block of every global
minibatch, the advantages normalised over the global minibatch and the
gradients averaged. Rank 0 logs, checkpoints, tests and registers.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ...config import Config, instantiate
from ...envs import spaces
from ...ops import gae
from ...optim import Clipped, clipped
from ...parallel.mesh import collective, collective_fields, rank_resume, ranks_state
from ...parallel.mesh import current as current_distributed
from ...parallel.placement import make_param_mirror
from ...resilience.guard import RunGuard
from ...telemetry.facade import Telemetry
from ...utils.checkpoint import CheckpointManager, gen_state, set_gen_state
from ...utils.env import episode_stats, single_env
from ...utils.logger import get_logger
from ...utils.model_manager import register_model
from ...utils import run_info
from ...utils.registry import register_algorithm, register_evaluation
from ..ppo.loss import entropy_loss, policy_loss, value_loss
from ..ppo.ppo import (LOSS_KEYS, bootstrap_truncated, draw_perms, evaluate_agent, global_normalize, make_coefs,
                       optimizer_step, resume_counters, rollout_buffer, scaled_lr, start_run)
from ..ppo.utils import env_actions
from .agent import Carry, RecurrentPPOAgent, actions_and_log_probs, build_agent
from .utils import AGGREGATOR_KEYS, one_hot_actions, prepare_obs, test


def make_act_fn() -> Callable:
    @torch.no_grad()
    def act(agent: RecurrentPPOAgent, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor, carry: Carry,
            generator=None, noise=None):
        """One step on ``[1, N, ...]`` inputs: (actions [N, dims], logprob
        [N, 1], value [N, 1], carry)."""
        is_first = torch.zeros(1, prev_actions.shape[1], 1, device=prev_actions.device)
        actor_out, value, carry = agent(obs, prev_actions, is_first, carry)
        actions, logprob, _ = actions_and_log_probs([a[0] for a in actor_out], agent.is_continuous, noise=noise,
                                                    generator=generator)
        return actions, logprob, value[0], carry

    return act


def make_value_fn() -> Callable:
    @torch.no_grad()
    def value_fn(agent: RecurrentPPOAgent, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor,
                 carry: Carry) -> torch.Tensor:
        is_first = torch.zeros(1, prev_actions.shape[1], 1, device=prev_actions.device)
        return agent(obs, prev_actions, is_first, carry)[1][0]

    return value_fn


def to_seq(x: Any, seq_len: int) -> np.ndarray:
    """``[T, N, ...]`` → sequence-major ``[T//L * N, L, ...]``."""
    x = np.asarray(x)
    T, N = x.shape[:2]
    chunks = T // seq_len
    return x.reshape(chunks, seq_len, N, *x.shape[2:]).swapaxes(1, 2).reshape(chunks * N, seq_len, *x.shape[2:])


def make_update_fn(agent: RecurrentPPOAgent, optimizer: Clipped, cfg: Config, num_minibatches: int,
                   mb_size: int, dist: Any = None) -> Callable:
    """``update(data, coefs, perms) -> metrics``: ``data`` holds
    sequence-major ``[S, L, ...]`` tensors (``obs:<key>``, ``actions``,
    ``prev_actions``, ``is_first``, ``logprobs``, ``values``, ``returns``,
    ``advantages``) and ``cx0``/``hx0`` ``[S, H]``; ``perms`` is
    ``[update_epochs, S]``.

    With a ``Distributed``, ``data`` holds every rank's sequences and
    ``mb_size`` is the global minibatch: rank ``d`` takes block ``d`` of each
    (the JAX package's batch sharding), the advantages are normalised over
    the global minibatch and the optimizer (built with the same ``dist``)
    averages the gradients; a ``sum`` reduction scales the rank's loss by
    the world size, as PPO's update does."""
    update_epochs = int(cfg.algo.update_epochs)
    clip_vloss = bool(cfg.algo.clip_vloss)
    normalize_advantages = bool(cfg.algo.normalize_advantages)
    reduction = str(cfg.algo.loss_reduction)
    obs_keys = tuple(cfg.algo.cnn_keys.encoder) + tuple(cfg.algo.mlp_keys.encoder)
    world, rank = (dist.world_size, dist.rank) if dist is not None else (1, 0)
    if mb_size % world:
        raise ValueError(f"the global minibatch of {mb_size} sequences must divide by the world size ({world})")
    local = mb_size // world
    scale = float(world) if reduction != "mean" else 1.0

    def loss_fn(mb: Dict[str, torch.Tensor], coefs: Dict[str, Any]):
        def tm(x):  # sequence-major → time-major
            return x.transpose(0, 1)

        obs = {k: tm(mb[f"obs:{k}"]) for k in obs_keys}
        actor_out, new_values, _ = agent(obs, tm(mb["prev_actions"]), tm(mb["is_first"]), (mb["cx0"], mb["hx0"]))
        _, new_logprobs, entropy = actions_and_log_probs(actor_out, agent.is_continuous, actions=tm(mb["actions"]))
        advantages = tm(mb["advantages"])
        if normalize_advantages:
            advantages = global_normalize(advantages, dist if world > 1 else None)
        pg = policy_loss(new_logprobs, tm(mb["logprobs"]), advantages, coefs["clip_coef"], reduction)
        vl = value_loss(new_values, tm(mb["values"]), tm(mb["returns"]), coefs["clip_coef"], clip_vloss, reduction)
        el = entropy_loss(entropy, reduction)
        loss, aux = pg + coefs["vf_coef"] * vl + coefs["ent_coef"] * el, torch.stack([pg, vl, el]).detach()
        return (loss * scale, aux * scale) if scale != 1.0 else (loss, aux)

    def update(data: Dict[str, torch.Tensor], coefs: Dict[str, Any], perms: torch.Tensor) -> Dict[str, torch.Tensor]:
        sums = None
        with scaled_lr(optimizer.optimizer, float(coefs["lr_frac"])):
            for e in range(update_epochs):
                idxs = perms[e][: num_minibatches * mb_size].reshape(num_minibatches, mb_size)
                if world > 1:  # this rank's block of each global minibatch
                    idxs = idxs[:, rank * local:(rank + 1) * local]
                for j in range(num_minibatches):
                    loss, aux = loss_fn({k: v.index_select(0, idxs[j]) for k, v in data.items()}, coefs)
                    optimizer_step(optimizer, loss)
                    sums = aux if sums is None else sums + aux
        return dict(zip(LOSS_KEYS, sums / (update_epochs * num_minibatches)))

    return update


def sequence_batch(local: Dict[str, np.ndarray], next_value: np.ndarray, chunk_carry: Tuple[np.ndarray, np.ndarray],
                   cfg: Config, device: Any) -> Dict[str, torch.Tensor]:
    """GAE over the ``[T, N, ...]`` rollout, then the sequence-major batch on
    ``device`` with ``is_first`` (from the dones, where the rollout reset the
    carry) and each sequence's initial ``cx0``/``hx0`` (chunk-major
    ``[C, N, H]`` → ``[C*N, H]``, the order of ``to_seq``)."""
    seq_len = int(cfg.algo.per_rank_sequence_length)

    def t(x):
        return torch.as_tensor(np.asarray(x)).to(device)

    rewards, values, dones = t(local["rewards"]), t(local["values"]), t(local["dones"])
    T, N = rewards.shape[:2]
    returns, advantages = gae(rewards, values, dones, t(next_value).reshape(N, 1), T, float(cfg.algo.gamma),
                              float(cfg.algo.gae_lambda))
    if bool(cfg.algo.reset_recurrent_state_on_done):
        is_first = np.concatenate([np.zeros((1, N, 1), np.float32), np.asarray(local["dones"][:-1])], axis=0)
    else:
        is_first = np.zeros((T, N, 1), np.float32)
    data = {k: t(to_seq(v, seq_len)) for k, v in local.items()}
    data["is_first"] = t(to_seq(is_first, seq_len))
    data["returns"] = t(to_seq(returns.cpu().numpy(), seq_len))
    data["advantages"] = t(to_seq(advantages.cpu().numpy(), seq_len))
    H = chunk_carry[0].shape[-1]
    data["cx0"] = t(chunk_carry[0].reshape(-1, H))
    data["hx0"] = t(chunk_carry[1].reshape(-1, H))
    return data


@register_algorithm(name="ppo_recurrent")
def main(cfg: Config) -> None:
    device, seed, log_dir, state, envs = start_run(cfg, "ppo_recurrent")
    dist = current_distributed(cfg)
    rank, world = dist.rank, dist.world_size
    saved_gens = rank_resume(state, dist)
    obs_space, action_space = envs.single_observation_space, envs.single_action_space
    num_envs = int(cfg.env.num_envs)  # every rank's: the sequences the update sees
    lo, hi = dist.local_envs(num_envs)
    n_local = hi - lo  # this rank's env block, which it rolls out
    cnn_keys, mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    multi = isinstance(action_space, spaces.MultiDiscrete)

    agent = build_agent(cfg, obs_space, action_space, device)
    actions_dim, act_width, H = agent.actions_dim, sum(agent.actions_dim), agent.lstm_hidden_size
    reset_on_done = bool(cfg.algo.reset_recurrent_state_on_done)
    optimizer = clipped(instantiate(cfg.algo.optimizer, [p for p in agent.parameters() if p.requires_grad]),
                        cfg.algo.select("max_grad_norm"), collective(cfg))
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)  # the same on every rank: the permutations of the sequences
    if state:
        agent.load_state_dict(state["agent"])
        optimizer.optimizer.load_state_dict(state["opt_state"])
        set_gen_state(generator, saved_gens["train"], "train", tag="ppo_recurrent")

    rollout_steps = int(cfg.algo.rollout_steps)
    seq_len = int(cfg.algo.per_rank_sequence_length)
    if rollout_steps % seq_len != 0:
        raise ValueError(f"rollout_steps ({rollout_steps}) must be divisible by per_rank_sequence_length ({seq_len})")
    num_sequences = rollout_steps // seq_len * num_envs
    num_batches = int(cfg.algo.per_rank_num_batches) * world
    mb_size = max(num_sequences // num_batches, 1) if num_batches > 0 else 1
    num_minibatches = num_sequences // mb_size
    update_epochs = int(cfg.algo.update_epochs)
    act, value_fn = make_act_fn(), make_value_fn()
    update = make_update_fn(agent, optimizer, cfg, num_minibatches, mb_size, collective(cfg))
    mirror, pdev, player_gen = make_param_mirror(cfg, device, {"agent": agent}, seed + rank)
    if state:
        set_gen_state(player_gen, saved_gens["player"], "player", tag="ppo_recurrent")

    logger = get_logger(cfg, log_dir, rank)
    telem = Telemetry.setup(cfg, log_dir, rank, logger=logger, aggregator_keys=AGGREGATOR_KEYS, device=device)
    aggregator = telem.aggregator
    guard = RunGuard.setup(cfg, CheckpointManager(log_dir, keep_last=cfg.checkpoint.keep_last, enabled=rank == 0),
                           log_dir, telem=telem, dist=dist)
    ckpt = guard.ckpt

    policy_steps_per_iter = num_envs * rollout_steps
    num_updates = int(cfg.algo.total_steps) // policy_steps_per_iter if not cfg.dry_run else 1
    start_iter, policy_step, last_log, last_checkpoint = resume_counters(cfg, state, agent, "ppo_recurrent")
    grad_steps = (start_iter - 1) * num_minibatches * update_epochs

    rb = rollout_buffer(cfg, rollout_steps, n_local, obs_keys, log_dir, f"rank_{rank}", seed)
    obs, _ = envs.reset(seed=seed + lo)  # env i of the block resets as the JAX package's env lo+i
    carry = agent.initial_states(n_local, pdev)
    prev_actions = np.zeros((n_local, act_width), np.float32)
    completed_update = start_iter - 1
    update_s: List[float] = []
    t0 = time.perf_counter()

    def prep(o: Dict[str, np.ndarray], n: int) -> Dict[str, torch.Tensor]:
        return prepare_obs(o, cnn_keys, mlp_keys, n, pdev)

    def as_prev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=pdev).reshape(1, a.shape[0], act_width)

    def sub_carry(c: Carry, idx: np.ndarray) -> Carry:
        i = torch.as_tensor(idx, device=pdev)
        return c[0][i], c[1][i]

    def _ckpt_state() -> Dict[str, Any]:
        gens = {"train": gen_state(generator), "player": gen_state(player_gen)}
        return {"agent": agent.state_dict(), "opt_state": optimizer.optimizer.state_dict(), "update": completed_update,
                "policy_step": policy_step, "last_log": last_log, "last_checkpoint": last_checkpoint,
                "generators": gens, **ranks_state(dist, gens)}

    steady_sync = run_info.device_sync(device)  # the first update's end, for run_info.mark_steady
    try:
        for update_iter in range(start_iter, num_updates + 1):
            telem.tick(policy_step)
            chunk_cx, chunk_hx = [], []
            with telem.span("Time/env_interaction_time"):
                for t in range(rollout_steps):
                    pa = mirror.current()["agent"]
                    if t % seq_len == 0:  # the carry that seeds this chunk's training sequences
                        chunk_cx.append(carry[0].cpu().numpy())
                        chunk_hx.append(carry[1].cpu().numpy())
                    actions, logprobs, values, carry = act(pa, prep(obs, n_local), as_prev(prev_actions), carry,
                                                           generator=player_gen)
                    # one device-to-host copy a step (small int actions are exact in f32)
                    host = torch.cat([actions.float(), logprobs, values], dim=-1).cpu().numpy()
                    np_actions, logprobs, values = host[:, :-2], host[:, -2:-1], host[:, -1:]
                    if not agent.is_continuous:
                        np_actions = np_actions.astype(np.int64)
                    next_obs, rewards, terminated, truncated, info = envs.step(
                        env_actions(np_actions, agent.is_continuous, n_local, multi))
                    rewards = np.asarray(rewards, dtype=np.float32).reshape(n_local, 1)
                    dones = np.logical_or(terminated, truncated).astype(np.float32).reshape(n_local, 1)
                    actions_oh = one_hot_actions(np_actions, actions_dim, agent.is_continuous)
                    # truncation bootstrapping: the final obs's value under the post-step carry
                    bootstrap_truncated(rewards, truncated, info, obs_keys,
                                        lambda o, idx: value_fn(pa, prep(o, len(idx)), as_prev(actions_oh[idx]),
                                                                sub_carry(carry, idx)).cpu(),
                                        float(cfg.algo.gamma))
                    step_data = {f"obs:{k}": np.asarray(obs[k]).reshape(1, n_local, *obs_space[k].shape)
                                 for k in obs_keys}
                    step_data["actions"] = np_actions.reshape(1, n_local, -1).astype(np.float32)
                    step_data["prev_actions"] = prev_actions.reshape(1, n_local, act_width)
                    step_data["logprobs"] = logprobs.reshape(1, n_local, 1)
                    step_data["values"] = values.reshape(1, n_local, 1)
                    step_data["rewards"] = rewards.reshape(1, n_local, 1)
                    step_data["dones"] = dones.reshape(1, n_local, 1)
                    rb.add(step_data, validate_args=cfg.buffer.validate_args)
                    # the host-side resets between steps
                    prev_actions = (1.0 - dones) * actions_oh
                    if reset_on_done and np.any(dones):
                        keep = torch.as_tensor(1.0 - dones, device=pdev)
                        carry = (carry[0] * keep, carry[1] * keep)
                    obs = next_obs
                    for ep_rew, ep_len in episode_stats(info):
                        aggregator.update("Rewards/rew_avg", ep_rew)
                        aggregator.update("Game/ep_len_avg", ep_len)
            policy_step += policy_steps_per_iter
            with telem.span("Time/train_time"):
                ts = time.perf_counter()
                next_value = value_fn(mirror.current()["agent"], prep(obs, n_local), as_prev(prev_actions), carry)
                local = {k: rb[k] for k in rb.keys()}
                next_value, chunks = next_value.cpu().numpy(), (np.stack(chunk_cx), np.stack(chunk_hx))
                if world > 1:  # every rank's env block, in rank order: the JAX package's [T, num_envs] rollout
                    parts = dist.all_gather_object((local, next_value, chunks))
                    local = {k: np.concatenate([p[0][k] for p in parts], axis=1) for k in local}
                    next_value = np.concatenate([p[1] for p in parts], axis=0)
                    chunks = tuple(np.concatenate([p[2][i] for p in parts], axis=1) for i in range(2))
                data = sequence_batch(local, next_value, chunks, cfg, device)
                perms = draw_perms(generator, update_epochs, num_sequences, device)
                metrics = update(data, make_coefs(cfg, update_iter, num_updates, device), perms)
                grad_steps += num_minibatches * update_epochs
                telem.record_grad_steps(num_minibatches * update_epochs)
                mirror.refresh({"agent": agent})  # blocking: the next rollout acts with these
                for k, v in metrics.items():
                    aggregator.update(k, float(v))  # host-sync: ok (update cadence)
                update_s.append(time.perf_counter() - ts)
                run_info.mark_steady(policy_step, sync=steady_sync)
            completed_update = update_iter
            if policy_step - last_log >= int(cfg.metric.log_every) or cfg.dry_run or update_iter == num_updates:
                dist.reduce_metrics(aggregator)  # N ranks: rank 0 logs the global means
                telem.log(policy_step, fields={"updates": completed_update, "grad_steps": grad_steps,
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


@register_evaluation("ppo_recurrent")
def evaluate_ppo_recurrent(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode with the checkpoint's agent, carrying its LSTM
    state (``eval``)."""
    evaluate_agent(cfg, state, build_agent, test)
