"""PPO training in PyTorch (counterpart of ``sheeprl_tpu/algos/ppo/ppo.py``).

* ``make_act_fn`` / ``make_value_fn``: the rollout's policy step and the
  bootstrap value, on the player's copy of the agent;
* ``make_update_fn``: the whole update, ``update_epochs`` × minibatches of
  Adam steps. The minibatch permutations are an argument (``perms
  [epochs, batch]``, drawn by the loop from its train generator), so a test
  can hand in the ones ``jax.random.permutation`` drew. ``lr_frac`` (the lr
  annealing) scales the param groups' lr for the update, which for Adam is
  the JAX package's scaling of the update;
* GAE is ``ops/returns.py:gae``;
* ``main``: the overlapped loop in strict on-policy mode (``algo.overlap``:
  ``staleness_bound: 0``, ``queue_depth: 1``): the player thread collects
  rollout k+1 only once the update on rollout k is published to the
  ``ParamMirror``, so its trajectory is the serial loop's; or the serial
  loop (``algo.overlap.enabled=False``). Ping-pong rollout buffers,
  checkpoints with ``checkpoint.resume_from``, the RunGuard (preemption,
  wall cap, watchdog) and the telemetry stream;
* ``evaluate_ppo``: one greedy episode from a checkpoint (the ``eval``
  command). The JAX package routes its evaluation through its serving
  subsystem, which the port does not have yet.

* the actor fleet (``algo.fleet.workers > 0``, ``fleet/``): supervised
  worker processes collect one rollout slice each per publication (strict
  rounds), merged full width by ``merge_ppo_round``; the learner publishes
  the agent through a host ``ParamMirror`` after every update.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ...config import Config, instantiate
from ...data import ReplayBuffer
from ...engine import OverlapEngine, Packet
from ...envs import spaces
from ...fleet import FleetEngine
from ...fleet.engine import PROGRAMS, refuse_fleet
from ...fleet.programs import merge_ppo_round
from ...ops import gae
from ...optim import Clipped, clipped
from ...parallel.mesh import collective_fields, local_cfg, rank_resume, ranks_state, run_log_dir
from ...parallel.mesh import current as current_distributed
from ...parallel.placement import make_param_mirror
from ...parallel.precision import disable_tf32
from ...resilience.guard import RunGuard
from ...telemetry.facade import Telemetry
from ...utils.checkpoint import CheckpointManager, gen_state, param_sums, set_gen_state
from ...utils.env import episode_stats, probe_env_spaces, single_env, vectorize
from ...utils.logger import get_logger
from ...utils.metric import MetricAggregator
from ...utils.model_manager import register_model
from ...utils import run_info
from ...utils.registry import register_algorithm, register_evaluation
from ...utils.utils import get_device, linear_annealing
from .agent import PPOAgent, actions_and_log_probs, build_agent
from .loss import entropy_loss, policy_loss, value_loss
from .utils import AGGREGATOR_KEYS, env_actions, prepare_obs, test

LOSS_KEYS = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")


def start_run(cfg: Config, algo: str):
    """The start every on-policy and off-policy loop shares: refuse the fleet
    where ``algo`` has no fleet program, pick the device (f32, TF32 off),
    make the run's log dir with its config and print ``[<algo>]
    log_dir=...``, load ``checkpoint.resume_from``, seed and build the vector
    env (under the fleet, ``probe_env_spaces``: the workers own the envs).
    On N ranks (``parallel/mesh.py``) the device is the rank's, rank 0 makes
    the log dir and the vector env is the rank's env block.
    Returns ``(device, seed, log_dir, state, envs)``."""
    refuse_fleet(cfg, algo)
    fleet = FleetEngine.configured(cfg)  # off on N ranks: each rank keeps its env loop
    dist = current_distributed(cfg)
    device = dist.device
    disable_tf32()
    seed = int(cfg.seed)
    log_dir = run_log_dir(cfg, dist)
    if dist.is_global_zero:
        print(f"[{algo}] log_dir={log_dir}", flush=True)
    MetricAggregator.disabled = int(cfg.metric.select("log_level", 1) or 0) == 0
    state = None
    if cfg.checkpoint.resume_from:
        state = CheckpointManager.load(cfg.checkpoint.resume_from, map_location=device)
    torch.manual_seed(seed)
    # N ranks: this rank's env block, seeded as the JAX package seeds those envs
    envs = probe_env_spaces(cfg, seed) if fleet else vectorize(local_cfg(cfg, dist), seed, dist.rank, run_name=log_dir)
    if not isinstance(envs.single_observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {envs.single_observation_space}")
    return device, seed, log_dir, state, envs


def resume_counters(cfg: Config, state: Optional[Dict[str, Any]], agent: torch.nn.Module, algo: str):
    """``(first update, policy_step, last_log, last_checkpoint)`` of a fresh
    run or of the checkpoint it resumes, which it prints as ``[<algo>]
    resumed {json}`` (counters and the agent's float64 parameter sum, to be
    held against the file's)."""
    if not state:
        return 1, 0, 0, 0
    counters = [int(state[k]) for k in ("update", "policy_step", "last_log", "last_checkpoint")]
    print(f"[{algo}] resumed " + json.dumps({
        "checkpoint": str(cfg.checkpoint.resume_from), **dict(zip(("update", "policy_step", "last_log",
                                                                  "last_checkpoint"), counters)),
        "param_sums": param_sums({"agent": agent}),
    }), flush=True)
    return counters[0] + 1, counters[1], counters[2], counters[3]


def make_act_fn() -> Callable:
    @torch.no_grad()
    def act(agent: PPOAgent, obs: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
            noise: Optional[Sequence[torch.Tensor]] = None):
        """(actions, logprob [N, 1], value [N, 1]) of one policy step."""
        actor_out, value = agent(obs)
        actions, logprob, _ = actions_and_log_probs(actor_out, agent.is_continuous, noise=noise, generator=generator)
        return actions, logprob, value

    return act


def make_value_fn() -> Callable:
    @torch.no_grad()
    def value_fn(agent: PPOAgent, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return agent(obs)[1]

    return value_fn


def make_coefs(cfg: Config, update_iter: int, num_updates: int, device: Any) -> Dict[str, Any]:
    """The update's coefficients (clip and entropy annealing, ``lr_frac``):
    f32 tensors on ``device`` as the JAX package passes them, ``lr_frac`` a
    float (it sets the param groups' lr)."""
    algo = cfg.algo

    def coef(name: str, anneal: bool) -> torch.Tensor:
        v = float(algo[name])
        return torch.tensor(linear_annealing(v, update_iter - 1, num_updates) if anneal else v, dtype=torch.float32,
                            device=device)

    return {
        "clip_coef": coef("clip_coef", bool(algo.anneal_clip_coef)),
        "ent_coef": coef("ent_coef", bool(algo.anneal_ent_coef)),
        "vf_coef": torch.tensor(float(algo.vf_coef), dtype=torch.float32, device=device),
        "lr_frac": 1.0 - (update_iter - 1) / max(num_updates, 1) if algo.anneal_lr else 1.0,
    }


@contextlib.contextmanager
def scaled_lr(optimizer: torch.optim.Optimizer, frac: float):
    """The param groups' lr times ``frac`` inside the block."""
    base = [g["lr"] for g in optimizer.param_groups]
    for g, lr in zip(optimizer.param_groups, base):
        g["lr"] = lr * frac
    try:
        yield
    finally:
        for g, lr in zip(optimizer.param_groups, base):
            g["lr"] = lr


def optimizer_step(optimizer: Clipped, loss: torch.Tensor) -> None:
    """Backward and one clipped step; a parameter without a gradient gets
    zeros, so its moments decay as optax updates every leaf."""
    optimizer.zero_grad()
    loss.backward()
    for p in optimizer.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()


def global_normalize(x: torch.Tensor, dist: Any = None) -> torch.Tensor:
    """``(x - mean) / (std + 1e-8)`` with the population std, as ``jnp.std``.
    With a ``Distributed`` the mean and the std are the global minibatch's:
    the count and the sum, then the sum of squared deviations, all-reduced."""
    if dist is None:
        return (x - x.mean()) / (x.std(correction=0) + 1e-8)
    n_sum = dist.all_reduce_sum(torch.stack([torch.tensor(float(x.numel()), device=x.device), x.sum()]))
    mean = n_sum[1] / n_sum[0]
    var = dist.all_reduce_sum((x - mean).square().sum()) / n_sum[0]
    return (x - mean) / (var.sqrt() + 1e-8)


def make_update_fn(agent: PPOAgent, optimizer: Clipped, cfg: Config, num_minibatches: int, mb_size: int,
                   dist: Any = None) -> Callable:
    """``update(data, coefs, perms) -> metrics``: ``data`` maps
    ``obs:<key>``, ``actions``, ``logprobs``, ``values``, ``returns`` and
    ``advantages`` to ``[batch, ...]`` tensors on the learner's device,
    ``perms`` is ``[update_epochs, batch]``. The agent and the optimizer are
    updated in place; the metrics are the mean losses over every minibatch,
    as tensors (no host sync).

    With a ``Distributed`` (``parallel/mesh.py``), ``data`` is the whole
    rollout on every rank and ``mb_size`` the global minibatch: rank ``d``
    takes slice ``d`` of each (the JAX package's batch sharding), the
    advantages are normalised over the global minibatch, and the optimizer
    (built with the same ``dist``) averages the gradients; a ``sum``
    reduction scales the rank's loss by the world size, so the average is
    the global sum's gradient, and its metrics likewise."""
    update_epochs = int(cfg.algo.update_epochs)
    clip_vloss = bool(cfg.algo.clip_vloss)
    normalize_advantages = bool(cfg.algo.normalize_advantages)
    reduction = str(cfg.algo.loss_reduction)
    world, rank = (dist.world_size, dist.rank) if dist is not None else (1, 0)
    local = mb_size // world
    scale = float(world) if reduction != "mean" else 1.0

    def loss_fn(mb: Dict[str, torch.Tensor], coefs: Dict[str, Any]):
        obs = {k[4:]: v for k, v in mb.items() if k.startswith("obs:")}
        actor_out, new_values = agent(obs)
        _, new_logprobs, entropy = actions_and_log_probs(actor_out, agent.is_continuous, actions=mb["actions"])
        advantages = mb["advantages"]
        if normalize_advantages:
            advantages = global_normalize(advantages, dist if world > 1 else None)
        pg = policy_loss(new_logprobs, mb["logprobs"], advantages, coefs["clip_coef"], reduction)
        vl = value_loss(new_values, mb["values"], mb["returns"], coefs["clip_coef"], clip_vloss, reduction)
        el = entropy_loss(entropy, reduction)
        loss, aux = pg + coefs["vf_coef"] * vl + coefs["ent_coef"] * el, torch.stack([pg, vl, el]).detach()
        return (loss * scale, aux * scale) if scale != 1.0 else (loss, aux)

    def update(data: Dict[str, torch.Tensor], coefs: Dict[str, Any], perms: torch.Tensor) -> Dict[str, torch.Tensor]:
        sums = None
        with scaled_lr(optimizer.optimizer, float(coefs["lr_frac"])):
            for e in range(update_epochs):
                idxs = perms[e][: num_minibatches * mb_size].reshape(num_minibatches, mb_size)
                if world > 1:  # this rank's slice of each global minibatch
                    idxs = idxs[:, rank * local:(rank + 1) * local]
                for j in range(num_minibatches):
                    mb = {k: v.index_select(0, idxs[j]) for k, v in data.items()}
                    loss, aux = loss_fn(mb, coefs)
                    optimizer_step(optimizer, loss)
                    sums = aux if sums is None else sums + aux
        means = sums / (update_epochs * num_minibatches)
        return dict(zip(LOSS_KEYS, means))

    return update


def draw_perms(generator: torch.Generator, epochs: int, batch: int, device: Any) -> torch.Tensor:
    return torch.stack([torch.randperm(batch, generator=generator, device=device) for _ in range(epochs)])


def rollout_batch(local: Dict[str, np.ndarray], next_value: Any, cfg: Config, device: Any):
    """GAE over a ``[T, N, ...]`` rollout and the flattened ``[T*N, ...]``
    batch on ``device`` with ``returns`` and ``advantages``."""
    def t(x):
        return torch.as_tensor(np.asarray(x)).to(device)

    rewards, values, dones = t(local["rewards"]), t(local["values"]), t(local["dones"])
    T, N = rewards.shape[:2]
    returns, advantages = gae(rewards, values, dones, t(next_value).reshape(N, 1), T, float(cfg.algo.gamma),
                              float(cfg.algo.gae_lambda))
    data = {k: t(v).reshape(T * N, *np.asarray(v).shape[2:]) for k, v in local.items()}
    data["returns"] = returns.reshape(T * N, 1)
    data["advantages"] = advantages.reshape(T * N, 1)
    return data


def rollout_buffer(cfg: Config, rollout_steps: int, num_envs: int, obs_keys: Sequence[str], log_dir: str, name: str,
                   seed: int) -> ReplayBuffer:
    memmap = bool(cfg.buffer.memmap)
    return ReplayBuffer(rollout_steps, num_envs, obs_keys=obs_keys, memmap=memmap,
                        memmap_dir=os.path.join(log_dir, "memmap_buffer", name) if memmap else None, seed=seed)


def bootstrap_truncated(rewards: np.ndarray, truncated: Any, info: Dict[str, Any], obs_keys, value_of, gamma: float):
    """Truncation bootstrapping: ``r += γ·V(final obs)`` for the envs that
    were truncated this step. ``value_of(obs dict, env indices)`` returns
    ``[n, 1]``."""
    truncated = np.asarray(truncated).reshape(-1)
    if not np.any(truncated) or "final_obs" not in info:
        return
    idx = np.nonzero(truncated)[0]
    stacked = {k: np.stack([np.asarray(info["final_obs"][i][k]) for i in idx]) for k in obs_keys}
    rewards[idx] += gamma * np.asarray(value_of(stacked, idx)).reshape(-1, 1)


class Rollout:
    """The rollout half of the on-policy loops: ``rollout(buf)`` steps the
    envs ``algo.rollout_steps`` times with the mirror's agent and the
    player's generator, fills ``buf``, and returns the ``[T, N, ...]``
    arrays, the bootstrap value (numpy, so no tensor of the player's stream
    crosses to the learner's) and the finished episodes' stats (returned,
    not aggregated: under overlap this runs on the player thread, and the
    aggregator stays on the learner's)."""

    def __init__(self, cfg: Config, envs: Any, mirror: Any, pdev: torch.device, generator: torch.Generator,
                 is_continuous: bool, act: Callable, value_fn: Callable):
        self.cfg, self.envs, self.mirror, self.pdev, self.generator = cfg, envs, mirror, pdev, generator
        self.is_continuous, self.act, self.value_fn = is_continuous, act, value_fn
        self.num_envs = int(cfg.env.num_envs)
        self.steps = int(cfg.algo.rollout_steps)
        self.cnn_keys, self.mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
        self.obs_keys = self.cnn_keys + self.mlp_keys
        self.obs_space = envs.single_observation_space
        self.multi = isinstance(envs.single_action_space, spaces.MultiDiscrete)
        self.obs = None

    def reset(self, seed: int) -> None:
        self.obs, _ = self.envs.reset(seed=seed)

    def prepare(self, obs: Dict[str, np.ndarray], n: int) -> Dict[str, torch.Tensor]:
        return prepare_obs(obs, self.cnn_keys, self.mlp_keys, n, self.pdev)

    def __call__(self, buf: ReplayBuffer):
        n, cfg = self.num_envs, self.cfg
        ep_stats = []
        for _ in range(self.steps):
            agent = self.mirror.current()["agent"]
            actions, logprobs, values = self.act(agent, self.prepare(self.obs, n), generator=self.generator)
            # one device-to-host copy a step: actions (small ints are exact in
            # f32), log-probs and values side by side
            host = torch.cat([actions.float(), logprobs, values], dim=-1).cpu().numpy()
            np_actions, logprobs, values = host[:, :-2], host[:, -2:-1], host[:, -1:]
            if not self.is_continuous:
                np_actions = np_actions.astype(np.int64)
            next_obs, rewards, terminated, truncated, info = self.envs.step(
                env_actions(np_actions, self.is_continuous, n, self.multi))
            rewards = np.asarray(rewards, dtype=np.float32).reshape(n, 1)
            dones = np.logical_or(terminated, truncated).astype(np.float32).reshape(n, 1)
            bootstrap_truncated(rewards, truncated, info, self.obs_keys,
                                lambda o, idx: self.value_fn(agent, self.prepare(o, len(idx))).cpu(),
                                float(cfg.algo.gamma))
            step_data = {f"obs:{k}": np.asarray(self.obs[k]).reshape(1, n, *self.obs_space[k].shape)
                         for k in self.obs_keys}
            step_data["actions"] = np_actions.reshape(1, n, -1).astype(np.float32)
            step_data["logprobs"] = logprobs.reshape(1, n, 1)
            step_data["values"] = values.reshape(1, n, 1)
            step_data["rewards"] = rewards.reshape(1, n, 1)
            step_data["dones"] = dones.reshape(1, n, 1)
            buf.add(step_data, validate_args=cfg.buffer.validate_args)
            self.obs = next_obs
            ep_stats.extend(episode_stats(info))
        next_value = self.value_fn(self.mirror.current()["agent"], self.prepare(self.obs, n))
        return {k: buf[k] for k in buf.keys()}, next_value.cpu().numpy(), ep_stats


@register_algorithm(name="ppo")
def main(cfg: Config) -> None:
    """PPO's training loop: rollout, GAE, the update; overlapped in strict
    on-policy mode or serial; checkpoints, the RunGuard and resume; one
    greedy test episode at the end.

    On N ranks (``parallel/mesh.py``) rank ``d`` rolls out env block ``d``;
    the ranks all-gather the iteration's rollout, draw the same minibatch
    permutations from one seeded generator and each trains on its slice of
    every global minibatch of ``per_rank_batch_size × world_size`` rows.
    Rank 0 logs the global metrics, checkpoints, tests and registers."""
    device, seed, log_dir, state, envs = start_run(cfg, "ppo")
    steady_sync = run_info.device_sync(device)  # the first update's end, for run_info.mark_steady
    dist = current_distributed(cfg)
    rank, world = dist.rank, dist.world_size
    obs_space, action_space = envs.single_observation_space, envs.single_action_space
    num_envs = int(cfg.env.num_envs)
    cnn_keys, mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    saved_gens = rank_resume(state, dist)

    agent = build_agent(cfg, obs_space, action_space, device)
    optimizer = clipped(instantiate(cfg.algo.optimizer, list(agent.parameters())), cfg.algo.select("max_grad_norm"),
                        dist if dist.collective else None)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)  # the same on every rank: the minibatch permutations
    if state:
        agent.load_state_dict(state["agent"])
        optimizer.optimizer.load_state_dict(state["opt_state"])
        set_gen_state(generator, saved_gens["train"], "train", tag="ppo")

    rollout_steps = int(cfg.algo.rollout_steps)
    total_batch = rollout_steps * num_envs
    mb_size = int(cfg.algo.per_rank_batch_size) * world
    if total_batch % mb_size != 0:
        raise ValueError(f"rollout_steps*num_envs ({total_batch}) must be divisible by "
                         f"per_rank_batch_size*world_size ({mb_size})")
    num_minibatches = total_batch // mb_size
    update_epochs = int(cfg.algo.update_epochs)
    update = make_update_fn(agent, optimizer, cfg, num_minibatches, mb_size, dist if dist.collective else None)
    # the player acts with its own copy of the agent and its own generator;
    # a blocking refresh after every update keeps PPO on-policy (the fleet
    # publishes from a host copy)
    fleet_on = FleetEngine.configured(cfg)
    mirror, pdev, player_gen = make_param_mirror(cfg, device, {"agent": agent}, seed + rank, host=fleet_on)
    if state:
        set_gen_state(player_gen, saved_gens["player"], "player", tag="ppo")

    logger = get_logger(cfg, log_dir, rank)
    telem = Telemetry.setup(cfg, log_dir, rank, logger=logger, aggregator_keys=AGGREGATOR_KEYS, device=device)
    aggregator = telem.aggregator
    ckpt = CheckpointManager(log_dir, keep_last=cfg.checkpoint.keep_last, enabled=rank == 0)
    guard = RunGuard.setup(cfg, ckpt, log_dir, telem=telem, dist=dist)
    ckpt = guard.ckpt

    policy_steps_per_iter = num_envs * rollout_steps
    num_updates = int(cfg.algo.total_steps) // policy_steps_per_iter if not cfg.dry_run else 1
    start_iter, policy_step, last_log, last_checkpoint = resume_counters(cfg, state, agent, "ppo")
    grad_steps = (start_iter - 1) * num_minibatches * update_epochs

    lcfg = local_cfg(cfg, dist)  # the rollout's envs: this rank's block
    rollout = Rollout(lcfg, envs, mirror, pdev, player_gen, agent.is_continuous, make_act_fn(), make_value_fn())
    if not fleet_on:
        rollout.reset(seed + dist.local_envs(num_envs)[0])  # env i of the block resets as the JAX package's env lo+i
    player_gen_state = gen_state(player_gen)  # after the last rollout the learner consumed
    completed_update = start_iter - 1
    update_s: List[float] = []  # wall seconds of each update since the last log
    t0 = time.perf_counter()

    def _ckpt_state() -> Dict[str, Any]:
        # `update` is the last update whose parameters the checkpoint holds
        # (the overlapped loop can break at the top of an iteration)
        gens = {"train": gen_state(generator), "player": player_gen_state}
        return {
            "agent": agent.state_dict(),
            "opt_state": optimizer.optimizer.state_dict(),
            "update": completed_update,
            "policy_step": policy_step,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "generators": gens,
            **ranks_state(dist, gens),
        }

    def record_ep_stats(ep_stats) -> None:
        for ep_rew, ep_len in ep_stats:
            aggregator.update("Rewards/rew_avg", ep_rew)
            aggregator.update("Game/ep_len_avg", ep_len)

    def update_from(local, next_value, update_iter: int) -> None:
        """GAE and the update on one rollout, the mirror refreshed (learner)."""
        nonlocal grad_steps
        ts = time.perf_counter()
        if world > 1:  # every rank's env block, in rank order: the JAX package's [T, num_envs] rollout
            parts = dist.all_gather_object((local, next_value))
            local = {k: np.concatenate([p[0][k] for p in parts], axis=1) for k in local}
            next_value = np.concatenate([p[1] for p in parts], axis=0)
        data = rollout_batch(local, next_value, cfg, device)
        perms = draw_perms(generator, update_epochs, total_batch, device)
        metrics = update(data, make_coefs(cfg, update_iter, num_updates, device), perms)
        grad_steps += num_minibatches * update_epochs
        telem.record_grad_steps(num_minibatches * update_epochs)
        mirror.refresh({"agent": agent})  # blocking: the next rollout acts with these
        for k, v in metrics.items():
            aggregator.update(k, float(v))  # host-sync: ok (update cadence)
        update_s.append(time.perf_counter() - ts)

    def flush_logs() -> None:
        nonlocal last_log
        if policy_step - last_log >= int(cfg.metric.log_every) or cfg.dry_run or completed_update == num_updates:
            dist.reduce_metrics(aggregator)  # N ranks: rank 0 logs the global means
            telem.log(policy_step, fields={"updates": completed_update, "grad_steps": grad_steps,
                                           "elapsed_s": time.perf_counter() - t0,
                                           "update_ms": 1e3 * sum(update_s) / len(update_s) if update_s else None,
                                           "mirror": mirror.stats(), **collective_fields(dist)})
            update_s.clear()
            last_log = policy_step

    def maybe_checkpoint(update_iter: int) -> None:
        nonlocal last_checkpoint
        every = int(cfg.checkpoint.every)
        if (every > 0 and policy_step - last_checkpoint >= every) or cfg.dry_run or update_iter == num_updates:
            last_checkpoint = policy_step
            ckpt.save(policy_step, _ckpt_state())

    engine = OverlapEngine.setup(cfg, telem, guard, total_steps=num_updates * policy_steps_per_iter,
                                 initial_step=policy_step)
    fleet = FleetEngine.setup(cfg, telem, guard, total_steps=num_updates * policy_steps_per_iter,
                              initial_step=policy_step)
    try:
        if fleet.enabled:
            # ---- actor fleet, strict rounds: each worker collects ONE rollout
            # slice per publication; only rollouts acted with the newest
            # publication merge (a post-crash duplicate for an older one is
            # dropped), full width; a quarantined worker's columns are
            # backfilled from the survivors, so the update's shapes never change
            fleet.start(PROGRAMS["ppo"], num_envs, cfg)
            fleet.publish(mirror.current())  # v1 releases the first rollouts
            stopped = False
            update_iter = start_iter
            try:
                while update_iter <= num_updates:
                    telem.tick(policy_step)
                    if guard.stop_reached(policy_step, int(cfg.algo.total_steps), None, save=False):
                        stopped = True
                        break
                    with telem.span("Time/env_interaction_time"):
                        rnd = fleet.take_round(policy_step, min_version=fleet.pub_version)
                    if rnd is None:
                        break
                    t_merge0 = time.time()
                    local, next_value, ep_stats = merge_ppo_round(rnd, fleet.workers)
                    fleet.mark_applied(rnd, t_merge0)
                    policy_step += rnd.env_steps
                    record_ep_stats(ep_stats)
                    with telem.span("Time/train_time"):
                        update_from(local, next_value, update_iter)
                        fleet.publish(mirror.current())  # releases the parked workers
                        run_info.mark_steady(policy_step, sync=steady_sync)
                    completed_update = update_iter
                    flush_logs()
                    maybe_checkpoint(update_iter)
                    update_iter += 1
            finally:
                # queued rollouts (for parameters that will never act again)
                # are dropped: PPO keeps no buffer across updates
                fleet.shutdown()
            if (stopped or update_iter <= num_updates) and not guard.preempted and cfg.checkpoint.save_last:
                ckpt.save(policy_step, _ckpt_state())
        elif engine.enabled:
            # ---- overlapped loop, strict on-policy (staleness_bound 0): the
            # player collects rollout k+1 once the update on rollout k is
            # published; queue_depth + 1 rollout buffers cycle round-robin, so
            # a buffer is refilled only after the learner consumed it
            bufs = [rollout_buffer(cfg, rollout_steps, rollout.num_envs, obs_keys, log_dir, f"rank_{rank}_overlap{i}",
                                   seed + 7 * i) for i in range(engine.queue_depth + 1)]
            player_stream = torch.cuda.Stream(pdev) if pdev.type == "cuda" else None
            n_played = [0]

            def play() -> Packet:
                buf = bufs[n_played[0] % len(bufs)]
                n_played[0] += 1
                with torch.cuda.stream(player_stream) if player_stream is not None else contextlib.nullcontext():
                    with telem.span("Time/env_interaction_time"):
                        local, next_value, ep_stats = rollout(buf)
                return Packet((local, next_value, ep_stats, gen_state(player_gen)), policy_steps_per_iter)

            engine.start(play)
            stopped = False
            update_iter = start_iter
            try:
                while update_iter <= num_updates:
                    telem.tick(policy_step)
                    if guard.stop_reached(policy_step, int(cfg.algo.total_steps), None, save=False):
                        stopped = True
                        break
                    pkts = engine.take(max_packets=1)
                    if dist.any(not pkts):  # N ranks: one rank's player ended, all stop here
                        break
                    local, next_value, ep_stats, player_gen_state = pkts[0].payload
                    policy_step += pkts[0].env_steps
                    record_ep_stats(ep_stats)
                    with telem.span("Time/train_time"):
                        update_from(local, next_value, update_iter)
                        engine.published()  # releases the strict player
                        run_info.mark_steady(policy_step, sync=steady_sync)  # on the learner thread
                    completed_update = update_iter
                    flush_logs()
                    maybe_checkpoint(update_iter)
                    update_iter += 1
            finally:
                # a queued rollout (for parameters that will never act again)
                # is dropped: PPO keeps no buffer across updates
                engine.shutdown()
            if stopped and not guard.preempted and cfg.checkpoint.save_last:
                ckpt.save(policy_step, _ckpt_state())
        else:
            # ---- serial loop (the reference's semantics) --------------------
            rb = rollout_buffer(cfg, rollout_steps, rollout.num_envs, obs_keys, log_dir, f"rank_{rank}", seed)
            for update_iter in range(start_iter, num_updates + 1):
                telem.tick(policy_step)
                with telem.span("Time/env_interaction_time"):
                    local, next_value, ep_stats = rollout(rb)
                player_gen_state = gen_state(player_gen)
                policy_step += policy_steps_per_iter
                record_ep_stats(ep_stats)
                with telem.span("Time/train_time"):
                    update_from(local, next_value, update_iter)
                    run_info.mark_steady(policy_step, sync=steady_sync)
                completed_update = update_iter
                flush_logs()
                maybe_checkpoint(update_iter)
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


@register_evaluation(["ppo", "ppo_decoupled"])
def evaluate_ppo(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode (``eval checkpoint_path=...``) through the serving
    stack's ``InferencePolicy`` (``serve/evaluate.py``), so evaluation and
    ``serve`` share one checkpoint→policy path."""
    from ...serve.evaluate import evaluate_with_policy

    evaluate_with_policy(cfg, state)


def evaluate_agent(cfg: Config, state: Dict[str, Any], builder: Callable, tester: Callable = test) -> None:
    """The ``eval`` entry of the on-policy family: the agent ``builder``
    makes, with the checkpoint's parameters, plays ``tester``'s greedy
    episode on the run's device."""
    device = get_device(cfg)
    disable_tf32()
    env = single_env(cfg, int(cfg.seed))
    torch.manual_seed(int(cfg.seed))
    agent = builder(cfg, env.observation_space, env.action_space, device)
    agent.load_state_dict(state["agent"])
    tester(agent, env, cfg, device)
