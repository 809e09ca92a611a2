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

PPO's actor fleet (``algo.fleet.workers > 0``) is not ported yet and raises.
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
from ...ops import gae
from ...optim import Clipped, clipped
from ...parallel.placement import make_param_mirror
from ...parallel.precision import disable_tf32
from ...resilience.guard import RunGuard
from ...telemetry.facade import Telemetry
from ...utils.checkpoint import CheckpointManager, gen_state, param_sums, set_gen_state
from ...utils.env import episode_stats, single_env, vectorize
from ...utils.logger import get_log_dir, get_logger
from ...utils.metric import MetricAggregator
from ...utils.registry import register_algorithm, register_evaluation
from ...utils.utils import get_device, linear_annealing, save_configs
from .agent import PPOAgent, actions_and_log_probs, build_agent
from .loss import entropy_loss, policy_loss, value_loss
from .utils import AGGREGATOR_KEYS, env_actions, prepare_obs, test

LOSS_KEYS = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")


def start_run(cfg: Config, algo: str):
    """The start every on-policy loop shares: refuse the fleet, pick the
    device (f32, TF32 off), make the run's log dir with its config and print
    ``[<algo>] log_dir=...``, load ``checkpoint.resume_from``, seed and build
    the vector env. Returns ``(device, seed, log_dir, state, envs)``."""
    if int(cfg.algo.select("fleet.workers", 0) or 0) > 0:
        raise NotImplementedError(f"algo.fleet.workers > 0: the actor fleet (sheeprl_tpu/fleet/) is not ported yet "
                                  f"for {algo}")
    device = get_device(cfg)
    disable_tf32()
    seed = int(cfg.seed)
    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    save_configs(cfg, log_dir)
    print(f"[{algo}] log_dir={log_dir}", flush=True)
    MetricAggregator.disabled = int(cfg.metric.select("log_level", 1) or 0) == 0
    state = None
    if cfg.checkpoint.resume_from:
        state = CheckpointManager.load(cfg.checkpoint.resume_from, map_location=device)
    torch.manual_seed(seed)
    envs = vectorize(cfg, seed, 0)
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


def make_update_fn(agent: PPOAgent, optimizer: Clipped, cfg: Config, num_minibatches: int, mb_size: int) -> Callable:
    """``update(data, coefs, perms) -> metrics``: ``data`` maps
    ``obs:<key>``, ``actions``, ``logprobs``, ``values``, ``returns`` and
    ``advantages`` to ``[batch, ...]`` tensors on the learner's device,
    ``perms`` is ``[update_epochs, batch]``. The agent and the optimizer are
    updated in place; the metrics are the mean losses over every minibatch,
    as tensors (no host sync)."""
    update_epochs = int(cfg.algo.update_epochs)
    clip_vloss = bool(cfg.algo.clip_vloss)
    normalize_advantages = bool(cfg.algo.normalize_advantages)
    reduction = str(cfg.algo.loss_reduction)

    def loss_fn(mb: Dict[str, torch.Tensor], coefs: Dict[str, Any]):
        obs = {k[4:]: v for k, v in mb.items() if k.startswith("obs:")}
        actor_out, new_values = agent(obs)
        _, new_logprobs, entropy = actions_and_log_probs(actor_out, agent.is_continuous, actions=mb["actions"])
        advantages = mb["advantages"]
        if normalize_advantages:
            advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
        pg = policy_loss(new_logprobs, mb["logprobs"], advantages, coefs["clip_coef"], reduction)
        vl = value_loss(new_values, mb["values"], mb["returns"], coefs["clip_coef"], clip_vloss, reduction)
        el = entropy_loss(entropy, reduction)
        return pg + coefs["vf_coef"] * vl + coefs["ent_coef"] * el, torch.stack([pg, vl, el]).detach()

    def update(data: Dict[str, torch.Tensor], coefs: Dict[str, Any], perms: torch.Tensor) -> Dict[str, torch.Tensor]:
        sums = None
        with scaled_lr(optimizer.optimizer, float(coefs["lr_frac"])):
            for e in range(update_epochs):
                idxs = perms[e][: num_minibatches * mb_size].reshape(num_minibatches, mb_size)
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
    greedy test episode at the end."""
    device, seed, log_dir, state, envs = start_run(cfg, "ppo")
    obs_space, action_space = envs.single_observation_space, envs.single_action_space
    num_envs = int(cfg.env.num_envs)
    cnn_keys, mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys

    agent = build_agent(cfg, obs_space, action_space, device)
    optimizer = clipped(instantiate(cfg.algo.optimizer, list(agent.parameters())), cfg.algo.select("max_grad_norm"))
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    if state:
        agent.load_state_dict(state["agent"])
        optimizer.optimizer.load_state_dict(state["opt_state"])
        set_gen_state(generator, state["generators"]["train"], "train", tag="ppo")

    rollout_steps = int(cfg.algo.rollout_steps)
    total_batch = rollout_steps * num_envs
    mb_size = int(cfg.algo.per_rank_batch_size)
    if total_batch % mb_size != 0:
        raise ValueError(f"rollout_steps*num_envs ({total_batch}) must be divisible by per_rank_batch_size ({mb_size})")
    num_minibatches = total_batch // mb_size
    update_epochs = int(cfg.algo.update_epochs)
    update = make_update_fn(agent, optimizer, cfg, num_minibatches, mb_size)
    # the player acts with its own copy of the agent and its own generator;
    # a blocking refresh after every update keeps PPO on-policy
    mirror, pdev, player_gen = make_param_mirror(cfg, device, {"agent": agent}, seed)
    if state:
        set_gen_state(player_gen, state["generators"]["player"], "player", tag="ppo")

    logger = get_logger(cfg, log_dir)
    telem = Telemetry.setup(cfg, log_dir, logger=logger, aggregator_keys=AGGREGATOR_KEYS, device=device)
    aggregator = telem.aggregator
    ckpt = CheckpointManager(log_dir, keep_last=cfg.checkpoint.keep_last)
    guard = RunGuard.setup(cfg, ckpt, log_dir, telem=telem)
    ckpt = guard.ckpt

    policy_steps_per_iter = num_envs * rollout_steps
    num_updates = int(cfg.algo.total_steps) // policy_steps_per_iter if not cfg.dry_run else 1
    start_iter, policy_step, last_log, last_checkpoint = resume_counters(cfg, state, agent, "ppo")
    grad_steps = (start_iter - 1) * num_minibatches * update_epochs

    rollout = Rollout(cfg, envs, mirror, pdev, player_gen, agent.is_continuous, make_act_fn(), make_value_fn())
    rollout.reset(seed)
    player_gen_state = gen_state(player_gen)  # after the last rollout the learner consumed
    completed_update = start_iter - 1
    update_s: List[float] = []  # wall seconds of each update since the last log
    t0 = time.perf_counter()

    def _ckpt_state() -> Dict[str, Any]:
        # `update` is the last update whose parameters the checkpoint holds
        # (the overlapped loop can break at the top of an iteration)
        return {
            "agent": agent.state_dict(),
            "opt_state": optimizer.optimizer.state_dict(),
            "update": completed_update,
            "policy_step": policy_step,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "generators": {"train": gen_state(generator), "player": player_gen_state},
        }

    def record_ep_stats(ep_stats) -> None:
        for ep_rew, ep_len in ep_stats:
            aggregator.update("Rewards/rew_avg", ep_rew)
            aggregator.update("Game/ep_len_avg", ep_len)

    def update_from(local, next_value, update_iter: int) -> None:
        """GAE and the update on one rollout, the mirror refreshed (learner)."""
        nonlocal grad_steps
        ts = time.perf_counter()
        data = rollout_batch(local, next_value, cfg, device)
        perms = draw_perms(generator, update_epochs, total_batch, device)
        metrics = update(data, make_coefs(cfg, update_iter, num_updates, device), perms)
        grad_steps += num_minibatches * update_epochs
        telem.record_grad_steps(num_minibatches * update_epochs)
        mirror.refresh({"agent": agent})  # blocking: the next rollout acts with these
        for k, v in metrics.items():
            aggregator.update(k, float(v))  # the host sync, once per update
        update_s.append(time.perf_counter() - ts)

    def flush_logs() -> None:
        nonlocal last_log
        if policy_step - last_log >= int(cfg.metric.log_every) or cfg.dry_run or completed_update == num_updates:
            telem.log(policy_step, fields={"updates": completed_update, "grad_steps": grad_steps,
                                           "elapsed_s": time.perf_counter() - t0,
                                           "update_ms": 1e3 * sum(update_s) / len(update_s) if update_s else None,
                                           "mirror": mirror.stats()})
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
    try:
        if engine.enabled:
            # ---- overlapped loop, strict on-policy (staleness_bound 0): the
            # player collects rollout k+1 once the update on rollout k is
            # published; queue_depth + 1 rollout buffers cycle round-robin, so
            # a buffer is refilled only after the learner consumed it
            bufs = [rollout_buffer(cfg, rollout_steps, num_envs, obs_keys, log_dir, f"rank_0_overlap{i}",
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
                    if not pkts:
                        break
                    local, next_value, ep_stats, player_gen_state = pkts[0].payload
                    policy_step += pkts[0].env_steps
                    record_ep_stats(ep_stats)
                    with telem.span("Time/train_time"):
                        update_from(local, next_value, update_iter)
                        engine.published()  # releases the strict player
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
            rb = rollout_buffer(cfg, rollout_steps, num_envs, obs_keys, log_dir, "rank_0", seed)
            for update_iter in range(start_iter, num_updates + 1):
                telem.tick(policy_step)
                with telem.span("Time/env_interaction_time"):
                    local, next_value, ep_stats = rollout(rb)
                player_gen_state = gen_state(player_gen)
                policy_step += policy_steps_per_iter
                record_ep_stats(ep_stats)
                with telem.span("Time/train_time"):
                    update_from(local, next_value, update_iter)
                completed_update = update_iter
                flush_logs()
                maybe_checkpoint(update_iter)
                if guard.stop_reached(policy_step, int(cfg.algo.total_steps), _ckpt_state):
                    break
    finally:
        guard.close(policy_step, _ckpt_state)
        envs.close()
        telem.close(policy_step)
    if cfg.algo.run_test:
        test(agent, single_env(cfg, seed), cfg, device, logger)
    if logger is not None:
        logger.close()


@register_evaluation("ppo")
def evaluate_ppo(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode with the checkpoint's agent on the run's device
    (``eval checkpoint_path=...``)."""
    evaluate_agent(cfg, state, build_agent)


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
