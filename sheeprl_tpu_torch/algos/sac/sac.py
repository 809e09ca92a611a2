"""SAC training in PyTorch (counterpart of ``sheeprl_tpu/algos/sac/sac.py``).

* ``make_train_fn``: a burst of G gradient steps, each a critic, an actor
  and an alpha update, then the target-critic EMA where ``step %
  algo.critic.target_network_frequency == 0``. The target bootstraps on
  ``terminated``, not on ``dones``. The G steps run as an eager loop over
  the leading axis of the ``[G, B, ...]`` batches; the modules and the
  optimizers are updated in place. Every draw of the step is pre-drawn
  noise (``draw_noise``: per step, the target action's and the actor's
  standard normals), so a test can hand in the JAX package's draws;
* ``OffPolicyLoop``: the training loop the SAC family shares (DroQ and
  SAC-AE run its serial loop): one vector-env step at a time from the
  player's ``ParamMirror`` copy and generator, the transitions into the
  replay buffer, the Ratio ledger's gradient steps per iteration, the
  replay feed staged one iteration ahead (``data/device_ring.py``:
  ``make_uniform_prefetcher``), checkpoints with the buffer, the RunGuard
  and the telemetry stream; overlapped on the player thread
  (``algo.overlap``, ``staleness_bound: 1``: SAC is off-policy) or serial;
* ``main`` (``exp=sac``) and ``evaluate_sac``, the ``eval`` entry of
  ``sac`` and ``sac_decoupled``: one greedy episode from a checkpoint. The
  JAX package routes its evaluation through its serving subsystem, which the
  port does not have yet.

* the actor fleet (``algo.fleet.workers > 0``, ``exp=sac`` alone, as in the
  JAX package): ``OffPolicyLoop.run``'s fleet branch applies each round of
  the workers' packets full width (``apply_concat``) and publishes the
  actor through a host ``ParamMirror`` after every burst.

The model manager is not ported yet.
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
from ...data.device_ring import estimate_row_bytes, make_uniform_prefetcher
from ...engine import BufferOpSink, OverlapEngine, Packet, RecordingSink
from ...envs import spaces
from ...fleet import FleetEngine
from ...fleet.engine import PROGRAMS
from ...data.buffers import env_block, gather_env_blocks
from ...parallel.mesh import collective_fields, rank_resume, ranks_state
from ...parallel.mesh import current as current_distributed
from ...parallel.placement import make_param_mirror
from ...parallel.precision import disable_tf32
from ...resilience.guard import RunGuard
from ...telemetry.facade import Telemetry
from ...telemetry.throughput import model_cost
from ...utils.checkpoint import CheckpointManager, gen_state, param_sums, set_gen_state
from ...utils.env import episode_stats, single_env
from ...utils.logger import get_logger
from ...utils.metric import MetricAggregator
from ...utils.model_manager import register_model
from ...utils import run_info
from ...utils.registry import register_algorithm, register_evaluation
from ...utils.utils import Ratio, get_device
from .agent import SACAgent, build_agent, sample_actions
from .loss import critic_loss, entropy_loss, policy_loss
from .utils import AGGREGATOR_KEYS, flatten_obs, test

LOSS_KEYS = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss")


class Optimizers:
    """The family's optimizers by name and the gradient-step counter the
    target EMA's frequency reads (the JAX package's ``opt_states``)."""

    def __init__(self, step: int = 0, **optimizers: torch.optim.Optimizer):
        self.by_name = optimizers
        self.step = int(step)

    def __getitem__(self, name: str) -> torch.optim.Optimizer:
        return self.by_name[name]

    def state_dict(self) -> Dict[str, Any]:
        return {**{k: o.state_dict() for k, o in self.by_name.items()}, "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for k, o in self.by_name.items():
            o.load_state_dict(state[k])
        self.step = int(state["step"])


def apply_grads(optimizer: torch.optim.Optimizer, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                apply: bool = True) -> None:
    """One optimizer step with ``grads``. With ``apply`` False the state
    advances on zero gradients (Adam's moments decay, its count goes up) and
    the parameters stay as they were, bitwise: the JAX package's masked
    update, which zeroes the gradients, runs optax and zeroes the update."""
    if apply:
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        return
    with torch.no_grad():
        before = [p.detach().clone() for p in params]
        for p in params:
            p.grad = torch.zeros_like(p)
        optimizer.step()
        torch._foreach_copy_(list(params), before)


def ema_(target: Sequence[torch.Tensor], source: Sequence[torch.Tensor], tau: float) -> None:
    """``t ← (1 - tau)·t + tau·s`` for every pair."""
    with torch.no_grad():
        torch._foreach_mul_(list(target), 1.0 - tau)
        torch._foreach_add_(list(target), list(source), alpha=tau)


def build_optimizers(cfg: Config, agent: SACAgent) -> Optimizers:
    return Optimizers(
        actor=instantiate(cfg.algo.actor.optimizer, list(agent.actor.parameters())),
        critic=instantiate(cfg.algo.critic.optimizer, list(agent.critic.parameters())),
        alpha=instantiate(cfg.algo.alpha.optimizer, [agent.log_alpha]),
    )


def rank_grads(loss: torch.Tensor, params: Sequence[torch.Tensor], dist: Any = None) -> Sequence[torch.Tensor]:
    """The gradients of ``loss`` over ``params``; with a ``Distributed``
    their mean over the ranks (one flattened all-reduce), as XLA averages a
    sharded batch's gradients in the JAX package's step."""
    grads = torch.autograd.grad(loss, params)
    if dist is not None:
        dist.all_reduce_mean(grads)
    return grads


def draw_noise(g: int, batch: int, act_dim: int, generator: Optional[torch.Generator], device: Any) -> torch.Tensor:
    """A burst's standard normals ``[G, 2, B, act_dim]``: per step the target
    action's and the actor's."""
    return torch.randn((g, 2, batch, act_dim), generator=generator, device=device)


def make_train_fn(agent: SACAgent, optimizers: Optimizers, cfg: Config, target_entropy: float,
                  dist: Any = None) -> Callable:
    """``train(batches, noise=None, generator=None) -> metrics``: ``batches``
    maps ``observations``, ``next_observations``, ``actions``, ``rewards``
    and ``terminated`` to ``[G, B, ...]`` tensors; ``noise`` is
    ``draw_noise``'s (drawn from ``generator`` when not given). The metrics
    are the losses' means over the G steps, as tensors (no host sync). With
    a ``Distributed`` (``parallel/mesh.py``) the batches are this rank's
    columns and each optimizer step takes the ranks' mean gradient (one
    flattened all-reduce per optimizer)."""

    def grads_of(loss: torch.Tensor, params: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        return rank_grads(loss, params, dist)

    gamma = float(cfg.algo.gamma)
    tau = float(cfg.algo.tau)
    tnf = int(cfg.algo.critic.target_network_frequency)
    actor, critic, target = agent.actor, agent.critic, agent.target_critic
    actor_params, critic_params = list(actor.parameters()), list(critic.parameters())
    target_params = list(target.parameters())

    def one_step(batch: Dict[str, torch.Tensor], noise: torch.Tensor) -> torch.Tensor:
        obs, next_obs = batch["observations"], batch["next_observations"]
        with torch.no_grad():
            mean, log_std = actor(next_obs)
            next_actions, next_logprobs = sample_actions(actor, mean, log_std, noise[0])
            target_q = target(next_obs, next_actions)  # [n, B, 1]
            min_target = target_q.amin(0) - torch.exp(agent.log_alpha) * next_logprobs
            y = batch["rewards"] + (1.0 - batch["terminated"]) * gamma * min_target
        qf_loss = critic_loss(critic(obs, batch["actions"]), y)
        apply_grads(optimizers["critic"], critic_params, grads_of(qf_loss, critic_params))

        mean, log_std = actor(obs)
        actions, logprobs = sample_actions(actor, mean, log_std, noise[1])
        min_q = critic(obs, actions).amin(0)
        a_loss = policy_loss(torch.exp(agent.log_alpha).detach(), logprobs, min_q)
        apply_grads(optimizers["actor"], actor_params, grads_of(a_loss, actor_params))

        al_loss = entropy_loss(agent.log_alpha, logprobs.detach(), target_entropy)
        apply_grads(optimizers["alpha"], [agent.log_alpha], grads_of(al_loss, [agent.log_alpha]))

        optimizers.step += 1
        if optimizers.step % tnf == 0:
            ema_(target_params, critic_params, tau)
        return torch.stack([qf_loss.detach(), a_loss.detach(), al_loss.detach()])

    def train(batches: Dict[str, torch.Tensor], noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        g, b = batches["actions"].shape[:2]
        if noise is None:
            noise = draw_noise(g, b, batches["actions"].shape[-1], generator, batches["actions"].device)
        sums = sum(one_step({k: v[i] for k, v in batches.items()}, noise[i]) for i in range(g))
        return dict(zip(LOSS_KEYS, sums / g))

    return train


def start_run(cfg: Config, algo: str):
    """The start the family shares: refuse the fleet where ``algo`` has no
    fleet program, pick the device (TF32 off), make the run's log dir with
    its config and print ``[<algo>] log_dir=...``, load
    ``checkpoint.resume_from``, seed and build the vector env (whose first
    env's action space, seeded by the env factory, gives the random warm-up
    actions; under the fleet only its spaces). Returns ``(device, seed,
    log_dir, state, envs)``."""
    from ..ppo.ppo import start_run as onpolicy_start

    device, seed, log_dir, state, envs = onpolicy_start(cfg, algo)
    if not isinstance(envs.single_action_space, spaces.Box):
        raise RuntimeError(f"{algo} requires a continuous (Box) action space, got {envs.single_action_space}")
    return device, seed, log_dir, state, envs


class OffPolicyLoop:
    """The SAC family's training loop around an algorithm's own pieces:

    * ``interact(sink)``: ONE vector-env step with the player (the mirror's
      copy, the player generator): the replay row and the finished episodes'
      stats go into ``sink`` (the buffer itself serially, a
      ``RecordingSink`` under the overlap engine);
    * ``burst(g) -> metrics``: ``g`` gradient steps on the learner, their
      mean losses as tensors;
    * ``refresh()``: the player's mirror refreshed from the learner;
    * ``stage(g)``: the next burst's batch started (the replay feed's);
    * ``state()``: the algorithm's part of a checkpoint (parameters,
      optimizers, the buffer); the loop adds its counters, the Ratio and
      the generators.

    ``run(rb, ...)`` drives them, filling the replay buffer ``rb``, serially,
    (``overlap`` and ``algo.overlap.enabled``) on the overlap engine's
    player thread, or (``fleet``, a program path, and ``algo.fleet.workers >
    0``) from the actor fleet's worker processes, one full-width round per
    iteration, after each burst publishing ``mirror.current()`` (a host
    mirror): the Ratio ledger is fed one call per ``num_envs`` env steps
    every way. Counters live on the loop (``policy_step``, ``grad_steps``,
    ``last_log``, ``last_checkpoint``). DreamerV1 and V2 run their serial
    loops on it too (``aggregator_keys``: the metrics the algorithm logs;
    ``dry_run_steps``: the vector-env steps of a dry run)."""

    def __init__(self, cfg: Config, algo: str, *, device: torch.device, log_dir: str, state: Optional[Dict[str, Any]],
                 envs: Any, mirror: Any, player_gen: torch.Generator, train_gen: torch.Generator, logger: Any,
                 params: Dict[str, torch.nn.Module], aggregator_keys: Any = None, dry_run_steps: int = 1):
        self.cfg, self.algo, self.device, self.envs = cfg, algo, device, envs
        self.mirror, self.player_gen, self.train_gen, self.params = mirror, player_gen, train_gen, params
        self.dist = current_distributed(cfg)
        self.rank, self.world = self.dist.rank, self.dist.world_size
        # the env steps of one call of the ledger (every rank's) and this rank's envs
        self.env_steps = int(cfg.env.num_envs)
        lo, hi = self.dist.local_envs(self.env_steps)
        self.num_envs, self.first_env = hi - lo, lo
        keys = AGGREGATOR_KEYS_ALL if aggregator_keys is None else aggregator_keys
        self.telem = Telemetry.setup(cfg, log_dir, self.rank, logger=logger, aggregator_keys=keys, device=device)
        self.aggregator = self.telem.aggregator
        ckpt = CheckpointManager(log_dir, keep_last=cfg.checkpoint.keep_last, enabled=self.rank == 0)
        self.guard = RunGuard.setup(cfg, ckpt, log_dir, telem=self.telem, dist=self.dist)
        self.ckpt = self.guard.ckpt
        self.ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
        self.total_steps = int(cfg.algo.total_steps) if not cfg.dry_run else dry_run_steps * self.env_steps
        self.learning_starts = int(cfg.algo.learning_starts) if not cfg.dry_run else 0
        self.policy_step = self.last_log = self.last_checkpoint = self.grad_steps = 0
        if state:
            saved_gens = rank_resume(state, self.dist)
            self.ratio.load_state_dict(state["ratio"])
            for k in ("policy_step", "last_log", "last_checkpoint", "grad_steps"):
                setattr(self, k, int(state[k]))
            set_gen_state(train_gen, saved_gens["train"], "train", tag=algo)
            set_gen_state(player_gen, saved_gens["player"], "player", tag=algo)
        if state and self.rank == 0:
            print(f"[{algo}] resumed " + json.dumps({
                "checkpoint": str(cfg.checkpoint.resume_from), "policy_step": self.policy_step,
                "grad_steps": self.grad_steps, "ratio": self.ratio.state_dict(), "last_log": self.last_log,
                "last_checkpoint": self.last_checkpoint, "param_sums": param_sums(params),
            }), flush=True)
        self.p_step = self.policy_step  # the player's env-step counter (== policy_step serially)
        # the player generator's state after the last transition in the buffer
        # (under overlap the player runs ahead; its state rides each packet)
        self.player_gen_state = gen_state(player_gen)
        self.log_on = not MetricAggregator.disabled
        self.pending: List[Dict[str, torch.Tensor]] = []
        self.burst_s: List[float] = []
        self.costed = False
        self.t0 = time.perf_counter()
        self.steady_sync = run_info.device_sync(device)  # the first burst's end, for run_info.mark_steady

    def random_phase(self) -> bool:
        """The player acts at random up to ``learning_starts`` (inclusive)."""
        return self.p_step <= self.learning_starts

    def ledger(self, step: int) -> float:
        """The Ratio ledger's step: per rank, as the JAX package's
        ``ratio(policy_step / world_size)``."""
        return step / self.world if self.world > 1 else step

    def checkpoint_state(self, algo_state: Dict[str, Any], overlapped: bool) -> Dict[str, Any]:
        gens = {"train": gen_state(self.train_gen),
                "player": self.player_gen_state if overlapped else gen_state(self.player_gen)}
        return {**algo_state, "ratio": self.ratio.state_dict(), "policy_step": self.policy_step,
                "last_log": self.last_log, "last_checkpoint": self.last_checkpoint, "grad_steps": self.grad_steps,
                "generators": gens, **ranks_state(self.dist, gens)}

    def run(self, rb: ReplayBuffer, interact: Callable[[Any], None],
            burst: Callable[[int], Dict[str, torch.Tensor]], refresh: Callable[[], None], stage: Callable[[int], None],
            state: Callable[[], Dict[str, Any]], overlap: bool = True, fleet: Optional[str] = None) -> None:
        cfg, telem, guard, ratio = self.cfg, self.telem, self.guard, self.ratio
        fleet_engine = FleetEngine.setup(cfg, telem, guard, total_steps=self.total_steps,
                                         initial_step=self.policy_step)
        fleet_engine.enabled = fleet_engine.enabled and fleet is not None
        engine = OverlapEngine.setup(cfg, telem, guard, total_steps=self.total_steps, initial_step=self.policy_step)
        engine.enabled = engine.enabled and overlap and not fleet_engine.enabled

        def ckpt_state() -> Dict[str, Any]:
            return self.checkpoint_state(state(), engine.enabled)

        def train(g: int) -> None:
            with telem.span("Time/train_time"):
                t = time.perf_counter()
                if self.costed or not telem.enabled:
                    metrics = burst(g)
                else:  # once: the step's operations and bytes, for MFU and the roofline record
                    metrics, cost = model_cost(lambda: burst(g))
                    self.costed = True
                    per_step = {k: v / g for k, v in cost.items()}
                    telem.set_model_flops(per_step["flops"], str(cfg.fabric.precision))
                    telem.register_roofline("train_step", per_step, track_grad_rate=True)
                values = torch.stack(list(metrics.values())).cpu()  # the burst's end, and its losses on the host
                self.burst_s.append(time.perf_counter() - t)
            self.grad_steps += g
            if self.log_on:
                self.pending.append(dict(zip(metrics, values.numpy())))

        def flush_logs() -> None:
            if not self.log_on or not (self.policy_step - self.last_log >= int(cfg.metric.log_every) or cfg.dry_run
                                       or self.policy_step >= self.total_steps):
                return
            for m in self.pending:
                for k, v in m.items():
                    self.aggregator.update(k, v)
            self.pending.clear()
            self.dist.reduce_metrics(self.aggregator)  # N ranks: rank 0 logs the global means
            extra = ({"Params/replay_ratio": self.grad_steps * self.world / self.policy_step}
                     if self.policy_step > 0 else None)
            telem.log(self.policy_step, extra_metrics=extra, fields={
                "grad_steps": self.grad_steps, "elapsed_s": time.perf_counter() - self.t0,
                "update_ms": 1e3 * sum(self.burst_s) / len(self.burst_s) if self.burst_s else None,
                "mirror": self.mirror.stats(), **collective_fields(self.dist)})
            self.burst_s.clear()
            self.last_log = self.policy_step

        def maybe_checkpoint() -> None:
            every = int(cfg.checkpoint.every)
            if (every > 0 and self.policy_step - self.last_checkpoint >= every) or cfg.dry_run \
                    or self.policy_step >= self.total_steps:
                self.last_checkpoint = self.policy_step
                self.ckpt.save(self.policy_step, ckpt_state())

        try:
            if fleet_engine.enabled:
                self.run_fleet(fleet_engine, fleet, rb, train, refresh, stage, flush_logs, maybe_checkpoint,
                               ckpt_state)
            elif engine.enabled:
                pdev = self.mirror.device
                player_stream = torch.cuda.Stream(pdev) if pdev.type == "cuda" else None

                def play() -> Packet:
                    rec = RecordingSink()
                    with torch.cuda.stream(player_stream) if player_stream is not None else contextlib.nullcontext():
                        with telem.span("Time/env_interaction_time"):
                            interact(rec)
                    return Packet((rec, gen_state(self.player_gen)), self.env_steps)

                def absorb(pkt: Packet) -> None:
                    rec, self.player_gen_state = pkt.payload
                    rec.apply(rb, self.aggregator)

                engine.start(play)
                stopped = False
                try:
                    while self.policy_step < self.total_steps:
                        telem.tick(self.policy_step)
                        if guard.stop_reached(self.policy_step, self.total_steps, None, save=False):
                            stopped = True
                            break
                        # one packet per iteration on N ranks: every rank runs the same bursts
                        packets = engine.take(max_packets=1 if self.world > 1 else 0)
                        if self.dist.any(not packets):  # N ranks: one rank's player ended, all stop here
                            break
                        # FIFO acks feed the Ratio ledger exactly as the serial loop would
                        gs = []
                        for pkt in packets:
                            absorb(pkt)
                            self.policy_step += pkt.env_steps
                            if self.policy_step >= self.learning_starts:
                                gs.append(ratio(self.ledger(self.policy_step)))
                                telem.record_grad_steps(gs[-1])
                        trained = False
                        for i, g in enumerate(gs):
                            if g > 0:
                                train(g)
                                trained = True
                                nxt = next((x for x in gs[i + 1:] if x > 0), 0)
                                if nxt > 0:
                                    stage(nxt)
                        if trained:
                            refresh()
                            run_info.mark_steady(self.policy_step, sync=self.steady_sync)  # on the learner thread
                        engine.published()  # release take()'s claim every iteration
                        if self.learning_starts <= self.policy_step < self.total_steps:
                            stage(ratio.peek(self.ledger(self.policy_step + self.env_steps)))
                        flush_logs()
                        maybe_checkpoint()
                finally:
                    # the player joins first; the queued transitions land in the
                    # buffer so the final checkpoint is consistent
                    self.policy_step += engine.shutdown(absorb)
                if stopped and not guard.preempted and cfg.checkpoint.save_last:
                    self.ckpt.save(self.policy_step, ckpt_state())
            else:
                sink = BufferOpSink(rb, self.aggregator)
                while self.policy_step < self.total_steps:
                    telem.tick(self.policy_step)
                    if guard.stop_reached(self.policy_step, self.total_steps, ckpt_state):
                        break
                    with telem.span("Time/env_interaction_time"):
                        interact(sink)
                    self.policy_step = self.p_step
                    if self.policy_step >= self.learning_starts:
                        g = ratio(self.ledger(self.policy_step))
                        telem.record_grad_steps(g)
                        if g > 0:
                            train(g)
                            refresh()
                            run_info.mark_steady(self.policy_step, sync=self.steady_sync)
                        if self.policy_step < self.total_steps:
                            stage(ratio.peek(self.ledger(self.policy_step + self.env_steps)))
                    flush_logs()
                    maybe_checkpoint()
        finally:
            guard.close(self.policy_step, ckpt_state)
            self.envs.close()
            telem.close(self.policy_step)


    def run_fleet(self, fleet: Any, program: str, rb: ReplayBuffer, train: Callable[[int], None],
                  refresh: Callable[[], None], stage: Callable[[int], None], flush_logs: Callable[[], None],
                  maybe_checkpoint: Callable[[], None], ckpt_state: Callable[[], Dict[str, Any]]) -> None:
        """The fleet branch of ``run``: N worker processes step the env slices
        and stream packets; one round (one packet per active worker, in
        worker order) is the serial loop's ``num_envs`` quantum, applied full
        width (``apply_concat``), so the Ratio ledger sees the serial call
        sequence. The drain lands every complete queued round in the buffer."""
        cfg, telem, guard, ratio = self.cfg, self.telem, self.guard, self.ratio
        validate = bool(cfg.buffer.validate_args)
        fleet.start(program, self.num_envs, cfg)
        fleet.publish(self.mirror.current())  # version 1: the workers act with these
        stopped = False
        try:
            while self.policy_step < self.total_steps:
                telem.tick(self.policy_step)
                if guard.stop_reached(self.policy_step, self.total_steps, None, save=False):
                    stopped = True
                    break
                with telem.span("Time/env_interaction_time"):
                    rnd = fleet.take_round(self.policy_step)
                if rnd is None:
                    break
                fleet.apply_concat(rnd, rb, self.aggregator, validate=validate)
                self.policy_step = self.p_step = self.policy_step + rnd.env_steps
                if self.policy_step >= self.learning_starts:
                    g = ratio(self.policy_step)
                    telem.record_grad_steps(g)
                    if g > 0:
                        train(g)
                        refresh()
                        fleet.publish(self.mirror.current())
                        run_info.mark_steady(self.policy_step, sync=self.steady_sync)
                    if self.policy_step < self.total_steps:
                        stage(ratio.peek(self.policy_step + self.num_envs))
                flush_logs()
                maybe_checkpoint()
        finally:
            self.policy_step += fleet.shutdown(lambda r: fleet.apply_concat(r, rb, self.aggregator, validate=validate))
        # an early exit (the wall cap, a fleet that is all quarantined) still
        # leaves a resumable checkpoint; preemption saves through the guard
        if (stopped or self.policy_step < self.total_steps) and not guard.preempted and cfg.checkpoint.save_last:
            self.ckpt.save(self.policy_step, ckpt_state())


# every loss key of the family (SAC-AE adds its reconstruction loss)
AGGREGATOR_KEYS_ALL = AGGREGATOR_KEYS | {"Loss/reconstruction_loss"}


def transition(obs_vec: np.ndarray, next_obs: Dict[str, np.ndarray], actions: np.ndarray, rewards: Any,
               terminated: Any, truncated: Any, info: Dict[str, Any], mlp_keys: Sequence[str], num_envs: int):
    """The replay row of one vector-env step for SAC and DroQ (the true next
    observation of an env that finished is its final one) and the next
    step's flattened observations."""
    real_next = flatten_obs(next_obs, mlp_keys, num_envs).copy()
    if "final_obs" in info:
        for i, fo in enumerate(info["final_obs"]):
            if fo is not None:
                real_next[i] = np.concatenate([np.asarray(fo[k], np.float32).reshape(-1) for k in mlp_keys])
    row = {
        "observations": obs_vec.reshape(1, num_envs, -1),
        "next_observations": real_next.reshape(1, num_envs, -1),
        "actions": actions.reshape(1, num_envs, -1).astype(np.float32),
        "rewards": np.asarray(rewards, np.float32).reshape(1, num_envs, 1),
        "terminated": np.asarray(terminated, np.float32).reshape(1, num_envs, 1),
        "dones": np.logical_or(terminated, truncated).astype(np.float32).reshape(1, num_envs, 1),
    }
    return row, flatten_obs(next_obs, mlp_keys, num_envs)


def make_vector_interact(loop: OffPolicyLoop, actor_of: Callable[[], Any], obs_keys: Sequence[str]):
    """``interact(sink)`` of SAC and DroQ: random actions up to
    ``learning_starts``, then the mirror's actor with the player generator."""
    cfg, envs, n = loop.cfg, loop.envs, loop.num_envs
    action_space = envs.single_action_space
    act_dim = int(np.prod(action_space.shape))
    obs, _ = envs.reset(seed=int(cfg.seed) + loop.first_env)  # N ranks: the block's envs, seeded as the run's
    current = {"obs": flatten_obs(obs, obs_keys, n)}

    def interact(sink) -> None:
        obs_vec = current["obs"]
        if loop.random_phase():
            actions = np.stack([action_space.sample() for _ in range(n)])
        else:
            actor = actor_of()
            with torch.no_grad():
                mean, log_std = actor(torch.from_numpy(obs_vec).to(loop.mirror.device))
                acts, _ = sample_actions(actor, mean, log_std, generator=loop.player_gen)
            actions = acts.cpu().numpy().reshape(n, act_dim)
        next_obs, rewards, terminated, truncated, info = envs.step(actions)
        loop.p_step += loop.env_steps
        row, current["obs"] = transition(obs_vec, next_obs, actions, rewards, terminated, truncated, info, obs_keys, n)
        sink.add(row, validate_args=cfg.buffer.validate_args)
        for ep_rew, ep_len in episode_stats(info):
            sink.stat("Rewards/rew_avg", ep_rew)
            sink.stat("Game/ep_len_avg", ep_len)

    return interact


def replay_buffer(cfg: Config, log_dir: str, seed: int, obs_keys: Sequence[str] = ("observations",),
                  dist: Any = None) -> ReplayBuffer:
    """The loop's uniform buffer; on N ranks (``dist``) rank ``d``'s holds its
    env block, seeded ``seed + 1024·d`` as the JAX package seeds a rank's."""
    num_envs = int(cfg.env.num_envs)
    size = int(cfg.buffer.size) if not cfg.dry_run else max(2 * num_envs, 8)
    memmap = bool(cfg.buffer.memmap)
    rank, n_envs = 0, num_envs
    if dist is not None:
        lo, hi = dist.local_envs(num_envs)
        rank, n_envs = dist.rank, hi - lo
    return ReplayBuffer(size, n_envs, obs_keys=obs_keys, memmap=memmap,
                        memmap_dir=os.path.join(log_dir, "memmap_buffer", f"rank_{rank}") if memmap else None,
                        seed=seed + 1024 * rank)


@register_algorithm(name="sac")
def main(cfg: Config) -> None:
    """SAC's training loop: overlapped (the default) or serial, with
    checkpoints, the RunGuard and resume; one greedy test episode at the end.
    On N ranks (``parallel/mesh.py``) rank ``d`` steps env block ``d`` into its
    own buffer and trains on its ``per_rank_batch_size`` columns with the
    ranks' mean gradients; rank 0 logs, checkpoints (the buffer gathered by
    env block), tests and registers."""
    device, seed, log_dir, state, envs = start_run(cfg, "sac")
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
    train_gen.manual_seed(seed + dist.rank)
    fleet = FleetEngine.configured(cfg)
    mirror, _, player_gen = make_param_mirror(cfg, device, {"actor": agent.actor}, seed + dist.rank, host=fleet)
    logger = get_logger(cfg, log_dir, dist.rank)
    loop = OffPolicyLoop(cfg, "sac", device=device, log_dir=log_dir, state=state, envs=envs, mirror=mirror,
                         player_gen=player_gen, train_gen=train_gen, logger=logger, params={"agent": agent})
    rb = replay_buffer(cfg, log_dir, seed, dist=dist)
    if state and cfg.buffer.checkpoint and "rb" in state:
        rb.load_state_dict(env_block(state["rb"], dist.rank, dist.world_size))
    batch_size = int(cfg.algo.per_rank_batch_size)
    prefetch = make_uniform_prefetcher(cfg, device, rb, batch_size,
                                       row_bytes_hint=estimate_row_bytes(obs_space, act_dim))
    train = make_train_fn(agent, optimizers, cfg, -act_dim, dist=dist if dist.collective else None)
    interact = None if fleet else make_vector_interact(loop, lambda: mirror.current()["actor"], mlp_keys)

    def algo_state() -> Dict[str, Any]:
        s = {"agent": agent.state_dict(), "opt_states": optimizers.state_dict()}
        if cfg.buffer.checkpoint:  # by env block, gathered to rank 0 on N ranks
            s["rb"] = gather_env_blocks(dist.gather_object(rb.checkpoint_state_dict()) or [{}])
        return s

    loop.run(rb, interact, lambda g: train(prefetch.take(g), generator=train_gen),
             lambda: mirror.refresh({"actor": agent.actor}), prefetch.stage, algo_state,
             fleet=PROGRAMS["sac"] if fleet else None)
    if cfg.algo.run_test and dist.is_global_zero:
        test(agent.actor, single_env(cfg, seed), cfg, device, logger)
    if dist.is_global_zero:
        register_model(cfg, {"actor": agent.actor, "critic": agent.critic}, log_dir)
    if logger is not None:
        logger.close()


def evaluate_agent(cfg: Config, state: Dict[str, Any], builder: Callable, tester: Callable) -> None:
    """The ``eval`` entry of the SAC family: the agent ``builder`` makes on
    the run's device, with the checkpoint's parameters, plays ``tester``'s
    greedy episode."""
    device = get_device(cfg)
    disable_tf32()
    env = single_env(cfg, int(cfg.seed))
    torch.manual_seed(int(cfg.seed))
    agent = builder(cfg, env.observation_space, env.action_space, device)
    agent.load_state_dict(state["agent"])
    tester(agent, env, cfg, device)


@register_evaluation("sac")
def evaluate_sac(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode (``eval checkpoint_path=...``) through the serving
    stack's ``InferencePolicy`` (``serve/evaluate.py``), so evaluation and
    ``serve`` share one checkpoint→policy path."""
    from ...serve.evaluate import evaluate_with_policy

    evaluate_with_policy(cfg, state)
