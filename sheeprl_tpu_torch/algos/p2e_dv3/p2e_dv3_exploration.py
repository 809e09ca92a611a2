"""Plan2Explore-DV3, the exploration phase, in PyTorch (counterpart of
``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_exploration.py``).

One gradient step (``make_train_fn``) is the JAX package's ``one_step``, in
its order, each update with its own optimizer and gradient clip:

1. the world model, on the coupled scan (``RSSM.dynamic``) whatever
   ``decoupled_rssm`` and ``pallas_gru`` say: the JAX step reads neither, so
   this step launches no LN-GRU kernel; the reward and continue heads read
   detached latents;
2. the ensembles: each member's MSE against the next stochastic state;
3. the exploration actor, through imagination on the updated world model,
   against the dict of exploration critics: each critic has its own reward
   stream (the ensembles' variance × ``intrinsic_reward_multiplier`` on
   detached inputs, or the world model's reward head), λ-values and Moments,
   and the advantages are summed weighted by ``weight / Σ weights``;
4. each exploration critic;
5. the task actor and the task critic (DreamerV3's update);
6. on ``step % per_rank_target_network_update_freq == 0`` the EMA of the
   task target and of every exploration target.

Every draw takes pre-drawn noise (``draw_train_noise``), so the tests can
hand the port the JAX package's own draws.

``main`` is the JAX package's serial loop (P2E never runs on the overlap
engine, whatever ``algo.overlap.enabled`` says), here on the SAC family's
``OffPolicyLoop`` with DreamerV3's rows (``run_serial``, which the
finetuning phase shares): the player acts with ``actor_<algo.player.actor_type>``
(exploration by default); checkpoints hold every module, every optimizer
(one per exploration critic), the task and exploration Moments, the
counters and the buffer. The test episode at the end, and ``eval``
(``evaluate_p2e_dv3``, registered for both phases), use the task actor.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Callable, Dict, List, Sequence

import torch
from torch import nn

from ...config import Config, instantiate
from ...data import EnvIndependentReplayBuffer, SequentialReplayBuffer
from ...data.device_ring import estimate_row_bytes, make_sequential_prefetcher
from ...distributions import MSEDistribution
from ...envs import spaces
from ...fleet.engine import refuse_fleet
from ...models import apply_ensembles
from ...optim import Clipped, clipped
from ...data.buffers import env_block
from ...parallel.layout import ParamLayout
from ...parallel.mesh import collective, emit_sharding_reports, local_cfg, maybe_shard_opt_state
from ...parallel.mesh import current as current_distributed
from ...parallel.placement import make_param_mirror
from ...utils.env import single_env, vectorize
from ...utils.logger import get_logger
from ...utils.model_manager import register_model, registry_names
from ...utils.registry import register_algorithm, register_evaluation
from ...utils.utils import get_device
from ..dreamer_v3.agent import build_agent as dv3_build_agent
from ..dreamer_v3.dreamer_v3 import (
    CriticStream,
    DV3Stepper,
    LoopParts,
    _actions_dim,
    _apply_grads,
    draw_rollout_noise,
    draw_train_noise as dv3_draw_train_noise,
    ema_,
    make_behaviour_step,
    make_player,
    make_world_model_step,
)
from ..dreamer_v3.utils import MomentsState, check_precision, init_moments, make_precision_applies, test
from ..dreamer_v2.dreamer_v2 import buffer_state, start_ranks
from ..sac.sac import OffPolicyLoop
from .agent import build_agent

WM_KEYS = (
    "Loss/world_model_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
)
METRIC_KEYS = WM_KEYS + ("Loss/ensemble_loss", "Loss/policy_loss_exploration", "Loss/policy_loss_task",
                         "Loss/value_loss_task")


MODELS_TO_REGISTER = {"world_model", "ensembles", "actor_task", "critic_task", "target_critic_task",
                      "actor_exploration", "critics_exploration", "moments_task", "moments_exploration"}


def metric_keys(cfg: Config) -> tuple:
    """The step's metrics: ``METRIC_KEYS`` and one
    ``Loss/value_loss_exploration_<name>`` per exploration critic."""
    return METRIC_KEYS + tuple(f"Loss/value_loss_exploration_{k}" for k in cfg.algo.critics_exploration)


def aggregator_keys(cfg: Config) -> set:
    return {"Rewards/rew_avg", "Game/ep_len_avg", *metric_keys(cfg)}


def clipped_optimizer(section: Config, module: nn.Module, dist: Any = None) -> Clipped:
    """``section.optimizer`` over ``module``'s parameters, its gradients
    clipped to ``section.clip_gradients`` (with a ``Distributed``, after
    their mean over the ranks)."""
    return clipped(instantiate(section.optimizer, list(module.parameters())), section.clip_gradients, dist)


class P2EOptimizers:
    """Plan2Explore's optimizers by name (a value is a ``Clipped`` or a dict
    of them, as the exploration critics'), and the gradient-step counter
    that paces the target networks."""

    def __init__(self, **optimizers: Any):
        self.__dict__.update(optimizers)
        self.names = tuple(optimizers)
        self.step = 0

    layout: Any = None  # the mesh's ParamLayout, once the states are laid out

    def state_dict(self) -> Dict[str, Any]:
        """Every state whole (a collective under a sharded layout)."""
        def sd(o):
            if isinstance(o, dict):
                return {k: sd(v) for k, v in o.items()}
            return self.layout.full_opt_state(o) if self.layout is not None else o.optimizer.state_dict()

        return {**{k: sd(getattr(self, k)) for k in self.names}, "step": self.step}

    def by_module(self, mods: Dict[str, nn.Module]) -> Dict[str, Any]:
        """``{name: (optimizer, module)}``, named as the JAX package's
        optimizer-state tree (an exploration critic's ``critics_exploration/<k>``)."""
        out = {}
        for k in self.names:
            o = getattr(self, k)
            if isinstance(o, dict):
                out.update({f"{k}/{c}": (v, mods[k][c]["critic"]) for c, v in o.items()})
            else:
                out[k] = (o, mods[k])
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        def load(o, s):
            if isinstance(o, dict):
                for k, v in o.items():
                    load(v, s[k])
            else:
                o.optimizer.load_state_dict(s)

        for k in self.names:
            load(getattr(self, k), state[k])
        self.step = int(state["step"])


def build_optimizers(cfg: Config, mods: Dict[str, nn.Module], dist: Any = None) -> P2EOptimizers:
    """Every optimizer of the exploration step, one per exploration critic;
    with a ``Distributed`` each averages its gradients over the ranks."""
    a = cfg.algo
    return P2EOptimizers(
        wm=clipped_optimizer(a.world_model, mods["wm"], dist),
        ensembles=clipped_optimizer(a.ensembles, mods["ensembles"], dist),
        actor_task=clipped_optimizer(a.actor, mods["actor_task"], dist),
        critic_task=clipped_optimizer(a.critic, mods["critic_task"], dist),
        actor_exploration=clipped_optimizer(a.actor, mods["actor_exploration"], dist),
        critics_exploration={k: clipped_optimizer(a.critic, v["critic"], dist)
                             for k, v in mods["critics_exploration"].items()})


def init_p2e_moments(cfg: Config, device=None) -> Dict[str, Any]:
    return {"task": init_moments(device), "exploration": {k: init_moments(device) for k in cfg.algo.critics_exploration}}


def moments_state(moments: Dict[str, Any]) -> Dict[str, Any]:
    """The Moments as a checkpoint holds them."""
    pair = lambda m: {"low": m.low, "high": m.high}  # noqa: E731
    return {"task": pair(moments["task"]), "exploration": {k: pair(m) for k, m in moments["exploration"].items()}}


def load_moments(saved: Dict[str, Any]) -> Dict[str, Any]:
    pair = lambda m: MomentsState(m["low"], m["high"])  # noqa: E731
    return {"task": pair(saved["task"]), "exploration": {k: pair(m) for k, m in saved["exploration"].items()}}


def draw_train_noise(cfg: Config, T: int, B: int, actions_dim, is_continuous: bool, generator, device) -> Dict[str, Any]:
    """Every draw of one exploration step: ``post`` [T, B, S, D], then the
    exploration rollout's (``exploration``) and the task rollout's
    (``task``), each in ``draw_rollout_noise``'s layout."""
    first = dv3_draw_train_noise(cfg, T, B, actions_dim, is_continuous, generator, device)
    post = first.pop("post")
    task = draw_rollout_noise(cfg, T * B, actions_dim, is_continuous, generator, device)
    return {"post": post, "exploration": first, "task": task}


def make_train_fn(mods: Dict[str, nn.Module], optimizers: P2EOptimizers, cfg: Config, is_continuous: bool,
                  actions_dim: Sequence[int], dist: Any = None):
    """Returns ``train(moments, batches, noise=None, generator=None) ->
    (moments, metrics)``: G exploration steps over ``batches`` [G, T, B,
    ...]; ``moments`` is ``{"task": MomentsState, "exploration": {name:
    MomentsState}}``; ``noise`` a list of G ``draw_train_noise`` dicts, else
    the draws come from ``generator``. Metrics are [G] tensors (``metric_keys``).
    With a ``Distributed`` the batches are this rank's columns and every
    Moments takes its quantiles of the global λ-returns (the optimizers,
    built with the same ``dist``, average the gradients)."""
    apply = make_precision_applies(cfg)
    wm, ens = mods["wm"], mods["ensembles"]
    critics = mods["critics_exploration"]
    critics_cfg = {k: (float(v.weight), str(v.reward_type)) for k, v in cfg.algo.critics_exploration.items()}
    intrinsic_mult = float(cfg.algo.intrinsic_reward_multiplier)
    tau = float(cfg.algo.critic.tau)
    target_freq = int(cfg.algo.critic.per_rank_target_network_update_freq)
    keys = metric_keys(cfg)
    world_model_step = make_world_model_step(wm, optimizers.wm, cfg, apply, force_coupled=True, detach_heads=True)
    behaviour_step = make_behaviour_step(wm, cfg, apply, is_continuous, actions_dim, dist=dist)

    def members(x: torch.Tensor) -> torch.Tensor:
        return apply(lambda v: apply_ensembles(ens, v), x)

    @torch.no_grad()
    def intrinsic_reward(trajectories: torch.Tensor, imagined_actions: torch.Tensor) -> torch.Tensor:
        """The members' disagreement on the next state, on detached inputs."""
        with apply.params(ens):
            preds = members(torch.cat([trajectories, imagined_actions], dim=-1))  # [n, H+1, TB, Z]
        return preds.var(0, unbiased=False).mean(-1, keepdim=True) * intrinsic_mult

    def one_step(batch, moments, noise):
        zs, hs, metrics = world_model_step(batch, noise)

        with apply.params(ens):
            out = members(torch.cat([zs, hs, batch["actions"]], dim=-1))[:, :-1]  # [n, T-1, B, Z]
            ens_loss = -MSEDistribution(out, dims=1).log_prob(zs[None, 1:]).mean((1, 2)).sum()
        optimizers.ensembles.zero_grad()
        ens_loss.backward()
        _apply_grads(optimizers.ensembles)

        streams = [CriticStream(critics[k]["critic"], critics[k]["target"], optimizers.critics_exploration[k],
                                moments["exploration"][k], w, intrinsic_reward if kind == "intrinsic" else None)
                   for k, (w, kind) in critics_cfg.items()]
        policy_expl, value_expl, moments_expl = behaviour_step(
            mods["actor_exploration"], optimizers.actor_exploration, streams, batch["terminated"], zs, hs,
            noise["exploration"])
        task = CriticStream(mods["critic_task"], mods["target_critic_task"], optimizers.critic_task, moments["task"])
        policy_task, (value_task,), (moments_task,) = behaviour_step(
            mods["actor_task"], optimizers.actor_task, [task], batch["terminated"], zs, hs, noise["task"])

        optimizers.step += 1
        if optimizers.step % target_freq == 0:
            ema_(mods["target_critic_task"], mods["critic_task"], tau)
            for k in critics_cfg:
                ema_(critics[k]["target"], critics[k]["critic"], tau)
        metrics.update({"Loss/ensemble_loss": ens_loss.detach(), "Loss/policy_loss_exploration": policy_expl,
                        "Loss/policy_loss_task": policy_task, "Loss/value_loss_task": value_task})
        for k, v in zip(critics_cfg, value_expl):
            metrics[f"Loss/value_loss_exploration_{k}"] = v
        return {"task": moments_task, "exploration": dict(zip(critics_cfg, moments_expl))}, metrics

    def train(moments: Dict[str, Any], batches: Dict[str, torch.Tensor], noise=None, generator=None):
        G, T, B = batches["rewards"].shape[:3]
        device = batches["rewards"].device
        steps: List[Dict[str, torch.Tensor]] = []
        for g in range(G):
            step_noise = (noise[g] if noise is not None
                          else draw_train_noise(cfg, T, B, actions_dim, is_continuous, generator, device))
            moments, metrics = one_step({k: v[g] for k, v in batches.items()}, moments, step_noise)
            steps.append(metrics)
        return moments, {k: torch.stack([m[k] for m in steps]) for k in keys}

    return train


def run_serial(cfg: Config, algo: str, setup: Callable[..., LoopParts]) -> None:
    """The serial training loop of P2E-DV3's two phases: DreamerV3's rows
    (``DV3Stepper``) on ``OffPolicyLoop``, the sequential buffer on the
    replay feed (the device ring or the staged prefetcher), the player on
    a ``ParamMirror`` of the world model and ``parts.player_actor``;
    ``setup(cfg, device, precision, obs_space, actions_dim, is_continuous,
    state)`` builds the phase's ``LoopParts`` (``state``: the checkpoint of
    ``checkpoint.resume_from``, or None). One greedy test episode with the
    task actor at the end. On N ranks as ``dreamer_v2.run_serial``: rank
    ``d`` steps env block ``d`` into its own buffer; rank 0 logs,
    checkpoints (the buffer gathered by env block), tests and registers."""
    refuse_fleet(cfg, algo)
    precision = check_precision(cfg)
    dist, device, seed, log_dir, state = start_ranks(cfg, algo)
    rank = dist.rank
    drank = dist.data_rank  # a tp group's ranks share their data rank: its env block, seeds and batch
    lcfg = local_cfg(cfg, dist)  # this rank's env block
    envs = vectorize(lcfg, seed, drank, restart_handled_by_loop=True, run_name=log_dir)
    obs_space, action_space = envs.single_observation_space, envs.single_action_space
    is_continuous = isinstance(action_space, spaces.Box)
    actions_dim = _actions_dim(action_space)
    num_envs = int(lcfg.env.num_envs)
    parts = setup(cfg, device, precision, obs_space, actions_dim, is_continuous, state)

    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + tuple(cfg.algo.mlp_keys.encoder)
    seq_len = int(cfg.algo.per_rank_sequence_length)
    memmap = bool(cfg.buffer.memmap)
    rb = EnvIndependentReplayBuffer(
        int(cfg.buffer.size) if not cfg.dry_run else max(4 * seq_len, 64), n_envs=num_envs, obs_keys=obs_keys,
        buffer_cls=SequentialReplayBuffer, seed=seed + 1024 * drank, memmap=memmap,
        memmap_dir=os.path.join(log_dir, "memmap_buffer", f"rank_{rank}") if memmap else None,
        memmap_fast_resume=bool(cfg.buffer.memmap_fast_resume),
    )
    if state and cfg.buffer.checkpoint and "rb" in state:
        rb.load_state_dict(env_block(state["rb"], drank, dist.data_parallel_size))
    elif state is None and parts.rb_state is not None:
        rb.load_state_dict(env_block(parts.rb_state, drank, dist.data_parallel_size))
    prefetch = make_sequential_prefetcher(cfg, device, rb, int(cfg.algo.per_rank_batch_size), seq_len,
                                          cnn_keys=cnn_keys,
                                          row_bytes_hint=estimate_row_bytes(obs_space, int(sum(actions_dim))))
    learning_starts = int(cfg.algo.learning_starts) if not cfg.dry_run else 0
    p_step0 = int(state["policy_step"]) if state else 0
    wm = parts.named["wm"]
    acting = [parts.player_actor(p_step0 >= learning_starts)]
    train_gen = torch.Generator(device=device)
    train_gen.manual_seed(seed + drank)
    mirror, _, player_gen = make_param_mirror(cfg, device, {"wm": wm, "actor": acting[0]}, seed + drank)
    logger = get_logger(cfg, log_dir, rank)
    loop = OffPolicyLoop(cfg, algo, device=device, log_dir=log_dir, state=state, envs=envs, mirror=mirror,
                         player_gen=player_gen, train_gen=train_gen, logger=logger, params=parts.named,
                         aggregator_keys=parts.aggregator_keys, dry_run_steps=4)
    emit_sharding_reports(loop.telem, dist)
    if parts.player_actor(False) is not parts.player_actor(True) and rank == 0:  # a phase that switches actors
        kind = "task" if acting[0] is parts.task_actor else "exploration"
        print(f"[{algo}] the player acts with the {kind} actor from policy step {loop.p_step}", flush=True)
    mods0 = mirror.current()
    player_init, player_step = make_player(mods0["wm"], mods0["actor"], cfg, actions_dim, is_continuous, num_envs)
    stepper = DV3Stepper(lcfg, envs, actions_dim, is_continuous, player_init, player_step, player_gen, mirror,
                         loop.p_step, loop.learning_starts, random_warmup=parts.random_warmup,
                         env_steps=loop.env_steps, first_env=loop.first_env)

    def interact(sink) -> None:
        actor = parts.player_actor(loop.p_step >= loop.learning_starts)
        if actor is not acting[0]:  # the switch to the task actor, before the step that uses it
            acting[0] = actor
            mirror.refresh({"wm": wm, "actor": actor})
            if rank == 0:
                print(f"[{algo}] the player acts with the task actor from policy step {loop.p_step}", flush=True)
        stepper(sink)
        loop.p_step = stepper.p_step

    def burst(g: int) -> Dict[str, torch.Tensor]:
        return {k: v.mean() for k, v in parts.train(prefetch.take(g), train_gen).items()}

    loop.run(rb, interact, burst, lambda: mirror.refresh({"wm": wm, "actor": acting[0]}), prefetch.stage,
             buffer_state(cfg, dist, rb, parts.algo_state), overlap=False)
    if cfg.algo.run_test and rank == 0:
        # the player acts in f32 (bf16-true keeps bf16 parameters)
        t_wm, t_actor = (wm, parts.task_actor) if precision.param_dtype == torch.float32 else (
            copy.deepcopy(wm).float(), copy.deepcopy(parts.task_actor).float())
        t_init, t_step = make_player(t_wm, t_actor, cfg, actions_dim, is_continuous, 1)
        test(t_init, t_step, single_env(cfg, seed), cfg, train_gen, logger=logger)
    if rank == 0:
        register_model(cfg, parts.registered(), log_dir)
    if logger is not None:
        logger.close()


def _setup(cfg: Config, device, precision, obs_space, actions_dim, is_continuous: bool, state) -> LoopParts:
    mods = build_agent(cfg, obs_space, actions_dim, is_continuous, device)
    for m in mods.values():
        m.to(precision.param_dtype)  # bf16-true: the parameters themselves are bf16
    optimizers = build_optimizers(cfg, mods, collective(cfg))
    moments = {"now": init_p2e_moments(cfg, device)}
    if state:
        for k, m in mods.items():
            m.load_state_dict(state[k])
        optimizers.load_state_dict(state["opt_states"])
        moments["now"] = load_moments(state["moments"])
    # the optimizer states' layout on the mesh (the parameters stay whole on
    # every rank, as the JAX package leaves them), fresh or resumed alike
    layout = ParamLayout(current_distributed(cfg), mods)
    maybe_shard_opt_state(cfg, current_distributed(cfg), layout, optimizers.by_module(mods), counters=("step",))
    optimizers.layout = layout
    train_fn = make_train_fn(mods, optimizers, cfg, is_continuous, actions_dim, dist=collective(cfg))

    def train(batches, generator):
        moments["now"], metrics = train_fn(moments["now"], batches, generator=generator)
        return metrics

    def algo_state() -> Dict[str, Any]:
        return {**{k: m.state_dict() for k, m in mods.items()}, "opt_states": optimizers.state_dict(),
                "moments": moments_state(moments["now"])}

    actor_type = str(cfg.algo.player.actor_type)
    if actor_type not in ("exploration", "task"):
        raise ValueError(f"algo.player.actor_type must be exploration | task, got {actor_type!r}")
    return LoopParts(mods, train, lambda task_phase: mods[f"actor_{actor_type}"], algo_state, mods["actor_task"],
                     aggregator_keys(cfg), lambda: registry_names(mods))


@register_algorithm(name="p2e_dv3_exploration")
def main(cfg: Config) -> None:
    """P2E-DV3's exploration phase (``run_serial``)."""
    run_serial(cfg, "p2e_dv3_exploration", _setup)


@register_evaluation(["p2e_dv3_exploration", "p2e_dv3_finetuning"])
def evaluate_p2e_dv3(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode with the checkpoint's world model and task actor
    (an exploration checkpoint's ``actor_task``, a finetuning one's
    ``actor``) on the run's device."""
    check_precision(cfg)
    device = get_device(cfg)
    seed = int(cfg.seed)
    env = single_env(cfg, seed)
    action_space = env.action_space
    is_continuous = isinstance(action_space, spaces.Box)
    actions_dim = _actions_dim(action_space)
    torch.manual_seed(seed)
    wm, actor, _, _ = dv3_build_agent(cfg, env.observation_space, actions_dim, is_continuous, device)
    wm.load_state_dict(state["wm"])
    actor.load_state_dict(state["actor_task"] if "actor_task" in state else state["actor"])
    t_init, t_step = make_player(wm.float(), actor.float(), cfg, actions_dim, is_continuous, 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    test(t_init, t_step, env, cfg, gen)

