"""DreamerV2 training in PyTorch (counterpart of
``sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py``).

One gradient step (``make_train_fn``) is the JAX package's ``one_step``:
the hard target-critic copy, decided before the step on the optimizer step
counter (``step % target_freq == 0``); the world model (the dynamic scan
with ``is_first[0] = 1``, Normal(·, 1) decoders, KL balancing, the optional
continue head); the actor on the world model as updated this step, through
the imagination rollout (``objective_mix``: reinforce against dynamics
backpropagation; the world model's and the critics' parameters get no
gradient from it); the critic. A burst of G steps is a Python loop; the
modules are updated in place. Every draw takes pre-drawn noise
(``draw_train_noise``), so the tests can hand the port the JAX package's
own draws.

``main`` is the JAX package's serial loop (on the SAC family's
``OffPolicyLoop``): the player acts with a ``ParamMirror`` copy of the
world model and actor and the exploration schedule ``expl_amount_at``; the
replay buffer is ``sequential`` (fed by the device ring or the staged
prefetcher) or ``episode`` (the staged prefetcher); the RunGuard drains on
SIGTERM; checkpoints hold the buffer and the step counter;
``checkpoint.resume_from`` and the ``resume`` command continue a run.
``run_dreamer`` is that loop with the algorithm's pieces, which DreamerV1
shares. ``evaluate_dreamer_v2`` is the ``eval`` command's entry point.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ...config import Config
from ...data import EnvIndependentReplayBuffer, EpisodeBuffer, SequentialReplayBuffer
from ...data.device_ring import estimate_row_bytes, make_sequential_prefetcher
from ...distributions import Bernoulli, Independent, Normal, OneHotCategoricalStraightThrough, gumbel_noise
from ...envs import spaces
from ...ops.transforms import unrolled_cumprod
from ...parallel.placement import make_param_mirror
from ...utils.checkpoint import CheckpointManager
from ...utils.env import episode_stats, patch_restarted_envs, single_env, vectorize
from ...utils.logger import get_log_dir, get_logger
from ...utils.metric import MetricAggregator
from ...utils.registry import register_algorithm, register_evaluation
from ...utils.utils import get_device, save_configs
from ..dreamer_v3.dreamer_v3 import DV3Optimizers, LoopParts, _actions_dim, _apply_grads, build_optimizers
from ..dreamer_v3.utils import check_precision, make_precision_applies
from ..sac.sac import OffPolicyLoop
from .agent import (
    DV2Actor,
    DV2WorldModel,
    action_noise,
    apply_exploration,
    build_agent,
    dv2_actor_dists,
    dv2_sample_actions,
    exploration_noise_draws,
)
from .loss import reconstruction_loss
from .utils import AGGREGATOR_KEYS, compute_lambda_values, normalize_obs, prepare_obs, test

METRIC_KEYS = (
    "Loss/world_model_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
    "Loss/policy_loss",
    "Loss/value_loss",
)


def draw_rollout_noise(cfg: Config, TB: int, actor: DV2Actor, generator, device) -> Dict[str, Any]:
    """The draws of one imagination rollout from TB states: ``img_a`` per
    action head [horizon, TB, A_i] (``agent.action_noise``) and ``img_z``
    [horizon, TB, S, D]."""
    wm_cfg = cfg.algo.world_model
    S, D = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    horizon = int(cfg.algo.horizon)
    return {
        "img_a": action_noise(actor, (horizon, TB), generator, device),
        "img_z": gumbel_noise((horizon, TB, S, D), generator, device),
    }


def draw_train_noise(cfg: Config, T: int, B: int, actor: DV2Actor, generator, device) -> Dict[str, Any]:
    """Every random draw of one gradient step: ``post`` [T, B, S, D]
    (posterior gumbel), then one rollout's (``draw_rollout_noise``)."""
    wm_cfg = cfg.algo.world_model
    S, D = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    post = gumbel_noise((T, B, S, D), generator, device)
    return {"post": post, **draw_rollout_noise(cfg, T * B, actor, generator, device)}


def observation_dists(recon: Dict[str, torch.Tensor], cnn_keys: Sequence[str]) -> Dict[str, Independent]:
    """Normal(·, 1) over each decoded key (the image's three axes, a
    vector's one)."""
    return {k: Independent(Normal(v, 1.0), 3 if k in cnn_keys else 1) for k, v in recon.items()}


def make_world_model_step(wm: DV2WorldModel, optimizer, cfg: Config, apply, detach_heads: bool = False):
    """Returns ``world_model_step(batch, noise) -> (zs, hs, metrics)``: one
    world-model update on ``batch`` [T, B, ...] (the dynamic scan with
    ``is_first[0] = 1``); the posterior samples and recurrent states come
    back detached. ``detach_heads``: the reward and continue heads read
    detached latents (Plan2Explore's)."""
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    obs_keys = cnn_keys + tuple(cfg.algo.mlp_keys.encoder)
    wm_cfg = cfg.algo.world_model
    S, D = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    stoch = S * D
    R = int(wm_cfg.recurrent_model.recurrent_state_size)
    gamma = float(cfg.algo.gamma)
    use_continues = bool(wm_cfg.use_continues)
    rssm = wm.rssm

    def world_model_step(batch, noise):
        T, B = batch["rewards"].shape[:2]
        batch_obs = normalize_obs({k: batch[k] for k in obs_keys}, cnn_keys)
        is_first = batch["is_first"].clone()
        is_first[0] = 1.0
        with apply.params(wm):
            embedded = apply(wm.embed, batch_obs)  # [T, B, E]
            a_c, e_c, f_c = apply.cast_in((batch["actions"], embedded, is_first))
            h = a_c.new_zeros(B, R)
            z = a_c.new_zeros(B, stoch)
            hs_l, zs_l, post_l, prior_l = [], [], [], []
            for t in range(T):
                h, z, pol, prl = rssm.dynamic(z, h, a_c[t], e_c[t], f_c[t], noise=noise["post"][t])
                zs_l.append(z)  # the posterior sample, f32 (the sampler's dtype)
                z = apply.cast_in(z)
                hs_l.append(h)
                post_l.append(pol)
                prior_l.append(prl)
            hs, post_logits, prior_logits = apply.cast_out((torch.stack(hs_l), torch.stack(post_l),
                                                            torch.stack(prior_l)))
            zs = torch.stack(zs_l)
            latents = torch.cat([zs, hs], dim=-1)
            head_in = latents.detach() if detach_heads else latents
            po = observation_dists(apply(wm.decode, latents), cnn_keys)
            pr = Independent(Normal(apply(wm.reward, head_in), 1.0), 1)
            pc = Independent(Bernoulli(logits=apply(wm.cont, head_in)), 1) if use_continues else None
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
            po, batch_obs, pr, batch["rewards"],
            prior_logits.reshape(T, B, S, D), post_logits.reshape(T, B, S, D),
            float(wm_cfg.kl_balancing_alpha), float(wm_cfg.kl_free_nats), bool(wm_cfg.kl_free_avg),
            float(wm_cfg.kl_regularizer), pc, (1 - batch["terminated"]) * gamma if use_continues else None,
            float(wm_cfg.discount_scale_factor),
        )
        optimizer.zero_grad()
        rec_loss.backward()
        _apply_grads(optimizer)
        post_ent = Independent(OneHotCategoricalStraightThrough(logits=post_logits.reshape(T, B, S, D)), 1).entropy()
        prior_ent = Independent(OneHotCategoricalStraightThrough(logits=prior_logits.reshape(T, B, S, D)), 1).entropy()
        metrics = {
            "Loss/world_model_loss": rec_loss,
            "Loss/observation_loss": observation_loss,
            "Loss/reward_loss": reward_loss,
            "Loss/state_loss": state_loss,
            "Loss/continue_loss": continue_loss,
            "State/kl": kl.mean(),
            "State/post_entropy": post_ent.mean(),
            "State/prior_entropy": prior_ent.mean(),
        }
        return zs.detach(), hs.detach(), {k: v.detach() for k, v in metrics.items()}

    return world_model_step


def make_behaviour_step(wm: DV2WorldModel, cfg: Config, apply, actions_dim: Sequence[int]):
    """Returns ``behaviour_step(actor, critic, target_critic, actor_opt,
    critic_opt, terminated, zs, hs, noise, reward=None) -> (policy_loss,
    value_loss, aux)``: the actor on the world model as updated this step,
    through the imagination rollout (``objective_mix``: reinforce against
    dynamics backpropagation; the world model's and the critics' parameters
    get no gradient from it), then the critic. ``reward(trajectories,
    actions)`` gives the imagined rewards (default: the world model's reward
    head); ``aux`` holds the detached rewards, target values and
    λ-values."""
    wm_cfg = cfg.algo.world_model
    stoch = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    R = int(wm_cfg.recurrent_model.recurrent_state_size)
    horizon = int(cfg.algo.horizon)
    gamma = float(cfg.algo.gamma)
    lmbda = float(cfg.algo.lmbda)
    ent_coef = float(cfg.algo.actor.ent_coef)
    objective_mix = float(cfg.algo.actor.objective_mix)
    use_continues = bool(wm_cfg.use_continues)
    act_width = int(sum(actions_dim))
    rssm = wm.rssm

    def rollout(actor, z0, h0, noise):
        """Imagination from every posterior state, on the world model as
        updated this step: [H+1, TB, L] latents (the posterior first) and
        [H+1, TB, A] actions (zeros first)."""
        latent = torch.cat([z0, h0], dim=-1)
        z, h = z0, h0
        latents, actions = [latent], [latent.new_zeros(latent.shape[0], act_width)]
        for i in range(horizon):
            acts, _ = dv2_sample_actions(actor, apply(actor, latent.detach()), [n[i] for n in noise["img_a"]])
            a = torch.cat(acts, dim=-1)
            z, h = apply(rssm.imagination, z, h, a, noise=noise["img_z"][i])
            latent = torch.cat([z, h], dim=-1)
            latents.append(latent)
            actions.append(a)
        return torch.stack(latents), torch.stack(actions)

    def behaviour_step(actor, critic, target_critic, actor_opt, critic_opt, terminated, zs, hs, noise, reward=None):
        TB = terminated.numel()
        with apply.params(wm, actor, critic, target_critic):
            # with objective_mix == 1 the actor learns through the log-probs of
            # detached trajectories only, so the rollout needs no graph
            with torch.set_grad_enabled(objective_mix != 1.0):
                trajectories, imagined_actions = rollout(actor, zs.reshape(TB, stoch), hs.reshape(TB, R), noise)
                target_values = apply(target_critic, trajectories)
                rewards_img = (apply(wm.reward, trajectories) if reward is None
                               else reward(trajectories, imagined_actions))
                if use_continues:
                    continues = torch.sigmoid(apply(wm.cont, trajectories))
                    true_cont = (1 - terminated).reshape(1, TB, 1) * gamma
                    continues = torch.cat([true_cont, continues[1:]], dim=0)
                else:
                    continues = torch.ones_like(rewards_img) * gamma
                lv = compute_lambda_values(rewards_img[:-1], target_values[:-1], continues[:-1],
                                           bootstrap=target_values[-1], lmbda=lmbda)
            discount = unrolled_cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]], dim=0)).detach()
            dists = dv2_actor_dists(actor, apply(actor, trajectories[:-2].detach()))
            advantage = (lv[1:] - target_values[:-2]).detach()
            logprobs, start = [], 0
            for d, adim in zip(dists, actions_dim):
                act = imagined_actions[1:-1, ..., start : start + adim].detach()
                logprobs.append(d.log_prob(act)[..., None])
                start += adim
            objective = objective_mix * sum(logprobs) * advantage + (1 - objective_mix) * lv[1:]
            try:
                entropy = ent_coef * sum(d.entropy() for d in dists)[..., None]
            except NotImplementedError:  # tanh_normal: no closed form
                entropy = torch.zeros_like(objective)
            policy_loss = -torch.mean(discount[:-2] * (objective + entropy))
            # the optimizer holds the master parameters, not the cast copies;
            # autograd.grad leaves every other parameter's .grad alone
            grads = torch.autograd.grad(policy_loss, actor_opt.params, allow_unused=True)
            _apply_grads(actor_opt, grads)

            traj_sg, lv_sg = trajectories.detach(), lv.detach()
            qv = Independent(Normal(apply(critic, traj_sg[:-1]), 1.0), 1)
            value_loss = -torch.mean(discount[:-1, ..., 0] * qv.log_prob(lv_sg))
            critic_opt.zero_grad()
            value_loss.backward()
            _apply_grads(critic_opt)
        aux = {"rewards": rewards_img.detach(), "values": target_values.detach(), "lambda_values": lv_sg}
        return policy_loss.detach(), value_loss.detach(), aux

    return behaviour_step


def hard_copy_(target: torch.nn.Module, source: torch.nn.Module) -> None:
    with torch.no_grad():
        for t, s in zip(target.parameters(), source.parameters()):
            t.copy_(s)


def make_train_fn(wm: DV2WorldModel, actor: DV2Actor, critic: torch.nn.Module, target_critic: torch.nn.Module,
                  optimizers: DV3Optimizers, cfg: Config, is_continuous: bool, actions_dim: Sequence[int]):
    """Returns ``train(batches, noise=None, generator=None) -> metrics``: G
    gradient steps over ``batches`` [G, T, B, ...] (tensors on the modules'
    device); ``noise`` is a list of G ``draw_train_noise`` dicts, else the
    draws come from ``generator``. Metrics are [G] tensors, on the device.
    Under a bf16 ``fabric.precision`` the forwards cross the cast boundary
    (``PrecisionApplies``) as in DreamerV3's step."""
    apply = make_precision_applies(cfg)
    target_freq = int(cfg.algo.critic.per_rank_target_network_update_freq)
    world_model_step = make_world_model_step(wm, optimizers.wm, cfg, apply)
    behaviour_step = make_behaviour_step(wm, cfg, apply, actions_dim)

    def one_step(batch, noise):
        # the hard target copy, decided on the step counter before the step
        if optimizers.step % target_freq == 0:
            hard_copy_(target_critic, critic)
        zs, hs, metrics = world_model_step(batch, noise)
        metrics["Loss/policy_loss"], metrics["Loss/value_loss"], _ = behaviour_step(
            actor, critic, target_critic, optimizers.actor, optimizers.critic, batch["terminated"], zs, hs, noise)
        optimizers.step += 1
        return metrics

    def train(batches: Dict[str, torch.Tensor], noise=None, generator=None) -> Dict[str, torch.Tensor]:
        G, T, B = batches["rewards"].shape[:3]
        device = batches["rewards"].device
        steps = []
        for g in range(G):
            step_noise = noise[g] if noise is not None else draw_train_noise(cfg, T, B, actor, generator, device)
            steps.append(one_step({k: v[g] for k, v in batches.items()}, step_noise))
        return {k: torch.stack([m[k] for m in steps]) for k in METRIC_KEYS}

    return train


def make_player(wm: torch.nn.Module, actor: DV2Actor, cfg: Config, actions_dim, is_continuous: bool, num_envs: int,
                stoch_width: Optional[int] = None):
    """The recurrent player of DreamerV2 (and, with ``stoch_width``, of
    DreamerV1): state (h, z, a) of zeros, [N, ...] on the modules' device.
    ``step(obs, state, noise=None, generator=None, greedy=False,
    expl_amount=0.0, modules=None)`` takes host observations
    (``prepare_obs``) and returns (env_actions, actions, state); ``noise``
    is ``{"repr", "act", "expl"}`` (the representation draw, the action
    draws of ``agent.action_noise`` and ``agent.exploration_noise_draws``).
    Outside ``greedy``, exploration noise of ``expl_amount`` is added when
    the schedule has any (``algo.actor.expl_amount`` or ``expl_min`` > 0).
    ``modules`` ({"wm", "actor"}, e.g. ``mirror.current()``) replaces
    ``wm`` and ``actor`` for that call. Returns ``(init_state, step,
    expl_amount_at)``."""
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    wm_cfg = cfg.algo.world_model
    stoch = stoch_width if stoch_width is not None else int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    R = int(wm_cfg.recurrent_model.recurrent_state_size)
    act_width = int(sum(actions_dim))
    base_expl = float(cfg.algo.actor.select("expl_amount") or 0.0)
    expl_decay = float(cfg.algo.actor.select("expl_decay") or 0.0)
    expl_min = float(cfg.algo.actor.select("expl_min") or 0.0)
    use_expl = base_expl > 0.0 or expl_min > 0.0

    def expl_amount_at(step_count: int) -> float:
        """The half-life decay ``expl_amount · 0.5 ** (step / expl_decay)``,
        at least ``expl_min`` (the JAX package's schedule)."""
        amount = base_expl
        if expl_decay:
            amount *= 0.5 ** (float(step_count) / expl_decay)
        return max(amount, expl_min)

    def _device(modules) -> torch.device:
        return next((wm if modules is None else modules["wm"]).parameters()).device

    @torch.no_grad()
    def init_state(mask=None, state=None, modules=None):
        device = _device(modules)
        zeros = (torch.zeros(num_envs, R, device=device), torch.zeros(num_envs, stoch, device=device),
                 torch.zeros(num_envs, act_width, device=device))
        if state is None or mask is None:
            return zeros
        m = torch.as_tensor(np.asarray(mask), device=device)[:, None]
        return tuple(torch.where(m, z0, x) for z0, x in zip(zeros, state))

    @torch.no_grad()
    def step(obs: Dict[str, np.ndarray], state, noise=None, generator=None, greedy: bool = False,
             expl_amount: float = 0.0, modules=None):
        wm_, actor_ = (wm, actor) if modules is None else (modules["wm"], modules["actor"])
        device = _device(modules)
        h, z, a = state
        obs_t = normalize_obs({k: torch.as_tensor(v, device=device) for k, v in obs.items()}, cnn_keys)
        embedded = wm_.embed(obs_t)
        h = wm_.rssm.recurrent_model(torch.cat([z, a], dim=-1), h)
        z = wm_.rssm.representation_step(h, embedded, noise["repr"] if noise else None, generator)
        pre = actor_(torch.cat([z, h], dim=-1))
        acts, _ = dv2_sample_actions(actor_, pre, noise["act"] if noise else None, generator, greedy)
        if not greedy and use_expl:
            draws = noise["expl"] if noise else exploration_noise_draws(actor_, h.shape[0], generator, device)
            acts = apply_exploration(actor_, acts, expl_amount, draws)
        a = torch.cat(acts, dim=-1)
        env_actions = a if is_continuous else torch.stack([torch.argmax(x, dim=-1) for x in acts], dim=-1)
        return env_actions, a, (h, z, a)

    return init_state, step, expl_amount_at


def build_buffer(cfg: Config, num_envs: int, obs_keys, log_dir: str, seed: int, buffer_type: Optional[str] = None):
    """``buffer_type`` (default ``buffer.type``): ``sequential`` (per-env
    sequential buffers) or ``episode`` (``EpisodeBuffer``, episodes at least
    a sequence long)."""
    seq_len = int(cfg.algo.per_rank_sequence_length)
    buffer_size = int(cfg.buffer.size) if not cfg.dry_run else max(4 * seq_len, 64)
    buffer_type = str(buffer_type or cfg.buffer.select("type") or "sequential").lower()
    memmap = bool(cfg.buffer.memmap)
    memmap_dir = os.path.join(log_dir, "memmap_buffer", "rank_0") if memmap else None
    if buffer_type == "sequential":
        return EnvIndependentReplayBuffer(buffer_size, n_envs=num_envs, obs_keys=obs_keys, memmap=memmap,
                                          memmap_dir=memmap_dir, buffer_cls=SequentialReplayBuffer, seed=seed,
                                          memmap_fast_resume=bool(cfg.buffer.select("memmap_fast_resume")))
    if buffer_type == "episode":
        return EpisodeBuffer(buffer_size, minimum_episode_length=1 if cfg.dry_run else seq_len, n_envs=num_envs,
                             obs_keys=obs_keys, prioritize_ends=bool(cfg.buffer.select("prioritize_ends") or False),
                             memmap=memmap, memmap_dir=memmap_dir, seed=seed)
    raise ValueError(f"Unrecognized buffer type: must be one of `sequential` or `episode`, received: {buffer_type}")


def run_dreamer(cfg: Config, algo: str, build: Callable, train_fn: Callable, player_fn: Callable,
                aggregator_keys: Any, is_first: bool, buffer_fn: Callable = build_buffer,
                log_expl: bool = False) -> None:
    """The serial training loop of DreamerV1 and V2 (``run_serial``):
    ``build(cfg, obs_space, actions_dim, is_continuous, device)`` gives the
    modules (a target critic or None last), ``train_fn(*modules, optimizers,
    cfg, is_continuous, actions_dim)`` the burst, ``player_fn(wm, actor, cfg,
    actions_dim, is_continuous, num_envs)`` the player. ``log_expl`` logs
    the exploration amount (DreamerV1's ``Params/exploration_amount``)."""

    def setup(cfg, device, precision, obs_space, actions_dim, is_continuous, state) -> LoopParts:
        *modules, target_critic = build(cfg, obs_space, actions_dim, is_continuous, device)
        wm, actor, critic = modules
        named = {"wm": wm, "actor": actor, "critic": critic}
        if target_critic is not None:
            named["target_critic"] = target_critic
        for m in named.values():
            m.to(precision.param_dtype)  # bf16-true: the parameters themselves are bf16
        optimizers = build_optimizers(cfg, wm, actor, critic)
        if state:
            for name, m in named.items():
                m.load_state_dict(state[name])
            for name in ("wm", "actor", "critic"):
                getattr(optimizers, name).optimizer.load_state_dict(state["opt_states"][name])
            optimizers.step = int(state["opt_states"]["step"])
        train = train_fn(wm, actor, critic, *([target_critic] if target_critic is not None else []), optimizers, cfg,
                         is_continuous, actions_dim)

        def algo_state() -> Dict[str, Any]:
            s: Dict[str, Any] = {name: m.state_dict() for name, m in named.items()}
            s["opt_states"] = {name: getattr(optimizers, name).optimizer.state_dict()
                               for name in ("wm", "actor", "critic")}
            s["opt_states"]["step"] = optimizers.step
            return s

        return LoopParts(named, lambda batches, gen: train(batches, generator=gen), lambda task_phase: actor,
                         algo_state, actor, aggregator_keys)

    run_serial(cfg, algo, setup, player_fn, is_first, buffer_fn,
               expl_stat=(lambda task_phase: "Params/exploration_amount") if log_expl else None)


def run_serial(cfg: Config, algo: str, setup: Callable[..., LoopParts], player_fn: Callable, is_first: bool,
               buffer_fn: Callable = build_buffer, expl_stat: Optional[Callable[[bool], str]] = None) -> None:
    """The serial training loop of DreamerV1 and V2 and of their
    Plan2Explore phases, on the SAC family's ``OffPolicyLoop``: ``setup(cfg,
    device, precision, obs_space, actions_dim, is_continuous, state)`` builds
    the phase's ``LoopParts`` (``state``: the checkpoint of
    ``checkpoint.resume_from``, or None); ``player_fn(wm, actor, cfg,
    actions_dim, is_continuous, num_envs)`` makes the player, which acts on
    a ``ParamMirror`` of the world model and ``parts.player_actor`` with the
    exploration schedule ``expl_amount_at`` (``expl_stat(task_phase)``
    names the stat it is logged as, if any). Rows hold each observation
    after a step with its action, reward, ``terminated`` and ``truncated``,
    and (``is_first``) whether the previous row ended an episode; the first
    row is the reset observation with zeros. One greedy test episode with
    ``parts.task_actor`` at the end."""
    if int(cfg.algo.select("fleet.workers", 0) or 0) > 0:
        raise NotImplementedError(f"algo.fleet.workers > 0: the actor fleet is not ported yet for {algo}")
    precision = check_precision(cfg)
    device = get_device(cfg)
    seed = int(cfg.seed)
    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    save_configs(cfg, log_dir)
    print(f"[{algo}] log_dir={log_dir}", flush=True)
    MetricAggregator.disabled = int(cfg.metric.select("log_level", 1) or 0) == 0
    state = None
    if cfg.checkpoint.resume_from:
        state = CheckpointManager.load(cfg.checkpoint.resume_from, map_location=device)
    torch.manual_seed(seed)
    num_envs = int(cfg.env.num_envs)
    cnn_keys, mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    rb = buffer_fn(cfg, num_envs, obs_keys, log_dir, seed)
    episodic = isinstance(rb, EpisodeBuffer)
    # only the sequential buffer can mark an in-flight env restart; with the
    # episode buffer the env reports it as a truncation
    envs = vectorize(cfg, seed, 0, restart_handled_by_loop=not episodic)
    obs_space, action_space = envs.single_observation_space, envs.single_action_space
    is_continuous = isinstance(action_space, spaces.Box)
    is_multidiscrete = isinstance(action_space, spaces.MultiDiscrete)
    actions_dim = _actions_dim(action_space)
    act_total = int(sum(actions_dim))
    parts = setup(cfg, device, precision, obs_space, actions_dim, is_continuous, state)
    if state and cfg.buffer.checkpoint and "rb" in state:
        rb.load_state_dict(state["rb"])
    elif state is None and parts.rb_state is not None:
        rb.load_state_dict(parts.rb_state)

    learning_starts = int(cfg.algo.learning_starts) if not cfg.dry_run else 0
    wm = parts.named["wm"]
    acting = [parts.player_actor((int(state["policy_step"]) if state else 0) >= learning_starts)]
    train_gen = torch.Generator(device=device)
    train_gen.manual_seed(seed)
    mirror, _, player_gen = make_param_mirror(cfg, device, {"wm": wm, "actor": acting[0]}, seed)
    logger = get_logger(cfg, log_dir)
    loop = OffPolicyLoop(cfg, algo, device=device, log_dir=log_dir, state=state, envs=envs, mirror=mirror,
                         player_gen=player_gen, train_gen=train_gen, logger=logger, params=parts.named,
                         aggregator_keys=parts.aggregator_keys, dry_run_steps=4)
    prefetch = make_sequential_prefetcher(cfg, device, rb, int(cfg.algo.per_rank_batch_size),
                                          int(cfg.algo.per_rank_sequence_length), cnn_keys=cnn_keys,
                                          row_bytes_hint=estimate_row_bytes(obs_space, act_total))
    if parts.player_actor(False) is not parts.player_actor(True):  # a phase that switches actors
        kind = "task" if acting[0] is parts.task_actor else "exploration"
        print(f"[{algo}] the player acts with the {kind} actor from policy step {loop.p_step}", flush=True)
    mods0 = mirror.current()
    player_init, player_step, expl_amount_at = player_fn(mods0["wm"], mods0["actor"], cfg, actions_dim,
                                                         is_continuous, num_envs)
    clip_rewards_fn = (lambda r: np.tanh(r)) if cfg.env.clip_rewards else (lambda r: r)
    force_done = bool(cfg.dry_run) and episodic

    obs, _ = envs.reset(seed=seed)
    step_data: Dict[str, np.ndarray] = {k: np.asarray(obs[k])[np.newaxis] for k in obs_keys}
    step_data["actions"] = np.zeros((1, num_envs, act_total), np.float32)
    step_data["rewards"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["terminated"] = np.zeros((1, num_envs, 1), np.float32)
    step_data["truncated"] = np.zeros((1, num_envs, 1), np.float32)
    if is_first:
        step_data["is_first"] = np.ones((1, num_envs, 1), np.float32)
    rb.add(step_data, validate_args=cfg.buffer.validate_args)
    current: Dict[str, Any] = {"obs": obs, "state": None}

    def interact(sink) -> None:
        """ONE vector-env step: random actions up to ``learning_starts``
        (with ``parts.random_warmup``), then the mirror's player with
        exploration; the row into ``sink``."""
        task_phase = loop.p_step >= loop.learning_starts
        actor = parts.player_actor(task_phase)
        if actor is not acting[0]:  # the switch to the task actor, before the step that uses it
            acting[0] = actor
            mirror.refresh({"wm": wm, "actor": actor})
            print(f"[{algo}] the player acts with the task actor from policy step {loop.p_step}", flush=True)
        mods = mirror.current()
        if current["state"] is None:
            current["state"] = player_init(modules=mods)
        if parts.random_warmup and loop.random_phase():
            actions_env = np.stack([action_space.sample() for _ in range(num_envs)])
            if is_continuous:
                actions_np = actions_env.reshape(num_envs, -1).astype(np.float32)
            else:
                acts2d = actions_env.reshape(num_envs, -1)
                actions_np = np.concatenate(
                    [np.eye(adim, dtype=np.float32)[acts2d[:, j]] for j, adim in enumerate(actions_dim)], axis=-1)
        else:
            expl = expl_amount_at(loop.p_step)
            if expl_stat is not None:
                sink.stat(expl_stat(task_phase), expl)
            env_actions, actions_cat, current["state"] = player_step(
                prepare_obs(current["obs"], cnn_keys, mlp_keys, num_envs), current["state"], generator=player_gen,
                expl_amount=expl, modules=mods)
            actions_np = actions_cat.cpu().numpy()
            actions_env = env_actions.cpu().numpy()
            if is_continuous:
                actions_env = actions_env.reshape(num_envs, -1)
            elif not is_multidiscrete:
                actions_env = actions_env.reshape(num_envs)
        prev_done = np.logical_or(step_data["terminated"], step_data["truncated"]).astype(np.float32)
        next_obs, rewards, terminated, truncated, info = envs.step(actions_env)
        loop.p_step += num_envs
        dones = np.logical_or(terminated, truncated)
        if force_done:  # a dry run commits an episode every step
            terminated, truncated, dones = np.ones_like(terminated), np.ones_like(truncated), np.ones_like(dones)
        for ep_rew, ep_len in episode_stats(info):
            sink.stat("Rewards/rew_avg", ep_rew)
            sink.stat("Game/ep_len_avg", ep_len)
        real_next_obs = {k: np.asarray(next_obs[k]).copy() for k in obs_keys}
        if "final_obs" in info:
            for i, fo in enumerate(info["final_obs"]):
                if fo is not None:
                    for k in obs_keys:
                        real_next_obs[k][i] = np.asarray(fo[k])
        for k in obs_keys:
            step_data[k] = real_next_obs[k][np.newaxis]
        if is_first:
            step_data["is_first"] = prev_done
        step_data["terminated"] = np.asarray(terminated, np.float32).reshape(1, num_envs, 1)
        step_data["truncated"] = np.asarray(truncated, np.float32).reshape(1, num_envs, 1)
        step_data["actions"] = actions_np.reshape(1, num_envs, -1)
        step_data["rewards"] = clip_rewards_fn(np.asarray(rewards, np.float32).reshape(1, num_envs, 1))
        # an env restarted in flight: its last row becomes a truncation
        # boundary, and its recurrent state starts anew
        restarted = patch_restarted_envs(info, dones, sink, step_data)
        if restarted is not None:
            current["state"] = player_init(restarted, current["state"], modules=mods)
        sink.add(step_data, validate_args=cfg.buffer.validate_args)
        if dones.any():
            current["state"] = player_init(np.asarray(dones).reshape(-1).astype(bool), current["state"],
                                           modules=mods)
        current["obs"] = next_obs

    def burst(g: int) -> Dict[str, torch.Tensor]:
        return {k: v.mean() for k, v in parts.train(prefetch.take(g), train_gen).items()}

    def algo_state() -> Dict[str, Any]:
        s = parts.algo_state()
        if cfg.buffer.checkpoint:
            s["rb"] = rb.checkpoint_state_dict()
        return s

    loop.run(rb, interact, burst, lambda: mirror.refresh({"wm": wm, "actor": acting[0]}), prefetch.stage,
             algo_state, overlap=False)
    if cfg.algo.run_test:
        # the player acts in f32 (bf16-true keeps bf16 parameters)
        t_wm, t_actor = (wm, parts.task_actor) if precision.param_dtype == torch.float32 else (
            copy.deepcopy(wm).float(), copy.deepcopy(parts.task_actor).float())
        t_init, t_step, _ = player_fn(t_wm, t_actor, cfg, actions_dim, is_continuous, 1)
        test(t_init, t_step, single_env(cfg, seed), cfg, train_gen, logger=logger)
    if logger is not None:
        logger.close()


def evaluate_dreamer(cfg: Config, state: Dict[str, Any], build: Callable, player_fn: Callable) -> None:
    """One greedy episode with the checkpoint's world model and actor on the
    run's device."""
    check_precision(cfg)
    device = get_device(cfg)
    seed = int(cfg.seed)
    env = single_env(cfg, seed)
    action_space = env.action_space
    is_continuous = isinstance(action_space, spaces.Box)
    actions_dim = _actions_dim(action_space)
    torch.manual_seed(seed)
    wm, actor, *_ = build(cfg, env.observation_space, actions_dim, is_continuous, device)
    wm.load_state_dict(state["wm"])
    actor.load_state_dict(state["actor"])
    t_init, t_step, _ = player_fn(wm.float(), actor.float(), cfg, actions_dim, is_continuous, 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    test(t_init, t_step, env, cfg, gen)


@register_algorithm(name="dreamer_v2")
def main(cfg: Config) -> None:
    """DreamerV2's serial training loop (``run_dreamer``)."""
    run_dreamer(cfg, "dreamer_v2", build_agent, make_train_fn, make_player, AGGREGATOR_KEYS, is_first=True)


@register_evaluation("dreamer_v2")
def evaluate_dreamer_v2(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode (``eval checkpoint_path=...``)."""
    evaluate_dreamer(cfg, state, build_agent, make_player)
