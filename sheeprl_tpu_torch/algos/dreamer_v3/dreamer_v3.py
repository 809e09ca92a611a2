"""DreamerV3 training in PyTorch (counterpart of
``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``).

One gradient step (``make_train_fn``) is the JAX package's ``one_step``:
world model (coupled scan, decoupled scan, or decoupled with the LN-GRU
sequence kernels), the actor through the imagination rollout, the critic,
Moments and the target-critic EMA. A burst of G steps is a Python loop over
the leading axis of the sampled batches. The modules are updated in place.

Every draw of the step takes pre-drawn noise (``draw_train_noise``), so the
tests can hand the port the JAX package's exact gumbel draws.

``main`` is the JAX package's training loop: ``interact(sink)`` steps the
envs once with the player, either on the overlap engine's player thread
(``algo.overlap.enabled``, the default) or serially through a
``BufferOpSink``; the player acts in f32 with a ``ParamMirror`` copy of the
world model and actor. Bursts take their batches from the replay feed
(``data/device_ring.py``: the device ring or the staged prefetcher), staged
one iteration ahead on the learner thread. The RunGuard drains on SIGTERM,
checkpoints land under the run's log dir and ``checkpoint.resume_from``
continues from one;
``evaluate_dreamer_v3`` is the ``eval`` command's entry point. The loop
logs through the ``Telemetry`` facade (``telemetry/``) at the places the
JAX package's does: ``<log_dir>/telemetry.jsonl`` gets the startup, log,
overlap, ckpt_async, preempt, resume, mem, roofline and shutdown events, and
the logger (TensorBoard, or its JSONL fallback) the scalars. The actor
fleet and the model manager are not ported yet.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ...config import Config, instantiate
from ...data import EnvIndependentReplayBuffer, SequentialReplayBuffer
from ...data.device_ring import estimate_row_bytes, make_sequential_prefetcher
from ...engine import BufferOpSink, OverlapEngine, Packet, RecordingSink
from ...envs import spaces
from ...distributions import (
    BernoulliSafeMode,
    Independent,
    OneHotCategoricalStraightThrough,
    TwoHotEncodingDistribution,
    gumbel_noise,
)
from ...ops import lambda_values as lambda_values_op
from ...ops import ln_gru
from ...ops.transforms import unrolled_cumprod
from ...optim import Clipped, clipped
from ...parallel.placement import make_param_mirror
from ...resilience.guard import RunGuard
from ...telemetry.facade import Telemetry
from ...telemetry.throughput import model_cost
from ...utils.checkpoint import CheckpointManager, param_sums, set_gen_state
from ...utils.checkpoint import gen_state as _gen_state
from ...utils.env import episode_stats, patch_restarted_envs, single_env, vectorize
from ...utils.logger import get_log_dir, get_logger
from ...utils.metric import MetricAggregator
from ...utils.registry import register_algorithm, register_evaluation
from ...utils.utils import Ratio, get_device, save_configs
from .agent import Actor, WorldModel, actor_dists, build_agent, compute_stochastic_state, sample_actor_actions
from .loss import reconstruction_loss
from .utils import (
    AGGREGATOR_KEYS,
    MomentsState,
    check_precision,
    decode_obs_dists,
    init_moments,
    make_precision_applies,
    normalize_obs,
    prepare_obs,
    test,
    update_moments,
)

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


class DV3Optimizers:
    """The clipped world-model / actor / critic optimizers and the gradient
    step counter that paces the target-critic EMA."""

    def __init__(self, wm: Clipped, actor: Clipped, critic: Clipped):
        self.wm, self.actor, self.critic = wm, actor, critic
        self.step = 0


def build_optimizers(cfg: Config, wm: torch.nn.Module, actor: torch.nn.Module, critic: torch.nn.Module) -> DV3Optimizers:
    return DV3Optimizers(
        clipped(instantiate(cfg.algo.world_model.optimizer, list(wm.parameters())), cfg.algo.world_model.clip_gradients),
        clipped(instantiate(cfg.algo.actor.optimizer, list(actor.parameters())), cfg.algo.actor.clip_gradients),
        clipped(instantiate(cfg.algo.critic.optimizer, list(critic.parameters())), cfg.algo.critic.clip_gradients),
    )


def _action_noise_shapes(lead, actions_dim, is_continuous):
    if is_continuous:
        return [(*lead, int(sum(actions_dim)))]
    return [(*lead, int(a)) for a in actions_dim]


def draw_rollout_noise(cfg: Config, TB: int, actions_dim, is_continuous: bool, generator, device) -> Dict[str, Any]:
    """The draws of one imagination rollout from TB states: ``act0`` and
    ``img_a`` per action head ([TB, A_i] and [horizon, TB, A_i]), ``img_z``
    [horizon, TB, S, D]. Gumbel for categorical heads, standard normal for a
    continuous one."""
    wm_cfg = cfg.algo.world_model
    S, D = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    horizon = int(cfg.algo.horizon)

    def act(lead):
        draw = (lambda s: torch.randn(s, generator=generator, device=device)) if is_continuous else (
            lambda s: gumbel_noise(s, generator, device)
        )
        return [draw(s) for s in _action_noise_shapes(lead, actions_dim, is_continuous)]

    return {"act0": act((TB,)), "img_z": gumbel_noise((horizon, TB, S, D), generator, device),
            "img_a": act((horizon, TB))}


def draw_train_noise(cfg: Config, T: int, B: int, actions_dim, is_continuous: bool, generator, device) -> Dict[str, Any]:
    """Every random draw of one gradient step, in the shapes the step takes:
    ``post`` [T,B,S,D] (posterior samples), then one rollout's
    (``draw_rollout_noise``)."""
    wm_cfg = cfg.algo.world_model
    S, D = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    post = gumbel_noise((T, B, S, D), generator, device)
    return {"post": post, **draw_rollout_noise(cfg, T * B, actions_dim, is_continuous, generator, device)}


def _apply_grads(opt: Clipped, grads: Optional[Sequence[Optional[torch.Tensor]]] = None) -> None:
    """Step ``opt``; a parameter without a gradient gets zeros, so Adam's
    moments decay for it exactly as optax updates every leaf."""
    params = opt.params
    if grads is not None:
        for p, g in zip(params, grads):
            p.grad = g
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()


def make_world_model_step(wm: WorldModel, optimizer: Clipped, cfg: Config, apply, force_coupled: bool = False,
                          detach_heads: bool = False):
    """Returns ``world_model_step(batch, noise) -> (zs, hs, metrics)``: one
    world-model update on ``batch`` [T, B, ...] (the posterior samples and
    recurrent states come back detached, the metrics as detached scalars).
    The RSSM runs the coupled scan, the decoupled scan, or the decoupled
    path on the LN-GRU sequence kernels, as ``decoupled_rssm`` and
    ``pallas_gru`` say; ``force_coupled`` runs the coupled scan whatever
    they say and reads neither (Plan2Explore's exploration step).
    ``detach_heads``: the reward and continue heads read detached latents."""
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    wm_cfg = cfg.algo.world_model
    S, D = int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size)
    stoch_flat = S * D
    decoupled = bool(wm_cfg.select("decoupled_rssm") or False) and not force_coupled
    R = int(wm_cfg.recurrent_model.recurrent_state_size)
    # LN-GRU sequence kernels (ops/ln_gru.py): only the decoupled path
    # qualifies (its GRU inputs are time-parallel); `interpret` runs their
    # plain versions, which take any shape. Under mixed precision they are
    # not selected (they compute in f32), as in the JAX package
    gru_mode = False if force_coupled else (wm_cfg.select("pallas_gru") or False)
    gru_plain = gru_mode == "interpret"
    use_kernel = decoupled and bool(gru_mode) and not apply.mixed
    if gru_mode and not use_kernel:
        reason = "decoupled_rssm=False" if not decoupled else "mixed precision (the kernel computes in f32)"
        print(
            f"[dreamer_v3] algo.world_model.pallas_gru is set but UNUSED: {reason} — the "
            "step-by-step GRU runs instead",
            file=sys.stderr,
        )
    F_gru = int(wm_cfg.recurrent_model.dense_units)
    if use_kernel and not gru_plain and not ln_gru.fits_smem(F_gru, R):
        raise ValueError(
            f"algo.world_model.pallas_gru=True: the LN-GRU kernels do not take F={F_gru}, H={R} "
            f"({ln_gru.FIT_RULE}; F must be a multiple of 4); set pallas_gru=interpret or False"
        )
    rssm = wm.rssm

    def world_model_step(batch, noise):
        T, B = batch["rewards"].shape[:2]
        batch_obs = normalize_obs({k: batch[k] for k in cnn_keys + mlp_keys}, cnn_keys)
        is_first = batch["is_first"].clone()
        is_first[0] = 1.0
        batch_actions = torch.cat([torch.zeros_like(batch["actions"][:1]), batch["actions"][:-1]], dim=0)

        with apply.params(wm):
            embedded = apply(wm.embed, batch_obs)  # [T, B, E]
            initial = apply(rssm.initial_states, (B,))
            if decoupled:
                # posterior of the whole sequence in one time-parallel MLP; the
                # posterior driving step i is the step i-1 sample (zeros at i=0)
                post_logits = apply(rssm.representation_logits, embedded)
                zs = compute_stochastic_state(post_logits, D, noise["post"]).reshape(T, B, stoch_flat)
                z_prev = torch.cat([torch.zeros_like(zs[:1]), zs[:-1]], dim=0)
                if use_kernel:
                    h0_row, z0_row = initial
                    z_in = (1 - is_first) * z_prev + is_first * z0_row[None]
                    a_in = (1 - is_first) * batch_actions
                    feats = rssm.recurrent_features(torch.cat([z_in, a_in], dim=-1))
                    gru = rssm.recurrent_model.gru
                    hs = ln_gru.gru_sequence(
                        feats, is_first, h0_row, gru.fused.weight.t(), gru.LayerNorm_0.weight,
                        gru.LayerNorm_0.bias, plain=gru_plain,
                    )
                    prior_logits = rssm._transition(hs)
                else:
                    # the scans run inside the cast boundary: their inputs
                    # cross once, before the loop, the carries stay in the
                    # compute dtype, and the outputs cross back once (the
                    # same values as a crossing per step)
                    z_c, a_c, f_c, init_c = apply.cast_in((z_prev, batch_actions, is_first, initial))
                    h = a_c.new_zeros(B, R)
                    hs_l, prior_l = [], []
                    for t in range(T):
                        h, pl = rssm.dynamic_decoupled(z_c[t], h, a_c[t], f_c[t], initial=init_c)
                        hs_l.append(h)
                        prior_l.append(pl)
                    hs, prior_logits = apply.cast_out((torch.stack(hs_l), torch.stack(prior_l)))
            else:
                a_c, e_c, f_c, init_c = apply.cast_in((batch_actions, embedded, is_first, initial))
                h = a_c.new_zeros(B, R)
                z = a_c.new_zeros(B, stoch_flat)
                hs_l, zs_l, post_l, prior_l = [], [], [], []
                for t in range(T):
                    h, z, pol, prl = rssm.dynamic(z, h, a_c[t], e_c[t], f_c[t], noise=noise["post"][t], initial=init_c)
                    zs_l.append(z)  # the posterior sample, f32 (the sampler's dtype)
                    z = apply.cast_in(z)
                    hs_l.append(h)
                    post_l.append(pol)
                    prior_l.append(prl)
                hs, post_logits, prior_logits = apply.cast_out(
                    (torch.stack(hs_l), torch.stack(post_l), torch.stack(prior_l)))
                zs = torch.stack(zs_l)
            latents = torch.cat([zs, hs], dim=-1)
            po, obs_targets = decode_obs_dists(wm, latents, batch_obs, cnn_keys, mlp_keys, apply)
            head_in = latents.detach() if detach_heads else latents
            pr = TwoHotEncodingDistribution(apply(wm.reward, head_in), dims=1)
            pc = Independent(BernoulliSafeMode(logits=apply(wm.cont, head_in)), 1)
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = reconstruction_loss(
            po,
            obs_targets,
            pr,
            batch["rewards"],
            prior_logits.reshape(T, B, S, D),
            post_logits.reshape(T, B, S, D),
            float(wm_cfg.kl_dynamic),
            float(wm_cfg.kl_representation),
            float(wm_cfg.kl_free_nats),
            float(wm_cfg.kl_regularizer),
            pc,
            1 - batch["terminated"],
            float(wm_cfg.continue_scale_factor),
        )
        optimizer.zero_grad()
        rec_loss.backward()
        _apply_grads(optimizer)
        metrics = {
            "Loss/world_model_loss": rec_loss,
            "Loss/observation_loss": observation_loss,
            "Loss/reward_loss": reward_loss,
            "Loss/state_loss": state_loss,
            "Loss/continue_loss": continue_loss,
            "State/kl": kl,
        }
        post_ent = Independent(OneHotCategoricalStraightThrough(logits=post_logits.reshape(T, B, S, D)), 1).entropy()
        prior_ent = Independent(OneHotCategoricalStraightThrough(logits=prior_logits.reshape(T, B, S, D)), 1).entropy()
        metrics["State/post_entropy"] = post_ent.mean()
        metrics["State/prior_entropy"] = prior_ent.mean()
        return zs.detach(), hs.detach(), {k: v.detach() for k, v in metrics.items()}

    return world_model_step


def imagine(apply, rssm, actor: Actor, z0: torch.Tensor, h0: torch.Tensor, noise: Dict[str, Any], horizon: int):
    """Imagination from every posterior state: [H+1, TB, L] states and
    actions (``noise``: ``act0``, ``img_z``, ``img_a`` of
    ``draw_train_noise``). Runs with the world model as it stands."""
    state0 = torch.cat([z0, h0], dim=-1)
    acts0, _ = sample_actor_actions(actor, apply(actor, state0), noise["act0"])
    a0 = torch.cat(acts0, dim=-1)
    z, h, a = z0, h0, a0
    states, actions = [state0], [a0]
    for i in range(horizon):
        z, h = apply(rssm.imagination, z, h, a, noise=noise["img_z"][i])
        state = torch.cat([z, h], dim=-1)
        acts, _ = sample_actor_actions(actor, apply(actor, state.detach()), [n[i] for n in noise["img_a"]])
        a = torch.cat(acts, dim=-1)
        states.append(state)
        actions.append(a)
    return torch.stack(states), torch.stack(actions)


class CriticStream(NamedTuple):
    """One value stream of ``behaviour_step``: a critic with its target and
    optimizer, its Moments, its weight in the actor's advantage and its
    reward (``reward(trajectories, actions) -> [H+1, TB, 1]``; None: the
    world model's reward head)."""

    critic: torch.nn.Module
    target: torch.nn.Module
    optimizer: Clipped
    moments: MomentsState
    weight: float = 1.0
    reward: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None


def make_behaviour_step(wm: WorldModel, cfg: Config, apply, is_continuous: bool, actions_dim: Sequence[int]):
    """Returns ``behaviour_step(actor, actor_opt, streams, terminated, zs, hs,
    noise) -> (policy_loss, value_losses, moments)``: one actor update
    through imagination on the world model as updated this step, against
    the weighted sum of each ``CriticStream``'s normalised advantage
    (``weight / Σ weights``), then each stream's critic update; Moments
    and value losses come back per stream. DreamerV3's step is one stream
    of weight 1 on the world model's reward."""
    wm_cfg = cfg.algo.world_model
    stoch_flat = int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size)
    R = int(wm_cfg.recurrent_model.recurrent_state_size)
    horizon = int(cfg.algo.horizon)
    gamma = float(cfg.algo.gamma)
    lmbda = float(cfg.algo.lmbda)
    ent_coef = float(cfg.algo.actor.ent_coef)
    moments_cfg = cfg.algo.actor.moments

    def behaviour_step(actor: Actor, actor_opt: Clipped, streams: Sequence[CriticStream], terminated, zs, hs, noise):
        TB = terminated.numel()
        true_continue0 = (1 - terminated).reshape(TB, 1)
        weights_sum = sum(s.weight for s in streams)
        modules = [m for s in streams for m in (s.critic, s.target)]
        # one cast of each module for the whole phase: the world model as
        # updated this step, the actor before its update, the critics before
        # theirs
        with apply.params(wm, actor, *modules):
            # the discrete objective reaches the actor only through the
            # log-probs of detached trajectories, so its rollout needs no
            # graph; the continuous objective differentiates through the
            # dynamics
            with torch.set_grad_enabled(is_continuous):
                trajectories, imagined_actions = imagine(apply, wm.rssm, actor, zs.reshape(TB, stoch_flat),
                                                         hs.reshape(TB, R), noise, horizon)
                continues = Independent(BernoulliSafeMode(logits=apply(wm.cont, trajectories)), 1).mode
                continues = torch.cat([true_continue0[None], continues[1:]], dim=0)
                values, lvs = [], []
                for s in streams:
                    values.append(TwoHotEncodingDistribution(apply(s.critic, trajectories), dims=1).mean)
                    reward = (TwoHotEncodingDistribution(apply(wm.reward, trajectories), dims=1).mean
                              if s.reward is None else s.reward(trajectories, imagined_actions))
                    lvs.append(lambda_values_op(reward[1:], values[-1][1:], continues[1:] * gamma, lmbda))
            discount = (unrolled_cumprod(continues * gamma) / gamma).detach()
            advantage, moments = 0.0, []
            for s, v, lv in zip(streams, values, lvs):
                m, offset, invscale = update_moments(
                    s.moments, lv, float(moments_cfg.decay), float(moments_cfg.max),
                    float(moments_cfg.percentile.low), float(moments_cfg.percentile.high),
                )
                moments.append(m)
                advantage = advantage + ((lv - offset) / invscale - (v[:-1] - offset) / invscale) * (
                    s.weight / weights_sum)
            dists = actor_dists(actor, apply(actor, trajectories.detach()))
            if is_continuous:
                objective = advantage
            else:
                logprobs, start = [], 0
                for d, adim in zip(dists, actions_dim):
                    act = imagined_actions[..., start : start + adim].detach()
                    logprobs.append(d.log_prob(act)[..., None][:-1])
                    start += adim
                objective = sum(logprobs) * advantage.detach()
            entropy = ent_coef * sum(d.entropy() for d in dists)[..., None]
            policy_loss = -torch.mean(discount[:-1] * (objective + entropy[:-1]))
            # the optimizer holds the master parameters, not the cast copies
            grads = torch.autograd.grad(policy_loss, actor_opt.params, allow_unused=True)
            _apply_grads(actor_opt, grads)

            traj_sg = trajectories.detach()
            value_losses = []
            for s, lv in zip(streams, lvs):
                qv = TwoHotEncodingDistribution(apply(s.critic, traj_sg[:-1]), dims=1)
                with torch.no_grad():
                    target_values = TwoHotEncodingDistribution(apply(s.target, traj_sg[:-1]), dims=1).mean
                value_loss = torch.mean((-qv.log_prob(lv.detach()) - qv.log_prob(target_values)) * discount[:-1, ..., 0])
                s.optimizer.zero_grad()
                value_loss.backward()
                _apply_grads(s.optimizer)
                value_losses.append(value_loss.detach())
        return policy_loss.detach(), value_losses, moments

    return behaviour_step


def ema_(target: torch.nn.Module, source: torch.nn.Module, tau: float) -> None:
    """``target ← (1 - tau) · target + tau · source``, parameter by parameter."""
    with torch.no_grad():
        for t, s in zip(target.parameters(), source.parameters()):
            t.copy_((1 - tau) * t + tau * s)


def make_train_fn(
    wm: WorldModel,
    actor: Actor,
    critic: torch.nn.Module,
    target_critic: torch.nn.Module,
    optimizers: DV3Optimizers,
    cfg: Config,
    is_continuous: bool,
    actions_dim: Sequence[int],
):
    """Returns ``train(moments, batches, noise=None, generator=None) ->
    (moments, metrics)``: G gradient steps over ``batches`` [G, T, B, ...]
    (tensors on the modules' device). ``noise`` is a list of G
    ``draw_train_noise`` dicts; without it the draws come from
    ``generator``. Metrics are [G] tensors, left on the device.

    Under a bf16 ``fabric.precision`` every forward of ``wm``, ``actor`` and
    ``critic`` crosses the cast boundary (``PrecisionApplies``), which casts
    each module's parameters once per phase of the step."""
    apply = make_precision_applies(cfg)
    tau = float(cfg.algo.critic.tau)
    target_freq = int(cfg.algo.critic.per_rank_target_network_update_freq)
    world_model_step = make_world_model_step(wm, optimizers.wm, cfg, apply)
    behaviour_step = make_behaviour_step(wm, cfg, apply, is_continuous, actions_dim)

    def one_step(batch, moments, noise):
        zs, hs, metrics = world_model_step(batch, noise)
        stream = CriticStream(critic, target_critic, optimizers.critic, moments)
        policy_loss, (value_loss,), (moments,) = behaviour_step(actor, optimizers.actor, [stream],
                                                                batch["terminated"], zs, hs, noise)
        optimizers.step += 1
        if optimizers.step % target_freq == 0:
            ema_(target_critic, critic, tau)
        metrics["Loss/policy_loss"] = policy_loss
        metrics["Loss/value_loss"] = value_loss
        return moments, metrics

    def train(moments: MomentsState, batches: Dict[str, torch.Tensor], noise=None, generator=None):
        G, T, B = batches["rewards"].shape[:3]
        device = batches["rewards"].device
        steps: List[Dict[str, torch.Tensor]] = []
        for g in range(G):
            batch = {k: v[g] for k, v in batches.items()}
            step_noise = (
                noise[g] if noise is not None
                else draw_train_noise(cfg, T, B, actions_dim, is_continuous, generator, device)
            )
            moments, metrics = one_step(batch, moments, step_noise)
            steps.append(metrics)
        return moments, {k: torch.stack([m[k] for m in steps]) for k in METRIC_KEYS}

    return train


def make_player(wm: WorldModel, actor: Actor, cfg: Config, actions_dim, is_continuous: bool, num_envs: int):
    """Recurrent player: state = (h, z, a), all [N, ...] on the modules'
    device. ``step(obs, state, noise=None, generator=None, greedy=False,
    modules=None)`` takes host observations (``prepare_obs``) and returns
    (env_actions, actions, state); ``noise`` is ``{"repr": [N,S,D], "act":
    [per head]}``. ``modules`` ({"wm", "actor"}, e.g. ``mirror.current()``)
    replaces ``wm`` and ``actor`` for that call; ``init_state`` takes it too."""
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    device = next(wm.parameters()).device

    @torch.no_grad()
    def init_state(mask=None, state=None, modules=None):
        wm_ = wm if modules is None else modules["wm"]
        h0, z0 = wm_.rssm.initial_states((num_envs,))
        h0 = h0.contiguous()
        a0 = torch.zeros(num_envs, int(sum(actions_dim)), device=device)
        if state is None or mask is None:
            return (h0, z0, a0)
        m = torch.as_tensor(np.asarray(mask), device=device)[:, None]
        return tuple(torch.where(m, x0, x) for x0, x in zip((h0, z0, a0), state))

    @torch.no_grad()
    def step(obs: Dict[str, np.ndarray], state, noise=None, generator=None, greedy: bool = False, modules=None):
        wm_, actor_ = (wm, actor) if modules is None else (modules["wm"], modules["actor"])
        h, z, a = state
        obs_t = normalize_obs({k: torch.as_tensor(v, device=device) for k, v in obs.items()}, cnn_keys)
        embedded = wm_.embed(obs_t)
        h = wm_.rssm.recurrent_model(torch.cat([z, a], dim=-1), h)
        z = wm_.rssm.representation_step(h, embedded, noise["repr"] if noise else None, generator)
        pre = actor_(torch.cat([z, h], dim=-1))
        acts, _ = sample_actor_actions(actor_, pre, noise["act"] if noise else None, generator, greedy)
        a = torch.cat(acts, dim=-1)
        if is_continuous:
            env_actions = a
        else:
            env_actions = torch.stack([torch.argmax(x, dim=-1) for x in acts], dim=-1)
        return env_actions, a, (h, z, a)

    return init_state, step


def _actions_dim(action_space) -> List[int]:
    if isinstance(action_space, spaces.Box):
        return [int(np.prod(action_space.shape))]
    if isinstance(action_space, spaces.MultiDiscrete):
        return [int(n) for n in action_space.nvec]
    return [int(action_space.n)]


def _set_gen_state(gen: torch.Generator, saved: Dict[str, Any], name: str) -> None:
    set_gen_state(gen, saved, name, tag="dreamer_v3")


class LoopParts(NamedTuple):
    """What ``run_serial`` needs of a phase: the modules a checkpoint and a
    resumed run's fingerprint hold (``named``), a burst (``train(batches,
    generator) -> metrics`` of [G] tensors), the actor the player acts with
    (``player_actor(task_phase)``: the task phase begins at
    ``learning_starts``), the phase's part of a checkpoint, the task actor
    for the test episode, the metrics it logs, whether it acts at random
    before ``learning_starts``, and a buffer state to start from."""

    named: Dict[str, nn.Module]
    train: Callable[[Dict[str, torch.Tensor], torch.Generator], Dict[str, torch.Tensor]]
    player_actor: Callable[[bool], nn.Module]
    algo_state: Callable[[], Dict[str, Any]]
    task_actor: nn.Module
    aggregator_keys: Any
    random_warmup: bool = True
    rb_state: Optional[Dict[str, Any]] = None


class DV3Stepper:
    """``stepper(sink)``: ONE vector-env step of the DreamerV3 family (the
    JAX package's row layout: each row holds an observation with the action
    taken from it; a finished episode adds a closing row with its final
    observation, and the next row opens with ``is_first``). Acts at random
    up to ``learning_starts`` when ``random_warmup``, else with the player
    on ``mirror.current()``; the rows and the finished episodes' stats go
    into ``sink`` (the buffer itself serially, a ``RecordingSink`` under the
    overlap engine). ``p_step`` counts the env steps taken."""

    def __init__(self, cfg: Config, envs, actions_dim: Sequence[int], is_continuous: bool, player_init, player_step,
                 player_gen: torch.Generator, mirror, p_step: int, learning_starts: int, random_warmup: bool = True):
        self.cfg, self.envs, self.actions_dim, self.is_continuous = cfg, envs, list(actions_dim), is_continuous
        self.player_init, self.player_step, self.player_gen, self.mirror = player_init, player_step, player_gen, mirror
        self.p_step, self.learning_starts, self.random_warmup = p_step, learning_starts, random_warmup
        self.num_envs = int(cfg.env.num_envs)
        self.cnn_keys, self.mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
        self.obs_keys = self.cnn_keys + self.mlp_keys
        self.is_multidiscrete = isinstance(envs.single_action_space, spaces.MultiDiscrete)
        self.clip_rewards = (lambda r: np.tanh(r)) if cfg.env.clip_rewards else (lambda r: r)
        self.obs, _ = envs.reset(seed=int(cfg.seed))
        n, act_total = self.num_envs, int(sum(actions_dim))
        self.step_data: Dict[str, np.ndarray] = {k: np.asarray(self.obs[k])[np.newaxis] for k in self.obs_keys}
        self.step_data["actions"] = np.zeros((1, n, act_total), np.float32)
        self.step_data["rewards"] = np.zeros((1, n, 1), np.float32)
        self.step_data["terminated"] = np.zeros((1, n, 1), np.float32)
        self.step_data["truncated"] = np.zeros((1, n, 1), np.float32)
        self.step_data["is_first"] = np.ones((1, n, 1), np.float32)
        self.player_state = None  # made by the player, on its own stream

    def __call__(self, sink) -> None:
        cfg, n, step_data, obs_keys = self.cfg, self.num_envs, self.step_data, self.obs_keys
        action_space = self.envs.single_action_space
        mods = self.mirror.current()
        if self.player_state is None:
            self.player_state = self.player_init(modules=mods)
        if self.random_warmup and self.p_step <= self.learning_starts:
            actions_env = np.stack([action_space.sample() for _ in range(n)])
            if self.is_continuous:
                actions_np = actions_env.reshape(n, -1).astype(np.float32)
            else:
                acts2d = actions_env.reshape(n, -1)
                actions_np = np.concatenate(
                    [np.eye(adim, dtype=np.float32)[acts2d[:, j]] for j, adim in enumerate(self.actions_dim)], axis=-1
                )
        else:
            host_obs = prepare_obs(self.obs, self.cnn_keys, self.mlp_keys, n)
            env_actions, actions_cat, self.player_state = self.player_step(
                host_obs, self.player_state, generator=self.player_gen, modules=mods
            )
            actions_np = actions_cat.cpu().numpy()
            actions_env = env_actions.cpu().numpy()
            if self.is_continuous:
                actions_env = actions_env.reshape(n, -1)
            elif not self.is_multidiscrete:
                actions_env = actions_env.reshape(n)

        step_data["actions"] = actions_np.reshape(1, n, -1)
        sink.add(step_data, validate_args=cfg.buffer.validate_args)
        next_obs, rewards, terminated, truncated, info = self.envs.step(actions_env)
        self.p_step += n
        dones = np.logical_or(terminated, truncated)
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
            step_data[k] = np.asarray(next_obs[k])[np.newaxis]
        step_data["is_first"] = np.zeros((1, n, 1), np.float32)
        step_data["terminated"] = np.asarray(terminated, np.float32).reshape(1, n, 1)
        step_data["truncated"] = np.asarray(truncated, np.float32).reshape(1, n, 1)
        step_data["rewards"] = self.clip_rewards(np.asarray(rewards, np.float32).reshape(1, n, 1))

        # an env restarted in flight: its last row becomes a truncation
        # boundary, and its recurrent state starts anew
        restarted = patch_restarted_envs(info, dones, sink, step_data)
        if restarted is not None:
            self.player_state = self.player_init(restarted, self.player_state, modules=mods)

        dones_idxes = np.nonzero(dones)[0].tolist()
        if dones_idxes:
            # closing row for the finished episodes, then an open row
            reset_data: Dict[str, np.ndarray] = {k: real_next_obs[k][dones_idxes][np.newaxis] for k in obs_keys}
            reset_data["terminated"] = step_data["terminated"][:, dones_idxes]
            reset_data["truncated"] = step_data["truncated"][:, dones_idxes]
            reset_data["actions"] = np.zeros((1, len(dones_idxes), int(sum(self.actions_dim))), np.float32)
            reset_data["rewards"] = step_data["rewards"][:, dones_idxes]
            reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
            sink.add(reset_data, dones_idxes, validate_args=cfg.buffer.validate_args)
            step_data["rewards"][:, dones_idxes] = 0
            step_data["terminated"][:, dones_idxes] = 0
            step_data["truncated"][:, dones_idxes] = 0
            step_data["is_first"][:, dones_idxes] = 1
            mask = np.zeros((n,), bool)
            mask[dones_idxes] = True
            self.player_state = self.player_init(mask, self.player_state, modules=mods)
        self.obs = next_obs


@register_algorithm(name="dreamer_v3")
def main(cfg: Config) -> None:
    """The DreamerV3 training loop: act, store, train G steps per the replay
    ratio; overlapped (player thread) or serial; checkpoints, the RunGuard's
    preemption drain and resume; one greedy test episode at the end."""
    if int(cfg.algo.select("fleet.workers", 0) or 0) > 0:
        raise NotImplementedError("algo.fleet.workers > 0: the actor fleet is not ported yet")
    precision = check_precision(cfg)
    device = get_device(cfg)
    seed = int(cfg.seed)
    log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
    save_configs(cfg, log_dir)
    print(f"[dreamer_v3] log_dir={log_dir}", flush=True)
    MetricAggregator.disabled = int(cfg.metric.select("log_level", 1) or 0) == 0
    log_on = not MetricAggregator.disabled

    state = None
    if cfg.checkpoint.resume_from:
        state = CheckpointManager.load(cfg.checkpoint.resume_from, map_location=device)
    torch.manual_seed(seed)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    envs = vectorize(cfg, seed, 0, restart_handled_by_loop=True)
    obs_space = envs.single_observation_space
    action_space = envs.single_action_space
    num_envs = int(cfg.env.num_envs)
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    is_continuous = isinstance(action_space, spaces.Box)
    actions_dim = _actions_dim(action_space)
    act_total = int(sum(actions_dim))

    wm, actor, critic, target_critic = build_agent(cfg, obs_space, actions_dim, is_continuous, device)
    for m in (wm, actor, critic, target_critic):
        m.to(precision.param_dtype)  # bf16-true: the parameters themselves are bf16
    optimizers = build_optimizers(cfg, wm, actor, critic)
    moments = init_moments(device)
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    if state:
        for name, m in (("wm", wm), ("actor", actor), ("critic", critic), ("target_critic", target_critic)):
            m.load_state_dict(state[name])
        for name in ("wm", "actor", "critic"):
            getattr(optimizers, name).optimizer.load_state_dict(state["opt_states"][name])
        optimizers.step = int(state["opt_states"]["step"])
        moments = MomentsState(state["moments"]["low"], state["moments"]["high"])
        ratio.load_state_dict(state["ratio"])
        _set_gen_state(generator, state["generators"]["train"], "train")

    seq_len = int(cfg.algo.per_rank_sequence_length)
    buffer_size = int(cfg.buffer.size) if not cfg.dry_run else max(4 * seq_len, 64)
    memmap = bool(cfg.buffer.memmap)
    rb = EnvIndependentReplayBuffer(
        buffer_size, n_envs=num_envs, obs_keys=obs_keys, buffer_cls=SequentialReplayBuffer, seed=seed,
        memmap=memmap, memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0") if memmap else None,
        memmap_fast_resume=bool(cfg.buffer.memmap_fast_resume),
    )
    if state and cfg.buffer.checkpoint and "rb" in state:
        rb.load_state_dict(state["rb"])
    # [G, T, B, ...] replay batches: the device ring where the mirrored
    # buffer fits (buffer.device_cache), else host samples staged one
    # iteration ahead through pinned memory
    prefetch = make_sequential_prefetcher(
        cfg, device, rb, int(cfg.algo.per_rank_batch_size), seq_len, cnn_keys=cnn_keys,
        row_bytes_hint=estimate_row_bytes(obs_space, act_total),
    )
    train = make_train_fn(wm, actor, critic, target_critic, optimizers, cfg, is_continuous, actions_dim)
    # the player acts with its own copy of {wm, actor} (the train step
    # updates the learner's in place) and its own generator
    mirror, pdev, player_gen = make_param_mirror(cfg, device, {"wm": wm, "actor": actor}, seed)
    if state:
        _set_gen_state(player_gen, state["generators"]["player"], "player")
    mods0 = mirror.current()
    player_init, player_step = make_player(mods0["wm"], mods0["actor"], cfg, actions_dim, is_continuous, num_envs)

    logger = get_logger(cfg, log_dir)
    telem = Telemetry.setup(cfg, log_dir, logger=logger, aggregator_keys=AGGREGATOR_KEYS, device=device)
    aggregator = telem.aggregator
    ckpt = CheckpointManager(log_dir, keep_last=cfg.checkpoint.keep_last)
    guard = RunGuard.setup(cfg, ckpt, log_dir, telem=telem)
    ckpt = guard.ckpt

    total_steps = int(cfg.algo.total_steps) if not cfg.dry_run else 4 * num_envs
    learning_starts = int(cfg.algo.learning_starts) if not cfg.dry_run else 0
    policy_step = int(state["policy_step"]) if state else 0
    last_log = int(state["last_log"]) if state else 0
    last_checkpoint = int(state["last_checkpoint"]) if state else 0
    log_every = int(cfg.metric.log_every)
    if state:
        print("[dreamer_v3] resumed " + json.dumps({
            "checkpoint": str(cfg.checkpoint.resume_from), "policy_step": policy_step, "grad_steps": optimizers.step,
            "ratio": ratio.state_dict(), "last_log": last_log, "last_checkpoint": last_checkpoint,
            "param_sums": param_sums({"wm": wm, "actor": actor, "critic": critic, "target_critic": target_critic}),
        }), flush=True)

    pending: List[Dict[str, torch.Tensor]] = []
    # the player generator's state after the last transition in the buffer
    # (under overlap the player runs ahead; its state rides each packet)
    player_gen_state = _gen_state(player_gen)
    engine = OverlapEngine.setup(cfg, telem, guard, total_steps=total_steps, initial_step=policy_step)
    costed = False  # the model FLOPs and bytes of a gradient step, counted on the first burst
    t0 = time.perf_counter()
    # the player's env steps (== policy_step serially)
    interact = DV3Stepper(cfg, envs, actions_dim, is_continuous, player_init, player_step, player_gen, mirror,
                          policy_step, learning_starts)

    def _ckpt_state() -> Dict[str, Any]:
        s: Dict[str, Any] = {
            "wm": wm.state_dict(),
            "actor": actor.state_dict(),
            "critic": critic.state_dict(),
            "target_critic": target_critic.state_dict(),
            "opt_states": {
                "wm": optimizers.wm.optimizer.state_dict(),
                "actor": optimizers.actor.optimizer.state_dict(),
                "critic": optimizers.critic.optimizer.state_dict(),
                "step": optimizers.step,
            },
            "moments": {"low": moments.low, "high": moments.high},
            "ratio": ratio.state_dict(),
            "policy_step": policy_step,
            "last_log": last_log,
            "last_checkpoint": last_checkpoint,
            "generators": {
                "train": _gen_state(generator),
                "player": player_gen_state if engine.enabled else _gen_state(player_gen),
            },
        }
        if cfg.buffer.checkpoint:
            s["rb"] = rb.checkpoint_state_dict()
        return s

    def burst(g: int) -> None:
        nonlocal moments, costed
        with telem.span("Time/train_time"):
            batch = prefetch.take(g)
            if costed or not telem.enabled:
                moments, metrics = train(moments, batch, generator=generator)
            else:  # once: the step's operations and bytes, for MFU and the roofline record
                (moments, metrics), cost = model_cost(lambda: train(moments, batch, generator=generator))
                costed = True
                per_step = {k: v / g for k, v in cost.items()}
                telem.set_model_flops(per_step["flops"], str(cfg.fabric.precision))
                telem.register_roofline("train_step", per_step, track_grad_rate=True)
        if log_on:
            pending.append(metrics)  # on the device until the log cadence

    def flush_logs() -> None:
        nonlocal last_log
        if not log_on or not (policy_step - last_log >= log_every or cfg.dry_run or policy_step >= total_steps):
            return
        for m in pending:  # the host sync, at the log cadence only
            for k, v in m.items():
                aggregator.update(k, v.cpu().numpy())
        pending.clear()
        # the run's own counters beside the interval's: what a reader of the
        # stream needs to line a record up with the loop's ledger
        telem.log(policy_step, fields={"grad_steps": optimizers.step, "elapsed_s": time.perf_counter() - t0,
                                       "mirror": mirror.stats()})
        last_log = policy_step

    def maybe_checkpoint() -> None:
        nonlocal last_checkpoint
        every = int(cfg.checkpoint.every)
        if (every > 0 and policy_step - last_checkpoint >= every) or cfg.dry_run or policy_step >= total_steps:
            last_checkpoint = policy_step
            ckpt.save(policy_step, _ckpt_state())

    try:
        if engine.enabled:
            # ---- overlapped player/learner loop (engine/overlap.py) ----------
            player_stream = torch.cuda.Stream(pdev) if pdev.type == "cuda" else None

            def play() -> Packet:
                rec = RecordingSink()
                with torch.cuda.stream(player_stream) if player_stream is not None else contextlib.nullcontext():
                    with telem.span("Time/env_interaction_time"):
                        interact(rec)
                return Packet((rec, _gen_state(player_gen)), num_envs)

            def absorb(pkt: Packet) -> None:
                nonlocal player_gen_state
                rec, player_gen_state = pkt.payload
                rec.apply(rb, aggregator)

            engine.start(play)
            stopped = False
            try:
                while policy_step < total_steps:
                    telem.tick(policy_step)
                    if guard.stop_reached(policy_step, total_steps, None, save=False):
                        stopped = True
                        break
                    packets = engine.take()
                    if not packets:
                        break
                    # ack packets in FIFO order, feeding the Ratio ledger exactly
                    # as the serial loop would (one call per num_envs env steps)
                    gs = []
                    for pkt in packets:
                        absorb(pkt)
                        policy_step += pkt.env_steps
                        if policy_step >= learning_starts:
                            gs.append(ratio(policy_step))
                            telem.record_grad_steps(gs[-1])
                    # one train call per owed burst; each launches
                    # asynchronously, so staging the next burst's batch
                    # overlaps the card's work on this one
                    trained = False
                    for i, g in enumerate(gs):
                        if g > 0:
                            burst(g)
                            trained = True
                            nxt = next((x for x in gs[i + 1 :] if x > 0), 0)
                            if nxt > 0:
                                prefetch.stage(nxt)
                    if trained:
                        mirror.refresh({"wm": wm, "actor": actor})
                    engine.published()  # release take()'s claim every iteration
                    if learning_starts <= policy_step < total_steps:
                        prefetch.stage(ratio.peek(policy_step + num_envs))
                    flush_logs()
                    maybe_checkpoint()
            finally:
                # the player joins before anything else (CUDA teardown included);
                # the queued transitions land in the buffer so the final
                # checkpoint is consistent
                policy_step += engine.shutdown(absorb)
            if stopped and not guard.preempted and cfg.checkpoint.save_last:
                ckpt.save(policy_step, _ckpt_state())
        else:
            # ---- serial loop (the reference's semantics) -----------------------
            sink = BufferOpSink(rb, aggregator)
            while policy_step < total_steps:
                telem.tick(policy_step)
                if guard.stop_reached(policy_step, total_steps, _ckpt_state):
                    break
                with telem.span("Time/env_interaction_time"):
                    interact(sink)
                policy_step = interact.p_step
                if policy_step >= learning_starts:
                    g = ratio(policy_step)
                    telem.record_grad_steps(g)
                    if g > 0:
                        burst(g)
                        mirror.refresh({"wm": wm, "actor": actor})
                    if policy_step < total_steps:
                        # the next burst's batch, while the card computes this one
                        prefetch.stage(ratio.peek(policy_step + num_envs))
                flush_logs()
                maybe_checkpoint()
    finally:
        # signal handlers uninstalled and pending writes flushed, also when the run fails
        guard.close(policy_step, _ckpt_state)
        envs.close()
        telem.close(policy_step)
    if cfg.algo.run_test:
        test_env = single_env(cfg, seed)
        # the player acts in f32 (bf16-true keeps bf16 parameters)
        t_wm, t_actor = (wm, actor) if precision.param_dtype == torch.float32 else (
            copy.deepcopy(wm).float(), copy.deepcopy(actor).float())
        t_init, t_step = make_player(t_wm, t_actor, cfg, actions_dim, is_continuous, 1)
        test(t_init, t_step, test_env, cfg, generator, logger=logger)
    if logger is not None:
        logger.close()


@register_evaluation("dreamer_v3")
def evaluate_dreamer_v3(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode with the checkpoint's world model and actor on the
    run's device (``eval checkpoint_path=...``)."""
    check_precision(cfg)
    device = get_device(cfg)
    seed = int(cfg.seed)
    env = single_env(cfg, seed)
    action_space = env.action_space
    is_continuous = isinstance(action_space, spaces.Box)
    actions_dim = _actions_dim(action_space)
    torch.manual_seed(seed)
    wm, actor, _, _ = build_agent(cfg, env.observation_space, actions_dim, is_continuous, device)
    wm.load_state_dict(state["wm"])
    actor.load_state_dict(state["actor"])
    t_init, t_step = make_player(wm, actor, cfg, actions_dim, is_continuous, 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    test(t_init, t_step, env, cfg, gen)
