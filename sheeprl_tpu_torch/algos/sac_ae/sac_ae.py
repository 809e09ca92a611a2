"""SAC-AE training in PyTorch (counterpart of
``sheeprl_tpu/algos/sac_ae/sac_ae.py``).

One gradient step (``make_train_fn``) is the JAX package's ``one_step``:

1. the critic: the target from the online encoder's features of the next
   observation (for the next action) and the target encoder's (for the
   target Qs); one update of the encoder and the Qs together (the ``qf``
   optimizer);
2. the targets' EMA where ``step % critic.per_rank_target_network_update_freq
   == 0``: tau for the Qs, ``encoder.tau`` for the encoder;
3. the actor and alpha on the encoder's detached features, due where
   ``step % actor.per_rank_update_freq == 0``;
4. the reconstruction: encoder and decoder, due where ``step %
   decoder.per_rank_update_freq == 0``, against the 5-bit dithered image
   (``preprocess_obs``) plus an L2 penalty on the features (``encoder`` and
   ``decoder`` optimizers; the decoder's is AdamW).

An update that is not due still steps its optimizer on zero gradients and
leaves the parameters as they were (``sac.apply_grads(apply=False)``), as
the JAX package's masked updates do: Adam's moments decay and its count
goes up every step. Every draw is an argument (``draw``: the two standard
normals and the dither of each image key per step).

``main`` is the serial loop of ``sac.OffPolicyLoop`` (as in the JAX
package), fed by ``make_uniform_prefetcher`` with the image keys and their
``next_`` twins kept uint8; ``evaluate_sac_ae`` is the ``eval`` entry. On N
ranks (``parallel/mesh.py``) rank ``d`` steps env block ``d`` into its own
buffer and trains on its ``per_rank_batch_size`` columns; every update that
is due (critic, actor and alpha, encoder with decoder) takes the ranks' mean
gradient in one flattened all-reduce; the updates that are not due step on
zero gradients on every rank alike, since the step counter that decides
them is global.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ...config import Config, instantiate
from ...data.buffers import env_block, gather_env_blocks
from ...data.device_ring import estimate_row_bytes, make_uniform_prefetcher
from ...parallel.mesh import collective
from ...parallel.mesh import current as current_distributed
from ...parallel.placement import make_param_mirror
from ...utils.env import episode_stats, single_env
from ...utils.logger import get_logger
from ...utils.model_manager import register_model
from ...utils.registry import register_algorithm, register_evaluation
from ..sac.agent import sample_actions
from ..sac.loss import critic_loss, entropy_loss, policy_loss
from ..sac.sac import (LOSS_KEYS, OffPolicyLoop, Optimizers, apply_grads, ema_, evaluate_agent, rank_grads,
                       replay_buffer, start_run)
from .agent import SACAEAgent, build_agent
from .utils import normalize_obs, prepare_obs, preprocess_obs, test

METRIC_KEYS = LOSS_KEYS + ("Loss/reconstruction_loss",)


def build_optimizers(cfg: Config, agent: SACAEAgent) -> Optimizers:
    """``qf`` over the encoder and the Qs, ``actor``, ``alpha``, ``encoder``
    (the reconstruction's) and ``decoder``: the encoder sits under two."""
    algo = cfg.algo
    enc = list(agent.encoder.parameters())
    return Optimizers(
        qf=instantiate(algo.critic.optimizer, enc + list(agent.qs.parameters())),
        actor=instantiate(algo.actor.optimizer, list(agent.actor.parameters())),
        alpha=instantiate(algo.alpha.optimizer, [agent.log_alpha]),
        encoder=instantiate(algo.encoder.optimizer, enc),
        decoder=instantiate(algo.decoder.optimizer, list(agent.decoder.parameters())),
    )


def draw(g: int, batch: Dict[str, torch.Tensor], cnn_keys: Sequence[str], act_dim: int,
         generator: Optional[torch.Generator]) -> List[Dict[str, Any]]:
    """Per step of a ``[G, B, ...]`` burst: the next action's and the actor's
    standard normals and a uniform dither of each image key's shape."""
    b = batch["actions"].shape[1]
    dev = batch["actions"].device
    return [{"next": torch.randn((b, act_dim), generator=generator, device=dev),
             "actor": torch.randn((b, act_dim), generator=generator, device=dev),
             "dither": [torch.rand(batch[k].shape[1:], generator=generator, device=dev) for k in cnn_keys]}
            for _ in range(g)]


def make_train_fn(agent: SACAEAgent, optimizers: Optimizers, cfg: Config, target_entropy: float,
                  cnn_keys: Sequence[str], mlp_keys: Sequence[str], dist: Any = None) -> Callable:
    """``train(batches, draws=None, generator=None) -> metrics``: ``batches``
    are ``[G, B, ...]`` (the observation keys and their ``next_`` twins,
    ``actions``, ``rewards``, ``terminated``); the metrics are the losses'
    means over the G steps, as tensors. With a ``Distributed`` the batches
    are this rank's columns and every update that is due takes the ranks'
    mean gradient."""

    def grads_of(loss: torch.Tensor, params) -> Any:
        return rank_grads(loss, params, dist)

    algo = cfg.algo
    gamma, tau, enc_tau = float(algo.gamma), float(algo.tau), float(algo.encoder.tau)
    target_freq = int(algo.critic.per_rank_target_network_update_freq)
    actor_freq = int(algo.actor.per_rank_update_freq)
    decoder_freq = int(algo.decoder.per_rank_update_freq)
    l2_lambda = float(algo.decoder.l2_lambda)
    encoder, qs, actor, decoder = agent.encoder, agent.qs, agent.actor, agent.decoder
    enc_params, qs_params = list(encoder.parameters()), list(qs.parameters())
    actor_params, dec_params = list(actor.parameters()), list(decoder.parameters())
    targets = (list(agent.target_qs.parameters()), qs_params, tau), \
        (list(agent.target_encoder.parameters()), enc_params, enc_tau)
    act_dim = actor.fc_mean.out_features

    def one_step(batch: Dict[str, torch.Tensor], d: Dict[str, Any]) -> torch.Tensor:
        obs = normalize_obs(batch, cnn_keys, mlp_keys)
        next_obs = normalize_obs(batch, cnn_keys, mlp_keys, prefix="next_")
        with torch.no_grad():
            mean, log_std = actor(encoder(next_obs))
            next_actions, next_logprobs = sample_actions(actor, mean, log_std, d["next"])
            target_q = agent.target_qs(agent.target_encoder(next_obs), next_actions)
            min_target = target_q.amin(0) - torch.exp(agent.log_alpha) * next_logprobs
            y = batch["rewards"] + (1.0 - batch["terminated"]) * gamma * min_target
        qf_loss = critic_loss(qs(encoder(obs), batch["actions"]), y)
        qf_params = enc_params + qs_params
        apply_grads(optimizers["qf"], qf_params, grads_of(qf_loss, qf_params))

        optimizers.step += 1
        step = optimizers.step
        if step % target_freq == 0:
            for t, s, rate in targets:
                ema_(t, s, rate)

        do_actor = step % actor_freq == 0
        with torch.no_grad():
            feat = encoder(obs, detach_conv=True)
        mean, log_std = actor(feat)
        actions, logprobs = sample_actions(actor, mean, log_std, d["actor"])
        a_loss = policy_loss(torch.exp(agent.log_alpha).detach(), logprobs, qs(feat, actions).amin(0))
        grads = grads_of(a_loss, actor_params) if do_actor else None
        apply_grads(optimizers["actor"], actor_params, grads, apply=do_actor)
        al_loss = entropy_loss(agent.log_alpha, logprobs.detach(), target_entropy)
        grads = grads_of(al_loss, [agent.log_alpha]) if do_actor else None
        apply_grads(optimizers["alpha"], [agent.log_alpha], grads, apply=do_actor)

        do_decoder = step % decoder_freq == 0
        hidden = encoder(obs)
        rec = decoder(hidden)
        l2 = l2_lambda * torch.mean(0.5 * torch.sum(torch.square(hidden), dim=-1))
        rec_loss = 0.0
        for i, k in enumerate(cnn_keys):
            rec_loss = rec_loss + torch.mean(torch.square(preprocess_obs(batch[k], 5, d["dither"][i]) - rec[k])) + l2
        for k in mlp_keys:
            rec_loss = rec_loss + torch.mean(torch.square(batch[k] - rec[k])) + l2
        grads = grads_of(rec_loss, enc_params + dec_params) if do_decoder else [None] * (
            len(enc_params) + len(dec_params))
        apply_grads(optimizers["encoder"], enc_params, grads[:len(enc_params)], apply=do_decoder)
        apply_grads(optimizers["decoder"], dec_params, grads[len(enc_params):], apply=do_decoder)
        return torch.stack([qf_loss.detach(), a_loss.detach(), al_loss.detach(), rec_loss.detach()])

    def train(batches: Dict[str, torch.Tensor], draws: Optional[List[Dict[str, Any]]] = None,
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        g = batches["actions"].shape[0]
        if draws is None:
            draws = draw(g, batches, cnn_keys, act_dim, generator)
        sums = sum(one_step({k: v[i] for k, v in batches.items()}, draws[i]) for i in range(g))
        return dict(zip(METRIC_KEYS, sums / g))

    return train


def make_interact(loop: OffPolicyLoop, modules_of: Callable[[], Dict[str, torch.nn.Module]],
                  cnn_keys: Sequence[str], mlp_keys: Sequence[str]):
    """``interact(sink)``: one vector-env step; the row holds each observation
    key and its ``next_`` twin (the final observation of an env that
    finished), images uint8."""
    cfg, envs, n = loop.cfg, loop.envs, loop.num_envs
    obs_space, action_space = envs.single_observation_space, envs.single_action_space
    act_dim = int(np.prod(action_space.shape))
    obs, _ = envs.reset(seed=int(cfg.seed) + loop.first_env)  # N ranks: the block's envs, seeded as the run's
    current = {"obs": obs}

    def interact(sink) -> None:
        obs = current["obs"]
        if loop.random_phase():
            actions = np.stack([action_space.sample() for _ in range(n)])
        else:
            mods = modules_of()
            with torch.no_grad():
                mean, log_std = mods["actor"](mods["encoder"](prepare_obs(obs, cnn_keys, mlp_keys, n,
                                                                          loop.mirror.device)))
                acts, _ = sample_actions(mods["actor"], mean, log_std, generator=loop.player_gen)
            actions = acts.cpu().numpy().reshape(n, act_dim)
        next_obs, rewards, terminated, truncated, info = envs.step(actions)
        loop.p_step += loop.env_steps
        row: Dict[str, np.ndarray] = {}
        for k in cnn_keys:
            row[k] = np.asarray(obs[k]).reshape(1, n, *obs_space[k].shape)
            row[f"next_{k}"] = np.asarray(next_obs[k]).reshape(1, n, *obs_space[k].shape).copy()
        for k in mlp_keys:
            row[k] = np.asarray(obs[k], np.float32).reshape(1, n, -1)
            row[f"next_{k}"] = np.asarray(next_obs[k], np.float32).reshape(1, n, -1).copy()
        if "final_obs" in info:
            for i, fo in enumerate(info["final_obs"]):
                if fo is not None:
                    for k in cnn_keys:
                        row[f"next_{k}"][0, i] = np.asarray(fo[k])
                    for k in mlp_keys:
                        row[f"next_{k}"][0, i] = np.asarray(fo[k], np.float32).reshape(-1)
        row["actions"] = actions.reshape(1, n, act_dim).astype(np.float32)
        row["rewards"] = np.asarray(rewards, np.float32).reshape(1, n, 1)
        row["terminated"] = np.asarray(terminated, np.float32).reshape(1, n, 1)
        row["dones"] = np.logical_or(terminated, truncated).astype(np.float32).reshape(1, n, 1)
        sink.add(row, validate_args=cfg.buffer.validate_args)
        current["obs"] = next_obs
        for ep_rew, ep_len in episode_stats(info):
            sink.stat("Rewards/rew_avg", ep_rew)
            sink.stat("Game/ep_len_avg", ep_len)

    return interact


@register_algorithm(name="sac_ae")
def main(cfg: Config) -> None:
    """SAC-AE's serial training loop, with checkpoints, the RunGuard and
    resume; one greedy test episode at the end."""
    device, seed, log_dir, state, envs = start_run(cfg, "sac_ae")
    dist = current_distributed(cfg)
    obs_space, action_space = envs.single_observation_space, envs.single_action_space
    cnn_keys, mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    act_dim = int(np.prod(action_space.shape))
    agent = build_agent(cfg, obs_space, action_space, device)
    optimizers = build_optimizers(cfg, agent)
    if state:
        agent.load_state_dict(state["agent"])
        optimizers.load_state_dict(state["opt_states"])
    train_gen = torch.Generator(device=device)
    train_gen.manual_seed(seed + dist.rank)
    mirror, _, player_gen = make_param_mirror(cfg, device, {"encoder": agent.encoder, "actor": agent.actor},
                                              seed + dist.rank)
    logger = get_logger(cfg, log_dir, dist.rank)
    loop = OffPolicyLoop(cfg, "sac_ae", device=device, log_dir=log_dir, state=state, envs=envs, mirror=mirror,
                         player_gen=player_gen, train_gen=train_gen, logger=logger, params={"agent": agent})
    rb = replay_buffer(cfg, log_dir, seed, obs_keys=cnn_keys + mlp_keys, dist=dist)
    if state and cfg.buffer.checkpoint and "rb" in state:
        rb.load_state_dict(env_block(state["rb"], dist.rank, dist.world_size))
    # the next_ frames are stored too: twice the observations in a row
    prefetch = make_uniform_prefetcher(cfg, device, rb, int(cfg.algo.per_rank_batch_size),
                                       cnn_keys=cnn_keys + tuple(f"next_{k}" for k in cnn_keys),
                                       row_bytes_hint=2 * estimate_row_bytes(obs_space, act_dim))
    train = make_train_fn(agent, optimizers, cfg, -act_dim, cnn_keys, mlp_keys, dist=collective(cfg))

    def algo_state() -> Dict[str, Any]:
        s = {"agent": agent.state_dict(), "opt_states": optimizers.state_dict()}
        if cfg.buffer.checkpoint:  # by env block, gathered to rank 0 on N ranks
            s["rb"] = gather_env_blocks(dist.gather_object(rb.checkpoint_state_dict()) or [{}])
        return s

    modules = {"encoder": agent.encoder, "actor": agent.actor}
    loop.run(rb, make_interact(loop, mirror.current, cnn_keys, mlp_keys),
             lambda g: train(prefetch.take(g), generator=train_gen), lambda: mirror.refresh(modules),
             prefetch.stage, algo_state, overlap=False)
    if cfg.algo.run_test and dist.is_global_zero:
        test(agent, single_env(cfg, seed), cfg, device, logger)
    if dist.is_global_zero:
        register_model(cfg, {"encoder": agent.encoder, "decoder": agent.decoder, "actor": agent.actor}, log_dir)
    if logger is not None:
        logger.close()


@register_evaluation("sac_ae")
def evaluate_sac_ae(cfg: Config, state: Dict[str, Any]) -> None:
    """One greedy episode with the checkpoint's encoder and actor."""
    evaluate_agent(cfg, state, build_agent, test)
