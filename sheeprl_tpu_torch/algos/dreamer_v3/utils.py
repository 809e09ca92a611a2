"""DreamerV3 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v3/utils.py``):
Moments, observation shaping, the decoder distributions and the greedy test
episode."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ...distributions import MSEDistribution, SymlogDistribution
from ...envs import spaces

AGGREGATOR_KEYS = (
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/world_model_loss",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "State/post_entropy",
    "State/prior_entropy",
)


class MomentsState(NamedTuple):
    low: torch.Tensor
    high: torch.Tensor


def init_moments(device=None) -> MomentsState:
    return MomentsState(low=torch.zeros((), device=device), high=torch.zeros((), device=device))


def update_moments(
    state: MomentsState,
    x: torch.Tensor,
    decay: float = 0.99,
    max_: float = 1.0,
    percentile_low: float = 0.05,
    percentile_high: float = 0.95,
) -> Tuple[MomentsState, torch.Tensor, torch.Tensor]:
    """Returns (new_state, offset, invscale); ``torch.quantile`` interpolates
    linearly, as ``jnp.quantile`` does."""
    x = x.detach().float().flatten()
    low = torch.quantile(x, percentile_low)
    high = torch.quantile(x, percentile_high)
    new_low = decay * state.low + (1 - decay) * low
    new_high = decay * state.high + (1 - decay) * high
    invscale = torch.clamp_min(new_high - new_low, 1.0 / max_)
    return MomentsState(new_low, new_high), new_low, invscale


def check_precision(cfg: Any) -> None:
    """The port runs float32 only: 32-true is full f32 on the card too, so
    TF32 is turned off for cuBLAS matmuls and cuDNN convolutions (PyTorch
    enables it for cuDNN by default)."""
    precision = str(cfg.select("fabric.precision", "32-true"))
    if precision != "32-true":
        raise NotImplementedError(
            f"fabric.precision={precision}: the PyTorch port runs 32-true only; bf16-mixed waits "
            "for a later slice (ROADMAP.md, Queue 1 item 5: the mixed-precision boundary)"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def prepare_obs(obs: Dict[str, np.ndarray], cnn_keys=(), mlp_keys=(), num_envs: int = 1) -> Dict[str, np.ndarray]:
    """Shape host observations for the player: images stay uint8 (normalised
    on the device), vectors float32."""
    out: Dict[str, np.ndarray] = {}
    for k in cnn_keys:
        out[k] = np.asarray(obs[k]).reshape(num_envs, *np.asarray(obs[k]).shape[-3:])
    for k in mlp_keys:
        out[k] = np.asarray(obs[k], np.float32).reshape(num_envs, -1)
    return out


def normalize_obs(obs: Dict[str, torch.Tensor], cnn_keys) -> Dict[str, torch.Tensor]:
    return {k: (v.float() / 255.0 - 0.5) if k in cnn_keys else v for k, v in obs.items()}


def decode_obs_dists(wm, latents, batch_obs, cnn_keys, mlp_keys):
    """Decoder distributions and the matching observation targets (the
    pixel-space form of the JAX package's ``decode_obs_dists``)."""
    recon = wm.decode(latents)
    po = {k: MSEDistribution(recon[k], dims=3) for k in cnn_keys}
    po.update({k: SymlogDistribution(recon[k], dims=1) for k in mlp_keys})
    return po, batch_obs


def test(player_init, player_step, env, cfg: Any, generator: torch.Generator, seed=None) -> float:
    """One greedy episode of ``env`` (a single env) with the recurrent
    player of ``make_player(..., num_envs=1)``; prints ``Test - Reward: <r>``
    and returns the episode's reward. ``dry_run`` stops after one step."""
    done = False
    cumulative_rew = 0.0
    obs, _ = env.reset(seed=seed if seed is not None else int(cfg.seed))
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    shaped = isinstance(env.action_space, (spaces.Box, spaces.MultiDiscrete))
    state = player_init()
    while not done:
        host_obs = prepare_obs(obs, cnn_keys, mlp_keys, 1)
        env_actions, _, state = player_step(host_obs, state, generator=generator, greedy=True)
        acts = env_actions.cpu().numpy()
        step_action = acts.reshape(env.action_space.shape) if shaped else acts.reshape(()).item()
        obs, reward, terminated, truncated, _ = env.step(step_action)
        done = bool(terminated or truncated)
        cumulative_rew += float(reward)
        if cfg.dry_run:
            done = True
    print(f"Test - Reward: {cumulative_rew}", flush=True)
    env.close()
    return cumulative_rew
