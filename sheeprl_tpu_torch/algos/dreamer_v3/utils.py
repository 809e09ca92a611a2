"""DreamerV3 helpers (counterpart of ``sheeprl_tpu/algos/dreamer_v3/utils.py``):
Moments, the precision boundary, observation shaping, the decoder
distributions and the greedy test episode."""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

from ...distributions import MSEDistribution, SymlogDistribution
from ...envs import spaces
from ...parallel.precision import Precision, cast_floating, disable_tf32, get_precision

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


def check_precision(cfg: Any) -> Precision:
    """``fabric.precision``'s policy (``parallel/precision.py``; an unknown
    name raises the JAX package's error). The f32 parts of every policy are
    full f32 on the card too, so TF32 is turned off for cuBLAS matmuls and
    cuDNN convolutions (PyTorch enables it for cuDNN by default)."""
    precision = get_precision(str(cfg.select("fabric.precision", "32-true")))
    disable_tf32()
    return precision


class PrecisionApplies:
    """The mixed-precision cast boundary of the train step (the port's
    ``make_precision_applies``): under a bf16 policy the forwards of ``wm``,
    ``actor`` and ``critic`` run on bf16 copies of their parameters and take
    bf16 inputs, and their outputs cross back in f32, so losses, Moments,
    the target EMA, the optimizers and (under ``bf16-mixed``) the master
    parameters stay f32. Under ``32-true`` both are the identity.

    ``with applies.params(*modules):`` casts each module's floating
    parameters once (``Tensor.to``, differentiable, so gradients reach the
    masters) and swaps the copies in until the block ends: one cast per
    module per phase of the step, however many applies the phase makes.
    ``applies(fn, *args, **kwargs)`` is one apply: floating tensors in the
    arguments go in as bf16 (pre-drawn ``noise`` stays f32, as the JAX
    package draws it in f32), floating outputs come out as f32."""

    _UNCAST = ("noise", "generator")

    def __init__(self, precision: Precision):
        self.precision = precision
        self.compute_dtype = precision.compute_dtype
        self.mixed = self.compute_dtype != torch.float32

    @contextlib.contextmanager
    def params(self, *modules: torch.nn.Module) -> Iterator[None]:
        if not self.mixed:
            yield
            return
        swapped = []
        try:
            for module in modules:
                for mod in module.modules():
                    for name, p in list(mod._parameters.items()):
                        if p is not None and p.is_floating_point() and p.dtype != self.compute_dtype:
                            swapped.append((mod, name, p))
                            mod._parameters[name] = p.to(self.compute_dtype)
            yield
        finally:
            for mod, name, p in reversed(swapped):
                mod._parameters[name] = p

    def cast_in(self, tree: Any) -> Any:
        """Floating tensors into the compute dtype (a scan casts its
        time-parallel inputs once, before its loop)."""
        return cast_floating(tree, self.compute_dtype) if self.mixed else tree

    def cast_out(self, tree: Any) -> Any:
        """Floating tensors back to f32."""
        return cast_floating(tree, torch.float32) if self.mixed else tree

    def __call__(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        if not self.mixed:
            return fn(*args, **kwargs)
        args = cast_floating(args, self.compute_dtype)
        kwargs = {k: v if k in self._UNCAST else cast_floating(v, self.compute_dtype) for k, v in kwargs.items()}
        return cast_floating(fn(*args, **kwargs), torch.float32)


def make_precision_applies(cfg: Any) -> PrecisionApplies:
    """The cast boundary for ``fabric.precision`` (TF32 off, as
    ``check_precision``)."""
    return PrecisionApplies(check_precision(cfg))


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


def decode_obs_dists(wm, latents, batch_obs, cnn_keys, mlp_keys, apply=None):
    """Decoder distributions and the matching observation targets (the
    pixel-space form of the JAX package's ``decode_obs_dists``); ``apply``
    is the precision boundary the decoder runs through."""
    recon = wm.decode(latents) if apply is None else apply(wm.decode, latents)
    po = {k: MSEDistribution(recon[k], dims=3) for k in cnn_keys}
    po.update({k: SymlogDistribution(recon[k], dims=1) for k in mlp_keys})
    return po, batch_obs


def test(player_init, player_step, env, cfg: Any, generator: torch.Generator, seed=None, logger=None) -> float:
    """One greedy episode of ``env`` (a single env) with the recurrent
    player of ``make_player(..., num_envs=1)``; prints ``Test - Reward: <r>``,
    logs it as ``Test/cumulative_reward`` to ``logger`` if one is given, and
    returns the episode's reward. ``dry_run`` stops after one step."""
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
    if logger is not None:
        logger.log_metrics({"Test/cumulative_reward": cumulative_rew}, 0)
    print(f"Test - Reward: {cumulative_rew}", flush=True)
    env.close()
    return cumulative_rew
