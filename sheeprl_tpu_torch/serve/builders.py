"""Per-algorithm policy builders of the serving stack (the port's
counterpart of ``sheeprl_tpu/serve/builders.py``).

Each builder maps ``(cfg, observation_space, action_space)`` to a
:class:`~sheeprl_tpu_torch.serve.policy.PolicyCore`: the algorithm's own
modules, built once on the serving device (``serve_device``) and run through
``torch.func.functional_call`` with the parameters the policy passes, the
draw of one batch's noise, and the algorithm's observation shaping, with
observation dtypes canonicalized to the env's observation-space dtypes so a
JSON client sending ints never runs a shape warmup did not.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .policy import PolicyCore, register_policy_builder, serve_device

# a DreamerV3 session served in mixed buckets against the same session
# served alone at bucket 1: f32 GEMMs picked per row count sum in another
# order, and the recurrence carries the difference from step to step
DV3_SERVE_TOL = 1e-4


def _flat(params: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """``{module: {name: t}}`` → ``{"module.name": t}`` for a wrapper module
    whose children are named like the params' modules."""
    return {f"{m}.{k}": t for m, sd in params.items() for k, t in sd.items()}


def _device_and_tf32(cfg: Any) -> torch.device:
    from ..parallel.precision import disable_tf32

    disable_tf32()  # f32 products in full f32 on the card, as the trainers run them
    return serve_device(cfg)


def _obs_fns(observation_space: Any, cnn_keys: Tuple[str, ...], mlp_keys: Tuple[str, ...]):
    """``prepare`` and ``dummy_obs`` of a dict-observation policy: images
    ``[n, H, W, C]`` in the space's dtype, vectors f32 ``[n, -1]``."""

    def prepare(raw: Dict[str, Any], n: int) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for k in cnn_keys:
            a = np.asarray(raw[k])
            out[k] = a.reshape(n, *a.shape[-3:]).astype(observation_space[k].dtype, copy=False)
        for k in mlp_keys:
            out[k] = np.asarray(raw[k], np.float32).reshape(n, -1)
        return out

    def dummy_obs(n: int) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for k in cnn_keys:
            out[k] = np.zeros((n, *tuple(observation_space[k].shape)[-3:]), observation_space[k].dtype)
        for k in mlp_keys:
            out[k] = np.zeros((n, int(np.prod(observation_space[k].shape))), np.float32)
        return out

    return prepare, dummy_obs


@register_policy_builder("ppo", "ppo_decoupled", "a2c")
def build_ppo_policy(cfg: Any, observation_space: Any, action_space: Any) -> PolicyCore:
    from ..algos.ppo.agent import actions_and_log_probs, actions_dim_of, build_agent
    from ..distributions import gumbel_noise

    device = _device_and_tf32(cfg)
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    agent = build_agent(cfg, observation_space, action_space, device).requires_grad_(False)
    actions_dim, is_continuous = actions_dim_of(action_space)

    def apply(params, obs, state, noise, greedy):
        actor_out, _ = functional_call(agent, params["agent"], (obs,))
        actions, _, _ = actions_and_log_probs(actor_out, is_continuous, noise=noise, greedy=greedy)
        return actions, state

    def draw_noise(generator: torch.Generator, n: int) -> List[torch.Tensor]:
        if is_continuous:
            return [torch.randn((n, int(sum(actions_dim))), generator=generator, device=generator.device)]
        return [gumbel_noise((n, int(a)), generator, generator.device) for a in actions_dim]

    prepare, dummy_obs = _obs_fns(observation_space, cnn_keys, mlp_keys)
    return PolicyCore(
        apply=apply,
        extract_params=lambda state: {"agent": state["agent"]},
        prepare=prepare,
        dummy_obs=dummy_obs,
        draw_noise=draw_noise,
        device=device,
        name=str(cfg.select("algo.name", "ppo")),
    )


@register_policy_builder("sac", "sac_decoupled", "droq")
def build_sac_policy(cfg: Any, observation_space: Any, action_space: Any) -> PolicyCore:
    from ..algos.sac.agent import build_actor, sample_actions
    from ..algos.sac.utils import flatten_obs
    from ..envs import spaces

    if not isinstance(action_space, spaces.Box):
        raise ValueError(f"SAC-family policies need continuous (Box) actions, got {action_space}")
    device = _device_and_tf32(cfg)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    obs_dim = int(sum(np.prod(observation_space[k].shape) for k in mlp_keys))
    act_dim = int(np.prod(action_space.shape))
    actor = build_actor(cfg, obs_dim, action_space, int(cfg.algo.actor.hidden_size)).to(device)
    actor.requires_grad_(False)

    def apply(params, obs, state, noise, greedy):
        mean, log_std = functional_call(actor, params["actor"], (obs,))
        actions, _ = sample_actions(actor, mean, log_std, noise, greedy=greedy)
        return actions, state

    def extract_params(state: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
        return {"actor": {k[len("actor."):]: v for k, v in state["agent"].items() if k.startswith("actor.")}}

    return PolicyCore(
        apply=apply,
        extract_params=extract_params,
        prepare=lambda raw, n: flatten_obs(raw, mlp_keys, n),
        dummy_obs=lambda n: np.zeros((n, obs_dim), np.float32),
        draw_noise=lambda generator, n: torch.randn((n, act_dim), generator=generator, device=generator.device),
        device=device,
        name=str(cfg.select("algo.name", "sac")),
    )


class _DV3Step(nn.Module):
    """The world model and actor as one module, so a single
    ``functional_call`` binds both to the served parameters: ``forward``
    is one recurrent player step (``kind="step"``) or the initial state
    (``kind="init"``)."""

    def __init__(self, wm: nn.Module, actor: nn.Module, cnn_keys, is_continuous: bool, act_total: int):
        super().__init__()
        self.wm, self.actor = wm, actor
        self.cnn_keys, self.is_continuous, self.act_total = tuple(cnn_keys), bool(is_continuous), int(act_total)

    def forward(self, kind: str, *args):
        from ..algos.dreamer_v3.agent import sample_actor_actions
        from ..algos.dreamer_v3.utils import normalize_obs

        if kind == "init":
            (n,) = args
            h0, z0 = self.wm.rssm.initial_states((n,))
            return h0.contiguous(), z0, torch.zeros(n, self.act_total, device=h0.device)
        obs, (h, z, a), noise, greedy = args
        embedded = self.wm.embed(normalize_obs(obs, self.cnn_keys))
        h = self.wm.rssm.recurrent_model(torch.cat([z, a], dim=-1), h)
        z = self.wm.rssm.representation_step(h, embedded, noise["repr"])
        pre = self.actor(torch.cat([z, h], dim=-1))
        acts, _ = sample_actor_actions(self.actor, pre, noise["act"], None, greedy)
        a = torch.cat(acts, dim=-1)
        env_actions = a if self.is_continuous else torch.stack([torch.argmax(x, dim=-1) for x in acts], dim=-1)
        return env_actions, (h, z, a)


@register_policy_builder("dreamer_v3")
def build_dreamer_v3_policy(cfg: Any, observation_space: Any, action_space: Any) -> PolicyCore:
    from ..algos.dreamer_v3.agent import build_agent
    from ..algos.dreamer_v3.dreamer_v3 import _actions_dim
    from ..distributions import gumbel_noise
    from ..envs import spaces

    device = _device_and_tf32(cfg)
    actions_dim = _actions_dim(action_space)
    is_continuous = isinstance(action_space, spaces.Box)
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    wm, actor, _, _ = build_agent(cfg, observation_space, actions_dim, is_continuous, device)
    step = _DV3Step(wm.float(), actor.float(), cnn_keys, is_continuous, sum(actions_dim)).requires_grad_(False)
    stoch = (int(cfg.algo.world_model.stochastic_size), int(cfg.algo.world_model.discrete_size))

    def apply(params, obs, state, noise, greedy):
        # one recurrent player step, batch-shape agnostic (cf. make_player,
        # which fixes num_envs at build)
        return functional_call(step, _flat(params), ("step", obs, state, noise, greedy))

    def init_state(params, n: int):
        return functional_call(step, _flat(params), ("init", int(n)))

    def draw_noise(generator: torch.Generator, n: int) -> Dict[str, Any]:
        dev = generator.device
        if is_continuous:
            act = [torch.randn((n, int(sum(actions_dim))), generator=generator, device=dev)]
        else:
            act = [gumbel_noise((n, int(a)), generator, dev) for a in actions_dim]
        return {"repr": gumbel_noise((n, *stoch), generator, dev), "act": act}

    prepare, dummy_obs = _obs_fns(observation_space, cnn_keys, mlp_keys)
    return PolicyCore(
        apply=apply,
        extract_params=lambda state: {"wm": state["wm"], "actor": state["actor"]},
        prepare=prepare,
        dummy_obs=dummy_obs,
        draw_noise=draw_noise,
        device=device,
        init_state=init_state,
        name="dreamer_v3",
        tol=DV3_SERVE_TOL,
    )
