"""Pad-invariant act cores of the fleet's worker mode (the port's counterpart
of ``sheeprl_tpu/fleet/act_core.py``).

A worker acts for its env slots with a CPU copy of the policy. The classic
failure of batched acting is RNG shape coupling: a policy that draws one
batch-shaped noise tensor gives different per-row samples the moment the
batch is padded or coalesced. The cores make row ``i``'s action depend only
on the params, ``obs[i]``, ``state[i]`` and the slot by construction: every
env slot has a ``torch.Generator`` of its own (``slot_generators``: seeded
from the worker's seed and the slot), and ``draw_noise`` draws each row's
noise from its slot's generator alone. The JAX package gets the same
property from per-row keys (``fold_in(key, slot)``); threefry and Philox
never agree, so the parity tests hand both the noise the JAX keys draw.

A core's modules live on its ``device``: the CPU in a worker, the learner's
device in the batched act service (``fleet/act_service.py``), which runs the
same core through ``torch.func.functional_call`` on its own parameters.
A core exposes:

* ``modules`` — its modules by publication name;
* ``extract_params(params_np)`` — the acting subtree of a publication (a
  dict of module name → state dict of numpy arrays) loaded into the core's
  modules, which it returns;
* ``draw_noise(generators)`` — one row of noise per slot generator;
* ``act(params, obs, noise, state=None, mask=None)`` →
  ``(env_actions, actions_cat, new_state)`` (stateless cores return ``None``
  for the latter two);
* stateful cores (DreamerV3's ``(h, z, a)`` latents) add
  ``init_state(params, n)`` / ``reset_state(params, mask, state)``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["ActCore", "build_act_core", "load_modules", "slot_generators"]


def slot_generators(seed: int, n: int) -> List[torch.Generator]:
    """One CPU generator per env slot, seeded from ``(seed, slot)`` alone (the
    slot's child of the seed's ``SeedSequence``)."""
    out = []
    for slot in range(int(n)):
        ss = np.random.SeedSequence(int(seed), spawn_key=(slot,))
        out.append(torch.Generator().manual_seed(int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))))
    return out


def load_modules(modules: Dict[str, torch.nn.Module], params_np: Dict[str, Dict[str, np.ndarray]]) -> None:
    """Load a publication's state dicts (numpy arrays) into ``modules``."""
    with torch.no_grad():
        for name, module in modules.items():
            module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params_np[name].items()})


class ActCore:
    """Base surface; concrete cores fill in the callables."""

    name = "act"
    stateful = False

    def extract_params(self, params_np: Any) -> Any:
        return params_np

    def draw_noise(self, generators: Sequence[torch.Generator]) -> Any:
        raise NotImplementedError

    def act(self, params: Any, obs: Any, noise: Any, state: Any = None, mask: Any = None) -> Tuple[Any, Any, Any]:
        raise NotImplementedError

    def init_state(self, params: Any, n: int) -> Any:
        raise NotImplementedError(f"{self.name} is stateless")

    def reset_state(self, params: Any, mask: Any, state: Any) -> Any:
        raise NotImplementedError(f"{self.name} is stateless")


class _SacActCore(ActCore):
    """The tanh-Gaussian SAC actor, one standard normal per row."""

    name = "sac"
    stateful = False

    def __init__(self, cfg: Any, obs_space: Any, action_space: Any, device: Any = "cpu") -> None:
        from ..algos.sac.agent import build_actor

        self.device = torch.device(device)
        self.act_dim = int(np.prod(action_space.shape))
        obs_dim = int(sum(np.prod(obs_space[k].shape) for k in cfg.algo.mlp_keys.encoder))
        self.actor = build_actor(cfg, obs_dim, action_space, int(cfg.algo.actor.hidden_size)).float().to(self.device)
        self.actor.requires_grad_(False)
        self.modules = {"actor": self.actor}

    def extract_params(self, params_np: Any) -> Any:
        load_modules({"actor": self.actor}, params_np)
        return self.actor

    def draw_noise(self, generators: Sequence[torch.Generator]) -> torch.Tensor:
        return torch.stack([torch.randn((self.act_dim,), generator=g) for g in generators])

    @torch.no_grad()
    def act(self, params: Any, obs: Any, noise: Any, state: Any = None, mask: Any = None) -> Tuple[Any, Any, Any]:
        from ..algos.sac.agent import sample_actions

        mean, log_std = params(torch.as_tensor(np.asarray(obs, np.float32), device=self.device))
        actions, _ = sample_actions(params, mean, log_std, noise)
        return actions, None, None


class _DreamerActCore(ActCore):
    """The recurrent DreamerV3 player (``dreamer_v3.make_player``'s step) on
    the core's copy of the world model and actor; each row's representation
    and action draws come from its own slot's noise."""

    name = "dreamer_v3"
    stateful = True

    def __init__(self, cfg: Any, obs_space: Any, action_space: Any, device: Any = "cpu") -> None:
        from ..algos.dreamer_v3.agent import build_agent
        from ..algos.dreamer_v3.dreamer_v3 import _actions_dim, make_player
        from ..envs import spaces

        self.is_continuous = isinstance(action_space, spaces.Box)
        self.actions_dim = _actions_dim(action_space)
        self.act_total = int(sum(self.actions_dim))
        wm_cfg = cfg.algo.world_model
        self.stoch = (int(wm_cfg.stochastic_size), int(wm_cfg.discrete_size))
        # module definitions only: the parameters arrive with every publication
        self.device = torch.device(device)
        wm, actor, _, _ = build_agent(cfg, obs_space, self.actions_dim, self.is_continuous, self.device)
        self.modules = {"wm": wm.float(), "actor": actor.float()}
        for m in self.modules.values():
            m.requires_grad_(False)
        _, self._step = make_player(wm, actor, cfg, self.actions_dim, self.is_continuous, 1)

    def extract_params(self, params_np: Any) -> Any:
        load_modules(self.modules, params_np)
        return self.modules

    def draw_noise(self, generators: Sequence[torch.Generator]) -> Dict[str, Any]:
        from ..distributions import gumbel_noise

        repr_rows, act_rows = [], []
        for g in generators:
            repr_rows.append(gumbel_noise(self.stoch, generator=g))
            if self.is_continuous:
                act_rows.append([torch.randn((self.act_total,), generator=g)])
            else:
                act_rows.append([gumbel_noise((a,), generator=g) for a in self.actions_dim])
        return {"repr": torch.stack(repr_rows),
                "act": [torch.stack([row[i] for row in act_rows]) for i in range(len(act_rows[0]))]}

    def act(self, params: Any, obs: Any, noise: Any, state: Any = None, mask: Any = None) -> Tuple[Any, Any, Any]:
        return self._step(obs, state, noise=noise, modules=params, mask=mask)

    @torch.no_grad()
    def init_state(self, params: Any, n: int) -> Any:
        h0, z0 = params["wm"].rssm.initial_states((int(n),))
        return (h0.contiguous(), z0, torch.zeros(int(n), self.act_total, device=self.device))

    def reset_state(self, params: Any, mask: Any, state: Any) -> Any:
        m = torch.as_tensor(np.asarray(mask, bool), device=self.device)[:, None]
        fresh = self.init_state(params, m.shape[0])
        return tuple(torch.where(m, x0, x) for x0, x in zip(fresh, state))


_BUILDERS: Dict[str, Callable[..., ActCore]] = {
    "sac": _SacActCore,
    "dreamer_v3": _DreamerActCore,
}


def build_act_core(name: str, cfg: Any, obs_space: Any, action_space: Any, device: Any = "cpu") -> ActCore:
    """The act core of a fleet program (``sac`` / ``dreamer_v3``) with its
    modules on ``device`` (the workers' CPU, or the act service's device).
    PPO's strict on-policy rollouts act with the whole agent and have none."""
    if name not in _BUILDERS:
        raise ValueError(f"no act core for program '{name}' (batched acting supports: {sorted(_BUILDERS)})")
    return _BUILDERS[name](cfg, obs_space, action_space, device)
