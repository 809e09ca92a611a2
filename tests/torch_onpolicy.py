"""Shared set-up of the on-policy parity tests (tests/test_torch_ppo.py,
test_torch_a2c.py, test_torch_ppo_recurrent.py): the JAX package's and the
port's configs for one experiment, small agents on both sides from the same
converted parameters, the JAX update's own permutation draws, and random
rollout batches made from a numpy seed."""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sheeprl_tpu.algos.ppo import agent as jagent
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu_torch import convert
from sheeprl_tpu_torch.algos.ppo import agent as tagent
from sheeprl_tpu_torch.config import compose as torch_compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.utils.checkpoint import CheckpointManager

IMG = (64, 64, 3)
STATE = 6
WIDTHS = dict(cnn_features_dim=32, mlp_features_dim=16, dense_units=16, mlp_layers=2)


def agents(pixels: bool, actions_dim, continuous: bool, layer_norm: bool = False, seed: int = 0):
    """The JAX agent's module and parameters, and the port's agent with them."""
    keys = (("rgb",) if pixels else ()), ("state",)
    jm = jagent.PPOAgent(actions_dim=tuple(actions_dim), is_continuous=continuous, cnn_keys=keys[0], mlp_keys=keys[1],
                         layer_norm=layer_norm, **WIDTHS)
    dummy = {k: jnp.asarray(v) for k, v in obs_batch(np.random.default_rng(0), (1,), pixels).items()}
    params = numpy_tree(jm.init(jax.random.PRNGKey(seed), dummy)["params"])
    ta = tagent.PPOAgent(obs_space(pixels), actions_dim, continuous, cnn_keys=keys[0], mlp_keys=keys[1],
                         layer_norm=layer_norm, **WIDTHS)
    convert.load_ppo(params, ta)
    return jm, params, ta


def configs(exp: str, overrides: Sequence[str] = ()):
    """(JAX cfg, port cfg) of ``exp`` with the same overrides."""
    return jax_compose("config", [f"exp={exp}", *overrides]), torch_compose("config", [f"exp={exp}", *overrides])


def obs_space(pixels: bool, vector: bool = True):
    d = {}
    if pixels:
        d["rgb"] = spaces.Box(0, 255, IMG, np.uint8)
    if vector:
        d["state"] = spaces.Box(-20, 20, (STATE,), np.float32)
    return spaces.Dict(d)


def obs_batch(rng: np.random.Generator, lead: Sequence[int], pixels: bool,
              vector: bool = True) -> Dict[str, np.ndarray]:
    out = {}
    if pixels:
        out["rgb"] = rng.integers(0, 256, (*lead, *IMG), dtype=np.uint8)
    if vector:
        out["state"] = rng.standard_normal((*lead, STATE)).astype(np.float32)
    return out


def numpy_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def jax_perms(key, epochs: int, batch: int) -> np.ndarray:
    """The permutations the JAX update draws from ``key`` (one split per
    epoch, ``permutation`` of the second half)."""
    out = []
    for _ in range(epochs):
        key, pk = jax.random.split(key)
        out.append(np.asarray(jax.random.permutation(pk, batch)))
    return np.stack(out)


def jax_coefs(coefs: Dict[str, float]):
    return {k: jnp.asarray(v, jnp.float32) for k, v in coefs.items()}


def torch_coefs(coefs: Dict[str, float]):
    out = {k: torch.tensor(v, dtype=torch.float32) for k, v in coefs.items() if k != "lr_frac"}
    out["lr_frac"] = float(coefs.get("lr_frac", 1.0))
    return out


def rollout_data(rng: np.random.Generator, batch: int, actions_dim: List[int], continuous: bool, pixels: bool,
                 lead: Sequence[int] = ()) -> Dict[str, np.ndarray]:
    """A random flattened rollout batch in the update's layout."""
    shape = (*lead, batch) if lead else (batch,)
    data = {f"obs:{k}": v for k, v in obs_batch(rng, shape, pixels).items()}
    if continuous:
        data["actions"] = rng.uniform(-1, 1, (*shape, sum(actions_dim))).astype(np.float32)
    else:
        data["actions"] = np.stack([rng.integers(0, d, shape) for d in actions_dim], -1).astype(np.float32)
    data["logprobs"] = (-1.0 + 0.3 * rng.standard_normal((*shape, 1))).astype(np.float32)
    data["values"] = rng.standard_normal((*shape, 1)).astype(np.float32)
    data["returns"] = rng.standard_normal((*shape, 1)).astype(np.float32)
    data["advantages"] = rng.standard_normal((*shape, 1)).astype(np.float32)
    return data


def to_torch(data: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def assert_params_close(agent: torch.nn.Module, want: Dict[str, torch.Tensor], atol: float) -> float:
    """Every parameter of ``agent`` within ``atol`` of ``want``; returns the
    largest difference."""
    got = agent.state_dict()
    worst = 0.0
    for name, v in want.items():
        diff = float((got[name] - v).abs().max())
        worst = max(worst, diff)
        assert diff <= atol, (name, diff)
    return worst


def last_checkpoint(run_name: str, algo: str = "ppo"):
    """The newest checkpoint of a CLI run in this working directory."""
    ckpts = sorted(Path("logs/runs").glob(f"{algo}/*/{run_name}/version_0/checkpoint/ckpt_*.ckpt"),
                   key=lambda p: int(p.stem.split("_")[1]))
    return CheckpointManager.load(ckpts[-1])
