"""Shared set-up of the tests that hold the other algorithms on two gloo ranks
against the JAX package at ``fabric.devices=2``
(tests/test_torch_mesh_{offpolicy,dreamer,onpolicy,p2e}.py): a batch or a
draw cut to a rank's columns, the JAX package's two-device ``Distributed``,
the JAX package's Ratio ledger and the checkpoints a run wrote.

Unlike ``torch_mesh_worker`` (which the spawned ranks import), this module
imports JAX and the JAX package.
"""
from __future__ import annotations

import glob
from pathlib import Path
from typing import Any, Dict, Optional

import jax
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from sheeprl_tpu.utils.utils import Ratio as JaxRatio

WORLD = 2
NUM_ENVS = 4


def jax_dist():
    """The JAX package's single-controller mesh over two devices."""
    from sheeprl_tpu.parallel import Distributed

    return Distributed(devices=WORLD)


def cols(x: Any, axis: int, rank: int) -> np.ndarray:
    """Rank ``rank``'s column block of ``x`` along ``axis``."""
    return np.ascontiguousarray(W.columns(np.asarray(x), axis, rank, WORLD))


def tb_cols(x: Any, lead: int, T: int, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of a draw over ``T·B`` states flattened t-major
    (after ``lead`` leading axes)."""
    return np.ascontiguousarray(W._tb_columns(np.asarray(x), lead, T, rank, WORLD))


def to_numpy(tree: Any) -> Any:
    return jax.tree.map(lambda v: np.array(v.detach() if torch.is_tensor(v) else v), tree)


def jax_ledger(ratio_v: float, pretrain: int, starts: int, total: int, start: int = 0,
               ratio_state: Optional[Dict[str, Any]] = None) -> Dict[int, Any]:
    """{policy step: (gradient steps so far, Ratio state)}: the JAX package's
    off-policy loops call ``ratio(policy_step / world_size)`` once per
    vector-env step of ``NUM_ENVS`` steps from ``learning_starts`` (e.g.
    ``sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py:641``), here on the JAX
    package's own ``Ratio``."""
    ratio = JaxRatio(ratio_v, pretrain_steps=pretrain)
    if ratio_state is not None:
        ratio.load_state_dict(ratio_state)
    out, grads = {}, 0
    for step in range(start + NUM_ENVS, total + 1, NUM_ENVS):
        if step >= starts:
            grads += ratio(step / WORLD)
        out[step] = (grads, ratio.state_dict())
    return out


def checkpoints(tmp: Path, algo: str, run: str) -> Dict[int, Dict[str, Any]]:
    """{policy step: checkpoint} of a run under ``tmp/logs/runs``."""
    return {int(Path(p).stem.split("_")[1]): torch.load(p, weights_only=False)
            for p in glob.glob(str(Path(tmp) / f"logs/runs/{algo}/*/{run}/version_0/checkpoint/ckpt_*.ckpt"))}


def check_ledger(ckpts: Dict[int, Dict[str, Any]], ledger: Dict[int, Any], grads0: int = 0) -> None:
    """Each checkpoint's step, gradient steps, optimizer step count and
    Ratio state against the JAX ledger; both ranks' generators kept."""
    for step, s in ckpts.items():
        grads, ratio = ledger[step]
        assert s["policy_step"] == step
        assert s["grad_steps"] == grads0 + grads, step
        assert int(s["opt_states"]["step"]) == grads0 + grads, step
        assert s["ratio"]["_prev"] == pytest.approx(ratio["_prev"]), step
        assert s["world_size"] == WORLD and len(s["rank_generators"]) == WORLD


def rank_zero_alone(outs: Any) -> None:
    """A CLI run's two ranks: rank 0 alone printed the log dir; the run's
    collectives ran."""
    a, b = outs
    assert a["stdout"].count("log_dir=") == 1 and not b["stdout"]
    assert a["stats"]["all_reduce"] > 0


def tiny_dv3_trainer(overrides=(), devices: int = 1, mesh: Optional[Dict[str, Any]] = None):
    """``dreamer_tiny.make_trainer``'s JAX trainer (``TINY_DV3`` and
    ``overrides``: the train function, the parameters, the optimizer states
    and Moments) on ``Distributed(devices, mesh)``, with the flax init traced
    under one ``jax.jit`` (``torch_offpolicy.jit_build``: the same
    parameters, one compile instead of one per initializer); the
    Distributed last."""
    import gymnasium as gym

    from dreamer_tiny import N_ACT, TINY_DV3
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_optimizers, make_train_fn
    from sheeprl_tpu.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu.config import compose
    from sheeprl_tpu.parallel import Distributed
    from torch_offpolicy import jit_build

    cfg = compose("config", TINY_DV3 + list(overrides))
    dist = Distributed(devices=devices, mesh=mesh)
    obs_space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    wm, actor, critic, params = jit_build(lambda k: build_agent(dist, cfg, obs_space, [N_ACT], False, k),
                                          jax.random.key(0))
    txs, opt_states = build_optimizers(cfg, params)
    return make_train_fn(wm, actor, critic, txs, cfg, False, [N_ACT]), params, opt_states, init_moments(), dist
