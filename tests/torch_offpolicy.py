"""Shared set-up of the off-policy parity tests (tests/test_torch_sac.py,
test_torch_droq.py, test_torch_sac_ae.py): the JAX package's and the port's
configs for one experiment at small widths, the spaces both sides build
from, random replay batches made from a numpy seed, the JAX updates' own
noise draws, flax's dropout masks recorded as the JAX critic draws them,
and the comparisons of parameters, targets and Adam states.

Run as a script, it prints the largest differences the off-policy parity
tests see (the values their docstrings state as measured):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_offpolicy.py
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, List, Sequence

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import torch

from sheeprl_tpu_torch import convert
from sheeprl_tpu_torch.envs import spaces
from torch_onpolicy import configs, numpy_tree  # noqa: F401 - re-exported for the off-policy tests

STATE = 6
ACT = 2
LOW, HIGH = np.array([-1.0, -2.0], np.float32), np.array([1.0, 0.5], np.float32)  # scale and bias both matter
IMG = (64, 64, 3)
SMALL = ["algo.hidden_size=32", "algo.per_rank_batch_size=8", "env.num_envs=2"]


def jax_spaces(pixels: bool = False, vector: bool = True):
    d = {}
    if pixels:
        d["rgb"] = gym.spaces.Box(0, 255, IMG, np.uint8)
    if vector:
        d["state"] = gym.spaces.Box(-20, 20, (STATE,), np.float32)
    return gym.spaces.Dict(d), gym.spaces.Box(LOW, HIGH, (ACT,), np.float32)


def torch_spaces(pixels: bool = False, vector: bool = True):
    d = {}
    if pixels:
        d["rgb"] = spaces.Box(0, 255, IMG, np.uint8)
    if vector:
        d["state"] = spaces.Box(-20, 20, (STATE,), np.float32)
    return spaces.Dict(d), spaces.Box(LOW, HIGH, (ACT,), np.float32)


def dist():
    from sheeprl_tpu.parallel import Distributed

    return Distributed(devices=1)


def replay_batch(rng: np.random.Generator, lead: Sequence[int], obs: Dict[str, Sequence[int]] = None,
                 vector_obs: bool = True) -> Dict[str, np.ndarray]:
    """A random ``[*lead, ...]`` replay batch: flattened ``observations`` and
    ``next_observations`` (SAC, DroQ) or per-key observations and their
    ``next_`` twins (``obs``: key → item shape; uint8 for images), actions
    within the bounds, rewards, ``terminated`` and ``dones``."""
    lead = tuple(lead)
    out: Dict[str, np.ndarray] = {}
    if vector_obs:
        for k in ("observations", "next_observations"):
            out[k] = rng.standard_normal((*lead, STATE)).astype(np.float32)
    for k, shape in (obs or {}).items():
        for name in (k, f"next_{k}"):
            if len(shape) == 3:
                out[name] = rng.integers(0, 256, (*lead, *shape), dtype=np.uint8)
            else:
                out[name] = rng.standard_normal((*lead, *shape)).astype(np.float32)
    out["actions"] = rng.uniform(LOW, HIGH, (*lead, ACT)).astype(np.float32)
    out["rewards"] = rng.standard_normal((*lead, 1)).astype(np.float32)
    out["terminated"] = (rng.random((*lead, 1)) < 0.3).astype(np.float32)
    out["dones"] = np.maximum(out["terminated"], (rng.random((*lead, 1)) < 0.2).astype(np.float32))
    return out


def to_jax(batch: Dict[str, np.ndarray]):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: Dict[str, np.ndarray]):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def sac_keys(keys, batch: int):
    """The standard normals SAC's JAX step draws from each step key: the
    target action's from ``split(key)[1]``, the actor's from
    ``fold_in(split(key)[0], 1)``; ``[G, 2, B, ACT]``."""
    out = []
    for k in keys:
        k, k1 = jax.random.split(k)
        out.append([np.asarray(jax.random.normal(k1, (batch, ACT))),
                    np.asarray(jax.random.normal(jax.random.fold_in(k, 1), (batch, ACT)))])
    return torch.from_numpy(np.asarray(out))


@contextmanager
def recorded_dropout(monkeypatch):
    """Record every flax dropout mask as the JAX package draws it (run the
    JAX side under ``jax.disable_jit()``: the masks arrive in program order,
    a vmapped call's members one by one), with dropout running wherever a
    ``Dropout`` has a rate: flax's ``nn.vmap`` drops the
    ``deterministic=False`` the JAX package passes (it warns "kwargs are not
    supported in vmap"), so the vmapped DroQ critic would otherwise run
    without dropout; the masks are drawn as flax draws them, from the same
    rng stream."""
    import flax.linen as nn
    import flax.linen.stochastic as stochastic

    masks: List[np.ndarray] = []
    real = stochastic.random

    class Recording:
        def __getattr__(self, name):
            return getattr(real, name)

        def bernoulli(self, key, p, shape):
            m = real.bernoulli(key, p=p, shape=shape)
            jax.debug.callback(lambda x: masks.append(np.asarray(x)), m)
            return m

    class Honored(nn.Dropout):
        @nn.compact
        def __call__(self, inputs, deterministic=None, rng=None):
            if self.rate == 0.0:
                return inputs
            keep = 1.0 - self.rate
            mask = stochastic.random.bernoulli(self.make_rng(self.rng_collection), p=keep, shape=inputs.shape)
            return jax.lax.select(mask, inputs / keep, jnp.zeros_like(inputs))

    with monkeypatch.context() as m:  # undone when the block ends
        m.setattr(stochastic, "random", Recording())
        m.setattr(nn, "Dropout", Honored)
        yield masks


def split_masks(masks: List[np.ndarray], n: int, layers: int) -> List[List[torch.Tensor]]:
    """Recorded masks, call by call, as the port's ``[n, B, h]`` per layer."""
    per_call = n * layers
    assert len(masks) % per_call == 0, len(masks)
    out = []
    for c in range(len(masks) // per_call):
        chunk = masks[c * per_call:(c + 1) * per_call]
        out.append([torch.from_numpy(np.stack(chunk[l * n:(l + 1) * n])) for l in range(layers)])
    return out


def _check(got: torch.Tensor, want: torch.Tensor, tol: float, what, outliers=None) -> float:
    """|got - want| within ``tol``; with ``outliers = (share, cap)`` at most
    that share of the elements may exceed it, each within ``cap``. Returns
    the largest difference."""
    diff = (got - want).abs()
    worst = float(diff.max()) if diff.numel() else 0.0
    if outliers is None:
        assert worst <= tol, (what, worst)
    else:
        share, cap = outliers
        over = float((diff > tol).float().mean())
        assert over <= share and worst <= cap, (what, over, worst)
    return worst


def max_diff(module: torch.nn.Module, params: Any, atol: float, what: str = "", outliers=None) -> float:
    """Every parameter of ``module`` within ``atol`` of the flax tree
    ``params`` (see ``_check`` for ``outliers``); returns the largest
    difference."""
    want = convert.params_to_state_dict(numpy_tree(params), module)
    got = module.state_dict()
    return max(_check(got[name], v, atol, (what, name), outliers) for name, v in want.items())


def adam_diff(optimizer: torch.optim.Optimizer, module: torch.nn.Module, opt_state: Any, rtol: float,
              what: str = "", outliers=None) -> float:
    """The port's Adam state of ``module``'s parameters against optax's: the
    count equal, each moment within ``rtol`` of the largest magnitude of its
    tensor (a moment is a running mean of gradients, whose f32 error scales
    with their size; ``outliers`` as in ``_check``, in the same units);
    returns the largest such relative difference."""
    adam = convert.find_state(numpy_tree(opt_state))
    mu = convert.params_to_state_dict(adam.mu, module)
    nu = convert.params_to_state_dict(adam.nu, module)
    worst = 0.0
    for name, p in module.named_parameters():
        st = optimizer.state[p]
        assert int(st["step"]) == int(adam.count), (what, name, int(st["step"]), int(adam.count))
        for got, want in ((st["exp_avg"], mu[name]), (st["exp_avg_sq"], nu[name])):
            scale = max(float(want.abs().max()), 1e-30)
            worst = max(worst, _check(got / scale, want / scale, rtol, (what, name), outliers))
    return worst


def assert_losses(t_metrics: Dict[str, torch.Tensor], j_metrics: Dict[str, Any], rtol: float) -> None:
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(t_metrics[k]), float(v), rtol=rtol, atol=1e-6, err_msg=k)


def within(a: Dict[str, Any], b: Dict[str, Any], path: str = "algo") -> None:
    """The port's config section ``a`` is ``b``'s restricted to the keys the
    port reads (the port's optimizer targets for the JAX package's)."""
    for k, v in a.items():
        assert k in b, f"{path}.{k}"
        if isinstance(v, dict):
            within(v, b[k], f"{path}.{k}")
        elif isinstance(v, str) and v.startswith("sheeprl_tpu_torch."):
            assert v.replace("sheeprl_tpu_torch.", "sheeprl_tpu.", 1) == b[k], (f"{path}.{k}", v, b[k])
        else:
            assert v == b[k], (f"{path}.{k}", v, b[k])


REPORT_MODULES = ("test_torch_sac", "test_torch_droq", "test_torch_sac_ae")
REPORT_SKIP = ("cli", "loops", "fleet", "refused", "compose", "lunar", "repeat", "jax_packages_vmapped")


def report(modules=REPORT_MODULES, skip=REPORT_SKIP) -> None:
    """Print, for each parity test case of ``modules`` (by default
    tests/test_torch_sac.py, test_torch_droq.py and test_torch_sac_ae.py;
    not the CLI runs, nor a test whose name holds one of ``skip``), the
    largest absolute and relative difference its ``np.testing.assert_allclose``
    calls compared, the largest parameter difference and share of elements
    beyond tolerance, and the largest relative difference of the Adam
    moments: the "measured" values the tests' docstrings state."""
    import collections
    import importlib
    import inspect
    import os
    import tempfile

    import pytest

    worst = collections.defaultdict(lambda: collections.defaultdict(float))
    case = [""]
    assert_allclose = np.testing.assert_allclose

    def recording(actual, desired, rtol=1e-7, atol=0, **kw):
        a, d = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
        diff = np.abs(a - d)
        if diff.size:
            w = worst[case[0]]
            w["max_abs"] = max(w["max_abs"], float(diff.max()))
            w["max_rel"] = max(w["max_rel"], float((diff / np.maximum(np.abs(d), 1e-30)).max()))
        return assert_allclose(actual, desired, rtol=rtol, atol=atol, **kw)

    import torch_offpolicy as helper  # the module the tests import (this file runs as __main__)

    check = helper._check
    in_adam = [False]

    def recording_check(got, want, tol, what, outliers=None):
        diff = (got - want).abs()
        if diff.numel():
            w = worst[case[0]]
            # adam_diff compares moments scaled by their tensor's largest magnitude
            key = "moments_rel" if in_adam[0] else "params_abs"
            w[f"{key}_max"] = max(w[f"{key}_max"], float(diff.max()))
            w[f"{key}_share_over_tol"] = max(w[f"{key}_share_over_tol"], float((diff > tol).float().mean()))
        return check(got, want, tol, what, outliers)

    adam = helper.adam_diff

    def recording_adam(*args, **kwargs):
        in_adam[0] = True
        try:
            return adam(*args, **kwargs)
        finally:
            in_adam[0] = False

    np.testing.assert_allclose = recording
    helper._check = recording_check
    cwd = os.getcwd()
    for name in modules:
        mod = importlib.import_module(name)
        mod.adam_diff = recording_adam
        for fname, fn in inspect.getmembers(mod, inspect.isfunction):
            if not fname.startswith("test_") or fn.__module__ != name or any(s in fname for s in skip):
                continue
            combos = [()]
            for mark in getattr(fn, "pytestmark", []):
                if mark.name == "parametrize":
                    vals = list(mark.args[1])
                    combos = [v if isinstance(v, tuple) else (v,) for v in vals]
            takes_mp = "monkeypatch" in inspect.signature(fn).parameters
            for combo in combos:
                case[0] = f"{name}::{fname}" + (f"[{'-'.join(map(str, combo))}]" if combo else "")
                with tempfile.TemporaryDirectory() as tmp:
                    os.chdir(tmp)
                    mp = pytest.MonkeyPatch()
                    try:
                        fn(*((mp,) if takes_mp else ()), *combo)
                    finally:
                        mp.undo()
                        os.chdir(cwd)
    for k, w in sorted(worst.items()):
        print(f"{k}: " + " ".join(f"{n}={v:.3g}" for n, v in sorted(w.items())))


if __name__ == "__main__":
    report()
