#!/usr/bin/env python3
"""Largest differences between the PyTorch port's on-policy algorithms and
the JAX package's, as the CPU parity tests see them.

Runs every parity test of tests/test_torch_ppo.py, test_torch_a2c.py and
test_torch_ppo_recurrent.py (not the CLI runs) in this process and prints,
for each test case, the largest absolute and relative difference that its
``np.testing.assert_allclose`` calls compared, and the largest parameter
difference after an update; and how far ``torch.optim.RMSprop`` lands
from optax after one step at A2C's eps. These are the "measured" values the
tests' docstrings state beside their tolerances.

    JAX_PLATFORMS=cpu python scripts/onpolicy_parity_report.py
"""
import collections
import importlib
import inspect
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

import torch_onpolicy  # noqa: E402

MODULES = ("test_torch_ppo", "test_torch_a2c", "test_torch_ppo_recurrent")
SKIP = ("cli", "loops", "fleet", "refuses", "misses", "truncation", "compose", "reset", "to_seq")


def main() -> None:
    worst = collections.defaultdict(lambda: [0.0, 0.0])
    case = [""]
    assert_allclose = np.testing.assert_allclose

    def recording(actual, desired, rtol=1e-7, atol=0, **kw):
        a, d = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
        diff = np.abs(a - d)
        if diff.size:
            w = worst[case[0]]
            w[0] = max(w[0], float(diff.max()))
            w[1] = max(w[1], float((diff / np.maximum(np.abs(d), 1e-30)).max()))
        return assert_allclose(actual, desired, rtol=rtol, atol=atol, **kw)

    params_close = torch_onpolicy.assert_params_close

    def recording_params(agent, want, atol):
        diff = params_close(agent, want, atol)
        worst[case[0] + " parameters"][0] = max(worst[case[0] + " parameters"][0], diff)
        return diff

    np.testing.assert_allclose = recording
    for name in MODULES:
        mod = importlib.import_module(name)
        mod.assert_params_close = recording_params
        for fname, fn in inspect.getmembers(mod, inspect.isfunction):
            if not fname.startswith("test_") or fn.__module__ != name or any(s in fname for s in SKIP):
                continue
            params = [None]
            for mark in getattr(fn, "pytestmark", []):
                if mark.name == "parametrize":
                    params = list(mark.args[1])
            for p in params:
                case[0] = f"{name}::{fname}" + ("" if p is None else f"[{p}]")
                fn() if p is None else fn(p)
    for k, (a, r) in sorted(worst.items()):
        print(f"{k}: max_abs={a:.3g} max_rel={r:.3g}")
    import torch

    got, want, _ = importlib.import_module("test_torch_a2c")._rmsprop_runs(torch.optim.RMSprop, steps=1)
    diff = np.abs(got - want)
    print(f"torch.optim.RMSprop against optax.rmsprop, one step: max_abs={diff.max():.3g} "
          f"max_rel={(diff / np.abs(want)).max():.3g}")


if __name__ == "__main__":
    main()
