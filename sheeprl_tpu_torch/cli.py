"""Command-line entry point of the PyTorch port:
``python -m sheeprl_tpu_torch run exp=dreamer_v3 env=dummy algo.overlap.enabled=False ...``.

``run`` composes the config from ``sheeprl_tpu_torch/configs``, looks the
algorithm up in the registry and calls its ``main(cfg)``. Only ``run`` is
ported; evaluation, resume and the serving commands wait for later slices.
"""
from __future__ import annotations

import importlib
import sys
from typing import Optional, Sequence

from .config import Config, compose
from .utils.registry import get_algorithm

# modules whose import registers an algorithm
ALGORITHM_MODULES = ("sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3",)


def run_algorithm(cfg: Config) -> None:
    for mod in ALGORITHM_MODULES:
        importlib.import_module(mod)
    if cfg.select("algo.name") is None:
        raise ValueError("Missing `algo.name`: select an experiment with `exp=<name>`")
    entry = get_algorithm(cfg.algo.name)
    entry["fn"](cfg)


def run(args: Optional[Sequence[str]] = None) -> None:
    """``run [exp=... key=value ...]``: compose and train."""
    argv = list(args if args is not None else sys.argv[1:])
    run_algorithm(compose("config", argv))


def main() -> None:
    argv = sys.argv[1:]
    cmd, rest = (argv[0], argv[1:]) if argv and "=" not in argv[0] else ("run", argv)
    if cmd != "run":
        raise SystemExit(f"unknown command {cmd!r}: the PyTorch port has `run` only")
    run(rest)
