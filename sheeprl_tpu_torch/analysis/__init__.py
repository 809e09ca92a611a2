"""Static analysis for the PyTorch port (`sheeprl_tpu_torch lint`).

The port's copy of the JAX package's rule engine (:mod:`.engine`) and its
catalogue (:mod:`.rules`): host-sync (with torch's syncs), rng-reuse and
pspec-literal (the torch counterparts of the JAX rules of those ids),
thread-shared-state, telemetry-schema-drift (against the port's
``telemetry/schema.py``), socket-timeout and hot-loop-emit. Suppress a line
with ``# lint: ok[<rule>] <reason>``.
"""
from __future__ import annotations

from .engine import Finding, ModuleContext, Rule, check_file, main, run_paths
from .rules import RULE_CLASSES, all_rules

__all__ = [
    "Finding",
    "ModuleContext",
    "Rule",
    "RULE_CLASSES",
    "all_rules",
    "check_file",
    "main",
    "run_paths",
]
