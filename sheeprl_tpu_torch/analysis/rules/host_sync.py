"""host-sync: no hidden device→host materializations in the training hot loops.

Every ``.item()`` / ``float(<tensor>)`` / ``np.asarray(metrics)`` inside a
per-step loop blocks the asynchronous CUDA stream: the host waits for the
card instead of queueing the next launches. The loops hold metrics as
device tensors until the log-cadence flush; this rule keeps them that way —
it fails on NEW syncs.

The port's copy of ``sheeprl_tpu/analysis/rules/host_sync.py``: everything
the JAX rule flags is flagged here with the same message, and torch's own
syncs are added:

* ``.tolist()`` (of anything but a numpy expression);
* ``torch.cuda.synchronize()`` and ``<stream or event>.synchronize()``;
* ``.cpu()`` / ``.numpy()`` of an expression that reads a metrics alias
  (``metrics["loss"].cpu()``, ``torch.stack(list(metrics.values())).cpu()``).

The action's ``.cpu()`` that every env step needs is not flagged, as the
JAX rule leaves ``np.asarray(actions)`` alone: only the train metrics
(``metrics`` and the names ``for k, v in metrics.items()`` binds) count.

Scope (deliberately narrow, to stay precise): statements inside a
``while``/``for`` loop of a hot function — one decorated with
``@register_algorithm`` or named ``*_loop`` (the JAX rule's test), or one of
the port's own loop holders (``PORT_LOOP_HOLDERS``), the functions and
methods the registered entry points hand their per-step loop to.

Exemptions: statements under an ``if`` gated on the log cadence
(``last_log`` / ``log_every`` / ``dry_run`` / ``last_checkpoint``), lines
carrying the legacy ``# host-sync: ok`` comment, and the engine-wide
``# lint: ok[host-sync]`` suppression.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..engine import Finding, ModuleContext, Rule

# names whose float() is host-side arithmetic, not a device sync
ALLOWED_FLOAT_ROOTS = {
    "cfg", "wm_cfg", "moments_cfg", "os", "np", "math", "time", "sys",
    "int", "float", "len", "state", "world_size", "deadline",
}
ASARRAY_FUNCS = {("np", "asarray"), ("jnp", "asarray"), ("np", "array"), ("jnp", "array")}
ALLOW_COMMENT = "# host-sync: ok"
CADENCE_NAMES = {"last_log", "log_every", "dry_run", "last_checkpoint"}
# roots of host (numpy) expressions: their .tolist() moves nothing off a device
HOST_ROOTS = {"np", "numpy"}

# The port's per-step loops that live outside a registered entry point or a
# ``*_loop`` function, by qualified name (``Class.method``; a nested def
# joins its parents' names): qualified name -> the loops it holds.
PORT_LOOP_HOLDERS: Dict[str, str] = {
    "OffPolicyLoop.run": (
        "the serial and overlapped loops of SAC, DroQ, SAC-AE, DreamerV1/V2 and the "
        "Plan2Explore phases (algos/sac/sac.py)"
    ),
    "OffPolicyLoop.run_fleet": "the actor fleet's learner loop of the off-policy family (algos/sac/sac.py)",
    "run_serial": (
        "the DreamerV1/V2 and Plan2Explore loop set-up and its per-step `interact` "
        "(algos/dreamer_v2/dreamer_v2.py, algos/p2e_dv3/p2e_dv3_exploration.py)"
    ),
    "run_dreamer": "DreamerV1's and V2's entry into `run_serial` (algos/dreamer_v2/dreamer_v2.py)",
    "Rollout.__call__": "the rollout of PPO, A2C and the decoupled PPO player (algos/ppo/ppo.py)",
    "_Player.run": "the decoupled SAC player (algos/sac/sac_decoupled.py)",
    "OverlapEngine._player_main": "the overlapped loops' player thread (engine/overlap.py)",
}


def root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def is_hot_entrypoint(fn: ast.FunctionDef, qualname: Optional[str] = None) -> bool:
    """A registered train loop, a ``*_loop`` thread/worker entry, or one of
    the port's loop holders (``qualname`` in ``PORT_LOOP_HOLDERS``) — the
    functions whose loop bodies are the per-step hot path."""
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = target.attr if isinstance(target, ast.Attribute) else getattr(target, "id", "")
        if name == "register_algorithm":
            return True
    return fn.name.endswith("_loop") or (qualname or fn.name) in PORT_LOOP_HOLDERS


def hot_functions(tree: ast.AST) -> List[Tuple[ast.FunctionDef, str]]:
    """Every hot function of a module (nested ones too), with its qualified name."""
    found: List[Tuple[ast.FunctionDef, str]] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                if isinstance(child, ast.FunctionDef) and is_hot_entrypoint(child, qual):
                    found.append((child, qual))
                visit(child, qual)
            else:
                visit(child, prefix)

    visit(tree, "")
    return found


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)} | {
        n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)
    }


class _HotLoopChecker(ast.NodeVisitor):
    def __init__(self, path: Path, source_lines: List[str]):
        self.path = path
        self.lines = source_lines
        self.violations: List[Tuple[Path, int, str]] = []
        self.loops_seen = 0  # loops entered: the coverage test reads it
        self._loop_depth = 0
        self._cadence_depth = 0  # inside a log/ckpt-cadence `if`
        self._metrics_aliases: Set[str] = {"metrics"}

    # -- scope plumbing ----------------------------------------------------
    def visit_loop(self, node: ast.AST) -> None:
        self.loops_seen += 1
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_While = visit_loop

    def visit_If(self, node: ast.If) -> None:
        cadence = bool(_names_in(node.test) & CADENCE_NAMES)
        if cadence:
            self._cadence_depth += 1
        self.generic_visit(node)
        if cadence:
            self._cadence_depth -= 1

    def _track_metrics_alias(self, node: ast.For) -> None:
        """`for k, v in metrics.items():` makes `v` a metrics alias."""
        it = node.iter
        if (
            isinstance(it, ast.Call)
            and isinstance(it.func, ast.Attribute)
            and it.func.attr == "items"
            and root_name(it.func.value) in self._metrics_aliases
        ):
            for t in ast.walk(node.target):
                if isinstance(t, ast.Name):
                    self._metrics_aliases.add(t.id)

    # -- the checks --------------------------------------------------------
    def _allowed_line(self, lineno: int) -> bool:
        line = self.lines[lineno - 1] if lineno - 1 < len(self.lines) else ""
        return ALLOW_COMMENT in line

    def _flag(self, node: ast.AST, msg: str) -> None:
        if self._loop_depth == 0 or self._cadence_depth > 0:
            return
        if self._allowed_line(node.lineno):
            return
        self.violations.append((self.path, node.lineno, msg))

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        # <expr>.item()
        if isinstance(fn, ast.Attribute) and fn.attr == "item" and not node.args:
            self._flag(node, ".item() host sync in a hot loop")
        # float(<device expr>)
        if isinstance(fn, ast.Name) and fn.id == "float" and node.args:
            arg = node.args[0]
            if not isinstance(arg, ast.Constant) and root_name(arg) not in ALLOWED_FLOAT_ROOTS:
                self._flag(node, f"float({ast.unparse(arg)}) host sync in a hot loop")
        # np.asarray(metrics) / np.asarray(v) with v from metrics.items()
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            if (fn.value.id, fn.attr) in ASARRAY_FUNCS and node.args:
                root = root_name(node.args[0])
                if root in self._metrics_aliases:
                    self._flag(
                        node,
                        f"{fn.value.id}.{fn.attr}({ast.unparse(node.args[0])}) materializes "
                        "train metrics per step (defer to the log-cadence flush)",
                    )
        if isinstance(fn, ast.Attribute) and not node.args:
            recv = ast.unparse(fn.value)
            # <tensor>.tolist()
            if fn.attr == "tolist" and root_name(fn.value) not in HOST_ROOTS:
                self._flag(node, f"{recv}.tolist() host sync in a hot loop")
            # torch.cuda.synchronize() / <stream or event>.synchronize()
            elif fn.attr == "synchronize":
                self._flag(node, f"{recv}.synchronize() blocks the host on the device in a hot loop")
            # metrics[...].cpu() / v.numpy() with v from metrics.items() /
            # torch.stack(list(metrics.values())).cpu()
            elif fn.attr in ("cpu", "numpy") and {
                n.id for n in ast.walk(fn.value) if isinstance(n, ast.Name)
            } & self._metrics_aliases:
                self._flag(
                    node,
                    f"{recv}.{fn.attr}() materializes train metrics per step "
                    "(defer to the log-cadence flush)",
                )
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:  # noqa: N802 — ast API
        self._track_metrics_alias(node)
        self.visit_loop(node)


def scan_hot_function(path: Path, lines: List[str], fn: ast.FunctionDef) -> _HotLoopChecker:
    checker = _HotLoopChecker(path, lines)
    for stmt in fn.body:
        checker.visit(stmt)
    return checker


def _check_tree(path: Path, lines: List[str], tree: ast.Module) -> List[Tuple[Path, int, str]]:
    out: List[Tuple[Path, int, str]] = []
    for fn, _qual in hot_functions(tree):
        out.extend(scan_hot_function(path, lines, fn).violations)
    return out


class HostSyncRule(Rule):
    """Hidden device→host sync (.item()/float()/.tolist()/synchronize()/metrics .cpu()) in a hot loop."""

    rule_id = "host-sync"

    def check_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        for path, lineno, msg in _check_tree(ctx.path, ctx.lines, ctx.tree):
            yield Finding(
                self.rule_id,
                str(path),
                lineno,
                msg,
                remediation=(
                    "hold the value as a device ref until the log-cadence flush, or "
                    "annotate the line with `# host-sync: ok (<cadence>)`"
                ),
            )
