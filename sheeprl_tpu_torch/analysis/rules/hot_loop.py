"""hot-loop-emit: no unsampled telemetry writes in the per-step hot loops.

One ``telem.emit({...})`` / ``sink.write({...})`` per training step writes a
JSON line (and, with the live relay attached, buffers a relay copy) every
few milliseconds: the stream balloons, rotation churns, and the relay's
bounded buffer overflows into counted drops — all for events no window ever
needs at per-step resolution. The in-loop telemetry surfaces are cadenced by
design (``telem.log(policy_step)`` flushes on the log cadence; interval
records ride ``stats_every_s``); this rule keeps NEW emissions on that
pattern.

Scope (the same hot functions as ``host-sync``): statements inside a
``while``/``for`` loop of a function decorated with ``@register_algorithm``
or named ``*_loop`` (decoupled player loops, the fleet worker loop), or of
one of the port's loop holders (``host_sync.PORT_LOOP_HOLDERS``).

Flagged: ``<recv>.emit(...)`` on any receiver, bare ``emit(...)`` /
``_emit(...)`` calls, and ``<recv>.write(...)`` where the receiver smells
like a telemetry sink (``sink`` / ``jsonl`` / ``telem`` in the name).

Exemptions: statements under an ``if`` whose test reads a cadence/sampling
name (``*_every*`` / ``last_*`` / ``*cadence*`` / ``*sample*`` /
``log_every`` / ``dry_run`` ...), and the engine-wide
``# lint: ok[hot-loop-emit]`` suppression (state the cadence in the
reason).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterator, List, Set, Tuple

from ..engine import Finding, ModuleContext, Rule
from .host_sync import hot_functions, root_name

# receiver-name fragments that mark a `.write(...)` as a telemetry write
SINK_HINTS = ("sink", "jsonl", "telem")
# a test mentioning any of these names (or name fragments) counts as a
# cadence/sampling gate — the emission is deliberate and bounded
CADENCE_FRAGMENTS = ("every", "last_", "_last", "cadence", "sample", "dry_run", "should_log")


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)} | {
        n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)
    }


def _is_cadence_test(test: ast.AST) -> bool:
    for name in _names_in(test):
        low = name.lower()
        if any(frag in low for frag in CADENCE_FRAGMENTS):
            return True
    return False


class _EmitChecker(ast.NodeVisitor):
    def __init__(self, path: Path):
        self.path = path
        self.violations: List[Tuple[Path, int, str]] = []
        self._loop_depth = 0
        self._cadence_depth = 0

    def visit_loop(self, node: ast.AST) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_While = visit_loop
    visit_For = visit_loop

    def visit_If(self, node: ast.If) -> None:
        cadence = _is_cadence_test(node.test)
        if cadence:
            self._cadence_depth += 1
        self.generic_visit(node)
        if cadence:
            self._cadence_depth -= 1

    def _flag(self, node: ast.AST, msg: str) -> None:
        if self._loop_depth == 0 or self._cadence_depth > 0:
            return
        self.violations.append((self.path, node.lineno, msg))

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr == "emit":
                recv = root_name(fn.value) or "?"
                self._flag(node, f"{recv}.emit(...) every step in a hot loop")
            elif fn.attr == "write":
                recv = root_name(fn.value) or ""
                if any(h in recv.lower() for h in SINK_HINTS):
                    self._flag(node, f"{recv}.write(...) every step in a hot loop")
        elif isinstance(fn, ast.Name) and fn.id in ("emit", "_emit"):
            self._flag(node, f"{fn.id}(...) every step in a hot loop")
        self.generic_visit(node)


def _check_tree(path: Path, tree: ast.Module) -> List[Tuple[Path, int, str]]:
    out: List[Tuple[Path, int, str]] = []
    for node, _qual in hot_functions(tree):
        checker = _EmitChecker(path)
        for stmt in node.body:
            checker.visit(stmt)
        out.extend(checker.violations)
    return out


class HotLoopEmitRule(Rule):
    """Unsampled telemetry emit/write on the per-step hot path."""

    rule_id = "hot-loop-emit"

    def check_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        for path, lineno, msg in _check_tree(ctx.path, ctx.tree):
            yield Finding(
                self.rule_id,
                str(path),
                lineno,
                msg,
                remediation=(
                    "gate the emission on a cadence (log_every / stats_every_s / "
                    "a *_sample counter) or annotate with "
                    "`# lint: ok[hot-loop-emit] <why it is bounded>`"
                ),
            )
