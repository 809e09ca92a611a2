"""The rule engine behind `sheeprl_tpu_torch lint`.

The port's copy of ``sheeprl_tpu/analysis/engine.py``, with its contract
unchanged: a finding-producing pass over Python source; each file is parsed
once into an AST and wrapped in a :class:`ModuleContext` (source lines,
import/alias resolution, suppression comments); every registered
:class:`Rule` then walks the module and yields :class:`Finding` records
with a stable ``rule_id``, ``file:line`` anchor, severity and a remediation
hint.

Why AST and not runtime checks: the invariants these rules guard (no hidden
device syncs in the per-step loops, no draws from the process-wide
generator, no unlocked cross-thread writes, telemetry events matching
``telemetry/schema.py``) only *fail* under timing or scale a unit test
can't reach — a 10-minute bench or a production run. Lint time is the
cheapest place to catch them.

Suppression: a finding is silenced by ``# lint: ok[<rule-id>] <reason>`` on
the finding's line or on a standalone comment line directly above it.
``# lint: ok[*]`` silences every rule for that line. State the reason — the
comment is the audit trail for why the invariant is intentionally waived.

Output: human text (``path:line: [rule-id] message``) or ``--json``
(``{"version": 1, "findings": [...]}`` with the JAX package's keys). Exit
code 1 iff any unsuppressed finding remains, 2 on a usage error or a rule
the port does not have (``NOT_PORTED`` says why for the two JAX rules whose
subjects the port lacks).
"""
from __future__ import annotations

import ast
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(r"#\s*lint:\s*ok\[([A-Za-z0-9_*,\- ]+)\]\s*(.*)")


@dataclass
class Finding:
    """One rule violation, anchored to a file:line."""

    rule_id: str
    path: str
    line: int
    message: str
    severity: str = "error"
    remediation: str = ""

    def as_dict(self) -> Dict[str, object]:
        return {
            "rule_id": self.rule_id,
            "file": self.path,
            "line": self.line,
            "severity": self.severity,
            "message": self.message,
            "remediation": self.remediation,
        }

    def render(self) -> str:
        text = f"{self.path}:{self.line}: [{self.rule_id}] {self.severity}: {self.message}"
        if self.remediation:
            text += f"\n    fix: {self.remediation}"
        return text


class ModuleContext:
    """One parsed module + the name-resolution state every rule needs.

    ``dotted(node)`` canonicalizes an attribute chain through the module's
    import aliases: with ``import torch.distributed as tdist`` and
    ``from torch import cuda``, both ``tdist.new_group`` →
    ``torch.distributed.new_group`` and ``cuda.synchronize`` →
    ``torch.cuda.synchronize``. Function-level imports are
    folded into the same table — alias shadowing across scopes is rare
    enough in lint targets that one flat table keeps every rule simple.
    """

    def __init__(self, path: Path, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.aliases: Dict[str, str] = {}
        self._suppressions: Dict[int, Set[str]] = {}
        # cross-rule memo: a rule may cache a whole-module scan here
        self.cache: Dict[str, object] = {}
        self._collect_imports()
        self._collect_suppressions()

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"

    def _collect_suppressions(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            m = SUPPRESS_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self._suppressions.setdefault(i, set()).update(rules)

    # -- name resolution ---------------------------------------------------
    def dotted(self, node: Optional[ast.AST]) -> Optional[str]:
        """Resolve ``a.b.c`` through import aliases; None if not a pure
        Name/Attribute chain."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.aliases.get(node.id, node.id)
        return ".".join([base] + list(reversed(parts)))

    def call_dotted(self, call: ast.Call) -> Optional[str]:
        return self.dotted(call.func)

    # -- suppression -------------------------------------------------------
    def suppressed(self, rule_id: str, line: int) -> bool:
        for cand in (line, line - 1):
            rules = self._suppressions.get(cand)
            if rules is None:
                continue
            if cand == line - 1 and not self.lines[cand - 1].lstrip().startswith("#"):
                continue  # the line above only counts as a standalone comment
            if rule_id in rules or "*" in rules:
                return True
        return False


class Rule:
    """Base class: one invariant, one stable ``rule_id``."""

    rule_id: str = "abstract"
    severity: str = "error"
    # when non-empty, the rule only runs on files whose path contains one of
    # these directory names (e.g. the thread-race rule scopes itself to the
    # threaded subsystems)
    path_parts: Tuple[str, ...] = ()

    def applies(self, path: Path) -> bool:
        if not self.path_parts:
            return True
        parts = set(path.parts)
        return any(p in parts for p in self.path_parts)

    def check_module(self, ctx: ModuleContext) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError


# -- running -----------------------------------------------------------------


def iter_py_files(paths: Sequence[Path]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    return files


def check_file(path: Path, rules: Sequence[Rule]) -> List[Finding]:
    try:
        source = path.read_text()
    except OSError as err:
        return [Finding("io-error", str(path), 0, f"cannot read file: {err}")]
    try:
        tree = ast.parse(source)
    except SyntaxError as err:
        return [
            Finding("syntax-error", str(path), err.lineno or 0, f"syntax error: {err.msg}")
        ]
    ctx = ModuleContext(path, source, tree)
    findings: List[Finding] = []
    for rule in rules:
        if not rule.applies(path):
            continue
        for f in rule.check_module(ctx):
            if not ctx.suppressed(f.rule_id, f.line):
                findings.append(f)
    return findings


def run_paths(paths: Sequence[Path], rules: Sequence[Rule]) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(check_file(f, rules))
    findings.sort(key=lambda x: (x.path, x.line, x.rule_id))
    return findings


# -- CLI ---------------------------------------------------------------------


# the JAX package's rules that have no subject in the port: asked for by
# name, they are refused with this reason rather than as unknown
NOT_PORTED = {
    "retrace-hazard": (
        "the port compiles nothing: it has no torch.compile or torch.jit site, so no "
        "trace can be retaken"
    ),
    "use-after-donate": "eager torch does not donate buffers, so no argument is invalidated by a call",
}


def default_paths() -> List[Path]:
    return [Path(__file__).resolve().parent.parent]  # the sheeprl_tpu_torch package


def main(argv: Optional[Sequence[str]] = None) -> int:
    """`sheeprl_tpu_torch lint [paths...] [--json] [--rule r1,r2] [--list-rules]`."""
    from .rules import all_rules

    argv = list(sys.argv[1:] if argv is None else argv)
    json_out = False
    rule_filter: Optional[Set[str]] = None
    paths: List[Path] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--json":
            json_out = True
        elif arg == "--list-rules":
            for rule in all_rules():
                print(f"{rule.rule_id}: {(rule.__doc__ or '').strip().splitlines()[0]}")
            return 0
        elif arg == "--rule" or arg.startswith("--rule="):
            if "=" in arg:
                value = arg.split("=", 1)[1]
            else:
                i += 1
                if i >= len(argv):
                    print("--rule needs a comma-separated rule list", file=sys.stderr)
                    return 2
                value = argv[i]
            rule_filter = {r.strip() for r in value.split(",") if r.strip()}
        elif arg.startswith("-"):
            print(f"unknown flag {arg!r}", file=sys.stderr)
            return 2
        else:
            paths.append(Path(arg))
        i += 1

    rules = all_rules()
    if rule_filter is not None:
        refused = sorted(rule_filter & set(NOT_PORTED))
        if refused:
            for rule_id in refused:
                print(f"rule {rule_id!r} is not in the PyTorch port: {NOT_PORTED[rule_id]}", file=sys.stderr)
            return 2
        unknown = rule_filter - {r.rule_id for r in rules}
        if unknown:
            print(
                f"unknown rule(s) {sorted(unknown)}; known: {sorted(r.rule_id for r in rules)}",
                file=sys.stderr,
            )
            return 2
        rules = [r for r in rules if r.rule_id in rule_filter]

    scan = paths or default_paths()
    findings = run_paths(scan, rules)
    if json_out:
        print(json.dumps({"version": 1, "findings": [f.as_dict() for f in findings]}, indent=2))
    else:
        for f in findings:
            print(f.render())
        n_files = len(iter_py_files(scan))
        if findings:
            print(f"sheeprl_tpu_torch lint: {len(findings)} finding(s) across {n_files} file(s)")
        else:
            print(f"sheeprl_tpu_torch lint: clean ({n_files} files, {len(rules)} rules)")
    return 1 if findings else 0
