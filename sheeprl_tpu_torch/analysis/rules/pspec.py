"""pspec-literal: mesh, placement and group objects come from parallel/.

The torch counterpart of the JAX package's rule of the same id. The mesh
subsystem (``sheeprl_tpu_torch/parallel/``, ``Distributed`` in
``parallel/mesh.py``) is the ONE place that knows the mesh's axis names,
their sizes and which ranks form each group, and the ``SpecEngine``
(``parallel/sharding.py``) the one that decides each leaf's placement. A
``DeviceMesh``, a ``Shard``/``Replicate`` placement or a ``new_group`` made
at a call site, or a bare axis name (``"dp"`` / ``"fsdp"`` / ``"tp"``)
handed to a mesh lookup or a collective, bakes one mesh layout into code
that must work on every layout: it breaks silently the first time someone
runs with ``fabric.mesh.tp=2``.

Flagged outside ``parallel/``:

* a call that builds a ``torch.distributed`` mesh, placement or group:
  ``init_device_mesh``, ``DeviceMesh``, ``distribute_tensor``,
  ``DTensor.from_local``, ``Shard(...)``, ``Replicate(...)``,
  ``new_group``;
* a mesh-axis string literal (tuples and lists included) used as a mesh
  lookup — ``device_mesh["dp"]``, ``get_group("tp")`` — or passed as a
  collective's ``group=``.

Suppress a deliberate exception with ``# lint: ok[pspec-literal] <reason>``.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Tuple

from ..engine import Finding, ModuleContext, Rule

AXIS_NAMES = {"dp", "fsdp", "tp"}
# terminal callee names that build a mesh, a placement or a process group
MESH_CTORS = {"init_device_mesh", "DeviceMesh", "distribute_tensor", "Shard", "Replicate", "new_group"}
# terminal callee names whose arguments name mesh axes
AXIS_LOOKUPS = {"get_group", "get_local_rank"}


def _terminal_name(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _axis_literals(node: ast.AST) -> List[Tuple[str, int]]:
    """(axis, line) for every mesh-axis string constant under ``node``
    (tuples/lists included — ``mesh[("dp", "fsdp")]`` is two hits)."""
    out = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) and sub.value in AXIS_NAMES:
            out.append((sub.value, sub.lineno))
    return out


def _is_mesh(node: ast.AST) -> bool:
    """A ``DeviceMesh`` by its name (``device_mesh``, ``self.device_mesh``,
    ``dp_mesh``), not a config section such as ``cfg.fabric.mesh``."""
    name = _terminal_name(node)
    return name == "device_mesh" or name.endswith("_mesh")


class PspecLiteralRule(Rule):
    """DeviceMesh / placement / process-group construction or mesh-axis literals outside sheeprl_tpu_torch/parallel/."""

    rule_id = "pspec-literal"

    def applies(self, path) -> bool:
        # the mesh subsystem IS the engine — everything else is a call site
        return "parallel" not in path.parts

    def _axis_finding(self, ctx: ModuleContext, axis: str, line: int, where: str) -> Finding:
        return Finding(
            self.rule_id,
            str(ctx.path),
            line,
            f"mesh-axis literal '{axis}' {where} outside sheeprl_tpu_torch/parallel/ — the axis "
            "layout is the mesh's to decide (this literal is wrong the moment fabric.mesh "
            "changes shape)",
            remediation=(
                "ask `Distributed` for the group or the placement (parallel/mesh.py); suppress a "
                "deliberate exception with `# lint: ok[pspec-literal] <reason>`"
            ),
        )

    def check_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Subscript) and _is_mesh(node.value):
                for axis, line in _axis_literals(node.slice):
                    yield self._axis_finding(ctx, axis, line, f"indexes `{ast.unparse(node.value)}`")
                continue
            if not isinstance(node, ast.Call):
                continue
            dotted = ctx.call_dotted(node) or ""
            callee = _terminal_name(node.func)
            from_local = callee == "from_local" and dotted.rsplit(".", 2)[-2:-1] == ["DTensor"]
            if callee in MESH_CTORS or from_local:
                name = "DTensor.from_local" if from_local else callee
                yield Finding(
                    self.rule_id,
                    str(ctx.path),
                    node.lineno,
                    f"`{name}(...)` outside sheeprl_tpu_torch/parallel/ — meshes, placements and "
                    "process groups come from the mesh subsystem, which owns axis names, sizes "
                    "and the ranks of each group",
                    remediation=(
                        "use `Distributed`'s groups and collectives (parallel/mesh.py) and the "
                        "SpecEngine's placements (parallel/sharding.py); a deliberate exception "
                        "needs `# lint: ok[pspec-literal] <reason>`"
                    ),
                )
                continue
            if callee in AXIS_LOOKUPS:
                for arg in node.args:
                    for axis, line in _axis_literals(arg):
                        yield self._axis_finding(ctx, axis, line, f"passed to `{callee}(...)`")
            for kw in node.keywords:
                if kw.arg in ("group", "mesh_dim"):
                    for axis, line in _axis_literals(kw.value):
                        yield self._axis_finding(ctx, axis, line, f"as {kw.arg}= of `{callee}(...)`")
