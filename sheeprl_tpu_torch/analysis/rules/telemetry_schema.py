"""telemetry-schema-drift: every emit() call site matches telemetry/schema.py.

The JSONL stream is a contract: doctor, the Prometheus mirror, bench_compare
and external dashboards all key on ``EVENT_SCHEMAS``. An emit site that
drifts (renamed event, missing required field, field the schema never
learned) doesn't fail at runtime — ``validate_event`` tolerates extras for
forward compatibility and only sinks with validation enabled see the error —
it just silently breaks whoever consumes the stream. So the *static* rule is
stricter than the runtime validator:

* unknown event name → finding;
* required field missing from the literal (no ``**spread`` and no later
  ``rec[...] = ...`` mutation in sight) → finding;
* literal field the schema doesn't declare → finding (add it to
  ``telemetry/schema.py`` — that's the point: the schema moves WITH the
  emit site, in the same PR).

Covered shapes: ``emit({...})`` / ``_emit(telem, {...})`` dict literals and
the ``rec = {...}`` … ``emit(rec)`` local-alias pattern (linear, per
function; a ``rec[k] = v`` between binding and emit downgrades the
missing-field check, not the unknown-key check).

Label-cardinality guard: event names and span names are LABELS — every
unique name becomes a Prometheus label value (``stage_latency_ms{stage=…}``),
a stage row in the trace report and a schema key. A dynamically formatted
name (``f"worker_{i}"``, ``"stage_" + name``, ``"%s" % x``, ``.format(…)``)
is an unbounded label set, so the rule flags it at ``emit({"event": …})``
and ``span(…)`` call sites. A plain variable passed through is allowed —
the binding site is where the literal lives.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..engine import Finding, ModuleContext, Rule

EMIT_NAMES = {"emit", "_emit"}


def _load_default_schema() -> Dict[str, Dict[str, Tuple[bool, type]]]:
    from ...telemetry.schema import EVENT_SCHEMAS

    return EVENT_SCHEMAS


class TelemetrySchemaRule(Rule):
    """emit() event name/fields cross-checked against telemetry/schema.py."""

    rule_id = "telemetry-schema-drift"

    def __init__(self, schema: Optional[Dict[str, Dict[str, Tuple[bool, type]]]] = None):
        self._schema = schema

    @property
    def schema(self) -> Dict[str, Dict[str, Tuple[bool, type]]]:
        if self._schema is None:
            self._schema = _load_default_schema()
        return self._schema

    def check_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        if ctx.path.name == "schema.py" and ctx.path.parent.name == "telemetry":
            return  # the schema itself
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.FunctionDef):
                yield from self._check_function(ctx, node)
            elif isinstance(node, ast.Call):
                yield from self._check_span_name(ctx, node)

    def _check_span_name(self, ctx: ModuleContext, call: ast.Call) -> Iterator[Finding]:
        """span(<dynamically built string>) — each unique span name is a
        metric key (SpanTracker totals, TraceAnnotation names) and, for
        trace spans, a Prometheus `stage` label: formatting data into it
        explodes label cardinality."""
        fn = call.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
        if name != "span" or not call.args:
            return
        if _dynamic_string(call.args[0]):
            yield Finding(
                self.rule_id,
                str(ctx.path),
                call.lineno,
                "non-literal span name (dynamically formatted) — span names are "
                "metric labels; formatting data into them is a label-cardinality "
                "explosion",
                remediation=(
                    "use a literal span name and carry the varying part as an "
                    "event field (worker=..., seq=...) instead"
                ),
            )

    # -- per-function linear walk -----------------------------------------
    def _check_function(self, ctx: ModuleContext, fn: ast.FunctionDef) -> Iterator[Finding]:
        # name -> (dict node, dirty): last literal binding before the emit
        aliases: Dict[str, Tuple[ast.Dict, bool]] = {}
        for stmt in self._linear_stmts(fn):
            if isinstance(stmt, ast.Assign):
                target_names = [t.id for t in stmt.targets if isinstance(t, ast.Name)]
                # rec["k"] = v dirties the alias (fields added dynamically)
                for t in stmt.targets:
                    if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
                        name = t.value.id
                        if name in aliases:
                            aliases[name] = (aliases[name][0], True)
                if isinstance(stmt.value, ast.Dict):
                    for name in target_names:
                        aliases[name] = (stmt.value, False)
                else:
                    for name in target_names:
                        aliases.pop(name, None)
            # scan only this statement's own expressions — nested statements
            # appear later in the flattened list and must not double-report
            for child in ast.iter_child_nodes(stmt):
                if not isinstance(child, ast.expr):
                    continue
                for call in ast.walk(child):
                    if isinstance(call, ast.Call) and self._is_emit(call):
                        yield from self._check_call(ctx, call, aliases)

    @staticmethod
    def _linear_stmts(fn: ast.FunctionDef) -> List[ast.stmt]:
        out: List[ast.stmt] = []

        def rec(body: List[ast.stmt]) -> None:
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                out.append(stmt)
                for attr in ("body", "orelse", "finalbody"):
                    rec(getattr(stmt, attr, []) or [])
                for handler in getattr(stmt, "handlers", []) or []:
                    rec(handler.body)

        rec(fn.body)
        return out

    @staticmethod
    def _is_emit(call: ast.Call) -> bool:
        fn = call.func
        name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
        return name in EMIT_NAMES

    def _check_call(
        self, ctx: ModuleContext, call: ast.Call, aliases: Dict[str, Tuple[ast.Dict, bool]]
    ) -> Iterator[Finding]:
        rec: Optional[ast.Dict] = None
        dirty = False
        for arg in call.args:
            candidates = [arg] if isinstance(arg, ast.Dict) else []
            if isinstance(arg, ast.Name) and arg.id in aliases:
                candidates = [aliases[arg.id][0]]
            for cand in candidates:
                if _dynamic_event_value(cand):
                    # the cardinality guard: f"fault_{kind}" as an event
                    # name is an unbounded label/schema-key set
                    yield Finding(
                        self.rule_id,
                        str(ctx.path),
                        call.lineno,
                        "non-literal event name (dynamically formatted) — event "
                        "names are schema keys and metric labels; formatting data "
                        "into them is a label-cardinality explosion",
                        remediation=(
                            "use a literal event name and carry the varying part "
                            "as a declared field (action=..., detail=...)"
                        ),
                    )
                    return
            if isinstance(arg, ast.Dict) and self._event_key(arg) is not None:
                rec = arg
                break
            if isinstance(arg, ast.Name) and arg.id in aliases:
                cand, cand_dirty = aliases[arg.id]
                if self._event_key(cand) is not None:
                    rec, dirty = cand, cand_dirty
                    break
        if rec is None:
            return
        event = self._event_key(rec)
        assert event is not None
        schema = self.schema.get(event)
        if schema is None:
            yield Finding(
                self.rule_id,
                str(ctx.path),
                call.lineno,
                f"emit of unknown event {event!r} — not declared in telemetry/schema.py "
                f"(known: {sorted(self.schema)})",
                remediation="add the event to EVENT_SCHEMAS, or fix the name at the call site",
            )
            return
        literal_keys: Set[str] = set()
        has_spread = False
        for k in rec.keys:
            if k is None:
                has_spread = True
            elif isinstance(k, ast.Constant) and isinstance(k.value, str):
                literal_keys.add(k.value)
            else:
                has_spread = True  # computed key: unknowable statically
        for key in sorted(literal_keys - {"event"} - set(schema)):
            yield Finding(
                self.rule_id,
                str(ctx.path),
                call.lineno,
                f"emit({event!r}): field {key!r} is not declared in telemetry/schema.py",
                remediation="declare the field in EVENT_SCHEMAS (schema moves with the emit site)",
            )
        if not has_spread and not dirty:
            required = {f for f, (req, _t) in schema.items() if req}
            for key in sorted(required - literal_keys):
                yield Finding(
                    self.rule_id,
                    str(ctx.path),
                    call.lineno,
                    f"emit({event!r}): required field {key!r} is missing",
                    remediation="populate the field, or relax it to optional in EVENT_SCHEMAS",
                )

    @staticmethod
    def _event_key(node: ast.Dict) -> Optional[str]:
        for k, v in zip(node.keys, node.values):
            if (
                isinstance(k, ast.Constant)
                and k.value == "event"
                and isinstance(v, ast.Constant)
                and isinstance(v.value, str)
            ):
                return v.value
        return None


def _dynamic_string(node: ast.AST) -> bool:
    """A string the code BUILDS rather than states: f-strings, ``+``/``%``
    concatenation involving a string literal, ``"...".format(...)`` and
    ``str(...)``. A bare Name/attribute passthrough is allowed — the
    literal lives at its binding site, and flagging every variable would
    bury the real explosions in noise."""
    if isinstance(node, ast.JoinedStr):
        return any(isinstance(v, ast.FormattedValue) for v in node.values)
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Mod)):
        return _contains_str_constant(node)
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "format":
            return True
        if isinstance(fn, ast.Name) and fn.id == "str":
            return True
    return False


def _contains_str_constant(node: ast.AST) -> bool:
    return any(
        isinstance(sub, ast.Constant) and isinstance(sub.value, str)
        for sub in ast.walk(node)
    )


def _dynamic_event_value(node: ast.Dict) -> bool:
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant) and k.value == "event" and _dynamic_string(v):
            return True
    return False
