"""socket-timeout: blocking socket ops need an explicit deadline.

The transport subsystems (``fleet/``, ``gateway/``, ``serve/``) talk to
peers that can partition, stall half-open or simply never answer. A
``recv``/``accept``/``connect``/``makefile`` on a socket with no timeout
parks its thread *forever* in exactly those cases — the failure mode only
shows up in production, never in a localhost unit test, which makes lint
time the cheapest place to catch it (the same argument as every rule in
this framework).

Detection is deliberately name-local and conservative (no findings on
objects the module didn't create, so HTTP-client internals never
false-positive):

* a name is a **tracked socket** when the module binds it from
  ``socket.socket(...)`` / ``socket.create_connection(...)`` (assignment or
  ``with ... as``) or unpacks it from ``<tracked>.accept()`` — accepted
  connections do NOT inherit the listener's timeout, which is exactly the
  bug this rule exists for;
* it counts as **timed** when ``create_connection`` was given a timeout,
  or ``.settimeout(<non-None>)`` / ``.setblocking(False)`` is called on it
  anywhere in the module, or it is passed to a module-local helper that
  calls ``settimeout`` on the corresponding parameter (the
  ``_configure(sock)`` idiom), or ``socket.setdefaulttimeout`` appears at
  module level;
* every ``.recv/.recvfrom/.recv_into/.accept/.connect/.makefile`` call on
  a tracked, untimed socket is a finding.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..engine import Finding, ModuleContext, Rule

BLOCKING_OPS = {"recv", "recvfrom", "recv_into", "accept", "connect", "makefile"}
SOCKET_CTORS = {"socket.socket", "socket.create_connection"}


def _name_of(node: ast.AST) -> Optional[str]:
    """A trackable binding target: a bare name or a ``self.attr``."""
    if isinstance(node, ast.Name):
        return node.id
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return f"self.{node.attr}"
    return None


def _has_timeout_arg(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "timeout" and not (
            isinstance(kw.value, ast.Constant) and kw.value.value is None
        ):
            return True
    # socket.create_connection(address, timeout, ...)
    return len(call.args) >= 2


class SocketTimeoutRule(Rule):
    """blocking socket recv/accept/connect/makefile without a timeout (fleet/gateway/serve/flywheel)."""

    rule_id = "socket-timeout"
    path_parts = ("fleet", "gateway", "serve", "flywheel")

    def check_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        # module-wide default timeout: everything is timed
        for node in ast.walk(ctx.tree):
            if (
                isinstance(node, ast.Call)
                and ctx.call_dotted(node) == "socket.setdefaulttimeout"
            ):
                return

        tracked: Dict[str, bool] = {}  # name -> timed?
        # helper functions that set a timeout on one of their parameters:
        # {func_name: set of parameter indices}
        setters: Dict[str, Set[int]] = {}
        for node in ctx.tree.body:
            fns: List[ast.FunctionDef] = []
            if isinstance(node, ast.FunctionDef):
                fns.append(node)
            elif isinstance(node, ast.ClassDef):
                fns.extend(n for n in node.body if isinstance(n, ast.FunctionDef))
            for fn in fns:
                params = [a.arg for a in fn.args.args if a.arg != "self"]
                for sub in ast.walk(fn):
                    if (
                        isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in ("settimeout", "setblocking")
                        and isinstance(sub.func.value, ast.Name)
                        and sub.func.value.id in params
                    ):
                        setters.setdefault(fn.name, set()).add(
                            params.index(sub.func.value.id)
                        )

        uses: List[Tuple[str, str, int]] = []  # (name, op, line)

        def track(target: ast.AST, call: ast.Call) -> None:
            name = _name_of(target)
            if name is None:
                return
            dotted = ctx.call_dotted(call)
            if dotted in SOCKET_CTORS:
                timed = dotted == "socket.create_connection" and _has_timeout_arg(call)
                tracked[name] = tracked.get(name, False) or timed

        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                for t in node.targets:
                    track(t, node.value)
                    # conn, addr = <tracked>.accept(): the accepted socket
                    # is a fresh BLOCKING socket regardless of the listener
                    if isinstance(t, ast.Tuple) and t.elts:
                        fnc = node.value.func
                        if (
                            isinstance(fnc, ast.Attribute)
                            and fnc.attr == "accept"
                            and _name_of(fnc.value) in tracked
                        ):
                            conn_name = _name_of(t.elts[0])
                            if conn_name is not None:
                                tracked.setdefault(conn_name, False)
            elif isinstance(node, ast.With):
                for item in node.items:
                    if isinstance(item.context_expr, ast.Call) and item.optional_vars is not None:
                        track(item.optional_vars, item.context_expr)
            elif isinstance(node, ast.Call):
                func = node.func
                if isinstance(func, ast.Attribute):
                    owner = _name_of(func.value)
                    if owner is not None and owner in tracked:
                        if func.attr == "settimeout":
                            first = node.args[0] if node.args else None
                            if not (isinstance(first, ast.Constant) and first.value is None):
                                tracked[owner] = True
                        elif func.attr == "setblocking":
                            first = node.args[0] if node.args else None
                            # only setblocking(False/0) bounds the ops
                            if isinstance(first, ast.Constant) and not first.value:
                                tracked[owner] = True
                        elif func.attr in BLOCKING_OPS:
                            uses.append((owner, func.attr, node.lineno))
                elif isinstance(func, ast.Name) or (
                    isinstance(func, ast.Attribute)
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "self"
                ):
                    # helper call: _configure(sock, ...) / self._configure(sock)
                    fname = func.id if isinstance(func, ast.Name) else func.attr
                    for idx in setters.get(fname, ()):
                        if idx < len(node.args):
                            arg_name = _name_of(node.args[idx])
                            if arg_name is not None and arg_name in tracked:
                                tracked[arg_name] = True

        for name, op, line in uses:
            if tracked.get(name):
                continue
            yield Finding(
                self.rule_id,
                str(ctx.path),
                line,
                f"blocking `.{op}()` on socket `{name}` with no timeout — a "
                f"partitioned or half-open peer parks this thread forever",
                remediation=(
                    "call `.settimeout(...)` on the socket before blocking ops "
                    "(accepted sockets do NOT inherit the listener's timeout), "
                    "pass `timeout=` to socket.create_connection, or bound the "
                    "op another way (select/poll with a deadline)"
                ),
            )
