"""thread-shared-state: cross-thread ``self.*`` writes need a declared lock.

The Podracer-style split (engine/, fleet/, gateway/, serve/ — player,
learner, batcher, reloader, monitor threads in one process) makes every
mutable ``self.*`` attribute a potential race. This rule is a lightweight,
class-local detector:

* **thread roots** are the methods a class hands to ``threading.Thread(
  target=self.<m>)``; every method reachable from a root through
  ``self.<m>()`` calls runs on that thread. Public (non-underscore)
  methods additionally run on the *caller* root even when a thread root
  calls them too — external callers can't be seen statically; private
  methods are caller-rooted only when nothing intra-class calls them.
* an attribute **written** (assigned/augmented) from two different roots —
  at least one of them a spawned thread — is shared mutable state: every
  access to it outside ``__init__`` must sit inside ``with self.<lock>:``
  where ``<lock>`` was bound in ``__init__`` to a ``threading.Lock`` /
  ``RLock`` / ``Condition``. A method named ``*_locked`` counts as guarded
  throughout (the codebase convention: callers hold the lock);
* attributes bound in ``__init__`` to an allowlisted atomic structure
  (``SpscRing``, ``queue.Queue``, ``mp.Queue``, ``deque``, threading
  primitives, shared ``Value``) are exempt — their methods synchronize
  internally, which is the whole reason the subsystems use them.

One happens-before shape is carved out automatically: accesses in the
spawner method *above* its ``.start()`` call (reset fields in the
``start()`` that spawns the thread) — the thread doesn't exist yet.
Other genuinely-ordered accesses are the intended use of
``# lint: ok[thread-shared-state] <happens-before reason>``.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from ..engine import Finding, ModuleContext, Rule

LOCK_CTORS = {"Lock", "RLock", "Condition"}
ATOMIC_CTORS = {
    "SpscRing", "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue", "JoinableQueue",
    "deque", "Event", "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
    "Barrier", "Value", "RawValue", "Array",
}
CALLER_ROOT = "<caller>"


def _terminal(dotted: Optional[str]) -> str:
    return dotted.rsplit(".", 1)[-1] if dotted else ""


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


class _ClassInfo:
    def __init__(self, ctx: ModuleContext, cls: ast.ClassDef):
        self.ctx = ctx
        self.cls = cls
        self.methods: Dict[str, ast.FunctionDef] = {
            n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)
        }
        self.thread_targets: Set[str] = set()
        self.lock_attrs: Set[str] = set()
        self.atomic_attrs: Set[str] = set()
        self.calls: Dict[str, Set[str]] = {}  # method -> self.<m>() callees
        # spawner method -> line of its first `.start()` call: accesses above
        # that line happen strictly before the thread exists (happens-before)
        self.pre_spawn: Dict[str, int] = {}
        self._scan()

    def _scan(self) -> None:
        init = self.methods.get("__init__")
        if init is not None:
            for node in ast.walk(init):
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                    ctor = _terminal(self.ctx.call_dotted(node.value))
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is None:
                            continue
                        if ctor in LOCK_CTORS:
                            self.lock_attrs.add(attr)
                        if ctor in ATOMIC_CTORS:
                            self.atomic_attrs.add(attr)
        for name, fn in self.methods.items():
            callees: Set[str] = set()
            spawns_here = False
            start_lines: List[int] = []
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                attr = _self_attr(node.func)
                if attr is not None and attr in self.methods:
                    callees.add(attr)
                if isinstance(node.func, ast.Attribute) and node.func.attr == "start":
                    start_lines.append(node.lineno)
                # threading.Thread(target=self.<m>) — also covers locally
                # aliased Thread imports via dotted resolution
                if _terminal(self.ctx.dotted(node.func)) == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            tgt = _self_attr(kw.value)
                            if tgt is not None and tgt in self.methods:
                                self.thread_targets.add(tgt)
                                spawns_here = True
            self.calls[name] = callees
            if spawns_here and start_lines:
                self.pre_spawn[name] = min(start_lines)
        # non-__init__ lock bindings count too (lazy construction)
        for name, fn in self.methods.items():
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                    ctor = _terminal(self.ctx.call_dotted(node.value))
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is not None and ctor in LOCK_CTORS:
                            self.lock_attrs.add(attr)

    def roots_per_method(self) -> Dict[str, Set[str]]:
        """Which execution roots can a method run under."""
        reach: Dict[str, Set[str]] = {m: set() for m in self.methods}
        for root in self.thread_targets:
            seen: Set[str] = set()
            stack = [root]
            while stack:
                m = stack.pop()
                if m in seen:
                    continue
                seen.add(m)
                reach.setdefault(m, set()).add(root)
                stack.extend(self.calls.get(m, ()))
        # caller root: the public surface. A public (non-underscore) method
        # is assumed callable from outside even when a thread root also
        # calls it — ReplicaManager.fault (monitor sweep + request threads)
        # is exactly that shape; private methods are caller-rooted only
        # when nothing intra-class calls them
        called_by: Dict[str, Set[str]] = {m: set() for m in self.methods}
        for src, callees in self.calls.items():
            for c in callees:
                called_by.setdefault(c, set()).add(src)
        changed = True
        caller_rooted: Set[str] = {
            m
            for m in self.methods
            if m not in self.thread_targets
            and (not called_by.get(m) or not m.startswith("_"))
        }
        while changed:
            changed = False
            for src in list(caller_rooted):
                for c in self.calls.get(src, ()):
                    if c not in caller_rooted and c not in self.thread_targets:
                        caller_rooted.add(c)
                        changed = True
        for m in caller_rooted:
            reach.setdefault(m, set()).add(CALLER_ROOT)
        return reach


class _AccessCollector(ast.NodeVisitor):
    """All self.<attr> accesses in a method with their lock-guard state.

    A method named ``*_locked`` is, by this codebase's convention, only ever
    called with the relevant lock already held — its whole body counts as
    guarded."""

    def __init__(self, lock_attrs: Set[str], held_by_convention: bool = False):
        self.lock_attrs = lock_attrs
        self._guard_depth = 1 if held_by_convention else 0
        self.writes: List[Tuple[str, int, bool]] = []  # (attr, line, guarded)
        self.reads: List[Tuple[str, int, bool]] = []

    def visit_With(self, node: ast.With) -> None:
        guarded = any(
            _self_attr(item.context_expr) in self.lock_attrs for item in node.items
        )
        if guarded:
            self._guard_depth += 1
        self.generic_visit(node)
        if guarded:
            self._guard_depth -= 1

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None:
            entry = (attr, node.lineno, self._guard_depth > 0)
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                self.writes.append(entry)
            else:
                self.reads.append(entry)
        self.generic_visit(node)


class ThreadSharedStateRule(Rule):
    """self.* written from >1 thread root without a declared lock (engine/fleet/gateway/serve/flywheel)."""

    rule_id = "thread-shared-state"
    path_parts = ("engine", "fleet", "gateway", "serve", "flywheel")

    def check_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(ctx, node)

    def _check_class(self, ctx: ModuleContext, cls: ast.ClassDef) -> Iterator[Finding]:
        info = _ClassInfo(ctx, cls)
        if not info.thread_targets:
            return
        roots = info.roots_per_method()

        accesses: Dict[str, _AccessCollector] = {}
        for name, fn in info.methods.items():
            if name == "__init__":
                continue
            col = _AccessCollector(info.lock_attrs, held_by_convention=name.endswith("_locked"))
            col.visit(fn)
            accesses[name] = col

        # attr -> roots that write it; writes in a spawner method before its
        # `.start()` call happen before the thread exists and don't count
        writer_roots: Dict[str, Set[str]] = {}
        for name, col in accesses.items():
            spawn_line = info.pre_spawn.get(name)
            for attr, line, _guarded in col.writes:
                if spawn_line is not None and line < spawn_line:
                    continue
                writer_roots.setdefault(attr, set()).update(roots.get(name, {CALLER_ROOT}))

        shared = {
            attr
            for attr, rts in writer_roots.items()
            if len(rts) >= 2
            and rts & info.thread_targets
            and attr not in info.atomic_attrs
            and attr not in info.lock_attrs
        }
        if not shared:
            return

        seen: Set[Tuple[str, int]] = set()
        for name, col in accesses.items():
            spawn_line = info.pre_spawn.get(name)
            for attr, line, guarded in col.writes + col.reads:
                if attr not in shared or guarded or (attr, line) in seen:
                    continue
                if spawn_line is not None and line < spawn_line:
                    continue  # pre-spawn access in the spawner method
                seen.add((attr, line))
                kind = "written" if (attr, line, guarded) in col.writes else "accessed"
                yield Finding(
                    self.rule_id,
                    str(ctx.path),
                    line,
                    f"`self.{attr}` is written from multiple thread roots "
                    f"({', '.join(sorted(writer_roots[attr]))}) but {kind} here without a "
                    f"declared lock",
                    remediation=(
                        "guard every access with `with self.<lock>:` (a threading.Lock/RLock/"
                        "Condition bound in __init__), switch to an atomic structure "
                        "(queue.Queue, SpscRing, Event), or suppress with the happens-before reason"
                    ),
                )
