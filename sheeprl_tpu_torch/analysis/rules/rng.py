"""rng-reuse: every draw names its generator, and no hot loop re-seeds one.

The torch counterpart of the JAX package's rule of the same id. There a key
must be consumed once; here the invariant is the port's explicit-generator
idiom, which its pre-drawn-noise parity with the JAX package depends on:
each draw comes from a ``torch.Generator`` the run made and seeded once
(the player's, the learner's, each fleet slot's), so a draw elsewhere —
a dropout mask, a warm-up action, a library call — can never shift another
stream. Two things break it, and both are flagged:

* **a draw from the process-wide generator**, anywhere in the package: a
  sampler called without ``generator=`` — ``torch.rand*`` (``rand``,
  ``rand_like``, ``randn*``, ``randint*``, ``randperm``),
  ``torch.bernoulli``, ``torch.multinomial``, ``torch.normal``,
  ``torch.poisson``, and the in-place samplers ``Tensor.normal_`` /
  ``uniform_`` / ``bernoulli_`` / ``exponential_`` / ``geometric_`` /
  ``log_normal_`` / ``cauchy_`` / ``random_``. The parameter initialisers
  of ``torch.nn.init`` are not flagged: they run when modules are built,
  after the run seeds the process-wide generator once (the JAX package's
  ``PRNGKey(seed)`` for its ``init``);
* **re-seeding inside a hot loop** (``host_sync.hot_functions``):
  ``torch.manual_seed``, ``torch.cuda.manual_seed*``,
  ``torch.Generator(...)`` or ``<gen>.manual_seed(...)`` in a ``while`` /
  ``for`` body restarts a stream every step — the same numbers again, or a
  stream keyed on step data. The counterpart of the JAX rule's
  ``PRNGKey`` in a hot loop: seed once outside the loop and draw on.

Nothing else: torch generators advance by themselves, so the JAX rule's
use-after-consume data flow has no counterpart.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Set, Tuple

from ..engine import Finding, ModuleContext, Rule
from .host_sync import hot_functions

GLOBAL_SAMPLERS = {"torch.bernoulli", "torch.multinomial", "torch.normal", "torch.poisson"}
INPLACE_SAMPLERS = {
    "normal_", "uniform_", "bernoulli_", "exponential_", "geometric_", "log_normal_", "cauchy_", "random_",
}
SEEDERS = {"torch.manual_seed", "torch.random.manual_seed", "torch.cuda.manual_seed",
           "torch.cuda.manual_seed_all", "torch.Generator"}


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def global_draw(ctx: ModuleContext, call: ast.Call) -> str:
    """The sampler's name if ``call`` draws from the process-wide
    generator, else the empty string."""
    if _has_generator(call):
        return ""
    dotted = ctx.call_dotted(call) or ""
    if dotted.startswith("torch.rand") or dotted in GLOBAL_SAMPLERS:
        return dotted
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in INPLACE_SAMPLERS:
        if dotted.startswith("torch."):
            return ""  # a torch.nn.init initialiser (or a torch.* function judged above)
        return f"Tensor.{fn.attr}"
    return ""


class _SeedChecker(ast.NodeVisitor):
    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx
        self.hits: List[Tuple[int, str]] = []
        self._loop_depth = 0

    def visit_loop(self, node: ast.AST) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = visit_loop
    visit_While = visit_loop

    def visit_Call(self, node: ast.Call) -> None:
        if self._loop_depth:
            dotted = self.ctx.call_dotted(node) or ""
            fn = node.func
            if dotted in SEEDERS:
                self.hits.append((node.lineno, dotted))
            elif isinstance(fn, ast.Attribute) and fn.attr == "manual_seed" and not isinstance(fn.value, ast.Call):
                # (`torch.Generator(...).manual_seed(...)`: the inner call is the one reported)
                self.hits.append((node.lineno, f"{ast.unparse(fn.value)}.manual_seed"))
        self.generic_visit(node)


class RngReuseRule(Rule):
    """A draw from torch's process-wide generator (no generator=), or a generator (re)seeded in a hot loop."""

    rule_id = "rng-reuse"

    def check_module(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = global_draw(ctx, node)
                if name:
                    yield Finding(
                        self.rule_id,
                        str(ctx.path),
                        node.lineno,
                        f"`{name}(...)` draws from the process-wide generator (no `generator=`)",
                        remediation=(
                            "pass the loop's own torch.Generator as `generator=` (the player's, "
                            "the learner's or the slot's), so no draw shifts another stream"
                        ),
                    )
        seen: Set[int] = set()
        for fn, _qual in hot_functions(ctx.tree):
            checker = _SeedChecker(ctx)
            for stmt in fn.body:
                checker.visit(stmt)
            for line, name in checker.hits:
                if line in seen:
                    continue
                seen.add(line)
                yield Finding(
                    self.rule_id,
                    str(ctx.path),
                    line,
                    f"`{name}(...)` seeds a generator inside a hot loop — the same stream every step",
                    remediation="seed the generator once outside the loop and draw on from it",
                )
