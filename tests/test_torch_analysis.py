"""The port's rule engine (``sheeprl_tpu_torch/analysis``, ``lint``) held
against the JAX package's (``sheeprl_tpu/analysis``):

* on every fixture of tests/test_analysis.py that one of the five shared
  rules lints (socket-timeout, thread-shared-state, hot-loop-emit,
  telemetry-schema-drift with the same injected schema, host-sync), the
  port's rule gives the JAX rule's findings exactly: rule id, line and
  message;
* torch fixtures, a red and a green for each: host-sync's ``.tolist()``,
  ``synchronize()`` and the metrics' ``.cpu()`` (an action's ``.cpu()`` is
  not flagged); rng-reuse's draw from the process-wide generator and its
  seeding in a hot loop; pspec-literal outside and inside ``parallel/``;
* the CLI surface: exit codes, the ``--json`` round trip with the JAX
  package's keys, ``--rule``, ``--list-rules``, and the refusal (exit 2, with
  the reason) of ``retrace-hazard`` and ``use-after-donate``;
* the hot set: for each registered entry point of the port, the chain of
  calls to the function whose per-step loop host-sync scans;
* the port's tree lints clean, through ``run_paths`` and through
  ``python -m sheeprl_tpu_torch lint``."""
import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from sheeprl_tpu.analysis import run_paths as jax_run_paths
from sheeprl_tpu.analysis.rules import host_sync as jax_host_sync
from sheeprl_tpu.analysis.rules import hot_loop as jax_hot_loop
from sheeprl_tpu.analysis.rules import sockets as jax_sockets
from sheeprl_tpu.analysis.rules import telemetry_schema as jax_telemetry_schema
from sheeprl_tpu.analysis.rules import threads as jax_threads
from sheeprl_tpu_torch.analysis import all_rules, run_paths
from sheeprl_tpu_torch.analysis.engine import NOT_PORTED
from sheeprl_tpu_torch.analysis.engine import main as lint_main
from sheeprl_tpu_torch.analysis.rules.host_sync import HostSyncRule, hot_functions, scan_hot_function
from sheeprl_tpu_torch.analysis.rules.hot_loop import HotLoopEmitRule
from sheeprl_tpu_torch.analysis.rules.pspec import PspecLiteralRule
from sheeprl_tpu_torch.analysis.rules.rng import RngReuseRule
from sheeprl_tpu_torch.analysis.rules.sockets import SocketTimeoutRule
from sheeprl_tpu_torch.analysis.rules.telemetry_schema import TelemetrySchemaRule
from sheeprl_tpu_torch.analysis.rules.threads import ThreadSharedStateRule

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "sheeprl_tpu_torch"
JAX_TESTS = REPO / "tests" / "test_analysis.py"

# rule class name in tests/test_analysis.py -> (the JAX rule's class, the port's)
SHARED = {
    "SocketTimeoutRule": (jax_sockets.SocketTimeoutRule, SocketTimeoutRule),
    "ThreadSharedStateRule": (jax_threads.ThreadSharedStateRule, ThreadSharedStateRule),
    "HotLoopEmitRule": (jax_hot_loop.HotLoopEmitRule, HotLoopEmitRule),
    "TelemetrySchemaRule": (jax_telemetry_schema.TelemetrySchemaRule, TelemetrySchemaRule),
    "HostSyncRule": (jax_host_sync.HostSyncRule, HostSyncRule),
}
RULE_CLASS_OF_ID = {"socket-timeout": "SocketTimeoutRule", "thread-shared-state": "ThreadSharedStateRule",
                    "hot-loop-emit": "HotLoopEmitRule", "telemetry-schema-drift": "TelemetrySchemaRule",
                    "host-sync": "HostSyncRule"}


def _jax_fixtures():
    """(id, source, file name, rule class name) of every fixture
    tests/test_analysis.py lints with a shared rule: the
    ``_lint(tmp_path, <source>, <Rule>(), name=...)`` calls and the
    ``RED_BY_RULE`` table, read from its AST; and its ``FAKE_SCHEMA``."""
    tree = ast.parse(JAX_TESTS.read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name == "RED_BY_RULE":  # tuples naming module constants: kept as the AST
                consts[name] = node.value
            elif name == "FAKE_SCHEMA":  # {event: {field: (required, type)}}
                consts[name] = eval(compile(ast.Expression(node.value), str(JAX_TESTS), "eval"),
                                    {"__builtins__": {}, "int": int, "str": str, "float": float})
            else:
                try:
                    consts[name] = ast.literal_eval(node.value)
                except ValueError:
                    pass

    def text(node):
        return consts[node.id] if isinstance(node, ast.Name) else ast.literal_eval(node)

    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for call in ast.walk(fn):
            if not (isinstance(call, ast.Call) and getattr(call.func, "id", "") == "_lint"):
                continue
            # `rule = TelemetrySchemaRule(schema=FAKE_SCHEMA)` is passed by name
            rule = "TelemetrySchemaRule" if isinstance(call.args[2], ast.Name) else call.args[2].func.id
            if rule not in SHARED:
                continue
            name = next((ast.literal_eval(k.value) for k in call.keywords if k.arg == "name"), "snippet.py")
            out.append((f"{fn.name}:{call.lineno}", text(call.args[1]), name, rule))
    for key, value in zip(consts["RED_BY_RULE"].keys, consts["RED_BY_RULE"].values):
        rule_id = ast.literal_eval(key)
        if rule_id in RULE_CLASS_OF_ID:
            rel, code, _line = value.elts
            out.append((f"RED_BY_RULE[{rule_id}]", text(code), ast.literal_eval(rel), RULE_CLASS_OF_ID[rule_id]))
    return out, consts["FAKE_SCHEMA"]


JAX_FIXTURES, FAKE_SCHEMA = _jax_fixtures()


def test_the_shared_fixtures_cover_every_shared_rule():
    assert {f[3] for f in JAX_FIXTURES} == set(SHARED)
    assert len(JAX_FIXTURES) >= 20


@pytest.mark.parametrize("fixture", JAX_FIXTURES, ids=[f[0] for f in JAX_FIXTURES])
def test_shared_rules_give_the_jax_rules_findings(tmp_path, fixture):
    _, code, name, rule = fixture
    f = tmp_path / name
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(code))
    jax_cls, port_cls = SHARED[rule]
    # the schema rule checks both against one schema (each package's own differ)
    kw = {"schema": FAKE_SCHEMA} if rule == "TelemetrySchemaRule" else {}
    want = [(x.rule_id, x.line, x.message) for x in jax_run_paths([f], [jax_cls(**kw)])]
    got = [(x.rule_id, x.line, x.message) for x in run_paths([f], [port_cls(**kw)])]
    assert got == want


def _lint(tmp_path, code, rule, name="snippet.py"):
    f = tmp_path / name
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(code))
    return [(x.rule_id, x.line, x.message) for x in run_paths([f], [rule])]


# ------------------------------------------------------------ torch fixtures
# (rule, file name, source, [(line, message fragment)]): reds flag those
# lines, greens (no expected lines) flag nothing
TORCH_CASES = {
    "host_sync_tolist_red": (HostSyncRule, "snippet.py", """
        @register_algorithm(name="fake")
        def main(cfg):
            while policy_step < total_steps:
                losses = train(batch)
                seen = losses.tolist()
        """, [(6, "losses.tolist() host sync")]),
    "host_sync_tolist_green": (HostSyncRule, "snippet.py", """
        @register_algorithm(name="fake")
        def main(cfg):
            while policy_step < total_steps:
                done = np.nonzero(dones)[0].tolist()   # a host array
                if policy_step - last_log >= cfg.metric.log_every:
                    flush(losses.tolist())             # the log cadence
        """, []),
    "host_sync_synchronize_red": (HostSyncRule, "sac.py", """
        import torch

        class OffPolicyLoop:
            def run(self):
                while self.policy_step < self.total_steps:
                    train(g)
                    torch.cuda.synchronize()
                    done_event.synchronize()
        """, [(8, "torch.cuda.synchronize() blocks"), (9, "done_event.synchronize() blocks")]),
    "host_sync_synchronize_green": (HostSyncRule, "sac.py", """
        import torch

        class OffPolicyLoop:
            def run(self):
                torch.cuda.synchronize()                  # outside the loop
                while self.policy_step < self.total_steps:
                    train(g)
                    if cfg.dry_run:
                        torch.cuda.synchronize()

        class Other:
            def run(self):                                # not a loop holder
                while True:
                    torch.cuda.synchronize()
        """, []),
    "host_sync_metrics_cpu_red": (HostSyncRule, "snippet.py", """
        def learner_loop(cfg):
            for step in range(steps):
                metrics = train(batch)
                loss = metrics["loss"].cpu()
                for k, v in metrics.items():
                    agg.update(k, v.numpy())
                values = torch.stack(list(metrics.values())).cpu()
        """, [(5, "metrics['loss'].cpu() materializes"), (7, "v.numpy() materializes"),
              (8, "torch.stack(list(metrics.values())).cpu() materializes")]),
    "host_sync_action_cpu_green": (HostSyncRule, "ppo.py", """
        class Rollout:
            def __call__(self, buf):
                for _ in range(self.steps):
                    actions, logprobs = self.act(agent, obs, generator=self.generator)
                    host = actions.cpu().numpy()
                    self.envs.step(host)
        """, []),
    "rng_global_draw_red": (RngReuseRule, "snippet.py", """
        import torch

        def noise(shape, x):
            a = torch.randn(shape)
            b = torch.randint(0, 9, shape, device=x.device)
            x.uniform_(-1, 1)
            return torch.bernoulli(a), torch.rand_like(a)
        """, [(5, "torch.randn(...)"), (6, "torch.randint(...)"), (7, "Tensor.uniform_(...)"),
              (8, "torch.bernoulli(...)"), (8, "torch.rand_like(...)")]),
    "rng_explicit_generator_green": (RngReuseRule, "snippet.py", """
        import numpy as np
        import torch
        from torch import nn

        def noise(shape, x, gen, rng):
            a = torch.randn(shape, generator=gen)
            x.uniform_(-1, 1, generator=gen)
            nn.init.trunc_normal_(x, 0.0, 1.0)           # an initialiser: the run's seeded build
            split = rng.multinomial(16, [0.5, 0.5])       # a numpy Generator
            return torch.randperm(9, generator=gen, device=x.device), a, split
        """, []),
    "rng_seeded_in_hot_loop_red": (RngReuseRule, "snippet.py", """
        import torch

        @register_algorithm(name="fake")
        def main(cfg):
            while policy_step < total_steps:
                torch.manual_seed(cfg.seed)
                gen = torch.Generator(device="cuda").manual_seed(policy_step)
                player_gen.manual_seed(7)
        """, [(7, "torch.manual_seed(...)` seeds"), (8, "torch.Generator(...)` seeds"),
              (9, "player_gen.manual_seed(...)` seeds")]),
    "rng_seeded_once_green": (RngReuseRule, "snippet.py", """
        import torch

        @register_algorithm(name="fake")
        def main(cfg):
            torch.manual_seed(cfg.seed)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(cfg.seed)
            while policy_step < total_steps:
                act(generator=gen)

        def make_slots(n):
            return [torch.Generator().manual_seed(i) for i in range(n)]   # not a hot loop
        """, []),
    "pspec_outside_parallel_red": (PspecLiteralRule, "algos/red.py", """
        import torch.distributed as tdist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

        def stage(x, dist):
            mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("dp", "tp"))
            g = tdist.new_group([0, 1])
            t = distribute_tensor(x, mesh, [Shard(0), Replicate()])
            y = DTensor.from_local(x, mesh, [Replicate()])
            sub = dist.device_mesh["tp"]
            tdist.all_reduce(x, group="dp")
            return mesh.get_group("fsdp")
        """, [(7, "init_device_mesh(...)"), (8, "new_group(...)"), (9, "distribute_tensor(...)"),
              (9, "Shard(...)"), (9, "Replicate(...)"), (10, "DTensor.from_local(...)"), (10, "Replicate(...)"),
              (11, "'tp' indexes `dist.device_mesh`"), (12, "'dp' as group="), (13, "'fsdp' passed to `get_group")]),
    "pspec_engine_helpers_green": (PspecLiteralRule, "algos/green.py", """
        import torch.distributed as tdist

        def stage(x, dist, cfg):
            tdist.all_reduce(x, group=dist.data_group)       # the mesh's own group
            sizes = {"dp": 2, "tp": 1}                        # plain dict keys are data
            axis = "dp" if cfg.fabric.mesh["dp"] > 1 else "tp"   # a config section, not a DeviceMesh
            return dist.all_gather(x), axis, sizes
        """, []),
}
# pspec-literal inside parallel/: the mesh subsystem owns these
TORCH_CASES["pspec_inside_parallel_green"] = (PspecLiteralRule, "parallel/mesh.py",
                                              TORCH_CASES["pspec_outside_parallel_red"][2], [])


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_torch_fixtures(tmp_path, case):
    rule, name, code, want = TORCH_CASES[case]
    got = _lint(tmp_path, code, rule(), name=name)
    assert all(rule_id == rule.rule_id for rule_id, _, _ in got)
    assert len(got) == len(want), got
    for (line, fragment), (_, got_line, msg) in zip(sorted(want), sorted(got, key=lambda x: (x[1], x[2]))):
        assert got_line == line and fragment in msg, (got, want)


# ---------------------------------------------------------------- the CLI
RED = """
import torch

def noise(shape):
    return torch.randn(shape)
"""


def test_cli_exit_codes_and_json_roundtrip(tmp_path, capsys):
    red, green = tmp_path / "red.py", tmp_path / "green.py"
    red.write_text(RED)
    green.write_text("x = 1\n")
    assert lint_main([str(green)]) == 0
    assert capsys.readouterr().out.strip() == "sheeprl_tpu_torch lint: clean (1 files, 7 rules)"
    assert lint_main([str(red), "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["version"] == 1
    (finding,) = out["findings"]
    assert set(finding) == {"rule_id", "file", "line", "severity", "message", "remediation"}  # the JAX keys
    assert finding["rule_id"] == "rng-reuse" and finding["file"] == str(red) and finding["line"] == 5
    assert finding["severity"] == "error"
    assert lint_main([str(red)]) == 1
    assert "sheeprl_tpu_torch lint: 1 finding(s) across 1 file(s)" in capsys.readouterr().out
    assert lint_main([str(green), "--no-such-flag"]) == 2


@pytest.mark.parametrize("rules,code", [("host-sync", 0), ("rng-reuse,host-sync", 1), ("no-such-rule", 2),
                                        ("retrace-hazard", 2), ("use-after-donate", 2),
                                        ("rng-reuse,use-after-donate", 2)])
def test_cli_rule_filter_and_the_rules_that_are_not_ported(tmp_path, capsys, rules, code):
    red = tmp_path / "red.py"
    red.write_text(RED)
    assert lint_main([str(red), "--rule", rules]) == code
    err = capsys.readouterr().err
    for rule_id, why in NOT_PORTED.items():
        if rule_id in rules:
            assert f"rule {rule_id!r} is not in the PyTorch port: {why}" in err
    if rules == "no-such-rule":
        assert "unknown rule(s)" in err


def test_cli_list_rules(capsys):
    assert lint_main(["--list-rules"]) == 0
    listed = [line.split(":", 1)[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == [r.rule_id for r in all_rules()]
    assert listed == ["host-sync", "rng-reuse", "thread-shared-state", "telemetry-schema-drift", "socket-timeout",
                      "pspec-literal", "hot-loop-emit"]


# ------------------------------------------------------------- the hot set
SAC, DV2 = "algos/sac/sac.py", "algos/dreamer_v2/dreamer_v2.py"
PPO, P2E3 = "algos/ppo/ppo.py", "algos/p2e_dv3/p2e_dv3_exploration.py"
OFF = [(SAC, "OffPolicyLoop.run")]
# each registered entry point -> the chain of calls from it to the function
# whose loop steps its envs (file under sheeprl_tpu_torch/, qualified name)
PER_STEP_LOOPS = {
    "ppo": [(PPO, "main"), (PPO, "Rollout.__call__")],
    "a2c": [("algos/a2c/a2c.py", "main"), (PPO, "Rollout.__call__")],
    "ppo_decoupled": [("algos/ppo/ppo_decoupled.py", "main"), (PPO, "Rollout.__call__")],
    "ppo_recurrent": [("algos/ppo_recurrent/ppo_recurrent.py", "main")],
    "sac": [(SAC, "main"), *OFF],
    "sac_decoupled": [("algos/sac/sac_decoupled.py", "main"), ("algos/sac/sac_decoupled.py", "_Player.run")],
    "droq": [("algos/droq/droq.py", "main"), *OFF],
    "sac_ae": [("algos/sac_ae/sac_ae.py", "main"), *OFF],
    "dreamer_v3": [("algos/dreamer_v3/dreamer_v3.py", "main")],
    "dreamer_v2": [(DV2, "main"), (DV2, "run_dreamer"), (DV2, "run_serial"), *OFF],
    "dreamer_v1": [("algos/dreamer_v1/dreamer_v1.py", "main"), (DV2, "run_dreamer"), (DV2, "run_serial"), *OFF],
    "p2e_dv3_exploration": [(P2E3, "main"), (P2E3, "run_serial"), *OFF],
    "p2e_dv3_finetuning": [("algos/p2e_dv3/p2e_dv3_finetuning.py", "main"), (P2E3, "run_serial"), *OFF],
    "p2e_dv2_exploration": [("algos/p2e_dv2/p2e_dv2_exploration.py", "main"), (DV2, "run_serial"), *OFF],
    "p2e_dv2_finetuning": [("algos/p2e_dv2/p2e_dv2_finetuning.py", "main"),
                           ("algos/p2e_dv2/p2e_dv2_finetuning.py", "finetune"), (DV2, "run_serial"), *OFF],
    "p2e_dv1_exploration": [("algos/p2e_dv1/p2e_dv1_exploration.py", "main"), (DV2, "run_serial"), *OFF],
    "p2e_dv1_finetuning": [("algos/p2e_dv1/p2e_dv1_finetuning.py", "main"),
                           ("algos/p2e_dv2/p2e_dv2_finetuning.py", "finetune"), (DV2, "run_serial"), *OFF],
}


def _function(rel: str, qualname: str) -> ast.FunctionDef:
    tree = ast.parse((PORT / rel).read_text())
    node = tree
    for part in qualname.split("."):
        node = next(n for n in node.body if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name == part)
    return node


def _references(fn: ast.FunctionDef, qualname: str) -> bool:
    """Whether ``fn`` reaches ``qualname``: a function by its name; a method
    ``C.m`` through its class and the method's name; ``C.__call__`` through
    its class (the instance is what gets called)."""
    names = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)} | {
        n.attr for n in ast.walk(fn) if isinstance(n, ast.Attribute)}
    parts = qualname.split(".")
    if len(parts) == 1:
        return parts[0] in names
    return parts[0] in names and (parts[1] == "__call__" or parts[1] in names)


def test_every_registered_entry_point_has_a_scanned_per_step_loop():
    from sheeprl_tpu_torch.cli import _register
    from sheeprl_tpu_torch.utils.registry import algorithm_registry

    _register()
    assert set(PER_STEP_LOOPS) == set(algorithm_registry), "an entry point without a scanned per-step loop"
    for name, chain in PER_STEP_LOOPS.items():
        info = algorithm_registry[name]
        assert (chain[0][0].replace("/", ".")[:-3], chain[0][1]) == (
            info["module"][len("sheeprl_tpu_torch."):], info["entrypoint"]), name
        for (rel, qual), (_, callee) in zip(chain, chain[1:]):
            assert _references(_function(rel, qual), callee), f"{name}: {qual} does not reach {callee}"
        rel, qual = chain[-1]
        tree = ast.parse((PORT / rel).read_text())
        hot = {q: fn for fn, q in hot_functions(tree)}
        assert qual in hot, f"{name}: {rel}:{qual} is not in host-sync's hot set"
        checker = scan_hot_function(PORT / rel, [], hot[qual])
        assert checker.loops_seen > 0, f"{name}: host-sync scans no loop in {qual}"


# ------------------------------------------------------------ the port's tree
def test_the_ports_tree_lints_clean():
    findings = run_paths([PORT], all_rules())
    assert findings == [], "\n".join(f.render() for f in findings)


def test_the_lint_command_on_the_ports_tree(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("SHEEPRL_TPU_LINT_LIGHT", None)
    proc = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch", "lint"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_files = len(list(PORT.rglob("*.py")))
    assert proc.stdout.strip().splitlines()[-1] == f"sheeprl_tpu_torch lint: clean ({n_files} files, 7 rules)"
