"""``scripts/torch_multihost_dryrun.py``: two node processes of two gloo ranks
each under ``fabric.num_nodes=2`` (the topology, a cross-process all-reduce,
a ZeRO-1 leaf that stays dp-sharded, a checkpoint every rank gathers and
rank 0 alone writes, its exact round trip), within a bound."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND_S = 120


def test_two_nodes_of_two_ranks_dryrun():
    env = {**os.environ, "MULTIHOST_BUDGET_S": str(BOUND_S)}
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_multihost_dryrun.py")],
                          capture_output=True, text=True, timeout=BOUND_S + 30, env=env, cwd=REPO)
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and rec["ok"], rec
    assert (rec["nodes"], rec["devices_per_node"], rec["ranks_ok"]) == (2, 2, 4)
    assert rec["elapsed_seconds"] < BOUND_S
