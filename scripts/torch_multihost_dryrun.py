"""Two nodes of two gloo ranks each on this host: the PyTorch port's
``fabric.num_nodes=2`` (counterpart of ``scripts/multihost_dryrun.py``).

The parent starts two node processes with the environment ``torchrun``
gives a node (``GROUP_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``); each calls ``parallel/mesh.launch`` with
``fabric.num_nodes=2 fabric.devices=2``, which spawns its two ranks (global
rank = node rank × 2 + local rank). Each rank, in turn:

1. asserts the topology: world size 4, its global rank and mesh coordinate;
2. runs a cross-process all-reduce (ranks on both nodes contribute);
3. lays out a module's Adam state with ZeRO-1 (``fabric.shard_optimizer_state``):
   a leaf of 2**16 elements stays sharded over dp, a quarter on each rank,
   and one optimizer step keeps every rank's parameter whole and equal;
4. checkpoints: every rank gathers the whole moments (``full_opt_state``),
   only rank 0 writes the file;
5. reads it back on every rank, lays it out again and gathers it whole: the
   round trip is exact.

The parent prints one JSON line, ``{"ok": true, ...}`` when both nodes and
all four ranks passed, and exits 0; else the tails of their output and 1.

Usage: ``python scripts/torch_multihost_dryrun.py`` (about 15 s on the CPU).
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NODES = 2
DEVICES_PER_NODE = 2
BUDGET_S = float(os.environ.get("MULTIHOST_BUDGET_S", 240))


def rank_checks(cfg) -> None:
    import torch
    from torch import nn

    from sheeprl_tpu_torch.optim import clipped
    from sheeprl_tpu_torch.parallel import mesh
    from sheeprl_tpu_torch.utils.checkpoint import CheckpointManager

    dist = mesh.current(cfg)
    world = NODES * DEVICES_PER_NODE
    node = int(os.environ["GROUP_RANK"])
    # 1) topology
    assert dist.world_size == world and dist.num_nodes == NODES and dist.collective
    assert node * DEVICES_PER_NODE <= dist.rank < (node + 1) * DEVICES_PER_NODE
    assert dist.coordinate == (dist.rank, 0, 0) and dist.is_global_zero == (dist.rank == 0)
    assert torch.distributed.get_world_size() == world and torch.distributed.get_rank() == dist.rank

    # 2) a cross-process all-reduce
    total = dist.all_reduce_sum(torch.full((8,), float(dist.rank + 1)))
    assert torch.equal(total, torch.full((8,), float(sum(range(1, world + 1)))))

    # 3) ZeRO-1: the moments of a replicated leaf sharded over dp
    def build():
        torch.manual_seed(0)
        m = nn.Module()
        m.add_module("fc", nn.Linear(64, 1024, bias=False))  # kernel [64, 1024]: 2**16 elements
        opt = clipped(torch.optim.Adam(list(m.parameters()), lr=1e-3), 100.0, dist)
        return m, opt

    def lay_out(m, opt):
        layout = mesh.maybe_shard_params(cfg, dist, {"m": m})
        mesh.maybe_shard_opt_state(cfg, dist, layout, {"m": (opt, m)})
        return layout

    m, opt = build()
    layout = lay_out(m, opt)
    reports = {r.group: r for r in dist.take_sharding_reports()}
    dec = next(d for d in reports["opt_state"].decisions if d.path == "m/1/0/mu/fc/kernel")
    assert (dec.rule, dec.spec) == ("zero1", ("dp", None)), dec
    opt.zero_grad()
    m.fc.weight.grad = torch.full_like(m.fc.weight, float(dist.rank))
    opt.step()
    moments = opt.optimizer.state[opt.params[0]]["exp_avg"]
    assert tuple(moments.shape) == (1024, 64 // world), moments.shape  # torch dim 1 is flax dim 0
    assert layout.opt_local_bytes(opt) == reports["opt_state"].bytes_per_chip - 4  # less optax's count
    weights = dist.all_gather(m.fc.weight.detach()[None])
    assert all(torch.equal(w, weights[0]) for w in weights), "the parameter differs between ranks"

    # 4) every rank gathers, rank 0 writes
    whole = layout.full_opt_state(opt)
    workdir = cfg.select("dryrun_dir")
    cm = CheckpointManager(workdir, enabled=dist.is_global_zero)
    path = cm.save(7, {"m": m.state_dict(), "opt": whole, "step": 7})
    assert (path is not None) == dist.is_global_zero, path
    torch.distributed.barrier()
    files = sorted(os.listdir(os.path.join(workdir, "checkpoint")))
    assert files == ["ckpt_7.ckpt"], files

    # 5) read back everywhere, laid out again, gathered whole
    loaded = CheckpointManager.load(os.path.join(workdir, "checkpoint", "ckpt_7.ckpt"))
    assert torch.equal(loaded["opt"]["state"][0]["exp_avg"], whole["state"][0]["exp_avg"])
    m2, opt2 = build()
    m2.load_state_dict(loaded["m"])
    opt2.optimizer.load_state_dict(loaded["opt"])
    layout2 = lay_out(m2, opt2)
    dist.take_sharding_reports()
    again = layout2.full_opt_state(opt2)
    for k in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(again["state"][0][k], whole["state"][0][k]), k
    assert torch.equal(m2.fc.weight, m.fc.weight)
    print(f"[rank {dist.rank} node {node}] OK " + json.dumps({"all_reduce": float(total[0]),
                                                               "moments_shape": list(moments.shape)}), flush=True)


def node(node_rank: int, workdir: str) -> None:
    from sheeprl_tpu_torch.config import Config
    from sheeprl_tpu_torch.parallel import mesh

    cfg = Config({"fabric": {"devices": DEVICES_PER_NODE, "num_nodes": NODES, "accelerator": "cpu",
                             "strategy": "ddp", "shard_optimizer_state": True, "timeout_s": 120.0},
                  "dryrun_dir": workdir})
    mesh.launch(rank_checks, cfg, deadline_s=BUDGET_S)
    print(f"[node {node_rank}] OK", flush=True)


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--node":
        node(int(sys.argv[2]), sys.argv[3])
        return
    with socket.socket() as s:  # a free port on this host for the rendezvous
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        procs = []
        for r in range(NODES):
            env = {**os.environ, "GROUP_RANK": str(r), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                   "WORLD_SIZE": str(NODES * DEVICES_PER_NODE), "OMP_NUM_THREADS": "1",
                   "PYTHONPATH": os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")]))}
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--node", str(r), workdir],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
                                          env=env))
        outs, rcs = [], []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=BUDGET_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += "\n[parent] TIMEOUT"
            outs.append(out)
            rcs.append(p.returncode)
    ranks_ok = sum(o.count("] OK {") for o in outs)
    ok = all(rc == 0 for rc in rcs) and ranks_ok == NODES * DEVICES_PER_NODE and all(
        f"[node {r}] OK" in o for r, o in enumerate(outs))
    rec = {"kind": "torch_multihost_dryrun", "ok": ok, "nodes": NODES, "devices_per_node": DEVICES_PER_NODE,
           "ranks_ok": ranks_ok, "rcs": rcs, "elapsed_seconds": round(time.perf_counter() - t0, 1),
           "checks": ["topology: global rank = node rank x devices + local rank",
                      "cross-process all-reduce over both nodes",
                      "ZeRO-1 moments stay dp-sharded, the parameter whole on every rank",
                      "every rank gathers the checkpoint, rank 0 alone writes it",
                      "read back, laid out again, gathered whole: exact"]}
    if not ok:
        rec["tails"] = [o[-1500:] for o in outs]
    print(json.dumps(rec))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
