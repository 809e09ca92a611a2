"""What the data-parallel tests (tests/test_torch_mesh*.py,
test_torch_decoupled.py) run on each rank, and the launch that runs it.

Nothing here imports JAX or the JAX package: spawned ranks import this
module (and the port) alone, so they start in about two seconds. The parent
hands a rank its inputs as one ``torch.save`` payload (modules, optimizer
states, numpy batches and pre-drawn noise) and reads each rank's outputs back
from ``rank_<d>.pt``.

* ``launch_ranks(fn, payload, tmp_path, world)`` runs ``fn(dist, payload)``
  on ``world`` gloo ranks (a ``file://`` rendezvous under ``tmp_path``, every
  collective bounded by ``timeout_s``, the ranks killed past ``deadline_s``);
  ``run_here(fn, payload)`` runs it in this process at world size 1;
* ``dv3_step``, ``ppo_update``, ``sac_burst``: one train step of DreamerV3,
  PPO and SAC on the rank's column block of a global batch (the JAX
  package's batch sharding);
* ``run_cli(argv, ...)``: a CLI run (``run_algorithm``'s launch) with a
  deadline.
"""
from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.config import Config, compose, instantiate
from sheeprl_tpu_torch.parallel import mesh

TIMEOUT_S = 60.0
DEADLINE_S = 120.0


def _entry(fn: Callable, payload_path: str, out_dir: str, cfg: Any) -> None:
    dist = mesh.current(cfg)
    payload = torch.load(payload_path, weights_only=False)
    out = fn(dist, payload)
    torch.save(out, os.path.join(out_dir, f"rank_{dist.rank}.pt"))


def fabric(tmp_path: Path, world: int) -> Dict[str, Any]:
    return {"devices": world, "accelerator": "cpu", "strategy": "auto", "rendezvous_dir": str(tmp_path / "rdv"),
            "timeout_s": TIMEOUT_S}


def launch_ranks(fn: Callable, payload: Dict[str, Any], tmp_path: Path, world: int = 2,
                 deadline_s: float = DEADLINE_S) -> List[Any]:
    """``fn(dist, payload)`` on ``world`` spawned gloo ranks; their returns."""
    tmp_path = Path(tmp_path)
    out_dir = tmp_path / f"out_{fn.__name__}"
    out_dir.mkdir(parents=True, exist_ok=True)
    payload_path = tmp_path / f"payload_{fn.__name__}.pt"
    torch.save(payload, payload_path)
    cfg = Config({"fabric": fabric(tmp_path, world)})
    mesh.launch(functools.partial(_entry, fn, str(payload_path), str(out_dir)), cfg, deadline_s=deadline_s)
    return [torch.load(out_dir / f"rank_{d}.pt", weights_only=False) for d in range(world)]


def run_here(fn: Callable, payload: Dict[str, Any]) -> Any:
    """``fn`` at world size 1 in this process (no process group)."""
    dist = mesh.build_distributed(Config({"fabric": {"devices": 1, "accelerator": "cpu"}}))
    return fn(dist, payload)


def columns(x: np.ndarray, axis: int, rank: int, world: int) -> np.ndarray:
    """Rank ``rank``'s block of ``x`` along ``axis``."""
    n = x.shape[axis] // world
    return np.take(x, np.arange(rank * n, (rank + 1) * n), axis=axis)


def _tb_columns(x: np.ndarray, lead: int, T: int, rank: int, world: int) -> np.ndarray:
    """A ``[*lead, T·B, ...]`` draw (states flattened t-major) cut to the
    rank's batch columns, flattened again."""
    shape = x.shape
    y = x.reshape(*shape[:lead], T, shape[lead] // T, *shape[lead + 1:])
    y = columns(y, lead + 1, rank, world)
    return y.reshape(*shape[:lead], -1, *shape[lead + 1:])


def dv3_noise_columns(noise: Dict[str, Any], T: int, rank: int, world: int) -> Dict[str, Any]:
    """DreamerV3's per-step draws (``draw_train_noise``'s layout) for the
    rank's batch columns."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    return {"post": t(columns(np.asarray(noise["post"]), 1, rank, world)),
            "act0": [t(_tb_columns(np.asarray(a), 0, T, rank, world)) for a in noise["act0"]],
            "img_z": t(_tb_columns(np.asarray(noise["img_z"]), 1, T, rank, world)),
            "img_a": [t(_tb_columns(np.asarray(a), 1, T, rank, world)) for a in noise["img_a"]]}


def dv3_step(dist: Any, p: Dict[str, Any]) -> Dict[str, Any]:
    """One DreamerV3 burst on the rank's columns of ``p["batch"]`` ``[G, T,
    B, ...]`` with ``p["noise"]`` (one ``draw_train_noise`` dict per step,
    global), from ``p["modules"]`` and ``p["opt_states"]``."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import MomentsState

    cfg = Config(p["cfg"])
    wm, actor, critic, target = (p["modules"][k] for k in ("wm", "actor", "critic", "target_critic"))
    coll = dist if dist.collective else None
    opts = tdv3.build_optimizers(cfg, wm, actor, critic, coll)
    for name in ("wm", "actor", "critic"):
        getattr(opts, name).optimizer.load_state_dict(p["opt_states"][name])
    train = tdv3.make_train_fn(wm, actor, critic, target, opts, cfg, False, p["actions_dim"], dist=coll)
    world, rank = dist.world_size, dist.rank
    T = p["batch"]["rewards"].shape[1]
    batch = {k: torch.from_numpy(np.ascontiguousarray(columns(v, 2, rank, world))) for k, v in p["batch"].items()}
    noise = [dv3_noise_columns(n, T, rank, world) for n in p["noise"]]
    moments, metrics = train(MomentsState(torch.tensor(0.0), torch.tensor(0.0)), batch, noise=noise)
    return {"state": {k: m.state_dict() for k, m in zip(("wm", "actor", "critic", "target_critic"),
                                                        (wm, actor, critic, target))},
            "opt_states": {k: getattr(opts, k).optimizer.state_dict() for k in ("wm", "actor", "critic")},
            "moments": (float(moments.low), float(moments.high)),
            "metrics": {k: float(v.mean()) for k, v in metrics.items()}, "stats": dict(dist.stats)}


def ppo_update(dist: Any, p: Dict[str, Any]) -> Dict[str, Any]:
    """One PPO update on the whole rollout ``p["data"]`` with the
    permutations ``p["perms"]``: the rank trains on its slice of each global
    minibatch of ``p["mb_size"]`` rows."""
    from sheeprl_tpu_torch.algos.ppo.ppo import make_update_fn
    from sheeprl_tpu_torch.optim import clipped

    cfg, agent = Config(p["cfg"]), p["agent"]
    coll = dist if dist.collective else None
    opt = clipped(instantiate(cfg.algo.optimizer, list(agent.parameters())), cfg.algo.select("max_grad_norm"), coll)
    opt.optimizer.load_state_dict(p["opt_state"])
    update = make_update_fn(agent, opt, cfg, p["data"]["advantages"].shape[0] // p["mb_size"], p["mb_size"], coll)
    coefs = {k: torch.tensor(v, dtype=torch.float32) for k, v in p["coefs"].items() if k != "lr_frac"}
    coefs["lr_frac"] = float(p["coefs"].get("lr_frac", 1.0))
    data = {k: torch.from_numpy(np.array(v)) for k, v in p["data"].items()}
    metrics = update(data, coefs, torch.from_numpy(p["perms"]))
    return {"agent": agent.state_dict(), "metrics": {k: float(v) for k, v in metrics.items()},
            "opt_state": opt.optimizer.state_dict(), "stats": dict(dist.stats)}


def sac_burst(dist: Any, p: Dict[str, Any]) -> Dict[str, Any]:
    """One SAC burst on the rank's columns of ``p["batches"]`` ``[G, B, ...]``
    with ``p["noise"]`` ``[G, 2, B, A]`` (global)."""
    from sheeprl_tpu_torch.algos.sac.sac import build_optimizers, make_train_fn

    cfg, agent = Config(p["cfg"]), p["agent"]
    opts = build_optimizers(cfg, agent)
    opts.load_state_dict(p["opt_states"])
    train = make_train_fn(agent, opts, cfg, p["target_entropy"], dist=dist if dist.collective else None)
    world, rank = dist.world_size, dist.rank
    batches = {k: torch.from_numpy(np.ascontiguousarray(columns(v, 1, rank, world))) for k, v in p["batches"].items()}
    noise = torch.from_numpy(np.ascontiguousarray(columns(p["noise"], 2, rank, world)))
    metrics = train(batches, noise=noise)
    return {"agent": agent.state_dict(), "opt_states": opts.state_dict(),
            "metrics": {k: float(v) for k, v in metrics.items()}, "stats": dict(dist.stats)}


def run_cli(argv: Sequence[str], deadline_s: float = DEADLINE_S) -> None:
    """``run <argv>`` as the CLI runs it (``check_configs``, then the mesh
    launch of the registered entry point), the spawned ranks bounded by
    ``deadline_s``."""
    from sheeprl_tpu_torch import cli

    cfg = compose("config", list(argv))
    if cfg.select("checkpoint.resume_from"):
        cfg = cli.resume_from_checkpoint(cfg)
    cli.check_configs(cfg)
    mesh.launch(functools.partial(cli._run_registered, cfg.algo.name), cfg, deadline_s=deadline_s)


def collectives(dist: Any, p: Dict[str, Any]) -> Dict[str, Any]:
    """Each collective once on rank-dependent values."""
    x = torch.full((3,), float(dist.rank + 1))
    dist.all_reduce_mean([x])
    parts = dist.all_gather(torch.tensor([float(dist.rank)]))
    b = torch.tensor([float(dist.rank)])
    dist.broadcast([b], src=1)
    chunk = dist.scatter([torch.tensor([10.0]), torch.tensor([20.0])] if dist.rank == 0 else None,
                         torch.zeros(1))
    return {"mean": x, "gathered": parts, "broadcast": b, "scattered": chunk,
            "objects": dist.all_gather_object({"rank": dist.rank}), "any": dist.any(dist.rank == 1),
            "backend": dist.backend, "stats": dict(dist.stats)}


def fail_on_rank_1(dist: Any, p: Dict[str, Any]) -> None:
    import time

    if dist.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    time.sleep(600)  # rank 0 would run on: the launch ends it


def sleep_long(dist: Any, p: Dict[str, Any]) -> None:
    import time

    time.sleep(600)
