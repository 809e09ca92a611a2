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
  deadline;
* ``run_jobs``: a list of jobs in one launch, each a train step of another
  algorithm on the rank's columns (``droq_step``, ``sac_ae_step``,
  ``dreamer_step``, ``p2e_step``, ``a2c_update``, ``ppo_recurrent_update``)
  or a CLI run in the ranks' own group (``cli_job``);
  ``launch_steps_and_runs`` runs a file's CLI runs in a second launch while
  its JAX references are computed.
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

# bounds on a hang, not on the work, from a whole tier-1 run (six workers
# sharing the host's cores): DEADLINE_S, a launch's and a CLI child's wait,
# is twice the longest two-rank launch seen there (117 s, its test's whole
# time); TIMEOUT_S, every gloo collective's and the rendezvous's, is far
# above the longest wait a rank had there in one of them (5 s)
TIMEOUT_S = 60.0
DEADLINE_S = 240.0


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
        cfg = cli.resume_from_checkpoint(cfg, argv)
    cli.check_configs(cfg)
    exploration = None
    if cli.get_algorithm(cfg.algo.name).get("requires_exploration_cfg"):
        exploration = cli.exploration_surgery(cfg).to_dict()
    mesh.launch(functools.partial(cli._run_registered, cfg.algo.name, exploration=exploration), cfg,
                deadline_s=deadline_s)


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


# -- the other algorithms (tests/test_torch_mesh_{offpolicy,onpolicy,p2e}.py) --
# One launch per file: ``run_jobs`` runs a list of jobs on each rank, each a
# train step (its inputs already cut to every rank's columns by the parent,
# ``job["ranks"][rank]``) or a CLI run in the ranks' own process group.
def _t(tree: Any) -> Any:
    """numpy leaves → tensors (lists and dicts kept)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_t(v) for v in tree)
    return torch.from_numpy(np.ascontiguousarray(tree)) if isinstance(tree, np.ndarray) else tree


def _floats(metrics: Dict[str, Any]) -> Dict[str, Any]:
    return {k: np.asarray(v.detach() if torch.is_tensor(v) else v, dtype=np.float64) for k, v in metrics.items()}


def droq_step(dist: Any, job: Dict[str, Any], mine: Dict[str, Any]) -> Dict[str, Any]:
    """One DroQ burst on the rank's columns with the JAX step's draws and masks."""
    from sheeprl_tpu_torch.algos.droq.droq import make_train_fn
    from sheeprl_tpu_torch.algos.sac.sac import build_optimizers

    cfg, agent = Config(job["cfg"]), job["agent"]
    opts = build_optimizers(cfg, agent)
    opts.load_state_dict(job["opt_states"])
    train = make_train_fn(agent, opts, cfg, job["target_entropy"], dist=dist if dist.collective else None)
    metrics = train(_t(mine["critic_batches"]), _t(mine["actor_batch"]), draws=_t(mine["draws"]))
    return {"agent": agent.state_dict(), "opt_states": opts.state_dict(), "metrics": _floats(metrics)}


def sac_ae_step(dist: Any, job: Dict[str, Any], mine: Dict[str, Any]) -> Dict[str, Any]:
    """One SAC-AE burst on the rank's columns with the JAX step's draws."""
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import build_optimizers, make_train_fn

    cfg, agent = Config(job["cfg"]), job["agent"]
    opts = build_optimizers(cfg, agent)
    opts.load_state_dict(job["opt_states"])
    train = make_train_fn(agent, opts, cfg, job["target_entropy"], ("rgb",), ("state",),
                          dist=dist if dist.collective else None)
    metrics = train(_t(mine["batches"]), draws=_t(mine["draws"]))
    return {"agent": agent.state_dict(), "opt_states": opts.state_dict(), "metrics": _floats(metrics)}


def dreamer_step(dist: Any, job: Dict[str, Any], mine: Dict[str, Any]) -> Dict[str, Any]:
    """One DreamerV2 or V1 burst (``job["algo"]``) on the rank's columns
    with the JAX step's draws."""
    import importlib

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers

    algo = importlib.import_module(f"sheeprl_tpu_torch.algos.{job['algo']}.{job['algo']}")
    cfg, mods = Config(job["cfg"]), job["modules"]
    opts = build_optimizers(cfg, *mods[:3], dist if dist.collective else None)
    for name in ("wm", "actor", "critic"):
        getattr(opts, name).optimizer.load_state_dict(job["opt_states"][name])
    train = algo.make_train_fn(*mods, opts, cfg, job["continuous"], job["actions_dim"])
    metrics = train(_t(mine["batch"]), noise=_t(mine["noise"]))
    return {"state": [m.state_dict() for m in mods], "step": opts.step, "metrics": _floats(metrics),
            "opt_states": {k: getattr(opts, k).optimizer.state_dict() for k in ("wm", "actor", "critic")}}


def p2e_step(dist: Any, job: Dict[str, Any], mine: Dict[str, Any]) -> Dict[str, Any]:
    """One Plan2Explore exploration burst (``job["algo"]``: p2e_dv3 or
    p2e_dv2) on the rank's columns with the JAX step's draws."""
    coll = dist if dist.collective else None
    cfg, mods = Config(job["cfg"]), job["modules"]
    out: Dict[str, Any] = {}
    if job["algo"] == "p2e_dv3":
        from sheeprl_tpu_torch.algos.dreamer_v3.utils import MomentsState
        from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as p2e

        opts = p2e.build_optimizers(cfg, mods, coll)
        opts.load_state_dict(job["opt_states"])
        train = p2e.make_train_fn(mods, opts, cfg, job["continuous"], job["actions_dim"], dist=coll)
        moments = job.get("moments") or {"task": MomentsState(torch.tensor(0.0), torch.tensor(0.0)),
                                         "exploration": {k: MomentsState(torch.tensor(0.0), torch.tensor(0.0))
                                                         for k in cfg.algo.critics_exploration}}
        moments, metrics = train(moments, _t(mine["batch"]), noise=_t(mine["noise"]))
        out["moments"] = {"task": (float(moments["task"].low), float(moments["task"].high)),
                          **{k: (float(m.low), float(m.high)) for k, m in moments["exploration"].items()}}
    else:
        from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration as p2e

        opts = p2e.build_optimizers(cfg, mods, coll)
        opts.load_state_dict(job["opt_states"])
        train = p2e.make_train_fn(mods, opts, cfg, job["continuous"], job["actions_dim"])
        metrics = train(_t(mine["batch"]), noise=_t(mine["noise"]))
    return {**out, "state": {k: m.state_dict() for k, m in mods.items()}, "opt_states": opts.state_dict(),
            "metrics": _floats(metrics)}


def a2c_update(dist: Any, job: Dict[str, Any], mine: Dict[str, Any]) -> Dict[str, Any]:
    """One A2C update on the rank's rows of the rollout."""
    from sheeprl_tpu_torch.algos.a2c.a2c import build_optimizer, make_update_fn

    cfg, agent = Config(job["cfg"]), job["agent"]
    coll = dist if dist.collective else None
    opt = build_optimizer(cfg, agent, coll)
    opt.optimizer.load_state_dict(job["opt_state"])
    metrics = make_update_fn(agent, opt, cfg, coll)(_t(mine["data"]))
    return {"agent": agent.state_dict(), "metrics": _floats(metrics), "opt_state": opt.optimizer.state_dict()}


def ppo_recurrent_update(dist: Any, job: Dict[str, Any], mine: Any) -> Dict[str, Any]:
    """One recurrent PPO update on the whole set of sequences with the JAX
    permutations: the rank trains on its block of each global minibatch."""
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import make_update_fn
    from sheeprl_tpu_torch.optim import clipped

    cfg, agent = Config(job["cfg"]), job["agent"]
    coll = dist if dist.collective else None
    opt = clipped(instantiate(cfg.algo.optimizer, [p for p in agent.parameters() if p.requires_grad]),
                  cfg.algo.select("max_grad_norm"), coll)
    opt.optimizer.load_state_dict(job["opt_state"])
    S, mb = job["data"]["advantages"].shape[0], job["mb_size"]
    coefs = {k: torch.tensor(v, dtype=torch.float32) for k, v in job["coefs"].items() if k != "lr_frac"}
    coefs["lr_frac"] = float(job["coefs"].get("lr_frac", 1.0))
    metrics = make_update_fn(agent, opt, cfg, S // mb, mb, coll)(_t(job["data"]), coefs, torch.from_numpy(job["perms"]))
    return {"agent": agent.state_dict(), "metrics": _floats(metrics), "opt_state": opt.optimizer.state_dict()}


def cli_job(dist: Any, job: Dict[str, Any], mine: Any) -> Dict[str, Any]:
    """``run <job["argv"]>`` on these ranks, in their process group (the
    CLI's checks and, for a finetuning entry point, its surgery, on each
    rank); what it printed on stdout and stderr. One intra-op thread a
    rank: the models are tiny, and the tier-1 run's workers share the
    host's cores, where more threads a rank only wait on each other."""
    import contextlib
    import io

    from sheeprl_tpu_torch import cli

    torch.set_num_threads(1)

    cfg = compose("config", list(job["argv"]))
    if cfg.select("checkpoint.resume_from"):
        cfg = cli.resume_from_checkpoint(cfg, job["argv"])
    cli.check_configs(cfg)
    exploration = None
    if cli.get_algorithm(cfg.algo.name).get("requires_exploration_cfg"):
        exploration = cli.exploration_surgery(cfg).to_dict()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli._run_registered(cfg.algo.name, cfg, exploration=exploration)
    return {"stdout": out.getvalue(), "stderr": err.getvalue()}


JOBS = {"droq": droq_step, "sac_ae": sac_ae_step, "dreamer": dreamer_step, "p2e": p2e_step, "a2c": a2c_update,
        "ppo_recurrent": ppo_recurrent_update, "cli": cli_job}


def run_jobs(dist: Any, p: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Each job of ``p["jobs"]`` in order (``JOBS[job["kind"]]``), each with
    the collectives it ran (``stats``); the ranks meet after every job, so a
    checkpoint rank 0 wrote is there for the next job on every rank."""
    outs = []
    for job in p["jobs"]:
        dist.reset_stats()
        mine = job["ranks"][dist.rank] if "ranks" in job else None
        out = JOBS[job["kind"]](dist, job, mine)
        out["stats"] = dict(dist.stats)
        dist.broadcast_object(None)
        outs.append(out)
    return outs


def launch_steps_and_runs(build_steps: Callable[[], Any], runs: Sequence[Dict[str, Any]], tmp_path: Path,
                          world: int = 2, deadline_s: float = DEADLINE_S):
    """A file's two launches: its CLI ``runs`` (``cli`` jobs) on ``world``
    ranks in the background while ``build_steps()`` computes the JAX
    references here and returns ``(step jobs, references)``, then the step
    jobs in one launch. The ranks' working directory is ``tmp_path`` (their
    ``logs/``). Returns ``(references, step outputs, run outputs)``, each
    output a list over the jobs of the ranks' returns."""
    from concurrent.futures import ThreadPoolExecutor

    tmp_path = Path(tmp_path)
    cwd = os.getcwd()
    os.chdir(tmp_path)  # spawned ranks start here
    try:
        with ThreadPoolExecutor(1) as pool:
            pending = pool.submit(launch_ranks, run_jobs, {"jobs": list(runs)}, tmp_path / "runs", world, deadline_s)
            jobs, refs = build_steps()
            steps = launch_ranks(run_jobs, {"jobs": jobs}, tmp_path / "steps", world, deadline_s) if jobs else None
            ran = pending.result()
    finally:
        os.chdir(cwd)

    def by_job(outs):
        return [[o[i] for o in outs] for i in range(len(outs[0]))] if outs else []

    return refs, by_job(steps), by_job(ran)


def dv3_sharded_steps(dist: Any, p: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One DreamerV3 burst per case of ``p["cases"]`` (``{"mesh": {dp, fsdp,
    tp[, min_shard_size]}, "zero1": bool, "clip": max norm, "precision": fabric.precision}``), each on its own
    mesh over this
    launch's ranks (``Distributed.adopt_group``), from ``p["modules"]`` and
    ``p["opt_states"]``: the parameters and optimizer states laid out as
    ``dreamer_v3.main`` lays them out, the rank's data block of ``p["batch"]``
    and of ``p["noise"]``. The player's mirror is made first, from the whole
    modules, as ``dreamer_v3.main`` makes it, and refreshed after the burst.
    Recorded beside what the rank holds at rest after the step (parameter
    and gradient bytes, the moments): its peak bytes over the burst and,
    apart, over the mirror's refresh (``MemTracker``: parameters, gradients,
    moments, the mirror, gathered copies, activations and temporaries), the
    largest unit's whole parameter bytes and the most whole-copy bytes the
    layout held at once during the burst. With ``p["resume"]``
    (``{"from": i, "mesh": ...}``) the whole state after case ``i`` is
    written by rank 0, read back by every rank on that mesh, laid out again
    and gathered whole."""
    import copy

    from torch.distributed._tools.mem_tracker import MemTracker

    class BurstTracker(MemTracker):
        """The live bytes of every tensor, without MemTracker's per-module
        statistics (which refuse a module called twice in one step)."""

        def _pre_fw_hook(self, *args, **kwargs): pass
        def _post_fw_hook(self, *args, **kwargs): pass
        def _pre_bw_hook(self, *args, **kwargs): pass
        def _post_bw_hook(self, *args, **kwargs): pass

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import MomentsState
    from sheeprl_tpu_torch.parallel.placement import make_param_mirror

    T = p["batch"]["rewards"].shape[1]
    names = ("wm", "actor", "critic", "target_critic")

    def case_cfg(case):
        c = Config(p["cfg"])
        if "clip" in case:  # every optimizer's global-norm clip
            for section in ("world_model", "actor", "critic"):
                c.set_path(f"algo.{section}.clip_gradients", case["clip"])
        if "precision" in case:
            c.set_path("fabric.precision", case["precision"])
        return c

    def case_dist(case):
        d = mesh.Distributed(devices=dist.world_size, accelerator="cpu", mesh=case["mesh"],
                             shard_optimizer_state=case.get("zero1", False), rank=dist.rank)
        d.adopt_group(TIMEOUT_S)
        return d

    def laid_out(case, d, modules, opt_states):
        cfg = case_cfg(case)
        wm, actor, critic, target = (modules[k] for k in names)
        opts = tdv3.build_optimizers(cfg, wm, actor, critic, d)
        for name in ("wm", "actor", "critic"):
            getattr(opts, name).optimizer.load_state_dict(opt_states[name])
        layout = mesh.maybe_shard_params(cfg, d, dict(zip(names, (wm, actor, critic, target))))
        mesh.maybe_shard_opt_state(cfg, d, layout, {"actor": (opts.actor, actor), "critic": (opts.critic, critic),
                                                    "wm": (opts.wm, wm)}, counters=("step",))
        return opts, layout

    def whole(layout, opts, modules):
        state = {k: {n: t.clone() for n, t in layout.state_dict(modules[k]).items()} for k in names}
        return state, copy.deepcopy({k: layout.full_opt_state(getattr(opts, k)) for k in ("wm", "actor", "critic")})

    def held(modules, what):
        ts = [getattr(q, what) for k in names for q in modules[k].parameters()]
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def peak(tracker):
        return int(tracker.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"])

    outs = []
    for case in p["cases"]:
        modules = copy.deepcopy(p["modules"])
        player = {"wm": modules["wm"], "actor": modules["actor"]}
        d = case_dist(case)
        sharded = mesh.params_sharded(d, dict(zip(names, (modules[k] for k in names))))
        mirror, pdev, _ = make_param_mirror(case_cfg(case), torch.device("cpu"), player, 0, params_sharded=sharded)
        opts, layout = laid_out(case, d, modules, copy.deepcopy(p["opt_states"]))
        if layout.sharded:
            mirror.layout = layout
        reports = {r.group: r for r in d.take_sharding_reports()}
        train = tdv3.make_train_fn(*(modules[k] for k in names), opts, case_cfg(case), False, p["actions_dim"],
                                   dist=d)
        n, r = d.data_parallel_size, d.data_rank
        batch = {k: torch.from_numpy(np.ascontiguousarray(columns(v, 2, r, n))) for k, v in p["batch"].items()}
        noise = [dv3_noise_columns(x, T, r, n) for x in p["noise"]]
        d.reset_stats()
        layout.gathered_peak_bytes = 0
        external = (*(modules[k] for k in names), *(getattr(opts, k).optimizer for k in ("wm", "actor", "critic")),
                    *(m for slot in mirror._slots for m in slot.values()))
        tracker = BurstTracker()
        tracker.track_external(*external)
        with tracker:
            moments, metrics = train(MomentsState(torch.tensor(0.0), torch.tensor(0.0)), batch, noise=noise)
        rest = {"param_bytes": held(modules, "data"), "grad_bytes": held(modules, "grad")}
        refresh = BurstTracker()
        refresh.track_external(*external)
        with refresh:
            mirror.refresh(player)
        moments_bytes = sum(layout.opt_local_bytes(getattr(opts, k)) for k in ("wm", "actor", "critic"))
        state, opt_states = whole(layout, opts, modules)
        mirror_state = {k: {n: t.clone() for n, t in m.state_dict().items()} for k, m in mirror.current().items()}
        params = reports.get("params")
        outs.append({"state": state, "opt_states": opt_states, "mirror": mirror_state,
                     "moments": (float(moments.low), float(moments.high)),
                     "metrics": {k: float(v.mean()) for k, v in metrics.items()}, "stats": dict(d.stats),
                     "summaries": {g: rep.summary() for g, rep in reports.items()},
                     "moment_leaf_bytes": sum(x.bytes_per_chip(rep.axis_sizes) for rep in reports.values()
                                              for x in rep.decisions if "/mu/" in x.path or "/nu/" in x.path),
                     "grad_leaf_bytes": None if params is None else sum(
                         x.bytes_per_chip(params.axis_sizes) for x in params.decisions
                         if not x.path.startswith("target_critic/")),
                     "unit_bytes": max((sum(e.leaf.dtype_bytes * int(np.prod(e.shape)) for e in es)
                                        for es in layout._units.values()), default=0),
                     "gathered_peak_bytes": layout.gathered_peak_bytes,
                     **rest, "moments_bytes": moments_bytes,
                     "mirror_bytes": sum(t.numel() * t.element_size() for ts in mirror._dst for t in ts),
                     "mirror_device": str(pdev), "peak_bytes": peak(tracker), "refresh_peak_bytes": peak(refresh),
                     "coordinate": d.coordinate, "data_rank": r})
        d.device_mesh = None
    resume = p.get("resume")
    if resume:
        src = outs[resume["from"]]
        path = os.path.join(p["dir"], "ckpt.pt")
        if dist.rank == 0:
            torch.save({**src["state"], "opt_states": src["opt_states"]}, path)
        torch.distributed.barrier()
        saved = torch.load(path, weights_only=False)
        modules = copy.deepcopy(p["modules"])
        for k in names:
            modules[k].load_state_dict(saved[k])
        case = {"mesh": resume["mesh"], "zero1": resume.get("zero1", False)}
        opts, layout = laid_out(case, case_dist(case), modules, saved["opt_states"])
        state, opt_states = whole(layout, opts, modules)
        outs.append({"state": state, "opt_states": opt_states, "param_bytes": held(modules, "data")})
    return outs
