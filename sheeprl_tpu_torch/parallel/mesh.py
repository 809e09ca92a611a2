"""The device mesh on ``torch.distributed`` (counterpart of
``sheeprl_tpu/parallel/mesh.py``'s ``Distributed``, ``build_distributed``,
``maybe_shard_params`` and ``maybe_shard_opt_state``).

The JAX package is single-controller: one process steps ``env.num_envs``
envs, samples a global batch of ``per_rank_batch_size × dp·fsdp`` and shards
it along the batch axis, and XLA averages the gradients inside the jitted
step. The port runs one process per device instead, as the JAX package lays
out a multi-host run, and keeps the config's meaning:

* ``launch(fn, cfg)`` runs ``fn(cfg)`` on ``fabric.devices`` ranks: in this
  process at world size 1, else in that many processes started with the
  ``spawn`` method. Each rank gets a device (``cuda:<local rank>`` on the
  card, the CPU under ``fabric.accelerator=cpu``) and a process group (NCCL
  on the card, gloo on the CPU) with a timeout, so a collective that one
  rank never reaches fails the run instead of hanging it. At world size 1 a
  group is made only under ``fabric.strategy=ddp`` (Lightning Fabric's
  meaning: the collective path on one device); under ``auto`` there is
  none, and every collective is the identity, as a one-device JAX mesh
  emits no psum. With ``fabric.num_nodes > 1`` each node runs ``launch``
  once: its rank in the nodes (``GROUP_RANK``, or ``NODE_RANK``), the
  rendezvous address (``MASTER_ADDR``, ``MASTER_PORT``) and the world size
  (``WORLD_SIZE``, which must be ``num_nodes × devices``) come from the
  environment variables ``torchrun`` sets, and global rank = node rank ×
  devices + local rank (under ``torchrun`` itself, which started this
  process as ``LOCAL_RANK``, the launch runs that one rank here);
* the group's ``DeviceMesh`` (``init_device_mesh`` over ``("dp", "fsdp",
  "tp")``, ranks laid out row-major) and the ``SpecEngine`` of
  ``parallel/sharding.py``. The engine lays out DreamerV3's parameters
  (``maybe_shard_params``: each rank keeps its shard of every leaf the
  ``params`` report does not replicate, ``parallel/layout.py``) and the
  optimizer states (``shard_opt_state``): each moment follows its
  parameter's spec, a replicated one falls back to ZeRO-1. Each report
  becomes ``sharding`` telemetry events (``take_sharding_reports``). Both
  are no-ops on a pure-dp mesh (where only ``fabric.shard_optimizer_state``
  asks for ZeRO-1 over dp), as in the JAX package;
* the data ranks are the dp × fsdp coordinates (``data_rank``,
  ``data_parallel_size``); the ranks of a tp group share one: rank ``d``'s
  data block ``d // tp`` steps env block ``d // tp`` (``local_envs``) and
  trains on its ``batch / (dp·fsdp)`` columns;
* ``all_reduce_mean`` averages a list of tensors over the data ranks in one
  flattened all-reduce (the gradients of one optimizer step); ``all_gather``
  concatenates the data ranks' tensors along the leading axis (DreamerV3's
  Moments take quantiles of the global batch); ``broadcast``, ``scatter``
  and the ``*_object`` collectives carry what is not a tensor on the card
  (rollouts, buffer states, the log directory) over a gloo group;
* every collective that runs counts its calls and bytes in ``stats``.

``running()`` makes the group, makes this ``Distributed`` the one the loops
read (``current``) and saves the generators' states; when the run ends, in
any way, it destroys the group and restores both. A mesh that asks for more
devices than the node has raises.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import random
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .precision import Precision, get_precision
from .sharding import (DEFAULT_MIN_SHARD_SIZE, MESH_AXES, Leaf, ShardingReport, SpecEngine, adam_leaves,
                       adam_prefix, infer_tree_specs, module_leaves, resolve_mesh_shape)

# the JAX package's rule for the actor fleet in more than one process
# (sheeprl_tpu/fleet/engine.py): the port's ranks are processes
FLEET_DISABLED = ("[fleet] actor fleet disabled: the fleet is a single-controller layout (multi-host runs keep "
                  "their per-process env loops)")
DEFAULT_TIMEOUT_S = 600.0

_ACTIVE: Optional["Distributed"] = None


def _platform(accelerator: str) -> str:
    """``fabric.accelerator`` as ``cuda`` or ``cpu``; auto | gpu | cuda need a
    card and raise without one (no silent fallback to the host)."""
    accelerator = str(accelerator or "auto").lower()
    if accelerator == "cpu":
        return "cpu"
    if accelerator in ("auto", "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"fabric.accelerator={accelerator} runs on a CUDA device and none is available "
                               "(pass fabric.accelerator=cpu to run on the host)")
        return "cuda"
    raise ValueError(f"fabric.accelerator must be auto | gpu | cuda | cpu, got {accelerator!r}")


def _get(node: Any, key: str, default: Any) -> Any:
    if node is None:
        return default
    val = node.get(key, default) if hasattr(node, "get") else getattr(node, key, default)
    return default if val is None else val


class Distributed:
    """The rank's view of the ``(dp, fsdp, tp)`` mesh on
    ``torch.distributed``, threaded through the training loops."""

    def __init__(self, devices: Any = 1, accelerator: str = "auto", precision: str = "32-true", num_nodes: int = 1,
                 strategy: Optional[str] = "auto", mesh: Any = None, shard_optimizer_state: bool = False,
                 rank: int = 0):
        strategy = "auto" if strategy is None else str(strategy)
        if strategy not in ("auto", "ddp", "dp"):
            raise ValueError(f"Unsupported fabric.strategy '{strategy}': data parallelism is expressed by the "
                             "device mesh; use fabric.devices to scale")
        self.platform = _platform(accelerator)
        available = torch.cuda.device_count() if self.platform == "cuda" else (os.cpu_count() or 1)
        per_node = available if devices in ("auto", -1, "-1", None) else int(devices)
        if per_node < 1:
            raise ValueError(f"fabric.devices must be >= 1, got {devices}")
        if per_node > available:
            raise RuntimeError(f"Requested {per_node} devices but only {available} available ({self.platform})")
        if int(num_nodes) < 1:
            raise ValueError(f"fabric.num_nodes must be >= 1, got {num_nodes}")
        n = per_node * int(num_nodes)
        dp, fsdp, tp = resolve_mesh_shape(n, dp=int(_get(mesh, "dp", -1)), fsdp=int(_get(mesh, "fsdp", 1)),
                                          tp=int(_get(mesh, "tp", 1)))
        if not 0 <= int(rank) < n:
            raise ValueError(f"rank {rank} outside a world of {n}")
        self.axis_sizes: Dict[str, int] = {"dp": dp, "fsdp": fsdp, "tp": tp}
        self.min_shard_size = int(_get(mesh, "min_shard_size", DEFAULT_MIN_SHARD_SIZE))
        self.spec_engine = SpecEngine(self.axis_sizes, min_shard_size=self.min_shard_size)
        # reports of maybe_shard_params/shard_opt_state until a loop emits them
        self.sharding_reports: List[ShardingReport] = []
        self.shard_optimizer_state = bool(shard_optimizer_state)
        self.strategy = strategy
        self.precision: Precision = get_precision(str(precision))
        self.num_nodes = int(num_nodes)
        self.devices_per_node = per_node
        self.rank = int(rank)
        self._world = n
        self.group: Any = None  # the default process group, once made
        self.device_mesh: Any = None  # its DeviceMesh over MESH_AXES
        self._data: Any = None  # the group of this rank's data ranks (its tp coordinate's), under tp > 1
        self._objects: Any = None  # a gloo group for object collectives under NCCL
        self.backend: Optional[str] = None
        self.stats: Dict[str, int] = {}
        self.reset_stats()

    # -- identity ----------------------------------------------------------
    @property
    def world_size(self) -> int:
        return self._world

    @property
    def dp(self) -> int:
        return self.axis_sizes["dp"]

    @property
    def fsdp(self) -> int:
        return self.axis_sizes["fsdp"]

    @property
    def tp(self) -> int:
        return self.axis_sizes["tp"]

    @property
    def data_parallel_size(self) -> int:
        """How many ways a batch's batch axis shards: dp × fsdp."""
        return self.dp * self.fsdp

    @property
    def is_pure_dp(self) -> bool:
        return self.fsdp == 1 and self.tp == 1

    @property
    def coordinate(self) -> Tuple[int, int, int]:
        """This rank's ``(dp, fsdp, tp)`` coordinate (ranks laid out row-major)."""
        return (self.rank // (self.fsdp * self.tp), (self.rank // self.tp) % self.fsdp, self.rank % self.tp)

    @property
    def data_rank(self) -> int:
        """This rank's index among the data ranks (dp × fsdp): the ranks of a
        tp group share it, their batch and their env block."""
        return self.rank // self.tp

    @property
    def process_index(self) -> int:
        return self.rank

    @property
    def is_global_zero(self) -> bool:
        return self.rank == 0

    @property
    def device(self) -> torch.device:
        if self.platform == "cuda":
            local = self.rank % self.devices_per_node
            return torch.device("cuda", local if self._world > 1 else torch.cuda.current_device())
        return torch.device("cpu")

    @property
    def needs_group(self) -> bool:
        """A process group is made at world size > 1, and at world size 1
        under ``fabric.strategy=ddp``."""
        return self._world > 1 or self.strategy == "ddp"

    @property
    def collective(self) -> bool:
        """Whether the collectives run (a group exists)."""
        return self.group is not None

    def local_envs(self, num_envs: int) -> Tuple[int, int]:
        """This rank's env block ``[lo, hi)`` of ``num_envs`` envs: its data
        rank's (the envs must divide by the data ranks, dp × fsdp)."""
        n = self.data_parallel_size
        if num_envs % n:
            what = "world size" if n == self._world else "data-parallel size (dp·fsdp)"
            raise ValueError(f"env.num_envs ({num_envs}) must be divisible by the {what} ({n}): each data rank "
                             "steps an equal env block")
        epd = num_envs // n
        return self.data_rank * epd, (self.data_rank + 1) * epd

    def data_blocks(self, per_rank: Sequence[Any]) -> List[Any]:
        """Of a list with one entry per rank (``gather_object``'s), those of
        the data ranks in order: a tp group's ranks hold the same block."""
        return list(per_rank)[::self.tp]

    def seed_everything(self, seed: int) -> int:
        """Seed Python's, numpy's and torch's global generators (``running``
        restores their states when the run ends). Returns ``seed``."""
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)
        return int(seed)

    # -- the group's lifetime ------------------------------------------------
    def init_group(self, init_method: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        import torch.distributed as tdist

        self.backend = "nccl" if self.platform == "cuda" else "gloo"
        if self.platform == "cuda":
            torch.cuda.set_device(self.device)
        timeout = datetime.timedelta(seconds=float(timeout_s))
        tdist.init_process_group(self.backend, init_method=init_method, world_size=self._world, rank=self.rank,
                                 timeout=timeout)
        self.adopt_group(timeout_s)

    def adopt_group(self, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        """Use the process group this process made already (``init_group``,
        or another library's) as this mesh's: its ``DeviceMesh`` and data
        groups are made on it. Every rank calls it, in the same order."""
        import torch.distributed as tdist

        if (tdist.get_world_size(), tdist.get_rank()) != (self._world, self.rank):
            raise ValueError(f"the process group's rank {tdist.get_rank()} of {tdist.get_world_size()} is not this "
                             f"mesh's rank {self.rank} of {self._world}")
        timeout = datetime.timedelta(seconds=float(timeout_s))
        self.backend = tdist.get_backend()
        self.group = tdist.group.WORLD
        if self.backend == "nccl" and self._world > 1:
            self._objects = tdist.new_group(backend="gloo", timeout=timeout)
        from torch.distributed.device_mesh import init_device_mesh

        self.device_mesh = init_device_mesh(self.platform, (self.dp, self.fsdp, self.tp), mesh_dim_names=MESH_AXES)
        if self.tp > 1:  # every rank makes every data group, in the same order
            for t in range(self.tp):
                g = tdist.new_group(list(range(t, self._world, self.tp)), timeout=timeout)
                if t == self.rank % self.tp:
                    self._data = g

    def destroy(self) -> None:
        if self.group is None:
            return
        import torch.distributed as tdist

        try:
            if tdist.is_initialized():
                tdist.destroy_process_group()
        finally:
            self.group = self._objects = self._data = self.device_mesh = None

    @contextlib.contextmanager
    def running(self, init_method: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
                rendezvous_dir: Optional[str] = None) -> Iterator["Distributed"]:
        """The run's scope: the process group (where ``needs_group``; without
        an ``init_method``, a ``file://`` store in a fresh directory under
        ``rendezvous_dir``), this ``Distributed`` as ``current()``'s answer,
        and the global generators' states, all undone when the block ends,
        however it ends."""
        global _ACTIVE
        cuda = self.platform == "cuda"
        prior, rng = _ACTIVE, (random.getstate(), np.random.get_state(), torch.get_rng_state(),
                               torch.cuda.get_rng_state_all() if cuda else None)
        own_dir = None
        try:
            if self.needs_group:
                if init_method is None:
                    init_method, own_dir = rendezvous(rendezvous_dir)
                self.init_group(init_method, timeout_s)
            _ACTIVE = self
            yield self
        finally:
            _ACTIVE = prior
            try:
                self.destroy()
            finally:
                random.setstate(rng[0])
                np.random.set_state(rng[1])
                torch.set_rng_state(rng[2])
                if cuda:
                    torch.cuda.set_rng_state_all(rng[3])
                if own_dir is not None:
                    shutil.rmtree(own_dir, ignore_errors=True)

    # -- collectives -----------------------------------------------------------
    def reset_stats(self) -> None:
        self.stats = {f"{op}{suffix}": 0 for op in ("all_reduce", "all_gather", "broadcast", "scatter")
                      for suffix in ("", "_bytes")}
        self.stats["object"] = 0  # the pickled collectives (rollouts, buffer states, stop flags): calls only

    def count_collective(self, op: str, nbytes: int = 0) -> None:
        """Count one collective of ``op`` moving ``nbytes``."""
        self.stats[op] += 1
        if op != "object":
            self.stats[f"{op}_bytes"] += int(nbytes)

    @torch.no_grad()
    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]) -> None:
        """In place: each tensor becomes its mean over the data ranks, in one
        flattened all-reduce (the identity without a group)."""
        tensors = [t for t in tensors if t is not None]
        if self.group is None or not tensors:
            return
        import torch.distributed as tdist

        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.count_collective("all_reduce", flat.numel() * flat.element_size())
        tdist.all_reduce(flat, group=self._data)
        flat.div_(self.data_parallel_size)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n

    @torch.no_grad()
    def mean_over_data(self, tensor: torch.Tensor) -> torch.Tensor:
        """The mean of ``tensor`` over the data ranks (a new tensor; a copy
        without a group)."""
        out = tensor.detach().clone(memory_format=torch.contiguous_format)
        self.all_reduce_mean([out])
        return out

    @torch.no_grad()
    def all_reduce_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``tensor`` (a new tensor)."""
        if self.group is None:
            return tensor.clone()
        import torch.distributed as tdist

        out = tensor.detach().clone()
        self.count_collective("all_reduce", out.numel() * out.element_size())
        tdist.all_reduce(out)
        return out

    @torch.no_grad()
    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``tensor`` (same shape on each) concatenated
        along the leading axis in rank order (``tensor`` itself without a
        group)."""
        if self.group is None:
            return tensor
        import torch.distributed as tdist

        t = tensor.detach().contiguous()
        n = self.data_parallel_size
        parts = [torch.empty_like(t) for _ in range(n)]
        self.count_collective("all_gather", t.numel() * t.element_size() * n)
        tdist.all_gather(parts, t, group=self._data)
        return torch.cat(parts)

    @torch.no_grad()
    def broadcast(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """In place: every rank's tensors take rank ``src``'s values."""
        if self.group is None:
            return
        import torch.distributed as tdist

        for t in tensors:
            self.count_collective("broadcast", t.numel() * t.element_size())
            tdist.broadcast(t, src)

    @torch.no_grad()
    def scatter(self, chunks: Optional[Sequence[torch.Tensor]], like: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src`` hands ``chunks[d]`` to rank ``d``; every rank passes
        ``like`` (its chunk's shape, dtype and device) and gets its chunk."""
        if self.group is None:
            return chunks[0]
        import torch.distributed as tdist

        out = torch.empty_like(like)
        self.count_collective("scatter", out.numel() * out.element_size())
        if self.backend == "nccl":  # NCCL has no scatter: a broadcast per rank
            for d in range(self._world):
                buf = chunks[d].contiguous() if self.rank == src else torch.empty_like(like)
                tdist.broadcast(buf, src)
                if d == self.rank:
                    out = buf
            return out
        tdist.scatter(out, [c.contiguous() for c in chunks] if self.rank == src else None, src=src)
        return out

    def _object_group(self) -> Any:
        return self._objects if self._objects is not None else self.group

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Rank ``src``'s picklable ``obj`` on every rank."""
        if self.group is None or self._world == 1:
            return obj
        import torch.distributed as tdist

        box = [obj if self.rank == src else None]
        tdist.broadcast_object_list(box, src=src, group=self._object_group())
        self.count_collective("object")
        return box[0]

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every rank's picklable ``obj``, in rank order."""
        if self.group is None or self._world == 1:
            return [obj]
        import torch.distributed as tdist

        out: List[Any] = [None] * self._world
        tdist.all_gather_object(out, obj, group=self._object_group())
        self.count_collective("object")
        return out

    def gather_object(self, obj: Any, dst: int = 0) -> Optional[List[Any]]:
        """Every rank's ``obj`` on rank ``dst`` (in rank order), None elsewhere."""
        if self.group is None or self._world == 1:
            return [obj]
        import torch.distributed as tdist

        out: Optional[List[Any]] = [None] * self._world if self.rank == dst else None
        tdist.gather_object(obj, out, dst=dst, group=self._object_group())
        self.count_collective("object")
        return out

    def reduce_metrics(self, aggregator: Any) -> None:
        """Every rank's log interval folded into rank 0's ``aggregator`` (a
        collective; the metrics rank 0 logs are the global ones)."""
        if self.group is None or self._world == 1:
            return
        states = self.gather_object(aggregator.states())
        if states is not None:
            aggregator.combine(self.data_blocks(states))

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (a stop decision
        that must be the same everywhere)."""
        if self.group is None or self._world == 1:
            return bool(flag)
        return any(self.all_gather_object(bool(flag)))


    # -- the layout of the optimizer states ----------------------------------
    def shard_opt_state(self, layout: Any, optimizers: Dict[str, Any], counters: Sequence[str] = (),
                        min_size: int = DEFAULT_MIN_SHARD_SIZE) -> Any:
        """The optimizer-state layout of ``optimizers`` (``{name: (clipped
        optimizer, module)}``, one Adam each) over ``layout``'s modules:
        moments follow their parameters' specs, and a replicated parameter's
        moments take the leading-axis ZeRO-1 layout (over fsdp, or dp on a
        pure-dp mesh) where it divides and the leaf has ``min_size``
        elements. ``counters`` name the loop's own step counters of the
        JAX package's optimizer-state tree (DreamerV3's ``step``). The
        report is recorded and the optimizers step their slices from here on."""
        leaves = [Leaf(c, (), 4, ()) for c in counters]
        for name, (opt, module) in optimizers.items():
            leaves += adam_leaves(name, module, opt.max_grad_norm is not None, shape_of=layout.leaf_shape)
        leaves.sort(key=lambda lf: lf.path.split("/"))
        report = infer_tree_specs(self.spec_engine, leaves, group="opt_state", zero1_fallback=True,
                                  zero1_min_size=min_size)
        self.sharding_reports.append(report)
        if any(not d.replicated for d in report.decisions):
            self._need_mesh("optimizer state's")
            by_path = {d.path: d for d in report.decisions}
            for name, (opt, module) in optimizers.items():
                layout.shard_opt_state(opt, module, by_path, f"{name}/{adam_prefix(opt.max_grad_norm is not None)}/mu/")
        return layout

    def take_sharding_reports(self) -> List[ShardingReport]:
        """The recorded reports, once (a loop emits them as telemetry)."""
        out, self.sharding_reports = self.sharding_reports, []
        return out

    def _need_mesh(self, what: str) -> None:
        if self.device_mesh is None:
            raise RuntimeError(f"the {what} sharding of a {self.axis_sizes} mesh needs its process group: launch "
                               "the run through sheeprl_tpu_torch.cli (run_algorithm) or mesh.launch")


def params_report(dist: Distributed, modules: Dict[str, torch.nn.Module]) -> ShardingReport:
    """The engine's ``params`` report of ``modules`` on ``dist``'s mesh (the
    JAX package's ``shard_params`` report of the same tree)."""
    return infer_tree_specs(dist.spec_engine, [lf for lf, *_ in module_leaves(modules)], group="params")


def params_sharded(dist: Optional[Distributed], modules: Dict[str, torch.nn.Module]) -> bool:
    """Whether ``maybe_shard_params`` cuts any of ``modules``' parameters on
    ``dist``'s mesh."""
    return (dist is not None and not dist.is_pure_dp
            and any(not d.replicated for d in params_report(dist, modules).decisions))


def maybe_shard_params(cfg: Any, dist: Optional[Distributed], modules: Dict[str, torch.nn.Module]) -> Any:
    """The layout of ``modules`` (``ParamLayout``, which the optimizer
    states are laid out over). On a multi-axis mesh every leaf goes through
    the rule engine and each rank keeps its shard of every leaf the
    ``params`` report does not replicate (``ParamLayout.shard_params``); on
    a pure-dp mesh the parameters are left as they are, as the JAX
    package's ``maybe_shard_params`` leaves them (the 1-D path stays
    bit-identical), and under ZeRO-1 the report is recorded, every leaf
    replicated."""
    from .layout import ParamLayout

    layout = ParamLayout(dist, modules)
    if dist is not None and (not dist.is_pure_dp or dist.shard_optimizer_state):
        report = params_report(dist, modules)
        dist.sharding_reports.append(report)
        if not dist.is_pure_dp and any(not d.replicated for d in report.decisions):
            dist._need_mesh("parameters'")
            layout.shard_params(report)
    return layout


def maybe_shard_opt_state(cfg: Any, dist: Optional[Distributed], layout: Any, optimizers: Dict[str, Any],
                          counters: Sequence[str] = ()) -> Any:
    """The optimizer states' layout, applied once to fresh and resumed state
    alike: on a multi-axis mesh always (moments follow their parameters'
    specs, replicated ones fall back to ZeRO-1); on a pure-dp mesh only
    under ``fabric.shard_optimizer_state`` (ZeRO-1 over dp)."""
    if dist is not None and (not dist.is_pure_dp or dist.shard_optimizer_state):
        dist.shard_opt_state(layout, optimizers, counters)
    return layout


def emit_sharding_reports(telem: Any, dist: Distributed) -> None:
    """Every recorded report as ``sharding`` events, once, after the
    telemetry facade is set up."""
    for report in dist.take_sharding_reports():
        for ev in report.events():
            telem.emit(ev)


# -- what a training loop on N ranks needs beside the collectives ------------
def local_cfg(cfg: Any, dist: Distributed) -> Any:
    """``cfg`` with ``env.num_envs`` this rank's block (``cfg`` itself at world
    size 1): the vector env, its seeds (``vectorize(local, seed, rank)``
    seeds env ``i`` of block ``d`` as the JAX package seeds env
    ``d·epd + i``), the rollout and the per-env buffers take it."""
    if dist.world_size == 1:
        return cfg
    from ..config import Config

    lo, hi = dist.local_envs(int(cfg.env.num_envs))
    return Config({**cfg.to_dict(), "env": {**cfg.env.to_dict(), "num_envs": hi - lo}})


def run_log_dir(cfg: Any, dist: Distributed) -> str:
    """The run's log directory: rank 0 makes it (and writes ``config.yaml``),
    the other ranks are told its path."""
    from ..utils.logger import get_log_dir
    from ..utils.utils import save_configs

    log_dir = None
    if dist.is_global_zero:
        log_dir = get_log_dir(cfg, cfg.root_dir, cfg.run_name)
        save_configs(cfg, log_dir)
    return dist.broadcast_object(log_dir)


def ranks_state(dist: Distributed, generators: Dict[str, Any]) -> Dict[str, Any]:
    """A checkpoint's part that only N ranks add (a collective): the world
    size and every rank's generators, in rank order (the checkpoint's own
    ``generators`` stay rank 0's)."""
    if dist.world_size == 1:
        return {}
    return {"world_size": dist.world_size, "rank_generators": dist.all_gather_object(generators)}


def rank_resume(state: Optional[Dict[str, Any]], dist: Distributed,
                any_world: bool = False) -> Optional[Dict[str, Any]]:
    """This rank's generators of a checkpoint (None for a fresh run). Its
    mesh may differ from this run's: the parameters and optimizer states it
    holds whole are laid out anew. A checkpoint of another world size
    raises, unless ``any_world`` (a loop that re-splits the buffer's env
    blocks and rescales its Ratio ledger): its generators do not map onto
    these ranks, so they start from the run's seed, and None is returned."""
    if not state:
        return None
    saved = int(state.get("world_size", 1))
    if saved != dist.world_size:
        if not any_world:
            raise NotImplementedError(f"the checkpoint was written on {saved} ranks and this run has "
                                      f"{dist.world_size}: resuming at another world size is not supported")
        if dist.is_global_zero:
            print(f"[resume] the checkpoint was written on {saved} ranks and this run has {dist.world_size}: the "
                  "parameters, optimizer states and the buffer's env blocks carry over, the generators start "
                  "from the seed", flush=True)
        return None
    return state["rank_generators"][dist.rank] if saved > 1 else state["generators"]


def collective_fields(dist: Distributed) -> Dict[str, Any]:
    """The ``log`` record's ``collectives`` field where the collectives run:
    the run's counts of each collective and its bytes so far."""
    if not dist.collective:
        return {}
    return {"collectives": {"backend": dist.backend, "world_size": dist.world_size, **dist.stats}}


def build_distributed(cfg: Any, rank: int = 0) -> Distributed:
    """The ``Distributed`` of ``cfg.fabric`` for ``rank``."""
    fab = cfg.select("fabric") if hasattr(cfg, "select") else None
    sel = (lambda k, d: _get(fab, k, d))
    return Distributed(devices=sel("devices", 1), accelerator=sel("accelerator", "auto"),
                       precision=str(sel("precision", "32-true")), num_nodes=int(sel("num_nodes", 1)),
                       strategy=sel("strategy", "auto"), mesh=sel("mesh", None),
                       shard_optimizer_state=bool(sel("shard_optimizer_state", False)), rank=rank)


def active() -> Optional[Distributed]:
    """The ``Distributed`` of the run in progress in this process, if any."""
    return _ACTIVE


def current(cfg: Any) -> Distributed:
    """The ``Distributed`` of the run in progress (``launch``/``running``),
    else a world-size-1 one without a group built from ``cfg``. A config
    that needs a group (more ranks, or ``fabric.strategy=ddp``) outside a
    launch raises: nothing silently runs at one device when more were asked
    for."""
    if _ACTIVE is not None:
        return _ACTIVE
    dist = build_distributed(cfg)
    if dist.needs_group:
        raise RuntimeError(f"fabric.devices={dist.world_size} fabric.strategy={dist.strategy} needs a process "
                           "group: launch the run through sheeprl_tpu_torch.cli (run_algorithm)")
    return dist


def collective(cfg: Any) -> Optional[Distributed]:
    """The run's ``Distributed`` where its collectives run (what a train
    step and its optimizers take to average gradients), else None."""
    dist = current(cfg)
    return dist if dist.collective else None


def rendezvous(parent: Optional[str] = None) -> Tuple[str, str]:
    """A ``file://`` init method in a fresh directory (under ``parent``, else
    the system's temporary directory) and that directory, which the caller
    removes when the run ends."""
    if parent:
        os.makedirs(parent, exist_ok=True)
    own = tempfile.mkdtemp(prefix="sheeprl_rdv_", dir=parent or None)
    return f"file://{os.path.join(own, 'store')}", own


def _rank_main(local_rank: int, fn: Callable[[Any], None], cfg_dict: Dict[str, Any], init_method: str,
               timeout_s: float, first_rank: int = 0) -> None:
    """A rank: its ``Distributed`` (global rank ``first_rank + local_rank``),
    its group, ``fn(cfg)``. On the host the node's ranks share its cores:
    each takes its share of them for PyTorch's intra-op threads, unless
    ``OMP_NUM_THREADS`` says how many."""
    from ..config import Config

    cfg = Config(cfg_dict)
    dist = build_distributed(cfg, rank=first_rank + local_rank)
    if dist.platform == "cpu" and not os.environ.get("OMP_NUM_THREADS"):
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // dist.devices_per_node))
    with dist.running(init_method, timeout_s):
        fn(cfg)


def node_rendezvous(dist: Distributed) -> Tuple[int, str]:
    """This node's rank and the rendezvous of a run on ``fabric.num_nodes``
    nodes, from the environment ``torchrun`` sets: ``GROUP_RANK`` (or
    ``NODE_RANK``), ``MASTER_ADDR``, ``MASTER_PORT`` and ``WORLD_SIZE``."""
    env = os.environ
    node = env.get("GROUP_RANK", env.get("NODE_RANK"))
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if not env.get(k)] + ([] if node else ["GROUP_RANK"])
    if missing:
        raise RuntimeError(f"fabric.num_nodes={dist.num_nodes}: set {', '.join(missing)} (as torchrun does) on "
                           "every node")
    world = int(env.get("WORLD_SIZE", dist.world_size))
    if world != dist.world_size:
        raise ValueError(f"WORLD_SIZE={world} but fabric.num_nodes × fabric.devices = {dist.world_size}")
    if not 0 <= int(node) < dist.num_nodes:
        raise ValueError(f"node rank {node} outside fabric.num_nodes={dist.num_nodes}")
    return int(node), f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"


def launch(fn: Callable[[Any], None], cfg: Any, deadline_s: Optional[float] = None) -> None:
    """Run ``fn(cfg)`` on ``fabric.devices`` ranks: here at world size 1,
    else in as many ``spawn`` processes (``fn`` must be picklable: a module's
    function or a partial of one). A rank that fails ends the others and the
    launch raises its error. The rendezvous is a ``file://`` store in a fresh
    directory under ``fabric.rendezvous_dir`` (the system's temporary
    directory when null), removed when the run ends; on more nodes, the
    address ``node_rendezvous`` reads (each node launches its own ranks, or,
    under ``torchrun``'s one process per device, runs its ``LOCAL_RANK``
    here). ``deadline_s`` bounds the wait for the spawned ranks: past it they
    are killed and the launch raises ``TimeoutError``."""
    dist = build_distributed(cfg)
    timeout_s = float(cfg.select("fabric.timeout_s", DEFAULT_TIMEOUT_S) or DEFAULT_TIMEOUT_S)
    parent = cfg.select("fabric.rendezvous_dir")
    if dist.world_size == 1:
        with dist.running(None, timeout_s, rendezvous_dir=parent):
            fn(cfg)
        return
    own_dir = None
    first = 0
    if dist.num_nodes > 1:
        node, init_method = node_rendezvous(dist)
        first = node * dist.devices_per_node
        if os.environ.get("LOCAL_RANK"):  # torchrun started this process for one device
            _rank_main(int(os.environ["LOCAL_RANK"]), fn, cfg.to_dict(), "env://", timeout_s, first)
            return
    else:
        init_method, own_dir = rendezvous(parent)
    import torch.multiprocessing as tmp

    ctx = None
    try:
        ctx = tmp.start_processes(_rank_main, args=(fn, cfg.to_dict(), init_method, timeout_s, first),
                                  nprocs=dist.devices_per_node, join=False, start_method="spawn")
        end = None if deadline_s is None else time.monotonic() + float(deadline_s)
        while not ctx.join(timeout=1.0):  # raises when a rank failed, after ending the others
            if end is not None and time.monotonic() > end:
                raise TimeoutError(f"the {dist.devices_per_node} ranks did not finish within {deadline_s} s")
    finally:
        if ctx is not None:  # every rank ends with the launch, however it ends
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        if own_dir is not None:
            shutil.rmtree(own_dir, ignore_errors=True)
