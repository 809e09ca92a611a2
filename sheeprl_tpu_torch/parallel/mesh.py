"""Data parallelism on ``torch.distributed`` (counterpart of
``sheeprl_tpu/parallel/mesh.py``'s ``Distributed`` and ``build_distributed``
at ``(dp=N, fsdp=1, tp=1)``).

The JAX package is single-controller: one process steps ``env.num_envs``
envs, samples a global batch of ``per_rank_batch_size × world_size`` and
shards it along the batch axis, and XLA averages the gradients inside the
jitted step. The port runs one process per device instead, as the JAX
package lays out a multi-host run, and keeps the config's meaning:

* ``launch(fn, cfg)`` runs ``fn(cfg)`` on ``fabric.devices`` ranks: in this
  process at world size 1, else in that many processes started with the
  ``spawn`` method. Each rank gets a device (``cuda:<rank>`` on the card,
  the CPU under ``fabric.accelerator=cpu``) and a process group (NCCL on the
  card, gloo on the CPU) with a timeout, so a collective that one rank never
  reaches fails the run instead of hanging it. At world size 1 a group is
  made only under ``fabric.strategy=ddp`` (Lightning Fabric's meaning: the
  collective path on one device); under ``auto`` there is none, and every
  collective is the identity, as a one-device JAX mesh emits no psum;
* rank ``d`` steps env block ``d`` (``local_envs``) and samples its
  ``batch / world_size`` columns from its own block;
* ``all_reduce_mean`` averages a list of tensors in one flattened
  all-reduce (the gradients of one optimizer step); ``all_gather``
  concatenates along the leading axis (DreamerV3's Moments take quantiles
  of the global batch); ``broadcast``, ``scatter`` and the ``*_object``
  collectives carry what is not a tensor on the card (rollouts, buffer
  states, the log directory) over a gloo group;
* every collective that runs counts its calls and bytes in ``stats``.

``running()`` makes the group, makes this ``Distributed`` the one the loops
read (``current``) and saves the generators' states; when the run ends, in
any way, it destroys the group and restores both. ``fsdp``/``tp`` > 1,
``fabric.shard_optimizer_state`` and ``num_nodes > 1`` raise, naming the
ROADMAP item that will take them.
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

MESH_AXES = ("dp", "fsdp", "tp")
# what the refusals name (ROADMAP.md, Queue 1)
WAITS_FOR_SHARDING = "ROADMAP Queue 1 item 4 (the mesh's FSDP2 and tensor parallelism)"
# the JAX package's rule for the actor fleet in more than one process
# (sheeprl_tpu/fleet/engine.py): the port's ranks are processes
FLEET_DISABLED = ("[fleet] actor fleet disabled: the fleet is a single-controller layout (multi-host runs keep "
                  "their per-process env loops)")
DEFAULT_TIMEOUT_S = 600.0
DEFAULT_MIN_SHARD_SIZE = 2**14

_ACTIVE: Optional["Distributed"] = None


def resolve_mesh_shape(n_devices: int, dp: int = -1, fsdp: int = 1, tp: int = 1) -> Tuple[int, int, int]:
    """``fabric.mesh.{dp,fsdp,tp}`` as a concrete ``(dp, fsdp, tp)`` whose
    product is ``n_devices``; at most one axis may be -1 (auto-fill). The
    JAX package's ``resolve_mesh_shape``, with its messages."""
    sizes = {"dp": int(dp), "fsdp": int(fsdp), "tp": int(tp)}
    autos = [name for name, s in sizes.items() if s == -1]
    if len(autos) > 1:
        raise ValueError(f"fabric.mesh: at most one axis may be -1, got {sizes}")
    for name, s in sizes.items():
        if s != -1 and s < 1:
            raise ValueError(f"fabric.mesh.{name} must be >= 1 or -1, got {s}")
    if autos:
        fixed = int(np.prod([s for name, s in sizes.items() if name != autos[0]]))
        if n_devices % fixed:
            raise ValueError(f"fabric.mesh: {n_devices} devices not divisible by the fixed axes "
                             f"{ {k: v for k, v in sizes.items() if k != autos[0]} }")
        sizes[autos[0]] = n_devices // fixed
    prod = sizes["dp"] * sizes["fsdp"] * sizes["tp"]
    if prod != n_devices:
        raise ValueError(f"fabric.mesh: dp*fsdp*tp = {prod} but the mesh has {n_devices} devices ({sizes}); "
                         "set one axis to -1 to auto-fill")
    return sizes["dp"], sizes["fsdp"], sizes["tp"]


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
    """The rank's view of a ``(dp=N, fsdp=1, tp=1)`` mesh on
    ``torch.distributed``, threaded through the training loops."""

    def __init__(self, devices: Any = 1, accelerator: str = "auto", precision: str = "32-true", num_nodes: int = 1,
                 strategy: Optional[str] = "auto", mesh: Any = None, shard_optimizer_state: bool = False,
                 rank: int = 0):
        strategy = "auto" if strategy is None else str(strategy)
        if strategy not in ("auto", "ddp", "dp"):
            raise ValueError(f"Unsupported fabric.strategy '{strategy}': data parallelism is expressed by the "
                             "device mesh; use fabric.devices to scale")
        if int(num_nodes) > 1:
            raise NotImplementedError(f"fabric.num_nodes={num_nodes}: the PyTorch port runs on one host; more "
                                      f"nodes wait for {WAITS_FOR_SHARDING}")
        self.platform = _platform(accelerator)
        available = torch.cuda.device_count() if self.platform == "cuda" else (os.cpu_count() or 1)
        n = available if devices in ("auto", -1, "-1", None) else int(devices)
        if n < 1:
            raise ValueError(f"fabric.devices must be >= 1, got {devices}")
        if n > available:
            raise RuntimeError(f"Requested {n} devices but only {available} available ({self.platform})")
        dp, fsdp, tp = resolve_mesh_shape(n, dp=int(_get(mesh, "dp", -1)), fsdp=int(_get(mesh, "fsdp", 1)),
                                          tp=int(_get(mesh, "tp", 1)))
        if fsdp > 1 or tp > 1:
            raise NotImplementedError(f"fabric.mesh fsdp={fsdp} tp={tp}: the PyTorch port shards the batch only "
                                      f"(dp); parameter and tensor sharding wait for {WAITS_FOR_SHARDING}")
        if bool(shard_optimizer_state):
            raise NotImplementedError("fabric.shard_optimizer_state=True (ZeRO-1 optimizer sharding) waits for "
                                      f"{WAITS_FOR_SHARDING}")
        if not 0 <= int(rank) < n:
            raise ValueError(f"rank {rank} outside a world of {n}")
        self.axis_sizes: Dict[str, int] = {"dp": dp, "fsdp": fsdp, "tp": tp}
        # the JAX package's floor under which a leaf is never sharded: kept for
        # the FSDP half (ROADMAP Queue 1 item 4), which nothing runs yet
        self.min_shard_size = int(_get(mesh, "min_shard_size", DEFAULT_MIN_SHARD_SIZE))
        self.strategy = strategy
        self.precision: Precision = get_precision(str(precision))
        self.num_nodes = int(num_nodes)
        self.rank = int(rank)
        self._world = n
        self.group: Any = None  # the default process group, once made
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
    def process_index(self) -> int:
        return self.rank

    @property
    def is_global_zero(self) -> bool:
        return self.rank == 0

    @property
    def device(self) -> torch.device:
        if self.platform == "cuda":
            return torch.device("cuda", self.rank if self._world > 1 else torch.cuda.current_device())
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
        """This rank's env block ``[lo, hi)`` of ``num_envs`` envs (they must
        divide by the world size)."""
        if num_envs % self._world:
            raise ValueError(f"env.num_envs ({num_envs}) must be divisible by the world size ({self._world}): each "
                             "rank steps an equal env block")
        epd = num_envs // self._world
        return self.rank * epd, (self.rank + 1) * epd

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
        tdist.init_process_group(self.backend, init_method=init_method, world_size=self._world, rank=self.rank,
                                 timeout=datetime.timedelta(seconds=float(timeout_s)))
        self.group = tdist.group.WORLD
        if self.backend == "nccl" and self._world > 1:
            self._objects = tdist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=float(timeout_s)))

    def destroy(self) -> None:
        if self.group is None:
            return
        import torch.distributed as tdist

        try:
            if tdist.is_initialized():
                tdist.destroy_process_group()
        finally:
            self.group = self._objects = None

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

    def _count(self, op: str, nbytes: int = 0) -> None:
        self.stats[op] += 1
        if op != "object":
            self.stats[f"{op}_bytes"] += int(nbytes)

    @torch.no_grad()
    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]) -> None:
        """In place: each tensor becomes its mean over the ranks, in one
        flattened all-reduce (the identity without a group)."""
        tensors = [t for t in tensors if t is not None]
        if self.group is None or not tensors:
            return
        import torch.distributed as tdist

        flat = torch.cat([t.reshape(-1) for t in tensors])
        self._count("all_reduce", flat.numel() * flat.element_size())
        tdist.all_reduce(flat)
        flat.div_(self._world)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n

    @torch.no_grad()
    def all_reduce_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``tensor`` (a new tensor)."""
        if self.group is None:
            return tensor.clone()
        import torch.distributed as tdist

        out = tensor.detach().clone()
        self._count("all_reduce", out.numel() * out.element_size())
        tdist.all_reduce(out)
        return out

    @torch.no_grad()
    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's ``tensor`` (same shape on each) concatenated along the
        leading axis in rank order (``tensor`` itself without a group)."""
        if self.group is None:
            return tensor
        import torch.distributed as tdist

        t = tensor.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(self._world)]
        self._count("all_gather", t.numel() * t.element_size() * self._world)
        tdist.all_gather(parts, t)
        return torch.cat(parts)

    @torch.no_grad()
    def broadcast(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """In place: every rank's tensors take rank ``src``'s values."""
        if self.group is None:
            return
        import torch.distributed as tdist

        for t in tensors:
            self._count("broadcast", t.numel() * t.element_size())
            tdist.broadcast(t, src)

    @torch.no_grad()
    def scatter(self, chunks: Optional[Sequence[torch.Tensor]], like: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src`` hands ``chunks[d]`` to rank ``d``; every rank passes
        ``like`` (its chunk's shape, dtype and device) and gets its chunk."""
        if self.group is None:
            return chunks[0]
        import torch.distributed as tdist

        out = torch.empty_like(like)
        self._count("scatter", out.numel() * out.element_size())
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
        self._count("object")
        return box[0]

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every rank's picklable ``obj``, in rank order."""
        if self.group is None or self._world == 1:
            return [obj]
        import torch.distributed as tdist

        out: List[Any] = [None] * self._world
        tdist.all_gather_object(out, obj, group=self._object_group())
        self._count("object")
        return out

    def gather_object(self, obj: Any, dst: int = 0) -> Optional[List[Any]]:
        """Every rank's ``obj`` on rank ``dst`` (in rank order), None elsewhere."""
        if self.group is None or self._world == 1:
            return [obj]
        import torch.distributed as tdist

        out: Optional[List[Any]] = [None] * self._world if self.rank == dst else None
        tdist.gather_object(obj, out, dst=dst, group=self._object_group())
        self._count("object")
        return out

    def reduce_metrics(self, aggregator: Any) -> None:
        """Every rank's log interval folded into rank 0's ``aggregator`` (a
        collective; the metrics rank 0 logs are the global ones)."""
        if self.group is None or self._world == 1:
            return
        states = self.gather_object(aggregator.states())
        if states is not None:
            aggregator.combine(states)

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (a stop decision
        that must be the same everywhere)."""
        if self.group is None or self._world == 1:
            return bool(flag)
        return any(self.all_gather_object(bool(flag)))


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


def rank_resume(state: Optional[Dict[str, Any]], dist: Distributed) -> Optional[Dict[str, Any]]:
    """This rank's generators of a checkpoint (None for a fresh run). A
    checkpoint of another world size raises: its env blocks and generators
    do not map onto these ranks."""
    if not state:
        return None
    saved = int(state.get("world_size", 1))
    if saved != dist.world_size:
        raise NotImplementedError(f"the checkpoint was written on {saved} ranks and this run has "
                                  f"{dist.world_size}: resuming at another world size is not supported")
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


def _rank_main(rank: int, fn: Callable[[Any], None], cfg_dict: Dict[str, Any], init_method: str,
               timeout_s: float) -> None:
    """A spawned rank: its ``Distributed``, its group, ``fn(cfg)``. On the
    host the ranks share its cores: each takes its share of them for
    PyTorch's intra-op threads."""
    from ..config import Config

    cfg = Config(cfg_dict)
    dist = build_distributed(cfg, rank=rank)
    if dist.platform == "cpu":
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // dist.world_size))
    with dist.running(init_method, timeout_s):
        fn(cfg)


def launch(fn: Callable[[Any], None], cfg: Any, deadline_s: Optional[float] = None) -> None:
    """Run ``fn(cfg)`` on ``fabric.devices`` ranks: here at world size 1,
    else in as many ``spawn`` processes (``fn`` must be picklable: a module's
    function or a partial of one). A rank that fails ends the others and the
    launch raises its error. The rendezvous is a ``file://`` store in a fresh
    directory under ``fabric.rendezvous_dir`` (the system's temporary
    directory when null), removed when the run ends. ``deadline_s`` bounds
    the wait for the spawned ranks: past it they are killed and the launch
    raises ``TimeoutError``."""
    dist = build_distributed(cfg)
    timeout_s = float(cfg.select("fabric.timeout_s", DEFAULT_TIMEOUT_S) or DEFAULT_TIMEOUT_S)
    parent = cfg.select("fabric.rendezvous_dir")
    if dist.world_size == 1:
        with dist.running(None, timeout_s, rendezvous_dir=parent):
            fn(cfg)
        return
    import torch.multiprocessing as tmp

    init_method, own_dir = rendezvous(parent)
    ctx = None
    try:
        ctx = tmp.start_processes(_rank_main, args=(fn, cfg.to_dict(), init_method, timeout_s),
                                  nprocs=dist.world_size, join=False, start_method="spawn")
        end = None if deadline_s is None else time.monotonic() + float(deadline_s)
        while not ctx.join(timeout=1.0):  # raises when a rank failed, after ending the others
            if end is not None and time.monotonic() > end:
                raise TimeoutError(f"the {dist.world_size} ranks did not finish within {deadline_s} s")
    finally:
        if ctx is not None:  # every rank ends with the launch, however it ends
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        shutil.rmtree(own_dir, ignore_errors=True)
