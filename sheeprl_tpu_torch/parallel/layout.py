"""Optimizer states laid out over the ``(dp, fsdp, tp)`` mesh (the port's
counterpart of what ``sheeprl_tpu/parallel/mesh.py``'s ``shard_opt_state``
does with ``NamedSharding``).

The port keeps every parameter whole on every rank, on every mesh: the
forward, the backward and the gradients are the 1-D path's. What the fsdp
and tp axes (and ZeRO-1 over dp) divide is the optimizer state.
``SpecEngine`` (``parallel/sharding.py``) decides a spec per Adam moment on
its flax path and shape, and ``placements`` turns a decision into the torch
dimension each mesh axis cuts. For every parameter whose moments the
optimizer-state report shards, a ``ParamLayout`` hands the rank's optimizer
``owned``, a view of the rank's slice of the whole parameter, so Adam's
moments take exactly the bytes that report gives each rank.

Each clipped optimizer (``optim.Clipped`` with ``layout``) then takes the
sharded step: the whole gradients averaged over the data ranks (dp × fsdp;
the ranks of a tp group saw the same batch) in one flattened all-reduce,
clipped by the norm of the whole averaged gradient, cut to each ``owned``
slice, stepped, and the updated slices all-gathered back into the whole
parameters. Each gradient entry of a rank's slice is the averaged whole
gradient's, and Adam is elementwise, so a sharded step updates every
element exactly as the unsharded step on the same data ranks does.

A rank's memory during a burst is therefore the whole parameters, their
whole gradients and the flat copy the all-reduce averages, the activations,
the player's mirror and this rank's slice of the moments: the parameters
report (``mesh.maybe_shard_params``) says every parameter is whole.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from .sharding import MESH_AXES, Leaf, ShardingReport, SpecDecision, module_leaves, placements, spec_str, torch_leaf


class _Entry:
    """One parameter: its leaf, the axes (and torch dimensions) its
    optimizer state shards over, and the tensor the optimizer steps."""

    def __init__(self, leaf: Leaf, param: nn.Parameter):
        self.leaf = leaf
        self.full: nn.Parameter = param
        self.place: Dict[str, int] = {}
        self.owned: nn.Parameter = param


def kept_whole(report: ShardingReport) -> ShardingReport:
    """The parameters report of the layout the port applies: every leaf
    whole on every rank, each reason naming the engine's spec, which lays
    out the leaf's moments instead."""
    out = ShardingReport(group=report.group, axis_sizes=report.axis_sizes)
    for d in report.decisions:
        reason = d.reason if d.replicated else f"kept whole (the engine's {spec_str(d.spec)} lays out its moments)"
        out.decisions.append(SpecDecision(path=d.path, shape=d.shape, dtype_bytes=d.dtype_bytes,
                                          spec=(None,) * len(d.shape), rule=d.rule, reason=reason, group=d.group))
    return out


class ParamLayout:
    """The layout of ``modules`` (``{name: module}``, named as the JAX
    package's parameter tree) on ``dist``'s mesh."""

    def __init__(self, dist: Any, modules: Dict[str, nn.Module]):
        self.dist = dist
        self.modules = dict(modules)
        self._by_param: Dict[int, _Entry] = {id(p): _Entry(leaf, p) for leaf, _, _, p in module_leaves(self.modules)}
        self._by_opt: Dict[int, List[_Entry]] = {}

    def _slice(self, t: torch.Tensor, place: Dict[str, int]) -> torch.Tensor:
        for ax, d in place.items():
            size = t.shape[d] // self.dist.axis_sizes[ax]
            t = t.narrow(d, int(self.dist.coordinate[MESH_AXES.index(ax)]) * size, size)
        return t

    def _gather(self, local: torch.Tensor, place: Dict[str, int]) -> torch.Tensor:
        """The whole tensor from every rank's ``local`` slice (``place``)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        spec = [Shard(place[ax]) if ax in place else Replicate() for ax in MESH_AXES]
        for ax in place:
            self.dist.count_collective("all_gather", local.numel() * local.element_size() * self.dist.axis_sizes[ax])
        return DTensor.from_local(local.detach().contiguous(), self.dist.device_mesh, spec,
                                  run_check=False).full_tensor()

    def shard_opt_state(self, opt: Any, module: nn.Module, decisions: Dict[str, SpecDecision], prefix: str) -> None:
        """Move the clipped optimizer ``opt`` of ``module``'s parameters onto
        their ``owned`` slices, cutting its state (fresh or resumed,
        whole-shaped) to them. ``decisions`` are the optimizer-state report's,
        by path; ``prefix`` is where the optimizer's ``mu`` leaves sit
        (``<name>/1/0/mu/``), before each parameter's path in ``module``."""
        rel = {id(p): torch_leaf(module, n, p).path for n, p in module.named_parameters()}
        inner = opt.optimizer
        entries = []
        for group in inner.param_groups:
            new = []
            for p in group["params"]:
                e = self._by_param[id(p)]
                place = placements(decisions[prefix + rel[id(p)]], e.leaf)
                if place:
                    e.place = place
                    e.owned = nn.Parameter(self._slice(e.full.data, place), requires_grad=e.full.requires_grad)
                st = inner.state.pop(p, None)
                if st:
                    inner.state[e.owned] = {k: (self._slice(v, place).clone() if torch.is_tensor(v) and v.dim() else v)
                                            for k, v in st.items()}
                new.append(e.owned)
                entries.append(e)
            group["params"] = new
        self._by_opt[id(opt)] = entries
        opt.layout = self

    def opt_local_bytes(self, opt: Any) -> int:
        """The bytes of ``opt``'s moments on this rank."""
        return sum(v.numel() * v.element_size() for st in opt.optimizer.state.values() for k, v in st.items()
                   if torch.is_tensor(v) and v.dim())

    def compute_params(self, opt: Any) -> List[torch.Tensor]:
        """The whole parameters ``opt``'s slices are cut from, in its order."""
        return [e.full for e in self._by_opt[id(opt)]]

    def zero_grad(self, opt: Any) -> None:
        for e in self._by_opt[id(opt)]:
            e.full.grad = None
            e.owned.grad = None

    @torch.no_grad()
    def step(self, opt: Any) -> None:
        """``opt``'s sharded step (see the module's docstring)."""
        from ..optim import clip_by_global_norm_

        entries = self._by_opt[id(opt)]
        grads = [e.full.grad if e.full.grad is not None else torch.zeros_like(e.full) for e in entries]
        self.dist.all_reduce_mean(grads)
        if opt.max_grad_norm is not None and grads:
            clip_by_global_norm_(grads, opt.max_grad_norm)
        for e, g in zip(entries, grads):
            e.owned.grad = self._slice(g, e.place).contiguous() if e.place else g
        opt.optimizer.step()
        for e in entries:
            if e.place:
                e.full.data.copy_(self._gather(e.owned.data, e.place))

    def full_opt_state(self, opt: Any) -> Dict[str, Any]:
        """``opt``'s ``state_dict()`` with every moment whole (a collective:
        every rank calls it), as the unsharded optimizer's would be."""
        sd = opt.optimizer.state_dict()
        entries = self._by_opt.get(id(opt))
        if entries is None:
            return sd
        state = {}
        for i, e in enumerate(entries):
            st = sd["state"].get(i)
            if st is None:
                continue
            state[i] = {k: (self._gather(v, e.place) if e.place and torch.is_tensor(v) and v.dim() else v)
                        for k, v in st.items()}
        return {**sd, "state": state}
