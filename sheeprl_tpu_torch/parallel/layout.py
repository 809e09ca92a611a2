"""Parameters and optimizer states laid out over the ``(dp, fsdp, tp)`` mesh
(the port's counterpart of what ``sheeprl_tpu/parallel/mesh.py``'s
``shard_params`` and ``shard_opt_state`` do with ``NamedSharding``).

``SpecEngine`` (``parallel/sharding.py``) decides a spec per leaf on its
flax path and shape, and ``placements`` turns a decision into the torch
dimension each mesh axis cuts: an fsdp leaf is cut on the engine's
dimension, a ``tp_out`` kernel on its output (column-parallel), a ``tp_in``
kernel on its input (row-parallel).

**Parameters** (``ParamLayout.shard_params``, DreamerV3's on a mesh with
fsdp or tp > 1). Every parameter the ``params`` report does not replicate
keeps, at rest, only this rank's shard: the module's registered
``nn.Parameter`` holds the shard's data, its ``.grad`` the shard's
gradient, and its Adam moments follow it. A module that owns a sharded
parameter is a unit. Its forward pre-hook all-gathers each shard into a
whole copy, made by ``_Gather`` (an autograd function: the whole copy's
gradient, averaged over the data ranks, comes back as the shard's), swaps
the copy in for the call and frees the copy's storage when the call
returns. The tensors the call saves for its backward that are the whole
copy or views of it are saved as handles (``saved_tensors_hooks``): the
backward gathers the copy again where a saved handle is unpacked, and frees
it when ``_Gather``'s backward has run, which is after every use of the
copy in that graph. So one unit's whole weights are on the rank at a time,
in the forward and in the backward. A unit called many times in a phase (a
scan) gathers at each call but keeps one ``_Gather`` node per phase, so its
gradient is reduced once, summed over the calls as an unsharded backward
sums it. Compute is on the gathered weight: the tp axis divides the
parameters' storage and gradients, not the matmuls, so a column-parallel
output is whole before its LayerNorm. Code that reads a unit's weight
outside its forward (the LN-GRU sequence kernels take the whole fused
weight) does so inside ``gathered(layout, module)``. An optimizer step moves the
shards, so it releases every gathered copy; a saved handle unpacked after
a release raises.

**Optimizer states** (``shard_opt_state``, every algorithm's on such a
mesh, and ZeRO-1 over dp). A moment follows its parameter's spec; a
replicated parameter's moments take the leading-axis ZeRO-1 layout where it
divides. Each clipped optimizer (``optim.Clipped`` with ``layout``) steps
``owned`` tensors: a sharded parameter itself, or a view of this rank's
slice of a replicated whole parameter. Its step averages the replicated
parameters' whole gradients over the data ranks (dp × fsdp; the ranks of a
tp group saw the same batch) in one flattened all-reduce (the sharded ones
were averaged in the backward), clips by the norm of the whole averaged
gradient (each shard's square sum counted once over the ranks that hold
it, replicated leaves once), steps, and all-gathers the updated ZeRO-1
slices back into their whole parameters. Adam is elementwise, so every
element is updated as the unsharded step on the same data ranks updates it.

On a pure-dp mesh the parameters are not laid out at all (the JAX
package's rule: the 1-D path stays bit-identical), and ZeRO-1 is the only
layout.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch import nn

from .sharding import MESH_AXES, Leaf, ShardingReport, SpecDecision, module_leaves, placements, torch_leaf


class _Entry:
    """One parameter: its whole leaf, its owner module, the axes (and torch
    dimensions) that shard it and its optimizer state, the tensor the
    optimizer steps, and this phase's gathered whole copy."""

    def __init__(self, leaf: Leaf, module: nn.Module, name: str, param: nn.Parameter):
        self.leaf = leaf
        self.module, self.name = module, name
        self.param: nn.Parameter = param  # the registered parameter: its data is the shard when `place`
        self.shape = tuple(param.shape)  # the whole shape
        self.place: Dict[str, int] = {}  # the parameter's own layout
        self.opt_place: Dict[str, int] = {}  # its moments'
        self.owned: nn.Parameter = param
        self.shards = 1
        self.whole: Optional[torch.Tensor] = None  # the phase's _Gather output (storage freed between uses)
        self.serial = 0  # counts the whole copies made
        self.cast: Optional[torch.Tensor] = None  # its cast into a compute dtype, under mixed precision
        self.stash: List[Any] = []  # what the unit's forward swapped out


class _Gather(torch.autograd.Function):
    """The whole parameter from this rank's shard; its backward averages the
    whole gradient over the data ranks and returns this rank's slice."""

    @staticmethod
    def forward(ctx, shard, layout, entry):
        ctx.layout, ctx.entry, ctx.serial = layout, entry, entry.serial
        return layout.gather(shard, entry.place)

    @staticmethod
    def backward(ctx, grad):
        layout, e = ctx.layout, ctx.entry
        if e.serial == ctx.serial:
            layout.free(e)  # every use of this whole copy in this graph is done
        grad = layout.dist.mean_over_data(grad)
        return layout.slice(grad, e.place).clone(), None, None


def _free(t: Optional[torch.Tensor]) -> None:
    if t is not None and t.untyped_storage().nbytes():
        t.untyped_storage().resize_(0)


class _Handle:
    """A saved tensor that is a gathered whole copy (or a view of one): the
    copy, its entry, the view's geometry and the release it belongs to."""

    __slots__ = ("base", "entry", "geometry", "epoch")

    def __init__(self, base, entry, t, epoch):
        self.base, self.entry, self.epoch = base, entry, epoch
        self.geometry = (t.size(), t.stride(), t.storage_offset())


class ParamLayout:
    """The layout of ``modules`` (``{name: module}``, named as the JAX
    package's parameter tree) on ``dist``'s mesh."""

    def __init__(self, dist: Any, modules: Dict[str, nn.Module]):
        self.dist = dist
        self.modules = dict(modules)
        self._by_param: Dict[int, _Entry] = {}
        for leaf, prefix, name, p in module_leaves(self.modules):
            mod_path, _, attr = name.rpartition(".")
            owner = self.modules[prefix].get_submodule(mod_path) if mod_path else self.modules[prefix]
            self._by_param[id(p)] = _Entry(leaf, owner, attr, p)
        self._by_opt: Dict[int, List[_Entry]] = {}
        self._units: Dict[nn.Module, List[_Entry]] = {}
        self._hooks: List[Any] = []
        self._epoch = 0  # counts the releases of the gathered copies
        self._active: List[_Entry] = []  # the entries whose whole copies the open forward reads
        self._open: Dict[nn.Module, List[Any]] = {}  # the open forwards' states, by unit
        self.gathered_peak_bytes = 0  # the most whole-copy bytes held at once (the caller resets it)

    # -- the mesh's collectives on one tensor ----------------------------------
    def slice(self, t: torch.Tensor, place: Dict[str, int]) -> torch.Tensor:
        """This rank's block of the whole ``t`` (a view)."""
        for ax, d in place.items():
            size = t.shape[d] // self.dist.axis_sizes[ax]
            t = t.narrow(d, int(self.dist.coordinate[MESH_AXES.index(ax)]) * size, size)
        return t

    @torch.no_grad()
    def gather(self, local: torch.Tensor, place: Dict[str, int]) -> torch.Tensor:
        """The whole tensor from every rank's ``local`` block (``place``): an
        all-gather over each axis that cuts it."""
        import torch.distributed as tdist

        t = local.detach().contiguous()
        for ax, d in place.items():
            n = self.dist.axis_sizes[ax]
            parts = [torch.empty_like(t) for _ in range(n)]
            self.dist.count_collective("all_gather", t.numel() * t.element_size() * n)
            tdist.all_gather(parts, t, group=self.dist.device_mesh.get_group(ax))
            t = torch.cat(parts, d)
        return t

    # -- the parameters' layout ---------------------------------------------------
    @property
    def sharded(self) -> List[_Entry]:
        return [e for e in self._by_param.values() if e.place]

    def _held(self) -> None:
        """Note the bytes of whole copies now held, for ``gathered_peak_bytes``."""
        held = sum(t.untyped_storage().nbytes() for es in self._units.values() for e in es
                   for t in (e.whole, e.cast) if t is not None)
        self.gathered_peak_bytes = max(self.gathered_peak_bytes, held)

    def shard_params(self, report: ShardingReport) -> None:
        """Cut every parameter the ``params`` report does not replicate to
        this rank's shard and hook its unit (a collective-free step: each
        rank keeps its own block of the whole it holds)."""
        by_path = {d.path: d for d in report.decisions}
        for e in self._by_param.values():
            place = placements(by_path[e.leaf.path], e.leaf)
            if not place:
                continue
            e.place, e.shards = place, 1
            for ax in place:
                e.shards *= self.dist.axis_sizes[ax]
            e.param.data = self.slice(e.param.data, place).clone()
            self._units.setdefault(e.module, []).append(e)
        for mod in self._units:
            self._hooks.append(mod.register_forward_pre_hook(self._pre_forward))
            self._hooks.append(mod.register_forward_hook(self._post_forward, always_call=True))

    def _materialize(self, e: _Entry, dtype: torch.dtype) -> torch.Tensor:
        """This phase's whole copy of ``e`` in ``dtype``, gathered (again)
        where its storage was freed."""
        graph = torch.is_grad_enabled() and e.param.requires_grad
        if e.whole is None or (graph and e.whole.grad_fn is None):
            e.serial += 1
            e.whole = _Gather.apply(e.param, self, e) if graph else self.gather(e.param, e.place)
            e.cast = None
        else:
            self._refill(e.whole, e)
        if dtype != e.whole.dtype:
            if e.cast is None or e.cast.dtype != dtype or (graph and e.cast.grad_fn is None):
                e.cast = e.whole.to(dtype)
            else:
                self._refill(e.cast, e, e.whole)
        self._held()
        return e.whole if dtype == e.whole.dtype else e.cast

    def _refill(self, t: torch.Tensor, e: _Entry, src: Optional[torch.Tensor] = None) -> None:
        if t.untyped_storage().nbytes():
            return
        data = self.gather(e.param, e.place) if src is None else src
        t.untyped_storage().resize_(t.numel() * t.element_size())
        with torch.no_grad():
            t.copy_(data)

    def free(self, e: _Entry) -> None:
        """Free the storage of ``e``'s whole copies (the tensors stay, empty)."""
        _free(e.whole)
        _free(e.cast)

    def release(self) -> None:
        """Drop every gathered copy (the shards moved, or the phase ended)."""
        self._epoch += 1
        for e in self.sharded:
            self.free(e)
            e.whole = e.cast = None

    def _pack(self, t: torch.Tensor) -> Any:
        base = t if t._base is None else t._base
        for e in self._active:
            if base is e.whole or base is e.cast:
                return _Handle(base, e, t, self._epoch)
        return t

    def _unpack(self, h: Any) -> torch.Tensor:
        if not isinstance(h, _Handle):
            return h
        if h.epoch != self._epoch:
            raise RuntimeError("a gathered parameter was read by a backward after the optimizer step moved it")
        e = h.entry
        if h.base is e.cast and e.whole is not None:  # the cast refills from its whole copy
            self._refill(e.whole, e)
            self._refill(h.base, e, e.whole)
        else:
            self._refill(h.base, e)
        self._held()
        return h.base.as_strided(*h.geometry)

    def _enter(self, modules: List[nn.Module]) -> Any:
        entries = []
        for mod in modules:
            for e in self._units.get(mod, ()):
                cur = mod._parameters[e.name]
                whole = self._materialize(e, cur.dtype)
                e.stash.append(cur)
                mod._parameters[e.name] = whole
                entries.append(e)
        outer, self._active = self._active, entries
        hooks = torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)
        hooks.__enter__()
        return hooks, entries, outer

    def _exit(self, state: Any) -> None:
        hooks, entries, self._active = state
        hooks.__exit__(None, None, None)
        for e in entries:
            e.module._parameters[e.name] = e.stash.pop()
            self.free(e)

    def _pre_forward(self, mod: nn.Module, args: Any) -> None:
        self._open.setdefault(mod, []).append(self._enter([mod]))

    def _post_forward(self, mod: nn.Module, args: Any, out: Any) -> None:
        states = self._open.get(mod)
        if states:
            self._exit(states.pop())

    def whole_tensor(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` whole: gathered if it is a sharded parameter (a collective)."""
        e = self._by_param.get(id(t))
        return self.gather(t, e.place) if e is not None and e.place else t

    def state_dict(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        """``module.state_dict()`` with every sharded parameter whole (a
        collective: every rank calls it), as the unsharded module's."""
        sd = module.state_dict()
        for name, p in module.named_parameters():
            e = self._by_param.get(id(p))
            if e is not None and e.place:
                sd[name] = self.gather(p, e.place)
        return sd

    def unshard(self) -> None:
        """Every sharded parameter whole again and the units unhooked (a
        collective), for what runs after training (the test episode, the
        registry)."""
        self.release()
        for e in self.sharded:
            e.param.data = self.gather(e.param, e.place)
            e.param.grad = None
        for h in self._hooks:
            h.remove()
        self._hooks, self._units = [], {}

    def leaf_shape(self, p: torch.Tensor) -> Optional[tuple]:
        """The whole shape of a parameter of the layout's modules."""
        e = self._by_param.get(id(p))
        return e.shape if e is not None else None

    # -- the optimizer states' layout ---------------------------------------------
    def shard_opt_state(self, opt: Any, module: nn.Module, decisions: Dict[str, SpecDecision], prefix: str) -> None:
        """Move the clipped optimizer ``opt`` of ``module``'s parameters onto
        their ``owned`` tensors, cutting its state (fresh or resumed,
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
                if e.place and place != e.place:
                    raise RuntimeError(f"{e.leaf.path}: its moments' layout {place} is not its own {e.place}")
                e.opt_place = place
                if place and not e.place:  # ZeRO-1: the optimizer steps a slice of the whole parameter
                    e.owned = nn.Parameter(self.slice(e.param.data, place), requires_grad=e.param.requires_grad)
                st = inner.state.pop(p, None)
                if st:
                    inner.state[e.owned] = {k: (self.slice(v, place).clone() if torch.is_tensor(v) and v.dim() else v)
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
        """The parameters the step's graph reads and its gradients land on,
        in ``opt``'s order: the registered ones (a sharded one holds its
        shard)."""
        return [e.param for e in self._by_opt[id(opt)]]

    def zero_grad(self, opt: Any) -> None:
        for e in self._by_opt[id(opt)]:
            e.param.grad = None
            e.owned.grad = None

    @torch.no_grad()
    def step(self, opt: Any) -> None:
        """``opt``'s laid-out step (see the module's docstring)."""
        from ..optim import clip_by_global_norm_

        entries = self._by_opt[id(opt)]
        grads = [e.param.grad if e.param.grad is not None else torch.zeros_like(e.param) for e in entries]
        self.dist.all_reduce_mean([g for e, g in zip(entries, grads) if not e.place])
        if opt.max_grad_norm is not None and grads:
            if any(e.place for e in entries):
                self._clip(entries, grads, opt.max_grad_norm)
            else:
                clip_by_global_norm_(grads, opt.max_grad_norm)
        for e, g in zip(entries, grads):
            if e.owned is e.param:
                e.param.grad = g
            else:
                e.owned.grad = self.slice(g, e.opt_place).contiguous()
        opt.optimizer.step()
        for e in entries:
            if e.owned is not e.param:
                e.param.data.copy_(self.gather(e.owned.data, e.opt_place))
                e.owned.grad = None
        self.release()

    def _clip(self, entries: List[_Entry], grads: List[torch.Tensor], max_norm: float) -> None:
        """``clip_by_global_norm_`` on the whole averaged gradient: a shard's
        square sum is weighted by shards / world size, so the sum over every
        rank counts each block once; replicated leaves add theirs once."""
        world = self.dist.world_size
        sharded = [g.square().sum() * (e.shards / world) for e, g in zip(entries, grads) if e.place]
        whole = [g.square().sum() for e, g in zip(entries, grads) if not e.place]
        sq = self.dist.all_reduce_sum(torch.stack(sharded).sum())
        if whole:
            sq = sq + torch.stack(whole).sum()
        norm = sq.sqrt()
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))

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
            place = e.opt_place
            state[i] = {k: (self.gather(v, place) if place and torch.is_tensor(v) and v.dim() else v)
                        for k, v in st.items()}
        return {**sd, "state": state}


@contextlib.contextmanager
def gathered(layout: Optional[ParamLayout], *modules: nn.Module) -> Iterator[None]:
    """Within the block, the sharded parameters of ``modules`` (units of
    ``layout``) read whole, as inside their forward; the identity without a
    layout or where none of them is a unit."""
    units = [m for m in modules if layout is not None and m in layout._units]
    state = layout._enter(units) if units else None
    try:
        yield
    finally:
        if state is not None:
            layout._exit(state)
