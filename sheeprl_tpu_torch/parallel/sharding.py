"""Partition-spec inference over the ``(dp, fsdp, tp)`` mesh (counterpart of
``sheeprl_tpu/parallel/sharding.py``).

The JAX package's rule engine, kept decision for decision: regex rules over
a leaf's ``/``-joined flax path pick a role (``tp_out``, ``tp_in``,
``fsdp``, ``replicate``), shape fallbacks and divisibility decide the rest,
and every decision is recorded (rule, reason, spec, bytes per chip) as a
``sharding`` telemetry event. A spec is a tuple with one entry per
dimension: ``None`` (replicated along it), an axis name, or a tuple of axis
names; ``spec_str`` writes it exactly as the JAX package writes a
``PartitionSpec``, so the two packages' reports compare line by line.

The engine decides on flax paths and flax layouts. The port's parameters
carry torch layouts (a Linear's weight is ``[out, in]``, a convolution's
OIHW), so ``torch_leaf`` names a port parameter by its flax path (the
inverse of ``convert.torch_key``/``kernel_to_torch``) and gives the flax
shape and the torch dimension of each flax dimension; ``module_leaves`` and
``adam_leaves`` list a module tree's parameters and an optimizer's Adam
moments that way, and ``placements`` turns a decision into the torch
dimension each mesh axis shards.

Degeneracy contract: on ``(dp=N, fsdp=1, tp=1)`` every parameter spec is
replicated and the ZeRO-1 layout shards only a leaf's leading dimension
over ``dp``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
MESH_AXES = (AXIS_DP, AXIS_FSDP, AXIS_TP)

# leaves smaller than this (elements) are never fsdp/ZeRO-sharded: the
# all-gather's latency would outweigh the memory it saves
DEFAULT_MIN_SHARD_SIZE = 2**14

Spec = Tuple[Any, ...]


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


@dataclass(frozen=True)
class SpecRule:
    """One named rule: ``pattern`` is a regex over the leaf's ``/``-joined
    flax path; ``role`` picks the placement recipe."""

    name: str
    pattern: str
    role: str  # tp_out | tp_in | fsdp | replicate

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


# first match wins; flax dense kernels are [in, out]: hidden projections
# shard the output dimension, heads the input dimension; convolutions and
# big unmatched leaves go to fsdp; norms and biases replicate
DEFAULT_PARAM_RULES: Tuple[SpecRule, ...] = (
    SpecRule("norm_or_bias", r"(^|/)(LayerNorm_\d+/.*|bias|scale)$", "replicate"),
    SpecRule("head_kernel", r"(^|/)(head_\d+|out|logits|to_obs)/kernel$", "tp_in"),
    SpecRule("dense_kernel", r"(^|/)(dense_\d+|Dense_\d+|fc|mlp|fused|representation|transition)/kernel$", "tp_out"),
    SpecRule("conv_kernel", r"(^|/)(conv|deconv)_\d+/kernel$", "fsdp"),
    SpecRule("embedding", r"(^|/)(embedding|embed\w*)(/kernel)?$", "fsdp"),
)


@dataclass
class SpecDecision:
    """One leaf's placement and why."""

    path: str
    shape: Tuple[int, ...]
    dtype_bytes: int
    spec: Spec
    rule: str
    reason: str
    group: str  # params | opt_state

    @property
    def bytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype_bytes if self.shape else self.dtype_bytes

    def shards(self, axis_sizes: Dict[str, int]) -> int:
        n = 1
        for entry in self.spec:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    n *= axis_sizes.get(ax, 1)
        return n

    def bytes_per_chip(self, axis_sizes: Dict[str, int]) -> int:
        return self.bytes // self.shards(axis_sizes)

    @property
    def replicated(self) -> bool:
        return all(e is None for e in self.spec)


@dataclass
class ShardingReport:
    """Every decision the engine took for one tree, and the per-chip totals."""

    group: str
    axis_sizes: Dict[str, int]
    decisions: List[SpecDecision] = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return sum(d.bytes for d in self.decisions)

    @property
    def bytes_per_chip(self) -> int:
        return sum(d.bytes_per_chip(self.axis_sizes) for d in self.decisions)

    @property
    def replicated_bytes(self) -> int:
        return sum(d.bytes for d in self.decisions if d.replicated)

    def summary(self) -> Dict[str, Any]:
        return {
            "group": self.group,
            "leaves": len(self.decisions),
            "replicated_leaves": sum(1 for d in self.decisions if d.replicated),
            "total_bytes": self.total_bytes,
            "bytes_per_chip": self.bytes_per_chip,
            "replicated_bytes": self.replicated_bytes,
            **{ax: int(sz) for ax, sz in self.axis_sizes.items()},
        }

    def events(self) -> List[Dict[str, Any]]:
        """The ``sharding`` telemetry records: one per leaf, then the summary
        (what doctor's ``replicated_giant`` reads)."""
        axis = {ax: int(sz) for ax, sz in self.axis_sizes.items()}
        out = [{"event": "sharding", "action": "leaf", "group": self.group, "path": d.path, "shape": list(d.shape),
                "spec": spec_str(d.spec), "rule": d.rule, "reason": d.reason, "bytes": d.bytes,
                "bytes_per_chip": d.bytes_per_chip(self.axis_sizes), **axis} for d in self.decisions]
        out.append({"event": "sharding", "action": "summary", **self.summary()})
        return out


def spec_str(spec: Spec) -> str:
    """``replicated``, or e.g. ``(fsdp, tp)`` / ``(None, tp)``."""
    if all(e is None for e in spec):
        return "replicated"
    parts = ["+".join(str(a) for a in e) if isinstance(e, tuple) else str(e) for e in spec]
    return "(" + ", ".join(parts) + ")"


def _biggest_divisible_axis(shape: Sequence[int], size: int, skip: Sequence[int] = ()) -> Optional[int]:
    best, best_dim = None, 0
    for i, dim in enumerate(shape):
        if i in skip or dim % size:
            continue
        if dim > best_dim:
            best, best_dim = i, dim
    return best


class SpecEngine:
    """A spec per leaf from the rules and the shape fallbacks. One engine
    per mesh: it knows the axis sizes, so size-1 axes drop out of every
    spec here, never at call sites."""

    def __init__(self, axis_sizes: Dict[str, int], rules: Sequence[SpecRule] = DEFAULT_PARAM_RULES,
                 min_shard_size: int = DEFAULT_MIN_SHARD_SIZE):
        self.axis_sizes = dict(axis_sizes)
        self.rules = tuple(rules)
        self.min_shard_size = int(min_shard_size)
        self.tp = int(axis_sizes.get(AXIS_TP, 1))
        self.fsdp = int(axis_sizes.get(AXIS_FSDP, 1))
        self.dp = int(axis_sizes.get(AXIS_DP, 1))

    # -- batch placement ---------------------------------------------------
    def data_axes(self) -> Tuple[str, ...]:
        """The axes a batch's batch dimension shards over: dp and fsdp (size-1
        axes dropped); tp ranks see the same batch."""
        return tuple(ax for ax, n in ((AXIS_DP, self.dp), (AXIS_FSDP, self.fsdp)) if n > 1)

    def batch_spec(self, batch_axis: int = 0) -> Spec:
        axes = self.data_axes()
        if not axes:
            return ()
        return (*([None] * batch_axis), axes[0] if len(axes) == 1 else axes)

    # -- parameter placement -----------------------------------------------
    def infer(self, path: str, shape: Sequence[int], dtype_bytes: int = 4, group: str = "params") -> SpecDecision:
        shape = tuple(int(s) for s in shape)
        rule_name, role = "shape-fallback", None
        for rule in self.rules:
            if rule.matches(path):
                rule_name, role = rule.name, rule.role
                break
        if role is None:  # big enough 2-D+ leaves are fsdp candidates, the rest replicate
            role = "fsdp" if len(shape) >= 2 else "replicate"
        return self._place(path, shape, dtype_bytes, rule_name, role, group)

    def _place(self, path: str, shape: Tuple[int, ...], dtype_bytes: int, rule_name: str, role: str,
               group: str) -> SpecDecision:
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        entries: List[Any] = [None] * len(shape)
        reasons: List[str] = []

        tp_axis_idx: Optional[int] = None
        if role in ("tp_out", "tp_in") and len(shape) >= 2 and self.tp > 1:
            cand = len(shape) - 1 if role == "tp_out" else len(shape) - 2
            if shape[cand] % self.tp == 0:
                entries[cand] = AXIS_TP
                tp_axis_idx = cand
                reasons.append(f"{role}: dim {cand} ({shape[cand]}) over tp={self.tp}")
            else:
                reasons.append(f"{role} wanted dim {cand} ({shape[cand]}) but tp={self.tp} does not divide it")
                role = "fsdp"
        elif role in ("tp_out", "tp_in"):
            if self.tp > 1:
                reasons.append(f"{role} needs >=2 dims, got {shape}")
            role = "fsdp"

        if role == "fsdp" or (tp_axis_idx is not None and self.fsdp > 1):
            if self.fsdp > 1 and size >= self.min_shard_size:
                skip = () if tp_axis_idx is None else (tp_axis_idx,)
                i = _biggest_divisible_axis(shape, self.fsdp, skip=skip)
                if i is not None:
                    entries[i] = AXIS_FSDP
                    reasons.append(f"fsdp: dim {i} ({shape[i]}) over fsdp={self.fsdp}")
                else:
                    reasons.append(f"no dim of {shape} divisible by fsdp={self.fsdp}")
            elif self.fsdp > 1 and size < self.min_shard_size:
                reasons.append(f"{size} elems under min_shard_size={self.min_shard_size}")

        if not reasons:
            reasons.append("replicated (rule)" if rule_name != "shape-fallback" else "replicated (small/1-D)")
        return SpecDecision(path=path, shape=shape, dtype_bytes=dtype_bytes, spec=tuple(entries), rule=rule_name,
                            reason="; ".join(reasons), group=group)

    # -- ZeRO-1 optimizer layout --------------------------------------------
    def zero1_axis(self) -> Optional[str]:
        """The axis an optimizer-state leaf of a replicated parameter shards
        its leading dimension over: fsdp when present, else dp."""
        if self.fsdp > 1:
            return AXIS_FSDP
        if self.dp > 1:
            return AXIS_DP
        return None

    def infer_zero1(self, path: str, shape: Sequence[int], dtype_bytes: int = 4,
                    min_size: Optional[int] = None) -> SpecDecision:
        """Leading-axis ZeRO-1 placement: dimension 0 over ``zero1_axis`` when
        it divides and the leaf is big enough, else replicated."""
        shape = tuple(int(s) for s in shape)
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        floor = self.min_shard_size if min_size is None else int(min_size)
        ax = self.zero1_axis()
        n = self.axis_sizes.get(ax, 1) if ax else 1
        if ax and len(shape) >= 1 and shape[0] % n == 0 and size >= floor:
            return SpecDecision(path=path, shape=shape, dtype_bytes=dtype_bytes,
                                spec=(ax, *([None] * (len(shape) - 1))), rule="zero1",
                                reason=f"leading dim ({shape[0] if shape else 0}) over {ax}={n}", group="opt_state")
        reason = ("no mesh axis to shard over" if ax is None
                  else f"leading dim of {shape} not divisible by {ax}={n}" if shape and shape[0] % n
                  else f"{size} elems under min_size={floor}" if size < floor
                  else "0-d leaf")
        return SpecDecision(path=path, shape=shape, dtype_bytes=dtype_bytes, spec=(None,) * len(shape),
                            rule="zero1", reason=reason, group="opt_state")


# -- leaves: a port tensor named and shaped as the JAX package's leaf ----------
class Leaf(NamedTuple):
    """One tensor as the engine sees it: its flax ``path`` and ``shape``,
    its element size, and ``dims[f]``, the torch dimension of flax
    dimension ``f``."""

    path: str
    shape: Tuple[int, ...]
    dtype_bytes: int
    dims: Tuple[int, ...]


def torch_leaf(module: Any, name: str, tensor: Any, prefix: str = "", shape: Optional[Sequence[int]] = None) -> Leaf:
    """The flax path, flax shape and dimension map of ``module``'s parameter
    ``name`` (a state-dict key): the inverse of ``convert.torch_key`` and
    ``convert.kernel_to_torch``. A Linear's ``weight`` [out, in] is the
    kernel [in, out]; a convolution's (or transposed convolution's) OIHW
    weight is the HWIO kernel; a LayerNorm's ``weight`` is its ``scale``
    under the JAX package's extra ``LayerNorm_0`` level; anything else keeps
    its name and layout. ``shape`` is the tensor's whole torch shape where
    the tensor itself is a shard."""
    from torch import nn

    from ..models.models import EnsembleLayerNorm, LayerNorm

    mod_path, _, leaf = name.rpartition(".")
    owner = module.get_submodule(mod_path) if mod_path else module
    shape = tuple(int(s) for s in (tensor.shape if shape is None else shape))
    dims = tuple(range(len(shape)))
    parts = mod_path.split(".") if mod_path else []
    if isinstance(owner, (nn.LayerNorm, LayerNorm, EnsembleLayerNorm)):
        parts.append("LayerNorm_0")
        leaf = "scale" if leaf == "weight" else leaf
    elif leaf == "weight" and isinstance(owner, nn.Linear):
        leaf, dims = "kernel", (1, 0)
    elif leaf == "weight" and isinstance(owner, (nn.Conv2d, nn.ConvTranspose2d)):
        leaf, dims = "kernel", (2, 3, 1, 0)
    path = "/".join(([prefix] if prefix else []) + parts + [leaf])
    return Leaf(path, tuple(shape[d] for d in dims), int(tensor.element_size()), dims)


def module_leaves(modules: Dict[str, Any]) -> List[Tuple[Leaf, str, str, Any]]:
    """``(leaf, module name, parameter name, parameter)`` of every parameter
    of ``{name: module}``, in the JAX package's tree order (sorted paths)."""
    out = [(torch_leaf(m, n, p, prefix), prefix, n, p) for prefix, m in modules.items()
           for n, p in m.named_parameters()]
    return sorted(out, key=lambda lp: lp[0].path.split("/"))


def adam_prefix(clipped: bool) -> str:
    """Where optax keeps the Adam state in the JAX package's optimizer:
    ``chain(clip_by_global_norm, adam)`` puts it at ``1/0``, a bare
    ``adam`` at ``0``."""
    return "1/0" if clipped else "0"


def adam_leaves(name: str, module: Any, clipped: bool, shape_of: Any = None) -> List[Leaf]:
    """The leaves of one optax Adam state over ``module``'s parameters:
    ``count`` (int32) and a ``mu`` and ``nu`` per parameter, named as the
    JAX package's optimizer-state tree names them. ``shape_of(p)`` gives a
    parameter's whole shape where it holds a shard."""
    pre = f"{name}/{adam_prefix(clipped)}"
    params = [torch_leaf(module, n, p, shape=shape_of(p) if shape_of else None)
              for n, p in module.named_parameters() if p.requires_grad]
    out = [Leaf(f"{pre}/count", (), 4, ())]
    for moment in ("mu", "nu"):
        out += [Leaf(f"{pre}/{moment}/{lf.path}", lf.shape, lf.dtype_bytes, lf.dims) for lf in params]
    return sorted(out, key=lambda lf: lf.path.split("/"))


def infer_tree_specs(engine: SpecEngine, leaves: Sequence[Leaf], group: str = "params", zero1_fallback: bool = False,
                     zero1_min_size: Optional[int] = None) -> ShardingReport:
    """A decision per leaf. With ``zero1_fallback`` (the optimizer-state
    mode) a leaf whose rule-based spec is replicated takes the leading-axis
    ZeRO-1 layout instead."""
    report = ShardingReport(group=group, axis_sizes=engine.axis_sizes)
    for lf in leaves:
        dec = engine.infer(lf.path, lf.shape, lf.dtype_bytes, group=group)
        if zero1_fallback and dec.replicated:
            dec = engine.infer_zero1(lf.path, lf.shape, lf.dtype_bytes, min_size=zero1_min_size)
        report.decisions.append(dec)
    return report


def placements(decision: SpecDecision, leaf: Leaf) -> Dict[str, int]:
    """``{axis: torch dimension}`` for every mesh axis that shards the leaf."""
    out: Dict[str, int] = {}
    for f, entry in enumerate(decision.spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                out[ax] = leaf.dims[f]
    return out
