"""The port's rule engine (``sheeprl_tpu_torch/parallel/sharding.py``) against
the JAX package's (``sheeprl_tpu/parallel/sharding.py``), in this process:

* the port's tiny DreamerV3 (``TINY_DV3``'s parameters converted into the
  port's modules) named and shaped as flax leaves reproduces
  ``tests/test_data/golden_sharding_dv3_2x2x2.json`` exactly, leaves and
  summary;
* the optimizer-state report under ``zero1_fallback`` equals the JAX
  package's ``infer_tree_specs`` over the JAX optimizer state, decision for
  decision, on several meshes;
* the unit cases of ``tests/test_sharding.py`` (mesh shapes, divisibility
  fallbacks, small leaves, ZeRO-1 on the fsdp axis, moments following their
  parameters, the pure-dp compat layout) give the JAX engine's decisions;
* a leaf's dimension map cuts a port tensor where the JAX package cuts the
  flax kernel it was converted from.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sheeprl_tpu.parallel import sharding as jsh
from sheeprl_tpu_torch import convert
from sheeprl_tpu_torch.parallel import sharding as tsh

GOLDEN = Path(__file__).resolve().parent / "test_data" / "golden_sharding_dv3_2x2x2.json"
MESHES = [{"dp": 2, "fsdp": 2, "tp": 2}, {"dp": 4, "fsdp": 1, "tp": 1}, {"dp": 1, "fsdp": 4, "tp": 1},
          {"dp": 1, "fsdp": 2, "tp": 2}]


@pytest.fixture(scope="module")
def tiny():
    """The JAX package's tiny DreamerV3 (parameters and optimizer state) and
    the port's, converted from it."""
    from test_torch_dreamer_v3 import _numpy_tree, torch_trainer
    from torch_mesh_parity import tiny_dv3_trainer

    _, params, opt_states, _, _ = tiny_dv3_trainer()
    _, (wm, actor, critic, target), opts, _ = torch_trainer()
    convert.load_dreamer_v3(_numpy_tree(params), wm, actor, critic, target, _numpy_tree(opt_states), opts)
    return params, opt_states, {"wm": wm, "actor": actor, "critic": critic, "target_critic": target}


def _rows(decisions, axis_sizes):
    return [(d.path, tuple(d.shape), tsh.spec_str(d.spec) if isinstance(d, tsh.SpecDecision) else jsh.spec_str(d.spec),
             d.rule, d.reason, d.bytes_per_chip(axis_sizes)) for d in decisions]


def test_golden_specs_from_the_ports_tiny_dreamer_v3(tiny):
    golden = json.loads(GOLDEN.read_text())
    engine = tsh.SpecEngine(golden["mesh"])
    rep = tsh.infer_tree_specs(engine, [lf for lf, *_ in tsh.module_leaves(tiny[2])])
    got = {d.path: {"shape": list(d.shape), "spec": tsh.spec_str(d.spec), "rule": d.rule,
                    "bytes_per_chip": d.bytes_per_chip(rep.axis_sizes)} for d in rep.decisions}
    assert got == golden["leaves"]
    assert rep.summary() == golden["summary"]
    assert rep.bytes_per_chip < rep.total_bytes
    events = rep.events()
    assert len(events) == len(golden["leaves"]) + 1 and events[-1]["action"] == "summary"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(str(v) for v in m.values()))
@pytest.mark.parametrize("min_size", [2**14, 64])
def test_optimizer_state_report_equals_the_jax_packages(tiny, mesh, min_size):
    params, opt_states, modules = tiny
    _, jrep = jsh.infer_tree_specs(jsh.SpecEngine(mesh, min_shard_size=min_size), opt_states, group="opt_state",
                                   zero1_fallback=True, zero1_min_size=min_size)
    leaves = [tsh.Leaf("step", (), 4, ())]
    for name in ("actor", "critic", "wm"):
        leaves += tsh.adam_leaves(name, modules[name], clipped=True)
    leaves.sort(key=lambda lf: lf.path.split("/"))
    trep = tsh.infer_tree_specs(tsh.SpecEngine(mesh, min_shard_size=min_size), leaves, group="opt_state",
                                zero1_fallback=True, zero1_min_size=min_size)
    assert _rows(trep.decisions, mesh) == _rows(jrep.decisions, mesh)
    assert trep.summary() == jrep.summary()
    assert [{k: v for k, v in e.items()} for e in trep.events()] == jrep.events()


# the meshes DreamerV3's parameters are laid out on in tests/test_torch_mesh_sharded.py
# (min_shard_size 64 where fsdp·tp > 1, so that fsdp shards the tiny model)
PARAM_MESHES = [({"dp": 1, "fsdp": 2, "tp": 2}, False), ({"dp": 2, "fsdp": 1, "tp": 2}, False),
                ({"dp": 2, "fsdp": 2, "tp": 1}, False), ({"dp": 1, "fsdp": 4, "tp": 1}, False),
                ({"dp": 4, "fsdp": 1, "tp": 1}, True)]


@pytest.mark.parametrize("mesh,zero1", PARAM_MESHES,
                         ids=["x".join(str(v) for v in m.values()) + ("-zero1" if z else "") for m, z in PARAM_MESHES])
def test_params_report_equals_the_jax_packages_shard_params(tiny, mesh, zero1):
    """The ``params`` report ``maybe_shard_params`` records for the port's
    DreamerV3 equals the report of the JAX package's ``shard_params`` for the
    same tree (``infer_tree_specs`` over the parameters): paths, specs, rules,
    reasons and bytes per chip, leaf for leaf, and the summary. On every mesh
    with fsdp·tp > 1 it shards, so a rank holds less than the whole."""
    from sheeprl_tpu_torch.parallel import mesh as tmesh

    params, _, modules = tiny
    min_size = 64 if mesh["fsdp"] * mesh["tp"] > 1 else jsh.DEFAULT_MIN_SHARD_SIZE
    _, jrep = jsh.infer_tree_specs(jsh.SpecEngine(mesh, min_shard_size=min_size), params, group="params")
    dist = tmesh.Distributed(devices=4, accelerator="cpu", mesh={**mesh, "min_shard_size": min_size},
                             shard_optimizer_state=zero1)
    if zero1:  # a pure-dp mesh: recorded, and nothing laid out
        layout = tmesh.maybe_shard_params(None, dist, modules)
        trep, = dist.take_sharding_reports()
        assert layout.sharded == []
    else:
        trep = tmesh.params_report(dist, modules)
        assert tmesh.params_sharded(dist, modules)
        assert trep.bytes_per_chip < trep.total_bytes
    assert _rows(trep.decisions, mesh) == _rows(jrep.decisions, mesh)
    assert trep.summary() == jrep.summary()
    assert trep.events() == jrep.events()


# (engine axis sizes, engine min_shard_size, method, args): the inputs of
# tests/test_sharding.py's unit cases
UNIT_CASES = [
    ({"dp": 8, "fsdp": 1, "tp": 1}, 2**14, "infer", ("dense_0/kernel", (256, 512))),
    ({"dp": 2, "fsdp": 2, "tp": 2}, 64, "infer", ("mlp/dense_0/kernel", (128, 255))),
    ({"dp": 2, "fsdp": 2, "tp": 2}, 64, "infer", ("mlp/dense_0/kernel", (127, 255))),
    ({"dp": 2, "fsdp": 2, "tp": 2}, 64, "infer", ("bias_like", (1023,))),
    ({"dp": 2, "fsdp": 2, "tp": 2}, 64, "infer", ("scalar", ())),
    ({"dp": 2, "fsdp": 2, "tp": 2}, 64, "infer", ("some/unknown_table", (4096, 33))),
    ({"dp": 2, "fsdp": 4, "tp": 1}, 2**14, "infer", ("tiny/unknown", (16, 16))),
    ({"dp": 2, "fsdp": 4, "tp": 1}, 2**14, "tree_zero1", ("m", (1024, 64))),
    ({"dp": 2, "fsdp": 4, "tp": 1}, 2**14, "tree_zero1", ("v", (65536,))),
    ({"dp": 2, "fsdp": 4, "tp": 1}, 2**14, "tree_zero1", ("small", (4, 4))),
    ({"dp": 2, "fsdp": 2, "tp": 2}, 2**14, "tree_zero1", ("mu/dense_0/kernel", (128, 256))),
    ({"dp": 2, "fsdp": 2, "tp": 2}, 2**14, "infer", ("dense_0/kernel", (128, 256))),
    ({"dp": 8, "fsdp": 1, "tp": 1}, 2**14, "tree_zero1", ("big", (1024, 64))),
    ({"dp": 8, "fsdp": 1, "tp": 1}, 2**14, "tree_zero1", ("odd", (1023, 64))),
    ({"dp": 8, "fsdp": 1, "tp": 1}, 2**14, "tree_zero1", ("small", (8, 4))),
    ({"dp": 8, "fsdp": 1, "tp": 1}, 2**14, "tree_zero1", ("scalar", ())),
    ({"dp": 1, "fsdp": 1, "tp": 1}, 2**14, "tree_zero1", ("big", (1024, 64))),
    ({"dp": 2, "fsdp": 2, "tp": 2}, 2**14, "infer", ("wm/rssm/recurrent_model/gru/fused/kernel", (1536, 1536))),
    ({"dp": 1, "fsdp": 2, "tp": 2}, 64, "infer", ("wm/observation_model/DV3CNNDecoder_0/to_obs/kernel", (4, 4, 3, 2))),
    ({"dp": 1, "fsdp": 2, "tp": 2}, 64, "infer", ("wm/encoder/DV3CNNEncoder_0/conv_3/kernel", (4, 4, 8, 16))),
    ({"dp": 1, "fsdp": 4, "tp": 1}, 64, "batch_spec", (2,)),
    ({"dp": 2, "fsdp": 2, "tp": 2}, 64, "batch_spec", (0,)),
    ({"dp": 8, "fsdp": 1, "tp": 1}, 64, "batch_spec", (2,)),
    ({"dp": 1, "fsdp": 1, "tp": 8}, 64, "batch_spec", (1,)),
]


def _decide(pkg, axis_sizes, min_size, method, args):
    engine = pkg.SpecEngine(axis_sizes, min_shard_size=min_size)
    if method == "batch_spec":
        return pkg.spec_str(tuple(engine.batch_spec(*args))), engine.data_axes(), engine.zero1_axis()
    if method == "tree_zero1":  # one leaf through infer_tree_specs' optimizer-state mode
        path, shape = args
        dec = engine.infer(path, shape, 4, group="opt_state")
        if dec.replicated:
            dec = engine.infer_zero1(path, shape, 4)
    else:
        dec = engine.infer(*args)
    return dec.path, tuple(dec.shape), pkg.spec_str(dec.spec), dec.rule, dec.reason, dec.bytes_per_chip(axis_sizes)


@pytest.mark.parametrize("case", UNIT_CASES, ids=[f"{c[2]}-{c[3][0]}-{i}" for i, c in enumerate(UNIT_CASES)])
def test_unit_cases_decide_as_the_jax_engine(case):
    assert _decide(tsh, *case) == _decide(jsh, *case)


@pytest.mark.parametrize("args", [(8,), (8, -1, 2), (8, 2, -1, 2), (8, 1, 1, 8), (8, -1, -1), (8, -1, 3),
                                  (8, 2, 2, 1), (8, 0), (6, -1, 1, 3)])
def test_mesh_shapes_resolve_as_the_jax_packages(args):
    def outcome(fn):
        try:
            return fn(*args)
        except ValueError as err:
            return str(err)

    assert outcome(tsh.resolve_mesh_shape) == outcome(jsh.resolve_mesh_shape)


@pytest.mark.parametrize("kind", ["linear", "conv", "deconv"])
def test_a_leafs_dimension_map_cuts_where_the_flax_kernel_is_cut(kind):
    """Cutting flax dimension f of a kernel and converting it gives the
    port's weight cut along ``dims[f]``."""
    from torch import nn

    mod = {"linear": nn.Linear(6, 8, bias=False), "conv": nn.Conv2d(4, 6, 3, bias=False),
           "deconv": nn.ConvTranspose2d(4, 6, 3, bias=False)}[kind]
    parent = nn.Module()
    parent.add_module("fc" if kind == "linear" else "conv_0", mod)
    name = ("fc" if kind == "linear" else "conv_0") + ".weight"
    leaf = tsh.torch_leaf(parent, name, mod.weight, "wm")
    assert leaf.path == "wm/" + name.replace(".weight", "/kernel")
    kernel = np.random.default_rng(0).standard_normal(leaf.shape).astype(np.float32)
    weight = torch.from_numpy(np.ascontiguousarray(convert.kernel_to_torch(kernel, mod)))
    assert tuple(weight.shape) == tuple(mod.weight.shape)
    for f, n in enumerate(leaf.shape):
        if n % 2:
            continue
        half = np.take(kernel, np.arange(n // 2, n), axis=f)
        want = torch.from_numpy(np.ascontiguousarray(convert.kernel_to_torch(half, mod)))
        torch.testing.assert_close(weight.narrow(leaf.dims[f], n // 2, n // 2), want, rtol=0, atol=0)
