"""The port's data-parallel mesh (``sheeprl_tpu_torch/parallel/mesh.py``) on
the CPU, against the JAX package's ``Distributed``:

* ``Distributed`` at two devices: the properties, the precision table and
  the mesh shapes of the JAX package's (``resolve_mesh_shape``, its errors);
* what the port refuses, with the JAX package's messages where it raises
  too: mesh shapes that do not multiply out to the devices, more devices
  than there are, an unknown strategy, no node; a config needing a group
  outside a launch; every algorithm is admitted on more ranks and under
  ``fabric.strategy=ddp``; DreamerV3 and the P2E-DV3 phases at fsdp=2,
  tp=2, ZeRO-1 and two nodes (the other entry points as the JAX package
  takes those meshes: tests/test_torch_mesh_sharded.py runs the steps);
* the decoupled admission rule: two devices as in the JAX package, or one
  card with the player on the host; refused otherwise with the JAX message;
* the collectives on two gloo ranks (every one once), a failing rank
  failing the launch, the deadline killing the ranks; at world size 1 under
  ``ddp`` a group that is made, counted and destroyed, the generators
  restored; without a group every collective is the identity; DreamerV3
  under ``ddp`` at world size 1 ends bitwise where the ``auto`` run ends;
* the ranks' log intervals combined (``MetricAggregator.combine``) as one
  aggregator fed every value, and the buffers' env blocks gathered and cut
  back bitwise;
* a loop leaves ``MetricAggregator.disabled`` as it found it, whether it
  returns or raises.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import json
import random

import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.config import Config, compose
from sheeprl_tpu_torch.data.buffers import (EnvIndependentReplayBuffer, ReplayBuffer, SequentialReplayBuffer,
                                            env_block, gather_env_blocks)
from sheeprl_tpu_torch.parallel import mesh
from sheeprl_tpu_torch.utils.metric import MetricAggregator


def _fabric(**kw):
    return Config({"fabric": {"devices": 2, "accelerator": "cpu", **kw}})


def test_distributed_matches_the_jax_packages_at_two_devices():
    from sheeprl_tpu.parallel import Distributed as JaxDistributed
    from sheeprl_tpu.parallel.mesh import get_precision as jax_precision
    from sheeprl_tpu.parallel.sharding import resolve_mesh_shape as jax_resolve

    jd = JaxDistributed(devices=2)
    for rank in (0, 1):
        td = mesh.build_distributed(_fabric(), rank=rank)
        for prop in ("world_size", "dp", "fsdp", "tp", "data_parallel_size", "is_pure_dp"):
            assert getattr(td, prop) == getattr(jd, prop), prop
        assert td.process_index == rank and td.is_global_zero == (rank == 0)
        assert td.device == torch.device("cpu") and not td.collective and td.needs_group
        assert td.local_envs(4) == ((0, 2), (2, 4))[rank]
        assert td.min_shard_size == jd.spec_engine.min_shard_size
    for name in ("32-true", "bf16-mixed", "bf16-true"):
        tp, jp = mesh.get_precision(name), jax_precision(name)
        assert (str(tp.param_dtype).split(".")[-1], str(tp.compute_dtype).split(".")[-1]) == (
            str(jp.param_dtype.dtype if hasattr(jp.param_dtype, "dtype") else jp.param_dtype.__name__),
            str(jp.compute_dtype.dtype if hasattr(jp.compute_dtype, "dtype") else jp.compute_dtype.__name__)), name
    for case in ((8, -1, 1, 1), (8, 2, -1, 1), (8, 2, 2, 2), (6, -1, 3, 1), (1, -1, 1, 1)):
        assert mesh.resolve_mesh_shape(*case) == jax_resolve(*case), case
    for bad in ((8, -1, -1, 1), (8, 3, -1, 1), (8, 2, 2, 1), (8, 0, 1, 1)):
        with pytest.raises(ValueError) as jerr:
            jax_resolve(*bad)
        with pytest.raises(ValueError) as terr:
            mesh.resolve_mesh_shape(*bad)
        assert str(terr.value) == str(jerr.value), bad
    with pytest.raises(ValueError, match="env.num_envs .5. must be divisible by the world size .2."):
        mesh.build_distributed(_fabric()).local_envs(5)
    # the mesh of the JAX package's at four devices, fsdp=2 and tp=2: the tp
    # ranks of a data rank share its env block
    jd = JaxDistributed(devices=4, mesh={"dp": 1, "fsdp": 2, "tp": 2})
    for rank in range(4):
        td = mesh.build_distributed(Config({"fabric": {"devices": 4, "accelerator": "cpu",
                                                       "mesh": {"dp": 1, "fsdp": 2, "tp": 2}}}), rank=rank)
        for prop in ("world_size", "dp", "fsdp", "tp", "data_parallel_size", "is_pure_dp"):
            assert getattr(td, prop) == getattr(jd, prop), prop
        assert td.coordinate == (0, rank // 2, rank % 2) and td.data_rank == rank // 2
        assert td.local_envs(4) == ((0, 2), (2, 4))[rank // 2]
        assert td.spec_engine.data_axes() == jd.spec_engine.data_axes() == ("fsdp",)


@pytest.mark.parametrize("fabric,error,match", [
    ({"mesh": {"dp": 1, "fsdp": 4, "tp": 1}}, ValueError, "dp\\*fsdp\\*tp = 4 but the mesh has 2 devices"),
    ({"mesh": {"dp": 1, "fsdp": 1, "tp": 4}}, ValueError, "dp\\*fsdp\\*tp = 4 but the mesh has 2 devices"),
    ({"mesh": {"dp": -1, "fsdp": 3, "tp": 1}}, ValueError, "not divisible by the fixed axes"),
    ({"num_nodes": 0}, ValueError, "fabric.num_nodes must be >= 1"),
    ({"devices": 100000}, RuntimeError, "Requested 100000 devices but only"),
    ({"strategy": "fsdp"}, ValueError, "Unsupported fabric.strategy"),
])
def test_refusals_name_what_they_wait_for(fabric, error, match):
    """The port raises where the JAX package raises (a mesh that does not
    multiply out to the devices, more devices than it has) with its
    message, and on a strategy or a node count it does not take."""
    from sheeprl_tpu.config import Config as JaxConfig
    from sheeprl_tpu.parallel.mesh import build_distributed as jax_build

    spec = {"devices": 2, "accelerator": "cpu", **fabric}
    with pytest.raises(error, match=match) as terr:
        mesh.build_distributed(Config({"fabric": spec}))
    jax_spec = {**spec, "accelerator": "auto"}
    if "mesh" in fabric:
        with pytest.raises(error) as jerr:
            jax_build(JaxConfig({"fabric": jax_spec}))
        assert str(jerr.value) == str(terr.value)
    elif "devices" in fabric:
        with pytest.raises(error, match=match):
            jax_build(JaxConfig({"fabric": jax_spec}))


ADMITTED = ["a2c", "ppo_recurrent", "droq", "sac_ae", "dreamer_v2", "dreamer_v1", "p2e_dv3_exploration",
            "p2e_dv3_finetuning", "p2e_dv2_exploration", "p2e_dv2_finetuning", "p2e_dv1_exploration",
            "p2e_dv1_finetuning"]


def _exp_args(exp):
    base = [f"exp={exp}", "env=dummy", "fabric.accelerator=cpu"]
    if exp in ("droq", "sac_ae"):
        base.append("env.id=continuous_dummy")
    if exp.endswith("_finetuning"):
        base.append("checkpoint.exploration_ckpt_path=exploration/checkpoint/ckpt_1.ckpt")
    return base


@pytest.mark.parametrize("exp", ADMITTED)
def test_every_algorithm_is_admitted_on_more_ranks(exp, monkeypatch):
    """The algorithms that refused N ranks until the slice that ported them
    to the mesh: the checks admit two devices and ``fabric.strategy=ddp``,
    and the CLI launches the entry point on ``fabric.devices`` ranks through
    ``parallel/mesh.launch``."""
    for extra in (["fabric.devices=2", "env.num_envs=2"], ["fabric.strategy=ddp"]):
        cli.check_configs(compose("config", _exp_args(exp) + extra))
    launched = []
    monkeypatch.setattr(mesh, "launch", lambda fn, cfg: launched.append((fn, cfg.select("fabric.devices"))))
    monkeypatch.setattr(cli, "exploration_surgery", lambda cfg: Config({"algo": {"name": "exploration"}}))
    cli.run_algorithm(compose("config", _exp_args(exp) + ["fabric.devices=2", "env.num_envs=2"]))
    (fn, devices), = launched
    assert (fn.func, fn.args, devices) == (cli._run_registered, (exp,), 2)
    assert (fn.keywords["exploration"] is not None) == exp.endswith("_finetuning")


SHARDED_MESHES = {
    "fsdp2": ["fabric.devices=2", "fabric.mesh.dp=1", "fabric.mesh.fsdp=2"],
    "tp2": ["fabric.devices=2", "fabric.mesh.dp=1", "fabric.mesh.tp=2"],
    "zero1": ["fabric.devices=2", "fabric.shard_optimizer_state=True"],
    "two_nodes": ["fabric.devices=2", "fabric.num_nodes=2"],
}


@pytest.mark.parametrize("mesh_name", list(SHARDED_MESHES))
@pytest.mark.parametrize("exp", ["dreamer_v3", "p2e_dv3_exploration", "p2e_dv3_finetuning"])
def test_dreamer_v3_and_p2e_dv3_take_the_sharded_meshes(exp, mesh_name, monkeypatch):
    """DreamerV3 and the P2E-DV3 phases pass the CLI's checks at fsdp=2,
    tp=2, ZeRO-1 and on two nodes, and launch on that mesh (two nodes: the
    node's two ranks of a world of four)."""
    argv = _exp_args(exp) + ["env.num_envs=4", *SHARDED_MESHES[mesh_name]]
    cfg = compose("config", argv)
    cli.check_configs(cfg)
    d = mesh.build_distributed(cfg)
    assert (d.world_size, d.dp, d.fsdp, d.tp, d.shard_optimizer_state) == {
        "fsdp2": (2, 1, 2, 1, False), "tp2": (2, 1, 1, 2, False), "zero1": (2, 2, 1, 1, True),
        "two_nodes": (4, 4, 1, 1, False)}[mesh_name]
    launched = []
    monkeypatch.setattr(mesh, "launch", lambda fn, cfg: launched.append(cfg.select("fabric")))
    monkeypatch.setattr(cli, "exploration_surgery", lambda cfg: Config({"algo": {"name": "exploration"}}))
    cli.run_algorithm(cfg)
    assert len(launched) == 1 and launched[0].devices == 2


OTHERS = [e for e in ADMITTED if not e.startswith("p2e_dv3")] + ["ppo", "sac"]


@pytest.mark.parametrize("exp", OTHERS)
def test_the_other_entry_points_take_fsdp_as_data_parallelism(exp):
    """The JAX package runs every other entry point at fsdp=2 as data
    parallelism over dp × fsdp with its parameters replicated: so does the
    port (the ranks are its data ranks); tp > 1 and ZeRO-1, which those
    entry points do not lay out, are refused with the reason."""
    base = _exp_args(exp) + ["env.num_envs=4", "fabric.devices=2"]
    cli.check_configs(compose("config", base + ["fabric.mesh.dp=1", "fabric.mesh.fsdp=2"]))
    d = mesh.build_distributed(compose("config", base + ["fabric.mesh.dp=1", "fabric.mesh.fsdp=2"]), rank=1)
    assert (d.data_parallel_size, d.data_rank, d.local_envs(4)) == (2, 1, (2, 4))
    for extra, match in ((["fabric.mesh.dp=1", "fabric.mesh.tp=2"], "fabric.mesh.tp=2"),
                         (["fabric.shard_optimizer_state=True"], "fabric.shard_optimizer_state=True")):
        with pytest.raises(NotImplementedError, match=f"{match}: '{exp}' lays out no parameter"):
            cli.check_configs(compose("config", base + extra))


def test_a_group_is_needed_outside_a_launch():
    with pytest.raises(RuntimeError, match="needs a process group"):
        mesh.current(_fabric())
    with pytest.raises(RuntimeError, match="needs a process group"):
        mesh.current(Config({"fabric": {"devices": 1, "accelerator": "cpu", "strategy": "ddp"}}))
    assert mesh.current(Config({"fabric": {"devices": 1, "accelerator": "cpu"}})).world_size == 1


@pytest.mark.parametrize("exp", ["ppo_decoupled", "sac_decoupled"])
def test_decoupled_admission_rule(exp, monkeypatch):
    """``fabric.devices >= 2`` as in the JAX package, or one card with the
    player on the host; one device otherwise is refused with the JAX
    package's message (the JAX check refuses every one-device case)."""
    from sheeprl_tpu import cli as jax_cli
    from sheeprl_tpu.config import compose as jax_compose

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    base = [f"exp={exp}", "env=dummy"] + (["env.id=continuous_dummy"] if exp == "sac_decoupled" else [])
    cli.check_configs(compose("config", base + ["fabric.devices=2", "fabric.accelerator=cpu"]))
    cli.check_configs(compose("config", base + ["fabric.devices=1", "algo.player.device=host"]))
    jax_cli.check_configs(jax_compose("config", base + ["fabric.devices=2"]))
    for refused in (["fabric.devices=1", "fabric.accelerator=cpu", "algo.player.device=host"],
                    ["fabric.devices=1", "algo.player.device=auto"],
                    ["fabric.devices=1", "algo.player.device=accelerator"]):
        with pytest.raises(RuntimeError) as terr:
            cli.check_configs(compose("config", base + refused))
        with pytest.raises(RuntimeError) as jerr:
            jax_cli.check_configs(jax_compose("config", base + ["fabric.devices=1"]))
        assert str(terr.value) == str(jerr.value)


def test_collectives_on_two_gloo_ranks(tmp_path):
    outs = W.launch_ranks(W.collectives, {}, tmp_path)
    for rank, o in enumerate(outs):
        assert torch.equal(o["mean"], torch.full((3,), 1.5))
        assert torch.equal(o["gathered"], torch.tensor([0.0, 1.0]))
        assert torch.equal(o["broadcast"], torch.tensor([1.0]))
        assert torch.equal(o["scattered"], torch.tensor([10.0 * (rank + 1)]))
        assert o["objects"] == [{"rank": 0}, {"rank": 1}] and o["any"] is True and o["backend"] == "gloo"
        assert o["stats"]["all_reduce"] == 1 and o["stats"]["all_reduce_bytes"] == 12
        assert o["stats"]["all_gather"] == 1 and o["stats"]["broadcast"] == 1 and o["stats"]["scatter"] == 1
    assert not torch.distributed.is_initialized()  # the parent makes no group


def test_a_failing_rank_fails_the_launch_and_the_deadline_kills_the_ranks(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        W.launch_ranks(W.fail_on_rank_1, {}, tmp_path / "fail")
    with pytest.raises(TimeoutError, match="did not finish within 3"):
        W.launch_ranks(W.sleep_long, {}, tmp_path / "hang", deadline_s=3)
    assert not any(p.name.startswith("sheeprl_rdv_") for p in (tmp_path / "fail" / "rdv").iterdir())


def test_world_size_one_collectives():
    """Under ``auto`` no group and every collective the identity; under
    ``ddp`` a gloo group of one, whose all-reduce (a division by one) leaves
    the values bitwise, counted; both leave no group, the run's
    ``Distributed`` and the generators as they were."""
    plain = mesh.build_distributed(Config({"fabric": {"devices": 1, "accelerator": "cpu"}}))
    x = torch.randn(5)
    y = x.clone()
    with plain.running():
        assert mesh.active() is plain and not plain.collective
        plain.all_reduce_mean([y])
        assert plain.all_gather(y) is y and plain.broadcast_object(3) == 3
    assert torch.equal(x, y) and sum(plain.stats.values()) == 0
    ddp = mesh.build_distributed(Config({"fabric": {"devices": 1, "accelerator": "cpu", "strategy": "ddp"}}))
    random.seed(1)
    torch.manual_seed(1)
    before = (random.random(), torch.rand(1))
    random.seed(1)
    torch.manual_seed(1)
    with ddp.running():
        assert torch.distributed.is_initialized() and ddp.backend == "gloo"
        ddp.seed_everything(123)
        ddp.all_reduce_mean([y])
        assert torch.equal(torch.cat([ddp.all_gather(y)]), x)
    assert torch.equal(x, y) and ddp.stats["all_reduce"] == 1 and ddp.stats["all_gather"] == 1
    assert not torch.distributed.is_initialized() and mesh.active() is None
    assert (random.random(), torch.rand(1)) == before


def test_ranks_log_intervals_combine_as_one_aggregator():
    kinds = {"a": "mean", "b": "sum", "c": "max", "d": "min", "e": "last"}
    rng = np.random.default_rng(0)
    ranks = [MetricAggregator(kinds) for _ in range(3)]
    whole = MetricAggregator(kinds)
    lasts = []
    for agg in ranks:
        for _ in range(4):
            v = rng.standard_normal(3)
            for k in kinds:
                agg.update(k, v)
                if k != "e":
                    whole.update(k, v)
        lasts.append(float(np.mean(v)))
    ranks[0].combine([r.states() for r in ranks])
    got, want = ranks[0].compute(), whole.compute()
    for k in ("a", "b", "c", "d"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert got["e"] == pytest.approx(np.mean(lasts), rel=1e-12)


def _filled(cls, n_envs: int, seed: int, steps: int = 5):
    rng = np.random.default_rng(seed)
    if cls is ReplayBuffer:
        rb = ReplayBuffer(8, n_envs, seed=seed)
    else:
        rb = EnvIndependentReplayBuffer(8, n_envs=n_envs, buffer_cls=SequentialReplayBuffer, seed=seed)
    for _ in range(steps):
        rb.add({"obs": rng.standard_normal((1, n_envs, 3)).astype(np.float32),
                "rewards": rng.standard_normal((1, n_envs, 1)).astype(np.float32)})
    return rb


@pytest.mark.parametrize("cls", [ReplayBuffer, EnvIndependentReplayBuffer])
def test_env_blocks_gather_and_cut_back(cls):
    """Each rank's buffer over its env block: gathered to one state over all
    envs (the JAX package's single buffer's layout), cut back to each rank's
    block and generator, bitwise."""
    blocks = [_filled(cls, 2, 10 + d) for d in range(2)]
    whole = gather_env_blocks([b.checkpoint_state_dict() for b in blocks])
    if cls is ReplayBuffer:
        assert whole["buffer"]["obs"].shape == (5, 4, 3)
        np.testing.assert_array_equal(whole["buffer"]["obs"][:, 2:], blocks[1]["obs"][:5])
    else:
        assert len(whole["buffers"]) == 4
    for d, b in enumerate(blocks):
        back = (ReplayBuffer(8, 2, seed=0) if cls is ReplayBuffer else
                EnvIndependentReplayBuffer(8, n_envs=2, buffer_cls=SequentialReplayBuffer, seed=0))
        back.load_state_dict(env_block(whole, d, 2))
        a, c = back.sample(4, **({} if cls is ReplayBuffer else {"sequence_length": 2})), \
            b.sample(4, **({} if cls is ReplayBuffer else {"sequence_length": 2}))
        for k in a:
            np.testing.assert_array_equal(a[k], c[k])
    assert gather_env_blocks([blocks[0].checkpoint_state_dict()]).keys() == blocks[0].checkpoint_state_dict().keys()


def test_a_loop_restores_the_aggregator_switch(tmp_path, monkeypatch):
    """An in-process PPO run with ``metric.log_level=0`` switches the
    aggregator off for its run and back on after it; a run that raises
    after switching it (a minibatch that does not divide the rollout) puts
    it back too; the other way round a run leaves it off."""
    monkeypatch.chdir(tmp_path)
    args = ["exp=ppo", "env=dummy", "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=8",
            "algo.per_rank_batch_size=8", "algo.total_steps=16", "algo.run_test=False", "buffer.memmap=False"]
    prior = MetricAggregator.disabled
    try:
        MetricAggregator.disabled = False
        cli.run(args + ["metric.log_level=0"])
        assert MetricAggregator.disabled is False
        with pytest.raises(ValueError, match="must be divisible"):
            cli.run(args + ["metric.log_level=0", "algo.per_rank_batch_size=7"])
        assert MetricAggregator.disabled is False
        MetricAggregator.disabled = True
        cli.run(args + ["metric.log_level=1"])
        assert MetricAggregator.disabled is True
    finally:
        MetricAggregator.disabled = prior


def test_dreamer_v3_under_ddp_at_world_size_one_is_bitwise_the_auto_run(tmp_path, monkeypatch):
    """``fabric.strategy=ddp`` on one device: a gloo group of one, every
    optimizer step's all-reduce and every Moments all-gather run and are
    counted, and the run ends bitwise where the same run without a group
    (``auto``) ends: a division by one is exact (chip_smoke.py's phase mesh
    holds the same on the card over NCCL)."""
    from test_torch_mesh_loops import TINY_DV3

    monkeypatch.chdir(tmp_path)
    args = TINY_DV3 + ["fabric.accelerator=cpu", "env.num_envs=2", "buffer.size=64", "algo.learning_starts=8",
                       "algo.total_steps=20", "algo.overlap.enabled=False", "buffer.memmap=False",
                       "algo.run_test=False", "metric.log_every=4"]
    ends, logs = {}, {}
    for strategy in ("ddp", "auto"):
        cli.run(args + [f"fabric.strategy={strategy}", f"run_name={strategy}"])
        run = next(tmp_path.glob(f"logs/runs/dreamer_v3/*/{strategy}/version_0"))
        ends[strategy] = torch.load(max((run / "checkpoint").glob("*.ckpt"), key=lambda p: int(p.stem[5:])),
                                    weights_only=False)
        logs[strategy] = [json.loads(l) for l in open(run / "telemetry.jsonl")]
    assert not torch.distributed.is_initialized()
    grads = ends["ddp"]["opt_states"]["step"]
    assert grads > 0 and logs["ddp"][0]["backend"] == "gloo" and logs["auto"][0]["backend"] == "none"
    coll = [e for e in logs["ddp"] if e["event"] == "log"][-1]["collectives"]
    assert coll["all_reduce"] == 3 * grads and coll["all_gather"] == grads
    assert all("collectives" not in e for e in logs["auto"] if e["event"] == "log")
    for key in ("wm", "actor", "critic", "target_critic"):
        for name, v in ends["ddp"][key].items():
            assert torch.equal(v, ends["auto"][key][name]), (key, name)
    for key in ("wm", "actor", "critic"):
        for idx, st in ends["ddp"]["opt_states"][key]["state"].items():
            for m, v in st.items():
                assert torch.equal(v, ends["auto"]["opt_states"][key]["state"][idx][m]), (key, idx, m)
    assert ends["ddp"]["moments"]["low"] == ends["auto"]["moments"]["low"]
    assert ends["ddp"]["ratio"] == ends["auto"]["ratio"]


def test_a_multi_axis_mesh_keeps_the_ring_host_staged_with_the_jax_message(monkeypatch, capsys):
    """On fsdp/tp > 1 the sequential feed stays host-staged with the JAX
    package's line (sheeprl_tpu/data/device_ring.py), and a forced
    ``buffer.device_cache=true`` raises it; a pure-dp mesh keeps the ring."""
    from sheeprl_tpu_torch.data import device_ring

    rb = EnvIndependentReplayBuffer(16, n_envs=1, obs_keys=("state",), buffer_cls=SequentialReplayBuffer)
    msg = "sharded device ring is pure-dp only (mesh is dp=1 fsdp=2 tp=2); multi-axis meshes stay host-staged"
    sharded = mesh.build_distributed(Config({"fabric": {"devices": 4, "accelerator": "cpu",
                                                        "mesh": {"dp": 1, "fsdp": 2, "tp": 2}}}))
    monkeypatch.setattr(mesh, "active", lambda: sharded)
    with pytest.raises(ValueError, match=msg.replace("(", r"\(").replace(")", r"\)")):
        device_ring.make_sequential_prefetcher(Config({"buffer": {"device_cache": True}}), torch.device("cpu"), rb, 2,
                                               2)
    monkeypatch.setattr(device_ring, "_use_ring", lambda *a: True)  # as auto would on a card
    pf = device_ring.make_sequential_prefetcher(Config({"buffer": {"device_cache": "auto"}}), torch.device("cpu"), rb,
                                                2, 2)
    assert type(pf).__name__ == "StagedPrefetcher"
    assert f"[device_ring] {msg}; falling back to host-staged batches" in capsys.readouterr().err
    monkeypatch.setattr(mesh, "active", lambda: mesh.build_distributed(_fabric()))  # (dp=2, 1, 1)
    pf = device_ring.make_sequential_prefetcher(Config({"buffer": {"device_cache": "auto"}}), torch.device("cpu"), rb,
                                                2, 2)
    assert type(pf).__name__ == "DeviceRingPrefetcher"
