"""DreamerV3 on the sharded mesh: one launch of four gloo ranks
(``torch_mesh_worker.dv3_sharded_steps``) takes one train step on each
case's ``(dp, fsdp, tp)`` mesh, laid out as ``dreamer_v3.main`` lays it out
(``maybe_shard_params``, ``maybe_shard_opt_state``), and the unsharded dp=4
step, while this process takes the JAX package's step on each of
``(1,2,2)``, ``(2,1,2)``, ``(2,2,1)``, ``(1,4,1)`` and ``(4,1,1)`` with ZeRO-1 from the
same converted parameters, the same global batch and the JAX step's own
draws: ``dreamer_tiny.make_trainer(devices=4, mesh=...)``'s step, its train
function built once (``build_agent`` uses the mesh only to replicate the
parameters, which each case replicates on its own mesh) and the batch
sharded over each mesh's data axes. The JAX step's parameters stay
replicated (``make_trainer`` places none): with them tp-sharded, its step
on a tp mesh leaves its step on every dp mesh by 1.1e-4 of the state loss,
whose dp result the port's tp steps reproduce (ROADMAP Queue 3 item 16);
the layouts themselves are held against the JAX package's in
tests/test_torch_sharding.py.

Decoupled on the LN-GRU sequence (``pallas_gru=True``: the plain versions
here, which take the whole fused weight, gathered for the call; the JAX
package's interpret-mode Pallas kernels), ``algo.dense_units=128`` so that
the heads' moments are big enough for ZeRO-1's floor (2**14 elements), and
the engine's ``min_shard_size`` 64 on the fsdp and tp meshes so that fsdp
shards the tiny model. Tolerances as tests/test_torch_dreamer_v3.py.
Besides:

* at rest after the step each rank holds its shard of every parameter the
  ``params`` report does not replicate and of its gradient: parameter bytes
  equal the report's ``bytes_per_chip`` (below ``total_bytes`` where
  fsdp·tp > 1), gradient bytes the same over the leaves that have one (all
  but the target critic's); its Adam moments take exactly the
  optimizer-state report's ``bytes_per_chip``;
* on (1,4,1) and (2,2,1), whose data ranks are dp=4's, each rank's peak
  over the burst is below the unsharded dp=4 step's by at least twice the
  bytes the parameters' layout saves at rest less twice the largest unit's
  whole parameters (the one a rank gathers at a time); the mirror's refresh
  is measured apart and fills the whole copies from the shards;
* ZeRO-1 at dp=4 (a pure-dp mesh: no parameter is laid out) is bitwise the
  unsharded dp=4 step; the sharded meshes' steps (each module's whole
  weights gathered, the sharded gradients averaged in the backward, one
  module at a time, the replicated ones in the step) agree with it to float
  rounding: for (2,2,1) the sums' order is the only difference
  (``tests/torch_dv3_fsdp_f64.py`` runs both sides in float64);
* with every optimizer's clip at 1e-3 (all of them clip), (1,2,2) and
  (2,2,1) agree with the clipped dp=4 step as above: the clip takes the
  norm of the whole averaged gradient, summed from the shards, not of a
  rank's shards;
* the state after the (1,2,2) step, written whole by rank 0, resumes at
  (4,1,1) with ZeRO-1 and gathers back to the same tensors;
* a CLI run at ``fabric.devices=4 fabric.mesh.fsdp=2 fabric.mesh.tp=2``
  trains, its stream passes both validators and its checkpoint is whole.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import glob
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from sheeprl_tpu_torch import convert
from test_torch_mesh_dv3 import PARAM_ATOL_DV3, _dv3_noise
from test_torch_mesh_steps import METRIC_RTOL, MOMENT_RTOL, _close_adam, _close_state

NAMES = ("wm", "actor", "critic", "target_critic")
WIDE = ["algo.world_model.decoupled_rssm=True", "algo.dense_units=128"]
CLIP = 1e-3


def _mesh(dp, fsdp, tp):
    return {"dp": dp, "fsdp": fsdp, "tp": tp, **({"min_shard_size": 64} if fsdp * tp > 1 else {})}


# the cases held to the JAX package's step, then the port's own: the clipped
# steps and the dp=4 steps the others are held to
JAX_CASES = [{"mesh": _mesh(1, 2, 2)}, {"mesh": _mesh(2, 1, 2)}, {"mesh": _mesh(2, 2, 1)},
             {"mesh": _mesh(1, 4, 1)}, {"mesh": _mesh(4, 1, 1), "zero1": True}]
TP, FSDP, ZERO1 = (0, 1), (2, 3), 4
CASES = JAX_CASES + [{"mesh": _mesh(1, 2, 2), "clip": CLIP}, {"mesh": _mesh(2, 2, 1), "clip": CLIP},
                     {"mesh": _mesh(4, 1, 1), "clip": CLIP}, {"mesh": _mesh(4, 1, 1)},
                     {"mesh": _mesh(2, 2, 1), "precision": "bf16-mixed"}, {"mesh": _mesh(4, 1, 1), "precision": "bf16-mixed"}]
CLIPPED_TP, CLIPPED_DP, CLIPPED_DP4, DP4, BF16_DP, BF16_DP4 = 5, 6, 7, 8, 9, 10


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' outputs (one list a rank, a record a case, the resumed
    state last) and the JAX package's step on each of ``JAX_CASES``."""
    from dreamer_tiny import N_ACT
    from sheeprl_tpu.parallel import Distributed
    from test_torch_dreamer_v3 import XLA, _numpy_tree, condition_two_hot_heads, torch_trainer
    from torch_mesh_parity import tiny_dv3_trainer

    tmp_path = tmp_path_factory.mktemp("sharded")
    train, params, opt_states, moments, _ = tiny_dv3_trainer(XLA + WIDE + ["algo.world_model.pallas_gru=interpret"],
                                                             devices=4, mesh=JAX_CASES[0]["mesh"])
    params0 = condition_two_hot_heads(_numpy_tree(params))
    opt0, moments0 = _numpy_tree(opt_states), _numpy_tree(moments)
    T, B = 4, 4  # one column a data rank at dp=4
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.integers(0, 255, (1, T, B, 64, 64, 3), np.uint8),
             "actions": np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, (1, T, B))],
             "rewards": rng.standard_normal((1, T, B, 1)).astype(np.float32),
             "terminated": np.zeros((1, T, B, 1), np.float32), "truncated": np.zeros((1, T, B, 1), np.float32),
             "is_first": np.zeros((1, T, B, 1), np.float32)}
    keys = jax.random.split(jax.random.key(7), 1)

    tover = WIDE + ["algo.world_model.pallas_gru=True"]
    cfg, (wm, actor, critic, target), opts, _ = torch_trainer(tover)
    convert.load_dreamer_v3(params0, wm, actor, critic, target, opt0, opts)
    payload = {"cfg": cfg.to_dict(), "actions_dim": [N_ACT], "batch": batch, "dir": str(tmp_path),
               "modules": dict(zip(NAMES, (wm, actor, critic, target))),
               "opt_states": {k: getattr(opts, k).optimizer.state_dict() for k in ("wm", "actor", "critic")},
               "noise": [_dv3_noise(keys[0], cfg, T, B, N_ACT)], "cases": CASES,
               "resume": {"from": 0, "mesh": _mesh(4, 1, 1), "zero1": True}}
    # the four ranks work while this process takes the JAX package's steps
    ranks: dict = {}

    def launch():
        try:
            ranks["outs"] = W.launch_ranks(W.dv3_sharded_steps, payload, tmp_path, world=4)
        except BaseException as err:  # re-raised below, in the test's thread
            ranks["error"] = err

    def jax_step(case):
        jdist = Distributed(devices=4, mesh=case["mesh"])
        placed = jdist.replicate(jax.tree.map(jnp.asarray, (params0, opt0, moments0)))
        sharded = {k: jax.device_put(jnp.asarray(v), jdist.shard_batch_axis(2)) for k, v in batch.items()}
        return jax.tree.map(np.asarray, jax.block_until_ready(train(*placed, sharded, keys)))

    thread = threading.Thread(target=launch)
    thread.start()
    refs = [jax_step(case) for case in JAX_CASES]
    thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return ranks["outs"], refs, tover


def _check_against_jax(outs, refs, tover, i):
    from test_torch_dreamer_v3 import _numpy_tree, torch_trainer

    case, (j_params, j_opt, j_moments, j_metrics) = CASES[i], refs[i]
    mesh = case["mesh"]
    data = [o[i] for o in outs if o[i]["coordinate"][2] == 0]  # one rank of each tp group
    assert len(data) == mesh["dp"] * mesh["fsdp"]
    for o in outs:  # every rank ends with the same whole state
        for k in NAMES:
            for n, t in outs[0][i]["state"][k].items():
                assert torch.equal(o[i]["state"][k][n], t), (case, k, n)
    _, (ewm, eactor, ecritic, etarget), eopts, _ = torch_trainer(tover)
    convert.load_dreamer_v3(_numpy_tree(j_params), ewm, eactor, ecritic, etarget, _numpy_tree(j_opt), eopts)
    for k in j_metrics:
        got = np.mean([o["metrics"][k] for o in data])
        assert got == pytest.approx(float(np.asarray(j_metrics[k])[0]), rel=METRIC_RTOL), (case, k)
    for name, m in zip(NAMES, (ewm, eactor, ecritic, etarget)):
        _close_state(outs[0][i]["state"][name], m.state_dict(), PARAM_ATOL_DV3, name)
    for name in ("wm", "actor", "critic"):
        _close_adam(outs[0][i]["opt_states"][name], getattr(eopts, name).optimizer.state_dict(), MOMENT_RTOL, name)
    np.testing.assert_allclose(outs[0][i]["moments"], [float(j_moments.low), float(j_moments.high)],
                               rtol=METRIC_RTOL)

    # the memory each rank holds at rest is the reports': its shards of the
    # parameters and their gradients, its slices of the moments
    summaries = outs[0][i]["summaries"]
    assert set(summaries) == {"params", "opt_state"}
    for o in outs:
        assert o[i]["param_bytes"] == summaries["params"]["bytes_per_chip"], case
        assert o[i]["grad_bytes"] == o[i]["grad_leaf_bytes"], case
        assert o[i]["moments_bytes"] == o[i]["moment_leaf_bytes"], case
    params = summaries["params"]
    if mesh["fsdp"] * mesh["tp"] > 1:
        assert params["bytes_per_chip"] < params["total_bytes"], case
    else:
        assert params["bytes_per_chip"] == params["total_bytes"], case
    assert summaries["opt_state"]["bytes_per_chip"] < summaries["opt_state"]["total_bytes"], case


def _same(a, b, what):
    for k in NAMES:
        for n, t in b["state"][k].items():
            assert torch.equal(a["state"][k][n], t), (what, k, n)
    for k in ("wm", "actor", "critic"):
        for pi, st in b["opt_states"][k]["state"].items():
            for sk, v in st.items():
                assert torch.equal(a["opt_states"][k]["state"][pi][sk], v), (what, k, pi, sk)


def test_dreamer_v3_on_the_tp_meshes_matches_jax_and_resumes_at_another_mesh(run):
    """(1,2,2) and (2,1,2) against the JAX package's step and to rounding the
    dp=4 step; the (1,2,2) state laid out again at (4,1,1) with ZeRO-1."""
    outs, refs, tover = run
    base = outs[0][DP4]
    assert base["summaries"] == {}
    for i in TP:
        _check_against_jax(outs, refs, tover, i)
        for k in NAMES:
            _close_state(outs[0][i]["state"][k], base["state"][k], 1e-7, k)
    _same(outs[0][len(CASES)], outs[0][0], "resumed at (4,1,1)")


def test_dreamer_v3_on_the_fsdp_and_zero1_meshes_matches_jax_bitwise_the_dp_step(run):
    """(2,2,1), (1,4,1) and (4,1,1) with ZeRO-1 against the JAX package's
    step; ZeRO-1 bit for bit the unsharded dp=4 step, the parameter-sharded
    meshes (their data ranks are dp=4's, their sums in another order) to
    rounding, at the tp meshes' tolerance."""
    outs, refs, tover = run
    base = outs[0][DP4]
    for i in (*FSDP, ZERO1):
        _check_against_jax(outs, refs, tover, i)
        assert base["param_bytes"] == outs[0][i]["summaries"]["params"]["total_bytes"]
    _same(outs[0][ZERO1], base, CASES[ZERO1])
    for i in FSDP:
        for k in NAMES:
            _close_state(outs[0][i]["state"][k], base["state"][k], 1e-7, k)


def test_the_global_norm_clip_takes_the_whole_gradients_norm(run):
    """Every optimizer clipped at 1e-3: the sharded steps clip by the norm of
    the whole averaged gradient, as the dp=4 step does (a shard's own norm
    would scale each shard apart)."""
    outs, _, _ = run
    clipped, plain = outs[0][CLIPPED_DP4], outs[0][DP4]
    moved = {k: max(float((clipped["state"][k][n] - plain["state"][k][n]).abs().max()) for n in plain["state"][k])
             for k in ("wm", "actor", "critic")}
    assert all(v > 1e-7 for v in moved.values()), moved  # the clip changed every optimizer's step
    for i in (CLIPPED_TP, CLIPPED_DP):
        for k in NAMES:
            _close_state(outs[0][i]["state"][k], clipped["state"][k], 1e-7, k)


def test_bf16_mixed_on_the_sharded_parameters_computes_the_dp_steps_forward(run):
    """Under ``fabric.precision=bf16-mixed`` a unit's gathered whole copy is
    cast into bf16 for its forward as the unsharded step casts its whole
    parameters: (2,2,1), whose data ranks are dp=4's, reads the same bf16
    weights on the same columns, so its losses are the bf16 dp=4 step's bit
    for bit and its update agrees with that step's to the gradients'
    summation order, at the tp meshes' tolerance; its shards are the
    report's."""
    outs, _, _ = run
    a, b = outs[0][BF16_DP], outs[0][BF16_DP4]
    assert a["metrics"] == b["metrics"]
    for k in NAMES:
        _close_state(a["state"][k], b["state"][k], 1e-7, k)
    for o in outs:
        assert o[BF16_DP]["param_bytes"] == a["summaries"]["params"]["bytes_per_chip"]
        assert o[BF16_DP]["grad_bytes"] == o[BF16_DP]["grad_leaf_bytes"]


def test_a_ranks_peak_during_a_burst_holds_the_whole_parameters_and_its_moment_slices(run):
    """Every case: at rest after the step a rank holds the report's
    ``bytes_per_chip`` of parameters and of gradients. On (1,4,1) and
    (2,2,1), which run the dp=4 step's computation on the same columns with
    one unit's whole weights gathered at a time, each rank's peak over the
    burst is below the unsharded dp=4 step's by at least 2 · (``total_bytes``
    − ``bytes_per_chip``) − 2 · (the largest unit's whole bytes). On every
    mesh the layout never holds more whole-copy bytes at once than the
    largest unit's (with its bf16 cast under bf16-mixed). The
    mirror's refresh, measured apart, fills the player's whole copies from
    the shards (a collective, one parameter at a time)."""
    outs, _, _ = run
    for i, case in enumerate(CASES):
        for o in outs:
            params = o[i]["summaries"].get("params")
            if params is not None:
                assert o[i]["param_bytes"] == params["bytes_per_chip"], case
                assert o[i]["grad_bytes"] == o[i]["grad_leaf_bytes"], case
            for k in ("wm", "actor"):
                for n, t in o[i]["state"][k].items():
                    assert torch.equal(o[i]["mirror"][k][n], t), (case, k, n)
            assert o[i]["refresh_peak_bytes"] >= o[i]["mirror_bytes"], case
            # one module's whole weights at a time (with their bf16 cast under bf16-mixed)
            held = o[i]["unit_bytes"] * (3 if case.get("precision") == "bf16-mixed" else 2) // 2
            assert o[i]["gathered_peak_bytes"] <= held, (case, o[i]["gathered_peak_bytes"], held)
    for i in FSDP:
        params = outs[0][i]["summaries"]["params"]
        for o in outs:
            margin = 2 * (params["total_bytes"] - params["bytes_per_chip"]) - 2 * o[i]["unit_bytes"]
            assert margin > 0 and o[DP4]["peak_bytes"] - o[i]["peak_bytes"] >= margin, (
                CASES[i], o[DP4]["peak_bytes"], o[i]["peak_bytes"], margin)
    print("rank 0 by case: mesh, peak bytes over the burst, over the refresh, parameter, gradient and moment "
          "bytes, the largest unit's whole bytes, the most whole-copy bytes held at once:",
          [(c["mesh"], outs[0][i]["peak_bytes"], outs[0][i]["refresh_peak_bytes"], outs[0][i]["param_bytes"],
            outs[0][i]["grad_bytes"], outs[0][i]["moments_bytes"], outs[0][i]["unit_bytes"],
            outs[0][i]["gathered_peak_bytes"])
           for i, c in enumerate(CASES)])


def test_dreamer_v3_cli_run_at_fsdp2_tp2_writes_valid_sharding_events_and_whole_checkpoints(tmp_path, monkeypatch,
                                                                                          capsys):
    """``run exp=dreamer_v3 fabric.devices=4 fabric.mesh.fsdp=2
    fabric.mesh.tp=2`` on the CPU: it trains; its stream passes both
    packages' validators and carries the two reports (each rank's
    parameters and moments below their totals); its checkpoint holds every
    tensor whole, ``serve``'s policy and ``eval`` load it, and a run on one
    rank resumes from it: the parameters it prints are the checkpoint's, and
    it trains on to its own last step."""
    from sheeprl_tpu.telemetry.schema import validate_jsonl as jax_validate
    from sheeprl_tpu_torch.telemetry.schema import validate_jsonl

    from sheeprl_tpu_torch.utils.checkpoint import param_sums

    monkeypatch.chdir(tmp_path)
    argv = ["exp=dreamer_v3", "env=dummy", "fabric.accelerator=cpu", "algo=dreamer_v3_XS", "env.num_envs=4",
               "buffer.size=128", "buffer.memmap=False", "algo.per_rank_sequence_length=4",
               "algo.per_rank_batch_size=2", "algo.learning_starts=32", "algo.total_steps=48",
               "checkpoint.every=48", "algo.run_test=False", "algo.dense_units=16",
               "algo.world_model.recurrent_model.recurrent_state_size=16",
               "algo.world_model.recurrent_model.dense_units=16", "algo.world_model.encoder.cnn_channels_multiplier=2",
               "algo.world_model.discrete_size=4", "algo.world_model.stochastic_size=4",
               "algo.world_model.transition_model.hidden_size=16",
               "algo.world_model.representation_model.hidden_size=16", "fabric.mesh.dp=1", "fabric.mesh.min_shard_size=64",
               f"fabric.rendezvous_dir={tmp_path / 'rdv'}", f"fabric.timeout_s={W.TIMEOUT_S}"]
    W.run_cli(argv + ["fabric.devices=4", "fabric.mesh.fsdp=2", "fabric.mesh.tp=2"])
    run_dir, = glob.glob(str(tmp_path / "logs/runs/dreamer_v3/*/*/version_0"))
    stream = f"{run_dir}/telemetry.jsonl"
    assert validate_jsonl(stream) == [] and jax_validate(stream) == []
    events = [json.loads(line) for line in open(stream)]
    summaries = {r["group"]: r for r in events if r["event"] == "sharding" and r["action"] == "summary"}
    assert set(summaries) == {"params", "opt_state"}
    for r in summaries.values():
        assert (r["dp"], r["fsdp"], r["tp"]) == (1, 2, 2)
    assert summaries["params"]["bytes_per_chip"] < summaries["params"]["total_bytes"]
    assert summaries["opt_state"]["bytes_per_chip"] < summaries["opt_state"]["total_bytes"]
    state = torch.load(f"{run_dir}/checkpoint/ckpt_48.ckpt", weights_only=False)
    assert state["policy_step"] == 48 and state["opt_states"]["step"] > 0
    leaves = {r["path"]: r["shape"] for r in events if r["event"] == "sharding" and r["group"] == "params"
              and r["action"] == "leaf"}
    # whole tensors: the saved parameters hold every element of the report's leaves
    n_saved = sum(t.numel() for k in NAMES for t in state[k].values())
    assert n_saved == sum(int(np.prod(s)) for s in leaves.values())
    assert all(type(t) is torch.Tensor for k in NAMES for t in state[k].values())

    # serve and eval read it as an unsharded run's checkpoint
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.serve.policy import InferencePolicy

    ckpt = f"{run_dir}/checkpoint/ckpt_48.ckpt"
    policy = InferencePolicy.from_checkpoint(ckpt, buckets=[1])
    assert policy.warmup() == 2
    capsys.readouterr()
    cli.evaluation([f"checkpoint_path={ckpt}", "fabric.accelerator=cpu"])
    assert "Test - Reward:" in capsys.readouterr().out

    # the (1,2,2) checkpoint at one rank
    capsys.readouterr()
    W.run_cli(argv + ["fabric.devices=1", "fabric.mesh.fsdp=1", "fabric.mesh.tp=1", "algo.total_steps=64",
                      "checkpoint.every=16", f"checkpoint.resume_from={run_dir}/checkpoint/ckpt_48.ckpt"])
    out = capsys.readouterr().out
    assert "[resume] the checkpoint was written on 4 ranks and this run has 1" in out
    resumed = json.loads(out.split("[dreamer_v3] resumed ", 1)[1].splitlines()[0])
    assert resumed["policy_step"] == 48
    assert resumed["param_sums"] == param_sums({k: state[k] for k in NAMES})
    last, = glob.glob(str(tmp_path / "logs/runs/dreamer_v3/*/*/version_*/checkpoint/ckpt_64.ckpt"))
    assert torch.load(last, weights_only=False)["opt_states"]["step"] > state["opt_states"]["step"]
