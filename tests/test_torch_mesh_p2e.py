"""The six Plan2Explore entry points on two gloo ranks against the JAX
package at ``fabric.devices=2``.

* One exploration burst of P2E-DV3 at dp=2 (``torch_mesh_worker.run_jobs``,
  one launch; tests/test_torch_p2e_dv3.py's coupled burst: G = 3 steps of a
  ``[T=4, B=2]`` batch, one column a rank), from the converted parameters,
  Adam states and Moments under way, with the JAX step's own draws; the JAX
  step takes the batch sharded along its batch axis over a two-device mesh.
  Every optimizer (the world model, the ensembles, both actors, the task
  critic and each exploration critic) averages its gradients over the ranks
  in one flattened all-reduce, and every Moments (the task critic's and each
  exploration critic's) takes its quantiles of the global λ-returns (one
  all-gather). Losses rel 1e-4 with atol 1e-6, parameters atol 5e-6,
  Moments atol 1e-5, Adam moments rel 1e-4 (the single-device test's
  tolerances); both ranks end bitwise equal. P2E-DV2's and DV1's steps
  build their optimizers the same way (``mesh.collective``) as DreamerV2's,
  which tests/test_torch_mesh_dreamer.py holds at dp=2.
* CLI runs of each exploration entry point and of its finetuning from the
  exploration checkpoint written before it in the same launch, in the
  background while the JAX burst compiles (P2E-DV3 decoupled on
  the LN-GRU wrappers, ``pallas_gru=True``, which the finetuning inherits):
  every checkpoint's step, gradient steps, optimizer step count and Ratio
  state follow the JAX package's ledger at ``fabric.devices=2`` (its loops
  call ``ratio(policy_step / world_size)``,
  ``sheeprl_tpu/algos/p2e_dv3/p2e_dv3_finetuning.py:283``); each
  finetuning run switches the player to the task actor at
  ``learning_starts``; rank 0 alone prints and checkpoints.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import glob
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from sheeprl_tpu.utils.utils import Ratio as JaxRatio
from sheeprl_tpu_torch import convert

WORLD = 2
NUM_ENVS = 4
RATIO, PRETRAIN, STARTS, TOTAL, EVERY = 0.25, 1, 16, 24, 12
DV = ["algo.dense_units=8", "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
      "algo.world_model.recurrent_model.recurrent_state_size=16", "algo.world_model.transition_model.hidden_size=8",
      "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=4",
      "algo.per_rank_sequence_length=2", "algo.per_rank_batch_size=2", "algo.horizon=3", "algo.ensembles.n=3"]
VARIANTS = {
    "dv3": ["env.id=discrete_dummy", "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=4",
            "algo.horizon=3", "algo.dense_units=16", "algo.mlp_layers=2",
            "algo.world_model.encoder.cnn_channels_multiplier=2",
            "algo.world_model.recurrent_model.recurrent_state_size=8",
            "algo.world_model.recurrent_model.dense_units=16", "algo.world_model.transition_model.hidden_size=16",
            "algo.world_model.representation_model.hidden_size=16", "algo.world_model.discrete_size=4",
            "algo.world_model.stochastic_size=4", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[]",
            "algo.ensembles.n=3", "algo.world_model.decoupled_rssm=True", "algo.world_model.pallas_gru=True"],
    "dv2": [*DV, "algo.world_model.discrete_size=4"],
    "dv1": [*DV, "env.id=continuous_dummy"],
}


ENV_ID = {"dv3": "discrete_dummy", "dv2": "discrete_dummy", "dv1": "continuous_dummy"}


def argv(variant, phase, tmp, extra=()):
    return [f"exp=p2e_{variant}_{phase}", "env=dummy", *VARIANTS[variant], "fabric.accelerator=cpu",
            f"fabric.devices={WORLD}", f"env.num_envs={NUM_ENVS}", "buffer.memmap=False", "algo.run_test=False", "metric.log_level=0",
            f"algo.replay_ratio={RATIO}", f"algo.per_rank_pretrain_steps={PRETRAIN}",
            f"algo.learning_starts={STARTS}", f"algo.total_steps={TOTAL}", f"checkpoint.every={EVERY}",
            "buffer.size=64", f"run_name={variant}_{phase}", f"fabric.rendezvous_dir={tmp / 'rdv'}",
            f"fabric.timeout_s={W.TIMEOUT_S}", *extra]


def exploration_ckpt(tmp, variant):
    return (tmp / f"logs/runs/p2e_{variant}_exploration/{ENV_ID[variant]}/{variant}_exploration/version_0/checkpoint"
            / f"ckpt_{TOTAL}.ckpt")


def jax_ledger():
    """{policy step: (gradient steps so far, Ratio state)} of the JAX loops."""
    ratio = JaxRatio(RATIO, pretrain_steps=PRETRAIN)
    out, grads = {}, 0
    for step in range(NUM_ENVS, TOTAL + 1, NUM_ENVS):
        if step >= STARTS:
            grads += ratio(step / WORLD)
        out[step] = (grads, ratio.state_dict())
    return out


def _jax_dist():
    from sheeprl_tpu.parallel import Distributed

    return Distributed(devices=WORLD)


def _cols(x, axis, rank):
    return np.ascontiguousarray(W.columns(np.asarray(x), axis, rank, WORLD))


def _tb(x, lead, T, rank):
    return np.ascontiguousarray(W._tb_columns(np.asarray(x), lead, T, rank, WORLD))


def _np(tree):
    return jax.tree.map(lambda v: np.array(v.detach() if torch.is_tensor(v) else v), tree)


def _rollout_cols(n, T, rank):
    out = {"img_z": _tb(n["img_z"], 1, T, rank), "img_a": [_tb(a, 1, T, rank) for a in n["img_a"]]}
    if "act0" in n:
        out["act0"] = [_tb(a, 0, T, rank) for a in n["act0"]]
    return out


def _noise_cols(noise, T, rank):
    return [{"post": _cols(n["post"], 1, rank), "exploration": _rollout_cols(n["exploration"], T, rank),
             "task": _rollout_cols(n["task"], T, rank)} for n in noise]


def dv3_job():
    from test_torch_p2e_dv3 import B, G, T
    from sheeprl_tpu.algos.dreamer_v3.utils import MomentsState as JMoments
    from sheeprl_tpu.algos.p2e_dv3 import p2e_dv3_exploration as jexp
    from sheeprl_tpu.config import instantiate as jax_instantiate
    from sheeprl_tpu.optim import clipped as jax_clipped
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as texp
    from torch_p2e import N_ACT, dv3_agents, dv3_batch, jax_dv3_noise, jax_txs, numpy_tree

    jcfg, tcfg, (wm, actor, critic, ens_apply), params, mods = dv3_agents()
    names = list(jcfg.algo.critics_exploration.keys())
    txs = jax_txs(jcfg, ["wm", "ensembles", "actor_task", "critic_task", "actor_exploration"])
    txs["critics_exploration"] = jax_clipped(jax_instantiate(jcfg.algo.critic.optimizer), jcfg.algo.critic.clip_gradients)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_states = {k: txs[k].init(jparams[k]) for k in ("wm", "ensembles", "actor_task", "critic_task",
                                                       "actor_exploration")}
    opt_states["critics_exploration"] = {k: txs["critics_exploration"].init(jparams["critics_exploration"][k]["critic"])
                                         for k in names}
    opt_states["step"] = jnp.zeros((), jnp.int32)
    opt0 = numpy_tree(opt_states)
    moments = {"task": JMoments(jnp.asarray(0.2), jnp.asarray(1.3)),
               "exploration": {k: JMoments(jnp.asarray(-0.1 * i), jnp.asarray(0.9 + i)) for i, k in enumerate(names)}}
    moments0 = convert.load_moments(numpy_tree(moments))
    batch = dv3_batch(np.random.default_rng(7), G, T, B)
    keys = jax.random.split(jax.random.PRNGKey(8), G)
    jdist = _jax_dist()
    train = jexp.make_train_fn(wm, actor, critic, ens_apply, txs, jcfg, False, [N_ACT])
    p2, s2, m2, jmetrics = train(jparams, opt_states, moments,
                                 {k: jax.device_put(jnp.asarray(v), jdist.shard_batch_axis(2)) for k, v in batch.items()},
                                 keys)
    optimizers = texp.build_optimizers(tcfg, mods)
    convert.load_p2e_dv3(params, mods, opt0, optimizers)
    noise = _np([jax_dv3_noise(k, tcfg, T, B) for k in keys])
    job = {"kind": "p2e", "algo": "p2e_dv3", "cfg": tcfg.to_dict(), "modules": mods,
           "opt_states": optimizers.state_dict(), "moments": moments0, "continuous": False, "actions_dim": [N_ACT],
           "ranks": [{"batch": {k: _cols(v, 2, r) for k, v in batch.items()}, "noise": _noise_cols(noise, T, r)}
                     for r in range(WORLD)]}
    return job, {"params": numpy_tree(p2), "opt_states": numpy_tree(s2), "moments": numpy_tree(m2),
                 "metrics": numpy_tree(jmetrics), "tcfg": tcfg, "G": G}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each exploration run and the finetuning run from its checkpoint in
    the background; the JAX burst, then the burst on the ranks."""
    tmp = tmp_path_factory.mktemp("mesh_p2e")
    names, runs = [], []
    for variant in VARIANTS:
        for phase in ("exploration", "finetuning"):
            extra = ([f"checkpoint.exploration_ckpt_path={exploration_ckpt(tmp, variant)}"]
                     if phase == "finetuning" else [])
            names.append(f"{variant}_{phase}")
            runs.append({"kind": "cli", "argv": argv(variant, phase, tmp, extra)})

    def steps():
        job, ref = dv3_job()
        return [job], ref

    ref, (burst,), ran = W.launch_steps_and_runs(steps, runs, tmp)
    return ref, {"p2e_dv3": burst, **dict(zip(names, ran))}, tmp


def test_exploration_burst_at_dp2_matches_jax(ranks):
    import test_torch_p2e_dv3 as single
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import MomentsState
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as texp
    from torch_p2e import dv3_agents, moments_diff, modules_diff, optimizers_diff

    ref, outs, _ = ranks
    a, b = outs["p2e_dv3"]
    for name, state in a["state"].items():
        for k, v in state.items():
            assert torch.equal(v, b["state"][name][k]), (name, k)
    mods = dv3_agents()[-1]
    for name, m in mods.items():
        m.load_state_dict(a["state"][name])
    optimizers = texp.build_optimizers(ref["tcfg"], mods)
    optimizers.load_state_dict(a["opt_states"])
    for k, v in ref["metrics"].items():
        got = np.mean([o["metrics"][k] for o in (a, b)], axis=0)
        np.testing.assert_allclose(got, v, rtol=single.LOSS_RTOL, atol=1e-6, err_msg=k)
    modules_diff(mods, ref["params"], single.PARAM_ATOL)
    optimizers_diff(optimizers, mods, ref["opt_states"], single.ADAM_RTOL)
    assert optimizers.step == int(ref["opt_states"]["step"]) == ref["G"]
    for k, (low, high) in a["moments"].items():
        want = ref["moments"]["task"] if k == "task" else ref["moments"]["exploration"][k]
        assert moments_diff(MomentsState(torch.tensor(low), torch.tensor(high)), want) <= single.MOMENTS_ATOL, k
    # per step: the world model, the ensembles, both actors, the task critic
    # and the two exploration critics; three Moments, one all-gather each
    assert a["stats"]["all_reduce"] == 7 * ref["G"] and a["stats"]["all_gather"] == 3 * ref["G"]


def _ckpts(tmp, algo, run):
    return {int(Path(p).stem.split("_")[1]): torch.load(p, weights_only=False)
            for p in glob.glob(str(tmp / f"logs/runs/{algo}/*/{run}/version_0/checkpoint/ckpt_*.ckpt"))}


@pytest.mark.parametrize("variant", ["dv3", "dv2", "dv1"])
@pytest.mark.parametrize("phase", ["exploration", "finetuning"])
def test_two_ranks_keep_the_jax_ledger(ranks, variant, phase):
    _, outs, tmp = ranks
    ckpts = _ckpts(tmp, f"p2e_{variant}_{phase}", f"{variant}_{phase}")
    assert sorted(ckpts) == list(range(EVERY, TOTAL + 1, EVERY))
    ledger = jax_ledger()
    for step, s in ckpts.items():
        grads, ratio = ledger[step]
        assert s["policy_step"] == step and s["grad_steps"] == grads and int(s["opt_states"]["step"]) == grads, step
        assert s["ratio"]["_prev"] == pytest.approx(ratio["_prev"]), step
        assert s["world_size"] == WORLD and len(s["rank_generators"]) == WORLD
        assert len(s["rb"]["buffers"]) == NUM_ENVS and len(s["rb"]["rank_rngs"]) == WORLD
    a, b = outs[f"{variant}_{phase}"]
    assert a["stdout"].count("log_dir=") == 1 and not b["stdout"]
    if phase == "finetuning":
        assert "from exploration" in a["stdout"]
        assert f"the player acts with the task actor from policy step {STARTS}" in a["stdout"]
