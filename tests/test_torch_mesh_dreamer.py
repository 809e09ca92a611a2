"""DreamerV2 and DreamerV1 on two gloo ranks against the JAX package at
``fabric.devices=2``.

* One burst of each at dp=2 (``torch_mesh_worker.run_jobs``, one launch):
  G = 2 gradient steps of a ``[T=3, B=4]`` batch at tests/torch_dreamer.py's
  widths (DreamerV2 discrete with its hard target copy every second step,
  DreamerV1 continuous), from the converted parameters and fresh Adam
  states, with the JAX step's own draws; the JAX step takes the batch
  sharded along its batch axis over a two-device mesh, each port rank its
  two columns of the batch and of the draws (the imagination's ``T·B``
  states flattened t-major). The world model, the actor and the critic each
  average the ranks' gradients in one flattened all-reduce per step;
  DreamerV1's actor gradient, taken through imagination over the actor's
  parameters alone, is all-reduced on its own. Losses rel 1e-5 with atol
  1e-6, parameters atol 5e-6, Adam moments rel 1e-4 of their tensor's
  largest (the single-device tests' tolerances); both ranks end bitwise
  equal.
* CLI runs at ``fabric.devices=2`` (another launch, in the background while
  the JAX bursts compile): ``dreamer_v2`` on the sequential buffer and on
  the episode buffer (then resumed at the same world size), ``dreamer_v1``.
  Every checkpoint's step, gradient steps, optimizer step count and Ratio
  state follow the JAX package's ledger (``torch_mesh_parity.jax_ledger``);
  rank 0 alone prints and checkpoints; a sequential buffer comes back
  gathered by env block, the ranks' episode buffers side by side, and those
  resume only at the world size that wrote them.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from torch_mesh_parity import (NUM_ENVS, WORLD, check_ledger, checkpoints, cols, jax_dist, jax_ledger,
                               rank_zero_alone, tb_cols, to_numpy)

DV = ["env=dummy", "fabric.accelerator=cpu", "algo.dense_units=8", "algo.mlp_layers=1",
      "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=16",
      "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
      "algo.world_model.stochastic_size=4", "algo.per_rank_sequence_length=2", "algo.per_rank_batch_size=2",
      "algo.horizon=3", "buffer.memmap=False", "algo.run_test=False", "metric.log_level=0"]
PRETRAIN = 1
# name → (argv, replay ratio, learning starts, total steps, checkpoint every)
LEDGERS = {
    "dreamer_v2": (["exp=dreamer_v2", *DV, "algo.world_model.discrete_size=4"], 0.25, 8, 32, 16),
    "dreamer_v1": (["exp=dreamer_v1", *DV, "env.id=continuous_dummy"], 0.25, 8, 32, 16),
    # episodes of 129 steps: the first ones commit at policy step 516 (4 envs)
    "dreamer_v2_episode": (["exp=dreamer_v2", *DV, "algo.world_model.discrete_size=4", "buffer.type=episode",
                            "env.id=multidiscrete_dummy"], 0.05, 520, 528, 264),
}
RESUMED_TOTAL = 544


def run_argv(name, tmp, total=None, extra=()):
    argv, ratio, starts, t, every = LEDGERS[name]
    return [*argv, f"fabric.devices={WORLD}", f"env.num_envs={NUM_ENVS}", f"algo.replay_ratio={ratio}",
            f"algo.per_rank_pretrain_steps={PRETRAIN}", f"algo.learning_starts={starts}",
            f"algo.total_steps={total or t}", f"checkpoint.every={every}", "buffer.size=600", f"run_name={name}",
            f"fabric.rendezvous_dir={tmp / 'rdv'}", f"fabric.timeout_s={W.TIMEOUT_S}", *extra]


def episode_ckpt(tmp):
    total = LEDGERS["dreamer_v2_episode"][3]
    return tmp / f"logs/runs/dreamer_v2/multidiscrete_dummy/dreamer_v2_episode/version_0/checkpoint/ckpt_{total}.ckpt"


def dreamer_job(algo, continuous):
    from importlib import import_module

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers
    from torch_dreamer import actions_dim, agents, jax_train_noise, jax_txs, replay_batch

    jalgo = import_module(f"sheeprl_tpu.algos.{algo}.{algo}")
    over = ["algo.critic.per_rank_target_network_update_freq=2"] if algo == "dreamer_v2" else []
    jcfg, tcfg, (wm, actor, critic), params, mods = agents(algo, over, continuous, "xla")
    txs = jax_txs(jcfg)
    G, T, B = 2, 3, 4
    batch = replay_batch(np.random.default_rng(7), (G, T, B), continuous)
    keys = jax.random.split(jax.random.PRNGKey(8), G)
    state = {k: txs[k].init(params[k]) for k in ("wm", "actor", "critic")}
    if algo == "dreamer_v2":
        state["step"] = jnp.zeros((), jnp.int32)
    jdist = jax_dist()
    train = jalgo.make_train_fn(wm, actor, critic, txs, jcfg, continuous, actions_dim(continuous))
    p2, s2, j_metrics = train(jax.tree.map(jnp.array, params), state,
                              {k: jax.device_put(jnp.asarray(v), jdist.shard_batch_axis(2)) for k, v in batch.items()},
                              keys)
    noise = [to_numpy(jax_train_noise(k, tcfg, continuous, T, B, gaussian=algo == "dreamer_v1")) for k in keys]
    mods = [m for m in mods if m is not None]
    opts = build_optimizers(tcfg, *mods[:3])
    job = {"kind": "dreamer", "algo": algo, "cfg": tcfg.to_dict(), "modules": mods,
           "opt_states": {k: getattr(opts, k).optimizer.state_dict() for k in ("wm", "actor", "critic")},
           "continuous": continuous, "actions_dim": actions_dim(continuous),
           "ranks": [{"batch": {k: cols(v, 2, r) for k, v in batch.items()},
                      "noise": [{"post": cols(n["post"], 1, r), "img_z": tb_cols(n["img_z"], 1, T, r),
                                 "img_a": [tb_cols(a, 1, T, r) for a in n["img_a"]]} for n in noise]}
                     for r in range(WORLD)]}
    return job, (to_numpy(p2), to_numpy(s2), j_metrics, tcfg, mods, G)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The CLI runs in the background; the JAX bursts, then both on the ranks."""
    tmp = tmp_path_factory.mktemp("mesh_dreamer")

    def steps():
        (v2, v2_ref), (v1, v1_ref) = dreamer_job("dreamer_v2", False), dreamer_job("dreamer_v1", True)
        return [v2, v1], {"dreamer_v2": v2_ref, "dreamer_v1": v1_ref}

    runs = [run_argv(name, tmp) for name in LEDGERS]
    runs.append(run_argv("dreamer_v2_episode", tmp, RESUMED_TOTAL,
                         ["run_name=resumed", f"checkpoint.resume_from={episode_ckpt(tmp)}"]))
    refs, (v2, v1), ran = W.launch_steps_and_runs(steps, [{"kind": "cli", "argv": a} for a in runs], tmp)
    return refs, {"dreamer_v2": v2, "dreamer_v1": v1,
                  **{f"run_{n}": r for n, r in zip([*LEDGERS, "resumed"], ran)}}, tmp


@pytest.mark.parametrize("algo", ["dreamer_v2", "dreamer_v1"])
def test_dreamer_burst_at_dp2_matches_jax(ranks, algo):
    from importlib import import_module

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers
    from torch_offpolicy import adam_diff, max_diff

    single = import_module(f"test_torch_{algo}")
    refs, outs, _ = ranks
    p2, s2, j_metrics, tcfg, mods, G = refs[algo]
    a, b = outs[algo]
    for sa, sb in zip(a["state"], b["state"]):
        for k, v in sa.items():
            assert torch.equal(v, sb[k]), k
    for state, module in zip(a["state"], mods):
        module.load_state_dict(state)
    opts = build_optimizers(tcfg, *mods[:3])
    for k in ("wm", "actor", "critic"):
        getattr(opts, k).optimizer.load_state_dict(a["opt_states"][k])
    for k, v in j_metrics.items():
        got = np.mean([o["metrics"][k] for o in outs[algo]], axis=0)
        np.testing.assert_allclose(got, np.asarray(v), rtol=single.LOSS_RTOL, atol=1e-6, err_msg=k)
    for key, module in zip(("wm", "actor", "critic", "target_critic"), mods):
        max_diff(module, p2[key], single.PARAM_ATOL, key)
    for key, module in zip(("wm", "actor", "critic"), mods):
        adam_diff(getattr(opts, key).optimizer, module, s2[key], single.MOMENT_RTOL, key)
    assert a["step"] == G
    # one flattened all-reduce per optimizer step: world model, actor, critic
    assert a["stats"]["all_reduce"] == 3 * G


@pytest.mark.parametrize("name", sorted(LEDGERS))
def test_two_ranks_keep_the_jax_ledger(ranks, name):
    _, outs, tmp = ranks
    argv, ratio, starts, total, every = LEDGERS[name]
    ckpts = checkpoints(tmp, argv[0].split("=")[1], name)
    assert sorted(ckpts) == list(range(every, total + 1, every))
    check_ledger(ckpts, jax_ledger(ratio, PRETRAIN, starts, total))
    assert ckpts[total]["grad_steps"] > 0
    rb = ckpts[total]["rb"]
    if name == "dreamer_v2_episode":  # one episode buffer per rank, side by side
        assert len(rb["rank_states"]) == WORLD and all(s["episodes"] for s in rb["rank_states"])
    else:  # one sequential buffer per env, both blocks
        assert len(rb["buffers"]) == NUM_ENVS and len(rb["rank_rngs"]) == WORLD
    rank_zero_alone(outs[f"run_{name}"])


def test_episode_buffers_resume_at_the_same_world_size_and_refuse_another(ranks):
    from sheeprl_tpu_torch.data.buffers import env_block

    _, outs, tmp = ranks
    _, ratio, starts, total, _ = LEDGERS["dreamer_v2_episode"]
    first = checkpoints(tmp, "dreamer_v2", "dreamer_v2_episode")[total]
    resumed = checkpoints(tmp, "dreamer_v2", "resumed")
    assert sorted(resumed) == [RESUMED_TOTAL]
    check_ledger(resumed, jax_ledger(ratio, PRETRAIN, starts, RESUMED_TOTAL, total, first["ratio"]),
                 grads0=first["grad_steps"])
    assert "[dreamer_v2] resumed" in outs["run_resumed"][0]["stdout"]
    assert not outs["run_resumed"][1]["stdout"]
    with pytest.raises(NotImplementedError, match="written on 2 ranks and this run has 1"):
        env_block(first["rb"], 0, 1)
