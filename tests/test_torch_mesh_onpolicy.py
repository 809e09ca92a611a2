"""A2C and PPO-recurrent on two gloo ranks against the JAX package at
``fabric.devices=2``, and the actor fleet on two ranks.

One launch of two ranks (``torch_mesh_worker.run_jobs``) runs the updates,
another the CLI runs, in the background while the JAX updates compile:

* one A2C update at dp=2 per loss reduction, from the converted parameters
  and RMSprop state (after a first JAX update), on a seed-made rollout of 20
  rows that the JAX step takes sharded over a two-device mesh and each port
  rank takes half of. Under the default ``algo.loss_reduction: sum`` the JAX
  loss is the sum over the whole rollout, so the global gradient is the sum
  of the ranks' gradients (the test fails if they are averaged); under
  ``mean`` it is their mean. Metrics rel 1e-4, parameters atol 1e-5
  (tests/test_torch_a2c.py's tolerances);
* one recurrent PPO update at dp=2 (2 epochs × 2 global minibatches of 4
  sequences of 4 steps, the JAX permutations over sequences, advantages
  normalised over the global minibatch): metrics rel 1e-4, parameters atol
  1e-5 (tests/test_torch_ppo_recurrent.py's);
* CLI runs of ``a2c`` and ``ppo_recurrent`` at ``fabric.devices=2``: every
  checkpoint's step, update count and optimizer step count follow the JAX
  package's formulas at ``fabric.devices=2`` (``num_updates = total_steps //
  (num_envs · rollout_steps)``; PPO-recurrent's minibatches
  ``per_rank_num_batches × world_size``,
  ``sheeprl_tpu/algos/ppo_recurrent/ppo_recurrent.py:189``); rank 0 alone
  prints the log dir and writes the checkpoints, which hold both ranks'
  generators;
* ``exp=ppo algo.fleet.workers=2`` on two ranks: rank 0 alone prints the JAX
  package's line ``[fleet] actor fleet disabled: ...``
  (``sheeprl_tpu/fleet/engine.py``), and each rank trains on its env loop.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import glob
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from sheeprl_tpu_torch import convert
from sheeprl_tpu_torch.parallel.mesh import FLEET_DISABLED

WORLD = 2
NUM_ENVS = 4
COMMON = ["env=dummy", "fabric.accelerator=cpu", f"fabric.devices={WORLD}", f"env.num_envs={NUM_ENVS}",
          "buffer.memmap=False", "algo.run_test=False", "metric.log_level=0"]
# name → (argv, rollout steps, total steps, checkpoint every, gradient steps an update)
LEDGERS = {
    "a2c": (["exp=a2c", "algo.rollout_steps=8"], 8, 96, 32, 1),
    # 8 sequences of 4 steps an update, per_rank_num_batches × 2 = 4 minibatches of 2, 2 epochs
    "ppo_recurrent": (["exp=ppo_recurrent", "algo.rollout_steps=8", "algo.per_rank_sequence_length=4",
                       "algo.per_rank_num_batches=2", "algo.update_epochs=2"], 8, 64, 32, 2 * 4),
    "ppo_fleet": (["exp=ppo", "algo.rollout_steps=16", "algo.per_rank_batch_size=8", "algo.fleet.workers=2",
                   "algo.update_epochs=2"], 16, 128, 64, 2 * 4),
}


def ledger_argv(name, tmp):
    argv, _, total, every, _ = LEDGERS[name]
    return [*argv, *COMMON, f"algo.total_steps={total}", f"checkpoint.every={every}", f"run_name={name}",
            f"fabric.rendezvous_dir={tmp / 'rdv'}", f"fabric.timeout_s={W.TIMEOUT_S}"]


def _jax_dist():
    from sheeprl_tpu.parallel import Distributed

    return Distributed(devices=WORLD)


def a2c_job(reduction):
    from sheeprl_tpu.algos.a2c.a2c import make_update_fn as jax_make_update_fn
    from sheeprl_tpu.config import instantiate as jax_instantiate
    from sheeprl_tpu.optim import clipped as jax_clipped
    from sheeprl_tpu_torch.algos.a2c.a2c import build_optimizer
    from torch_onpolicy import agents, configs, numpy_tree, rollout_data

    jcfg, tcfg = configs("a2c", [f"algo.loss_reduction={reduction}"])
    adim = [3]
    jm, params, ta = agents(False, adim, False)
    tx = jax_clipped(jax_instantiate(jcfg.algo.optimizer), jcfg.algo.get("max_grad_norm", 0.0))
    j_update = jax_make_update_fn(jm, tx, jcfg)
    rng = np.random.default_rng(2)
    warm = {k: jnp.asarray(v) for k, v in rollout_data(rng, 20, adim, False, False).items()}
    p1, s1, _ = j_update(jax.tree.map(jnp.array, params), tx.init(params), warm)
    p1, s1 = numpy_tree(p1), numpy_tree(s1)
    opt = build_optimizer(tcfg, ta)
    convert.load_a2c(p1, ta, s1, opt)
    data = rollout_data(rng, 20, adim, False, False)
    jdist = _jax_dist()
    p2, _, j_metrics = j_update(jax.tree.map(jnp.array, p1), s1,
                                {k: jax.device_put(jnp.asarray(v), jdist.batch_sharding) for k, v in data.items()})
    job = {"kind": "a2c", "cfg": tcfg.to_dict(), "agent": ta, "opt_state": opt.optimizer.state_dict(),
           "ranks": [{"data": {k: np.ascontiguousarray(W.columns(v, 0, r, WORLD)) for k, v in data.items()}}
                     for r in range(WORLD)]}
    return job, (convert.params_to_state_dict(numpy_tree(p2), ta), j_metrics)


def ppo_recurrent_job():
    from sheeprl_tpu.algos.ppo_recurrent.ppo_recurrent import make_update_fn as jax_make_update_fn
    from sheeprl_tpu.config import instantiate as jax_instantiate
    from sheeprl_tpu.optim import clipped as jax_clipped
    from sheeprl_tpu_torch.config import instantiate as torch_instantiate
    from sheeprl_tpu_torch.optim import clipped as torch_clipped
    from test_torch_ppo_recurrent import H, rec_agents
    from torch_onpolicy import configs, jax_coefs, jax_perms, numpy_tree, rollout_data

    jcfg, tcfg = configs("ppo_recurrent", ["algo.update_epochs=2", "algo.normalize_advantages=True"])
    adim = [3]
    jm, params, ta = rec_agents(adim, False)
    S, L, mb = 8, 4, 4  # tests/test_torch_ppo_recurrent.py's update; 2 sequences a rank in each minibatch
    tx = jax_clipped(jax_instantiate(jcfg.algo.optimizer), jcfg.algo.get("max_grad_norm", 0.0))
    j_update = jax_make_update_fn(jm, tx, jcfg, S // mb, mb)
    rng = np.random.default_rng(4)
    coefs = dict(clip_coef=0.2, ent_coef=0.001, vf_coef=0.2, lr_frac=1.0)

    def batch():
        d = rollout_data(rng, L, adim, False, False, lead=(S,))
        d["prev_actions"] = rng.standard_normal((S, L, sum(adim))).astype(np.float32)
        d["is_first"] = (rng.random((S, L, 1)) < 0.25).astype(np.float32)
        d["cx0"], d["hx0"] = (rng.standard_normal((S, H)).astype(np.float32) for _ in range(2))
        return d

    warm = {k: jnp.asarray(v) for k, v in batch().items()}
    p1, s1, _ = j_update(jax.tree.map(jnp.array, params), tx.init(params), warm, jax_coefs(coefs),
                         jax.random.PRNGKey(1))
    p1, s1 = numpy_tree(p1), numpy_tree(s1)
    opt = torch_clipped(torch_instantiate(tcfg.algo.optimizer, [p for p in ta.parameters() if p.requires_grad]),
                        tcfg.algo.max_grad_norm)
    convert.load_ppo_recurrent(p1, ta, s1, opt)
    data = batch()
    key = jax.random.PRNGKey(2)
    jdist = _jax_dist()
    p2, _, j_metrics = j_update(jax.tree.map(jnp.array, p1), s1,
                                {k: jax.device_put(jnp.asarray(v), jdist.batch_sharding) for k, v in data.items()},
                                jax_coefs(coefs), key)
    job = {"kind": "ppo_recurrent", "cfg": tcfg.to_dict(), "agent": ta, "opt_state": opt.optimizer.state_dict(),
           "data": data, "perms": jax_perms(key, 2, S).astype(np.int64), "mb_size": mb, "coefs": coefs}
    return job, (convert.params_to_state_dict(numpy_tree(p2), ta), j_metrics)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The CLI runs in the background; the JAX updates, then the three on the ranks."""
    tmp = tmp_path_factory.mktemp("mesh_onpolicy")

    def steps():
        built = {"a2c_sum": a2c_job("sum"), "a2c_mean": a2c_job("mean"), "ppo_recurrent": ppo_recurrent_job()}
        return [job for job, _ in built.values()], {name: ref for name, (_, ref) in built.items()}

    refs, updates, runs = W.launch_steps_and_runs(
        steps, [{"kind": "cli", "argv": ledger_argv(name, tmp)} for name in LEDGERS], tmp)
    return refs, {**dict(zip(("a2c_sum", "a2c_mean", "ppo_recurrent"), updates)),
                  **{f"cli_{n}": r for n, r in zip(LEDGERS, runs)}}, tmp


def _same_on_both_ranks(outs):
    for k, v in outs[0]["agent"].items():
        assert torch.equal(v, outs[1]["agent"][k]), k


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_a2c_update_at_dp2_matches_jax(ranks, reduction):
    from test_torch_a2c import METRIC_RTOL, PARAM_ATOL

    refs, outs, _ = ranks
    want, j_metrics = refs[f"a2c_{reduction}"]
    got = outs[f"a2c_{reduction}"]
    _same_on_both_ranks(got)
    for name, v in want.items():
        np.testing.assert_allclose(got[0]["agent"][name].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=name)
    for k, v in j_metrics.items():  # the global losses, logged alike on both ranks
        assert got[0]["metrics"][k] == got[1]["metrics"][k]
        np.testing.assert_allclose(float(got[0]["metrics"][k]), float(v), rtol=METRIC_RTOL, err_msg=k)
    # one flattened all-reduce of the gradients (summed or averaged), one of the two losses
    assert got[0]["stats"]["all_reduce"] == 2


def test_ppo_recurrent_update_at_dp2_matches_jax(ranks):
    from test_torch_ppo_recurrent import METRIC_RTOL, PARAM_ATOL

    refs, outs, _ = ranks
    want, j_metrics = refs["ppo_recurrent"]
    got = outs["ppo_recurrent"]
    _same_on_both_ranks(got)
    for name, v in want.items():
        np.testing.assert_allclose(got[0]["agent"][name].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=name)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(np.mean([o["metrics"][k] for o in got]), float(v), rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=k)
    # per minibatch step: the gradients, and the advantages' global moments (two sums)
    assert got[0]["stats"]["all_reduce"] == 2 * 2 * 3


def _ckpts(tmp, algo, run):
    return {int(Path(p).stem.split("_")[1]): torch.load(p, weights_only=False)
            for p in glob.glob(str(tmp / f"logs/runs/{algo}/*/{run}/version_0/checkpoint/ckpt_*.ckpt"))}


def _opt_count(opt_state):
    return int(opt_state["state"][0]["step"])


@pytest.mark.parametrize("name", ["a2c", "ppo_recurrent", "ppo_fleet"])
def test_two_ranks_keep_the_jax_ledger(ranks, name):
    _, outs, tmp = ranks
    argv, rollout, total, every, per_update = LEDGERS[name]
    algo = argv[0].split("=")[1]
    ckpts = _ckpts(tmp, algo, name)
    assert sorted(ckpts) == list(range(every, total + 1, every))
    per_iter = NUM_ENVS * rollout
    for step, s in ckpts.items():
        assert s["policy_step"] == step and s["update"] == step // per_iter
        assert _opt_count(s["opt_state"]) == per_update * s["update"]
        assert s["world_size"] == WORLD and len(s["rank_generators"]) == WORLD
    a, b = outs[f"cli_{name}"]
    assert a["stdout"].count("log_dir=") == 1 and "log_dir=" not in b["stdout"]
    assert a["stats"]["all_reduce"] > 0


def test_the_fleet_on_two_ranks_prints_the_jax_line_once_and_trains(ranks):
    _, outs, tmp = ranks
    a, b = outs["cli_ppo_fleet"]
    assert a["stderr"].count(FLEET_DISABLED) == 1 and FLEET_DISABLED not in b["stderr"]
    assert FLEET_DISABLED.startswith("[fleet] actor fleet disabled: the fleet is a single-controller layout")
    assert not list(tmp.glob("logs/runs/ppo/*/ppo_fleet/version_0/workers"))  # no worker process ran
