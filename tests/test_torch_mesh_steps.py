"""One train step of PPO and SAC at dp=2 (DreamerV3's:
tests/test_torch_mesh_dv3.py): the port on two gloo ranks against the JAX package
on ``Distributed(devices=2)``, and against itself on one rank.

The same seed-made global batch, the same converted parameters and Adam
states and the JAX step's own draws go to both sides. The JAX step takes the
global batch sharded along its batch axis over a two-device mesh (XLA
averages the gradients); each port rank takes its column block of the batch
and of the draws (``tests/torch_mesh_worker.py``), averages its gradients
with the other rank's in one all-reduce per optimizer step.

* PPO, 2 epochs × 2 global minibatches of 16 with advantage normalisation
  over the global minibatch: metrics rel 1e-4, parameters atol 1e-5 (as
  tests/test_torch_ppo.py);
* SAC, a burst of 3 steps on a global batch of 16: losses rel 1e-4,
  parameters atol 1e-5, Adam moments rel 1e-4 of their largest entry (as
  tests/test_torch_sac.py).

Both ranks end with bitwise the same parameters. The port at two ranks is
held against the port at one rank on the whole batch at the same
tolerances (the gradients are summed in another order).
"""

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_mesh_worker as W
from sheeprl_tpu_torch import convert

PARAM_ATOL = 1e-5
METRIC_RTOL = 1e-4
MOMENT_RTOL = 1e-4


def _jax_dist():
    from sheeprl_tpu.parallel import Distributed

    return Distributed(devices=2)


def _same_on_both_ranks(outs, key):
    for name, v in outs[0][key].items():
        if isinstance(v, dict):
            for n, t in v.items():
                assert torch.equal(t, outs[1][key][name][n]), (key, name, n)
        else:
            assert torch.equal(v, outs[1][key][name]), (key, name)


def _close_state(got, want, atol, what):
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=f"{what}.{name}")


def _close_adam(got, want, rtol, what):
    """Two optimizer ``state_dict``s: equal counts, each moment within
    ``rtol`` of its tensor's largest magnitude."""
    for idx, st in want["state"].items():
        g = got["state"][idx]
        assert int(g["step"]) == int(st["step"]), (what, idx)
        for m in ("exp_avg", "exp_avg_sq"):
            scale = max(float(st[m].abs().max()), 1e-30)
            np.testing.assert_allclose(g[m].numpy() / scale, st[m].numpy() / scale, rtol=0, atol=rtol,
                                       err_msg=f"{what}.{idx}.{m}")


# -- PPO ---------------------------------------------------------------------
def test_ppo_update_at_dp2_matches_jax(tmp_path):
    from sheeprl_tpu.algos.ppo.ppo import make_update_fn as jax_make_update_fn
    from sheeprl_tpu.config import instantiate as jax_instantiate
    from sheeprl_tpu.optim import clipped as jax_clipped
    from sheeprl_tpu_torch.config import instantiate as torch_instantiate
    from sheeprl_tpu_torch.optim import clipped as torch_clipped
    from torch_onpolicy import agents, configs, jax_coefs, jax_perms, numpy_tree, rollout_data

    jcfg, tcfg = configs("ppo", ["algo.update_epochs=2", "algo.normalize_advantages=True"])
    batch, mb = 32, 16  # global minibatches of 16: 8 rows a rank
    coefs = {"clip_coef": 0.2, "ent_coef": 0.01, "vf_coef": 0.5, "lr_frac": 1.0}
    jm, params, ta = agents(False, [3], False)
    tx = jax_clipped(jax_instantiate(jcfg.algo.optimizer), jcfg.algo.get("max_grad_norm", 0.0))
    j_update = jax_make_update_fn(jm, tx, jcfg, batch // mb, mb)
    rng = np.random.default_rng(5)
    warm = {k: jnp.asarray(v) for k, v in rollout_data(rng, batch, [3], False, False).items()}
    p1, s1, _ = j_update(jax.tree.map(jnp.array, params), tx.init(params), warm, jax_coefs(coefs),
                         jax.random.PRNGKey(1))
    p1, s1 = numpy_tree(p1), numpy_tree(s1)
    opt = torch_clipped(torch_instantiate(tcfg.algo.optimizer, list(ta.parameters())), tcfg.algo.max_grad_norm)
    convert.load_ppo(p1, ta, s1, opt)

    data = rollout_data(rng, batch, [3], False, False)
    key = jax.random.PRNGKey(2)
    jdist = _jax_dist()
    p2, _, j_metrics = j_update(jax.tree.map(jnp.array, p1), s1,
                                {k: jax.device_put(jnp.asarray(v), jdist.batch_sharding) for k, v in data.items()},
                                jax_coefs(coefs), key)
    payload = {"cfg": tcfg.to_dict(), "agent": ta, "opt_state": opt.optimizer.state_dict(), "data": data,
               "perms": jax_perms(key, 2, batch).astype(np.int64), "mb_size": mb, "coefs": coefs}
    outs = W.launch_ranks(W.ppo_update, payload, tmp_path)
    _same_on_both_ranks(outs, "agent")
    want = convert.params_to_state_dict(numpy_tree(p2), ta)
    _close_state(outs[0]["agent"], want, PARAM_ATOL, "agent")
    for k, v in j_metrics.items():
        got = np.mean([o["metrics"][k] for o in outs])
        np.testing.assert_allclose(got, float(v), rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    # one all-reduce a minibatch step, plus the advantages' global moments (two sums)
    assert outs[0]["stats"]["all_reduce"] == 2 * 2 * 3

    one = W.run_here(W.ppo_update, payload)
    _close_state(outs[0]["agent"], one["agent"], PARAM_ATOL, "agent")
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(np.mean([o["metrics"][k] for o in outs]), v, rtol=METRIC_RTOL, atol=1e-7)


# -- SAC ---------------------------------------------------------------------
def test_sac_burst_at_dp2_matches_jax(tmp_path):
    from test_torch_sac import agents as sac_agents, jax_burst
    from sheeprl_tpu_torch.algos.sac.sac import build_optimizers
    from torch_offpolicy import ACT, replay_batch, sac_keys

    jcfg, tcfg, actor, critic, params, agent = sac_agents([])
    G, B = 3, 16
    rng = np.random.default_rng(5)
    p1, s1, _ = jax_burst(jcfg, actor, critic, params, None, replay_batch(rng, (2, B)),
                          jax.random.split(jax.random.PRNGKey(1), 2))
    optimizers = build_optimizers(tcfg, agent)
    convert.load_sac(p1, agent, s1, optimizers)
    batches = replay_batch(rng, (G, B))
    keys = jax.random.split(jax.random.PRNGKey(2), G)
    jdist = _jax_dist()
    sharded = {k: jax.device_put(jnp.asarray(v), jdist.shard_batch_axis(1)) for k, v in batches.items()}
    from sheeprl_tpu.algos.sac.sac import make_train_fn as jax_make_train_fn
    from sheeprl_tpu.config import instantiate as jax_instantiate

    txs = {k: jax_instantiate(jcfg.algo[k].optimizer) for k in ("actor", "critic", "alpha")}
    p2, s2, j_metrics = jax_make_train_fn(actor, critic, txs, jcfg, -float(ACT))(
        jax.tree.map(jnp.array, p1), jax.tree.map(jnp.array, s1), sharded, keys)
    payload = {"cfg": tcfg.to_dict(), "agent": agent, "opt_states": optimizers.state_dict(), "batches": batches,
               "noise": sac_keys(keys, B).numpy(), "target_entropy": -float(ACT)}
    outs = W.launch_ranks(W.sac_burst, payload, tmp_path)
    _same_on_both_ranks(outs, "agent")
    ecfg, etcfg, _, _, _, expect = sac_agents([])
    eopts = build_optimizers(etcfg, expect)
    convert.load_sac(jax.tree.map(np.asarray, p2), expect, jax.tree.map(np.asarray, s2), eopts)
    _close_state(outs[0]["agent"], expect.state_dict(), PARAM_ATOL, "agent")
    for name in ("actor", "critic"):
        _close_adam(outs[0]["opt_states"][name], eopts.state_dict()[name], MOMENT_RTOL, name)
    assert outs[0]["opt_states"]["step"] == eopts.step == 5
    for k, v in j_metrics.items():
        got = np.mean([o["metrics"][k] for o in outs])
        np.testing.assert_allclose(got, float(np.mean(np.asarray(v))), rtol=METRIC_RTOL, err_msg=k)
    assert outs[0]["stats"]["all_reduce"] == 3 * G  # critic, actor, alpha each step

    one = W.run_here(W.sac_burst, payload)
    _close_state(outs[0]["agent"], one["agent"], PARAM_ATOL, "agent")
