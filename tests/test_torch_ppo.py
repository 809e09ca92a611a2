"""PPO in the PyTorch port against the JAX package, on the CPU.

* ``PPOAgent`` forward (vector keys, and pixels + vector through NatureCNN)
  from the JAX agent's converted parameters;
* ``actions_and_log_probs`` with the JAX package's own draws (gumbel per
  categorical head, standard normal for the Normal heads): the same actions,
  log-probs and entropies, discrete, multi-discrete and continuous;
* the three losses;
* one whole update, 2 epochs × 2 minibatches, with the permutations
  ``jax.random.permutation`` drew, from the same parameters and Adam state
  (taken after one JAX update, so the moments are not zero);
* GAE against ``sheeprl_tpu.ops.gae``;
* ``exp=ppo`` composes to the JAX package's algo section;
* a CPU dry run of the CLI, and the overlapped (strict on-policy) and the
  serial loop ending with equal ledgers and equal parameters.

Tolerances (f32 sums in another order): forward outputs atol 1e-5
(measured: 3.9e-7), log-probs, entropies and continuous actions atol 1e-5
(measured: 9.5e-7); losses rel 1e-5 (measured: 2.6e-7); the update's
metrics rel 1e-4 (measured: 3.9e-7) and parameters atol 1e-5 (measured:
1.2e-7); GAE atol 1e-5 (measured: 6.0e-7). Sampled discrete actions and the
two loops' parameters: exactly equal.
The measured values: ``python scripts/onpolicy_parity_report.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo import agent as jagent
from sheeprl_tpu.algos.ppo import loss as jloss
from sheeprl_tpu.algos.ppo.ppo import make_update_fn as jax_make_update_fn
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.ops import gae as jax_gae
from sheeprl_tpu.optim import clipped as jax_clipped
from sheeprl_tpu_torch import cli, convert
from sheeprl_tpu_torch.algos.ppo import agent as tagent
from sheeprl_tpu_torch.algos.ppo import loss as tloss
from sheeprl_tpu_torch.algos.ppo.ppo import make_update_fn as torch_make_update_fn
from sheeprl_tpu_torch.config import instantiate as torch_instantiate
from sheeprl_tpu_torch.ops import gae as torch_gae
from sheeprl_tpu_torch.optim import clipped as torch_clipped
from torch_onpolicy import (agents, assert_params_close, configs, jax_coefs, jax_perms, last_checkpoint, numpy_tree,
                            obs_batch, rollout_data, to_torch, torch_coefs)

FWD_ATOL = 1e-5
LOSS_RTOL = 1e-5
METRIC_RTOL = 1e-4
PARAM_ATOL = 1e-5
CASES = {
    "vector-discrete": (False, [3], False),
    "vector-multidiscrete": (False, [3, 2], False),
    "vector-continuous": (False, [2], True),
    "pixel-discrete": (True, [4], False),
}


@pytest.mark.parametrize("case", ["vector-discrete", "pixel-discrete", "vector-continuous"])
def test_agent_forward_matches_jax(case):
    pixels, adim, cont = CASES[case]
    jm, params, ta = agents(pixels, adim, cont, layer_norm=case == "vector-discrete")
    obs = obs_batch(np.random.default_rng(1), (5,), pixels)
    j_out, j_v = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in obs.items()})
    with torch.no_grad():
        t_out, t_v = ta(to_torch(obs))
    np.testing.assert_allclose(t_v.numpy(), np.asarray(j_v), rtol=0, atol=FWD_ATOL)
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("case", ["vector-discrete", "vector-multidiscrete", "vector-continuous"])
def test_actions_and_log_probs_with_the_jax_draws(case):
    pixels, adim, cont = CASES[case]
    jm, params, ta = agents(pixels, adim, cont)
    obs = obs_batch(np.random.default_rng(2), (64,), pixels)
    j_out, _ = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in obs.items()})
    key = jax.random.PRNGKey(7)
    j_act, j_lp, j_ent = jagent.actions_and_log_probs(j_out, cont, key=key)
    if cont:  # Normal.rsample draws one standard normal of the mean's shape
        noise = [torch.from_numpy(np.array(jax.random.normal(key, j_out[0].shape)))]
    else:  # jax.random.categorical is argmax(logits + gumbel) per head, one split key each
        keys = jax.random.split(key, len(j_out))
        noise = [torch.from_numpy(np.array(jax.random.gumbel(k, l.shape))) for k, l in zip(keys, j_out)]
    with torch.no_grad():
        t_out, _ = ta(to_torch(obs))
        t_act, t_lp, t_ent = tagent.actions_and_log_probs(t_out, cont, noise=noise)
        g_act, _, _ = tagent.actions_and_log_probs(t_out, cont, greedy=True)
    if cont:
        np.testing.assert_allclose(t_act.numpy(), np.asarray(j_act), rtol=0, atol=FWD_ATOL)
    else:
        np.testing.assert_array_equal(t_act.numpy(), np.asarray(j_act))
    np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(t_ent.numpy(), np.asarray(j_ent), rtol=0, atol=FWD_ATOL)
    j_greedy, _, _ = jagent.actions_and_log_probs(j_out, cont, greedy=True)
    np.testing.assert_allclose(g_act.numpy(), np.asarray(j_greedy), rtol=0, atol=FWD_ATOL)
    # the evaluation path: the log-probs of given actions
    with torch.no_grad():
        _, e_lp, _ = tagent.actions_and_log_probs(t_out, cont, actions=torch.from_numpy(np.array(j_act, np.float32)))
    np.testing.assert_allclose(e_lp.numpy(), np.asarray(j_lp), rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_losses_match_jax(reduction):
    rng = np.random.default_rng(3)
    lp, old, adv, new_v, old_v, ret, ent = (rng.standard_normal((32, 1)).astype(np.float32) for _ in range(7))
    j, t = (lambda *a: [jnp.asarray(x) for x in a]), (lambda *a: [torch.from_numpy(x) for x in a])
    pairs = [
        (jloss.policy_loss(*j(lp, old, adv), jnp.float32(0.2), reduction),
         tloss.policy_loss(*t(lp, old, adv), torch.tensor(0.2), reduction)),
        (jloss.entropy_loss(*j(ent), reduction), tloss.entropy_loss(*t(ent), reduction)),
    ]
    for clip in (False, True):
        pairs.append((jloss.value_loss(*j(new_v, old_v, ret), jnp.float32(0.2), clip, reduction),
                      tloss.value_loss(*t(new_v, old_v, ret), torch.tensor(0.2), clip, reduction)))
    for a, b in pairs:
        np.testing.assert_allclose(float(b), float(a), rtol=LOSS_RTOL)


def test_gae_matches_jax():
    rng = np.random.default_rng(4)
    T, N = 16, 3
    rewards, values = (rng.standard_normal((T, N, 1)).astype(np.float32) for _ in range(2))
    dones = (rng.random((T, N, 1)) < 0.2).astype(np.float32)
    nxt = rng.standard_normal((N, 1)).astype(np.float32)
    j_ret, j_adv = jax_gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones), jnp.asarray(nxt), T, 0.99,
                           0.95)
    t_ret, t_adv = torch_gae(*(torch.from_numpy(x) for x in (rewards, values, dones, nxt)), T, 0.99, 0.95)
    np.testing.assert_allclose(t_ret.numpy(), np.asarray(j_ret), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), rtol=0, atol=1e-5)


UPDATE_CASES = {
    # case: (pixels, actions_dim, continuous, overrides, coefs)
    "vector-discrete": (False, [3], False, [], dict(clip_coef=0.2, ent_coef=0.0, vf_coef=1.0, lr_frac=1.0)),
    "vector-continuous-clipped": (False, [2], True,
                                  ["algo.clip_vloss=True", "algo.normalize_advantages=True", "algo.max_grad_norm=0.5"],
                                  dict(clip_coef=0.1, ent_coef=0.01, vf_coef=0.5, lr_frac=0.5)),
    "pixel-discrete": (True, [4], False, [], dict(clip_coef=0.2, ent_coef=0.01, vf_coef=1.0, lr_frac=1.0)),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_update_matches_jax(case):
    """One whole update (2 epochs × 2 minibatches of 8) from the same
    parameters and Adam state, with the JAX update's permutations."""
    pixels, adim, cont, overrides, coefs = UPDATE_CASES[case]
    jcfg, tcfg = configs("ppo", ["algo.update_epochs=2", *overrides])
    batch, mb = 16, 8
    jm, params, ta = agents(pixels, adim, cont)
    tx = jax_clipped(jax_instantiate(jcfg.algo.optimizer), jcfg.algo.get("max_grad_norm", 0.0))
    j_update = jax_make_update_fn(jm, tx, jcfg, batch // mb, mb)
    rng = np.random.default_rng(5)
    # a first JAX update, so the Adam moments handed over are not zero
    warm = {k: jnp.asarray(v) for k, v in rollout_data(rng, batch, adim, cont, pixels).items()}
    p1, s1, _ = j_update(jax.tree.map(jnp.array, params), tx.init(params), warm, jax_coefs(coefs),
                         jax.random.PRNGKey(1))
    p1, s1 = numpy_tree(p1), numpy_tree(s1)
    opt = torch_clipped(torch_instantiate(tcfg.algo.optimizer, list(ta.parameters())), tcfg.algo.max_grad_norm)
    convert.load_ppo(p1, ta, s1, opt)

    data = rollout_data(rng, batch, adim, cont, pixels)
    key = jax.random.PRNGKey(2)
    p2, _, j_metrics = j_update(jax.tree.map(jnp.array, p1), s1, {k: jnp.asarray(v) for k, v in data.items()},
                                jax_coefs(coefs), key)
    t_update = torch_make_update_fn(ta, opt, tcfg, batch // mb, mb)
    perms = torch.from_numpy(jax_perms(key, 2, batch).astype(np.int64))
    t_metrics = t_update(to_torch(data), torch_coefs(coefs), perms)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(t_metrics[k]), float(v), rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    assert_params_close(ta, convert.params_to_state_dict(numpy_tree(p2), ta), PARAM_ATOL)
    assert opt.optimizer.param_groups[0]["lr"] == pytest.approx(float(tcfg.algo.optimizer.lr))  # lr_frac undone


@pytest.mark.parametrize("exp", ["ppo", "a2c", "ppo_recurrent"])
def test_presets_compose_to_the_jax_packages_algo(exp):
    """exp=ppo|a2c|ppo_recurrent: the port's algo section is the JAX
    package's, restricted to the keys the port reads."""
    jcfg, tcfg = configs(exp)

    def within(a, b, path="algo"):
        for k, v in a.items():
            assert k in b, f"{path}.{k}"
            if isinstance(v, dict):
                within(v, b[k], f"{path}.{k}")
            elif isinstance(v, str) and v.startswith("sheeprl_tpu_torch."):
                assert v.replace("sheeprl_tpu_torch.", "sheeprl_tpu.", 1) == b[k], (f"{path}.{k}", v, b[k])
            else:
                assert v == b[k], (f"{path}.{k}", v, b[k])

    within(tcfg.algo.to_dict(), jcfg.algo.to_dict())


# episodes truncated at 3 steps: the rollout's truncation bootstrapping runs too
RUN_ARGS = ["exp=ppo", "env=dummy", "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=32",
            "algo.per_rank_batch_size=16", "algo.update_epochs=2", "algo.total_steps=192", "checkpoint.every=64",
            "metric.log_every=64", "buffer.memmap=False", "algo.run_test=False", "env.max_episode_steps=3"]


def test_cli_dry_run_on_cpu(capsys):
    cli.run(["exp=ppo", "env=dummy", "fabric.accelerator=cpu", "dry_run=True", "env.num_envs=2",
             "buffer.memmap=False", "run_name=dry"])
    out = capsys.readouterr().out
    assert "[ppo] log_dir=" in out and "Test - Reward:" in out
    assert last_checkpoint("dry")["update"] == 1


def test_overlapped_and_serial_loops_end_with_equal_ledgers():
    """Strict on-policy overlap: the player collects each rollout with the
    parameters of the update before it, so both loops take the same
    trajectory: the same counters, generators and parameters, bitwise."""
    cli.run(RUN_ARGS + ["run_name=overlap"])
    cli.run(RUN_ARGS + ["run_name=serial", "algo.overlap.enabled=False"])
    a, b = last_checkpoint("overlap"), last_checkpoint("serial")
    for k in ("policy_step", "update", "last_log", "last_checkpoint"):
        assert a[k] == b[k], k
    assert a["policy_step"] == 192 and a["update"] == 3
    for k in ("train", "player"):
        assert torch.equal(a["generators"][k]["state"], b["generators"][k]["state"]), k
    for k, v in a["agent"].items():
        assert torch.equal(v, b["agent"][k]), k


def test_truncation_bootstrap_adds_the_discounted_final_value():
    from sheeprl_tpu_torch.algos.ppo.ppo import bootstrap_truncated

    rewards = np.ones((3, 1), np.float32)
    info = {"final_obs": np.array([None, {"state": np.full(2, 4.0)}, None], dtype=object)}
    bootstrap_truncated(rewards, np.array([False, True, False]), info, ("state",),
                        lambda o, idx: o["state"].sum(-1, keepdims=True) * (1 + 0 * idx[:, None]), 0.5)
    np.testing.assert_array_equal(rewards[:, 0], [1.0, 5.0, 1.0])
    bootstrap_truncated(rewards, np.array([False, False, False]), info, ("state",), None, 0.5)
    np.testing.assert_array_equal(rewards[:, 0], [1.0, 5.0, 1.0])


def test_fleet_mode_is_refused():
    with pytest.raises(NotImplementedError, match="fleet"):
        cli.run(RUN_ARGS + ["run_name=fleet", "algo.fleet.workers=1"])
