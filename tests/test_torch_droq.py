"""DroQ in the PyTorch port against the JAX package, on the CPU.

* the critic ensemble (Linear → Dropout → LayerNorm → ReLU, twice, then the
  head; one module with a leading ``n`` axis) with each member's own flax
  dropout masks, recorded as the JAX package draws them and injected into
  the port;
* ``models.MLP`` with dropout against the JAX package's ``MLP``;
* the reference's caveat: flax's ``nn.vmap`` drops the
  ``deterministic=False`` keyword the JAX package passes, so its vmapped
  critic runs without dropout (the port applies the configured dropout; the
  tests that hold it against JAX masks run the JAX side with dropout
  honoured, a test-only wrapper around flax's ``nn.Dropout``);
* one burst of G = 3 critic steps and the actor and alpha step of
  ``make_train_fn`` from the same parameters and Adam states, with the JAX
  step's draws (``split(key, 4)`` per critic step, the actor key split in
  two) and its masks: the losses, the parameters, the target critic (its
  EMA after every step), ``log_alpha`` and every Adam state; and the same
  burst without dropout, as the JAX package runs it;
* CLI runs on the CPU: a dry run and ``eval``, CNN keys dropped with the
  JAX package's warning.

Tolerances: forwards atol 1e-5 (measured: 2.4e-7); the burst's losses rel
1e-4 and log_alpha atol 1e-5 (measured: 5.7e-6 rel, 2.0e-5 abs of losses
near 4), parameters and targets atol 1e-5 (measured: 1.2e-7), Adam moments
rel 1e-4 of each tensor's largest (measured: 7.8e-6); see
tests/test_torch_sac.py for why an Adam step bounds a parameter's error.
The masks are the JAX package's bits, injected: equal by construction.
The measured values: ``PYTHONPATH=. python tests/torch_offpolicy.py``.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import glob
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.droq import agent as jagent
from sheeprl_tpu.algos.droq.droq import make_train_fn as jax_make_train_fn
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu_torch import cli, convert
from sheeprl_tpu_torch.algos.droq import agent as tagent
from sheeprl_tpu_torch.algos.droq.droq import draw
from sheeprl_tpu_torch.algos.droq.droq import make_train_fn as torch_make_train_fn
from sheeprl_tpu_torch.algos.sac.sac import build_optimizers
from torch_offpolicy import (ACT, SMALL, adam_diff, assert_losses, configs, dist, jax_spaces, max_diff, numpy_tree,
                             recorded_dropout, replay_batch, split_masks, t, to_jax, to_torch, torch_spaces)

FWD_ATOL = 1e-5
BURST_RTOL = 1e-4
PARAM_ATOL = 1e-5
MOMENT_RTOL = 1e-4
N, LAYERS = 2, 2


def agents(overrides=()):
    jcfg, tcfg = configs("droq", [*SMALL, "algo.critic.dropout=0.2", *overrides])
    jo, ja = jax_spaces()
    actor, critic, params = jagent.build_agent(dist(), jcfg, jo, ja, jax.random.PRNGKey(0))
    params = numpy_tree(params)
    to, ta = torch_spaces()
    agent = tagent.build_agent(tcfg, to, ta)
    convert.load_droq(params, agent)
    return jcfg, tcfg, actor, critic, params, agent


def inputs(seed=1, batch=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, 6)).astype(np.float32), rng.uniform(-1, 1, (batch, ACT)).astype(np.float32)


def test_critic_ensemble_with_each_members_masks_matches_flax(monkeypatch):
    _, _, _, critic, params, agent = agents()
    obs, act = inputs()
    with recorded_dropout(monkeypatch) as rec, jax.disable_jit(), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # flax: kwargs are not supported in vmap
        j_q = critic.apply({"params": params["critic"]}, jnp.asarray(obs), jnp.asarray(act), deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(4)})
    (masks,) = split_masks(rec, N, LAYERS)
    assert masks[0].shape == (N, 5, 32) and not torch.equal(masks[0][0], masks[0][1])  # each member its own
    assert not bool(masks[0].all())  # a rate of 0.2 drops units
    with torch.no_grad():
        t_q = agent.critic(t(obs), t(act), masks)
        plain = agent.critic(t(obs), t(act))
    np.testing.assert_allclose(t_q.numpy(), np.asarray(j_q), rtol=0, atol=FWD_ATOL)
    assert not torch.allclose(t_q, plain)
    # drawn from a generator: [n, B, h] per layer, about 1 - rate kept
    drawn = tagent.critic_masks(agent.critic, 4096, torch.Generator().manual_seed(0), "cpu")
    assert [m.shape for m in drawn] == [(N, 4096, 32)] * LAYERS
    assert abs(float(torch.stack(drawn).float().mean()) - 0.8) < 0.01
    burst = draw(agent, 3, 4, torch.Generator().manual_seed(0), "cpu")
    assert len(burst["critic"]) == 3 and burst["critic"][0]["next"].shape == (4, ACT)
    assert [m.shape for m in burst["actor"]["masks"]] == [(N, 4, 32)] * LAYERS


def test_mlp_with_dropout_matches_flax(monkeypatch):
    """models.MLP: Linear → Dropout → LayerNorm → ReLU per layer, as the
    JAX package's MLP, with flax's masks injected; deterministic without
    masks."""
    from sheeprl_tpu.models import MLP as JaxMLP
    from sheeprl_tpu_torch.models import MLP, lecun_normal_

    jm = JaxMLP(hidden_sizes=(16, 16), output_dim=3, activation="relu", dropout=0.3, norm_layer="layernorm")
    x = np.random.default_rng(6).standard_normal((5, 7)).astype(np.float32)
    params = numpy_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    tm = MLP(7, (16, 16), norm_eps=1e-5, init=lecun_normal_, activation="relu", output_dim=3, dropout=0.3)
    convert.load_params(params, tm)
    with recorded_dropout(monkeypatch) as rec, jax.disable_jit():
        j_y = jm.apply({"params": params}, jnp.asarray(x), deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)})
    assert [m.shape for m in rec] == [(5, 16), (5, 16)]
    with torch.no_grad():
        t_y = tm(t(x), [t(m) for m in rec])
        plain = tm(t(x))
    np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y), rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jm.apply({"params": params}, jnp.asarray(x))), rtol=0,
                               atol=FWD_ATOL)


def test_the_jax_packages_vmapped_critic_runs_without_dropout():
    """The reference's caveat the port departs from: deterministic=False
    reaches no Dropout under nn.vmap."""
    _, _, _, critic, params, _ = agents()
    obs, act = inputs()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        q_train = critic.apply({"params": params["critic"]}, jnp.asarray(obs), jnp.asarray(act), deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(4)})
    q_eval = critic.apply({"params": params["critic"]}, jnp.asarray(obs), jnp.asarray(act))
    assert any("kwargs are not supported in vmap" in str(w.message) for w in caught)
    np.testing.assert_array_equal(np.asarray(q_train), np.asarray(q_eval))


def jax_train_fn(jcfg, actor, critic):
    """The JAX package's optimizers and its jitted train step."""
    txs = {k: jax_instantiate(jcfg.algo[k].optimizer) for k in ("actor", "critic", "alpha")}
    return txs, jax_make_train_fn(actor, critic, txs, jcfg, -float(ACT))


def jax_burst(jcfg, actor, critic, params, opt_states, critic_batches, actor_batch, keys, actor_key, train=None):
    """One JAX burst; ``train`` (``jax_train_fn``'s) lets bursts of the same
    shapes share one compile."""
    txs, own = jax_train_fn(jcfg, actor, critic)
    train = train or own
    if opt_states is None:
        opt_states = {"actor": txs["actor"].init(params["actor"]), "critic": txs["critic"].init(params["critic"]),
                      "alpha": txs["alpha"].init(params["log_alpha"])}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        p, s, m = train(jax.tree.map(jnp.array, params), jax.tree.map(jnp.array, opt_states), to_jax(critic_batches),
                        to_jax(actor_batch), keys, actor_key)
    return numpy_tree(p), numpy_tree(s), m


def jax_draws(keys, actor_key, masks, batch):
    """The port's draws from the JAX step's keys and its recorded masks:
    per critic step the target's call, then the online critic's; the actor
    step's call last."""
    calls = split_masks(masks, N, LAYERS)
    assert len(calls) == 2 * len(keys) + 1, len(calls)
    steps = []
    for i, k in enumerate(keys):
        _, k_act, _, _ = jax.random.split(k, 4)
        steps.append({"next": t(jax.random.normal(k_act, (batch, ACT))), "target_masks": calls[2 * i],
                      "masks": calls[2 * i + 1]})
    k_sample, _ = jax.random.split(actor_key)
    return {"critic": steps, "actor": {"noise": t(jax.random.normal(k_sample, (batch, ACT))), "masks": calls[-1]}}


@pytest.mark.parametrize("dropout", [0.2, 0.0])
def test_train_burst_matches_jax(monkeypatch, dropout):
    """G = 3 critic steps and one actor/alpha step from the same parameters
    and Adam states (after a first JAX burst), with the JAX step's draws and
    masks; dropout 0.0 is the burst as the JAX package runs it."""
    jcfg, tcfg, actor, critic, params, agent = agents([f"algo.critic.dropout={dropout}"])
    G, B = 3, 8
    rng = np.random.default_rng(5)
    with recorded_dropout(monkeypatch) as rec, jax.disable_jit():
        p1, s1, _ = jax_burst(jcfg, actor, critic, params, None, replay_batch(rng, (2, B)), replay_batch(rng, (B,)),
                              jax.random.split(jax.random.PRNGKey(1), 2), jax.random.PRNGKey(9))
        rec.clear()
        critic_batches, actor_batch = replay_batch(rng, (G, B)), replay_batch(rng, (B,))
        keys, actor_key = jax.random.split(jax.random.PRNGKey(2), G), jax.random.PRNGKey(3)
        p2, s2, j_metrics = jax_burst(jcfg, actor, critic, p1, s1, critic_batches, actor_batch, keys, actor_key)
    optimizers = build_optimizers(tcfg, agent)
    convert.load_droq(p1, agent, s1, optimizers)
    if dropout:
        draws = jax_draws(keys, actor_key, rec, B)
    else:  # flax draws no mask at rate 0, and the port's critic takes none
        assert not rec
        draws = jax_draws(keys, actor_key, [np.ones((B, 32), bool)] * (N * LAYERS * (2 * G + 1)), B)
    train = torch_make_train_fn(agent, optimizers, tcfg, -float(ACT))
    t_metrics = train(to_torch(critic_batches), to_torch(actor_batch), draws=draws)
    assert_losses(t_metrics, j_metrics, BURST_RTOL)
    for key in ("actor", "critic", "target_critic"):
        max_diff(getattr(agent, key), p2[key], PARAM_ATOL, key)
    np.testing.assert_allclose(float(agent.log_alpha.detach()), float(p2["log_alpha"]), rtol=0, atol=PARAM_ATOL)
    adam_diff(optimizers["actor"], agent.actor, s2["actor"], MOMENT_RTOL, "actor")
    adam_diff(optimizers["critic"], agent.critic, s2["critic"], MOMENT_RTOL, "critic")
    assert int(optimizers["actor"].state[agent.actor.fc_mean.weight]["step"]) == 2  # one actor step a burst


RUN = ["exp=droq", "env=dummy", "env.id=continuous_dummy", "fabric.accelerator=cpu", "env.num_envs=2",
       "algo.hidden_size=16", "buffer.memmap=False"]


def test_cli_dry_run_eval_and_cnn_keys_dropped(capsys):
    with pytest.warns(UserWarning, match="DroQ cannot use image observations"):
        cli.run(RUN + ["dry_run=True", "algo.cnn_keys.encoder=[rgb]", "run_name=dry"])
    out = capsys.readouterr().out
    assert "[droq] log_dir=" in out and "Test - Reward:" in out
    cli.run(RUN + ["algo.total_steps=24", "algo.learning_starts=16", "algo.per_rank_batch_size=4",
                   "algo.replay_ratio=2", "buffer.size=32", "algo.run_test=False", "run_name=short"])
    ckpt = sorted(glob.glob("logs/runs/droq/*/short/version_0/checkpoint/*.ckpt"))[-1]
    state = torch.load(ckpt, weights_only=False)
    assert state["policy_step"] == 24 and state["grad_steps"] == 16 and state["opt_states"]["step"] == 16
    capsys.readouterr()
    cli.evaluation([f"checkpoint_path={ckpt}"])
    assert "Test - Reward:" in capsys.readouterr().out
