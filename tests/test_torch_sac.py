"""SAC in the PyTorch port against the JAX package, on the CPU.

* ``SACActor`` and the critic ensemble (one module, a leading ``n`` axis on
  every weight) forward from the JAX agent's converted parameters;
* ``sample_actions`` with the JAX draws (asymmetric action bounds, so the
  rescaling's scale and bias both count), and greedy;
* the three losses;
* one burst of G = 3 gradient steps of ``make_train_fn`` from the same
  parameters and Adam states (taken after a first JAX burst, so the moments
  are not zero), with the JAX step's own key schedule (``split(key)`` for
  the target action, ``fold_in(key, 1)`` for the actor): the losses, the
  parameters, the target critic, ``log_alpha``, every Adam state and the
  step counter; with the target EMA every step and every second step;
* the replay buffer's uniform sample against the JAX package's (same seed:
  the same rows), and the device ring against the staged feed, bitwise;
* ``exp=sac|sac_decoupled|droq|sac_ae`` compose to the JAX package's algo;
* CLI runs on the CPU: a dry run, ``exp=sac`` on the continuous dummy env
  and on ``LunarLanderContinuous-v3``, ``eval``, the overlapped and the
  serial loop with equal ledgers, ``resume``, ``sac_decoupled`` refused on
  one device, the fleet refused.

Tolerances (f32 sums in another order): forwards and sampled actions atol
1e-5 (measured: 1.2e-7); log-probs rel 1e-4 (measured: 2.8e-5, 4.7e-5
absolute): near tanh's saturation ``log(1 - tanh²(x))`` turns
tanh's last-bit rounding, which differs between XLA and torch, into a
relative error of about 2·ulp/(1 - y²); losses rel 1e-5 (measured: 0);
the burst's losses rel 1e-4 and log_alpha atol 1e-5 (measured: 4.5e-6
rel, 2.9e-6 abs), parameters and targets atol 1e-5 (measured: 6.0e-8),
Adam moments rel 1e-4 of each tensor's largest (measured: 3.4e-6). An
Adam step moves a weight by about lr·sign(g), so a weight whose gradient
were rounding noise could differ by lr (3e-4): none does at these shapes,
and the 1e-5 bound would catch one. The measured values:
``PYTHONPATH=. python tests/torch_offpolicy.py``.
"""
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac import agent as jagent
from sheeprl_tpu.algos.sac import loss as jloss
from sheeprl_tpu.algos.sac.sac import make_train_fn as jax_make_train_fn
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.data.buffers import ReplayBuffer as JaxReplayBuffer
from sheeprl_tpu_torch import cli, convert
from sheeprl_tpu_torch.config import Config
from sheeprl_tpu_torch.algos.sac import agent as tagent
from sheeprl_tpu_torch.algos.sac import loss as tloss
from sheeprl_tpu_torch.algos.sac.sac import build_optimizers
from sheeprl_tpu_torch.algos.sac.sac import make_train_fn as torch_make_train_fn
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.data.device_ring import DeviceUniformRingPrefetcher, make_uniform_prefetcher
from sheeprl_tpu_torch.data.prefetch import StagedPrefetcher
from torch_onpolicy import last_checkpoint
from torch_offpolicy import (ACT, SMALL, adam_diff, assert_losses, configs, dist, jax_spaces, max_diff, numpy_tree,
                             replay_batch, sac_keys, t, to_jax, to_torch, torch_spaces, within)

FWD_ATOL = 1e-5
LOGP_RTOL = 1e-4
LOSS_RTOL = 1e-5
BURST_RTOL = 1e-4
PARAM_ATOL = 1e-5
MOMENT_RTOL = 1e-4


def agents(overrides=(), exp="sac"):
    """(JAX cfg, port cfg, JAX actor, JAX critic, JAX params, port agent)
    from the same parameters."""
    jcfg, tcfg = configs(exp, [*SMALL, *overrides])
    jo, ja = jax_spaces()
    actor, critic, params = jagent.build_agent(dist(), jcfg, jo, ja, jax.random.PRNGKey(0))
    params = numpy_tree(params)
    to, ta = torch_spaces()
    agent = tagent.build_agent(tcfg, to, ta)
    convert.load_sac(params, agent)
    return jcfg, tcfg, actor, critic, params, agent


def test_actor_and_critic_ensemble_forward_match_jax():
    _, _, actor, critic, params, agent = agents()
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((5, 6)).astype(np.float32)
    act = rng.uniform(-1, 1, (5, ACT)).astype(np.float32)
    j_mean, j_ls = actor.apply({"params": params["actor"]}, jnp.asarray(obs))
    j_q = critic.apply({"params": params["critic"]}, jnp.asarray(obs), jnp.asarray(act))
    with torch.no_grad():
        t_mean, t_ls = agent.actor(t(obs))
        t_q = agent.critic(t(obs), t(act))
    assert t_q.shape == (2, 5, 1) and agent.critic.MLP_0.dense_0.weight.shape[0] == 2
    for a, b in ((t_mean, j_mean), (t_ls, j_ls), (t_q, j_q)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=FWD_ATOL)
    # the two members are different networks, and the target a copy
    assert not torch.allclose(t_q[0], t_q[1])
    assert all(not p.requires_grad for p in agent.target_critic.parameters())


def test_sample_actions_with_the_jax_draws():
    _, _, actor, _, params, agent = agents()
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((64, 6)).astype(np.float32)
    mean, log_std = actor.apply({"params": params["actor"]}, jnp.asarray(obs))
    key = jax.random.PRNGKey(3)
    j_act, j_lp = jagent.sample_actions(actor, mean, log_std, key)
    g_act, g_lp = jagent.sample_actions(actor, mean, log_std, None, greedy=True)
    noise = t(jax.random.normal(key, mean.shape))
    with torch.no_grad():
        t_act, t_lp = tagent.sample_actions(agent.actor, t(mean), t(log_std), noise)
        tg_act, tg_lp = tagent.sample_actions(agent.actor, t(mean), t(log_std), greedy=True)
    for a, b in ((t_act, j_act), (tg_act, g_act)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=FWD_ATOL)
    for a, b in ((t_lp, j_lp), (tg_lp, g_lp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=LOGP_RTOL, atol=FWD_ATOL)
    assert t_lp.shape == (64, 1)
    # drawn from a generator: the same for the same seed, within the bounds
    gen = torch.Generator().manual_seed(0)
    a1, _ = tagent.sample_actions(agent.actor, t(mean), t(log_std), generator=gen)
    a2, _ = tagent.sample_actions(agent.actor, t(mean), t(log_std), generator=gen.manual_seed(0))
    assert torch.equal(a1, a2)
    assert bool((a1 >= torch.tensor([-1.0, -2.0])).all() and (a1 <= torch.tensor([1.0, 0.5])).all())


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 16, 1)).astype(np.float32)
    y, lp, min_q = (rng.standard_normal((16, 1)).astype(np.float32) for _ in range(3))
    pairs = [
        (jloss.critic_loss(jnp.asarray(q), jnp.asarray(y), 2), tloss.critic_loss(t(q), t(y))),
        (jloss.policy_loss(jnp.float32(0.3), jnp.asarray(lp), jnp.asarray(min_q)),
         tloss.policy_loss(torch.tensor(0.3), t(lp), t(min_q))),
        (jloss.entropy_loss(jnp.float32(-0.2), jnp.asarray(lp), -2.0), tloss.entropy_loss(torch.tensor(-0.2), t(lp),
                                                                                         -2.0)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(float(b), float(a), rtol=LOSS_RTOL)


def jax_burst(jcfg, actor, critic, params, opt_states, batches, keys):
    txs = {k: jax_instantiate(jcfg.algo[k].optimizer) for k in ("actor", "critic", "alpha")}
    train = jax_make_train_fn(actor, critic, txs, jcfg, -float(ACT))
    if opt_states is None:
        opt_states = {"actor": txs["actor"].init(params["actor"]), "critic": txs["critic"].init(params["critic"]),
                      "alpha": txs["alpha"].init(params["log_alpha"]), "step": jnp.zeros((), jnp.int32)}
    p, s, m = train(jax.tree.map(jnp.array, params), jax.tree.map(jnp.array, opt_states), to_jax(batches), keys)
    return numpy_tree(p), numpy_tree(s), m


@pytest.mark.parametrize("target_every", [1, 2])
def test_train_burst_matches_jax(target_every):
    """G = 3 gradient steps from the same parameters and Adam states, with
    the JAX step's draws: losses, parameters, targets, log_alpha, Adam
    states and the step counter."""
    jcfg, tcfg, actor, critic, params, agent = agents([f"algo.critic.target_network_frequency={target_every}"])
    G, B = 3, 8
    rng = np.random.default_rng(5)
    p1, s1, _ = jax_burst(jcfg, actor, critic, params, None, replay_batch(rng, (2, B)),
                          jax.random.split(jax.random.PRNGKey(1), 2))
    optimizers = build_optimizers(tcfg, agent)
    convert.load_sac(p1, agent, s1, optimizers)
    assert optimizers.step == 2

    batches = replay_batch(rng, (G, B))
    keys = jax.random.split(jax.random.PRNGKey(2), G)
    p2, s2, j_metrics = jax_burst(jcfg, actor, critic, p1, s1, batches, keys)
    train = torch_make_train_fn(agent, optimizers, tcfg, -float(ACT))
    t_metrics = train(to_torch(batches), noise=sac_keys(keys, B))
    assert_losses(t_metrics, j_metrics, BURST_RTOL)
    for key in ("actor", "critic", "target_critic"):
        max_diff(getattr(agent, key), p2[key], PARAM_ATOL, key)
    np.testing.assert_allclose(float(agent.log_alpha.detach()), float(p2["log_alpha"]), rtol=0, atol=PARAM_ATOL)
    adam_diff(optimizers["actor"], agent.actor, s2["actor"], MOMENT_RTOL, "actor")
    adam_diff(optimizers["critic"], agent.critic, s2["critic"], MOMENT_RTOL, "critic")
    st = optimizers["alpha"].state[agent.log_alpha]
    adam = convert.find_state(s2["alpha"])
    assert int(st["step"]) == int(adam.count) == 5
    np.testing.assert_allclose(float(st["exp_avg"]), float(adam.mu), rtol=MOMENT_RTOL)
    assert optimizers.step == int(s2["step"]) == 5
    # the target moved only on EMA steps: with every second step it is not the
    # critic's first EMA of this burst
    assert not torch.equal(agent.target_critic.MLP_0.out.weight, agent.critic.MLP_0.out.weight)


def filled_pair(steps: int, size=16, n_envs=3, seed=7):
    """The port's and the JAX package's buffers with the same rows and seed
    (wrapped around where ``steps`` > ``size``), images and their ``next_``
    twins uint8 as SAC-AE stores them."""
    rng = np.random.default_rng(0)
    a, b = ReplayBuffer(size, n_envs, seed=seed), JaxReplayBuffer(size, n_envs, seed=seed)
    for _ in range(steps):
        row = random_row(rng, n_envs)
        a.add(row)
        b.add(row)
    return a, b


def random_row(rng, n_envs):
    return {"rgb": rng.integers(0, 256, (1, n_envs, 4, 4, 3), dtype=np.uint8),
            "next_rgb": rng.integers(0, 256, (1, n_envs, 4, 4, 3), dtype=np.uint8),
            "state": rng.standard_normal((1, n_envs, 5)).astype(np.float32),
            "rewards": rng.standard_normal((1, n_envs, 1)).astype(np.float32),
            "actions": rng.standard_normal((1, n_envs, 2)).astype(np.float64)}


@pytest.mark.parametrize("steps", [10, 21])
def test_uniform_sample_matches_the_jax_buffer(steps):
    a, b = filled_pair(steps)
    for n in (1, 3):
        x, y = a.sample(4, n_samples=n), b.sample(4, n_samples=n)
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("steps", [10, 21])
def test_uniform_ring_and_staged_feed_are_bitwise_equal(steps):
    """The device ring (on the CPU here) and the staged host feed serve the
    same [G, B, ...] batches for the same buffer state, before and after the
    buffer wraps: uint8 image keys (and their next_ twins), f32 for the
    rest; the ring ships only the steps added since its last sync."""
    a, _ = filled_pair(steps)
    b, _ = filled_pair(steps)
    cnn = ("rgb", "next_rgb")
    ring = DeviceUniformRingPrefetcher(a, 4, cnn_keys=cnn, device="cpu")
    staged = make_uniform_prefetcher(Config({"buffer": {"device_cache": False}}), torch.device("cpu"), b, 4,
                                     cnn_keys=cnn)
    assert isinstance(staged, StagedPrefetcher)
    rng = np.random.default_rng(1)
    for g in (3, 1, 2):
        ring.stage(g)
        staged.stage(g)
        x, y = ring.take(g), staged.take(g)
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].shape[:2] == (g, 4) and x[k].dtype == y[k].dtype, k
            assert torch.equal(x[k], y[k]), k
        assert x["rgb"].dtype == x["next_rgb"].dtype == torch.uint8 and x["actions"].dtype == torch.float32
        shipped = ring.synced_rows
        row = random_row(rng, 3)
        a.add(row)
        b.add(row)
        ring.take(1)
        staged.take(1)
        assert ring.synced_rows == shipped + 1


@pytest.mark.parametrize("exp", ["sac", "sac_decoupled", "droq", "sac_ae"])
def test_presets_compose_to_the_jax_packages_algo(exp):
    jcfg, tcfg = configs(exp)
    within(tcfg.algo.to_dict(), jcfg.algo.to_dict())


RUN_ARGS = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "fabric.accelerator=cpu", "env.num_envs=2",
            "algo.hidden_size=16", "algo.per_rank_batch_size=8", "algo.learning_starts=16", "buffer.size=64",
            "buffer.memmap=False", "metric.log_every=16", "checkpoint.every=32", "algo.run_test=False"]


def test_cli_dry_run_and_eval_on_cpu(capsys):
    cli.run(["exp=sac", "env=dummy", "env.id=continuous_dummy", "fabric.accelerator=cpu", "dry_run=True",
             "env.num_envs=2", "buffer.memmap=False", "algo.hidden_size=16", "run_name=dry"])
    out = capsys.readouterr().out
    assert "[sac] log_dir=" in out and "Test - Reward:" in out
    ckpt = sorted(glob.glob("logs/runs/sac/*/dry/version_0/checkpoint/*.ckpt"))[-1]
    cli.evaluation([f"checkpoint_path={ckpt}"])
    assert "Test - Reward:" in capsys.readouterr().out


def test_lunar_lander_continuous_trains_on_cpu(capsys):
    """exp=sac on its own env (gymnasium's Box2D LunarLanderContinuous-v3)."""
    cli.run(["exp=sac", "fabric.accelerator=cpu", "env.num_envs=2", "algo.hidden_size=16", "algo.total_steps=48",
             "algo.learning_starts=16", "algo.per_rank_batch_size=8", "buffer.size=64", "buffer.memmap=False",
             "checkpoint.every=0", "metric.log_every=16", "run_name=lunar"])
    out = capsys.readouterr().out
    assert "LunarLanderContinuous-v3" in out and "Test - Reward:" in out
    s = last_checkpoint("lunar", "sac")
    assert s["policy_step"] == 48 and s["grad_steps"] == 32
    assert s["rb"]["buffer"]["observations"].shape[1:] == (2, 8)


def test_overlapped_and_serial_loops_end_with_equal_ledgers():
    """Bounded staleness lets the player act with parameters one burst old,
    so the trajectories differ; the Ratio ledger, the counters and the
    buffer's fill do not."""
    cli.run(RUN_ARGS + ["algo.total_steps=96", "run_name=overlap"])
    cli.run(RUN_ARGS + ["algo.total_steps=96", "run_name=serial", "algo.overlap.enabled=False"])
    a, b = last_checkpoint("overlap", "sac"), last_checkpoint("serial", "sac")
    for k in ("policy_step", "grad_steps", "ratio", "last_log", "last_checkpoint"):
        assert a[k] == b[k], k
    assert a["opt_states"]["step"] == b["opt_states"]["step"] == a["grad_steps"] == 80
    assert (a["rb"]["pos"], a["rb"]["full"]) == (b["rb"]["pos"], b["rb"]["full"])


def test_serial_runs_repeat_bitwise_and_resume(capsys):
    """Every draw is seeded (the warm-up actions from the env factory's
    seeded action space), so two serial runs end with bitwise-equal
    parameters; the resume command continues
    from the newest checkpoint's counters and parameters."""
    args = RUN_ARGS + ["algo.total_steps=48", "algo.overlap.enabled=False"]
    cli.run(args + ["run_name=one"])
    cli.run(args + ["run_name=two"])
    a, b = last_checkpoint("one", "sac"), last_checkpoint("two", "sac")
    assert all(torch.equal(v, b["agent"][k]) for k, v in a["agent"].items())
    capsys.readouterr()
    cli.resume([f"run_dir=logs/runs/sac/continuous_dummy/one", "algo.total_steps=80"])
    out = capsys.readouterr().out
    started = [l for l in out.splitlines() if l.startswith("[sac] resumed ")]
    assert started and '"policy_step": 48' in started[0]
    resumed = sorted(glob.glob("logs/runs/sac/*/one/version_1/checkpoint/*.ckpt"), key=lambda p: int(p[:-5].split("_")[-1]))
    assert torch.load(resumed[-1], weights_only=False)["policy_step"] == 80


def test_sac_decoupled_is_refused_on_one_device():
    with pytest.raises(RuntimeError, match="decoupled algorithm: it needs at least one player and one trainer"):
        cli.run(["exp=sac_decoupled", "fabric.devices=1", "fabric.accelerator=cpu"])
    with pytest.raises(NotImplementedError, match="one device"):
        cli.run(["exp=sac_decoupled", "fabric.accelerator=cpu"])


def test_fleet_mode_is_refused():
    with pytest.raises(NotImplementedError, match="fleet"):
        cli.run(RUN_ARGS + ["algo.total_steps=32", "run_name=fleet", "algo.fleet.workers=1"])
