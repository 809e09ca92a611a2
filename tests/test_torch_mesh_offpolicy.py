"""DroQ and SAC-AE on two gloo ranks against the JAX package at
``fabric.devices=2``.

* One burst of each at dp=2 (``torch_mesh_worker.run_jobs``, one launch):
  the bursts of tests/test_torch_droq.py (G = 3 critic steps of 8 rows, the
  actor and alpha step; without dropout, as the JAX package's vmapped critic
  runs) and tests/test_torch_sac_ae.py (G = 2 steps of 4 rows), from the
  converted parameters and Adam states after a first JAX burst of the same
  shapes (one compile for both), with the
  JAX step's own draws. The JAX step takes the batch sharded along its batch
  axis over a two-device mesh, each port rank its column block of the batch
  and of the draws; every optimizer step averages the ranks' gradients in
  one flattened all-reduce (an SAC-AE update that is not due steps on zero
  gradients on both ranks and runs none). Losses rel 1e-4, parameters atol
  1e-5 (DroQ) and 2e-5 with SAC-AE's outlier share, Adam moments rel 1e-4
  of their tensor's largest (SAC-AE's decoder 5e-2): the single-device
  tests' tolerances. Both ranks end bitwise equal.
* CLI runs of ``droq`` and ``sac_ae`` at ``fabric.devices=2`` (another
  launch, in the background while the JAX bursts compile): every
  checkpoint's step, gradient steps, optimizer step count and Ratio state
  follow the JAX package's ledger (``torch_mesh_parity.jax_ledger``); rank 0
  alone prints and checkpoints the buffer, the ranks' env blocks side by
  side, with both ranks' generators.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from sheeprl_tpu_torch import convert
from torch_mesh_parity import (NUM_ENVS, WORLD, check_ledger, checkpoints, cols, jax_dist, jax_ledger,
                               rank_zero_alone, to_numpy)

OFF = ["fabric.accelerator=cpu", "env=dummy", "env.id=continuous_dummy", "buffer.memmap=False", "algo.run_test=False",
       "metric.log_level=0"]
# name → (argv, replay ratio, learning starts, total steps, checkpoint every)
LEDGERS = {
    "droq": (["exp=droq", *OFF, "algo.hidden_size=16", "algo.per_rank_batch_size=4"], 0.5, 8, 32, 16),
    "sac_ae": (["exp=sac_ae", *OFF, "algo.cnn_channels_multiplier=1", "algo.hidden_size=32",
                "algo.per_rank_batch_size=4", "algo.encoder.features_dim=16", "algo.dense_units=16"], 0.25, 8, 32, 16),
}


def run_argv(name, tmp):
    argv, ratio, starts, total, every = LEDGERS[name]
    return [*argv, f"fabric.devices={WORLD}", f"env.num_envs={NUM_ENVS}", f"algo.replay_ratio={ratio}",
            "algo.per_rank_pretrain_steps=0", f"algo.learning_starts={starts}", f"algo.total_steps={total}",
            f"checkpoint.every={every}", "buffer.size=64", f"run_name={name}", f"fabric.rendezvous_dir={tmp / 'rdv'}",
            f"fabric.timeout_s={W.TIMEOUT_S}"]


def droq_job():
    from test_torch_droq import LAYERS, N, agents, jax_burst, jax_draws, jax_train_fn
    from sheeprl_tpu_torch.algos.sac.sac import build_optimizers
    from torch_offpolicy import ACT, replay_batch

    jcfg, tcfg, actor, critic, params, agent = agents(["algo.critic.dropout=0.0"])
    G, B = 3, 8
    rng = np.random.default_rng(5)
    jdist = jax_dist()
    _, train = jax_train_fn(jcfg, actor, critic)  # one compile: the warm-up burst takes the same shapes

    def sharded(critic_batches, actor_batch):
        return ({k: jax.device_put(jnp.asarray(v), jdist.shard_batch_axis(1)) for k, v in critic_batches.items()},
                {k: jax.device_put(jnp.asarray(v), jdist.batch_sharding) for k, v in actor_batch.items()})

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        p1, s1, _ = jax_burst(jcfg, actor, critic, params, None, *sharded(replay_batch(rng, (G, B)),
                                                                          replay_batch(rng, (B,))),
                              jax.random.split(jax.random.PRNGKey(1), G), jax.random.PRNGKey(9), train=train)
        critic_batches, actor_batch = replay_batch(rng, (G, B)), replay_batch(rng, (B,))
        keys, actor_key = jax.random.split(jax.random.PRNGKey(2), G), jax.random.PRNGKey(3)
        p2, s2, j_metrics = jax_burst(jcfg, actor, critic, p1, s1, *sharded(critic_batches, actor_batch), keys,
                                      actor_key, train=train)
    optimizers = build_optimizers(tcfg, agent)
    convert.load_droq(p1, agent, s1, optimizers)
    # flax draws no mask at rate 0; the port's critic takes masks of ones
    draws = to_numpy(jax_draws(keys, actor_key, [np.ones((B, 32), bool)] * (N * LAYERS * (2 * G + 1)), B))

    def mine(r):
        masks = lambda ms: [cols(m, 1, r) for m in ms]  # noqa: E731 - [n, B, h] per layer
        return {"critic_batches": {k: cols(v, 1, r) for k, v in critic_batches.items()},
                "actor_batch": {k: cols(v, 0, r) for k, v in actor_batch.items()},
                "draws": {"critic": [{"next": cols(d["next"], 0, r), "target_masks": masks(d["target_masks"]),
                                      "masks": masks(d["masks"])} for d in draws["critic"]],
                          "actor": {"noise": cols(draws["actor"]["noise"], 0, r),
                                    "masks": masks(draws["actor"]["masks"])}}}

    job = {"kind": "droq", "cfg": tcfg.to_dict(), "agent": agent, "opt_states": optimizers.state_dict(),
           "target_entropy": -float(ACT), "ranks": [mine(r) for r in range(WORLD)]}
    return job, (p2, s2, j_metrics, G)


def sac_ae_job():
    from test_torch_sac_ae import IMG, STATE, agents, jax_burst, jax_draws, jax_train_fn
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import build_optimizers
    from torch_offpolicy import ACT, replay_batch

    jcfg, tcfg, mods, params, agent = agents("xla")
    G, B = 2, 4
    rng = np.random.default_rng(5)
    spec = {"rgb": IMG, "state": (STATE,)}
    jdist = jax_dist()
    _, train = jax_train_fn(jcfg, mods)  # one compile: the warm-up burst takes the same shapes

    def sharded(batches):
        return {k: jax.device_put(jnp.asarray(v), jdist.shard_batch_axis(1)) for k, v in batches.items()}

    p1, s1, _ = jax_burst(jcfg, mods, params, None, sharded(replay_batch(rng, (G, B), spec, vector_obs=False)),
                          jax.random.split(jax.random.PRNGKey(1), G), train=train)
    batches = replay_batch(rng, (G, B), spec, vector_obs=False)
    keys = jax.random.split(jax.random.PRNGKey(2), G)
    p2, s2, j_metrics = jax_burst(jcfg, mods, p1, s1, sharded(batches), keys, train=train)
    optimizers = build_optimizers(tcfg, agent)
    convert.load_sac_ae(p1, agent, s1, optimizers)
    draws = to_numpy(jax_draws(keys, B))
    job = {"kind": "sac_ae", "cfg": tcfg.to_dict(), "agent": agent, "opt_states": optimizers.state_dict(),
           "target_entropy": -float(ACT),
           "ranks": [{"batches": {k: cols(v, 1, r) for k, v in batches.items()},
                      "draws": [{"next": cols(d["next"], 0, r), "actor": cols(d["actor"], 0, r),
                                 "dither": [cols(x, 0, r) for x in d["dither"]]} for d in draws]}
                     for r in range(WORLD)]}
    return job, (p2, s2, j_metrics, G)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The CLI runs in the background; the JAX bursts, then both on the ranks."""
    tmp = tmp_path_factory.mktemp("mesh_offpolicy")

    def steps():
        (droq, droq_ref), (sac_ae, sac_ae_ref) = droq_job(), sac_ae_job()
        return [droq, sac_ae], {"droq": droq_ref, "sac_ae": sac_ae_ref}

    refs, (droq, sac_ae), runs = W.launch_steps_and_runs(
        steps, [{"kind": "cli", "argv": run_argv(name, tmp)} for name in LEDGERS], tmp)
    return refs, {"droq": droq, "sac_ae": sac_ae, **{f"run_{n}": r for n, r in zip(LEDGERS, runs)}}, tmp


def _same_agents(outs):
    for k, v in outs[0]["agent"].items():
        assert torch.equal(v, outs[1]["agent"][k]), k


def _losses(outs):
    return {k: torch.tensor(np.mean([o["metrics"][k] for o in outs])) for k in outs[0]["metrics"]}


def test_droq_burst_at_dp2_matches_jax(ranks):
    from test_torch_droq import BURST_RTOL, MOMENT_RTOL, PARAM_ATOL, agents
    from sheeprl_tpu_torch.algos.sac.sac import build_optimizers
    from torch_offpolicy import adam_diff, assert_losses, max_diff

    refs, outs, _ = ranks
    p2, s2, j_metrics, G = refs["droq"]
    _same_agents(outs["droq"])
    a = outs["droq"][0]
    _, tcfg, _, _, _, agent = agents(["algo.critic.dropout=0.0"])
    agent.load_state_dict(a["agent"])
    opts = build_optimizers(tcfg, agent)
    opts.load_state_dict(a["opt_states"])
    assert_losses(_losses(outs["droq"]), j_metrics, BURST_RTOL)
    for key in ("actor", "critic", "target_critic"):
        max_diff(getattr(agent, key), p2[key], PARAM_ATOL, key)
    np.testing.assert_allclose(float(agent.log_alpha.detach()), float(p2["log_alpha"]), rtol=0, atol=PARAM_ATOL)
    adam_diff(opts["actor"], agent.actor, s2["actor"], MOMENT_RTOL, "actor")
    adam_diff(opts["critic"], agent.critic, s2["critic"], MOMENT_RTOL, "critic")
    # one flattened all-reduce per optimizer step: G critic steps, the actor, alpha
    assert a["stats"]["all_reduce"] == G + 2


def test_sac_ae_burst_at_dp2_matches_jax(ranks):
    from test_torch_sac_ae import (BURST_RTOL, DECODER_MOMENT_RTOL, MOMENT_RTOL, OUTLIER_SHARE, PARAM_ATOL,
                                   agents)
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import build_optimizers
    from torch_offpolicy import adam_diff, assert_losses, max_diff

    refs, outs, _ = ranks
    p2, s2, j_metrics, G = refs["sac_ae"]
    _same_agents(outs["sac_ae"])
    a = outs["sac_ae"][0]
    _, tcfg, _, _, agent = agents("xla")
    agent.load_state_dict(a["agent"])
    opts = build_optimizers(tcfg, agent)
    opts.load_state_dict(a["opt_states"])
    assert_losses(_losses(outs["sac_ae"]), j_metrics, BURST_RTOL)
    for key in ("encoder", "qs", "actor", "decoder", "target_encoder", "target_qs"):
        max_diff(getattr(agent, key), p2[key], PARAM_ATOL, key, outliers=(OUTLIER_SHARE, G * 1e-3))
    modules = {"qf": torch.nn.ModuleDict({"encoder": agent.encoder, "qs": agent.qs}), "actor": agent.actor,
               "encoder": agent.encoder, "decoder": agent.decoder}
    for name, module in modules.items():
        adam_diff(opts[name], module, s2[name], DECODER_MOMENT_RTOL if name == "decoder" else MOMENT_RTOL, name)
    assert opts.step == int(s2["step"]) == 2 * G  # the warm-up burst's G steps, then the burst's
    # steps G+1..2G: the critic every step, the actor with alpha and the
    # encoder with the decoder where due; a masked update that is not due
    # runs no collective
    actor_freq, decoder_freq = tcfg.algo.actor.per_rank_update_freq, tcfg.algo.decoder.per_rank_update_freq
    assert a["stats"]["all_reduce"] == sum(1 + 2 * (s % actor_freq == 0) + (s % decoder_freq == 0)
                                           for s in range(G + 1, 2 * G + 1))


@pytest.mark.parametrize("name", sorted(LEDGERS))
def test_two_ranks_keep_the_jax_ledger(ranks, name):
    _, outs, tmp = ranks
    argv, ratio, starts, total, every = LEDGERS[name]
    ckpts = checkpoints(tmp, name, name)
    assert sorted(ckpts) == list(range(every, total + 1, every))
    check_ledger(ckpts, jax_ledger(ratio, 0, starts, total))
    rb = ckpts[total]["rb"]  # the uniform buffer: the ranks' env blocks side by side
    assert rb["buffer"]["actions"].shape[1] == NUM_ENVS and len(rb["rank_rngs"]) == WORLD
    rank_zero_alone(outs[f"run_{name}"])
