"""Plan2Explore-DV2 in the PyTorch port against the JAX package, on the CPU,
at the DreamerV1/V2 tests' widths (tests/torch_dreamer.py: dense 8, one MLP
layer, multiplier 2, recurrent 16, stochastic 4x4, 64x64 frames and a vector
key; three ensemble members), from the same converted parameters:

* one G = 3 exploration burst (both target critics hard-copied at steps 0
  and 2) on the JAX package's own draws, with a discrete actor, and with
  ``tanh_normal``, ``objective_mix`` 0.5 and the continue head: every loss
  and metric, every parameter group (world model, ensembles, task and
  exploration actor, critic and target critic), every optimizer's Adam(W)
  moments and the step counter;
* finetuning: the CLI's surgery, the parameters the run starts from (the
  exploration checkpoint's), the player's exploration actor before
  ``learning_starts`` and task actor from there;
* CLI runs of both entry points (the chain through ``cli.run``) and
  ``eval`` of both checkpoints.

Tolerances, with the largest differences measured (``PYTHONPATH=. python
tests/torch_p2e.py``): losses and metrics rel 1e-5 (7.3e-6), parameters
atol 5e-6 (4.4e-7), Adam moments rel 1e-4 of each tensor's largest
(7.6e-5, the tanh-normal burst's).
"""
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.p2e_dv2 import p2e_dv2_exploration as jexp
from sheeprl_tpu_torch import cli, convert
from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as tdv2
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration as texp
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_finetuning as tft
from sheeprl_tpu_torch.utils.checkpoint import param_sums
from torch_dreamer import actions_dim, replay_batch
from torch_p2e import dreamer_agents, jax_dreamer_noise, jax_txs, modules_diff, numpy_tree, optimizers_diff

LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-6
ADAM_RTOL = 1e-4
G, T, B = 3, 3, 2
NAMES = ("wm", "ensembles", "actor_task", "critic_task", "actor_exploration", "critic_exploration")
BURSTS = {"discrete": (False, []),
          "tanh_normal": (True, ["distribution.type=tanh_normal", "algo.actor.objective_mix=0.5",
                                 "algo.world_model.use_continues=True"])}


@pytest.fixture(scope="module", params=sorted(BURSTS))
def burst(request):
    continuous, extra = BURSTS[request.param]
    over = ["algo.critic.per_rank_target_network_update_freq=2", *extra]
    jcfg, tcfg, (wm, actor, critic, ens_apply), params, mods = dreamer_agents("dv2", over, continuous)
    txs = jax_txs(jcfg, NAMES)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_states = {k: txs[k].init(jparams[k]) for k in NAMES}
    opt_states["step"] = jnp.zeros((), jnp.int32)
    opt0 = numpy_tree(opt_states)
    batch = replay_batch(np.random.default_rng(7), (G, T, B), continuous)
    keys = jax.random.split(jax.random.PRNGKey(8), G)
    train = jexp.make_train_fn(wm, actor, critic, ens_apply, txs, jcfg, continuous, actions_dim(continuous))
    p2, s2, jmetrics = train(jparams, opt_states, jax.tree.map(jnp.asarray, batch), keys)

    optimizers = texp.build_optimizers(tcfg, mods)
    convert.load_p2e_dv2(params, mods, opt0, optimizers)
    ttrain = texp.make_train_fn(mods, optimizers, tcfg, continuous, actions_dim(continuous))
    noise = [jax_dreamer_noise(k, tcfg, continuous, T, B, gaussian=False) for k in keys]
    tmetrics = ttrain({k: torch.from_numpy(v) for k, v in batch.items()}, noise=noise)
    return {"params": numpy_tree(p2), "opt_states": numpy_tree(s2), "jmetrics": numpy_tree(jmetrics), "mods": mods,
            "optimizers": optimizers, "tmetrics": tmetrics}


def test_exploration_burst_losses_and_metrics_match_jax(burst):
    assert set(texp.METRIC_KEYS) == set(burst["jmetrics"])
    for k in texp.METRIC_KEYS:
        np.testing.assert_allclose(burst["tmetrics"][k].numpy(), burst["jmetrics"][k], rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)


def test_exploration_burst_parameters_and_adam_states_match_jax(burst):
    mods = burst["mods"]
    modules_diff(mods, burst["params"], PARAM_ATOL)
    # the copies at step 2 took each critic after two updates, not the third
    for name in ("task", "exploration"):
        c, t_ = mods[f"critic_{name}"], mods[f"target_critic_{name}"]
        assert max(float((a - b).detach().abs().max()) for a, b in zip(c.parameters(), t_.parameters())) > 1e-7
    optimizers_diff(burst["optimizers"], mods, burst["opt_states"], ADAM_RTOL)
    assert burst["optimizers"].step == int(burst["opt_states"]["step"]) == G


RUN = ["env=dummy", "fabric.accelerator=cpu", "algo.dense_units=8", "algo.mlp_layers=1",
       "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=16",
       "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
       "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4", "algo.per_rank_sequence_length=2",
       "algo.per_rank_batch_size=2", "algo.horizon=3", "buffer.memmap=False", "algo.ensembles.n=3",
       "algo.run_test=False", "algo.per_rank_pretrain_steps=1", "metric.log_level=0"]


def last(pattern):
    return sorted(glob.glob(pattern), key=lambda p: int(p[:-5].rsplit("_", 1)[1]))[-1]


def test_finetuning_surgery_start_and_actor_switch(monkeypatch):
    cli.run(["exp=p2e_dv2_exploration", *RUN, "algo.learning_starts=4", "algo.total_steps=8", "run_name=ex",
             "algo.actor.expl_amount=0.3", "algo.gamma=0.9"])
    ex = last("logs/runs/p2e_dv2_exploration/*/ex/version_0/checkpoint/*.ckpt")
    saved = torch.load(ex, weights_only=False)
    want = param_sums({"wm": saved["wm"], "actor": saved["actor_task"], "critic": saved["critic_task"],
                       "target_critic": saved["target_critic_task"]})
    expl_sum, task_sum = param_sums({"e": saved["actor_exploration"], "t": saved["actor_task"]}).values()
    seen = {"start": None, "acting": []}

    def make_train_fn(wm, actor, critic, target_critic, *args):
        seen["start"] = param_sums({"wm": wm, "actor": actor, "critic": critic, "target_critic": target_critic})
        seen["cfg"], seen["actor"] = args[1], actor
        return tdv2.make_train_fn(wm, actor, critic, target_critic, *args)

    def make_player(*args, **kwargs):
        init, step, expl_at = tdv2.make_player(*args, **kwargs)

        def recording(obs, state, modules=None, **kw):
            seen["acting"].append(param_sums({"mirror": modules["actor"], "task": seen["actor"]}))
            return step(obs, state, modules=modules, **kw)

        return init, recording, expl_at

    monkeypatch.setattr(tft, "make_train_fn", make_train_fn)
    monkeypatch.setattr(tft, "make_player", make_player)
    with pytest.raises(ValueError, match="different environment"):
        cli.run(["exp=p2e_dv2_finetuning", *RUN, "env.id=continuous_dummy", f"checkpoint.exploration_ckpt_path={ex}"])
    cli.run(["exp=p2e_dv2_finetuning", *RUN, f"checkpoint.exploration_ckpt_path={ex}", "algo.learning_starts=3",
             "algo.total_steps=6", "algo.gamma=0.5", "env.clip_rewards=True", "run_name=ft"])
    assert seen["start"] == want
    assert seen["cfg"].algo.gamma == 0.9 and seen["cfg"].algo.actor.expl_amount == 0.3  # the exploration run's
    assert seen["cfg"].env.clip_rewards is False
    # one env: policy steps 0, 1, 2 act with the exploration actor, 3 on with
    # the task actor (trained by the burst at policy step 3 already)
    assert [a["mirror"] for a in seen["acting"][:3]] == [expl_sum] * 3
    assert all(a["mirror"] == a["task"] != expl_sum for a in seen["acting"][3:]) and len(seen["acting"]) == 6
    assert seen["acting"][0]["task"] == task_sum
    ft = torch.load(last("logs/runs/p2e_dv2_finetuning/*/ft/version_0/checkpoint/*.ckpt"), weights_only=False)
    assert set(ft) >= {"wm", "actor", "critic", "target_critic", "actor_exploration", "opt_states", "rb"}
    assert param_sums({"e": ft["actor_exploration"]})["e"] == expl_sum


def test_cli_chain_and_eval_of_both_phases(capsys):
    cli.run(["exp=p2e_dv2_exploration", *RUN, "dry_run=True", "run_name=ex", "buffer.type=episode"])
    ex = last("logs/runs/p2e_dv2_exploration/*/ex/version_0/checkpoint/*.ckpt")
    state = torch.load(ex, weights_only=False)
    assert set(state["opt_states"]) == {*NAMES, "step"} and "target_critic_exploration" in state
    cli.run(["exp=p2e_dv2_finetuning", *RUN, "dry_run=True", "run_name=ft", f"checkpoint.exploration_ckpt_path={ex}"])
    ft = last("logs/runs/p2e_dv2_finetuning/*/ft/version_0/checkpoint/*.ckpt")
    out = capsys.readouterr().out
    assert "[p2e_dv2_exploration] log_dir=" in out and "[p2e_dv2_finetuning] log_dir=" in out
    for ckpt in (ex, ft):
        cli.evaluation([f"checkpoint_path={ckpt}"])
        assert "Test - Reward:" in capsys.readouterr().out


def test_presets_compose_to_the_jax_packages_algo():
    from torch_offpolicy import configs, within

    for exp, extra in (("p2e_dv2_exploration", []), ("p2e_dv2_finetuning", ["checkpoint.exploration_ckpt_path=x"])):
        jcfg, tcfg = configs(exp, extra)
        within(tcfg.algo.to_dict(), jcfg.algo.to_dict())
        assert tcfg.algo.actor.cls == "sheeprl_tpu_torch.algos.p2e_dv2.agent.Actor"
