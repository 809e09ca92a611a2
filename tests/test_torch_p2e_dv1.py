"""Plan2Explore-DV1 in the PyTorch port against the JAX package, on the CPU,
at the DreamerV1/V2 tests' widths (tests/torch_dreamer.py: dense 8, one MLP
layer, multiplier 2, recurrent 16, stochastic 4, 64x64 frames and a vector
key; three ensemble members predicting the encoder's 72-wide output), from
the same converted parameters:

* one G = 3 exploration burst on the JAX package's own draws, with a
  discrete actor and with the truncated normal: every loss and metric,
  every parameter group (world model, ensembles, task and exploration actor
  and critic) and every optimizer's Adam moments;
* finetuning from an exploration checkpoint: the parameters the run starts
  from are the checkpoint's (no target critic);
* CLI runs of both entry points (the chain through ``cli.run``) and
  ``eval`` of both checkpoints.

Tolerances, with the largest differences measured (``PYTHONPATH=. python
tests/torch_p2e.py``): losses and metrics rel 1e-5 (7.8e-7), parameters
atol 5e-6 (1.5e-6), Adam moments rel 1e-4 of each tensor's largest
(2.3e-5).
"""
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.p2e_dv1 import p2e_dv1_exploration as jexp
from sheeprl_tpu_torch import cli, convert
from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as tdv1
from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_exploration as texp
from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_finetuning as tft
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_finetuning as tft2
from sheeprl_tpu_torch.utils.checkpoint import param_sums
from torch_dreamer import actions_dim, replay_batch
from torch_p2e import dreamer_agents, jax_dreamer_noise, jax_txs, modules_diff, numpy_tree, optimizers_diff

LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-6
ADAM_RTOL = 1e-4
G, T, B = 3, 3, 2
NAMES = ("wm", "ensembles", "actor_task", "critic_task", "actor_exploration", "critic_exploration")


@pytest.fixture(scope="module", params=["discrete", "trunc_normal"])
def burst(request):
    continuous = request.param != "discrete"
    jcfg, tcfg, (wm, actor, critic, ens_apply), params, mods = dreamer_agents("dv1", [], continuous)
    assert mods["ensembles"].out.weight.shape[-1] == mods["wm"].encoder.output_dim == 72
    txs = jax_txs(jcfg, NAMES)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_states = {k: txs[k].init(jparams[k]) for k in NAMES}
    opt0 = numpy_tree(opt_states)
    batch = replay_batch(np.random.default_rng(7), (G, T, B), continuous)
    keys = jax.random.split(jax.random.PRNGKey(8), G)
    train = jexp.make_train_fn(wm, actor, critic, ens_apply, txs, jcfg, continuous, actions_dim(continuous))
    p2, s2, jmetrics = train(jparams, opt_states, jax.tree.map(jnp.asarray, batch), keys)

    optimizers = texp.build_optimizers(tcfg, mods)
    convert.load_p2e_dv1(params, mods, opt0, optimizers)
    ttrain = texp.make_train_fn(mods, optimizers, tcfg, continuous, actions_dim(continuous))
    noise = [jax_dreamer_noise(k, tcfg, continuous, T, B, gaussian=True) for k in keys]
    tmetrics = ttrain({k: torch.from_numpy(v) for k, v in batch.items()}, noise=noise)
    return {"params": numpy_tree(p2), "opt_states": numpy_tree(s2), "jmetrics": numpy_tree(jmetrics), "mods": mods,
            "optimizers": optimizers, "tmetrics": tmetrics}


def test_exploration_burst_losses_and_metrics_match_jax(burst):
    assert set(texp.METRIC_KEYS) == set(burst["jmetrics"])
    for k in texp.METRIC_KEYS:
        np.testing.assert_allclose(burst["tmetrics"][k].numpy(), burst["jmetrics"][k], rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)


def test_exploration_burst_parameters_and_adam_states_match_jax(burst):
    modules_diff(burst["mods"], burst["params"], PARAM_ATOL)
    optimizers_diff(burst["optimizers"], burst["mods"], burst["opt_states"], ADAM_RTOL)
    assert burst["optimizers"].step == G


RUN = ["env=dummy", "env.id=continuous_dummy", "fabric.accelerator=cpu", "algo.dense_units=8", "algo.mlp_layers=1",
       "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=16",
       "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
       "algo.world_model.stochastic_size=4", "algo.per_rank_sequence_length=2", "algo.per_rank_batch_size=2",
       "algo.horizon=3", "buffer.memmap=False", "algo.ensembles.n=3"]


def last(pattern):
    return sorted(glob.glob(pattern), key=lambda p: int(p[:-5].rsplit("_", 1)[1]))[-1]


def test_cli_chain_starts_from_the_checkpoint_and_evals(monkeypatch, capsys):
    cli.run(["exp=p2e_dv1_exploration", *RUN, "dry_run=True", "run_name=ex"])
    ex = last("logs/runs/p2e_dv1_exploration/*/ex/version_0/checkpoint/*.ckpt")
    saved = torch.load(ex, weights_only=False)
    assert set(saved["opt_states"]) == {*NAMES, "step"} and "target_critic_task" not in saved
    want = param_sums({"wm": saved["wm"], "actor": saved["actor_task"], "critic": saved["critic_task"]})
    seen = {}

    def make_train_fn(wm, actor, critic, *args):
        seen["start"] = param_sums({"wm": wm, "actor": actor, "critic": critic})
        return tdv1.make_train_fn(wm, actor, critic, *args)

    monkeypatch.setattr(tft, "make_train_fn", make_train_fn)
    cli.run(["exp=p2e_dv1_finetuning", *RUN, "dry_run=True", "run_name=ft", f"checkpoint.exploration_ckpt_path={ex}"])
    assert seen["start"] == want
    ft = last("logs/runs/p2e_dv1_finetuning/*/ft/version_0/checkpoint/*.ckpt")
    assert "target_critic" not in torch.load(ft, weights_only=False)
    out = capsys.readouterr().out
    assert "[p2e_dv1_exploration] log_dir=" in out and "[p2e_dv1_finetuning] log_dir=" in out
    for ckpt in (ex, ft):
        cli.evaluation([f"checkpoint_path={ckpt}"])
        assert "Test - Reward:" in capsys.readouterr().out


def test_presets_compose_and_finetuning_inherits_the_exploration_algo():
    from torch_offpolicy import configs, within

    for exp, extra in (("p2e_dv1_exploration", []), ("p2e_dv1_finetuning", ["checkpoint.exploration_ckpt_path=x"])):
        jcfg, tcfg = configs(exp, extra)
        within(tcfg.algo.to_dict(), jcfg.algo.to_dict())
        assert tcfg.algo.actor.cls == "sheeprl_tpu_torch.algos.p2e_dv1.agent.Actor"
    assert "layer_norm" not in tft.INHERITED and "layer_norm" in tft2.INHERITED  # as the JAX package's lists
