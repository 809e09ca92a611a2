"""Plan2Explore-DV3 in the PyTorch port against the JAX package, on the CPU,
at tiny widths (tests/torch_p2e.py: dense 16, two MLP layers, recurrent 8,
stochastic 4x4, 64x64 frames, three ensemble members, two exploration
critics), from the same converted parameters:

* one G = 3 exploration burst (the target EMA due at step 2), coupled and
  with ``decoupled_rssm=True`` (the coupled scan over the decoupled RSSM,
  as the JAX step runs it), on the JAX package's own draws: every loss and
  metric (``Loss/value_loss_exploration_<name>`` per critic), every
  parameter group (world model, ensembles, task actor, critic and target,
  exploration actor, each exploration critic and its target), the task
  Moments and each exploration critic's, every optimizer's Adam moments and
  the step counter;
* the exploration step with ``pallas_gru=True`` reaches no LN-GRU kernel
  and prints no UNUSED line;
* finetuning: the CLI's surgery (the env keys copied, another ``env.id``
  refused) and the ``algo`` keys the run inherits; the parameters it starts
  from are the exploration checkpoint's; the player acts with the
  exploration actor before ``learning_starts`` and with the task actor
  from there; its first burst with ``decoupled_rssm=True
  pallas_gru=interpret`` (on the CPU, the plain versions of the LN-GRU
  kernels) equals the JAX package's DreamerV3 burst on the same converted
  weights, Moments, batch and draws;
* CLI runs of both entry points (the exploration→finetuning chain through
  ``cli.run``), ``eval`` of both checkpoints, and a resumed finetuning run
  that acts with the task actor from its first step.

Tolerances, with the largest differences measured (``PYTHONPATH=. python
tests/torch_p2e.py``): losses and metrics rel 1e-4 (7.2e-7; the
finetuning burst 3.4e-7), parameters atol 5e-6 (9.5e-7; the finetuning
burst 2.4e-7; an Adam step moves a weight by at most lr, 1e-4 here),
Moments atol 1e-5 (9.5e-7), Adam moments rel 1e-4 of each tensor's
largest (3.2e-5).
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.utils import MomentsState as JMoments
from sheeprl_tpu.algos.p2e_dv3 import p2e_dv3_exploration as jexp
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.optim import clipped as jax_clipped
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu_torch import cli, convert
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
from sheeprl_tpu_torch.algos.dreamer_v3.utils import MomentsState, check_precision
from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as texp
from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_finetuning as tft
from sheeprl_tpu_torch.config import compose as torch_compose
from sheeprl_tpu_torch.ops import ln_gru
from sheeprl_tpu_torch.utils.checkpoint import param_sums
from torch_p2e import (N_ACT, TINY_DV3, dv3_agents, dv3_batch, dv3_spaces, jax_dv3_noise, jax_txs, moments_diff,
                       modules_diff, numpy_tree, optimizers_diff)

LOSS_RTOL = 1e-4
PARAM_ATOL = 5e-6
MOMENTS_ATOL = 1e-5
ADAM_RTOL = 1e-4
G, T, B = 3, 4, 2
DEC = ["algo.world_model.decoupled_rssm=True"]


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=["coupled", "decoupled"])
def burst(request):
    """One exploration burst on both sides from the same state."""
    jcfg, tcfg, (wm, actor, critic, ens_apply), params, mods = dv3_agents([] if request.param == "coupled" else DEC)
    names = list(jcfg.algo.critics_exploration.keys())
    assert names == ["intrinsic", "extrinsic"]
    txs = jax_txs(jcfg, ["wm", "ensembles", "actor_task", "critic_task", "actor_exploration"])
    txs["critics_exploration"] = jax_clipped(jax_instantiate(jcfg.algo.critic.optimizer), jcfg.algo.critic.clip_gradients)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_states = {k: txs[k].init(jparams[k]) for k in ("wm", "ensembles", "actor_task", "critic_task",
                                                       "actor_exploration")}
    opt_states["critics_exploration"] = {k: txs["critics_exploration"].init(jparams["critics_exploration"][k]["critic"])
                                         for k in names}
    opt_states["step"] = jnp.zeros((), jnp.int32)
    opt0 = numpy_tree(opt_states)
    # Moments already under way (the converter carries each critic's)
    moments = {"task": JMoments(jnp.asarray(0.2), jnp.asarray(1.3)),
               "exploration": {k: JMoments(jnp.asarray(-0.1 * i), jnp.asarray(0.9 + i)) for i, k in enumerate(names)}}
    moments0 = convert.load_moments(numpy_tree(moments))
    batch = dv3_batch(np.random.default_rng(7), G, T, B)
    keys = jax.random.split(jax.random.PRNGKey(8), G)
    train = jexp.make_train_fn(wm, actor, critic, ens_apply, txs, jcfg, False, [N_ACT])
    p2, s2, m2, jmetrics = train(jparams, opt_states, moments, jax.tree.map(jnp.asarray, batch), keys)

    optimizers = texp.build_optimizers(tcfg, mods)
    convert.load_p2e_dv3(params, mods, opt0, optimizers)
    ttrain = texp.make_train_fn(mods, optimizers, tcfg, False, [N_ACT])
    noise = [jax_dv3_noise(k, tcfg, T, B) for k in keys]
    tm, tmetrics = ttrain(moments0, to_torch(batch), noise=noise)
    return {"jcfg": jcfg, "tcfg": tcfg, "params": numpy_tree(p2), "opt_states": numpy_tree(s2),
            "moments": numpy_tree(m2), "jmetrics": numpy_tree(jmetrics), "mods": mods, "optimizers": optimizers,
            "tmoments": tm, "tmetrics": tmetrics}


def test_exploration_burst_losses_and_metrics_match_jax(burst):
    keys = texp.metric_keys(burst["tcfg"])
    assert set(keys) == set(burst["jmetrics"]) and "Loss/value_loss_exploration_intrinsic" in keys
    for k in keys:
        np.testing.assert_allclose(burst["tmetrics"][k].numpy(), burst["jmetrics"][k], rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)


def test_exploration_burst_parameters_match_jax(burst):
    mods = burst["mods"]
    modules_diff(mods, burst["params"], PARAM_ATOL)
    # the EMA at step 2 took each critic after two updates, not the third
    for c, t_ in ((mods["critic_task"], mods["target_critic_task"]),
                  *((v["critic"], v["target"]) for v in mods["critics_exploration"].values())):
        assert max(float((a - b).detach().abs().max()) for a, b in zip(c.parameters(), t_.parameters())) > 1e-7


def test_exploration_burst_moments_and_adam_states_match_jax(burst):
    tm, jm = burst["tmoments"], burst["moments"]
    assert moments_diff(tm["task"], jm["task"]) <= MOMENTS_ATOL
    for k in ("intrinsic", "extrinsic"):
        assert moments_diff(tm["exploration"][k], jm["exploration"][k]) <= MOMENTS_ATOL, k
        assert float(tm["exploration"][k].high) != 0.0
    optimizers_diff(burst["optimizers"], burst["mods"], burst["opt_states"], ADAM_RTOL)
    assert burst["optimizers"].step == int(burst["opt_states"]["step"]) == G


def test_exploration_step_reaches_no_ln_gru_kernel(monkeypatch, capsys):
    """With decoupled_rssm=True pallas_gru=True the step runs the coupled
    scan, as the JAX step does, and says nothing about pallas_gru."""

    def refuse(*args, **kwargs):
        raise AssertionError("the exploration step reached an LN-GRU kernel")

    monkeypatch.setattr(ln_gru, "gru_sequence", refuse)
    _, tcfg, _, _, mods = dv3_agents(DEC + ["algo.world_model.pallas_gru=True"])
    train = texp.make_train_fn(mods, texp.build_optimizers(tcfg, mods), tcfg, False, [N_ACT])
    _, metrics = train(texp.init_p2e_moments(tcfg), to_torch(dv3_batch(np.random.default_rng(1), 1, T, B)),
                       generator=torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert "UNUSED" not in capsys.readouterr().err


# ---------------------------------------------------------------- finetuning

# metric.log_level=0: no telemetry stream, whose count of a first burst's
# operations runs in Python op by op (the stream is tested elsewhere)
TINY_RUN = TINY_DV3 + ["fabric.accelerator=cpu", "env.num_envs=2", "buffer.memmap=False", "algo.run_test=False",
                       "metric.log_level=0"]


@pytest.fixture(scope="module")
def explored(tmp_path_factory):
    """A CLI exploration run (decoupled, pallas_gru=True), its checkpoints and
    log dir: (cwd, checkpoints)."""
    cwd = tmp_path_factory.mktemp("p2e_dv3")
    old = os.getcwd()
    os.chdir(cwd)
    try:
        cli.run(["exp=p2e_dv3_exploration", *TINY_RUN, *DEC, "algo.world_model.pallas_gru=True",
                 "algo.learning_starts=8", "algo.total_steps=16", "checkpoint.every=8", "run_name=ex"])
    finally:
        os.chdir(old)
    ckpts = sorted(glob.glob(str(cwd / "logs/runs/p2e_dv3_exploration/*/ex/version_0/checkpoint/*.ckpt")),
                   key=lambda p: int(p[:-5].rsplit("_", 1)[1]))
    return cwd, ckpts


def finetuning_cfg(ckpt, extra=()):
    return torch_compose("config", ["exp=p2e_dv3_finetuning", *TINY_RUN, f"checkpoint.exploration_ckpt_path={ckpt}",
                                    *extra])


def test_cli_surgery_copies_env_and_algo_keys_and_refuses_another_env(explored):
    _, ckpts = explored
    cfg = finetuning_cfg(ckpts[-1], ["env.screen_size=32", "env.clip_rewards=True", "env.frame_stack_dilation=3",
                                     "env.max_episode_steps=7", "algo.world_model.decoupled_rssm=False",
                                     "algo.gamma=0.5"])
    exploration_cfg = cli.exploration_surgery(cfg)
    assert (cfg.env.screen_size, cfg.env.clip_rewards, cfg.env.frame_stack_dilation) == (64, False, 1)
    assert cfg.env.max_episode_steps == 7  # the exploration run's is null: nothing to copy, as in the JAX package
    tft.inherit_exploration_algo(cfg, exploration_cfg)
    assert cfg.algo.world_model.decoupled_rssm is True and cfg.algo.world_model.pallas_gru is True
    assert cfg.algo.gamma == exploration_cfg.algo.gamma != 0.5
    assert cfg.algo.name == "p2e_dv3_finetuning" and cfg.algo.learning_starts == 65536
    with pytest.raises(ValueError, match="different environment"):
        cli.exploration_surgery(finetuning_cfg(ckpts[-1], ["env.id=continuous_dummy"]))
    with pytest.raises(FileNotFoundError, match="config"):
        cli.exploration_surgery(finetuning_cfg("nowhere/checkpoint/ckpt_1.ckpt"))


class Recorder:
    """The actor the finetuning player acts with at each env step (the
    float64 sum of the mirror's copy) and the modules its train step is
    built on."""

    def __init__(self, monkeypatch):
        self.acting, self.start = [], None
        stepper = tdv3.DV3Stepper
        rec = self

        class Recording(stepper):
            def __call__(self, sink):
                actor = self.mirror.current()["actor"]
                rec.acting.append((self.p_step, param_sums({"a": actor})["a"]))
                return super().__call__(sink)

        def make_train_fn(wm, actor, critic, target_critic, *args):
            rec.start = param_sums({"wm": wm, "actor": actor, "critic": critic, "target_critic": target_critic})
            return tdv3.make_train_fn(wm, actor, critic, target_critic, *args)

        monkeypatch.setattr(texp, "DV3Stepper", Recording)
        monkeypatch.setattr(tft, "make_train_fn", make_train_fn)


def test_finetuning_starts_from_the_checkpoint_and_switches_actor_at_learning_starts(explored, monkeypatch, capsys):
    _, ckpts = explored
    saved = torch.load(ckpts[-1], weights_only=False)
    want = param_sums({"wm": saved["wm"], "actor": saved["actor_task"], "critic": saved["critic_task"],
                       "target_critic": saved["target_critic_task"]})
    expl_sum = param_sums({"a": saved["actor_exploration"]})["a"]
    task_sum = want["actor"]
    assert expl_sum != task_sum
    rec = Recorder(monkeypatch)
    cli.run(["exp=p2e_dv3_finetuning", *TINY_RUN, f"checkpoint.exploration_ckpt_path={ckpts[-1]}",
             "algo.learning_starts=8", "algo.total_steps=16", "checkpoint.every=12", "run_name=ft"])
    assert "UNUSED" not in capsys.readouterr().err
    assert rec.start == want
    before = [s for p, s in rec.acting if p < 8]
    after = [(p, s) for p, s in rec.acting if p >= 8]
    assert before and all(s == expl_sum for s in before)
    assert after[0] == (8, task_sum)  # the task actor from learning_starts, before any update
    assert all(s != expl_sum for _, s in after)
    # a run resumed past learning_starts acts with the task actor from its first step
    mid = sorted(glob.glob("logs/runs/p2e_dv3_finetuning/*/ft/version_0/checkpoint/ckpt_12.ckpt"))[0]
    state = torch.load(mid, weights_only=False)
    rec.acting.clear()
    cli.run(["exp=p2e_dv3_finetuning", *TINY_RUN, f"checkpoint.exploration_ckpt_path={ckpts[-1]}",
             "algo.learning_starts=8", "algo.total_steps=20", f"checkpoint.resume_from={mid}", "run_name=ft"])
    assert rec.acting[0] == (12, param_sums({"a": state["actor"]})["a"])
    last = torch.load(sorted(glob.glob("logs/runs/p2e_dv3_finetuning/*/ft/version_*/checkpoint/ckpt_20.ckpt"))[0],
                      weights_only=False)
    assert last["policy_step"] == 20 and last["opt_states"]["step"] > state["opt_states"]["step"]


def test_finetuning_first_burst_matches_jax_dreamer_v3(tmp_path, monkeypatch):
    """The finetuning phase's set-up from an exploration checkpoint holding
    the converted JAX parameters and task Moments, then one burst with
    decoupled_rssm=True pallas_gru=interpret, against the JAX package's
    DreamerV3 burst from the same parameters, Moments, batch and draws."""
    from sheeprl_tpu.algos.dreamer_v3 import dreamer_v3 as jdv3
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jdv3_build
    from test_torch_dreamer_v3 import jax_train_noise
    from torch_offpolicy import dist

    _, _, _, params, mods = dv3_agents(DEC)
    ckpt = tmp_path / "ckpt_8.ckpt"
    torch.save({**{k: m.state_dict() for k, m in mods.items()},
                "moments": {"task": {"low": torch.tensor(0.25), "high": torch.tensor(1.75)},
                            "exploration": {k: {"low": torch.tensor(0.0), "high": torch.tensor(0.0)}
                                            for k in mods["critics_exploration"]}}}, ckpt)
    over = [*TINY_DV3, *DEC, "algo.world_model.pallas_gru=interpret", f"checkpoint.exploration_ckpt_path={ckpt}"]
    tcfg = torch_compose("config", ["exp=p2e_dv3_finetuning", *over, "fabric.accelerator=cpu"])
    jcfg = jax_compose("config", ["exp=p2e_dv3_finetuning", *over])
    batch = dv3_batch(np.random.default_rng(9), 1, T, B)
    key = jax.random.split(jax.random.PRNGKey(10), 1)

    jo, to = dv3_spaces()
    state = {"wm": params["wm"], "actor": params["actor_task"], "critic": params["critic_task"],
             "target_critic": params["target_critic_task"]}
    wm, actor, critic, jp = jdv3_build(dist(), jcfg, jo, [N_ACT], False, jax.random.PRNGKey(0), state)
    txs, opt_states = jdv3.build_optimizers(jcfg, jp)
    jtrain = jdv3.make_train_fn(wm, actor, critic, txs, jcfg, False, [N_ACT])
    p2, _, m2, jmetrics = jtrain(jp, opt_states, JMoments(jnp.asarray(0.25), jnp.asarray(1.75)),
                                 jax.tree.map(jnp.asarray, batch), key)

    noise = jax_train_noise(key[0], tcfg, coupled=False)
    monkeypatch.setattr(tdv3, "draw_train_noise", lambda *args, **kwargs: noise)
    parts = tft._setup(tcfg, torch.device("cpu"), check_precision(tcfg), to, [N_ACT], False, None)
    assert isinstance(parts.named["actor_exploration"], torch.nn.Module) and parts.random_warmup is False
    tmetrics = parts.train(to_torch(batch), torch.Generator())
    for k in tdv3.METRIC_KEYS:
        np.testing.assert_allclose(float(tmetrics[k][0]), float(np.asarray(jmetrics[k])[0]), rtol=LOSS_RTOL,
                                   err_msg=k)
    p2 = numpy_tree(p2)
    modules_diff({k: parts.named[k] for k in ("wm", "actor", "critic", "target_critic")}, p2, PARAM_ATOL)
    moments = MomentsState(*numpy_tree(m2))
    m = parts.algo_state()["moments"]
    assert abs(float(m["low"]) - float(moments.low)) <= MOMENTS_ATOL
    assert abs(float(m["high"]) - float(moments.high)) <= MOMENTS_ATOL
    assert float(m["high"]) != 1.75  # moved from the checkpoint's


def test_cli_chain_and_eval_of_both_phases(capsys):
    """exploration → finetuning through ``cli.run`` (dry runs), then ``eval``
    of each phase's checkpoint: the task actor's greedy episode."""
    cli.run(["exp=p2e_dv3_exploration", *TINY_RUN, "dry_run=True", "algo.per_rank_sequence_length=2",
             "run_name=ex"])
    ex = sorted(glob.glob("logs/runs/p2e_dv3_exploration/*/ex/version_0/checkpoint/*.ckpt"))[-1]
    state = torch.load(ex, weights_only=False)
    assert set(state["critics_exploration"]) >= {"intrinsic.critic.out.weight", "extrinsic.target.out.weight"}
    assert set(state["opt_states"]["critics_exploration"]) == {"intrinsic", "extrinsic"}
    assert set(state["moments"]["exploration"]) == {"intrinsic", "extrinsic"} and state["opt_states"]["step"] > 0
    cli.run(["exp=p2e_dv3_finetuning", *TINY_RUN, "dry_run=True", "algo.per_rank_sequence_length=2",
             "run_name=ft", f"checkpoint.exploration_ckpt_path={ex}"])
    ft = sorted(glob.glob("logs/runs/p2e_dv3_finetuning/*/ft/version_0/checkpoint/*.ckpt"))[-1]
    out = capsys.readouterr().out
    assert "[p2e_dv3_exploration] log_dir=" in out and "[p2e_dv3_finetuning] log_dir=" in out
    for ckpt in (ex, ft):
        cli.evaluation([f"checkpoint_path={ckpt}"])
        assert "Test - Reward:" in capsys.readouterr().out


def test_entry_points_refuse_a_missing_card_and_compose_the_presets():
    from sheeprl_tpu_torch.utils.registry import algorithm_registry, evaluation_registry
    from torch_offpolicy import configs, within

    cli._register()
    for name in ("p2e_dv3_exploration", "p2e_dv3_finetuning"):
        assert name in algorithm_registry and name in evaluation_registry
    assert algorithm_registry["p2e_dv3_finetuning"]["requires_exploration_cfg"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="fabric.accelerator=cpu"):
            cli.run(["exp=p2e_dv3_exploration", *TINY_DV3, "dry_run=True"])
    for exp, extra in (("p2e_dv3_exploration", []), ("p2e_dv3_finetuning", ["checkpoint.exploration_ckpt_path=x"]),
                       ("p2e_dv3_expl_L_doapp_128px_gray_combo_discrete_15Mexpl_20Mstps", []),
                       ("p2e_dv3_fntn_L_doapp_64px_gray_combo_discrete_5Mstps", ["checkpoint.exploration_ckpt_path=x"])):
        jcfg, tcfg = configs(exp, extra)
        within(tcfg.algo.to_dict(), jcfg.algo.to_dict())
        assert tcfg.env.id == jcfg.env.id and tcfg.select("buffer.load_from_exploration") == jcfg.select(
            "buffer.load_from_exploration")
