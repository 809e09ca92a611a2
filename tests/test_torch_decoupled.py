"""``ppo_decoupled`` on two gloo ranks (``fabric.devices=2
fabric.accelerator=cpu``): rank 0's player thread rolls out all
``env.num_envs`` envs, every rank trains on its slice of each global
minibatch of the broadcast rollout. Against the JAX package's
``ppo_decoupled`` at ``fabric.devices=2`` on the same config: every
checkpoint's ledger (policy step, update, the Adam step count). The trainers'
update is PPO's ``make_update_fn``, whose dp=2 step on a given rollout is
held against the JAX package's in tests/test_torch_mesh_steps.py. ``eval``
of the checkpoint plays a greedy episode through ``serve/evaluate.py``; a
player thread that raises fails the run on both ranks, each saying so.
(``sac_decoupled``: tests/test_torch_decoupled_sac.py.)
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
from pathlib import Path

import pytest
import torch

import torch_mesh_worker as W
from sheeprl_tpu_torch import cli

ARGS = ["exp=ppo_decoupled", "env=dummy", "env.num_envs=4", "algo.rollout_steps=16", "algo.per_rank_batch_size=8",
        "algo.total_steps=256", "checkpoint.every=128", "buffer.memmap=False", "algo.run_test=False",
        "fabric.devices=2"]


def _port(tmp_path, run_name, *extra):
    return ARGS + ["fabric.accelerator=cpu", f"run_name={run_name}", f"fabric.rendezvous_dir={tmp_path / 'rdv'}",
                   f"fabric.timeout_s={W.TIMEOUT_S}", *extra]


def _ckpts(root, run_name):
    return {int(p.stem.split("_")[1]): p for p in Path(root, "logs/runs").glob(f"*/*/{run_name}/*/checkpoint/*.ckpt")}


def test_ppo_decoupled_trains_with_the_ppo_update():
    from sheeprl_tpu_torch.algos.ppo import ppo, ppo_decoupled

    assert ppo_decoupled.make_update_fn is ppo.make_update_fn and ppo_decoupled.rollout_batch is ppo.rollout_batch


def test_ppo_decoupled_on_two_ranks_keeps_the_jax_ledger_and_evaluates(tmp_path, monkeypatch, capsys):
    from sheeprl_tpu import cli as jax_cli
    from sheeprl_tpu.utils.checkpoint import CheckpointManager as JaxCkpt
    from sheeprl_tpu_torch import convert

    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_cli.run(ARGS + ["run_name=jax"])
    jax_ckpts = {s: JaxCkpt.load(p) for s, p in _ckpts(tmp_path / "jax", "jax").items()}
    monkeypatch.chdir(tmp_path)
    W.run_cli(_port(tmp_path, "port"))
    port = _ckpts(tmp_path, "port")
    assert sorted(port) == sorted(jax_ckpts) == [128, 256]
    for step, j in jax_ckpts.items():
        p = torch.load(port[step], weights_only=False)
        assert (p["policy_step"], p["update"], p["last_checkpoint"]) == (j["policy_step"], j["update"],
                                                                         j["last_checkpoint"])
        assert int(p["opt_state"]["state"][0]["step"]) == int(convert.find_state(j["opt_state"]).count)
        assert p["world_size"] == 2 and p["generators"]["player"] is not None
    capsys.readouterr()
    cli.evaluation([f"checkpoint_path={port[256]}", "fabric.accelerator=cpu"])
    out = capsys.readouterr().out
    assert "[eval] ppo_decoupled through serve/evaluate.py" in out and "Test - Reward:" in out
    assert not torch.distributed.is_initialized()


def test_a_crashed_player_fails_the_run_on_both_ranks(tmp_path, monkeypatch, capfd):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(Exception, match="the player thread crashed"):
        W.run_cli(_port(tmp_path, "crash", "resilience.chaos.enabled=True",
                        "resilience.chaos.player_raise_at_step=128"))
    err = capfd.readouterr().err
    for rank in (0, 1):
        assert f"[ppo_decoupled] rank {rank}: the player thread crashed (RuntimeError: chaos: the player thread " \
               "raises at policy step 128)" in err, rank
