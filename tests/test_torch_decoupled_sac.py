"""``sac_decoupled`` on two gloo ranks (``fabric.devices=2
fabric.accelerator=cpu``): rank 0's player thread steps all envs into the one
buffer and samples each burst's global ``[G, B, ...]`` batch, which rank 0
scatters by column block; every rank runs SAC's G steps on its columns.
Against the JAX package's ``sac_decoupled`` at ``fabric.devices=2`` on the
same config: every checkpoint's ledger (policy step, gradient steps, the
optimizers' step, the Ratio) and the buffer's layout. The trainers' burst is
SAC's ``make_train_fn``, whose dp=2 burst on a given batch is held against
the JAX package's in tests/test_torch_mesh_steps.py. ``eval`` of the
checkpoint goes through SAC's evaluation; a player thread that raises fails
the run on both ranks, each saying so.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
from pathlib import Path

import pytest
import torch

import torch_mesh_worker as W
from sheeprl_tpu_torch import cli

ARGS = ["exp=sac_decoupled", "env=dummy", "env.id=continuous_dummy", "env.num_envs=4", "algo.hidden_size=16",
        "algo.per_rank_batch_size=8", "algo.learning_starts=16", "algo.total_steps=64", "buffer.size=64",
        "checkpoint.every=32", "buffer.memmap=False", "algo.run_test=False", "fabric.devices=2"]


def _port(tmp_path, run_name, *extra):
    return ARGS + ["fabric.accelerator=cpu", f"run_name={run_name}", f"fabric.rendezvous_dir={tmp_path / 'rdv'}",
                   f"fabric.timeout_s={W.TIMEOUT_S}", *extra]


def _ckpts(root, run_name):
    return {int(p.stem.split("_")[1]): p for p in Path(root, "logs/runs").glob(f"*/*/{run_name}/*/checkpoint/*.ckpt")}


def test_sac_decoupled_trains_with_the_sac_burst():
    from sheeprl_tpu_torch.algos.sac import sac, sac_decoupled

    assert sac_decoupled.make_train_fn is sac.make_train_fn


def test_sac_decoupled_on_two_ranks_keeps_the_jax_ledger_and_evaluates(tmp_path, monkeypatch, capsys):
    from sheeprl_tpu import cli as jax_cli
    from sheeprl_tpu.utils.checkpoint import CheckpointManager as JaxCkpt

    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_cli.run(ARGS + ["run_name=jax"])
    jax_ckpts = {s: JaxCkpt.load(p) for s, p in _ckpts(tmp_path / "jax", "jax").items()}
    monkeypatch.chdir(tmp_path)
    W.run_cli(_port(tmp_path, "port"))
    port = _ckpts(tmp_path, "port")
    assert sorted(port) == sorted(jax_ckpts) == [32, 64]
    for step, j in jax_ckpts.items():
        p = torch.load(port[step], weights_only=False)
        assert p["policy_step"] == j["policy_step"] and p["grad_steps"] == j["cumulative_grad_steps"]
        assert p["opt_states"]["step"] == int(j["opt_states"]["step"]) == p["grad_steps"]
        assert p["ratio"]["_prev"] == pytest.approx(j["ratio"]["_prev"])
        assert p["rb"]["buffer"]["actions"].shape[1:] == j["rb"]["buffer"]["actions"].shape[1:] == (4, 2)
        assert p["rb"]["pos"] == j["rb"]["pos"] and p["world_size"] == 2
    capsys.readouterr()
    cli.evaluation([f"checkpoint_path={port[64]}", "fabric.accelerator=cpu"])
    out = capsys.readouterr().out
    assert "[eval] sac_decoupled through serve/evaluate.py" in out and "Test - Reward:" in out
    assert not torch.distributed.is_initialized()


def test_a_crashed_player_fails_the_run_on_both_ranks(tmp_path, monkeypatch, capfd):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(Exception, match="the player thread crashed"):
        W.run_cli(_port(tmp_path, "crash", "resilience.chaos.enabled=True",
                        "resilience.chaos.player_raise_at_step=40"))
    err = capfd.readouterr().err
    for rank in (0, 1):
        assert f"[sac_decoupled] rank {rank}: the player thread crashed (RuntimeError: chaos: the player thread " \
               "raises at policy step 40)" in err, rank
