"""PPO and SAC trained on two gloo ranks (``fabric.devices=2
fabric.accelerator=cpu``) against the JAX package's loops at
``fabric.devices=2`` on the same configs: every checkpoint's ledger (policy
step, update or gradient steps, the optimizers' step counts, the Ratio's
state), a checkpoint written by rank 0 only.

PPO runs as users launch it, ``python -m sheeprl_tpu_torch run ...`` in a
child process (its own session, killed past a deadline); SAC through the
CLI's launch in this process (its ranks spawned and bounded). SAC's JAX loop
runs serially: its overlapped loop takes whatever packets are ready, so its
checkpoints land where its takes do, while the port's takes one packet an
iteration on N ranks, which puts them where the serial loop's are.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import torch_mesh_worker as W

REPO = Path(__file__).resolve().parents[1]
PPO = ["exp=ppo", "env=dummy", "env.num_envs=4", "algo.rollout_steps=16", "algo.per_rank_batch_size=8",
       "algo.total_steps=256", "checkpoint.every=128", "buffer.memmap=False", "algo.run_test=False",
       "algo.normalize_advantages=True", "fabric.devices=2"]
SAC = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "env.num_envs=4", "algo.hidden_size=16",
       "algo.per_rank_batch_size=8", "algo.learning_starts=16", "algo.total_steps=64", "buffer.size=64",
       "checkpoint.every=32", "buffer.memmap=False", "algo.run_test=False", "fabric.devices=2"]


def _jax_run(args, tmp_path, monkeypatch):
    from sheeprl_tpu import cli as jax_cli
    from sheeprl_tpu.utils.checkpoint import CheckpointManager as JaxCkpt

    tmp_path.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(tmp_path)
    jax_cli.run(args + ["run_name=jax"])
    return {int(p.stem.split("_")[1]): JaxCkpt.load(p) for p in Path("logs/runs").glob("*/*/jax/*/checkpoint/*.ckpt")}


def _port_ckpts(tmp_path):
    return {int(p.stem.split("_")[1]): torch.load(p, weights_only=False)
            for p in Path(tmp_path, "logs/runs").glob("*/*/port/*/checkpoint/*.ckpt")}


def _adam_count(opt_state):
    from sheeprl_tpu_torch import convert

    return int(convert.find_state(opt_state).count)


def test_ppo_on_two_ranks_from_the_command_line_keeps_the_jax_ledger(tmp_path, monkeypatch):
    jax_ckpts = _jax_run(PPO, tmp_path / "jax", monkeypatch)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    cmd = [sys.executable, "-m", "sheeprl_tpu_torch", "run", *PPO, "fabric.accelerator=cpu", "run_name=port",
           f"fabric.rendezvous_dir={tmp_path / 'rdv'}", f"fabric.timeout_s={W.TIMEOUT_S}"]
    proc = subprocess.Popen(cmd, cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=W.DEADLINE_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the launcher and its ranks
        out, err = proc.communicate()
        pytest.fail(f"the two-rank run did not end within {W.DEADLINE_S} s; its stderr ends with:\n{err[-3000:]}")
    assert proc.returncode == 0, err[-3000:]
    assert out.count("[ppo] log_dir=") == 1  # rank 0 alone
    port = _port_ckpts(tmp_path)
    assert sorted(port) == sorted(jax_ckpts) == [128, 256]
    for step, j in jax_ckpts.items():
        p = port[step]
        assert (p["policy_step"], p["update"], p["last_checkpoint"]) == (j["policy_step"], j["update"],
                                                                         j["last_checkpoint"])
        assert int(p["opt_state"]["state"][0]["step"]) == _adam_count(j["opt_state"]) == 40 * j["update"]  # 4 global minibatches × 10 epochs
        assert p["world_size"] == 2
    assert not list((tmp_path / "rdv").iterdir())


def test_sac_on_two_ranks_keeps_the_jax_ledger(tmp_path, monkeypatch):
    jax_ckpts = _jax_run(SAC + ["algo.overlap.enabled=False"], tmp_path / "jax", monkeypatch)
    monkeypatch.chdir(tmp_path)
    W.run_cli(SAC + ["fabric.accelerator=cpu", "run_name=port", f"fabric.rendezvous_dir={tmp_path / 'rdv'}",
                     f"fabric.timeout_s={W.TIMEOUT_S}"])
    port = _port_ckpts(tmp_path)
    assert sorted(port) == sorted(jax_ckpts) == [32, 64]
    for step, j in jax_ckpts.items():
        p = port[step]
        assert p["policy_step"] == j["policy_step"] and p["grad_steps"] == j["cumulative_grad_steps"]
        assert p["opt_states"]["step"] == int(j["opt_states"]["step"]) == p["grad_steps"]
        assert p["ratio"]["_prev"] == pytest.approx(j["ratio"]["_prev"])
        # the whole buffer, the JAX package's env layout: the ranks' blocks side by side
        assert p["rb"]["buffer"]["actions"].shape[1:] == j["rb"]["buffer"]["actions"].shape[1:] == (4, 2)
        assert p["rb"]["pos"] == j["rb"]["pos"]
    assert port[64]["grad_steps"] == 24
