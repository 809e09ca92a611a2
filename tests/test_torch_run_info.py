"""The port's ``utils/run_info.py`` (``last_run``, ``mark_steady``) and its
call sites, held against the JAX package's:

* a PPO and a DreamerV3 dry run on the CPU (tiny widths, ``env=dummy``)
  leave ``steady_step`` inside the run, ``steady_t`` and the run's
  ``log_dir``;
* ``algo.max_wall_time_s`` leaves ``wall_capped`` with the step where the run
  stopped, short of ``total_steps``; a preemption leaves ``preempted``;
* after the same PPO dry run on each package, the port's ``last_run`` has
  the JAX package's keys.

``last_run`` is one dict per process, and under ``--dist loadfile`` test
files share interpreters: each test clears it first and leaves it cleared."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import os
import time

import pytest

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.resilience.preemption import clear_preemption
from sheeprl_tpu_torch.utils import run_info

PPO = ["exp=ppo", "env=dummy", "fabric.accelerator=cpu", "env.num_envs=2", "algo.rollout_steps=16",
       "algo.per_rank_batch_size=16", "algo.update_epochs=1", "buffer.memmap=False", "algo.run_test=False"]
DV3 = ["exp=dreamer_v3", "env=dummy", "fabric.accelerator=cpu", "algo=dreamer_v3_XS", "env.num_envs=2",
       "algo.per_rank_sequence_length=2", "algo.per_rank_batch_size=2", "algo.dense_units=8",
       "algo.world_model.recurrent_model.recurrent_state_size=8",
       "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.run_test=False", "buffer.memmap=False"]


@pytest.fixture(autouse=True)
def _clear_last_run():
    run_info.last_run.clear()
    clear_preemption()
    yield
    run_info.last_run.clear()
    clear_preemption()


@pytest.mark.parametrize("args,total", [(PPO + ["algo.total_steps=96"], 96),
                                        (DV3 + ["algo.learning_starts=8", "algo.total_steps=16"], 16)],
                         ids=["ppo", "dreamer_v3"])
def test_a_run_marks_its_steady_state_and_log_dir(args, total):
    t0 = time.perf_counter()
    cli.run(args + ["run_name=steady"])
    last = run_info.last_run
    assert 0 < last["steady_step"] <= total, last
    assert t0 < last["steady_t"] < time.perf_counter()
    assert os.path.isfile(os.path.join(last["log_dir"], "telemetry.jsonl")), last
    assert "wall_capped" not in last and "preempted" not in last  # a run that completes records no stop


def test_the_wall_cap_records_where_the_run_stopped():
    # the serial loop asks after each update: a spent budget stops it after the first
    cli.run(PPO + ["algo.total_steps=100000", "algo.max_wall_time_s=1e-9", "algo.overlap.enabled=False",
                   "run_name=capped"])
    last = run_info.last_run
    assert last["wall_capped"] is True and last["total_steps"] == 100000
    assert last["policy_step"] == last["steady_step"] == 32, last  # one rollout of 16 steps on 2 envs


def test_a_preemption_records_preempted():
    cli.run(PPO + ["algo.total_steps=128", "checkpoint.every=10000", "run_name=preempted",
                   "resilience.preemption.poll_every_s=0.0",
                   "+resilience.preemption.poller._target_=sheeprl_tpu_torch.resilience.preemption.CountdownPoller",
                   "+resilience.preemption.poller.n=3"])
    last = run_info.last_run
    assert last["preempted"] is True and last["total_steps"] == 128
    assert 0 < last["policy_step"] < 128, last
    assert "wall_capped" not in last


def test_last_run_has_the_jax_packages_keys_after_the_same_ppo_run():
    from sheeprl_tpu import cli as jcli
    from sheeprl_tpu.utils import run_info as jrun_info

    same = ["exp=ppo", "env=dummy", "dry_run=True", "env.num_envs=2", "buffer.memmap=False", "algo.run_test=False",
            "run_name=keys"]
    jrun_info.last_run.clear()
    try:
        jcli.run(same)
        jax_keys = set(jrun_info.last_run)
    finally:
        jrun_info.last_run.clear()
    cli.run(same + ["fabric.accelerator=cpu"])
    assert {"steady_step", "steady_t", "log_dir"} <= jax_keys
    assert set(run_info.last_run) == jax_keys
