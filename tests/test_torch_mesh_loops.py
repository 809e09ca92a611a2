"""DreamerV3 trained on two gloo ranks (``fabric.devices=2
fabric.accelerator=cpu``), overlapped (the default) and serial, against the
JAX package's ledger at ``fabric.devices=2``; a checkpoint written by rank 0
and ``checkpoint.resume_from`` on two ranks continuing the ledger.

The JAX package's loop calls its ``Ratio`` once per vector-env step of
``env.num_envs`` steps with ``policy_step / world_size``
(``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py:896``); the expected ledger
here is that call sequence on the JAX package's own ``Ratio``. (The JAX
loop itself, run once on this config at ``fabric.devices=2``, ended at
policy step 48 with 16 gradient steps and ``_prev`` 24.0; its overlapped
loop checkpoints wherever its takes land, so its checkpoint steps are not a
ledger. The port's overlapped loop takes one packet an iteration on N ranks,
so its checkpoints land where the serial loop's do.) A run of the JAX loop
costs about 50 s of compilation, which this file cannot afford.

Each checkpoint holds the whole buffer, gathered by env block (4 envs, the
JAX package's layout), the world size and each rank's generators; only rank
0 writes the log directory's files; the startup record names the gloo
backend and two ranks, the ``log`` records the collectives; no process group
and no rendezvous file outlive a run; a checkpoint of two ranks refuses a
resume on one.
"""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import json
from pathlib import Path

import pytest
import torch

import torch_mesh_worker as W
from sheeprl_tpu.utils.utils import Ratio as JaxRatio

TINY_DV3 = ["exp=dreamer_v3", "algo=dreamer_v3_XS", "env=dummy", "env.id=discrete_dummy",
            "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=4", "algo.horizon=3", "algo.dense_units=16",
            "algo.world_model.encoder.cnn_channels_multiplier=2",
            "algo.world_model.recurrent_model.recurrent_state_size=8",
            "algo.world_model.recurrent_model.dense_units=16", "algo.world_model.transition_model.hidden_size=16",
            "algo.world_model.representation_model.hidden_size=16", "algo.world_model.discrete_size=4",
            "algo.world_model.stochastic_size=4", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[]",
            "algo.world_model.decoupled_rssm=True", "algo.world_model.pallas_gru=True"]
NUM_ENVS, LEARNING_STARTS = 4, 16


def _args(tmp_path, run_name, total, *extra):
    return TINY_DV3 + ["fabric.accelerator=cpu", "fabric.devices=2", f"fabric.rendezvous_dir={tmp_path / 'rdv'}",
                       f"fabric.timeout_s={W.TIMEOUT_S}", f"env.num_envs={NUM_ENVS}", "buffer.size=64",
                       f"algo.learning_starts={LEARNING_STARTS}", f"algo.total_steps={total}", "checkpoint.every=16",
                       "metric.log_every=16", "buffer.memmap=False", "algo.run_test=False", f"run_name={run_name}",
                       *extra]


def jax_ledger(total, start=0, ratio_state=None, world=2):
    """{policy step: (gradient steps so far, Ratio state)} of the JAX loop's
    call sequence."""
    ratio = JaxRatio(1.0)
    if ratio_state is not None:
        ratio.load_state_dict(ratio_state)
    out, grads = {}, 0
    for step in range(start + NUM_ENVS, total + 1, NUM_ENVS):
        if step >= LEARNING_STARTS:
            grads += ratio(step / world)
        out[step] = (grads, ratio.state_dict())
    return out


def _ckpts(tmp_path, run_name):
    run = next(Path("logs/runs/dreamer_v3").glob(f"*/{run_name}/version_0"))
    return run, {int(p.stem.split("_")[1]): torch.load(p, weights_only=False)
                 for p in (run / "checkpoint").glob("ckpt_*.ckpt")}


def _check(ckpts, ledger, grads0=0):
    for step, s in ckpts.items():
        grads, ratio = ledger[step]
        assert s["policy_step"] == step
        assert s["opt_states"]["step"] == grads0 + grads, step
        assert s["ratio"]["_prev"] == pytest.approx(ratio["_prev"]), step
        assert s["world_size"] == 2 and len(s["rank_generators"]) == 2
        assert len(s["rb"]["buffers"]) == NUM_ENVS and len(s["rb"]["rank_rngs"]) == 2


@pytest.mark.parametrize("loop", ["overlapped", "serial"])
def test_dreamer_v3_on_two_ranks_keeps_the_jax_ledger(loop, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    extra = [] if loop == "overlapped" else ["algo.overlap.enabled=False"]
    W.run_cli(_args(tmp_path, loop, 48, *extra))
    run, ckpts = _ckpts(tmp_path, loop)
    assert sorted(ckpts) == [16, 32, 48]
    _check(ckpts, jax_ledger(48))
    assert ckpts[48]["opt_states"]["step"] == 16 and ckpts[48]["ratio"]["_prev"] == 24.0
    # one buffer's rows per env, the same on every env of both blocks
    assert [b["pos"] for b in ckpts[48]["rb"]["buffers"]] == [14] * NUM_ENVS
    events = [json.loads(l) for l in open(run / "telemetry.jsonl")]
    startup = events[0]
    assert startup["event"] == "startup" and startup["world_size"] == 2 and startup["backend"] == "gloo"
    logs = [e for e in events if e["event"] == "log"]
    assert logs and logs[-1]["collectives"]["all_reduce"] > 0 and logs[-1]["collectives"]["world_size"] == 2
    assert sorted(p.name for p in run.iterdir() if p.name.startswith("memmap")) == []
    assert not torch.distributed.is_initialized() and not list((tmp_path / "rdv").iterdir())


def test_dreamer_v3_resumes_on_two_ranks_and_refuses_one(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    W.run_cli(_args(tmp_path, "first", 32, "algo.overlap.enabled=False"))
    _, first = _ckpts(tmp_path, "first")
    ckpt = next(Path("logs/runs/dreamer_v3").glob("*/first/version_0/checkpoint/ckpt_32.ckpt"))
    W.run_cli(_args(tmp_path, "resumed", 64, "algo.overlap.enabled=False", f"checkpoint.resume_from={ckpt}"))
    _, resumed = _ckpts(tmp_path, "resumed")
    assert sorted(resumed) == [48, 64]
    _check(resumed, jax_ledger(64, 32, first[32]["ratio"]), grads0=first[32]["opt_states"]["step"])
    assert resumed[64]["opt_states"]["step"] == 24
    # a resume keeps the saved run's fabric.devices; a checkpoint of two
    # ranks handed to one rank is refused
    from sheeprl_tpu_torch.config import Config
    from sheeprl_tpu_torch.parallel import mesh

    one = mesh.build_distributed(Config({"fabric": {"devices": 1, "accelerator": "cpu"}}))
    with pytest.raises(NotImplementedError, match="written on 2 ranks and this run has 1"):
        mesh.rank_resume(first[32], one)
