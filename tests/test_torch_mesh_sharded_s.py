"""DreamerV3 at the S preset's widths with its parameters sharded over four
gloo ranks at ``(1,4,1)``, the pure-FSDP mesh users run: one launch
(``torch_mesh_worker.dv3_sharded_steps``) takes one train step laid out as
``dreamer_v3.main`` lays it out, while this process takes the JAX package's
step (its parameters replicated, as tests/test_torch_mesh_sharded.py holds
every mesh) from the same converted parameters, global batch and draws.

Cut in length only: T = 4, a global batch of 4 columns (one a rank), the
imagination horizon 3; the widths are ``algo=dreamer_v3_S``'s (dense 512,
GRU 512, CNN multiplier 32, 32 × 32 latents). Decoupled on the LN-GRU
sequence (``pallas_gru=True``: the plain versions here, on the fused weight
gathered for the call; the JAX package's interpret-mode Pallas kernels), as
on the card; the imagination's GRU cell is gathered at each of its steps.
The engine's default ``min_shard_size``. Each rank's parameter and gradient bytes at
rest equal the ``params`` report's ``bytes_per_chip`` (a quarter of the
big leaves), and no more whole-copy bytes are held at once than the
largest unit's. The step matches the JAX step at
tests/test_torch_mesh_sharded.py's tolerances in its metrics, Moments and
Adam moments; the parameters Adam moved match the port's unsharded dp=4
step on the same ranks at ``PARAM_ATOL_DV3``. At these widths the JAX
step's parameters leave the port's, sharded or not alike, by more than
that on 32 of the 17,658,758 trained elements (by up to 1.7e-4), those
whose gradient is rounding noise next to Adam's eps (ROADMAP Queue 3 item
17)."""
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread for the module)
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from sheeprl_tpu_torch import convert
from test_torch_mesh_dv3 import PARAM_ATOL_DV3, _dv3_noise
from test_torch_mesh_steps import METRIC_RTOL, MOMENT_RTOL, _close_adam, _close_state

NAMES = ("wm", "actor", "critic", "target_critic")
# the S preset's widths over the tiny config's cuts (TINY_DV3 sets XS widths
# explicitly: each is set back to S's here)
S_WIDTHS = ["algo=dreamer_v3_S", "algo.dense_units=512", "algo.world_model.encoder.cnn_channels_multiplier=32",
            "algo.world_model.recurrent_model.recurrent_state_size=512",
            "algo.world_model.recurrent_model.dense_units=512", "algo.world_model.transition_model.hidden_size=512",
            "algo.world_model.representation_model.hidden_size=512", "algo.world_model.discrete_size=32",
            "algo.world_model.stochastic_size=32"]
DECOUPLED = ["algo.world_model.decoupled_rssm=True"]
MESH = {"dp": 1, "fsdp": 4, "tp": 1}
T, B = 4, 4


def test_dreamer_v3_s_on_1_4_1_holds_its_shards_and_matches_jax(tmp_path):
    from dreamer_tiny import N_ACT
    from sheeprl_tpu.parallel import Distributed
    from test_torch_dreamer_v3 import XLA, _numpy_tree, condition_two_hot_heads, torch_trainer
    from torch_mesh_parity import tiny_dv3_trainer

    train, params, opt_states, moments, _ = tiny_dv3_trainer(XLA + S_WIDTHS + DECOUPLED + [
        "algo.world_model.pallas_gru=interpret"], devices=4, mesh=MESH)
    params0 = condition_two_hot_heads(_numpy_tree(params))
    opt0, moments0 = _numpy_tree(opt_states), _numpy_tree(moments)
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.integers(0, 255, (1, T, B, 64, 64, 3), np.uint8),
             "actions": np.eye(N_ACT, dtype=np.float32)[rng.integers(0, N_ACT, (1, T, B))],
             "rewards": rng.standard_normal((1, T, B, 1)).astype(np.float32),
             "terminated": np.zeros((1, T, B, 1), np.float32), "truncated": np.zeros((1, T, B, 1), np.float32),
             "is_first": np.zeros((1, T, B, 1), np.float32)}
    keys = jax.random.split(jax.random.key(7), 1)
    cfg, (wm, actor, critic, target), opts, _ = torch_trainer(S_WIDTHS + DECOUPLED + ["algo.world_model.pallas_gru=True"])
    convert.load_dreamer_v3(params0, wm, actor, critic, target, opt0, opts)
    payload = {"cfg": cfg.to_dict(), "actions_dim": [N_ACT], "batch": batch, "dir": str(tmp_path),
               "modules": dict(zip(NAMES, (wm, actor, critic, target))),
               "opt_states": {k: getattr(opts, k).optimizer.state_dict() for k in ("wm", "actor", "critic")},
               "noise": [_dv3_noise(keys[0], cfg, T, B, N_ACT)], "cases": [{"mesh": MESH}, {"mesh": {"dp": 4, "fsdp": 1, "tp": 1}}]}
    ranks: dict = {}

    def launch():
        try:
            ranks["outs"] = W.launch_ranks(W.dv3_sharded_steps, payload, tmp_path, world=4)
        except BaseException as err:  # re-raised below, in the test's thread
            ranks["error"] = err

    thread = threading.Thread(target=launch)
    thread.start()
    jdist = Distributed(devices=4, mesh=MESH)
    placed = jdist.replicate(jax.tree.map(jnp.asarray, (params0, opt0, moments0)))
    sharded = {k: jax.device_put(jnp.asarray(v), jdist.shard_batch_axis(2)) for k, v in batch.items()}
    j_params, j_opt, j_moments, j_metrics = jax.tree.map(np.asarray, jax.block_until_ready(
        train(*placed, sharded, keys)))
    thread.join()
    if "error" in ranks:
        raise ranks["error"]
    outs, dp4 = [o[0] for o in ranks["outs"]], ranks["outs"][0][1]

    params = outs[0]["summaries"]["params"]
    print("S at (1,4,1): params report", params, "rank 0's peak bytes over the burst", outs[0]["peak_bytes"],
          "dp=4's", dp4["peak_bytes"], "the most whole-copy bytes held at once", outs[0]["gathered_peak_bytes"],
          "the largest unit's", outs[0]["unit_bytes"])
    assert params["bytes_per_chip"] < params["total_bytes"] // 2
    for o in outs:
        assert o["gathered_peak_bytes"] <= o["unit_bytes"]  # one module's whole weights at a time
        assert o["param_bytes"] == params["bytes_per_chip"]
        assert o["grad_bytes"] == o["grad_leaf_bytes"]
        assert o["moments_bytes"] == o["moment_leaf_bytes"]
        for k in NAMES:
            for n, t in outs[0]["state"][k].items():
                assert torch.equal(o["state"][k][n], t), (k, n)

    _, (ewm, eactor, ecritic, etarget), eopts, _ = torch_trainer(S_WIDTHS + DECOUPLED)
    convert.load_dreamer_v3(_numpy_tree(j_params), ewm, eactor, ecritic, etarget, _numpy_tree(j_opt), eopts)
    for k in j_metrics:
        got = np.mean([o["metrics"][k] for o in outs])
        assert got == pytest.approx(float(np.asarray(j_metrics[k])[0]), rel=METRIC_RTOL), k
    np.testing.assert_allclose(outs[0]["moments"], [float(j_moments.low), float(j_moments.high)], rtol=METRIC_RTOL)
    for name in ("wm", "actor", "critic"):
        _close_adam(outs[0]["opt_states"][name], getattr(eopts, name).optimizer.state_dict(), MOMENT_RTOL, name)
    # the parameters Adam moved: against the unsharded dp=4 step of the port
    # (the JAX step's own parameters leave both by more than PARAM_ATOL_DV3
    # on a few elements whose gradient is rounding noise: ROADMAP Queue 3
    # item 17)
    for name in NAMES:
        _close_state(outs[0]["state"][name], dp4["state"][name], PARAM_ATOL_DV3, name)
