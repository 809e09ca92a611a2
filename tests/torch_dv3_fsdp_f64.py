"""DreamerV3's step on ``(2,2,1)`` with its parameters sharded against the
unsharded dp=4 step, once in f32 as ``tests/test_torch_mesh_sharded.py``
runs it and once in f64 on both sides (the modules, the Adam states, the
batch and the draws in float64, every module's floating inputs cast to
it; the distributions' own f32 casts stay). The RSSM runs the decoupled
scan (``pallas_gru=False``): the LN-GRU sequence kernels, and their plain
versions, compute in f32.

The two meshes split the global batch over the same four data ranks and
compute the same forward and the same per-rank gradients; they differ in
how the four ranks' gradients are summed (one all-reduce per sharded
parameter in its backward, against one flattened all-reduce per optimizer
step) and in the global norm's sum (from the shards). If that order is the
only difference, the gap between the two steps falls from f32 rounding
to f64 rounding. Prints, per precision and per case (plain and every
optimizer clipped at 1e-3), the largest gap of the updated parameters and
of the Adam moments, relative to each tensor's largest entry.

Usage: ``cd tests && PYTHONPATH=..:. python torch_dv3_fsdp_f64.py`` (about
a minute: two launches of four gloo ranks)."""
import tempfile
from pathlib import Path

import numpy as np
import torch

import torch_mesh_worker as W

CASES = [{"mesh": {"dp": 2, "fsdp": 2, "tp": 1, "min_shard_size": 64}}, {"mesh": {"dp": 4, "fsdp": 1, "tp": 1}},
         {"mesh": {"dp": 2, "fsdp": 2, "tp": 1, "min_shard_size": 64}, "clip": 1e-3},
         {"mesh": {"dp": 4, "fsdp": 1, "tp": 1}, "clip": 1e-3}]


def to_f64(module, args):
    """A forward pre-hook: the call's floating inputs in float64 (samples
    and one-hot actions come out of the distributions in f32)."""
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args)


def f64_steps(dist, p):
    """``dv3_sharded_steps`` with float64 as the default dtype and the
    images normalised into it (the port's ``normalize_obs`` makes f32)."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3

    torch.set_default_dtype(torch.float64)
    tdv3.normalize_obs = lambda obs, cnn_keys: {k: (v.double() / 255.0 - 0.5) if k in cnn_keys else v
                                                for k, v in obs.items()}
    return W.dv3_sharded_steps(dist, p)


def payload(mode: str, tmp: Path):
    from dreamer_tiny import N_ACT
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as tdv3
    from test_torch_dreamer_v3 import torch_trainer

    cfg, (wm, actor, critic, target), opts, _ = torch_trainer(["algo.world_model.decoupled_rssm=True",
                                                               "algo.dense_units=128",
                                                               "algo.world_model.pallas_gru=False"])
    T, B = 4, 4
    rng = np.random.default_rng(0)
    dt = np.float64 if mode == "f64" else np.float32
    batch = {"rgb": rng.integers(0, 255, (1, T, B, 64, 64, 3), np.uint8),
             "actions": np.eye(N_ACT, dtype=dt)[rng.integers(0, N_ACT, (1, T, B))],
             "rewards": rng.standard_normal((1, T, B, 1)).astype(dt),
             "terminated": np.zeros((1, T, B, 1), dt), "truncated": np.zeros((1, T, B, 1), dt),
             "is_first": np.zeros((1, T, B, 1), dt)}
    noise = tdv3.draw_train_noise(cfg, T, B, [N_ACT], False, torch.Generator().manual_seed(7), "cpu")
    cast = (lambda t: t.double()) if mode == "f64" else (lambda t: t)
    noise = {k: [cast(x).numpy() for x in v] if isinstance(v, list) else cast(v).numpy() for k, v in noise.items()}
    modules = dict(zip(("wm", "actor", "critic", "target_critic"), (wm, actor, critic, target)))
    if mode == "f64":
        for m in modules.values():
            m.double()
            for sub in m.modules():
                sub.register_forward_pre_hook(to_f64)
    return {"cfg": cfg.to_dict(), "actions_dim": [N_ACT], "batch": batch, "dir": str(tmp), "modules": modules,
            "opt_states": {k: getattr(opts, k).optimizer.state_dict() for k in ("wm", "actor", "critic")},
            "noise": [noise], "cases": CASES}


def gaps(a, b):
    """The largest gap of the parameters and of the moments, relative to
    each tensor's largest entry."""
    params = max(float((a["state"][k][n].double() - t.double()).abs().max()) / max(float(t.abs().max()), 1e-300)
                 for k in b["state"] for n, t in b["state"][k].items())
    moments = max(float((a["opt_states"][k]["state"][i][m].double() - v[m].double()).abs().max())
                  / max(float(v[m].abs().max()), 1e-300)
                  for k in b["opt_states"] for i, v in b["opt_states"][k]["state"].items()
                  for m in ("exp_avg", "exp_avg_sq"))
    return params, moments


if __name__ == "__main__":
    for mode in ("f32", "f64"):
        with tempfile.TemporaryDirectory() as d:
            outs = W.launch_ranks(f64_steps if mode == "f64" else W.dv3_sharded_steps, payload(mode, Path(d)),
                                  Path(d), world=4)
        for label, (i, j) in (("plain", (0, 1)), ("clipped", (2, 3))):
            p, m = gaps(outs[0][i], outs[0][j])
            dtype = outs[0][i]["state"]["wm"][next(iter(outs[0][i]["state"]["wm"]))].dtype
            print(f"{mode} ({dtype}), {label}: (2,2,1) against dp=4, largest gap of the parameters {p:.3e}, "
                  f"of the moments {m:.3e} of the tensor's largest", flush=True)
