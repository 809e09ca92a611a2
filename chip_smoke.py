#!/usr/bin/env python3
"""Drive the PyTorch port (sheeprl_tpu_torch) on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line; the script exits non-zero at the first
that fails and then prints no result:

1. card      — nvidia-smi name and power limit (also printed raw on its own
               line), torch and CUDA versions;
2. build     — nvcc builds the LN-GRU kernels from csrc/ln_gru.cu (timed;
               ptxas register / shared-memory / spill lines); for the
               DreamerV3-S and XS widths, the CTAs of a cluster and each
               CTA's shared memory (the fit rule of ops/ln_gru.py, which
               also gives the build its layout) and how many clusters the
               card holds at once (cudaOccupancyMaxActiveClusters);
3. kernels   — at the DreamerV3-S (T=64, B=16, F=H=512) and XS (F=H=256)
               GRU shapes, resets in mid-sequence: the whole sequence on the
               kernels against the plain passes (the forward and all five
               gradients, h_first of shape [H] and [B,H]), and each of the
               five kernels against its plain version on the same inputs,
               TF32 off, with the tolerances printed; the three 3xTF32
               GEMMs (ln_gru_xproj, ln_gru_dx, ln_gru_wgrad's dW) also
               against a float64 product on the card (their error at most
               F64_FACTOR times torch.mm's in f32) and two launches of each
               bitwise equal (ln_gru_wgrad's dscale and dbias too); at
               DreamerV3-S the kernels' and plain versions' medians over timed reps
               (CUDA events, each launch queued behind a spin so that the
               host's launch cost stays out of the device time), the
               recurrent kernels' probe variants without their product (the
               cost of the barriers and the rest of a step), the one
               PyTorch call that computes the same function where there is
               one, and the bound computed from the shapes;
4. train     — DreamerV3-S gradient steps through make_train_fn, MsPacman-
               shaped (64x64x3, 9 actions), T=64, B=16, horizon 15: three
               decoupled steps on the kernels (losses finite, each kernel's
               launch count up by >= 3) plus one step under torch.profiler
               (device time by kernel; device busy share = that device
               time over the median unprofiled step), the same three
               steps on the plain passes, and one step of the coupled
               default; ms/step and peak device memory of each;
5. run       — the training loop as users launch it, through the CLI entry
               points (sheeprl_tpu_torch.cli.run / .evaluation), on the
               dummy env at DreamerV3-S width on the kernel path, each leg
               with every kernel count set to 0 just before it and read just
               after (each must be > 0 where the leg trains):
               run         the default overlapped loop (player thread on its
                           own CUDA stream, ParamMirror on the card), one
                           checkpoint mid-run and the last one;
               serial      the same arguments with algo.overlap.enabled=False;
                           its ledger (policy_step, grad steps, Ratio state,
                           the buffer's pos/full) must equal the run leg's;
               host_player a short overlapped leg with algo.player.device=host;
               resume      checkpoint.resume_from=<the run leg's mid-run
                           checkpoint> with a higher algo.total_steps: the
                           parameters and counters it starts from must equal
                           the file's, and it must reach its target;
               eval        eval checkpoint_path=<the run leg's last
                           checkpoint>: one greedy episode on the card;
               every number is read from the legs' printed lines ([dreamer_v3],
               [overlap], [mirror], [ckpt_async], Test - Reward) and their
               checkpoints; then the blocks of each kernel's last launch on
               the run leg, as its CUDA entry recorded the grid it launched;
6. kernels   — one {"kernels": [...]} line: launches and blocks from the run
               leg (SMs = the smaller of the blocks and the card's SMs), times
               from phase 3, the bound and the f32-only bound beside it, the
               kernel's arithmetic (3xtf32 or f32-simt), largest error at
               either shape (and, beside ln_gru_wgrad, cuBLAS's dW product
               alone);
7. the last line: {"ok": true, "device": {...}}.

Times and rates are of this run on this card; compare versions only within
one run.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, dense TF32 on them, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
T, B, F, H = 64, 16, 512, 512
# the GRU shapes of the presets the kernels take (the cluster split changes with H)
SHAPES = {"S": (T, B, 512, 512), "XS": (T, B, 256, 256)}
FWD_TOL = dict(atol=1e-4, rtol=1e-4)  # |kernel - plain| <= atol + rtol * max|plain|
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
# a 3xTF32 GEMM's largest error against float64 may be at most this many
# times torch.mm's in f32 (TF32 off); a lost correction term gives plain
# TF32's, about a hundred times larger
F64_FACTOR = 4
GEMMS = ("ln_gru_xproj", "ln_gru_dx", "ln_gru_wgrad")  # the kernels in 3xTF32 on the tensor cores
SPIN_CYCLES = 1_000_000  # device clock cycles a timed launch is queued behind (about 0.5 ms)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(phase: str, err: BaseException) -> int:
    emit(phase, ok=False, error=f"{type(err).__name__}: {err}")
    return 1


def bound_ms(flops: float, nbytes: float):
    """The least time the card could take for ``flops`` f32-accurate
    operations on ``nbytes`` bytes (ms), what bounds it, and the bound
    without the tensor cores beside it: operations at the faster of f32
    outside the tensor cores and three TF32 products on them (3xTF32), or
    bytes, whichever takes longer."""
    t_simt, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    t_ops = min(t_simt, 3 * flops / PEAK_TF32_FLOPS)
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", max(t_simt, t_bytes) * 1e3


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times. Each call is queued behind a
    spin of SPIN_CYCLES on the device, so that its launches are on the
    queue before the first event fires: the time is the device's, not the
    host's launch cost (a call whose host work outlasts the spin, like the
    plain recurrences' thousands of launches, still shows the host's pace)."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def check(name, got, ref, tol, errors) -> None:
    err = float((got - ref).abs().max())
    limit = tol["atol"] + tol["rtol"] * float(ref.abs().max())
    errors[name] = err
    if not err <= limit:
        raise AssertionError(f"{name}: max |kernel - plain| = {err:.3e} > {limit:.3e}")


def check_gemm(torch, name, got, a, b, launch, f64_errors) -> None:
    """A 3xTF32 GEMM's output ``got`` of a·b: its largest error against a
    float64 product on the card at most F64_FACTOR times torch.mm's in f32,
    and another launch on the same inputs bitwise equal to it."""
    ref = torch.mm(a.double(), b.double())
    err = float((got.double() - ref).abs().max())
    mm_err = float((torch.mm(a, b).double() - ref).abs().max())
    f64_errors[name] = {"kernel": err, "torch_mm": mm_err}
    if not err <= F64_FACTOR * mm_err:
        raise AssertionError(f"{name}: max |kernel - f64| = {err:.3e} > {F64_FACTOR} x torch.mm's {mm_err:.3e}")
    if not torch.equal(launch(), got):
        raise AssertionError(f"{name}: two launches on the same inputs differ")


def phase_kernels(torch, ln_gru):
    """The kernel checks and times, with TF32 off; the caller's TF32 flags
    are restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _kernels_vs_plain(torch, ln_gru)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def gru_inputs(torch, shape, dev, seed=0):
    T_, B_, F_, H_ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn(T_, B_, F_, device=dev, generator=g)
    first = torch.zeros(T_, B_, 1, device=dev)
    first[0] = 1.0
    first[21, 3] = 1.0
    first[40, 7:10] = 1.0
    w = torch.randn(F_ + H_, 3 * H_, device=dev, generator=g) / (F_ + H_) ** 0.5
    scale = 1.0 + 0.1 * torch.randn(3 * H_, device=dev, generator=g)
    bias = 0.1 * torch.randn(3 * H_, device=dev, generator=g)
    cot = torch.randn(T_, B_, H_, device=dev, generator=g)
    return feats, first, w, scale, bias, cot, g


def _kernels_vs_plain(torch, ln_gru):
    dev = torch.device("cuda")
    errors, f64_errors = {}, {}
    for label, shape in SHAPES.items():
        T_, B_, F_, H_ = shape
        feats, first, w, scale, bias, cot, g = gru_inputs(torch, shape, dev)
        # the whole sequence: forward and the five gradients
        for hshape in ((H_,), (B_, H_)):
            h_first = 0.5 * torch.randn(*hshape, device=dev, generator=g)
            grads = {}
            for plain in (False, True):
                leaves = [t.clone().requires_grad_(True) for t in (feats, h_first, w, scale, bias)]
                hs = ln_gru.gru_sequence(leaves[0], first, *leaves[1:], plain=plain)
                (hs * cot).sum().backward()
                grads[plain] = [hs.detach()] + [t.grad for t in leaves]
            torch.cuda.synchronize()
            tag = f"{label}.hfirst_" + "x".join(map(str, hshape))
            names = ("hs", "dfeats", "dh_first", "dW", "dscale", "dbias")
            for i, n in enumerate(names):
                check(f"{tag}.{n}", grads[False][i], grads[True][i], FWD_TOL if i == 0 else GRAD_TOL, errors)
        # each kernel against its plain version on the same inputs
        hf = (0.5 * torch.randn(B_, H_, device=dev, generator=g)).contiguous()
        M = T_ * B_
        wx, wh, x2 = w[:F_], w[F_:], feats.reshape(M, F_)
        gx = ln_gru.ln_gru_xproj(x2, wx)
        check(f"{label}.xproj.gx", gx, ln_gru.xproj_plain(x2, wx), FWD_TOL, errors)
        check_gemm(torch, f"{label}.xproj", gx, x2, wx, lambda: ln_gru.ln_gru_xproj(x2, wx), f64_errors)
        gx = gx.reshape(T_, B_, 3 * H_)
        fw = ln_gru.ln_gru_fwd(gx, first, hf, wh, scale, bias)
        for n, a, b in zip(("hs", "yn", "istd"), fw, ln_gru.forward_plain(gx, first, hf, wh, scale, bias)):
            check(f"{label}.fwd.{n}", a, b, FWD_TOL, errors)
        hs, yn, istd = fw
        bw = ln_gru.ln_gru_bwd(feats, first, hs, hf, wh, scale, bias, cot, yn, istd)
        bw_plain = ln_gru.backward_plain(feats, first, hs, hf, wh, scale, bias, cot, yn, istd)
        for n, a, b in zip(("dh_first", "dy", "dy_raw", "xh"), bw, bw_plain):
            check(f"{label}.bwd.{n}", a, b, GRAD_TOL, errors)
        xh2, dyr2, dy2, yn2 = bw[3].reshape(M, -1), bw[2].reshape(M, -1), bw[1].reshape(M, -1), yn.reshape(M, -1)
        dfeats = ln_gru.ln_gru_dx(dyr2, wx)
        check(f"{label}.dx.dfeats", dfeats, ln_gru.dx_plain(dyr2, wx), GRAD_TOL, errors)
        check_gemm(torch, f"{label}.dx", dfeats, dyr2, wx.t(), lambda: ln_gru.ln_gru_dx(dyr2, wx), f64_errors)
        wg = ln_gru.ln_gru_wgrad(xh2, dyr2, dy2, yn2)
        for n, a, b in zip(("dW", "dscale", "dbias"), wg, ln_gru.wgrad_plain(xh2, dyr2, dy2, yn2)):
            check(f"{label}.wgrad.{n}", a, b, GRAD_TOL, errors)
        check_gemm(torch, f"{label}.wgrad", wg[0], xh2.t(), dyr2, lambda: ln_gru.ln_gru_wgrad(xh2, dyr2, dy2, yn2)[0],
                   f64_errors)
        if not all(torch.equal(a, b) for a, b in zip(wg[1:], ln_gru.ln_gru_wgrad(xh2, dyr2, dy2, yn2)[1:])):
            raise AssertionError(f"{label}.wgrad: dscale or dbias differ between two launches on the same inputs")
        if label == "S":
            timed = (feats, first, hf, wx, wh, scale, bias, cot, x2, gx, hs, yn, istd, xh2, dyr2, dy2, yn2)

    # times at DreamerV3-S, the plain versions and library calls beside them
    feats, first, hf, wx, wh, scale, bias, cot, x2, gx, hs, yn, istd, xh2, dyr2, dy2, yn2 = timed
    fwd_args = (gx, first, hf, wh, scale, bias)
    bwd_args = (feats, first, hs, hf, wh, scale, bias, cot, yn, istd)
    t = {
        "ln_gru_xproj": (time_ms(lambda: ln_gru.ln_gru_xproj(x2, wx)), time_ms(lambda: ln_gru.xproj_plain(x2, wx))),
        "ln_gru_fwd": (time_ms(lambda: ln_gru.ln_gru_fwd(*fwd_args)),
                       time_ms(lambda: ln_gru.forward_plain(*fwd_args), reps=10)),
        "ln_gru_bwd": (time_ms(lambda: ln_gru.ln_gru_bwd(*bwd_args)),
                       time_ms(lambda: ln_gru.backward_plain(*bwd_args), reps=10)),
        "ln_gru_dx": (time_ms(lambda: ln_gru.ln_gru_dx(dyr2, wx)), time_ms(lambda: ln_gru.dx_plain(dyr2, wx))),
        "ln_gru_wgrad": (time_ms(lambda: ln_gru.ln_gru_wgrad(xh2, dyr2, dy2, yn2)),
                         time_ms(lambda: ln_gru.wgrad_plain(xh2, dyr2, dy2, yn2))),
    }
    # one PyTorch call computing the same function, where there is one
    library = {
        "ln_gru_xproj": time_ms(lambda: torch.mm(x2, wx)),
        "ln_gru_dx": time_ms(lambda: torch.mm(dyr2, wx.t())),
    }
    mm_ms = time_ms(lambda: torch.mm(xh2.t(), dyr2))
    no_product = no_product_ms(torch, ln_gru, fwd_args, bwd_args)
    f32 = 4
    M, K, N = T * B, F + H, 3 * H
    bounds = {
        "ln_gru_xproj": bound_ms(2 * M * F * N, f32 * (M * F + F * N + M * N)),
        "ln_gru_fwd": bound_ms(2 * M * H * N, f32 * (M * N + M + B * H + H * N + 2 * N + M * H + M * N + M)),
        "ln_gru_bwd": bound_ms(2 * M * H * N, f32 * (M * F + M + 2 * M * H + B * H + H * N + 2 * N + M * N + M
                                                     + B * H + 2 * M * N + M * K)),
        "ln_gru_dx": bound_ms(2 * M * N * F, f32 * (M * N + F * N + M * F)),
        "ln_gru_wgrad": bound_ms(2 * M * K * N + 3 * M * N, f32 * (M * K + 3 * M * N + K * N + 2 * N)),
    }
    return errors, f64_errors, t, bounds, mm_ms, library, no_product


def no_product_ms(torch, ln_gru, fwd_args, bwd_args):
    """The recurrent kernels' probe variants (ln_gru_fwd_probe,
    ln_gru_bwd_probe: the kernel with its product left out), timed on the
    same inputs: two cluster barriers a step, the DSMEM exchanges, the gate
    math and the loads and stores. Their outputs are not the function's."""
    lib = ln_gru._lib()
    gx, first, hf, wh, scale, bias = fwd_args
    feats = bwd_args[0]
    T_, B_, F_ = feats.shape
    H_ = wh.shape[0]
    units = ln_gru.cluster_split(H_)[1]
    smem_fwd, smem_bwd = ln_gru.smem_bytes(H_)
    empty = lambda *shape: torch.empty(*shape, device=feats.device)  # noqa: E731
    fwd_out = (empty(T_, B_, H_), empty(T_, B_, 3 * H_), empty(T_, B_))
    bwd_out = (empty(B_, H_), empty(T_, B_, 3 * H_), empty(T_, B_, 3 * H_), empty(T_, B_, F_ + H_))
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn, args, dims, smem):
        rc = fn(*(a.data_ptr() for a in args), *dims, units, smem, stream)
        if rc != 0:
            raise RuntimeError(f"{fn.__name__}: CUDA error {rc}: {lib.ln_gru_error_string(rc).decode()}")

    return {
        "ln_gru_fwd": time_ms(lambda: launch(lib.ln_gru_fwd_probe, fwd_args + fwd_out, (T_, B_, H_), smem_fwd)),
        "ln_gru_bwd": time_ms(lambda: launch(lib.ln_gru_bwd_probe, bwd_args + bwd_out, (T_, B_, F_, H_),
                                             smem_bwd)),
    }


def cluster_report(ln_gru):
    """CTAs, shared memory and resident clusters of the recurrent kernels at
    each preset width; fails if a preset does not fit or the card holds no
    cluster."""
    out = {}
    for label, (_, _, F_, H_) in SHAPES.items():
        if not ln_gru.fits_smem(F_, H_):
            raise AssertionError(f"{label}: F={F_}, H={H_} does not fit the cluster kernels")
        fwd, bwd = ln_gru.cluster_capacity(H_)
        if min(fwd, bwd) < 1:
            raise AssertionError(f"{label}: the card holds no cluster (forward {fwd}, backward {bwd})")
        out[label] = {"H": H_, "cluster_ctas": ln_gru.cluster_split(H_)[0], "smem_bytes": ln_gru.smem_bytes(H_),
                      "max_active_clusters": {"fwd": fwd, "bwd": bwd},
                      "clusters_needed": -(-B // ln_gru.ROWS_PER_CLUSTER)}
    return out


def make_batch(torch, G, n_act, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    is_first = torch.zeros(G, T, B, 1, device=dev)
    is_first[:, T // 2, ::4] = 1.0
    terminated = torch.zeros(G, T, B, 1, device=dev)
    terminated[:, T // 2 - 1, ::4] = 1.0
    return {
        "rgb": torch.randint(0, 256, (G, T, B, 64, 64, 3), device=dev, dtype=torch.uint8, generator=g),
        "actions": torch.nn.functional.one_hot(
            torch.randint(0, n_act, (G, T, B), device=dev, generator=g), n_act
        ).float(),
        "rewards": torch.randn(G, T, B, 1, device=dev, generator=g),
        "terminated": terminated,
        "truncated": torch.zeros(G, T, B, 1, device=dev),
        "is_first": is_first,
    }


def profile_step(torch, train, moments, batch, gen, step_ms):
    """One gradient step under torch.profiler: device time summed over the
    kernels that ran and the kernels that took the most of it. The busy
    share is that device time over ``step_ms``, the median time of the same
    step without the profiler (whose host overhead would make the step look
    host-bound); the profiled step's own wall time is reported beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(moments, batch, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        # host ops and annotated ranges (Optimizer.step#...) also carry the
        # time of the kernels inside them: count the kernels alone
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.count, evt.key[:80]))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    if device_ms == 0:
        return {"device_ms": "not measured (the profiler recorded no device time)", "wall_ms": wall_ms}
    return {
        "profiled_wall_ms": wall_ms,
        "unprofiled_step_ms": step_ms,
        "device_ms": device_ms,
        "device_busy_share": device_ms / step_ms,
        "n_kernels": sum(r[1] for r in rows),
        "top": [{"ms": ms, "calls": n, "name": name} for ms, n, name in rows[:12]],
    }


def phase_train(torch, ln_gru, dev="cuda", overrides=()):
    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces

    dev = torch.device(dev)
    n_act = 9  # MsPacman
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    base = ["exp=dreamer_v3", "env=dummy", f"algo.per_rank_batch_size={B}",
            f"algo.per_rank_sequence_length={T}", "algo.horizon=15", *overrides]
    modes = {
        "decoupled_kernel": ["algo.world_model.decoupled_rssm=True", "algo.world_model.pallas_gru=True"],
        "decoupled_plain": ["algo.world_model.decoupled_rssm=True", "algo.world_model.pallas_gru=interpret"],
        "coupled": [],
    }
    out = {}
    for mode, extra in modes.items():
        cfg = compose("config", base + extra)
        torch.manual_seed(0)
        wm, actor, critic, target = build_agent(cfg, space, [n_act], False, dev)
        opts = dv3.build_optimizers(cfg, wm, actor, critic)
        train = dv3.make_train_fn(wm, actor, critic, target, opts, cfg, False, [n_act])
        gen = torch.Generator(device=dev).manual_seed(0)
        moments = init_moments(dev)
        n_steps = 1 if mode == "coupled" else 3
        batches = make_batch(torch, 1 + n_steps, n_act, dev, seed=1)
        moments, _ = train(moments, {k: v[:1] for k, v in batches.items()}, generator=gen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ln_gru.reset_launch_counts()
        times, losses = [], []
        for i in range(1, 1 + n_steps):
            t0 = time.perf_counter()
            moments, metrics = train(moments, {k: v[i : i + 1] for k, v in batches.items()}, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(v[0]) for k, v in metrics.items()})
        counts = {k.__name__: k.launches for k in ln_gru.KERNELS}
        bad = [k for m in losses for k, v in m.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{mode}: non-finite {sorted(set(bad))}")
        if mode == "decoupled_kernel" and min(counts.values()) < n_steps:
            raise AssertionError(f"{mode}: kernel launches {counts} < {n_steps} each")
        if mode != "decoupled_kernel" and max(counts.values()) != 0:
            raise AssertionError(f"{mode}: launched kernels {counts}")
        if mode == "decoupled_kernel" and dev.type == "cuda":
            profile = profile_step(torch, train, moments, {k: v[:1] for k, v in batches.items()}, gen,
                                   statistics.median(times))
        else:
            profile = None
        out[mode] = {
            "profile": profile,
            "ms_per_step": times,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": counts,
            "world_model_loss": [m["Loss/world_model_loss"] for m in losses],
            "policy_loss": [m["Loss/policy_loss"] for m in losses],
        }
        del wm, actor, critic, target, opts, train, batches
        torch.cuda.empty_cache()
    return out


# the run legs: DreamerV3-S on the dummy env, two envs, 64 policy steps of
# random actions, then one gradient step per iteration (replay ratio 0.5)
LEARNING_STARTS, TOTAL, RESUME_TOTAL, HOST_TOTAL = 128, 256, 320, 192
RUN_ROOT = "chip_smoke"  # logs/runs/chip_smoke/<leg>/version_N, removed at the end


class _Tee(io.TextIOBase):
    """Keeps what a leg prints and echoes it to stderr (stdout stays the
    script's own JSON lines)."""

    def __init__(self):
        self.buf = io.StringIO()

    def write(self, text):
        self.buf.write(text)
        sys.stderr.write(text)
        return len(text)

    def flush(self):
        sys.stderr.flush()


def parse_leg(text: str) -> dict:
    """The numbers a leg printed: its log dir, the loop's metric lines, the
    engine's and the mirror's records, the checkpoint writer's records, the
    resumed state and the test reward."""
    out = {"log_dir": None, "lines": [], "overlap": [], "mirror": [], "ckpt": [], "resumed": None, "reward": None}
    for line in text.splitlines():
        if line.startswith("[dreamer_v3] log_dir="):
            out["log_dir"] = line.split("=", 1)[1]
        elif line.startswith("[dreamer_v3] resumed "):
            out["resumed"] = json.loads(line[len("[dreamer_v3] resumed "):])
        elif line.startswith("[dreamer_v3] policy_step="):
            out["lines"].append({k: float(v) for k, v in (kv.split("=", 1) for kv in line.split()[1:])})
        elif line.startswith("[overlap] "):
            out["overlap"].append(json.loads(line[len("[overlap] "):]))
        elif line.startswith("[mirror] "):
            out["mirror"].append(json.loads(line[len("[mirror] "):]))
        elif line.startswith("[ckpt_async] "):
            out["ckpt"].append(json.loads(line[len("[ckpt_async] "):]))
        elif line.startswith("Test - Reward: "):
            out["reward"] = float(line.split(": ", 1)[1])
    return out


def drive(torch, ln_gru, command, argv):
    """One CLI call in this process, its output kept; returns (parsed,
    launch counts, seconds, peak device memory)."""
    from sheeprl_tpu_torch import cli

    tee = _Tee()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ln_gru.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        {"run": cli.run, "eval": cli.evaluation}[command](argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in ln_gru.KERNELS}
    return parse_leg(tee.buf.getvalue()), counts, seconds, torch.cuda.max_memory_allocated()


def checkpoints(log_dir):
    d = os.path.join(log_dir, "checkpoint")
    return sorted((os.path.join(d, f) for f in os.listdir(d) if f.endswith(".ckpt")),
                  key=lambda p: int(os.path.basename(p)[len("ckpt_"):-len(".ckpt")]))


def ledger(torch, path):
    """What must match between the overlapped and the serial loop."""
    s = torch.load(path, map_location="cpu", weights_only=False)
    return {"policy_step": s["policy_step"], "grad_steps": s["opt_states"]["step"], "ratio": s["ratio"],
            "rb": [(b["pos"], b["full"]) for b in s["rb"]["buffers"]]}


def leg_summary(parsed, counts, seconds, peak, learning_starts, trains=True):
    """The numbers of one training leg; fails if it did not train or printed
    no result."""
    lines = parsed["lines"]
    if not lines:
        raise AssertionError("the leg printed no [dreamer_v3] policy_step line")
    if trains and min(counts.values()) < 1:
        raise AssertionError(f"the leg launched {counts}")
    after = [l for l in lines if l["policy_step"] >= learning_starts]
    first, last = after[0], after[-1]
    sps = ((last["policy_step"] - first["policy_step"]) / (last["elapsed_s"] - first["elapsed_s"])
           if last["elapsed_s"] > first["elapsed_s"] else None)
    out = {"seconds": seconds, "policy_step": int(last["policy_step"]), "grad_steps": int(last["grad_steps"]),
           "policy_steps_per_s_after_learning_starts": sps,
           "sps_window": [first["policy_step"], last["policy_step"]], "peak_device_memory": peak,
           "launches": counts, "mirror": parsed["mirror"][-1] if parsed["mirror"] else None}
    ov = parsed["overlap"]
    if ov:
        busy, pstall = sum(r["player_busy_s"] for r in ov), sum(r["player_stall_s"] for r in ov)
        lstall, span = sum(r["learner_stall_s"] for r in ov), sum(r["interval_s"] for r in ov)
        out["engine"] = {"player_stall_frac": pstall / (busy + pstall) if busy + pstall > 0 else 0.0,
                         "learner_stall_frac": lstall / span if span > 0 else 0.0,
                         "staleness_max": max(r["staleness_max"] for r in ov),
                         "staleness_seen_max": ov[-1].get("staleness_seen_max"),
                         "bursts": ov[-1]["bursts"], "player_busy_s": busy, "player_stall_s": pstall,
                         "learner_stall_s": lstall, "records": len(ov)}
    written = [r for r in parsed["ckpt"] if r["action"] == "written"]
    if any(r["action"] == "failed" for r in parsed["ckpt"]):
        raise AssertionError(f"a checkpoint write failed: {parsed['ckpt']}")
    out["checkpoints"] = [{"step": r["step"], "snapshot_ms": r["snapshot_ms"], "write_ms": r["write_ms"],
                           "bytes": r["bytes"]} for r in written]
    return out


def phase_run(torch, ln_gru, overrides=()):
    """The legs of phase 5; returns (the run leg's counts, blocks, report)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import param_sums

    common = [
        "exp=dreamer_v3", "env=dummy", "algo.world_model.decoupled_rssm=True", "algo.world_model.pallas_gru=True",
        "env.num_envs=2", f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}",
        f"algo.learning_starts={LEARNING_STARTS}", "algo.replay_ratio=0.5", "buffer.size=1024",
        "metric.log_every=32", "checkpoint.every=96", "checkpoint.save_last=True", "algo.run_test=False",
        f"root_dir={RUN_ROOT}", *overrides,
    ]
    report = {}
    # the default overlapped loop
    run_args = common + [f"algo.total_steps={TOTAL}", "run_name=run"]
    parsed, counts, seconds, peak = drive(torch, ln_gru, "run", run_args)
    # the grid of each kernel's last launch on this leg, as its entry recorded it
    blocks = {k.__name__: int(ln_gru._lib().ln_gru_last_blocks(i)) for i, k in enumerate(ln_gru.KERNELS)}
    report["run"] = leg_summary(parsed, counts, seconds, peak, LEARNING_STARTS)
    report["run"]["args"] = run_args
    eng = report["run"].get("engine")
    if not eng:
        raise AssertionError("the run leg printed no [overlap] record: the overlap engine did not run")
    if eng["staleness_seen_max"] > 1:
        raise AssertionError(f"staleness {eng['staleness_seen_max']} > algo.overlap.staleness_bound=1")
    run_ckpts = checkpoints(parsed["log_dir"])
    mid = [p for p in run_ckpts if LEARNING_STARTS < int(os.path.basename(p)[5:-5]) < TOTAL]
    if not mid or int(os.path.basename(run_ckpts[-1])[5:-5]) != TOTAL:
        raise AssertionError(f"the run leg's checkpoints {run_ckpts} hold no mid-run one or not the last one")
    run_ledger = ledger(torch, run_ckpts[-1])

    # the serial loop on the same arguments: the same ledger
    parsed, counts, seconds, peak = drive(torch, ln_gru, "run", common + [
        f"algo.total_steps={TOTAL}", "run_name=serial", "algo.overlap.enabled=False"])
    report["serial"] = leg_summary(parsed, counts, seconds, peak, LEARNING_STARTS)
    serial_ledger = ledger(torch, checkpoints(parsed["log_dir"])[-1])
    if serial_ledger != run_ledger:
        raise AssertionError(f"ledgers differ: overlapped {run_ledger}, serial {serial_ledger}")
    report["serial"]["ledger_equal"] = run_ledger

    # the player on the host: pinned device-to-host refreshes
    parsed, counts, seconds, peak = drive(torch, ln_gru, "run", common + [
        f"algo.total_steps={HOST_TOTAL}", "run_name=host_player", "algo.player.device=host"])
    report["host_player"] = leg_summary(parsed, counts, seconds, peak, LEARNING_STARTS)
    if (report["host_player"]["mirror"] or {}).get("device") != "cpu":
        raise AssertionError(f"the host_player leg's mirror is on {report['host_player']['mirror']}")

    # resume from the run leg's mid-run checkpoint to a later target
    saved = torch.load(mid[-1], map_location="cpu", weights_only=False)
    parsed, counts, seconds, peak = drive(torch, ln_gru, "run", common + [
        f"algo.total_steps={RESUME_TOTAL}", "run_name=resume", f"checkpoint.resume_from={mid[-1]}"])
    started = parsed["resumed"]
    if started is None:
        raise AssertionError("the resume leg printed no resumed state")
    want = {"policy_step": saved["policy_step"], "grad_steps": saved["opt_states"]["step"], "ratio": saved["ratio"]}
    got = {k: started[k] for k in want}
    if got != want:
        raise AssertionError(f"resumed counters {got} != the checkpoint's {want}")
    file_sums = param_sums({k: saved[k] for k in ("wm", "actor", "critic", "target_critic")})
    for k, v in file_sums.items():
        if abs(started["param_sums"][k] - v) > 1e-9 * max(1.0, abs(v)):
            raise AssertionError(f"resumed {k} parameters sum to {started['param_sums'][k]}, the file's to {v}")
    report["resume"] = leg_summary(parsed, counts, seconds, peak, LEARNING_STARTS)
    if report["resume"]["policy_step"] != RESUME_TOTAL:
        raise AssertionError(f"the resumed run stopped at {report['resume']['policy_step']} < {RESUME_TOTAL}")
    report["resume"].update(checkpoint=os.path.basename(mid[-1]), started_from=got, param_sums=file_sums)

    # eval: one greedy episode from the run leg's last checkpoint
    parsed, counts, seconds, _ = drive(torch, ln_gru, "eval", [f"checkpoint_path={run_ckpts[-1]}"])
    if parsed["reward"] is None:
        raise AssertionError("eval printed no `Test - Reward:`")
    report["eval"] = {"seconds": seconds, "reward": parsed["reward"], "checkpoint": os.path.basename(run_ckpts[-1])}
    shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
    return report["run"]["launches"], blocks, report


def main() -> int:
    try:
        import torch
    except ImportError as err:
        return fail("card", err)
    if not torch.cuda.is_available():
        return fail("card", RuntimeError("torch.cuda.is_available() is False: this script needs an NVIDIA GPU"))
    if not os.path.isdir(os.path.join(HERE, "sheeprl_tpu_torch")):
        return fail("card", RuntimeError(f"no sheeprl_tpu_torch package beside {__file__}: run from a checkout"))
    sys.path.insert(0, HERE)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        emit("card", ok=True, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
             device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    except Exception as err:  # noqa: BLE001 - a phase boundary: report and stop
        return fail("card", err)

    from sheeprl_tpu_torch.ops import ln_gru

    try:
        t0 = time.perf_counter()
        lib, log = ln_gru.build(force=True)
        seconds = time.perf_counter() - t0
        ptxas = [l.strip() for l in log.splitlines() if "Used" in l or "spill" in l or "Function properties" in l]
        clusters = cluster_report(ln_gru)
        emit("build", ok=True, seconds=round(seconds, 3), library=os.path.relpath(lib, HERE), ptxas=ptxas,
             clusters=clusters)
    except Exception as err:  # noqa: BLE001
        return fail("build", err)

    try:
        errors, f64_errors, times, bounds, mm_ms, library, no_product = phase_kernels(torch, ln_gru)
        emit("kernels_vs_plain", ok=True, shapes=SHAPES, timed_shape="S", fwd_tol=FWD_TOL, grad_tol=GRAD_TOL,
             f64_factor=F64_FACTOR, max_abs_err=errors, err_vs_f64=f64_errors,
             times_ms={k: {"kernel_ms": v[0], "plain_ms": v[1]} for k, v in times.items()},
             library_ms=library, no_product_ms=no_product,
             bound_ms={k: v[0] for k, v in bounds.items()}, bound_simt_ms={k: v[2] for k, v in bounds.items()},
             dW_torch_mm_ms=mm_ms, spin_cycles=SPIN_CYCLES,
             peaks=dict(f32_flops=PEAK_F32_FLOPS, tf32_flops=PEAK_TF32_FLOPS, bytes_per_s=PEAK_BYTES))
    except Exception as err:  # noqa: BLE001
        return fail("kernels_vs_plain", err)

    try:
        train = phase_train(torch, ln_gru)
        emit("train", ok=True, model="DreamerV3-S", T=T, B=B, horizon=15, obs="64x64x3", actions=9, modes=train)
    except Exception as err:  # noqa: BLE001
        return fail("train", err)

    try:
        os.chdir(HERE)  # the legs write logs/runs/chip_smoke/ in the checkout (gitignored)
        counts, blocks, legs = phase_run(torch, ln_gru)
        emit("run", ok=True, nvidia_smi=smi, launches=counts, last_launch_blocks=blocks, legs=legs)
    except Exception as err:  # noqa: BLE001
        return fail("run", err)

    replaces = {  # the pallas_call each kernel's work comes from
        "ln_gru_xproj": "sheeprl_tpu/ops/pallas_gru.py:127",
        "ln_gru_fwd": "sheeprl_tpu/ops/pallas_gru.py:127",
        "ln_gru_bwd": "sheeprl_tpu/ops/pallas_gru.py:227",
        "ln_gru_dx": "sheeprl_tpu/ops/pallas_gru.py:227",
        "ln_gru_wgrad": "sheeprl_tpu/ops/pallas_gru.py:227",
    }
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    kernels = []
    for name, src in replaces.items():
        short = name[len("ln_gru_"):]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "sheeprl_tpu_torch/csrc/ln_gru.cu",
            "replaces": src,
            "launches": counts[name],
            "max_abs_err": max(v for k, v in errors.items() if k.split(".")[1] == short),
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "bound_simt_ms": bounds[name][2],
            "math": "3xtf32" if name in GEMMS else "f32-simt",
            "library_ms": library.get(name),
            "blocks": blocks[name],
            "sms": min(n_sm, blocks[name]),
        })
        if name in no_product:
            kernels[-1]["no_product_ms"] = no_product[name]
        if name in GEMMS:
            mine = [v for k, v in f64_errors.items() if k.split(".")[1] == short]
            kernels[-1]["err_vs_f64"] = max(v["kernel"] for v in mine)
            kernels[-1]["torch_mm_err_vs_f64"] = max(v["torch_mm"] for v in mine)
        if name == "ln_gru_wgrad":
            # no one call computes dW, dscale and dbias; cuBLAS's dW product
            # alone, on the same inputs, is the library time to beat
            kernels[-1]["torch_mm_dW_ms"] = mm_ms
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
