#!/usr/bin/env python3
"""Drive the PyTorch port (sheeprl_tpu_torch) on one NVIDIA GPU and check it.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line; the script exits non-zero at the first
that fails and then prints no result:

1. card      — nvidia-smi name and power limit (also printed raw on its own
               line), torch and CUDA versions;
2. build     — nvcc builds the LN-GRU kernels from csrc/ln_gru.cu (timed;
               ptxas register / shared-memory / spill lines); for each
               preset's GRU width (XS, S, M, L, XL), the instance of the
               recurrent kernels that takes it (resident or streamed), the
               CTAs of a cluster, units of a CTA, W_h tile rows and each
               CTA's shared memory (the fit rule of ops/ln_gru.py, which also
               gives the build its layout) and how many clusters the card
               holds at once (cudaOccupancyMaxActiveClusters);
3. kernels   — at the DreamerV3-S (T=64, B=16, F=H=512) and XS (F=H=256)
               GRU shapes (the resident instance) and the M (F=640, H=1024),
               L (768, 2048) and XL (1024, 4096) shapes (the streamed
               instance), resets in mid-sequence: the whole sequence on the
               kernels against the plain passes (the forward and all five
               gradients, h_first of shape [H] and [B,H]), and each of the
               five kernels against its plain version on the same inputs,
               TF32 off, with the tolerances printed; the three 3xTF32
               GEMMs (ln_gru_xproj, ln_gru_dx, ln_gru_wgrad's dW) also
               against a float64 product on the card (their error at most
               F64_FACTOR times torch.mm's in f32) and two launches of each
               bitwise equal (ln_gru_wgrad's dscale and dbias too); at
               every shape the kernels' and plain versions' medians over timed
               reps (CUDA events, each launch queued behind a spin so that
               the host's launch cost stays out of the device time), the
               recurrent kernels' probe variants without their product (the
               cost of the barriers and the rest of a step), the one
               PyTorch call that computes the same function where there is
               one, and the bound computed from the shapes, with its
               operations and bytes bounds apart (and, for the streamed
               instance, the time its re-reads of W_h take at 3.35 TB/s);
4. train     — DreamerV3-S gradient steps through make_train_fn, MsPacman-
               shaped (64x64x3, 9 actions), T=64, B=16, horizon 15: three
               decoupled steps on the kernels (losses finite, each kernel's
               launch count up by >= 3) plus one step under torch.profiler
               (device time by kernel; device busy share = that device
               time over the median unprofiled step), the same three
               steps on the plain passes, and one step of the coupled
               default (profiled too); ms/step and peak device memory of
               each; then the coupled step under bf16-mixed: one step held
               against 32-true from the same weights on the same batch and
               noise (every loss within BF16_TOL), three timed steps and a
               profiled one (do the convolutions and GEMMs run on bf16
               tensor-core kernels?), and decoupled with pallas_gru=True
               under bf16-mixed: no LN-GRU launch and the UNUSED line; then
               DreamerV3-M decoupled on the kernels (the streamed instance):
               its first step held against pallas_gru=interpret on the same
               weights, batch and noise (world-model losses within
               KERNEL_TOL), three timed steps and a profiled one, launch
               counts > 0; and one timed and one profiled step each at L
               and XL; one decoupled S step under the telemetry's cost
               count (model_cost, as a run's first burst takes it), timed;
4b. feed     — one burst's replay feed at the bench shape from a 404 MB
               memmap buffer, three ways: the synchronous sample with a
               pageable copy, the staged prefetcher (pinned buffers, its
               own copy stream) and the device ring; host ms on this
               thread, device ms, the copy's GB/s, the ring's sync bytes
               per burst and its gather against the bound; the three
               batches bitwise equal for one generator state; the native
               gather (which must have loaded) against numpy's;
5. run       — the training loop as users launch it, through the CLI entry
               points (sheeprl_tpu_torch.cli.run / .evaluation), on the
               dummy env at DreamerV3-S width on the kernel path, each leg
               with every kernel count set to 0 just before it and read just
               after (each must be > 0 where the leg trains):
               run         the default overlapped loop (player thread on its
                           own CUDA stream, ParamMirror on the card), one
                           checkpoint mid-run and the last one;
               run_M       the same at DreamerV3-M (the streamed instance);
               serial      the same arguments as run with
                           algo.overlap.enabled=False; its ledger
                           (policy_step, grad steps, Ratio state, the
                           buffer's pos/full) must equal the run leg's;
               host_player a short overlapped leg with algo.player.device=host;
               resume      checkpoint.resume_from=<the run leg's mid-run
                           checkpoint> with a higher algo.total_steps: the
                           parameters and counters it starts from must equal
                           the file's, and it must reach its target;
               eval        eval checkpoint_path=<the run leg's last
                           checkpoint>: one greedy episode on the card;
               walker_ring, walker_staged
                           the DMC walker-walk preset's settings (coupled,
                           bf16-mixed, memmap, action repeat 2) on the
                           continuous dummy env, on the device ring and on
                           the staged prefetcher: equal ledgers;
               walker_resume
                           a resume from walker_staged's last checkpoint,
                           which references its memmap files
                           (memmap_fast_resume);
               ppo         exp=ppo on the discrete dummy env (4 envs, the
                           preset's algorithm settings), the default
                           overlapped loop in strict on-policy mode, a
                           mid-run checkpoint and the last one (4,096
                           policy steps): policy steps/s, update ms, peak
                           device memory;
               ppo_serial  the same with algo.overlap.enabled=False: the
                           same counters and bitwise-equal parameters;
               ppo_pixels  algo.cnn_keys.encoder=[rgb]: NatureCNN at
                           64x64x3;
               ppo_continuous
                           the continuous dummy env (the Normal heads);
               a2c, ppo_recurrent
                           the presets' algorithm settings on the discrete
                           dummy env (ppo_recurrent at 8 envs: one update
                           of its 512-step rollout);
               ppo_resume_cmd
                           `resume run_dir=<the ppo leg's run>` to a higher
                           algo.total_steps: it starts from the file's
                           counters and parameters and reaches its target;
               ppo_eval    eval checkpoint_path=<the ppo leg's last
                           checkpoint>: one greedy episode on the card;
               ppo_watchdog
                           the ppo leg with the watchdog on (stall_s 600):
                           no watchdog event, and the ppo leg's end;
               no on-policy leg launches an LN-GRU kernel;
               sac         exp=sac on the continuous dummy env (4 envs, the
                           preset's widths and settings: hidden 256, two
                           critics, batch 256, replay ratio 1), the default
                           overlapped loop (staleness bound 1), to 1,024
                           policy steps, a mid-run checkpoint and the last;
               sac_serial  the same, serial, fed by the device ring (which
                           device_cache: auto takes at this buffer size):
                           the same Ratio ledger as sac;
               sac_staged  sac_serial on the staged host feed
                           (buffer.device_cache=false): its batches are the
                           ring's, so its parameters end bitwise equal;
               droq        exp=droq, serial, to 256 policy steps (replay
                           ratio 20: about 3,000 critic steps);
               sac_ae      exp=sac_ae at full width (multiplier 16, hidden
                           1024, batch 128, 64x64x3 pixels), serial,
                           learning_starts cut to 64, 64 gradient steps;
               sac_resume  checkpoint.resume_from=<the sac leg's mid-run
                           checkpoint, which holds the buffer>: its
                           counters and parameters, and on to 1,536;
               sac_eval, droq_eval, sac_ae_eval
                           eval checkpoint_path=<each leg's last one>;
               sac_ae_step one SAC-AE gradient step at the preset's width
                           through make_train_fn, timed and profiled as in
                           phase 4, with its model FLOPs and MFU;
               each off-policy leg records policy steps/s after
               learning_starts, update ms (a burst's wall time), gradient
               steps and its own peak device memory; none launches an
               LN-GRU kernel;
               dreamer_v2  exp=dreamer_v2 at the preset's widths
                           (multiplier 48, recurrent 600, 32x32, batch 16,
                           sequence 50, horizon 15, 32-true) on the discrete
                           dummy env (one env), the sequential buffer on the
                           device ring, learning_starts 64, to 256 policy
                           steps (its 20 pretrain steps, then ratio 0.2), a
                           mid-run checkpoint and the last;
               dreamer_v2_episode
                           buffer.type=episode, prioritize_ends, memmap, on
                           the staged feed, on the multidiscrete dummy env
                           (129-step episodes: the discrete dummy's 5-step
                           ones are shorter than a sequence, which the
                           episode buffer's minimum length asks), to 320;
               dreamer_v2_resume
                           checkpoint.resume_from=<dreamer_v2's mid-run
                           checkpoint, which holds the buffer>: its
                           counters and parameters, the target-copy step
                           counter carried on, to 320;
               dreamer_v1  exp=dreamer_v1 at the preset's widths
                           (multiplier 32, recurrent 200, stochastic 30,
                           batch 50, sequence 50) on the continuous dummy
                           env: the truncated-normal actor, exploration
                           noise 0.3, learning_starts 128, to 512;
               dreamer_v2_eval, dreamer_v1_eval
                           eval checkpoint_path=<each leg's last one>;
               dv2_step, dv1_step
                           one gradient step of each at the preset's
                           width through make_train_fn, timed and profiled
                           as in phase 4, with its model FLOPs, f32 bound
                           and MFU; dv2_step also under bf16-mixed from the
                           same weights, batch and noise, its losses within
                           BF16_TOL of f32's;
               each DreamerV1/V2 leg records what an off-policy leg does;
               none launches an LN-GRU kernel;
               p2e_dv3_exploration
                           exp=p2e_dv3_exploration as composed (coupled,
                           XL: dense 1024 x 5, recurrent 4096, multiplier
                           96, 32x32, B 16, T 64, 8 ensemble members, 4
                           envs) on the discrete dummy env (64x64x3),
                           learning_starts cut to 256, to 264 policy steps
                           (8 gradient steps), a checkpoint at 260;
               p2e_dv3_exploration_decoupled
                           the same with decoupled_rssm=True
                           pallas_gru=True, to 260: the JAX step's coupled
                           scan all the same, so no LN-GRU launch;
               p2e_dv3_finetuning
                           checkpoint.exploration_ckpt_path=<the decoupled
                           leg's last checkpoint>: it inherits decoupled and
                           pallas_gru=True, so every one of the five LN-GRU
                           kernels launches at XL (F=1024, H=4096, the
                           streamed instance; counts zeroed before the leg,
                           launches and blocks kept); it must start from
                           the checkpoint's wm, actor_task and
                           actor_exploration (its `from exploration`
                           line) and switch from the exploration actor to
                           the task actor at learning_starts (256), a
                           checkpoint at 260, the last at 264;
               p2e_dv3_finetuning_resume
                           checkpoint.resume_from=<its checkpoint at 260>:
                           the file's counters and parameters, the task
                           actor from the first step, on to 272;
               p2e_dv2_exploration, p2e_dv2_finetuning
                           the presets' widths (multiplier 48, recurrent
                           400, 32x32, 10 members, B 16, T 50; one env) on
                           the discrete dummy env, learning_starts 64, to
                           128 and 96; the finetuning leg from the
                           exploration leg's checkpoint (its parameters,
                           the actor switch at 64);
               p2e_dv1_exploration, p2e_dv1_finetuning
                           the same at the presets' widths (multiplier 32,
                           recurrent 400, stochastic 60, 10 members, B 50,
                           T 50) on the continuous dummy env, to 224 and
                           176;
               p2e_dv3_eval, p2e_dv2_eval, p2e_dv1_eval
                           eval checkpoint_path=<each exploration leg's
                           last one>: the task actor's greedy episode;
               p2e_dv3_step
                           one P2E-DV3 exploration gradient step at the XL
                           preset through make_train_fn, timed and profiled
                           as dv2_step, its counted FLOPs holding the
                           ensembles' intrinsic-reward forward;
               no P2E leg but the two finetuning DV3 legs launches an
               LN-GRU kernel;
               every training leg's <log_dir>/telemetry.jsonl must pass the
               port's validate_jsonl and open with a startup record that
               names the card; its numbers come from that stream (log
               records: policy steps, gradient steps, elapsed seconds, MFU,
               peak device memory, the mirror's statistics; overlap and
               ckpt_async records) and from the lines the loop prints
               (log_dir, resumed state, Test - Reward); then the blocks of
               each kernel's last launch on the run and run_M legs, as its
               CUDA entry recorded the grid it launched;
6. time and kernels
             — the script's whole time in seconds (one JSON line), then
               one {"kernels": [...]} line: a row for each kernel at each
               width a training leg runs it (resident at S, streamed at M
               and XL), with launches and blocks from the run leg, the
               run_M leg or the p2e_dv3_finetuning leg, times
               from phase 3, the bound (the operations and bytes bounds
               apart are in phase 3's record), the kernel's arithmetic
               (3xtf32 or f32-simt), largest error at that shape (and,
               beside ln_gru_wgrad, cuBLAS's dW product alone);
7. the last line: {"ok": true, "device": {...}}.

Two narrower runs, for comparisons within one call (see USAGE): the
recurrent kernels alone at chosen shapes (phases 1-2, then each checked and
timed as in phase 3), and the telemetry's cost (phases 1-2, then phase 5's
run and serial legs with the stream on, off, and on without its
per-iteration trace ranges and span timers).

Times and rates are of this run on this card; compare versions only within
one run.
"""
from __future__ import annotations

import contextlib
import copy
import gc
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
# the GRU shapes (T, B, F, H) of the presets: XS and S take the resident
# instance of the recurrent kernels, M, L and XL the streamed one
SHAPES = {"S": (T, B, 512, 512), "XS": (T, B, 256, 256), "M": (T, B, 640, 1024), "L": (T, B, 768, 2048),
          "XL": (T, B, 1024, 4096)}
# the widths whose kernels the main path's legs launch, and their instance:
# S on the run leg, M on run_M, XL on p2e_dv3_finetuning
INSTANCE_SHAPES = {"S": "resident", "M": "streamed", "XL": "streamed"}
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
    operations on ``nbytes`` bytes (ms), what bounds it, the bound without
    the tensor cores, and the operations and bytes bounds apart: operations
    at the faster of f32 outside the tensor cores and three TF32 products on
    them (3xTF32), or bytes (each input read once, each output written
    once), whichever takes longer."""
    t_simt, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    t_ops = min(t_simt, 3 * flops / PEAK_TF32_FLOPS)
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", max(t_simt, t_bytes) * 1e3,
            t_ops * 1e3, t_bytes * 1e3)


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
    errors, f64_errors, per_shape = {}, {}, {}
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
        per_shape[label] = _time_kernels(torch, ln_gru, shape, (feats, first, hf, wx, wh, scale, bias, cot, x2, gx,
                                                                hs, yn, istd, xh2, dyr2, dy2, yn2))
    return errors, f64_errors, per_shape


def _time_kernels(torch, ln_gru, shape, inputs):
    """Each kernel's median time at one GRU shape, its plain version's, the
    one PyTorch call that computes the same function where there is one,
    cuBLAS's dW product alone, the recurrent kernels' probes without their
    product, and the bounds from the shapes."""
    T_, B_, F_, H_ = shape
    feats, first, hf, wx, wh, scale, bias, cot, x2, gx, hs, yn, istd, xh2, dyr2, dy2, yn2 = inputs
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
    library = {  # one PyTorch call computing the same function, where there is one
        "ln_gru_xproj": time_ms(lambda: torch.mm(x2, wx)),
        "ln_gru_dx": time_ms(lambda: torch.mm(dyr2, wx.t())),
    }
    f32 = 4
    M, K, N = T_ * B_, F_ + H_, 3 * H_
    bounds = {
        "ln_gru_xproj": bound_ms(2 * M * F_ * N, f32 * (M * F_ + F_ * N + M * N)),
        "ln_gru_fwd": bound_ms(2 * M * H_ * N, f32 * (M * N + M + B_ * H_ + H_ * N + 2 * N + M * H_ + M * N + M)),
        "ln_gru_bwd": bound_ms(2 * M * H_ * N, f32 * (M * F_ + M + 2 * M * H_ + B_ * H_ + H_ * N + 2 * N + M * N + M
                                                      + B_ * H_ + 2 * M * N + M * K)),
        "ln_gru_dx": bound_ms(2 * M * N * F_, f32 * (M * N + F_ * N + M * F_)),
        "ln_gru_wgrad": bound_ms(2 * M * K * N + 3 * M * N, f32 * (M * K + 3 * M * N + K * N + 2 * N)),
    }
    instance = ln_gru.launch_layout(H_)[0]
    # what the streamed design moves besides: W_h read again each step by each cluster
    clusters = -(-B_ // ln_gru.ROWS_PER_CLUSTER)
    restream = T_ * clusters * f32 * H_ * N / PEAK_BYTES * 1e3 if instance == "streamed" else None
    return {"instance": instance, "times": t, "library": library, "bounds": bounds,
            "dW_torch_mm_ms": time_ms(lambda: torch.mm(xh2.t(), dyr2)),
            "no_product_ms": no_product_ms(torch, ln_gru, fwd_args, bwd_args), "w_h_restream_ms": restream}


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
    _, _, units, kt, (smem_fwd, smem_bwd) = ln_gru.launch_layout(H_)
    empty = lambda *shape: torch.empty(*shape, device=feats.device)  # noqa: E731
    fwd_out = (empty(T_, B_, H_), empty(T_, B_, 3 * H_), empty(T_, B_))
    bwd_out = (empty(B_, H_), empty(T_, B_, 3 * H_), empty(T_, B_, 3 * H_), empty(T_, B_, F_ + H_))
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn, args, dims, smem):
        rc = fn(*(a.data_ptr() for a in args), *dims, units, kt, smem, stream)
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
        instance, ctas, units, kt, smem = ln_gru.launch_layout(H_)
        out[label] = {"H": H_, "instance": instance, "cluster_ctas": ctas, "units_per_cta": units,
                      "w_h_tile_rows": kt, "smem_bytes": smem, "max_active_clusters": {"fwd": fwd, "bwd": bwd},
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
    from sheeprl_tpu_torch.telemetry.throughput import model_cost

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
        if mode in ("decoupled_kernel", "coupled") and dev.type == "cuda":
            profile = profile_step(torch, train, moments, {k: v[:1] for k, v in batches.items()}, gen,
                                   statistics.median(times))
        else:
            profile = None
        if mode == "decoupled_kernel":
            # the run's first burst: the same step with its operations and
            # bytes counted (the telemetry's MFU and roofline), host clock
            t0 = time.perf_counter()
            (moments, _), cost = model_cost(lambda: train(moments, {k: v[:1] for k, v in batches.items()},
                                                          generator=gen))
            torch.cuda.synchronize()
            counted = {"ms": (time.perf_counter() - t0) * 1e3, **cost}
        else:
            counted = None
        out[mode] = {
            "profile": profile,
            "ms_per_step": times,
            "cost_counted_step": counted,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": counts,
            "world_model_loss": [m["Loss/world_model_loss"] for m in losses],
            "policy_loss": [m["Loss/policy_loss"] for m in losses],
        }
        del wm, actor, critic, target, opts, train, batches
        torch.cuda.empty_cache()
    return out


# bf16-mixed held against 32-true on the same weights, batch and noise: every
# loss within BF16_TOL * max(1, |f32|). On the CPU the TINY_DV3 burst under
# bf16-mixed moves the losses by up to 0.9% from f32 (policy loss; the rest
# below 0.2%) and agrees with the JAX package's bf16 burst to 1%
# (tests/test_torch_precision.py); the JAX package's own bf16 test allows 5%
BF16_TOL = 0.05
BF16_KEYS = ("Loss/world_model_loss", "Loss/observation_loss", "Loss/reward_loss", "Loss/state_loss",
             "Loss/continue_loss", "Loss/policy_loss", "Loss/value_loss", "State/kl")


def phase_train_bf16(torch, ln_gru, dev="cuda"):
    """The coupled DreamerV3-S step under bf16-mixed at the bench shape: one
    step held against 32-true from the same weights on the same batch and
    noise, then ms/step, a profiled step and peak memory as for the f32
    modes; and decoupled with pallas_gru=True under bf16-mixed, where the
    LN-GRU kernels are not selected: no launch, and the UNUSED line."""
    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces

    dev = torch.device(dev)
    n_act = 9
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    base = ["exp=dreamer_v3", "env=dummy", f"algo.per_rank_batch_size={B}",
            f"algo.per_rank_sequence_length={T}", "algo.horizon=15"]

    def trainer(precision, extra=(), weights=None):
        cfg = compose("config", base + [f"fabric.precision={precision}", *extra])
        torch.manual_seed(0)
        mods = build_agent(cfg, space, [n_act], False, dev)
        if weights is not None:
            for m, w in zip(mods, weights):
                m.load_state_dict(w.state_dict())
        opts = dv3.build_optimizers(cfg, *mods[:3])
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            train = dv3.make_train_fn(*mods, opts, cfg, False, [n_act])
        return cfg, mods, train, err.getvalue()

    batches = make_batch(torch, 5, n_act, dev, seed=1)
    first = {k: v[:1] for k, v in batches.items()}
    cfg32, m32, train32, _ = trainer("32-true")
    _, m16, train16, _ = trainer("bf16-mixed", weights=m32)
    gen = torch.Generator(device=dev).manual_seed(3)
    noise = dv3.draw_train_noise(cfg32, T, B, [n_act], False, gen, dev)
    _, met32 = train32(init_moments(dev), first, noise=[noise])
    moments, met16 = train16(init_moments(dev), first, noise=[noise])
    vs = {k: {"f32": float(met32[k][0]), "bf16_mixed": float(met16[k][0])} for k in BF16_KEYS}
    for k, v in vs.items():
        if not np.isfinite(v["bf16_mixed"]) or abs(v["bf16_mixed"] - v["f32"]) > BF16_TOL * max(1.0, abs(v["f32"])):
            raise AssertionError(f"bf16-mixed {k} = {v['bf16_mixed']} against f32 {v['f32']} (tol {BF16_TOL})")
    del m32, train32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ln_gru.reset_launch_counts()
    times, losses = [], []
    for i in range(2, 5):
        t0 = time.perf_counter()
        moments, metrics = train16(moments, {k: v[i : i + 1] for k, v in batches.items()}, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v[0]) for k, v in metrics.items()})
    bad = [k for m in losses for k, v in m.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"bf16-mixed: non-finite {sorted(set(bad))}")
    out = {"coupled_bf16_mixed": {
        "profile": profile_step(torch, train16, moments, {k: v[1:2] for k, v in batches.items()}, gen,
                                statistics.median(times)),
        "ms_per_step": times,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "first_step_vs_f32": vs, "tol": BF16_TOL,
        "world_model_loss": [m["Loss/world_model_loss"] for m in losses],
        "policy_loss": [m["Loss/policy_loss"] for m in losses],
    }}
    del m16, train16
    torch.cuda.empty_cache()
    # decoupled, pallas_gru=True, under bf16-mixed: the kernels stay out
    _, mods, train, stderr = trainer("bf16-mixed", ["algo.world_model.decoupled_rssm=True",
                                                    "algo.world_model.pallas_gru=True"])
    if "UNUSED: mixed precision" not in stderr:
        raise AssertionError(f"no UNUSED line under bf16-mixed with pallas_gru=True: {stderr!r}")
    ln_gru.reset_launch_counts()
    _, metrics = train(init_moments(dev), first, generator=gen)
    torch.cuda.synchronize()
    counts = {k.__name__: k.launches for k in ln_gru.KERNELS}
    if max(counts.values()) != 0:
        raise AssertionError(f"LN-GRU kernels launched under bf16-mixed: {counts}")
    out["decoupled_kernel_bf16_mixed"] = {
        "launches": counts, "unused_line": [l for l in stderr.splitlines() if "UNUSED" in l],
        "world_model_loss": float(metrics["Loss/world_model_loss"][0])}
    del mods, train
    torch.cuda.empty_cache()
    return out


# the DreamerV3 presets whose GRU takes the streamed instance; decoupled,
# pallas_gru=True, f32, at bench_dv3.py's shape. M: three timed steps and
# its losses against pallas_gru=interpret; L and XL one timed step each
WIDE = {"M": 3, "L": 1, "XL": 1}
# the world model's losses on the kernels against the plain passes from the
# same weights, batch and noise: the LN-GRU's outputs differ in their last
# bits only, so these agree to KERNEL_TOL * max(1, |plain|); the actor's and
# critic's losses read the two-hot mean of zero-init heads (f32 cancellation
# noise, ROADMAP Queue 3 item 5) and are held to BF16_TOL instead
KERNEL_TOL = 1e-4
WM_KEYS = ("Loss/world_model_loss", "Loss/observation_loss", "Loss/reward_loss", "Loss/state_loss",
           "Loss/continue_loss", "State/kl")


def phase_train_wide(torch, ln_gru, dev="cuda"):
    """DreamerV3-M, L and XL decoupled on the LN-GRU kernels (the streamed
    instance) at the bench shape: ms/step on the host clock, one profiled
    step (device ms, kernel count), peak device memory and the LN-GRU launch
    counts (each > 0); at M also the first step held against
    pallas_gru=interpret on the same weights, batch and noise."""
    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import init_moments
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces

    dev = torch.device(dev)
    n_act = 9
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    out = {}
    for preset, n_steps in WIDE.items():
        base = ["exp=dreamer_v3", f"algo=dreamer_v3_{preset}", "env=dummy", f"algo.per_rank_batch_size={B}",
                f"algo.per_rank_sequence_length={T}", "algo.horizon=15", "algo.world_model.decoupled_rssm=True"]
        cfg = compose("config", base + ["algo.world_model.pallas_gru=True"])
        rm = cfg.algo.world_model.recurrent_model
        layout = ln_gru.launch_layout(int(rm.recurrent_state_size))
        torch.manual_seed(0)
        mods = build_agent(cfg, space, [n_act], False, dev)
        train = dv3.make_train_fn(*mods, dv3.build_optimizers(cfg, *mods[:3]), cfg, False, [n_act])
        batches = make_batch(torch, 1 + n_steps, n_act, dev, seed=1)
        first = {k: v[:1] for k, v in batches.items()}
        vs = None
        if preset == "M":  # the same weights, batch and noise through the plain passes
            pcfg = compose("config", base + ["algo.world_model.pallas_gru=interpret"])
            pmods = build_agent(pcfg, space, [n_act], False, dev)
            for m, w in zip(pmods, mods):
                m.load_state_dict(w.state_dict())
            ptrain = dv3.make_train_fn(*pmods, dv3.build_optimizers(pcfg, *pmods[:3]), pcfg, False, [n_act])
            noise = dv3.draw_train_noise(cfg, T, B, [n_act], False, torch.Generator(device=dev).manual_seed(3), dev)
            ln_gru.reset_launch_counts()
            _, plain = ptrain(init_moments(dev), first, noise=[noise])
            if max(k.launches for k in ln_gru.KERNELS) != 0:
                raise AssertionError("pallas_gru=interpret launched an LN-GRU kernel")
            _, kern = train(init_moments(dev), first, noise=[noise])
            vs = {k: {"kernels": float(kern[k][0]), "plain": float(plain[k][0])} for k in BF16_KEYS}
            for k, v in vs.items():
                tol = KERNEL_TOL if k in WM_KEYS else BF16_TOL
                if not abs(v["kernels"] - v["plain"]) <= tol * max(1.0, abs(v["plain"])):
                    raise AssertionError(f"M: {k} on the kernels {v['kernels']} against the plain passes "
                                         f"{v['plain']} (tol {tol})")
            del pmods, ptrain
            torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(0)
        moments, _ = train(init_moments(dev), first, generator=gen)  # warm-up
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
        if min(counts.values()) < n_steps:
            raise AssertionError(f"{preset}: kernel launches {counts} < {n_steps} each")
        bad = [k for m in losses for k, v in m.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{preset}: non-finite {sorted(set(bad))}")
        out[f"decoupled_kernel_{preset}"] = {
            "recurrent_state_size": int(rm.recurrent_state_size), "dense_units": int(rm.dense_units),
            "instance": layout[0], "units_per_cta": layout[2], "w_h_tile_rows": layout[3],
            "profile": profile_step(torch, train, moments, first, gen, statistics.median(times)),
            "ms_per_step": times, "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": counts,
            "world_model_loss": [m["Loss/world_model_loss"] for m in losses],
            "policy_loss": [m["Loss/policy_loss"] for m in losses],
            "first_step_vs_plain": vs, "tol": {"world_model": KERNEL_TOL, "actor_critic": BF16_TOL} if vs else None,
        }
        del mods, train, batches
        torch.cuda.empty_cache()
    return out


FEED_ENVS, FEED_ROWS = 4, 8192  # 4 x 8192 rows of 64x64x3 uint8 + 9 actions: about 404 MB


def phase_feed(torch, dev="cuda", reps=10):
    """One burst's replay feed at DreamerV3-S's bench shape (G=1, T=64,
    B=16, 64x64x3 uint8, 9 actions) from a memmap buffer of about 404 MB,
    three ways: the synchronous sample with a pageable copy, the staged
    prefetcher (pinned buffers, copy stream) and the device ring. Host ms on
    this (the learner's) thread and device ms of each; the three batches
    bitwise equal for the same generator state; the ring's sync bytes per
    burst and its gather against the bound; the native gather against the
    numpy one."""
    import copy as _copy

    import numpy as np

    from sheeprl_tpu_torch.data import EnvIndependentReplayBuffer, native
    from sheeprl_tpu_torch.data.device_ring import DeviceRingPrefetcher, _gather_batch
    from sheeprl_tpu_torch.data.prefetch import StagedPrefetcher

    status = native.status()
    if not status["loaded"]:
        raise AssertionError(f"the native replay gather did not load: {status['reason']}")
    dev = torch.device(dev)
    n_act, G = 9, 1
    mdir = os.path.join(HERE, "logs", "chip_smoke_feed")
    shutil.rmtree(mdir, ignore_errors=True)
    rb = EnvIndependentReplayBuffer(FEED_ROWS, n_envs=FEED_ENVS, obs_keys=("rgb",), memmap=True, memmap_dir=mdir,
                                    seed=0)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(FEED_ROWS // 1024):
        n = (1024, FEED_ENVS)
        rb.add({"rgb": rng.integers(0, 256, n + (64, 64, 3), np.uint8),
                "actions": np.eye(n_act, dtype=np.float32)[rng.integers(0, n_act, n)],
                "rewards": rng.standard_normal(n + (1,)).astype(np.float32),
                "terminated": np.zeros(n + (1,), np.float32), "truncated": np.zeros(n + (1,), np.float32),
                "is_first": (rng.random(n + (1,)) < 0.01).astype(np.float32)})
    fill_s = time.perf_counter() - t0
    stored = sum(np.asarray(b._buf[k]).nbytes for b in rb.buffer for k in b.keys())

    def snap():
        return _copy.deepcopy([rb._rng.bit_generator.state] + [b._rng.bit_generator.state for b in rb.buffer])

    def restore(st):
        rb._rng.bit_generator.state = st[0]
        for b, s_ in zip(rb.buffer, st[1:]):
            b._rng.bit_generator.state = s_

    def host_sample(g, out=None):
        s_ = rb.sample(B, sequence_length=T, n_samples=g, out=out)
        return {k: v if k == "rgb" else np.asarray(v, np.float32) for k, v in s_.items()}

    s0 = snap()
    out = {"buffer_bytes": stored, "fill_s": fill_s, "native": status}

    # 1. the synchronous sample and a pageable copy (the loop before this feed)
    host, dev_ms, ref = [], [], None
    for _ in range(reps):
        restore(s0)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        sample = host_sample(G)
        a.record()
        batch = {k: torch.from_numpy(v).to(dev, non_blocking=True) for k, v in sample.items()}
        b.record()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        dev_ms.append(a.elapsed_time(b))
        if ref is None:
            ref = {k: v.cpu() for k, v in batch.items()}
    batch_bytes = sum(v.numel() * v.element_size() for v in ref.values())
    out["sync"] = {"host_ms": statistics.median(host), "copy_device_ms": statistics.median(dev_ms),
                   "gb_per_s": batch_bytes / statistics.median(dev_ms) / 1e6, "batch_bytes": batch_bytes}

    def same(batch, name):
        for k, v in ref.items():
            if not torch.equal(batch[k].cpu(), v):
                raise AssertionError(f"{name}: '{k}' differs from the synchronous sample")

    # 2. the staged prefetcher: stage (sample into pinned memory, copy on its
    # stream), then take (the consumer's stream waits on the copy's event)
    pf = StagedPrefetcher(host_sample, dev)
    restore(s0)
    pf.stage(G)
    same(pf.take(G), "staged")
    stage_ms, take_ms, copy_ms = [], [], []
    for _ in range(reps):
        restore(s0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pf.stage(G)
        t1 = time.perf_counter()
        got = pf.take(G)
        t2 = time.perf_counter()
        stage_ms.append((t1 - t0) * 1e3)
        take_ms.append((t2 - t1) * 1e3)
        copy_ms.append(pf.last_copy()["ms"])
    same(got, "staged")
    out["staged"] = {"host_ms": statistics.median(stage_ms) + statistics.median(take_ms),
                     "stage_host_ms": statistics.median(stage_ms), "take_host_ms": statistics.median(take_ms),
                     "copy_device_ms": statistics.median(copy_ms),
                     "gb_per_s": batch_bytes / statistics.median(copy_ms) / 1e6}

    # 3. the device ring: the whole buffer crosses once, then per burst only
    # the new rows; the batch is gathered on the card
    ring = DeviceRingPrefetcher(rb, B, T, cnn_keys=("rgb",), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring.sync()
    torch.cuda.synchronize()
    first_sync = {"s": time.perf_counter() - t0, "bytes": ring.synced_bytes}
    restore(s0)
    ring.stage(G)
    same(ring.take(G), "ring")
    t_idx, env_order = ring._last_idx
    ti, ei = torch.from_numpy(t_idx).to(dev), torch.from_numpy(env_order).to(dev)
    gather_ms = time_ms(lambda: _gather_batch(ring.ring, ti, ei, ring._f32_keys()))
    host = []
    for _ in range(reps):
        restore(s0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring.stage(G)
        ring.take(G)
        host.append((time.perf_counter() - t0) * 1e3)
    # one loop iteration's new rows (one per env), then the next burst's sync
    before = ring.synced_bytes
    n = (1, FEED_ENVS)
    rb.add({"rgb": np.zeros(n + (64, 64, 3), np.uint8), "actions": np.zeros(n + (n_act,), np.float32),
            "rewards": np.zeros(n + (1,), np.float32), "terminated": np.zeros(n + (1,), np.float32),
            "truncated": np.zeros(n + (1,), np.float32), "is_first": np.zeros(n + (1,), np.float32)})
    ring.stage(G)
    torch.cuda.synchronize()
    out["ring"] = {"host_ms": statistics.median(host), "gather_device_ms": gather_ms,
                   "gather_bound_ms": 2 * batch_bytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
                   "sync_bytes_per_burst": ring.synced_bytes - before, "first_sync": first_sync,
                   "ring_bytes": sum(v.numel() * v.element_size() for v in ring.ring.values())}
    del ring

    # the native gather against numpy's, on the same draws
    restore(s0)
    native_batch = rb.sample(B, sequence_length=T, n_samples=G)
    nat, npy = [], []
    gather_rows = native.gather_rows
    try:
        for _ in range(reps):  # the two in turn, so neither pays for the other's first touches
            for use in (True, False):
                # None is what the gather gives where it is not built: numpy's runs
                native.gather_rows = gather_rows if use else (lambda *a: None)
                restore(s0)
                t0 = time.perf_counter()
                got = rb.sample(B, sequence_length=T, n_samples=G)
                (nat if use else npy).append((time.perf_counter() - t0) * 1e3)
    finally:
        native.gather_rows = gather_rows
    for k, v in got.items():
        if not np.array_equal(v, native_batch[k]):
            raise AssertionError(f"native gather: '{k}' differs from numpy's")
    out["sample_host_ms"] = {"native": statistics.median(nat), "numpy": statistics.median(npy)}
    del rb
    shutil.rmtree(mdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# the run legs: DreamerV3-S on the dummy env, two envs, 64 policy steps of
# random actions, then one gradient step per iteration (replay ratio 0.5)
LEARNING_STARTS, TOTAL, RESUME_TOTAL, HOST_TOTAL = 128, 256, 320, 192
RUN_ROOT = "chip_smoke"  # logs/runs/chip_smoke/<leg>/version_N, removed at the end
ALGOS = ("dreamer_v3", "ppo", "a2c", "ppo_recurrent", "sac", "droq", "sac_ae", "dreamer_v2",
         "dreamer_v1", "p2e_dv3_exploration", "p2e_dv3_finetuning", "p2e_dv2_exploration", "p2e_dv2_finetuning",
         "p2e_dv1_exploration", "p2e_dv1_finetuning")  # the `[<algo>] log_dir=` lines
# the on-policy legs: the presets' algorithm settings on the dummy envs, 4 envs
# (PPO: 128-step rollouts, 8 updates of 10 epochs x 8 minibatches of 64)
PPO_TOTAL, PPO_SHORT, PPO_RESUME_TOTAL, A2C_TOTAL = 4096, 2048, 6144, 2000
# the off-policy legs: the presets' algorithm settings and widths on the
# continuous dummy env, 4 envs, cut in length and buffer size only
SAC_TOTAL, SAC_RESUME_TOTAL, SAC_BUFFER, DROQ_TOTAL = 1024, 1536, 1024, 256
AE_LEARNING_STARTS, AE_TOTAL, AE_BUFFER = 64, 128, 256


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
    """The numbers a leg left: its log dir, resumed state and test reward
    from the lines it printed; from its telemetry stream (validated by the
    port's ``validate_jsonl``, events counted by type) the startup record,
    the log records (policy step, gradient steps, elapsed seconds, MFU,
    memory, the player mirror's statistics), the engine's overlap records
    and the checkpoint writer's records."""
    from sheeprl_tpu_torch.telemetry.schema import validate_jsonl

    out = {"log_dir": None, "lines": [], "overlap": [], "mirror": [], "ckpt": [], "resumed": None, "reward": None,
           "logs": [], "startup": None, "events": {}, "from_exploration": None, "acting": []}
    for line in text.splitlines():
        algo = line[1:line.index("]")] if line.startswith("[") and "]" in line else None
        if algo in ALGOS and line.startswith(f"[{algo}] log_dir="):
            out["log_dir"] = line.split("=", 1)[1]
        elif algo in ALGOS and line.startswith(f"[{algo}] resumed "):
            out["resumed"] = json.loads(line[len(f"[{algo}] resumed "):])
        elif algo in ALGOS and line.startswith(f"[{algo}] from exploration "):
            out["from_exploration"] = json.loads(line[len(f"[{algo}] from exploration "):])
        elif algo in ALGOS and line.startswith(f"[{algo}] the player acts with the "):
            words = line.split()  # [<algo>] the player acts with the <kind> actor from policy step <n>
            out["acting"].append((words[6], int(words[-1])))
        elif line.startswith("Test - Reward: "):
            out["reward"] = float(line.split(": ", 1)[1])
    if out["log_dir"] is None:
        return out
    path = os.path.join(out["log_dir"], "telemetry.jsonl")
    errors = validate_jsonl(path)
    if errors:
        raise AssertionError(f"{path} fails the schema: {errors[:5]}")
    with open(path) as fh:
        for rec in map(json.loads, fh):
            kind = rec["event"]
            out["events"][kind] = out["events"].get(kind, 0) + 1
            if kind == "startup":
                out["startup"] = rec
            elif kind == "log":
                out["logs"].append(rec)
                out["lines"].append({"policy_step": rec["step"], "grad_steps": rec["grad_steps"],
                                     "elapsed_s": rec["elapsed_s"]})
                if "mirror" in rec:
                    out["mirror"].append(rec["mirror"])
            elif kind == "overlap":
                out["overlap"].append(rec)
            elif kind == "ckpt_async":
                out["ckpt"].append(rec)
    return out


def drive(torch, ln_gru, command, argv):
    """One CLI call in this process, its output kept; returns (parsed,
    launch counts, seconds, peak device memory)."""
    from sheeprl_tpu_torch import cli

    tee = _Tee()
    gc.collect()  # an earlier leg's reference cycles (closures over its loop's tensors) still hold device memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ln_gru.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        {"run": cli.run, "eval": cli.evaluation, "resume": cli.resume}[command](argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in ln_gru.KERNELS}
    parsed = parse_leg(tee.buf.getvalue())
    start = parsed["startup"]
    if command != "eval" and (start is None or start["platform"] != "gpu"
                             or start["device_kind"] != torch.cuda.get_device_name(0)):
        raise AssertionError(f"the leg's startup record {start} does not name the card")
    return parsed, counts, seconds, torch.cuda.max_memory_allocated()


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
    mfu = [l["throughput"]["mfu"] for l in parsed["logs"] if "mfu" in l["throughput"]]
    out = {"seconds": seconds, "policy_step": int(last["policy_step"]), "grad_steps": int(last["grad_steps"]),
           "policy_steps_per_s_after_learning_starts": sps,
           "sps_window": [first["policy_step"], last["policy_step"]], "peak_device_memory": peak,
           "launches": counts, "mirror": parsed["mirror"][-1] if parsed["mirror"] else None,
           "telemetry": {"events": parsed["events"], "mfu": mfu,
                         "hbm_peak_bytes": max(l["memory"].get("hbm_peak_bytes", 0) for l in parsed["logs"]),
                         "h2d_bytes": parsed["logs"][-1]["device"].get("h2d_bytes"),
                         "device_kind": parsed["startup"]["device_kind"]}}
    if trains and not mfu:
        raise AssertionError("the leg's log records carry no MFU")
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


def run_common(overrides=()):
    """The arguments every DreamerV3-S leg of phase 5 shares."""
    return [
        "exp=dreamer_v3", "env=dummy", "algo.world_model.decoupled_rssm=True", "algo.world_model.pallas_gru=True",
        "env.num_envs=2", f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}",
        f"algo.learning_starts={LEARNING_STARTS}", "algo.replay_ratio=0.5", "buffer.size=1024",
        "metric.log_every=32", "checkpoint.every=96", "checkpoint.save_last=True", "algo.run_test=False",
        f"root_dir={RUN_ROOT}", *overrides,
    ]


def phase_run(torch, ln_gru, overrides=()):
    """The legs of phase 5; returns (the run leg's counts, blocks, report)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import param_sums

    common = run_common(overrides)
    report = {}
    # the default overlapped loop
    run_args = common + [f"algo.total_steps={TOTAL}", "run_name=run"]
    parsed, counts, seconds, peak = drive(torch, ln_gru, "run", run_args)
    # the grid of each kernel's last launch on this leg, as its entry recorded it
    blocks = {k.__name__: int(ln_gru._lib().ln_gru_last_blocks(i)) for i, k in enumerate(ln_gru.KERNELS)}
    report["run"] = leg_summary(parsed, counts, seconds, peak, LEARNING_STARTS)
    report["run"]["args"] = run_args
    m_args = common + ["algo=dreamer_v3_M", f"algo.total_steps={HOST_TOTAL}", "run_name=run_M"]
    parsed_m, counts_m, seconds_m, peak_m = drive(torch, ln_gru, "run", m_args)
    blocks_m = {k.__name__: int(ln_gru._lib().ln_gru_last_blocks(i)) for i, k in enumerate(ln_gru.KERNELS)}
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
    # DreamerV3-M decoupled on the kernels: the streamed instance on the main path
    report["run_M"] = leg_summary(parsed_m, counts_m, seconds_m, peak_m, LEARNING_STARTS)
    report["run_M"]["args"] = m_args
    report.update(walker_legs(torch, ln_gru))
    report.update(ppo_legs(torch, ln_gru))
    report.update(offpolicy_legs(torch, ln_gru))
    report.update(dreamer_legs(torch, ln_gru))
    p2e, counts_xl, blocks_xl = p2e_legs(torch, ln_gru)
    report.update(p2e)
    shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
    launches = {"S": report["run"]["launches"], "M": report["run_M"]["launches"], "XL": counts_xl}
    return launches, {"S": blocks, "M": blocks_m, "XL": blocks_xl}, report


def onpolicy_summary(parsed, seconds, peak):
    """The numbers of one on-policy leg, from its telemetry stream: policy
    steps/s between its first and last log records (from the start where it
    logged once), the mean update wall ms, and the allocator's peak over the
    leg (``device_memory_at_start`` beside it is what earlier legs still
    hold; the leg's own is the difference)."""
    logs = parsed["logs"]
    if not logs:
        raise AssertionError("the leg wrote no log record")
    first, last = logs[0], logs[-1]
    if last["elapsed_s"] > first["elapsed_s"]:
        sps = (last["step"] - first["step"]) / (last["elapsed_s"] - first["elapsed_s"])
    else:
        sps = last["step"] / last["elapsed_s"]
    update_ms = [r["update_ms"] for r in logs if r.get("update_ms") is not None]
    written = [r for r in parsed["ckpt"] if r["action"] == "written"]
    if any(r["action"] == "failed" for r in parsed["ckpt"]):
        raise AssertionError(f"a checkpoint write failed: {parsed['ckpt']}")
    return {"seconds": seconds, "policy_step": int(last["step"]), "updates": int(last["updates"]),
            "grad_steps": int(last["grad_steps"]), "policy_steps_per_s": sps,
            "update_ms": statistics.mean(update_ms) if update_ms else None, "peak_device_memory": peak,
            "telemetry": {"events": parsed["events"], "device_kind": parsed["startup"]["device_kind"],
                          "hbm_peak_bytes": max(r["memory"].get("hbm_peak_bytes", 0) for r in logs)},
            "checkpoints": [r["step"] for r in written]}


def agent_ledger(torch, path):
    """What must match between two PPO legs: the counters of the checkpoint
    and the agent's parameters."""
    s = torch.load(path, map_location="cpu", weights_only=False)
    return {k: s[k] for k in ("policy_step", "update", "last_log", "last_checkpoint")}, s["agent"]


def same_agent(torch, a, b):
    """(bitwise equal, largest difference) of two agents' parameters."""
    diff = max(float((a[k].double() - b[k].double()).abs().max()) for k in a)
    return all(torch.equal(a[k], b[k]) for k in a), diff


def ppo_legs(torch, ln_gru):
    """The on-policy family on the card (phase 5): PPO overlapped (strict
    on-policy) with a mid-run checkpoint, serial (equal ledger and
    parameters), on pixels (NatureCNN at 64x64x3), continuous (Normal
    heads), A2C and PPO-recurrent at their presets' algorithm settings, the
    resume command and eval from the PPO leg, and the PPO leg again with the
    watchdog on (no event, the same end)."""
    from sheeprl_tpu_torch.utils.checkpoint import param_sums

    common = ["env=dummy", "metric.log_every=1024", "algo.run_test=False", f"root_dir={RUN_ROOT}"]
    ppo = ["exp=ppo", *common, f"algo.total_steps={PPO_TOTAL}", "checkpoint.every=2048"]
    report, logs = {}, {}

    def leg(name, args, command="run"):
        gc.collect()
        before = torch.cuda.memory_allocated()  # what earlier legs still hold: not this leg's
        parsed, counts, seconds, peak = drive(torch, ln_gru, command,
                                              args + ([f"run_name={name}"] if command == "run" else []))
        if command != "eval":
            report[name] = onpolicy_summary(parsed, seconds, peak)
            report[name]["device_memory_at_start"] = before
            report[name]["args"] = args
            logs[name] = parsed["log_dir"]
        if any(counts.values()):
            raise AssertionError(f"the {name} leg launched LN-GRU kernels: {counts}")
        return parsed

    leg("ppo", ppo)
    ckpts = checkpoints(logs["ppo"])
    if [int(os.path.basename(p)[5:-5]) for p in ckpts] != [2048, PPO_TOTAL]:
        raise AssertionError(f"the ppo leg's checkpoints {ckpts}: not a mid-run one and the last one")
    eng = [r for r in (json.loads(l) for l in open(os.path.join(logs["ppo"], "telemetry.jsonl")))
           if r["event"] == "overlap"]
    if not eng or eng[-1].get("staleness_seen_max", 1) != 0:
        raise AssertionError(f"the ppo leg's overlap records {eng[-1:] or None}: not strict on-policy")
    report["ppo"]["engine"] = {"records": len(eng), "staleness_seen_max": eng[-1]["staleness_seen_max"],
                               "player_stall_frac": eng[-1]["player_stall_frac"]}
    ppo_ledger, ppo_agent = agent_ledger(torch, ckpts[-1])
    if ppo_ledger["policy_step"] != PPO_TOTAL or ppo_ledger["update"] != PPO_TOTAL // 512:
        raise AssertionError(f"the ppo leg ended at {ppo_ledger}")
    for name, extra in (("ppo_serial", ["algo.overlap.enabled=False"]),
                        ("ppo_watchdog", ["resilience.watchdog.enabled=True", "resilience.watchdog.stall_s=600"])):
        leg(name, ppo + extra)
        got, agent = agent_ledger(torch, checkpoints(logs[name])[-1])
        bitwise, diff = same_agent(torch, ppo_agent, agent)
        if got != ppo_ledger or not bitwise:
            raise AssertionError(f"the {name} leg ended at {got} (max parameter difference {diff}), the ppo leg at "
                                 f"{ppo_ledger}")
        report[name]["ledger_equal"] = ppo_ledger
        report[name]["parameters_bitwise_equal"] = bitwise
    if report["ppo_watchdog"]["telemetry"]["events"].get("watchdog"):
        raise AssertionError("the watchdog fired on the ppo_watchdog leg")
    leg("ppo_pixels", ["exp=ppo", *common, f"algo.total_steps={PPO_SHORT}", "algo.cnn_keys.encoder=[rgb]",
                       "algo.mlp_keys.encoder=[]"])
    leg("ppo_continuous", ["exp=ppo", *common, "env.id=continuous_dummy", f"algo.total_steps={PPO_SHORT}"])
    leg("a2c", ["exp=a2c", *common, f"algo.total_steps={A2C_TOTAL}", "metric.log_every=400"])
    # the preset's rollout of 512 steps at 8 envs: one update of 4096 policy steps
    leg("ppo_recurrent", ["exp=ppo_recurrent", *common, f"algo.total_steps={PPO_TOTAL}", "env.num_envs=8"])
    for name, want in (("ppo_pixels", PPO_SHORT), ("ppo_continuous", PPO_SHORT), ("a2c", A2C_TOTAL),
                       ("ppo_recurrent", PPO_TOTAL)):
        if report[name]["policy_step"] != want or report[name]["grad_steps"] < 1:
            raise AssertionError(f"the {name} leg stopped at {report[name]['policy_step']} of {want}")

    saved = torch.load(ckpts[-1], map_location="cpu", weights_only=False)
    parsed = leg("ppo_resume_cmd", [f"run_dir={os.path.dirname(logs['ppo'])}",
                                    f"algo.total_steps={PPO_RESUME_TOTAL}"], command="resume")
    started, want = parsed["resumed"], {"policy_step": saved["policy_step"], "update": saved["update"]}
    if started is None or {k: started[k] for k in want} != want:
        raise AssertionError(f"the resume command started from {started}, the checkpoint holds {want}")
    file_sums = param_sums({"agent": saved["agent"]})
    if abs(started["param_sums"]["agent"] - file_sums["agent"]) > 1e-9 * max(1.0, abs(file_sums["agent"])):
        raise AssertionError(f"resumed parameters sum to {started['param_sums']}, the file's to {file_sums}")
    if report["ppo_resume_cmd"]["policy_step"] != PPO_RESUME_TOTAL:
        raise AssertionError(f"the resume command stopped at {report['ppo_resume_cmd']['policy_step']}")
    report["ppo_resume_cmd"].update(started_from=want, param_sums=file_sums)

    t0 = time.perf_counter()
    parsed = leg("ppo_eval", [f"checkpoint_path={ckpts[-1]}"], command="eval")
    if parsed["reward"] is None:
        raise AssertionError("eval printed no `Test - Reward:`")
    report["ppo_eval"] = {"seconds": time.perf_counter() - t0, "reward": parsed["reward"],
                          "checkpoint": os.path.basename(ckpts[-1])}
    return report


def offpolicy_summary(parsed, seconds, peak, before, learning_starts):
    """The numbers of one off-policy leg, from its telemetry stream: policy
    steps/s between its first log record at or after ``learning_starts`` and
    its last, the mean burst wall ms (``update_ms``: a burst's G gradient
    steps up to its losses on the host), gradient steps, and the
    allocator's peak less what earlier legs still held (``before``)."""
    logs = parsed["logs"]
    if not logs:
        raise AssertionError("the leg wrote no log record")
    after = [r for r in logs if r["step"] >= learning_starts] or logs
    first, last = after[0], logs[-1]
    sps = ((last["step"] - first["step"]) / (last["elapsed_s"] - first["elapsed_s"])
           if last["elapsed_s"] > first["elapsed_s"] else None)
    update_ms = [r["update_ms"] for r in logs if r.get("update_ms") is not None]
    if any(r["action"] == "failed" for r in parsed["ckpt"]):
        raise AssertionError(f"a checkpoint write failed: {parsed['ckpt']}")
    mfu = [r["throughput"]["mfu"] for r in logs if "mfu" in r.get("throughput", {})]
    return {"seconds": seconds, "policy_step": int(last["step"]), "grad_steps": int(last["grad_steps"]),
            "policy_steps_per_s_after_learning_starts": sps, "sps_window": [first["step"], last["step"]],
            "update_ms": statistics.mean(update_ms) if update_ms else None, "mfu": mfu[-1] if mfu else None,
            "peak_device_memory": peak, "device_memory_at_start": before, "own_peak_device_memory": peak - before,
            "telemetry": {"events": parsed["events"], "device_kind": parsed["startup"]["device_kind"]},
            "checkpoints": [r["step"] for r in parsed["ckpt"] if r["action"] == "written"]}


def make_leg(torch, ln_gru, report, logs, feeds):
    """``leg(name, args, learning_starts, command="run", kernels=False)``:
    one CLI call (``drive``) that must launch no LN-GRU kernel (with
    ``kernels``: every one of the five at least once); its summary
    (``offpolicy_summary``; an eval's reward) lands in ``report[name]``, its
    log dir in ``logs`` and the replay feed it took (its ``[prefetch]``
    line) in ``feeds``. Returns the parsed leg."""

    def leg(name, args, learning_starts, command="run", kernels=False):
        gc.collect()
        before = torch.cuda.memory_allocated()  # what earlier legs still hold: not this leg's
        err = io.StringIO()

        class _Err(io.TextIOBase):  # the [prefetch] line says which feed the leg took
            def write(self, text):
                err.write(text)
                return sys.__stderr__.write(text)

        with contextlib.redirect_stderr(_Err()):
            parsed, counts, seconds, peak = drive(torch, ln_gru, command,
                                                  args + ([f"run_name={name}"] if command == "run" else []))
        if (min(counts.values()) < 1) if kernels else any(counts.values()):
            raise AssertionError(f"the {name} leg launched LN-GRU kernels {counts}, "
                                 f"{'each >= 1' if kernels else 'none'} expected")
        if command == "eval":
            if parsed["reward"] is None:
                raise AssertionError(f"{name} printed no `Test - Reward:`")
            report[name] = {"seconds": seconds, "reward": parsed["reward"]}
            return parsed
        report[name] = offpolicy_summary(parsed, seconds, peak, before, learning_starts)
        report[name]["args"] = args
        feeds[name] = [l.split()[1] for l in err.getvalue().splitlines() if l.startswith("[prefetch] ")]
        report[name]["feed"] = feeds[name]
        report[name]["launches"] = counts
        logs[name] = parsed["log_dir"]
        return parsed

    return leg


def offpolicy_ledger(torch, path):
    """What must match between two SAC legs: the Ratio ledger and counters,
    the buffer's fill, and (for a bitwise comparison) the agent."""
    s = torch.load(path, map_location="cpu", weights_only=False)
    return {"policy_step": s["policy_step"], "grad_steps": s["grad_steps"], "ratio": s["ratio"],
            "opt_step": s["opt_states"]["step"], "rb": (s["rb"]["pos"], s["rb"]["full"])}, s["agent"]


def sac_ae_step(torch, ln_gru, dev="cuda", reps=3):
    """One SAC-AE gradient step at the preset's full width (multiplier 16:
    512 channels, features 64, hidden 1024, batch 128, 64x64x3 frames,
    32-true, TF32 off) through make_train_fn, in the form of phase train:
    host ms of timed steps, one step under torch.profiler (device ms, kernel
    count, busy share, top kernels), the step's model FLOPs counted once
    (model_cost) and MFU against the f32 peak, and peak device memory."""
    import numpy as np

    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import build_optimizers, make_train_fn
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.dummy import ContinuousDummyEnv
    from sheeprl_tpu_torch.parallel.precision import disable_tf32
    from sheeprl_tpu_torch.telemetry.throughput import model_cost

    disable_tf32()
    cfg = compose("config", ["exp=sac_ae", "env=dummy", "env.id=continuous_dummy"])
    env = ContinuousDummyEnv()
    torch.manual_seed(0)
    agent = build_agent(cfg, env.observation_space, env.action_space, dev)
    train = make_train_fn(agent, build_optimizers(cfg, agent), cfg, -2.0, ("rgb",), ())
    b = int(cfg.algo.per_rank_batch_size)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {k: torch.randint(0, 256, (1, b, 64, 64, 3), dtype=torch.uint8, device=dev, generator=g)
             for k in ("rgb", "next_rgb")}
    batch.update(actions=torch.rand((1, b, 2), device=dev, generator=g) * 2 - 1,
                 rewards=torch.randn((1, b, 1), device=dev, generator=g),
                 terminated=torch.zeros((1, b, 1), device=dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    train(batch, generator=gen)  # warm-up: cuDNN's algorithm choice, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ln_gru.reset_launch_counts()
    times, losses = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        m = train(batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in m.items()})
    if not all(np.isfinite(v) for l in losses for v in l.values()):
        raise AssertionError(f"sac_ae step: non-finite losses {losses}")
    if any(k.launches for k in ln_gru.KERNELS):
        raise AssertionError("the SAC-AE step launched LN-GRU kernels")
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times)
    profile = profile_step(torch, lambda _m, bt, generator=None: train(bt, generator=generator), None, batch, gen,
                           step_ms)
    _, cost = model_cost(lambda: train(batch, generator=gen))
    device_ms = profile.get("device_ms")
    return {"model": "SAC-AE preset (multiplier 16, features 64, hidden 1024), batch 128, 64x64x3, 32-true",
            "ms_per_step": times, "profile": profile, "model_flops_per_step": cost["flops"],
            "bytes_per_step": cost["bytes_accessed"],
            "mfu_f32": cost["flops"] / (step_ms / 1e3) / PEAK_F32_FLOPS,
            "mfu_f32_device_time": (cost["flops"] / (device_ms / 1e3) / PEAK_F32_FLOPS
                                    if isinstance(device_ms, float) else "not measured"),
            "max_memory_allocated": peak, "losses": losses}


def offpolicy_legs(torch, ln_gru):
    """The off-policy family on the card (phase 5), on the continuous dummy
    env at 4 envs with the presets' algorithm settings and widths, cut in
    length and buffer size: SAC overlapped and serial (equal ledgers), the
    serial leg again on the staged host feed (bitwise-equal parameters: the
    ring's batches are the staged feed's), DroQ, SAC-AE at full width, a
    resume from the SAC leg's mid-run checkpoint (which holds the buffer),
    eval of each, and one profiled SAC-AE gradient step. No leg launches an
    LN-GRU kernel."""
    from sheeprl_tpu_torch.utils.checkpoint import param_sums

    common = ["env=dummy", "env.id=continuous_dummy", "env.num_envs=4", "algo.run_test=False",
              f"root_dir={RUN_ROOT}"]
    sac = ["exp=sac", *common, f"algo.total_steps={SAC_TOTAL}", f"buffer.size={SAC_BUFFER}", "checkpoint.every=512",
           "metric.log_every=256"]
    report, logs, feeds = {}, {}, {}
    leg = make_leg(torch, ln_gru, report, logs, feeds)

    leg("sac", sac, 100)
    ckpts = checkpoints(logs["sac"])
    steps = [int(os.path.basename(p)[5:-5]) for p in ckpts]  # overlapped: a mid-run one where a take crossed 512
    if len(steps) != 2 or not 100 < steps[0] < SAC_TOTAL or steps[-1] != SAC_TOTAL:
        raise AssertionError(f"the sac leg's checkpoints {ckpts}: not a mid-run one and the last one")
    eng = [r for r in (json.loads(l) for l in open(os.path.join(logs["sac"], "telemetry.jsonl")))
           if r["event"] == "overlap"]
    if not eng or eng[-1].get("staleness_seen_max", 0) > 1:
        raise AssertionError(f"the sac leg's overlap records {eng[-1:] or None}: no engine, or staleness above 1")
    report["sac"]["engine"] = {"records": len(eng), "staleness_seen_max": eng[-1]["staleness_seen_max"],
                               "player_stall_frac": eng[-1]["player_stall_frac"]}
    sac_ledger, _ = offpolicy_ledger(torch, ckpts[-1])
    leg("sac_serial", sac + ["algo.overlap.enabled=False"], 100)
    serial_ledger, serial_agent = offpolicy_ledger(torch, checkpoints(logs["sac_serial"])[-1])
    if serial_ledger != sac_ledger or sac_ledger["policy_step"] != SAC_TOTAL:
        raise AssertionError(f"ledgers differ: overlapped {sac_ledger}, serial {serial_ledger}")
    report["sac_serial"]["ledger_equal"] = sac_ledger
    leg("sac_staged", sac + ["algo.overlap.enabled=False", "buffer.device_cache=false"], 100)
    if feeds["sac_serial"] != ["DeviceUniformRingPrefetcher"] or feeds["sac_staged"] != ["StagedPrefetcher"]:
        raise AssertionError(f"feeds: sac_serial {feeds['sac_serial']}, sac_staged {feeds['sac_staged']}")
    staged_ledger, staged_agent = offpolicy_ledger(torch, checkpoints(logs["sac_staged"])[-1])
    bitwise, diff = same_agent(torch, serial_agent, staged_agent)
    if staged_ledger != serial_ledger or not bitwise:
        raise AssertionError(f"sac_staged ended at {staged_ledger} (max parameter difference {diff}), sac_serial "
                             f"at {serial_ledger}")
    report["sac_staged"].update(ledger_equal=serial_ledger, parameters_bitwise_equal=bitwise)

    leg("droq", ["exp=droq", *common, f"algo.total_steps={DROQ_TOTAL}", "buffer.size=256", "checkpoint.every=0",
                 "metric.log_every=64"], 100)
    leg("sac_ae", ["exp=sac_ae", *common, f"algo.total_steps={AE_TOTAL}",
                   f"algo.learning_starts={AE_LEARNING_STARTS}", f"buffer.size={AE_BUFFER}", "checkpoint.every=0",
                   "metric.log_every=32"], AE_LEARNING_STARTS)
    for name, total in (("droq", DROQ_TOTAL), ("sac_ae", AE_TOTAL)):
        if report[name]["policy_step"] != total or report[name]["grad_steps"] < 1:
            raise AssertionError(f"the {name} leg stopped at {report[name]['policy_step']} of {total}")
    if report["sac_ae"]["grad_steps"] != AE_TOTAL - AE_LEARNING_STARTS:
        raise AssertionError(f"the sac_ae leg took {report['sac_ae']['grad_steps']} gradient steps")

    saved = torch.load(ckpts[0], map_location="cpu", weights_only=False)
    parsed = leg("sac_resume", [a for a in sac if not a.startswith("algo.total_steps=")] + [
        f"algo.total_steps={SAC_RESUME_TOTAL}", f"checkpoint.resume_from={ckpts[0]}"], 100)
    started = parsed["resumed"]
    want = {"policy_step": saved["policy_step"], "grad_steps": saved["grad_steps"], "ratio": saved["ratio"]}
    if started is None or {k: started[k] for k in want} != want:
        raise AssertionError(f"sac_resume started from {started}, the checkpoint holds {want}")
    file_sums = param_sums({"agent": saved["agent"]})
    if abs(started["param_sums"]["agent"] - file_sums["agent"]) > 1e-9 * max(1.0, abs(file_sums["agent"])):
        raise AssertionError(f"resumed parameters sum to {started['param_sums']}, the file's to {file_sums}")
    if report["sac_resume"]["policy_step"] != SAC_RESUME_TOTAL or "rb" not in saved:
        raise AssertionError(f"sac_resume stopped at {report['sac_resume']['policy_step']}")
    report["sac_resume"].update(started_from=want, param_sums=file_sums, checkpoint=os.path.basename(ckpts[0]))

    for name in ("sac", "droq", "sac_ae"):
        leg(f"{name}_eval", [f"checkpoint_path={checkpoints(logs[name])[-1]}"], 0, command="eval")
    t0 = time.perf_counter()
    report["sac_ae_step"] = sac_ae_step(torch, ln_gru)
    report["sac_ae_step"]["seconds"] = time.perf_counter() - t0
    return report


# the DreamerV1/V2 legs: the presets' widths and algorithm settings on the
# dummy envs with 64x64x3 frames, one env (the presets'), cut in length and
# buffer size only. DV2's first burst takes its 20 pretrain steps (100 at
# ratio 0.2); the multidiscrete dummy's 129-step episodes outlast the episode
# buffer's minimum length (the sequence, 50), the discrete dummy's 5 do not
DV2_LEARNING_STARTS, DV2_TOTAL, DV2_RESUME_TOTAL, DV2_BUFFER = 64, 256, 320, 512
DV2_EP_LEARNING_STARTS, DV2_EP_TOTAL = 160, 320
DV1_LEARNING_STARTS, DV1_TOTAL, DV1_BUFFER = 128, 512, 1024


def dreamer_step(torch, ln_gru, algo, env_id, n_act, continuous, dev="cuda", reps=3):
    """One DreamerV2 or V1 gradient step at the preset's full width on
    64x64x3 frames, TF32 off, through make_train_fn, in the form of phase
    train: host ms of timed steps, one step under torch.profiler (device ms,
    kernel count, busy share, top kernels), the step's model FLOPs counted
    once (model_cost) and MFU against the f32 peak, peak device memory; and
    (DV2) the first step under bf16-mixed from the same weights, batch and
    noise, its losses held against f32's (BF16_TOL), with its own timed
    steps and profile."""
    import importlib

    import numpy as np

    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.telemetry.throughput import model_cost

    mod = importlib.import_module(f"sheeprl_tpu_torch.algos.{algo}.{algo}")
    agent = importlib.import_module(f"sheeprl_tpu_torch.algos.{algo}.agent")
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers

    dev = torch.device(dev)
    space = spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    adim = [n_act]

    def trainer(precision, weights=None):
        cfg = compose("config", [f"exp={algo}", "env=dummy", f"env.id={env_id}", f"fabric.precision={precision}"])
        torch.manual_seed(0)
        mods = [m for m in agent.build_agent(cfg, space, adim, continuous, dev) if m is not None]
        if weights is not None:
            for m, w in zip(mods, weights):
                m.load_state_dict(w.state_dict())
        opts = build_optimizers(cfg, *mods[:3])
        return cfg, mods, mod.make_train_fn(*mods, opts, cfg, continuous, adim)

    cfg, mods, train = trainer("32-true")
    T, B = int(cfg.algo.per_rank_sequence_length), int(cfg.algo.per_rank_batch_size)
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"rgb": torch.randint(0, 256, (1, T, B, 64, 64, 3), device=dev, dtype=torch.uint8, generator=g),
             "rewards": torch.randn(1, T, B, 1, device=dev, generator=g),
             "terminated": torch.zeros(1, T, B, 1, device=dev), "truncated": torch.zeros(1, T, B, 1, device=dev),
             "is_first": torch.zeros(1, T, B, 1, device=dev)}
    batch["is_first"][:, T // 2, ::4] = 1.0
    batch["terminated"][:, T // 2 - 1, ::4] = 1.0
    if continuous:
        batch["actions"] = torch.rand(1, T, B, n_act, device=dev, generator=g) * 2 - 1
    else:
        batch["actions"] = torch.nn.functional.one_hot(torch.randint(0, n_act, (1, T, B), device=dev, generator=g),
                                                       n_act).float()
    gen = torch.Generator(device=dev).manual_seed(3)
    noise = mod.draw_train_noise(cfg, T, B, mods[1], gen, dev)
    out = {"model": f"{algo} preset: T={T}, B={B}, horizon {cfg.algo.horizon}, 64x64x3, "
                    f"{'continuous' if continuous else 'discrete'} ({n_act}), 32-true"}
    # the f32 weights before any step, for DV2's bf16 comparison
    weights = [copy.deepcopy(m) for m in mods] if algo == "dreamer_v2" else None
    met32 = train(batch, noise=[noise])  # also the warm-up: cuDNN's algorithm choice, the allocator

    def timed(train_fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ln_gru.reset_launch_counts()
        times, losses = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            m = train_fn(batch, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(v[0]) for k, v in m.items()})
        if not all(np.isfinite(v) for l in losses for v in l.values()):
            raise AssertionError(f"{algo} step: non-finite losses {losses}")
        if any(k.launches for k in ln_gru.KERNELS):
            raise AssertionError(f"the {algo} step launched LN-GRU kernels")
        peak = torch.cuda.max_memory_allocated()
        step_ms = statistics.median(times)
        profile = profile_step(torch, lambda _m, bt, generator=None: train_fn(bt, generator=generator), None, batch,
                               gen, step_ms)
        return {"ms_per_step": times, "profile": profile, "max_memory_allocated": peak, "losses": losses}

    out.update(timed(train))
    _, cost = model_cost(lambda: train(batch, generator=gen))
    device_ms = out["profile"].get("device_ms")
    step_ms = statistics.median(out["ms_per_step"])
    out.update(model_flops_per_step=cost["flops"], bytes_per_step=cost["bytes_accessed"],
               f32_bound_ms=bound_ms(cost["flops"], cost["bytes_accessed"])[2],  # f32 outside the tensor cores
               f32_bound_ops_ms=cost["flops"] / PEAK_F32_FLOPS * 1e3,
               f32_bound_bytes_ms=cost["bytes_accessed"] / PEAK_BYTES * 1e3,
               mfu_f32=cost["flops"] / (step_ms / 1e3) / PEAK_F32_FLOPS,
               mfu_f32_device_time=(cost["flops"] / (device_ms / 1e3) / PEAK_F32_FLOPS
                                    if isinstance(device_ms, float) else "not measured"))
    if weights is not None:
        del mods, train
        torch.cuda.empty_cache()
        _, m16, train16 = trainer("bf16-mixed", weights=weights)
        met16 = train16(batch, noise=[noise])
        vs = {k: {"f32": float(met32[k][0]), "bf16_mixed": float(met16[k][0])} for k in met32}
        for k, v in vs.items():
            if not np.isfinite(v["bf16_mixed"]) or abs(v["bf16_mixed"] - v["f32"]) > BF16_TOL * max(1.0,
                                                                                                    abs(v["f32"])):
                raise AssertionError(f"{algo} bf16-mixed {k} = {v['bf16_mixed']} against f32 {v['f32']}")
        out["bf16_mixed"] = {"first_step_vs_f32": vs, "tol": BF16_TOL, **timed(train16)}
    return out


def dreamer_legs(torch, ln_gru):
    """DreamerV2 and V1 on the card (phase 5), through the CLI at the
    presets' widths on the dummy envs with 64x64x3 frames, one env, cut in
    length and buffer size only: DV2 on the sequential buffer (the device
    ring, as buffer.device_cache=auto takes it), DV2 on the episode buffer
    with prioritize_ends and memmap (the staged feed), a DV2 resume from the
    first leg's mid-run checkpoint (which holds the buffer; the target-copy
    counter carries on), DV1 on a continuous action (the truncated-normal
    actor, exploration noise 0.3), eval of both, and one profiled gradient
    step of each (DV2's also under bf16-mixed). No leg launches an LN-GRU
    kernel."""
    from sheeprl_tpu_torch.utils.checkpoint import param_sums

    report, logs, feeds = {}, {}, {}
    leg = make_leg(torch, ln_gru, report, logs, feeds)
    t_legs = time.perf_counter()
    base = ["env=dummy", "algo.run_test=False", f"root_dir={RUN_ROOT}"]
    dv2 = ["exp=dreamer_v2", *base, "env.id=discrete_dummy", f"algo.learning_starts={DV2_LEARNING_STARTS}",
           f"buffer.size={DV2_BUFFER}", "checkpoint.every=128", "metric.log_every=64"]
    leg("dreamer_v2", dv2 + [f"algo.total_steps={DV2_TOTAL}"], DV2_LEARNING_STARTS)
    leg("dreamer_v2_episode", ["exp=dreamer_v2", *base, "env.id=multidiscrete_dummy", "buffer.type=episode",
                               "buffer.prioritize_ends=True", "buffer.memmap=True", "buffer.size=1024",
                               f"algo.learning_starts={DV2_EP_LEARNING_STARTS}", f"algo.total_steps={DV2_EP_TOTAL}",
                               "checkpoint.every=0", "metric.log_every=64"], DV2_EP_LEARNING_STARTS)
    if feeds["dreamer_v2"] != ["DeviceRingPrefetcher"] or feeds["dreamer_v2_episode"] != ["StagedPrefetcher"]:
        raise AssertionError(f"feeds: dreamer_v2 {feeds['dreamer_v2']}, episode {feeds['dreamer_v2_episode']}")
    for name, total in (("dreamer_v2", DV2_TOTAL), ("dreamer_v2_episode", DV2_EP_TOTAL)):
        if report[name]["policy_step"] != total or report[name]["grad_steps"] < 24:
            raise AssertionError(f"the {name} leg: {report[name]['policy_step']} of {total} policy steps, "
                                 f"{report[name]['grad_steps']} gradient steps")

    ckpts = checkpoints(logs["dreamer_v2"])
    saved = torch.load(ckpts[0], map_location="cpu", weights_only=False)
    if not DV2_LEARNING_STARTS < saved["policy_step"] < DV2_TOTAL or "rb" not in saved:
        raise AssertionError(f"the dreamer_v2 leg's first checkpoint {ckpts[0]}: not a mid-run one with the buffer")
    parsed = leg("dreamer_v2_resume", dv2 + [f"algo.total_steps={DV2_RESUME_TOTAL}",
                                             f"checkpoint.resume_from={ckpts[0]}"], DV2_LEARNING_STARTS)
    started = parsed["resumed"]
    want = {"policy_step": saved["policy_step"], "grad_steps": saved["grad_steps"], "ratio": saved["ratio"]}
    if started is None or {k: started[k] for k in want} != want:
        raise AssertionError(f"dreamer_v2_resume started from {started}, the checkpoint holds {want}")
    file_sums = param_sums({k: saved[k] for k in ("wm", "actor", "critic", "target_critic")})
    for k, v in file_sums.items():
        if abs(started["param_sums"][k] - v) > 1e-9 * max(1.0, abs(v)):
            raise AssertionError(f"resumed {k} parameters sum to {started['param_sums'][k]}, the file's to {v}")
    last = torch.load(checkpoints(logs["dreamer_v2_resume"])[-1], map_location="cpu", weights_only=False)
    if last["policy_step"] != DV2_RESUME_TOTAL or last["opt_states"]["step"] != last["grad_steps"] \
            or last["grad_steps"] <= saved["opt_states"]["step"]:
        raise AssertionError(f"dreamer_v2_resume ended at {last['policy_step']} with the step counter "
                             f"{last['opt_states']['step']} (started from {saved['opt_states']['step']})")
    report["dreamer_v2_resume"].update(started_from=want, param_sums=file_sums,
                                       target_copy_counter={"start": saved["opt_states"]["step"],
                                                            "end": last["opt_states"]["step"]},
                                       checkpoint=os.path.basename(ckpts[0]))

    leg("dreamer_v1", ["exp=dreamer_v1", *base, "env.id=continuous_dummy", f"algo.total_steps={DV1_TOTAL}",
                       f"algo.learning_starts={DV1_LEARNING_STARTS}", f"buffer.size={DV1_BUFFER}",
                       "checkpoint.every=0", "metric.log_every=128"], DV1_LEARNING_STARTS)
    if report["dreamer_v1"]["policy_step"] != DV1_TOTAL or report["dreamer_v1"]["grad_steps"] < 24:
        raise AssertionError(f"the dreamer_v1 leg: {report['dreamer_v1']}")
    for name in ("dreamer_v2", "dreamer_v1"):
        leg(f"{name}_eval", [f"checkpoint_path={checkpoints(logs[name])[-1]}"], 0, command="eval")
    report["legs_seconds"] = time.perf_counter() - t_legs
    for key, name, env_id, continuous in (("dv2_step", "dreamer_v2", "discrete_dummy", False),
                                          ("dv1_step", "dreamer_v1", "continuous_dummy", True)):
        t0 = time.perf_counter()
        report[key] = step = dreamer_step(torch, ln_gru, name, env_id, 2, continuous)
        step["seconds"] = time.perf_counter() - t0
    return report


# the Plan2Explore legs: DV3 at the presets' XL widths on 4 envs (64-row
# sequences: a sequence in each env's buffer from policy step 256), DV2 and
# DV1 at theirs on one env; cut in length, buffer size and learning_starts
P2E_LEARNING_STARTS, P2E_TOTAL, P2E_DEC_TOTAL, P2E_FT_MID, P2E_FT_TOTAL, P2E_RESUME_TOTAL = 256, 264, 260, 260, 264, 272
P2E_DREAMER = {"dv2": ("discrete_dummy", 64, 128, 96), "dv1": ("continuous_dummy", 64, 224, 176)}


def p2e_legs(torch, ln_gru):
    """Plan2Explore on the card (phase 5), through the CLI on the dummy
    envs: P2E-DV3's exploration at the preset (coupled, XL, 8 members; a
    mid-run checkpoint), again with decoupled_rssm=True pallas_gru=True
    (the JAX step's coupled scan all the same: no LN-GRU launch), the
    finetuning from that run's last checkpoint (it inherits decoupled and
    pallas_gru=True: every LN-GRU kernel at XL, the streamed instance; it
    starts from the checkpoint's parameters and switches from the
    exploration actor to the task actor at learning_starts) and its resume
    past learning_starts (the task actor from the first step); P2E-DV2's
    and DV1's exploration and finetuning at the presets' widths; eval of
    each exploration checkpoint; one profiled P2E-DV3 exploration step
    (``p2e_dv3_step``). Returns (report, the finetuning leg's launch counts
    and blocks of each kernel's last launch)."""
    from sheeprl_tpu_torch.utils.checkpoint import param_sums

    report, logs, feeds = {}, {}, {}
    leg = make_leg(torch, ln_gru, report, logs, feeds)
    t_legs = time.perf_counter()
    base = ["env=dummy", "algo.run_test=False", f"root_dir={RUN_ROOT}"]
    dv3 = ["exp=p2e_dv3_exploration", *base, f"algo.learning_starts={P2E_LEARNING_STARTS}", "buffer.size=1024",
           "metric.log_every=4"]
    leg("p2e_dv3_exploration", dv3 + [f"algo.total_steps={P2E_TOTAL}", f"checkpoint.every={P2E_FT_MID}"],
        P2E_LEARNING_STARTS)
    leg("p2e_dv3_exploration_decoupled", dv3 + [f"algo.total_steps={P2E_DEC_TOTAL}", "checkpoint.every=0",
                                                "algo.world_model.decoupled_rssm=True",
                                                "algo.world_model.pallas_gru=True"], P2E_LEARNING_STARTS)
    for name, total, steps in (("p2e_dv3_exploration", P2E_TOTAL, 8), ("p2e_dv3_exploration_decoupled", P2E_DEC_TOTAL, 4)):
        ckpts = checkpoints(logs[name])
        if report[name]["policy_step"] != total or report[name]["grad_steps"] < steps:
            raise AssertionError(f"the {name} leg: {report[name]['policy_step']} of {total} policy steps, "
                                 f"{report[name]['grad_steps']} gradient steps")
        if name == "p2e_dv3_exploration" and len(ckpts) < 2:
            raise AssertionError(f"the {name} leg wrote {ckpts}: no mid-run checkpoint")
    explored = checkpoints(logs["p2e_dv3_exploration_decoupled"])[-1]
    saved = torch.load(explored, map_location="cpu", weights_only=False)
    want = param_sums({"wm": saved["wm"], "actor": saved["actor_task"], "actor_exploration": saved["actor_exploration"]})
    ft = ["exp=p2e_dv3_finetuning", *base, f"checkpoint.exploration_ckpt_path={explored}",
          f"algo.learning_starts={P2E_LEARNING_STARTS}", "buffer.size=1024", "metric.log_every=4"]
    parsed = leg("p2e_dv3_finetuning", ft + [f"algo.total_steps={P2E_FT_TOTAL}", f"checkpoint.every={P2E_FT_MID}"],
                 P2E_LEARNING_STARTS, kernels=True)
    # the grid of each kernel's last launch on this leg, as its entry recorded it
    blocks = {k.__name__: int(ln_gru._lib().ln_gru_last_blocks(i)) for i, k in enumerate(ln_gru.KERNELS)}
    counts = report["p2e_dv3_finetuning"]["launches"]
    started = (parsed["from_exploration"] or {}).get("param_sums", {})
    if any(abs(started.get(k, float("nan")) - v) > 1e-9 * max(1.0, abs(v)) for k, v in want.items()):
        raise AssertionError(f"the finetuning leg started from {started}, the exploration checkpoint holds {want}")
    if parsed["acting"] != [("exploration", 0), ("task", P2E_LEARNING_STARTS)]:
        raise AssertionError(f"the finetuning leg's player: {parsed['acting']}")
    report["p2e_dv3_finetuning"].update(started_from=want, acting=parsed["acting"], blocks=blocks,
                                        shape={"F": 1024, "H": 4096, "instance": ln_gru.launch_layout(4096)[0]})
    mid = [p for p in checkpoints(logs["p2e_dv3_finetuning"]) if os.path.basename(p) == f"ckpt_{P2E_FT_MID}.ckpt"]
    if not mid:
        raise AssertionError(f"the finetuning leg wrote no ckpt_{P2E_FT_MID}.ckpt")
    state = torch.load(mid[0], map_location="cpu", weights_only=False)
    parsed = leg("p2e_dv3_finetuning_resume", ft + [f"algo.total_steps={P2E_RESUME_TOTAL}",
                                                    f"checkpoint.resume_from={mid[0]}", "checkpoint.every=0"],
                 P2E_LEARNING_STARTS, kernels=True)
    got = parsed["resumed"] or {}
    file_sums = param_sums({k: state[k] for k in ("wm", "actor", "critic", "target_critic", "actor_exploration")})
    if {k: got.get(k) for k in ("policy_step", "grad_steps")} != {"policy_step": P2E_FT_MID,
                                                                   "grad_steps": state["grad_steps"]} \
            or any(abs(got["param_sums"][k] - v) > 1e-9 * max(1.0, abs(v)) for k, v in file_sums.items()):
        raise AssertionError(f"the resume leg started from {got}, the checkpoint holds {file_sums}")
    if parsed["acting"] != [("task", P2E_FT_MID)] or report["p2e_dv3_finetuning_resume"]["policy_step"] != \
            P2E_RESUME_TOTAL:
        raise AssertionError(f"the resume leg: player {parsed['acting']}, "
                             f"{report['p2e_dv3_finetuning_resume']['policy_step']} of {P2E_RESUME_TOTAL}")
    report["p2e_dv3_finetuning_resume"].update(started_from={"policy_step": P2E_FT_MID, "param_sums": file_sums},
                                               acting=parsed["acting"])
    for v, (env_id, ls, total, ft_total) in P2E_DREAMER.items():
        args = [*base, f"env.id={env_id}", f"algo.learning_starts={ls}", "buffer.size=512", "checkpoint.every=0",
                "metric.log_every=32"]
        leg(f"p2e_{v}_exploration", [f"exp=p2e_{v}_exploration", *args, f"algo.total_steps={total}"], ls)
        explored = checkpoints(logs[f"p2e_{v}_exploration"])[-1]
        saved = torch.load(explored, map_location="cpu", weights_only=False)
        parsed = leg(f"p2e_{v}_finetuning", [f"exp=p2e_{v}_finetuning", *args, f"algo.total_steps={ft_total}",
                                             f"checkpoint.exploration_ckpt_path={explored}"], ls)
        started = (parsed["from_exploration"] or {}).get("param_sums", {})
        want = param_sums({"wm": saved["wm"], "actor": saved["actor_task"]})
        if any(abs(started.get(k, float("nan")) - x) > 1e-9 * max(1.0, abs(x)) for k, x in want.items()) \
                or parsed["acting"] != [("exploration", 0), ("task", ls)]:
            raise AssertionError(f"p2e_{v}_finetuning started from {started} (the checkpoint: {want}), "
                                 f"player {parsed['acting']}")
        for name, steps in ((f"p2e_{v}_exploration", total), (f"p2e_{v}_finetuning", ft_total)):
            if report[name]["policy_step"] != steps or report[name]["grad_steps"] < 8:
                raise AssertionError(f"the {name} leg: {report[name]}")
        report[f"p2e_{v}_finetuning"].update(started_from=want, acting=parsed["acting"])
    for v in ("dv3", "dv2", "dv1"):
        leg(f"p2e_{v}_eval", [f"checkpoint_path={checkpoints(logs[f'p2e_{v}_exploration'])[-1]}"], 0, command="eval")
    report["legs_seconds"] = time.perf_counter() - t_legs
    t0 = time.perf_counter()
    report["p2e_dv3_step"] = step = p2e_dv3_step(torch, ln_gru)
    step["seconds"] = time.perf_counter() - t0
    return report, counts, blocks


def p2e_dv3_step(torch, ln_gru, dev="cuda", reps=3):
    """One P2E-DV3 exploration gradient step at the preset's width (XL,
    8 ensemble members) on 64x64x3 frames, T=64, B=16, 9 actions, f32 with
    TF32 off, through make_train_fn, timed and profiled as phase train
    times a step: host ms, device ms, kernels, busy share, the step's model
    FLOPs counted once (model_cost), the f32 bound and MFU, peak device
    memory; and the ensembles' intrinsic-reward forward counted from their
    shapes (n x (horizon+1) x T·B rows x 2 x the members' in·out sums), which
    the counted FLOPs must hold."""
    import numpy as np

    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as p2e
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.models import EnsembleLinear
    from sheeprl_tpu_torch.telemetry.throughput import model_cost

    dev = torch.device(dev)
    n_act = 9
    cfg = compose("config", ["exp=p2e_dv3_exploration", "env=dummy"])
    torch.manual_seed(0)
    mods = build_agent(cfg, spaces.Dict({"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)}), [n_act], False, dev)
    train = p2e.make_train_fn(mods, p2e.build_optimizers(cfg, mods), cfg, False, [n_act])
    batch = make_batch(torch, 1, n_act, dev, seed=1)
    gen = torch.Generator(device=dev).manual_seed(3)
    moments = p2e.init_p2e_moments(cfg, dev)
    moments, _ = train(moments, batch, generator=gen)  # the warm-up: cuDNN's algorithm choice, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ln_gru.reset_launch_counts()
    times, losses = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        moments, m = train(moments, batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v[0]) for k, v in m.items()})
    if not all(np.isfinite(v) for l in losses for v in l.values()):
        raise AssertionError(f"p2e_dv3 step: non-finite losses {losses}")
    if any(k.launches for k in ln_gru.KERNELS):
        raise AssertionError("the P2E-DV3 exploration step launched LN-GRU kernels")
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times)
    profile = profile_step(torch, lambda mo, bt, generator=None: train(mo, bt, generator=generator), moments, batch,
                           gen, step_ms)
    _, cost = model_cost(lambda: train(moments, batch, generator=gen))
    rows = (int(cfg.algo.horizon) + 1) * T * B
    ens = mods["ensembles"]
    ens_flops = ens.n * rows * 2 * sum(l.weight.shape[1] * l.weight.shape[2] for l in ens.modules()
                                       if isinstance(l, EnsembleLinear))
    if cost["flops"] < ens_flops:
        raise AssertionError(f"the counted step ({cost['flops']} FLOP) holds less than the ensembles' "
                             f"intrinsic-reward forward ({ens_flops})")
    device_ms = profile.get("device_ms")
    return {"model": f"p2e_dv3_exploration preset (XL, {ens.n} members): T={T}, B={B}, horizon {cfg.algo.horizon}, "
                     f"64x64x3, {n_act} actions, 32-true",
            "ms_per_step": times, "profile": profile, "max_memory_allocated": peak, "losses": losses,
            "model_flops_per_step": cost["flops"], "bytes_per_step": cost["bytes_accessed"],
            "ensemble_intrinsic_flops": ens_flops, "ensemble_intrinsic_rows": rows,
            "ensemble_intrinsic_f32_ms": ens_flops / PEAK_F32_FLOPS * 1e3,
            "f32_bound_ms": bound_ms(cost["flops"], cost["bytes_accessed"])[2],
            "f32_bound_ops_ms": cost["flops"] / PEAK_F32_FLOPS * 1e3,
            "f32_bound_bytes_ms": cost["bytes_accessed"] / PEAK_BYTES * 1e3,
            "mfu_f32": cost["flops"] / (step_ms / 1e3) / PEAK_F32_FLOPS,
            "mfu_f32_device_time": (cost["flops"] / (device_ms / 1e3) / PEAK_F32_FLOPS
                                    if isinstance(device_ms, float) else "not measured")}


def walker_legs(torch, ln_gru):
    """The DMC walker-walk preset's settings (bf16-mixed, memmap buffer,
    action repeat 2, coupled DreamerV3-S) on the continuous dummy env, cut
    to the smoke's scale: on the device ring and on the staged prefetcher
    (equal ledgers), then a resume from the staged leg's last checkpoint,
    which references its flushed memmap files (memmap_fast_resume)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import param_sums

    common = [
        "exp=dreamer_v3_dmc_walker_walk", "env=dummy", "env.id=continuous_dummy", "env.num_envs=2",
        f"algo.per_rank_sequence_length={T}", f"algo.per_rank_batch_size={B}",
        f"algo.learning_starts={LEARNING_STARTS}", "buffer.size=1024", "metric.log_every=32",
        "checkpoint.every=96", "checkpoint.save_last=True", "algo.run_test=False", f"root_dir={RUN_ROOT}",
    ]
    report, ledgers, logs = {}, {}, {}
    for leg, extra in (("walker_ring", ["buffer.device_cache=true"]),
                       ("walker_staged", ["buffer.device_cache=false", "buffer.memmap_fast_resume=True"])):
        args = common + [f"algo.total_steps={TOTAL}", f"run_name={leg}", *extra]
        parsed, counts, seconds, peak = drive(torch, ln_gru, "run", args)
        report[leg] = leg_summary(parsed, counts, seconds, peak, LEARNING_STARTS, trains=False)
        if report[leg]["grad_steps"] < 1:
            raise AssertionError(f"the {leg} leg took no gradient step")
        logs[leg] = parsed["log_dir"]
        ledgers[leg] = ledger(torch, checkpoints(parsed["log_dir"])[-1])
        report[leg]["args"] = args
    if ledgers["walker_ring"] != ledgers["walker_staged"]:
        raise AssertionError(f"walker ledgers differ: ring {ledgers['walker_ring']}, staged {ledgers['walker_staged']}")
    report["walker_staged"]["ledger_equal"] = ledgers["walker_ring"]
    last = checkpoints(logs["walker_staged"])[-1]
    saved = torch.load(last, map_location="cpu", weights_only=False)
    if not all(b.get("__memmap_ref__") for b in saved["rb"]["buffers"]):
        raise AssertionError("the staged leg's checkpoint holds rows, not memmap file references")
    parsed, counts, seconds, peak = drive(torch, ln_gru, "run", common + [
        f"algo.total_steps={RESUME_TOTAL}", "run_name=walker_resume", "buffer.device_cache=true",
        f"checkpoint.resume_from={last}"])
    started = parsed["resumed"]
    want = {"policy_step": saved["policy_step"], "grad_steps": saved["opt_states"]["step"], "ratio": saved["ratio"]}
    if started is None or {k: started[k] for k in want} != want:
        raise AssertionError(f"the walker resume started from {started}, the checkpoint holds {want}")
    file_sums = param_sums({k: saved[k] for k in ("wm", "actor", "critic", "target_critic")})
    for k, v in file_sums.items():
        if abs(started["param_sums"][k] - v) > 1e-9 * max(1.0, abs(v)):
            raise AssertionError(f"resumed {k} parameters sum to {started['param_sums'][k]}, the file's to {v}")
    report["walker_resume"] = leg_summary(parsed, counts, seconds, peak, LEARNING_STARTS, trains=False)
    if report["walker_resume"]["policy_step"] != RESUME_TOTAL:
        raise AssertionError(f"the walker resume stopped at {report['walker_resume']['policy_step']}")
    report["walker_resume"].update(checkpoint=os.path.basename(last), started_from=want, memmap_fast_resume=True)
    return report


# the telemetry A/B's arms: the stream on, off, and on without its
# per-iteration trace ranges and span timers
TELEMETRY_ARMS = {
    "on": [],
    "off": ["metric.telemetry.enabled=False"],
    "no_ranges": ["metric.telemetry.step_annotation=False", "metric.disable_timer=True"],
}


def telemetry_ab(torch, ln_gru):
    """What the telemetry costs a user's run: the run and serial legs of
    phase 5 in each arm of TELEMETRY_ARMS, twice in the order on, off,
    no_ranges, no_ranges, off, on, after one uncounted warm-up leg (the
    process's first leg pays for cuDNN's and the allocator's first calls);
    each leg's seconds on the host clock for the same policy steps (a leg
    with the stream off leaves no stream to read; its loop takes the same
    steps, its ledger is checked against the other arms')."""
    from sheeprl_tpu_torch import cli

    out = {leg: {arm: [] for arm in TELEMETRY_ARMS} for leg in ("run", "serial")}
    ledgers = {}
    warmup = None
    for arm in ("warmup",) + ("on", "off", "no_ranges", "no_ranges", "off", "on") * 2:
        for leg, extra in (("run", []), ("serial", ["algo.overlap.enabled=False"])):
            if arm == "warmup" and leg == "serial":
                continue
            args = run_common([f"algo.total_steps={TOTAL}", f"run_name=ab_{leg}_{arm}",
                               *TELEMETRY_ARMS.get(arm, TELEMETRY_ARMS["off"]), *extra])
            tee = _Tee()
            torch.cuda.synchronize()
            ln_gru.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee):
                cli.run(args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if arm == "warmup":
                warmup = seconds
                continue
            if min(k.launches for k in ln_gru.KERNELS) < 1:
                raise AssertionError(f"the {leg} leg ({arm}) launched {[k.launches for k in ln_gru.KERNELS]}")
            log_dir = next(l.split("=", 1)[1] for l in tee.buf.getvalue().splitlines()
                           if l.startswith("[dreamer_v3] log_dir="))
            ledgers.setdefault(leg, set()).add(json.dumps(ledger(torch, checkpoints(log_dir)[-1]), sort_keys=True))
            streamed = os.path.isfile(os.path.join(log_dir, "telemetry.jsonl"))
            if streamed != (arm != "off"):
                raise AssertionError(f"the {leg} leg ({arm}) left a stream: {streamed}")
            out[leg][arm].append(seconds)
    for leg, seen in ledgers.items():
        if len(seen) != 1:
            raise AssertionError(f"the {leg} legs' ledgers differ between the arms: {seen}")
    shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
    return {"policy_steps": TOTAL, "learning_starts": LEARNING_STARTS, "warmup_s": warmup, "seconds": out,
            "median_s": {leg: {arm: statistics.median(s) for arm, s in v.items()} for leg, v in out.items()}}


def recurrences(torch, ln_gru, labels):
    """The recurrent kernels alone at chosen preset shapes: each held against
    its plain version (largest |kernel - plain| of all their outputs, within
    FWD_TOL and GRAD_TOL) and timed as in phase 3. For an A/B of two trees:
    run this in each, old, new, new, old, within one call."""
    dev = torch.device("cuda")
    out = {}
    for label in labels:
        feats, first, w, scale, bias, cot, g = gru_inputs(torch, SHAPES[label], dev)
        T_, B_, F_, H_ = SHAPES[label]
        hf = 0.5 * torch.randn(B_, H_, device=dev, generator=g)
        gx = (feats.reshape(T_ * B_, F_) @ w[:F_]).reshape(T_, B_, 3 * H_)
        fwd_args = (gx, first, hf, w[F_:], scale, bias)
        hs, yn, istd = ln_gru.forward_plain(*fwd_args)
        bwd_args = (feats, first, hs, hf, w[F_:], scale, bias, cot, yn, istd)
        errors = {}
        for name, got, want in (("fwd", ln_gru.ln_gru_fwd(*fwd_args), (hs, yn, istd)),
                                ("bwd", ln_gru.ln_gru_bwd(*bwd_args), ln_gru.backward_plain(*bwd_args))):
            for i, (a, b) in enumerate(zip(got, want)):
                check(f"{label}.{name}.{i}", a, b, FWD_TOL if name == "fwd" else GRAD_TOL, errors)
        out[label] = {"instance": ln_gru.launch_layout(H_)[0],
                      "fwd_ms": time_ms(lambda: ln_gru.ln_gru_fwd(*fwd_args), reps=10),
                      "bwd_ms": time_ms(lambda: ln_gru.ln_gru_bwd(*bwd_args), reps=10),
                      "max_abs_err": max(errors.values())}
        del feats, w, gx, hs, yn, istd, fwd_args, bwd_args
        torch.cuda.empty_cache()
    return out


USAGE = """usage: python3 chip_smoke.py                      every phase (what the contract runs)
       python3 chip_smoke.py --dreamer              phase 5's DreamerV1/V2 legs and steps alone
       python3 chip_smoke.py --p2e                  phase 5's Plan2Explore legs and step alone
       python3 chip_smoke.py --recurrences [M L XL] the recurrent kernels alone at those shapes
       python3 chip_smoke.py --telemetry-ab         the run and serial legs with the stream on, off, and on
                                                    without its per-iteration ranges and timers"""


def main(argv=None) -> int:
    t_script = time.perf_counter()
    argv = sys.argv[1:] if argv is None else list(argv)
    mode = argv[0] if argv else None
    if mode not in (None, "--recurrences", "--telemetry-ab", "--dreamer", "--p2e") or (mode == "--recurrences"
                                                                 and not set(argv[1:]) <= set(SHAPES)):
        print(USAGE, file=sys.stderr)
        return 2
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

    if mode == "--recurrences":
        try:
            torch.backends.cuda.matmul.allow_tf32 = False
            emit("recurrences", ok=True, nvidia_smi=smi, T=T, B=B,
                 by_shape=recurrences(torch, ln_gru, argv[1:] or ["M", "L", "XL"]))
        except Exception as err:  # noqa: BLE001
            return fail("recurrences", err)
        return 0
    if mode == "--dreamer":
        try:
            os.chdir(HERE)
            t0 = time.perf_counter()
            legs = dreamer_legs(torch, ln_gru)
            shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
            emit("dreamer", ok=True, nvidia_smi=smi, seconds=time.perf_counter() - t0, legs=legs)
        except Exception as err:  # noqa: BLE001
            return fail("dreamer", err)
        return 0
    if mode == "--p2e":
        try:
            os.chdir(HERE)
            t0 = time.perf_counter()
            legs, counts, blocks = p2e_legs(torch, ln_gru)
            shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
            emit("p2e", ok=True, nvidia_smi=smi, seconds=time.perf_counter() - t0, launches=counts, blocks=blocks,
                 legs=legs)
        except Exception as err:  # noqa: BLE001
            return fail("p2e", err)
        return 0
    if mode == "--telemetry-ab":
        try:
            os.chdir(HERE)
            emit("telemetry_ab", ok=True, nvidia_smi=smi, **telemetry_ab(torch, ln_gru))
        except Exception as err:  # noqa: BLE001
            return fail("telemetry_ab", err)
        return 0

    try:
        errors, f64_errors, per_shape = phase_kernels(torch, ln_gru)
        timing = {label: {"instance": r["instance"],
                          "times_ms": {k: {"kernel_ms": v[0], "plain_ms": v[1]} for k, v in r["times"].items()},
                          "library_ms": r["library"], "dW_torch_mm_ms": r["dW_torch_mm_ms"],
                          "no_product_ms": r["no_product_ms"], "w_h_restream_ms": r["w_h_restream_ms"],
                          "bound_ms": {k: v[0] for k, v in r["bounds"].items()},
                          "bound_by": {k: v[1] for k, v in r["bounds"].items()},
                          "bound_ops_ms": {k: v[3] for k, v in r["bounds"].items()},
                          "bound_bytes_ms": {k: v[4] for k, v in r["bounds"].items()},
                          "bound_simt_ms": {k: v[2] for k, v in r["bounds"].items()}}
                  for label, r in per_shape.items()}
        emit("kernels_vs_plain", ok=True, shapes=SHAPES, fwd_tol=FWD_TOL, grad_tol=GRAD_TOL,
             f64_factor=F64_FACTOR, max_abs_err=errors, err_vs_f64=f64_errors, by_shape=timing,
             spin_cycles=SPIN_CYCLES,
             peaks=dict(f32_flops=PEAK_F32_FLOPS, tf32_flops=PEAK_TF32_FLOPS, bytes_per_s=PEAK_BYTES))
    except Exception as err:  # noqa: BLE001
        return fail("kernels_vs_plain", err)

    try:
        train = phase_train(torch, ln_gru)
        train.update(phase_train_bf16(torch, ln_gru))
        train.update(phase_train_wide(torch, ln_gru))
        emit("train", ok=True, model="DreamerV3-S (and M, L, XL decoupled on the kernels)", T=T, B=B, horizon=15,
             obs="64x64x3", actions=9, modes=train)
    except Exception as err:  # noqa: BLE001
        return fail("train", err)

    try:
        emit("feed", ok=True, nvidia_smi=smi, G=1, T=T, B=B, obs="64x64x3 uint8", actions=9, **phase_feed(torch))
    except Exception as err:  # noqa: BLE001
        return fail("feed", err)

    try:
        os.chdir(HERE)  # the legs write logs/runs/chip_smoke/ in the checkout (gitignored)
        t0 = time.perf_counter()
        counts, blocks, legs = phase_run(torch, ln_gru)
        emit("run", ok=True, nvidia_smi=smi, seconds=time.perf_counter() - t0, launches=counts,
             last_launch_blocks=blocks, legs=legs)
    except Exception as err:  # noqa: BLE001
        return fail("run", err)

    replaces = {  # the pallas_call each kernel's work comes from
        "ln_gru_xproj": "sheeprl_tpu/ops/pallas_gru.py:127",
        "ln_gru_fwd": "sheeprl_tpu/ops/pallas_gru.py:127",
        "ln_gru_bwd": "sheeprl_tpu/ops/pallas_gru.py:227",
        "ln_gru_dx": "sheeprl_tpu/ops/pallas_gru.py:227",
        "ln_gru_wgrad": "sheeprl_tpu/ops/pallas_gru.py:227",
    }
    kernels = []
    for label, instance in INSTANCE_SHAPES.items():  # each kernel at each width a leg of the main path runs
        r = per_shape[label]
        for name, src in replaces.items():
            short = name[len("ln_gru_"):]
            row = {
                "name": name,
                "route": "cuda",
                "source": "sheeprl_tpu_torch/csrc/ln_gru.cu",
                "replaces": src,
                "instance": instance,
                "shape": label,
                "launches": counts[label][name],
                "max_abs_err": max(v for k, v in errors.items()
                                   if k.startswith(f"{label}.") and k.split(".")[1] == short),
                "ms": r["times"][name][0],
                "plain_ms": r["times"][name][1],
                "bound_ms": r["bounds"][name][0],
                "bound_by": r["bounds"][name][1],
                "math": "3xtf32" if name in GEMMS else "f32-simt",
                "library_ms": r["library"].get(name),
                "blocks": blocks[label][name],
            }
            if name in r["no_product_ms"]:
                row["no_product_ms"] = r["no_product_ms"][name]
            if name in GEMMS:
                mine = [v for k, v in f64_errors.items() if k.startswith(f"{label}.") and k.split(".")[1] == short]
                row["err_vs_f64"] = max(v["kernel"] for v in mine)
                row["torch_mm_err_vs_f64"] = max(v["torch_mm"] for v in mine)
            if name == "ln_gru_wgrad":
                # no one call computes dW, dscale and dbias; cuBLAS's dW product
                # alone, on the same inputs, is the library time to beat
                row["torch_mm_dW_ms"] = r["dW_torch_mm_ms"]
            kernels.append(row)
    emit("time", ok=True, seconds=time.perf_counter() - t_script)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
