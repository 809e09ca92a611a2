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
               time over the median unprofiled step; the profile's Chrome
               trace read by the port's prof.capture must give each LN-GRU
               kernel's launches as key_averages() does and its device ms,
               and the step's total, within PROF_MS_TOL), the same three
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
               dv3_ms_pacman
                           exp=dreamer_v3_100k_ms_pacman (DreamerV3-S at
                           the preset's widths, batch 16, sequence 64,
                           replay ratio 1, one env, coupled 32-true) on the
                           discrete dummy env, learning_starts, total_steps
                           and buffer.size cut (PRESET_*): policy steps/s
                           after learning_starts, peak device memory, and
                           from utils/run_info.py the first burst's end
                           (steady_step, inside the run), the steady-state
                           policy steps/s after it and the run's log_dir;
               dv3_XL_crafter
                           exp=dreamer_v3_XL_crafter (DreamerV3-XL at the
                           preset's widths, batch 16, sequence 64, replay
                           ratio 0.5, one env, coupled 32-true, encoder keys
                           rgb and reward) on the crafter stand-in
                           (tests/torch_suite_stubs) through the port's
                           CrafterWrapper, learning_starts, total_steps,
                           buffer.size and the checkpoint cadence cut
                           (CRAFTER_*): 32 gradient steps, no LN-GRU launch,
                           the same readings as dv3_ms_pacman, on a line of
                           its own;
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
                           overlapped loop (staleness bound 1), to
                           SAC_TOTAL policy steps, a mid-run checkpoint and
                           the last;
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
                           learning_starts cut to 64, 32 gradient steps;
               sac_resume  checkpoint.resume_from=<the sac leg's mid-run
                           checkpoint, which holds the buffer>: its
                           counters and parameters, and on to
                           SAC_RESUME_TOTAL;
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
               then the actor fleet's legs (algo.fleet.workers=2: worker
               processes that step their env slices and act on the host
               CPU, the learner on the card):
               fleet_dv3_serial, fleet_dv3
                           DreamerV3-S decoupled on the kernels at 4 envs,
                           serially and with 2 workers: equal ledgers, each
                           of the five LN-GRU kernels launched on the
                           learner, and no worker holding a CUDA context
                           (the card's compute apps, sampled during the leg,
                           list one process at a time and no worker pid;
                           each worker's exit record says it never
                           initialised CUDA);
               fleet_dv3_inference
                           fleet_dv3 with fleet.act_mode=inference: the
                           workers ship obs and noise rows to the learner's
                           batched act service on the card (Sebulba), which
                           keeps the latents; fleet_dv3's ledger, each
                           LN-GRU kernel launched as often as on fleet_dv3,
                           no worker holding a CUDA context, the service's
                           requests, batches, occupancy and pad waste;
               fleet_dv3_chaos
                           fleet_dv3 with worker 0 crashing at a lifetime
                           step and worker 1 hanging past fleet.hang_s=6:
                           the serial Ratio ledger still (policy steps,
                           gradient steps, the Ratio's state; each column
                           holds exactly one step row per env step, and a
                           respawn restarts its worker's episodes, so a
                           column closes the serial loop's episodes less at
                           most one per respawn of its worker), crash, hang
                           and respawn for each, no quarantine;
               fleet_sac, fleet_sac_socket
                           the sac leg with 2 workers on the mp queues and
                           on loopback sockets: sac_serial's ledger (and a
                           net accept for both workers on the socket leg);
               fleet_sac_inference, fleet_sac_inference_socket
                           the same with fleet.act_mode=inference:
                           sac_serial's ledger, the act service's numbers,
                           steps/s beside the worker-mode leg's;
               fleet_ppo   the ppo leg with 2 workers, strict rounds:
                           ppo_serial's counters, one rollout per
                           publication;
               each with policy steps/s after learning_starts beside its
               serial twin's, the learner's env-interaction (waiting for
               rounds) and train seconds, publications with their bytes
               and ms, respawns, the largest queue depth, its own peak
               device memory and the workers' span totals (program steps,
               queue waits, publication lags); every stream (the
               learner's and each worker's) passes validate_jsonl;
               then serving on the card:
               serve_ppo, serve_sac
                           serve_from_checkpoint(block=False), HTTP on an
                           ephemeral port, from the ppo and sac legs'
                           mid-run checkpoints, every bucket (1-16) warmed
                           for both greedy variants; 32 HTTP clients x 50
                           POST /v1/act (half deterministic); the leg's
                           last checkpoint is put beside the served one
                           once traffic runs and the reloader must swap it
                           in before the traffic ends: completed, errors
                           (0), rejected, retraces (0), reloads (>= 1),
                           batch occupancy, pad waste, p50/p95/p99 (the
                           server's histogram and the clients' exact
                           ones), the device memory the server holds;
               serve_dv3   the same from the run leg's checkpoints (64x64x3
                           pixels): 16 sessions x 64 steps, one session
                           exporting its state and going on under a fresh
                           id that imports it; two deterministic sessions
                           replayed alone at bucket 1 within the builder's
                           tolerance (actions and latents); then the reload
                           under traffic;
               serve_cmd   `python -m sheeprl_tpu_torch serve` on the ppo
                           leg's last checkpoint in a process of its own:
                           it says it serves on cuda:0 and the card's name,
                           and answers one request;
               anakin      run_anakin on the card (1024 lanes, chunks of
                           256, seed 5) for 5 s: env steps/s, operations
                           and CUDA kernels per chunk;
               no serving leg launches an LN-GRU kernel, and ppo_eval and
               sac_eval say they went through serve/evaluate.py;
               every training leg's <log_dir>/telemetry.jsonl must pass the
               port's validate_jsonl and open with a startup record that
               names the card; its numbers come from that stream (log
               records: policy steps, gradient steps, elapsed seconds, MFU,
               peak device memory, the mirror's statistics; overlap and
               ckpt_async records) and from the lines the loop prints
               (log_dir, resumed state, Test - Reward); then the blocks of
               each kernel's last launch on the run and run_M legs, as its
               CUDA entry recorded the grid it launched;
5b. diag     — run diagnostics and the model registry over phase 5's legs:
               the diag leg (DreamerV3-S on the kernels through cli.run,
               16 bursts after learning_starts, one torch.profiler window
               over bursts, metric.telemetry.prometheus_port on a free port,
               model_manager.disabled=False), whose GET /metrics (the log
               and overlap events' families, counts above 0) and GET /live
               (a snapshot with its window) are scraped mid-run and which
               registers its five groups at its end; then, through the CLI,
               prof on its run dir (a capture with a device lane on the
               card, the five LN-GRU kernels launched under the training
               scope, the idle fraction), doctor on it (no critical
               finding) and on fleet_dv3_chaos's (worker_flap), trace on
               fleet_dv3's (learner and worker stages, completeness > 0),
               top once offline, and registration of the run leg's last
               checkpoint (one new version of each MODELS_TO_REGISTER
               group; the registered world model and actor, loaded into
               fresh modules on the card, act bitwise as the checkpoint's
               on the same observations and noise); the phase's seconds;
5c. mesh     — the data-parallel mesh (parallel/mesh.py) at world size 1,
               the one GPU the card's machine shows: mesh_dv3 (the run
               leg's arguments, serial, fabric.strategy=ddp: a world-size-1
               NCCL group, one flattened all-reduce per optimizer step and
               one Moments all-gather per gradient step, counted with their
               bytes, the five LN-GRU kernels launched) against its twin
               under fabric.strategy=auto (no group), in turns (auto, ddp,
               ddp, auto), every leg on deterministic kernels: the same
               ledger and bitwise the same parameters, optimizer states and
               Moments, each leg's policy steps/s; then mesh_dv3_sharded,
               the same leg through the sharded mesh's path
               (fabric.mesh.dp=1 fsdp=1 tp=1, fabric.shard_optimizer_state
               =True: the rule engine's layout on the group's DeviceMesh),
               bitwise mesh_dv3, its sharding events every parameter and
               optimizer-state leaf replicated with bytes_per_chip equal to
               total_bytes in both summaries, doctor on it without
               replicated_giant, the five kernels launched; then
               ppo_decoupled and
               sac_decoupled at fabric.devices=1 algo.player.device=host:
               the trainer rank 0 on the card under NCCL, the player thread
               on the host, the ledger of the JAX package's formula, eval of
               the last checkpoint through serve/evaluate.py, policy
               steps/s; then the other algorithms under ddp: mesh_dv2
               (DreamerV2 at the preset) bitwise its auto twin,
               mesh_p2e_dv3_finetuning at XL from phase run's decoupled
               exploration checkpoint (every LN-GRU kernel launched under
               the group, three all-reduces and one Moments all-gather a
               gradient step with their bytes, the ledger of the JAX
               package's formula, the switch to the task actor at
               learning_starts), and one leg each of a2c, ppo_recurrent,
               droq, sac_ae, dreamer_v1 and P2E-DV2's and DV1's
               exploration to its first checkpoint after learning_starts;
               the phase's seconds (--mesh runs it alone after phases 1-2,
               with an XL exploration run of its own);
5d. gateway  — the serving plane scaled out (gateway/) and the data
               flywheel (flywheel/), every replica a process of its own on
               cuda:0, each leg watching the card's compute processes (a
               sample must list this process and its replicas) and reading
               each replica's stream (memory samples of the card):
               gateway_dv3 the run leg's mid-run checkpoint behind
                           gateway_from_checkpoint (2 replicas, the WAL-backed
                           inproc broker, capture on): 16 sessions x 64
                           steps from 16 client threads (64x64x3 frames),
                           replica 0 chaos-exiting at its 200th request; the
                           last checkpoint published and POST
                           /admin/rolling_reload under 8 more steps of each
                           session: every step acked with its session's next
                           broker version, failovers and migrations >= 1,
                           both replicas swapped to params_version >= 1, the
                           capture's trace ids the acked ones; requests/s,
                           the gateway's p50/p95/p99, the crash-to-routable
                           and reload seconds, each replica's device memory;
               gateway_flywheel
                           two synthetic counter fleets (capture on and
                           off): 100 sessions x 4 rounds from 8 threads, one
                           turn of `python -m sheeprl_tpu_torch flywheel`
                           with flywheel.gateway_url (400 samples, trace
                           join 1.0, ckpt_10.ckpt, the HTTP rolling reload),
                           2 more rounds (counters continue, only
                           params_version 1), a second turn (200 new, 400
                           duplicates); then the act p95 with capture on and
                           off, two arms each in turns (recorded, not gated);
               flywheel_bc the sac leg's last checkpoint behind 2 replicas
                           with capture on, 32 sessions x 50 sampled
                           requests, then run_flywheel with the SAC
                           PolicyCore on cuda:0 (greedy BC, 50 steps of
                           batch 64): the step on cuda:0, the loss finite,
                           the actor moved, a policy on the new actor acts;
               no gateway leg launches an LN-GRU kernel (--gateway runs the
               sac and run legs, then the phase, after phases 1-2);
6. time and kernels
             — the script's whole time in seconds (one JSON line), then
               one {"kernels": [...]} line: a row for each kernel at each
               width a training leg runs it (resident at S, streamed at M
               and XL), with launches and blocks from the run leg, the
               run_M leg or the p2e_dv3_finetuning leg (and, in
               launches_by_path, each leg's own count: at S the run leg's,
               fleet_dv3's and fleet_dv3_inference's learners', the diag
               leg's and mesh_dv3's apart; at XL p2e_dv3_finetuning's and
               mesh_p2e_dv3_finetuning's), times
               from phase 3, the bound (the operations and bytes bounds
               apart are in phase 3's record), the kernel's arithmetic
               (3xtf32 or f32-simt), largest error at that shape (and,
               beside ln_gru_wgrad, cuBLAS's dW product alone);
7. the last line: {"ok": true, "device": {...}}.

Two narrower runs, for comparisons within one call (see USAGE): the
recurrent kernels alone at chosen shapes (phases 1-2, then each checked and
timed as in phase 3), and the telemetry's cost (phases 1-2, then phase 5's
run and serial legs with the stream on, off, on without its per-iteration
trace ranges and span timers, and on without the live aggregator).

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
    """Report a failed phase on stdout (its JSON line) and on stderr (the
    traceback's end and the error), so either stream's tail says why."""
    import traceback

    error = f"{type(err).__name__}: {err}"
    emit(phase, ok=False, error=error)
    print("".join(traceback.format_exception(err))[-4000:], file=sys.stderr)
    print(f"[chip_smoke] phase {phase} failed: {error[:4000]}", file=sys.stderr, flush=True)
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


PROF_MS_TOL = 0.01  # prof's per-kernel and total device ms against key_averages()', relative


def prof_vs_key_averages(torch, ln_gru, prof, launched):
    """The port's ``prof`` reading of a profile against ``key_averages()`` of
    the same profile: the profile's Chrome trace is exported and summarized
    by ``sheeprl_tpu_torch.prof.capture``; for each LN-GRU kernel (device
    symbols mapped by ``ln_gru.kernel_of``) the launch counts must be equal
    and the device ms within PROF_MS_TOL, and so must the total device ms of
    the step. With ``launched`` the step ran every LN-GRU kernel, and both
    readings must count each at least once (a symbol map that lost the
    kernels would give two equal zeros); without it, neither may count one.
    Fails on a gap."""
    from torch.autograd import DeviceType

    from sheeprl_tpu_torch.prof.capture import summarize_capture

    ka = {k.__name__: [0, 0.0] for k in ln_gru.KERNELS}
    ka_total_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        ka_total_us += dev_us
        name = ln_gru.kernel_of(evt.key)
        if name is not None:
            ka[name][0] += evt.count
            ka[name][1] += dev_us
    out_dir = os.path.join(HERE, "logs", "prof_check")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace_profile_step.json")
    try:
        prof.export_chrome_trace(path)
        summary = summarize_capture(path, top_k=1 << 30)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    pr = {k.__name__: [0, 0.0] for k in ln_gru.KERNELS}
    for row in summary["ops"]:
        name = ln_gru.kernel_of(row["op"])
        if name is not None:
            pr[name][0] += row["count"]
            pr[name][1] += row["total_us"]
    pr_total_us = sum(row["total_us"] for row in summary["ops"])
    rows = {name: {"count": ka[name][0], "prof_count": pr[name][0], "ms": ka[name][1] / 1e3,
                   "prof_ms": pr[name][1] / 1e3} for name in ka}
    rows["total"] = {"ms": ka_total_us / 1e3, "prof_ms": pr_total_us / 1e3}
    for name, r in rows.items():
        if r.get("count") != r.get("prof_count") or abs(r["prof_ms"] - r["ms"]) > PROF_MS_TOL * r["ms"]:
            raise AssertionError(f"prof and key_averages() disagree on {name}: {r}")
        if name != "total" and (r["count"] >= 1) != launched:
            raise AssertionError(f"{name}: {r['count']} launches in a step that "
                                 f"{'runs' if launched else 'runs no'} LN-GRU kernel")
    return {"tol": PROF_MS_TOL, "kernels": rows, "device_idle_frac": summary["device_idle_frac"],
            "platform": summary["windows"][0]["platform"]}


def profile_step(torch, train, moments, batch, gen, step_ms, ln_gru=None, launched=False):
    """One gradient step under torch.profiler: device time summed over the
    kernels that ran and the kernels that took the most of it. The busy
    share is that device time over ``step_ms``, the median time of the same
    step without the profiler (whose host overhead would make the step look
    host-bound); the profiled step's own wall time is reported beside it.
    With ``ln_gru``, ``prof`` reads the same profile and is held to
    ``key_averages()`` (``prof_vs_key_averages``; ``launched``: the step
    runs the LN-GRU kernels)."""
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
    extra = ({"prof_vs_key_averages": prof_vs_key_averages(torch, ln_gru, prof, launched)}
             if ln_gru is not None else {})
    return {
        **extra,
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
                                   statistics.median(times), ln_gru=ln_gru, launched=mode == "decoupled_kernel")
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
# noise, ROADMAP Queue 3 item 8) and are held to BF16_TOL instead
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
ALGOS = ("dreamer_v3", "ppo", "ppo_decoupled", "a2c", "ppo_recurrent", "sac", "sac_decoupled", "droq", "sac_ae",
         "dreamer_v2",
         "dreamer_v1", "p2e_dv3_exploration", "p2e_dv3_finetuning", "p2e_dv2_exploration", "p2e_dv2_finetuning",
         "p2e_dv1_exploration", "p2e_dv1_finetuning")  # the `[<algo>] log_dir=` lines
# the on-policy legs: the presets' algorithm settings on the dummy envs, 4 envs
# (PPO: 128-step rollouts, 8 updates of 10 epochs x 8 minibatches of 64)
PPO_TOTAL, PPO_SHORT, PPO_RESUME_TOTAL, A2C_TOTAL = 4096, 2048, 6144, 2000
# the off-policy legs: the presets' algorithm settings and widths on the
# continuous dummy env, 4 envs, cut in length and buffer size only
SAC_TOTAL, SAC_RESUME_TOTAL, SAC_BUFFER, DROQ_TOTAL, SAC_CKPT_EVERY = 288, 640, 1024, 140, 256
AE_LEARNING_STARTS, AE_TOTAL, AE_BUFFER = 64, 80, 256


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
           "logs": [], "startup": None, "events": {}, "from_exploration": None, "acting": [], "fleet": [], "net": [],
           "route": None}
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
        elif line.startswith("[eval] "):
            out["route"] = line[len("[eval] "):]
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
            elif kind in ("fleet", "net"):
                out[kind].append(rec)
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


def column_rows(torch, path):
    """Each env column's rows in a DreamerV3 checkpoint's buffer, as (step
    rows, closing rows): a step row holds the action taken (one-hot on the
    discrete dummy env), an episode's closing row a zero action."""
    s = torch.load(path, map_location="cpu", weights_only=False)
    out = []
    for b in s["rb"]["buffers"]:
        acted = (b["buffer"]["actions"][: b["pos"]] != 0).any(axis=-1).reshape(-1)
        out.append((int(acted.sum()), int((~acted).sum())))
    return out


def leg_summary(parsed, counts, seconds, peak, learning_starts, trains=True, window_from=None):
    """The numbers of one training leg; fails if it did not train or printed
    no result. Its policy steps/s are read from the first line at or after
    ``learning_starts`` (``window_from`` when given) to the last."""
    lines = parsed["lines"]
    if not lines:
        raise AssertionError("the leg printed no [dreamer_v3] policy_step line")
    if trains and min(counts.values()) < 1:
        raise AssertionError(f"the leg launched {counts}")
    after = [l for l in lines if l["policy_step"] >= (learning_starts if window_from is None else window_from)]
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
    report["dv3_ms_pacman"] = preset_leg(torch, ln_gru)
    report["dv3_XL_crafter"] = crafter_leg(torch, ln_gru)
    report.update(walker_legs(torch, ln_gru))
    report.update(ppo_legs(torch, ln_gru))
    report.update(offpolicy_legs(torch, ln_gru))
    report.update(dreamer_legs(torch, ln_gru))
    p2e, counts_xl, blocks_xl = p2e_legs(torch, ln_gru)
    report.update(p2e)
    report.update(fleet_legs(torch, ln_gru, report))
    report.update(serving_legs(torch, ln_gru))
    # the legs' run dirs stay for phase diag, which removes them
    # each width's launches, path by path: each leg's counts were zeroed just
    # before it and read just after (at S the run leg's, fleet_dv3's and
    # fleet_dv3_inference's apart)
    paths = {"S": {"run": report["run"]["launches"], "fleet_dv3": report["fleet_dv3"]["launches"],
                   "fleet_dv3_inference": report["fleet_dv3_inference"]["launches"]},
             "M": {"run_M": report["run_M"]["launches"]}, "XL": {"p2e_dv3_finetuning": counts_xl}}
    return paths, {"S": blocks, "M": blocks_m, "XL": blocks_xl}, report


# the reference's MsPacman preset (exp=dreamer_v3_100k_ms_pacman: DreamerV3-S,
# batch 16, sequence 64, replay ratio 1, one env, coupled 32-true) on the
# discrete dummy env, cut in learning_starts, total_steps and buffer.size
# only; its log cadence is the leg's own, so that its rate can be read
PRESET_LEARNING_STARTS, PRESET_TOTAL, PRESET_BUFFER = 64, 112, 1024
PRESET_SHAPE = {"algo.per_rank_batch_size": 16, "algo.per_rank_sequence_length": 64, "algo.replay_ratio": 1,
                "env.num_envs": 1, "fabric.precision": "32-true", "algo.world_model.decoupled_rssm": False,
                "algo.dense_units": 512, "algo.world_model.recurrent_model.recurrent_state_size": 512,
                "algo.world_model.encoder.cnn_channels_multiplier": 32, "algo.horizon": 15}
# the reference's Crafter preset (exp=dreamer_v3_XL_crafter: DreamerV3-XL, batch
# 16, sequence 64, replay ratio 0.5, one env, coupled 32-true, encoder keys rgb
# and reward) on the crafter stand-in (tests/torch_suite_stubs: the card's
# machine has no crafter) through the port's CrafterWrapper and
# RewardAsObservationWrapper, cut in learning_starts, total_steps (32 gradient
# steps), buffer.size and the checkpoint cadence only
CRAFTER_LEARNING_STARTS, CRAFTER_TOTAL, CRAFTER_BUFFER = 64, 128, 1024
CRAFTER_GRAD_STEPS = 32
CRAFTER_SHAPE = {"algo.per_rank_batch_size": 16, "algo.per_rank_sequence_length": 64, "algo.replay_ratio": 0.5,
                 "env.num_envs": 1, "fabric.precision": "32-true", "algo.world_model.decoupled_rssm": False,
                 "algo.dense_units": 1024, "algo.world_model.recurrent_model.recurrent_state_size": 4096,
                 "algo.world_model.encoder.cnn_channels_multiplier": 96, "algo.horizon": 15,
                 "algo.cnn_keys.encoder": ["rgb"], "algo.mlp_keys.encoder": ["reward"], "env.id": "crafter_reward",
                 "env.reward_as_observation": True, "env.wrapper._target_": "sheeprl_tpu_torch.envs.crafter.CrafterWrapper"}
STUBS = os.path.join(HERE, "tests", "torch_suite_stubs")


def run_preset(torch, ln_gru, name, args, learning_starts, total, shape, grad_steps):
    """One preset through the CLI on ``cuda:0`` (leg ``name``). Its policy
    steps/s after learning_starts (from its log records) and peak device
    memory; from ``utils/run_info.py`` the end of its first burst
    (``steady_step``, ``steady_t``), the steady-state policy steps/s after it,
    as a bench computes it (to the CLI call's return), and the run's
    ``log_dir``. Fails if ``steady_step`` is missing or outside the run, if
    the leg did not take ``total`` policy steps and ``grad_steps`` gradient
    steps, if its own ``config.yaml`` does not hold ``shape`` or if it
    launched an LN-GRU kernel (the presets' RSSM is coupled)."""
    from sheeprl_tpu_torch.config import load_config_file
    from sheeprl_tpu_torch.utils import run_info

    args = [*args, f"algo.learning_starts={learning_starts}", f"algo.total_steps={total}", "metric.log_every=16",
            f"root_dir={RUN_ROOT}", f"run_name={name}"]
    run_info.last_run.clear()
    t_start = time.perf_counter()
    parsed, counts, seconds, peak = drive(torch, ln_gru, "run", args)
    t_end = time.perf_counter()
    last = dict(run_info.last_run)
    run_info.last_run.clear()
    if any(counts.values()):
        raise AssertionError(f"the {name} leg launched LN-GRU kernels {counts}: its RSSM is coupled")
    out = leg_summary(parsed, counts, seconds, peak, learning_starts, trains=False)
    if out["policy_step"] != total or out["grad_steps"] < grad_steps:
        raise AssertionError(f"the {name} leg: {out['policy_step']} of {total} policy steps, "
                             f"{out['grad_steps']} gradient steps (at least {grad_steps})")
    steady_step, steady_t = last.get("steady_step"), last.get("steady_t")
    if steady_step is None or not learning_starts <= steady_step < total or not t_start < steady_t < t_end:
        raise AssertionError(f"run_info.last_run {last}: no steady_step inside the run [{learning_starts}, {total})")
    if last.get("log_dir") != parsed["log_dir"]:
        raise AssertionError(f"run_info.last_run's log_dir {last.get('log_dir')} is not the leg's {parsed['log_dir']}")
    # the run's own config: the preset's widths and shape, uncut
    cfg = load_config_file(os.path.join(parsed["log_dir"], "config.yaml"))
    ran = {k: cfg.select(k) for k in shape}
    if ran != shape:
        raise AssertionError(f"the {name} leg ran {ran}, the preset is {shape}")
    out.update(args=args, shape=ran, steady_step=steady_step, startup_seconds=steady_t - t_start,
               steady_state_policy_steps_per_s=(out["policy_step"] - steady_step) / (t_end - steady_t),
               log_dir=last["log_dir"])
    return out


def preset_leg(torch, ln_gru):
    """``dv3_ms_pacman`` (phase 5): the MsPacman preset (``run_preset``);
    at replay ratio 1 a gradient step for each policy step after
    learning_starts but the first."""
    args = ["exp=dreamer_v3_100k_ms_pacman", "env=dummy", "env.id=discrete_dummy", f"buffer.size={PRESET_BUFFER}"]
    return run_preset(torch, ln_gru, "dv3_ms_pacman", args, PRESET_LEARNING_STARTS, PRESET_TOTAL, PRESET_SHAPE,
                      PRESET_TOTAL - PRESET_LEARNING_STARTS - 1)


def crafter_leg(torch, ln_gru):
    """``dv3_XL_crafter`` (phase 5): the XL Crafter preset (``run_preset``)
    on the crafter stand-in, which is importable for this leg alone: its
    directory leads ``sys.path`` and the port's suite gates are read again,
    both undone after the leg. Exactly ``CRAFTER_GRAD_STEPS`` gradient
    steps. Prints its own line (``suite: stand-in``)."""
    import importlib
    import importlib.util

    from sheeprl_tpu_torch.utils import imports

    sys.path.insert(0, STUBS)
    importlib.reload(imports)
    try:
        found = importlib.util.find_spec("crafter")
        if not imports._IS_CRAFTER_AVAILABLE or not found.origin.startswith(STUBS):
            raise AssertionError(f"the crafter stand-in in {STUBS} is not the one found: {found}")
        args = ["exp=dreamer_v3_XL_crafter", f"buffer.size={CRAFTER_BUFFER}", f"checkpoint.every={CRAFTER_TOTAL}"]
        out = run_preset(torch, ln_gru, "dv3_XL_crafter", args, CRAFTER_LEARNING_STARTS, CRAFTER_TOTAL,
                         CRAFTER_SHAPE, CRAFTER_GRAD_STEPS)
    finally:
        sys.path.remove(STUBS)
        for name in [m for m, mod in sys.modules.items() if (getattr(mod, "__file__", None) or "").startswith(STUBS)]:
            del sys.modules[name]
        importlib.reload(imports)
    if out["grad_steps"] != CRAFTER_GRAD_STEPS:
        raise AssertionError(f"the dv3_XL_crafter leg took {out['grad_steps']} gradient steps, not {CRAFTER_GRAD_STEPS}")
    out["suite"] = "stand-in"
    emit("dv3_XL_crafter", ok=True, suite="stand-in", seconds=out["seconds"], policy_step=out["policy_step"],
         grad_steps=out["grad_steps"],
         policy_steps_per_s_after_learning_starts=out["policy_steps_per_s_after_learning_starts"],
         steady_state_policy_steps_per_s=out["steady_state_policy_steps_per_s"], steady_step=out["steady_step"],
         startup_seconds=out["startup_seconds"], peak_device_memory=out["peak_device_memory"],
         launches=out["launches"], checkpoints=out["checkpoints"])
    return out


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
    if "serve/evaluate.py" not in (parsed["route"] or "") or "cuda" not in parsed["route"]:
        raise AssertionError(f"ppo_eval's route: {parsed['route']}")
    report["ppo_eval"] = {"seconds": time.perf_counter() - t0, "reward": parsed["reward"],
                          "checkpoint": os.path.basename(ckpts[-1]), "route": parsed["route"]}
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
            report[name] = {"seconds": seconds, "reward": parsed["reward"], "route": parsed["route"]}
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
    sac = ["exp=sac", *common, f"algo.total_steps={SAC_TOTAL}", f"buffer.size={SAC_BUFFER}",
           f"checkpoint.every={SAC_CKPT_EVERY}", "metric.log_every=256"]
    report, logs, feeds = {}, {}, {}
    leg = make_leg(torch, ln_gru, report, logs, feeds)

    leg("sac", sac, 100)
    ckpts = checkpoints(logs["sac"])
    steps = [int(os.path.basename(p)[5:-5]) for p in ckpts]  # overlapped: a mid-run one where a take crossed 256
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
    route = report["sac_eval"]["route"] or ""
    if "serve/evaluate.py" not in route or "cuda" not in route or report["droq_eval"]["route"]:
        raise AssertionError(f"eval routes: sac {route}, droq {report['droq_eval']['route']}")
    t0 = time.perf_counter()
    report["sac_ae_step"] = sac_ae_step(torch, ln_gru)
    report["sac_ae_step"]["seconds"] = time.perf_counter() - t0
    return report


# the DreamerV1/V2 legs: the presets' widths and algorithm settings on the
# dummy envs with 64x64x3 frames, one env (the presets'), cut in length and
# buffer size only. DV2's first burst takes its 20 pretrain steps (100 at
# ratio 0.2); the multidiscrete dummy's 129-step episodes outlast the episode
# buffer's minimum length (the sequence, 50), the discrete dummy's 5 do not
DV2_LEARNING_STARTS, DV2_TOTAL, DV2_RESUME_TOTAL, DV2_BUFFER = 64, 160, 224, 512
DV2_EP_LEARNING_STARTS, DV2_EP_TOTAL = 160, 224
DV1_LEARNING_STARTS, DV1_TOTAL, DV1_BUFFER = 128, 416, 1024


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
P2E_DREAMER = {"dv2": ("discrete_dummy", 64, 96, 96), "dv1": ("continuous_dummy", 64, 160, 176)}


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


# the walker legs train 32 policy steps after learning_starts, the resume 32
# more (PR 16 cut them from 128 to 64 and PR 18 to 32, to keep the script
# under 900 s)
WALKER_TOTAL, WALKER_RESUME_TOTAL = 160, 192


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
        args = common + [f"algo.total_steps={WALKER_TOTAL}", f"run_name={leg}", *extra]
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
        f"algo.total_steps={WALKER_RESUME_TOTAL}", "run_name=walker_resume", "buffer.device_cache=true",
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
    if report["walker_resume"]["policy_step"] != WALKER_RESUME_TOTAL:
        raise AssertionError(f"the walker resume stopped at {report['walker_resume']['policy_step']}")
    report["walker_resume"].update(checkpoint=os.path.basename(last), started_from=want, memmap_fast_resume=True)
    return report


# the actor fleet's DreamerV3 legs: the run legs' DV3-S at 4 envs (a 64-row
# sequence in each env's buffer from policy step 256), 2 workers of 2 envs
FLEET_LEARNING_STARTS, FLEET_TOTAL = 256, 288
FLEET_KNOBS = ["fleet.backoff_s=0.05", "fleet.stats_every_s=1.0"]


class ComputeApps:
    """Samples the card's compute processes (``nvidia-smi
    --query-compute-apps``) on a thread while a leg runs: the pids seen and
    the most processes one sample listed (the sandbox's pid namespace may
    show the card's processes under other pids than ``os.getpid()``)."""

    def __init__(self, every_s=0.5):
        import threading

        self.pids, self.samples, self.max_rows, self.error = set(), 0, 0, None
        self._stop = threading.Event()
        self._every = every_s
        self._thread = threading.Thread(target=self._run, name="smoke-compute-apps", daemon=True)

    def _run(self):
        while not self._stop.wait(self._every):
            try:
                out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                                     capture_output=True, text=True, timeout=30).stdout
                rows = [int(x) for x in out.split() if x.strip().isdigit()]
                self.pids.update(rows)
                self.max_rows = max(self.max_rows, len(rows))
                self.samples += 1
            except Exception as err:  # noqa: BLE001 - reported with the leg
                self.error = repr(err)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


def fleet_summary(parsed, seconds, peak, before, learning_starts, twin):
    """The fleet numbers of one leg beside its serial twin's steps/s: the
    learner's span seconds (env interaction is its wait for rounds), the
    last fleet interval record (publications with bytes and ms, respawns,
    the largest queue depth) and the leg's own peak device memory."""
    logs = parsed["logs"]
    if not logs or not parsed["fleet"]:
        raise AssertionError(f"the leg wrote {len(logs)} log and {len(parsed['fleet'])} fleet records")
    after = [r for r in logs if r["step"] >= learning_starts] or logs
    first, last = after[0], logs[-1]
    sps = ((last["step"] - first["step"]) / (last["elapsed_s"] - first["elapsed_s"])
           if last["elapsed_s"] > first["elapsed_s"] else None)
    spans = {}
    for r in logs:
        for k, v in (r.get("spans") or {}).items():
            spans[k] = spans.get(k, 0.0) + v
    interval = [r for r in parsed["fleet"] if r["action"] == "interval"][-1]
    pubs = max(1, interval["publications"])
    return {"seconds": seconds, "policy_step": int(last["step"]), "grad_steps": int(last.get("grad_steps") or 0),
            "policy_steps_per_s_after_learning_starts": sps, "serial_twin_policy_steps_per_s": twin,
            "env_interaction_s": spans.get("Time/env_interaction_time"), "train_s": spans.get("Time/train_time"),
            "publications": interval["publications"], "publish_bytes_per_publication": interval["publish_bytes"] / pubs,
            "publish_ms_per_publication": interval["publish_ms"] / pubs, "respawns": interval["respawns"],
            "queue_depth_max": max(r.get("queue_depth_max", 0) for r in parsed["fleet"] if r["action"] == "interval"),
            "rounds": interval["rounds"], "relayed_events": interval.get("relayed_events"),
            "own_peak_device_memory": peak - before,
            "incidents": [(r["action"], r.get("worker")) for r in parsed["fleet"]
                          if r["action"] not in ("interval", "spawn", "drain")],
            "act": {k: interval[k] for k in ("act_mode", "act_requests", "act_batches", "act_occupancy",
                                             "act_pad_waste", "act_sessions", "act_version") if k in interval}}


def worker_streams(log_dir):
    """Every worker stream of a fleet leg, validated; returns the paths, the
    exit records (each worker incarnation that ended cleanly writes one) and
    where the workers' time went: each span name's count and total ms over
    both workers (``env_step``: a program step, acting and the env;
    ``queue_wait``: parked on the full data queue; ``param_apply``: a
    publication's wall time from the learner's send to its load in the
    worker)."""
    from sheeprl_tpu_torch.telemetry.schema import validate_jsonl

    root = os.path.join(log_dir, "workers")
    paths = sorted(os.path.join(root, d, "telemetry.jsonl") for d in os.listdir(root))
    exits, spans = [], {}
    for path in paths:
        errors = validate_jsonl(path)
        if errors:
            raise AssertionError(f"{path} fails the schema: {errors[:5]}")
        with open(path) as fh:
            for r in map(json.loads, fh):
                if r["event"] == "fleet" and r["action"] == "worker_exit":
                    exits.append(r)
                elif r["event"] == "trace_span":
                    agg = spans.setdefault(r["name"], {"count": 0, "total_ms": 0.0})
                    agg["count"] += 1
                    agg["total_ms"] += r["dur_ms"]
    return paths, exits, spans


def fleet_twins(torch, ln_gru):
    """The sac_serial and ppo_serial legs alone (the fleet legs' twins),
    for ``--fleet``; phase 5 takes them from its off- and on-policy legs."""
    report, logs, feeds = {}, {}, {}
    common = ["env=dummy", "env.id=continuous_dummy", "env.num_envs=4", "algo.run_test=False",
              f"root_dir={RUN_ROOT}"]
    sac = ["exp=sac", *common, f"algo.total_steps={SAC_TOTAL}", f"buffer.size={SAC_BUFFER}",
           f"checkpoint.every={SAC_CKPT_EVERY}",
           "metric.log_every=256", "algo.overlap.enabled=False"]
    make_leg(torch, ln_gru, report, logs, feeds)("sac_serial", sac, 100)
    report["sac_serial"]["ledger_equal"], _ = offpolicy_ledger(torch, checkpoints(logs["sac_serial"])[-1])
    ppo = ["exp=ppo", "env=dummy", "metric.log_every=1024", "algo.run_test=False", f"root_dir={RUN_ROOT}",
           f"algo.total_steps={PPO_TOTAL}", "checkpoint.every=2048", "algo.overlap.enabled=False"]
    parsed, counts, seconds, peak = drive(torch, ln_gru, "run", ppo + ["run_name=ppo_serial"])
    report["ppo_serial"] = onpolicy_summary(parsed, seconds, peak)
    report["ppo_serial"]["args"] = ppo
    report["ppo_serial"]["ledger_equal"], _ = agent_ledger(torch, checkpoints(parsed["log_dir"])[-1])
    return report


def fleet_dv3_args():
    """The DreamerV3-S fleet legs' arguments: those they share with their
    serial twin, and each fleet leg's own (before ``algo.fleet.workers=2``)."""
    dv3 = run_common([f"algo.total_steps={FLEET_TOTAL}", f"algo.learning_starts={FLEET_LEARNING_STARTS}",
                      "env.num_envs=4", "checkpoint.every=0", *FLEET_KNOBS])
    return dv3, {
        "fleet_dv3": [],
        # the batched act service on the card (Sebulba): the workers ship obs and noise rows
        "fleet_dv3_inference": ["fleet.act_mode=inference"],
        # hang_s above a respawned worker's first params transfer (a 65.9 MB
        # publication, seconds on a slow host): a shorter budget flags that
        # transfer as a hang, respawns again and nears quarantine
        "fleet_dv3_chaos": ["fleet.hang_s=6.0", "resilience.chaos.enabled=True",
                            # lifetime steps: a worker takes FLEET_TOTAL / 2
                            f"resilience.chaos.crash_at_step={FLEET_TOTAL // 4}",
                            "resilience.chaos.crash_workers=[0]",
                            f"resilience.chaos.hang_at_step={3 * FLEET_TOTAL // 8}",
                            "resilience.chaos.hang_workers=[1]",
                            "resilience.chaos.hang_s=60.0"],
    }


def fleet_legs(torch, ln_gru, done):
    """The actor fleet (phase 5), after the legs whose serial twins it is
    held to (``done``: sac_serial's and ppo_serial's ledgers)."""
    report = {}

    def leg(name, args, learning_starts, twin, kernels=False):
        gc.collect()
        before = torch.cuda.memory_allocated()
        with ComputeApps() as apps:
            parsed, counts, seconds, peak = drive(torch, ln_gru, "run", args + [f"run_name={name}"])
        if (min(counts.values()) < 1) if kernels else any(counts.values()):
            raise AssertionError(f"the {name} leg launched LN-GRU kernels {counts}")
        out = fleet_summary(parsed, seconds, peak, before, learning_starts, twin)
        spawned = {r["pid"] for r in parsed["fleet"] if r["action"] in ("spawn", "respawn") and "pid" in r}
        paths, exits, spans = worker_streams(parsed["log_dir"])
        if len(paths) != 2 or not exits or any(r["cuda_initialized"] for r in exits):
            raise AssertionError(f"the {name} leg's workers: streams {paths}, exit records {exits}")
        # the learner is the one process on the card: no sample lists a second
        if spawned & apps.pids or apps.max_rows > 1 or not apps.samples:
            raise AssertionError(f"the {name} leg's compute apps: pids {sorted(apps.pids)} (workers "
                                 f"{sorted(spawned)}), at most {apps.max_rows} a sample, {apps.samples} samples, "
                                 f"{apps.error}")
        out.update(launches=counts, args=args, worker_pids=sorted(spawned), compute_app_pids=sorted(apps.pids),
                   compute_apps_per_sample_max=apps.max_rows, compute_app_samples=apps.samples,
                   compute_apps_error=apps.error, learner_pid=os.getpid(),
                   workers_cuda_initialized=[r["cuda_initialized"] for r in exits], worker_spans=spans)
        report[name] = out
        return parsed

    # DreamerV3-S on the kernels: serial twin, fleet, fleet under chaos
    dv3, dv3_legs = fleet_dv3_args()
    parsed, counts, seconds, peak = drive(torch, ln_gru, "run", dv3 + ["run_name=fleet_dv3_serial",
                                                                       "algo.overlap.enabled=False"])
    report["fleet_dv3_serial"] = leg_summary(parsed, counts, seconds, peak, FLEET_LEARNING_STARTS)
    serial = ledger(torch, checkpoints(parsed["log_dir"])[-1])
    serial_rows = column_rows(torch, checkpoints(parsed["log_dir"])[-1])
    twin = report["fleet_dv3_serial"]["policy_steps_per_s_after_learning_starts"]
    for name, extra in dv3_legs.items():
        parsed = leg(name, dv3 + ["algo.fleet.workers=2", *extra], FLEET_LEARNING_STARTS, twin, kernels=True)
        got = ledger(torch, checkpoints(parsed["log_dir"])[-1])
        if name in ("fleet_dv3", "fleet_dv3_inference"):
            if got != serial:
                raise AssertionError(f"the {name} leg's ledger {got} != fleet_dv3_serial's {serial}")
            report[name]["ledger_equal"] = serial
            if name == "fleet_dv3_inference":
                act = report[name]["act"]
                if report[name]["launches"] != report["fleet_dv3"]["launches"] or not act.get("act_requests"):
                    raise AssertionError(f"fleet_dv3_inference launched {report[name]['launches']} (fleet_dv3: "
                                         f"{report['fleet_dv3']['launches']}); act service {act}")
                report[name]["worker_mode_policy_steps_per_s"] = \
                    report["fleet_dv3"]["policy_steps_per_s_after_learning_starts"]
            continue
        # a respawn restarts its worker's episodes mid-way, so that worker's
        # columns may close one episode fewer (one closing row) per respawn
        # than the serial loop's: the Ratio ledger is the serial one, every
        # column holds exactly one step row per env step and the serial
        # loop's closing rows less at most its worker's respawns
        ratio_ledger = {k: got[k] for k in ("policy_step", "grad_steps", "ratio")}
        rows = column_rows(torch, checkpoints(parsed["log_dir"])[-1])
        respawns = [report[name]["incidents"].count(("respawn", w)) for w in range(2)]
        epw = len(rows) // 2
        steps = got["policy_step"] // len(rows)
        if ratio_ledger != {k: serial[k] for k in ratio_ledger} or any(full for _, full in got["rb"]) or any(
                (step, step + closing) != (steps, pos) or not serial_closing - respawns[c // epw] <= closing
                <= serial_closing for c, ((step, closing), (_, serial_closing), (pos, _))
                in enumerate(zip(rows, serial_rows, got["rb"]))):
            raise AssertionError(f"the {name} leg's ledger {got}, rows {rows} (respawns {respawns}); "
                                 f"fleet_dv3_serial's {serial}, rows {serial_rows}")
        report[name].update(ratio_ledger_equal=ratio_ledger, rb=got["rb"], serial_rb=serial["rb"], rows=rows,
                            serial_rows=serial_rows, respawns_by_worker=respawns)
    incidents = report["fleet_dv3_chaos"]["incidents"]
    for want in (("crash", 0), ("respawn", 0), ("hang", 1), ("respawn", 1)):
        if want not in incidents:
            raise AssertionError(f"fleet_dv3_chaos: no {want} in {incidents}")
    if any(a == "quarantine" for a, _ in incidents) or report["fleet_dv3"]["incidents"] or \
            report["fleet_dv3_inference"]["incidents"]:
        raise AssertionError(f"fleet incidents: {report['fleet_dv3']['incidents']}, "
                             f"{report['fleet_dv3_inference']['incidents']}, chaos {incidents}")

    # SAC at the sac leg's preset widths, 4 envs: sac_serial's ledger
    sac = [a for a in done["sac_serial"]["args"] if a != "algo.overlap.enabled=False"]
    for name, extra in (("fleet_sac", []), ("fleet_sac_socket", ["fleet.transport=socket"]),
                        ("fleet_sac_inference", ["fleet.act_mode=inference"]),
                        ("fleet_sac_inference_socket", ["fleet.act_mode=inference", "fleet.transport=socket"])):
        parsed = leg(name, sac + ["algo.fleet.workers=2", *FLEET_KNOBS, *extra], 100,
                     done["sac_serial"]["policy_steps_per_s_after_learning_starts"])
        got, _ = offpolicy_ledger(torch, checkpoints(parsed["log_dir"])[-1])
        if got != done["sac_serial"]["ledger_equal"]:
            raise AssertionError(f"the {name} leg's ledger {got} != sac_serial's {done['sac_serial']['ledger_equal']}")
        report[name]["ledger_equal"] = got
        if "socket" in name:
            accepts = sorted(r["worker"] for r in parsed["net"] if r["action"] == "accept")
            if accepts != [0, 1]:
                raise AssertionError(f"{name}: net accepts {accepts}")
            report[name]["net_accepts"] = accepts
        if "inference" in name:
            act = report[name]["act"]
            if act.get("act_mode") != "inference" or not act.get("act_requests") or report[name]["incidents"]:
                raise AssertionError(f"{name}: act service {act}, incidents {report[name]['incidents']}")
            report[name]["worker_mode_policy_steps_per_s"] = \
                report[name.replace("_inference", "")]["policy_steps_per_s_after_learning_starts"]

    # PPO at the ppo leg's settings, strict rounds: ppo_serial's counters
    ppo = [a for a in done["ppo_serial"]["args"] if a != "algo.overlap.enabled=False"]
    parsed = leg("fleet_ppo", ppo + ["algo.fleet.workers=2", *FLEET_KNOBS], 0,
                 done["ppo_serial"]["policy_steps_per_s"])
    got, _ = agent_ledger(torch, checkpoints(parsed["log_dir"])[-1])
    if got != done["ppo_serial"]["ledger_equal"]:
        raise AssertionError(f"fleet_ppo's counters {got} != ppo_serial's {done['ppo_serial']['ledger_equal']}")
    if report["fleet_ppo"]["publications"] != got["update"] + 1:  # the first, then one after each update
        raise AssertionError(f"fleet_ppo: {report['fleet_ppo']['publications']} publications, {got['update']} updates")
    report["fleet_ppo"]["ledger_equal"] = got
    return report


# the serving legs: 32 HTTP clients x 50 act requests (PPO, SAC), 16
# DreamerV3-S sessions x 64 steps; the reloader polls every 0.2 s
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_SESSIONS, SERVE_STEPS = 32, 50, 16, 64
SERVE_POLL_S, SERVE_DEADLINE_S = 0.2, 120.0
# Anakin at bench.py's lanes and chunks: 1024 lanes, chunks of 256 steps, seed 5, for 5 s
ANAKIN_SLOTS, ANAKIN_CHUNK, ANAKIN_SEED, ANAKIN_SECONDS = 1024, 256, 5, 5.0


def serve_copy(name, src_log_dir, ckpt, root=RUN_ROOT):
    """A fresh run dir for a serving leg: the source run's config.yaml and
    one of its checkpoints, so the reloader sees only what the leg puts
    there. Returns the checkpoint's path in it."""
    d = os.path.join(HERE, "logs", "runs", root, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(os.path.join(d, "checkpoint"))
    shutil.copy(os.path.join(src_log_dir, "config.yaml"), d)
    dst = os.path.join(d, "checkpoint", os.path.basename(ckpt))
    shutil.copy(ckpt, dst)
    return dst


def serve_publish(ckpt, serve_ckpt):
    """Put a newer checkpoint beside the served one the way a run writes it
    (a temporary name, then one rename): the reloader never sees half a
    file."""
    d = os.path.dirname(serve_ckpt)
    tmp = os.path.join(d, os.path.basename(ckpt) + ".part")
    shutil.copy(ckpt, tmp)
    os.replace(tmp, os.path.join(d, os.path.basename(ckpt)))


def serve_start(torch, ckpt):
    """``serve_from_checkpoint(block=False)`` on the checkpoint's saved
    config with the serve defaults, HTTP on an ephemeral port, every bucket
    warmed for both greedy variants. Returns (server, its start line, the
    device memory before it, the env's observation spec for the clients)."""
    from sheeprl_tpu_torch.config import CONFIG_ROOT, load_config_file
    from sheeprl_tpu_torch.serve import serve_from_checkpoint
    from sheeprl_tpu_torch.utils.env import probe_env_spaces

    cfg = load_config_file(os.path.join(os.path.dirname(os.path.dirname(ckpt)), "config.yaml"))
    cfg["serve"] = load_config_file(os.path.join(CONFIG_ROOT, "serve", "default.yaml"))
    cfg.set_path("serve.http.port", 0)
    cfg.set_path("serve.hot_reload.poll_interval_s", SERVE_POLL_S)
    cfg.set_path("serve.telemetry.log_every_s", 1.0)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        server = serve_from_checkpoint(ckpt, cfg, block=False)
    sys.stderr.write(err.getvalue())
    line = [l for l in err.getvalue().splitlines() if l.startswith("[serve] policy ")]
    policy = server.policy
    if policy.device.type != "cuda" or not line or torch.cuda.get_device_name(0) not in line[0]:
        server.stop()
        raise AssertionError(f"the policy serves on {policy.device}: {line}")
    space = probe_env_spaces(cfg, int(cfg.seed)).single_observation_space
    keys = tuple(cfg.algo.cnn_keys.encoder) + tuple(cfg.algo.mlp_keys.encoder)
    obs = {k: [list(space[k].shape), str(space[k].dtype)] for k in keys}
    return server, line[0], before, obs


def serve_clients(spec):
    """The load generator, run in a process of its own (the server keeps its
    GIL): one HTTP/1.1 keep-alive connection a client, each POSTing /v1/act
    in turn. ``spec``: ``port``, ``obs`` (key → [shape, dtype]),
    ``deadline_s``, ``until_reload`` (a client past its quota goes on while
    ``GET /healthz`` shows no reload) and ``clients``, each ``{seed, n,
    det (a bool, or "alternate"), session?, export_at?, record?}``: with
    ``export_at`` the client asks for its session's state at that step and
    goes on under ``<session>_imported``, importing it. Returns ``{results:
    [(client, i, status, latency_s, response, body if record)], seconds}``."""
    import http.client
    import threading

    import numpy as np

    port, t_end = spec["port"], time.monotonic() + spec["deadline_s"]
    out, lock = [], threading.Lock()

    def obs(rng):
        return {k: (rng.integers(0, 256, shape, dtype="uint8") if dtype == "uint8"
                    else rng.standard_normal(shape).astype("float32")).tolist()
                for k, (shape, dtype) in spec["obs"].items()}

    def client(c, cs):
        rng = np.random.default_rng(cs["seed"])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        i, prev, sid = 0, None, cs.get("session")
        try:
            while time.monotonic() < t_end:
                if i >= cs["n"]:
                    if not spec["until_reload"]:
                        break
                    conn.request("GET", "/healthz")
                    if json.loads(conn.getresponse().read().decode())["reloads"] >= 1:
                        break
                det = cs["det"] if isinstance(cs["det"], bool) else (i + c) % 2 == 0
                body = {"obs": obs(rng), "deterministic": det}
                if cs.get("export_at") == i:
                    body["return_state"] = True
                if cs.get("export_at") is not None and i == cs["export_at"] + 1:
                    sid = f"{sid}_imported"
                    body["session_state"] = prev["session_state"]
                if sid is not None:
                    body["session_id"] = sid
                t0 = time.perf_counter()
                # bytes: headers and body leave in one send (no Nagle wait between them)
                conn.request("POST", "/v1/act", json.dumps(body).encode(), {"Content-Type": "application/json"})
                r = conn.getresponse()
                prev = json.loads(r.read().decode())
                dt = time.perf_counter() - t0
                with lock:
                    out.append((c, i, r.status, dt, prev, body if cs.get("record") else None))
                i += 1
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c, cs)) for c, cs in enumerate(spec["clients"])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"results": out, "seconds": time.perf_counter() - t0}


def _serve_clients_main(spec, conn):
    conn.send(serve_clients(spec))
    conn.close()


def serve_traffic(spec, during=None, target=None):
    """``serve_clients(spec)`` (or ``target``'s clients) in a spawned
    process; ``during()`` runs here meanwhile (e.g. publishing a newer
    checkpoint). Returns its result."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=target or _serve_clients_main, args=(spec, send), name="smoke-serve-clients",
                       daemon=True)
    proc.start()
    send.close()
    try:
        if during is not None:
            during()
        if not recv.poll(spec["deadline_s"] + 60):
            raise AssertionError("the serving clients gave no result")
        return recv.recv()
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()


def serve_report(torch, server, line, before, traffic):
    """The leg's numbers: the server's own `serve` record (its counts,
    occupancy, pad waste and histogram p50/p95/p99), the clients' exact
    latency percentiles and requests/s, retraces and reloads, the device
    memory the server holds, and its stream validated by the port's schema.
    Fails on an error, a shape warmup did not run, or no reload."""
    from sheeprl_tpu_torch.telemetry.schema import validate_jsonl

    results = [r for t in traffic for r in t["results"]]
    seconds = sum(t["seconds"] for t in traffic)
    stats = server.stats()
    lat = sorted(r[3] * 1e3 for r in results)
    bad = [(r[2], r[4]) for r in results if r[2] != 200]
    q = (lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]) if lat else (lambda p: None)
    rep = {"start": line, "device": str(server.policy.device), "requests": len(results),
           "http_non_200": len(bad), "completed": stats["completed"], "errors": stats["errors"],
           "rejected": stats["rejected"], "retraces": stats["retraces"], "reloads": stats["reloads"],
           "params_version": stats["params_version"], "batches": stats["batches"],
           "batch_occupancy": stats["batch_occupancy"], "pad_waste": stats["pad_waste"],
           "avg_batch_size": stats["avg_batch_size"], "p50_ms": stats["p50_ms"], "p95_ms": stats["p95_ms"],
           "p99_ms": stats["p99_ms"], "client_p50_ms": q(0.50), "client_p95_ms": q(0.95), "client_p99_ms": q(0.99),
           "traffic_s": seconds, "requests_per_s": len(results) / seconds if seconds > 0 else None,
           "device_memory_held_bytes": torch.cuda.memory_allocated() - before,
           "device_memory_peak_bytes": torch.cuda.max_memory_allocated() - before,
           "buckets": list(server.policy.buckets)}
    server.stop()
    stream = os.path.join(os.path.dirname(str(server.reloader.ckpt_dir)), "serve", "telemetry.jsonl")
    errors = validate_jsonl(stream)
    if errors:
        raise AssertionError(f"{stream} fails the schema: {errors[:5]}")
    with open(stream) as fh:
        recs = [json.loads(l) for l in fh]
    rep["reload_events"] = [{k: r.get(k) for k in ("action", "step", "params_version", "error")}
                            for r in recs if r["event"] == "reload"]
    if bad or rep["errors"] or rep["retraces"] or rep["reloads"] < 1 or rep["completed"] != len(results) or any(
            r["action"] != "swapped" for r in rep["reload_events"]):
        raise AssertionError(f"serving: {len(bad)} failed requests {bad[:3]}, {rep}")
    return rep


def serve_flat_leg(torch, ln_gru, name, src_log_dir, mid, last):
    """serve_ppo / serve_sac: the mid-run checkpoint served, 32 clients x 50
    requests (every other one deterministic), the last checkpoint put beside
    it once an eighth of the requests are answered: the reloader must swap
    it in before the traffic ends (clients go on past their quota until
    it has)."""
    ckpt = serve_copy(name, src_log_dir, mid)
    ln_gru.reset_launch_counts()
    server, line, before, obs = serve_start(torch, ckpt)

    def publish():
        deadline = time.monotonic() + SERVE_DEADLINE_S
        while (server.batcher.stats.snapshot()["completed"] < SERVE_CLIENTS * SERVE_REQUESTS // 8
               and time.monotonic() < deadline):
            time.sleep(0.005)
        serve_publish(last, ckpt)

    spec = {"port": server.port, "obs": obs, "deadline_s": SERVE_DEADLINE_S, "until_reload": True,
            "clients": [{"seed": 1000 + c, "n": SERVE_REQUESTS, "det": "alternate"} for c in range(SERVE_CLIENTS)]}
    traffic = serve_traffic(spec, during=publish)
    counts = {k.__name__: k.launches for k in ln_gru.KERNELS}
    rep = serve_report(torch, server, line, before, [traffic])
    if any(counts.values()):
        raise AssertionError(f"{name} launched LN-GRU kernels {counts}")
    rep.update(checkpoints=[os.path.basename(mid), os.path.basename(last)], clients=SERVE_CLIENTS,
               requests_per_client=SERVE_REQUESTS, extra_requests=rep["requests"] - SERVE_CLIENTS * SERVE_REQUESTS)
    return rep


def serve_dv3_leg(torch, ln_gru, src_log_dir, mid, last):
    """serve_dv3: the DreamerV3-S run leg's mid-run checkpoint (64x64x3
    pixels), 16 sessions x 64 steps, sessions 0-7 deterministic and the rest
    sampled; session 1 exports its state at step 31 and goes on under a
    fresh id whose first request imports it. Sessions 0 and 1 replayed alone
    at bucket 1 afterwards, on the representation noise their rows drew in
    the mixed batches, give the same actions and latents within the
    builder's tolerance. Then the last checkpoint is put beside the served
    one and 14 sessions go on stepping until the reloader has swapped it in."""
    import threading

    import numpy as np

    from sheeprl_tpu_torch.serve.policy import tree_map
    from sheeprl_tpu_torch.serve.session_codec import decode_state

    ckpt = serve_copy("serve_dv3", src_log_dir, mid)
    ln_gru.reset_launch_counts()
    server, line, before, obs = serve_start(torch, ckpt)
    policy = server.policy
    tol = policy.core.tol
    # the representation samples its state in greedy serving too (as the
    # reference's player does): record the noise rows sessions 0 and 1 get
    # in their mixed batches, to replay them alone on the same draws
    watch, noise_rows, batch_sessions = ("s0", "s1", "s1_imported"), {}, threading.local()
    served_act_batch, served_apply = policy.act_batch, policy.core.apply

    def act_batch(obs, n, deterministic=False, sessions=None, expired_out=None):
        batch_sessions.ids = list(sessions or [])
        return served_act_batch(obs, n, deterministic, sessions, expired_out)

    def apply(params, obs, state, noise, greedy):
        for i, sid in enumerate(getattr(batch_sessions, "ids", [])):
            if sid in watch:
                noise_rows.setdefault(sid, []).append(tree_map(lambda t: t[i:i + 1].clone(), noise))
        return served_apply(params, obs, state, noise, greedy)

    policy.act_batch, policy.core.apply = act_batch, apply
    clients = [{"seed": 2000 + c, "n": SERVE_STEPS, "det": c < SERVE_SESSIONS // 2, "session": f"s{c}",
                "record": c < 2} for c in range(SERVE_SESSIONS)]
    clients[1]["export_at"] = 31
    phase_a = serve_traffic({"port": server.port, "obs": obs, "deadline_s": SERVE_DEADLINE_S,
                             "until_reload": False, "clients": clients})
    got = phase_a["results"]
    policy.act_batch, policy.core.apply = served_act_batch, served_apply
    if len(got) != SERVE_SESSIONS * SERVE_STEPS or any(r[2] != 200 for r in got):
        bad = [(r[0], r[1], r[2], r[4]) for r in got if r[2] != 200][:3]
        raise AssertionError(f"serve_dv3: {len(got)} answers, failures {bad}")
    stats_a = server.stats()
    blob = next(r[4]["session_state"] for r in got if r[0] == 1 and r[1] == 31)
    # sessions 0 and 1 alone at bucket 1, on their own observations and draws
    compare, draw = {}, policy.core.draw_noise
    for c in (0, 1):
        mine = sorted((r for r in got if r[0] == c), key=lambda r: r[1])
        rows = iter(noise_rows["s0"] if c == 0 else noise_rows["s1"] + noise_rows["s1_imported"])
        policy.core.draw_noise = lambda g, n, rows=rows: next(rows)
        served = np.concatenate([np.asarray(r[4]["actions"], np.float64) for r in mine])
        alone = np.concatenate([policy.act({k: np.asarray(v) for k, v in r[5]["obs"].items()}, True,
                                           session=f"alone_{c}").astype(np.float64) for r in mine])
        policy.core.draw_noise = draw
        final = policy.export_session("s0" if c == 0 else "s1_imported")
        ref = policy.export_session(f"alone_{c}")
        latent = max(float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
                     for x, y in zip(final, ref))
        compare[f"s{c}"] = {"steps": len(mine), "max_abs_action_diff": float(np.abs(served - alone).max()),
                            "max_abs_latent_diff": latent}
        if compare[f"s{c}"]["max_abs_action_diff"] > tol or latent > tol:
            raise AssertionError(f"serve_dv3 session {c}: mixed buckets vs alone {compare[f's{c}']} > {tol}")

    # phase B: the last checkpoint published; sessions go on until it is swapped in
    serve_publish(last, ckpt)
    phase_b = serve_traffic({"port": server.port, "obs": obs, "deadline_s": SERVE_DEADLINE_S, "until_reload": True,
                             "clients": [{"seed": 3000 + c, "n": 8, "det": c % 2 == 0, "session": f"s{c}"}
                                         for c in range(2, SERVE_SESSIONS)]})
    counts = {k.__name__: k.launches for k in ln_gru.KERNELS}
    rep = serve_report(torch, server, line, before, [phase_a, phase_b])
    if any(counts.values()):
        raise AssertionError(f"serve_dv3 launched LN-GRU kernels {counts}")
    lat_a = sorted(r[3] * 1e3 for r in got)
    rep.update(checkpoints=[os.path.basename(mid), os.path.basename(last)], sessions=SERVE_SESSIONS,
               steps=SERVE_STEPS, serve_tol=tol, alone_vs_mixed=compare,
               exported_state_shapes=[list(np.asarray(x).shape) for x in decode_state(blob)],
               phase_a={"seconds": phase_a["seconds"], "requests": len(got), "batches": stats_a["batches"],
                        "occupancy": stats_a["batch_occupancy"], "pad_waste": stats_a["pad_waste"],
                        "p50_ms": stats_a["p50_ms"], "p99_ms": stats_a["p99_ms"],
                        "client_p50_ms": lat_a[len(lat_a) // 2], "client_p99_ms": lat_a[int(0.99 * len(lat_a))]},
               phase_b={"seconds": phase_b["seconds"], "requests": len(phase_b["results"])})
    return rep


def anakin_leg(torch, ln_gru):
    """anakin: ``run_anakin`` on the card at bench.py's settings (1024 lanes,
    chunks of 256 steps, seed 5) for 5 s: env steps/s, the operations one
    chunk dispatches, and the CUDA kernels one chunk launches as
    torch.profiler records them (None with the reason where it records
    none); the state and mean reward finite."""
    from sheeprl_tpu_torch.config import Config
    from sheeprl_tpu_torch.fleet.anakin import build_anakin, run_anakin

    cfg = Config({"seed": ANAKIN_SEED, "fleet": {"anakin": {"slots": ANAKIN_SLOTS, "chunk": ANAKIN_CHUNK}}})
    ln_gru.reset_launch_counts()
    res = run_anakin(cfg, min_seconds=ANAKIN_SECONDS, device="cuda")
    params, carry, chunk_fn, _, _ = build_anakin(cfg, device="cuda")
    carry, r = chunk_fn(params, carry)
    torch.cuda.synchronize()
    kernels, why = None, None
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            carry, r = chunk_fn(params, carry)
            torch.cuda.synchronize()
        kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if not kernels:
            kernels, why = None, "the profiler recorded no device event"
    except Exception as err:  # noqa: BLE001 - reported with the leg
        why = repr(err)
    if not (torch.isfinite(carry[0]).all() and torch.isfinite(r)):
        raise AssertionError("anakin: a non-finite state or reward")
    if any(k.launches for k in ln_gru.KERNELS):
        raise AssertionError("anakin launched LN-GRU kernels")
    res.update(kernels_per_chunk=kernels, kernels_per_chunk_note=why, mean_reward=float(r), seed=ANAKIN_SEED)
    return res


def serve_command(torch, ckpt):
    """serve_cmd: ``python -m sheeprl_tpu_torch serve checkpoint_path=<ckpt>
    serve.http.port=0`` as users start it, in a process of its own: it must
    say it serves on the card (device and name on stderr), answer one
    ``POST /v1/act`` and report it in ``GET /stats``; then it is stopped."""
    import http.client

    proc = subprocess.Popen([sys.executable, "-m", "sheeprl_tpu_torch", "serve", f"checkpoint_path={ckpt}",
                             "serve.http.port=0", "serve.hot_reload.enabled=False", "serve.telemetry.jsonl=False"],
                            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    try:
        line = proc.stdout.readline().strip()
        started = time.perf_counter() - t0
        port = int(line.rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/act", json.dumps({"obs": {"state": [0.5] * 10}, "deterministic": True}).encode(),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        act = json.loads(r.read().decode())
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read().decode())
        conn.close()
    finally:
        proc.kill()
        _, err = proc.communicate(timeout=60)
    start = [l for l in err.splitlines() if l.startswith("[serve] policy ")]
    name = torch.cuda.get_device_name(0)
    if r.status != 200 or stats["completed"] != 1 or not start or f"on cuda:0 ({name})" not in start[0]:
        raise AssertionError(f"the serve command: {r.status} {act}, stats {stats}, start {start}, {err[-2000:]}")
    return {"start": start[0], "listening": line, "ready_s": started, "actions": act["actions"],
            "completed": stats["completed"]}


def run_dir(name):
    """A phase-5 leg's run dir (``logs/runs/chip_smoke/<leg>/version_0``)."""
    return os.path.join(HERE, "logs", "runs", RUN_ROOT, name, "version_0")


def serving_legs(torch, ln_gru):
    """serve_ppo, serve_sac, the serve command (serve_cmd) and serve_dv3
    from the ppo, sac and run legs' mid-run and last checkpoints, then
    anakin; each leg's seconds."""
    report = {}
    for name, src in (("serve_ppo", "ppo"), ("serve_sac", "sac")):
        t0 = time.perf_counter()
        ck = checkpoints(run_dir(src))
        report[name] = serve_flat_leg(torch, ln_gru, name, run_dir(src), ck[0], ck[-1])
        report[name]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["serve_cmd"] = serve_command(torch, checkpoints(run_dir("ppo"))[-1])
    report["serve_cmd"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck = checkpoints(run_dir("run"))
    mid = [p for p in ck if LEARNING_STARTS < int(os.path.basename(p)[5:-5]) < TOTAL]
    report["serve_dv3"] = serve_dv3_leg(torch, ln_gru, run_dir("run"), mid[-1], ck[-1])
    report["serve_dv3"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["anakin"] = anakin_leg(torch, ln_gru)
    report["anakin"]["leg_seconds"] = time.perf_counter() - t0
    return report


def serve_alone(torch, ln_gru):
    """``--serve``: the three training legs whose checkpoints the serving
    legs serve (ppo, sac and the DreamerV3-S run leg, as phase 5 runs them),
    the ppo and sac evals (through serve/evaluate.py), then serving_legs."""
    report = {}
    ppo = ["exp=ppo", "env=dummy", "metric.log_every=1024", "algo.run_test=False", f"root_dir={RUN_ROOT}",
           f"algo.total_steps={PPO_TOTAL}", "checkpoint.every=2048", "run_name=ppo"]
    sac = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "env.num_envs=4", "algo.run_test=False",
           f"root_dir={RUN_ROOT}", f"algo.total_steps={SAC_TOTAL}", f"buffer.size={SAC_BUFFER}",
           f"checkpoint.every={SAC_CKPT_EVERY}", "metric.log_every=256", "run_name=sac"]
    dv3 = run_common() + [f"algo.total_steps={TOTAL}", "run_name=run"]
    for name, args in (("ppo", ppo), ("sac", sac), ("run", dv3)):
        _, counts, seconds, _ = drive(torch, ln_gru, "run", args)
        report[name] = {"seconds": seconds, "launches": counts, "checkpoints": [
            os.path.basename(p) for p in checkpoints(run_dir(name))]}
    for name, src in (("ppo_eval", "ppo"), ("sac_eval", "sac")):
        parsed, _, seconds, _ = drive(torch, ln_gru, "eval", [f"checkpoint_path={checkpoints(run_dir(src))[-1]}"])
        if parsed["reward"] is None or "serve/evaluate.py" not in (parsed["route"] or ""):
            raise AssertionError(f"{name}: reward {parsed['reward']}, route {parsed['route']}")
        report[name] = {"seconds": seconds, "reward": parsed["reward"], "route": parsed["route"]}
    report.update(serving_legs(torch, ln_gru))
    return report


# phase gateway: the serving plane scaled out (sheeprl_tpu_torch/gateway/)
# and the data flywheel (sheeprl_tpu_torch/flywheel/), replicas on the card.
# Its inputs live under GATEWAY_ROOT, which phase diag's clean-up leaves be:
# the checkpoints the serving legs served, kept by gateway_stash.
GATEWAY_ROOT = "chip_smoke_gateway"
GW_DV3_CRASH_AT = 200  # replica 0 os._exits at its 200th act request, first incarnation only
GW_FLY_SESSIONS, GW_FLY_ROUNDS, GW_FLY_MORE, GW_FLY_THREADS = 100, 4, 2, 8
GW_ARM_SESSIONS, GW_ARM_ROUNDS = 100, 2
GW_BC_STEPS, GW_BC_BATCH = 50, 64
GW_BC_TOL = 1e-5  # one BC step, the card against the CPU, f32 with TF32 off on both
GW_DEADLINE_S = 180.0


def gateway_dir(name):
    return os.path.join(HERE, "logs", "runs", GATEWAY_ROOT, name)


def gateway_stash(dv3_log_dir, dv3_mid, dv3_last, sac_log_dir, sac_ckpt):
    """Keep what phase gateway serves: the DreamerV3-S run leg's config and
    mid-run checkpoint (its last beside them, to publish), the SAC leg's
    config and last checkpoint, each in a run dir of its own under
    GATEWAY_ROOT (serve_copy)."""
    shutil.rmtree(os.path.join(HERE, "logs", "runs", GATEWAY_ROOT), ignore_errors=True)
    serve_copy("gateway_dv3", dv3_log_dir, dv3_mid, root=GATEWAY_ROOT)
    os.makedirs(gateway_dir("gateway_dv3_next"))
    shutil.copy(dv3_last, gateway_dir("gateway_dv3_next"))
    serve_copy("flywheel_bc", sac_log_dir, sac_ckpt, root=GATEWAY_ROOT)


def gateway_clients(spec):
    """The gateway's load generator, run in a process of its own: ``threads``
    threads, each with one HTTP/1.1 keep-alive connection, step the sessions
    dealt to it in rounds (round r steps each of its sessions once). Every
    request carries its session id, a ``traceparent`` with a trace id of its
    own and the reward; a 503 (admission's shed, with ``retry_after_s``) is
    retried after that hint under the same trace id, any other answer is
    final. ``spec``: ``port``, ``deadline_s``, ``obs`` (key → [shape, dtype],
    or None for the counter policy's ``{"x": [[0.0]]}``), ``threads`` and
    ``sessions`` (``{sid, steps, det, seed}``). Returns ``{results: [(sid,
    step, status, latency_s, attempts, trace_id, answer)], seconds}``, the
    answer holding the actions, params_version and session_version."""
    import http.client
    import threading
    import uuid

    import numpy as np

    port, t_end = spec["port"], time.monotonic() + spec["deadline_s"]
    out, lock = [], threading.Lock()

    def obs(rng):
        if spec["obs"] is None:
            return {"x": [[0.0]]}
        return {k: (rng.integers(0, 256, shape, dtype="uint8") if dtype == "uint8"
                    else rng.standard_normal(shape).astype("float32")).tolist()
                for k, (shape, dtype) in spec["obs"].items()}

    def worker(mine):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        rngs = {s["sid"]: np.random.default_rng(s["seed"]) for s in mine}
        try:
            for step in range(max(s["steps"] for s in mine)):
                for s in mine:
                    if step >= s["steps"] or time.monotonic() > t_end:
                        continue
                    trace_id = uuid.uuid4().hex
                    body = json.dumps({"obs": obs(rngs[s["sid"]]), "deterministic": s["det"],
                                       "session_id": s["sid"], "reward": 1.0,
                                       "traceparent": f"00-{trace_id}-{uuid.uuid4().hex[:16]}-01"}).encode()
                    t0, attempts = time.perf_counter(), 0
                    while True:
                        attempts += 1
                        conn.request("POST", "/v1/act", body, {"Content-Type": "application/json"})
                        r = conn.getresponse()
                        answer = json.loads(r.read().decode())
                        if r.status != 503 or time.monotonic() > t_end:
                            break
                        time.sleep(float(answer.get("retry_after_s") or 0.25))
                    dt = time.perf_counter() - t0
                    keep = {k: answer.get(k) for k in ("actions", "params_version", "session_version", "replica",
                                                       "error")}
                    with lock:
                        out.append((s["sid"], step, r.status, dt, attempts, trace_id, keep))
        finally:
            conn.close()

    dealt = [spec["sessions"][t::spec["threads"]] for t in range(spec["threads"])]
    threads = [threading.Thread(target=worker, args=(mine,)) for mine in dealt if mine]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"results": out, "seconds": time.perf_counter() - t0}


def _gateway_clients_main(spec, conn):
    conn.send(gateway_clients(spec))
    conn.close()


def gateway_cfg(ckpt=None, **settings):
    """A gateway config: the checkpoint's run config (when serving one) with
    the serve and gateway defaults composed in, then ``settings``
    (dotted key → value), as the gateway command composes it."""
    from sheeprl_tpu_torch.config import CONFIG_ROOT, Config, load_config_file

    cfg = load_config_file(os.path.join(os.path.dirname(os.path.dirname(ckpt)), "config.yaml")) if ckpt else Config()
    for group in ("serve", "gateway"):
        cfg[group] = load_config_file(os.path.join(CONFIG_ROOT, group, "default.yaml"))
    base = {"gateway.replicas": 2, "gateway.http.port": 0, "gateway.replica.platform": "cuda",
            "gateway.supervisor.health_poll_s": 0.2, "gateway.supervisor.backoff_s": 0.2,
            "gateway.supervisor.jitter": 0.1, "gateway.telemetry.log_every_s": 1.0,
            "gateway.replica.hot_reload.poll_interval_s": 3600.0}  # reloads only through the rolling reload
    for key, val in {**base, **settings}.items():
        cfg.set_path(key, val)
    return cfg


def gateway_routable(gw, ready):
    if len(gw.manager.routable()) != gw.manager.num_replicas:
        gateway_stop(gw)
        raise AssertionError(f"{len(gw.manager.routable())} of {gw.manager.num_replicas} replicas came up")
    return gw, ready


def gateway_start(ckpt, **settings):
    """A started gateway from a checkpoint, through gateway_from_checkpoint
    as the gateway command calls it (block=False, its stdout line kept off
    this script's). Returns (gateway, seconds until every replica
    answered)."""
    from sheeprl_tpu_torch.gateway import gateway_from_checkpoint

    cfg = gateway_cfg(ckpt, **settings)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        gw = gateway_from_checkpoint(ckpt, cfg, block=False)
    return gateway_routable(gw, time.perf_counter() - t0)


def gateway_spawn(run_dir, ckpt=None, **settings):
    """A gateway built (build_cluster, its stream under ``run_dir``) whose
    replicas are spawned now and started later by ``gateway_ready``, so the
    next legs' replicas come up while an earlier leg runs: the checkpoint's
    replicas, or the synthetic counter fleet. Returns (gateway, config,
    spawn time)."""
    from sheeprl_tpu_torch.gateway import build_cluster
    from sheeprl_tpu_torch.telemetry.sinks import JsonlSink

    cfg = gateway_cfg(ckpt, **settings)
    sink = JsonlSink(os.path.join(run_dir, "gateway", "telemetry.jsonl"))
    gw = build_cluster(cfg, ckpt_path=ckpt, sink=sink, start=False, telemetry_dir=run_dir)
    t0 = time.perf_counter()
    gw.manager.start()
    return gw, cfg, t0


def gateway_ready(spawned):
    """start_cluster on a spawned gateway; returns (gateway, seconds from
    its spawn until every replica answered)."""
    from sheeprl_tpu_torch.gateway import start_cluster

    gw, cfg, t0 = spawned
    start_cluster(gw, cfg)
    return gateway_routable(gw, time.perf_counter() - t0)


def gateway_stop(gw):
    gw.stop()
    gw.manager.shutdown()
    if gw._sink is not None:
        gw._sink.close()


def gateway_traffic(port, sessions, threads, obs=None, during=None):
    """``gateway_clients`` in a spawned process (the gateway keeps its GIL);
    ``during()`` runs here meanwhile."""
    return serve_traffic({"port": port, "deadline_s": GW_DEADLINE_S, "obs": obs, "threads": threads,
                          "sessions": sessions}, during=during, target=_gateway_clients_main)


def replica_streams(run_dir):
    """Each replica incarnation's stream under ``run_dir``: path → records."""
    import glob

    out = {}
    for path in sorted(glob.glob(os.path.join(run_dir, "replicas", "*", "telemetry.jsonl*"))):
        with open(path) as fh:
            out[path] = [json.loads(l) for l in fh if l.strip().startswith("{")]
    return out


def replicas_on_card(run_dirs, apps, baseline_rows, n):
    """The replicas served on the card: every replica stream under the
    ``run_dirs`` validates and its memory samples carry the card's allocator
    numbers, and a sample of the card's compute apps listed ``n`` replica
    processes beside what was there before (this process). Returns each
    stream's device memory."""
    from sheeprl_tpu_torch.telemetry.schema import validate_jsonl

    streams = {path: recs for d in run_dirs for path, recs in replica_streams(d).items()}
    root = os.path.join(HERE, "logs", "runs", GATEWAY_ROOT)
    memory = {}
    for path, recs in streams.items():
        errors = validate_jsonl(path)
        if errors:
            raise AssertionError(f"{path} fails the schema: {errors[:3]}")
        mem = [r for r in recs if r["event"] == "mem"]
        name = os.path.relpath(path, root)
        memory[name] = {"hbm_peak_bytes": max((r.get("hbm_peak_bytes", 0) for r in mem), default=None),
                        "hbm_bytes_reserved": max((r.get("hbm_bytes_reserved", 0) for r in mem), default=None),
                        "rss_bytes": max((r.get("rss_bytes", 0) for r in mem), default=None)}
        if not mem or not memory[name]["hbm_peak_bytes"]:
            raise AssertionError(f"{name}: no memory sample of the card ({len(mem)} samples)")
    if len(streams) < n or apps.max_rows < baseline_rows + n or not apps.samples:
        raise AssertionError(f"{len(streams)} replica streams; the card's compute apps listed at most "
                             f"{apps.max_rows} processes a sample ({baseline_rows} before), {apps.samples} "
                             f"samples, {apps.error}")
    return {"replica_device_memory": memory, "compute_apps_per_sample_max": apps.max_rows,
            "compute_apps_before": baseline_rows}


def compute_app_rows():
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout
    return sum(1 for x in out.split() if x.strip().isdigit())


def capture_records(capture_dir, every=False):
    """The capture records under a capture root (all replicas, all
    segments) as the flywheel's reader gives them, or ``every`` one written."""
    from sheeprl_tpu_torch.diag.timeline import iter_events
    from sheeprl_tpu_torch.flywheel import discover_capture_streams, iter_capture_records

    if every:
        return [r for s in discover_capture_streams(capture_dir) for r in iter_events(s) if r.get("event") == "capture"]
    return list(iter_capture_records(capture_dir))


def latency_pcts(results):
    lat = sorted(r[3] * 1e3 for r in results)
    q = (lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]) if lat else (lambda p: None)
    return {"p50_ms": q(0.50), "p95_ms": q(0.95), "p99_ms": q(0.99)}


def gateway_dv3_leg(torch, ln_gru, base_rows):
    """gateway_dv3: the DreamerV3-S run leg's mid-run checkpoint behind
    gateway_from_checkpoint, 2 replicas on cuda:0, the WAL-backed inproc
    broker, capture on; 16 sessions x 64 steps from 16 client threads (the
    serve_dv3 leg's 64x64x3 frames, sessions 0-7 deterministic), replica 0
    chaos-exiting at its GW_DV3_CRASH_AT-th request. Once both replicas
    answer again, the run leg's last checkpoint is published and POST
    /admin/rolling_reload runs under 8 more steps of each session. Every
    step acked (its session_version the step's number: nothing acked was
    lost or replayed), at least one failover and one migration, every live
    replica swapped and serving params_version >= 1, and one capture record
    for each acked act: as many records as acked trace ids, no trace id
    twice, the same set, as the capture reader gives them (a record that the
    killed replica wrote for an act it never answered gives way to the
    retry's). ``base_rows``: the card's compute processes besides
    this leg's replicas (this process, the fleets spawned for the later
    legs)."""
    import threading
    import urllib.request

    run = gateway_dir("gateway_dv3")
    ckpt = checkpoints(run)[0]
    nxt = os.path.join(gateway_dir("gateway_dv3_next"), os.listdir(gateway_dir("gateway_dv3_next"))[0])
    ln_gru.reset_launch_counts()
    with ComputeApps() as apps:
        gw, ready = gateway_start(ckpt, **{"gateway.broker.wal_dir": os.path.join(run, "wal"),
                                                  "serve.capture.enabled": True,
                                                  "gateway.replica.chaos": {"crash_at_step": GW_DV3_CRASH_AT}})
        manager, obs = gw.manager, None
        try:
            from sheeprl_tpu_torch.utils.env import probe_env_spaces

            run_cfg = gateway_cfg(ckpt)
            space = probe_env_spaces(run_cfg, int(run_cfg.seed)).single_observation_space
            keys = tuple(run_cfg.algo.cnn_keys.encoder) + tuple(run_cfg.algo.mlp_keys.encoder)
            obs = {k: [list(space[k].shape), str(space[k].dtype)] for k in keys}
            # the supervisor's view, sampled: when the crash was seen and when
            # both replicas answered again
            marks, stop = {}, threading.Event()

            def watch():
                while not stop.wait(0.02):
                    if manager.crashes and "crash" not in marks:
                        marks["crash"] = time.perf_counter()
                    if "crash" in marks and "back" not in marks and len(manager.routable()) == 2:
                        marks["back"] = time.perf_counter()

            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            sessions = [{"sid": f"s{c}", "steps": SERVE_STEPS, "det": c < SERVE_SESSIONS // 2, "seed": 4000 + c}
                        for c in range(SERVE_SESSIONS)]
            phase_a = gateway_traffic(gw.port, sessions, SERVE_SESSIONS, obs)
            stats_a = gw.stats.snapshot()
            if not manager.wait_routable(timeout_s=GW_DEADLINE_S):
                raise AssertionError(f"replica 0 did not come back: {[h.state for h in manager.handles]}")
            serve_publish(nxt, ckpt)
            reload = {}

            def rolling_reload():
                time.sleep(1.0)  # under traffic
                t0 = time.perf_counter()
                req = urllib.request.Request(f"http://127.0.0.1:{gw.port}/admin/rolling_reload", data=b"{}",
                                             method="POST")
                with urllib.request.urlopen(req, timeout=GW_DEADLINE_S) as resp:
                    reload["results"] = json.loads(resp.read())["results"]
                reload["seconds"] = time.perf_counter() - t0

            more = [dict(s, steps=8, seed=s["seed"] + 100) for s in sessions]
            phase_b = gateway_traffic(gw.port, more, SERVE_SESSIONS, obs, during=rolling_reload)
            stop.set()
            watcher.join(timeout=5)
            # each replica's params_version, as the reload's settle poll read it
            versions = {h.replica_id: h.params_version for h in manager.handles}
            record = gw.gateway_record()
            stats = gw.stats.snapshot()
        finally:
            gateway_stop(gw)
    counts = {k.__name__: k.launches for k in ln_gru.KERNELS}
    results = phase_a["results"] + [(sid, SERVE_STEPS + step, *rest) for sid, step, *rest in phase_b["results"]]
    bad = [r for r in results if r[2] != 200]
    lost = []
    for c in range(SERVE_SESSIONS):
        got = sorted((r[1], r[6]["session_version"]) for r in results if r[0] == f"s{c}" and r[2] == 200)
        if [v for _, v in got] != list(range(1, SERVE_STEPS + 9)):
            lost.append((f"s{c}", got[:3], len(got)))
    swapped = [r for r in reload.get("results", []) if r.get("swapped")]
    captured = capture_records(os.path.join(run, "capture"))
    written = capture_records(os.path.join(run, "capture"), every=True)
    acked_ids = {r[5] for r in results if r[2] == 200}
    captured_ids = [r.get("trace_id") for r in captured]
    rep = {"ready_s": ready, "sessions": SERVE_SESSIONS, "steps": SERVE_STEPS + 8, "requests": len(results),
           "non_200": len(bad), "retried_503": sum(r[4] - 1 for r in results),
           "requests_per_s": len(phase_a["results"]) / phase_a["seconds"], "phase_a_seconds": phase_a["seconds"],
           "gateway_p50_ms": record["p50_ms"], "gateway_p95_ms": record["p95_ms"], "gateway_p99_ms": record["p99_ms"],
           "client": latency_pcts(phase_a["results"]),
           # the replica that answered each session's first step, and its last
           "first_replica_sessions": {str(r): sum(1 for x in results if x[1] == 0 and x[6].get("replica") == r)
                                      for r in range(2)},
           "last_replica_sessions": {str(r): sum(1 for x in results if x[1] == SERVE_STEPS + 7
                                                 and x[6].get("replica") == r) for r in range(2)},
           "failovers": stats["failovers"], "migrations": stats["migrations"], "rehydrates": stats["rehydrates"],
           "failovers_phase_a": stats_a["failovers"], "crashes": manager.crashes,
           "respawns": manager.total_respawns, "crash_to_routable_s": (marks["back"] - marks["crash"])
           if {"crash", "back"} <= set(marks) else None,
           "failover_request_max_ms": max(r[3] for r in phase_a["results"]) * 1e3,
           "reload_seconds": reload.get("seconds"), "reload_results": reload.get("results"),
           "params_version_by_replica": versions, "capture_records": len(captured),
           "capture_unique_trace_ids": len(set(captured_ids)), "acked": len(acked_ids),
           "capture_written": len(written), "capture_retried": sum(1 for r in captured if r.get("attempt")),
           "capture_equals_acked": set(captured_ids) == acked_ids, "launches": counts,
           **replicas_on_card([run], apps, base_rows, 2)}
    problems = []
    if bad or lost:
        problems.append(f"unacked {[(r[0], r[1], r[2], r[6]) for r in bad[:3]]}, sessions off their versions {lost[:3]}")
    if rep["failovers"] < 1 or rep["migrations"] < 1 or manager.crashes < 1:
        problems.append(f"failovers {rep['failovers']}, migrations {rep['migrations']}, crashes {manager.crashes}")
    if len(swapped) != 2 or any(v < 1 for v in versions.values()):
        problems.append(f"rolling reload {reload}, params_version by replica {versions}")
    if not rep["capture_equals_acked"] or not len(captured) == len(acked_ids) == len(set(captured_ids)):
        problems.append(f"capture: {len(captured)} records, {len(set(captured_ids))} trace ids, "
                        f"{len(acked_ids)} acked, equal {rep['capture_equals_acked']}")
    if any(counts.values()):
        problems.append(f"launched LN-GRU kernels {counts}")
    if problems:
        raise AssertionError(f"gateway_dv3: {'; '.join(problems)}")
    return rep


def flywheel_cli(run_dir, ckpt, *overrides):
    """``python -m sheeprl_tpu_torch flywheel ...`` as users run it, in a
    process of its own; returns (its summary, seconds)."""
    import ast

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch", "flywheel", f"run_dir={run_dir}",
                           f"checkpoint_path={ckpt}", "flywheel.algo=synthetic_counter", *overrides],
                          cwd=HERE, capture_output=True, text=True, timeout=GW_DEADLINE_S)
    seconds = time.perf_counter() - t0
    line = [l for l in proc.stdout.splitlines() if l.startswith("[flywheel] ")]
    if proc.returncode or not line:
        raise AssertionError(f"the flywheel command: rc {proc.returncode}, {proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    return ast.literal_eval(line[0][len("[flywheel] "):]), seconds


def counter_sessions(prefix, n):
    return [{"sid": f"{prefix}{i:03d}", "steps": 0, "det": True, "seed": i} for i in range(n)]


def counter_check(results, start, mismatches, versions):
    """The counter policy's actions continue each session's count: the
    answer to step k is k + start."""
    for sid, step, status, _, _, _, answer in results:
        if status != 200 or float(answer["actions"][0][0]) != float(step + start):
            mismatches.append((sid, step, status, answer))
        versions.add(answer.get("params_version"))


def gateway_flywheel_leg(torch, ln_gru, spawned_a, spawned_b, base_rows):
    """gateway_flywheel: the JAX package's acceptance loop at its flywheel
    runs' scale. Two synthetic counter fleets on the card (2 replicas each,
    seeded from a checkpoint dir): A with capture on, B without. 100
    sessions x 4 rounds from 8 threads through A; then one turn of the
    flywheel command with flywheel.gateway_url (ingest, synthetic_counter
    fine-tune, checkpoint, the HTTP rolling reload); 2 more rounds (the
    counters continue, only params_version 1 answers); a second turn
    without the gateway ingests exactly the 200 new samples and counts the
    400 as duplicates. Then the act p95 with capture on (A) and off (B),
    two arms each in turns (on, off, off, on), fresh sessions each arm.
    ``spawned_a``/``spawned_b``: the fleets from flywheel_spawn."""
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.flywheel import run_flywheel

    run_a, run_b = gateway_dir("flywheel_on"), gateway_dir("flywheel_off")
    seed = os.path.join(run_a, "checkpoint", "ckpt_0.ckpt")
    ln_gru.reset_launch_counts()
    with ComputeApps() as apps:
        gw_a, ready_a = gateway_ready(spawned_a)
        gw_b, ready_b = gateway_ready(spawned_b)
        try:
            sessions = counter_sessions("u", GW_FLY_SESSIONS)
            first = gateway_traffic(gw_a.port, [dict(s, steps=GW_FLY_ROUNDS) for s in sessions], GW_FLY_THREADS)
            mismatches, before = [], set()
            counter_check(first["results"], 0, mismatches, before)
            turn1, turn1_s = flywheel_cli(run_a, seed, f"flywheel.gateway_url=http://127.0.0.1:{gw_a.port}")
            more = gateway_traffic(gw_a.port, [dict(s, steps=GW_FLY_MORE) for s in sessions], GW_FLY_THREADS)
            after = set()
            counter_check(more["results"], GW_FLY_ROUNDS, mismatches, after)
            # the second turn in this process, on the command's own composition
            t0 = time.perf_counter()
            turn2 = run_flywheel(*cli.flywheel_config([f"run_dir={run_a}", f"checkpoint_path={turn1['checkpoint']}",
                                                       "flywheel.algo=synthetic_counter"]))
            turn2_s = time.perf_counter() - t0
            arms = []
            for k, (name, gw) in enumerate((("on", gw_a), ("off", gw_b), ("off", gw_b), ("on", gw_a))):
                arm = gateway_traffic(gw.port, [dict(s, steps=GW_ARM_ROUNDS) for s in counter_sessions(
                    f"arm{k}-", GW_ARM_SESSIONS)], GW_FLY_THREADS)
                counter_check(arm["results"], 0, mismatches, set())
                arms.append({"capture": name, "requests": len(arm["results"]),
                             "requests_per_s": len(arm["results"]) / arm["seconds"], **latency_pcts(arm["results"])})
        finally:
            gateway_stop(gw_b)
            gateway_stop(gw_a)
    counts = {k.__name__: k.launches for k in ln_gru.KERNELS}
    p95 = {side: statistics.mean(a["p95_ms"] for a in arms if a["capture"] == side) for side in ("on", "off")}
    ing1, ing2 = turn1["ingest"], turn2["ingest"]
    reload_results = (turn1.get("reload") or {}).get("results") or []
    rep = {"ready_s": {"capture_on": ready_a, "capture_off": ready_b},
           "first_rounds": {"requests": len(first["results"]), "seconds": first["seconds"],
                            **latency_pcts(first["results"])},
           "turn1": {"seconds": turn1_s, "ingest": ing1, "finetune": turn1.get("finetune"),
                     "checkpoint": os.path.basename(turn1.get("checkpoint", "")), "reload": turn1.get("reload"),
                     "duration_s": turn1.get("duration_s")},
           "turn2": {"seconds": turn2_s, "samples": ing2["samples"], "duplicates": ing2["duplicates"],
                     "checkpoint": os.path.basename(turn2.get("checkpoint", ""))},
           "params_versions_before": sorted(before), "params_versions_after": sorted(after),
           "mismatches": len(mismatches), "p95_arms": arms, "p95_ms_capture_on": p95["on"],
           "p95_ms_capture_off": p95["off"], "capture_p95_overhead": p95["on"] / p95["off"] - 1.0,
           "launches": counts, **replicas_on_card([run_a, run_b], apps, base_rows, 4)}
    problems = []
    if mismatches:
        problems.append(f"counter mismatches {mismatches[:3]}")
    if ing1["samples"] != GW_FLY_SESSIONS * GW_FLY_ROUNDS or ing1["trace_join_frac"] != 1.0:
        problems.append(f"turn 1 ingest {ing1}")
    if rep["turn1"]["checkpoint"] != "ckpt_10.ckpt" or len(reload_results) != 2 or not all(
            r.get("swapped") for r in reload_results):
        problems.append(f"turn 1 checkpoint {rep['turn1']['checkpoint']}, reload {turn1.get('reload')}")
    if before != {0} or after != {1}:
        problems.append(f"params_version {before} before the reload, {after} after")
    if ing2["samples"] != GW_FLY_SESSIONS * GW_FLY_MORE or ing2["duplicates"] != GW_FLY_SESSIONS * GW_FLY_ROUNDS:
        problems.append(f"turn 2 ingest {ing2}")
    if any(counts.values()):
        problems.append(f"launched LN-GRU kernels {counts}")
    if problems:
        raise AssertionError(f"gateway_flywheel: {'; '.join(problems)}")
    return rep


def flywheel_spawn():
    """Spawn phase gateway's later fleets together: the synthetic counter
    fleets of gateway_flywheel (A with capture, B without; each seeded from
    a checkpoint dir holding ckpt_0) and flywheel_bc's SAC replicas, 6
    replica processes."""
    import numpy as np

    from sheeprl_tpu_torch.flywheel import write_checkpoint

    out = {}
    for name, capture in (("flywheel_on", True), ("flywheel_off", False)):
        run = gateway_dir(name)
        write_checkpoint(os.path.join(run, "checkpoint"), 0, {"params": {"w": np.zeros((1,), np.float32)}})
        out[name] = gateway_spawn(run, **{"gateway.replica.ckpt_dir": os.path.join(run, "checkpoint"),
                                          "serve.capture.enabled": capture})
    run = gateway_dir("flywheel_bc")
    out["flywheel_bc"] = gateway_spawn(run, checkpoints(run)[0], **{"serve.capture.enabled": True})
    return out


def flywheel_bc_leg(torch, ln_gru, spawned, base_rows):
    """flywheel_bc: behaviour cloning on the card over real captured
    traffic. The SAC leg's last checkpoint behind gateway_from_checkpoint
    (2 replicas on cuda:0, capture on); 32 sessions x 50 sampled requests;
    then run_flywheel over that capture with the port's SAC PolicyCore on
    cuda:0 (the generic greedy-BC step), from a seed checkpoint
    ``{"params": core.extract_params(state), "algo": "sac_bc"}``,
    flywheel.steps=50, batch_size=64. The step ran on cuda:0, its loss is
    finite, the new checkpoint's actor differs from the seed's, and a
    policy built from the new actor on the card acts. Two checks hold the
    step's arithmetic: one BC step from the seed on the capture's first 64
    records, on the card, agrees with the same step on the CPU (the actor
    within GW_BC_TOL, the loss within rel GW_BC_TOL), and the turn lowers
    the loss over the whole capture. ``spawned``: its replicas from
    flywheel_spawn."""
    import dataclasses

    import numpy as np

    from sheeprl_tpu_torch.config import Config
    from sheeprl_tpu_torch.flywheel import run_flywheel, write_checkpoint
    from sheeprl_tpu_torch.flywheel.recipe import build_finetune_step
    from sheeprl_tpu_torch.serve import InferencePolicy
    from sheeprl_tpu_torch.serve.policy import get_policy_builder
    from sheeprl_tpu_torch.utils.checkpoint import CheckpointManager
    from sheeprl_tpu_torch.utils.env import probe_env_spaces

    run = gateway_dir("flywheel_bc")
    ckpt = checkpoints(run)[0]
    cfg = gateway_cfg(ckpt)
    spaces = probe_env_spaces(cfg, int(cfg.seed))
    keys = tuple(cfg.algo.mlp_keys.encoder)
    obs = {k: [list(spaces.single_observation_space[k].shape), "float32"] for k in keys}
    ln_gru.reset_launch_counts()
    with ComputeApps() as apps:
        gw, ready = gateway_ready(spawned)
        try:
            traffic = gateway_traffic(gw.port, [{"sid": f"c{c}", "steps": SERVE_REQUESTS, "det": False,
                                                 "seed": 5000 + c} for c in range(SERVE_CLIENTS)], SERVE_CLIENTS,
                                      obs)
        finally:
            gateway_stop(gw)
    bad = [r for r in traffic["results"] if r[2] != 200]
    core = get_policy_builder(str(cfg.algo.name))(cfg, spaces.single_observation_space, spaces.single_action_space)
    state = CheckpointManager.load_for_inference(ckpt)
    seed = write_checkpoint(os.path.join(run, "bc_checkpoint"), 0,
                            {"params": core.extract_params(state), "algo": "sac_bc"})
    fw = Config({"flywheel": {"steps": GW_BC_STEPS, "batch_size": GW_BC_BATCH, "lr": 0.01, "max_version_lag": 4,
                              "buffer_size": 100000, "seed": 0, "capture_dir": os.path.join(run, "capture")}})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_flywheel(run, seed, cfg=fw, core=core)
    turn_s = time.perf_counter() - t0
    new = CheckpointManager.load(out["checkpoint"])
    old = CheckpointManager.load(seed)
    moved = {k: float((new["params"]["actor"][k].float() - old["params"]["actor"][k].float()).abs().max())
             for k in old["params"]["actor"]}
    policy = InferencePolicy(dataclasses.replace(core, extract_params=lambda p: p["params"]), new, buckets=[1])
    act = np.asarray(policy.act({k: np.zeros(spaces.single_observation_space[k].shape, np.float32) for k in keys},
                                deterministic=True))
    # the step's arithmetic: the card against the CPU on one fixed batch, and
    # the whole capture's loss before and after the turn (the step returns the
    # loss of the parameters it was given)
    recs = capture_records(os.path.join(run, "capture"))
    whole = {k: np.asarray([np.asarray(r["obs"][k], np.float32).reshape(-1) for r in recs], np.float32) for k in keys}
    whole["actions"] = np.asarray([np.asarray(r["actions"], np.float32).reshape(-1) for r in recs], np.float32)
    first = {k: v[:GW_BC_BATCH] for k, v in whole.items()}
    cpu_cfg = Config(cfg.to_dict())
    cpu_cfg.set_path("fabric.accelerator", "cpu")
    cpu_core = get_policy_builder(str(cfg.algo.name))(cpu_cfg, spaces.single_observation_space,
                                                      spaces.single_action_space)
    card_params, card_m = build_finetune_step("sac_bc", fw, core=core)(old["params"], first)
    cpu_params, cpu_m = build_finetune_step("sac_bc", fw, core=cpu_core)(old["params"], first)
    step_err = max(float((card_params["actor"][k].cpu() - cpu_params["actor"][k]).abs().max())
                   for k in cpu_params["actor"])
    loss_rel = abs(card_m["loss"] - cpu_m["loss"]) / max(abs(cpu_m["loss"]), 1e-12)
    measure = build_finetune_step("sac_bc", fw, core=core)
    whole_before = measure(old["params"], whole)[1]["loss"]
    whole_after = measure(new["params"], whole)[1]["loss"]
    counts = {k.__name__: k.launches for k in ln_gru.KERNELS}
    fin = out.get("finetune") or {}
    rep = {"ready_s": ready, "requests": len(traffic["results"]), "non_200": len(bad),
           "traffic_seconds": traffic["seconds"], **latency_pcts(traffic["results"]),
           "ingest": {k: out["ingest"][k] for k in ("samples", "duplicates", "trace_join_frac", "torn_lines")},
           "device": fin.get("device"), "first_loss": fin.get("first_loss"), "last_loss": fin.get("loss"),
           "steps": fin.get("steps"), "batch_size": fin.get("batch_size"), "turn_seconds": turn_s,
           "checkpoint": os.path.basename(out.get("checkpoint", "")), "actor_max_abs_change": max(moved.values()),
           "policy_device": str(policy.device), "action": act.tolist(), "launches": counts,
           "step_card_vs_cpu": {"cpu_device": cpu_m["device"], "actor_max_abs_err": step_err,
                                "loss_rel_err": loss_rel, "tol": GW_BC_TOL},
           "capture_loss_before": whole_before, "capture_loss_after": whole_after, "capture_rows": len(recs),
           **replicas_on_card([run], apps, base_rows, 2)}
    problems = []
    if bad or out["ingest"]["samples"] != SERVE_CLIENTS * SERVE_REQUESTS:
        problems.append(f"{len(bad)} failed requests {bad[:3]}, ingest {out['ingest']}")
    if fin.get("device") != "cuda:0" or not np.isfinite(fin.get("loss", np.nan)):
        problems.append(f"the BC step on {fin.get('device')}, loss {fin.get('loss')}")
    if not max(moved.values()) > 0 or policy.device.type != "cuda" or not np.isfinite(act).all():
        problems.append(f"actor change {moved}, policy on {policy.device}, action {act}")
    if card_m["device"] != "cuda:0" or cpu_m["device"] != "cpu" or not (step_err <= GW_BC_TOL
                                                                         and loss_rel <= GW_BC_TOL):
        problems.append(f"one BC step on {card_m['device']} against {cpu_m['device']}: actor max abs err "
                        f"{step_err}, loss rel err {loss_rel} (tolerance {GW_BC_TOL})")
    if not whole_after < whole_before:
        problems.append(f"the turn did not lower the loss over the capture: {whole_before} -> {whole_after}")
    if any(counts.values()):
        problems.append(f"launched LN-GRU kernels {counts}")
    if problems:
        raise AssertionError(f"flywheel_bc: {'; '.join(problems)}")
    return rep


def phase_gateway(torch, ln_gru):
    """The three legs of phase gateway, each with its seconds. The fleets of
    gateway_flywheel and flywheel_bc (6 replica processes) are spawned when
    the phase starts and come up while gateway_dv3 runs (their ready_s count
    from that spawn); each leg's compute-apps check counts the replicas
    alive beside its own. The phase's inputs (GATEWAY_ROOT) are removed at
    its end."""
    report = {}
    base_rows = compute_app_rows()  # this process
    spawned = flywheel_spawn()
    try:
        t0 = time.perf_counter()
        report["gateway_dv3"] = gateway_dv3_leg(torch, ln_gru, base_rows + 6)
        report["gateway_dv3"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["gateway_flywheel"] = gateway_flywheel_leg(torch, ln_gru, spawned["flywheel_on"],
                                                          spawned["flywheel_off"], base_rows + 2)
        report["gateway_flywheel"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["flywheel_bc"] = flywheel_bc_leg(torch, ln_gru, spawned["flywheel_bc"], base_rows)
        report["flywheel_bc"]["seconds"] = time.perf_counter() - t0
    finally:
        for gw, _, _ in spawned.values():
            gateway_stop(gw)  # a second stop of a stopped gateway is a no-op
    shutil.rmtree(os.path.join(HERE, "logs", "runs", GATEWAY_ROOT), ignore_errors=True)
    return report


def gateway_alone(torch, ln_gru):
    """``--gateway``: the sac and DreamerV3-S run legs (as phase 5 runs them)
    for the checkpoints phase gateway serves, then the phase."""
    sac = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "env.num_envs=4", "algo.run_test=False",
           f"root_dir={RUN_ROOT}", f"algo.total_steps={SAC_TOTAL}", f"buffer.size={SAC_BUFFER}",
           f"checkpoint.every={SAC_CKPT_EVERY}", "metric.log_every=256", "run_name=sac"]
    dv3 = run_common() + [f"algo.total_steps={TOTAL}", "run_name=run"]
    report = {}
    for name, args in (("sac", sac), ("run", dv3)):
        _, counts, seconds, _ = drive(torch, ln_gru, "run", args)
        report[name] = {"seconds": seconds, "launches": counts}
    gateway_keep()
    shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
    t0 = time.perf_counter()
    report.update(phase_gateway(torch, ln_gru))
    report["phase_seconds"] = time.perf_counter() - t0
    return report


def gateway_keep():
    """gateway_stash from the run and sac legs' run dirs."""
    ck = checkpoints(run_dir("run"))
    mid = [p for p in ck if LEARNING_STARTS < int(os.path.basename(p)[5:-5]) < TOTAL]
    gateway_stash(run_dir("run"), mid[-1], ck[-1], run_dir("sac"), checkpoints(run_dir("sac"))[-1])


# the diag leg: DreamerV3-S on the kernels with the live plane's endpoint up,
# one torch.profiler window over bursts after learning_starts (two envs: a
# window of 8 policy steps holds 4 iterations, each with one burst), and the
# model manager on; 16 bursts in all
DIAG_TOTAL, DIAG_TRACE_AT, DIAG_TRACE_WINDOW = LEARNING_STARTS + 32, LEARNING_STARTS + 8, 8
# the scopes a training step's launches fall in: the facade's step range, and
# the train-time span that encloses the burst on the learner's thread
TRAIN_SCOPES = ("train", "Time/train_time")


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def prom_values(text):
    """A Prometheus text exposition as {family sample (labels dropped): value}."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        out[name.split("{", 1)[0]] = float(value)
    return out


class LiveScraper:
    """Polls a running leg's ``GET /metrics`` and ``GET /live`` on a thread
    until one scrape shows the families the ``log`` and ``overlap`` events
    feed with counts above 0 and a ``/live`` snapshot with its window; keeps
    that scrape (the endpoint is up only while the run is)."""

    FAMILIES = ("sheeprl_step", "sheeprl_step_time_seconds_hist_count", "sheeprl_overlap_queue_cap",
                "sheeprl_overlap_player_stall_frac_hist_count")

    def __init__(self, port, every_s=0.2):
        import threading

        self.base = f"http://127.0.0.1:{port}"
        self.metrics, self.live, self.scrapes, self.error = None, None, 0, None
        self._stop = threading.Event()
        self._every = every_s
        self._thread = threading.Thread(target=self._run, name="smoke-live-scraper", daemon=True)

    def _run(self):
        import urllib.request

        while self.live is None and not self._stop.wait(self._every):
            try:
                with urllib.request.urlopen(self.base + "/metrics", timeout=5) as resp:
                    values = prom_values(resp.read().decode())
                with urllib.request.urlopen(self.base + "/live", timeout=5) as resp:
                    live = json.loads(resp.read().decode())
                self.scrapes += 1
            except Exception as err:  # noqa: BLE001 - the endpoint is not up (yet, or any more)
                self.error = repr(err)
                continue
            if all(values.get(f, 0) > 0 for f in self.FAMILIES) and live.get("window_s") and \
                    live.get("events_in_window", 0) > 0:
                self.metrics = {f: values[f] for f in self.FAMILIES}
                self.live = {k: live.get(k) for k in ("window_s", "events_in_window", "streams", "sps",
                                                      "binding_stage", "ingested")}

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)


def diag_cli(command, argv):
    """One diagnostics command of the port's CLI in this process; returns
    its JSON report (its stdout)."""
    from sheeprl_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.COMMANDS[command](argv)
    return json.loads(buf.getvalue()) if "json=true" in argv else buf.getvalue()


def registry_versions(name_prefix):
    """{group: [versions]} of the local model registry (``models_registry/``
    in the working dir) for one ``<algo>_<env>_`` prefix."""
    root = os.path.join(HERE, "models_registry")
    out = {}
    for d in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        if d.startswith(name_prefix):
            out[d[len(name_prefix):]] = sorted(int(v[1:]) for v in os.listdir(os.path.join(root, d)))
    return out


def registered_actions(torch, ckpt, prefix, steps=8):
    """The registered world model and actor, loaded into fresh modules on
    the card, against the checkpoint's own on the same observations and
    noise: their env actions and recurrent states must be bitwise equal."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _actions_dim, make_player
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs
    from sheeprl_tpu_torch.config import load_config_file
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.utils.env import single_env
    from sheeprl_tpu_torch.utils.model_manager import ModelManager

    cfg = load_config_file(os.path.join(os.path.dirname(os.path.dirname(ckpt)), "config.yaml"))
    dev = torch.device("cuda")
    env = single_env(cfg, int(cfg.seed))
    is_continuous = isinstance(env.action_space, spaces.Box)
    actions_dim = _actions_dim(env.action_space)
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    manager = ModelManager(os.path.join(HERE, "models_registry"))
    sources = {"checkpoint": (1234, saved["wm"], saved["actor"]),
               "registry": (4321, manager.download_model(prefix + "world_model"),
                            manager.download_model(prefix + "actor"))}
    players = {}
    for name, (seed, wm_sd, actor_sd) in sources.items():
        torch.manual_seed(seed)  # other weights each: only the loaded state may make them agree
        wm, actor, _, _ = build_agent(cfg, env.observation_space, actions_dim, is_continuous, dev)
        wm.load_state_dict(wm_sd)
        actor.load_state_dict(actor_sd)
        players[name] = (wm, actor, *make_player(wm, actor, cfg, actions_dim, is_continuous, 1))
    obs, _ = env.reset(seed=int(cfg.seed))
    gens = {name: torch.Generator(device=dev).manual_seed(7) for name in players}
    states = {name: p[2]() for name, p in players.items()}
    cnn, mlp = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    actions = []
    for _ in range(steps):
        host = prepare_obs(obs, cnn, mlp, 1)
        got = {}
        for name, (_, _, _, step) in players.items():
            got[name], _, states[name] = step(host, states[name], generator=gens[name])
        if not torch.equal(got["checkpoint"], got["registry"]) or not all(
                torch.equal(a, b) for a, b in zip(states["checkpoint"], states["registry"])):
            raise AssertionError(f"the registered actor acts {got['registry'].tolist()}, the checkpoint's "
                                 f"{got['checkpoint'].tolist()}")
        actions.append(got["checkpoint"].reshape(-1).tolist())
        act = got["checkpoint"].cpu().numpy()
        shaped = isinstance(env.action_space, (spaces.Box, spaces.MultiDiscrete))
        obs, _, term, trunc, _ = env.step(act.reshape(env.action_space.shape) if shaped else act.reshape(()).item())
        if term or trunc:
            obs, _ = env.reset()
    env.close()
    return actions


def diag_inputs(torch, ln_gru):
    """``--diag``: the legs phase 5 leaves for phase diag (the run leg's
    checkpoints, fleet_dv3 and fleet_dv3_chaos), as phase 5 runs them."""
    parsed, counts, _, _ = drive(torch, ln_gru, "run", run_common([f"algo.total_steps={TOTAL}", "run_name=run"]))
    if min(counts.values()) < 1:
        raise AssertionError(f"the run leg launched {counts}")
    dv3, legs = fleet_dv3_args()
    for name in ("fleet_dv3", "fleet_dv3_chaos"):
        drive(torch, ln_gru, "run", dv3 + ["algo.fleet.workers=2", *legs[name], f"run_name={name}"])


def phase_diag(torch, ln_gru):
    """Phase diag, after phase 5 (whose legs' run dirs it reads): the diag
    leg through ``cli.run`` with ``/metrics`` and ``/live`` scraped mid-run,
    then ``prof``, ``doctor``, ``trace`` and ``top`` through the CLI on the
    legs' run dirs, and ``registration`` of the run leg's last checkpoint."""
    port = free_port()
    args = run_common([f"algo.total_steps={DIAG_TOTAL}", "run_name=diag",
                       f"metric.telemetry.trace_every={DIAG_TRACE_AT}",
                       f"metric.telemetry.trace_window={DIAG_TRACE_WINDOW}",
                       f"metric.telemetry.prometheus_port={port}", "model_manager.disabled=False",
                       # overlap records every half second: the scrape sees them mid-run
                       "algo.overlap.stats_every_s=0.5"])
    report = {"args": args}
    shutil.rmtree(os.path.join(HERE, "models_registry"), ignore_errors=True)
    prefix = "dreamer_v3_discrete_dummy_"
    with LiveScraper(port) as scraper, live_plane_timer() as spent:
        parsed, counts, seconds, _ = drive(torch, ln_gru, "run", args)
    if scraper.metrics is None:
        raise AssertionError(f"no mid-run scrape of :{port} showed {LiveScraper.FAMILIES} and a /live window "
                             f"({scraper.scrapes} scrapes, last error {scraper.error})")
    if min(counts.values()) < 1:
        raise AssertionError(f"the diag leg launched {counts}")
    end_of_run = registry_versions(prefix)
    if sorted(end_of_run) != sorted(["world_model", "actor", "critic", "target_critic", "moments"]):
        raise AssertionError(f"the diag leg registered {end_of_run} at its end")
    report.update(leg_seconds=seconds, live_plane=live_plane_cost(spent, seconds), launches=counts,
                  metrics=scraper.metrics, live=scraper.live,
                  scrapes=scraper.scrapes, end_of_run_registered=end_of_run)

    # prof over the leg's own capture: the five kernels on the card under a train scope
    prof = diag_cli("prof", [f"run_dir={parsed['log_dir']}", "json=true", "top_k=100000"])
    caps = prof["captures"]
    windows = [w for c in caps for w in c["windows"]]
    if not caps or not any(w["platform"] == "gpu" and w["device_lanes"] >= 1 for w in windows):
        raise AssertionError(f"prof found captures {[c['capture_dir'] for c in caps]}, windows {windows}")
    found = {}
    for c in caps:
        for row in c["ops"]:
            name = ln_gru.kernel_of(row["op"])
            if name is not None:
                agg = found.setdefault(name, {"count": 0, "ms": 0.0, "scopes": set()})
                agg["count"] += row["count"]
                agg["ms"] += row["total_us"] / 1e3
                agg["scopes"].add(row["scope"])
    want = {k.__name__ for k in ln_gru.KERNELS}
    if set(found) != want or any(f["count"] < 1 or not f["scopes"] <= set(TRAIN_SCOPES) for f in found.values()):
        raise AssertionError(f"prof's LN-GRU rows {found}: want {sorted(want)} launched under {TRAIN_SCOPES}")
    top = caps[0]["ops"][:5]
    report["prof"] = {"captures": len(caps), "device_idle_frac": [c["device_idle_frac"] for c in caps],
                      "windows": windows, "ln_gru": {k: {**v, "scopes": sorted(v["scopes"])} for k, v in found.items()},
                      "top_ops": [{k: r[k] for k in ("op", "count", "total_us", "frac", "scope")} for r in top],
                      "scopes": caps[0]["scopes"], "rooflines": len(prof["rooflines"])}
    print(f"[diag] prof: device idle fraction {report['prof']['device_idle_frac']}", file=sys.stderr, flush=True)

    # doctor on this run and on the chaos leg's; trace on fleet_dv3's; top offline
    mine = diag_cli("doctor", [f"run_dir={parsed['log_dir']}", "json=true"])
    critical = [f["code"] for f in mine["findings"] if f["severity"] == "critical"]
    chaos = diag_cli("doctor", [f"run_dir={run_dir('fleet_dv3_chaos')}", "json=true"])
    codes = [f["code"] for f in chaos["findings"]]
    if critical or "worker_flap" not in codes:
        raise AssertionError(f"doctor: the diag leg's critical findings {critical}; fleet_dv3_chaos's {codes}")
    report["doctor"] = {"diag_findings": [(f["code"], f["severity"]) for f in mine["findings"]],
                        "chaos_findings": [(f["code"], f["severity"]) for f in chaos["findings"]]}
    tr = diag_cli("trace", [f"run_dir={run_dir('fleet_dv3')}", "json=true"])
    roles = {k.split("/", 1)[0] for k in tr["stages"]}
    if not {"learner", "worker"} <= roles or not (tr["completeness"].get("round") or 0) > 0:
        raise AssertionError(f"trace on fleet_dv3: stages {sorted(tr['stages'])}, completeness {tr['completeness']}")
    report["trace"] = {"completeness": tr["completeness"], "stages": {k: {m: v[m] for m in ("count", "p50_ms",
                                                                                           "p95_ms") if m in v}
                                                                       for k, v in tr["stages"].items()}}
    live = diag_cli("top", [f"run_dir={parsed['log_dir']}", "once=true", "json=true"])
    if live.get("source") == "live" or not live.get("ingested"):
        raise AssertionError(f"top once=true after the run: source {live.get('source')}, "
                             f"{live.get('ingested')} events aggregated")
    report["top"] = {k: live.get(k) for k in ("source", "window_s", "events_in_window", "ingested", "sps")}

    # registration of the run leg's last checkpoint: one version per group
    ckpt = checkpoints(run_dir("run"))[-1]
    diag_cli("registration", [f"checkpoint_path={ckpt}"])
    after = registry_versions(prefix)
    added = {g: [v for v in after.get(g, []) if v not in end_of_run.get(g, [])] for g in after}
    if sorted(added) != sorted(["world_model", "actor", "critic", "target_critic", "moments"]) or any(
            len(v) != 1 for v in added.values()):
        raise AssertionError(f"registration of {ckpt} added versions {added}")
    report["registration"] = {"checkpoint": os.path.basename(ckpt), "added": added,
                              "actions_bitwise_equal": registered_actions(torch, ckpt, prefix)}
    shutil.rmtree(os.path.join(HERE, "models_registry"), ignore_errors=True)
    return report


@contextlib.contextmanager
def live_plane_timer():
    """The host time the live plane takes inside the facade's ``_emit``
    while the block runs: calls and seconds of ``LiveAggregator.ingest``
    (every run, rank 0) and ``Registry.observe_event`` (with a Prometheus
    port), each method wrapped by a perf_counter pair for the block."""
    import threading

    from sheeprl_tpu_torch.diag.aggregator import LiveAggregator
    from sheeprl_tpu_torch.diag.prometheus import Registry

    spent = {"ingest": [0, 0.0], "observe_event": [0, 0.0]}
    lock = threading.Lock()
    saved = []
    for cls, name in ((LiveAggregator, "ingest"), (Registry, "observe_event")):
        def timed(self, *a, _orig=getattr(cls, name), _cell=spent[name], **kw):
            t0 = time.perf_counter()
            try:
                return _orig(self, *a, **kw)
            finally:
                dt = time.perf_counter() - t0
                with lock:
                    _cell[0] += 1
                    _cell[1] += dt

        saved.append((cls, name, cls.__dict__[name]))
        setattr(cls, name, timed)
    try:
        yield spent
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)


def live_plane_cost(spent, seconds):
    return {name: {"calls": n, "host_s": t, "share_of_leg": t / seconds} for name, (n, t) in spent.items()}


# the telemetry A/B's arms: the stream on, off, on without its
# per-iteration trace ranges and span timers, and on without the live
# aggregator
# phase mesh: the DV3-S legs' length, and the decoupled legs' (PPO: one
# update of 4 envs x 128 steps; SAC: the off-policy legs' settings)
MESH_TOTAL, MESH_PPO_TOTAL, MESH_SAC_TOTAL, MESH_SAC_LEARNING_STARTS = 192, 512, 512, 100
# the DV3-S legs' steps/s are read from here on: the first log interval
# after learning_starts holds the pretraining burst and the group's first
# collective (NCCL's set-up), which the steady state does not pay
MESH_WARM = LEARNING_STARTS + 32
# the other algorithms under ddp: DV2's twins at the preset (one env: the
# first burst, the pretraining, at learning_starts), the P2E-DV3 finetuning
# at XL on the kernels, and each other entry point to its first checkpoint
# after learning_starts
MESH_DV2_TOTAL = DV2_LEARNING_STARTS + 8
MESH_ROOT = "chip_smoke_mesh"  # what phase mesh keeps of phase run past phase diag's clean-up


def state_diff(torch, a, b):
    """The largest |a - b| over two checkpoints' parameters, optimizer
    states and Moments, where the algorithm has them (0.0: bitwise equal),
    and the names that differ."""
    worst, names = 0.0, []

    def walk(x, y, name):
        nonlocal worst
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{name}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{name}[{i}]")
        elif isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                names.append(name)
                worst = max(worst, float((x.double() - y.double()).abs().max()))
        elif x != y:
            names.append(name)

    for key in ("wm", "actor", "critic", "target_critic", "opt_states", "moments"):
        if key in a or key in b:
            walk(a[key], b[key], key)
    return worst, names


@contextlib.contextmanager
def deterministic_kernels(torch):
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    implementations inside the block (warnings where an op has none), as
    they were after it: two runs of the same work can only be bitwise equal
    where every kernel is deterministic (cuDNN's default convolution
    gradients accumulate in no fixed order)."""
    prior = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prior[:2]
        torch.use_deterministic_algorithms(prior[2], warn_only=prior[3])


def mesh_keep():
    """Keep the decoupled P2E-DV3 exploration leg's config and last
    checkpoint (under MESH_ROOT, the layout the finetuning's surgery reads)
    for phase mesh's finetuning leg: the checkpoint hard-linked, not copied
    (gigabytes at XL)."""
    src = run_dir("p2e_dv3_exploration_decoupled")
    ckpt = checkpoints(src)[-1]
    d = os.path.join(HERE, "logs", "runs", MESH_ROOT, "p2e_dv3_exploration")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(os.path.join(d, "checkpoint"))
    shutil.copy(os.path.join(src, "config.yaml"), d)
    dst = os.path.join(d, "checkpoint", os.path.basename(ckpt))
    try:
        os.link(ckpt, dst)
    except OSError:
        shutil.copy(ckpt, dst)


def mesh_explored(torch, ln_gru, report):
    """The XL P2E-DV3 exploration checkpoint (decoupled, pallas_gru=True)
    phase mesh finetunes from: phase run's, kept by ``mesh_keep``, or, when
    phase mesh runs alone, a short exploration leg of its own."""
    kept = os.path.join(HERE, "logs", "runs", MESH_ROOT, "p2e_dv3_exploration", "checkpoint")
    if os.path.isdir(kept) and os.listdir(kept):
        return checkpoints(os.path.dirname(kept))[-1]
    parsed, counts, seconds, _ = drive(torch, ln_gru, "run", [
        "exp=p2e_dv3_exploration", "env=dummy", "algo.run_test=False", f"root_dir={RUN_ROOT}",
        f"algo.learning_starts={P2E_LEARNING_STARTS}", "buffer.size=1024", "metric.log_every=4",
        f"algo.total_steps={P2E_DEC_TOTAL}", "checkpoint.every=0", "algo.world_model.decoupled_rssm=True",
        "algo.world_model.pallas_gru=True", "run_name=mesh_p2e_dv3_exploration"])
    report["mesh_p2e_dv3_exploration"] = {"seconds": seconds, "launches": counts}
    return checkpoints(parsed["log_dir"])[-1]


def jax_ratio_ledger(cfg, total, env_steps):
    """The gradient steps and the Ratio state of the JAX package's
    off-policy loops at world size 1 from a fresh run: ``ratio(policy_step /
    world_size)`` once per vector-env step from ``learning_starts``."""
    from sheeprl_tpu_torch.utils.utils import Ratio

    ratio, grads = Ratio(float(cfg.algo.replay_ratio), pretrain_steps=int(cfg.algo.per_rank_pretrain_steps)), 0
    for step in range(env_steps, total + 1, env_steps):
        if step >= int(cfg.algo.learning_starts):
            grads += ratio(step / 1)
    return grads, ratio.state_dict()


def mesh_other_legs(torch, ln_gru, report):
    """The algorithms the mesh admitted last (``cli.check_configs``), each
    under ``fabric.strategy=ddp`` on a world-size-1 NCCL group:

    * ``mesh_dv2``: DreamerV2 at the preset, serial, with its twin
      ``mesh_dv2_auto`` under ``auto`` from the same seed on deterministic
      kernels: the same ledger and bitwise the same checkpoint state; one
      all-reduce per optimizer step (three a gradient step);
    * ``mesh_p2e_dv3_finetuning``: P2E-DV3's finetuning at XL from the
      decoupled exploration checkpoint (``mesh_explored``), inheriting
      ``decoupled_rssm=True pallas_gru=True``: every LN-GRU kernel launched
      at XL (the streamed instance) under the group, the all-reduces and
      Moments' all-gathers in its log records with their bytes, the ledger
      of the JAX package's formula, the switch to the task actor at
      ``learning_starts``;
    * ``mesh_<algo>`` for a2c, ppo_recurrent, droq, sac_ae, dreamer_v1 and
      P2E-DV2's and DV1's exploration, each to its first checkpoint after
      ``learning_starts``, with collectives in its log records.
    Returns the XL finetuning leg's launch counts."""
    from sheeprl_tpu_torch.config import compose

    base = ["env=dummy", "algo.run_test=False", f"root_dir={RUN_ROOT}", "fabric.devices=1"]

    def ddp_leg(name, args, learning_starts, strategy="ddp"):
        gc.collect()
        before = torch.cuda.memory_allocated()
        argv = args + [f"run_name={name}", f"fabric.strategy={strategy}"]
        parsed, counts, seconds, peak = drive(torch, ln_gru, "run", argv)
        start, logs = parsed["startup"], parsed["logs"]
        want = "nccl" if strategy == "ddp" else "none"
        if start.get("backend") != want or start.get("world_size") != 1:
            raise AssertionError(f"{name}: startup names backend {start.get('backend')} at world size "
                                 f"{start.get('world_size')}, not {want} at 1")
        coll = logs[-1].get("collectives") if logs else None
        if strategy == "ddp" and (not coll or coll["all_reduce"] < 1 or coll["all_reduce_bytes"] < 1):
            raise AssertionError(f"{name}: its log records carry no all-reduce: {coll}")
        ckpts = checkpoints(parsed["log_dir"])
        state = torch.load(ckpts[-1], map_location="cpu", weights_only=False)
        if state["policy_step"] < learning_starts:
            raise AssertionError(f"{name}: its last checkpoint is at policy step {state['policy_step']}, before "
                                 f"learning_starts {learning_starts}")
        report[name] = offpolicy_summary(parsed, seconds, peak, before, learning_starts)
        report[name].update(collectives=coll, checkpoint_step=state["policy_step"], launches=counts)
        return parsed, counts, state, compose("config", argv)

    # DreamerV2 and its twin, in turns
    dv2 = ["exp=dreamer_v2", *base, "env.id=discrete_dummy", "env.num_envs=1",
           f"algo.learning_starts={DV2_LEARNING_STARTS}", f"algo.total_steps={MESH_DV2_TOTAL}",
           "algo.per_rank_pretrain_steps=1", "algo.replay_ratio=0.5", f"buffer.size={DV2_BUFFER}",
           "checkpoint.every=0", "metric.log_every=4"]
    ends = {}
    for name, strategy in (("mesh_dv2_auto", "auto"), ("mesh_dv2", "ddp")):
        with deterministic_kernels(torch):
            _, _, ends[name], cfg = ddp_leg(name, dv2, DV2_LEARNING_STARTS, strategy)
    a, b = ends["mesh_dv2"], ends["mesh_dv2_auto"]
    la, lb = ({k: s[k] for k in ("policy_step", "grad_steps", "ratio")} for s in (a, b))
    worst, names = state_diff(torch, a, b)
    if la != lb or names:
        raise AssertionError(f"mesh_dv2 and mesh_dv2_auto differ: ledgers {la} / {lb}, state {names[:8]} "
                             f"(max |diff| {worst})")
    grads, ratio = jax_ratio_ledger(cfg, MESH_DV2_TOTAL, 1)
    coll = report["mesh_dv2"]["collectives"]
    if la["grad_steps"] != grads or la["ratio"]["_prev"] != ratio["_prev"] or coll["all_reduce"] != 3 * grads:
        raise AssertionError(f"mesh_dv2: ledger {la}, the JAX package's formula gives {grads} gradient steps; "
                             f"collectives {coll}")
    report["mesh_dv2"]["twin"] = {"ledger": la, "bitwise_equal": True}

    # P2E-DV3's finetuning at XL on the kernels
    explored = mesh_explored(torch, ln_gru, report)
    ft = ["exp=p2e_dv3_finetuning", *base, f"checkpoint.exploration_ckpt_path={explored}",
          f"algo.learning_starts={P2E_LEARNING_STARTS}", f"algo.total_steps={P2E_FT_TOTAL}", "buffer.size=1024",
          "metric.log_every=4", "checkpoint.every=0"]
    parsed, counts, state, cfg = ddp_leg("mesh_p2e_dv3_finetuning", ft, P2E_LEARNING_STARTS)
    if min(counts.values()) < 1:
        raise AssertionError(f"mesh_p2e_dv3_finetuning launched {counts}: every LN-GRU kernel at XL expected")
    grads, ratio = jax_ratio_ledger(cfg, P2E_FT_TOTAL, int(cfg.env.num_envs))
    coll = report["mesh_p2e_dv3_finetuning"]["collectives"]
    got = {"policy_step": state["policy_step"], "grad_steps": state["grad_steps"], "ratio": state["ratio"]["_prev"]}
    if got != {"policy_step": P2E_FT_TOTAL, "grad_steps": grads, "ratio": ratio["_prev"]} \
            or coll["all_reduce"] != 3 * grads or coll["all_gather"] != grads:
        raise AssertionError(f"mesh_p2e_dv3_finetuning: ledger {got}, the JAX package's formula gives {grads} "
                             f"gradient steps; collectives {coll} (three all-reduces and one all-gather a step)")
    if parsed["acting"] != [("exploration", 0), ("task", P2E_LEARNING_STARTS)]:
        raise AssertionError(f"mesh_p2e_dv3_finetuning's player: {parsed['acting']}")
    report["mesh_p2e_dv3_finetuning"].update(
        ledger=got, acting=parsed["acting"], shape={"F": 1024, "H": 4096, "instance": ln_gru.launch_layout(4096)[0]},
        collectives_per_grad_step={k: coll[k] / grads for k in ("all_reduce", "all_reduce_bytes", "all_gather",
                                                                   "all_gather_bytes")})

    # the other entry points, each to its first checkpoint after learning_starts
    off = [*base, "env.id=continuous_dummy", "env.num_envs=4"]
    legs = {
        "mesh_a2c": (["exp=a2c", *base, "algo.total_steps=200", "checkpoint.every=0", "metric.log_every=100"], 0),
        "mesh_ppo_recurrent": (["exp=ppo_recurrent", *base, "env.num_envs=2", "algo.total_steps=1024",
                                "checkpoint.every=0"], 0),
        "mesh_droq": (["exp=droq", *off, "algo.learning_starts=100", "algo.total_steps=104", "buffer.size=256",
                       "checkpoint.every=0", "metric.log_every=4"], 100),
        "mesh_sac_ae": (["exp=sac_ae", *off, f"algo.learning_starts={AE_LEARNING_STARTS}",
                         f"algo.total_steps={AE_LEARNING_STARTS + 8}", f"buffer.size={AE_BUFFER}",
                         "checkpoint.every=0", "metric.log_every=4"], AE_LEARNING_STARTS),
        "mesh_dreamer_v1": (["exp=dreamer_v1", *base, "env.id=continuous_dummy",
                             f"algo.learning_starts={DV1_LEARNING_STARTS}", f"algo.total_steps={DV1_LEARNING_STARTS + 8}",
                             f"buffer.size={DV1_BUFFER}", "algo.replay_ratio=0.5", "algo.per_rank_pretrain_steps=1",
                             "checkpoint.every=0", "metric.log_every=4"], DV1_LEARNING_STARTS),
    }
    for v, (env_id, ls, _, _) in P2E_DREAMER.items():
        legs[f"mesh_p2e_{v}_exploration"] = ([f"exp=p2e_{v}_exploration", *base, f"env.id={env_id}",
                                              f"algo.learning_starts={ls}", f"algo.total_steps={ls + 8}",
                                              "algo.replay_ratio=0.5", "algo.per_rank_pretrain_steps=1",
                                              "buffer.size=512", "checkpoint.every=0", "metric.log_every=4"], ls)
    for name, (args, learning_starts) in legs.items():
        _, counts, state, _ = ddp_leg(name, args, learning_starts)
        if any(counts.values()):
            raise AssertionError(f"the {name} leg launched LN-GRU kernels: {counts}")
        grads = state.get("grad_steps", state.get("update"))
        if not grads:
            raise AssertionError(f"{name}: no gradient step by policy step {state['policy_step']}")
    return report["mesh_p2e_dv3_finetuning"]["launches"]


def phase_mesh(torch, ln_gru):
    """The data-parallel mesh on the card (``parallel/mesh.py``), world size 1
    (the card's machine shows one GPU):

    * ``mesh_dv3``: the DV3-S run leg's arguments, serial, with
      ``fabric.strategy=ddp``: a world-size-1 NCCL group, one flattened
      all-reduce per optimizer step (three a gradient step, counted with
      their bytes in the log records), Moments' all-gather, the five LN-GRU
      kernels launched; its twin ``mesh_dv3_auto`` under
      ``fabric.strategy=auto`` (no group) from the same seed ends with the
      same ledger and bitwise the same parameters, optimizer states and
      Moments (the legs on deterministic kernels: ``deterministic_kernels``);
      the legs run in turns (auto, ddp, ddp, auto: ``mesh_dv3_2`` and
      ``mesh_dv3_auto_2`` are the repeats, all four bitwise equal), with
      each one's policy steps/s from ``MESH_WARM`` on (past the first
      interval after ``learning_starts``);
    * ``mesh_dv3_sharded`` (``mesh_sharded_leg``): ``mesh_dv3``'s leg through
      the sharded mesh's path at ``(1,1,1)`` with ZeRO-1, bitwise
      ``mesh_dv3``;
    * ``mesh_ppo_decoupled``, ``mesh_sac_decoupled``: the decoupled pair at
      ``fabric.devices=1 algo.player.device=host`` (and ``fabric.strategy=ddp``):
      the trainer is rank 0 on the card under NCCL, the player thread acts
      on the host; the ledger of
      the JAX package's formula, a checkpoint, and ``eval`` of it through
      ``serve/evaluate.py``; policy steps/s;
    * the other algorithms under ``ddp`` (``mesh_other_legs``): DreamerV2's
      bitwise twins, P2E-DV3's finetuning at XL on the LN-GRU kernels, and
      each other newly admitted entry point.
    Returns the report; its ``launches`` are mesh_dv3's (S) and
    ``launches_xl`` the XL finetuning leg's."""
    from sheeprl_tpu_torch.utils.utils import Ratio

    report = {}
    common = run_common(["algo.overlap.enabled=False", f"algo.total_steps={MESH_TOTAL}"])
    ends = {}
    # in turns (auto, ddp, ddp, auto): the first leg pays the phase's one-time
    # costs, so each strategy's steps/s is read from one early and one late leg
    for name, strategy in (("mesh_dv3_auto", "auto"), ("mesh_dv3", "ddp"), ("mesh_dv3_2", "ddp"),
                           ("mesh_dv3_auto_2", "auto")):
        with deterministic_kernels(torch):
            parsed, counts, seconds, peak = drive(torch, ln_gru, "run", common + [
                f"run_name={name}", f"fabric.strategy={strategy}", "fabric.devices=1"])
        report[name] = leg_summary(parsed, counts, seconds, peak, LEARNING_STARTS, window_from=MESH_WARM)
        start, last = parsed["startup"], parsed["logs"][-1]
        want_backend = "nccl" if strategy == "ddp" else "none"
        if start.get("backend") != want_backend or start.get("world_size") != 1:
            raise AssertionError(f"{name}: startup names backend {start.get('backend')} at world size "
                                 f"{start.get('world_size')}, not {want_backend} at 1")
        coll = last.get("collectives")
        if strategy == "ddp":
            grads = int(last["grad_steps"])
            if not coll or coll["all_reduce"] != 3 * grads or coll["all_gather"] != grads:
                raise AssertionError(f"{name}: {grads} gradient steps but collectives {coll}: one all-reduce per "
                                     "optimizer step and one Moments all-gather per step expected")
            report[name]["collectives"] = coll
            report[name]["collectives_per_grad_step"] = {
                k: coll[k] / grads for k in ("all_reduce", "all_reduce_bytes", "all_gather", "all_gather_bytes")}
        elif coll:
            raise AssertionError(f"{name}: collectives ran without a group: {coll}")
        ends[name] = torch.load(checkpoints(parsed["log_dir"])[-1], map_location="cpu", weights_only=False)
    a = ends["mesh_dv3"]
    la = {k: a[k] for k in ("policy_step", "ratio", "last_checkpoint")} | {"grad_steps": a["opt_states"]["step"]}
    for other in ("mesh_dv3_auto", "mesh_dv3_2", "mesh_dv3_auto_2"):
        b = ends[other]
        lb = {k: b[k] for k in ("policy_step", "ratio", "last_checkpoint")} | {"grad_steps": b["opt_states"]["step"]}
        worst, names = state_diff(torch, a, b)
        if la != lb or names:
            raise AssertionError(f"mesh_dv3 and {other} differ: ledgers {la} / {lb}, state {names[:8]} "
                                 f"(max |diff| {worst})")
    report["mesh_dv3"]["twin"] = {"ledger": la, "bitwise_equal": True}
    report["mesh_dv3"]["sps_in_turns"] = {n: report[n]["policy_steps_per_s_after_learning_starts"]
                                          for n in ("mesh_dv3_auto", "mesh_dv3", "mesh_dv3_2", "mesh_dv3_auto_2")}
    report["mesh_dv3_sharded"] = mesh_sharded_leg(torch, ln_gru, common, a, la,
                                                  report["mesh_dv3"]["peak_device_memory"])

    # the decoupled pair: trainer rank 0 on the card (NCCL), player on the host
    decoupled = ["fabric.devices=1", "fabric.strategy=ddp", "algo.player.device=host", "env=dummy",
                 "algo.run_test=False", f"root_dir={RUN_ROOT}", "env.num_envs=4"]
    legs = {
        "mesh_ppo_decoupled": ["exp=ppo_decoupled", *decoupled, f"algo.total_steps={MESH_PPO_TOTAL}",
                               "checkpoint.every=512", "metric.log_every=512"],
        "mesh_sac_decoupled": ["exp=sac_decoupled", *decoupled, "env.id=continuous_dummy",
                               f"algo.total_steps={MESH_SAC_TOTAL}", f"algo.learning_starts={MESH_SAC_LEARNING_STARTS}",
                               f"buffer.size={SAC_BUFFER}", "checkpoint.every=256", "metric.log_every=128"],
    }
    for name, args in legs.items():
        gc.collect()
        before = torch.cuda.memory_allocated()
        parsed, counts, seconds, peak = drive(torch, ln_gru, "run", args + [f"run_name={name}"])
        if any(counts.values()):
            raise AssertionError(f"the {name} leg launched LN-GRU kernels: {counts}")
        if parsed["startup"].get("backend") != "nccl" or not parsed["startup"]["device_kind"].startswith("NVIDIA"):
            raise AssertionError(f"{name}: the trainer's startup record {parsed['startup']}")
        mirror = parsed["mirror"][-1] if parsed["mirror"] else {}
        if mirror.get("device") != "cpu":
            raise AssertionError(f"{name}: the player acted on {mirror.get('device')}, not the host")
        ckpts = checkpoints(parsed["log_dir"])
        s = torch.load(ckpts[-1], map_location="cpu", weights_only=False)
        if name == "mesh_ppo_decoupled":
            report[name] = onpolicy_summary(parsed, seconds, peak)
            per_update = (4 * 128 // 64) * 10  # 8 minibatches of 64, 10 epochs
            want = {"policy_step": MESH_PPO_TOTAL, "update": MESH_PPO_TOTAL // (4 * 128),
                    "adam_steps": per_update * (MESH_PPO_TOTAL // (4 * 128))}
            got = {"policy_step": s["policy_step"], "update": s["update"],
                   "adam_steps": int(s["opt_state"]["state"][0]["step"])}
        else:
            report[name] = offpolicy_summary(parsed, seconds, peak, before, MESH_SAC_LEARNING_STARTS)
            ratio, grads = Ratio(1.0), 0
            for step in range(4, MESH_SAC_TOTAL + 1, 4):  # the JAX loop's ratio(policy_step / world_size)
                if step >= MESH_SAC_LEARNING_STARTS:
                    grads += ratio(step / 1)
            want = {"policy_step": MESH_SAC_TOTAL, "grad_steps": grads, "opt_step": grads}
            got = {"policy_step": s["policy_step"], "grad_steps": s["grad_steps"], "opt_step": s["opt_states"]["step"]}
        if got != want:
            raise AssertionError(f"{name}: ledger {got}, the JAX package's formula gives {want}")
        report[name]["ledger"] = got
        report[name]["player"] = mirror
        ev, _, ev_s, _ = drive(torch, ln_gru, "eval", [f"checkpoint_path={ckpts[-1]}"])
        if ev["reward"] is None or not (ev["route"] or "").startswith(f"{name[5:]} through serve/evaluate.py"):
            raise AssertionError(f"{name}: eval printed reward {ev['reward']} by route {ev['route']}")
        report[name]["eval"] = {"seconds": ev_s, "reward": ev["reward"], "route": ev["route"]}
    report["launches_xl"] = mesh_other_legs(torch, ln_gru, report)
    shutil.rmtree(os.path.join(HERE, "logs", "runs", MESH_ROOT), ignore_errors=True)
    report["launches"] = report["mesh_dv3"]["launches"]
    return report


def mesh_sharded_leg(torch, ln_gru, common, twin, twin_ledger, twin_peak):
    """``mesh_dv3_sharded``: mesh_dv3's leg through the sharded mesh's path
    (``fabric.mesh.dp=1 fsdp=1 tp=1`` stated, ``fabric.shard_optimizer_state=True``:
    ``maybe_shard_params``/``maybe_shard_opt_state`` on a world-size-1 NCCL
    group's ``DeviceMesh``), on deterministic kernels. The degeneracy
    contract of ``parallel/sharding.py``: every parameter and optimizer-state
    leaf is replicated, each by the engine's own reason (the ``params``
    report is the JAX package's ``shard_params`` one), ``bytes_per_chip ==
    total_bytes`` in both summaries, no parameter is laid out, and the run
    ends bitwise where ``mesh_dv3`` ends (``twin``, its checkpoint;
    ``twin_ledger``, its ledger); ``doctor`` on the run finds no
    ``replicated_giant``. The leg's peak device memory is printed beside
    ``mesh_dv3``'s (``twin_peak``): at world size 1 nothing is sharded, so
    the two should be equal. Returns the leg's report (its ``launches``: the
    five LN-GRU kernels, at S)."""
    with deterministic_kernels(torch):
        parsed, counts, seconds, peak = drive(torch, ln_gru, "run", common + [
            "run_name=mesh_dv3_sharded", "fabric.strategy=ddp", "fabric.devices=1", "fabric.mesh.dp=1",
            "fabric.mesh.fsdp=1", "fabric.mesh.tp=1", "fabric.shard_optimizer_state=True"])
    out = leg_summary(parsed, counts, seconds, peak, LEARNING_STARTS, window_from=MESH_WARM)
    s = torch.load(checkpoints(parsed["log_dir"])[-1], map_location="cpu", weights_only=False)
    ledger_s = {k: s[k] for k in ("policy_step", "ratio", "last_checkpoint")} | {"grad_steps": s["opt_states"]["step"]}
    worst, names = state_diff(torch, twin, s)
    if ledger_s != twin_ledger or names:
        raise AssertionError(f"mesh_dv3_sharded and mesh_dv3 differ: ledgers {ledger_s} / {twin_ledger}, state "
                             f"{names[:8]} (max |diff| {worst})")
    with open(os.path.join(parsed["log_dir"], "telemetry.jsonl")) as f:
        stream = [json.loads(line) for line in f if line.strip()]
    events = [r for r in stream if r.get("event") == "sharding"]
    n_params = sum(len(s[k]) for k in ("wm", "actor", "critic", "target_critic"))
    n_trained = sum(len(s["opt_states"][k]["state"]) for k in ("wm", "actor", "critic"))
    leaves = {g: [r for r in events if r["action"] == "leaf" and r["group"] == g] for g in ("params", "opt_state")}
    summaries = {r["group"]: r for r in events if r["action"] == "summary"}
    want = {"params": n_params, "opt_state": 1 + 3 + 2 * n_trained}  # the EMA step, three counts, mu and nu
    got = {g: len(v) for g, v in leaves.items()}
    sharded = [r["path"] for v in leaves.values() for r in v
               if r["spec"] != "replicated" or r["reason"].startswith("kept whole")]
    if got != want or sharded or set(summaries) != {"params", "opt_state"} or any(
            r["bytes_per_chip"] != r["total_bytes"] or (r["dp"], r["fsdp"], r["tp"]) != (1, 1, 1)
            for r in summaries.values()):
        raise AssertionError(f"mesh_dv3_sharded's sharding events: leaves {got} (want {want}), sharded {sharded[:4]}, "
                             f"summaries {summaries}")
    doctor = diag_cli("doctor", [f"run_dir={parsed['log_dir']}", "json=true"])
    codes = [f["code"] for f in doctor["findings"]]
    if "replicated_giant" in codes:
        raise AssertionError(f"doctor on mesh_dv3_sharded: {codes}")
    out["peak_device_memory_beside_mesh_dv3"] = {"mesh_dv3_sharded": peak, "mesh_dv3": twin_peak,
                                                 "equal": peak == twin_peak}
    print(f"[mesh] peak device memory: mesh_dv3_sharded {peak}, mesh_dv3 {twin_peak} bytes", file=sys.stderr,
          flush=True)
    out.update({"twin": {"of": "mesh_dv3", "bitwise_equal": True}, "sharding_leaves": got,
                "sharding_summaries": {g: {k: r[k] for k in ("leaves", "total_bytes", "bytes_per_chip")}
                                       for g, r in summaries.items()},
                "doctor_findings": codes})
    return out


TELEMETRY_ARMS = {
    "on": [],
    "off": ["metric.telemetry.enabled=False"],
    "no_ranges": ["metric.telemetry.step_annotation=False", "metric.disable_timer=True"],
    "no_live": ["diag.live.enabled=False"],
}


def telemetry_ab(torch, ln_gru):
    """What the telemetry costs a user's run: the run and serial legs of
    phase 5 in each arm of TELEMETRY_ARMS, twice in the order on, off,
    no_ranges, no_live, no_live, no_ranges, off, on, after one uncounted
    warm-up leg (the
    process's first leg pays for cuDNN's and the allocator's first calls);
    each leg's seconds on the host clock for the same policy steps (a leg
    with the stream off leaves no stream to read; its loop takes the same
    steps, its ledger is checked against the other arms'), and in each leg
    the host time of the live plane itself (``live_plane_timer``)."""
    from sheeprl_tpu_torch import cli

    out = {leg: {arm: [] for arm in TELEMETRY_ARMS} for leg in ("run", "serial")}
    live = {leg: {arm: [] for arm in TELEMETRY_ARMS} for leg in ("run", "serial")}
    ledgers = {}
    warmup = None
    for arm in ("warmup",) + ("on", "off", "no_ranges", "no_live", "no_live", "no_ranges", "off", "on") * 2:
        for leg, extra in (("run", []), ("serial", ["algo.overlap.enabled=False"])):
            if arm == "warmup" and leg == "serial":
                continue
            args = run_common([f"algo.total_steps={TOTAL}", f"run_name=ab_{leg}_{arm}",
                               *TELEMETRY_ARMS.get(arm, TELEMETRY_ARMS["off"]), *extra])
            tee = _Tee()
            torch.cuda.synchronize()
            ln_gru.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee), live_plane_timer() as spent:
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
            live[leg][arm].append(live_plane_cost(spent, seconds))
            if (spent["ingest"][0] > 0) != (arm in ("on", "no_ranges")):
                raise AssertionError(f"the {leg} leg ({arm}): {spent['ingest'][0]} events into the live aggregator")
    for leg, seen in ledgers.items():
        if len(seen) != 1:
            raise AssertionError(f"the {leg} legs' ledgers differ between the arms: {seen}")
    shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
    return {"policy_steps": TOTAL, "learning_starts": LEARNING_STARTS, "warmup_s": warmup, "seconds": out,
            "median_s": {leg: {arm: statistics.median(s) for arm, s in v.items()} for leg, v in out.items()},
            "live_plane": live}


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
       python3 chip_smoke.py --preset               phase 5's preset legs alone (dv3_ms_pacman, dv3_XL_crafter)
       python3 chip_smoke.py --dreamer              phase 5's DreamerV1/V2 legs and steps alone
       python3 chip_smoke.py --p2e                  phase 5's Plan2Explore legs and step alone
       python3 chip_smoke.py --fleet                phase 5's actor-fleet legs alone, with the serial twins
       python3 chip_smoke.py --serve                phase 5's serving legs, evals and Anakin leg alone, with the
                                                    training legs whose checkpoints they serve
       python3 chip_smoke.py --diag                 phase diag alone, after the legs it reads (the run leg,
                                                    fleet_dv3 and fleet_dv3_chaos)
       python3 chip_smoke.py --mesh                 phase mesh alone: mesh_dv3 on a world-size-1 NCCL group with
                                                    its auto twin, and the decoupled pair on one card
       python3 chip_smoke.py --gateway              phase gateway alone, after the sac and DreamerV3-S run legs
                                                    whose checkpoints it serves
       python3 chip_smoke.py --recurrences [M L XL] the recurrent kernels alone at those shapes
       python3 chip_smoke.py --telemetry-ab         the run and serial legs with the stream on, off, on
                                                    without its per-iteration ranges and timers, and on
                                                    without the live aggregator"""


def main(argv=None) -> int:
    t_script = time.perf_counter()
    argv = sys.argv[1:] if argv is None else list(argv)
    mode = argv[0] if argv else None
    if mode not in (None, "--recurrences", "--telemetry-ab", "--preset", "--dreamer", "--p2e", "--fleet", "--serve",
                    "--diag", "--mesh", "--gateway") or (
            mode == "--recurrences" and not set(argv[1:]) <= set(SHAPES)):
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
    if mode == "--preset":
        try:
            os.chdir(HERE)
            t0 = time.perf_counter()
            legs = {"dv3_ms_pacman": preset_leg(torch, ln_gru), "dv3_XL_crafter": crafter_leg(torch, ln_gru)}
            shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
            emit("preset", ok=True, nvidia_smi=smi, seconds=time.perf_counter() - t0, **legs)
        except Exception as err:  # noqa: BLE001
            return fail("preset", err)
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
    if mode == "--fleet":
        try:
            os.chdir(HERE)
            t0 = time.perf_counter()
            twins = fleet_twins(torch, ln_gru)
            legs = fleet_legs(torch, ln_gru, twins)
            shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
            emit("fleet", ok=True, nvidia_smi=smi, seconds=time.perf_counter() - t0, twins=twins, legs=legs)
        except Exception as err:  # noqa: BLE001
            return fail("fleet", err)
        return 0
    if mode == "--serve":
        try:
            os.chdir(HERE)
            t0 = time.perf_counter()
            legs = serve_alone(torch, ln_gru)
            shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
            emit("serve", ok=True, nvidia_smi=smi, seconds=time.perf_counter() - t0, legs=legs)
        except Exception as err:  # noqa: BLE001
            return fail("serve", err)
        return 0
    if mode == "--diag":
        try:
            os.chdir(HERE)
            t0 = time.perf_counter()
            diag_inputs(torch, ln_gru)
            inputs_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            diag = phase_diag(torch, ln_gru)
            shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
            emit("diag", ok=True, nvidia_smi=smi, seconds=time.perf_counter() - t0, inputs_seconds=inputs_s, **diag)
        except Exception as err:  # noqa: BLE001
            return fail("diag", err)
        return 0
    if mode == "--mesh":
        try:
            os.chdir(HERE)
            t0 = time.perf_counter()
            mesh = phase_mesh(torch, ln_gru)
            shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
            emit("mesh", ok=True, nvidia_smi=smi, seconds=time.perf_counter() - t0, **mesh)
        except Exception as err:  # noqa: BLE001
            return fail("mesh", err)
        return 0
    if mode == "--gateway":
        try:
            os.chdir(HERE)
            t0 = time.perf_counter()
            legs = gateway_alone(torch, ln_gru)
            emit("gateway", ok=True, nvidia_smi=smi, seconds=time.perf_counter() - t0, legs=legs)
        except Exception as err:  # noqa: BLE001
            return fail("gateway", err)
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
        gateway_keep()  # the checkpoints phase gateway serves, kept past phase diag's clean-up
        mesh_keep()  # the P2E-DV3 exploration checkpoint phase mesh finetunes from
        emit("run", ok=True, nvidia_smi=smi, seconds=time.perf_counter() - t0, launches=counts,
             last_launch_blocks=blocks, legs=legs)
    except Exception as err:  # noqa: BLE001
        return fail("run", err)

    try:
        t0 = time.perf_counter()
        diag = phase_diag(torch, ln_gru)
        shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
        counts["S"]["diag"] = diag["launches"]  # a path of its own: zeroed before the leg, read after
        emit("diag", ok=True, nvidia_smi=smi, seconds=time.perf_counter() - t0, **diag)
    except Exception as err:  # noqa: BLE001
        return fail("diag", err)

    try:
        t0 = time.perf_counter()
        mesh = phase_mesh(torch, ln_gru)
        shutil.rmtree(os.path.join(HERE, "logs", "runs", RUN_ROOT), ignore_errors=True)
        counts["S"]["mesh_dv3"] = mesh["launches"]  # a path of its own: zeroed before the leg, read after
        counts["S"]["mesh_dv3_sharded"] = mesh["mesh_dv3_sharded"]["launches"]
        counts["XL"]["mesh_p2e_dv3_finetuning"] = mesh["launches_xl"]
        emit("mesh", ok=True, nvidia_smi=smi, seconds=time.perf_counter() - t0, **mesh)
    except Exception as err:  # noqa: BLE001
        return fail("mesh", err)

    try:
        t0 = time.perf_counter()
        legs = phase_gateway(torch, ln_gru)
        emit("gateway", ok=True, nvidia_smi=smi, seconds=time.perf_counter() - t0, legs=legs)
    except Exception as err:  # noqa: BLE001
        return fail("gateway", err)

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
                # the first path's count (the width's main leg), then every
                # path that runs the kernel at this width with its own count
                "launches": next(iter(counts[label].values()))[name],
                "launches_by_path": {path: c[name] for path, c in counts[label].items()},
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
