#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Drives the paths of the port (``mri_raytracer_tpu_torch``) on a 256^3
four-modality synthetic volume (seed 0) with the GT-seg overlay at 1024^2:
the interactive BraTS frame of ``bench.py``, rendered by
``BratsRenderer(backend="auto")``, which must resolve to ``sweep_cuda``
(stage 1 in PyTorch, then the CUDA kernels K1 and K2); the live-INR
neural march (mode 2), rendered by ``NeuralBratsRenderer(backend="auto")``
with the default INR (``ModelConfig()``, weights from a seed), which must
resolve to ``fused`` (the INR's strided prediction field, stage 1, K1 with
the field overlay K1b, K2); the frame's FLOP/MFU accounting of
``bench.py``, whose exact stage-2 count comes from K1 with its
executed-plane counter (K1c); and the two BraTS front ends, the viewer CLI
and the HTTP frame server, on a 256^3 NIfTI case written to disk; and
INR training (``train_inr``) at the default configuration, whose trained
field the neural frame then renders; the optimizer zoo's optax.contrib
optimizers through the same trainer; the U-Net baseline (``train_unet``
with its native-loaded cases, distillation into an implicit MLP and the
nnU-Net dataset conversion), which runs no kernel of the port (the JAX
package's convolutions are XLA's, the port's cuDNN's); the parallel
modules over a one-rank NCCL process group (the data-parallel train step,
and the stripe- and slab-sharded renderers, whose warp is K2); and
differentiable rendering with the two fits of an INR from rendered views
(``train/fit_views.py``); and
the ROI policy renderer with its evaluation protocol and training at
1920 x 1080 (``ops/roi_policy.py``, ``eval/roi_protocol.py``), which runs
no kernel of the port (the JAX package computes it in XLA too); and the
secondary renderers through their five apps (the u8 grid volume, the SDF
sphere tracer, the simplex-noise demo, the brute-force and BVH triangle
tracers, the hybrid volume + mesh-shadow renderer), which run no kernel
either; and the front ends: the notebook viewers and the eleven script
CLIs. Phases:

  1. env      torch / CUDA / card / nvcc report
  2. build    nvcc of every kernel in csrc/ (in parallel), with what
              -Xptxas -v says about registers, shared memory and spills
              (a spill in any kernel fails the run); K1's tile, window,
              shared memory and blocks per SM of each variant; K2's tile,
              blocks per SM and registers
  3. kernels  K1 and K2 at the main path's shapes, each held against its
              plain PyTorch version on the same inputs (tolerance TOL); K2
              also at the other five poses of bench.py, each frame equal to
              the background wherever the plain version's pixel is off
              the intermediate
  4. main     a warm-up, then BATCHES x ITERS orbit frames; both launch
              counters must equal the number of frames; fps on the host
              clock around torch.cuda.synchronize()
  5. quality  PSNR against the port's oracle at the six poses of bench.py,
              each >= 40 dB
  6. timing   device times (torch.profiler, from a cold L2) and
              back-to-back CUDA-event times of K1 (at the start pose and,
              held against its plain version, at the heaviest accounting
              pose), K2, stage 1, the plain versions and the library
              yardstick, beside each kernel's bound (K2's counts the part
              of the intermediate that valid pixels touch)
  7. profile  torch.profiler over PROFILE_FRAMES orbit frames: device
              kernels per frame, device busy time per frame by kernel,
              and the device's idle share of the unprofiled frame time
  8. neural   mode 2: K1b held against its plain version at the start
              pose; a warm-up, then BATCHES x ITERS orbit frames whose K1,
              K1b and K2 launch counts must equal the number of frames;
              the fused frame against the plain scan on the same geometry
              and field at the six poses, each >= 40 dB; device and
              CUDA-event times of predict_field, stage 1, K1b, K2 and
              bake_labels, K1b's bound; K3 (the INR's MLP) held against
              its plain version on the start pose's first block of planes
              (B = 16, Op = O / 4), its device time beside its bound and the
              plain version's, and over the orbit its launches and
              field.kernel_points = field.points; a profile of the neural
              frame; and a few 'rebake' frames (K1 with baked-pred rows)
  9. account  K1c held against its plain version at the start pose, C and
              T bit-equal with the counter on and off, K1's device time
              with and without it; then bench.py's accounting: ACCT_POSES
              poses along the timed orbit, frame_stats + executed_planes
              -> frame_flops, and mfu at phase 4's fps against the peak of
              the card's name (K1c launches must equal ACCT_POSES)
 10. front    a 256^3 synthetic NIfTI case and a ModelConfig() checkpoint
              written to disk; the viewer CLI on the case at 1024^2, plain
              and with the checkpoint baked in (VIEWER_FRAMES PNGs each;
              K1 and K2 launches = frames + warm-up), then with
              --neural-march at a small size; the HTTP server on the case
              at 1024^2: /info, / and SERVER_FRAMES /frame requests, each
              200 with a 1024^2 PNG, timed as render + PNG encode
 11. train    INR training through ``train_inr`` at the full default
              ``TrainConfig()`` on TRAIN_CASES synthetic cases of BraTS
              2023's 240 x 240 x 155 (4 train, 1 validation), written
              under build/ and removed after: wall time by part, ms per
              step over steps 101-2000 (CUDA events at the log steps),
              voxels/s, peak memory; the loss must halve and stay finite,
              the validation Dice beat the initial weights', the final
              checkpoint reload with bit-equal logits (and in the flat
              format), and RESUME_STEPS straight equal half, a resume from
              the train state and half again (<= RESUME_TOL); the trained
              field rendered by NeuralBratsRenderer('auto' -> 'fused',
              fused vs scan >= 40 dB, K1b launches = TRAIN_FRAMES); and a
              profile of PROFILE_STEPS steady steps (device operations,
              busy time and idle share per step)
 11a. optim   on the same cases, each optax.contrib optimizer of the zoo
              (muon, prodigy, dadapt_adamw, schedule_free_adamw,
              momo_adam) through train_inr at the default TrainConfig()
              with only the optimizer changed, OPTIM_STEPS steps: ms a
              step (CUDA events), the loss at the first and last log
              (finite; whether it fell is reported); each one's first
              OPTIM_UPDATES updates on the card against the CPU's
              (<= OPTIM_TOL); sophia raises optax's ValueError
 11b. unet    the native loader (runtime/mri_io.cpp built by g++ into
              build/native/): its build, RAMCache(use_native=True) on the
              cases, one case against the Python loader (seg bit-equal,
              the z-score bit-equal to the library's arithmetic in NumPy);
              train_unet(base 32, batch 8, 3 epochs, lr 1e-3) on the 4
              train cases with the validation case: slices, steps, ms a
              step (CUDA events, median after UNET_SKIP), images/s, GFLOP
              a step from the shapes, TFLOP/s, peak memory; the loss
              finite and falling, the best val Dice above the initial
              weights', unet_best.npz reloading with bit-equal logits,
              the trained logits on the card against the CPU
              (<= UNET_CPU_TOL); distill_to_implicit at its defaults on
              the U-Net's label volume of the validation case (loss
              falls, accuracy > DISTILL_ACC); a profile of
              UNET_PROFILE_STEPS steps; prepare_brats_dataset on the five
              cases (20 image links, labels in {0..3}); K1 and K2 launch
              no time in 11a-11b
 11c. parallel  the parallel modules on a world-size-1 NCCL process group
              (file rendezvous; the mesh's groups NCCL): the DP step
              (``build_dp_train_step(data_parallel=1)``) at TrainConfig()
              on [train]'s loaded train cases against the plain step from
              the same key, PAR_STEPS steps in turns, metrics and params
              <= PAR_TOL, ms a step of each (median after PAR_SKIP), the
              all-reduce's NCCL record in a profile of 3 DP steps; the
              stripe renderer on the bench frame at the six poses against
              the unsharded scan frame, in turns (<= PAR_TOL; K2 launches
              one a frame), ms a frame of each, a profile of one stripe
              frame; the slab renderer at the start pose against the
              one-rank term_gate=False composite (<= PAR_TOL, one K2
              launch)
 11d. cli     the front ends on [train]'s cases, loaded cache and trained
              INR: OrbitViewer.frame on the bench renderer (equal to
              render_numpy clipped; K1a and K2 once each), SliceViewer's
              multiview of the bench volume, HoldoutViewer's prediction
              (wall, the cache hit), slice report and image; then the
              eleven script CLIs through their main(argv) at the JAX
              scripts' defaults but for the CLI_* cuts: read_npz on the
              checkpoint, roi_report, neural_psnr_cert --train-steps 600
              (each pose's dB beside JAX's record; rc 0 exactly when its
              pass_40db holds), bench_neural_march (plain, baked, neural
              fps, MLP overhead, re-bake ms), full_geometry_smoke on the
              cases (no new write), demo_end_to_end (PSNR against the
              oracle, the scan's fps), orbit_video (BraTS, then ROI),
              roi_occupancy_bound, roi_showcase_figures,
              bench_roi_overhead at 1920 x 1080 and roi_retime, each
              exiting as it should with its files written; K1a / K1b / K2
              launches counted from 0 around each call and held to its
              frames (none on the ROI paths)
 12. fit      differentiable rendering and fit-from-views: each
              autograd.Function (trilinear_sample, composite_fronttoback,
              isosurface_intersect) against autograd through its plain
              forward on the card in float64; at the scene of
              tests/test_diff_shearwarp.py, the 'scan_remat' volume
              gradient against the unchecked sweep + gather warp and a
              directional finite difference, and K1 / K2 refusing inputs
              that require grad; then the two fits of
              docs/FIT_FROM_VIEWS*.md at their documented configurations
              (shear-warp: 64^3, 16 + 4 views at 256^2, out_res 128, 200
              steps of 2 views, cut from 400; marcher: 2,500 steps of
              4,096 rays, 48 -> 96 samples): wall by part, ms per step
              (CUDA events, median over steps 51 on), device operations,
              busy time and idle share per step over profiled steps, peak
              memory; the loss must halve and stay finite and train and
              held-out PSNR reach FIT_PSNR_MIN; K2 launches on the
              shear-warp fit's own path = its 'scan' renders of targets
              and recovered views, none on the marcher's; the recovered
              volume's held-out views through 'fused' (K1a + K2, one
              launch each a view) >= 40 dB against
              'scan', and K1a and K2 against their plain versions at the
              fit's shapes on those views (<= TOL)
 13. roi      the ROI policy renderer (ops/roi_policy, eval/roi_protocol)
              at the protocol of docs/ROI_RESULTS.md: the five showcase
              scenes at 96 x 96 x 80, 1920 x 1080, the committed
              docs/roi_policy.npz, pareto_sweep(foveated=True) over the
              30-pose orbit at budgets ROI_BUDGETS (ROI_TIMING_FRAMES timed
              frames); images finite, each voting scene's foveated policy
              at its operating budget within 0.5 dB of the port's own
              B1 at 64, each policy median within ROI_JAX_DB of JAX's; the
              foveated ROI pixels against the full-resolution render at
              one pose; the LOD series (docs/roi_policy_lod.npz) on tumor-a
              at 64 within ROI_JAX_DB of JAX's; K1 and K2
              launch no time on this path; a profile of a foveated policy
              frame, a full policy frame and a B1 frame at 64; then
              train_policy as the CLI calls it (800 steps at 96^2, four
              scenes, validation on tumor-a's held-out views): ms per step
              from CUDA events, peak memory, the loss finite and its last
              lap within ROI_LOSS_BAND of its first, best validation
              wPSNR >= ROI_VAL_MIN_DB
 14-18.      the secondary renderers, each app through its main(argv) at
              its defaults and at a BraTS-shaped size (one 240 x 240 x 155
              NIfTI case from seed 0, written under build/ and removed
              after); for each configuration fps (SEC_FRAMES synced frames
              on the host clock), device operations, busy time and idle
              share a frame (torch.profiler), peak memory, and for the BVH
              its traversal steps and host syncs a frame; each renderer's
              card frame against its CPU frame at CPU_RES^2 (bars SEC_TOL,
              SEC_AGREE); K1 and K2 launch no time in these phases:
     volume   volume_app in composite, mip and iso at its defaults
              (synthetic 96^3 u8, 512^2, 64 steps, 12 frames); a modality
              through --nii at 64 and 512 steps, and through --format bc4
              --dims after encode_bc4
     sdf      sdf_app at its defaults (512^2, 96 steps, 12 frames)
     noise    noise_app at its defaults (512^2, 12 frames), with and
              without --mouse
     mesh     mesh_app on its built-in mesh; ASCII PLY files of the
              occluder meshes of the 96 x 96 x 80 case (15,312 triangles,
              'auto' -> brute) and the 240 x 240 x 155 case (83,176,
              'auto' -> bvh) at 512^2; brute against BVH on the card
     hybrid   hybrid_app at its defaults (synthetic 96 x 96 x 80, 384^2,
              192 steps, shadows and skip on, 12 frames); the case through
              --case with shadows and skip both on and both off, and its
              frames with each on and off; the one-time mesh extraction
              and BVH build
 19. report   the kernels JSON line, the card's name and power limit, the
              script's wall time, and the final ok line

Needs one CUDA card: exits non-zero, printing no result, without one or
without the port package. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import pathlib
import re
import shutil
import struct
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
import warnings

import numpy as np

WIDTH = HEIGHT = 1024
VOL = (256, 256, 256)
WARMUP, ITERS, BATCHES = 15, 15, 3
PROFILE_FRAMES = 5
NEURAL_WARMUP = 5
ACCT_POSES = 5
# The accounting pose (frames into the timed orbit) with the most executed
# (pixel, plane) pairs in PR 3: K1 is timed there beside the start pose.
HEAVY_K = 23
VIEWER_FRAMES = 5
SERVER_FRAMES = 4
# Warm-up frames of BratsRenderer.warmup: one per sweep axis.
APP_WARMUP = 3
# Front-end scratch (cases, checkpoint, PNGs), under the checkout's
# gitignored build/ and removed at the end.
BUILD = pathlib.Path(__file__).resolve().parent / "build"
DOCS = BUILD.parent / "docs"
# Added to the random INR's last bias so that several classes appear
# (tests/test_neural_march.py:176).
BIAS_NUDGE = (0.0, 0.4, 0.5, 0.45)
# The [train] phase: BraTS 2023 GLI's case shape, the one cut (5 of its
# 625 cases: 4 train, 1 validation), the exact-resume check's run length and
# its bound, the trained field's orbit frames, the profiled steady steps.
TRAIN_SHAPE = (240, 240, 155)
TRAIN_CASES = 5
RESUME_STEPS = 40
RESUME_TOL = 1e-5
TRAIN_FRAMES = 5
PROFILE_STEPS = 20
# The [optim] phase: the optax.contrib optimizers of the zoo through
# train_inr at the default TrainConfig() with only the optimizer changed,
# OPTIM_STEPS steps each (of its 2,000), timed after OPTIM_SKIP; the card's
# first OPTIM_UPDATES updates against the CPU's on a seeded gradient
# sequence, max |difference| over max |value| per parameter <= OPTIM_TOL.
OPTIMS = ("muon", "prodigy", "dadapt_adamw", "schedule_free_adamw",
          "momo_adam")
OPTIM_STEPS = 200
OPTIM_SKIP = 10
OPTIM_UPDATES = 5
OPTIM_TOL = 1e-4
# The [unet] phase: the reference's U-Net baseline (base 32, batch 8, 3
# epochs, lr 1e-3) on [train]'s cases; per-step times after UNET_SKIP;
# UNET_PROFILE_STEPS profiled steps; the trained weights' logits on one
# batch, card against CPU: max |difference| <= UNET_CPU_TOL x max |logit|
# (float32 convolutions on both); distillation at its defaults, accuracy
# above DISTILL_ACC (tests/test_unet_nnunet.py's bar).
UNET_BASE = 32
UNET_BATCH = 8
UNET_EPOCHS = 3
UNET_LR = 1e-3
UNET_SKIP = 10
UNET_PROFILE_STEPS = 5
UNET_CPU_TOL = 1e-4
DISTILL_ACC = 0.5
# [parallel]: the DP step's steps, the steps its median skips, and the bound
# on its difference from the plain step and on the sharded frames'
# difference from the unsharded ones (one rank computes the same).
PAR_STEPS = 50
PAR_SKIP = 10
PAR_TOL = 1e-6
# The [fit] phase: docs/FIT_FROM_VIEWS_shearwarp.md's and
# docs/FIT_FROM_VIEWS.md's configurations (scripts/fit_from_views.py), the
# PSNR gate of both (train and held-out means), the steps left out of the
# per-step median (compilation, allocator warm-up), the profiled steps, and
# the scene of tests/test_diff_shearwarp.py with its bounds.
FIT_SHAPE = (64, 64, 64)
FIT_RES = 256
FIT_VIEWS, FIT_HELD = 16, 4
# Cut from the documented 400 steps to 200, so that the script with the
# secondary renderers' phases stays well inside its time limit.
FIT_SW_STEPS = 200
FIT_SW_OUT_RES = 128
FIT_STEPS = 2500
FIT_PSNR_MIN = 30.0
FIT_SKIP = 50
FIT_PROFILE_STEPS = 3
GRAD_SHAPE = (24, 24, 20)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
FD_TOL = 0.02
# The [roi] phase: the protocol of docs/ROI_RESULTS.md
# (scripts/roi_policy_eval.py) at its scene size, resolution, coarse probes,
# block and reference steps, over its 30-pose orbit; the budgets cut to the
# operating points and the tuned baseline, the timing frames from 30 to 10.
# Gates: evaluate_success's 0.5 dB bar at each voting scene's operating
# budget; each policy median at most ROI_JAX_DB under JAX's
# (docs/roi_results.json); the LOD series' median at most ROI_JAX_DB under
# JAX's (its loss against the plain policy is printed: the blend's own
# error, the mip's prefilter, weighs more in dB under the float32 port's
# plain policy, 6 dB above JAX's TPU run on tumor-a; at 480 x 270 on the
# CPU the blend costs JAX 0.62 dB and the port 0.55,
# tools/roi_gate_evidence.py lod); the foveated ROI pixels against the
# full-resolution render at the bar of tests/test_roi_policy.py (rtol
# 1e-4, atol 2e-4); the training's best validation wPSNR at least JAX's
# 54.94 dB (docs/roi_policy_meta.json) less 1.5 dB, and its loss finite
# and not diverging: the mean over its last lap of (scene, view) pairs at
# most ROI_LOSS_BAND times the first lap's. From the occupancy-informed
# start the loss moves a few percent either way with the init's draw (800
# steps on the CPU, tools/roi_gate_evidence.py train: torch seed 0 +0.02%,
# seed 1 -2.91%, JAX's PRNGKey(0) init -3.63% in the port and -3.85% in
# JAX), so a fall is printed, not required.
ROI_SHAPE = (96, 96, 80)
ROI_WIDTH, ROI_HEIGHT = 1920, 1080
ROI_BUDGETS = (28, 32, 64)
ROI_TUNED = 64
ROI_QUALITY_FRAMES = 30
ROI_TIMING_FRAMES = 10
ROI_N_COARSE, ROI_BLOCK, ROI_REF_STEPS = 48, 32, 512
ROI_LOSS_DB = 0.5
ROI_JAX_DB = 1.0
ROI_FOV_RTOL, ROI_FOV_ATOL = 1e-4, 2e-4
ROI_TRAIN_STEPS, ROI_TRAIN_RES = 800, 96
ROI_VAL_MIN_DB = 54.94 - 1.5
ROI_LOSS_BAND = 1.05
ROI_PROFILE_FRAMES = 2

# The [cli] phase: the script CLIs of apps/ and the notebook viewers, at
# the JAX scripts' defaults but for these cuts (the phase aims at <= 150 s
# and the script at a margin over the spread of its wall between hosts):
# orbit_video --which roi at 12 of its 72 frames, roi_retime on one scene at
# 3 of its 20 rounds, bench_roi_overhead at 3 of its 12 frames,
# demo_end_to_end at 100 of its 400 training steps. The two trainings of
# the phase (full_geometry_smoke's and the demo's) skip the host Hausdorff
# of train_inr's final eval: [train] runs that eval in full, and no gate
# here reads it.
CLI_ROI_FRAMES = 12
CLI_VIDEO = (384, 72)  # orbit_video's default --res and --frames
CLI_RETIME_SCENE = "tumor-a"
CLI_RETIME_ROUNDS = 3
CLI_OVERHEAD_FRAMES = 3
CLI_CERT_STEPS = 600
CLI_FG_CASES = 3
CLI_FG_STEPS = 60
CLI_DEMO_STEPS = 100
# Written by the JAX script on its TPU (docs/neural_psnr_cert_trained.json):
# context for the port's certificate, not a gate (the inits differ).
JAX_CERT = DOCS / "neural_psnr_cert_trained.json"

# Phases 14-18: the secondary renderers and their apps (no kernel of the
# port's; PyTorch on the card, as the JAX package computes them in XLA).
# Timed frames a configuration (each synced): at most SEC_FRAMES, fewer
# where the warm-up frame says they would take over SEC_TIMED_S.
SEC_FRAMES = 3
SEC_TIMED_S = 1.5
SEC_PROFILE = 1  # profiled frames a configuration
SEC_SHAPE = (96, 96, 80)  # hybrid_app's default case; its occluder: 15,312
BRATS_SHAPE = (240, 240, 155)  # BraTS 2023 GLI's grid; occluder 83,176
VOL96 = (96, 96, 96)  # volume_app's synthetic default
CPU_RES = 128  # the card's frame against the CPU's at this size
# Card against CPU, max abs error: frames without a discrete decision;
# frames with one must agree on SEC_AGREE of their pixels' decisions and
# within SEC_TOL where they agree.
SEC_TOL = 1e-4
SEC_AGREE = 0.999
GRID_MODES = ("composite", "mip", "iso")
# Kernel vs plain version, max abs error on C, T and the frame: both sides
# read the same bf16 stage-1 rows and do the same fp32 operations in the
# same order; 1e-3 leaves room for the compiler's fused multiply-adds and
# for expf/powf/tanf differing in the last bits.
TOL = 1e-3
PSNR_MIN_DB = 40.0
# K3 against its plain version: a label may differ only where the plain
# top-two logit gap is within K3_GAP of the logits' largest magnitude (the
# two may round hidden states to neighbouring bf16 values, one step, 2^-8
# to 2^-7 of each, apart, which the weights downstream carry to the logits:
# labels off at gaps of up to 6.1e-3 of the scale on the card).
K3_GAP = 2.0 ** -5
# bench.py:108-110.
POSES = [("orbit", 0.6, 1.2), ("face-x", 0.0, np.pi / 2),
         ("face-y", np.pi / 2, np.pi / 2), ("top", 0.3, 0.12),
         ("diag-low", 0.85, 0.6), ("diagonal", 0.85, 0.85)]
# The card's published peaks (dense bf16 tensor cores, fp32 outside them,
# device memory bytes/s) come from utils/arith.py's table, by the card's
# name: the bounds below and the MFU use the same numbers.
# Overwritten before each timed call, so that no input is still in the
# card's 50 MB L2 from the call before; its kernel's name holds FLUSH_OP,
# which no timed function uses.
L2_FLUSH_BYTES = 256 << 20
FLUSH_OP = "bitwise_not"
# fp32 operations counted in csrc/composite.cu per (pixel, plane) pair that
# composites (gate, entry correction, 2-tap lerp, transfer, alpha with its
# expf, colour and T update); per such pair when an overlay is on, the
# nearest label row (clamp, round); per overlay tap whose label is in
# [1, 8) (alpha with its expf, three colour sums, T update; label 0 is
# transparent and needs none); and in csrc/warp.cu per screen pixel (ray,
# base-plane hit, maps, clamps, weights, 3 channels).
K1_OPS_PLANE = 40
K1_OPS_NEAREST = 3
K1_OPS_LABEL = 14
K2_OPS_PIXEL = 60


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(torch, fn, n: int, warm: int = 2) -> float:
    """Mean time of ``fn`` over ``n`` back-to-back calls, by CUDA events,
    after ``warm`` untimed calls. For a short kernel behind a Python
    wrapper this is the host's issue rate, not the device's time."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_activity(torch, fn, n: int, flush=None, warm: bool = True):
    """{name: (count, us)} of the device activities torch.profiler records
    over ``n`` calls of ``fn`` (after one untimed call unless ``warm`` is
    false), user annotations left out. ``flush``, when
    given, runs before each call; activities whose name holds
    ``FLUSH_OP`` are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        # A user annotation (an optimizer's step) spans kernels counted on
        # their own.
        if e.device_type == DeviceType.CUDA and not (
                flush is not None and FLUSH_OP in e.name) and not getattr(
                    e, "is_user_annotation", False):
            k, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (k + 1, us + e.time_range.elapsed_us())
    return by_name


def device_ms(torch, fn, n: int) -> float:
    """Mean device time of one ``fn`` call from a cold L2: a buffer larger
    than the L2 is overwritten before each call (its kernel is not
    counted), so inputs are read from device memory as the bound assumes.
    Per activity name, the mean duration times its count per call: every
    call issues the same activities, and the profiler may lose a record of
    a long run (a count one short of a multiple of ``n``); a loss is
    logged. The host's issue time between launches is not in it."""
    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    by_name = device_activity(torch, fn, n, flush=buf.bitwise_not_)
    if not by_name:
        raise RuntimeError("torch.profiler saw no device activity")
    ms, lost = 0.0, 0
    for k, us in by_name.values():
        per_call = max(1, round(k / n))
        lost += abs(per_call * n - k)
        ms += us / k * per_call / 1e3
    if lost:
        log("timing", f"torch.profiler's device records are {lost} off a "
            f"whole count per call over {n} calls; the mean of the others "
            "stands for them")
    return ms


def bound(peaks, nbytes: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = nbytes / peaks.bytes * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_info(torch, composite, kernels) -> None:
    """K1's tile, window, stages and shared memory, and for its four
    instantiations (counter off / on, gamma off / on) the blocks per SM the
    CUDA runtime grants, registers and local bytes (stack frame and spills;
    ``mrt_composite_info``). Fails if the Python mirror's constants differ
    from the kernel's."""
    info = kernels.function("composite", "mrt_composite_info",
                            [ctypes.c_int, ctypes.c_void_p])
    for K in (225, 257):
        out = torch.zeros(19, dtype=torch.int32)
        err = info(K, out.data_ptr())
        if err != 0:
            raise RuntimeError(f"mrt_composite_info: cudaError {err}")
        ti, tj, threads, win, stages, smem, smem_max, *var = out.tolist()
        log("build", f"K1 at K={K}: tile {ti}x{tj}, {threads} threads, "
            f"a-row window {win} rows, {stages} stages, {smem} bytes of "
            f"shared memory (at most {smem_max}); " + "; ".join(
                f"{name}: {var[3 * v]} blocks/SM, {var[3 * v + 1]} "
                f"registers, {var[3 * v + 2]} local bytes" for v, name in
                enumerate(("K1", "K1 gamma", "K1c", "K1c gamma"))))
        mirror = (composite.TILE_I, composite.TILE_J, composite.WIN_ROWS,
                  composite._SMEM_RING + K * composite._SMEM_PLANE,
                  composite._SMEM_MAX)
        if (ti, tj, win, smem, smem_max) != mirror:
            raise RuntimeError(f"ops/composite.py's K1 constants {mirror} "
                               "differ from the kernel's")


def k2_info(torch, kernels) -> None:
    """K2's tile, pixels a thread and threads, and for its wide and scalar
    instantiations the blocks per SM, registers and local bytes
    (``mrt_warp_info``)."""
    info = kernels.function("warp", "mrt_warp_info", [ctypes.c_void_p])
    out = torch.zeros(10, dtype=torch.int32)
    err = info(out.data_ptr())
    if err != 0:
        raise RuntimeError(f"mrt_warp_info: cudaError {err}")
    tw, th, pix, threads, *var = out.tolist()
    log("build", f"K2: tile {tw}x{th}, {pix} pixels a thread, {threads} "
        "threads; " + "; ".join(
            f"{name}: {var[3 * v]} blocks/SM, {var[3 * v + 1]} registers, "
            f"{var[3 * v + 2]} local bytes"
            for v, name in enumerate(("wide stores", "scalar stores"))))


def run(torch) -> int:
    import torch.nn.functional as F

    from mri_raytracer_tpu_torch import env
    from mri_raytracer_tpu_torch.data.brats import percentile_normalize
    from mri_raytracer_tpu_torch.data.synthetic import synthetic_case
    from mri_raytracer_tpu_torch.eval.metrics import psnr
    from mri_raytracer_tpu_torch.ops import (composite, kernels, raymarch,
                                             shearwarp, warp)
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.brats import BratsRenderer
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.utils import arith

    t_script = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = env.power_limit() or "nvidia-smi not available"
    card = f"{torch.cuda.get_device_name(0)} [{smi}]"
    # Every bound and the MFU divide by this card's peaks: the fallback
    # warning for a card the table does not name fails the run, rather than
    # report against another card's rates.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        peaks = arith.device_peaks(0)

    # ------------------------------------------------------------- 1. env
    log("env", json.dumps(env.report()))
    log("env", f"peaks for {torch.cuda.get_device_name(0)} (utils/arith.py): "
        f"bf16 {peaks.bf16 / 1e12:.1f} TFLOP/s, fp32 {peaks.fp32 / 1e12:.1f}"
        f" TFLOP/s, memory {peaks.bytes / 1e12:.2f} TB/s")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    built = kernels.build()
    log("build", f"nvcc built {sorted(built)} in "
        f"{time.perf_counter() - t0:.1f} s (all sources at once; "
        + ", ".join(f"{k} {v[0]:.1f} s" for k, v in built.items()) + ")")
    spilled = []
    for src in kernels.SOURCES:
        text = kernels.library_path(src).with_suffix(".log").read_text()
        for line in text.splitlines():
            if "ptxas info" in line or "spill" in line:
                log("build", f"{src}: {line.strip()}")
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                spilled.append(f"{src}.cu: {line.strip()}")
    if spilled:
        raise RuntimeError(f"ptxas spills: {spilled}")
    k1_info(torch, composite, kernels)
    k2_info(torch, kernels)

    # ----------------------------------------------------------- scene
    t0 = time.perf_counter()
    raw, seg = synthetic_case(VOL, seed=0)
    mods = np.stack([percentile_normalize(m) for m in raw])
    seg = seg.astype(np.int32)
    p = rp.default_render_params(VOL, show_seg=True, show_pred=False)
    renderer = BratsRenderer(mods, seg, None, width=WIDTH, height=HEIGHT)
    if renderer.backend != "sweep_cuda":
        raise RuntimeError(f"backend 'auto' resolved to {renderer.backend}")
    radius = rp.default_camera_radius(p, VOL)
    log("scene", f"synthetic {VOL} seed 0 + seg, {WIDTH}x{HEIGHT}, backend "
        f"{renderer.backend}, built in {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------------- 3. kernels
    basis = OrbitalCamera(radius=radius, theta=0.6, phi=1.2).basis()
    fr = renderer.sweep_frame(basis, p)
    geom = shearwarp.content_geometry(
        fr.basis, fr.p, tuple(fr.mixed_s.shape), fr.axis, fr.out_res, WIDTH,
        HEIGHT, fr.z_offset, fr.nk_global, fr.ab_offset, fr.inplane_global)
    k1 = composite.stage1(fr.mixed_s, fr.seg_s, fr.pred_s, geom, fr.p,
                          fr.axis, fr.out_res, fr.z_offset, fr.nk_global)
    flags = (fr.use_gamma, fr.use_clip)
    K, Na, O = k1.t1b.shape
    C_k, T_k = composite.composite_planes(*k1, *flags)
    torch.cuda.synchronize()
    plain = composite.composite_planes_plain(*k1, *flags)
    C_p, T_p = plain.C, plain.T
    err_k1 = max(float((C_k - C_p).abs().max()), float((T_k - T_p).abs().max()))
    s = shearwarp.warp_scalars(geom, fr.basis, fr.p.bg_color)
    img_k = warp.warp_screen(C_p, s, fr.axis, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    img_p = warp.warp_screen_plain(C_p, s, fr.axis, WIDTH, HEIGHT)
    err_k2 = float((img_k - img_p).abs().max())
    err_k2_poses = k2_poses(torch, renderer, p, radius, composite, shearwarp,
                            warp, OrbitalCamera)
    n_active, n_labeled = int(plain.n_active), int(plain.n_labeled.sum())
    log("kernels", f"pose orbit: axis {fr.axis}, K={K} planes, Na={Na}, "
        f"O={O}, crop k={fr.z_offset} ab={fr.ab_offset}, active "
        f"(pixel, plane) pairs {n_active}, of which overlay taps with a "
        f"label in [1, 8) {n_labeled}")
    log("kernels", f"K1 composite max|kernel - plain| over C, T = {err_k1:.3e}"
        f" (tolerance {TOL})")
    log("kernels", f"K2 warp max|kernel - plain| over the frame = {err_k2:.3e}"
        f" (tolerance {TOL})")
    for name, t in (("C", C_k), ("T", T_k), ("frame", img_k)):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"kernel output {name} is not finite")
    if not (err_k1 <= TOL and err_k2 <= TOL):
        raise RuntimeError("a kernel disagrees with its plain version")
    err_k2 = max(err_k2, err_k2_poses)

    # ------------------------------------------------------ 4. main path
    cam = OrbitalCamera(radius=radius, theta=0.6, phi=1.2)
    for _ in range(WARMUP):
        cam.orbit(0.03, 0.0)
        img = renderer.render(cam.basis(), p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite.composite_planes.launches = 0
    composite.composite_planes.count_launches = 0
    warp.warp_screen.launches = 0
    rates, frames = [], 0
    for _ in range(BATCHES):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            cam.orbit(0.03, 0.01)
            img = renderer.render(cam.basis(), p)
            frames += 1
        torch.cuda.synchronize()
        rates.append(ITERS / (time.perf_counter() - t0))
    launches = {"K1": composite.composite_planes.launches,
                "K1c": composite.composite_planes.count_launches,
                "K2": warp.warp_screen.launches}
    log("main", f"{frames} frames: launches {launches}")
    if launches != {"K1": frames, "K1c": 0, "K2": frames}:
        raise RuntimeError(f"launch counts {launches} != {frames} frames "
                           "(and no K1c)")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or \
            not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"bad frame: shape {tuple(img.shape)}")
    fps = float(np.median(rates))
    log("main", f"fps median {fps:.2f} over {BATCHES} batches of {ITERS} "
        f"(per batch {[round(r, 2) for r in rates]}), host clock around "
        f"torch.cuda.synchronize(), {WIDTH}^2/{VOL[0]}^3 + seg, on {card}")
    log("main", f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
        f" MiB (torch.cuda.max_memory_allocated over the orbit)")

    # -------------------------------------------------------- 5. quality
    dt_oracle = float(p.voxel_size.min())
    p_o = p._replace(step_size=torch.tensor(dt_oracle, dtype=torch.float32))
    worst = None
    for name, th, ph in POSES:
        b = OrbitalCamera(radius=radius, theta=th, phi=ph).basis()
        fast = renderer.render(b, p).clamp(0.0, 1.0)
        oracle = raymarch.render_brats(renderer.mods, renderer.seg, None, b,
                                       p_o, WIDTH, HEIGHT, max_steps=640,
                                       device=dev).clamp(0.0, 1.0)
        q = psnr(fast, oracle)
        log("quality", f"{name} (theta {th:.3f}, phi {ph:.3f}): {q:.2f} dB "
            f"vs oracle (step {dt_oracle:.5f}, 640 steps)")
        worst = q if worst is None else min(worst, q)
        if not q >= PSNR_MIN_DB:
            raise RuntimeError(f"PSNR {q:.2f} dB at {name} < {PSNR_MIN_DB}")
    log("quality", f"min {worst:.2f} dB over {len(POSES)} poses")

    # --------------------------------------------------------- 6. timing
    # Device time (torch.profiler) is what the kernels line reports; the
    # CUDA-event time over back-to-back calls is printed beside it and
    # includes the host's issue time between launches.
    k1_fn = lambda: composite.composite_planes(*k1, *flags)
    k1_plain_fn = lambda: composite.composite_planes_plain(*k1, *flags)
    k2_fn = lambda: warp.warp_screen(C_p, s, fr.axis, WIDTH, HEIGHT)
    k2_plain_fn = lambda: warp.warp_screen_plain(C_p, s, fr.axis, WIDTH,
                                                 HEIGHT)
    # Library yardstick for K2: grid_sample's bilinear on the same maps
    # (the map computation itself is not in it).
    i_map, j_map, _ = warp.screen_maps(s, fr.axis, O, WIDTH, HEIGHT)
    grid = torch.stack([j_map / (O - 1) * 2 - 1, i_map / (O - 1) * 2 - 1],
                       dim=-1)[None]
    c_nchw = C_p.permute(2, 0, 1)[None].contiguous()
    k2_lib_fn = lambda: F.grid_sample(c_nchw, grid, mode="bilinear",
                                      align_corners=True)
    # Stage 1 as a whole, and its bf16 batched product alone.
    Nk, _, Nb = fr.mixed_s.shape
    z, _, _, _, _, off_b, sc_b = shearwarp.sweep_plane_affines(
        geom, fr.p, fr.axis, Nk + 1, fr.z_offset)
    bcl, bch, _, bml, bmh = shearwarp._geom_bounds(geom, 1, Nb)
    zi = torch.clamp(z, 0.0, Nk - 1).long()
    slices = fr.mixed_s.index_select(0, zi).to(torch.bfloat16)
    wb_t = shearwarp._batched_hat(off_b, sc_b, Nb, O, bcl, bch, bml, bmh,
                                  dtype=torch.bfloat16)[0].transpose(1, 2)
    bmm_fn = lambda: torch.bmm(slices, wb_t)
    stage1_fn = lambda: composite.stage1(
        fr.mixed_s, fr.seg_s, fr.pred_s, geom, fr.p, fr.axis, fr.out_res,
        fr.z_offset, fr.nk_global)
    t = {}  # name: (device ms, event ms)
    for name, fn, n in (("K1", k1_fn, 20), ("K1 plain", k1_plain_fn, 2),
                        ("K2", k2_fn, 100), ("K2 plain", k2_plain_fn, 20),
                        ("grid_sample", k2_lib_fn, 100), ("bmm", bmm_fn, 20),
                        ("stage 1", stage1_fn, 10)):
        t[name] = (device_ms(torch, fn, n),
                   cuda_ms(torch, fn, n, 1 if "plain" in name else 2))
        log("timing", f"{name}: device {t[name][0]:.4f} ms (cold L2), CUDA "
            f"events {t[name][1]:.4f} ms back to back (mean of {n} calls)")

    def k1_cost(k1, n_active, n_labeled):
        """K1a's bytes and fp32 operations on these inputs; n_active is the
        sum of the plain version's executed-plane map."""
        O = k1.t1b.shape[2]
        overlays = sum(r is not None for r in (k1.seg_rows, k1.pred_rows))
        nbytes = (k1.t1b.numel() * 2 + overlays * k1.t1b.numel()
                  + k1.pp.numel() * 4 + (16 + 32) * 4 + 3 * O * O * 4
                  + 4 * O * O * 4)
        ops = (n_active * (K1_OPS_PLANE + (K1_OPS_NEAREST if overlays else 0))
               + n_labeled * K1_OPS_LABEL)
        return nbytes, ops

    k1_bytes, k1_ops = k1_cost(k1, n_active, n_labeled)
    k1_bound, k1_by = bound(peaks, k1_bytes, k1_ops, peaks.fp32)
    # K1 at the heaviest pose of phase 9's accounting (HEAVY_K frames into
    # the timed orbit, axis 2 in PR 3), held against its plain version and
    # timed beside the start pose.
    bh = OrbitalCamera(radius=radius, theta=0.6 + 0.03 * (WARMUP + HEAVY_K),
                       phi=1.2 + 0.01 * HEAVY_K).basis()
    frh = renderer.sweep_frame(bh, p)
    geomh = shearwarp.content_geometry(
        frh.basis, frh.p, tuple(frh.mixed_s.shape), frh.axis, frh.out_res,
        WIDTH, HEIGHT, frh.z_offset, frh.nk_global, frh.ab_offset,
        frh.inplane_global)
    k1h = composite.stage1(frh.mixed_s, frh.seg_s, frh.pred_s, geomh, frh.p,
                           frh.axis, frh.out_res, frh.z_offset, frh.nk_global)
    flagsh = (frh.use_gamma, frh.use_clip)
    Ch, Th = composite.composite_planes(*k1h, *flagsh)
    torch.cuda.synchronize()
    plainh = composite.composite_planes_plain(*k1h, *flagsh)
    err_h = max(float((Ch - plainh.C).abs().max()),
                float((Th - plainh.T).abs().max()))
    if not err_h <= TOL:
        raise RuntimeError(f"K1 disagrees with its plain version at the "
                           f"heavy pose ({err_h:.3e})")
    k1h_fn = lambda: composite.composite_planes(*k1h, *flagsh)
    t["K1 heavy"] = (device_ms(torch, k1h_fn, 20), cuda_ms(torch, k1h_fn, 20))
    k1h_bytes, k1h_ops = k1_cost(k1h, int(plainh.n_active),
                                 int(plainh.n_labeled.sum()))
    k1h_bound, k1h_by = bound(peaks, k1h_bytes, k1h_ops, peaks.fp32)
    log("timing", f"K1 at the heavy pose k={HEAVY_K} (axis {frh.axis}, "
        f"K={k1h.t1b.shape[0]}, Na={k1h.t1b.shape[1]}, O={frh.out_res}, "
        f"{int(plainh.n_active)} active pairs): max|kernel - plain| "
        f"{err_h:.3e}; device {t['K1 heavy'][0]:.4f} ms (cold L2), CUDA "
        f"events {t['K1 heavy'][1]:.4f} ms, bound {k1h_bound:.4f} ms by "
        f"{k1h_by}, on {card}")
    # K2 reads only the corners of valid pixels: the bound counts the
    # intermediate's pixels that some valid pixel's 4 corners touch.
    i_map, j_map, valid = warp.screen_maps(s, fr.axis, O, WIDTH, HEIGHT)
    i0 = torch.clamp(torch.floor(i_map[valid]).long(), 0, O - 2)
    j0 = torch.clamp(torch.floor(j_map[valid]).long(), 0, O - 2)
    touched = torch.zeros((O + 1) * (O + 1), dtype=torch.bool, device=dev)
    for d in (0, 1, O + 1, O + 2):
        touched[i0 * (O + 1) + j0 + d] = True
    n_touched = int(touched.sum())
    k2_bytes = n_touched * 3 * 4 + 24 * 4 + HEIGHT * WIDTH * 3 * 4
    k2_bound, k2_by = bound(peaks, k2_bytes, HEIGHT * WIDTH * K2_OPS_PIXEL,
                            peaks.fp32)
    bmm_bound, bmm_by = bound(
        peaks, (slices.numel() + wb_t.numel() + K * Na * O) * 2,
        2.0 * K * Na * Nb * O, peaks.bf16)
    log("timing", f"K1 device {t['K1'][0]:.4f} ms, bound {k1_bound:.4f} ms "
        f"by {k1_by} ({k1_bytes / 1e6:.1f} MB, {k1_ops / 1e9:.3f} Gop fp32)")
    log("timing", f"K2 device {t['K2'][0]:.4f} ms (cold L2), CUDA events "
        f"{t['K2'][1]:.4f} ms back to back, bound {k2_bound:.4f} ms by "
        f"{k2_by} ({k2_bytes / 1e6:.2f} MB: {n_touched} of {O * O} "
        f"intermediate pixels touched, {int(valid.sum())} valid of "
        f"{HEIGHT * WIDTH} screen pixels), grid_sample "
        f"{t['grid_sample'][0]:.4f} ms, on {card}")
    log("timing", f"bf16 bmm device {t['bmm'][0]:.4f} ms, bound "
        f"{bmm_bound:.4f} ms by {bmm_by}")
    log("timing", f"frame at {fps:.2f} fps = {1e3 / fps:.3f} ms host; "
        f"stage 1 + K1 + K2 device "
        f"{t['stage 1'][0] + t['K1'][0] + t['K2'][0]:.3f} ms, on {card}")

    # -------------------------------------------------------- 7. profile
    def orbit_frame():
        cam.orbit(0.03, 0.01)
        renderer.render(cam.basis(), p)

    by_name = device_activity(torch, orbit_frame, PROFILE_FRAMES)
    if not by_name:
        log("profile", "device time not measured: the profiler saw no "
            "device activity")
    else:
        busy_ms = sum(us for _, us in by_name.values()) / 1e3 / PROFILE_FRAMES
        count = sum(n for n, _ in by_name.values()) / PROFILE_FRAMES
        log("profile", f"per frame over {PROFILE_FRAMES} frames: {count:.1f} "
            f"device activities, device busy {busy_ms:.3f} ms; device idle "
            f"share of the unprofiled {1e3 / fps:.3f} ms frame "
            f"{1.0 - busy_ms * fps / 1e3:.3f}, on {card}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        for name, (n, us) in top:
            log("profile", f"{us / 1e3 / PROFILE_FRAMES:8.4f} ms/frame "
                f"{n / PROFILE_FRAMES:5.1f}x  {name[:90]}")

    # --------------------------------------------------------- 8. neural
    k1b_entry, k3_entry = neural_phase(torch, raw, mods, seg, radius, card,
                                       peaks)

    # ------------------------------------------------------- 9. accounting
    k1c_entry = accounting_phase(torch, renderer, p, radius, k1, flags,
                                 plain, C_k, T_k, k1_bytes, k1_ops, fps,
                                 t["K1 plain"][0], card, peaks)

    # ------------------------------------------------------ 10. front ends
    front_end_phase(torch, card)

    # ----------------------------------- 11. training, optimizers, U-Net
    with training_cases(card) as cases:
        train_cache = train_phase(torch, card, cases)
        optim_phase(torch, card, cases)
        unet_phase(torch, card, cases)
        parallel_phase(torch, card, cases, train_cache, mods, seg)
        cli_phase(torch, card, cases, train_cache, renderer, p, radius,
                  mods, seg)

    # ------------------------------------------------------------ 12. fit
    fit_phase(torch, card)

    # ------------------------------------------------------------ 13. roi
    roi_phase(torch, card)

    # ---------------------------------------- 14-18. secondary renderers
    secondary_phases(torch, card)

    # -------------------------------------------------------- 19. report
    report = {"kernels": [
        {"name": "K1a composite", "route": "cuda",
         "source": "mri_raytracer_tpu_torch/csrc/composite.cu",
         "replaces": "mri_raytracer_tpu/ops/pallas_composite.py:575",
         "launches": launches["K1"], "max_abs_err": err_k1,
         "ms": t["K1"][0], "plain_ms": t["K1 plain"][0], "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "K2 warp", "route": "cuda",
         "source": "mri_raytracer_tpu_torch/csrc/warp.cu",
         "replaces": "mri_raytracer_tpu/ops/pallas_warp.py:222",
         "launches": launches["K2"], "max_abs_err": err_k2,
         "ms": t["K2"][0], "plain_ms": t["K2 plain"][0], "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": t["grid_sample"][0]},
        k1b_entry,
        k1c_entry,
        k3_entry,
    ]}
    log("report", f"chip_smoke.py wall {time.perf_counter() - t_script:.1f} "
        f"s, on {card}")
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def k2_poses(torch, renderer, p, radius: float, composite, shearwarp, warp,
             OrbitalCamera) -> float:
    """K2 against its plain version on K1's intermediate at every pose of
    POSES (phase 3): max abs error <= TOL, and the background exactly
    wherever the plain version's pixel is off the intermediate. Returns
    the largest error."""
    worst = 0.0
    for name, th, ph in POSES:
        fr = renderer.sweep_frame(
            OrbitalCamera(radius=radius, theta=th, phi=ph).basis(), p)
        geom = shearwarp.content_geometry(
            fr.basis, fr.p, tuple(fr.mixed_s.shape), fr.axis, fr.out_res,
            WIDTH, HEIGHT, fr.z_offset, fr.nk_global, fr.ab_offset,
            fr.inplane_global)
        k1 = composite.stage1(fr.mixed_s, fr.seg_s, fr.pred_s, geom, fr.p,
                              fr.axis, fr.out_res, fr.z_offset, fr.nk_global)
        C, _ = composite.composite_planes(*k1, fr.use_gamma, fr.use_clip)
        s = shearwarp.warp_scalars(geom, fr.basis, fr.p.bg_color)
        img = warp.warp_screen(C, s, fr.axis, WIDTH, HEIGHT)
        torch.cuda.synchronize()
        ref = warp.warp_screen_plain(C, s, fr.axis, WIDTH, HEIGHT)
        _, _, valid = warp.screen_maps(s, fr.axis, C.shape[0], WIDTH, HEIGHT)
        err = float((img - ref).abs().max())
        off_bg = bool((img[~valid] == s[21:24]).all())
        log("kernels", f"K2 at {name} (theta {th:.3f}, phi {ph:.3f}; axis "
            f"{fr.axis}, O={C.shape[0]}): max|kernel - plain| {err:.3e}, "
            f"valid {float(valid.float().mean()):.4f} of the screen, pixels "
            f"off the intermediate {'all' if off_bg else 'NOT all'} "
            "background")
        if not (err <= TOL and off_bg and bool(torch.isfinite(img).all())):
            raise RuntimeError(f"K2 disagrees with its plain version at {name}")
        worst = max(worst, err)
    return worst


def fused_vs_scan(renderer, basis, p):
    """(PSNR, frame, field): the fused mode-2 frame (K1b) against the plain
    scan over the same prepared frame, geometry and field."""
    from mri_raytracer_tpu_torch.eval.metrics import psnr
    from mri_raytracer_tpu_torch.ops import neural_march as nm, shearwarp

    model, params = renderer.model, renderer.params
    S, Kf = renderer.stride, renderer.kstride
    fr = renderer.sweep_frame(basis, p)
    field = nm.frame_field(model, params, fr, S, Kf)
    C = nm._render_neural_fused(fr, model, params, S, Kf, field=field)
    fused = shearwarp.warp_to_screen(C, fr.geom, fr.basis, fr.axis, WIDTH,
                                     HEIGHT, fr.p.bg_color)
    scan = nm._render_neural_axis(fr, model, params, WIDTH, HEIGHT, S, Kf,
                                  field=field)
    return psnr(fused.clamp(0.0, 1.0), scan.clamp(0.0, 1.0)), fr, field


def neural_phase(torch, raw, mods, seg, radius: float, card: str,
                 peaks) -> dict:
    """Phase 8, the live-INR neural march (mode 2) at WIDTH^2 / VOL with
    the repo's default INR. Returns the K1b entry of the kernels line."""
    from mri_raytracer_tpu_torch.config import ModelConfig
    from mri_raytracer_tpu_torch.data.brats import zscore_nonzero
    from mri_raytracer_tpu_torch.eval.metrics import psnr
    from mri_raytracer_tpu_torch.models.api import build_model
    from mri_raytracer_tpu_torch.models.mlp import count_params
    from mri_raytracer_tpu_torch.ops import composite, shearwarp, warp
    from mri_raytracer_tpu_torch.ops import neural_march as nm
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    zsc = np.stack([zscore_nonzero(m.copy()) for m in raw])
    cfg = ModelConfig()
    model = build_model(cfg, num_modalities=len(raw))
    params = model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        params[-1].b += torch.tensor(BIAS_NUDGE)
    p = rp.default_render_params(VOL, show_seg=True, show_pred=True)
    renderer = nm.NeuralBratsRenderer(mods, zsc, seg, model, params,
                                      width=WIDTH, height=HEIGHT)
    if renderer.backend != "fused":
        raise RuntimeError(f"backend 'auto' resolved to {renderer.backend}")
    params = renderer.params
    S, Kf = renderer.stride, renderer.kstride
    log("neural", f"ModelConfig(): kind {cfg.kind}, hidden {cfg.hidden_dims}"
        f", {cfg.fourier_freqs} harmonics, {cfg.num_classes} classes, "
        f"in_dim {model.input_dim}, {count_params(params)} parameters "
        f"(torch.Generator seed 0, last bias + {list(BIAS_NUDGE)}); "
        f"backend {renderer.backend}, pred_stride {S}, pred_kstride {Kf}; "
        f"set-up {time.perf_counter() - t0:.1f} s")

    # K1b against its plain version at the start pose.
    basis = OrbitalCamera(radius=radius, theta=0.6, phi=1.2).basis()
    fr = renderer.sweep_frame(basis, p)
    flags = (fr.use_gamma, fr.use_clip)
    field = nm.frame_field(model, params, fr, S, Kf)
    k1 = composite.stage1(fr.mixed_s, fr.seg_s, None, fr.geom, fr.p, fr.axis,
                          fr.out_res, fr.z_offset, fr.nk_global)
    fkw = dict(pred_field=composite.field_labels(field), field_stride=S,
               field_kstride=Kf)
    C_k, T_k = composite.composite_planes(*k1, *flags, **fkw)
    torch.cuda.synchronize()
    C_p, T_p, planes, n_labeled = composite.composite_planes_plain(
        *k1, *flags, **fkw)
    err = max(float((C_k - C_p).abs().max()), float((T_k - T_p).abs().max()))
    K, Na, O = k1.t1b.shape
    shares = torch.bincount(field.reshape(-1).long(),
                            minlength=cfg.num_classes).cpu().numpy()
    n_active, (n_seg, n_field) = int(planes.sum()), n_labeled.tolist()
    log("neural", f"pose orbit: axis {fr.axis}, K={K} planes, Na={Na}, "
        f"O={O}, field {tuple(field.shape)}, crop k={fr.z_offset} "
        f"ab={fr.ab_offset}; field label shares "
        f"{[round(float(x), 4) for x in shares / field.numel()]}")
    log("neural", f"active (pixel, plane) pairs {n_active}; overlay taps "
        f"with a label in [1, 8): seg {n_seg}, field {n_field}")
    log("neural", f"K1b composite max|kernel - plain| over C, T = {err:.3e} "
        f"(tolerance {TOL})")
    if not (bool(torch.isfinite(C_k).all()) and bool(torch.isfinite(T_k)
                                                     .all())):
        raise RuntimeError("K1b output is not finite")
    if not err <= TOL:
        raise RuntimeError("K1b disagrees with its plain version")
    if n_field <= 0:
        raise RuntimeError("the field put no label on the frame")

    k3_entry = k3_check(torch, model, params, fr, S, Kf, card, peaks)

    # The main neural path.
    cam = OrbitalCamera(radius=radius, theta=0.6, phi=1.2)
    for _ in range(NEURAL_WARMUP):
        cam.orbit(0.03, 0.0)
        img = renderer.render(cam.basis(), p)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite.composite_planes.launches = 0
    composite.composite_planes.field_launches = 0
    warp.warp_screen.launches = 0
    nm.separable_mlp.launches = 0
    points0 = profiling.counters()
    rates, frames = [], 0
    for _ in range(BATCHES):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            cam.orbit(0.03, 0.01)
            img = renderer.render(cam.basis(), p)
            frames += 1
        torch.cuda.synchronize()
        rates.append(ITERS / (time.perf_counter() - t0))
    launches = {"K1": composite.composite_planes.launches,
                "K1b": composite.composite_planes.field_launches,
                "K2": warp.warp_screen.launches}
    log("neural", f"{frames} frames: launches {launches}")
    if launches != {"K1": frames, "K1b": frames, "K2": frames}:
        raise RuntimeError(f"launch counts {launches} != {frames} frames")
    points = {k: v - points0.get(k, 0)
              for k, v in profiling.counters().items()
              if k in ("field.points", "field.kernel_points")}
    k3_entry["launches"] = nm.separable_mlp.launches
    log("neural", f"{frames} frames: K3 launches {nm.separable_mlp.launches} "
        f"({nm.separable_mlp.launches / frames:.1f} a frame), {points}")
    if not (nm.separable_mlp.launches >= frames and points.get(
            "field.points", 0) > 0 and points.get("field.kernel_points")
            == points["field.points"]):
        raise RuntimeError(f"K3 did not label every field point: {points}")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or \
            not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"bad neural frame: shape {tuple(img.shape)}")
    fps = float(np.median(rates))
    log("neural", f"fps median {fps:.2f} over {BATCHES} batches of {ITERS} "
        f"(per batch {[round(r, 2) for r in rates]}), host clock around "
        f"torch.cuda.synchronize(), {WIDTH}^2/{VOL[0]}^3 + seg + live INR, "
        f"on {card}")
    log("neural", f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
        f"(torch.cuda.max_memory_allocated over the orbit)")

    # Quality: the fused frame against the plain scan over the same
    # prepared frame, geometry and field.
    worst = None
    for name, th, ph in POSES:
        b = OrbitalCamera(radius=radius, theta=th, phi=ph).basis()
        q, frq, _ = fused_vs_scan(renderer, b, p)
        log("neural", f"quality {name} (theta {th:.3f}, phi {ph:.3f}): "
            f"fused vs scan {q:.2f} dB (O={frq.out_res}, same field)")
        worst = q if worst is None else min(worst, q)
        if not q >= PSNR_MIN_DB:
            raise RuntimeError(f"neural PSNR {q:.2f} dB at {name} < "
                               f"{PSNR_MIN_DB}")
    log("neural", f"quality min {worst:.2f} dB over {len(POSES)} poses")

    # Timing at the start pose.
    s = shearwarp.warp_scalars(fr.geom, fr.basis, fr.p.bg_color)
    fns = (
        ("predict_field", lambda: nm.frame_field(model, params, fr, S, Kf),
         5),
        ("stage 1", lambda: composite.stage1(
            fr.mixed_s, fr.seg_s, None, fr.geom, fr.p, fr.axis, fr.out_res,
            fr.z_offset, fr.nk_global), 10),
        ("K1b", lambda: composite.composite_planes(*k1, *flags, **fkw), 20),
        ("K1b plain", lambda: composite.composite_planes_plain(
            *k1, *flags, **fkw), 2),
        ("K2", lambda: warp.warp_screen(C_p, s, fr.axis, WIDTH, HEIGHT),
         100),
        ("bake_labels", lambda: nm.bake_labels(model, params,
                                               renderer.modsz), 3),
    )
    t = {}
    for name, fn, n in fns:
        t[name] = (device_ms(torch, fn, n),
                   cuda_ms(torch, fn, n, 1 if n < 5 else 2))
        log("neural", f"timing {name}: device {t[name][0]:.4f} ms (cold L2), "
            f"CUDA events {t[name][1]:.4f} ms back to back (mean of {n} "
            "calls)")
    k1b_bytes = (k1.t1b.numel() * 2 + k1.seg_rows.numel()
                 + fkw["pred_field"].numel() + k1.pp.numel() * 4
                 + (16 + 32) * 4 + 3 * O * O * 4 + 4 * O * O * 4)
    k1b_ops = (n_active * (K1_OPS_PLANE + K1_OPS_NEAREST)
               + (n_seg + n_field) * K1_OPS_LABEL)
    k1b_bound, k1b_by = bound(peaks, k1b_bytes, k1b_ops, peaks.fp32)
    log("neural", f"K1b device {t['K1b'][0]:.4f} ms, bound {k1b_bound:.4f} "
        f"ms by {k1b_by} ({k1b_bytes / 1e6:.1f} MB, {k1b_ops / 1e9:.3f} Gop "
        f"fp32)")
    dev_sum = sum(t[k][0] for k in ("predict_field", "stage 1", "K1b", "K2"))
    log("neural", f"frame at {fps:.2f} fps = {1e3 / fps:.3f} ms host; "
        f"predict_field + stage 1 + K1b + K2 device {dev_sum:.3f} ms "
        f"(predict_field {t['predict_field'][0]:.3f}), on {card}")

    def orbit_frame():
        cam.orbit(0.03, 0.01)
        renderer.render(cam.basis(), p)

    by_name = device_activity(torch, orbit_frame, PROFILE_FRAMES)
    if not by_name:
        log("neural", "profile: device time not measured: the profiler saw "
            "no device activity")
    else:
        busy_ms = sum(us for _, us in by_name.values()) / 1e3 / PROFILE_FRAMES
        count = sum(n for n, _ in by_name.values()) / PROFILE_FRAMES
        log("neural", f"profile per frame over {PROFILE_FRAMES} frames: "
            f"{count:.1f} device activities, device busy {busy_ms:.3f} ms; "
            f"device idle share of the unprofiled {1e3 / fps:.3f} ms frame "
            f"{1.0 - busy_ms * fps / 1e3:.3f}, on {card}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        for name, (n, us) in top:
            log("neural", f"profile {us / 1e3 / PROFILE_FRAMES:8.4f} ms/frame"
                f" {n / PROFILE_FRAMES:6.1f}x  {name[:90]}")

    # 'rebake': bake_labels into a BratsRenderer, whose K1 then reads the
    # baked-pred rows (K1a) on the card.
    rb = nm.NeuralBratsRenderer(mods, zsc, seg, model, params, width=WIDTH,
                                height=HEIGHT, backend="rebake")
    t0 = time.perf_counter()
    rb.render(basis, p)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    fr_rb = rb.brats.sweep_frame(basis, p)
    if fr_rb.pred_s is None:
        raise RuntimeError("the rebake renderer holds no baked prediction")
    for _ in range(NEURAL_WARMUP):
        cam.orbit(0.03, 0.0)
        rb.render(cam.basis(), p)
    torch.cuda.synchronize()
    composite.composite_planes.launches = 0
    warp.warp_screen.launches = 0
    rb_rates, rb_frames = [], 0
    for _ in range(BATCHES):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            cam.orbit(0.03, 0.01)
            img = rb.render(cam.basis(), p)
            rb_frames += 1
        torch.cuda.synchronize()
        rb_rates.append(ITERS / (time.perf_counter() - t0))
    rb_launches = {"K1": composite.composite_planes.launches,
                   "K2": warp.warp_screen.launches}
    if rb_launches != {"K1": rb_frames, "K2": rb_frames}:
        raise RuntimeError(f"rebake launch counts {rb_launches} != "
                           f"{rb_frames} frames")
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("bad rebake frame")
    baked = rb.brats.pred
    bshares = torch.bincount(baked.reshape(-1).long(),
                             minlength=cfg.num_classes).cpu().numpy()
    log("neural", f"rebake: first frame (bake + render) {first_ms:.1f} ms "
        f"host; then fps median {float(np.median(rb_rates)):.2f} over "
        f"{BATCHES} batches of {ITERS} (per batch "
        f"{[round(r, 2) for r in rb_rates]}), launches {rb_launches} (K1 "
        f"with baked-pred rows, O={fr_rb.out_res}); baked label shares "
        f"{[round(float(x), 4) for x in bshares / baked.numel()]}")

    return {"name": "K1b composite field", "route": "cuda",
            "source": "mri_raytracer_tpu_torch/csrc/composite.cu",
            "replaces": "mri_raytracer_tpu/ops/pallas_composite.py:317",
            "launches": launches["K1b"], "max_abs_err": err,
            "ms": t["K1b"][0], "plain_ms": t["K1b plain"][0],
            "bound_ms": k1b_bound, "bound_by": k1b_by,
            "library_ms": None}, k3_entry


def k3_check(torch, model, params, fr, S: int, Kf: int, card: str,
             peaks) -> dict:
    """K3, the INR's MLP, on the first block of planes of ``fr``'s field
    (the arguments ``predict_field`` hands ``mlp_block``), against its
    plain version on the same inputs: labels equal wherever the plain
    top-two logit gap exceeds K3_GAP of the logits' largest magnitude, at
    most 1e-3 of the points off; then both device times (cold L2) beside
    K3's bound: 2 (M H1 + sum of the later layers' in x out) FLOPs a point
    on the bf16 tensor cores, the intensities read and the labels written
    once. Returns the kernels line's K3 entry."""
    from mri_raytracer_tpu_torch.ops import neural_march as nm

    blocks = []

    def grab(fn):
        def call(*a, **kw):
            blocks.append(a[1:7])
            return fn(*a, **kw)
        return call

    with torch.no_grad(), patched(nm, "mlp_block", grab):
        nm.frame_field(model, params, fr, S, Kf)
    prm, intens, a_n, b_n, k_n, inv_order = blocks[0]
    K = model.cfg.fourier_freqs
    args = (prm, K, intens, a_n, b_n, k_n, inv_order)
    B, Oa, Ob, M = intens.shape
    with torch.no_grad():
        got = nm.separable_mlp(*args)
        logits = nm.separable_logits_plain(*args)
    torch.cuda.synchronize()
    want = logits.argmax(-1)
    top2 = logits.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    scale = float(logits.abs().max())
    off = got.long() != want
    share = float(off.float().mean())
    worst = float(gap[off].max()) / scale if bool(off.any()) else 0.0
    log("neural", f"K3 block B={B} Oa={Oa} Ob={Ob} M={M}, hidden "
        f"{[layer.W.shape[1] for layer in prm][:-1]}: labels off plain "
        f"{int(off.sum())} of {off.numel()} ({share:.3e}; limit 1e-3), "
        f"the largest top-two gap of a point off {worst:.3e} of the logits' "
        f"scale {scale:.3f} (limit {K3_GAP:.3e})")
    if worst > K3_GAP or not share <= 1e-3:
        raise RuntimeError("K3 disagrees with its plain version")

    def kernel():
        with torch.no_grad():
            return nm.separable_mlp(*args)

    def plain():
        with torch.no_grad():
            return nm.separable_logits_plain(*args).argmax(-1)

    ms = device_ms(torch, kernel, 20)
    plain_ms = device_ms(torch, plain, 3)
    widths = [prm[0].W.shape[1]] + [layer.W.shape[1] for layer in prm[1:]]
    P = B * Oa * Ob
    flops = 2.0 * P * (M * widths[0] + sum(
        a * b for a, b in zip(widths[:-1], widths[1:])))
    nbytes = P * (4 * M + 4) + sum(t.numel() * 4 for layer in prm
                                   for t in (layer.W, layer.b))
    k3_bound, k3_by = bound(peaks, nbytes, flops, peaks.bf16)
    log("neural", f"K3 device {ms:.4f} ms (cold L2), bound {k3_bound:.4f} ms "
        f"by {k3_by} ({flops / 1e9:.2f} GFLOP bf16, {nbytes / 1e6:.1f} MB), "
        f"{100 * k3_bound / ms:.1f}% of it; plain version {plain_ms:.4f} ms "
        f"({plain_ms / ms:.1f}x), on {card}")
    return {"name": "K3 INR MLP", "route": "cuda",
            "source": "mri_raytracer_tpu_torch/csrc/inr_mlp.cu",
            "replaces": None, "launches": 0, "max_abs_err": share,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": k3_bound,
            "bound_by": k3_by, "library_ms": None}


def accounting_phase(torch, renderer, p, radius: float, k1, flags, plain,
                     C_k, T_k, k1_bytes: float, k1_ops: float, fps: float,
                     plain_ms: float, card: str, peaks) -> dict:
    """Phase 9: K1c and the frame's FLOP/MFU accounting (bench.py:135-181)
    at the bench frame. Returns the K1c entry of the kernels line."""
    from mri_raytracer_tpu_torch.ops import composite
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.utils import arith

    # K1c against its plain version at the start pose (phase 3's inputs).
    C_c, T_c, planes = composite.composite_planes(*k1, *flags,
                                                  count_planes=True)
    torch.cuda.synchronize()
    O = planes.shape[0]
    diff = (planes - plain.planes).abs()
    n_diff, max_diff = int((diff > 0).sum()), int(diff.max())
    same_img = torch.equal(C_c, C_k) and torch.equal(T_c, T_k)
    err_ct = max(float((C_c - plain.C).abs().max()),
                 float((T_c - plain.T).abs().max()))
    log("account", f"K1c executed-plane map vs plain at the start pose: "
        f"{n_diff} of {O * O} pixels differ, largest difference {max_diff} "
        f"plane(s); kernel total {int(planes.sum())}, plain total "
        f"{int(plain.n_active)}; C and T with the counter on "
        f"{'bit-equal' if same_img else 'NOT bit-equal'} to it off; "
        f"max|C, T - plain| {err_ct:.3e}")
    # A pixel whose T lands within rounding of 0.01 may stop one plane
    # earlier or later in the kernel than in the plain version.
    if not (n_diff == 0 or (max_diff == 1 and n_diff <= 1e-4 * O * O)):
        raise RuntimeError("K1c disagrees with its plain version")
    if not same_img:
        raise RuntimeError("the counter changed C or T")
    if not err_ct <= TOL:
        raise RuntimeError("K1c's C, T disagree with the plain version")

    k1_fn = lambda: composite.composite_planes(*k1, *flags)
    k1c_fn = lambda: composite.composite_planes(*k1, *flags,
                                                count_planes=True)
    t = {}
    for name, fn in (("K1 counter off", k1_fn), ("K1c counter on", k1c_fn),
                     ("K1 counter off again", k1_fn),
                     ("K1c counter on again", k1c_fn)):
        t[name] = (device_ms(torch, fn, 20), cuda_ms(torch, fn, 20))
        log("account", f"{name}: device {t[name][0]:.4f} ms (cold L2), CUDA "
            f"events {t[name][1]:.4f} ms back to back (mean of 20 calls)")
    k1c_ms = 0.5 * (t["K1c counter on"][0] + t["K1c counter on again"][0])
    k1_ms = 0.5 * (t["K1 counter off"][0] + t["K1 counter off again"][0])
    k1c_bound, k1c_by = bound(peaks, k1_bytes + 4 * O * O, k1_ops,
                              peaks.fp32)
    log("account", f"K1c device {k1c_ms:.4f} ms vs K1 {k1_ms:.4f} ms "
        f"(counter cost {k1c_ms - k1_ms:+.4f} ms), bound {k1c_bound:.4f} ms "
        f"by {k1c_by}, on {card}")

    # bench.py:148-158: ACCT_POSES poses along the timed orbit of phase 4.
    composite.composite_planes.count_launches = 0
    per_pose = []
    n_timed = BATCHES * ITERS
    for k in np.linspace(1, n_timed, ACCT_POSES):
        basis = OrbitalCamera(radius=radius, theta=0.6 + 0.03 * (WARMUP + k),
                              phi=1.2 + 0.01 * k).basis()
        stats = renderer.frame_stats(basis, p)
        counts = renderer.executed_planes(basis, p)
        if counts.shape != (stats["out_res"],) * 2 or \
                not 0 <= counts.min() <= counts.max() <= stats["planes"]:
            raise RuntimeError(f"bad executed-plane map {counts.shape}, "
                               f"[{counts.min()}, {counts.max()}]")
        f = arith.frame_flops(stats, WIDTH, HEIGHT, executed_planes=counts)
        per_pose.append(f)
        log("account", f"pose k={k:g}: axis {stats['axis']}, K="
            f"{stats['planes']}, Na={stats['Na']}, Nb={stats['Nb']}, O="
            f"{stats['out_res']}; executed (pixel, plane) pairs "
            f"{int(counts.sum(dtype=np.int64))}; GFLOP stage 1 "
            f"{f['flops_stage1'] / 1e9:.3f}, stage 2 "
            f"{f['flops_stage2'] / 1e9:.3f}; steps/ray eff "
            f"{f['steps_per_ray_eff']:.2f} of {f['steps_per_ray_max']:.0f}")
    launches = composite.composite_planes.count_launches
    if launches != ACCT_POSES:
        raise RuntimeError(f"K1c launches {launches} != {ACCT_POSES} poses")
    mean = lambda key: float(np.mean([f[key] for f in per_pose]))
    fl = mean("flops_total")
    m = arith.mfu(fl, fps, 0)
    exact = all(f["stage2_exact"] for f in per_pose)
    log("account", f"{fl / 1e9:.3f} GFLOP/frame (stage 1 "
        f"{mean('flops_stage1') / 1e9:.3f} + stage 2 "
        f"{mean('flops_stage2') / 1e9:.3f} + warp "
        f"{mean('flops_warp') / 1e9:.3f}) over {ACCT_POSES} poses -> "
        f"{m['tflops_per_s']:.3f} TFLOP/s at phase 4's {fps:.2f} fps, MFU "
        f"{100 * m['mfu']:.3f}% of the {m['peak_tflops']:.1f} TFLOP/s dense "
        f"bf16 peak of {card}; steps/ray eff {mean('steps_per_ray_eff'):.2f}"
        f" (max {mean('steps_per_ray_max'):.1f}); stage2_exact {exact}; "
        f"K1c launches {launches}")
    if not exact or not np.isfinite(fl) or fl <= 0:
        raise RuntimeError("the accounting is not exact or not finite")

    return {"name": "K1c composite echo='planes'", "route": "cuda",
            "source": "mri_raytracer_tpu_torch/csrc/composite.cu",
            "replaces": "mri_raytracer_tpu/ops/pallas_composite.py:575",
            "launches": launches, "max_abs_err": float(max_diff),
            "ms": k1c_ms, "plain_ms": plain_ms, "bound_ms": k1c_bound,
            "bound_by": k1c_by, "library_ms": None}


def png_size(data: bytes):
    """(width, height) from a PNG's IHDR chunk."""
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise RuntimeError("not a PNG")
    return struct.unpack(">II", data[16:24])


def front_end_phase(torch, card: str) -> None:
    """Phase 10: the viewer CLI and the HTTP frame server on a 256^3 NIfTI
    case at WIDTH x HEIGHT, through the entry points a user calls."""
    import dataclasses

    from mri_raytracer_tpu_torch.apps import brats_app, serve
    from mri_raytracer_tpu_torch.config import ModelConfig
    from mri_raytracer_tpu_torch.data.synthetic import write_synthetic_dataset
    from mri_raytracer_tpu_torch.io.checkpoint import save_object
    from mri_raytracer_tpu_torch.models.api import build_model
    from mri_raytracer_tpu_torch.ops import composite, warp

    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=BUILD) as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        case = write_synthetic_dataset(tmp / "data", num_cases=1, shape=VOL,
                                       seed=0) / "BraTS-SYN-00000-000"
        t_case = time.perf_counter() - t0
        cfg = ModelConfig()
        model = build_model(cfg, num_modalities=4)
        params = model.init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            params[-1].b += torch.tensor(BIAS_NUDGE)
        ckpt = tmp / "inr.npz"
        save_object(params, ckpt, info={"model": dataclasses.asdict(cfg)})
        size_mb = sum(f.stat().st_size for f in case.iterdir()) / 2**20
        log("front", f"wrote {case.name} ({VOL}, 5 .nii.gz, {size_mb:.1f} "
            f"MiB) in {t_case:.1f} s, and a ModelConfig() checkpoint")

        def counts():
            return (composite.composite_planes.launches,
                    warp.warp_screen.launches)

        # The viewer CLI: plain, then with the checkpoint baked in.
        for name, extra in (("plain", []),
                            ("inr", ["--inr-checkpoint", str(ckpt)])):
            out = tmp / f"viewer_{name}"
            before = counts()
            t0 = time.perf_counter()
            rc = brats_app.main(["--case-dir", str(case), "--width",
                                 str(WIDTH), "--height", str(HEIGHT),
                                 "--frames", str(VIEWER_FRAMES), "--out",
                                 str(out)] + extra)
            wall = time.perf_counter() - t0
            grew = tuple(a - b for a, b in zip(counts(), before))
            pngs = sorted(out.glob("frame_*.png"))
            sizes = {png_size(f.read_bytes()) for f in pngs}
            log("front", f"viewer {name}: rc {rc}, {len(pngs)} PNGs of "
                f"{sizes}, K1/K2 launches +{grew} (frames {VIEWER_FRAMES} + "
                f"warm-up {APP_WARMUP}), {wall:.1f} s wall (load, warm-up, "
                f"frames, PNG writes), on {card}")
            want = VIEWER_FRAMES + APP_WARMUP
            if rc != 0 or len(pngs) != VIEWER_FRAMES or \
                    sizes != {(WIDTH, HEIGHT)} or grew != (want, want):
                raise RuntimeError(f"viewer {name} failed")

        # Mode 2 through the viewer: the plain scan evaluates the INR at
        # every plane pixel at stride 1, so only as an entry check, small.
        out = tmp / "viewer_neural"
        t0 = time.perf_counter()
        rc = brats_app.main(["--synthetic", "--synthetic-shape", "64,64,64",
                             "--width", "128", "--height", "128", "--frames",
                             "1", "--neural-march", "--inr-checkpoint",
                             str(ckpt), "--out", str(out)])
        pngs = sorted(out.glob("frame_*.png"))
        log("front", f"viewer --neural-march (64^3, 128^2): rc {rc}, "
            f"{len(pngs)} PNG, {time.perf_counter() - t0:.1f} s wall")
        if rc != 0 or len(pngs) != 1 or \
                png_size(pngs[0].read_bytes()) != (128, 128):
            raise RuntimeError("viewer --neural-march failed")

        # The HTTP frame server.
        before = counts()
        t0 = time.perf_counter()
        service = serve.build_service(str(case), size=WIDTH)
        srv = serve.make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        log("front", f"server up at {base} in {time.perf_counter() - t0:.1f}"
            f" s (case load, warm-up)")
        try:
            for path in ("/info", "/"):
                with urllib.request.urlopen(base + path, timeout=120) as r:
                    body = r.read()
                    if r.status != 200:
                        raise RuntimeError(f"{path}: HTTP {r.status}")
                log("front", f"GET {path}: 200, {len(body)} bytes"
                    + (f": {body.decode()}" if path == "/info" else ""))
            queries = ["theta=0.6&phi=1.2", "theta=0.9&phi=1.0",
                       "theta=2.0&phi=0.7&preset=t1c-enhancing",
                       "theta=3.5&phi=1.6&ww=0.8&wl=0.6&seg=0"]
            for q in queries[:SERVER_FRAMES]:
                t0 = time.perf_counter()
                with urllib.request.urlopen(base + "/frame?" + q,
                                            timeout=120) as r:
                    body = r.read()
                    timing = r.headers.get("Server-Timing", "")
                    status = r.status
                ms = (time.perf_counter() - t0) * 1e3
                size = png_size(body)
                log("front", f"GET /frame?{q}: {status}, {size} PNG "
                    f"{len(body)} bytes, {ms:.1f} ms at the client; server "
                    f"{timing}, on {card}")
                if status != 200 or size != (WIDTH, HEIGHT):
                    raise RuntimeError(f"/frame?{q} failed")
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=30)
        grew = tuple(a - b for a, b in zip(counts(), before))
        want = SERVER_FRAMES + APP_WARMUP
        log("front", f"server K1/K2 launches +{grew} (requests "
            f"{SERVER_FRAMES} + warm-up {APP_WARMUP})")
        if grew != (want, want) or thread.is_alive():
            raise RuntimeError("server launch counts or shutdown wrong")


def call_app(app, argv):
    """``app.main(argv)`` with its stdout captured: (rc, stdout, seconds)."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = app.main([str(a) for a in argv])
    return rc, buf.getvalue(), time.perf_counter() - t0


def cli_phase(torch, card: str, cases, train_cache, renderer, p,
              radius: float, mods, seg) -> None:
    """Phase 11d: the notebook viewers (render/widgets.py) and the eleven
    script CLIs of apps/ through their entry points, on the bench frame,
    [train]'s cases, its loaded cache and its trained INR, at the JAX
    scripts' defaults but for the CLI_* cuts. Each call's K1a / K1b / K2
    launches are counted from 0 and held to what its frames need; every
    file a CLI writes (under a work directory in build/, removed after)
    is checked."""
    from PIL import Image

    from mri_raytracer_tpu_torch import convert
    from mri_raytracer_tpu_torch.apps import (
        bench_neural_march, bench_roi_overhead, demo_end_to_end,
        full_geometry_smoke, neural_psnr_cert, orbit_video, read_npz,
        roi_occupancy_bound, roi_report, roi_retime, roi_showcase_figures)
    from mri_raytracer_tpu_torch.config import ModelConfig
    from mri_raytracer_tpu_torch.eval import metrics
    from mri_raytracer_tpu_torch.io import checkpoint as ckpt
    from mri_raytracer_tpu_torch.ops import composite, warp
    from mri_raytracer_tpu_torch.render import widgets
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera

    k1, k2 = composite.composite_planes, warp.warp_screen
    walls = {}

    def launched(name: str, want) -> None:
        """K1a / K1b / K2 launches since the counters were zeroed, held to
        ``want``, then zeroed again."""
        torch.cuda.synchronize()
        got = (k1.launches - k1.field_launches, k1.field_launches,
               k2.launches)
        log("cli", f"{name}: K1a / K1b / K2 launches {got} (want {want})")
        if got != tuple(want):
            raise RuntimeError(f"[cli] {name}: launches {got}, want {want}")
        k1.launches = k1.field_launches = k2.launches = 0

    def app(name: str, module, argv, want, rc_ok=(0,)):
        rc, text, sec = call_app(module, argv)
        walls[name] = sec
        for line in text.splitlines():
            log("cli", f"  {line}")
        log("cli", f"{name} {' '.join(map(str, argv))}: rc {rc}, "
            f"{sec:.1f} s wall, on {card}")
        if rc not in rc_ok:
            raise RuntimeError(f"[cli] {name} returned {rc}")
        launched(name, want)
        return rc, text

    def no_hausdorff(_):
        """The final eval's Hausdorff as NaN a class (what the eval writes
        for a class it cannot score)."""
        return lambda pred, true, spacing=None, num_classes=4: {
            c: float("nan") for c in range(num_classes)}

    def need(path: pathlib.Path) -> pathlib.Path:
        if not path.is_file() or path.stat().st_size == 0:
            raise RuntimeError(f"[cli] {path.name} was not written")
        return path

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    k1.launches = k1.field_launches = k1.count_launches = k2.launches = 0
    work_dir, data = cases
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_",
                                     dir=BUILD) as tmp:
        tmp = pathlib.Path(tmp)

        # The viewers. OrbitViewer over the bench renderer: one frame.
        cam = OrbitalCamera(radius=radius, theta=0.6, phi=1.2)
        viewer = widgets.OrbitViewer(renderer, p, cam)
        t0 = time.perf_counter()
        img = viewer.frame()
        walls["OrbitViewer.frame"] = time.perf_counter() - t0
        launched("OrbitViewer.frame", (1, 0, 1))
        same = np.array_equal(img, np.clip(renderer.render_numpy(
            cam.basis(), p), 0, 1))
        k1.launches = k2.launches = 0
        log("cli", f"OrbitViewer.frame {img.shape} in "
            f"{walls['OrbitViewer.frame'] * 1e3:.1f} ms: equal to "
            f"render_numpy clipped: {same}, on {card}")
        if not same:
            raise RuntimeError("[cli] OrbitViewer.frame differs")
        t0 = time.perf_counter()
        multi = widgets.SliceViewer(mods, seg=seg).render_multiview()
        walls["SliceViewer.render_multiview"] = time.perf_counter() - t0
        log("cli", f"SliceViewer.render_multiview on {VOL}: {multi.shape} "
            f"in {walls['SliceViewer.render_multiview']:.2f} s (host NumPy)")
        if multi.shape != (VOL[1], 3 * VOL[0], 3) or \
                not np.isfinite(multi).all():
            raise RuntimeError("[cli] SliceViewer.render_multiview failed")
        # HoldoutViewer: [train]'s trained INR on one of its cases.
        inr = work_dir / "run" / "inr.npz"
        tree, info = ckpt.model_load(inr)
        model, params = convert.inr_params_from_numpy(
            tree, ModelConfig.from_info(info), device="cuda")
        case = train_cache.get(0)
        hv = widgets.HoldoutViewer(model, params, [case])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = hv.prediction(0)
        t_pred = time.perf_counter() - t0
        t0 = time.perf_counter()
        cached = hv.prediction(0) is pred
        t_cached = time.perf_counter() - t0
        # The slice with the most tumour voxels.
        z = int(np.argmax((np.asarray(case["seg"]) > 0).sum(axis=(0, 1))))
        rep = hv.slice_report(0, z)
        pic = hv.render(0, z)
        walls["HoldoutViewer"] = t_pred
        launched("HoldoutViewer", (0, 0, 0))
        log("cli", f"HoldoutViewer on {case.get('name', 'case 0')} "
            f"{tuple(case['seg'].shape)}: prediction {t_pred:.3f} s wall "
            f"(again from the cache in {t_cached * 1e3:.3f} ms: {cached}); "
            f"slice {z}: macro Dice {rep['macro_dice']:.4f}, PSNR "
            f"{rep['psnr']:.2f} dB; image {pic.shape}, on {card}")
        if not cached or pic.shape != (case["seg"].shape[0],
                                       2 * case["seg"].shape[1], 3):
            raise RuntimeError("[cli] HoldoutViewer failed")

        # read_npz on [train]'s checkpoint; roi_report into build/.
        _, text = app("read_npz", read_npz, [inr], (0, 0, 0))
        if not text.startswith(f"== {inr}") or len(text.splitlines()) < 4:
            raise RuntimeError("[cli] read_npz printed no tree")
        app("roi_report", roi_report, ["--out", tmp / "roi_report"],
            (0, 0, 0))
        need(tmp / "roi_report" / "ROI_RESULTS.md")

        # neural_psnr_cert --train-steps 600 at its defaults: 6 poses x 2
        # kstrides of fused neural frames (K1b + K2 each).
        rc, _ = app("neural_psnr_cert", neural_psnr_cert,
                    ["--train-steps", CLI_CERT_STEPS, "--out", tmp / "cert"],
                    (0, 12, 12), rc_ok=(0, 1))
        rec = json.loads(need(tmp / "cert" /
                              "neural_psnr_cert_trained.json").read_text())
        jrec = json.loads(JAX_CERT.read_text())
        for ks, r in rec["kstride"].items():
            j = jrec["kstride"].get(ks, {})
            log("cli", f"cert kstride {ks}: " + ", ".join(
                f"{n} {q:.2f}" for n, q in r["per_pose"].items())
                + f" dB; min {r['min_db']:.2f} at {r['min_pose']}, median "
                f"{r['median_db']:.2f} (JAX on its TPU, recorded: min "
                f"{j.get('min_db')}, median {j.get('median_db')}); pass_40db "
                f"{r['pass_40db']}, on {card}")
        if rc != (0 if rec["overall_pass"] else 1):
            raise RuntimeError(f"[cli] neural_psnr_cert rc {rc} against "
                               f"overall_pass {rec['overall_pass']}")

        # bench_neural_march at its defaults: 1 + 10 x 3 frames each of
        # plain and baked (K1a + K2) and neural (K1b + K2).
        n = 1 + 10 * 3
        _, text = app("bench_neural_march", bench_neural_march,
                      ["--out", tmp / "bnm"], (2 * n, n, 3 * n))
        nm = json.loads(text.strip().splitlines()[-1])
        log("cli", f"bench_neural_march {nm['size']}^2 / {nm['vol']}^3: "
            f"plain {nm['plain_fps']} fps, baked {nm['baked_fps']}, neural "
            f"{nm['value']}; MLP overhead {nm['mlp_overhead_ms']} ms a "
            f"frame; bake {nm['bake_seconds']} s, re-bake {nm['rebake_ms']}"
            f" ms, on {card}")

        # full_geometry_smoke on [train]'s dataset (no new write): warm-up
        # 3 + 1 + 3 x 10 orbit frames + the checked frame (K1a + K2).
        before = sorted(str(q) for q in data.rglob("*"))
        with patched(metrics, "hausdorff_distance", no_hausdorff):
            _, text = app("full_geometry_smoke", full_geometry_smoke,
                          ["--root", data, "--cases", CLI_FG_CASES,
                           "--steps", CLI_FG_STEPS, "--out", tmp / "fg"],
                          (35, 0, 35))
        if sorted(str(q) for q in data.rglob("*")) != before:
            raise RuntimeError("[cli] full_geometry_smoke wrote a dataset")
        fg = json.loads(text.strip().splitlines()[-1])
        log("cli", "full_geometry_smoke: " + ", ".join(
            f"{k} {v}" for k, v in fg.items() if k not in ("metric", "unit"))
            + f", on {card}")

        # demo_end_to_end at its constants but CLI_DEMO_STEPS: the 'sweep'
        # backend (the plain scan) warps with K2: warm-up 3 + 1 + 3 + 20
        # frames.
        with patched(metrics, "hausdorff_distance", no_hausdorff), \
                patched(demo_end_to_end, "run_demo", lambda run: (
                    lambda *a, **kw: run(*a, steps=CLI_DEMO_STEPS, **kw))):
            _, text = app("demo_end_to_end", demo_end_to_end,
                          ["--out", tmp / "demo"], (0, 0, 27))
        for f in ("RESULTS_r1.md", "renders/inr_overlay_sweep.png",
                  "renders/inr_overlay_oracle.png"):
            need(tmp / "demo" / f)
        for line in text.splitlines():
            if "PSNR" in line or "fps" in line:
                log("cli", f"demo_end_to_end: {line.strip('- ')}")

        # orbit_video: the BraTS orbit at its defaults, then the ROI split
        # screens at CLI_ROI_FRAMES frames.
        res, frames = CLI_VIDEO
        app("orbit_video brats", orbit_video,
            ["--which", "brats", "--out", tmp / "video"],
            (frames, 0, frames))
        gif = Image.open(need(tmp / "video" / "img" / "brats_orbit.gif"))
        if gif.n_frames != frames or gif.size != (res, res):
            raise RuntimeError(f"[cli] brats_orbit.gif: {gif.n_frames} "
                               f"frames of {gif.size}")
        app("orbit_video roi", orbit_video,
            ["--which", "roi", "--frames", CLI_ROI_FRAMES, "--out",
             tmp / "video"], (0, 0, 0))
        verdicts = json.loads((DOCS / "roi_results.json").read_text())[
            "verdicts"]
        voting = sorted(v["scene"] for v in verdicts
                        if v.get("counts_toward_bar", True))
        rois = sorted((tmp / "video" / "img").glob("roi_orbit_*.gif"))
        if [g.name for g in rois] != [f"roi_orbit_{v}.gif" for v in voting] \
                or any(Image.open(g).n_frames != CLI_ROI_FRAMES
                       for g in rois):
            raise RuntimeError(f"[cli] ROI orbit GIFs: {rois}")

        # The ROI CLIs (no kernel of the port).
        _, text = app("roi_occupancy_bound", roi_occupancy_bound, [],
                      (0, 0, 0))
        if len(text.strip().splitlines()) != 5:
            raise RuntimeError("[cli] roi_occupancy_bound: not 5 scenes")
        app("roi_showcase_figures", roi_showcase_figures,
            ["--out", tmp / "fig"], (0, 0, 0))
        need(tmp / "fig" / "experiments.csv")
        for kind in ("pareto", "frames"):
            got = sorted(q.name for q in
                         (tmp / "fig" / "img").glob(f"roi_{kind}_*.png"))
            if got != sorted(f"roi_{kind}_{v['scene']}.png"
                             for v in verdicts):
                raise RuntimeError(f"[cli] roi_{kind} PNGs: {got}")
        _, text = app("bench_roi_overhead", bench_roi_overhead,
                      ["--frames", CLI_OVERHEAD_FRAMES], (0, 0, 0))
        if len(text.strip().splitlines()) != 4:
            raise RuntimeError("[cli] bench_roi_overhead: not 3 budgets")
        docs_json = DOCS / "roi_results.json"
        stamp = docs_json.read_bytes()
        app("roi_retime", roi_retime,
            ["--scenes", CLI_RETIME_SCENE, "--rounds", CLI_RETIME_ROUNDS,
             "--out", tmp / "retime", "--ref-cache", tmp / "refs"],
            (0, 0, 0))
        need(tmp / "retime" / "roi_results.json")
        need(tmp / "retime" / "ROI_RESULTS.md")
        if docs_json.read_bytes() != stamp:
            raise RuntimeError("[cli] roi_retime changed docs/")
    total = time.perf_counter() - t_phase
    log("cli", "walls (s): " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in walls.items()))
    log("cli", f"phase wall {total:.1f} s, on {card}")


class _Stop(Exception):
    """Ends a [train] run from its step hook."""


@contextlib.contextmanager
def patched(module, name: str, wrap):
    """While open, ``module.name`` is ``wrap(original)``."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def step_hook(hook):
    """While open, every train step the engine builds runs as
    ``hook(step, args)``, where ``step(*args)`` is the real step and
    ``args`` its ``(params, optimizer, generator, mods, segs, step_idx,
    boundary)``: the hook may record around the call or end the run."""
    from mri_raytracer_tpu_torch.train import steps

    def wrap(build):
        def hooked_build(*a, **kw):
            step = build(*a, **kw)
            return lambda *args: hook(step, args)

        return hooked_build

    return patched(steps, "build_train_step", wrap)


@contextlib.contextmanager
def training_cases(card: str):
    """TRAIN_CASES synthetic cases of TRAIN_SHAPE (seed 0, BraTS-2023 NIfTI
    layout) in a work directory under build/, removed after: yields (work
    directory, data root). [train], [optim] and [unet] share them."""
    from mri_raytracer_tpu_torch.data.synthetic import write_synthetic_dataset

    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_",
                                     dir=BUILD) as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        data = write_synthetic_dataset(tmp / "data", num_cases=TRAIN_CASES,
                                       shape=TRAIN_SHAPE, seed=0)
        log("train", f"wrote {TRAIN_CASES} synthetic cases {TRAIN_SHAPE} "
            f"(seed 0, BraTS-2023 NIfTI layout) in "
            f"{time.perf_counter() - t0:.1f} s wall, on {card}")
        yield tmp, data


def train_config(tmp: pathlib.Path, data: pathlib.Path, out: str):
    """The default ``TrainConfig()`` on the TRAIN_CASES cases: 4 train, 1
    validation (fold 0), writing under ``tmp / out``."""
    from mri_raytracer_tpu_torch.config import TrainConfig

    c = TrainConfig()
    c.data.data_root = str(data)
    c.data.case_limit = TRAIN_CASES
    c.data.num_folds = TRAIN_CASES
    c.data.fold_index = 0
    c.out_dir = str(tmp / out)
    return c


def train_phase(torch, card: str, cases=None):
    """Phase 11: INR training through ``train_inr`` at the full default
    ``TrainConfig()`` on TRAIN_CASES synthetic BraTS-2023-size cases, its
    checks (loss, Dice, checkpoints, exact resume) and the trained field
    rendered by the neural frame. ``cases`` is ``training_cases``'s
    (work directory, data root); without it the phase writes its own.
    Returns the main run's loaded train cache, which [parallel] reuses."""
    import copy

    from mri_raytracer_tpu_torch import convert
    from mri_raytracer_tpu_torch.config import ModelConfig
    from mri_raytracer_tpu_torch.data.brats import percentile_normalize
    from mri_raytracer_tpu_torch.eval import inference, metrics
    from mri_raytracer_tpu_torch.io import checkpoint as ckpt
    from mri_raytracer_tpu_torch.ops import composite
    from mri_raytracer_tpu_torch.ops import neural_march as nm
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.train import engine

    if cases is None:
        with training_cases(card) as cases:
            return train_phase(torch, card, cases)
    tmp, data = cases

    def config(out: str):
        return train_config(tmp, data, out)

    # The main run, timed by phase, with CUDA events at the log steps.
    cfg = config("run")
    walls = {}

    def timed(fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                walls[fn.__name__] = time.perf_counter() - t

        return call

    events, live = {}, {}

    def main_hook(step, args):
        params, step_idx = args[0], args[5]
        if not live:
            live["init"] = copy.deepcopy(params)
        live["step"], live["args"] = step, args
        m = step(*args)
        if step_idx % cfg.log_every == 0:
            events[step_idx] = torch.cuda.Event(enable_timing=True)
            events[step_idx].record()
        return m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with patched(engine.cache_mod, "build_train_val_caches", timed), \
            patched(engine.inference, "evaluate_cases", timed), \
            step_hook(main_hook):
        state = engine.train_inr(cfg)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model, params = state["model"], state["params"]
    hist = state["history"]
    log("train", f"TrainConfig() defaults: {cfg.model.kind} "
        f"{cfg.model.hidden_dims}, {cfg.model.fourier_freqs} harmonics, "
        f"{cfg.train_steps} steps, global batch {cfg.global_batch} = "
        f"{cfg.global_batch // cfg.micro_batch} x micro {cfg.micro_batch}"
        f", {cfg.optim.optimizer} lr {cfg.optim.lr} "
        f"{cfg.optim.schedule}, clip {cfg.optim.grad_clip}, sampler "
        f"{cfg.data.sampler}, pool {cfg.data.pool_size}; "
        f"{state['train_cache'].n_cases} train + "
        f"{state['val_cache'].n_cases} val cases")
    log("train", f"wall: train_inr {wall:.1f} s = cache load "
        f"{walls['build_train_val_caches']:.1f} s + loop "
        f"{state['train_time_sec']:.1f} s + final eval "
        f"{walls['evaluate_cases']:.1f} s + the rest (pool, checkpoints"
        f", logs); peak device memory {peak / 2**20:.1f} MiB "
        f"(torch.cuda.max_memory_allocated), of which "
        f"{held / 2**20:.1f} MiB held by earlier phases: "
        f"{(peak - held) / 2**20:.1f} MiB for training, on {card}")
    per_step = []
    marks = sorted(events)
    for a, b in zip(marks, marks[1:]):
        if a >= 100:
            per_step.append(events[a].elapsed_time(events[b]) / (b - a))
    ms = float(np.median(per_step))
    log("train", f"ms per step over steps 101-{cfg.train_steps} (CUDA "
        f"events at the log steps, {len(per_step)} windows of "
        f"{cfg.log_every}): median {ms:.4f}, mean "
        f"{float(np.mean(per_step)):.4f}, min {min(per_step):.4f}, max "
        f"{max(per_step):.4f}; {cfg.global_batch / ms * 1e3:.0f} "
        f"voxels/s at the median, on {card}")
    losses = [h["loss"] for h in hist]
    log("train", f"logged loss: step {hist[0]['step']} {losses[0]:.4g}"
        f", step {hist[len(hist) // 2]['step']} "
        f"{losses[len(hist) // 2]:.4g}, step {hist[-1]['step']} "
        f"{losses[-1]:.4g} ({len(hist)} log steps)")
    if not all(np.isfinite(losses)):
        raise RuntimeError("a logged loss is not finite")
    if not losses[-1] < 0.5 * losses[0]:
        raise RuntimeError(f"the loss did not halve: {losses[0]:.4f} -> "
                           f"{losses[-1]:.4f}")

    # Validation: the trained network against itself at its initial
    # weights, on the same case, by evaluate_single_case's mean Dice.
    val = state["val_cache"].get(0)
    agg = state["eval"]
    pred0, true0 = inference.predict_volume(model, live["init"], val)
    s0 = metrics.dice_score(pred0, true0, cfg.model.num_classes)
    valid0 = [v for v in s0.values() if not np.isnan(v)]
    dice0 = float(np.mean(valid0)) if valid0 else 0.0
    nc = cfg.model.num_classes
    log("train", f"val {val['name']}: mean Dice {agg['mean_dice'][0]:.4f}"
        f" (initial weights {dice0:.4f}); per class "
        + ", ".join(f"{c}: {agg[f'dice_class_{c}'][0]:.4f}"
                    for c in range(nc))
        + "; Hausdorff " + ", ".join(
            f"{c}: {agg[f'hd_class_{c}'][0]:.2f}" for c in range(nc))
        + f"; coverage Dice {agg['coverage_dice'][0]:.4f}, on {card}")
    if not agg["mean_dice"][0] > dice0:
        raise RuntimeError("validation Dice did not beat the initial "
                           "weights'")

    # The checkpoints: the object format through model_load, bit-equal
    # logits; the reference's flat format through load_params.
    tree, info = ckpt.model_load(state["checkpoint"])
    m2, p2 = convert.inr_params_from_numpy(
        tree, ModelConfig.from_info(info), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(9)
    coords = torch.rand((8192, 3), generator=g, device="cuda") * 2 - 1
    intens = torch.randn((8192, 4), generator=g, device="cuda")
    with torch.no_grad():
        same = torch.equal(model.apply(params, coords, intens),
                           m2.apply(p2, coords, intens))
    flat = ckpt.load_params(pathlib.Path(cfg.out_dir) /
                            f"{cfg.run_name}_flat.npz")
    flat_ok = all(np.array_equal(a[k], b[k]) for a, b in zip(
        flat, ckpt.params_to_numpy(params)) for k in ("W", "b"))
    log("train", f"final checkpoint {pathlib.Path(state['checkpoint']).name}"
        f" reloads with bit-equal logits: {same}; flat format "
        f"({len(flat)} layers) equal: {flat_ok}")
    if not (same and flat_ok):
        raise RuntimeError("the checkpoint does not reload")

    # Exact resume on the card: 40 steps straight against 20, a stop,
    # a resume from the train state and 20 more (each run ends at its
    # last step, before its final eval).
    snaps = {}

    def stop_after(n, key):
        def hook(step, args):
            if args[5] > n:
                raise _Stop
            m = step(*args)
            if args[5] == n and key:
                snaps[key] = copy.deepcopy(args[0])
                raise _Stop
            return m

        return hook

    t0 = time.perf_counter()
    for out, n, key, every, resume in (
            ("straight", RESUME_STEPS, "straight", 0, None),
            ("first", RESUME_STEPS // 2, None, RESUME_STEPS // 2, None),
            ("resumed", RESUME_STEPS, "resumed", 0,
             tmp / "first" / "inr_trainstate.npz")):
        c = config(out)
        c.train_steps = RESUME_STEPS
        c.checkpoint_every = every
        c.resume_from = None if resume is None else str(resume)
        with step_hook(stop_after(n, key)):
            try:
                engine.train_inr(c)
            except _Stop:
                pass
    with torch.no_grad():
        diff = max(float((a - b).abs().max()) for a, b in zip(
            snaps["straight"].parameters(),
            snaps["resumed"].parameters()))
    log("train", f"exact resume: {RESUME_STEPS} steps straight vs "
        f"{RESUME_STEPS // 2} + resume + {RESUME_STEPS // 2}: max abs "
        f"param difference {diff:.3e} (bound {RESUME_TOL}), "
        f"{time.perf_counter() - t0:.1f} s wall")
    if not diff <= RESUME_TOL:
        raise RuntimeError("exact resume differs")

    # The trained field through the neural frame on the validation case.
    disp = np.stack([percentile_normalize(m) for m in val["mods"]])
    seg = val["seg"].astype(np.int32)
    renderer = nm.NeuralBratsRenderer(disp, val["mods"], seg, model,
                                      params, width=WIDTH, height=HEIGHT)
    if renderer.backend != "fused":
        raise RuntimeError(f"backend 'auto' resolved to "
                           f"{renderer.backend}")
    p = rp.default_render_params(TRAIN_SHAPE, show_seg=True,
                                 show_pred=True)
    radius = rp.default_camera_radius(p, TRAIN_SHAPE)
    cam = OrbitalCamera(radius=radius, theta=0.6, phi=1.2)
    q, fr, field = fused_vs_scan(renderer, cam.basis(), p)
    counts = torch.bincount(field.reshape(-1).long(),
                            minlength=nc).tolist()
    log("train", f"trained field at the start pose: O={fr.out_res}, "
        f"field {tuple(field.shape)}, label counts {counts}; fused vs "
        f"scan {q:.2f} dB (>= {PSNR_MIN_DB})")
    if not q >= PSNR_MIN_DB:
        raise RuntimeError(f"trained field: fused vs scan {q:.2f} dB")
    torch.cuda.synchronize()
    composite.composite_planes.field_launches = 0
    for _ in range(TRAIN_FRAMES):
        cam.orbit(0.03, 0.01)
        img = renderer.render(cam.basis(), p)
    torch.cuda.synchronize()
    k1b = composite.composite_planes.field_launches
    log("train", f"{TRAIN_FRAMES} orbit frames of the trained field: "
        f"K1b launches {k1b}")
    if k1b != TRAIN_FRAMES or not bool(torch.isfinite(img).all()):
        raise RuntimeError("trained-field frames failed")

    # 20 steady steps of the main run's own step, under the profiler.
    step, args = live["step"], live["args"]
    by_name = device_activity(torch, lambda: step(*args), PROFILE_STEPS)
    if not by_name:
        log("train", "profile: device time not measured: the profiler "
            "saw no device activity")
    else:
        busy = sum(us for _, us in by_name.values()) / 1e3 / PROFILE_STEPS
        ops = sum(n for n, _ in by_name.values()) / PROFILE_STEPS
        log("train", f"profile per step over {PROFILE_STEPS} steps: "
            f"{ops:.1f} device operations, device busy {busy:.4f} ms; "
            f"idle share of the {ms:.4f} ms step {1.0 - busy / ms:.3f}, "
            f"on {card}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        for name, (n, us) in top:
            log("train", f"profile {us / 1e3 / PROFILE_STEPS:8.4f} ms/step"
                f" {n / PROFILE_STEPS:6.1f}x  {name[:90]}")
    return state["train_cache"]


def optim_phase(torch, card: str, cases) -> None:
    """Phase 11a: each optax.contrib optimizer of the zoo through
    ``train_inr`` at the default ``TrainConfig()`` with only the optimizer
    changed, OPTIM_STEPS steps (ended through the step hook, before the
    final eval; no periodic checkpoints); the card's first OPTIM_UPDATES
    updates against the CPU's; sophia's ValueError."""
    import copy

    from mri_raytracer_tpu_torch.config import ModelConfig, OptimConfig
    from mri_raytracer_tpu_torch.io import native
    from mri_raytracer_tpu_torch.models.api import build_model
    from mri_raytracer_tpu_torch.ops import composite, warp
    from mri_raytracer_tpu_torch.train import engine, optimizers

    tmp, data = cases
    t_phase = time.perf_counter()
    composite.composite_planes.launches = warp.warp_screen.launches = 0
    loaded = {}

    def load_once(fn):
        def call(*a, **kw):
            if "caches" not in loaded:
                t = time.perf_counter()
                loaded["caches"] = fn(*a, **kw)
                loaded["s"] = time.perf_counter() - t
            return loaded["caches"]

        return call

    for name in OPTIMS:
        cfg = train_config(tmp, data, f"optim_{name}")
        cfg.optim.optimizer = name
        cfg.checkpoint_every = 0
        marks, losses = {}, {}

        def hook(step, args):
            i = args[5]
            if i > OPTIM_STEPS:
                raise _Stop
            m = step(*args)
            if i % cfg.log_every == 0 or i == 1:
                losses[i] = m.loss
            if i in (OPTIM_SKIP, OPTIM_STEPS):
                marks[i] = torch.cuda.Event(enable_timing=True)
                marks[i].record()
            return m

        t0 = time.perf_counter()
        with patched(engine.cache_mod, "build_train_val_caches", load_once), \
                step_hook(hook):
            try:
                engine.train_inr(cfg)
            except _Stop:
                pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ms = marks[OPTIM_SKIP].elapsed_time(marks[OPTIM_STEPS]) / (
            OPTIM_STEPS - OPTIM_SKIP)
        logged = {k: float(v) for k, v in sorted(losses.items())}
        first, last = logged[min(logged)], logged[max(logged)]
        log("optim", f"{name}: {OPTIM_STEPS} steps of TrainConfig() "
            f"({cfg.model.kind} {cfg.model.hidden_dims}, global batch "
            f"{cfg.global_batch}), {ms:.4f} ms a step over steps "
            f"{OPTIM_SKIP + 1}-{OPTIM_STEPS} (CUDA events), loss step "
            f"{min(logged)} {first:.4g} -> step {max(logged)} {last:.4g} "
            f"({'fell' if last < first else 'did not fall'}), run wall "
            f"{wall:.1f} s, on {card}")
        if not all(np.isfinite(list(logged.values()))):
            raise RuntimeError(f"[optim] {name}: a logged loss is not "
                               "finite")
    log("optim", f"cache load {loaded['s']:.1f} s (RAMCache, native "
        f"loader {'on' if native.available() else 'off'}), once for the "
        "five runs")

    # The card's first updates against the CPU's, from the same weights
    # (the default INR) on the same seeded gradients and loss values.
    model = build_model(ModelConfig(), 4)
    init = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    shapes = [p.shape for p in init.parameters()]
    seq = [([rng.normal(0, 0.05, s).astype(np.float32) for s in shapes],
            np.float32(rng.uniform(0.5, 2.0))) for _ in range(OPTIM_UPDATES)]
    for name in OPTIMS:
        runs = {}
        for dev in ("cpu", "cuda"):
            params = copy.deepcopy(init).to(dev)
            opt = optimizers.build_optimizer(OptimConfig(optimizer=name),
                                             2000, params)
            for grads, value in seq:
                for p, g in zip(params.parameters(), grads):
                    p.grad = torch.from_numpy(g).to(dev)
                opt.step(value=torch.tensor(value, device=dev))
            runs[dev] = [p.detach().cpu() for p in params.parameters()]
        err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(runs["cuda"], runs["cpu"]))
        log("optim", f"{name}: card vs CPU after {OPTIM_UPDATES} updates: "
            f"max |diff| / max |value| {err:.3e} (bar {OPTIM_TOL})")
        if not err <= OPTIM_TOL:
            raise RuntimeError(f"[optim] {name}: the card's updates differ "
                               "from the CPU's")
    try:
        optimizers.build_optimizer(OptimConfig(optimizer="sophia"), 10,
                                   init)
        raise RuntimeError("[optim] sophia built")
    except ValueError as e:
        log("optim", f"sophia raises ValueError, as JAX's train step: {e}")
    k12 = kernel_launches(composite, warp)
    log("optim", f"K1, K2 launches {k12} (want (0, 0)); phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    if k12 != (0, 0):
        raise RuntimeError(f"[optim] K1/K2 launched {k12} times")


def unet_flops(base: int, in_ch: int, n_classes: int, H: int, W: int
               ) -> float:
    """Forward FLOPs of one image through ``UNet2D`` (2 per multiply-add
    of every convolution, transposed convolution and the head; pools,
    norms, ReLUs and concatenations left out)."""
    b = base
    convs = []  # (c_in, c_out, kernel area, output pixels)
    levels = [(in_ch, b, 1), (b, 2 * b, 2), (2 * b, 4 * b, 4),
              (4 * b, 8 * b, 8), (8 * b, 4 * b, 4), (4 * b, 2 * b, 2),
              (2 * b, b, 1)]
    for ci, co, s in levels:  # the DoubleConvs: d1 d2 d3 b c3 c2 c1
        px = (H // s) * (W // s)
        convs += [(ci, co, 9, px), (co, co, 9, px)]
    for ci, co, s in ((8 * b, 4 * b, 4), (4 * b, 2 * b, 2), (2 * b, b, 1)):
        convs.append((ci, co, 4, (H // s) * (W // s) // 4))  # u3 u2 u1
    convs.append((b, n_classes, 1, H * W))  # out
    return float(sum(2 * ci * co * k * px for ci, co, k, px in convs))


def _zscore_like_the_library(arr):
    """runtime/mri_io.cpp's z-score in NumPy: sums in double, in order;
    mean and std rounded to float32."""
    v = arr[arr != 0].astype(np.float64)
    if v.size == 0:
        return arr
    mu = np.cumsum(v)[-1] / v.size
    var = np.cumsum(v * v)[-1] / v.size - mu * mu
    sigma = np.float32(np.sqrt(max(var, 0.0))) + np.float32(1e-6)
    return (arr - np.float32(mu)) / sigma


def unet_phase(torch, card: str, cases) -> None:
    """Phase 11b: the native loader, the U-Net baseline (``train_unet``)
    on [train]'s cases, the trained U-Net distilled into an implicit MLP,
    and the nnU-Net dataset conversion."""
    import copy

    from mri_raytracer_tpu_torch import convert
    from mri_raytracer_tpu_torch.data import brats, cache as cache_mod, nifti
    from mri_raytracer_tpu_torch.data import slices
    from mri_raytracer_tpu_torch.io import checkpoint as ckpt
    from mri_raytracer_tpu_torch.io import native
    from mri_raytracer_tpu_torch.models import unet
    from mri_raytracer_tpu_torch.ops import composite, warp
    from mri_raytracer_tpu_torch.train import nnunet, unet_trainer

    tmp, data = cases
    t_phase = time.perf_counter()
    composite.composite_planes.launches = warp.warp_screen.launches = 0

    # The native loader, built from runtime/mri_io.cpp.
    info = native.build_info()
    if info["available"]:
        log("unet", f"native: {'built' if info['built'] else 'loaded'} in "
            f"{info['seconds']:.2f} s ({info['path']})")
    else:
        log("unet", f"native: unavailable ({info['error']})")
    train_cases, val_cases = cache_mod.kfold_split(
        brats.find_cases(data), TRAIN_CASES, 0, 0)
    t0 = time.perf_counter()
    train_cache = cache_mod.RAMCache(train_cases, verbose=False,
                                     use_native=True)
    val_cache = cache_mod.RAMCache(val_cases, verbose=False, use_native=True)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = brats.load_case_dict(val_cases[0])
    t_py = time.perf_counter() - t0
    got = val_cache.get(0)
    seg_ok = np.array_equal(got["seg"], py["seg"])
    base = pathlib.Path(val_cases[0]).name
    raw = [nifti.load(pathlib.Path(val_cases[0]) / f"{base}-{m}.nii.gz")
           .data.astype(np.float32) for m in brats.MODALITY_SUFFIXES]
    if info["available"]:
        mods_ok = all(np.array_equal(a, _zscore_like_the_library(r))
                      for a, r in zip(got["mods"], raw))
    else:
        mods_ok = np.array_equal(got["mods"], py["mods"])
    dz = float(np.abs(got["mods"] - py["mods"]).max())
    log("unet", f"RAMCache(use_native=True): {TRAIN_CASES} cases in "
        f"{t_nat:.2f} s wall; the Python loader {t_py:.2f} s for one; case "
        f"{got['name']}: seg bit-equal to the Python loader's {seg_ok}, "
        f"modalities bit-equal to "
        f"{'the library z-score in NumPy' if info['available'] else 'it'}"
        f" {mods_ok}, max |diff| to zscore_nonzero {dz:.3e} (<= 1e-4)")
    if not (seg_ok and mods_ok and dz <= 1e-4):
        raise RuntimeError("[unet] the native loader differs")

    # The U-Net baseline, each step timed by CUDA events.
    live, events, snaps = {}, [], {}

    def timed_step(make):
        def build(model, optimizer, num_classes=4):
            live["model"] = model
            live["init"] = copy.deepcopy(model.state_dict())
            step = make(model, optimizer, num_classes)

            def run(imgs, labels):
                live["args"] = (imgs, labels)
                out = step(imgs, labels)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
                return out

            live["step"] = step
            return run

        return build

    def snap_best(save):
        def call(tree, path, info=None):
            snaps["best"] = copy.deepcopy(live["model"].state_dict())
            return save(tree, path, info)

        return call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with patched(unet_trainer, "make_train_step", timed_step), \
            patched(unet_trainer.ckpt, "save_object", snap_best):
        out = unet_trainer.train_unet(
            train_cache, val_cache, epochs=UNET_EPOCHS,
            batch_size=UNET_BATCH, lr=UNET_LR, base=UNET_BASE,
            out_dir=str(tmp / "unet"), verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model, hist = out["model"], out["history"]
    idx = slices.build_slice_index(train_cache, seed=0)
    val_idx = slices.build_slice_index(val_cache, seed=0)
    n_steps = len(events)
    per = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    ms = float(np.median(per[UNET_SKIP:]))
    H, W = TRAIN_SHAPE[:2]
    gflop = 3 * UNET_BATCH * unet_flops(UNET_BASE, 4, 4, H, W) / 1e9
    log("unet", f"train_unet(base={UNET_BASE}, batch_size={UNET_BATCH}, "
        f"epochs={UNET_EPOCHS}, lr={UNET_LR}): {len(idx)} training slices "
        f"of {len(train_cases)} cases ({len(val_idx)} validation), "
        f"{n_steps} steps, wall {wall:.1f} s; float32 convolutions")
    log("unet", f"ms a step (CUDA events, median over steps "
        f"{UNET_SKIP + 2}-{n_steps}): {ms:.4f} (mean "
        f"{float(np.mean(per[UNET_SKIP:])):.4f}, min "
        f"{min(per[UNET_SKIP:]):.4f}, max {max(per[UNET_SKIP:]):.4f}); "
        f"{UNET_BATCH / ms * 1e3:.1f} images/s; {gflop:.1f} GFLOP a step "
        f"(3 x forward {gflop / 3 / UNET_BATCH:.2f} GFLOP an image), "
        f"{gflop / ms:.2f} TFLOP/s; peak device memory "
        f"{(peak - held) / 2**20:.1f} MiB for training, on {card}")
    losses = [h["loss"] for h in hist]
    dices = [h["val_dice"] for h in hist]
    model0 = unet.UNet2D(4, 4, UNET_BASE).cuda()
    model0.load_state_dict(live["init"])
    dice0 = unet_trainer.val_dice(model0, val_cache, val_idx, UNET_BATCH,
                                  "cuda")
    log("unet", f"epoch losses {['%.4f' % v for v in losses]}, val Dice "
        f"{['%.4f' % v for v in dices]} (initial weights {dice0:.4f}), best "
        f"epoch {out['best']['epoch']}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise RuntimeError("[unet] the loss did not fall")
    if not out["best"]["val_dice"] > dice0:
        raise RuntimeError("[unet] val Dice did not beat the initial "
                           "weights'")

    # unet_best.npz back into the port: the best epoch's weights, bit for
    # bit; the trained weights on the card against the CPU.
    imgs, labels = next(slices.slice_batches(val_cache, val_idx, UNET_BATCH,
                                             seed=0, epochs=1))
    x = torch.from_numpy(imgs)
    best = unet.UNet2D(4, 4, UNET_BASE).cuda()
    best.load_state_dict(snaps["best"])
    back = unet.UNet2D(4, 4, UNET_BASE).cuda()
    back.load_state_dict(convert.unet_from_flax(
        ckpt.load_params(tmp / "unet" / "unet_best.npz")))
    with unet_trainer.fp32_convs():
        same = torch.equal(unet.unet_apply(best, x.cuda()),
                           unet.unet_apply(back, x.cuda()))
        on_card = unet.unet_apply(model, x.cuda()).cpu()
    on_cpu = unet.unet_apply(copy.deepcopy(model).cpu(), x)
    err = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    log("unet", f"unet_best.npz reloads with bit-equal logits: {same}; "
        f"trained logits on a {tuple(x.shape)} batch, card vs CPU: max "
        f"|diff| / max |logit| {err:.3e} (bar {UNET_CPU_TOL}, float32 "
        "convolutions)")
    if not same:
        raise RuntimeError("[unet] unet_best.npz does not reload")
    if not err <= UNET_CPU_TOL:
        raise RuntimeError("[unet] the card's logits differ from the CPU's")

    # The trained U-Net's label volume of the validation case, distilled.
    case = val_cache.get(0)
    vol = np.moveaxis(case["mods"], 0, -1)  # (H, W, D, M)
    preds = []
    for z0 in range(0, vol.shape[2], UNET_BATCH):
        batch = np.ascontiguousarray(np.moveaxis(
            vol[:, :, z0:z0 + UNET_BATCH], 2, 0))
        preds.append(unet_trainer.predict_slices(
            model, torch.from_numpy(batch).cuda()).cpu().numpy())
    teacher = np.moveaxis(np.concatenate(preds), 0, -1).astype(np.int16)
    t0 = time.perf_counter()
    dist = unet_trainer.distill_to_implicit(teacher)
    torch.cuda.synchronize()
    t_dist = time.perf_counter() - t0
    coords, lab = unet_trainer.collect_voxels(teacher, 512, 1)
    with torch.no_grad():
        logits = dist["model"].apply(dist["params"],
                                     torch.from_numpy(coords).cuda(), None)
    acc = float((logits.argmax(-1).cpu().numpy() == lab).mean())
    lh = dist["loss_history"]
    log("unet", f"distill_to_implicit on the U-Net's {teacher.shape} label "
        f"volume (classes {np.bincount(teacher.ravel(), minlength=4).tolist()}"
        f"): 500 steps of 4,096 in {t_dist:.1f} s, loss {lh[0]:.4f} -> "
        f"{lh[-1]:.4f}, accuracy {acc:.4f} (> {DISTILL_ACC})")
    if not (lh[-1] < lh[0] and acc > DISTILL_ACC):
        raise RuntimeError("[unet] distillation did not learn")

    # A few steps of the trainer's own step under the profiler (after the
    # distillation: they train the model further).
    step, args = live["step"], live["args"]
    with unet_trainer.fp32_convs():
        by_name = device_activity(torch, lambda: step(*args),
                                  UNET_PROFILE_STEPS)
    if not by_name:
        log("unet", "profile: device time not measured: the profiler saw "
            "no device activity")
    else:
        busy = sum(us for _, us in by_name.values()) / 1e3 / UNET_PROFILE_STEPS
        ops = sum(n for n, _ in by_name.values()) / UNET_PROFILE_STEPS
        log("unet", f"profile per step over {UNET_PROFILE_STEPS} steps: "
            f"{ops:.1f} device operations, device busy {busy:.4f} ms; idle "
            f"share of the {ms:.4f} ms step {1.0 - busy / ms:.3f}, on {card}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        for name, (n, us) in top:
            log("unet", f"profile {us / 1e3 / UNET_PROFILE_STEPS:8.4f} "
                f"ms/step {n / UNET_PROFILE_STEPS:5.1f}x  {name[:90]}")

    # nnU-Net's raw layout of the five cases.
    t0 = time.perf_counter()
    env = nnunet.setup_nnunet_env(tmp / "nnunet")
    ds = nnunet.prepare_brats_dataset(brats.find_cases(data),
                                      env["nnUNet_raw"])
    imgs_tr = sorted((ds / "imagesTr").iterdir())
    labs = set()
    for p in (ds / "labelsTr").iterdir():
        labs |= set(np.unique(nifti.load(p).data).tolist())
    meta = json.loads((ds / "dataset.json").read_text())
    ok = (len(imgs_tr) == 4 * TRAIN_CASES
          and all(p.is_symlink() for p in imgs_tr)
          and labs <= {0, 1, 2, 3} and meta["numTraining"] == TRAIN_CASES)
    log("unet", f"prepare_brats_dataset: {len(imgs_tr)} image links, labels "
        f"{sorted(labs)}, numTraining {meta['numTraining']}, "
        f"{time.perf_counter() - t0:.1f} s; nnunetv2 installed: "
        f"{nnunet.has_nnunet()}")
    if not ok:
        raise RuntimeError("[unet] the nnU-Net conversion is wrong")
    k12 = kernel_launches(composite, warp)
    log("unet", f"K1, K2 launches {k12} (want (0, 0)); phase wall "
        f"{time.perf_counter() - t_phase:.1f} s, on {card}")
    if k12 != (0, 0):
        raise RuntimeError(f"[unet] K1/K2 launched {k12} times")


def parallel_phase(torch, card: str, cases=None, train_cache=None,
                   mods=None, seg=None) -> None:
    """Phase 11c: the parallel modules on a world-size-1 NCCL process group
    (file rendezvous), so that every collective is an NCCL launch. The DP
    step at ``TrainConfig()`` on [train]'s loaded train cases against the
    plain step from the same key, PAR_STEPS steps in turns (metrics and
    params <= PAR_TOL), ms a step of each; the stripe renderer on the bench
    frame at the six poses against the unsharded scan frame (<= PAR_TOL,
    one K2 launch a frame), ms a frame; the slab renderer at the start
    pose against the one-rank term_gate=False composite (<= PAR_TOL).
    Alone, without [train]'s cases and cache or the bench volume
    (display-normalized modalities and labels), it makes its own."""
    import copy
    import datetime

    import torch.distributed as dist

    from mri_raytracer_tpu_torch.data import pool as pool_mod
    from mri_raytracer_tpu_torch.data import sampling
    from mri_raytracer_tpu_torch.models.api import build_model
    from mri_raytracer_tpu_torch.ops import shearwarp as sw
    from mri_raytracer_tpu_torch.ops import warp
    from mri_raytracer_tpu_torch.parallel import mesh as mesh_mod
    from mri_raytracer_tpu_torch.parallel import render as prender
    from mri_raytracer_tpu_torch.parallel import training as ptrain
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.train import optimizers, steps

    if cases is None:
        with training_cases(card) as cases:
            return parallel_phase(torch, card, cases, train_cache, mods, seg)
    tmp, data = cases
    if train_cache is None:
        from mri_raytracer_tpu_torch.data import cache as cache_mod

        c = train_config(tmp, data, "parallel").data
        train_cache = cache_mod.build_train_val_caches(
            c.data_root, c.case_limit, c.num_folds, c.fold_index, c.seed,
            cache_kind="ram", verbose=False)[0]
    if mods is None:
        from mri_raytracer_tpu_torch.data.brats import percentile_normalize
        from mri_raytracer_tpu_torch.data.synthetic import synthetic_case

        raw, seg = synthetic_case(VOL, seed=0)
        mods = np.stack([percentile_normalize(m) for m in raw])
        seg = seg.astype(np.int32)
    t_phase = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=mesh_mod.rendezvous_url(str(tmp / "pg_store")),
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = mesh_mod.make_mesh(1, 1)
        backends = {a: dist.get_backend(mesh.axis(a).group)
                    for a in ("data", "space")}
        log("parallel", f"process group: world 1, backend "
            f"{dist.get_backend()}, mesh {mesh.shape}, axis groups "
            f"{backends}, on {card}")
        if set(backends.values()) != {"nccl"}:
            raise RuntimeError(f"the mesh's groups are not NCCL: {backends}")

        # --- The DP step against the plain step, in turns.
        cfg = train_config(tmp, data, "parallel")
        dc = cfg.data
        model = build_model(cfg.model, train_cache.n_modalities,
                            rff_seed=dc.seed)
        p_dp = model.init(torch.Generator().manual_seed(dc.seed)).cuda()
        p_plain = copy.deepcopy(p_dp)
        pool = pool_mod.DevicePool(
            train_cache, dc.pool_size, seed=dc.seed,
            with_boundary=cfg.loss.boundary_weight > 0.0)
        sampler = sampling.make_sampler(dc.sampler, cfg.micro_batch,
                                        dc.tumor_ratio,
                                        dc.min_subclass_samples, model=model)
        noise = steps.make_coord_noise_schedule(
            cfg.optim.coord_noise_sigma_start,
            cfg.optim.coord_noise_sigma_end, cfg.train_steps)
        accum = -(-cfg.global_batch // cfg.micro_batch)
        o_dp = optimizers.build_optimizer(cfg.optim, cfg.train_steps, p_dp)
        o_plain = optimizers.build_optimizer(cfg.optim, cfg.train_steps,
                                             p_plain)
        dp_step = ptrain.build_dp_train_step(model, cfg.loss, o_dp, sampler,
                                             accum, 1, noise, mesh)
        plain_step = steps.build_train_step(model, cfg.loss, o_plain,
                                            sampler, accum, noise)
        k_dp = torch.Generator().manual_seed(dc.seed)
        k_plain = torch.Generator().manual_seed(dc.seed)
        pools = (pool.mods, pool.segs)
        ev = {"dp": [], "plain": []}
        m_err = 0.0
        for s in range(1, PAR_STEPS + 1):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            marks[0].record()
            m_dp = dp_step(p_dp, o_dp, k_dp, *pools, s, pool.boundary)
            marks[1].record()
            # The plain step with the rank generator the DP step seeds.
            g = torch.Generator(device="cuda").manual_seed(
                ptrain.shard_seed(k_plain, 0))
            marks[2].record()
            m_plain = plain_step(p_plain, o_plain, g, *pools, s,
                                 pool.boundary)
            marks[3].record()
            ev["dp"].append(marks[:2])
            ev["plain"].append(marks[2:])
            m_err = max([m_err] + [float((a - b).abs().max())
                                   for a, b in zip(m_dp, m_plain)])
        torch.cuda.synchronize()
        with torch.no_grad():
            p_err = max(float((a - b).abs().max()) for a, b in
                        zip(p_dp.parameters(), p_plain.parameters()))
            moved = max(float((a - b).abs().max()) for a, b in zip(
                p_dp.parameters(), model.init(torch.Generator().manual_seed(
                    dc.seed)).cuda().parameters()))
        ms = {k: float(np.median([a.elapsed_time(b) for a, b in
                                  v[PAR_SKIP:]])) for k, v in ev.items()}
        log("parallel", f"DP step (data_parallel=1) vs plain step, "
            f"{PAR_STEPS} steps in turns at TrainConfig() "
            f"({cfg.model.hidden_dims}, global batch {cfg.global_batch} = "
            f"{accum} x {cfg.micro_batch}) on {train_cache.n_cases} train "
            f"cases: max|metrics| diff {m_err:.3e}, max|params| diff "
            f"{p_err:.3e} (bound {PAR_TOL}), params moved {moved:.3e}; "
            f"last loss {float(m_dp.loss):.4f}, on {card}")
        log("parallel", f"ms a step, median after step {PAR_SKIP} (CUDA "
            f"events): DP {ms['dp']:.4f}, plain {ms['plain']:.4f}, "
            f"DP - plain {ms['dp'] - ms['plain']:+.4f}, on {card}")
        if not (m_err <= PAR_TOL and p_err <= PAR_TOL and moved > 1e-3
                and np.isfinite(float(m_dp.loss))):
            raise RuntimeError("the DP step differs from the plain step")
        # The all-reduce goes through NCCL: its host-side record in a
        # profile of 3 DP steps. (NCCL launches no kernel for an in-place
        # all-reduce over one rank; its device kernels, if any, print.)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                dp_step(p_dp, o_dp, k_dp, *pools, PAR_STEPS, pool.boundary)
            torch.cuda.synchronize()
        calls, kern = {}, {}
        for e in prof.events():
            if "nccl" in e.name.lower():
                d = kern if e.device_type == DeviceType.CUDA else calls
                d[e.name] = d.get(e.name, 0) + 1
        log("parallel", f"profile of 3 DP steps: NCCL calls {calls}, NCCL "
            f"device kernels {kern or 'none'}, on {card}")
        if not any("all_reduce" in n for n in calls):
            raise RuntimeError("the DP step made no NCCL all-reduce")
        del pool, p_dp, p_plain, o_dp, o_plain

        # --- The stripe renderer on the bench frame at the six poses.
        p = rp.default_render_params(VOL, show_seg=True, show_pred=False)
        radius = rp.default_camera_radius(p, VOL)
        mods_d = torch.as_tensor(mods, device="cuda")
        seg_d = torch.as_tensor(seg, device="cuda")
        stripe = prender.build_sharded_renderer(mesh, VOL, WIDTH, HEIGHT,
                                                has_seg=True)
        bases = [OrbitalCamera(radius=radius, theta=th, phi=ph).basis()
                 for _, th, ph in POSES]
        stripe(mods_d, seg_d, None, bases[0], p)  # warm-up
        # In turns, pose by pose: the stripe frame (its K2 launches counted
        # from 0 around it), then the unsharded scan frame.
        imgs, walls, refs, ref_walls, k2 = [], [], [], [], 0
        for b in bases:
            torch.cuda.synchronize()
            warp.warp_screen.launches = 0
            t0 = time.perf_counter()
            imgs.append(stripe(mods_d, seg_d, None, b, p))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            k2 += warp.warp_screen.launches
            t0 = time.perf_counter()
            refs.append(sw.render_brats(mods_d, seg_d, None, b, p, WIDTH,
                                        HEIGHT, composite="scan"))
            torch.cuda.synchronize()
            ref_walls.append((time.perf_counter() - t0) * 1e3)
        errs = [float((a - b).abs().max()) for a, b in zip(imgs, refs)]
        log("parallel", f"stripe renderer, {VOL} at {WIDTH}x{HEIGHT} + seg, "
            f"six poses: max|stripe - unsharded scan| per pose "
            + ", ".join(f"{n} {e:.3e}" for (n, _, _), e in zip(POSES, errs))
            + f" (bound {PAR_TOL}); K2 launches {k2} for {len(bases)} "
            f"frames, on {card}")
        log("parallel", f"ms a frame (host clock, synced, in turns): "
            f"stripe median {np.median(walls):.1f} (min {min(walls):.1f}, "
            f"max {max(walls):.1f}), unsharded scan median "
            f"{np.median(ref_walls):.1f}; stripe - unsharded per pose "
            + ", ".join(f"{a - b:+.1f}" for a, b in zip(walls, ref_walls))
            + f", on {card}")
        if not (max(errs) <= PAR_TOL and k2 == len(bases) and all(
                bool(torch.isfinite(i).all()) for i in imgs)):
            raise RuntimeError("the stripe renderer failed")
        by_name = device_activity(
            torch, lambda: stripe(mods_d, seg_d, None, bases[0], p), 1,
            warm=False)
        if not by_name:
            log("parallel", "profile of a stripe frame: device time not "
                "measured: the profiler saw no device activity")
        else:
            busy = sum(us for _, us in by_name.values()) / 1e3
            frame = float(np.median(walls))
            log("parallel", f"profile of a stripe frame at pose "
                f"{POSES[0][0]}: {sum(n for n, _ in by_name.values())} "
                f"device operations, device busy {busy:.1f} ms; idle share "
                f"of the {frame:.1f} ms frame {1.0 - busy / frame:.3f}, on "
                f"{card}")
            top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
            for name, (n, us) in top:
                log("parallel", f"profile {us / 1e3:8.3f} ms {n:5d}x  "
                    f"{name[:90]}")
        del imgs, refs

        # --- The slab renderer at the start pose.
        basis = bases[0].to("cuda")
        axis = sw.dominant_axis(basis)
        mixed_s, seg_s, _ = sw.prepare_sweep_volumes(
            mods_d, seg_d, None, p.to("cuda"), axis)
        slab = prender.build_volume_sharded_renderer(
            mesh, VOL, WIDTH, HEIGHT, axis, has_seg=True)
        place = mesh_mod.space_sharded(mesh, 0)
        torch.cuda.synchronize()
        warp.warp_screen.launches = 0
        t0 = time.perf_counter()
        img = slab(place.local(mixed_s), place.local(seg_s), basis, p)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        k2 = warp.warp_screen.launches
        pd = p.to("cuda")
        use_gamma, use_clip = sw.static_flags(pd)
        geom = sw.sweep_geometry(basis, pd, tuple(mixed_s.shape), axis,
                                 WIDTH, frustum_wh=(WIDTH, HEIGHT))
        C, _ = sw.sweep_composite(mixed_s, seg_s, None, geom, pd, axis,
                                  WIDTH, 1, use_gamma, use_clip,
                                  term_gate=False)
        ref = sw.warp_to_screen(C, geom, basis, axis, WIDTH, HEIGHT,
                                pd.bg_color)
        err = float((img - ref).abs().max())
        log("parallel", f"slab renderer at pose {POSES[0][0]} (axis "
            f"{axis}, one slab of {mixed_s.shape[0]}): max|slab - one-rank "
            f"term_gate=False composite| {err:.3e} (bound {PAR_TOL}); K2 "
            f"launches {k2}; {wall:.1f} ms (host clock, synced), on {card}")
        if not (err <= PAR_TOL and k2 == 1
                and bool(torch.isfinite(img).all())):
            raise RuntimeError("the slab renderer failed")
    finally:
        dist.destroy_process_group()
    log("parallel", f"phase {time.perf_counter() - t_phase:.1f} s wall, on "
        f"{card}")


def _plain_composite(torch, colors, alphas):
    """composite_fronttoback's forward in plain autograd ops."""
    T_excl = torch.cat([torch.ones_like(alphas[..., :1]),
                        torch.cumprod(1.0 - alphas, dim=-1)[..., :-1]], -1)
    C = torch.sum((T_excl * alphas)[..., None] * colors, dim=-2)
    return C, torch.prod(1.0 - alphas, dim=-1)


def _sphere_root(torch, params, o, d):
    """The entering root of |o + t d - c| = r in closed form."""
    c, r = params
    oc = o - c
    a = torch.sum(d * d, -1)
    b = torch.sum(d * oc, -1)
    cc = torch.sum(oc * oc, -1) - r * r
    return (-b - torch.sqrt(b * b - a * cc)) / a


def _grads(torch, fn, inputs):
    """Gradients of ``fn(*inputs)`` (a scalar) w.r.t. copies of inputs."""
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    fn(*xs).backward()
    return [x.grad for x in xs]


def _max_rel(torch, got, want) -> float:
    return max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in zip(got, want))


def autograd_checks(torch, card: str) -> None:
    """Each autograd.Function against autograd through its plain forward,
    on the card in float64."""
    from mri_raytracer_tpu_torch.ops import diffrender, isosurface, trilinear

    dev, f64 = torch.device("cuda"), torch.float64
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.rand(shape, generator=g, device=dev,
                                    dtype=f64)
    # trilinear_sample: grid and points (inside, and outside the clamp).
    vol = rnd(9, 8, 7)
    pts = rnd(4096, 3) * torch.tensor([10.0, 9.0, 8.0], device=dev,
                                      dtype=f64) - 0.5
    w = rnd(4096)
    want = _grads(torch, lambda v, x: (trilinear.trilinear_sample_base(v, x)
                                       * w).sum(), (vol, pts))
    got = _grads(torch, lambda v, x: (trilinear.trilinear_sample(v, x)
                                      * w).sum(), (vol, pts))
    e_tri = _max_rel(torch, got, want)
    # composite_fronttoback: colors, alphas and the T_final cotangent.
    colors, alphas = rnd(256, 48, 3), rnd(256, 48) * 0.9
    loss = lambda C, T: (C ** 2).sum() + (T ** 3).sum()
    want = _grads(torch, lambda c, a: loss(*_plain_composite(torch, c, a)),
                  (colors, alphas))
    got = _grads(torch, lambda c, a: loss(*diffrender.composite_fronttoback(
        c, a)), (colors, alphas))
    e_comp = _max_rel(torch, got, want)
    # isosurface_intersect: a sphere's entering root, params (centre and
    # radius), origins and directions, against the closed-form root.
    n = 512
    o = torch.stack([torch.full((n,), -2.0, device=dev, dtype=f64),
                     rnd(n) * 0.4 - 0.2, rnd(n) * 0.4 - 0.2], -1)
    d = torch.stack([torch.ones(n, device=dev, dtype=f64),
                     rnd(n) * 0.1 - 0.05, rnd(n) * 0.1 - 0.05], -1)
    c = torch.tensor([0.1, 0.0, 0.05], device=dev, dtype=f64)
    r = torch.tensor(0.5, device=dev, dtype=f64)
    wt = rnd(n)
    t_lo = torch.full((n,), 0.1, device=dev, dtype=f64)
    t_hi = torch.full((n,), 4.0, device=dev, dtype=f64)
    field = lambda p, x: p[1] - torch.linalg.vector_norm(x - p[0], dim=-1)
    want = _grads(torch, lambda c_, r_, o_, d_: (_sphere_root(
        torch, (c_, r_), o_, d_) * wt).sum(), (c, r, o, d))
    iso = isosurface.isosurface_intersect
    t_star, hit = iso(field, 0.0, 64, (c, r), o, d, t_lo, t_hi)
    got = _grads(torch, lambda c_, r_, o_, d_: (iso(
        field, 0.0, 64, (c_, r_), o_, d_, t_lo, t_hi)[0] * wt).sum(),
        (c, r, o, d))
    e_root = float((t_star - _sphere_root(torch, (c, r), o, d)).abs().max())
    e_iso = _max_rel(torch, got, want)
    log("fit", f"autograd.Functions vs autograd through the plain forward "
        f"(float64, on {card}): trilinear_sample grid + points max rel err "
        f"{e_tri:.2e}; composite_fronttoback colors + alphas (with G_T) "
        f"{e_comp:.2e}; isosurface_intersect ({int(hit.sum())} of {n} rays "
        f"hit, root err {e_root:.2e}) params + origins + dirs {e_iso:.2e}")
    if not (bool(hit.all()) and e_tri < 1e-9 and e_comp < 1e-9
            and e_iso < 1e-6):
        raise RuntimeError("an autograd.Function disagrees with autograd")


def shearwarp_grad_checks(torch, card: str) -> None:
    """At tests/test_diff_shearwarp.py's scene on the card: 'scan_remat'
    against the unchecked sweep + gather warp, a directional finite
    difference, and K1 / K2 refusing grad."""
    from mri_raytracer_tpu_torch.data.brats import percentile_normalize
    from mri_raytracer_tpu_torch.data.synthetic import synthetic_case
    from mri_raytracer_tpu_torch.ops import composite, shearwarp as sw, warp
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera

    dev = torch.device("cuda")
    mods, _ = synthetic_case(GRAD_SHAPE, seed=2)
    disp = torch.as_tensor(np.stack([percentile_normalize(m) for m in mods]),
                           device=dev)
    p = rp.default_render_params(GRAD_SHAPE, show_seg=False, device=dev)
    basis = OrbitalCamera(radius=rp.default_camera_radius(p, GRAD_SHAPE),
                          theta=0.5, phi=1.2).basis(dev)
    probe = torch.cos(torch.arange(48.0, device=dev))[None, :]
    axis = sw.dominant_axis(basis)

    def remat_loss(m):
        img = sw.render_brats(m, None, None, basis, p, 48, 48, out_res=64,
                              composite="scan_remat", device=dev)
        return (img[..., 0] * probe).sum()

    def unchecked_loss(m):
        vols = sw.prepare_sweep_volumes(m, None, None, p, axis)
        geom = sw.content_geometry(basis, p, tuple(vols[0].shape), axis, 64,
                                   48, 48)
        use_gamma, use_clip = sw.static_flags(p)
        C, _ = sw.sweep_composite(*vols, geom, p, axis, 64, 1, use_gamma,
                                  use_clip)
        img = sw.warp_to_screen(C, geom, basis, axis, 48, 48, p.bg_color,
                                gather=True)
        return (img[..., 0] * probe).sum()

    (g_r,) = _grads(torch, remat_loss, (disp,))
    (g_u,) = _grads(torch, unchecked_loss, (disp,))
    err = float((g_r - g_u).abs().max())
    ok_eq = bool(torch.allclose(g_r, g_u, rtol=GRAD_RTOL, atol=GRAD_ATOL))
    live = float((g_r.abs() > 0).float().mean())
    dirn = g_r / torch.linalg.vector_norm(g_r)
    eps = 0.3
    with torch.no_grad():
        fd = (float(remat_loss(disp + eps * dirn))
              - float(remat_loss(disp - eps * dirn))) / (2 * eps)
    an = float((g_r * dirn).sum())
    rel = abs(fd - an) / max(abs(an), 1e-9)
    log("fit", f"shear-warp gradient at {GRAD_SHAPE}, 48^2, out_res 64 (on "
        f"{card}): scan_remat vs the unchecked sweep + gather warp max abs "
        f"err {err:.3e} (rtol {GRAD_RTOL}, atol {GRAD_ATOL}: {ok_eq}), "
        f"{live:.3f} of voxels live; directional FD {fd:.6f} vs analytic "
        f"{an:.6f}: rel {rel:.4f} (<= {FD_TOL})")
    if not (ok_eq and live > 0.1 and rel <= FD_TOL):
        raise RuntimeError("the shear-warp gradient check failed")

    m = disp.clone().requires_grad_(True)
    refused = []
    for comp, what in (("scan", "warp_screen (kernel K2)"),
                       ("fused", "composite_planes (kernel K1)")):
        try:
            sw.render_brats(m, None, None, basis, p, 48, 48, out_res=64,
                            composite=comp, device=dev)
        except RuntimeError as e:
            refused.append(what in str(e) and "no backward" in str(e))
        else:
            refused.append(False)
    with torch.no_grad():
        k1, k2 = composite.composite_planes.launches, warp.warp_screen.launches
        img = sw.render_brats(m, None, None, basis, p, 48, 48, out_res=64,
                              composite="fused", device=dev)
        ran = (composite.composite_planes.launches - k1,
               warp.warp_screen.launches - k2)
    log("fit", f"with grad enabled and the volume requiring grad, 'scan' "
        f"(K2) and 'fused' (K1) refuse: {refused}; under no_grad 'fused' "
        f"renders (K1, K2 launches {ran})")
    if not (all(refused) and ran == (1, 1)
            and bool(torch.isfinite(img).all())):
        raise RuntimeError("K1 / K2 did not refuse grad")


def _step_timer(torch, steps: dict):
    """A wrap for a fit's step builder: a CUDA event after every step, and
    the step with its last arguments kept for profiling."""
    def wrap(build):
        def built(*a, **kw):
            step = build(*a, **kw)

            def timed(*args):
                out = step(*args)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                steps["events"].append(ev)
                steps["last"] = (step, args)
                return out

            return timed

        return built

    return wrap


def _fit_report(torch, name: str, rec: dict, steps: dict, peak: int,
                held: int, card: str) -> float:
    """Log a fit's numbers and check its gates; returns ms per step.
    ``peak``: the device memory allocated at most during the fit, of which
    ``held`` was held before it (earlier phases)."""
    ev = steps["events"]
    ms = [a.elapsed_time(b) for a, b in zip(ev[FIT_SKIP - 1:], ev[FIT_SKIP:])]
    med = float(np.median(ms))
    losses = rec["losses"]
    log("fit", f"{name}: {rec['n_params']} MLP params, {rec['steps']} steps; "
        f"wall: targets {rec['wall_s_targets']} s, fit {rec['wall_s_fit']} "
        f"s, evaluation {rec['wall_s_render']} s; ms per step over steps "
        f"{FIT_SKIP + 1}-{rec['steps']} (CUDA events): median {med:.3f}, "
        f"mean {float(np.mean(ms)):.3f}, min {min(ms):.3f}, max "
        f"{max(ms):.3f}; peak device memory {peak / 2**20:.1f} MiB, of "
        f"which {held / 2**20:.1f} MiB held before the fit: "
        f"{(peak - held) / 2**20:.1f} MiB for the fit, on {card}")
    step, args = steps["last"]
    by_name = device_activity(torch, lambda: step(*args), FIT_PROFILE_STEPS)
    if by_name:
        busy = sum(us for _, us in by_name.values()) / 1e3 / FIT_PROFILE_STEPS
        ops = sum(n for n, _ in by_name.values()) / FIT_PROFILE_STEPS
        log("fit", f"{name} profile per step over {FIT_PROFILE_STEPS} steps:"
            f" {ops:.1f} device operations, device busy {busy:.3f} ms; idle "
            f"share of the {med:.3f} ms step {1.0 - busy / med:.3f}, on "
            f"{card}")
        for op, (n, us) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][1])[:8]:
            log("fit", f"{name} profile {us / 1e3 / FIT_PROFILE_STEPS:9.4f} "
                f"ms/step {n / FIT_PROFILE_STEPS:8.1f}x  {op[:80]}")
    else:
        log("fit", f"{name} profile: device time not measured: the profiler "
            "saw no device activity")
    extra = (f", volume PSNR {rec['volume_psnr_db']:.2f} dB"
             if "volume_psnr_db" in rec else "")
    log("fit", f"{name}: loss {losses[0]:.4e} -> {losses[-1]:.4e} "
        f"({len(losses)} logged); PSNR train mean / min "
        f"{rec['psnr_train_mean']:.2f} / {rec['psnr_train_min']:.2f} dB, "
        f"held-out {rec['psnr_heldout_mean']:.2f} / "
        f"{rec['psnr_heldout_min']:.2f} dB{extra} (gate: means >= "
        f"{FIT_PSNR_MIN} dB, loss halves)")
    if not (all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0]
            and rec["psnr_train_mean"] >= FIT_PSNR_MIN
            and rec["psnr_heldout_mean"] >= FIT_PSNR_MIN):
        raise RuntimeError(f"{name} fit missed its gates")
    return med


def fit_kernel_checks(torch, baked, bases, p) -> tuple[float, float]:
    """K1a and K2 against their plain versions at the shear-warp fit's
    shapes (O = FIT_SW_OUT_RES, FIT_RES^2 frames) on the recovered
    volume's held-out views: each view's stage-1 inputs as 'fused' makes
    them, K2 on the plain intermediate. Max abs error <= TOL, and the
    background exactly wherever the plain pixel is off the intermediate.
    Returns the largest errors (K1a, K2)."""
    from mri_raytracer_tpu_torch.ops import composite, shearwarp as sw, warp

    dev = baked.device
    p = p.to(dev)
    flags = sw.static_flags(p)
    err_k1 = err_k2 = 0.0
    for b in bases:
        b = b.to(dev)
        axis = sw.dominant_axis(b)
        mixed_s, seg_s, pred_s = sw.prepare_sweep_volumes(baked, None, None,
                                                          p, axis)
        geom = sw.content_geometry(b, p, tuple(mixed_s.shape), axis,
                                   FIT_SW_OUT_RES, FIT_RES, FIT_RES)
        k1 = composite.stage1(mixed_s, seg_s, pred_s, geom, p, axis,
                              FIT_SW_OUT_RES)
        C_k, T_k = composite.composite_planes(*k1, *flags)
        torch.cuda.synchronize()
        plain = composite.composite_planes_plain(*k1, *flags)
        s = sw.warp_scalars(geom, b, p.bg_color)
        img = warp.warp_screen(plain.C, s, axis, FIT_RES, FIT_RES)
        torch.cuda.synchronize()
        ref = warp.warp_screen_plain(plain.C, s, axis, FIT_RES, FIT_RES)
        _, _, valid = warp.screen_maps(s, axis, FIT_SW_OUT_RES, FIT_RES,
                                       FIT_RES)
        e1 = max(float((C_k - plain.C).abs().max()),
                 float((T_k - plain.T).abs().max()))
        e2 = float((img - ref).abs().max())
        off_bg = bool((img[~valid] == s[21:24]).all())
        finite = all(bool(torch.isfinite(t).all()) for t in (C_k, T_k, img))
        log("fit", f"recovered volume, held-out view (axis {axis}, "
            f"K={k1.t1b.shape[0]}, O={FIT_SW_OUT_RES}, {FIT_RES}^2): K1a "
            f"max|kernel - plain| over C, T {e1:.3e}, K2 over the frame "
            f"{e2:.3e} (tolerance {TOL}); pixels off the intermediate "
            f"{'all' if off_bg else 'NOT all'} background")
        if not (e1 <= TOL and e2 <= TOL and off_bg and finite):
            raise RuntimeError("K1a / K2 disagree with their plain versions "
                               "at the fit's shapes")
        err_k1, err_k2 = max(err_k1, e1), max(err_k2, e2)
    return err_k1, err_k2


def kernel_launches(composite, warp) -> tuple[int, int]:
    return composite.composite_planes.launches, warp.warp_screen.launches


def fit_phase(torch, card: str) -> None:
    """Phase 12: differentiable rendering on the card and the two fits of
    an INR from rendered views at their documented configurations."""
    from mri_raytracer_tpu_torch.eval.metrics import psnr
    from mri_raytracer_tpu_torch.ops import composite, shearwarp as sw, warp
    from mri_raytracer_tpu_torch.render import params as rp
    from mri_raytracer_tpu_torch.train import fit_views as fv

    autograd_checks(torch, card)
    shearwarp_grad_checks(torch, card)
    dev = torch.device("cuda")
    quiet = lambda msg: None

    # The shear-warp fit (docs/FIT_FROM_VIEWS_shearwarp.md).
    steps = {"events": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    composite.composite_planes.launches = warp.warp_screen.launches = 0
    with patched(fv, "build_shearwarp_step", _step_timer(torch, steps)):
        rec = fv.run_shearwarp(shape=FIT_SHAPE, res=FIT_RES,
                               out_res=FIT_SW_OUT_RES,
                               n_train_views=FIT_VIEWS,
                               n_held_views=FIT_HELD, steps=FIT_SW_STEPS,
                               views_per_step=2, seed=0, log_fn=quiet,
                               device=dev)
    peak = torch.cuda.max_memory_allocated()
    ran = kernel_launches(composite, warp)
    want = (0, 2 * (FIT_VIEWS + FIT_HELD))
    log("fit", f"shear-warp fit: K1, K2 launches {ran} (K2 renders the "
        f"{FIT_VIEWS} + {FIT_HELD} targets and again the recovered views in "
        f"'scan'; the loss warps by the gather; want {want})")
    if ran != want:
        raise RuntimeError(f"shear-warp fit launches {ran} != {want}")

    # The recovered volume's held-out views through 'fused' (K1a + K2),
    # before the profile of _fit_report updates the params again.
    p = rp.default_render_params(FIT_SHAPE, show_seg=False)
    bases = fv.make_orbit_bases(
        FIT_HELD, radius=rp.default_camera_radius(p, FIT_SHAPE),
        phase=np.pi / FIT_VIEWS, phi=1.3)
    with torch.no_grad():
        baked = fv.bake_modalities(rec["_params"], FIT_SHAPE)
        torch.cuda.synchronize()
        composite.composite_planes.launches = warp.warp_screen.launches = 0
        kw = dict(out_res=FIT_SW_OUT_RES, device=dev)
        fused = [sw.render_brats(baked, None, None, b, p, FIT_RES, FIT_RES,
                                 composite="fused", **kw) for b in bases]
        torch.cuda.synchronize()
        k1, k2 = kernel_launches(composite, warp)
        scan = [sw.render_brats(baked, None, None, b, p, FIT_RES, FIT_RES,
                                composite="scan", **kw) for b in bases]
    q = [psnr(f.clamp(0, 1), s.clamp(0, 1)) for f, s in zip(fused, scan)]
    log("fit", f"recovered volume, {FIT_HELD} held-out views through "
        f"'fused': K1 launches {k1}, K2 launches {k2}; fused vs scan "
        + ", ".join(f"{v:.2f}" for v in q) + f" dB (>= {PSNR_MIN_DB})")
    if not (k1 == k2 == FIT_HELD and min(q) >= PSNR_MIN_DB):
        raise RuntimeError("the recovered volume's fused views failed")
    with torch.no_grad():
        composite.composite_planes.launches = warp.warp_screen.launches = 0
        fit_kernel_checks(torch, baked, bases, p)
    _fit_report(torch, "shear-warp fit", rec, steps, peak, held, card)
    del rec, baked, steps

    # The marcher fit (docs/FIT_FROM_VIEWS.md).
    steps = {"events": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    composite.composite_planes.launches = warp.warp_screen.launches = 0
    with patched(fv, "build_fit_step", _step_timer(torch, steps)):
        rec = fv.run(shape=FIT_SHAPE, res=FIT_RES, n_train_views=FIT_VIEWS,
                     n_held_views=FIT_HELD, steps=FIT_STEPS, seed=0,
                     log_fn=quiet, device=dev)
    peak = torch.cuda.max_memory_allocated()
    ran = kernel_launches(composite, warp)
    log("fit", f"marcher fit: K1, K2 launches {ran} (the marcher renders "
        "without the shear-warp kernels; want (0, 0))")
    if ran != (0, 0):
        raise RuntimeError(f"marcher fit launches {ran} != (0, 0)")
    _fit_report(torch, "marcher fit", rec, steps, peak, held, card)


def _roi_finite(sweep: dict) -> bool:
    """Every frame's metrics finite: a NaN or infinite pixel makes its
    frame's PSNR NaN or infinite."""
    return all(np.isfinite(q[m]) for k in ("baseline", "policy",
                                           "policy_fov", "policy_lod")
               for q in sweep.get(k, []) for m in ("psnr", "wpsnr", "ssim"))


def _roi_protocol(torch, card, scenes, pol, pol_lod, jres, jver, kw,
                  stride, ru, cache) -> None:
    """The [roi] sweeps, the foveated check, the LOD series and the frame
    profile."""
    from mri_raytracer_tpu_torch.eval import roi_protocol as rpt
    from mri_raytracer_tpu_torch.ops import composite, roi_policy, warp

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    composite.composite_planes.launches = warp.warp_screen.launches = 0
    failed = []
    for i, sc in enumerate(scenes):
        t1 = time.perf_counter()
        name = sc["name"]
        views = rpt.make_orbit_views(sc["radius"], ROI_QUALITY_FRAMES)
        sweep = rpt.pareto_sweep(pol, sc, views, ROI_BUDGETS,
                                 n_frames=ROI_TIMING_FRAMES, block=ROI_BLOCK,
                                 foveated=True,
                                 ref_cache=cache if i == 0 else None, **kw)
        v = rpt.evaluate_success(sweep, tuned_budget=ROI_TUNED)
        jv, js = jver[name], jres["scenes"][name]
        for b, q, f in zip(sweep["baseline"], sweep["policy"],
                           sweep["policy_fov"]):
            jf = next(r for r in js["policy_fov"] if r["n"] == f["n"])
            log("roi", f"{name} n={b['n']}: B1 {b['ms']:.3f} ms "
                f"{b['wpsnr']:.2f} dB; policy {q['ms']:.3f} ms "
                f"{q['wpsnr']:.2f} dB; foveated {f['ms']:.3f} ms "
                f"{f['wpsnr']:.2f} dB [{f['wpsnr_ci'][0]:.2f}, "
                f"{f['wpsnr_ci'][1]:.2f}], SSIM {f['ssim']:.5f}, "
                f"{f['steps']:.2f} steps/ray (JAX on a TPU: foveated "
                f"{jf['wpsnr']:.2f} dB, {jf['ms']:.1f} ms)")
        b64 = next(q for q in sweep["baseline"] if q["n"] == ROI_TUNED)
        op = next(q for q in sweep["policy_fov"] if q["n"] == jv["policy_n"])
        bar = b64["wpsnr"] - ROI_LOSS_DB
        jbar = jv["policy_wpsnr"] - ROI_JAX_DB
        vote = i < 4
        ok = (_roi_finite(sweep) and op["wpsnr"] >= jbar
              and (op["wpsnr"] >= bar or not vote))
        log("roi", f"{name}: operating point foveated n={jv['policy_n']} "
            f"{op['wpsnr']:.2f} dB (gates: >= B1@{ROI_TUNED} "
            f"{b64['wpsnr']:.2f} - {ROI_LOSS_DB} = {bar:.2f} dB"
            f"{'' if vote else ', not voting'}; >= JAX's "
            f"{jv['policy_wpsnr']:.2f} - {ROI_JAX_DB} = {jbar:.2f} dB); "
            f"evaluate_success: speedup {v['speedup']:.2f}x at "
            f"{v.get('policy_kind')} n={v.get('policy_n')}, success "
            f"{v['success']} (JAX on a TPU: {jv['speedup']:.2f}x, "
            f"{jv['tuned_ms']:.1f} -> {jv['policy_ms']:.1f} ms); "
            f"{time.perf_counter() - t1:.1f} s, on {card}"
            f"{'' if ok else ' FAILED'}")
        if not ok:
            failed.append(name)
    peak = torch.cuda.max_memory_allocated()
    k12 = kernel_launches(composite, warp)
    log("roi", f"sweeps: K1, K2 launches {k12} (want (0, 0)); peak device "
        f"memory {peak / 2**20:.1f} MiB, {(peak - held) / 2**20:.1f} MiB "
        f"over the {held / 2**20:.1f} MiB held before")
    if failed or k12 != (0, 0):
        raise RuntimeError(f"[roi] protocol gates failed: {failed}, "
                           f"launches {k12}")

    # Foveated ROI pixels against the full-resolution policy render.
    sc, st = scenes[0], rpt.scene_tuple(scenes[0])
    p = sc["params"]
    bv = torch.as_tensor(rpt.make_orbit_views(sc["radius"], 1)[0]).to(dev)
    corners = torch.as_tensor(
        roi_policy.roi_world_corners(sc["P"], sc["B"], p), device=dev)
    fov_fn = lambda: roi_policy.render_policy_foveated(
        pol, *st, bv, p, ROI_WIDTH, ROI_HEIGHT, corners, ROI_N_COARSE,
        ROI_TUNED, probe_stride=stride, block=ROI_BLOCK, rho_upsample=ru)
    full_fn = lambda: roi_policy.render_policy(
        pol, *st, bv, p, ROI_WIDTH, ROI_HEIGHT, ROI_N_COARSE, ROI_TUNED,
        probe_stride=stride, block=ROI_BLOCK, rho_upsample=ru)
    b1_fn = lambda: roi_policy.render_fixed(st[0], bv, p, ROI_WIDTH,
                                            ROI_HEIGHT, ROI_TUNED,
                                            block=ROI_BLOCK)
    with torch.no_grad():
        fov, fst = fov_fn()
        full, _ = full_fn()
    x0, y0, rw, rh = (int(fst["rect"][0]), int(fst["rect"][1]),
                      fst["rect"][2], fst["rect"][3])
    fe = 16  # render_policy_foveated's feather
    a = fov[y0 + fe:y0 + rh - fe, x0 + fe:x0 + rw - fe]
    b = full[y0 + fe:y0 + rh - fe, x0 + fe:x0 + rw - fe]
    err = float((a - b).abs().max())
    close = bool(torch.all((a - b).abs() <= ROI_FOV_ATOL
                           + ROI_FOV_RTOL * b.abs()))
    log("roi", f"foveated inset at {sc['name']} pose 0, n={ROI_TUNED}: rect "
        f"({x0}, {y0}, {rw}, {rh}); inside the feather max|foveated - full "
        f"res| {err:.3e} (rtol {ROI_FOV_RTOL}, atol {ROI_FOV_ATOL}), "
        f"{int((a != b).any(-1).sum())} of {a.shape[0] * a.shape[1]} pixels "
        "not bit-equal")
    if not (close and bool(torch.isfinite(fov).all())):
        raise RuntimeError("[roi] foveated ROI pixels differ from the full-"
                           "resolution render")
    del fov, full, a, b

    # The LOD series (docs/roi_policy_lod.npz) on tumor-a at 64, over the
    # same orbit, at the CLI's block // 4.
    t1 = time.perf_counter()
    sweep_lod = rpt.pareto_sweep(
        pol, sc, rpt.make_orbit_views(sc["radius"], ROI_QUALITY_FRAMES),
        [ROI_TUNED], n_frames=ROI_TIMING_FRAMES,
        block=max(8, ROI_BLOCK // 4), lod=True, policy_lod=pol_lod,
        ref_cache=cache, **kw)
    pl, plod = sweep_lod["policy"][0], sweep_lod["policy_lod"][0]
    jab = jres["lod_ablation"]
    jbar = jab["policy_lod"][-1]["wpsnr"] - ROI_JAX_DB
    log("roi", f"LOD at {sc['name']} n={ROI_TUNED}: policy {pl['wpsnr']:.2f} "
        f"dB {pl['ms']:.3f} ms -> +LOD {plod['wpsnr']:.2f} dB "
        f"{plod['ms']:.3f} ms, delta {plod['wpsnr'] - pl['wpsnr']:+.2f} dB "
        f"(JAX on a TPU, 10 poses: {jab['policy'][-1]['wpsnr']:.2f} -> "
        f"{jab['policy_lod'][-1]['wpsnr']:.2f} dB); gate: +LOD >= "
        f"{jbar:.2f} dB; {time.perf_counter() - t1:.1f} s, on {card}")
    if not (_roi_finite(sweep_lod) and plod["wpsnr"] >= jbar):
        raise RuntimeError("[roi] the LOD series failed its gate")

    # Profile: one foveated policy frame, one full policy frame, one B1 frame
    # at 64, each beside its unprofiled frame time.
    with torch.no_grad():
        for label, fn in (("foveated policy", fov_fn),
                          ("full policy", full_fn), ("B1", b1_fn)):
            host_ms = 1e3 * rpt._median_time(lambda: fn()[0], 3)
            by_name = device_activity(torch, fn, ROI_PROFILE_FRAMES)
            if not by_name:
                log("roi", f"profile {label}: device time not measured")
                continue
            busy = sum(us for _, us in by_name.values()) / 1e3 \
                / ROI_PROFILE_FRAMES
            ops = sum(n for n, _ in by_name.values()) / ROI_PROFILE_FRAMES
            log("roi", f"profile {label} frame at n={ROI_TUNED}: "
                f"{host_ms:.3f} ms a frame (median of 3 batches of 3), "
                f"{ops:.1f} device operations, device busy {busy:.3f} ms, "
                f"idle share {1.0 - busy / host_ms:.3f}, on {card}")
            for op_name, (n, us) in sorted(by_name.items(),
                                           key=lambda kv: -kv[1][1])[:6]:
                per = us / 1e3 / ROI_PROFILE_FRAMES
                log("roi", f"profile {label} {per:8.3f} ms "
                    f"{n / ROI_PROFILE_FRAMES:6.1f}x  {op_name[:80]}")


def roi_phase(torch, card: str) -> None:
    """Phase 13: the ROI policy renderer's protocol, its LOD series and its
    training at the documented configuration; gates as ROI_* above."""
    from mri_raytracer_tpu_torch.apps import roi_policy_eval as app
    from mri_raytracer_tpu_torch.eval import roi_protocol as rpt
    from mri_raytracer_tpu_torch.ops import roi_policy

    dev = torch.device("cuda")
    docs = pathlib.Path(__file__).resolve().parent / "docs"
    jres = json.loads((docs / "roi_results.json").read_text())
    jver = {v["scene"]: v for v in jres["verdicts"]}
    t0 = time.perf_counter()
    scenes = rpt.build_scenes(ROI_SHAPE, device=dev)
    pol = roi_policy.load_policy(docs / "roi_policy.npz", device=dev)
    pol_lod = roi_policy.load_policy(docs / "roi_policy_lod.npz", device=dev)
    stride = rpt.auto_probe_stride(ROI_WIDTH)
    ru = rpt.auto_rho_upsample(stride)
    kw = dict(width=ROI_WIDTH, height=ROI_HEIGHT, ref_steps=ROI_REF_STEPS,
              n_coarse=ROI_N_COARSE, probe_stride=stride)
    log("roi", f"{len(scenes)} scenes {[s['name'] for s in scenes]} at "
        f"{ROI_SHAPE} built in {time.perf_counter() - t0:.1f} s; "
        f"{ROI_WIDTH}x{ROI_HEIGHT}, n_coarse {ROI_N_COARSE}, probe stride "
        f"{stride}, rho_upsample {ru}, block {ROI_BLOCK}, reference "
        f"{ROI_REF_STEPS} steps, budgets {list(ROI_BUDGETS)}, "
        f"{ROI_QUALITY_FRAMES}-pose orbit, {ROI_TIMING_FRAMES} timed frames")

    # The protocol sweep. The ROI path runs in PyTorch: K1 and K2 launch no
    # time on it. tumor-a's references are cached under build/ for the LOD
    # series (removed after).
    cache = BUILD / "chip_smoke_roi_refs"
    shutil.rmtree(cache, ignore_errors=True)
    try:
        _roi_protocol(torch, card, scenes, pol, pol_lod, jres, jver, kw,
                      stride, ru, cache)
    finally:
        shutil.rmtree(cache, ignore_errors=True)

    # Training as the CLI calls it, a CUDA event after every update.
    events = []

    class Timed(roi_policy.ClippedOptimizer):
        def step(self):
            super().step()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

    budgets = [int(x) for x in app.DEFAULT_BUDGETS.split(",")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    with patched(roi_policy, "ClippedOptimizer", lambda _: Timed):
        _, losses, sel, tasks = app.train_protocol_policy(
            scenes, torch.Generator().manual_seed(0), budgets,
            ROI_TRAIN_STEPS, ROI_TRAIN_RES, ROI_N_COARSE, ROI_REF_STEPS,
            ROI_TUNED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    every = sel["eval_every"]
    # The interval after an evaluation step holds the evaluation.
    ms = [a.elapsed_time(b) for j, (a, b) in
          enumerate(zip(events[:-1], events[1:])) if (j + 1) % every]
    lap = len(tasks) * 3  # every (scene, view) pair once
    first, last = float(np.mean(losses[:lap])), float(np.mean(losses[-lap:]))
    log("roi", f"training: {sel['steps_run']} steps at {ROI_TRAIN_RES}^2, "
        f"{len(tasks)} scenes, n_fine {budgets[len(budgets) // 2]}, "
        f"validation budgets {sel['val_budgets']}: wall {wall:.1f} s; ms a "
        f"step (CUDA events, {len(ms)} steps without an evaluation): median "
        f"{float(np.median(ms)):.3f}, mean {float(np.mean(ms)):.3f}; peak "
        f"device memory {peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} "
        f"MiB for the training), on {card}")
    log("roi", f"training: loss {losses[0]:.4e} -> {losses[-1]:.4e}, mean "
        f"over the first / last {lap} steps (each scene and view once) "
        f"{first:.5e} / {last:.5e} ({'fell' if last < first else 'did not '
        'fall'}; gate: last <= {ROI_LOSS_BAND} x first); selected step "
        f"{sel['selected_step']}, "
        f"best validation wPSNR {sel['best_val_wpsnr']:.2f} dB (gate >= "
        f"{ROI_VAL_MIN_DB:.2f}; JAX on a TPU: 54.94 at step 700), curve "
        + ", ".join(f"{s}: {q:.2f}" for s, q in sel["val_wpsnr_curve"]))
    if not (all(np.isfinite(losses)) and last <= ROI_LOSS_BAND * first
            and sel["best_val_wpsnr"] >= ROI_VAL_MIN_DB):
        raise RuntimeError("[roi] training missed its gates")


def run_app(phase: str, app, argv) -> str:
    """``app.main(argv)`` with its stdout echoed under the phase's tag;
    fails unless it returns 0. Returns what it printed."""
    rc, text, sec = call_app(app, argv)
    for line in text.splitlines():
        log(phase, f"  {line}")
    log(phase, f"{app.__name__.rsplit('.', 1)[-1]} {' '.join(map(str, argv))}"
        f": rc {rc}, {sec:.1f} s")
    if rc != 0:
        raise RuntimeError(f"[{phase}] the app returned {rc}")
    return text


def check_pngs(phase: str, out: pathlib.Path, n: int, size) -> None:
    pngs = sorted(out.glob("frame_*.png"))
    sizes = {png_size(f.read_bytes()) for f in pngs}
    if len(pngs) != n or sizes != {tuple(size)}:
        raise RuntimeError(f"[{phase}] {out.name}: {len(pngs)} PNGs of "
                           f"{sizes}, want {n} of {tuple(size)}")


def frame_stats(torch, phase: str, label: str, fn, card: str,
                extra=None, profile: bool = True) -> dict:
    """One configuration's numbers: fps over up to SEC_FRAMES frames (as
    many as fit SEC_TIMED_S by the warm-up frame's time, at least one),
    each timed on the host clock between torch.cuda.synchronize() calls;
    unless ``profile`` is false, device operations, busy time and idle
    share a frame from torch.profiler over SEC_PROFILE frames; peak device
    memory over the timed frames. ``extra()``, when given, adds a string
    read after the last timed frame (a tracer's counts)."""
    t_all = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t_all
    n = max(1, min(SEC_FRAMES, int(SEC_TIMED_S / max(warm, 1e-6))))
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    more = extra() if extra is not None else ""
    ms = 1e3 * float(np.median(times))
    by_name = (device_activity(torch, fn, SEC_PROFILE, warm=False)
               if profile else {})
    busy = sum(us for _, us in by_name.values()) / 1e3 / SEC_PROFILE
    ops = sum(k for k, _ in by_name.values()) / SEC_PROFILE
    rec = dict(ms=ms, fps=1e3 / ms, busy_ms=busy, ops=ops,
               idle=1.0 - busy / ms, peak_mib=peak / 2**20)
    busy_s = (f"{ops:.1f} device operations, device busy {busy:.3f} ms, "
              f"idle share {rec['idle']:.3f}" if by_name else
              "device time not profiled" if not profile else
              "device time not measured (the profiler saw no device "
              "activity)")
    log(phase, f"{label}: {rec['fps']:.3f} fps ({ms:.3f} ms a frame, median "
        f"of {n} synced frames; min {1e3 * min(times):.3f}, max "
        f"{1e3 * max(times):.3f}); per frame {busy_s}; peak device memory "
        f"{rec['peak_mib']:.1f} MiB ({(peak - held) / 2**20:.1f} over the "
        f"{held / 2**20:.1f} held){more}, on {card}; measured in "
        f"{time.perf_counter() - t_all:.1f} s")
    return rec


def card_vs_cpu(torch, phase: str, label: str, card_out, cpu_out,
                decision=None) -> None:
    """The card's frame against the CPU's. ``decision``: (card, cpu)
    per-pixel decision masks, or None for a frame without one."""
    a = card_out.detach().cpu().float()
    b = cpu_out.detach().float()
    diff = (a - b).abs()
    if diff.dim() == 3:
        diff = diff.amax(-1)
    finite = bool(torch.isfinite(a).all())
    if decision is None:
        err = float(diff.max())
        ok = finite and err <= SEC_TOL
        log(phase, f"{label}: card vs CPU max abs error {err:.3e} (bar "
            f"{SEC_TOL}), {int((diff > 0).sum())} of {diff.numel()} pixels "
            f"not bit-equal{'' if ok else ' FAILED'}")
    else:
        dc, dp = (d.detach().cpu().bool() for d in decision)
        agree = dc == dp
        share = float(agree.float().mean())
        err = float(diff[agree].max()) if bool(agree.any()) else 0.0
        ok = finite and share >= SEC_AGREE and err <= SEC_TOL
        log(phase, f"{label}: card vs CPU decisions agree on {share:.6f} "
            f"of {agree.numel()} pixels ({int((~agree).sum())} differ; bar "
            f">= {SEC_AGREE}), max abs error where they agree {err:.3e} "
            f"(bar {SEC_TOL}), {int((diff > 0).sum())} pixels not "
            f"bit-equal{'' if ok else ' FAILED'}")
    if not ok:
        raise RuntimeError(f"[{phase}] {label}: the card's frame differs "
                           "from the CPU's")


def secondary_phases(torch, card: str) -> None:
    """Phases 14-18: the u8 grid volume, SDF, noise, mesh and hybrid
    renderers through their apps on the card, at the apps' defaults and at
    a BraTS-shaped size; K1 and K2 launch no time on these paths."""
    from mri_raytracer_tpu_torch.data.synthetic import write_synthetic_dataset
    from mri_raytracer_tpu_torch.ops import composite, warp

    BUILD.mkdir(exist_ok=True)
    t_all = time.perf_counter()
    composite.composite_planes.launches = warp.warp_screen.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sec_",
                                     dir=BUILD) as tmp:
        work = pathlib.Path(tmp)
        t0 = time.perf_counter()
        case = write_synthetic_dataset(work / "data", num_cases=1,
                                       shape=BRATS_SHAPE, seed=0) \
            / "BraTS-SYN-00000-000"
        log("volume", f"a {BRATS_SHAPE} NIfTI case (seed 0) written in "
            f"{time.perf_counter() - t0:.1f} s")
        for phase, fn in (("volume", volume_phase), ("sdf", sdf_phase),
                          ("noise", noise_phase), ("mesh", mesh_phase),
                          ("hybrid", hybrid_phase)):
            t0 = time.perf_counter()
            fn(torch, card, work, case)
            log(phase, f"phase wall {time.perf_counter() - t0:.1f} s")
    k12 = kernel_launches(composite, warp)
    log("hybrid", f"phases 14-18: K1, K2 launches {k12} (want (0, 0)); wall "
        f"{time.perf_counter() - t_all:.1f} s, on {card}")
    if k12 != (0, 0):
        raise RuntimeError(f"[hybrid] K1/K2 launched {k12} times on the "
                           "secondary renderers' paths")


def volume_phase(torch, card: str, work: pathlib.Path, case) -> None:
    """Phase 14: apps/volume_app.py in its three modes at its defaults
    (synthetic 96^3 u8, 512^2, 64 steps, 12 frames); a modality of the
    BraTS-shaped case through --nii at 64 and 512 steps, and through
    --format bc4 --dims after encode_bc4; each mode's numbers; the card
    against the CPU at 96^3 and 128^2."""
    from mri_raytracer_tpu_torch.apps import volume_app
    from mri_raytracer_tpu_torch.data import codecs
    from mri_raytracer_tpu_torch.data.synthetic import synthetic_u8_volume
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.render.volume import (GridVolumeRenderer,
                                                       load_volume)

    dev = torch.device("cuda")
    for mode in GRID_MODES:
        out = work / f"volume_{mode}"
        run_app("volume", volume_app, ["--synthetic", "--render-mode", mode,
                                       "--out", out])
        check_pngs("volume", out, 12, (512, 512))
    cam = OrbitalCamera(radius=3.0, fov_y=np.radians(72.0))
    cam.orbit(0.7, 0.0)
    vol96 = synthetic_u8_volume(VOL96, seed=0)
    r = GridVolumeRenderer(vol96, 512, 512, device=dev)
    for mode in GRID_MODES:
        frame_stats(torch, "volume", f"synthetic 96^3 {mode}, 512^2, 64 "
                    "steps", lambda: r.render(cam.basis(), step_count=64.0,
                                              mode=mode), card)

    nii = case / f"{case.name}-t1n.nii.gz"
    big = load_volume(nii)
    rb = GridVolumeRenderer(big, 512, 512, device=dev)
    for steps in (64, 512):
        for mode in GRID_MODES:
            out = work / f"volume_nii_{mode}_{steps}"
            run_app("volume", volume_app, [
                "--nii", nii, "--render-mode", mode, "--steps", steps,
                "--frames", 1, "--out", out])
            check_pngs("volume", out, 1, (512, 512))
            frame_stats(torch, "volume", f"--nii {BRATS_SHAPE} {mode}, "
                        f"512^2, {steps} steps",
                        lambda: rb.render(cam.basis(), step_count=steps,
                                          mode=mode), card,
                        profile=mode == "composite" and steps == 64)
    del rb
    dims = ",".join(str(d) for d in big.shape)
    bc4 = work / "t1n.bc4"
    t0 = time.perf_counter()
    bc4.write_bytes(codecs.encode_bc4(big.transpose(2, 1, 0)))
    dec = load_volume(bc4, fmt="bc4", dims=big.shape)
    log("volume", f"encode_bc4 of the {big.shape} modality in "
        f"{time.perf_counter() - t0:.1f} s with its decode: "
        f"{bc4.stat().st_size} bytes, max |decoded - original| "
        f"{int(np.abs(dec.astype(int) - big).max())} levels")
    for mode in GRID_MODES:
        out = work / f"volume_bc4_{mode}"
        run_app("volume", volume_app, [
            "--volume", bc4, "--format", "bc4", "--dims", dims,
            "--render-mode", mode, "--frames", 1, "--out", out])
        check_pngs("volume", out, 1, (512, 512))
    rd = GridVolumeRenderer(dec, 512, 512, device=dev)
    frame_stats(torch, "volume", f"--format bc4 {BRATS_SHAPE} composite, "
                "512^2, 64 steps", lambda: rd.render(cam.basis()), card,
                profile=False)
    del rd

    rc = GridVolumeRenderer(vol96, CPU_RES, CPU_RES, device=dev)
    rp = GridVolumeRenderer(vol96, CPU_RES, CPU_RES, device="cpu")
    for mode in GRID_MODES:
        a = rc.render(cam.basis(), mode=mode)
        b = rp.render(cam.basis(), mode=mode)
        card_vs_cpu(torch, "volume", f"96^3 {mode} at {CPU_RES}^2", a, b,
                    None if mode != "iso" else (a[..., 0] > 0,
                                                b[..., 0] > 0))


def sdf_phase(torch, card: str, work: pathlib.Path, case) -> None:
    """Phase 15: apps/sdf_app.py at its defaults (512^2, 96 steps, 12
    frames), its numbers, and the card against the CPU at 128^2."""
    from mri_raytracer_tpu_torch.apps import sdf_app
    from mri_raytracer_tpu_torch.ops import sdf
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera

    out = work / "sdf"
    run_app("sdf", sdf_app, ["--out", out])
    check_pngs("sdf", out, 12, (512, 512))
    cam = OrbitalCamera(radius=2.5, fov_y=np.radians(55.0))
    cam.orbit(0.5, 0.0)
    p = sdf.default_sdf_params()
    frame_stats(torch, "sdf", "sphere, 512^2, 96 steps",
                lambda: sdf.render_sdf(cam.basis(), p, 512, 512,
                                       max_steps=96), card)
    a, b = (sdf.render_sdf(cam.basis(), p, CPU_RES, CPU_RES, max_steps=96,
                           device=d) for d in ("cuda", "cpu"))
    card_vs_cpu(torch, "sdf", f"sphere at {CPU_RES}^2", a, b)


def noise_phase(torch, card: str, work: pathlib.Path, case) -> None:
    """Phase 16: apps/noise_app.py at its defaults (512^2, 12 frames) with
    and without --mouse, its numbers, and the card against the CPU at
    128^2."""
    from mri_raytracer_tpu_torch.apps import noise_app
    from mri_raytracer_tpu_torch.ops.noise2d import render_noise_demo

    for tag, extra in (("plain", []), ("mouse", ["--mouse", "256,200"])):
        out = work / f"noise_{tag}"
        run_app("noise", noise_app, extra + ["--out", out])
        check_pngs("noise", out, 12, (512, 512))
    for mouse in (None, (256.0, 200.0)):
        frame_stats(torch, "noise", f"512^2, t 0.2, mouse {mouse}",
                    lambda: render_noise_demo(512, 512, 0.2, mouse_pos=mouse),
                    card)
        a, b = (render_noise_demo(CPU_RES, CPU_RES, 0.2,
                                  mouse_pos=None if mouse is None else
                                  (64.0, 50.0), device=d)
                for d in ("cuda", "cpu"))
        diff = (a.cpu() - b).abs().amax(-1)
        card_vs_cpu(torch, "noise", f"{CPU_RES}^2, mouse "
                    f"{mouse is not None}", a, b,
                    (diff <= SEC_TOL, torch.ones_like(diff, dtype=bool)))


def _write_ply(path: pathlib.Path, verts, tris) -> None:
    head = ("ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\nproperty float x\n"
            "property float y\nproperty float z\n"
            f"element face {len(tris)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    body = "\n".join(f"{x!r} {y!r} {z!r}" for x, y, z in verts.tolist())
    faces = "\n".join(f"3 {a} {b} {c}" for a, b, c in tris.tolist())
    path.write_text(head + body + "\n" + faces + "\n")


def mesh_phase(torch, card: str, work: pathlib.Path, case) -> None:
    """Phase 17: apps/mesh_app.py on its built-in mesh at its defaults;
    ASCII PLY files of the two occluder meshes (15,312 triangles: brute;
    83,176: BVH) through --ply at 512^2; each tracer's numbers, the BVH's
    traversal steps and host syncs a frame; brute against BVH on the
    card; the card against the CPU at 128^2."""
    from mri_raytracer_tpu_torch.apps import mesh_app
    from mri_raytracer_tpu_torch.data import brats
    from mri_raytracer_tpu_torch.data.synthetic import synthetic_case
    from mri_raytracer_tpu_torch.render import mesh
    from mri_raytracer_tpu_torch.render.camera import (OrbitalCamera,
                                                       camera_rays)
    from mri_raytracer_tpu_torch.render.hybrid import extract_boundary_mesh

    dev = torch.device("cuda")
    out = work / "mesh_demo"
    run_app("mesh", mesh_app, ["--out", out])
    check_pngs("mesh", out, 12, (512, 512))

    _, seg_small = synthetic_case(SEC_SHAPE, seed=0)
    seg_big = brats.load_seg_volume(case / f"{case.name}-seg.nii.gz")
    meshes = {}
    for name, seg, want_mode in (("small", seg_small, "brute"),
                                 ("big", seg_big, "bvh")):
        t0 = time.perf_counter()
        verts, tris = extract_boundary_mesh(seg > 0)
        ply = work / f"occluder_{name}.ply"
        _write_ply(ply, verts, tris)
        log("mesh", f"occluder of {seg.shape}: {len(tris)} triangles, "
            f"{len(verts)} vertices, extracted and written as ASCII PLY in "
            f"{time.perf_counter() - t0:.1f} s")
        text = run_app("mesh", mesh_app, ["--ply", ply, "--frames", 1,
                                          "--out", work / f"mesh_{name}"])
        check_pngs("mesh", work / f"mesh_{name}", 1, (512, 512))
        if f"tracer={want_mode}" not in text:
            raise RuntimeError(f"[mesh] {len(tris)} triangles did not "
                               f"resolve to {want_mode}")
        meshes[name] = mesh.load_ply_ascii(ply)

    cam = OrbitalCamera(radius=3.0, fov_y=np.radians(55.0))
    cam.orbit(0.9, 0.0)
    renderers = {}
    for name, mode in (("small", "brute"), ("small", "bvh"), ("big", "bvh")):
        t0 = time.perf_counter()
        r = mesh.MeshRenderer(*meshes[name], 512, 512, mode=mode, device=dev)
        label = f"{len(meshes[name][1])} triangles, {mode}, 512^2"
        log("mesh", f"{label}: renderer built in "
            f"{time.perf_counter() - t0:.2f} s"
            + (f" ({r.nodes.shape[0]} BVH nodes)" if mode == "bvh" else "")
            + (f", chunk {mesh.brute_chunk(512 * 512, dev)} triangles"
               if mode == "brute" else ""))
        extra = None
        if mode == "bvh":
            extra = lambda r=r: (
                f"; BVH traversal steps {r.last_stats['steps']}, host syncs "
                f"{r.last_stats['syncs']}, ray-steps "
                f"{r.last_stats['ray_steps']} a frame")
        frame_stats(torch, "mesh", label, lambda r=r: r.render(cam.basis()),
                    card, extra=extra)
        renderers[(name, mode)] = r

    # Brute against BVH on the card, on the 15,312-triangle mesh.
    rb, rv = renderers[("small", "brute")], renderers[("small", "bvh")]
    ro, rd = camera_rays(cam.basis(dev), 512, 512)
    tb = mesh.trace_brute(ro, rd, rb.verts, rb.tris)
    tv = mesh.trace_bvh(ro, rd, rv.nodes, rv.bvh_tris, rv.verts)
    _hits_agree(torch, "mesh", "brute vs BVH on the card, 15,312 "
                "triangles at 512^2", tb, tv)
    del renderers, rb, rv

    small = meshes["small"]
    for mode in ("brute", "bvh"):
        traced = [_trace(mesh.MeshRenderer(*small, CPU_RES, CPU_RES,
                                           mode=mode, device=d), cam.basis())
                  for d in ("cuda", "cpu")]
        agree = _hits_agree(torch, "mesh", f"{mode} card vs CPU, "
                            f"{len(small[1])} triangles at {CPU_RES}^2",
                            traced[0][2:], traced[1][2:])
        card_vs_cpu(torch, "mesh", f"{mode} frame at {CPU_RES}^2",
                    mesh.shade(*traced[0]), mesh.shade(*traced[1]),
                    (agree, torch.ones_like(agree)))


def _trace(r, basis):
    """(ro, rd, t, n, hit) of a MeshRenderer's frame at ``basis``: its
    ``render`` is ``shade`` of these."""
    from mri_raytracer_tpu_torch.render import mesh
    from mri_raytracer_tpu_torch.render.camera import camera_rays

    ro, rd = camera_rays(basis.to(r.device), r.width, r.height)
    if r.mode == "brute":
        return (ro, rd) + mesh.trace_brute(ro, rd, r.verts, r.tris)
    return (ro, rd) + mesh.trace_bvh(ro, rd, r.nodes, r.bvh_tris, r.verts)


def _hits_agree(torch, phase: str, label: str, got, want):
    """Two tracers' (t, n, hit). A ray's decisions are whether it hits and,
    where both hit, which triangle: at a tie in t (a ray through an edge
    two triangles share) brute-force keeps the lowest index and the BVH
    the first it visits, as in JAX, so the normals may differ there; a
    normal more than SEC_TOL apart counts as the other triangle. The
    decisions must agree on SEC_AGREE of the rays, and t within SEC_TOL
    wherever both hit (a differing normal comes with an equal t). Returns
    the (card-agnostic, CPU) mask of rays whose decisions agree."""
    (t1, n1, h1), (t2, n2, h2) = ((x.detach().cpu() for x in r)
                                  for r in (got, want))
    both = h1 & h2
    other = both & ((n1 - n2).abs().amax(-1) > SEC_TOL)
    agree = (h1 == h2) & ~other
    share = float(agree.float().mean())
    et = float((t1 - t2)[both].abs().max()) if bool(both.any()) else 0.0
    ok = share >= SEC_AGREE and et <= SEC_TOL
    log(phase, f"{label}: decisions agree on {share:.6f} of {agree.numel()} "
        f"rays ({int((h1 != h2).sum())} hit flips, {int(other.sum())} ties "
        f"resolved to another triangle, {int(both.sum())} both hit; bar >= "
        f"{SEC_AGREE}); max |dt| {et:.3e} where both hit (bar {SEC_TOL})"
        f"{'' if ok else ' FAILED'}")
    if not ok:
        raise RuntimeError(f"[{phase}] {label}: the tracers disagree")
    return agree


def hybrid_phase(torch, card: str, work: pathlib.Path, case) -> None:
    """Phase 18: apps/hybrid_app.py at its defaults (synthetic 96 x 96 x
    80, 384^2, 192 steps, shadows and skip on, 12 frames) and on the
    BraTS-shaped case directory through --case (83,176 occluder
    triangles) with shadows and skip both on and both off; the renderer's
    numbers there with shadows and skip each on and off (profiled: both
    on), the two BVH passes' traversal steps and host syncs a
    frame, the one-time mesh extraction and BVH build; the card against
    the CPU at 96 x 96 x 80, 128^2."""
    from mri_raytracer_tpu_torch.apps import hybrid_app
    from mri_raytracer_tpu_torch.data import brats
    from mri_raytracer_tpu_torch.data.synthetic import synthetic_case
    from mri_raytracer_tpu_torch.render.camera import OrbitalCamera
    from mri_raytracer_tpu_torch.render.hybrid import HybridRenderer

    dev = torch.device("cuda")
    out = work / "hybrid_default"
    run_app("hybrid", hybrid_app, ["--out", out])
    check_pngs("hybrid", out, 12, (384, 384))
    combos = ((True, True), (True, False), (False, True), (False, False))
    for shadows, skip in (combos[0], combos[3]):
        out = work / f"hybrid_case_{int(shadows)}{int(skip)}"
        run_app("hybrid", hybrid_app, ["--case", case, "--frames", 1,
                                       "--out", out]
                + ([] if shadows else ["--no-shadows"])
                + ([] if skip else ["--no-skip"]))
        check_pngs("hybrid", out, 1, (384, 384))

    cam = OrbitalCamera(radius=3.0, theta=np.pi, phi=1.1)
    cam.orbit(0.6, 0.0)
    t0 = time.perf_counter()
    mods, seg = brats.load_case(case)
    vol = np.stack([brats.percentile_normalize(m) for m in mods]).mean(0)
    t1 = time.perf_counter()
    r = HybridRenderer(vol.astype(np.float32), seg > 0, 384, 384,
                       light_dir=(1.0, 0.6, 0.4), device=dev)
    torch.cuda.synchronize()
    log("hybrid", f"{BRATS_SHAPE} case: load {t1 - t0:.1f} s; occluder "
        f"mesh extraction, BVH build and upload (one-time host cost) "
        f"{time.perf_counter() - t1:.2f} s: {r.n_tris} triangles, "
        f"{r.n_nodes} nodes")

    def passes():
        return "; BVH " + ", ".join(
            f"{k} pass {v['steps']} steps, {v['syncs']} host syncs, "
            f"{v['ray_steps']} ray-steps" for k, v in r.last_stats.items())

    for shadows, skip in combos:
        frame_stats(torch, "hybrid", f"{BRATS_SHAPE}, 384^2, 192 steps, "
                    f"shadows {shadows}, skip {skip}",
                    lambda: r.render(cam.basis(), shadows=shadows,
                                     mesh_skip=skip), card,
                    extra=passes if (shadows or skip) else None,
                    profile=shadows and skip)
    del r

    mods, seg = synthetic_case(SEC_SHAPE, seed=0)
    vol = np.stack([brats.percentile_normalize(m) for m in mods]) \
        .mean(0).astype(np.float32)
    rs = {d: HybridRenderer(vol, seg > 0, CPU_RES, CPU_RES,
                            light_dir=(1.0, 0.6, 0.4), device=d)
          for d in ("cuda", "cpu")}
    for shadows, skip in combos:
        a, b = (rs[d].render(cam.basis(), shadows=shadows, mesh_skip=skip)
                for d in ("cuda", "cpu"))
        dec = ((rs["cuda"].last_stats["shadow"]["hit"],
                rs["cpu"].last_stats["shadow"]["hit"]) if shadows else None)
        card_vs_cpu(torch, "hybrid", f"{SEC_SHAPE} at {CPU_RES}^2, shadows "
                    f"{shadows}, skip {skip}", a, b, dec)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] torch.cuda.is_available() is false: this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    try:
        import mri_raytracer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"[chip_smoke] the port package is missing: {e}",
              file=sys.stderr)
        return 1
    try:
        return run(torch)
    except Exception:
        traceback.print_exc()
        print("[chip_smoke] FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
