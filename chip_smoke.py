#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs torch with CUDA, nvcc (the CUDA toolkit) and numpy; it imports
neither jax nor lif_tpu. Phases, each of which exits 1 on failure:

1. device: a CUDA device, and its name and power limit from nvidia-smi;
2. build: compile csrc/sweep_march.cu, csrc/sweep_target.cu,
   csrc/sweep_scaled.cu and csrc/splat_march.cu with nvcc (sm_90a) and
   the LIF codec csrc/lif_container.cpp with g++ into
   lif_tpu_torch/_build/, one compiler per source, started together;
3. lateral kernel vs plain: a seeded 1280x800 scene (smooth noise plus a
   hard near box, SFMoMA's constants: focal 0.78*W, baseline 0.045 m,
   inverse depth 0.0001..0.09), 8 lateral poses; the kernel's found /
   invz* / rgba* against the plain march on the card and against
   march_translation_skip_plain, the plain mirror of its skip walk (on
   the first N_MIRROR poses), each exact (no found flip, max abs 0), at
   refine 0 (production) and refine 2;
4. main path 1 (lateral): render_fast_batch(method="march") over 96
   lateral poses (two pose chunks) with every launch count reset just
   before it; tiers ('march',), the kernel launched, finite output,
   alpha coverage in (0.5, 1]; pose 0 >= 40 dB against the 640-step
   exact march;
5. lateral timing: CUDA events, median of 5 runs after a warm-up, the
   kernel beside its previous design's time;
6. target kernel vs plain: the same scene, 8 orbit poses
   orbit_pose([0, 0, -1], 1, theta), theta over +-15 deg; depth-only at
   refine 0, depth-only on a 2-px ladder with refine 1, and full color,
   each exact (no found flip, max abs 0) against march_target_plain and
   against march_target_skip_plain, the plain mirror of the kernel's skip
   walk;
7. main path 2 (orbit): render_fast_batch over 120 orbit poses (theta in
   linspace(-15, 15, 120) deg, three pose chunks) with every launch
   count reset just before it; tiers ('target',), the kernel launched,
   finite output, alpha coverage in (0.5, 1]; PSNR against the 640-step
   march at poses 0, 30 and 60: pose 60 (the center) >= 40 dB, every
   pose at most 1 dB under lif_tpu's value on the same scene and pose;
8. main path 3 (pitch): 8 pitch-orbit poses (phi over +-8 deg) through
   the transposed route, counts reset just before; tiers ('target',),
   the kernel launched, finite output;
9. orbit timing: CUDA events, median of 5 runs after a warm-up, the
   kernel beside its previous design's time;
10. scaled kernel vs plain: the same scene, planned as render_fast_batch
    plans the main paths (renderer.plan_tiers): the first 8 poses of the
    dolly batch (K = 128) depth only at refine 2 (production) and refine 0,
    and full color; the first 8 poses of the tilted orbit's phase A (its
    1792x1024 intermediate, per-pose ladders, K = 320) depth only at
    refine 2; each exact (no found flip, max abs 0) against
    march_scaled_plain and against march_scaled_skip_plain, the plain
    mirror of the kernel's skip walk (on the first N_MIRROR poses);
11. main path 4 (dolly): render_fast_batch over 48 unrotated poses
    (0.03 cos 2 pi t, 0.02 sin 2 pi t, z), z in linspace(-0.05, 0.05), with
    every launch count reset just before it; tiers ('scaled',), the scaled
    kernel launched, finite output, alpha coverage in (0.5, 1]; PSNR
    against the 640-step march at poses 0, 24 and 47 at most 1 dB under
    lif_tpu's value on the same scene and pose;
12. main path 5 (tilted orbit): render_fast_batch over 16 poses
    orbit_pose([0, 0, -1], 1, theta, 2 deg), theta in linspace(-8, 8) deg,
    counts reset just before; tiers ('rotated',), the scaled kernel
    launched in phase A, finite output, coverage in (0.5, 1]; PSNR at
    poses 0, 8 and 15 at most 1 dB under lif_tpu's;
13. scaled timing: CUDA events, median of 5 after a warm-up: frames/s of
    both new paths, the kernel against its plain version (8 poses, depth
    only, refine 2), and the kernel at the tilted orbit's phase-A shapes
    beside that configuration's bound, each beside its previous design's
    time;
14. billboard kernel vs plain and the oracle: the same scene, the 8
    lateral poses of phase 3 planned by renderer.plan_billboard (K = 312,
    point_size 1); the kernel's hit / texel / colour against
    billboard_scatter_plain and billboard_march_plain (equal: no hit flip,
    no mismatch, max abs 0) and its colour and show_depth images against
    forward_splat
    (render(mode='billboard')) on the card, pose by pose: at most 64 hit
    flips and 64 colour mismatches (tests/test_splat_march.py:106-115
    allows 1e-3 of the pixels, 1024);
15. main path 6 (billboard): render_billboard_fast_batch over the 96
    lateral poses of main path 1, counts reset just before: exactly one
    billboard launch and no other kernel's, finite output, alpha coverage
    in (0.5, 1], poses 0 / 48 / 95 within the same 64 of
    render(mode='billboard');
16. main path 7 (mesh modes): render(mode='mesh') and
    render(mode='billboard') at lateral pose 0 and orbit pose 0 (theta
    -15 deg): finite output, alpha coverage within 0.005 of lif_tpu's and
    PSNR against the 640-step march at most 1 dB under lif_tpu's, both on
    the same scene and pose (tools/reference_psnr.py);
17. billboard timing: CUDA events, median of 5 after a warm-up: main path
    6 frames/s, the kernel (beside its previous design's time) against
    both plain versions (8 poses), and render(mode='billboard') /
    render(mode='mesh') per frame;
18. main path 8 (a LIF file to frames): a LIF authored in memory from the
    seed (make_lif, PNG payloads through the port's encode_png): view 0
    the scene above as one layer with frustum_skew (0.012, -0.0037) (a
    shift d = (-11.98, 3.69) px: a fractional y pre-shift), view 1 a
    3-layer LDI in the legacy layered_depth_image_data form with 128 px
    of outpainting (layers 1408x928), stereo_render_data.invd set. It is
    written under lif_tpu_torch/_build/ and loaded with load_lif_file
    (load time, native codec, textures on cuda); render(mode='fast') at
    x = 0.135 on both views (BASELINE config 0) with PSNR against the
    640-step march, ms/frame and a 20-pose sequential pass; render_fast_view
    at a y-only pose and a dolly pose on view 0 and an orbit pose (8 deg
    about orbit_center) on view 1, each with its tier; render_depth_fast at
    the lateral pose, equal to the plain march's invz* * baseline; the
    lateral kernel on view 0's skewed, pre-shifted source (8 poses, row
    tables from that source) exact against the plain march and its skip
    mirror at refine 0 and 2; the viewer's render_trajectory(mode='fast')
    over 24 orbit frames about orbit_center, timed. Every PSNR at most 1
    dB under lif_tpu's on the same LIF, pose and route
    (tools/reference_lif_psnr.py); every step's launches counted exactly,
    and every launch a step makes (view 1's cropped lateral layers and
    its orbit's target launches, the skewed dolly's and the viewer's
    phase-A scaled launches, ...) recorded and held, on its own inputs,
    to the kernel's plain march (each pose) and the plain mirror of its
    skip walk (the first N_MIRROR poses): no found flip, max abs 0.
19. main path 9 (stereo from a LIF file, BASELINE config 2): a stereo LIF
    authored from the seed (make_stereo_lif: the left view make_scene(0)
    at -baseline/2, the right eye synthesized from it at +baseline/2 by
    the port on the CPU; its sha256 printed beside the reference tool's),
    written under lif_tpu_torch/_build/ and loaded with load_lif_file;
    render_stereo_fast_batch over 60 pairs (120 cameras at -+baseline/2
    + 0.5 mm i): tiers ('march',) for both eyes, exactly 2 eyes x 3
    balanced chunks = 6 lateral launches and no other kernel's, finite
    output, coverage in (0.5, 1], pairs/s by CUDA events (median of 5
    after a warm-up); against the exact 640-step render_stereo_view, at
    most 1 dB under lif_tpu's value on the same file and pose
    (tools/reference_stereo_psnr.py): the mid pose x = 4 mm (tiers
    ('march',)), a 6-degree yaw head pose ('target', one launch per
    eye), an off-axis head pose (4, 10, 20) mm ('scaled') and poses 0 and
    15 of an 8-pair batch under the camera skew (0.01, -0.004) (the
    lateral fold with a fractional y pre-shift); LDI stereo on main path
    8's 3-layer view paired with a copy one baseline to its right (the
    hard mode: eroded masks, three lateral launches per eye), run mono ->
    stereo -> mono, each frame equal to its plain-version render (the
    lateral tier's plain march on the same tensors, no cached march
    pack), the second mono frame equal to the first and every layer's
    march packs holding both masks. Every launch is held to the plain
    versions on its own inputs (the pair batch's launches on 4 poses
    each).
20. main path 10 (multi-projector fusion, BASELINE config 4): four
    projectors synthesized from make_scene(0) at x = 0.02 i m by the port
    on the CPU (make_fusion_projectors), moved to the card and resampled
    there to 3840x2160 (scale 3, center crop); render_fused_fast_batch
    at four cameras x = 0.05 + 0.002 j m, counts reset just before:
    exactly 4 lateral launches (one per projector) and no other kernel's,
    finite output, coverage in (0.5, 1], the peak device memory; each
    launch held to the plain versions on its own inputs (2 poses each);
    a second call reusing every texture entry and march pack, its frames
    equal to the first; the frames equal to their plain-version render
    (plain_lateral); fused frames/s by CUDA events (median of 5 after a
    warm-up) at 4 cameras and at 1; the peak device memory at 8 and 16
    cameras, and 24 cameras in one call (its pose chunk bounded by the
    free device memory: exactly 4 launches a chunk) frame for frame
    against calls of 4 cameras (max abs <= 1e-5); at 1280x800, the fused
    frame at x = 0.05 m against the port's 640-step
    render_fused_projectors at the default fuse_tol and at 0.1, each at
    most 1 dB under lif_tpu's value on the same projectors
    (tools/reference_fused_psnr.py).
21. main path 11 (the plane-sweep tier, plain torch: no kernel may
    launch), on the scene of main paths 1-7, each drive with every launch
    count reset just before it: render_fast_batch(method="sweep") over
    the first 16 poses of main path 1 (40 hybrid planes, chunk 2), the
    same with exact_color=True, render_fast_view at x = 0.135 m with a
    zoomed camera (focal 0.9 W: the single view's per-layer fallback) and
    render_fast_batch over 4 rotated poses no march tier covers
    (render_rotated). Each: tiers ('sweep',) and lif_tpu's
    TierFallbackWarnings (none for method='sweep', one each for the view
    and the rotated batch), no launch, finite output, coverage in (0.5,
    1], pose 0 against the 640-step march at most 1 dB under lif_tpu's
    value (tools/reference_sweep_psnr.py), the card's pose-0 frame against
    the CPU port's (>= 50 dB, at most 0.5% of the pixels off by > 2e-3),
    frames/s by CUDA events (median of 5 after a warm-up) beside the
    40-step exact march at pose 0 (its PSNR and ms: a measurement only,
    ROADMAP item 6); then the solved invz* (solve_depth_aligned) on the
    card against the CPU port's (at most 100 found flips, max abs 1e-4),
    with TF32 off.
22. main path 12 (scene fitting, no kernel): make_fit_problem's targets,
    four poses rendered from the true disparity by the port's soft sweep
    on the card; fit_projector from the clipped N(0, 0.15) start for
    FIT_STEPS Adam steps (12 planes): min(last 5) < 0.85 x the first loss,
    the fitted disparity closer to the truth than the start, the first
    three losses within 1e-3 of lif_tpu's (tools/reference_fit.py), ms per
    step by CUDA events and the peak device memory.
23. main path 13 (multi-device: parallel.sharding on the one card, each
    step's launch counts zeroed just before it): world size 1 on NCCL in
    this process, render_fast_trajectory_sharded over main path 1's 96
    lateral, main path 2's 120 orbit and main path 4's 48 dolly poses,
    each equal to that main path's frames (max abs 0); then 2 and 4 ranks
    on gloo with CUDA tensors (NCCL refuses two ranks on one GPU), each
    launch through parallel.launch.run_ranks, the ranks reading the main
    paths' results through CUDA IPC: the three trajectories (max abs <=
    1e-6 against those frames; every rank's launches exactly one per pose
    chunk of its block), render_view_tiled at main path 1's pose 0 against
    its 640-step oracle (<= 1e-5), render_fused_projectors on main path
    10's four 1280x800 projectors against the one-process fusion (<= 1e-6;
    2 views on 2 ranks, 4 views and 2 views x 2 tiles on 4), and at 4
    ranks two fit steps of main path 12's problem on a (2, 2) (data, tile)
    mesh, their losses within 1e-5 (relative) of main path 12's first
    two; wall ms of each sharded call at 1, 2 and 4 ranks and each rank's
    peak device memory (one card shared by the ranks: no scaling
    measurement); last, entry.dryrun_multichip(4) with its defaults (the
    card; gloo on CUDA tensors, as 4 ranks share it): every rank on the
    card, one loss, its own fused order check.
24. main path 14 (the uniform and hybrid march grids,
    RenderConfig.plane_mode, each step's launch counts zeroed just before
    it): the lateral kernel against its plain march and skip mirror (no
    found flip, max abs 0) on 8 poses of the uniform grid of 256 planes,
    planned as the main path plans it (renderer._march_tables; at least
    90% of its fractions nonzero, so the lerp runs at fractional shifts)
    and on 2 poses of 1536 planes (past the kernel's 1024-plane segment),
    with its bound and ms/frame; render_fast_batch(method="march") over
    main path 1's 96 poses on the uniform and on the hybrid grid (tiers
    ('march',), exactly main path 1's 2 launches each, every launch held
    on 4 poses to the plain versions), PSNR at poses 0, 48 and 95 against
    the 640-step march at most 1 dB under lif_tpu's
    (tools/reference_plane_mode_psnr.py), ms per call (CUDA events,
    median of 5 after a warm-up); main path 9's 60 pairs on the uniform
    grid (6 launches) and main path 10's four 1280x800 projectors at 4
    cameras on the hybrid grid (4 launches), each launch held to the plain
    versions.

Main paths 1-6 also check their launch counts (2, 3, 1, 1, 1, 1), main
paths 8, 9, 10 and 14 each step's against the tiers it took, main path 13
each rank's against its block of poses. The
second-to-last line is the kernels' JSON record (with each kernel's bound:
the larger of its bytes over 3.35 TB/s and its FP32 operations over 67
TFLOP/s, as the source note of its .cu file counts them, a march's
planes counted from this run's crossings, the billboard splat's O(1) per
source pixel, `launches_by_path`, each main path's launches of the
kernel, and for the lateral kernel `uniform_grid`, main path 14's K,
ms/frame, planes per pixel, bound and ms per call of each grid) and the
last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

W, H = 1280, 800
BASELINE = 0.045  # m
INVZ_NEAR, INVZ_FAR = 0.09, 0.0001  # 1/m
N_CHECK = 8  # poses of the kernel-vs-plain check
N_MIRROR = 2  # of them, poses checked against a skip walk's plain mirror
N_MAIN = 96  # poses of the main-path run: two chunks of the default 48
PSNR_MIN = 40.0  # dB against the converged (640-step) march
N_ORBIT = 120  # orbit poses: three chunks of 40
ORBIT_DEG = 15.0  # orbit half-angle
PITCH_DEG = 8.0  # pitch-orbit half-angle
# lif_tpu.render_fast_batch on this scene against its own 640-step
# march at orbit poses 0 (edge, -15 deg), 30 and 60 (center), dB; JAX on
# the CPU at full size (the fidelity of the tier does not depend on the
# backend)
LIF_TPU_PSNR = {0: 37.208, 30: 41.786, 60: 77.470}
# the redesigned kernels' previous designs (one thread per target pixel
# walking its ladder), ms/frame at the same check batches: this script on
# the card named, each just before its redesign
EARLIER_MS = {"target_march": 0.2907, "billboard_march": 0.6173,
              "lateral_march": 0.2252, "scaled_march": 0.2334,
              "scaled_march phase A": 0.9099}
EARLIER_CARD = "NVIDIA H100 80GB HBM3, 700 W"
N_DOLLY = 48  # dolly poses: one chunk of the default 48
TILT_DEG, TILT_PHI, N_TILT = 8.0, 2.0, 16  # tilted orbit: yaw range, pitch
LATERAL_REFINE = 2  # the lateral kernel's refine check (production: 0)
# lif_tpu's tier code on this scene, planned over the whole batch, against
# its own 640-step march at the checked poses, dB; JAX on the CPU at full
# size (the fidelity of a tier does not depend on the backend)
LIF_TPU_DOLLY_PSNR = {0: 52.476, 24: 59.170, 47: 49.916}
LIF_TPU_TILT_PSNR = {0: 33.711, 8: 47.477, 15: 33.917}
# lif_tpu's billboard (the EAGER forward_splat) and mesh
# (render_connected_mesh) modes on this scene against its own 640-step
# march, dB, and their alpha coverage, at lateral pose 0 and orbit pose 0;
# JAX on the CPU at full size (tools/reference_psnr.py). The splat leaves
# disocclusion holes and the mesh culls stretched quads, so neither is
# near the march: the gate holds the port to lif_tpu's values.
LIF_TPU_BILLBOARD_PSNR = {"lateral": 7.126, "orbit": 7.642}
LIF_TPU_MESH_PSNR = {"lateral": 6.453, "orbit": 4.910}
LIF_TPU_COVERAGE = {("billboard", "lateral"): 0.5345,
                    ("billboard", "orbit"): 0.5750,
                    ("mesh", "lateral"): 0.4463, ("mesh", "orbit"): 0.2330}
COVERAGE_TOL = 0.005
# the billboard kernel against forward_splat: hit flips and colour
# mismatches a pose, each (the scatter and the gather dual round apart at
# coverage margins: at most 19 a pose measured on the H100; the tests'
# bound, 1e-3 of the pixels, is 1024 here). Against its plain version,
# which follows the same float sequence, it must agree exactly.
BB_ORACLE_MAX = 64
# main path 8's LIF: view 0's frustum skew, view 1's outpainting (px), its
# three layers' inverse-depth ranges (1/m, near to far) and the
# convergence distance behind stereo_render_data.invd (m)
LIF_SKEW = (0.012, -0.0037)
LIF_OUTPAINT = 128
LIF_LAYERS = ((0.09, 0.02), (0.05, 0.005), (0.02, 0.0001))
LIF_CONVERGENCE = 1.0
LIF_X = 0.135  # BASELINE config 0's fixed novel view, m
N_SEQ = 20  # poses of the sequential pass (bench_configs.py:168-178)
N_VIEWER = 24  # orbit frames of the viewer run
ORBIT_LIF_DEG = 8.0  # main path 8's orbit pose
VIEWER_SWEEP = 2 * ORBIT_LIF_DEG  # deg: the viewer's orbit, +-8
# main path 8's renders: (view, pose of lif_cams)
LIF_RENDERS = ((0, "lateral"), (1, "lateral"), (0, "y-only"), (0, "dolly"),
               (1, "orbit"))
# lif_tpu on main path 8's LIF (loaded with lif_tpu.load_lif_file, PIL
# decode), render_fast_view against its own 640-step march, dB; JAX on
# the CPU at full size (tools/reference_lif_psnr.py)
LIF_TPU_LIF_PSNR = {(0, "lateral"): 41.311, (1, "lateral"): 41.952,
                    (0, "y-only"): 49.600, (0, "dolly"): 53.965,
                    (1, "orbit"): 36.965}
# main path 9 (BASELINE config 2, bench_configs.py:407-485): the stereo
# LIF of make_stereo_lif, 60 pairs (120 eye cameras) 0.5 mm apart, the
# fidelity poses (the mid pose, a 6-degree yaw head pose, an off-axis
# head pose) and an 8-pair batch under a shared camera skew
N_PAIRS = 60
STEREO_DX = 0.0005  # m between pairs
STEREO_MID_X = 0.004  # m, bench_configs.py:447
STEREO_YAW_DEG = 6.0  # bench_configs.py:452-461
STEREO_OFFAXIS = (0.004, 0.01, 0.02)  # m
STEREO_SKEW = (0.01, -0.004)
N_SKEW_PAIRS = 8
LDI_STEREO_X = 0.02  # m: the LDI stereo pose, between the two views
# the checked (batch, pose) of main path 9 and lif_tpu's
# render_stereo_fast_batch there against its own 640-step
# render_stereo_view on the same file, dB; JAX on the CPU at full size
# (tools/reference_stereo_psnr.py, which also prints the file's sha256)
LIF_TPU_STEREO_PSNR = {("mid", 0): 43.224, ("yaw", 0): 43.956,
                       ("offaxis", 0): 42.063, ("skewed", 0): 87.134,
                       ("skewed", 2 * N_SKEW_PAIRS - 1): 43.205}
STEREO_TIERS = {"pairs": "march", "mid": "march", "yaw": "target",
                "offaxis": "scaled", "skewed": "march"}
STEREO_LIF_SHA256 = (
    "00bf3b14560350d8a1cab34073b639181a4e13d99d00b6996bbd3d729bf7251f")
# main path 10 (BASELINE config 4, bench_configs.py:540-600): four
# projectors synthesized from make_scene(0) at x = FUSED_DX i, resampled
# to 3840x2160, fused at four cameras x = FUSED_CAM_X + FUSED_CAM_DX j;
# fidelity at 1280x800 against the FUSED_STEPS-step exact fused oracle at
# each fuse_tol point (None: the config default)
N_FUSED = 4
FUSED_DX = 0.02  # m between projectors
FUSED_CAM_X, FUSED_CAM_DX = 0.05, 0.002  # m
W4, H4 = 3840, 2160
FUSED_SCALE = W4 / W
FUSED_STEPS = 640
FUSE_TOLS = {"default": None, "0.1": 0.1}
# the fused core's footprint at 3840x2160: peak memory at these camera
# counts, then N_FUSED_MANY cameras in one call (its pose chunk bounded by
# the free device memory) frame for frame against calls of FUSED_GROUP
# cameras, which plan their own groups: at most FUSED_GROUP_TOL apart
FUSED_FOOTPRINT = (8, 16)
N_FUSED_MANY, FUSED_GROUP, FUSED_GROUP_TOL = 24, 4, 1e-5
# lif_tpu's render_fused_fast_batch on the same four 1280x800 projectors
# at x = FUSED_CAM_X against its own FUSED_STEPS-step
# render_fused_projectors at the same fuse_tol, dB; JAX on the CPU
# (tools/reference_fused_psnr.py)
LIF_TPU_FUSED_PSNR = {"default": 50.165, "0.1": 52.919}
# main path 11 (the plane-sweep tier, on the scene of main paths 1-7): the
# first N_SWEEP poses of main path 1 with method='sweep' (the soft composite
# and exact_color), the single view at x = SWEEP_VIEW_X with a zoomed
# camera (focal SWEEP_VIEW_FOCAL * W: its layer is not march-eligible and
# falls back to the sweep) and N_SWEEP_ROT rotated poses no march tier
# covers (pitch SWEEP_ROT_DEG, yaw SWEEP_ROT_DEG * (1 + j / 4) deg at
# (0.01 j, SWEEP_ROT_Y, 0) m: the rotated tier's phase A exceeds its y
# window budget, and the transposed route is not yaw-family either)
N_SWEEP = 16
SWEEP_VIEW_X, SWEEP_VIEW_FOCAL = 0.135, 0.9  # m, x W
SWEEP_ROT_Y, SWEEP_ROT_DEG, N_SWEEP_ROT = 0.12, 2.0, 4
# each drive's TierFallbackWarnings (lif_tpu's counts, printed by
# tools/reference_sweep_psnr.py): method='sweep' asked for the sweep
SWEEP_WARNINGS = {"sweep": 0, "exact_color": 0, "view": 1, "rotated": 1}
# lif_tpu at pose 0 of each drive against its own 640-step march, dB; JAX
# on the CPU at full size (tools/reference_sweep_psnr.py)
LIF_TPU_SWEEP_PSNR = {"sweep": 32.615, "exact_color": 33.218,
                      "view": 32.024, "rotated": 33.130}
# the card's pose-0 frame against the CPU port's on the same inputs (sRGB):
# the bf16 colour product's rounding and the first crossings' grazing
# pixels may differ, nothing else
SWEEP_CPU_DB, SWEEP_CPU_OFF = 50.0, 5e-3  # min dB; max share off by > 2e-3
# the solved invz* (solve_depth_aligned at pose 0, the hybrid table) on the
# card against the CPU port's: found flips, max abs where both found (TF32
# in the float32 products would miss it by ~1e-3)
INVZ_CPU_FLIPS, INVZ_CPU_MAX = 100, 1e-4
# main path 12 (scene fitting): make_fit_problem's 1280x800 scene, four
# poses as tests/test_train.py::_setup places them, FIT_DY off the texel
# lattice, Adam for FIT_STEPS steps at FIT_LR on FIT_PLANES sweep planes
FIT_POSES, FIT_DY = 4, 0.001  # m
FIT_INVZ = (2.0, 0.2)  # _setup's range, baseline 1
FIT_NOISE, FIT_SEED = 0.15, 1  # the start: clip(truth + N(0, 0.15), 0, 1)
FIT_STEPS, FIT_LR, FIT_PLANES = 30, 3e-3, 12
FIT_DROP = 0.85  # min(last 5 losses) < FIT_DROP x the first (test_train.py)
# lif_tpu's first three losses on the same problem, JAX on the CPU at full
# size (tools/reference_fit.py), and the card's relative tolerance
LIF_TPU_FIT_LOSSES = (0.003640431445091963, 0.006393398158252239,
                      0.005992839112877846)
FIT_LOSS_RTOL = 1e-3
# main path 13 (multi-device, parallel.sharding on the one card): world
# size 1 on NCCL in this process, then SHARD_RANKS ranks on gloo with CUDA
# tensors (NCCL refuses two ranks on one GPU), each launch through
# parallel.launch.run_ranks within SHARD_TIMEOUT_S; the sharded frames of
# main paths 1, 2 and 4 against theirs (SHARD_TOL), the row-banded exact
# march against main path 1's 640-step oracle (TILED_TOL), the fused
# exact march against the one-process fusion (SHARD_TOL) and
# FIT_SHARD_STEPS sharded fit steps on a FIT_MESH (data, tile) mesh
# against main path 12's first losses (relative FIT_SHARD_RTOL)
SHARD_RANKS = (2, 4)
SHARD_TIMEOUT_S = 300.0
SHARD_TOL, TILED_TOL = 1e-6, 1e-5
FIT_MESH, FIT_SHARD_STEPS, FIT_SHARD_RTOL = (2, 2), 2, 1e-5
# main path 14 (the uniform and hybrid march grids): main path 1's poses
# through render_fast_batch(method='march') on each grid of PLANE_MODE_K
# planes (config.march_planes), PSNR at PLANE_MODE_POSES; the kernel
# against its plain versions on an N_CHECK-pose batch of the uniform grid
# (at least FRACTION_MIN of its fractions nonzero) and on a
# N_SEGMENT-pose batch of SEGMENT_K uniform planes, past the kernel's
# 1024-plane segment; main path 9's pairs on the uniform grid and main
# path 10's 1280x800 projectors at N_FUSED cameras on the hybrid grid
PLANE_MODES = ("uniform", "hybrid")
PLANE_MODE_K, PLANE_MODE_POSES = 256, (0, 48, 95)
FRACTION_MIN = 0.9
N_SEGMENT, SEGMENT_K = 2, 1536
# lif_tpu's render_fast_batch on each grid against its own 640-step march
# at the checked poses, dB; JAX on the CPU at full size
# (JAX_PLATFORMS=cpu python3 tools/reference_plane_mode_psnr.py, about 6
# minutes on a CPU)
LIF_TPU_PLANE_MODE_PSNR = {("uniform", 0): 39.667, ("uniform", 48): 39.043,
                           ("uniform", 95): 38.318, ("hybrid", 0): 39.300,
                           ("hybrid", 48): 38.667, ("hybrid", 95): 38.147}
# the H100 SXM's published peaks: HBM bytes/s and FP32 operations/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the FP32 operation count in each kernel's source note
OPS_NOTE = re.compile(
    r"FP32 ops: per plane (\d+), per pixel (\d+), per found (\d+)\.")


class SmokeFailure(Exception):
    pass


# what main paths 1, 2, 4, 10 and 12 computed, on the card, which main
# path 13 holds its shards to
MAIN_FRAMES: dict = {}


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors among the arguments (each read or written
    once)."""
    import torch

    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def planes_walked(found, invz, plane_invz, v_top) -> int:
    """Planes a first-crossing march visits, summed over pixels and poses:
    from the plane before the first one any texel can reach (its inverse
    depth at most v_top, the largest decoded texel) through the crossing
    (the planes above invz*, plus the crossing itself), or every
    reachable plane where it finds none. plane_invz: (B, K)."""
    import torch

    b, k = plane_invz.shape
    asc = torch.sort(plane_invz.to(torch.float32), dim=-1).values
    top = torch.full((b, 1), float(v_top), device=asc.device)
    skipped = k - torch.searchsorted(asc, top, right=True)  # above v_top
    above = k - torch.searchsorted(asc, invz.reshape(b, -1).contiguous(),
                                   right=True)
    walked = torch.where(found.reshape(b, -1) > 0, above + 1, k) - skipped
    return int(walked.clamp(1, k).sum())


def bound_record(name, source, nbytes, walked, n_px, n_found, frames):
    """(bound_ms per frame, bound_by): the larger of the bytes over the HBM
    rate and the FP32 operations over the FP32 peak, the operations as the
    source note of `source` counts them per plane visited, per pixel and
    per pixel that finds its crossing or winner."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, source)) as f:
        note = OPS_NOTE.search(f.read())
    check(note is not None, f"{source} states no FP32 op count")
    per_plane, per_px, per_found = (int(g) for g in note.groups())
    ops = per_plane * walked + per_px * n_px + per_found * n_found
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3 / frames
    t_ops = ops / FP32_OPS_PER_S * 1e3 / frames
    print(f"{name} bound: {nbytes / 1e6:.1f} MB -> {t_bytes:.5f} ms/frame, "
          f"{ops / 1e9:.3f} GFLOP ({walked / n_px:.1f} planes per pixel) -> "
          f"{t_ops:.5f} ms/frame", flush=True)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def kernel_record(name, source, replaces, launches, err, ms, plain_ms, bound):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,  # no single PyTorch call computes this march
    }


def make_scene(seed: int = 0):
    from tests.scenes import smooth_noise  # numpy only

    rng = np.random.default_rng(seed)
    disp = smooth_noise(rng, H, W, octaves=3, lo=0.2, hi=0.8)
    disp[H // 3 : H // 2, W // 3 : W // 2] = 0.95  # near box: a hard edge
    rgb = np.stack([smooth_noise(rng, H, W, octaves=4) for _ in range(3)], -1)
    return rgb.astype(np.float32), disp.astype(np.float32)


def make_lif(seed: int = 0) -> bytes:
    """Main path 8's LIF file, authored in memory from the seed with the
    port's PNG encoder and container writer (numpy and the port's io
    only). View 0: make_scene(seed) as one layer with frustum skew
    LIF_SKEW. View 1: a 3-layer LDI in the legacy layered_depth_image_data
    form, each layer LIF_OUTPAINT px wider and taller than the view, the
    two front layers masked; its stored inverse-depth ranges are those
    process_views divides by (1 + outpaint / width) and by
    -focal_ratio_to_width, so the loaded ranges are LIF_LAYERS. Both views
    at the origin; stereo_render_data.invd puts the convergence plane
    LIF_CONVERGENCE m away."""
    from lif_tpu_torch.io import container
    from lif_tpu_torch.io.decode import encode_png
    from tests.scenes import smooth_noise  # numpy only

    ratio = 0.78
    rgb, disp = make_scene(seed)
    rng = np.random.default_rng(seed + 1)
    hl, wl = H + LIF_OUTPAINT, W + LIF_OUTPAINT
    blobs = {20: encode_png(disp)}
    common = {
        "image": {"blob_id": -1},
        "inv_z_map": {"blob_id": 20, "min": INVZ_NEAR, "max": INVZ_FAR},
        "width_px": W, "height_px": H, "focal_px": ratio * W,
        "position": [0.0, 0.0, 0.0], "rotation": [0.0, 0.0, 0.0],
    }
    layers = []
    scale = -(1.0 + LIF_OUTPAINT / W) * ratio
    for i, (near, far) in enumerate(LIF_LAYERS):
        l_disp = smooth_noise(rng, hl, wl, octaves=3, lo=0.1, hi=0.9)
        l_rgb = np.stack([smooth_noise(rng, hl, wl, octaves=4)
                          for _ in range(3)], -1)
        mask = (np.ones((hl, wl)) if i == len(LIF_LAYERS) - 1 else
                (smooth_noise(rng, hl, wl, octaves=2) > 0.45).astype(float))
        ids = (30 + 3 * i, 31 + 3 * i, 32 + 3 * i)
        for blob_id, arr in zip(ids, (l_rgb, l_disp, mask)):
            blobs[blob_id] = encode_png(arr)
        layers.append({
            "image": {"blob_id": ids[0]},
            "inv_z_map": {"blob_id": ids[1], "min": near * scale,
                          "max": far * scale},
            "mask": {"blob_id": ids[2]},
        })
    views = [
        dict(common, frustum_skew=list(LIF_SKEW)),
        dict(common, camera_data={"focal_ratio_to_width": ratio},
             layered_depth_image_data={
                 "outpainting_added_width_px": LIF_OUTPAINT,
                 "outpainting_added_height_px": LIF_OUTPAINT,
                 "layers_top_to_bottom": layers,
             }),
    ]
    meta = {"views": views, "baseline_mm": BASELINE * 1e3,
            "stereo_render_data": {"invd": BASELINE / LIF_CONVERGENCE}}
    return container.write(encode_png(rgb), meta, blobs)


def make_stereo_lif(seed: int = 0) -> bytes:
    """Main path 9's stereo LIF, authored from the seed after
    examples/multiview_demo.py:34-111 with PNG payloads: the left view is
    make_scene(seed) at -baseline/2 (LIF position -0.5); the right view
    at +baseline/2 is synthesized from the left alone by the port ON THE
    CPU (render_fast_view with to_srgb=True, mask_mode='none',
    feathering=0, and render_depth_fast), so the bytes do not depend on
    the card. Both views 1280x800, focal 0.78 W, inverse depth
    INVZ_FAR..INVZ_NEAR; stereo_render_data.invd puts the convergence
    plane LIF_CONVERGENCE m away."""
    import lif_tpu_torch as lt
    from lif_tpu_torch.io import container
    from lif_tpu_torch.io.decode import encode_png

    rgb, disp = make_scene(seed)
    view = {"width_px": W, "height_px": H, "focal_px": 0.78 * W,
            "rotation": [0.0, 0.0, 0.0]}
    left = dict(view, position=[-0.5, 0.0, 0.0], image={"blob_id": -1},
                inv_z_map={"blob_id": 20, "min": INVZ_NEAR,
                           "max": INVZ_FAR})
    image, blobs = encode_png(rgb), {20: encode_png(disp)}
    mono = {"views": [left], "baseline_mm": BASELINE * 1e3}
    proj = lt.load_lif_file(container.write(image, mono, blobs),
                            device="cpu").projectors[0]
    cam_r = lt.Camera.create(W, H, focal_px=float(proj.focal[0]),
                             position=[BASELINE / 2, 0.0, 0.0])
    rgb_r = lt.render_fast_view(proj, cam_r, to_srgb=True, mask_mode="none",
                                feathering=0.0)[..., :3].numpy()
    invz_r = lt.render_depth_fast(proj, cam_r).numpy()
    blobs[30] = encode_png(rgb_r)
    blobs[31] = encode_png(np.clip(
        (invz_r - INVZ_FAR) / (INVZ_NEAR - INVZ_FAR), 0.0, 1.0))
    right = dict(view, position=[0.5, 0.0, 0.0], image={"blob_id": 30},
                 inv_z_map={"blob_id": 31, "min": INVZ_NEAR,
                            "max": INVZ_FAR})
    meta = {"views": [left, right], "baseline_mm": BASELINE * 1e3,
            "stereo_render_data": {"invd": BASELINE / LIF_CONVERGENCE}}
    return container.write(image, meta, blobs)


def make_fusion_projectors(seed: int = 0):
    """Main path 10's four 1280x800 projectors: make_scene(seed) as a
    projector at the origin (focal 0.78 W, INVZ_FAR..INVZ_NEAR, the
    baseline), and from it one projector synthesized at x = FUSED_DX i
    (synthesize_projector: the fast view and its solved depth there) by
    the port ON THE CPU, so they do not depend on the card
    (bench_configs.py:548-553). Returns the CPU projectors."""
    import lif_tpu_torch as lt

    rgb, disp = make_scene(seed)
    base = lt.projector_from_arrays(
        rgb, disp, focal_px=0.78 * W, invz_min=INVZ_NEAR, invz_max=INVZ_FAR,
        baseline=BASELINE, device="cpu")
    return [lt.synthesize_projector(base, [FUSED_DX * i, 0.0, 0.0])
            for i in range(N_FUSED)]


def stereo_cams(lt, focal, eye):
    """Main path 9's camera batches, {name: [Camera, ...]}: 'pairs', the
    N_PAIRS pairs at (-+eye + STEREO_DX i, 0, 0) (bench_configs.py:416-424);
    'mid', 'yaw' and 'offaxis', one camera each; 'skewed', N_SKEW_PAIRS
    pairs under the camera skew STEREO_SKEW."""
    def cam(pos, rot=None, skew=(0.0, 0.0)):
        return lt.Camera.create(W, H, focal_px=focal, position=pos,
                                rotation=rot, skew=skew)

    def pairs(n, skew=(0.0, 0.0)):
        return [cam([s * eye + STEREO_DX * i, 0.0, 0.0], skew=skew)
                for i in range(n) for s in (-1.0, 1.0)]

    th = np.deg2rad(STEREO_YAW_DEG)
    yaw = np.array([[np.cos(th), 0.0, np.sin(th)], [0.0, 1.0, 0.0],
                    [-np.sin(th), 0.0, np.cos(th)]])
    return {"pairs": pairs(N_PAIRS), "mid": [cam([STEREO_MID_X, 0.0, 0.0])],
            "yaw": [cam([STEREO_MID_X, 0.0, 0.0], yaw)],
            "offaxis": [cam(list(STEREO_OFFAXIS))],
            "skewed": pairs(N_SKEW_PAIRS, STEREO_SKEW)}


def lif_cams(lt, proj, orbit_center):
    """Main path 8's poses on a loaded view `proj`, {name: Camera}: the
    fixed novel view (BASELINE config 0), a y-only pose, a dolly pose and
    an orbit pose of ORBIT_LIF_DEG about orbit_center (the viewer's
    radius: the view's distance to it)."""
    focal = float(proj.focal[0])
    radius = float(np.linalg.norm(np.asarray(proj.position) - orbit_center))
    pos, rot = lt.orbit_pose(orbit_center, radius,
                             float(np.deg2rad(ORBIT_LIF_DEG)))
    poses = {"lateral": ([LIF_X, 0.0, 0.0], None),
             "y-only": ([0.0, 0.05, 0.0], None),
             "dolly": ([0.02, 0.01, 0.05], None),
             "orbit": (pos, rot)}
    return {name: lt.Camera.create(W, H, focal_px=focal, position=p,
                                   rotation=r)
            for name, (p, r) in poses.items()}


def orbit_cams(lt, focal, thetas=(), phis=()):
    return [
        lt.Camera.create(W, H, focal_px=focal, position=p, rotation=r)
        for p, r in (
            lt.orbit_pose([0.0, 0.0, -1.0], 1.0, t, ph)
            for t, ph in zip(thetas or [0.0] * len(phis),
                             phis or [0.0] * len(thetas))
        )
    ]


def dolly_cams(lt, focal):
    t = np.linspace(0.0, 1.0, N_DOLLY)
    z = np.linspace(-0.05, 0.05, N_DOLLY)
    return [
        lt.Camera.create(W, H, focal_px=focal, position=[
            0.03 * np.cos(2 * np.pi * a), 0.02 * np.sin(2 * np.pi * a), b])
        for a, b in zip(t, z)
    ]


def rot_x(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def rot_y(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def sweep_drives(lt, focal):
    """Main path 11's drives, {name: (cameras, keyword arguments)}: 'sweep'
    and 'exact_color' render_fast_batch the first N_SWEEP poses of main
    path 1 with method='sweep'; 'view' is render_fast_view of its one
    zoomed camera; 'rotated' render_fast_batch (method 'auto') of
    N_SWEEP_ROT rotated poses."""
    lateral = [lt.Camera.create(W, H, focal_px=focal, position=[
        0.135 + 0.02 * i / N_MAIN, 0.0, 0.0]) for i in range(N_SWEEP)]
    view = [lt.Camera.create(W, H, focal_px=SWEEP_VIEW_FOCAL * W,
                             position=[SWEEP_VIEW_X, 0.0, 0.0])]
    rotated = [lt.Camera.create(
        W, H, focal_px=focal, position=[0.01 * j, SWEEP_ROT_Y, 0.0],
        rotation=rot_x(SWEEP_ROT_DEG) @ rot_y(SWEEP_ROT_DEG * (1 + j / 4)))
        for j in range(N_SWEEP_ROT)]
    return {"sweep": (lateral, {"method": "sweep"}),
            "exact_color": (lateral, {"method": "sweep",
                                      "exact_color": True}),
            "view": (view, {}), "rotated": (rotated, {})}


def make_fit_problem(seed: int = 0):
    """Main path 12's problem, numpy only: make_scene(seed)'s colour and
    disparity (the truth), the start clip(truth + N(0, FIT_NOISE), 0, 1)
    drawn from FIT_SEED, and FIT_POSES world poses placed as
    tests/test_train.py::_setup places them, moved FIT_DY in y: _setup's
    pose 0 (y = z = 0) reads the source exactly at texel centres, where a
    bilinear read's derivative along y is one-sided and two float orders
    pick different sides. Returns (rgb, truth, start, positions,
    rotations)."""
    rgb, truth = make_scene(seed)
    rng = np.random.default_rng(FIT_SEED)
    start = np.clip(truth + rng.normal(0.0, FIT_NOISE, truth.shape), 0.0,
                    1.0).astype(np.float32)
    b = FIT_POSES
    positions = np.stack([[0.05 * (i - b / 2), 0.02 * i + FIT_DY, 0.0]
                          for i in range(b)])
    return rgb, truth, start, positions, np.stack([np.eye(3)] * b)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def psnr(a, b) -> float:
    mse = float(((a[..., :3] - b[..., :3]) ** 2).mean())
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def run():
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import lif_tpu_torch
        from lif_tpu_torch.core.pose import relative_view_pose
        from lif_tpu_torch.io import native
        from lif_tpu_torch.models import renderer
        from lif_tpu_torch.ops.cuda import build
        from lif_tpu_torch.ops.cuda import sweep_march as kmarch
        from lif_tpu_torch.ops.sweep_march import (
            march_translation_plain,
            march_translation_skip_plain,
        )
        from lif_tpu_torch.utils.profiling import device_timer
    except ImportError as e:
        raise SmokeFailure(
            f"the lif_tpu_torch package must sit beside chip_smoke.py: {e}"
        ) from e
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device
    card = card_line()
    print(card, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)

    # 2. build, one nvcc per source and g++ for the LIF codec, all started
    # together
    sources = ("sweep_march", "sweep_target", "sweep_scaled", "splat_march")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        codec = pool.submit(native.load_library)
        list(pool.map(build.load_library, sources))
        check(codec.result() is not None,
              f"the LIF codec did not build: {native.build_error()}")
    print(f"build: {', '.join(f'{n}.cu' for n in sources)} and "
          f"lif_container.cpp in {time.perf_counter() - t0:.2f} s "
          f"({build.BUILD_DIR})", flush=True)
    for name in sources:
        for log in build.BUILD_DIR.glob(f"lib{name}-*.log"):
            for line in log.read_text().splitlines():
                # the kernel (a mangled name), then its registers and spills
                if ("entry function" in line or "registers" in line
                        or "spill" in line):
                    print(f"  ptxas {name}: {line.strip()}", flush=True)

    counter = launch_counter()

    def reset_counts():
        counter(reset=True)

    def launch_counts():
        return counter()

    rgb, disp = make_scene(0)
    proj = lif_tpu_torch.projector_from_arrays(
        rgb, disp, focal_px=0.78 * W, invz_min=INVZ_NEAR, invz_max=INVZ_FAR,
        baseline=BASELINE, device=dev,
    )
    focal = float(proj.focal[0])

    def cam(x):
        return lif_tpu_torch.Camera.create(W, H, focal_px=focal,
                                           position=[x, 0.0, 0.0])

    # 3. kernel vs plain, at the main path's shapes (its planning)
    cams8 = [cam(0.135 + 0.02 * i / N_CHECK) for i in range(N_CHECK)]
    c1 = np.stack([
        relative_view_pose(proj.position, proj.rotation, c.position,
                           c.rotation)[0]
        for c in cams8
    ]).astype(np.float32)
    lay = renderer._prepared_textures(proj)[0]
    plan = renderer._march_plan(lay, float(np.abs(c1[:, 0]).max()), W, H)
    planes, k = renderer._snap_tables(lay, c1[:, 0], None, 0.0, 1, dev)
    tex = (lay["rgb"], lay["disp"], lay["mask"])
    izmin, izmax, f1 = lay["izmin_host"], lay["izmax_host"], lay["focal_host"]
    prep = kmarch.prepare_translation_src(*tex, plan)
    args = kmarch.lateral_kernel_inputs(prep, izmin, izmax, c1, f1, planes,
                                        plan, k)
    found = invz = rgba = None
    for refine in (0, LATERAL_REFINE):
        out = kmarch.sweep_lateral(*args, refine=refine,
                                   rows=lay["skip_rows"])
        torch.cuda.synchronize()
        # against the plain march and the plain mirror of the kernel's skip
        # walk: (found mismatches, max abs) each
        worst = {"plain": (0, 0.0), "skip mirror": (0, 0.0)}
        for i in range(N_CHECK):
            for label, plain in (("plain", march_translation_plain),
                                 ("skip mirror",
                                  march_translation_skip_plain)):
                if label == "skip mirror" and i >= N_MIRROR:
                    continue
                ref = plain(*tex, izmin, izmax, c1[i], f1, planes[i], plan,
                            k, refine=refine)
                flips = int((out[0][i] != ref[0]).sum())
                err = max(float((got[i] - want).abs().max())
                          for got, want in zip(out[1:], ref[1:]))
                worst[label] = (worst[label][0] + flips,
                                max(worst[label][1], err))
        print(f"lateral kernel vs plain, refine {refine} ({N_CHECK} poses, "
              f"{W}x{H}, K={k}): found mismatches {worst['plain'][0]}, max "
              f"abs {worst['plain'][1]:.3g}; vs its skip mirror "
              f"({N_MIRROR} poses): found mismatches "
              f"{worst['skip mirror'][0]}, max abs "
              f"{worst['skip mirror'][1]:.3g}; found share "
              f"{float(out[0].mean()):.4f}", flush=True)
        check(worst["plain"] == (0, 0.0) and worst["skip mirror"] == (0, 0.0),
              f"refine {refine}: the lateral kernel is not exact")
        if refine == 0:  # the production configuration, timed below
            found, invz, rgba = out
            err_lateral = max(worst["plain"][1], worst["skip mirror"][1])
        del out
    v_top = izmax + (izmin - izmax) * float(lay["disp"].max())
    lateral_bound = bound_record(
        "lateral_march", "lif_tpu_torch/csrc/sweep_march.cu",
        tensor_bytes(*args, found, invz, rgba),
        planes_walked(found, invz, planes, v_top), found.numel(),
        int(found.sum()), N_CHECK)

    # 4. main path 1, with every launch count zeroed just before it
    cams = trajectory_drives(lif_tpu_torch, focal)["lateral"][0]
    reset_counts()
    out, tiers = lif_tpu_torch.render_fast_batch(
        proj, cams, method="march", return_tiers=True
    )
    torch.cuda.synchronize()
    launches = kmarch.sweep_lateral.launches
    record_path("main path 1", launch_counts())
    coverage = float(out[..., 3].mean())
    print(f"main path: render_fast_batch({N_MAIN} poses) -> "
          f"{tuple(out.shape)}, tiers {tiers}, lateral_march launches "
          f"{launches}, alpha coverage {coverage:.4f}", flush=True)
    check(tiers == ("march",), f"tiers {tiers}")
    check(launches == 2, f"{launches} lateral launches for two pose chunks")
    check(tuple(out.shape) == (N_MAIN, H, W, 4), f"shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite output")
    check(0.5 < coverage <= 1.0, f"alpha coverage {coverage}")

    exact = lif_tpu_torch.render_mono_view(proj, cams[0], mask_mode="none",
                                           num_steps=640)
    MAIN_FRAMES.update(lateral=out, lateral_exact=exact)
    ref40 = lif_tpu_torch.render_mono_view(proj, cams[0], mask_mode="none",
                                           num_steps=40)
    q_fast = psnr(out[0], exact)
    q_40 = psnr(ref40, exact)
    # the columns whose rays can leave the source (x > W at near planes):
    # there the march's 2-texel border clamp and the fast path's edge
    # replication pick different first crossings
    strip = int(np.ceil(focal * abs(float(c1[0, 0])) * lay["izmin_host"]))
    q_inner = psnr(out[0][:, : W - strip], exact[:, : W - strip])
    print(f"fidelity vs the 640-step march at pose 0: fast path "
          f"{q_fast:.2f} dB, 40-step march {q_40:.2f} dB "
          f"(gate {PSNR_MIN:g} dB); fast path {q_inner:.2f} dB outside "
          f"the {strip}-column exit strip", flush=True)
    check(q_fast >= PSNR_MIN, f"fast path only {q_fast:.2f} dB")

    # 5. timing on the card
    batch_ms = device_timer(lif_tpu_torch.render_fast_batch, proj, cams,
                            method="march", iters=1, repeats=5)
    fps = N_MAIN / (batch_ms / 1e3)
    # with the skip tables the main path caches with the textures
    kernel_ms = device_timer(kmarch.sweep_lateral, *args,
                             rows=lay["skip_rows"], iters=10, repeats=5)
    plain_ms = device_timer(lambda: [
        march_translation_plain(*tex, izmin, izmax, c1[i], f1, planes[i],
                                plan, k)
        for i in range(N_CHECK)
    ], iters=1, repeats=3)
    print(f"render_fast_batch: {batch_ms:.3f} ms per {N_MAIN} poses = "
          f"{fps:.1f} frames/s at {W}x{H} [{card}]", flush=True)
    print(f"lateral_march kernel: {kernel_ms / N_CHECK:.4f} ms/frame (previous "
          f"design: {EARLIER_MS['lateral_march']} on {EARLIER_CARD}), plain "
          f"march {plain_ms / N_CHECK:.3f} ms/frame ({N_CHECK}-pose batch, "
          f"K={k}) [{card}]", flush=True)
    lateral = kernel_record(
        "lateral_march", "lif_tpu_torch/csrc/sweep_march.cu",
        "lif_tpu/ops/pallas/sweep_march.py:124", launches, err_lateral,
        kernel_ms / N_CHECK, plain_ms / N_CHECK, lateral_bound)
    target = orbit_phases(proj, focal, lay, reset_counts, card)
    scaled = scaled_phases(proj, focal, lay, reset_counts, card)
    billboard = billboard_phases(proj, focal, lay, cams, reset_counts,
                                 launch_counts, card)
    # main paths 8, 9 and 10 held each launch to the plain versions: their
    # worst errors join each kernel's record
    errs, views = lif_phase(reset_counts, launch_counts, card)
    errs9 = stereo_phase(reset_counts, launch_counts, card, views[1])
    errs10 = fusion_phase(reset_counts, launch_counts, card)
    sweep_phase(proj, focal, reset_counts, launch_counts, card)
    fit_phase(reset_counts, launch_counts, card, dev)
    shard_phase(proj, focal, reset_counts, launch_counts, card)
    errs14, lateral["uniform_grid"] = plane_mode_phase(
        proj, focal, lay, reset_counts, launch_counts, card)
    kernels = [lateral, target, scaled, billboard]
    for rec in kernels:
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 *(e.get(rec["name"], 0.0)
                                   for e in (errs, errs9, errs10, errs14)))
        rec["launches_by_path"] = {
            path: counts[rec["name"]]
            for path, counts in LAUNCHES_BY_PATH.items()
            if counts.get(rec["name"])}
    return {"kernels": kernels}, card


def orbit_phases(proj, focal, lay, reset_counts, card):
    """Phases 6-9: the target-ray kernel against its plain version, the
    120-pose orbit and the pitch route through render_fast_batch, and
    their timing. Returns the kernel's JSON record."""
    import torch

    import lif_tpu_torch as lt
    from lif_tpu_torch.core.pose import relative_view_pose
    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.ops import sweep_target as starget
    from lif_tpu_torch.ops.cuda import sweep_target as ktarget
    from lif_tpu_torch.utils.profiling import device_timer

    izmin, izmax = lay["izmin_host"], lay["izmax_host"]
    disp = lay["disp"]

    # 6. kernel vs plain at the main path's shapes (its planning)
    cams8 = orbit_cams(lt, focal, thetas=list(
        np.deg2rad(np.linspace(-ORBIT_DEG, ORBIT_DEG, N_CHECK))))
    pos8, rot8 = zip(*(relative_view_pose(proj.position, proj.rotation,
                                          c.position, c.rotation)
                       for c in cams8))
    plan = starget.plan_target(W, H, W, H, focal, focal, rot8, pos8, izmin,
                               izmax)[0]
    poses = torch.as_tensor(np.stack([
        starget.target_pose_scalars(r, c, focal, focal, W, H, W, H)
        for r, c in zip(rot8, pos8)
    ]), device=disp.device)
    rgbm = starget._rgbm_stack(lay["rgb"], lay["mask"])
    max_err, kernel_args = 0.0, None
    for name, step_px, refine, color in (
        ("depth-only", 1.0, 0, False), ("depth-only 2-px ladder", 2.0, 1,
                                        False), ("full color", 1.0, 0, True),
    ):
        grids, k = starget.target_plane_grids(
            rot8, pos8, focal, focal, W, H, W, H, izmin, izmax,
            step_px=step_px)
        grids = torch.as_tensor(grids, device=disp.device)
        out = ktarget.march_target_cuda(
            disp, izmin, izmax, poses, grids, plan, refine=refine,
            rgbm=rgbm if color else None, tables=lay["skip_target"])
        torch.cuda.synchronize()
        if kernel_args is None:  # the production configuration, timed below
            kernel_args = (disp, izmin, izmax, poses, grids, plan)
            v_top = izmax + (izmin - izmax) * float(disp.max())
            # inputs: disp, the pose packs, the ladder and its thresholds
            target_bound = bound_record(
                "target_march", "lif_tpu_torch/csrc/sweep_target.cu",
                tensor_bytes(disp, poses, grids, grids, *out),
                planes_walked(out[0], out[1], grids, v_top), out[0].numel(),
                int(out[0].sum()), N_CHECK)
        # against the plain march and the plain mirror of the kernel's
        # skip walk: (found mismatches, max abs) each
        worst = {"plain": (0, 0.0), "skip mirror": (0, 0.0)}
        for i in range(N_CHECK):
            kw = dict(refine=refine, rgbm=rgbm if color else None)
            for label, plain in (("plain", starget.march_target_plain),
                                 ("skip mirror",
                                  starget.march_target_skip_plain)):
                ref = plain(disp, izmin, izmax, poses[i], grids[i], W, H,
                            **kw)
                flips = int((out[0][i] != ref[0]).sum())
                err = max(float((got[i] - want).abs().max())
                          for got, want in zip(out[1:], ref[1:]))
                worst[label] = (worst[label][0] + flips,
                                max(worst[label][1], err))
        print(f"target kernel vs plain, {name} ({N_CHECK} poses, {W}x{H}, "
              f"K={k}, refine {refine}): found mismatches "
              f"{worst['plain'][0]} of {N_CHECK * W * H}, max abs "
              f"{worst['plain'][1]:.3g}; vs its skip mirror: found "
              f"mismatches {worst['skip mirror'][0]}, max abs "
              f"{worst['skip mirror'][1]:.3g}; found share "
              f"{float(out[0].mean()):.4f}", flush=True)
        check(worst["plain"] == (0, 0.0) and worst["skip mirror"] == (0, 0.0),
              f"{name}: the target kernel is not exact")
        max_err = max(max_err, worst["plain"][1])

    # 7. main path 2: the orbit, every launch count zeroed just before it
    thetas = np.deg2rad(np.linspace(-ORBIT_DEG, ORBIT_DEG, N_ORBIT))
    cams = trajectory_drives(lt, focal)["orbit"][0]
    reset_counts()
    out, tiers = lt.render_fast_batch(proj, cams, return_tiers=True)
    torch.cuda.synchronize()
    launches = ktarget.sweep_target.launches
    record_path("main path 2", {"target_march": launches})
    coverage = float(out[..., 3].mean())
    print(f"main path 2: render_fast_batch({N_ORBIT} orbit poses, +-"
          f"{ORBIT_DEG:g} deg) -> {tuple(out.shape)}, tiers {tiers}, "
          f"target_march launches {launches}, alpha coverage "
          f"{coverage:.4f}", flush=True)
    MAIN_FRAMES["orbit"] = out
    check(tiers == ("target",), f"orbit tiers {tiers}")
    check(launches == 3, f"{launches} target launches for three chunks")
    check(tuple(out.shape) == (N_ORBIT, H, W, 4), f"shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite orbit output")
    check(0.5 < coverage <= 1.0, f"orbit alpha coverage {coverage}")
    for i, ref_db in LIF_TPU_PSNR.items():
        exact = lt.render_mono_view(proj, cams[i], mask_mode="none",
                                    num_steps=640)
        q = psnr(out[i], exact)
        print(f"fidelity vs the 640-step march at orbit pose {i} (theta "
              f"{np.rad2deg(thetas[i]):+.2f} deg): {q:.2f} dB, lif_tpu "
              f"{ref_db:.2f} dB", flush=True)
        check(q >= ref_db - 1.0, f"pose {i}: {q:.2f} dB, lif_tpu {ref_db}")
        if i == N_ORBIT // 2:
            check(q >= PSNR_MIN, f"center pose only {q:.2f} dB")

    # 8. main path 3: pitch poses through the transposed route
    phis = np.deg2rad(np.linspace(-PITCH_DEG, PITCH_DEG, N_CHECK))
    pcams = orbit_cams(lt, focal, phis=list(phis))
    n_transposed = len(renderer._TRANSPOSED_CACHE)
    reset_counts()
    pout, ptiers = lt.render_fast_batch(proj, pcams, return_tiers=True)
    torch.cuda.synchronize()
    plaunches = ktarget.sweep_target.launches
    record_path("main path 3", {"target_march": plaunches})
    transposed = len(renderer._TRANSPOSED_CACHE) > n_transposed
    print(f"main path 3: render_fast_batch({N_CHECK} pitch poses, +-"
          f"{PITCH_DEG:g} deg) -> {tuple(pout.shape)}, tiers {ptiers}, "
          f"transposed route {transposed}, target_march launches "
          f"{plaunches}, alpha coverage {float(pout[..., 3].mean()):.4f}",
          flush=True)
    check(ptiers == ("target",), f"pitch tiers {ptiers}")
    check(transposed, "the pitch batch did not take the transposed route")
    check(plaunches == 1, f"{plaunches} target launches on the pitch route")
    check(tuple(pout.shape) == (N_CHECK, H, W, 4), "pitch output shape")
    check(bool(torch.isfinite(pout).all()), "non-finite pitch output")

    # 9. timing on the card
    batch_ms = device_timer(lt.render_fast_batch, proj, cams, iters=1,
                            repeats=5)
    kernel_ms = device_timer(ktarget.march_target_cuda, *kernel_args,
                             tables=lay["skip_target"], iters=10, repeats=5)
    disp_, _, _, poses_, grids_, _ = kernel_args
    plain_ms = device_timer(lambda: [
        starget.march_target_plain(disp_, izmin, izmax, poses_[i],
                                   grids_[i], W, H)
        for i in range(N_CHECK)
    ], iters=1, repeats=5)
    print(f"render_fast_batch orbit: {batch_ms:.3f} ms per {N_ORBIT} poses "
          f"= {N_ORBIT / (batch_ms / 1e3):.1f} frames/s at {W}x{H} [{card}]",
          flush=True)
    print(f"target_march kernel: {kernel_ms / N_CHECK:.4f} ms/frame (previous "
          f"design: {EARLIER_MS['target_march']} on {EARLIER_CARD}), plain "
          f"march "
          f"{plain_ms / N_CHECK:.3f} ms/frame ({N_CHECK}-pose batch, "
          f"K={grids_.shape[1]}, depth only) [{card}]", flush=True)
    return kernel_record(
        "target_march", "lif_tpu_torch/csrc/sweep_target.cu",
        "lif_tpu/ops/pallas/sweep_target.py:89", launches, max_err,
        kernel_ms / N_CHECK, plain_ms / N_CHECK, target_bound)


def scaled_phases(proj, focal, lay, reset_counts, card):
    """Phases 10-13: the scaled kernel against its plain version, the
    48-pose dolly ('scaled') and the 16-pose tilted orbit ('rotated', the
    kernel in phase A) through render_fast_batch, and their timing.
    Returns the kernel's JSON record."""
    import torch

    import lif_tpu_torch as lt
    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.ops import sweep_scaled as sscaled
    from lif_tpu_torch.ops import sweep_target as starget
    from lif_tpu_torch.ops.cuda import sweep_scaled as kscaled
    from lif_tpu_torch.utils.profiling import device_timer

    izmin, izmax, f1 = lay["izmin_host"], lay["izmax_host"], lay["focal_host"]
    disp = lay["disp"]
    refine = lt.DEFAULT_CONFIG.rotated_refine  # both tiers' production value
    cams = dolly_cams(lt, focal)
    thetas = np.deg2rad(np.linspace(-TILT_DEG, TILT_DEG, N_TILT))
    tcams = orbit_cams(lt, focal, thetas=list(thetas),
                       phis=[np.deg2rad(TILT_PHI)] * N_TILT)

    # 10. kernel vs plain at both main paths' shapes, planned as
    # render_fast_batch plans them: the dolly's scaled tier (output = the
    # source, one shared ladder) and the tilted orbit's phase A (a wider
    # intermediate than the source, per-pose ladders, fr = 1)
    dplan = renderer.plan_tiers(proj, cams)
    mode, (plan, k, fr, dxu, dyu), extra = dplan.planned[0]
    check(mode == "scaled", f"the dolly plans onto {mode!r}")
    c1 = dplan.pos_b[:N_CHECK]
    tabs = sscaled.scaled_table_stack(
        plan, extra["grids"][:N_CHECK],
        torch.as_tensor(c1, dtype=torch.float32, device=disp.device), f1, fr,
        dxu, dyu)
    tmode, tsetup, textra = renderer.plan_tiers(proj, tcams).planned[0]
    check(tmode == "rotated", f"the tilted orbit plans onto {tmode!r}")
    rplan, k_r, skip = tsetup[0], tsetup[3], tsetup[4]
    check(not skip, "the tilted orbit skips phase A")
    rtabs = sscaled.scaled_table_stack(
        rplan, textra["grids"][:N_CHECK], textra["aligned"][:N_CHECK], f1,
        1.0)
    rgbm = starget._rgbm_stack(lay["rgb"], lay["mask"])
    max_err, scaled_bound, phase_a_bound = 0.0, None, None
    for name, tb, pl, kk, ref_n, color in (
        (f"dolly, depth-only refine {refine}", tabs, plan, k, refine, False),
        ("dolly, depth-only refine 0", tabs, plan, k, 0, False),
        (f"dolly, full color refine {refine}", tabs, plan, k, refine, True),
        (f"tilted orbit phase A, depth-only refine {refine}", rtabs, rplan,
         k_r, refine, False),
    ):
        out = kscaled.march_scaled_cuda(disp, izmin, izmax, tb, pl,
                                        refine=ref_n,
                                        rgbm=rgbm if color else None,
                                        skip_tables=lay["skip_scaled"])
        torch.cuda.synchronize()
        v_top = izmax + (izmin - izmax) * float(disp.max())
        if scaled_bound is None or tb is rtabs:  # the timed configurations
            bound = bound_record(
                "scaled_march" if tb is tabs else "scaled_march phase A",
                "lif_tpu_torch/csrc/sweep_scaled.cu",
                tensor_bytes(disp, tb, *out),
                planes_walked(out[0], out[1], tb[:, 4], v_top),
                out[0].numel(), int(out[0].sum()), N_CHECK)
            if tb is tabs:
                scaled_bound = bound
            else:
                phase_a_bound = bound
        # against the plain march and the plain mirror of the kernel's skip
        # walk: (found mismatches, max abs) each
        worst = {"plain": (0, 0.0), "skip mirror": (0, 0.0)}
        for i in range(N_CHECK):
            for label, plain in (("plain", sscaled.march_scaled_plain),
                                 ("skip mirror",
                                  sscaled.march_scaled_skip_plain)):
                if label == "skip mirror" and i >= N_MIRROR:
                    continue
                ref = plain(disp, izmin, izmax, tb[i], pl, refine=ref_n,
                            rgbm=rgbm if color else None)
                flips = int((out[0][i] != ref[0]).sum())
                err = max(float((got[i] - want).abs().max())
                          for got, want in zip(out[1:], ref[1:]))
                worst[label] = (worst[label][0] + flips,
                                max(worst[label][1], err))
        print(f"scaled kernel vs plain, {name} ({N_CHECK} poses, "
              f"{pl.out_w}x{pl.out_h} from {W}x{H}, K={kk}): found "
              f"mismatches {worst['plain'][0]}, max abs "
              f"{worst['plain'][1]:.3g}; vs its skip mirror ({N_MIRROR} "
              f"poses): found mismatches {worst['skip mirror'][0]}, max abs "
              f"{worst['skip mirror'][1]:.3g}; found share "
              f"{float(out[0].mean()):.4f}", flush=True)
        check(worst["plain"] == (0, 0.0) and worst["skip mirror"] == (0, 0.0),
              f"{name}: the scaled kernel is not exact")
        max_err = max(max_err, worst["plain"][1], worst["skip mirror"][1])
        del out

    # 11. main path 4: the dolly, every launch count zeroed just before it
    reset_counts()
    out, tiers = lt.render_fast_batch(proj, cams, return_tiers=True)
    torch.cuda.synchronize()
    launches = kscaled.sweep_scaled.launches
    record_path("main path 4", {"scaled_march": launches})
    coverage = float(out[..., 3].mean())
    print(f"main path 4: render_fast_batch({N_DOLLY} dolly poses) -> "
          f"{tuple(out.shape)}, tiers {tiers}, scaled_march launches "
          f"{launches}, alpha coverage {coverage:.4f}", flush=True)
    MAIN_FRAMES["dolly"] = out
    check(tiers == ("scaled",), f"dolly tiers {tiers}")
    check(launches == 1, f"{launches} scaled launches on the dolly")
    check(tuple(out.shape) == (N_DOLLY, H, W, 4), f"shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite dolly output")
    check(0.5 < coverage <= 1.0, f"dolly alpha coverage {coverage}")
    for i, ref_db in LIF_TPU_DOLLY_PSNR.items():
        exact = lt.render_mono_view(proj, cams[i], mask_mode="none",
                                    num_steps=640)
        q = psnr(out[i], exact)
        print(f"fidelity vs the 640-step march at dolly pose {i}: {q:.2f} "
              f"dB, lif_tpu {ref_db:.2f} dB", flush=True)
        check(q >= ref_db - 1.0, f"dolly pose {i}: {q:.2f} dB, lif_tpu "
                                 f"{ref_db}")
    del out

    # 12. main path 5: the tilted orbit through the two-phase tier
    reset_counts()
    tout, ttiers = lt.render_fast_batch(proj, tcams, return_tiers=True)
    torch.cuda.synchronize()
    tlaunches = kscaled.sweep_scaled.launches
    record_path("main path 5", {"scaled_march": tlaunches})
    coverage = float(tout[..., 3].mean())
    print(f"main path 5: render_fast_batch({N_TILT} tilted orbit poses, "
          f"+-{TILT_DEG:g} deg at {TILT_PHI:g} deg pitch) -> "
          f"{tuple(tout.shape)}, tiers {ttiers}, scaled_march launches "
          f"{tlaunches}, alpha coverage {coverage:.4f}", flush=True)
    check(ttiers == ("rotated",), f"tilted orbit tiers {ttiers}")
    check(tlaunches == 1, f"{tlaunches} scaled launches on the tilted orbit")
    check(tuple(tout.shape) == (N_TILT, H, W, 4), "tilted orbit shape")
    check(bool(torch.isfinite(tout).all()), "non-finite tilted orbit output")
    check(0.5 < coverage <= 1.0, f"tilted orbit alpha coverage {coverage}")
    for i, ref_db in LIF_TPU_TILT_PSNR.items():
        exact = lt.render_mono_view(proj, tcams[i], mask_mode="none",
                                    num_steps=640)
        q = psnr(tout[i], exact)
        print(f"fidelity vs the 640-step march at tilted orbit pose {i} "
              f"(theta {np.rad2deg(thetas[i]):+.2f} deg): {q:.2f} dB, "
              f"lif_tpu {ref_db:.2f} dB", flush=True)
        check(q >= ref_db - 1.0, f"tilted pose {i}: {q:.2f} dB, lif_tpu "
                                 f"{ref_db}")
    del tout

    # 13. timing on the card
    dolly_ms = device_timer(lt.render_fast_batch, proj, cams, iters=1,
                            repeats=5)
    tilt_ms = device_timer(lt.render_fast_batch, proj, tcams, iters=1,
                           repeats=5)
    kernel_ms = device_timer(kscaled.march_scaled_cuda, disp, izmin, izmax,
                             tabs, plan, refine=2,
                             skip_tables=lay["skip_scaled"], iters=10,
                             repeats=5)
    plain_ms = device_timer(lambda: [
        sscaled.march_scaled_plain(disp, izmin, izmax, tabs[i], plan,
                                   refine=2)
        for i in range(N_CHECK)
    ], iters=1, repeats=5)
    print(f"render_fast_batch dolly: {dolly_ms:.3f} ms per {N_DOLLY} poses "
          f"= {N_DOLLY / (dolly_ms / 1e3):.1f} frames/s at {W}x{H} [{card}]",
          flush=True)
    print(f"render_fast_batch tilted orbit: {tilt_ms:.3f} ms per {N_TILT} "
          f"poses = {N_TILT / (tilt_ms / 1e3):.1f} frames/s at {W}x{H} "
          f"[{card}]", flush=True)
    print(f"scaled_march kernel: {kernel_ms / N_CHECK:.4f} ms/frame (previous "
          f"design: {EARLIER_MS['scaled_march']} on {EARLIER_CARD}), plain "
          f"march {plain_ms / N_CHECK:.3f} ms/frame ({N_CHECK}-pose batch, "
          f"K={k}, depth only, refine 2) [{card}]", flush=True)
    phase_a_ms = device_timer(kscaled.march_scaled_cuda, disp, izmin, izmax,
                              rtabs, rplan, refine=refine,
                              skip_tables=lay["skip_scaled"], iters=10,
                              repeats=5)
    print(f"scaled_march kernel in the tilted orbit's phase A: "
          f"{phase_a_ms / N_CHECK:.4f} ms/frame ({N_CHECK}-pose batch, "
          f"{rplan.out_w}x{rplan.out_h}, K={k_r}, depth only, refine "
          f"{refine}; previous design: "
          f"{EARLIER_MS['scaled_march phase A']} on {EARLIER_CARD}), bound "
          f"{phase_a_bound[0]:.5f} ms/frame (by {phase_a_bound[1]}) "
          f"[{card}]", flush=True)
    return kernel_record(
        "scaled_march", "lif_tpu_torch/csrc/sweep_scaled.cu",
        "lif_tpu/ops/pallas/sweep_scaled.py:60", launches, max_err,
        kernel_ms / N_CHECK, plain_ms / N_CHECK, scaled_bound)


def billboard_phases(proj, focal, lay, cams, reset_counts, launch_counts,
                     card):
    """Phases 14-17: the billboard kernel against its plain version and
    the scatter oracle, main path 6 (render_billboard_fast_batch over the
    96 lateral poses `cams`), main path 7 (the mesh modes at a lateral and
    an orbit pose) and their timing. Returns the kernel's JSON record."""
    import torch

    import lif_tpu_torch as lt
    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.ops import splat
    from lif_tpu_torch.ops import splat_march as sbb
    from lif_tpu_torch.ops.cuda import splat_march as kbb
    from lif_tpu_torch.utils.profiling import device_timer

    def disagreement(ref, got):
        """(hit flips, colour mismatches > 1e-6 where both hit), pixels."""
        hit_r, hit_g = ref[..., 3] > 0.5, got[..., 3] > 0.5
        err = (got[..., :3] - ref[..., :3]).abs().amax(-1)
        return (int((hit_r != hit_g).sum()),
                int(((err > 1e-6) & hit_r & hit_g).sum()))

    n_px = H * W
    izmin, izmax, f1 = lay["izmin_host"], lay["izmax_host"], lay["focal_host"]

    # 14. kernel vs plain and vs the scatter, at phase 3's poses, planned
    # as render_billboard_fast_batch plans them
    cams8 = [lt.Camera.create(
        W, H, focal_px=focal, position=[0.135 + 0.02 * i / N_CHECK, 0.0, 0.0])
        for i in range(N_CHECK)]
    bp = renderer.plan_billboard(proj, cams8)
    args = sbb.billboard_inputs(
        lay["rgb"], lay["disp"], lay["mask"], izmin, izmax, bp.c1x, f1,
        bp.ixs, bp.mms, bp.plan, bp.num_planes, bp.cx0, bp.cy0, 1.0)
    found, tex, rgba = kbb.sweep_billboard(*args)
    torch.cuda.synchronize()
    k = bp.num_planes
    zero_bg = np.zeros(4, np.float32)
    oracle_worst = (0, 0)
    oracle_total, err = [0, 0], 0.0
    # against the scatter's plain version and the dual's: hit flips and
    # texel/colour mismatches, summed over the poses
    plains = {"scatter plain": sbb.billboard_scatter_plain,
              "dual twin": sbb.billboard_march_plain}
    twin_total = {label: [0, 0] for label in plains}
    for i in range(N_CHECK):
        for label, plain in plains.items():
            f_p, t_p, c_p = plain(args[0], args[1], args[2][i], args[3][i],
                                  args[4][i], *args[5:])
            err = max(err, float((c_p - rgba[i]).abs().max()),
                      float((t_p - tex[i]).abs().max()))
            twin_total[label][0] += int((f_p != found[i]).sum())
            twin_total[label][1] += int(((t_p != tex[i])
                                         | (c_p != rgba[i]).any(-1)).sum())
        oracle = (0, 0)
        for show_depth in (False, True):
            img = sbb.finish_billboard(found[i:i + 1], tex[i:i + 1],
                                       rgba[i:i + 1], zero_bg, False,
                                       show_depth)[0]
            ref = splat.render_mesh_view(proj, cams8[i], to_srgb=False,
                                         show_depth=show_depth)
            oracle = tuple(max(a, b) for a, b in
                           zip(oracle, disagreement(ref, img)))
        oracle_total[0] += oracle[0]
        oracle_total[1] += oracle[1]
        oracle_worst = tuple(max(a, b) for a, b in zip(oracle_worst, oracle))
    vs_plain = "; ".join(
        f"vs the {label}: hit flips {t[0]}, texel/colour mismatches {t[1]}"
        for label, t in twin_total.items())
    print(f"billboard kernel ({N_CHECK} poses, {W}x{H} = {N_CHECK * n_px} "
          f"pixels, K={k}, su/2 <= {float(args[4][0, 2]):.4f}) {vs_plain}, "
          f"max abs {err:.3g}; vs forward_splat (colour and show_depth): hit "
          f"flips {oracle_total[0]}, colour mismatches {oracle_total[1]} "
          f"(worst pose {oracle_worst}; gate {BB_ORACLE_MAX} a pose); hit "
          f"share {float(found.mean()):.4f}", flush=True)
    check(all(t == [0, 0] for t in twin_total.values()) and err == 0.0,
          "the billboard kernel disagrees with its plain versions")
    check(max(oracle_worst) <= BB_ORACLE_MAX,
          "the billboard kernel disagrees with forward_splat")
    # the function's bound: a z-buffered splat, O(1) work per source pixel
    bound = bound_record("billboard_march",
                         "lif_tpu_torch/csrc/splat_march.cu",
                         tensor_bytes(*args[:5], found, tex, rgba), 0,
                         found.numel(), int(found.sum()), N_CHECK)

    # 15. main path 6, every launch count zeroed just before it
    reset_counts()
    out = lt.render_billboard_fast_batch(proj, cams)
    torch.cuda.synchronize()
    counts = launch_counts()
    record_path("main path 6", counts)
    launches = counts.pop("billboard_march")
    coverage = float(out[..., 3].mean())
    print(f"main path 6: render_billboard_fast_batch({len(cams)} lateral "
          f"poses) -> {tuple(out.shape)}, billboard_march launches "
          f"{launches}, others {counts}, alpha coverage {coverage:.4f}",
          flush=True)
    check(launches == 1, f"{launches} billboard launches for one batch")
    check(not any(counts.values()), f"other kernels launched: {counts}")
    check(tuple(out.shape) == (len(cams), H, W, 4), f"shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite billboard output")
    check(0.5 < coverage <= 1.0, f"billboard alpha coverage {coverage}")
    for i in (0, len(cams) // 2, len(cams) - 1):
        flips, mism = disagreement(lt.render(proj, cams[i], mode="billboard"),
                                   out[i])
        print(f"  pose {i}: against render(mode='billboard') hit flips "
              f"{flips}, colour mismatches {mism}", flush=True)
        check(max(flips, mism) <= BB_ORACLE_MAX,
              f"billboard pose {i} disagrees")
    del out

    # 16. main path 7: the mesh modes at a lateral and an orbit pose
    ocam = orbit_cams(lt, focal, thetas=[float(np.deg2rad(-ORBIT_DEG))])[0]
    for pose, cam in (("lateral", cams[0]), ("orbit", ocam)):
        exact = lt.render_mono_view(proj, cam, mask_mode="none",
                                    num_steps=640)
        for mode, refs in (("billboard", LIF_TPU_BILLBOARD_PSNR),
                           ("mesh", LIF_TPU_MESH_PSNR)):
            reset_counts()
            img = lt.render(proj, cam, mode=mode)
            torch.cuda.synchronize()
            check(not any(launch_counts().values()),
                  f"render(mode={mode!r}) launched a hand-written kernel")
            cov = float(img[..., 3].mean())
            hit = img[..., 3] > 0.5
            q, q_hit = psnr(img, exact), psnr(img[hit], exact[hit])
            ref_cov = LIF_TPU_COVERAGE[(mode, pose)]
            print(f"main path 7: render(mode={mode!r}) at {pose} pose 0: "
                  f"{q:.3f} dB against the 640-step march (lif_tpu "
                  f"{refs[pose]:.3f}), {q_hit:.3f} dB over its covered "
                  f"pixels, coverage {cov:.4f} (lif_tpu {ref_cov:.4f})",
                  flush=True)
            check(bool(torch.isfinite(img).all()), f"non-finite {mode}")
            check(abs(cov - ref_cov) <= COVERAGE_TOL,
                  f"{mode} at {pose}: coverage {cov}, lif_tpu {ref_cov}")
            check(q >= refs[pose] - 1.0,
                  f"{mode} at {pose}: {q:.3f} dB, lif_tpu {refs[pose]}")

    # 17. timing on the card
    batch_ms = device_timer(lt.render_billboard_fast_batch, proj, cams,
                            iters=1, repeats=5)
    kernel_ms = device_timer(kbb.sweep_billboard, *args, iters=10, repeats=5)
    plain_ms = {label: device_timer(lambda: [
        plain(args[0], args[1], args[2][i], args[3][i], args[4][i], *args[5:])
        for i in range(N_CHECK)
    ], iters=1, repeats=3) / N_CHECK for label, plain in plains.items()}
    splat_ms = device_timer(lt.render, proj, cams[0], mode="billboard",
                            iters=3, repeats=5)
    mesh_ms = device_timer(lt.render, proj, cams[0], mode="mesh", iters=1,
                           repeats=5)
    print(f"render_billboard_fast_batch: {batch_ms:.3f} ms per {len(cams)} "
          f"poses = {len(cams) / (batch_ms / 1e3):.1f} frames/s at {W}x{H} "
          f"[{card}]", flush=True)
    print(f"billboard_march kernel: {kernel_ms / N_CHECK:.4f} ms/frame "
          f"(previous design: {EARLIER_MS['billboard_march']} on "
          f"{EARLIER_CARD}), "
          + ", ".join(f"{label} {ms:.3f}" for label, ms in plain_ms.items())
          + f" ms/frame ({N_CHECK}-pose batch, K={k}) [{card}]", flush=True)
    print(f"render(mode='billboard') (forward_splat, the oracle's cost): "
          f"{splat_ms:.3f} ms/frame; render(mode='mesh'): {mesh_ms:.3f} "
          f"ms/frame [{card}]", flush=True)
    return kernel_record(
        "billboard_march", "lif_tpu_torch/csrc/splat_march.cu",
        "lif_tpu/ops/pallas/splat_march.py:99", launches, err,
        kernel_ms / N_CHECK, plain_ms["scatter plain"], bound)


# the hand-written kernel each tier launches once per layer and pose chunk
# ('rotated': the scaled kernel in its phase A)
TIER_KERNEL = {"march": "lateral_march", "target": "target_march",
               "scaled": "scaled_march", "rotated": "scaled_march"}


@contextlib.contextmanager
def recorded_calls():
    """Record every call of the march kernels' entry points made inside
    (ops/cuda/*.py's march_translation_cuda, march_target_cuda and
    march_scaled_cuda, which the renderer's dispatchers look up when they
    run) as (kernel, the call's bound arguments, a copy of its outputs).
    The calls run and launch as they would; hold_to_plain replays them."""
    from lif_tpu_torch.ops.cuda import sweep_march as kmarch
    from lif_tpu_torch.ops.cuda import sweep_scaled as kscaled
    from lif_tpu_torch.ops.cuda import sweep_target as ktarget

    calls = []
    entries = ((kmarch, "march_translation_cuda", "lateral_march"),
               (ktarget, "march_target_cuda", "target_march"),
               (kscaled, "march_scaled_cuda", "scaled_march"))
    saved = [getattr(mod, attr) for mod, attr, _ in entries]

    def recorder(fn, kernel):
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            calls.append((kernel, bound.arguments,
                          tuple(t.clone() for t in out)))
            return out

        return call

    for (mod, attr, kernel), fn in zip(entries, saved):
        setattr(mod, attr, recorder(fn, kernel))
    try:
        yield calls
    finally:
        for (mod, attr, _), fn in zip(entries, saved):
            setattr(mod, attr, fn)


def hold_to_plain(calls, step, poses=None):
    """Each kernel call a main-path step made (recorded_calls), pose by
    pose on that call's own inputs, against the kernel's plain version
    (every pose, or `poses` of them spread evenly over each call) and the
    plain mirror of its skip walk (the first N_MIRROR poses): no found
    flip and max abs 0 against both. Returns {kernel: max abs}."""
    import torch

    from lif_tpu_torch.ops import sweep_march as smarch
    from lif_tpu_torch.ops import sweep_scaled as sscaled
    from lif_tpu_torch.ops import sweep_target as starget

    torch.cuda.synchronize()
    errs = {}
    for kernel, a, out in calls:
        kw = dict(refine=a["refine"])
        if kernel == "lateral_march":
            plains = (smarch.march_translation_plain,
                      smarch.march_translation_skip_plain)
            c1 = np.asarray(a["c1"], np.float32)
            kw["offset"] = a["offset"]

            def ref(plain, i):
                return plain(a["rgb"], a["disp"], a["mask"], a["invz_min"],
                             a["invz_max"], c1[i], a["f1"],
                             a["plane_invz"][i], a["plan"], a["num_planes"],
                             **kw)
        elif kernel == "target_march":
            plains = (starget.march_target_plain,
                      starget.march_target_skip_plain)
            kw["rgbm"] = a["rgbm"]

            def ref(plain, i):
                return plain(a["disp"], a["invz_min"], a["invz_max"],
                             a["pose_b"][i], a["plane_invz"][i],
                             a["plan"].out_w, a["plan"].out_h, **kw)
        else:
            plains = (sscaled.march_scaled_plain,
                      sscaled.march_scaled_skip_plain)
            kw["rgbm"] = a["rgbm"]

            def ref(plain, i):
                return plain(a["disp"], a["invz_min"], a["invz_max"],
                             a["tabs"][i], a["plan"], **kw)
        worst = [[0, 0.0], [0, 0.0]]
        n = out[0].shape[0]
        held = (range(n) if poses is None or poses >= n else
                np.unique(np.linspace(0, n - 1, poses).round().astype(int)))
        for i in held:
            for j, plain in enumerate(plains):
                if j and i >= N_MIRROR:
                    continue
                r = ref(plain, i)
                worst[j][0] += int((out[0][i] != r[0]).sum())
                worst[j][1] = max([worst[j][1]] + [
                    float((got[i] - want).abs().max())
                    for got, want in zip(out[1:], r[1:])])
        h, w = out[0].shape[1:]
        print(f"{step}: {kernel} ({n} poses, {w}x{h}, refine "
              f"{a['refine']}, colour {len(out) > 2}) on the launch's own "
              f"inputs, {len(held)} poses: vs plain found "
              f"mismatches {worst[0][0]}, max abs {worst[0][1]:.3g}; vs its "
              f"skip mirror ({min(N_MIRROR, out[0].shape[0])} poses) found "
              f"mismatches {worst[1][0]}, max abs {worst[1][1]:.3g}",
              flush=True)
        check(worst == [[0, 0.0], [0, 0.0]],
              f"{step}: the {kernel} kernel is not exact on its launch")
        errs[kernel] = max(errs.get(kernel, 0.0), worst[0][1], worst[1][1])
    return errs


# launches per main path, {path: {kernel: launches}}, for the kernels'
# JSON line
LAUNCHES_BY_PATH: dict = {}


def record_path(path, counts):
    """Add a main path's launches (a step's counts) to LAUNCHES_BY_PATH."""
    tally = LAUNCHES_BY_PATH.setdefault(path, {})
    for kernel, n in counts.items():
        if n:
            tally[kernel] = tally.get(kernel, 0) + n


class MainPath:
    """The steps of one main path: each zeroes the launch counts just
    before it, records the kernel calls it makes (recorded_calls) and
    reads its launches just after (added to LAUNCHES_BY_PATH); held()
    replays the calls against the kernels' plain versions (hold_to_plain)
    and keeps each kernel's worst error in `errs`."""

    def __init__(self, name, reset_counts, launch_counts):
        self.name = name
        self.reset_counts = reset_counts
        self.launch_counts = launch_counts
        self.errs = {}

    def counted(self, fn, *args, **kwargs):
        """fn's result, the kernel launches it made and the recorded
        kernel calls."""
        import torch

        self.reset_counts()
        with recorded_calls() as calls:
            out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        counts = self.launch_counts()
        record_path(self.name, counts)
        return out, counts, calls

    def expect(self, tiers):
        """The launch counts of one launch per tier named."""
        want = dict.fromkeys(self.launch_counts(), 0)
        for tier in tiers:
            want[TIER_KERNEL[tier]] += 1
        return want

    def held(self, calls, step, poses=None):
        for kernel, err in hold_to_plain(calls, f"{self.name}: {step}",
                                         poses).items():
            self.errs[kernel] = max(self.errs.get(kernel, 0.0), err)


def lif_phase(reset_counts, launch_counts, card):
    """Phase 18, main path 8: a LIF file to frames (see the module note).
    Every step zeroes the launch counts just before it and checks them
    just after, exactly, and holds each kernel launch it made to the
    kernel's plain version on that launch's inputs (hold_to_plain).
    Returns ({kernel: max abs against its plain versions}, the loaded
    views)."""
    import torch

    import lif_tpu_torch as lt
    from lif_tpu_torch.apps import viewer
    from lif_tpu_torch.core.pose import relative_view_pose
    from lif_tpu_torch.io import native
    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.ops import sweep_march as smarch
    from lif_tpu_torch.ops.cuda import build
    from lif_tpu_torch.ops.cuda import sweep_march as kmarch
    from lif_tpu_torch.utils.profiling import device_timer

    path8 = MainPath("main path 8", reset_counts, launch_counts)
    counted, expect, held = path8.counted, path8.expect, path8.held

    # the file: authored, written, loaded onto the card
    t0 = time.perf_counter()
    data = make_lif(0)
    path = build.BUILD_DIR / "chip_smoke.lif"
    path.write_bytes(data)
    author_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    result, counts, _ = counted(lt.load_lif_file, str(path))
    load_ms = (time.perf_counter() - t0) * 1e3
    views = result.projectors
    devices = sorted({p.disp.device.type for p in views})
    center = result.orbit_center
    print(f"main path 8: a {len(data) / 1e6:.2f} MB LIF authored in "
          f"{author_s:.2f} s; load_lif_file {load_ms:.1f} ms (host clock; "
          f"native codec {native.load_library() is not None}), "
          f"{len(views)} views of {[p.num_layers for p in views]} layers, "
          f"textures on {devices}, orbit_center "
          f"{np.round(center, 6).tolist()}", flush=True)
    check(devices == ["cuda"], f"textures on {devices}")
    check(not any(counts.values()), f"loading launched kernels: {counts}")
    check(center is not None, "no orbit_center from stereo_render_data")
    check([p.num_layers for p in views] == [1, 3], "the views' layers")
    res = np.asarray(views[1].layer_res)[:, :2]
    check((res == [W + LIF_OUTPAINT, H + LIF_OUTPAINT]).all(),
          f"view 1's layer dims {res.tolist()}")
    check(np.allclose(views[1].invz_min, [n for n, _ in LIF_LAYERS])
          and np.allclose(views[1].invz_max, [f for _, f in LIF_LAYERS]),
          "view 1's inverse-depth ranges")
    check(np.allclose(views[0].skew, LIF_SKEW), "view 0's frustum skew")
    cams = {v: lif_cams(lt, views[v], center) for v in (0, 1)}

    # the renders: render(mode='fast') at the fixed novel view, then
    # render_fast_view at the other poses, each against the 640-step march
    for v, pose in LIF_RENDERS:
        proj, cam = views[v], cams[v][pose]
        if pose == "lateral":
            img, counts, calls = counted(lt.render, proj, cam, mode="fast")
            tiers, route = ("march",) * proj.num_layers, "render(mode='fast')"
        else:
            img, counts, calls = counted(lt.render_fast_view, proj, cam)
            route = "render_fast_view"
            if pose == "y-only":  # the x<->y transpose onto the march
                tiers = ("march",) * proj.num_layers
            else:
                tiers = tuple(lt.render_fast_batch(proj, [cam],
                                                   return_tiers=True)[1])
        exact = lt.render_mono_view(proj, cam, num_steps=640)
        q, ref_db = psnr(img, exact), LIF_TPU_LIF_PSNR[(v, pose)]
        print(f"main path 8: {route} on view {v} at the {pose} pose: tiers "
              f"{tiers}, launches {counts}, {q:.3f} dB against the 640-step "
              f"march (lif_tpu {ref_db:.3f}), alpha coverage "
              f"{float(img[..., 3].mean()):.4f}", flush=True)
        check(tuple(img.shape) == (H, W, 4), f"shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"non-finite {pose} render")
        check(counts == expect(tiers), f"view {v} {pose}: launches {counts}")
        check(q >= ref_db - 1.0, f"view {v} {pose}: {q:.3f} dB, lif_tpu "
                                 f"{ref_db}")
        check(sum(counts.values()) == len(calls),
              f"view {v} {pose}: {len(calls)} recorded calls")
        held(calls, f"{route} on view {v} at the {pose} pose")

    # render_depth_fast at the lateral pose: the plain march's raw invz*
    # times the baseline, exactly
    v0, cam = views[0], cams[0]["lateral"]
    depth, counts, calls = counted(lt.render_depth_fast, v0, cam)
    lay = renderer._prepared_textures(v0)[0]
    izmin, izmax, f1 = lay["izmin_host"], lay["izmax_host"], lay["focal_host"]
    c1 = relative_view_pose(v0.position, v0.rotation, cam.position,
                            cam.rotation)[0]
    plan = renderer._march_plan(lay, abs(float(c1[0])), W, H)
    tab, k = smarch.snap_plane_tables_batch(f1, [float(c1[0])], izmin, izmax)
    raw = smarch.render_translation_plain(
        lay["rgb"], lay["disp"], lay["mask"], izmin, izmax, c1, f1,
        torch.as_tensor(tab[0], device=depth.device), np.zeros(4, np.float32),
        plan, k, mask_mode="none", to_srgb=False, raw=True)
    want = raw[3] * float(np.float32(v0.baseline))
    print(f"main path 8: render_depth_fast on view 0 at the lateral pose: "
          f"launches {counts}, max abs against the plain march "
          f"{float((depth - want).abs().max()):.3g}, hit share "
          f"{float((depth > 0).float().mean()):.4f}", flush=True)
    check(counts == expect(("march",)), f"render_depth_fast: {counts}")
    check(torch.equal(depth, want), "render_depth_fast is not the plain "
                                    "march's invz* times the baseline")
    held(calls, "render_depth_fast on view 0 at the lateral pose")

    # the lateral kernel on view 0's skewed source: the fold's y pre-shift,
    # d[0] in the snap phase and the warp offset, row tables of the shifted
    # source (not launches of the main path: the counts are not read)
    cxs = [LIF_X + 0.02 * i / N_CHECK for i in range(N_CHECK)]
    plan, crop, phase, doff = renderer._march_fold(
        lay, v0.skew, cam.skew, max(cxs), W, H, 0.0)
    lay = dict(lay, doff=doff)
    srcs, _, rows = renderer._march_pack(lay, plan, crop)
    stale = sum(int((a != b).any(-1).sum())
                for a, b in zip(rows, lay["skip_rows"]))
    planes, k = smarch.snap_plane_tables_batch(f1, cxs, izmin, izmax,
                                               phase_px=phase)
    c1 = np.zeros((N_CHECK, 3), np.float32)
    c1[:, 0] = cxs
    for refine in (0, LATERAL_REFINE):
        out = kmarch.march_translation_cuda(
            *srcs, izmin, izmax, c1, f1,
            torch.as_tensor(planes).to(srcs[1].device), plan, k,
            offset=(doff[0], 0.0), refine=refine, rows=rows)
        torch.cuda.synchronize()
        worst = {"plain": (0, 0.0), "skip mirror": (0, 0.0)}
        for i in range(N_CHECK):
            for label, plain in (
                    ("plain", smarch.march_translation_plain),
                    ("skip mirror", smarch.march_translation_skip_plain)):
                ref = plain(*srcs, izmin, izmax, c1[i], f1, planes[i], plan,
                            k, refine=refine, offset=doff)
                flips = int((out[0][i] != ref[0]).sum())
                err = max(float((got[i] - want).abs().max())
                          for got, want in zip(out[1:], ref[1:]))
                worst[label] = (worst[label][0] + flips,
                                max(worst[label][1], err))
        print(f"main path 8: lateral kernel on view 0's skewed source "
              f"(d = ({doff[0]:.3f}, {doff[1]:.3f}) px, {N_CHECK} poses, "
              f"K={k}, refine {refine}; its row tables differ from the "
              f"unshifted texture's in {stale} rows): vs plain found "
              f"mismatches "
              f"{worst['plain'][0]}, max abs {worst['plain'][1]:.3g}; vs its "
              f"skip mirror found mismatches {worst['skip mirror'][0]}, max "
              f"abs {worst['skip mirror'][1]:.3g}; found share "
              f"{float(out[0].mean()):.4f}", flush=True)
        check(worst["plain"] == (0, 0.0) and worst["skip mirror"] == (0, 0.0),
              f"refine {refine}: the lateral kernel is not exact on the "
              "skewed source")
        del out

    # the viewer: an orbit trajectory about orbit_center in one chunk
    radius = float(np.linalg.norm(np.asarray(v0.position) - center))
    positions, rotations = viewer.orbit_trajectory(center, radius, N_VIEWER,
                                                   VIEWER_SWEEP)
    template = lt.Camera.create(W, H, focal_px=f1)
    t0 = time.perf_counter()
    frames, counts, calls = counted(viewer.render_trajectory, v0, positions,
                                    rotations, template, mode="fast")
    viewer_s = time.perf_counter() - t0
    tiers = tuple(lt.render_fast_batch(v0, [
        lt.Camera.create(W, H, focal_px=f1, position=p, rotation=r)
        for p, r in zip(positions, rotations)], return_tiers=True)[1])
    print(f"main path 8: viewer render_trajectory(mode='fast') of "
          f"{N_VIEWER} orbit frames (+-{VIEWER_SWEEP / 2:g} deg about "
          f"orbit_center) on view 0 -> {frames.shape}: tiers {tiers}, "
          f"launches {counts}, {viewer_s * 1e3:.1f} ms = "
          f"{N_VIEWER / viewer_s:.1f} frames/s (host clock, frames copied "
          f"to the host) [{card}]", flush=True)
    check(frames.shape == (N_VIEWER, H, W, 4), f"shape {frames.shape}")
    check(bool(np.isfinite(frames).all()), "non-finite viewer frames")
    check(counts == expect(tiers), f"viewer launches {counts}")
    check(sum(counts.values()) == len(calls),
          f"viewer: {len(calls)} recorded calls")
    held(calls, "the viewer's orbit")

    # timing on the card
    for v in (0, 1):
        proj, cam = views[v], cams[v]["lateral"]
        frame_ms = device_timer(lt.render, proj, cam, mode="fast", iters=1,
                                repeats=5)
        seq = [lt.Camera.create(W, H, focal_px=float(proj.focal[0]),
                                position=[LIF_X + 0.001 * i, 0.0, 0.0])
               for i in range(N_SEQ)]
        seq_ms = device_timer(
            lambda: [lt.render_fast_view(proj, c) for c in seq], iters=1,
            repeats=3)
        print(f"main path 8: render(mode='fast') on view {v} "
              f"({views[v].num_layers} layers) at x = {LIF_X}: "
              f"{frame_ms:.3f} ms/frame; {N_SEQ}-pose sequential pass "
              f"{seq_ms:.3f} ms = {N_SEQ / (seq_ms / 1e3):.1f} frames/s "
              f"at {W}x{H} [{card}]", flush=True)
    return path8.errs, views


@contextlib.contextmanager
def plain_lateral():
    """Inside, the renderer's lateral tier runs its plain version on the
    card's tensors: no march pack is attached (each call cuts the source
    from the layer's own textures and mask, _march_sources) and the plain
    march and _finalize run pose by pose where the kernel would launch.
    A render inside is the plain-version twin of the same render outside;
    the kernel is exact against the plain march, so the two must be
    equal."""
    import torch

    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.ops import sweep_march as smarch
    from lif_tpu_torch.ops.cuda import sweep_march as kmarch

    def plain_batch(rgb, disp, mask, invz_min, invz_max, c1, f1, plane_invz,
                    background, plan, num_planes, prepared=None, rows=None,
                    **kw):
        outs = [smarch.render_translation_plain(
            rgb, disp, mask, invz_min, invz_max, cc, f1, pp, background, plan,
            num_planes, **kw) for cc, pp in zip(c1, plane_invz)]
        if kw.get("raw"):
            return tuple(torch.stack(parts) for parts in zip(*outs))
        return torch.stack(outs)

    saved = (kmarch.render_translation_batch_cuda,
             renderer._attach_march_prep)
    kmarch.render_translation_batch_cuda = plain_batch
    renderer._attach_march_prep = lambda layers, *_: list(layers)
    try:
        yield
    finally:
        (kmarch.render_translation_batch_cuda,
         renderer._attach_march_prep) = saved


def stereo_phase(reset_counts, launch_counts, card, ldi):
    """Phase 19, main path 9: stereo from a LIF file (see the module
    note). `ldi` is main path 8's 3-layer view. Every step zeroes the
    launch counts just before it and checks them just after, exactly, and
    holds each launch it made to the kernel's plain versions on that
    launch's inputs. Returns {kernel: max abs against its plain
    versions}."""
    import dataclasses
    import hashlib

    import torch

    import lif_tpu_torch as lt
    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.ops.cuda import build
    from lif_tpu_torch.utils.profiling import device_timer

    path9 = MainPath("main path 9", reset_counts, launch_counts)

    # the file: authored (the right eye rendered on the CPU), written,
    # loaded onto the card
    t0 = time.perf_counter()
    data = make_stereo_lif(0)
    author_s = time.perf_counter() - t0
    sha = hashlib.sha256(data).hexdigest()
    path = build.BUILD_DIR / "chip_smoke_stereo.lif"
    path.write_bytes(data)
    result, counts, _ = path9.counted(lt.load_lif_file, str(path))
    left, right = result.projectors[:2]
    eye = float(left.baseline) / 2.0
    print(f"main path 9: a {len(data) / 1e6:.2f} MB stereo LIF authored in "
          f"{author_s:.2f} s (right eye on the CPU), sha256 {sha} (the "
          f"reference tool's: {sha == STEREO_LIF_SHA256}); views at "
          f"{[float(p.position[0]) for p in result.projectors]} m, textures "
          f"on {sorted({p.disp.device.type for p in result.projectors})}",
          flush=True)
    check(len(result.projectors) == 2, "the stereo LIF's views")
    check(all(p.disp.device.type == "cuda" for p in result.projectors),
          "the stereo LIF's textures are not on the card")
    check(np.allclose([left.position[0], right.position[0]], [-eye, eye]),
          "the views' positions")
    check(not any(counts.values()), f"loading launched kernels: {counts}")
    cams = stereo_cams(lt, float(left.focal[0]), eye)
    MAIN_FRAMES["stereo"] = (left, right, cams["pairs"])

    def stereo_batch(name):
        return path9.counted(lt.render_stereo_fast_batch, left, right,
                             cams[name], return_tiers=True)

    # the pairs: 120 eye cameras, three balanced chunks of 40
    (out, tiers), counts, calls = stereo_batch("pairs")
    coverage = float(out[..., 3].mean())
    print(f"main path 9: render_stereo_fast_batch({N_PAIRS} pairs = "
          f"{len(cams['pairs'])} cameras) -> {tuple(out.shape)}, tiers "
          f"{tiers}, launches {counts}, alpha coverage {coverage:.4f}",
          flush=True)
    check(tiers == (("march",), ("march",)), f"pair tiers {tiers}")
    check(counts == dict(path9.expect(("march",) * 6)),
          f"pair launches {counts}: 2 eyes x 3 chunks")
    check(tuple(out.shape) == (2 * N_PAIRS, H, W, 4), "pair output shape")
    check(bool(torch.isfinite(out).all()), "non-finite pair output")
    check(0.5 < coverage <= 1.0, f"pair alpha coverage {coverage}")
    del out
    path9.held(calls, f"{N_PAIRS} pairs", poses=4)
    pair_ms = device_timer(lt.render_stereo_fast_batch, left, right,
                           cams["pairs"], iters=1, repeats=5)
    print(f"main path 9: render_stereo_fast_batch: {pair_ms:.3f} ms per "
          f"{N_PAIRS} pairs = {N_PAIRS / (pair_ms / 1e3):.1f} pairs/s at "
          f"{W}x{H} [{card}]", flush=True)

    # fidelity against the exact 640-step two-view march
    for name in ("mid", "yaw", "offaxis", "skewed"):
        (out, tiers), counts, calls = stereo_batch(name)
        want = (STEREO_TIERS[name],)
        chunks = -(-len(cams[name]) // lt.DEFAULT_CONFIG.pose_chunk)
        check(tiers == (want, want), f"{name} tiers {tiers}")
        check(counts == path9.expect(want * 2 * chunks),
              f"{name} launches {counts}")
        check(bool(torch.isfinite(out).all()), f"non-finite {name} output")
        for (batch, pose), ref_db in LIF_TPU_STEREO_PSNR.items():
            if batch != name:
                continue
            exact = lt.render_stereo_view(left, right, cams[name][pose],
                                          num_steps=640)
            q = psnr(out[pose], exact)
            print(f"main path 9: {name} batch of {len(cams[name])}, pose "
                  f"{pose}: tiers {tiers}, launches {counts}, {q:.3f} dB "
                  f"against the 640-step render_stereo_view (lif_tpu "
                  f"{ref_db:.3f})", flush=True)
            check(q >= ref_db - 1.0, f"stereo {name} pose {pose}: {q:.3f} "
                                     f"dB, lif_tpu {ref_db}")
        path9.held(calls, f"the {name} batch")

    # LDI stereo: the 3-layer view and a copy one baseline to its right,
    # in the hard mode (eroded masks); mono -> stereo -> mono on that
    # projector, each render equal to its plain-version twin
    ldi_r = dataclasses.replace(
        ldi, position=np.asarray(ldi.position) + [BASELINE, 0.0, 0.0])
    cam = lt.Camera.create(W, H, focal_px=float(ldi.focal[0]),
                           position=np.asarray(ldi.position)
                           + [LDI_STEREO_X, 0.0, 0.0])
    steps = (("mono", lambda: lt.render(ldi, cam, mode="fast"),
              ("march",) * 3),
             ("stereo", lambda: lt.render([ldi, ldi_r], cam,
                                          mode="stereo_fast"),
              ("march",) * 6),
             ("mono again", lambda: lt.render(ldi, cam, mode="fast"),
              ("march",) * 3))
    frames = []
    for step, fn, want in steps:
        img, counts, calls = path9.counted(fn)
        with plain_lateral():
            twin = fn()
        torch.cuda.synchronize()
        err = float((img - twin).abs().max())
        print(f"main path 9: LDI {step} (3 layers, 1408x928 outpainted, "
              f"x = {LDI_STEREO_X} m): launches {counts}, max abs against "
              f"its plain-version render {err:.3g}, alpha coverage "
              f"{float(img[..., 3].mean()):.4f}", flush=True)
        check(counts == path9.expect(want), f"LDI {step} launches {counts}")
        check(torch.equal(img, twin),
              f"LDI {step}: not its plain-version render")
        path9.held(calls, f"LDI {step}")
        frames.append(img)
    check(torch.equal(frames[2], frames[0]),
          "the second mono frame differs from the first")
    tiers = renderer.render_stereo_fast_batch(ldi, ldi_r, [cam],
                                              return_tiers=True)[1]
    check(tiers == (("march",) * 3,) * 2, f"LDI stereo tiers {tiers}")
    for lay in renderer._prepared_textures(ldi):
        held = {id(mask) for mask, _ in lay["march_packs"].values()}
        check(held == {id(lay["mask"]), id(lay["eroded_mask"])},
              "the march packs do not hold both masks")
    return path9.errs


def fusion_phase(reset_counts, launch_counts, card):
    """Phase 20, main path 10: multi-projector fusion, BASELINE config 4
    (see the module note). Every step zeroes the launch counts just
    before it and checks them just after, exactly, and holds each launch
    it made to the lateral kernel's plain versions on that launch's
    inputs. Returns {kernel: max abs against its plain versions}."""
    import torch

    import lif_tpu_torch as lt
    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.parallel.sharding import render_fused_projectors
    from lif_tpu_torch.utils.profiling import device_timer

    path10 = MainPath("main path 10", reset_counts, launch_counts)
    dev = torch.device("cuda", 0)

    # the projectors: synthesized on the CPU, moved to the card, resampled
    # there to 3840x2160 (bench_configs.py:548-557)
    t0 = time.perf_counter()
    projs1k = [p.to(dev) for p in make_fusion_projectors(0)]
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    projs4 = [lt.resample_projector(p, FUSED_SCALE, out_w=W4, out_h=H4,
                                    device=dev) for p in projs1k]
    torch.cuda.synchronize()
    resample_s = time.perf_counter() - t0
    focal4 = float(projs4[0].focal[0])
    print(f"main path 10: {N_FUSED} projectors synthesized on the CPU at x "
          f"= {[round(float(p.position[0]), 4) for p in projs1k]} m in "
          f"{synth_s:.2f} s, resampled on the card to {W4}x{H4} in "
          f"{resample_s:.2f} s (focal {focal4:.1f} px)", flush=True)
    for p in projs4:
        check(p.disp.device.type == "cuda", "4K textures not on the card")
        check(tuple(np.asarray(p.layer_res)[0]) == (W4, H4),
              f"4K layer dims {np.asarray(p.layer_res)[0].tolist()}")
    cams4 = [lt.Camera.create(W4, H4, focal_px=focal4, position=[
        FUSED_CAM_X + FUSED_CAM_DX * j, 0.0, 0.0]) for j in range(N_FUSED)]
    want = path10.expect(("march",) * N_FUSED)

    # the 4K batch, first call (cold caches), launches counted
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out, counts, calls = path10.counted(lt.render_fused_fast_batch, projs4,
                                        cams4)
    end.record()
    torch.cuda.synchronize()
    first_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()
    coverage = float(out[..., 3].mean())
    plans = [(a["num_planes"], a["plan"].pad_lo_x, a["plan"].src_w)
             for _, a, _ in calls]
    print(f"main path 10: render_fused_fast_batch({N_FUSED} projectors, "
          f"{len(cams4)} cameras at {W4}x{H4}) -> {tuple(out.shape)}, "
          f"launches {counts}, alpha coverage {coverage:.4f}; first call "
          f"{first_ms:.1f} ms (cold caches); peak device memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated; "
          f"{resident / 2**30:.2f} GiB resident before the call); per launch "
          f"(K, pad_lo_x, src_w) {plans}", flush=True)
    check(counts == want, f"4K fused launches {counts}")
    check(len(calls) == N_FUSED, f"{len(calls)} recorded calls")
    check(tuple(out.shape) == (N_FUSED, H4, W4, 4), "4K fused output shape")
    check(bool(torch.isfinite(out).all()), "non-finite 4K fused output")
    check(0.5 < coverage <= 1.0, f"4K fused alpha coverage {coverage}")
    path10.held(calls, "the 4K batch", poses=2)
    del calls

    # the second call reuses the texture cache entries and march packs
    packs = [[dict(lay["march_packs"]) for lay in
              renderer._prepared_textures(p)] for p in projs4]
    start.record()
    again, counts, _ = path10.counted(lt.render_fused_fast_batch, projs4,
                                      cams4)
    end.record()
    torch.cuda.synchronize()
    second_ms = start.elapsed_time(end)
    reused = all(
        lay["march_packs"].keys() == old.keys()
        and all(lay["march_packs"][k][1] is v[1] for k, v in old.items())
        for p, olds in zip(projs4, packs)
        for lay, old in zip(renderer._prepared_textures(p), olds))
    print(f"main path 10: second call {second_ms:.1f} ms (first "
          f"{first_ms:.1f}), launches {counts}, texture entries and march "
          f"packs reused {reused}, frames equal {torch.equal(again, out)}",
          flush=True)
    check(counts == want, f"second 4K fused call launches {counts}")
    check(reused, "the second call rebuilt a texture entry or a march pack")
    check(torch.equal(again, out), "the second 4K call differs")
    del again, packs
    with plain_lateral():
        twin = lt.render_fused_fast_batch(projs4, cams4)
    torch.cuda.synchronize()
    err = float((out - twin).abs().max())
    print(f"main path 10: the 4K batch against its plain-version render "
          f"(the lateral tier's plain march, no cached pack): max abs "
          f"{err:.3g}", flush=True)
    check(torch.equal(out, twin), "the 4K fused frames are not their "
                                  "plain-version render")
    del out, twin
    torch.cuda.empty_cache()

    # timing: CUDA events, median of 5 after a warm-up
    batch_ms = device_timer(lt.render_fused_fast_batch, projs4, cams4,
                            iters=1, repeats=5)
    one_ms = device_timer(lt.render_fused_fast_batch, projs4, cams4[:1],
                          iters=1, repeats=5)
    print(f"main path 10: render_fused_fast_batch at {W4}x{H4}: "
          f"{batch_ms:.3f} ms per {len(cams4)} cameras = "
          f"{len(cams4) / (batch_ms / 1e3):.2f} fused frames/s; batch of 1 "
          f"{one_ms:.3f} ms = {1e3 / one_ms:.2f} frames/s; peak device "
          f"memory {peak / 2**30:.2f} GiB [{card}]", flush=True)

    # the footprint: the peak above the resident state at more cameras
    # (each call twice: the first builds the march packs of its batch's
    # plan, the second, measured, reuses them; no call recorded, since
    # recorded_calls keeps a copy of every kernel output), its growth per
    # camera as bytes per projector, pixel and pose (against the bound's
    # renderer._FUSED_BYTES_PER_VIEW_PX), then N_FUSED_MANY cameras in one
    # call, its pose chunk bounded by the free memory
    # (renderer._fused_pose_chunk, spied on), against groups of FUSED_GROUP
    def cams_4k(n):
        return [lt.Camera.create(W4, H4, focal_px=focal4, position=[
            FUSED_CAM_X + FUSED_CAM_DX * j, 0.0, 0.0]) for j in range(n)]

    above = {}
    for n in FUSED_FOOTPRINT:
        warm = lt.render_fused_fast_batch(projs4, cams_4k(n))
        del warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        many = lt.render_fused_fast_batch(projs4, cams_4k(n))
        torch.cuda.synchronize()
        counts = launch_counts()
        record_path(path10.name, counts)
        peak = torch.cuda.max_memory_allocated()
        above[n] = peak - resident
        print(f"main path 10: render_fused_fast_batch({N_FUSED} projectors, "
              f"{n} cameras at {W4}x{H4}): launches {counts}, peak device "
              f"memory {peak / 2**30:.3f} GiB, {above[n] / 2**30:.3f} GiB "
              f"above the {resident / 2**30:.3f} GiB resident "
              f"(max_memory_allocated) [{card}]", flush=True)
        check(counts == want, f"{n} fused cameras: launches {counts}")
        check(bool(torch.isfinite(many).all()), f"{n} fused cameras")
        del many
    lo, hi = FUSED_FOOTPRINT
    slope = (above[hi] - above[lo]) / (hi - lo)
    print(f"main path 10: the footprint grows {slope / 2**30:.3f} GiB a "
          f"camera = {slope / (N_FUSED * W4 * H4):.1f} bytes per projector, "
          f"pixel and pose (the chunk bound assumes "
          f"{renderer._FUSED_BYTES_PER_VIEW_PX}) [{card}]", flush=True)
    check(slope <= renderer._FUSED_BYTES_PER_VIEW_PX * N_FUSED * W4 * H4,
          "the fused core holds more per pose than its chunk bound assumes")
    torch.cuda.empty_cache()
    chunks = []
    bound = renderer._fused_pose_chunk

    def spy(*args):
        chunks.append(bound(*args))
        return chunks[-1]

    renderer._fused_pose_chunk = spy
    try:
        reset_counts()
        many = lt.render_fused_fast_batch(projs4, cams_4k(N_FUSED_MANY))
        torch.cuda.synchronize()
        counts = launch_counts()
        record_path(path10.name, counts)
    finally:
        renderer._fused_pose_chunk = bound
    n_chunks = len(renderer._pose_chunks(N_FUSED_MANY, chunks[0]))
    worst = flipped = 0.0
    for g in range(0, N_FUSED_MANY, FUSED_GROUP):
        part = lt.render_fused_fast_batch(projs4, cams_4k(N_FUSED_MANY)[
            g:g + FUSED_GROUP])
        diff = (many[g:g + FUSED_GROUP] - part).abs()
        worst = max(worst, float(diff.max()))
        flipped += float((diff > FUSED_GROUP_TOL).sum())
        del part, diff
    print(f"main path 10: {N_FUSED_MANY} cameras at {W4}x{H4} in one call: "
          f"pose chunk {chunks[0]} ({n_chunks} chunks), launches {counts}; "
          f"against calls of {FUSED_GROUP} cameras: max abs {worst:.3g}, "
          f"{int(flipped)} values over {FUSED_GROUP_TOL:g}", flush=True)
    check(counts["lateral_march"] == N_FUSED * n_chunks,
          f"{N_FUSED_MANY} fused cameras: launches {counts}")
    check(worst <= FUSED_GROUP_TOL,
          f"{N_FUSED_MANY} fused cameras differ from groups of {FUSED_GROUP}"
          f" by {worst:.3g}")
    del many
    torch.cuda.empty_cache()

    # fidelity at 1280x800 against the exact fused oracle
    cam = lt.Camera.create(W, H, focal_px=float(projs1k[0].focal[0]),
                           position=[FUSED_CAM_X, 0.0, 0.0])
    for name, tol in FUSE_TOLS.items():
        cfg = lt.DEFAULT_CONFIG.replace(
            fuse_tol=lt.DEFAULT_CONFIG.fuse_tol if tol is None else tol)
        fast, counts, calls = path10.counted(
            lt.render_fused_fast_batch, projs1k, [cam], config=cfg)
        check(counts == want, f"fuse_tol {name}: launches {counts}")
        check(bool(torch.isfinite(fast).all()), "non-finite fused frame")
        path10.held(calls, f"the {W}x{H} fused frame at fuse_tol {name}")
        exact = render_fused_projectors(projs1k, cam, num_steps=FUSED_STEPS,
                                        fuse_tol=cfg.fuse_tol)
        if tol is None:
            MAIN_FRAMES.update(fused_projs=projs1k, fused_cam=cam,
                               fused_exact=exact)
        q, ref_db = psnr(fast[0], exact), LIF_TPU_FUSED_PSNR[name]
        print(f"main path 10: {W}x{H} fused frame at x = {FUSED_CAM_X} m, "
              f"fuse_tol {name} ({cfg.fuse_tol:g}): launches {counts}, "
              f"{q:.3f} dB against the {FUSED_STEPS}-step "
              f"render_fused_projectors (lif_tpu {ref_db:.3f}), alpha "
              f"coverage {float(fast[..., 3].mean()):.4f}", flush=True)
        check(q >= ref_db - 1.0, f"fused fuse_tol {name}: {q:.3f} dB, "
                                 f"lif_tpu {ref_db}")
    return path10.errs


def sweep_phase(proj, focal, reset_counts, launch_counts, card):
    """Phase 21, main path 11: the plane-sweep tier (see the module note).
    The sweep is plain torch (matrix products and elementwise passes): each
    drive zeroes the launch counts just before it and must launch no
    kernel."""
    import warnings

    import torch

    import lif_tpu_torch as lt
    from lif_tpu_torch.core.pose import relative_view_pose
    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.ops.sweep_fast import solve_depth_aligned
    from lif_tpu_torch.utils.profiling import device_timer

    path11 = MainPath("main path 11", reset_counts, launch_counts)
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 would reach the sweep's float32 disparity products")
    cfg = lt.DEFAULT_CONFIG
    proj_cpu = proj.to("cpu")

    def render(p, name, cams, kw):
        """(frames, tiers, TierFallbackWarnings fired) of one drive."""
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            if name == "view":
                out, tiers = lt.render_fast_view(p, cams[0], **kw)[None], None
            else:
                out, tiers = lt.render_fast_batch(p, cams, return_tiers=True,
                                                  **kw)
        fired = [r for r in rec
                 if issubclass(r.category, renderer.TierFallbackWarning)]
        if tiers is None:  # the single view's one layer: its warning says
            tiers = ("sweep",) if fired else ("march",)
        return out, tuple(tiers), fired

    for name, (cams, kw) in sweep_drives(lt, focal).items():
        (out, tiers, fired), counts, _ = path11.counted(render, proj, name,
                                                        cams, kw)
        coverage = float(out[..., 3].mean())
        print(f"main path 11 ({name}): {len(cams)} poses {kw} -> "
              f"{tuple(out.shape)}, tiers {tiers}, launches {counts}, "
              f"TierFallbackWarnings {len(fired)}, alpha coverage "
              f"{coverage:.4f}", flush=True)
        check(counts == path11.expect(()), f"{name}: launches {counts}")
        check(tiers == ("sweep",), f"{name}: tiers {tiers}")
        check(len(fired) == SWEEP_WARNINGS[name],
              f"{name}: {len(fired)} TierFallbackWarnings")
        check(tuple(out.shape) == (len(cams), H, W, 4), f"{name}: shape")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        check(0.5 < coverage <= 1.0, f"{name}: alpha coverage {coverage}")
        exact = lt.render_mono_view(proj, cams[0], mask_mode="none",
                                    num_steps=640)
        q, ref_db = psnr(out[0], exact), LIF_TPU_SWEEP_PSNR[name]
        # ROADMAP item 6's question, measured only: the reference's 40-step
        # exact march on the same pose
        q40 = psnr(lt.render_mono_view(proj, cams[0], mask_mode="none"),
                   exact)
        ms40 = device_timer(lt.render_mono_view, proj, cams[0],
                            mask_mode="none", iters=1, repeats=5)
        # pose 0 alone: a sweep frame does not depend on its batch, but
        # the routing of the rotated batch does, so that drive asks for
        # the sweep by name
        cpu = render(proj_cpu, name, cams[:1], dict(kw, method="sweep")
                     if name == "rotated" else kw)[0][0]
        q_cpu = psnr(out[0].cpu(), cpu)
        off = float(((out[0].cpu() - cpu).abs().amax(-1) > 2e-3)
                    .float().mean())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", renderer.TierFallbackWarning)
            ms = device_timer(render, proj, name, cams, kw, iters=1,
                              repeats=5)
        print(f"main path 11 ({name}): pose 0 {q:.3f} dB against the "
              f"640-step march (lif_tpu {ref_db}); against the CPU port's "
              f"frame {q_cpu:.2f} dB, {off:.2e} of the pixels off by > 2e-3; "
              f"{ms:.3f} ms per {len(cams)} poses = "
              f"{len(cams) / (ms / 1e3):.2f} frames/s; the 40-step exact "
              f"march at pose 0 {q40:.3f} dB, {ms40:.3f} ms [{card}]",
              flush=True)
        check(q >= ref_db - 1.0, f"{name}: {q:.3f} dB, lif_tpu {ref_db}")
        check(q_cpu >= SWEEP_CPU_DB and off <= SWEEP_CPU_OFF,
              f"{name}: the card's frame is not the CPU port's")
        del out, exact

    # the solved invz* in full float32: the card against the CPU port
    cams = sweep_drives(lt, focal)["sweep"][0]
    c1 = np.float32(relative_view_pose(proj.position, proj.rotation,
                                       cams[0].position,
                                       cams[0].rotation)[0])
    solved = []
    for p in (proj, proj_cpu):
        lay = renderer._prepared_textures(p)[0]
        tab = renderer._sweep_tables(p, [lay], cfg.sweep_planes)[0]
        solved.append(solve_depth_aligned(
            lay["disp"], lay["izmin_host"], lay["izmax_host"], c1, focal,
            out_w=W, out_h=H, focal1=focal, num_planes=cfg.sweep_planes,
            chunk=cfg.sweep_chunk, plane_invz=tab).cpu())
    flips = int(((solved[0] > 0) != (solved[1] > 0)).sum())
    both = (solved[0] > 0) & (solved[1] > 0)
    err = float((solved[0] - solved[1])[both].abs().max())
    print(f"main path 11: solved invz* at pose 0 (K = {cfg.sweep_planes}, "
          f"hybrid table), card against the CPU port: {flips} found flips, "
          f"max abs {err:.3g} where both found ({float(both.float().mean()):.4f}"
          f" of the pixels); TF32 off (float32 matmul precision "
          f"{torch.get_float32_matmul_precision()!r})", flush=True)
    check(flips <= INVZ_CPU_FLIPS and err <= INVZ_CPU_MAX,
          "the card's solved invz* is not the CPU port's")


def fit_phase(reset_counts, launch_counts, card, dev):
    """Phase 22, main path 12: scene fitting (see the module note): the
    targets rendered with the true disparity by the port's soft sweep on
    the card, then fit_projector from the perturbed start. No kernel may
    launch."""
    import torch

    import lif_tpu_torch as lt
    from lif_tpu_torch.train import fit

    path12 = MainPath("main path 12", reset_counts, launch_counts)
    rgb, truth, start, positions, rotations = make_fit_problem(0)
    kw = dict(focal_px=0.78 * W, invz_min=FIT_INVZ[0], invz_max=FIT_INVZ[1],
              baseline=1.0, device=dev)
    true_proj = lt.projector_from_arrays(rgb, truth, **kw)
    cam = lt.Camera.create(W, H, focal_px=0.78 * W)
    rel_p, rel_r = fit.relative_poses(true_proj, positions, rotations)
    zero = torch.zeros(3, device=dev)
    with torch.no_grad():
        targets = fit.render_with_params(
            fit.FitParams(true_proj.disp, zero, zero),
            fit.static_projector(true_proj, cam),
            torch.as_tensor(rel_p, device=dev),
            torch.as_tensor(rel_r, device=dev), W, H, 1, FIT_PLANES)
    bad = lt.projector_from_arrays(rgb, start, **kw)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    (params, losses), counts, _ = path12.counted(
        fit.fit_projector, bad, positions, rotations, cam, targets,
        steps=FIT_STEPS, learning_rate=FIT_LR, num_steps=FIT_PLANES)
    ev1.record()
    torch.cuda.synchronize()
    ms = ev0.elapsed_time(ev1) / FIT_STEPS
    peak = torch.cuda.max_memory_allocated()
    err0 = float(np.abs(start - truth).mean())
    err1 = float(np.abs(np.clip(params.disp[0].cpu().numpy(), 0, 1)
                        - truth).mean())
    drop = min(losses[-5:]) / losses[0]
    print(f"main path 12: fit_projector({FIT_POSES} poses at {W}x{H}, "
          f"{FIT_PLANES} planes, {FIT_STEPS} Adam steps at lr {FIT_LR:g}): "
          f"launches {counts}; losses {[round(v, 6) for v in losses]}",
          flush=True)
    print(f"main path 12: min(last 5) / first {drop:.4f} (gate < "
          f"{FIT_DROP}); mean |disp - truth| {err0:.5f} -> {err1:.5f}; first "
          f"losses {losses[:3]} (lif_tpu {LIF_TPU_FIT_LOSSES})", flush=True)
    print(f"main path 12: {ms:.2f} ms per step (CUDA events over the "
          f"{FIT_STEPS} steps, each ending in a host read of its loss); peak "
          f"device memory {peak / 2**30:.2f} GiB (max_memory_allocated; "
          f"{resident / 2**30:.2f} GiB resident before) [{card}]", flush=True)
    MAIN_FRAMES.update(fit_targets=targets, fit_losses=losses)
    check(counts == path12.expect(()), f"fit launches {counts}")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(drop < FIT_DROP, f"the fit's loss fell only to {drop:.4f}")
    check(err1 < err0, f"the fitted disparity is no closer ({err1} vs {err0})")
    for got, want in zip(losses[:3], LIF_TPU_FIT_LOSSES):
        check(abs(got - want) <= FIT_LOSS_RTOL * want,
              f"losses {losses[:3]}, lif_tpu {LIF_TPU_FIT_LOSSES}")


def trajectory_drives(lt, focal):
    """The trajectories of main paths 1, 2 and 4, which main path 13
    shards, {name: (cameras, render_fast_batch keyword arguments)}: main
    path 1's lateral poses (method 'march', as main path 1 renders them),
    main path 2's orbit and main path 4's dolly."""
    lateral = [lt.Camera.create(W, H, focal_px=focal, position=[
        0.135 + 0.02 * i / N_MAIN, 0.0, 0.0]) for i in range(N_MAIN)]
    orbit = orbit_cams(lt, focal, thetas=list(
        np.deg2rad(np.linspace(-ORBIT_DEG, ORBIT_DEG, N_ORBIT))))
    return {"lateral": (lateral, {"method": "march"}), "orbit": (orbit, {}),
            "dolly": (dolly_cams(lt, focal), {})}


def shard_fast(proj, cams, kw, mesh, counts):
    """render_fast_trajectory_sharded of `cams` over the mesh's 'frame'
    axis, cold then warm: (frames of the cold call, its launches, the
    warm call's wall ms: from a barrier to the synchronize after the
    all-gather). counts() zeroes, then reads the launch counts."""
    import torch
    import torch.distributed as dist

    import lif_tpu_torch as lt
    from lif_tpu_torch.parallel import sharding

    template = lt.Camera.create(W, H, focal_px=float(cams[0].focal_px))
    args = (proj, np.stack([c.position for c in cams]), template, mesh)
    kw = dict(kw, cameras_rotations=np.stack([c.rotation for c in cams]))
    counts(reset=True)
    frames = sharding.render_fast_trajectory_sharded(*args, **kw)
    torch.cuda.synchronize()
    launches = counts()
    dist.barrier()
    t0 = time.perf_counter()
    sharding.render_fast_trajectory_sharded(*args, **kw)
    torch.cuda.synchronize()
    return frames, launches, (time.perf_counter() - t0) * 1e3


def plane_mode_phase(proj, focal, lay, reset_counts, launch_counts, card):
    """Main path 14: the uniform and hybrid march grids (see the constants
    note). Every step zeroes the launch counts just before it and checks
    them just after, exactly, and holds each launch it made to the lateral
    kernel's plain versions on that launch's inputs. Returns ({kernel:
    max abs against its plain versions}, the lateral kernel's uniform-grid
    record)."""
    import torch

    import lif_tpu_torch as lt
    from lif_tpu_torch.core.pose import relative_view_pose
    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.ops.cuda import sweep_march as kmarch
    from lif_tpu_torch.utils.profiling import device_timer

    t_phase = time.perf_counter()
    path14 = MainPath("main path 14", reset_counts, launch_counts)
    cfgs = {mode: lt.DEFAULT_CONFIG.replace(plane_mode=mode,
                                           march_planes=PLANE_MODE_K)
            for mode in PLANE_MODES}
    tex = (lay["rgb"], lay["disp"], lay["mask"])
    izmin, izmax, f1 = lay["izmin_host"], lay["izmax_host"], lay["focal_host"]

    # the kernel against its plain versions on the uniform grid, planned
    # as the main path plans it (renderer._march_tables): the 8-pose check
    # batch, then a 2-pose batch of SEGMENT_K planes
    def kernel_check(n, k):
        cams_n = [lt.Camera.create(W, H, focal_px=focal, position=[
            0.135 + 0.02 * i / N_CHECK, 0.0, 0.0]) for i in range(n)]
        c1 = np.stack([relative_view_pose(proj.position, proj.rotation,
                                          c.position, c.rotation)[0]
                       for c in cams_n]).astype(np.float32)
        cfg = cfgs["uniform"].replace(march_planes=k)
        planes, k_l = renderer._march_tables(proj, 0, cfg, None, c1[:, 0],
                                             0.0)
        plan = renderer._march_plan(lay, float(np.abs(c1[:, 0]).max()), W,
                                    H)
        args = kmarch.lateral_kernel_inputs(
            kmarch.prepare_translation_src(*tex, plan), izmin, izmax, c1,
            f1, planes, plan, k_l)
        share = float((args[2] != 0).float().mean())
        with recorded_calls() as calls:
            kmarch.march_translation_cuda(*tex, izmin, izmax, c1, f1, planes,
                                          plan, k_l, rows=lay["skip_rows"])
        errs = hold_to_plain(calls, f"main path 14: the uniform grid, K = "
                                    f"{k_l}, {n} poses")
        print(f"main path 14: uniform grid, K = {k_l}, {n} poses: "
              f"{share:.4f} of the (pose, plane) fractions nonzero (gate "
              f"{FRACTION_MIN})", flush=True)
        check(share >= FRACTION_MIN, f"K = {k_l}: only {share:.4f} of the "
                                     "fractions are nonzero")
        return args, planes, calls[0][2], errs["lateral_march"]

    args, planes, (found, invz, rgba), err = kernel_check(N_CHECK,
                                                          PLANE_MODE_K)
    v_top = izmax + (izmin - izmax) * float(lay["disp"].max())
    walked, n_px = planes_walked(found, invz, planes, v_top), found.numel()
    bound = bound_record(
        "lateral_march uniform", "lif_tpu_torch/csrc/sweep_march.cu",
        tensor_bytes(*args, found, invz, rgba), walked, found.numel(),
        int(found.sum()), N_CHECK)
    kernel_ms = device_timer(kmarch.sweep_lateral, *args,
                             rows=lay["skip_rows"], iters=10, repeats=5)
    del found, invz, rgba
    check(SEGMENT_K > kmarch.SEGMENT_PLANES,
          f"K = {SEGMENT_K} stays inside one kernel segment")
    err = max(err, kernel_check(N_SEGMENT, SEGMENT_K)[3])
    path14.errs["lateral_march"] = err

    # the mono batch on each grid over main path 1's poses
    cams = trajectory_drives(lt, focal)["lateral"][0]
    exact = {0: MAIN_FRAMES["lateral_exact"]}
    for pose in PLANE_MODE_POSES:
        if pose not in exact:
            exact[pose] = lt.render_mono_view(proj, cams[pose],
                                              mask_mode="none", num_steps=640)
    batch_ms = {}
    for mode, cfg in cfgs.items():
        (out, tiers), counts, calls = path14.counted(
            lt.render_fast_batch, proj, cams, method="march", config=cfg,
            return_tiers=True)
        coverage = float(out[..., 3].mean())
        print(f"main path 14: render_fast_batch({N_MAIN} poses, plane_mode "
              f"{mode!r}, K = {PLANE_MODE_K}) -> {tuple(out.shape)}, tiers "
              f"{tiers}, launches {counts}, alpha coverage {coverage:.4f}",
              flush=True)
        check(tiers == ("march",), f"{mode} tiers {tiers}")
        check(counts == path14.expect(("march",) * 2),
              f"{mode} launches {counts}: as main path 1, two chunks")
        check(tuple(out.shape) == (N_MAIN, H, W, 4), f"{mode} shape")
        check(bool(torch.isfinite(out).all()), f"non-finite {mode} output")
        check(0.5 < coverage <= 1.0, f"{mode} alpha coverage {coverage}")
        check(not torch.equal(out, MAIN_FRAMES["lateral"]),
              f"the {mode} frames are main path 1's snap frames")
        path14.held(calls, f"{mode} batch", poses=4)
        for pose in PLANE_MODE_POSES:
            q = psnr(out[pose], exact[pose])
            ref_db = LIF_TPU_PLANE_MODE_PSNR[(mode, pose)]
            print(f"main path 14: {mode}, pose {pose}: {q:.3f} dB against "
                  f"the 640-step march (lif_tpu {ref_db:.3f})", flush=True)
            check(q >= ref_db - 1.0,
                  f"{mode} pose {pose}: {q:.3f} dB, lif_tpu {ref_db}")
        del out, calls
        batch_ms[mode] = device_timer(lt.render_fast_batch, proj, cams,
                                      method="march", config=cfg, iters=1,
                                      repeats=5)
        print(f"main path 14: render_fast_batch on the {mode} grid: "
              f"{batch_ms[mode]:.3f} ms per {N_MAIN} poses = "
              f"{N_MAIN / (batch_ms[mode] / 1e3):.1f} frames/s at {W}x{H} "
              f"[{card}]", flush=True)
    print(f"main path 14: lateral_march kernel on the uniform grid: "
          f"{kernel_ms / N_CHECK:.4f} ms/frame ({N_CHECK}-pose batch, K = "
          f"{PLANE_MODE_K}, {walked / n_px:.1f} planes per pixel), "
          f"bound {bound[0]:.5f} ms/frame (by {bound[1]}) [{card}]",
          flush=True)

    # stereo: main path 9's pairs on the uniform grid
    left, right, pairs = MAIN_FRAMES.pop("stereo")
    (out, tiers), counts, calls = path14.counted(
        lt.render_stereo_fast_batch, left, right, pairs,
        config=cfgs["uniform"], return_tiers=True)
    print(f"main path 14: render_stereo_fast_batch({N_PAIRS} pairs, "
          f"uniform grid) -> {tuple(out.shape)}, tiers {tiers}, launches "
          f"{counts}", flush=True)
    check(tiers == (("march",), ("march",)), f"uniform pair tiers {tiers}")
    check(counts == path14.expect(("march",) * 6),
          f"uniform pair launches {counts}: 2 eyes x 3 chunks")
    check(bool(torch.isfinite(out).all()), "non-finite uniform pairs")
    del out
    path14.held(calls, f"{N_PAIRS} pairs, uniform grid", poses=4)
    del calls

    # fusion: main path 10's 1280x800 projectors at N_FUSED cameras on the
    # hybrid grid
    projs = MAIN_FRAMES["fused_projs"]
    fcams = [lt.Camera.create(W, H, focal_px=float(projs[0].focal[0]),
                              position=[FUSED_CAM_X + FUSED_CAM_DX * j, 0.0,
                                        0.0]) for j in range(N_FUSED)]
    out, counts, calls = path14.counted(lt.render_fused_fast_batch, projs,
                                        fcams, config=cfgs["hybrid"])
    print(f"main path 14: render_fused_fast_batch({len(projs)} projectors, "
          f"{N_FUSED} cameras at {W}x{H}, hybrid grid) -> "
          f"{tuple(out.shape)}, launches {counts}, alpha coverage "
          f"{float(out[..., 3].mean()):.4f}", flush=True)
    check(counts == path14.expect(("march",) * len(projs)),
          f"hybrid fused launches {counts}")
    check(bool(torch.isfinite(out).all()), "non-finite hybrid fused frames")
    del out
    path14.held(calls, "fused, hybrid grid", poses=2)
    del calls
    print(f"main path 14: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    record = {"k": PLANE_MODE_K, "ms": kernel_ms / N_CHECK,
              "planes_per_px": walked / n_px,
              "bound_ms": bound[0], "bound_by": bound[1],
              "batch_ms": batch_ms}
    return path14.errs, record


def launch_counter():
    """counts(reset=False): zero every kernel's launch count (reset) or
    read them."""
    from lif_tpu_torch.ops.cuda import splat_march as kbb
    from lif_tpu_torch.ops.cuda import sweep_march as kmarch
    from lif_tpu_torch.ops.cuda import sweep_scaled as kscaled
    from lif_tpu_torch.ops.cuda import sweep_target as ktarget

    wrappers = {"lateral_march": kmarch.sweep_lateral,
                "target_march": ktarget.sweep_target,
                "scaled_march": kscaled.sweep_scaled,
                "billboard_march": kbb.sweep_billboard}

    def counts(reset=False):
        if reset:
            for fn in wrappers.values():
                fn.launches = 0
        return {name: fn.launches for name, fn in wrappers.items()}

    return counts


def shard_rank(refs):
    """One rank of main path 13's gloo launches (CUDA tensors, the ranks
    sharing the card): the seeded scene of main paths 1-7 on the card; the
    sharded lateral, orbit and dolly trajectories against main paths 1, 2
    and 4's frames (`refs`, CUDA tensors this process reads through CUDA
    IPC) with each drive's launches; render_view_tiled at main path 1's
    pose 0 against its 640-step oracle; render_fused_projectors on main
    path 10's 1280x800 projectors against the one-process fusion (a view
    per rank; at 4 ranks also 2 views x 2 tiles); at 4 ranks
    FIT_SHARD_STEPS fit steps of main path 12's problem on a FIT_MESH
    (data, tile) mesh. Returns the errors, launches, wall ms, losses and
    the rank's peak device memory."""
    import torch
    import torch.distributed as dist

    import lif_tpu_torch as lt
    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.parallel import sharding
    from lif_tpu_torch.parallel.sharding import render_fused_projectors
    from lif_tpu_torch.train import fit

    n = dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    counts = launch_counter()
    rgb, disp = make_scene(0)
    proj = lt.projector_from_arrays(
        rgb, disp, focal_px=0.78 * W, invz_min=INVZ_NEAR, invz_max=INVZ_FAR,
        baseline=BASELINE, device=dev)
    focal = float(proj.focal[0])
    frames_mesh = sharding.make_mesh(("frame",), device_type="cuda")
    drives = trajectory_drives(lt, focal)
    out = {"drives": {}}
    for name, (cams, kw) in drives.items():
        frames, launches, ms = shard_fast(proj, cams, kw, frames_mesh,
                                          counts)
        chunks = len(renderer._pose_chunks(len(cams) // n,
                                           lt.DEFAULT_CONFIG.pose_chunk))
        out["drives"][name] = dict(
            err=float((frames - refs[name]).abs().max()), launches=launches,
            chunks=chunks, ms=ms, shape=tuple(frames.shape))
        del frames
    tiles = sharding.make_mesh(("tile",), device_type="cuda")
    cam0 = drives["lateral"][0][0]
    dist.barrier()
    t0 = time.perf_counter()
    band = sharding.render_view_tiled(proj, cam0, tiles, mask_mode="none",
                                      num_steps=640)
    torch.cuda.synchronize()
    out["tiled"] = dict(err=float((band - refs["lateral_exact"]).abs().max()),
                        ms=(time.perf_counter() - t0) * 1e3)
    del band
    projs, cam = refs["fused_projs"], refs["fused_cam"]
    views = sharding.make_mesh(("view",), device_type="cuda")
    fused = {}
    if n == len(projs):
        got = render_fused_projectors(projs, cam, views,
                                      num_steps=FUSED_STEPS)
        fused[f"{n} views"] = float((got - refs["fused_exact"]).abs().max())
    if n == 2:
        got = render_fused_projectors(projs[:2], cam, views,
                                      num_steps=FUSED_STEPS)
        fused["2 views"] = float((got - refs["fused_exact2"]).abs().max())
    if n == 4:
        mesh = sharding.make_mesh(("view", "tile"), (2, 2),
                                  device_type="cuda")
        got = render_fused_projectors(projs[:2], cam, mesh, tile_axis="tile",
                                      num_steps=FUSED_STEPS)
        fused["2 views x 2 tiles"] = float(
            (got - refs["fused_exact2"]).abs().max())
        rgb_f, _, start, positions, rotations = make_fit_problem(0)
        bad = lt.projector_from_arrays(
            rgb_f, start, focal_px=0.78 * W, invz_min=FIT_INVZ[0],
            invz_max=FIT_INVZ[1], baseline=1.0, device=dev)
        _, losses = fit.fit_projector(
            bad, positions, rotations, lt.Camera.create(W, H,
                                                        focal_px=0.78 * W),
            refs["fit_targets"], steps=FIT_SHARD_STEPS,
            learning_rate=FIT_LR, num_steps=FIT_PLANES,
            mesh=sharding.make_mesh(("data", "tile"), FIT_MESH,
                                    device_type="cuda"))
        out["fit_losses"] = losses
    out["fused"] = fused
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def shard_phase(proj, focal, reset_counts, launch_counts, card):
    """Phase 23, main path 13: parallel.sharding on the one card (see the
    module note). World size 1 runs on NCCL in this process; SHARD_RANKS
    ranks run on gloo with CUDA tensors through parallel.launch.run_ranks,
    reading main paths 1, 2, 4, 10 and 12's results through CUDA IPC.
    Every rank's launches must be what its block of poses implies: one
    launch of the drive's kernel per pose chunk of the block."""
    import functools
    import tempfile

    import torch
    import torch.distributed as dist

    import lif_tpu_torch as lt
    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.parallel import sharding
    from lif_tpu_torch.parallel.launch import run_ranks
    from lif_tpu_torch.parallel.sharding import render_fused_projectors

    kernel_of = {"lateral": "lateral_march", "orbit": "target_march",
                 "dolly": "scaled_march"}

    def counts(reset=False):
        if reset:
            reset_counts()
        return launch_counts()

    def expect(name, chunks):
        want = dict.fromkeys(launch_counts(), 0)
        want[kernel_of[name]] = chunks
        return want

    wall = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = sharding.make_mesh(("frame",), device_type="cuda")
            for name, (cams, kw) in trajectory_drives(lt, focal).items():
                frames, launches, ms = shard_fast(proj, cams, kw, mesh,
                                                  counts)
                record_path("main path 13, 1 rank", launches)
                chunks = len(renderer._pose_chunks(
                    len(cams), lt.DEFAULT_CONFIG.pose_chunk))
                equal = torch.equal(frames, MAIN_FRAMES[name])
                wall[(name, 1)] = ms
                print(f"main path 13: render_fast_trajectory_sharded({name}, "
                      f"{len(cams)} poses) on 1 rank (NCCL): launches "
                      f"{launches}, equal to render_fast_batch's {equal}, "
                      f"{ms:.3f} ms (wall, warm)", flush=True)
                check(equal, f"1-rank sharded {name} frames differ")
                check(launches == expect(name, chunks),
                      f"1-rank sharded {name} launches {launches}")
                del frames
        finally:
            dist.destroy_process_group()
    projs = MAIN_FRAMES["fused_projs"]
    refs = {name: MAIN_FRAMES[name] for name in (
        "lateral", "orbit", "dolly", "lateral_exact", "fused_projs",
        "fused_cam", "fused_exact", "fit_targets")}
    refs["fused_exact2"] = render_fused_projectors(
        projs[:2], MAIN_FRAMES["fused_cam"], num_steps=FUSED_STEPS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for n in SHARD_RANKS:
        t0 = time.perf_counter()
        ranks = run_ranks(functools.partial(shard_rank, refs), n,
                          backend="gloo", device_type="cuda",
                          timeout_s=SHARD_TIMEOUT_S)
        launch_s = time.perf_counter() - t0
        for name in kernel_of:
            recs = [r["drives"][name] for r in ranks]
            err = max(r["err"] for r in recs)
            wall[(name, n)] = max(r["ms"] for r in recs)
            per_rank = [r["launches"] for r in recs]
            want = expect(name, recs[0]["chunks"])
            record_path(f"main path 13, {n} ranks (rank 0)", per_rank[0])
            print(f"main path 13: render_fast_trajectory_sharded({name}) on "
                  f"{n} ranks (gloo, CUDA tensors): frames "
                  f"{recs[0]['shape']}, max abs against the one-process "
                  f"frames {err:.3g}, launches per rank {per_rank} "
                  f"(expected {want}), {wall[(name, n)]:.3f} ms (wall, "
                  f"warm, slowest rank)", flush=True)
            check(err <= SHARD_TOL, f"{n}-rank sharded {name}: {err:.3g}")
            check(all(c == want for c in per_rank),
                  f"{n}-rank sharded {name} launches {per_rank}")
        tiled = max(r["tiled"]["err"] for r in ranks)
        fused = {k: max(r["fused"][k] for r in ranks)
                 for k in ranks[0]["fused"]}
        peaks = [round(r["peak_gib"], 3) for r in ranks]
        print(f"main path 13, {n} ranks: render_view_tiled ({W}x{H}, 640 "
              f"steps, {H // n} rows a rank) against render_mono_view: max "
              f"abs {tiled:.3g}, {max(r['tiled']['ms'] for r in ranks):.1f} "
              f"ms; render_fused_projectors ({FUSED_STEPS} steps) against the "
              f"one-process fusion: {fused}; peak device memory per rank "
              f"{peaks} GiB; launch {launch_s:.1f} s [{card}]", flush=True)
        check(tiled <= TILED_TOL, f"{n}-rank tiled render: {tiled:.3g}")
        check(fused and all(v <= SHARD_TOL for v in fused.values()),
              f"{n}-rank fused render: {fused}")
        if n == FIT_MESH[0] * FIT_MESH[1]:
            losses = [r["fit_losses"] for r in ranks]
            want = MAIN_FRAMES["fit_losses"][:FIT_SHARD_STEPS]
            rel = max(abs(a - b) / b for a, b in zip(losses[0], want))
            print(f"main path 13: fit_projector on a {FIT_MESH} (data, tile) "
                  f"mesh, {FIT_SHARD_STEPS} steps: losses {losses[0]} "
                  f"(one process: {want}), max relative difference "
                  f"{rel:.3g}", flush=True)
            check(all(x == losses[0] for x in losses),
                  "the ranks report different losses")
            check(rel <= FIT_SHARD_RTOL, f"sharded fit losses: {rel:.3g}")
    from lif_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    dry = dryrun_multichip(max(SHARD_RANKS), timeout_s=SHARD_TIMEOUT_S)
    print(f"main path 13: entry.dryrun_multichip({len(dry)}) with its "
          f"defaults on {torch.cuda.device_count()} card(s): devices {sorted({r['device'] for r in dry})}, fit "
          f"loss {dry[0]['loss']}, fused {dry[0]['shape']} finite "
          f"{all(r['finite'] for r in dry)}, max abs against the reversed "
          f"projector order {max(r['order_err'] for r in dry):.3g}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(all(r["device"] == "cuda" for r in dry),
          "the dry run did not run on the card")
    check(len({r["loss"] for r in dry}) == 1,
          "the dry run's ranks report different losses")
    per_drive = [
        f"{name} " + ", ".join(f"{n} rank(s) {wall[(name, n)]:.1f}"
                               for n in (1, *SHARD_RANKS))
        for name in kernel_of]
    print("main path 13: wall ms of render_fast_trajectory_sharded (warm, "
          "slowest rank) " + "; ".join(per_drive)
          + f" [{card}]; the ranks share one card, so this is no scaling "
          f"measurement; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    try:
        record, card = run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
