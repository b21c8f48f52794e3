#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs torch with CUDA, nvcc (the CUDA toolkit) and numpy; it imports
neither jax nor lif_tpu. Phases, each of which exits 1 on failure:

1. device: a CUDA device, and its name and power limit from nvidia-smi;
2. build: compile csrc/sweep_march.cu, csrc/sweep_target.cu,
   csrc/sweep_scaled.cu and csrc/splat_march.cu with nvcc (sm_90a) into
   lif_tpu_torch/_build/, one nvcc per source, started together;
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
    render(mode='mesh') per frame.

Main paths 1-6 also check their launch counts (2, 3, 1, 1, 1, 1). The
second-to-last line is the kernels' JSON record (with each kernel's bound:
the larger of its bytes over 3.35 TB/s and its FP32 operations over 67
TFLOP/s, as the source note of its .cu file counts them, a march's
planes counted from this run's crossings, the billboard splat's O(1) per
source pixel) and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
# the H100 SXM's published peaks: HBM bytes/s and FP32 operations/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the FP32 operation count in each kernel's source note
OPS_NOTE = re.compile(
    r"FP32 ops: per plane (\d+), per pixel (\d+), per found (\d+)\.")


class SmokeFailure(Exception):
    pass


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
        from lif_tpu_torch.models import renderer
        from lif_tpu_torch.ops.cuda import build
        from lif_tpu_torch.ops.cuda import splat_march as kbb
        from lif_tpu_torch.ops.cuda import sweep_march as kmarch
        from lif_tpu_torch.ops.cuda import sweep_scaled as kscaled
        from lif_tpu_torch.ops.cuda import sweep_target as ktarget
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

    # 2. build, one nvcc per source, all started together
    sources = ("sweep_march", "sweep_target", "sweep_scaled", "splat_march")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.load_library, sources))
    print(f"build: {', '.join(f'{n}.cu' for n in sources)} in "
          f"{time.perf_counter() - t0:.2f} s ({build.BUILD_DIR})", flush=True)
    for name in sources:
        for log in build.BUILD_DIR.glob(f"lib{name}-*.log"):
            for line in log.read_text().splitlines():
                # the kernel (a mangled name), then its registers and spills
                if ("entry function" in line or "registers" in line
                        or "spill" in line):
                    print(f"  ptxas {name}: {line.strip()}", flush=True)

    def reset_counts():
        kmarch.sweep_lateral.launches = 0
        ktarget.sweep_target.launches = 0
        kscaled.sweep_scaled.launches = 0
        kbb.sweep_billboard.launches = 0

    def launch_counts():
        return {"lateral_march": kmarch.sweep_lateral.launches,
                "target_march": ktarget.sweep_target.launches,
                "scaled_march": kscaled.sweep_scaled.launches,
                "billboard_march": kbb.sweep_billboard.launches}

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
    cams = [cam(0.135 + 0.02 * i / N_MAIN) for i in range(N_MAIN)]
    reset_counts()
    out, tiers = lif_tpu_torch.render_fast_batch(
        proj, cams, method="march", return_tiers=True
    )
    torch.cuda.synchronize()
    launches = kmarch.sweep_lateral.launches
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
    return {"kernels": [lateral, target, scaled, billboard]}, card


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
    cams = orbit_cams(lt, focal, thetas=list(thetas))
    reset_counts()
    out, tiers = lt.render_fast_batch(proj, cams, return_tiers=True)
    torch.cuda.synchronize()
    launches = ktarget.sweep_target.launches
    coverage = float(out[..., 3].mean())
    print(f"main path 2: render_fast_batch({N_ORBIT} orbit poses, +-"
          f"{ORBIT_DEG:g} deg) -> {tuple(out.shape)}, tiers {tiers}, "
          f"target_march launches {launches}, alpha coverage "
          f"{coverage:.4f}", flush=True)
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
    coverage = float(out[..., 3].mean())
    print(f"main path 4: render_fast_batch({N_DOLLY} dolly poses) -> "
          f"{tuple(out.shape)}, tiers {tiers}, scaled_march launches "
          f"{launches}, alpha coverage {coverage:.4f}", flush=True)
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
