#!/usr/bin/env python3
"""What the four march kernels do on one CUDA card, at the shapes of
chip_smoke.py's kernel checks (8 poses of its seeded 1280x800 scene).

Run from the repository root: ``python3 tools/profile_kernels.py
[kernel ...]`` with kernels from billboard, target, lateral, dolly and
phase_a (default: all five, each in a process of its own, since
torch.profiler can stop reporting kernels after a few sessions in one
process). For each kernel it prints its time (CUDA events, median of 5
runs of 10 launches after a warm-up), torch.profiler's device time per
launch (10 launches in one session, the kernels' recorded device time over
the launches recorded; "not measured" where it records none), and the
work of its walk,
counted by replaying the walk in plain torch on the card (the replay
makes the same decisions as the kernel, so its counts are what a device
counter in the kernel would read):

- billboard: the planes the gather dual of lif_tpu's TPU kernel visits
  per pixel (through its winner and the plane that ends its chain, all K
  where nothing covers it) and per warp (32 columns of a row, the
  slowest lane);
- target: the planes the one-thread-per-pixel walk visits per pixel and
  per warp from its start plane through the crossing, and for the skip
  walk of ops.sweep_target.march_target_skip_plain at runs of 8, 16, 24
  and 32 planes: warp runs tested and skipped, planes walked per warp
  (those where a lane has a candidate, and the candidate rounds in which
  the kernel reads taps), b0 tests and bilinear reads;
- lateral (8 lateral poses, K = 320, refine 0): the planes the previous
  one-thread walk visits per pixel (from k_lo - 1 through the crossing)
  and per warp (32 columns of a row), and for the skip walk of
  ops.sweep_march.march_translation_skip_plain at runs of 8, 16 and 32
  planes: warp runs tested and skipped, planes walked per warp (whole
  groups of 4), lane plane reads and bracket refreshes;
- dolly (8 dolly poses, K = 128, refine 2) and phase_a (8 poses of the
  tilted orbit's phase A, 1792x1024, K = 320, refine 2), the scaled
  kernel: the previous one-thread walk per pixel and per warp, and the
  skip walk of ops.sweep_scaled.march_scaled_skip_plain at runs of 8, 16
  and 32 planes, counted as for target.
The kernels are timed as built (the lateral and scaled kernels skip runs
of 16 planes, kRun in their sources); the counts at other run lengths
come from the plain mirrors alone.

Needs torch with CUDA, nvcc and numpy; imports neither jax nor lif_tpu.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = (8, 16, 24, 32)  # the target kernel's mirror (the kernel: kRun 24)
NEW_RUNS = (8, 16, 32)  # the lateral and scaled mirrors (the kernels: 16)
KERNELS = ("billboard", "target", "lateral", "dolly", "phase_a")


def profiled_ms(fn, calls: int = 10) -> float | None:
    """Device time (ms) per launch of the march kernel fn launches, from
    `calls` calls in one torch.profiler session: the recorded device time
    over the number of launches recorded, or None where none was."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and (
                "march_kernel" in e.key or "billboard_kernel" in e.key):
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
            n += e.count
    return us / 1e3 / n if n and us else None


def per_frame(ms, n) -> str:
    """A profiler reading per frame, or "not measured"."""
    return "not measured" if ms is None else f"{ms / n:.4f} ms/frame"


def billboard(cs, lt, proj, lay, focal, card):
    import torch

    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.ops import splat_march as sbb
    from lif_tpu_torch.ops.cuda import splat_march as kbb
    from lif_tpu_torch.utils.profiling import device_timer

    cams = [lt.Camera.create(cs.W, cs.H, focal_px=focal, position=[
        0.135 + 0.02 * i / cs.N_CHECK, 0.0, 0.0]) for i in range(cs.N_CHECK)]
    bp = renderer.plan_billboard(proj, cams)
    args = sbb.billboard_inputs(
        lay["rgb"], lay["disp"], lay["mask"], lay["izmin_host"],
        lay["izmax_host"], bp.c1x, lay["focal_host"], bp.ixs, bp.mms,
        bp.plan, bp.num_planes, bp.cx0, bp.cy0, 1.0)
    ms = device_timer(kbb.sweep_billboard, *args, iters=10, repeats=5)
    prof = profiled_ms(lambda: kbb.sweep_billboard(*args))
    # the winner's source column, carried through the colour channel
    h, w = lay["disp"].shape
    cols = torch.arange(w, device=args[0].device, dtype=torch.float32)
    probe = torch.zeros_like(args[1])
    probe[..., 0] = cols
    k = bp.num_planes
    lane = lane_max = 0
    for i in range(cs.N_CHECK):
        found, _, src = sbb.billboard_scatter_plain(
            args[0], probe, args[2][i], args[3][i], args[4][i], *args[5:])
        m_win = cols - src[..., 0]  # the winner's shift
        ladder = args[3][i]
        first = ladder[0]
        step = 1.0 if float(ladder[-1]) >= float(first) else -1.0
        kstar = (m_win - first) * step
        visits = torch.where(found > 0, torch.clamp(kstar + 2, max=k),
                             float(k))
        lane += float(visits.sum())
        lane_max += float(visits.reshape(h, -1, 32).amax(-1).sum()) * 32
    n_px = cs.N_CHECK * h * w
    print(f"\n== billboard kernel ({cs.N_CHECK} poses, {w}x{h}, K={k}): "
          f"{ms / cs.N_CHECK:.4f} ms/frame (CUDA events), torch.profiler "
          f"{per_frame(prof, cs.N_CHECK)} [{card}]")
    print(f"  gather dual: {lane / n_px:.1f} planes visited per pixel, "
          f"{lane_max / n_px:.1f} per pixel as its warp's slowest lane "
          f"(SIMT efficiency {lane / lane_max:.3f})")


def target(cs, lt, proj, lay, focal, card):
    import torch

    from lif_tpu_torch.core.pose import relative_view_pose
    from lif_tpu_torch.ops import sweep_target as starget
    from lif_tpu_torch.ops.cuda import sweep_target as ktarget
    from lif_tpu_torch.utils.profiling import device_timer

    izmin, izmax = lay["izmin_host"], lay["izmax_host"]
    disp = lay["disp"]
    cams = cs.orbit_cams(lt, focal, thetas=list(
        np.deg2rad(np.linspace(-cs.ORBIT_DEG, cs.ORBIT_DEG, cs.N_CHECK))))
    pos, rot = zip(*(relative_view_pose(proj.position, proj.rotation,
                                        c.position, c.rotation)
                     for c in cams))
    plan = starget.plan_target(cs.W, cs.H, cs.W, cs.H, focal, focal, rot,
                               pos, izmin, izmax)[0]
    poses = torch.as_tensor(np.stack([
        starget.target_pose_scalars(r, c, focal, focal, cs.W, cs.H, cs.W,
                                    cs.H) for r, c in zip(rot, pos)
    ]), device=disp.device)
    grids, k = starget.target_plane_grids(rot, pos, focal, focal, cs.W, cs.H,
                                          cs.W, cs.H, izmin, izmax)
    grids = torch.as_tensor(grids, device=disp.device)
    args = (disp, izmin, izmax, poses, grids, plan)
    tables = lay["skip_target"]  # cached with the textures, as on the path
    ms = device_timer(ktarget.march_target_cuda, *args, tables=tables,
                      iters=10, repeats=5)
    prof = profiled_ms(lambda: ktarget.march_target_cuda(*args,
                                                         tables=tables))
    n_px = cs.N_CHECK * cs.W * cs.H
    n_warps = n_px // 32
    print(f"\n== target kernel ({cs.N_CHECK} orbit poses, {cs.W}x{cs.H}, "
          f"K={k}, depth only): {ms / cs.N_CHECK:.4f} ms/frame (CUDA "
          f"events), torch.profiler {per_frame(prof, cs.N_CHECK)} "
          f"[{card}]")
    for run in RUNS:
        st: dict = {}
        for i in range(cs.N_CHECK):
            starget.march_target_skip_plain(disp, izmin, izmax, poses[i],
                                            grids[i], cs.W, cs.H, run=run,
                                            stats=st)
        if run == RUNS[0]:
            print(f"  one thread per pixel: {st['old_lane_visits'] / n_px:.1f}"
                  f" planes visited per pixel, "
                  f"{st['old_warp_visits'] / n_px:.1f} as its warp's "
                  f"slowest lane (SIMT efficiency "
                  f"{st['old_lane_visits'] / st['old_warp_visits']:.3f})")
        print(f"  skip walk, runs of {run}: {st['runs'] / n_warps:.2f} runs "
              f"tested per warp, {st['runs_skipped'] / max(st['runs'], 1):.3f}"
              f" of them skipped; {st['warp_steps'] / n_warps:.1f} planes "
              f"walked per warp ({st['warp_bil_steps'] / n_warps:.1f} with "
              f"a lane's candidate, {st['warp_bil_rounds'] / n_warps:.1f} "
              f"candidate rounds); per pixel {st['lane_tests'] / n_px:.1f} "
              f"b0 tests, {st['bil_reads'] / n_px:.2f} bilinear reads")


def lateral(cs, lt, proj, lay, focal, card):
    import torch

    from lif_tpu_torch.core.pose import relative_view_pose
    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.ops import sweep_march as smarch
    from lif_tpu_torch.ops.cuda import sweep_march as kmarch
    from lif_tpu_torch.utils.profiling import device_timer

    cams = [lt.Camera.create(cs.W, cs.H, focal_px=focal, position=[
        0.135 + 0.02 * i / cs.N_CHECK, 0.0, 0.0]) for i in range(cs.N_CHECK)]
    c1 = np.stack([relative_view_pose(proj.position, proj.rotation,
                                      c.position, c.rotation)[0]
                   for c in cams]).astype(np.float32)
    plan = renderer._march_plan(lay, float(np.abs(c1[:, 0]).max()), cs.W,
                                cs.H)
    planes, k = renderer._snap_tables(lay, c1[:, 0], None, 0.0, 1,
                                      lay["disp"].device)
    izmin, izmax = lay["izmin_host"], lay["izmax_host"]
    prep = kmarch.prepare_translation_src(lay["rgb"], lay["disp"],
                                          lay["mask"], plan)
    args = kmarch.lateral_kernel_inputs(prep, izmin, izmax, c1,
                                        lay["focal_host"], planes, plan, k)
    src, ix, fx, izt, klo, khi = args[:6]
    rows = lay["skip_rows"]
    n_px = cs.N_CHECK * cs.W * cs.H
    n_warps = n_px // 32
    prof = profiled_ms(lambda: kmarch.sweep_lateral(*args, rows=rows))
    ms = device_timer(kmarch.sweep_lateral, *args, rows=rows, iters=10,
                      repeats=5)
    print(f"\n== lateral kernel ({cs.N_CHECK} lateral poses, {cs.W}x{cs.H}, "
          f"K={k}, refine 0, runs of {smarch.LATERAL_RUN}): "
          f"{ms / cs.N_CHECK:.4f} ms/frame (CUDA events), torch.profiler "
          f"{per_frame(prof, cs.N_CHECK)} [{card}]")
    for run in NEW_RUNS:
        st: dict = {}
        for i in range(cs.N_CHECK):
            smarch.lateral_skip_walk(
                src, ix[i], fx[i], izt[i], klo[i], khi[i], izmin, izmax,
                plan.pad_lo_x, kmarch._pick_tw(plan.out_w), rows, run=run,
                stats=st)
        if run == NEW_RUNS[0]:
            print(f"  one thread per pixel: {st['old_lane_visits'] / n_px:.1f}"
                  f" planes visited per pixel, "
                  f"{st['old_warp_visits'] / n_px:.1f} as its warp's "
                  f"slowest lane (SIMT efficiency "
                  f"{st['old_lane_visits'] / st['old_warp_visits']:.3f})")
        print(f"  skip walk, runs of {run}: {st['runs'] / n_warps:.2f} "
              f"runs tested per warp, "
              f"{st['runs_skipped'] / max(st['runs'], 1):.3f} of them "
              f"skipped; {st['warp_steps'] / n_warps:.1f} planes walked per "
              f"warp; per pixel {st['lane_reads'] / n_px:.1f} plane reads, "
              f"{st['refreshes'] / n_px:.3f} bracket refreshes")


def scaled(cs, lt, proj, lay, focal, card, which):
    import torch

    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.ops import sweep_scaled as sscaled
    from lif_tpu_torch.ops.cuda import sweep_scaled as kscaled
    from lif_tpu_torch.utils.profiling import device_timer

    izmin, izmax, f1 = lay["izmin_host"], lay["izmax_host"], lay["focal_host"]
    disp = lay["disp"]
    refine = lt.DEFAULT_CONFIG.rotated_refine
    if which == "dolly":
        tp = renderer.plan_tiers(proj, cs.dolly_cams(lt, focal))
        _, (plan, k, fr, dxu, dyu), extra = tp.planned[0]
        c1 = torch.as_tensor(tp.pos_b[:cs.N_CHECK], dtype=torch.float32,
                             device=disp.device)
        tabs = sscaled.scaled_table_stack(plan, extra["grids"][:cs.N_CHECK],
                                          c1, f1, fr, dxu, dyu)
    else:
        thetas = np.deg2rad(np.linspace(-cs.TILT_DEG, cs.TILT_DEG,
                                        cs.N_TILT))
        tcams = cs.orbit_cams(lt, focal, thetas=list(thetas),
                              phis=[np.deg2rad(cs.TILT_PHI)] * cs.N_TILT)
        _, setup, extra = renderer.plan_tiers(proj, tcams).planned[0]
        plan, k = setup[0], setup[3]
        tabs = sscaled.scaled_table_stack(
            plan, extra["grids"][:cs.N_CHECK], extra["aligned"][:cs.N_CHECK],
            f1, 1.0)
    tables, dlim = lay["skip_scaled"]
    n_px = cs.N_CHECK * plan.out_w * plan.out_h
    n_warps = n_px // 32

    def launch():
        return kscaled.sweep_scaled(disp, tabs, dlim, plan, izmin, izmax,
                                    refine=refine, tables=tables)

    prof = profiled_ms(launch)
    ms = device_timer(launch, iters=10, repeats=5)
    print(f"\n== scaled kernel, {which} ({cs.N_CHECK} poses, "
          f"{plan.out_w}x{plan.out_h} from {cs.W}x{cs.H}, K={k}, depth only, "
          f"refine {refine}, runs of {sscaled.SCALED_RUN}): "
          f"{ms / cs.N_CHECK:.4f} ms/frame (CUDA events), torch.profiler "
          f"{per_frame(prof, cs.N_CHECK)} [{card}]")
    for run in NEW_RUNS:
        st: dict = {}
        for i in range(cs.N_CHECK):
            sscaled.march_scaled_skip_plain(disp, izmin, izmax, tabs[i], plan,
                                            refine=refine, run=run, stats=st)
        if run == NEW_RUNS[0]:
            print(f"  one thread per pixel: {st['old_lane_visits'] / n_px:.1f}"
                  f" planes visited per pixel, "
                  f"{st['old_warp_visits'] / n_px:.1f} as its warp's "
                  f"slowest lane (SIMT efficiency "
                  f"{st['old_lane_visits'] / st['old_warp_visits']:.3f})")
        print(f"  skip walk, runs of {run}: {st['runs'] / n_warps:.2f} "
              f"runs tested per warp, "
              f"{st['runs_skipped'] / max(st['runs'], 1):.3f} of them "
              f"skipped; {st['warp_steps'] / n_warps:.1f} planes walked per "
              f"warp ({st['warp_bil_steps'] / n_warps:.1f} with a lane's "
              f"candidate, {st['warp_bil_rounds'] / n_warps:.1f} candidate "
              f"rounds); per pixel {st['lane_tests'] / n_px:.1f} b0 tests, "
              f"{st['bil_reads'] / n_px:.2f} bilinear reads")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device", file=sys.stderr)
        return 1
    which = sys.argv[1:] or list(KERNELS)
    bad = [w for w in which if w not in KERNELS]
    if bad:
        print(f"profile_kernels: unknown kernels {bad}; choose from "
              f"{KERNELS}", file=sys.stderr)
        return 2
    if len(which) > 1:  # one process per kernel
        import subprocess

        return max(subprocess.run([sys.executable, __file__, name]).returncode
                   for name in which)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import lif_tpu_torch as lt
    from lif_tpu_torch.models import renderer

    card = cs.card_line()
    print(card, flush=True)
    rgb, disp = cs.make_scene(0)
    proj = lt.projector_from_arrays(
        rgb, disp, focal_px=0.78 * cs.W, invz_min=cs.INVZ_NEAR,
        invz_max=cs.INVZ_FAR, baseline=cs.BASELINE,
        device=torch.device("cuda", 0))
    focal = float(proj.focal[0])
    lay = renderer._prepared_textures(proj)[0]
    for name in which:
        if name in ("dolly", "phase_a"):
            scaled(cs, lt, proj, lay, focal, card, name)
        else:
            globals()[name](cs, lt, proj, lay, focal, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
