#!/usr/bin/env python3
"""What the billboard and target-ray kernels do on one CUDA card, at the
shapes of chip_smoke.py's kernel checks (8 poses of its seeded 1280x800
scene).

Run from the repository root: ``python3 tools/profile_kernels.py``. For
each kernel it prints its time (CUDA events, median of 5 runs of 10
launches after a warm-up), torch.profiler's device time for one launch,
and the work of its walk, counted by replaying the walk in plain torch on
the card (the replay makes the same decisions as the kernel, so its
counts are what a device counter in the kernel would read):

- billboard: the planes the gather dual of lif_tpu's TPU kernel visits
  per pixel (through its winner and the plane that ends its chain, all K
  where nothing covers it) and per warp (32 columns of a row, the
  slowest lane);
- target: the planes the one-thread-per-pixel walk visits per pixel and
  per warp from its start plane through the crossing, and for the skip
  walk of ops.sweep_target.march_target_skip_plain at runs of 8, 16, 24
  and 32 planes: warp runs tested and skipped, planes walked per warp
  (those where a lane has a candidate, and the candidate rounds in which
  the kernel reads taps), b0 tests and bilinear reads.

Needs torch with CUDA, nvcc and numpy; imports neither jax nor lif_tpu.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = (8, 16, 24, 32)


def profiled_ms(fn) -> float:
    """Device time (ms) of the CUDA kernels one call of fn launches."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from profile_paths import kernel_rows

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ms for name, ms in kernel_rows(prof, 1)
               if "march_kernel" in name or "billboard_kernel" in name)


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
          f"{prof / cs.N_CHECK:.4f} ms/frame [{card}]")
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
    ms = device_timer(ktarget.march_target_cuda, *args, iters=10, repeats=5)
    prof = profiled_ms(lambda: ktarget.march_target_cuda(*args))
    n_px = cs.N_CHECK * cs.W * cs.H
    n_warps = n_px // 32
    print(f"\n== target kernel ({cs.N_CHECK} orbit poses, {cs.W}x{cs.H}, "
          f"K={k}, depth only): {ms / cs.N_CHECK:.4f} ms/frame (CUDA "
          f"events), torch.profiler {prof / cs.N_CHECK:.4f} ms/frame "
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_kernels: no CUDA device", file=sys.stderr)
        return 1
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
    billboard(cs, lt, proj, lay, focal, card)
    target(cs, lt, proj, lay, focal, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
