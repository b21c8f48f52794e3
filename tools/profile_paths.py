#!/usr/bin/env python3
"""Where the time goes on one CUDA card, for the drives of chip_smoke.py.

Run from the repository root: ``python3 tools/profile_paths.py [drive ...]``
with drives from lateral, orbit, dolly, tilt, billboard, view0, view1,
stereo, fused, uniform and hybrid (default: all eleven). Each of the
first five renders chip_smoke.py's pose batch through render_fast_batch
(billboard: render_billboard_fast_batch over the lateral drive's 96
poses) on chip_smoke.py's seeded 1280x800 scene, and uniform and hybrid
render the lateral drive with that plane_mode at chip_smoke.py's
PLANE_MODE_K march planes (main path 14); view0 and view1 render ONE frame
with render(mode='fast') at BASELINE config 0's x = 0.135 m on view 0
(one skewed layer) and view 1 (the 3-layer outpainted LDI) of
chip_smoke.py's main-path-8 LIF, loaded with load_lif_file; stereo
renders main path 9's 60 pairs (120 cameras) through
render_stereo_fast_batch on chip_smoke.py's stereo LIF; fused renders
main path 10's 4K batch (four projectors synthesized by
chip_smoke.make_fusion_projectors, resampled to 3840x2160, four cameras)
through render_fused_fast_batch. Each drive prints:

- the call's device time (CUDA events around the call, median of 5 after
  2 warm-up calls) and its host wall time;
- torch.profiler over 3 calls: each of the renderer's spans
  (lif_tpu_torch.utils.profiling; PERF.md lists them) with its device
  time per call, the span's device-side annotation (from the first kernel
  launched inside it to the end of the last), and its host time per call
  (the span's own record). Nested spans are in their parent's time: the
  kernels with their inputs ("lif.kernel.<tier>", the billboard's input
  stack "lif.inputs" inside its kernel span), each tier's work after its
  kernel ("lif.epilogue.<tier>", with the packed colour fetch "lif.fetch"
  and the rotated tier's corner fetch "lif.corner" and bracket march
  "lif.bracket" inside), the stereo stretch confidence and fill/blend
  ("lif.stereo.conf", "lif.stereo.blend"), the fusion merge
  ("lif.merge"), the renderer's compositing ("lif.composite"), the
  pose-independent source prep on a cache miss (the skew pre-shift and
  the march source stack, "lif.prep") and the planning ("lif.plan");
- from the same profile: the kernels' device time per call, the device's
  idle share (1 - kernel time / call time) and the kernels that take the
  most device time.

Needs torch with CUDA, nvcc and numpy; imports neither jax nor lif_tpu.
"""

from __future__ import annotations

import os
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVES = ("lateral", "orbit", "dolly", "tilt", "billboard", "view0",
          "view1", "stereo", "fused", "uniform", "hybrid")
# the drives on the lateral poses through render_fast_batch(method='march')
LATERAL = ("lateral", "uniform", "hybrid")


def _events():
    import torch

    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def span_rows(prof, calls: int):
    """(span name, device ms per call, host ms per call) of every
    renderer span the profiler saw, largest device time first: the device
    time sums the span's device-side annotations, the host time its
    records (utils.profiling.snapshot)."""
    from torch.autograd import DeviceType

    from lif_tpu_torch.utils import profiling

    dev = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA and e.is_user_annotation()
                and e.name().startswith("lif.")):
            dev[e.name()] = dev.get(e.name(), 0.0) + e.duration_ns() * 1e-6
    host = profiling.snapshot()["spans"]
    rows = [(name, dev.get(name, 0.0) / calls, s["total_ms"] / calls)
            for name, s in host.items()]
    return sorted(rows, key=lambda r: -r[1])


def drive_cameras(cs, lt, focal, drive):
    if drive in LATERAL or drive == "billboard":
        return [lt.Camera.create(cs.W, cs.H, focal_px=focal, position=[
            0.135 + 0.02 * i / cs.N_MAIN, 0.0, 0.0]) for i in range(cs.N_MAIN)]
    if drive == "orbit":
        return cs.orbit_cams(lt, focal, thetas=list(np.deg2rad(
            np.linspace(-cs.ORBIT_DEG, cs.ORBIT_DEG, cs.N_ORBIT))))
    if drive == "dolly":
        return cs.dolly_cams(lt, focal)
    return cs.orbit_cams(
        lt, focal,
        thetas=list(np.deg2rad(np.linspace(-cs.TILT_DEG, cs.TILT_DEG,
                                           cs.N_TILT))),
        phis=[np.deg2rad(cs.TILT_PHI)] * cs.N_TILT)


def kernel_rows(prof, calls: int):
    """(name, device ms per call) of every CUDA kernel the profiler saw,
    largest first (the renderer's spans annotate the device too: they are
    left out)."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("lif."):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3 / calls))
    return sorted(rows, key=lambda r: -r[1])


def drive_call(lt, drive):
    """The entry point a drive calls, as fn(proj, cams)."""
    if drive == "billboard":
        return lt.render_billboard_fast_batch
    if drive == "stereo":
        return lambda pair, cams: lt.render_stereo_fast_batch(*pair, cams)
    if drive == "fused":
        return lt.render_fused_fast_batch
    if drive.startswith("view"):
        return lambda proj, cams: lt.render(proj, cams[0], mode="fast")
    kw = {"method": "march"} if drive in LATERAL else {}
    if drive in ("uniform", "hybrid"):
        import chip_smoke as cs

        kw["config"] = lt.DEFAULT_CONFIG.replace(
            plane_mode=drive, march_planes=cs.PLANE_MODE_K)
    return lambda proj, cams, **extra: lt.render_fast_batch(proj, cams,
                                                            **kw, **extra)


def profile_drive(lt, proj, cams, drive, card):
    import torch

    from lif_tpu_torch.utils import profiling

    render = drive_call(lt, drive)
    if drive == "billboard":
        tiers = ("billboard",)
    elif drive == "stereo":
        tiers = lt.render_stereo_fast_batch(*proj, cams,
                                            return_tiers=True)[1]
    elif drive.startswith("view"):
        tiers = ("march",) * proj.num_layers  # the lateral route
    elif drive == "fused":
        tiers = ("march",) * sum(p.num_layers for p in proj)
    else:
        _, tiers = render(proj, cams, return_tiers=True)
    render(proj, cams)
    torch.cuda.synchronize()
    calls, walls = [], []
    for _ in range(5):
        start, end = _events()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        render(proj, cams)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        calls.append(start.elapsed_time(end))
    call_ms = statistics.median(calls)
    print(f"\n== {drive}: {len(cams)} poses, tiers {tiers}; "
          f"{call_ms:.3f} ms per call (CUDA events, median of 5) = "
          f"{len(cams) / (call_ms / 1e3):.1f} frames/s; host wall "
          f"{statistics.median(walls):.3f} ms [{card}]", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    profiling.reset()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            render(proj, cams)
        torch.cuda.synchronize()
    print("  spans (device ms per call, its share of the call; host ms per "
          "call):")
    for name, dev_ms, host_ms in span_rows(prof, 3):
        print(f"    {name}: {dev_ms:.3f} ms ({100 * dev_ms / call_ms:.1f}%); "
              f"host {host_ms:.3f} ms")
    rows = kernel_rows(prof, 3)
    busy = sum(ms for _, ms in rows)
    print(f"  torch.profiler over 3 calls: kernels {busy:.3f} ms per call, "
          f"device idle {100 * max(0.0, 1.0 - busy / call_ms):.1f}% of the "
          f"call")
    for name, ms in rows[:8]:
        print(f"    {ms:8.3f} ms {100 * ms / busy:5.1f}%  {name[:90]}")


def main(argv) -> int:
    drives = argv or list(DRIVES)
    bad = [d for d in drives if d not in DRIVES]
    if bad:
        print(f"unknown drive(s) {bad}; choose from {DRIVES}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("profile_paths: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import lif_tpu_torch as lt
    from lif_tpu_torch.ops.cuda import build

    card = cs.card_line()
    print(card, flush=True)
    sources = ("sweep_march", "sweep_target", "sweep_scaled", "splat_march")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.load_library, sources))
    rgb, disp = cs.make_scene(0)
    proj = lt.projector_from_arrays(
        rgb, disp, focal_px=0.78 * cs.W, invz_min=cs.INVZ_NEAR,
        invz_max=cs.INVZ_FAR, baseline=cs.BASELINE,
        device=torch.device("cuda", 0),
    )
    focal = float(proj.focal[0])
    views = center = pair = None
    if any(d.startswith("view") for d in drives):
        loaded = lt.load_lif_file(cs.make_lif(0))
        views, center = loaded.projectors, loaded.orbit_center
    if "stereo" in drives:
        pair = lt.load_lif_file(cs.make_stereo_lif(0)).projectors[:2]
    if "fused" in drives:
        projs4 = [lt.resample_projector(p.to(proj.device), cs.FUSED_SCALE,
                                        out_w=cs.W4, out_h=cs.H4)
                  for p in cs.make_fusion_projectors(0)]
        focal4 = float(projs4[0].focal[0])
        cams4 = [lt.Camera.create(cs.W4, cs.H4, focal_px=focal4, position=[
            cs.FUSED_CAM_X + cs.FUSED_CAM_DX * j, 0.0, 0.0])
            for j in range(cs.N_FUSED)]
    for drive in drives:
        if drive.startswith("view"):
            view = views[int(drive[4:])]
            cams = [cs.lif_cams(lt, view, center)["lateral"]]
            profile_drive(lt, view, cams, drive, card)
        elif drive == "stereo":
            cams = cs.stereo_cams(lt, float(pair[0].focal[0]),
                                  float(pair[0].baseline) / 2.0)["pairs"]
            profile_drive(lt, pair, cams, drive, card)
        elif drive == "fused":
            profile_drive(lt, projs4, cams4, drive, card)
        else:
            profile_drive(lt, proj, drive_cameras(cs, lt, focal, drive),
                          drive, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
