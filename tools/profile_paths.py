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
- stage times: CUDA events around each stage's function, median over the
  same 5 calls (the scaled and target marches with their kernel, the
  packed color fetch, the rotated tier's corner fetch and bracket march,
  the billboard's input stack, kernel and epilogue, the lateral march's
  skew pre-shift, source stack, kernel with its tables and _finalize,
  the stereo eyes' stretch confidence and fill/blend, the fusion merge
  across projectors, and the renderer's compositing epilogue); the rest of the call is planning and glue;
- torch.profiler over 3 calls: the kernels' device time per call, the
  device's idle share (1 - kernel time / call time) and the kernels that
  take the most device time.

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


def instrument(stages: dict):
    """Wrap each stage's function (in every module that calls it) so that
    CUDA events bracket it; the event pairs collect in `stages`."""
    import types

    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.ops import (composite, rotated_march, splat_march,
                                   stereo, sweep_march, sweep_scaled,
                                   sweep_target)
    from lif_tpu_torch.ops.cuda import sweep_march as kmarch

    def timed(label, fn):
        def wrap(*args, **kwargs):
            start, end = _events()
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            stages.setdefault(label, []).append((start, end))
            return out
        return wrap

    for mod, name, label in (
        (sweep_scaled, "_march_batch", "scaled march (kernel)"),
        (sweep_target, "_march_batch", "target march (kernel)"),
        (sweep_scaled, "bilinear_sample_packed", "packed color fetch"),
        (sweep_target, "bilinear_sample_packed", "packed color fetch"),
        (rotated_march, "bilinear_sample_packed", "packed color fetch"),
        (rotated_march, "_corner_quad", "corner fetch"),
        (rotated_march, "_bracket_march", "bracket march"),
        (splat_march, "billboard_inputs", "billboard input stack"),
        (splat_march, "billboard_march_batch", "billboard march (kernel)"),
        (splat_march, "finish_billboard", "billboard epilogue"),
        (sweep_march, "preshift_source", "skew pre-shift"),
        (renderer, "prepare_translation_src", "march source stack"),
        (kmarch, "march_translation_cuda", "lateral march (kernel, tables)"),
        (kmarch, "_finalize", "lateral _finalize"),
        (renderer, "_stretch_conf", "stereo stretch confidence"),
        (stereo, "occlusion_blend", "stereo fill/blend"),
        (renderer, "_fuse_views", "fusion merge"),
    ):
        setattr(mod, name, timed(label, getattr(mod, name)))
    # the renderer's own compositing epilogue: a copy of the composite
    # module for the renderer alone, so the tiers' epilogues (inside the
    # stages above) are not timed twice
    renderer._composite = types.SimpleNamespace(
        **{name: getattr(composite, name) for name in composite.__all__})
    for name in ("over", "finish_over_background"):
        setattr(renderer._composite, name,
                timed("renderer epilogue (over, finish_over_background)",
                      getattr(composite, name)))


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
    largest first."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
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


def profile_drive(lt, proj, cams, drive, card, stages):
    import torch

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
    stages.clear()
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
    staged = 0.0
    for label, pairs in stages.items():
        per_call = len(pairs) // 5
        ms = [sum(a.elapsed_time(b) for a, b in pairs[i:i + per_call])
              for i in range(0, len(pairs), per_call)]
        med = statistics.median(ms)
        staged += med
        print(f"  {label}: {med:.3f} ms per call "
              f"({100 * med / call_ms:.1f}%)")
    if stages:
        print(f"  the rest (planning, epilogue, glue): "
              f"{call_ms - staged:.3f} ms per call")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            render(proj, cams)
        torch.cuda.synchronize()
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
    stages: dict = {}
    instrument(stages)
    for drive in drives:
        if drive.startswith("view"):
            view = views[int(drive[4:])]
            cams = [cs.lif_cams(lt, view, center)["lateral"]]
            profile_drive(lt, view, cams, drive, card, stages)
        elif drive == "stereo":
            cams = cs.stereo_cams(lt, float(pair[0].focal[0]),
                                  float(pair[0].baseline) / 2.0)["pairs"]
            profile_drive(lt, pair, cams, drive, card, stages)
        elif drive == "fused":
            profile_drive(lt, projs4, cams4, drive, card, stages)
        else:
            profile_drive(lt, proj, drive_cameras(cs, lt, focal, drive),
                          drive, card, stages)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
