#!/usr/bin/env python3
"""Where the time goes on one CUDA card, for chip_smoke.py's main paths 11
(the plane-sweep tier) and 12 (scene fitting).

Run from the repository root: ``python3 tools/profile_sweep.py [drive ...]``
with drives from sweep, exact_color, sweep_view, sweep_rotated and fit
(default: all five). The first four are chip_smoke.sweep_drives on
chip_smoke.py's seeded 1280x800 scene: render_fast_batch over main path
1's first 16 poses with method='sweep' (soft and exact_color),
render_fast_view of the zoomed camera (its layer falls back to the
sweep) and render_fast_batch of the 4 rotated poses no march tier
covers. Each prints:

- the call's device time (CUDA events around the call, median of 5 after
  2 warm-up calls) and its host wall time;
- stage times: CUDA events around each stage's function, median over the
  same 5 calls (the plane tables, the colour products with their
  matrices, the disparity products with theirs, the streamed composite,
  the first-crossing solve, the rotated sweep's phase B, the renderer's
  compositing epilogue); the rest of the call is planning and glue;
- torch.profiler over 3 calls: the kernels' device time per call, the
  device's idle share (1 - kernel time / call time) and the kernels that
  take the most device time.

fit is main path 12's train step (chip_smoke.make_fit_problem,
fit_projector's model and Adam) by stage (forward, backward, Adam step)
over 5 steps after 2 warm-up steps, with torch.profiler over 3 steps and
the peak device memory of a step. Needs torch with CUDA and numpy;
imports neither jax nor lif_tpu, and builds no kernel (none runs here).
"""

from __future__ import annotations

import os
import statistics
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVES = ("sweep", "exact_color", "sweep_view", "sweep_rotated", "fit")
# the drives by their chip_smoke.sweep_drives names
SWEEP_DRIVES = {"sweep": "sweep", "exact_color": "exact_color",
                "sweep_view": "view", "sweep_rotated": "rotated"}


def instrument(stages: dict):
    """Wrap each stage's function so that CUDA events bracket it; the event
    pairs collect in `stages`. No stage calls another."""
    import types

    from profile_paths import _events

    from lif_tpu_torch.models import renderer
    from lif_tpu_torch.ops import composite, sweep_fast

    def timed(label, fn):
        def wrap(*args, **kwargs):
            start, end = _events()
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            stages.setdefault(label, []).append((start, end))
            return out
        return wrap

    for owner, name, label in (
        (renderer, "_sweep_tables", "plane tables (cache lookup)"),
        (sweep_fast, "_color_planes",
         "colour products (bf16 row, float32 column, their matrices)"),
        (sweep_fast, "_disp_planes",
         "disparity products (float32, their matrices)"),
        (sweep_fast, "_axis_visibility", "visibility"),
        (sweep_fast._SoftComposite, "chunk", "streamed composite"),
        (sweep_fast._FirstCrossing, "step", "first-crossing solve"),
        (sweep_fast, "_rotated_phase_b", "rotated phase B (two fetches)"),
    ):
        setattr(owner, name, timed(label, getattr(owner, name)))
    # the renderer's own compositing epilogue
    renderer._composite = types.SimpleNamespace(
        **{name: getattr(composite, name) for name in composite.__all__})
    for name in ("over", "finish_over_background"):
        setattr(renderer._composite, name,
                timed("renderer epilogue (over, finish_over_background)",
                      getattr(composite, name)))


def profile_sweep(lt, proj, cams, kw, drive, card, stages):
    import torch

    from profile_paths import _events, kernel_rows

    def render():
        if drive == "sweep_view":
            return lt.render_fast_view(proj, cams[0], **kw)
        return lt.render_fast_batch(proj, cams, **kw)

    render()
    torch.cuda.synchronize()
    stages.clear()
    calls, walls = [], []
    for _ in range(5):
        start, end = _events()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        render()
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        calls.append(start.elapsed_time(end))
    call_ms = statistics.median(calls)
    print(f"\n== {drive}: {len(cams)} poses {kw}, tier 'sweep'; "
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
    print(f"  the rest (planning, the exact colour fetch, glue): "
          f"{call_ms - staged:.3f} ms per call")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            render()
        torch.cuda.synchronize()
    rows = kernel_rows(prof, 3)
    busy = sum(ms for _, ms in rows)
    print(f"  torch.profiler over 3 calls: kernels {busy:.3f} ms per call, "
          f"device idle {100 * max(0.0, 1.0 - busy / call_ms):.1f}% of the "
          f"call, {sum(1 for _ in rows)} kernel names")
    for name, ms in rows[:8]:
        print(f"    {ms:8.3f} ms {100 * ms / busy:5.1f}%  {name[:90]}")


def profile_fit(cs, lt, card):
    """Main path 12's train step by stage: CUDA events around the forward
    (render_with_params and the loss), the backward and Adam's step, each
    the median of 5 steps after 2 warm-up steps; torch.profiler over 3
    steps; the peak device memory of a step."""
    import torch

    from profile_paths import _events, kernel_rows

    from lif_tpu_torch.train import fit, losses

    dev = torch.device("cuda", 0)
    rgb, truth, start, positions, rotations = cs.make_fit_problem(0)
    kw = dict(focal_px=0.78 * cs.W, invz_min=cs.FIT_INVZ[0],
              invz_max=cs.FIT_INVZ[1], baseline=1.0, device=dev)
    true_proj = lt.projector_from_arrays(rgb, truth, **kw)
    bad = lt.projector_from_arrays(rgb, start, **kw)
    cam = lt.Camera.create(cs.W, cs.H, focal_px=0.78 * cs.W)
    rel_p, rel_r = (torch.as_tensor(a, device=dev) for a in
                    fit.relative_poses(bad, positions, rotations))
    zero = torch.zeros(3, device=dev)
    with torch.no_grad():
        targets = fit.render_with_params(
            fit.FitParams(true_proj.disp, zero, zero),
            fit.static_projector(true_proj, cam), rel_p, rel_r, cs.W, cs.H,
            1, cs.FIT_PLANES)
    model = fit.SceneFit(fit.FitParams(bad.disp, zero, zero),
                         fit.static_projector(bad, cam), cs.W, cs.H, 1,
                         cs.FIT_PLANES)
    opt = torch.optim.Adam(model.parameters(), lr=cs.FIT_LR)

    def step(times=None):
        marks = [_events()[0] for _ in range(4)]
        marks[0].record()
        opt.zero_grad(set_to_none=True)
        loss = losses.l2_loss(model(rel_p, rel_r), targets)
        marks[1].record()
        loss.backward()
        marks[2].record()
        opt.step()
        marks[3].record()
        if times is not None:
            times.append(marks)
        return float(loss.detach())

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        step(times)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    parts = [statistics.median(m[i].elapsed_time(m[i + 1]) for m in times)
             for i in range(3)]
    total = statistics.median(m[0].elapsed_time(m[3]) for m in times)
    print(f"\n== fit: {cs.FIT_POSES} poses at {cs.W}x{cs.H}, "
          f"{cs.FIT_PLANES} planes; {total:.3f} ms per step (CUDA events, "
          f"median of 5) = {1e3 / total:.2f} steps/s; peak device memory "
          f"{peak / 2**30:.2f} GiB [{card}]", flush=True)
    for label, ms in zip(("forward (render_with_params, loss)", "backward",
                          "Adam step"), parts):
        print(f"  {label}: {ms:.3f} ms per step ({100 * ms / total:.1f}%)")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    rows = kernel_rows(prof, 3)
    busy = sum(ms for _, ms in rows)
    print(f"  torch.profiler over 3 steps: kernels {busy:.3f} ms per step, "
          f"device idle {100 * max(0.0, 1.0 - busy / total):.1f}% of the "
          f"step")
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
        print("profile_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import chip_smoke as cs
    import lif_tpu_torch as lt

    card = cs.card_line()
    print(card, flush=True)
    rgb, disp = cs.make_scene(0)
    proj = lt.projector_from_arrays(
        rgb, disp, focal_px=0.78 * cs.W, invz_min=cs.INVZ_NEAR,
        invz_max=cs.INVZ_FAR, baseline=cs.BASELINE,
        device=torch.device("cuda", 0),
    )
    drive_args = cs.sweep_drives(lt, float(proj.focal[0]))
    stages: dict = {}
    instrument(stages)
    warnings.simplefilter("ignore", lt.models.renderer.TierFallbackWarning)
    for drive in drives:
        if drive == "fit":
            profile_fit(cs, lt, card)
        else:
            cams, kw = drive_args[SWEEP_DRIVES[drive]]
            profile_sweep(lt, proj, cams, kw, drive, card, stages)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
