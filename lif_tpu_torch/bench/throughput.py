"""The headline bench on one CUDA card: novel-view frames/s of
render_fast_batch, the mixed-family composite and their fidelity.

Run from the repository root: ``python3 bench_torch.py [--preset
full|smoke|tiny] [--seed N] [--device cuda|cpu]``. Workload (the port of
bench.py), on the seeded synthetic scene of lif_tpu_torch.bench.scenes
(SFMoMA's constants; the scene is named in the metric):

- headline: render_fast_batch(proj, cams, method='march') over `batch`
  lateral poses x = 0.135 + 0.02 i / batch m (full: 432 at 1280x800, nine
  pose chunks of 48, one lateral-kernel launch each, checked exactly);
  host clock around each call and a torch.sum of its frames, ending in
  torch.cuda.synchronize(), median of `reps` after a warm-up, with the
  CUDA-event time and torch.cuda.max_memory_allocated() beside it;
- composite: three families of `third` poses, lateral (as the headline),
  orbit (orbit_pose([0, 0, -1], 1, theta), theta in linspace(-15, 15)
  deg) and zoom (z = 0.1 + 0.1 i / third m), each one render_fast_batch
  call with method='auto'; frames/s of the three calls, median of 3, each
  family's tiers, launches and rate beside it;
- fidelity: pose 0 of the headline and of each family against the
  converged (conv_steps) render_mono_view, with the 40-step march beside
  the headline's.

Bars (exit 1 on a miss, and no headline line): at the full preset the
headline's pose 0 at PSNR_MIN dB or more; every PSNR at most 1 dB under
lif_tpu's on the same scene and pose and each family routed as lif_tpu
routes it (LIF_TPU, from tools/reference_bench_psnr.py); the headline's
launches one per pose chunk. The last line of a run is one JSON object
with 'metric', 'value', 'unit' and 'device'; with --device cpu its
timings sit under 'cpu_smoke' and 'value' is null.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import common
from .scenes import lateral_cams, orbit_cams, scene_projector

PSNR_MIN = 40.0  # dB: the headline's pose 0 at the full preset
ORBIT_DEG = 15.0  # the composite orbit's half-angle
COMP_REPS = 3  # timed passes of the composite
# lif_tpu on the same seeded scene and poses: pose 0 of each drive against
# its own converged march (dB), the 40-step march's PSNR, and each
# composite family's routed tiers; JAX on the CPU
# (JAX_PLATFORMS=cpu python3 tools/reference_bench_psnr.py --preset P)
LIF_TPU = {
    "full": {
        "headline": 40.331, "headline_march40": 31.613,
        "lateral": 40.331, "orbit": 37.208, "zoom": 48.114,
        "lateral_tiers": ("march",), "orbit_tiers": ("target",),
        "zoom_tiers": ("scaled",),
    },
    "smoke": {
        "headline": 40.827, "headline_march40": 37.842,
        "lateral": 40.827, "orbit": 41.061, "zoom": 55.177,
        "lateral_tiers": ("march",), "orbit_tiers": ("target",),
        "zoom_tiers": ("scaled",),
    },
}


def headline_cams(lt, focal, sizes):
    return lateral_cams(lt, focal, sizes.batch, w=sizes.w, h=sizes.h)


def composite_cams(lt, focal, sizes):
    """{family: cameras} of the composite (bench.py:181-197; the orbit
    about scenes.ORBIT_CENTER)."""
    n, w, h = sizes.third, sizes.w, sizes.h
    return {
        "lateral": lateral_cams(lt, focal, n, w=w, h=h),
        "orbit": orbit_cams(lt, focal, thetas=list(np.deg2rad(
            np.linspace(-ORBIT_DEG, ORBIT_DEG, n))), w=w, h=h),
        "zoom": [lt.Camera.create(w, h, focal_px=focal,
                                  position=[0.0, 0.0, 0.1 + 0.1 * i / n])
                 for i in range(n)],
    }


def run(sizes: common.BenchSizes, device: str = "cuda", seed: int = 0,
        observe=common.unobserved):
    """The headline, the composite and their fidelity. Returns (lines,
    misses): the JSON lines to print (the composite's, then the
    headline's) and every missed bar or count. observe(step) wraps each
    counted call: 'headline', then 'composite <family>'."""
    import lif_tpu_torch as lt
    from lif_tpu_torch.models import renderer

    dev = common.resolve_device(device)
    cuda = dev.type == "cuda"
    card = common.card_line(dev)
    proj = scene_projector(lt, seed, sizes.w, sizes.h, device=dev)
    focal = float(proj.focal[0])
    misses = []
    refs = LIF_TPU.get(sizes.name)

    # headline: the first call counts the launches and keeps pose 0
    cams = headline_cams(lt, focal, sizes)
    chunks = len(renderer._pose_chunks(len(cams),
                                       lt.DEFAULT_CONFIG.pose_chunk))
    with observe("headline"):
        out, launches = common.counted(dev, lt.render_fast_batch, proj,
                                       cams, method="march")
    frame0 = out[0].clone()
    del out
    if cuda and launches != {"lateral_march": chunks}:
        misses.append(f"headline launches {launches}, expected "
                      f"{chunks} lateral (one per pose chunk)")

    def headline_step():
        torch.sum(lt.render_fast_batch(proj, cams, method="march"))

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    host_s, event_ms = [], []
    for _ in range(sizes.reps):
        if cuda:
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
        host_s += common.seconds(headline_step, dev, 1)
        if cuda:
            ev1.record()
            torch.cuda.synchronize()
            event_ms.append(ev0.elapsed_time(ev1))
    fps = len(cams) / common.median(host_s)
    timings = {"frames_per_s": fps, "s_per_call": common.median(host_s),
               "passes_s": host_s}
    if cuda:
        timings.update(event_ms_per_call=common.median(event_ms),
                       max_memory_allocated_gib=(
                           torch.cuda.max_memory_allocated() / 2**30))

    # composite: one counted call a family (the warm-up), then COMP_REPS
    # timed passes of the three calls
    fams = composite_cams(lt, focal, sizes)
    fam = {}
    for name, fcams in fams.items():
        with observe(f"composite {name}"):
            (out, tiers), fam_launches = common.counted(
                dev, lt.render_fast_batch, proj, fcams, method="auto",
                return_tiers=True)
        fam[name] = {"tiers": common.tiers_tuple(tiers),
                     "launches": fam_launches,
                     "frame0": out[0].clone()}
        del out
    fam_s = {name: [] for name in fams}
    pass_s = []
    for _ in range(COMP_REPS if sizes.reps > 1 else 1):
        total = 0.0
        for name, fcams in fams.items():
            (t,) = common.seconds(lambda c=fcams: torch.sum(
                lt.render_fast_batch(proj, c, method="auto")), dev, 1)
            fam_s[name].append(t)
            total += t
        pass_s.append(total)
    n_comp = sum(len(c) for c in fams.values())
    comp_fps = common.median([n_comp / t for t in pass_s])

    # fidelity: pose 0 of each drive against the converged march
    def exact(cam, steps):
        return lt.render_mono_view(proj, cam, mask_mode="none",
                                   num_steps=steps)

    conv0 = exact(cams[0], sizes.conv_steps)
    q = {"headline": common.psnr(frame0, conv0),
         "headline_march40": common.psnr(exact(cams[0], 40), conv0)}
    for name, rec in fam.items():
        cam0 = fams[name][0]
        same = np.array_equal(cam0.position, cams[0].position) and (
            np.array_equal(cam0.rotation, cams[0].rotation))
        conv = conv0 if same else exact(cam0, sizes.conv_steps)
        q[name] = common.psnr(rec.pop("frame0"), conv)
        rec["psnr_pose0_dB"] = q[name]
    if sizes is common.FULL and q["headline"] < PSNR_MIN:
        misses.append(f"headline pose 0: {q['headline']:.3f} dB < "
                      f"{PSNR_MIN} dB")
    got = dict(q, **{f"{n}_tiers": r["tiers"] for n, r in fam.items()})
    misses += common.bar_misses("throughput", got, refs)

    scene = (f"seeded synthetic {sizes.w}x{sizes.h} scene (SFMoMA constants, "
             f"seed {seed})")
    comp_desc = (f"{n_comp} frames as 1/3 lateral + 1/3 orbit (+-{ORBIT_DEG:g}"
                 f" deg) + 1/3 zoom (z 0.1..0.2 m), each family one "
                 f"render_fast_batch(method='auto') call, host clock ending "
                 f"in torch.cuda.synchronize(), median of {len(pass_s)} "
                 f"passes, on the {scene}")
    fam_rates = {name: len(fams[name]) / common.median(ts)
                 for name, ts in fam_s.items()}
    comp_line = {"composite_metric": f"mixed-pose-family frames/s @"
                 f"{sizes.w}x{sizes.h}: {comp_desc}",
                 "value": comp_fps if cuda else None, "unit": "frames/s",
                 "families": fam, "device": card}
    if cuda:
        for name, r in fam.items():
            r["frames_per_s"] = fam_rates[name]
    else:
        comp_line["cpu_smoke"] = {"frames_per_s": comp_fps,
                                  "family_frames_per_s": fam_rates}
    rate = (f"; mixed-family composite 1/3 lateral + 1/3 orbit + 1/3 zoom: "
            f"{comp_fps:.1f} frames/s" if cuda else "")
    metric = (
        f"novel-view frames/s @{sizes.w}x{sizes.h} on the {scene}: "
        f"render_fast_batch(method='march') over {len(cams)} lateral poses "
        f"({chunks} pose chunks), host clock around each call ending in "
        f"torch.cuda.synchronize(), median of {sizes.reps} after a warm-up; "
        f"measured this run: {q['headline']:.2f} dB against the "
        f"{sizes.conv_steps}-step march at pose 0, where the 40-step march "
        f"measures {q['headline_march40']:.2f} dB{rate}")
    head_line = {"metric": metric, "value": fps if cuda else None,
                 "unit": "frames/s", "device": card,
                 "launches": launches, "psnr_dB": q}
    if cuda:
        head_line["timings"] = timings
    else:
        head_line["cpu_smoke"] = timings
    return [comp_line, head_line], misses


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=sorted(common.PRESETS),
                    default="full")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: measurements) or cpu (tests)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    lines, misses = run(common.PRESETS[args.preset], args.device, args.seed)
    common.dump_line(lines[0])
    if misses:
        return common.fail("bench_torch: FAILED: " + "; ".join(misses))
    common.dump_line(lines[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
