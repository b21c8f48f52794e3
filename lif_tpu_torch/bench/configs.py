"""The configuration sweep on one CUDA card: every section of
bench_configs.py, written to a JSON record.

Run from the repository root: ``python3 bench_configs_torch.py [--preset
full|smoke|tiny] [--seed N] [--device cuda|cpu] [--out PATH]``. The
record (default lif_tpu_torch/_build/BENCH_DETAILS_TORCH.json, or
BENCH_DETAILS_TORCH_SMOKE.json there at the smoke preset) is rewritten
after every section; config 4's fused frames go beside it
(``<stem>_fused.npz``), where the scaling subprocess reads them.

Sections (the scene: lif_tpu_torch.bench.scenes, seeded; every PSNR
against the converged exact march of conv_steps steps, or the section's
own oracle):

- config0: the fixed novel view x = 0.135 m: render_fast_view(method=
  'march') sequentially over n_seq poses, render_fast_batch over the
  streaming batch and over `batch` poses in one call, the marginal rate
  between the two, and the 40-step exact march's time and PSNR;
- config0b_mesh, config0b_billboard: render(mode='mesh' | 'billboard'),
  first call and median of 3;
- config0b_billboard_kernel: render_billboard_fast_batch at bb_batch and
  bb_small poses, its frame against render(mode='billboard') and the
  converged march;
- config1_orbit: render_fast_batch over orbit_frames orbit poses (+-15
  deg about scenes.ORBIT_CENTER) and every third of them, the routed
  tiers, PSNR at poses 0, n/4 and n/2;
- config1b_orbit_step2_refine1: the same with RenderConfig(
  target_step_px=2, target_refine=1);
- config2_stereo: render_stereo_fast_batch over n_pairs pairs of the
  seeded stereo LIF (scenes.make_stereo_lif) and a quarter of them, the
  tiers, PSNR against render_stereo_view at x = 4 mm and at a 6-degree
  head yaw;
- config3_ldi: a 3-layer LDI built from the scene as
  bench_configs.py:491-505 builds it, n_ldi poses and a quarter;
- config4_fusion: four projectors (scenes.make_fusion_projectors)
  resampled to w4 x h4, render_fused_fast_batch at 4 cameras and 1 with
  the peak device memory; the w x h fused frames at x = 0.05 m (the
  default fuse_tol and 0.1) saved for scaling;
- scaling: lif_tpu_torch.bench.scaling as a subprocess (the tile-sharded
  view and the fused oracle's PSNR), its failure this section's;
- interactive_planning: cold and warm host ms of the target tier's
  planning (renderer._plan_march_tier) for orbit cameras no cache has
  seen.

Each section's first call of its workload is its counted step: the
launches it made and the tiers it took go into the record, and a
caller's observe(section) wraps it (run()'s `observe`).

A section that raises is recorded as {"error": ...}; a PSNR more than 1
dB under lif_tpu's on the same input (LIF_TPU, from
tools/reference_bench_psnr.py) or a route other than lif_tpu's is
recorded under "misses". Either makes the run exit 1. With --device cpu
every timing sits under a section's 'cpu_smoke' key.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from . import common
from .scenes import (
    BASELINE,
    INVZ_FAR,
    INVZ_NEAR,
    lateral_cams,
    make_fusion_projectors,
    make_scene,
    make_stereo_lif,
    orbit_cams,
    pair_cams,
    rot_y,
    scene_projector,
)

ROOT = Path(__file__).resolve().parents[2]
FIXED_X = 0.135  # m: config 0's fixed novel view
ORBIT_DEG = 15.0
STEREO_MID_X, STEREO_YAW_DEG = 0.004, 6.0  # bench_configs.py:447-461
FUSED_CAM_X, FUSED_CAM_DX = 0.05, 0.002  # m
FUSE_TOL_WIDE = 0.1  # config 4's second fuse_tol point
PLAN_THETA, PLAN_DTHETA, PLAN_WARM = 5.0, 0.03, 7  # deg, deg, poses
SCALING_TIMEOUT_S = 1800
# lif_tpu on the same seeded inputs, dB against its own converged march
# (or the section's oracle), and the tiers it routes; JAX on the CPU
# (JAX_PLATFORMS=cpu python3 tools/reference_bench_psnr.py --preset P)
LIF_TPU = {
    "full": {
        "config0": {"psnr": 40.331, "march40_psnr": 31.613},
        "config0b_mesh": {"psnr": 6.453},
        "config0b_billboard": {"psnr": 7.126},
        "config0b_billboard_kernel": {"psnr": 7.126},
        "config1_orbit": {"psnr_0": 37.208, "psnr_30": 41.786,
                          "psnr_60": 77.470, "tiers": ("target",)},
        "config1b_orbit_step2_refine1": {"psnr_0": 34.55, "psnr_30": 38.039,
                                         "psnr_60": 77.515},
        "config2_stereo": {"psnr_mid": 43.224, "psnr_yaw": 43.956,
                           "tiers": (("march",), ("march",))},
        "config3_ldi": {"psnr": 39.327},
        "scaling": {"psnr_default": 50.165, "psnr_0.1": 52.919},
    },
    "smoke": {
        "config0": {"psnr": 40.827, "march40_psnr": 37.842},
        "config0b_mesh": {"psnr": 9.355},
        "config0b_billboard": {"psnr": 7.454},
        "config0b_billboard_kernel": {"psnr": 7.454},
        "config1_orbit": {"psnr_0": 41.061, "psnr_3": 46.624,
                          "psnr_6": 60.031, "tiers": ("target",)},
        "config1b_orbit_step2_refine1": {"psnr_0": 36.921, "psnr_3": 42.382,
                                         "psnr_6": 60.033},
        "config2_stereo": {"psnr_mid": 46.375, "psnr_yaw": 49.285,
                           "tiers": (("march",), ("march",))},
        "config3_ldi": {"psnr": 39.68},
        "scaling": {"psnr_default": 48.984, "psnr_0.1": 53.208},
    },
}


class Context:
    """One run's inputs, device and shared results."""

    def __init__(self, sizes, dev, seed, out_path, observe):
        import lif_tpu_torch as lt

        self.lt = lt
        self.sizes, self.dev, self.seed = sizes, dev, seed
        self.cuda = dev.type == "cuda"
        self.out_path = Path(out_path)
        self.fused_path = self.out_path.with_name(
            self.out_path.stem + "_fused.npz")
        self.proj = scene_projector(lt, seed, sizes.w, sizes.h, device=dev)
        self.focal = float(self.proj.focal[0])
        self.refs = LIF_TPU.get(sizes.name, {})
        self.reps3 = min(3, sizes.reps)  # the shorter sections' passes
        self.misses = []
        self._conv = {}
        self._observe = observe
        self.section = None  # the running section's name (run())

    def counted(self, fn, *args, **kwargs):
        """The section's counted step: fn's result and its launches, with
        the caller's observe(section) around the call."""
        with self._observe(self.section):
            return common.counted(self.dev, fn, *args, **kwargs)

    def cam(self, pos, rot=None):
        return self.lt.Camera.create(self.sizes.w, self.sizes.h,
                                     focal_px=self.focal, position=pos,
                                     rotation=rot)

    def conv(self, cam):
        """The converged exact march at `cam` (cached by pose)."""
        key = (cam.position.tobytes(), cam.rotation.tobytes())
        if key not in self._conv:
            self._conv[key] = self.lt.render(
                self.proj, cam, mode="raycast", mask_mode="none",
                num_steps=self.sizes.conv_steps)
        return self._conv[key]

    def seconds(self, fn, reps=None):
        return common.median(common.seconds(fn, self.dev,
                                            reps or self.sizes.reps))

    def gate(self, section, got):
        """Hold `got` ({key: PSNR or tiers}) to lif_tpu's values."""
        misses = common.bar_misses(section, got, self.refs.get(section)
                                   if self.refs else None)
        self.misses += misses
        return misses


def fixed_cams(ctx):
    """config 0's poses: (the fixed view, the sequential views, the
    streaming batch, the one-call batch)."""
    s = ctx.sizes
    fixed = ctx.cam([FIXED_X, 0.0, 0.0])
    seq = [ctx.cam([FIXED_X + 0.001 * i, 0.0, 0.0]) for i in range(s.n_seq)]
    stream = [ctx.cam([FIXED_X + 0.0005 * i, 0.0, 0.0])
              for i in range(s.batch_stream)]
    big = lateral_cams(ctx.lt, ctx.focal, s.batch, x0=FIXED_X, w=s.w, h=s.h)
    return fixed, seq, stream, big


def orbit_batch(lt, focal, sizes):
    return orbit_cams(lt, focal, thetas=list(np.deg2rad(np.linspace(
        -ORBIT_DEG, ORBIT_DEG, sizes.orbit_frames))), w=sizes.w, h=sizes.h)


def orbit_checked(sizes):
    n = sizes.orbit_frames
    return (0, n // 4, n // 2)


def stereo_checked_cams(lt, focal, sizes):
    """config 2's fidelity poses: {'mid': x = 4 mm, 'yaw': there with a
    6-degree head yaw}."""
    def cam(rot=None):
        return lt.Camera.create(sizes.w, sizes.h, focal_px=focal,
                                position=[STEREO_MID_X, 0.0, 0.0],
                                rotation=rot)
    return {"mid": cam(), "yaw": cam(rot_y(STEREO_YAW_DEG))}


def ldi_arrays(seed, sizes):
    """config 3's LDI as bench_configs.py:491-505 builds it from the
    scene: (rgb0, disp0, focal, extra layers); layer 1's colour flipped
    upside down."""
    rgb0, disp0 = make_scene(seed, sizes.w, sizes.h)
    focal = 0.78 * sizes.w
    layers = []
    for i in range(2):
        m = (disp0 > (0.4 + 0.2 * i)).astype(np.float32)
        layers.append(dict(
            rgb=rgb0[::-1 if i else 1].copy(), disp=disp0, mask=m,
            focal_px=focal, invz_min=INVZ_NEAR / (i + 1), invz_max=INVZ_FAR))
    return rgb0, disp0, focal, layers


def ldi_cams(lt, focal, sizes):
    n = sizes.n_ldi
    return [lt.Camera.create(sizes.w, sizes.h, focal_px=focal, position=[
        FIXED_X + 0.02 * i / n, 0.0, 0.0]) for i in range(n)]


def fused_cam(lt, focal, sizes):
    return lt.Camera.create(sizes.w, sizes.h, focal_px=focal,
                            position=[FUSED_CAM_X, 0.0, 0.0])


# ---- sections ------------------------------------------------------------


def config0(ctx):
    lt, proj, s = ctx.lt, ctx.proj, ctx.sizes
    fixed, seq, stream, big = fixed_cams(ctx)
    img = lt.render_fast_view(proj, fixed, method="march")
    conv = ctx.conv(fixed)
    t0 = time.perf_counter()
    ref40 = lt.render(proj, fixed, mode="raycast", mask_mode="none",
                      num_steps=40)
    common.sync(ctx.dev)
    first40 = time.perf_counter() - t0
    q = {"psnr": common.psnr(img, conv),
         "march40_psnr": common.psnr(ref40, conv)}
    del img, ref40

    def seq_pass():
        for c in seq:
            torch.sum(lt.render_fast_view(proj, c, method="march"))

    seq_pass()
    t_seq = ctx.seconds(seq_pass, ctx.reps3)
    stream_reps = 4 if s.reps > 1 else 2

    def stream_pass():
        for _ in range(stream_reps):
            torch.sum(lt.render_fast_batch(proj, stream))

    stream_pass()
    t_stream = ctx.seconds(stream_pass)

    def one_call(cams):
        return lambda: torch.sum(lt.render_fast_batch(proj, cams))

    (out, tiers), launches = ctx.counted(lt.render_fast_batch, proj, big,
                                         return_tiers=True)
    del out
    q.update(tiers=common.tiers_tuple(tiers), launches=launches)
    t_small = ctx.seconds(one_call(stream))
    t_big = ctx.seconds(one_call(big))
    t40 = ctx.seconds(lambda: torch.sum(lt.render(
        proj, fixed, mode="raycast", mask_mode="none", num_steps=40)),
        ctx.reps3)
    timings = {
        "fast_view_fps_sequential": len(seq) / t_seq,
        "fast_batch_fps_streaming": stream_reps * len(stream) / t_stream,
        "fast_batch_fps_one_call": len(big) / t_big,
        "fps_marginal": common.marginal_rate(t_big, len(big), t_small,
                                             len(stream)),
        "march40_fps": 1.0 / t40,
        "march40_first_call_s": first40,
        "statistic": (f"host clock ending in a synchronize: sequential "
                      f"{len(seq)} views median of {ctx.reps3} passes; "
                      f"streaming "
                      f"{stream_reps} calls of {len(stream)} and the one-call "
                      f"batches of {len(stream)} / {len(big)} median of "
                      f"{s.reps}; the 40-step march median of "
                      f"{ctx.reps3}"),
    }
    return q, timings


def mode_section(mode):
    def section(ctx):
        lt, proj = ctx.lt, ctx.proj
        fixed = ctx.cam([FIXED_X, 0.0, 0.0])
        t0 = time.perf_counter()
        img, launches = ctx.counted(lt.render, proj, fixed, mode=mode)
        first = time.perf_counter() - t0
        q = {"psnr": common.psnr(img, ctx.conv(fixed)), "launches": launches}
        t = ctx.seconds(lambda: torch.sum(lt.render(proj, fixed, mode=mode)),
                        ctx.reps3)
        return q, {"fps": 1.0 / t, "s_per_frame": t, "first_call_s": first,
                   "statistic": f"median of {ctx.reps3} calls after the "
                                "first"}
    return section


def config0b_billboard_kernel(ctx):
    lt, proj, s = ctx.lt, ctx.proj, ctx.sizes

    def cams(n):
        return lateral_cams(lt, ctx.focal, n, w=s.w, h=s.h)

    def one_call(n):
        c = cams(n)
        return lambda: torch.sum(lt.render_billboard_fast_batch(proj, c))

    one_call(s.bb_small)()
    _, launches = ctx.counted(one_call(s.bb_batch))
    t_big = ctx.seconds(one_call(s.bb_batch))
    t_small = ctx.seconds(one_call(s.bb_small))
    fixed = ctx.cam([FIXED_X, 0.0, 0.0])
    img = lt.render_billboard_fast_batch(proj, [fixed], to_srgb=True)[0]
    mode = lt.render(proj, fixed, mode="billboard")
    # measured beside the bar: the kernel's frame against the same mode's
    # other implementation (lif_tpu's CPU path computes both with one
    # function, so it holds no value to compare with)
    q = {"psnr": common.psnr(img, ctx.conv(fixed)),
         "psnr_vs_render_billboard": common.psnr(img, mode),
         "launches": launches}
    return q, {
        "fps_batch_one_call": s.bb_batch / t_big,
        "fps_marginal": common.marginal_rate(t_big, s.bb_batch, t_small,
                                             s.bb_small),
        "statistic": f"median of {s.reps} calls of {s.bb_batch} and of "
                     f"{s.bb_small} poses"}


def orbit_section(cfg_kw):
    def section(ctx):
        lt, proj, s = ctx.lt, ctx.proj, ctx.sizes
        kw = {"config": lt.RenderConfig(**cfg_kw)} if cfg_kw else {}
        cams = orbit_batch(lt, ctx.focal, s)
        small = cams[::3]

        def one_call(c):
            return lambda: torch.sum(lt.render_fast_batch(proj, c, **kw))

        (out, tiers), launches = ctx.counted(
            lt.render_fast_batch, proj, cams, return_tiers=True, **kw)
        q = {f"psnr_{i}": common.psnr(out[i], ctx.conv(cams[i]))
             for i in orbit_checked(s)}
        del out
        q["tiers"] = common.tiers_tuple(tiers)
        one_call(small)()
        t = ctx.seconds(one_call(cams), ctx.reps3)
        t_small = ctx.seconds(one_call(small), ctx.reps3)
        return dict(q, launches=launches), {
            "batched_fps": len(cams) / t, "ms_per_frame": 1e3 * t / len(cams),
            "fps_marginal": common.marginal_rate(t, len(cams), t_small,
                                                 len(small)),
            "statistic": f"median of {ctx.reps3} calls of {len(cams)} and of "
                         f"{len(small)} poses"}
    return section


def config2_stereo(ctx):
    lt, s = ctx.lt, ctx.sizes
    left, right = lt.load_lif_file(make_stereo_lif(ctx.seed, s.w, s.h),
                                   device=ctx.dev).projectors[:2]
    focal = float(left.focal[0])
    pairs = pair_cams(lt, focal, float(left.baseline) / 2.0, s.n_pairs,
                      w=s.w, h=s.h)
    small = pairs[: 2 * max(1, s.n_pairs // 4)]
    (out, tiers), launches = ctx.counted(
        lt.render_stereo_fast_batch, left, right, pairs, return_tiers=True)
    del out

    def one_call(c):
        return lambda: torch.sum(lt.render_stereo_fast_batch(left, right, c))

    one_call(small)()
    t = ctx.seconds(one_call(pairs))
    t_small = ctx.seconds(one_call(small), ctx.reps3)
    q = {"tiers": common.tiers_tuple(tiers), "launches": launches}
    for name, cam in stereo_checked_cams(lt, focal, s).items():
        fast = lt.render_stereo_fast_batch(left, right, [cam])[0]
        exact = lt.render_stereo_view(left, right, cam,
                                      num_steps=s.conv_steps)
        q[f"psnr_{name}"] = common.psnr(fast, exact)
    return q, {
        "stereo_pairs_per_s": s.n_pairs / t,
        "ms_per_pair": 1e3 * t / s.n_pairs,
        "pairs_marginal": common.marginal_rate(t, s.n_pairs, t_small,
                                               len(small) // 2),
        "statistic": f"median of {s.reps} calls of {s.n_pairs} pairs"}


def config3_ldi(ctx):
    lt, s = ctx.lt, ctx.sizes
    rgb0, disp0, focal, layers = ldi_arrays(ctx.seed, s)
    proj3 = lt.projector_from_arrays(
        rgb0, disp0, focal_px=focal, invz_min=INVZ_NEAR, invz_max=INVZ_FAR,
        baseline=BASELINE, extra_layers=layers, device=ctx.dev)
    cams = ldi_cams(lt, focal, s)
    small = cams[: max(1, len(cams) // 4)]

    def one_call(c):
        return lambda: torch.sum(lt.render_fast_batch(proj3, c))

    (out, tiers), launches = ctx.counted(lt.render_fast_batch, proj3, cams,
                                         return_tiers=True)
    del out
    one_call(small)()
    t = ctx.seconds(one_call(cams))
    t_small = ctx.seconds(one_call(small), ctx.reps3)
    fast = lt.render_fast_batch(proj3, cams[:1])[0]
    conv = lt.render(proj3, cams[0], mode="raycast", num_steps=s.conv_steps)
    return {"layers": 3, "psnr": common.psnr(fast, conv),
            "tiers": common.tiers_tuple(tiers), "launches": launches}, {
        "fast_fps_one_call": len(cams) / t,
        "ms_per_frame": 1e3 * t / len(cams),
        "fps_marginal": common.marginal_rate(t, len(cams), t_small,
                                             len(small)),
        "statistic": f"median of {s.reps} calls of {len(cams)} poses"}


def config4_fusion(ctx):
    lt, s, dev = ctx.lt, ctx.sizes, ctx.dev
    synths = make_fusion_projectors(ctx.seed, s.w, s.h)
    projs1k = [p.to(dev) for p in synths]
    projs4 = [lt.resample_projector(p, s.w4 / s.w, out_w=s.w4, out_h=s.h4,
                                    device=dev) for p in projs1k]
    focal4 = float(projs4[0].focal[0])
    cams4 = [lt.Camera.create(s.w4, s.h4, focal_px=focal4, position=[
        FUSED_CAM_X + FUSED_CAM_DX * j, 0.0, 0.0]) for j in range(4)]

    def one_call(c):
        return lambda: torch.sum(lt.render_fused_fast_batch(projs4, c))

    _, launches = ctx.counted(one_call(cams4))
    one_call(cams4[:1])()
    if ctx.cuda:
        torch.cuda.reset_peak_memory_stats()
    t = ctx.seconds(one_call(cams4), ctx.reps3)
    peak = torch.cuda.max_memory_allocated() / 2**30 if ctx.cuda else None
    t_one = ctx.seconds(one_call(cams4[:1]), ctx.reps3)
    del projs4
    # the w x h frames the oracle (scaling) is held to, and the arrays of
    # the projectors it fuses
    cam1k = fused_cam(lt, float(projs1k[0].focal[0]), s)
    fast = {}
    for name, tol in (("default", None), ("0.1", FUSE_TOL_WIDE)):
        kw = {} if tol is None else {
            "config": lt.DEFAULT_CONFIG.replace(fuse_tol=tol)}
        fast[name] = lt.render_fused_fast_batch(projs1k, [cam1k], **kw)[0]
    np.savez(
        ctx.fused_path,
        fast_default=fast["default"].cpu().numpy(),
        fast_tol=fast["0.1"].cpu().numpy(),
        rgb=np.stack([p.rgb[0].numpy() for p in synths]),
        disp=np.stack([p.disp[0].numpy() for p in synths]),
        positions=np.stack([np.asarray(p.position) for p in synths]),
        focal=float(synths[0].focal[0]), izmin=float(synths[0].invz_min[0]),
        izmax=float(synths[0].invz_max[0]),
        baseline=float(synths[0].baseline))
    timings = {
        "fused_frames_per_s": len(cams4) / t,
        "fps_marginal": common.marginal_rate(t, len(cams4), t_one, 1),
        "statistic": f"median of {ctx.reps3} calls at 4 cameras and at 1"}
    if peak is not None:
        timings["max_memory_allocated_gib"] = peak
    return {"projectors": len(synths), "resolution": f"{s.w4}x{s.h4}",
            "launches": launches, "fused_frames": str(ctx.fused_path.name),
            "psnr_note": "the oracle's PSNR is the scaling section's"}, timings


def scaling(ctx):
    if not ctx.fused_path.exists():
        raise RuntimeError(f"{ctx.fused_path} is missing: config4_fusion "
                           "did not run")
    cmd = [sys.executable, "-m", "lif_tpu_torch.bench.scaling", "--preset",
           ctx.sizes.name, "--seed", str(ctx.seed), "--device",
           ctx.dev.type, "--fused", str(ctx.fused_path.resolve())]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=SCALING_TIMEOUT_S)
    sys.stderr.write(res.stderr[-4000:])
    if res.returncode != 0:
        raise RuntimeError(f"the scaling subprocess exited "
                           f"{res.returncode}: {res.stderr.strip()[-1500:]}")
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    fid = {k: v for k, v in rec.items() if k != "cpu_smoke"}
    if not all(fid["tile_parity"].values()):
        ctx.misses.append(f"scaling: tile parity {fid['tile_parity']}")
    return fid, rec.get("cpu_smoke", {})


def interactive_planning(ctx):
    lt, proj, s = ctx.lt, ctx.proj, ctx.sizes
    from lif_tpu_torch.core.pose import relative_view_pose
    from lif_tpu_torch.models import renderer

    lay = renderer._prepared_textures(proj)[0]
    renderer._TARGET_PLAN_CACHE.clear()
    renderer._TARGET_NEIGHBORHOOD_CACHE.clear()

    def plan_ms(theta):
        cam = orbit_cams(lt, ctx.focal, thetas=[np.deg2rad(theta)],
                         w=s.w, h=s.h)[0]
        p, r = relative_view_pose(proj.position, proj.rotation, cam.position,
                                  cam.rotation)
        t0 = time.perf_counter()
        mode, _, _ = renderer._plan_march_tier(
            lay, ctx.focal, s.w, s.w, s.h, p[None], r[None], True,
            lt.DEFAULT_CONFIG, None, ctx.dev)
        common.sync(ctx.dev)
        dt = (time.perf_counter() - t0) * 1e3
        if mode != "target":
            raise RuntimeError(f"theta {theta}: planned {mode!r}, not "
                               "'target'")
        return dt

    cold = plan_ms(PLAN_THETA)
    warm = [plan_ms(PLAN_THETA + PLAN_DTHETA * (i + 1))
            for i in range(PLAN_WARM)]
    return {"tier": "target"}, {
        "cold_new_neighborhood_ms": cold,
        "warm_novel_pose_ms_median": common.median(warm),
        "warm_novel_pose_ms_max": float(np.max(warm)),
        "note": "host ms of the target tier's planning for orbit cameras "
                "no plan cache has seen: cold is the first pose after the "
                "caches are cleared, warm novel poses inside its "
                "neighborhood"}


SECTIONS = {
    "config0": config0,
    "config0b_mesh": mode_section("mesh"),
    "config0b_billboard": mode_section("billboard"),
    "config0b_billboard_kernel": config0b_billboard_kernel,
    "config1_orbit": orbit_section({}),
    "config1b_orbit_step2_refine1": orbit_section(
        {"target_step_px": 2.0, "target_refine": 1}),
    "config2_stereo": config2_stereo,
    "config3_ldi": config3_ldi,
    "config4_fusion": config4_fusion,
    "scaling": scaling,
    "interactive_planning": interactive_planning,
}


def default_out(sizes) -> Path:
    """The record's default path, in the build directory git ignores."""
    return ROOT / "lif_tpu_torch" / "_build" / (
        "BENCH_DETAILS_TORCH_SMOKE.json" if sizes.name == "smoke"
        else "BENCH_DETAILS_TORCH.json")


def run(sizes, device="cuda", seed=0, out=None, observe=common.unobserved):
    """Run every section of SECTIONS in order, rewriting the record at
    `out` after each. Returns the record; its 'misses' and each section's
    'error' say what failed. observe(section) wraps each section's
    counted step (Context.counted)."""
    dev = common.resolve_device(device)
    out = Path(out or default_out(sizes))
    out.parent.mkdir(parents=True, exist_ok=True)
    ctx = Context(sizes, dev, seed, out, observe)
    results = {"preset": sizes.name, "seed": seed,
               "scene": f"seeded synthetic {sizes.w}x{sizes.h} scene "
                        f"(SFMoMA constants, seed {seed})",
               "_provenance": common.provenance(dev, ROOT)}
    for name, section in SECTIONS.items():
        t0 = time.perf_counter()
        ctx.section = name
        try:
            fid, timings = section(ctx)
            rec = common.split_record(dev, fid, timings)
            missed = ctx.gate(name, fid)
            if missed:
                rec["misses"] = missed
            if name in ctx.refs:
                rec["lif_tpu"] = ctx.refs[name]
        except Exception as e:  # recorded; the run then exits non-zero
            traceback.print_exc()
            rec = {"error": repr(e)[:1500]}
        rec["section_s"] = time.perf_counter() - t0
        results[name] = rec
        print(f"{name}: {json.dumps(rec)}", flush=True)
        results["misses"] = ctx.misses
        out.write_text(json.dumps(results, indent=2, default=list))
    return results


def failures(results) -> list:
    return results["misses"] + [
        f"{name}: {rec['error']}" for name, rec in results.items()
        if isinstance(rec, dict) and "error" in rec]


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=sorted(common.PRESETS),
                    default="full")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: measurements) or cpu (tests)")
    ap.add_argument("--out", help="the JSON record (default "
                    "lif_tpu_torch/_build/BENCH_DETAILS_TORCH.json, _SMOKE "
                    "at the smoke preset)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    results = run(common.PRESETS[args.preset], args.device, args.seed,
                  args.out)
    bad = failures(results)
    if bad:
        return common.fail("bench_configs_torch: FAILED: " + "; ".join(bad))
    print(json.dumps({"ok": True, "out": str(args.out or default_out(
        common.PRESETS[args.preset])), "device": results["_provenance"][
            "card"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
