#!/usr/bin/env python3
"""lif_tpu's fidelity and routes on the benches' inputs, for the values
the port's runners hold (lif_tpu_torch/bench/throughput.py and
configs.py: LIF_TPU).

Run from the repository root with JAX on the CPU:
``JAX_PLATFORMS=cpu python3 tools/reference_bench_psnr.py [--preset
full|smoke] [--sections NAME ...]``. It builds each section's inputs as
the runners build them (lif_tpu_torch.bench.scenes, seed 0: the scene,
the stereo LIF and the fused projectors, the last two synthesized by the
port on the CPU), carries them into lif_tpu (projector_from_arrays,
load_lif_file) and prints, per section, lif_tpu's PSNR (dB) of the
benched render against its own converged march (or the section's
oracle) and the tiers it routes, then the dict the runners paste:

- throughput: pose 0 of the headline (render_fast_batch of that pose,
  method='march', as bench.py:236-238) and its 40-step march; pose 0 of
  each composite family (the whole family through render_fast_batch,
  method='auto') with the family's tiers;
- config0: render_fast_view(method='march') at x = 0.135 m and the
  40-step march; config0b: render(mode='mesh') and the billboard through
  the EAGER forward_splat (tools/reference_psnr.py: the jitted one is no
  oracle), which is also config 0b+'s value (the port's billboard kernel
  is exact against it); config1 / config1b: the orbit batch (the default
  and RenderConfig(target_step_px=2, target_refine=1)) at poses 0, n/4,
  n/2 with its tiers; config2: the stereo pairs' per-eye tiers (read from
  the statics of lif_tpu's stereo core) and the mid and yaw poses against
  render_stereo_view; config3: the 3-layer LDI at its pose 0; config4:
  render_fused_fast_batch at x = 0.05 m against render_fused_projectors
  over a 4-device virtual CPU mesh, at the default fuse_tol and 0.1.

The full preset takes tens of minutes and several GB on 8 CPU cores (run
its sections in turn); the smoke preset a few minutes. The tests call
reference() at the tiny preset. This is a reference-side tool: it imports
jax and lif_tpu, and the port does not import it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = ("throughput", "config0", "config0b", "config1", "config1b",
            "config2", "config3", "config4")


def _psnr(a, b) -> float:
    from lif_tpu_torch.bench.common import psnr

    return round(psnr(np.asarray(a), np.asarray(b)), 3)


def _tiers(t):
    return tuple(_tiers(x) for x in t) if isinstance(t, (list, tuple)) else t


def reference(sizes, seed=0, sections=SECTIONS, log=print) -> dict:
    """lif_tpu's values on the runners' inputs at `sizes`: {section: {key:
    dB or tiers}}, keyed as the runners' LIF_TPU tables."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import lif_tpu
    from lif_tpu.models import renderer as jr
    from lif_tpu.parallel import sharding
    from lif_tpu_torch.bench import configs, scenes, throughput

    import jax

    s = sizes
    proj = scenes.scene_projector(lif_tpu, seed, s.w, s.h)
    focal = float(np.asarray(proj.focal)[0])
    out = {}

    def conv(p, cam, **kw):
        return np.asarray(lif_tpu.render(p, cam, mode="raycast",
                                         num_steps=s.conv_steps, **kw))

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        log(f"{name}: {res} ({time.perf_counter() - t0:.1f} s)")
        out.update(res)

    def fixed_cam(rot=None):
        return lif_tpu.Camera.create(s.w, s.h, focal_px=focal, position=[
            configs.FIXED_X, 0.0, 0.0], rotation=rot)

    def sec_throughput():
        cam0 = throughput.headline_cams(lif_tpu, focal, s)[0]
        fast = np.asarray(lif_tpu.render_fast_batch(proj, [cam0],
                                                     method="march"))[0]
        ref = conv(proj, cam0, mask_mode="none")
        r = {"headline": _psnr(fast, ref), "headline_march40": _psnr(
            np.asarray(lif_tpu.render_mono_view(proj, cam0, mask_mode="none",
                                                num_steps=40)), ref)}
        for name, cams in throughput.composite_cams(lif_tpu, focal,
                                                    s).items():
            imgs, tiers = lif_tpu.render_fast_batch(proj, cams, method="auto",
                                                    return_tiers=True)
            r[name] = _psnr(np.asarray(imgs[0]),
                            conv(proj, cams[0], mask_mode="none"))
            r[f"{name}_tiers"] = _tiers(tiers)
            del imgs
        return {"throughput": r}

    def sec_config0():
        cam = fixed_cam()
        ref = conv(proj, cam, mask_mode="none")
        fast = np.asarray(lif_tpu.render_fast_view(proj, cam, method="march"))
        m40 = np.asarray(lif_tpu.render(proj, cam, mode="raycast",
                                        mask_mode="none", num_steps=40))
        return {"config0": {"psnr": _psnr(fast, ref),
                            "march40_psnr": _psnr(m40, ref)}}

    def sec_config0b():
        import jax.numpy as jnp
        from reference_psnr import billboard_eager

        cam = fixed_cam()
        ref = conv(proj, cam, mask_mode="none")
        mesh = np.asarray(lif_tpu.render(proj, cam, mode="mesh"))
        bb = _psnr(np.asarray(billboard_eager(jnp, proj, cam)), ref)
        return {"config0b_mesh": {"psnr": _psnr(mesh, ref)},
                "config0b_billboard": {"psnr": bb},
                "config0b_billboard_kernel": {"psnr": bb}}

    def orbit(name, **kw):
        cams = configs.orbit_batch(lif_tpu, focal, s)
        imgs, tiers = lif_tpu.render_fast_batch(proj, cams, return_tiers=True,
                                                **kw)
        r = {f"psnr_{i}": _psnr(np.asarray(imgs[i]),
                                conv(proj, cams[i], mask_mode="none"))
             for i in configs.orbit_checked(s)}
        if not kw:
            r["tiers"] = _tiers(tiers)
        return {name: r}

    def sec_config2():
        data = scenes.make_stereo_lif(seed, s.w, s.h)
        left, right = lif_tpu.load_lif_file(data).projectors[:2]
        f2 = float(np.asarray(left.focal)[0])
        pairs = scenes.pair_cams(lif_tpu, f2, float(left.baseline) / 2.0,
                                 s.n_pairs, w=s.w, h=s.h)
        seen = {}
        real = jr._stereo_fast_core_jit

        def spy(**statics):
            seen["tiers"] = (tuple(statics["modes_l"]),
                             tuple(statics["modes_r"]))
            return real(**statics)

        jr._stereo_fast_core_jit = spy
        try:
            lif_tpu.render_stereo_fast_batch(left, right, pairs)
        finally:
            jr._stereo_fast_core_jit = real
        r = {"tiers": seen["tiers"]}
        for name, cam in configs.stereo_checked_cams(lif_tpu, f2, s).items():
            fast = np.asarray(lif_tpu.render_stereo_fast_batch(
                left, right, [cam]))[0]
            exact = np.asarray(lif_tpu.render_stereo_view(
                left, right, cam, num_steps=s.conv_steps))
            r[f"psnr_{name}"] = _psnr(fast, exact)
        return {"config2_stereo": r}

    def sec_config3():
        rgb0, disp0, f3, layers = configs.ldi_arrays(seed, s)
        proj3 = lif_tpu.projector_from_arrays(
            rgb0, disp0, focal_px=f3, invz_min=scenes.INVZ_NEAR,
            invz_max=scenes.INVZ_FAR, baseline=scenes.BASELINE,
            extra_layers=layers)
        cam0 = configs.ldi_cams(lif_tpu, f3, s)[0]
        fast = np.asarray(lif_tpu.render_fast_batch(proj3, [cam0]))[0]
        return {"config3_ldi": {"psnr": _psnr(fast, conv(proj3, cam0))}}

    def sec_config4():
        synths = scenes.make_fusion_projectors(seed, s.w, s.h)
        projs = [lif_tpu.projector_from_arrays(
            p.rgb[0].numpy(), p.disp[0].numpy(), focal_px=float(p.focal[0]),
            invz_min=float(p.invz_min[0]), invz_max=float(p.invz_max[0]),
            baseline=float(p.baseline), position=np.asarray(p.position))
            for p in synths]
        cam = configs.fused_cam(lif_tpu, float(projs[0].focal[0]), s)
        mesh = sharding.make_mesh(("view",), shape=(len(projs),),
                                  devices=jax.devices()[:len(projs)])
        r = {}
        for name, tol in (("default", None), ("0.1", configs.FUSE_TOL_WIDE)):
            cfg = lif_tpu.DEFAULT_CONFIG.replace(
                fuse_tol=lif_tpu.DEFAULT_CONFIG.fuse_tol if tol is None
                else tol)
            fast = np.asarray(lif_tpu.render_fused_fast_batch(
                projs, [cam], config=cfg))[0]
            exact = np.asarray(sharding.render_fused_projectors(
                projs, cam, mesh, num_steps=s.conv_steps,
                fuse_tol=cfg.fuse_tol))
            r[f"psnr_{name}"] = _psnr(fast, exact)
        return {"scaling": r}

    run = {"throughput": sec_throughput, "config0": sec_config0,
           "config0b": sec_config0b,
           "config1": lambda: orbit("config1_orbit"),
           "config1b": lambda: orbit(
               "config1b_orbit_step2_refine1",
               config=lif_tpu.RenderConfig(target_step_px=2.0,
                                           target_refine=1)),
           "config2": sec_config2, "config3": sec_config3,
           "config4": sec_config4}
    for name in sections:
        timed(name, run[name])
    return out


def main() -> int:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from lif_tpu_torch.bench import common

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=("full", "smoke"), default="full")
    ap.add_argument("--sections", nargs="+", choices=SECTIONS,
                    default=list(SECTIONS))
    args = ap.parse_args()
    res = reference(common.PRESETS[args.preset], 0, args.sections,
                    log=lambda m: print(m, flush=True))
    print(f"{args.preset!r}: {res!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
