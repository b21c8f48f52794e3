#!/usr/bin/env python3
"""lif_tpu's fusion fidelity on chip_smoke.py's four projectors, for the
values it hard-codes.

Run from the repository root with JAX on the CPU:
``JAX_PLATFORMS=cpu python3 tools/reference_fused_psnr.py``. It builds
chip_smoke.py's main-path-10 projectors at 1280x800
(chip_smoke.make_fusion_projectors, seed 0: the port synthesizes them on
the CPU from make_scene(0) at x = 0.02 i m), carries their arrays into
lif_tpu with lif_tpu.projector_from_arrays, and prints, at each fuse_tol
point of that phase (the default and 0.1), lif_tpu's
render_fused_fast_batch at the camera x = FUSED_CAM_X against lif_tpu's
own FUSED_STEPS-step render_fused_projectors on a 4-device virtual CPU
mesh at the same fuse_tol, in dB (the figures chip_smoke.py's
LIF_TPU_FUSED_PSNR holds). A few minutes on 8 CPU cores. This is a
reference-side tool: it imports jax and lif_tpu, and the port does not
import it.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import lif_tpu
    from lif_tpu.parallel import sharding

    t0 = time.perf_counter()
    synths = cs.make_fusion_projectors(0)
    projs = [
        lif_tpu.projector_from_arrays(
            s.rgb[0].numpy(), s.disp[0].numpy(),
            focal_px=float(s.focal[0]), invz_min=float(s.invz_min[0]),
            invz_max=float(s.invz_max[0]), baseline=float(s.baseline),
            position=np.asarray(s.position),
        )
        for s in synths
    ]
    print(f"synthesized {len(projs)} projectors on the port's CPU path in "
          f"{time.perf_counter() - t0:.1f} s; positions "
          f"{[float(p.position[0]) for p in projs]} m", flush=True)
    cam = lif_tpu.Camera.create(cs.W, cs.H, focal_px=float(projs[0].focal[0]),
                                position=[cs.FUSED_CAM_X, 0.0, 0.0])
    mesh = sharding.make_mesh(("view",), shape=(len(projs),),
                              devices=jax.devices()[:len(projs)])
    for name, tol in cs.FUSE_TOLS.items():
        t0 = time.perf_counter()
        cfg = lif_tpu.DEFAULT_CONFIG.replace(
            fuse_tol=lif_tpu.DEFAULT_CONFIG.fuse_tol if tol is None else tol)
        fast = np.asarray(lif_tpu.render_fused_fast_batch(
            projs, [cam], config=cfg))[0]
        exact = np.asarray(sharding.render_fused_projectors(
            projs, cam, mesh, num_steps=cs.FUSED_STEPS, fuse_tol=cfg.fuse_tol))
        print(f"fuse_tol {name} ({cfg.fuse_tol:g}): {cs.psnr(fast, exact):.3f}"
              f" dB against the {cs.FUSED_STEPS}-step fused oracle, alpha "
              f"coverage {float(fast[..., 3].mean()):.4f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
