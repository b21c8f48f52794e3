#!/usr/bin/env python3
"""lif_tpu's fidelity on the uniform and hybrid march grids, for the values
chip_smoke.py hard-codes in LIF_TPU_PLANE_MODE_PSNR.

Run from the repository root with JAX on the CPU:
``JAX_PLATFORMS=cpu python3 tools/reference_plane_mode_psnr.py``. It builds
chip_smoke.py's seeded 1280x800 scene in lif_tpu, renders main path 1's 96
lateral poses through lif_tpu.render_fast_batch(method='march') with
plane_mode 'uniform' and then 'hybrid' at PLANE_MODE_K march planes
(planned over the whole batch, as main path 14 renders them), and prints
the PSNR (dB) of each checked pose (PLANE_MODE_POSES) against lif_tpu's
own 640-step exact march, with the tiers. This is a reference-side tool:
it imports jax and lif_tpu, and the port does not import it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import lif_tpu

    rgb, disp = cs.make_scene(0)
    proj = lif_tpu.projector_from_arrays(
        rgb, disp, focal_px=0.78 * cs.W, invz_min=cs.INVZ_NEAR,
        invz_max=cs.INVZ_FAR, baseline=cs.BASELINE,
    )
    focal = float(np.asarray(proj.focal)[0])
    cams = [lif_tpu.Camera.create(cs.W, cs.H, focal_px=focal, position=[
        0.135 + 0.02 * i / cs.N_MAIN, 0.0, 0.0]) for i in range(cs.N_MAIN)]
    exact = {pose: np.asarray(lif_tpu.render_mono_view(
        proj, cams[pose], mask_mode="none", num_steps=640))
        for pose in cs.PLANE_MODE_POSES}
    for mode in cs.PLANE_MODES:
        cfg = lif_tpu.DEFAULT_CONFIG.replace(plane_mode=mode,
                                             march_planes=cs.PLANE_MODE_K)
        out, tiers = lif_tpu.render_fast_batch(
            proj, cams, method="march", config=cfg, return_tiers=True)
        out = np.asarray(out)
        for pose in cs.PLANE_MODE_POSES:
            print(f"{mode}, K = {cs.PLANE_MODE_K}, tiers {tuple(tiers)}, "
                  f"pose {pose}: {cs.psnr(out[pose], exact[pose]):.3f} dB "
                  f"against the 640-step march", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
