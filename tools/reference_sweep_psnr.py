#!/usr/bin/env python3
"""lif_tpu's plane-sweep fidelity on chip_smoke.py's scene, for the values
it hard-codes.

Run from the repository root with JAX on the CPU:
``JAX_PLATFORMS=cpu python3 tools/reference_sweep_psnr.py``. It builds
chip_smoke.py's seeded 1280x800 scene in lif_tpu and, for each drive of
main path 11 (chip_smoke.sweep_drives), prints lif_tpu's tiers, its
TierFallbackWarnings and the PSNR (dB) of its frame at pose 0 against its
own 640-step exact march (the figures chip_smoke.py's
LIF_TPU_SWEEP_PSNR and SWEEP_WARNINGS hold), with the frame's alpha
coverage. The method='sweep' drives render pose 0 alone (with
method='sweep' every layer sweeps whatever the batch, and a sweep frame
does not depend on its batch); the rotated drive renders its whole batch,
whose routing it decides. A few minutes on 8 CPU cores. This is a
reference-side tool: it imports jax and lif_tpu, and the port does not
import it.
"""

from __future__ import annotations

import os
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import lif_tpu
    from lif_tpu.models.renderer import TierFallbackWarning, render_fast_view

    rgb, disp = cs.make_scene(0)
    proj = lif_tpu.projector_from_arrays(
        rgb, disp, focal_px=0.78 * cs.W, invz_min=cs.INVZ_NEAR,
        invz_max=cs.INVZ_FAR, baseline=cs.BASELINE,
    )
    focal = float(np.asarray(proj.focal)[0])
    for name, (cams, kw) in cs.sweep_drives(lif_tpu, focal).items():
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            if name == "view":
                frame, tiers = np.asarray(render_fast_view(proj, cams[0])), None
            else:
                batch = cams if name == "rotated" else cams[:1]
                out, tiers = lif_tpu.render_fast_batch(proj, batch,
                                                       return_tiers=True, **kw)
                frame = np.asarray(out)[0]
        fired = [r for r in rec if issubclass(r.category, TierFallbackWarning)]
        exact = np.asarray(lif_tpu.render_mono_view(
            proj, cams[0], mask_mode="none", num_steps=640))
        print(f"{name}: tiers {tiers}, TierFallbackWarnings {len(fired)}, pose "
              f"0 {cs.psnr(frame, exact):.3f} dB against the 640-step march, "
              f"alpha coverage {frame[..., 3].mean():.4f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        for r in fired:
            print(f"  {r.message}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
