#!/usr/bin/env python3
"""lif_tpu's fidelity on chip_smoke.py's LIF, for the values it hard-codes.

Run from the repository root with JAX on the CPU:
``JAX_PLATFORMS=cpu python3 tools/reference_lif_psnr.py``. It authors
chip_smoke.py's main-path-8 LIF (chip_smoke.make_lif, seed 0), loads it
with lif_tpu.load_lif_file (PIL decode) and prints, for each render of
that phase, lif_tpu's render_fast_view (the route render(mode='fast')
takes) against lif_tpu's own 640-step render_mono_view at the same pose,
both with their default mask mode, in dB: the figures chip_smoke.py's
LIF_TPU_LIF_PSNR holds. For each render it also prints the tiers
lif_tpu's render_fast_batch picks at that pose (render_fast_view routes
a y-only pose onto the lateral march through a transpose instead) and
the loaded orbit_center. This is a reference-side tool: it imports jax
and lif_tpu, and the port does not import it.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import lif_tpu
    from lif_tpu.models.renderer import render_fast_batch, render_fast_view

    t0 = time.perf_counter()
    result = lif_tpu.load_lif_file(cs.make_lif(0))
    print(f"authored and loaded in {time.perf_counter() - t0:.1f} s; "
          f"orbit_center {result.orbit_center.tolist()}", flush=True)
    for (view, pose) in cs.LIF_RENDERS:
        proj = result.projectors[view]
        cam = cs.lif_cams(lif_tpu, proj, result.orbit_center)[pose]
        t0 = time.perf_counter()
        img = np.asarray(render_fast_view(proj, cam))
        exact = np.asarray(lif_tpu.render_mono_view(proj, cam, num_steps=640))
        _, tiers = render_fast_batch(proj, [cam], return_tiers=True)
        print(f"view {view} {pose}: {cs.psnr(img, exact):.3f} dB, tiers "
              f"{tuple(tiers)} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
