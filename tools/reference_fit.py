#!/usr/bin/env python3
"""lif_tpu's scene fit on chip_smoke.py's main-path-12 problem, for the
values it hard-codes.

Run from the repository root with JAX on the CPU:
``JAX_PLATFORMS=cpu python3 tools/reference_fit.py``. It builds
chip_smoke.make_fit_problem(0) in lif_tpu (the true and the perturbed
projector at 1280x800, four poses), renders the targets with lif_tpu's
soft sweep from the true disparity (as tests/test_train.py::_setup does)
and runs lif_tpu's fit_projector for chip_smoke.FIT_STEPS Adam steps; it
prints every loss, the first three (chip_smoke.py's LIF_TPU_FIT_LOSSES),
min(last 5) / first against chip_smoke.FIT_DROP and the mean distance of
the start and of the fitted disparity to the truth. About 5 minutes and
14 GB of host memory on 8 CPU cores (the sweep's residuals for the
backward pass). This is a reference-side tool: it imports jax and
lif_tpu, and the port does not import it.
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
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import lif_tpu
    from lif_tpu.core.pose import relative_view_pose
    from lif_tpu.ops import sweep
    from lif_tpu.train import fit

    rgb, truth, start, positions, rotations = cs.make_fit_problem(0)
    kw = dict(focal_px=0.78 * cs.W, invz_min=cs.FIT_INVZ[0],
              invz_max=cs.FIT_INVZ[1], baseline=1.0)
    true_proj = lif_tpu.projector_from_arrays(rgb, truth, **kw)
    bad = lif_tpu.projector_from_arrays(rgb, start, **kw)
    cam = lif_tpu.Camera.create(cs.W, cs.H, focal_px=0.78 * cs.W)
    rel = [relative_view_pose(true_proj.position, true_proj.rotation, p, r)
           for p, r in zip(positions, rotations)]
    rel_p = np.stack([p for p, _ in rel]).astype(np.float32)
    rel_r = np.stack([r for _, r in rel]).astype(np.float32)
    t0 = time.perf_counter()
    targets = np.asarray(sweep.render_sweep(
        jnp.asarray(true_proj.rgb), jnp.asarray(true_proj.disp),
        jnp.asarray(true_proj.mask), jnp.asarray(true_proj.layer_res),
        jnp.asarray(true_proj.invz_min), jnp.asarray(true_proj.invz_max),
        jnp.asarray(true_proj.focal), jnp.asarray(true_proj.skew),
        jnp.asarray(rel_p), jnp.asarray(rel_r), jnp.float32(0.78 * cs.W),
        jnp.zeros(2, jnp.float32), jnp.zeros(4, jnp.float32),
        out_w=cs.W, out_h=cs.H, num_layers=1, num_planes=cs.FIT_PLANES,
        to_srgb=False)[..., :3])
    print(f"targets {targets.shape} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    params, losses = fit.fit_projector(
        bad, positions, rotations, cam, targets, steps=cs.FIT_STEPS,
        learning_rate=cs.FIT_LR, num_steps=cs.FIT_PLANES)
    err0 = float(np.abs(start - truth).mean())
    err1 = float(np.abs(np.clip(np.asarray(params.disp[0]), 0, 1)
                        - truth).mean())
    print(f"fit_projector: {cs.FIT_STEPS} steps in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"losses {[float(v) for v in losses]}")
    print(f"first three {tuple(float(v) for v in losses[:3])}")
    print(f"min(last 5) / first {min(losses[-5:]) / losses[0]:.4f} (gate < "
          f"{cs.FIT_DROP}); mean |disp - truth| {err0:.5f} -> {err1:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
