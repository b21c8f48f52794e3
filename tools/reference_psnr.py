#!/usr/bin/env python3
"""lif_tpu's fidelity on chip_smoke.py's scene, for the values it hard-codes.

Run from the repository root with JAX on the CPU:
``JAX_PLATFORMS=cpu python3 tools/reference_psnr.py``. It builds
chip_smoke.py's seeded 1280x800 scene in lif_tpu and prints the PSNR (dB)
of lif_tpu's billboard and mesh render modes against lif_tpu's own
640-step exact march at lateral pose 0 (x = 0.135 m) and at orbit pose 0
(theta = -15 deg), the figures chip_smoke.py's LIF_TPU_BILLBOARD_PSNR and
LIF_TPU_MESH_PSNR hold, with each render's alpha coverage (held by
LIF_TPU_COVERAGE) and its PSNR over the pixels it covers; and the
billboard's coverage at the last lateral pose of main path 6 (x = 0.135 +
0.02 * 95 / 96 m). The billboard value comes from the eager
forward_splat (its jitted evaluation is not the oracle: see
tests/test_splat_march.py); the mesh value from render_connected_mesh.
This is a reference-side tool: it imports jax and lif_tpu, and the port
does not import it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def billboard_eager(jnp, proj, cam):
    """lif_tpu's render(mode='billboard') through the EAGER forward_splat:
    render_mesh_view's argument plumbing, then forward_splat.__wrapped__."""
    from lif_tpu.core.pose import relative_view_pose
    from lif_tpu.ops.splat import forward_splat

    pos, rot = relative_view_pose(
        np.asarray(proj.position, np.float64),
        np.asarray(proj.rotation, np.float64),
        np.asarray(cam.position, np.float64),
        np.asarray(cam.rotation, np.float64),
    )
    pos = pos * np.array([1.0, 1.0, -1.0])
    intr = proj.intrinsics
    cy_gl = proj.height - intr["cy"]
    f32 = jnp.float32
    return forward_splat.__wrapped__(
        jnp.asarray(proj.rgb[0]), jnp.asarray(proj.disp[0]),
        jnp.asarray(proj.invz_min[0], f32), jnp.asarray(proj.invz_max[0], f32),
        jnp.asarray(proj.baseline, f32), jnp.asarray(intr["fx"], f32),
        jnp.asarray(intr["fy"], f32), jnp.asarray(intr["cx"], f32),
        jnp.asarray(cy_gl, f32), jnp.asarray(rot, f32),
        jnp.asarray(pos, f32), jnp.asarray(cam.focal_px, f32),
        out_w=cam.width, out_h=cam.height,
        background=jnp.zeros(4, f32),
    )


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import lif_tpu
    from lif_tpu.ops.mesh import render_mesh_connected_view

    rgb, disp = cs.make_scene(0)
    proj = lif_tpu.projector_from_arrays(
        rgb, disp, focal_px=0.78 * cs.W, invz_min=cs.INVZ_NEAR,
        invz_max=cs.INVZ_FAR, baseline=cs.BASELINE,
    )
    focal = float(np.asarray(proj.focal)[0])
    pos, rot = lif_tpu.orbit_pose([0.0, 0.0, -1.0], 1.0,
                                  float(np.deg2rad(-cs.ORBIT_DEG)))
    cams = {
        "lateral": lif_tpu.Camera.create(cs.W, cs.H, focal_px=focal,
                                         position=[0.135, 0.0, 0.0]),
        "orbit": lif_tpu.Camera.create(cs.W, cs.H, focal_px=focal,
                                       position=pos, rotation=rot),
    }
    for name, cam in cams.items():
        exact = np.asarray(lif_tpu.render_mono_view(
            proj, cam, mask_mode="none", num_steps=640))
        bb = np.asarray(billboard_eager(jnp, proj, cam))
        mesh = np.asarray(render_mesh_connected_view(proj, cam))
        for mode, img in (("billboard", bb), ("mesh", mesh)):
            cov = img[..., 3] > 0.5
            print(f"{name} pose 0, {mode}: {cs.psnr(img, exact):.3f} dB, "
                  f"coverage {img[..., 3].mean():.4f}, "
                  f"{cs.psnr(img[cov], exact[cov]):.3f} dB over the covered "
                  f"pixels", flush=True)
    x_last = 0.135 + 0.02 * (cs.N_MAIN - 1) / cs.N_MAIN
    last = np.asarray(billboard_eager(jnp, proj, lif_tpu.Camera.create(
        cs.W, cs.H, focal_px=focal, position=[x_last, 0.0, 0.0])))
    print(f"lateral pose {cs.N_MAIN - 1} (x = {x_last:.6f}), billboard: "
          f"coverage {last[..., 3].mean():.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
