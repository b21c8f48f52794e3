"""Multi-view LIF demo: view switching, stereo toggle, runtime modes.

The port of lif_tpu's examples/multiview_demo.py, the offline analog of
the reference demo's multi-view UI (reference: index.html:1558-1816 —
file input, all views added to the scene, a view-selector switching the
active view, camera teleport to the view pose, auto-orbit when the LIF
carries `invd`; :534-739 runtime toggles L mesh<->raycast and M
mono<->stereo).

Authors a 2-view stereo LIF in memory (the SFMoMA scene of render_sfmoma
at -baseline/2 and the right eye synthesized by the renderer at
+baseline/2, the standard stereo capture layout), then:

  1. renders every view at its own pose ("view switching"),
  2. renders the stereo blend at a middle pose ("M" toggle analog),
  3. renders mesh / billboard / raycast / fast modes at one pose
     ("L" toggle analog),
  4. renders a short orbit about the LIF's convergence center
     (auto-orbit analog, orbit center from stereo_render_data.invd —
     reference LifLoader.ts:589-666).

The SFMoMA JPEG and the right eye's JPEG need PIL (decoding and encoding);
the PNGs are the port's own.

Usage:
  python3 -m lif_tpu_torch.examples.multiview_demo --out DIR [--small]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np

from .render_sfmoma import _host, save_png


def build_stereo_lif(small=False, scale=1, device="cuda") -> bytes:
    """Author a 2-view stereo LIF. The right-eye view is SYNTHESIZED from
    the left with the renderer (novel view + solved depth at +baseline) on
    `device`: duplicating one image at two positions would describe two
    DIFFERENT scenes — each view's rgb/depth is valid only at ITS pose —
    and the stereo blend would ghost by a full eye separation. A real
    stereo LIF carries per-eye imagery; this builds one."""
    from .. import Camera, load_lif_file, render_depth_fast, render_fast_view
    from ..io import container
    from ..io.decode import _pil_image, encode_png
    from . import render_sfmoma

    jpeg, depth, w, h = render_sfmoma.sfmoma_assets(small, scale)

    # load the LEFT view alone, synthesize the RIGHT eye from it
    mono = {
        "views": [{
            "image": {"blob_id": -1},
            "inv_z_map": {"blob_id": 20, "min": 0.09, "max": 0.0001},
            "width_px": w, "height_px": h, "focal_px": 0.78 * w,
            "position": [-0.5, 0, 0], "rotation": [0, 0, 0],
        }],
        "baseline_mm": 45.0,
    }
    left = load_lif_file(container.write(jpeg, mono, {20: depth}),
                         device=device)
    proj = left.projectors[0]
    focal = float(proj.focal[0])
    baseline = float(proj.baseline)
    cam_r = Camera.create(w, h, focal_px=focal,
                          position=[baseline / 2, 0.0, 0.0])
    # feathering=0, like models/api.synthesize_projector: the border
    # taper is a display effect; baking it into the authored right-eye
    # texture would darken its edge band and ghost the stereo borders
    rgb_r = _host(render_fast_view(proj, cam_r, to_srgb=True,
                                   mask_mode="none", feathering=0.0))[..., :3]
    invz_r = _host(render_depth_fast(proj, cam_r))
    # encode: sRGB JPEG (top-down) + 8-bit normalized invz PNG
    buf = io.BytesIO()
    _pil_image("encoding the right eye's JPEG").fromarray(
        (np.clip(rgb_r[::-1], 0, 1) * 255).astype(np.uint8)
    ).save(buf, "JPEG", quality=95)
    jpeg_r = buf.getvalue()
    depth_r = encode_png(np.clip((invz_r - 0.0001) / (0.09 - 0.0001),
                                 0.0, 1.0))

    view = {
        "width_px": w, "height_px": h, "focal_px": 0.78 * w,
        "rotation": [0, 0, 0],
    }
    # LIF positions are baseline-normalized (LifLoader.ts:169-189):
    # views at -+0.5 land at -+baseline/2 meters
    meta = {
        "views": [
            dict(view, position=[-0.5, 0, 0],
                 image={"blob_id": -1},
                 inv_z_map={"blob_id": 20, "min": 0.09, "max": 0.0001}),
            dict(view, position=[0.5, 0, 0],
                 image={"blob_id": 30},
                 inv_z_map={"blob_id": 31, "min": 0.09, "max": 0.0001}),
        ],
        "baseline_mm": 45.0,
        "stereo_render_data": {"invd": 0.045},
    }
    return container.write(jpeg, meta, {20: depth, 30: jpeg_r, 31: depth_r})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="multiview_out")
    ap.add_argument("--small", action="store_true",
                    help="quarter-res for quick CPU runs")
    ap.add_argument("--device", default="cuda",
                    help="the textures' device (cuda: the card)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    from .. import Camera, load_lif_file, render
    from ..apps.viewer import orbit_trajectory, render_trajectory

    result = load_lif_file(build_stereo_lif(args.small, device=args.device),
                           device=args.device)
    projs = result.projectors
    print(f"loaded {len(projs)} views; orbit center = {result.orbit_center}")
    w, h = projs[0].width, projs[0].height
    focal = float(projs[0].focal[0])

    # 1. view switching: render each view at its own pose (the demo's
    # view-selector teleports the camera to the view pose)
    for i, p in enumerate(projs):
        cam = Camera.create(w, h, focal_px=focal,
                            position=np.asarray(p.position))
        img = render(p, cam, mode="fast")
        save_png(img, os.path.join(args.out, f"view_{i}.png"))
        print(f"view {i}: rendered at its own pose")

    # 2. stereo blend at the rig center (the 'M' mono<->stereo toggle)
    cam_mid = Camera.create(w, h, focal_px=focal, position=[0.0, 0.0, 0.0])
    img = render(projs, cam_mid, mode="stereo_fast")
    save_png(img, os.path.join(args.out, "stereo_blend.png"))
    print("stereo blend: rendered")

    # 3. render-mode toggles at one pose (the 'L' toggle)
    cam_t = Camera.create(w, h, focal_px=focal, position=[0.01, 0.0, 0.0])
    for mode in ("fast", "raycast", "mesh", "billboard"):
        img = render(projs[0], cam_t, mode=mode)
        save_png(img, os.path.join(args.out, f"mode_{mode}.png"))
        print(f"mode {mode}: rendered")

    # 4. auto-orbit about the convergence center (invd present)
    if result.orbit_center is not None:
        center = np.asarray(result.orbit_center)
        radius = max(float(np.linalg.norm(center)), 1e-3)
        pos, rot = orbit_trajectory(center, radius, frames=8,
                                    sweep_degrees=10.0)
        frames = render_trajectory(
            projs[0], pos, rot,
            Camera.create(w, h, focal_px=focal),
            mode="fast",
            out_dir=os.path.join(args.out, "orbit"),
        )
        print(f"orbit: {len(frames)} frames")
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
