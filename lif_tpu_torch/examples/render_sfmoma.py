"""End-to-end example: the SFMoMA demo scene -> novel views on the card.

The port of lif_tpu's examples/render_sfmoma.py (reference: index.html:
110-170 scene constants; assets rgb.jpg + depth.png at 1280x800). Authors
the scene as a LIF container in memory, loads it through the public API,
renders an identity view, a translated novel view, an orbit view and an
extreme far view, saves PNGs (the port's own encoder), and self-checks:

  1. identity pose reproduces the input JPEG (center crop PSNR > 45 dB)
  2. novel view shows parallax (finite, covered, differs from identity)
  3. extreme pose (100 m away) yields zero coverage and no NaNs
  4. in raycast mode, the production fast path agrees with the exact
     march at the novel pose (> 30 dB)

The assets are read from ASSETS_DIR (--assets DIR), the repository's
assets/ by default; decoding the JPEG needs PIL (the port's PNG decoder
needs none). Timings are CUDA events (utils.profiling.device_timer) on the
card, the host clock with --device cpu.

Usage:
  python3 -m lif_tpu_torch.examples.render_sfmoma --out DIR
      [--mode fast|raycast] [--frames N] [--device cuda|cpu] [--assets DIR]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ASSETS_DIR = Path(__file__).resolve().parents[2] / "assets"


def sfmoma_assets(small: bool = False, scale: int = 1,
                  assets_dir=ASSETS_DIR):
    """The SFMoMA demo assets, rgb.jpg and depth.png in `assets_dir`
    (reference: public/assets, scene constants index.html:142-168).
    Returns (jpeg_bytes, depth_png_bytes, w, h); `scale` downsamples by
    that integer factor (small=True is scale 4, for quick CPU runs) through
    PIL, as lif_tpu's does."""
    from ..io.decode import _pil_image, image_dimensions

    jpeg = (Path(assets_dir) / "rgb.jpg").read_bytes()
    depth = (Path(assets_dir) / "depth.png").read_bytes()
    w, h = image_dimensions(jpeg)
    if small:
        scale = 4
    if scale != 1:
        Image = _pil_image("resizing the SFMoMA assets")
        out = []
        for data, fmt, kw in ((jpeg, "JPEG", {"quality": 95}),
                              (depth, "PNG", {})):
            buf = io.BytesIO()
            with Image.open(io.BytesIO(data)) as im:
                im.resize((w // scale, h // scale)).save(buf, fmt, **kw)
            out.append(buf.getvalue())
        jpeg, depth = out
        w, h = w // scale, h // scale
    return jpeg, depth, w, h


def build_sfmoma_lif(position=(0, 0, 0), small: bool = False,
                     scale: int = 1, assets_dir=ASSETS_DIR) -> bytes:
    """Author the SFMoMA scene as an in-memory LIF container, with
    lif_tpu's scene constants (reference: index.html:142-168)."""
    from ..io import container

    jpeg, depth, w, h = sfmoma_assets(small, scale, assets_dir=assets_dir)
    meta = {
        "views": [{
            "image": {"blob_id": -1},
            "inv_z_map": {"blob_id": 20, "min": 0.09, "max": 0.0001},
            "width_px": w, "height_px": h, "focal_px": 0.78 * w,
            "position": list(position), "rotation": [0, 0, 0],
        }],
        "baseline_mm": 45.0,
        "stereo_render_data": {"invd": 0.045},
    }
    return container.write(jpeg, meta, {20: depth})


def _host(img) -> np.ndarray:
    """A render (a tensor on any device, or an array) as a numpy array."""
    return img.detach().cpu().numpy() if hasattr(img, "detach") else (
        np.asarray(img))


def save_png(img, path):
    """Write a GL-oriented render's colour as a top-down 8-bit PNG (the
    port's encoder)."""
    from ..io.decode import encode_png

    with open(path, "wb") as f:
        f.write(encode_png(_host(img)[..., :3]))


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def timed(fn, device):
    """fn()'s result and its seconds: CUDA events on the card
    (device_timer, one timed call after the one that gives the result),
    the host clock on the CPU."""
    if device.type == "cuda":
        from ..utils.profiling import device_timer

        out = fn()
        return out, device_timer(fn, warmup=0, iters=1) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="render_sfmoma_out")
    ap.add_argument("--mode", default="raycast", choices=["fast", "raycast"])
    ap.add_argument("--frames", type=int, default=0,
                    help="also render an N-frame orbit trajectory")
    ap.add_argument("--device", default="cuda",
                    help="the textures' device (cuda: the card)")
    ap.add_argument("--assets", default=str(ASSETS_DIR),
                    help="directory holding rgb.jpg and depth.png")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    import torch

    from .. import Camera, load_lif_file, render
    from ..io.decode import decode_rgb

    device = torch.device(args.device)
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu")
    jpeg = sfmoma_assets(assets_dir=args.assets)[0]
    result = load_lif_file(build_sfmoma_lif(assets_dir=args.assets),
                           device=device)
    proj = result.projectors[0]
    w = int(proj.layer_res[0, 0])
    h = int(proj.layer_res[0, 1])
    focal = float(proj.focal[0])
    baseline = float(proj.baseline)
    kwargs = {} if args.mode == "fast" else {"mask_mode": "none"}

    def cam(pos, rot=None):
        return Camera.create(w, h, focal_px=focal, position=pos, rotation=rot)

    report = {"mode": args.mode}

    # 1. identity passthrough
    t0 = time.time()
    img_id = _host(render(proj, cam([0.0, 0.0, 0.0]), mode=args.mode,
                          **kwargs))
    print(f"identity render (incl kernel build): {time.time() - t0:.1f}s")
    save_png(img_id, os.path.join(args.out, "identity.png"))
    ref = decode_rgb(jpeg, linear=False)
    crop = (slice(160, -160), slice(160, -160))
    p = psnr(img_id[crop][..., :3], ref[crop])
    report["identity_psnr_dB"] = round(p, 2)
    assert p > 45.0, f"identity passthrough only {p:.1f} dB"

    # 2. novel view: 3 baselines right
    nv, dt = timed(lambda: render(proj, cam([3 * baseline, 0.0, 0.0]),
                                  mode=args.mode, **kwargs), device)
    nv = _host(nv)
    save_png(nv, os.path.join(args.out, "novel_right.png"))
    assert np.all(np.isfinite(nv)), "novel view has non-finite values"
    cov = float(np.mean(nv[..., 3]))
    shift = float(np.mean(np.abs(nv[..., :3] - img_id[..., :3])))
    report["novel_coverage"] = round(cov, 3)
    report["novel_mean_abs_diff"] = round(shift, 4)
    report["novel_render_s"] = round(dt, 3)
    assert 0.5 < cov <= 1.0, f"novel-view alpha coverage {cov}"
    assert shift > 0.01, f"no parallax: mean abs diff {shift}"

    # 3. extreme pose: 100 m away -> nothing visible, no NaNs
    far = _host(render(proj, cam([100.0, 0.0, 0.0]), mode=args.mode,
                       **kwargs))
    assert np.all(np.isfinite(far)), "extreme pose has non-finite values"
    report["far_coverage"] = round(float(np.mean(far[..., 3])), 4)
    assert float(np.mean(far[..., 3])) < 0.01, "extreme pose should be empty"

    # 4. the production fast path agrees with the exact march at the novel
    # pose (the fast path's fidelity gate, end to end through the public
    # API)
    if args.mode == "raycast":
        img_fast = _host(render(proj, cam([3 * baseline, 0.0, 0.0]),
                                mode="fast"))
        save_png(img_fast, os.path.join(args.out, "novel_right_fast.png"))
        pf = psnr(img_fast[crop][..., :3], nv[crop][..., :3])
        report["fast_vs_march_psnr_dB"] = round(pf, 2)
        assert pf > 30.0, (
            f"fast path only {pf:.1f} dB vs the march at the novel pose "
            "(the march's own discretization noise floor is ~34 dB; "
            "below 30 means a real regression)"
        )

    # optional orbit
    if args.frames:
        from .. import orbit_pose

        frames_dir = os.path.join(args.out, "frames")
        os.makedirs(frames_dir, exist_ok=True)
        for i, t in enumerate(np.linspace(-10, 10, args.frames)):
            pos, rot = orbit_pose(result.orbit_center, 1.0,
                                  theta=np.deg2rad(t))
            img = render(proj, cam(pos, rot), mode=args.mode, **kwargs)
            save_png(img, os.path.join(frames_dir, f"orbit_{i:03d}.png"))
        report["orbit_frames"] = args.frames

    print(json.dumps(report))
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
