"""Offline viewer: render orbit/linear camera trajectories to image files.

The counterpart of lif_tpu.apps.viewer, the framework's replacement for
the browser demo's interactive camera (reference: index.html:391-449
free-fly, :1203-1313 orbit controls, :1558-1816 LIF load flow):
trajectories are generated analytically and rendered in batches on the
card. Frames are written as PNG through io.decode.encode_png (no PIL).

CLI:
    python -m lif_tpu_torch.apps.viewer scene.lif --mode orbit --frames 24 \
        --out ./frames --render fast
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core.camera import Camera
from ..core.pose import look_at_rotation, orbit_pose
from ..io.decode import encode_png, to_display
from ..models.api import load_lif_file
from ..models.renderer import render, render_fast_batch

__all__ = ["orbit_trajectory", "linear_trajectory", "render_trajectory", "main"]


def orbit_trajectory(center, radius, frames, sweep_degrees=30.0, phi=0.0):
    """Orbit poses around `center` (the demo's double-click orbit mode).
    Returns (positions (F,3), rotations (F,3,3))."""
    thetas = np.deg2rad(
        np.linspace(-sweep_degrees / 2, sweep_degrees / 2, frames)
    )
    poses = [orbit_pose(center, radius, t, phi) for t in thetas]
    return (
        np.stack([p for p, _ in poses]),
        np.stack([r for _, r in poses]),
    )


def linear_trajectory(start, end, frames, target=None):
    """Linear dolly from `start` to `end`, optionally looking at `target`."""
    ts = np.linspace(0.0, 1.0, frames)[:, None]
    positions = np.asarray(start) * (1 - ts) + np.asarray(end) * ts
    if target is None:
        rotations = np.stack([np.eye(3)] * frames)
    else:
        rotations = np.stack(
            [look_at_rotation(p, target) for p in positions]
        )
    return positions, rotations


def render_trajectory(
    projector,
    positions,
    rotations,
    camera_template: Camera,
    mode: str = "raycast",
    out_dir: str | None = None,
    chunk: int = 24,
    **kwargs,
):
    """Render every pose; optionally dump PNGs. Returns (F, H, W, 4) numpy
    (top-down display orientation).

    mode='fast' renders the trajectory in `chunk`-frame batches through
    render_fast_batch (one kernel launch per layer and chunk on CUDA);
    any other mode renders frame by frame through render(mode=...), for
    'stereo' with `projector` the (left, right) pair."""
    def _cam(i):
        return Camera.create(
            camera_template.width,
            camera_template.height,
            focal_px=float(camera_template.focal_px),
            position=positions[i],
            rotation=rotations[i],
            skew=np.asarray(camera_template.skew),
        )

    if mode == "fast":
        frames = []
        for lo in range(0, len(positions), chunk):
            cams = [_cam(i) for i in range(lo, min(lo + chunk, len(positions)))]
            out = render_fast_batch(projector, cams, **kwargs).cpu().numpy()
            frames.extend(to_display(f) for f in out)
        frames = np.stack(frames)
    else:
        frames = []
        for i in range(len(positions)):
            img = render(projector, _cam(i), mode=mode, **kwargs)
            frames.append(to_display(img.cpu().numpy()))
        frames = np.stack(frames)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for i, frame in enumerate(frames):
            # encode_png takes GL rows: flip the display frame back
            png = encode_png(np.asarray(frame[::-1, :, :3]))
            with open(os.path.join(out_dir, f"frame_{i:04d}.png"), "wb") as f:
                f.write(png)
    return frames


def main(argv=None):
    parser = argparse.ArgumentParser(description="Offline LIF trajectory renderer")
    parser.add_argument("lif", help="path to a .lif file")
    parser.add_argument("--mode", choices=["orbit", "dolly"], default="orbit")
    parser.add_argument("--render",
                        choices=["raycast", "mesh", "billboard", "stereo",
                                 "fast"],
                        default="fast")
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--sweep", type=float, default=30.0,
                        help="orbit sweep in degrees")
    parser.add_argument("--out", default="./frames")
    parser.add_argument("--view", type=int, default=0, help="view index")
    parser.add_argument("--device", default=None,
                        help="torch device of the textures (default: cuda)")
    args = parser.parse_args(argv)

    result = load_lif_file(args.lif, device=args.device)
    projector = result.projectors[args.view]
    center = (
        result.orbit_center
        if result.orbit_center is not None
        else np.asarray(projector.position) + np.array([0, 0, -1.0])
    )
    cam = Camera.create(
        projector.width, projector.height, focal_px=float(projector.focal[0])
    )
    radius = float(np.linalg.norm(np.asarray(projector.position) - center))
    if radius < 1e-6:
        radius = 1.0
    if args.mode == "orbit":
        positions, rotations = orbit_trajectory(center, radius, args.frames,
                                                args.sweep)
    else:
        start = np.asarray(projector.position)
        positions, rotations = linear_trajectory(
            start, center * 0.3 + start * 0.7, args.frames
        )

    # stereo blends the first two views along the first view's trajectory
    if args.render == "stereo" and len(result.projectors) >= 2:
        projector = result.projectors[:2]
    frames = render_trajectory(
        projector, positions, rotations, cam, mode=args.render, out_dir=args.out
    )
    print(f"rendered {len(frames)} frames to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
