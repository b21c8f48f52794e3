"""Seeded synthetic scenes and camera builders, numpy and the port only.

The scene stands in for SFMoMA (not on the card host): smooth-noise
disparity in [0.2, 0.8] with a hard near box at 0.95 and smooth-noise
colour, with SFMoMA's constants (focal 0.78 W, baseline 0.045 m, inverse
depth INVZ_FAR..INVZ_NEAR). The benches and chip_smoke.py build every
input here, from a seed.
"""

from __future__ import annotations

import numpy as np

W, H = 1280, 800
FOCAL_RATIO = 0.78  # focal / width
BASELINE = 0.045  # m
INVZ_NEAR, INVZ_FAR = 0.09, 0.0001  # 1/m
ORBIT_CENTER = (0.0, 0.0, -1.0)  # m: the orbits' center, radius 1 m
# the convergence distance behind a stereo LIF's stereo_render_data.invd
LIF_CONVERGENCE = 1.0
# the fused projectors: N_FUSED, synthesized at x = FUSED_DX i
N_FUSED = 4
FUSED_DX = 0.02  # m between projectors


def smooth_noise(rng, h, w, octaves=3, lo=0.0, hi=1.0):
    """Band-limited noise in [lo, hi] (bilinear-upsampled random grids)."""
    acc = np.zeros((h, w))
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        gh = max(2, h // (2 ** (octaves - o + 1)))
        gw = max(2, w // (2 ** (octaves - o + 1)))
        grid = rng.random((gh, gw))
        ys = np.linspace(0, gh - 1, h)
        xs = np.linspace(0, gw - 1, w)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, gh - 1)
        x1 = np.minimum(x0 + 1, gw - 1)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        up = (
            grid[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + grid[np.ix_(y0, x1)] * (1 - fy) * fx
            + grid[np.ix_(y1, x0)] * fy * (1 - fx)
            + grid[np.ix_(y1, x1)] * fy * fx
        )
        acc += amp * up
        total += amp
        amp *= 0.5
    acc /= total
    return lo + (hi - lo) * acc


def make_scene(seed: int = 0, w: int = W, h: int = H):
    """(rgb (h, w, 3), disp (h, w)) float32 of the seeded scene."""
    rng = np.random.default_rng(seed)
    disp = smooth_noise(rng, h, w, octaves=3, lo=0.2, hi=0.8)
    disp[h // 3 : h // 2, w // 3 : w // 2] = 0.95  # near box: a hard edge
    rgb = np.stack([smooth_noise(rng, h, w, octaves=4) for _ in range(3)], -1)
    return rgb.astype(np.float32), disp.astype(np.float32)


def scene_projector(lt, seed: int = 0, w: int = W, h: int = H, **kwargs):
    """make_scene(seed, w, h) as a one-layer projector of package `lt`
    (lif_tpu_torch, or lif_tpu on the reference side) at the origin;
    kwargs go to projector_from_arrays (device=)."""
    rgb, disp = make_scene(seed, w, h)
    return lt.projector_from_arrays(
        rgb, disp, focal_px=FOCAL_RATIO * w, invz_min=INVZ_NEAR,
        invz_max=INVZ_FAR, baseline=BASELINE, **kwargs)


def make_stereo_lif(seed: int = 0, w: int = W, h: int = H) -> bytes:
    """A stereo LIF authored from the seed after
    examples/multiview_demo.py:34-111 with PNG payloads: the left view is
    make_scene(seed, w, h) at -baseline/2 (LIF position -0.5); the right
    view at +baseline/2 is synthesized from the left alone by the port ON
    THE CPU (render_fast_view with to_srgb=True, mask_mode='none',
    feathering=0, and render_depth_fast), so the bytes do not depend on
    the card. Both views w x h, focal 0.78 w, inverse depth
    INVZ_FAR..INVZ_NEAR; stereo_render_data.invd puts the convergence
    plane LIF_CONVERGENCE m away."""
    import lif_tpu_torch as lt
    from lif_tpu_torch.io import container
    from lif_tpu_torch.io.decode import encode_png

    rgb, disp = make_scene(seed, w, h)
    view = {"width_px": w, "height_px": h, "focal_px": FOCAL_RATIO * w,
            "rotation": [0.0, 0.0, 0.0]}
    left = dict(view, position=[-0.5, 0.0, 0.0], image={"blob_id": -1},
                inv_z_map={"blob_id": 20, "min": INVZ_NEAR,
                           "max": INVZ_FAR})
    image, blobs = encode_png(rgb), {20: encode_png(disp)}
    mono = {"views": [left], "baseline_mm": BASELINE * 1e3}
    proj = lt.load_lif_file(container.write(image, mono, blobs),
                            device="cpu").projectors[0]
    cam_r = lt.Camera.create(w, h, focal_px=float(proj.focal[0]),
                             position=[BASELINE / 2, 0.0, 0.0])
    rgb_r = lt.render_fast_view(proj, cam_r, to_srgb=True, mask_mode="none",
                                feathering=0.0)[..., :3].numpy()
    invz_r = lt.render_depth_fast(proj, cam_r).numpy()
    blobs[30] = encode_png(rgb_r)
    blobs[31] = encode_png(np.clip(
        (invz_r - INVZ_FAR) / (INVZ_NEAR - INVZ_FAR), 0.0, 1.0))
    right = dict(view, position=[0.5, 0.0, 0.0], image={"blob_id": 30},
                 inv_z_map={"blob_id": 31, "min": INVZ_NEAR,
                            "max": INVZ_FAR})
    meta = {"views": [left, right], "baseline_mm": BASELINE * 1e3,
            "stereo_render_data": {"invd": BASELINE / LIF_CONVERGENCE}}
    return container.write(image, meta, blobs)


def make_fusion_projectors(seed: int = 0, w: int = W, h: int = H):
    """Four w x h projectors: make_scene(seed, w, h) as a projector at the
    origin, and from it one projector synthesized at x = FUSED_DX i
    (synthesize_projector: the fast view and its solved depth there) by
    the port ON THE CPU, so they do not depend on the card
    (bench_configs.py:548-553). Returns the CPU projectors."""
    import lif_tpu_torch as lt

    base = scene_projector(lt, seed, w, h, device="cpu")
    return [lt.synthesize_projector(base, [FUSED_DX * i, 0.0, 0.0])
            for i in range(N_FUSED)]


def lateral_cams(lt, focal, n, x0=0.135, spread=0.02, w=W, h=H):
    """n lateral cameras at x = x0 + spread i / n m (bench.py's pose
    batch: x0 is BASELINE config 0's fixed novel view)."""
    return [lt.Camera.create(w, h, focal_px=focal,
                             position=[x0 + spread * i / n, 0.0, 0.0])
            for i in range(n)]


def orbit_cams(lt, focal, thetas=(), phis=(), w=W, h=H):
    """Cameras orbit_pose(ORBIT_CENTER, 1, theta, phi) (radians)."""
    return [
        lt.Camera.create(w, h, focal_px=focal, position=p, rotation=r)
        for p, r in (
            lt.orbit_pose(list(ORBIT_CENTER), 1.0, t, ph)
            for t, ph in zip(thetas or [0.0] * len(phis),
                             phis or [0.0] * len(thetas))
        )
    ]


def dolly_cams(lt, focal, n=48, w=W, h=H):
    """n unrotated head-tracking cameras (0.03 cos 2 pi t, 0.02 sin 2 pi t,
    z) m, z in linspace(-0.05, 0.05)."""
    t = np.linspace(0.0, 1.0, n)
    z = np.linspace(-0.05, 0.05, n)
    return [
        lt.Camera.create(w, h, focal_px=focal, position=[
            0.03 * np.cos(2 * np.pi * a), 0.02 * np.sin(2 * np.pi * a), b])
        for a, b in zip(t, z)
    ]


def pair_cams(lt, focal, eye, n, dx=0.0005, skew=(0.0, 0.0), w=W, h=H):
    """n stereo pairs, left then right, at (-+eye + dx i, 0, 0) m
    (bench_configs.py:416-424)."""
    return [lt.Camera.create(w, h, focal_px=focal,
                             position=[s * eye + dx * i, 0.0, 0.0], skew=skew)
            for i in range(n) for s in (-1.0, 1.0)]


def rot_x(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def rot_y(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
