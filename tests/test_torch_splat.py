"""Parity of the port's billboard scatter (ops/splat.py) with lif_tpu (CPU).

The same seeded numpy inputs go through lif_tpu's forward_splat and the
port's. The oracle is lif_tpu's EAGER forward_splat
(`forward_splat.__wrapped__`): its jitted evaluation is not one, since
XLA's approximate reciprocal moves u and flips about 2-11% of hits on a
smooth scene (tests/test_splat_march.py:4-11). Against the eager scatter
the port evaluates the same float32 operations one by one, so it should
agree exactly; the gate is the repo's bound for the billboard
(tests/test_splat_march.py:106-115): hit disagreement and colour
mismatches (> 1e-6 where both hit) each under 1e-3 of the pixels,
tolerating an isolated ulp-level coverage flip.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu.core.pose import relative_view_pose
from lif_tpu.ops import splat as jsp
from lif_tpu_torch.ops import splat as tsp

from .scenes import smooth_noise
from .test_splat import _brute_force_splat

torch.set_num_threads(1)


def _args(rgb, disp, pos, rot=None):
    h, w = disp.shape
    f1 = np.float32(0.78 * w)
    return (rgb.astype(np.float32), disp.astype(np.float32), np.float32(2.0),
            np.float32(0.2), np.float32(1.0), f1, f1, np.float32(w / 2),
            np.float32(h / 2),
            np.asarray(np.eye(3) if rot is None else rot, np.float32),
            np.asarray(pos, np.float32), f1)


def _both(args, out_w, out_h, **kw):
    """(eager lif_tpu, port) images for the same arguments."""
    bg = np.asarray(kw.pop("background", np.zeros(4, np.float32)))
    ref = np.asarray(jsp.forward_splat.__wrapped__(
        *(jnp.asarray(a) for a in args), out_w=out_w, out_h=out_h,
        background=jnp.asarray(bg), **kw))
    got = tsp.forward_splat(
        torch.from_numpy(args[0]), torch.from_numpy(args[1]), *args[2:],
        out_w=out_w, out_h=out_h, background=bg, **kw).numpy()
    return ref, got


def _assert_parity(ref, got, channels=3):
    hit_r, hit_g = ref[..., 3] > 0.5, got[..., 3] > 0.5
    assert (hit_r != hit_g).mean() < 1e-3, (hit_r != hit_g).mean()
    both = hit_r & hit_g
    mism = (np.abs(got[..., :channels] - ref[..., :channels]).max(-1)
            > 1e-6) & both
    assert mism.mean() < 1e-3, mism.mean()


def test_identity_flat_depth_passthrough(rng):
    """footprint 1, flat depth, identity pose: both pass the source
    through, equal to each other (tests/test_splat.py:54)."""
    h, w = 24, 32
    rgb = rng.random((h, w, 3)).astype(np.float32)
    disp = np.full((h, w), 0.5, np.float32)
    ref, got = _both(_args(rgb, disp, [0, 0, 0]), w, h, footprint=1,
                     to_srgb=False)
    np.testing.assert_allclose(got[..., :3], rgb, atol=1e-5)
    np.testing.assert_allclose(got[..., 3], 1.0)
    assert np.array_equal(ref, got)


def test_matches_brute_force_and_eager(rng):
    """The float64 brute-force z-buffer at pos (0.15, -0.05, 0.1) with
    tests/test_splat.py:73's bounds, and the eager scatter to the parity
    gate; also in sRGB and with show_depth."""
    h, w = 20, 26
    rgb = rng.random((h, w, 3))
    disp = smooth_noise(rng, h, w)
    pos = [0.15, -0.05, 0.1]
    golden, hit = _brute_force_splat(rgb, disp, 2.0, 0.2, 1.0, 0.78 * w,
                                     0.78 * w, w / 2, h / 2, np.eye(3),
                                     np.asarray(pos), 0.78 * w, w, h)
    args = _args(rgb, disp, pos)
    ref, got = _both(args, w, h, footprint=2, to_srgb=False)
    _assert_parity(ref, got)
    agree = (got[..., 3] > 0.5) == hit
    assert agree.mean() > 0.97, agree.mean()
    both = (got[..., 3] > 0.5) & hit
    assert np.quantile(np.abs(got[..., :3][both] - golden[both]), 0.95) < 2e-2
    for kw in (dict(to_srgb=True), dict(to_srgb=False, show_depth=True)):
        _assert_parity(*_both(args, w, h, **kw))


@pytest.mark.parametrize("rot_deg,pos,point_size", [
    (0.0, [0.3, 0.0, 0.0], 1.0),
    (6.0, [0.1, 0.02, -0.05], 1.0),
    (-4.0, [-0.2, 0.0, 0.1], 1.4),
])
def test_general_poses_match_eager(rng, rot_deg, pos, point_size):
    """Lateral, rotated and dollied poses, a larger point size and an
    output larger than the source: the eager scatter's images."""
    h, w = 40, 56
    rgb = rng.random((h, w, 3))
    disp = smooth_noise(rng, h, w, lo=0.1, hi=0.9)
    t = np.deg2rad(rot_deg)
    rot = np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                    [-np.sin(t), 0, np.cos(t)]])
    args = _args(rgb, disp, pos, rot=rot)
    _assert_parity(*_both(args, w, h, point_size=point_size, to_srgb=False))
    _assert_parity(*_both(args, w + 8, h + 6, point_size=point_size,
                          to_srgb=False))


def test_behind_camera_discard(rng):
    """Every point behind the camera: background everywhere, as lif_tpu
    (tests/test_splat.py:102)."""
    h, w = 16, 20
    rgb = rng.random((h, w, 3)).astype(np.float32)
    disp = np.full((h, w), 0.5, np.float32)
    bg = np.asarray([0.3, 0, 0, 1], np.float32)
    ref, got = _both(_args(rgb, disp, [0, 0, 100.0]), w, h, footprint=1,
                     to_srgb=False, background=bg)
    np.testing.assert_allclose(got[..., 0], 0.3, atol=1e-6)
    assert np.array_equal(ref, got)


def test_gradient_cull(rng):
    """A sharp depth edge: the tight threshold culls coverage, and both
    thresholds equal lif_tpu's images (tests/test_splat.py:121)."""
    h, w = 16, 20
    rgb = np.ones((h, w, 3), np.float32)
    disp = np.zeros((h, w), np.float32)
    disp[:, 10:] = 1.0
    args = _args(rgb, disp, [0, 0, 0])
    out = {}
    for thr in (0.0, 0.1):
        ref, got = _both(args, w, h, footprint=1, to_srgb=False,
                         delta_invz_threshold=thr)
        assert np.array_equal(ref, got)
        out[thr] = got
    assert (out[0.0][..., 3] > 0.5).sum() > (out[0.1][..., 3] > 0.5).sum()


def _view_eager(jp, cam, **kw):
    """lif_tpu's render_mesh_view with the eager forward_splat."""
    pos, rot = relative_view_pose(jp.position, jp.rotation, cam.position,
                                  cam.rotation)
    intr = jp.intrinsics
    return np.asarray(jsp.forward_splat.__wrapped__(
        jnp.asarray(jp.rgb[0]), jnp.asarray(jp.disp[0]),
        jnp.float32(jp.invz_min[0]), jnp.float32(jp.invz_max[0]),
        jnp.float32(jp.baseline), jnp.float32(intr["fx"]),
        jnp.float32(intr["fy"]), jnp.float32(intr["cx"]),
        jnp.float32(jp.height - intr["cy"]), jnp.asarray(rot, jnp.float32),
        jnp.asarray(pos * np.array([1.0, 1.0, -1.0]), jnp.float32),
        jnp.float32(cam.focal_px), out_w=cam.width, out_h=cam.height,
        background=jnp.zeros(4, jnp.float32), **kw))


def test_render_mesh_view_and_dispatch(rng):
    """render_mesh_view (and render(mode='billboard')) through
    projector_from_reference: lif_tpu's identity passthrough
    (tests/test_splat.py:144), then a skewed projector at a novel pose
    against the eager oracle through lif_tpu's view plumbing."""
    h, w = 24, 32
    jp = lif_tpu.projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32),
        np.full((h, w), 0.5, np.float32), focal_px=0.78 * w, invz_min=2.0,
        invz_max=0.2, baseline=1.0)
    tp = lif_tpu_torch.projector_from_reference(jp, device="cpu")
    cam = lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w)
    out = tsp.render_mesh_view(tp, cam, to_srgb=False, footprint=1).numpy()
    np.testing.assert_allclose(out[..., :3], np.asarray(jp.rgb[0]), atol=1e-5)

    disp = smooth_noise(rng, h, w, lo=0.2, hi=0.8).astype(np.float32)
    jp = lif_tpu.projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32), disp, focal_px=0.78 * w,
        invz_min=2.0, invz_max=0.2, baseline=0.5, skew=(0.01, -0.02))
    tp = lif_tpu_torch.projector_from_reference(jp, device="cpu")
    assert tp.intrinsics == jp.intrinsics
    jc = lif_tpu.Camera.create(w, h, focal_px=0.8 * w,
                               position=[0.05, -0.02, 0.03])
    tc = lif_tpu_torch.Camera.create(w, h, focal_px=0.8 * w,
                                     position=[0.05, -0.02, 0.03])
    ref = _view_eager(jp, jc, to_srgb=True)
    got = lif_tpu_torch.render(tp, tc, mode="billboard").numpy()
    _assert_parity(ref, got)
    assert np.array_equal(got, tsp.render_mesh_view(tp, tc).numpy())
