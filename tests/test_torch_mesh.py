"""Parity of the port's connected-mesh rasterizer (ops/mesh.py) with
lif_tpu (CPU), on the cases of tests/test_mesh.py.

The same seeded numpy inputs go through lif_tpu's render_connected_mesh
(jitted: for the mesh its jitted and eager evaluations agree, 0 hit flips
and a max abs difference of 2.7e-6 on a 64x96 scene) and the port's. The
port rounds every float32 product, while XLA on the CPU may contract a
multiply-add into an FMA, so an edge-function test at a pixel centre can
flip at an isolated pixel: hit disagreement must stay under 1e-3 of the
pixels (the billboard's bound, tests/test_splat_march.py:106-115), and
where both hit the colour within 1e-4 (a few float32 ulps of the
perspective-correct interpolation) at all but 1e-3 of the pixels.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu.ops import mesh as jmesh
from lif_tpu_torch.ops import mesh as tmesh

from .test_mesh import _corner_blur_expected, _psnr, _smooth_rgb

torch.set_num_threads(1)


def _both(rgb, disp, pos, f2=None, out_w=None, out_h=None, rot=None, **kw):
    h, w = disp.shape
    f1 = np.float32(0.78 * w)
    args = (rgb.astype(np.float32), disp.astype(np.float32), np.float32(2.0),
            np.float32(0.2), np.float32(1.0), f1, f1, np.float32(w / 2),
            np.float32(h / 2),
            np.asarray(np.eye(3) if rot is None else rot, np.float32),
            np.asarray(pos, np.float32), np.float32(f1 if f2 is None else f2))
    common = dict(out_w=out_w or w, out_h=out_h or h, to_srgb=False, **kw)
    ref = np.asarray(jmesh.render_connected_mesh(
        *(jnp.asarray(a) for a in args), background=jnp.zeros(4), **common))
    got = tmesh.render_connected_mesh(
        torch.from_numpy(args[0]), torch.from_numpy(args[1]), *args[2:],
        background=np.zeros(4, np.float32), **common).numpy()
    return ref, got


def _assert_parity(ref, got):
    hit_r, hit_g = ref[..., 3] > 0.5, got[..., 3] > 0.5
    assert (hit_r != hit_g).mean() < 1e-3, (hit_r != hit_g).mean()
    both = hit_r & hit_g
    err = np.abs(got[..., :3] - ref[..., :3]).max(-1)
    assert ((err > 1e-4) & both).mean() < 1e-3, err[both].max()


def test_identity_passthrough(rng):
    """Identity pose, flat depth: hole-free, shaded as the reference's
    corner-interpolated colours (tests/test_mesh.py:58), equal to
    lif_tpu's."""
    h, w = 48, 64
    rgb = _smooth_rgb(rng, h, w)
    ref, got = _both(rgb, np.full((h, w), 0.6, np.float32), [0.0, 0.0, 0.0])
    _assert_parity(ref, got)
    assert float(got[..., 3].min()) == 1.0
    expected = _corner_blur_expected(rgb)
    assert _psnr(got[1:-1, 1:-1, :3], expected[1:-1, 1:-1]) > 40.0


def test_flat_depth_translation_is_hole_free_shift(rng):
    """Flat depth + an exact 2-px lateral parallax: a hole-free shift
    (tests/test_mesh.py:71)."""
    h, w = 48, 64
    rgb = _smooth_rgb(rng, h, w)
    invz = 0.2 + (2.0 - 0.2) * 0.5
    cx = -2 / (0.78 * w * invz)
    ref, got = _both(rgb, np.full((h, w), 0.5, np.float32), [cx, 0.0, 0.0])
    _assert_parity(ref, got)
    assert float(got[:, : w - 3, 3].min()) == 1.0
    expected = _corner_blur_expected(rgb)[:, 2 : w - 1]
    assert _psnr(got[1:-1, : w - 3, :3], expected[1:-1]) > 38.0


def test_magnification_hole_free(rng):
    """2x magnification (f2 = 2 f1): the connected triangles leave no hole
    in the central crop (tests/test_mesh.py:91)."""
    h, w = 48, 64
    rgb = _smooth_rgb(rng, h, w)
    disp = rng.uniform(0.4, 0.6, (h, w)).astype(np.float32)
    ref, got = _both(rgb, disp, [0.0, 0.0, 0.0], f2=2 * 0.78 * w,
                     max_quad_px=4)
    _assert_parity(ref, got)
    crop = (slice(h // 4, -h // 4), slice(w // 4, -w // 4))
    assert float((got[crop][..., 3] > 0).mean()) == 1.0


def test_gradient_cull_drops_depth_cliff(rng):
    """A steep depth edge loses coverage under a tight threshold
    (tests/test_mesh.py:124); both thresholds equal lif_tpu's."""
    h, w = 48, 64
    rgb = _smooth_rgb(rng, h, w)
    disp = np.full((h, w), 0.2, np.float32)
    disp[:, : w // 2] = 0.9
    out = {}
    for thr in (0.0, 0.1):
        ref, got = _both(rgb, disp, [-0.05, 0.0, 0.0],
                         delta_invz_threshold=thr)
        _assert_parity(ref, got)
        out[thr] = got
    assert float(out[0.1][..., 3].sum()) < float(out[0.0][..., 3].sum()) - 10


@pytest.mark.parametrize("rot_deg,pos,size", [
    (0.0, [0.04, 0.01, 0.02], None),
    (5.0, [0.05, -0.02, 0.0], (72, 52)),
    (-3.0, [-0.03, 0.0, 0.04], None),
])
def test_general_poses_and_show_depth(rng, rot_deg, pos, size):
    """Rough depth at translated, rotated and dollied poses, a larger
    output, and the depth-visualization shading."""
    h, w = 40, 56
    rgb = _smooth_rgb(rng, h, w)
    disp = rng.uniform(0.3, 0.7, (h, w)).astype(np.float32)
    t = np.deg2rad(rot_deg)
    rot = np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                    [-np.sin(t), 0, np.cos(t)]])
    ow, oh = size or (w, h)
    for show_depth in (False, True):
        _assert_parity(*_both(rgb, disp, pos, out_w=ow, out_h=oh, rot=rot,
                              show_depth=show_depth))


def test_view_wrapper_and_dispatch(rng):
    """render(mode='mesh') == render_mesh_connected_view through
    projector_from_reference, against lif_tpu's view wrapper
    (tests/test_mesh.py:144), in sRGB."""
    h, w = 48, 64
    rgb = _smooth_rgb(rng, h, w)
    disp = rng.uniform(0.3, 0.7, (h, w)).astype(np.float32)
    jp = lif_tpu.projector_from_arrays(rgb, disp, focal_px=0.78 * w,
                                       invz_min=2.0, invz_max=0.2,
                                       baseline=1.0)
    tp = lif_tpu_torch.projector_from_reference(jp, device="cpu")
    jc = lif_tpu.Camera.create(w, h, focal_px=0.78 * w,
                               position=[0.02, 0.01, 0.0])
    tc = lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                     position=[0.02, 0.01, 0.0])
    ref = np.asarray(jmesh.render_mesh_connected_view(jp, jc))
    got = lif_tpu_torch.render(tp, tc, mode="mesh").numpy()
    _assert_parity(ref, got)
    assert np.array_equal(got,
                          tmesh.render_mesh_connected_view(tp, tc).numpy())
