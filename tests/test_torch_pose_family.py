"""Where a camera batch stands, decided once for every fast entry point
(models/renderer.py::_read_poses), on the CPU at 32x64.

A batch is lateral, the lateral march's pose family, where no relative
rotation is off identity by over 1e-5 and every |y| and |z| is under
1e-9. Each of the six fast entry points takes that one decision: a pose
at y = 2e-9 or a yaw of 2e-5 rad is routed off the march or refused with
the entry point's own text, and a pose at y = 5e-10 marches. The view's
lateral plane table stays lif_tpu's: the pose's own snap_plane_table at
stride 1, whatever config.march_stride says, and not the batch ladder's
row, which at num_planes=None can take a wider stride. lif_tpu's six
entry points route or refuse each of those poses the same way (they
part only at |y| or |z| exactly 1e-9, which lif_tpu's view, depth,
fused and billboard paths take as lateral). The rotation test is
np.allclose(rot, I, atol=1e-5) element for element, at its edges too.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import lif_tpu
import lif_tpu_torch as lt
from lif_tpu.models import renderer as jrenderer
from lif_tpu_torch.core.pose import relative_view_pose
from lif_tpu_torch.models import renderer
from lif_tpu_torch.ops import sweep_march as tsm

H, W = 32, 64
FOCAL = 0.78 * W


def _projector(rng, x=0.0, pkg=lt):
    disp = (0.3 + 0.4 * rng.random((H, W))).astype(np.float32)
    disp[H // 4:H // 2, W // 4:W // 2] = 0.9
    rgb = rng.random((H, W, 3)).astype(np.float32)
    kw = dict(device="cpu") if pkg is lt else {}
    return pkg.projector_from_arrays(rgb, disp, focal_px=FOCAL, invz_min=2.0,
                                     invz_max=0.1, baseline=1.0,
                                     position=(x, 0.0, 0.0), **kw)


def _yaw(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _tiers_of(fn, monkeypatch):
    """Runs fn; returns the tiers of every _fast_batch_core call it made
    (the mono batch's and the view's lateral path's)."""
    seen = []
    core = renderer._fast_batch_core

    def spy(layers, modes, *args, **kwargs):
        seen.append(tuple(modes))
        return core(layers, modes, *args, **kwargs)

    monkeypatch.setattr(renderer, "_fast_batch_core", spy)
    fn()
    return seen


def _route(entry, proj, other, cams, monkeypatch):
    """The tier the entry point renders the batch's layer on, or the
    ValueError it raises."""
    if entry == "render_fast_batch":
        (tiers,) = _tiers_of(lambda: lt.render_fast_batch(proj, cams),
                             monkeypatch)
        return tiers[0]
    if entry == "render_fast_view":
        (tiers,) = _tiers_of(lambda: lt.render_fast_view(proj, cams[-1]),
                             monkeypatch)
        return tiers[0]
    if entry == "render_stereo_fast_batch":
        _, (left, right) = lt.render_stereo_fast_batch(proj, other, cams,
                                                       return_tiers=True)
        assert left == right
        return left[0]
    if entry == "render_depth_fast":
        lt.render_depth_fast(proj, cams[-1])
    elif entry == "render_fused_fast_batch":
        lt.render_fused_fast_batch([proj, other], cams)
    else:
        lt.render_billboard_fast_batch(proj, cams)
    return "march"


# the refusals of the entry points that take lateral batches only
REFUSALS = {
    "render_depth_fast": "render_depth_fast needs a lateral (x-only) pose",
    "render_fused_fast_batch": "render_fused_fast needs lateral poses; use "
    "parallel.sharding.render_fused_projectors for arbitrary poses",
    "render_billboard_fast_batch": "render_billboard_fast_batch needs "
    "lateral poses; use render(mode='billboard') per frame otherwise",
}
ENTRIES = ["render_fast_batch", "render_fast_view",
           "render_stereo_fast_batch", *REFUSALS]
# the last camera of the batch: (its pose, whether the batch is lateral)
POSES = {
    "y=2e-9": (dict(position=(0.017, 2e-9, 0.0)), False),
    "yaw=2e-5": (dict(position=(0.017, 0.0, 0.0), rotation=_yaw(2e-5)),
                 False),
    "y=5e-10": (dict(position=(0.017, 5e-10, 0.0)), True),
}


@pytest.mark.parametrize("pose", list(POSES))
@pytest.mark.parametrize("entry", ENTRIES)
def test_every_entry_point_takes_one_lateral_family(rng, entry, pose,
                                                    monkeypatch):
    """A batch of a lateral camera and the pose: lateral at y = 5e-10
    (the march), not at y = 2e-9 or a yaw of 2e-5 rad (another tier, or
    the entry point's own refusal)."""
    kw, lateral = POSES[pose]
    proj, other = _projector(rng), _projector(rng, x=0.02)
    cams = [lt.Camera.create(W, H, focal_px=FOCAL, position=(0.011, 0, 0)),
            lt.Camera.create(W, H, focal_px=FOCAL, **kw)]
    assert renderer._read_poses(proj, cams).lateral is lateral
    if lateral:
        assert _route(entry, proj, other, cams, monkeypatch) == "march"
    elif entry in REFUSALS:
        with pytest.raises(ValueError) as err:
            _route(entry, proj, other, cams, monkeypatch)
        assert str(err.value) == REFUSALS[entry]
    else:
        assert _route(entry, proj, other, cams, monkeypatch) != "march"


def _reference_route(entry, proj, other, cams, monkeypatch):
    """lif_tpu's _route: the tier its entry point renders the batch's
    layer on (the view's lateral path: 'march'), or the text of the
    ValueError it raises."""
    seen = []
    batch = jrenderer.render_fast_batch

    def spy_batch(*args, **kwargs):
        if seen:  # render_fast_batch's own call on the transpose
            return batch(*args, **kwargs)
        seen.append(None)
        out, tiers = batch(*args, **dict(kwargs, return_tiers=True))
        seen[0] = tiers[0]
        return out

    stereo = jrenderer._stereo_fast_core_jit

    def spy_stereo(**statics):
        seen.append(statics["modes_l"][0])
        assert statics["modes_l"] == statics["modes_r"]
        return stereo(**statics)

    monkeypatch.setattr(jrenderer, "render_fast_batch", spy_batch)
    monkeypatch.setattr(jrenderer, "_stereo_fast_core_jit", spy_stereo)
    calls = {
        "render_fast_batch": lambda: spy_batch(proj, cams),
        "render_fast_view": lambda: jrenderer.render_fast_view(proj,
                                                               cams[-1]),
        "render_stereo_fast_batch": lambda: jrenderer.render_stereo_fast_batch(
            proj, other, cams),
        "render_depth_fast": lambda: jrenderer.render_depth_fast(proj,
                                                                 cams[-1]),
        "render_fused_fast_batch": lambda: jrenderer.render_fused_fast_batch(
            [proj, other], cams),
        "render_billboard_fast_batch":
            lambda: jrenderer.render_billboard_fast_batch(proj, cams),
    }
    try:
        calls[entry]()
    except ValueError as err:
        return str(err)
    return seen[0] if seen else "march"


@pytest.mark.parametrize("pose", list(POSES))
@pytest.mark.parametrize("entry", ENTRIES)
def test_lif_tpu_routes_the_pose_the_same_way(rng, entry, pose,
                                               monkeypatch):
    """The port's route of each pose, as in the test above, is lif_tpu's:
    the same tier, or the same refusal."""
    kw = POSES[pose][0]
    seed = int(rng.integers(1 << 31))
    routes = []
    for pkg in (lt, lif_tpu):
        rng_p = np.random.default_rng(seed)
        proj = _projector(rng_p, pkg=pkg)
        other = _projector(rng_p, x=0.02, pkg=pkg)
        cams = [pkg.Camera.create(W, H, focal_px=FOCAL,
                                  position=(0.011, 0, 0)),
                pkg.Camera.create(W, H, focal_px=FOCAL, **kw)]
        if pkg is lt:
            try:
                routes.append(_route(entry, proj, other, cams, monkeypatch))
            except ValueError as err:
                routes.append(str(err))
        else:
            routes.append(_reference_route(entry, proj, other, cams,
                                           monkeypatch))
    assert routes[0] == routes[1]


def test_view_plane_table_is_its_own_snap_ladder(rng, monkeypatch):
    """Under RenderConfig(march_stride=2) render_fast_view's lateral
    plane table is the pose's snap_plane_table at stride 1, bit for bit,
    while the batch of the same pose takes the stride-2 ladder."""
    proj = _projector(rng)
    cam = lt.Camera.create(W, H, focal_px=FOCAL, position=(0.1, 0.0, 0.0))
    cfg = lt.DEFAULT_CONFIG.replace(march_stride=2)
    tables = []
    core = renderer._fast_batch_core

    def spy(layers, *args, **kwargs):
        tables.append(layers[0]["plane_invz"].numpy())
        return core(layers, *args, **kwargs)

    monkeypatch.setattr(renderer, "_fast_batch_core", spy)
    lt.render_fast_view(proj, cam, config=cfg)
    lt.render_fast_batch(proj, [cam], config=cfg)
    cx = float(relative_view_pose(proj.position, proj.rotation, cam.position,
                                  cam.rotation)[0][0])
    lay = renderer._prepared_textures(proj)[0]
    want, k = tsm.snap_plane_table(lay["focal_host"], cx, lay["izmin_host"],
                                   lay["izmax_host"])
    view, batch = tables
    assert view.shape == (1, k)
    assert np.array_equal(view[0].view(np.uint32), want.view(np.uint32))
    strided, _ = tsm.snap_plane_tables_batch(
        lay["focal_host"], [cx], lay["izmin_host"], lay["izmax_host"],
        stride=2)
    assert np.array_equal(batch.view(np.uint32), strided.view(np.uint32))
    assert not np.array_equal(batch, want[None])


def test_batch_ladder_row_can_differ_from_the_single_ladder():
    """Why the view plans its own snap_plane_table and not a one-row
    snap_plane_tables_batch: at num_planes=None the batch builds its rows
    at num_planes=K, which caps each ladder at K planes, and a ladder
    whose endpoint integer was filtered out can pass K by its integer
    count and double its stride there. Here 63 integer shifts 0..62 (a
    shift of 62.5 px at izmin), the one at izmax = 0 filtered: the single
    ladder has 64 planes at stride 1, the batch row takes stride 2."""
    args = (1.0, [-62.5], 1.0, 0.0)
    single, k = tsm.snap_plane_table(*args[:1], args[1][0], *args[2:])
    row, k_b = tsm.snap_plane_tables_batch(*args)
    assert k == k_b == 64
    assert np.array_equal(single, tsm.snap_plane_table(
        1.0, -62.5, 1.0, 0.0, stride=1)[0])
    assert not np.array_equal(row[0], single)
    assert np.array_equal(row[0].view(np.uint32), tsm.snap_plane_table(
        1.0, -62.5, 1.0, 0.0, num_planes=64)[0].view(np.uint32))
    # the single ladder steps one pixel of shift a plane, the row two
    assert np.allclose(np.diff(single[-63:]), -1.0 / 62.5, rtol=1e-3)
    assert np.allclose(np.diff(row[0][-32:]), -2.0 / 62.5, rtol=1e-3)


def _off(i, j, v):
    rot = np.eye(3)
    rot[i, j] = v
    return rot


# relative rotations at np.allclose's edge (atol 1e-5, rtol 1e-5 of |I|)
EDGES = {
    "off-diagonal at atol": _off(0, 2, 1e-5),
    "off-diagonal past atol": _off(0, 2, np.nextafter(1e-5, 1.0)),
    "diagonal at atol + rtol": _off(1, 1, 1.0 + 2e-5),
    "diagonal under": _off(1, 1, 1.0 - 1.9e-5),
    "nan": _off(2, 0, np.nan),
    "inf": _off(2, 2, np.inf),
}


@pytest.mark.parametrize("edge", list(EDGES))
def test_rotation_test_is_np_allclose(edge, monkeypatch):
    """_read_poses' `rotated` is np.allclose(rot, I, atol=1e-5) at the
    tolerance's edge and on NaN and inf, for a pose batch whose other
    rotation is the identity."""
    rots = iter([np.eye(3), EDGES[edge]])
    monkeypatch.setattr(renderer, "relative_view_pose",
                        lambda *args: (np.array([0.01, 0.0, 0.0]),
                                       next(rots)))
    pose = SimpleNamespace(position=None, rotation=None)
    poses = renderer._read_poses(pose, [pose, pose])
    want = not np.allclose(np.stack([np.eye(3), EDGES[edge]]), np.eye(3),
                           atol=1e-5)
    assert poses.rotated is want
    assert poses.lateral is (not want)


STEREO_DIMS = "render_stereo_fast_batch cameras must share width/height/focal"
STEREO_SKEW = ("render_stereo_fast_batch cameras must share skew; batch "
               "per-eye frusta as separate calls")


@pytest.mark.parametrize("order,text", [
    (("skew", "wide"), STEREO_SKEW),
    (("wide", "skew"), STEREO_DIMS),
    (("narrow-focal-and-skew",), STEREO_DIMS),
])
def test_stereo_refuses_the_first_camera_that_differs(rng, order, text):
    """One batched intrinsics check, as the per-camera loop it replaced:
    the first camera off cameras[0] names what it gets wrong, its width,
    height or focal before its skew."""
    proj, other = _projector(rng), _projector(rng, x=0.02)
    kinds = {
        "skew": dict(width=W, focal_px=FOCAL, skew=(0.01, 0.0)),
        "wide": dict(width=W + 8, focal_px=FOCAL),
        "narrow-focal-and-skew": dict(width=W, focal_px=FOCAL + 1.0,
                                      skew=(0.01, 0.0)),
    }
    cams = [lt.Camera.create(W, H, focal_px=FOCAL, position=(0.011, 0, 0))]
    cams += [lt.Camera.create(height=H, position=(0.013, 0, 0), **kinds[k])
             for k in order]
    with pytest.raises(ValueError) as err:
        lt.render_stereo_fast_batch(proj, other, cams)
    assert str(err.value) == text
