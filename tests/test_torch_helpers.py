"""The port's picking, debug and profiling tools and its small helpers,
against lif_tpu's (CPU).

Each helper gets the same seeded inputs in both packages and must agree:
the host math (FOV, frustum corners, Projector.inv_depth_range, the debug
dumps, the wireframe) to float64 rounding, the float32 matrices
(mat_from_roll, mat_from_slant, build_skr1, build_fskr2, srgb_to_linear)
to 1e-6, nearest_sample and the texture montage exactly (the PNG decoded
pixel for pixel), compose_layers / blend_background to 1e-6, the render
row band bit for bit against the full frame's rows, render_scaled's CPU
dispatch equal to the plain twin and held to lif_tpu's render_scaled as
tests/test_torch_sweep_scaled.py holds the twin, pick() on
tests/test_apps.py's flat and miss cases and on an LDI against lif_tpu's
pick (hit, layer, point within 1e-4 m), FpsCounter on the same clock
stamps; trace() writes a Chrome trace; benchmark_fn raises without a card
(tests/test_torch_cuda.py runs it on one).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu.apps import picking as jpicking
from lif_tpu.core import camera as jcamera
from lif_tpu.core import color as jcolor
from lif_tpu.core import transforms as jtransforms
from lif_tpu.ops import raycast as jraycast
from lif_tpu.ops import sampling as jsampling
from lif_tpu.ops import sweep_scaled as jss
from lif_tpu.utils import debug as jdebug
from lif_tpu.utils import profiling as jprofiling
from lif_tpu_torch.apps import picking as tpicking
from lif_tpu_torch.core import camera as tcamera
from lif_tpu_torch.core import color as tcolor
from lif_tpu_torch.core import transforms as ttransforms
from lif_tpu_torch.io.decode import decode_image
from lif_tpu_torch.ops import raycast as traycast
from lif_tpu_torch.ops import sampling as tsampling
from lif_tpu_torch.ops import sweep_scaled as tss
from lif_tpu_torch.utils import debug as tdebug
from lif_tpu_torch.utils import profiling as tprofiling

from .scenes import smooth_noise
from .test_torch_sweep_scaled import (IZMAX, IZMIN, _color_bounds,
                                      _depth_bounds, _setup, _t)

torch.set_num_threads(1)


def _pair(rng, h=32, w=48, flat=None, layers=1, **kw):
    """tests/test_apps.py's projector (optionally flat, optionally with a
    masked second layer) in both packages."""
    disp = (np.full((h, w), flat, np.float32) if flat is not None
            else smooth_noise(rng, h, w).astype(np.float32))
    extra = [dict(rgb=rng.random((h, w, 3)).astype(np.float32),
                  disp=smooth_noise(rng, h, w).astype(np.float32),
                  mask=(smooth_noise(rng, h, w) > 0.5).astype(np.float32),
                  focal_px=0.78 * w, invz_min=1.0, invz_max=0.1)
             for _ in range(layers - 1)]
    jp = lif_tpu.projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32), disp, focal_px=0.78 * w,
        invz_min=2.0, invz_max=0.2, baseline=kw.pop("baseline", 1.0),
        extra_layers=extra or None, **kw)
    return jp, lif_tpu_torch.projector_from_reference(jp, device="cpu")


def _cam_pair(w, h, **kw):
    return (lif_tpu.Camera.create(w, h, focal_px=0.78 * w, **kw),
            lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w, **kw))


# --- picking ---------------------------------------------------------------


def test_pick_flat_depth_center_matches_lif_tpu(rng):
    """tests/test_apps.py's flat case: disparity 0.5 is inverse depth 1.1
    1/m, hit at the centre pixel at that depth, as lif_tpu's pick."""
    jp, tp = _pair(rng, flat=0.5)
    jc, tc = _cam_pair(48, 32)
    got = tpicking.pick(tp, tc, 24, 16)
    want = jpicking.pick(jp, jc, 24, 16)
    assert got.hit and want.hit and got.layer == want.layer == 0
    np.testing.assert_allclose(-got.point[2], 1.0 / (0.2 + 1.8 * 0.5),
                               rtol=0.03)
    np.testing.assert_allclose(got.uv, [0.51, 0.515], atol=0.05)
    np.testing.assert_allclose(got.point, want.point, atol=1e-5)
    np.testing.assert_allclose(got.uv, want.uv, atol=1e-6)
    np.testing.assert_allclose(got.inv_z, want.inv_z, rtol=1e-6)
    np.testing.assert_allclose(got.distance, want.distance, rtol=1e-6)


def test_pick_miss_matches_lif_tpu(rng):
    jp, tp = _pair(rng, flat=0.5)
    jc, tc = _cam_pair(48, 32, position=(50.0, 0.0, 0.0))
    got = tpicking.pick(tp, tc, 0, 0)
    want = jpicking.pick(jp, jc, 0, 0)
    assert not got.hit and not want.hit
    assert (got.point, got.uv, got.layer, got.distance, got.inv_z) == (
        None, None, -1, float("inf"), 0.0)


@pytest.mark.parametrize("px,py", [(5, 7), (24, 16), (40, 25), (33, 3)])
def test_pick_ldi_matches_lif_tpu(rng, px, py):
    """A 2-layer LDI seen from an offset camera: the same hit, layer, uv
    and point as lif_tpu's pick."""
    jp, tp = _pair(rng, layers=2, baseline=0.5)
    jc, tc = _cam_pair(48, 32, position=(0.02, -0.01, 0.03))
    got = tpicking.pick(tp, tc, px, py)
    want = jpicking.pick(jp, jc, px, py)
    assert (got.hit, got.layer) == (want.hit, want.layer)
    if want.hit:
        np.testing.assert_allclose(got.point, want.point, atol=1e-4)
        np.testing.assert_allclose(got.uv, want.uv, atol=1e-4)
        np.testing.assert_allclose(got.inv_z, want.inv_z, rtol=1e-4)


# --- core helpers ----------------------------------------------------------


def test_camera_helpers_match_lif_tpu(rng):
    for f in (998.4, 300.0, 1500.0):
        assert tcamera.fov_from_focal(f, 800) == jcamera.fov_from_focal(f,
                                                                        800)
    assert abs(tcamera.fov_from_focal(tcamera.focal_from_fov(60.0, 800), 800)
               - 60.0) < 1e-9
    intr = {"fx": 998.4, "fy": 998.4, "cx": 640.0, "cy": 400.0}
    args = (intr, 1280, 800, 0.09, 0.0001, 0.045)
    np.testing.assert_array_equal(tcamera.frustum_corners(*args),
                                  jcamera.frustum_corners(*args))
    jp, tp = _pair(rng, skew=(0.02, -0.01), position=(0.1, 0.0, 0.2))
    np.testing.assert_array_equal(tp.frustum_corners(), jp.frustum_corners())
    assert tp.inv_depth_range == jp.inv_depth_range


@pytest.mark.parametrize("a,b", [(0.3, -0.2), (0.0, 0.0), (-1.2, 0.7)])
def test_slant_and_roll_match_lif_tpu(a, b):
    np.testing.assert_allclose(ttransforms.mat_from_slant(a, b).numpy(),
                               np.asarray(jtransforms.mat_from_slant(a, b)),
                               atol=1e-6)
    for deg in (a * 100, b * 100, 90.0):
        got = ttransforms.mat_from_roll(deg).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jtransforms.mat_from_roll(deg)), atol=1e-6)
    np.testing.assert_allclose(ttransforms.mat_from_roll(90.0).numpy()
                               @ [1, 0, 0], [0, 1, 0], atol=1e-5)


def test_srgb_to_linear_matches_lif_tpu():
    x = np.linspace(0.0, 1.0, 257, dtype=np.float32)
    got = tcolor.srgb_to_linear(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcolor.srgb_to_linear(x)),
                               atol=1e-6)
    back = tcolor.linear_to_srgb(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, x, atol=1e-5)


def test_nearest_sample_matches_lif_tpu(rng):
    tex = rng.random((4, 6, 3)).astype(np.float32)
    u = rng.uniform(-0.2, 1.2, (5, 7)).astype(np.float32)
    v = rng.uniform(-0.2, 1.2, (5, 7)).astype(np.float32)
    got = tsampling.nearest_sample(torch.from_numpy(tex), torch.from_numpy(u),
                                   torch.from_numpy(v), 6, 4).numpy()
    want = np.asarray(jsampling.nearest_sample(jnp.asarray(tex), u, v, 6, 4))
    np.testing.assert_array_equal(got, want)
    assert float(tsampling.nearest_sample(
        torch.from_numpy(tex[..., 0]), torch.tensor(0.26), torch.tensor(0.6),
        6, 4)) == tex[2, 1, 0]


# --- raycast helpers -------------------------------------------------------


def test_transform_matrices_match_lif_tpu(rng):
    rot = lif_tpu.orbit_pose([0.0, 0.0, -1.0], 1.0, 0.2, 0.1)[1]
    skew1, skew2 = (0.03, -0.02), (0.01, 0.04)
    got = traycast.build_skr1(np.asarray(skew1, np.float32),
                              np.asarray(rot, np.float32)).numpy()
    want = jraycast.build_skr1(jnp.asarray(skew1, jnp.float32),
                               jnp.asarray(rot, jnp.float32))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    for rot2 in (None, rot):
        got = traycast.build_fskr2(998.4, 1280.0, 800.0,
                                   np.asarray(skew2, np.float32),
                                   None if rot2 is None else
                                   np.asarray(rot2, np.float32)).numpy()
        want = jraycast.build_fskr2(
            jnp.float32(998.4), 1280.0, 800.0, jnp.asarray(skew2),
            None if rot2 is None else jnp.asarray(rot2, jnp.float32))
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_compose_and_blend_match_lif_tpu(rng):
    layers = rng.random((3, 6, 5, 4)).astype(np.float32)
    bg = np.asarray([0.2, 0.4, 0.1, 0.7], np.float32)
    for n in (1, 3):
        rgb_t, a_t = traycast.compose_layers(torch.from_numpy(layers), n)
        rgb_j, a_j = jraycast.compose_layers(jnp.asarray(layers), n)
        np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j),
                                   atol=1e-6)
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-6)
        out_t = traycast.blend_background(rgb_t, a_t, bg)
        out_j = jraycast.blend_background(rgb_j, a_j, jnp.asarray(bg))
        for got, want in zip(out_t, out_j):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6)


@pytest.mark.parametrize("rows", [(0, 8), (8, 16), (24, 32), (5, 19)])
def test_render_mono_row_band_is_the_frame_rows(rng, rows):
    """render_mono's (full_h, row_start) band equals those rows of the
    full frame bit for bit, and lif_tpu's band within 1e-5."""
    jp, tp = _pair(rng, layers=2)
    lo, hi = rows
    common = (tp.layer_res, tp.invz_min, tp.invz_max, tp.focal, tp.skew,
              np.asarray([0.03, 0.01, 0.02], np.float32),
              np.eye(3, dtype=np.float32))
    kw = dict(out_w=48, num_layers=2, mask_mode="multiply")
    full = traycast.render_mono(tp.rgb, tp.disp, tp.mask, *common, 37.44,
                                np.zeros(2, np.float32), np.zeros(4), out_h=32,
                                **kw)
    band = traycast.render_mono(tp.rgb, tp.disp, tp.mask, *common, 37.44,
                                np.zeros(2, np.float32), np.zeros(4),
                                out_h=hi - lo, full_h=32, row_start=lo, **kw)
    assert torch.equal(band, full[lo:hi])
    want = jraycast.render_mono(
        *map(jnp.asarray, (jp.rgb, jp.disp, jp.mask)),
        *map(jnp.asarray, common), jnp.float32(37.44), jnp.zeros(2),
        jnp.zeros(4), out_h=hi - lo, full_h=32, row_start=lo, **kw)
    assert np.abs(band.numpy() - np.asarray(want)).max() <= 1e-5


@pytest.mark.parametrize("family", ["dolly", "zoom", "general"])
def test_render_scaled_dispatch_matches_lif_tpu(rng, family):
    """render_scaled on CPU tensors is the plain twin, and lif_tpu's
    render_scaled (its XLA twin on the CPU) within the twin's gates."""
    rgb, disp, mask, f1, fr, c1, pa, pb, grid, k = _setup(rng, family)
    tex = _t(rgb, disp, mask)
    bg = np.asarray([0.1, 0.2, 0.3, 1.0], np.float32)
    got = tss.render_scaled(*tex, IZMIN, IZMAX, c1, f1, fr, grid, bg, pb, k,
                            refine=2)
    plain = tss.render_scaled_plain(*tex, IZMIN, IZMAX, c1, f1, fr, grid, bg,
                                    pb, k, refine=2)
    assert torch.equal(got, plain)
    ref = jss.render_scaled(rgb, disp, mask, IZMIN, IZMAX,
                            jnp.asarray(c1, jnp.float32), f1, fr, grid,
                            jnp.asarray(bg), pa, k, refine=2)
    _color_bounds(ref, got.numpy())
    f_t, v_t = tss.render_scaled(*tex, IZMIN, IZMAX, c1, f1, fr, grid, None,
                                 pb, k, depth_only=True)
    f_j, v_j = jss.render_scaled(rgb, disp, mask, IZMIN, IZMAX,
                                 jnp.asarray(c1, jnp.float32), f1, fr, grid,
                                 jnp.zeros(4), pa, k, depth_only=True)
    _depth_bounds(f_j, v_j, f_t.numpy(), v_t.numpy())


# --- debug -----------------------------------------------------------------


def test_dump_render_inputs_matches_lif_tpu(rng):
    jp, tp = _pair(rng, layers=2, baseline=0.05, skew=(0.01, 0.0))
    jc, tc = _cam_pair(48, 32, position=(0.1, 0.0, 0.0), skew=(0.0, 0.02))
    got = tdebug.dump_render_inputs(tp, tc)
    assert got == jdebug.dump_render_inputs(jp, jc)
    np.testing.assert_allclose(
        got["projector"]["uViewPosition (camera-local, Z-negated)"],
        [-0.1, 0, 0], atol=1e-7)


def test_montage_depth_and_wireframe_match_lif_tpu(rng, tmp_path):
    """texture_montage equals lif_tpu's, and its PNG (the port's
    encode_png) decodes to the pixels of lif_tpu's PNG (PIL); the depth
    view and the wireframe equal lif_tpu's."""
    jp, tp = _pair(rng, layers=2, baseline=0.05)
    got = tdebug.texture_montage(tp, str(tmp_path / "t.png"))
    want = jdebug.texture_montage(jp, str(tmp_path / "j.png"))
    assert got.shape == (64, 144, 3)
    np.testing.assert_array_equal(got, want)
    png_t = decode_image((tmp_path / "t.png").read_bytes())
    png_j = decode_image((tmp_path / "j.png").read_bytes())
    np.testing.assert_array_equal(png_t, png_j)
    for layer in (0, 1):
        np.testing.assert_array_equal(tdebug.depth_visualization(tp, layer),
                                      jdebug.depth_visualization(jp, layer))
    wt, wj = (tdebug.frustum_wireframe_points(p) for p in (tp, jp))
    np.testing.assert_array_equal(wt["corners"], wj["corners"])
    assert wt["edges"] == wj["edges"] and wt["apex_rays"] == wj["apex_rays"]
    np.testing.assert_array_equal(wt["origin"], wj["origin"])
    np.testing.assert_allclose(wt["corners"][:4, 2], -0.025, atol=1e-6)


# --- profiling -------------------------------------------------------------


def test_fps_counter_matches_lif_tpu():
    stamps = 100.0 + np.cumsum(np.r_[0.0, np.full(30, 0.1), [0.02, 0.7]])
    for window in (0.5, 10.0):
        tc = tprofiling.FpsCounter(window_seconds=window)
        jc = jprofiling.FpsCounter(window_seconds=window)
        assert [tc.tick(t) for t in stamps] == [jc.tick(t) for t in stamps]
    fps = tprofiling.FpsCounter(window_seconds=10.0)
    assert abs([fps.tick(100.0 + i * 0.1) for i in range(11)][-1]
               - 10.0) < 0.5


def test_trace_writes_a_timeline(tmp_path):
    with tprofiling.trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert doc["traceEvents"]
    assert any("matmul" in e.key for e in prof.key_averages())


def test_benchmark_fn_needs_a_card(monkeypatch):
    """A CPU timing is never a device number: benchmark_fn raises where
    torch sees no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tprofiling.benchmark_fn(lambda: None)
