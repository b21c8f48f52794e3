"""The port's loaders, scene containers and viewer against lif_tpu's (CPU).

The same LIF bytes (authored with PNG payloads, or JPEG ones that both
packages decode through PIL) go through lif_tpu.load_lif_file and
lif_tpu_torch.load_lif_file(device="cpu"). Gates: texture arrays and
host fields equal exactly, orbit_center within 1e-12;
resample_projector within 1e-5 of lif_tpu's jax.image.resize at scales
0.5, 1.5 and 3.0 (measured up to 1.6e-6 on [0, 1] textures: float32
rounding of the two filters' weights, border columns included); renders
through the fast path held to the kernel-vs-twin gate of
tests/test_torch_render.py (max abs < 3e-5 in linear light).
"""

import io

import numpy as np
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu.apps import viewer as jviewer
from lif_tpu.models import scene as jscene
from lif_tpu_torch.apps import viewer
from lif_tpu_torch.io import container, decode
from lif_tpu_torch.models import scene

from .scenes import smooth_noise

torch.set_num_threads(1)

_TEX = ("rgb", "disp", "mask")
_HOST = ("layer_res", "invz_min", "invz_max", "focal", "skew", "position",
         "rotation", "baseline")


def _png(arr01):
    """PNG bytes of a top-down [0, 1] image (encode_png flips GL rows)."""
    return decode.encode_png(np.asarray(arr01)[::-1])


def _jpeg(arr01):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((np.clip(arr01, 0, 1) * 255).astype(np.uint8)).save(
        buf, format="JPEG")
    return buf.getvalue()


def make_lif(rng, w=32, h=24, layers=0, stereo_data=None, baseline_mm=63.0,
             fmt="PNG", skew=None, outer=True, legacy_ldi=False,
             rotation=(0.02, -0.01, 0.03)):
    """A LIF file in the shape of tests/test_api.py::_make_lif, with PNG
    (or JPEG) colour payloads: one view, optionally `layers` LDI layers
    with masks (legacy_ldi: lif_tpu's layered_depth_image_data form with
    4 px of outpainting and legacy invZ signs), stereo metadata and
    frustum skew. outer=False stores view 0's image as a field instead
    of the outer image; `rotation` is the view's LIF rotation."""
    enc = _png if fmt == "PNG" else _jpeg
    img = enc(rng.random((h, w, 3)))
    blobs = {20: _png(smooth_noise(rng, h, w))}
    view = {
        "image": {"blob_id": -1 if outer else 29},
        "inv_z_map": {"blob_id": 20, "min": 0.5, "max": 0.01},
        "width_px": w,
        "height_px": h,
        "focal_px": 0.78 * w,
        "position": [0.1, -0.2, 0.05],
        "rotation": list(rotation),
    }
    if not outer:
        blobs[29] = img
    if skew is not None:
        view["frustum_skew"] = skew
    lays = []
    for i in range(layers):
        lw, lh = (w + 4, h + 4) if legacy_ldi else (w, h)
        img_id, dep_id, mask_id = 30 + 3 * i, 31 + 3 * i, 32 + 3 * i
        blobs[img_id] = enc(rng.random((lh, lw, 3)))
        blobs[dep_id] = _png(smooth_noise(rng, lh, lw))
        blobs[mask_id] = _png(
            (smooth_noise(rng, lh, lw) > 0.3).astype(np.float32))
        lays.append({
            "image": {"blob_id": img_id},
            "inv_z_map": {"blob_id": dep_id,
                          "min": (-0.39 if legacy_ldi else 0.5) / (i + 1),
                          "max": -0.0078 if legacy_ldi else 0.01},
            "mask": {"blob_id": mask_id},
        })
    if legacy_ldi:
        view["camera_data"] = {"focal_ratio_to_width": 0.78}
        view["layered_depth_image_data"] = {
            "outpainting_added_width_px": 4,
            "outpainting_added_height_px": 4,
            "layers_top_to_bottom": lays,
        }
    elif lays:
        view["layers_top_to_bottom"] = lays
    meta = {"views": [view], "baseline_mm": baseline_mm}
    if stereo_data:
        meta["stereo_render_data"] = stereo_data
    return container.write(img if outer else _png(rng.random((4, 4, 3))),
                           meta, blobs)


def assert_same_projector(tp, jp):
    """Textures and host fields equal exactly."""
    for f in _TEX:
        assert np.array_equal(getattr(tp, f).cpu().numpy(),
                              np.asarray(getattr(jp, f))), f
    for f in _HOST:
        a, b = np.asarray(getattr(tp, f)), np.asarray(getattr(jp, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (tp.num_layers, tp.width, tp.height) == (jp.num_layers, jp.width,
                                                    jp.height)


_FILES = {
    "single": dict(),
    "single_jpeg": dict(fmt="JPEG"),
    "ldi": dict(layers=2, outer=False),
    "legacy_ldi": dict(layers=3, legacy_ldi=True),
    "stereo_meta": dict(stereo_data={"invd": 0.2,
                                     "frustum_skew": {"x": 0.01, "y": 0}},
                        skew=[0.02, -0.01], baseline_mm=45.0),
    "stereo_skew_dict": dict(stereo_data={"inv_convergence_distance": 0.1},
                             skew={"x": -0.015, "y": 0.004}),
}


@pytest.mark.parametrize("kind", sorted(_FILES))
def test_load_lif_file_equals_lif_tpu(rng, kind):
    """load_lif_file on single-view (PNG and JPEG payloads), LDI, legacy
    outpainted LDI and stereo-metadata files: every projector equal to
    lif_tpu's, orbit_center within 1e-12, the same baseline and stereo
    data."""
    data = make_lif(rng, **_FILES[kind])
    got = lif_tpu_torch.load_lif_file(data, device="cpu")
    ref = lif_tpu.load_lif_file(data)
    assert len(got.projectors) == len(ref.projectors) == 1
    for tp, jp in zip(got.projectors, ref.projectors):
        assert tp.disp.device.type == "cpu"
        assert_same_projector(tp, jp)
    assert got.baseline_meters == ref.baseline_meters
    assert got.stereo_render_data == ref.stereo_render_data
    if ref.orbit_center is None:
        assert got.orbit_center is None
    else:
        np.testing.assert_allclose(got.orbit_center, ref.orbit_center,
                                   rtol=0, atol=1e-12)
    if kind == "legacy_ldi":
        p = got.projectors[0]
        assert p.num_layers == 3 and tuple(p.layer_res[0]) == (36.0, 28.0)


def test_load_sources_and_orbit_center(rng, tmp_path):
    """A path, bytes or a file object load the same; the orbit centre of
    tests/test_api.py:85-90 (baseline/invd down -Z)."""
    data = make_lif(rng, stereo_data={"invd": 0.2,
                                      "frustum_skew": {"x": 0, "y": 0}})
    path = tmp_path / "scene.lif"
    path.write_bytes(data)
    a = lif_tpu_torch.load_lif_file(str(path), device="cpu")
    with open(path, "rb") as f:
        b = lif_tpu_torch.load_lif_file(f, device="cpu")
    for res in (a, b):
        assert torch.equal(res.projectors[0].disp,
                           lif_tpu_torch.load_lif_file(
                               data, device="cpu").projectors[0].disp)
    p = a.projectors[0]
    local = np.asarray(p.rotation, np.float64) @ np.array([0, 0, -0.315])
    np.testing.assert_allclose(a.orbit_center - np.asarray(p.position),
                               local, atol=1e-6)


def test_lif_loader_class(rng):
    """tests/test_api.py:93-99."""
    loader = lif_tpu_torch.LifLoader()
    meta = loader.load(make_lif(rng, stereo_data={"invd": 0.1}))
    assert loader.get_views() is meta["views"]
    assert loader.get_stereo_render_data() == {"invd": 0.1}
    for get in ("get_views", "get_stereo_render_data", "get_animations"):
        with pytest.raises(RuntimeError):
            getattr(lif_tpu_torch.LifLoader(), get)()


def test_pose_helpers_equal_lif_tpu():
    """The LIF rotation encodings (array, slant/roll dict, x/y/roll dict,
    +Z-facing) and the quaternion helpers equal lif_tpu's exactly."""
    from lif_tpu.core import pose as jpose
    from lif_tpu_torch.core import pose as tpose

    for rot in ([0.1, -0.2, 0.3], [0.0, 0.0, 0.0],
                {"rotation_slant": {"x": 0.05, "y": -0.1},
                 "roll_degrees": 3.0},
                {"x": 0.2, "y": 0.1, "roll": -0.05}):
        for fn in ("lif_rotation_to_quaternion", "lif_rotation_to_matrix"):
            assert np.array_equal(getattr(tpose, fn)(rot),
                                  getattr(jpose, fn)(rot))
    q = tpose.quat_from_axis_angle([1.0, 2.0, -0.5], 0.7)
    assert np.array_equal(q, jpose.quat_from_axis_angle([1.0, 2.0, -0.5],
                                                        0.7))
    assert np.array_equal(tpose.quat_multiply(q, q[::-1]),
                          jpose.quat_multiply(q, q[::-1]))
    assert np.array_equal(tpose.quat_to_matrix(q), jpose.quat_to_matrix(q))


@pytest.mark.parametrize("scale", [0.5, 1.5, 3.0])
def test_resample_projector_matches_lif_tpu(rng, scale):
    """Every layer resampled (antialiased when shrinking) and focal
    scaled, with and without a center crop: within 1e-5 of lif_tpu,
    border rows and columns included; equal host fields."""
    jp = lif_tpu.load_lif_file(make_lif(rng, w=40, h=24, layers=2,
                                        outer=False)).projectors[0]
    tp = lif_tpu_torch.projector_from_reference(jp, device="cpu")
    for crop in ((None, None), (int(36 * scale) // 2 * 2, 20)):
        ref = lif_tpu.resample_projector(jp, scale, *crop)
        got = lif_tpu_torch.resample_projector(tp, scale, *crop,
                                               device="cpu")
        for f in _TEX:
            a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
            assert a.shape == b.shape
            assert np.abs(a - b).max() < 1e-5, f
        for f in _HOST:
            assert np.array_equal(np.asarray(getattr(got, f)),
                                  np.asarray(getattr(ref, f))), f


def test_entry_points_default_to_the_card(rng):
    """load_lif_file, projector_from_lif_view and resample_projector build
    their textures on CUDA unless given `device`; where torch sees no card
    they raise (torch's own error: no CPU fallback). render_fast_view and
    render_depth_fast return on the projector's device."""
    from lif_tpu_torch.io import schema

    data = make_lif(rng)
    view = schema.load_meta(container.parse(data))["views"][0]
    cpu = lif_tpu_torch.load_lif_file(data, device="cpu").projectors[0]
    for build in (
        lambda: lif_tpu_torch.load_lif_file(data),
        lambda: lif_tpu_torch.projector_from_lif_view(view),
        lambda: lif_tpu_torch.resample_projector(cpu, 0.5),
    ):
        if torch.cuda.is_available():
            assert build().disp.device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                build()
    assert lif_tpu_torch.projector_from_lif_view(
        view, device="cpu").disp.device.type == "cpu"
    cam = lif_tpu_torch.Camera.create(cpu.width, cpu.height,
                                      focal_px=float(cpu.focal[0]),
                                      position=np.asarray(cpu.position)
                                      + cpu.rotation @ [0.01, 0, 0],
                                      rotation=cpu.rotation)
    assert lif_tpu_torch.render_fast_view(cpu, cam).device.type == "cpu"
    assert lif_tpu_torch.render_depth_fast(cpu, cam).device.type == "cpu"


def test_layer_group_and_scene(rng):
    """tests/test_api.py:133-153: auto mode by layer count, stats equal
    lif_tpu's, renders through render(); Scene renders its projectors."""
    data = make_lif(rng, layers=2, outer=False)
    jp = lif_tpu.load_lif_file(data).projectors[0]
    tp = lif_tpu_torch.load_lif_file(data, device="cpu").projectors[0]
    single = lif_tpu_torch.projector_from_arrays(
        rng.random((24, 32, 3)), smooth_noise(rng, 24, 32), focal_px=0.78 * 32,
        invz_min=2.0, invz_max=0.2, baseline=1.0, device="cpu")
    assert scene.LayerGroup(single).render_mode == "mesh"
    group = scene.LayerGroup(tp)
    assert group.render_mode == "raycast"
    assert group.get_stats() == jscene.LayerGroup(jp).get_stats()
    group.set_gradient_threshold(0.5)
    assert group.gradient_threshold == 0.5
    assert group.toggle_depth_visualization() is True
    cam = lif_tpu_torch.Camera.create(32, 24, focal_px=0.78 * 32,
                                      position=tp.position)
    img = group.render(cam, num_steps=8)
    assert img.shape == (24, 32, 4) and bool(torch.isfinite(img).all())
    group.set_render_mode("mesh")
    assert group.render(cam).shape == (24, 32, 4)
    sc = scene.Scene()
    sc.add(tp)
    assert torch.equal(sc.render(cam, num_steps=8),
                       lif_tpu_torch.render(tp, cam, num_steps=8))


def test_viewer_trajectories_equal_lif_tpu():
    """orbit_trajectory and linear_trajectory equal lif_tpu's
    (tests/test_apps.py:33-46)."""
    for args in (([0, 0, -2.0], 2.0, 5), ([0.1, 0, -1.0], 1.0, 4, 10.0, 0.1)):
        for a, b in zip(viewer.orbit_trajectory(*args),
                        jviewer.orbit_trajectory(*args)):
            assert np.array_equal(a, b)
    pos, rot = viewer.orbit_trajectory([0, 0, -2.0], 2.0, 5, sweep_degrees=20)
    np.testing.assert_allclose(pos[2], [0, 0, 0], atol=1e-9)
    np.testing.assert_allclose(rot[2], np.eye(3), atol=1e-9)
    for target in (None, [0, 0, -3.0]):
        for a, b in zip(viewer.linear_trajectory([0, 0, 0], [1, 0, 0], 3,
                                                 target),
                        jviewer.linear_trajectory([0, 0, 0], [1, 0, 0], 3,
                                                  target)):
            assert np.array_equal(a, b)


def test_render_trajectory_fast_matches_lif_tpu(rng, tmp_path):
    """mode='fast' renders chunks through render_fast_batch: frames equal
    lif_tpu's in display orientation, to the gate of the tier the orbit
    takes (PSNR >= 60 dB, under 0.1% of pixels off by more than 1e-3),
    and the PNGs written without PIL read back as the frames' quantized
    colour."""
    from PIL import Image

    data = make_lif(rng, w=48, h=32)
    jp = lif_tpu.load_lif_file(data).projectors[0]
    tp = lif_tpu_torch.load_lif_file(data, device="cpu").projectors[0]
    center = np.asarray(tp.position, np.float64) + [0, 0, -1.0]
    pos, rot = viewer.orbit_trajectory(center, 1.0, 5, sweep_degrees=6)
    kw = dict(mode="fast", chunk=2, to_srgb=False)
    got = viewer.render_trajectory(
        tp, pos, rot, lif_tpu_torch.Camera.create(48, 32, focal_px=0.78 * 48),
        out_dir=str(tmp_path), **kw)
    ref = jviewer.render_trajectory(
        jp, pos, rot, lif_tpu.Camera.create(48, 32, focal_px=0.78 * 48), **kw)
    assert got.shape == (5, 32, 48, 4)
    # the rotated tier's gate (tests/test_torch_orbit.py::_assert_close)
    err = np.abs(got - np.asarray(ref))
    assert 10 * np.log10(1.0 / max(float((err[..., :3] ** 2).mean()),
                                   1e-12)) >= 60.0
    assert (err.max(-1) > 1e-3).mean() < 1e-3
    files = sorted(tmp_path.glob("frame_*.png"))
    assert len(files) == 5
    with Image.open(files[1]) as im:
        want = (np.clip(got[1][..., :3], 0, 1) * 255).astype(np.uint8)
        assert np.array_equal(np.asarray(im), want)


def test_viewer_main_on_cpu(rng, tmp_path):
    """The CLI loads a LIF, orbits about its orbit centre on the fast path
    and writes the frames; --render stereo on this one-view LIF raises
    lif_tpu's two-projector ValueError."""
    path = tmp_path / "scene.lif"
    path.write_bytes(make_lif(rng, w=32, h=24,
                              stereo_data={"invd": 0.1}))
    out = tmp_path / "frames"
    assert viewer.main([str(path), "--frames", "3", "--sweep", "4",
                        "--out", str(out), "--device", "cpu"]) == 0
    assert len(list(out.glob("frame_*.png"))) == 3
    with pytest.raises(ValueError, match="stereo mode needs two"):
        viewer.main([str(path), "--render", "stereo", "--frames", "1",
                     "--out", str(out), "--device", "cpu"])


def test_synthesize_projector_matches_lif_tpu(rng):
    """synthesize_projector: the fast render and the solved depth at a
    lateral position, wrapped as a projector there: equal to lif_tpu's
    to the kernel-vs-twin gate (tests/test_fusion.py's construction)."""
    data = make_lif(rng, w=64, h=32, rotation=(0.0, 0.0, 0.0))
    jp = lif_tpu.load_lif_file(data).projectors[0]
    tp = lif_tpu_torch.load_lif_file(data, device="cpu").projectors[0]
    pos = np.asarray(tp.position, np.float64) + [0.004, 0.0, 0.0]
    got = lif_tpu_torch.synthesize_projector(tp, pos)
    ref = lif_tpu.synthesize_projector(jp, pos)
    for f in _TEX:
        assert np.abs(getattr(got, f).numpy()
                      - np.asarray(getattr(ref, f))).max() < 3e-5, f
    for f in _HOST:
        assert np.array_equal(np.asarray(getattr(got, f)),
                              np.asarray(getattr(ref, f))), f
    assert got.disp.device == tp.disp.device
