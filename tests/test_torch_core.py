"""Parity of the port's host math, helpers and exact ray march with
lif_tpu (CPU).

Pose, camera, config and projector arrays are host numpy in both
packages and must match exactly; the float32 helpers to 1e-6; the exact
march (a 40-step float32 loop in both) to >= 60 dB, and to >= 40 dB
against the independent float64 reference renderer, as
tests/test_raycast.py holds lif_tpu.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lif_tpu
from lif_tpu.config import RenderConfig as JaxRenderConfig
from lif_tpu.core import pose as jpose
from lif_tpu.ops import composite as jcomp
from lif_tpu.ops import raycast as jraycast
from lif_tpu.ops import sampling as jsampling
import lif_tpu_torch
from lif_tpu_torch.core import pose as tpose
from lif_tpu_torch.core.color import linear_to_srgb
from lif_tpu_torch.ops import composite as tcomp
from lif_tpu_torch.ops import raycast as traycast
from lif_tpu_torch.ops import sampling as tsampling

from . import reference_renderer as ref
from .scenes import layers_to_arrays, make_layer

torch.set_num_threads(1)


def test_config_is_a_copy():
    assert dataclasses.asdict(JaxRenderConfig()) == dataclasses.asdict(
        lif_tpu_torch.RenderConfig()
    )
    assert lif_tpu_torch.DEFAULT_CONFIG == lif_tpu_torch.RenderConfig()


def test_pose_math_equal(rng):
    """relative_view_pose and orbit_pose: float64 host math, identical."""
    for _ in range(5):
        vp, cp = rng.normal(size=3), rng.normal(size=3)
        _, vr = jpose.orbit_pose(rng.normal(size=3), 1.0, rng.uniform(-1, 1))
        _, cr = jpose.orbit_pose(rng.normal(size=3), 2.0, rng.uniform(-1, 1),
                                 rng.uniform(-0.5, 0.5))
        a = jpose.relative_view_pose(vp, vr, cp, cr)
        b = tpose.relative_view_pose(vp, vr, cp, cr)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for theta, phi in ((0.0, 0.0), (0.3, -0.2), (-1.1, 0.7)):
        a = jpose.orbit_pose([0.1, 0.2, -1.5], 1.3, theta, phi)
        b = lif_tpu_torch.orbit_pose([0.1, 0.2, -1.5], 1.3, theta, phi)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kw", [
    dict(focal_px=998.4, position=[0.135, 0.0, 0.0]),
    dict(fov_y_degrees=47.0, rotation=np.eye(3) * 1.0, skew=(0.01, -0.02)),
])
def test_camera_create_equal(kw):
    a = lif_tpu.Camera.create(1280, 800, **kw)
    b = lif_tpu_torch.Camera.create(1280, 800, **kw)
    for f in ("position", "rotation", "focal_px", "skew"):
        x, y = np.asarray(getattr(a, f)), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.width, a.height) == (b.width, b.height)


def test_projector_arrays_and_reference_carry(rng):
    """projector_from_arrays builds lif_tpu's arrays; projector_from_reference
    carries a lif_tpu.Projector across unchanged."""
    l0 = make_layer(rng, 24, 32, with_mask=True)
    l1 = make_layer(rng, 28, 36, invz_min=1.0, invz_max=0.3)
    kw = dict(focal_px=l0["focal"], invz_min=2.0, invz_max=0.2,
              baseline=0.045, skew=(0.01, 0.0), position=(0.1, 0.0, 0.0),
              extra_layers=[dict(rgb=l1["rgb"], disp=l1["disp"],
                                 focal_px=l1["focal"], invz_min=1.0,
                                 invz_max=0.3)])
    args = (l0["rgb"], l0["disp"], l0["mask"])
    a = lif_tpu.projector_from_arrays(*args, **kw)
    b = lif_tpu_torch.projector_from_arrays(*args, **kw, device="cpu")
    c = lif_tpu_torch.projector_from_reference(a, device="cpu")
    for p in (b, c):
        for f in ("rgb", "disp", "mask", "layer_res", "invz_min", "invz_max",
                  "focal", "skew", "position", "rotation", "baseline"):
            x, y = np.asarray(getattr(a, f)), getattr(p, f)
            y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
            assert np.array_equal(x, y), f
        assert (p.num_layers, p.width, p.height) == (2, 32, 24)
        assert p.to("cpu").disp.device.type == "cpu"


def test_color_composite_and_sampling_match(rng):
    """The float32 helpers agree with lif_tpu's to 1e-6."""
    x = rng.uniform(-0.01, 1.2, size=(64, 3)).astype(np.float32)
    assert np.abs(
        np.asarray(lif_tpu.core.color.linear_to_srgb(jnp.asarray(x)))
        - linear_to_srgb(torch.from_numpy(x)).numpy()
    ).max() < 1e-6

    found = (rng.random((20, 30)) > 0.3).astype(np.float32)
    u = rng.uniform(-0.1, 1.1, (20, 30)).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, (20, 30)).astype(np.float32)
    m = rng.uniform(0, 1, (20, 30)).astype(np.float32)
    for mode in ("none", "multiply", "hard"):
        ja = jcomp.edge_alpha(*map(jnp.asarray, (found, u, v)), 0.1,
                              jnp.asarray(m), mode)
        ta = tcomp.edge_alpha(*map(torch.from_numpy, (found, u, v)), 0.1,
                              torch.from_numpy(m), mode)
        for p, q in zip(ja, ta):
            assert np.abs(np.asarray(p) - q.numpy()).max() < 1e-6, mode
    rgb = rng.random((20, 30, 3), dtype=np.float32)
    bg = np.asarray([0.2, 0.3, 0.4, 0.7], np.float32)
    for srgb in (False, True):
        a = jcomp.finish_over_background(jnp.asarray(rgb), jnp.asarray(m),
                                         jnp.asarray(bg), srgb)
        b = tcomp.finish_over_background(torch.from_numpy(rgb),
                                         torch.from_numpy(m), bg, srgb)
        assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-6

    tex = rng.random((17, 23, 3), dtype=np.float32)
    a = jsampling.bilinear_sample(jnp.asarray(tex), jnp.asarray(u),
                                  jnp.asarray(v), 21.0, 15.0)
    b = tsampling.bilinear_sample(torch.from_numpy(tex), torch.from_numpy(u),
                                  torch.from_numpy(v), 21.0, 15.0)
    assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-6
    a = jsampling.read_disp(jnp.asarray(tex[..., 0]), jnp.asarray(u),
                            jnp.asarray(v), jnp.float32(2.0),
                            jnp.float32(0.1), jnp.float32(21.0),
                            jnp.float32(15.0))
    b = tsampling.read_disp(torch.from_numpy(tex[..., 0].copy()),
                            torch.from_numpy(u), torch.from_numpy(v), 2.0,
                            0.1, 21.0, 15.0)
    assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-6


def _pose(tx=0.0, ty=0.0, tz=0.0, yaw=0.0):
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array([tx, ty, tz]), np.array(
        [[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]
    )


@pytest.mark.parametrize("case", ["lateral", "rotated_ldi", "skewed"])
def test_render_mono_matches_both_references(rng, case):
    """The exact march: >= 40 dB against the float64 reference renderer,
    >= 60 dB against lif_tpu's render_mono."""
    h, w = 40, 56
    skew2 = (0.0, 0.0)
    bg = (0.0, 0.0, 0.0, 0.0)
    mask_mode = "none"
    if case == "lateral":
        layers = [make_layer(rng, h, w)]
        c1, rot1 = _pose(tx=0.2)
    elif case == "rotated_ldi":
        layers = [
            make_layer(rng, h, w, invz_min=3.0, invz_max=1.0, with_mask=True),
            make_layer(rng, h + 8, w + 8, invz_min=1.2, invz_max=0.2),
        ]
        c1, rot1 = _pose(tx=0.1, ty=0.05, tz=-0.1, yaw=0.1)
        bg = (0.2, 0.3, 0.4, 1.0)
        mask_mode = "multiply"
    else:
        layers = [make_layer(rng, h, w)]
        c1, rot1 = _pose(tx=0.1)
        skew2 = (0.05, -0.03)
    f2 = 0.78 * w
    golden = ref.render_mono_reference(
        layers, (0, 0), c1, rot1, f2, skew2, w, h, background=bg,
        feathering=0.1, mask_mode=mask_mode,
    )
    arrs = layers_to_arrays(layers)
    common = (arrs["layer_res"], arrs["invz_min"], arrs["invz_max"],
              arrs["focal"], np.zeros(2, np.float32),
              np.asarray(c1, np.float32), np.asarray(rot1, np.float32))
    kw = dict(out_w=w, out_h=h, num_layers=len(layers), mask_mode=mask_mode)
    jax_img = np.asarray(jraycast.render_mono(
        *map(jnp.asarray, (arrs["rgb"], arrs["disp"], arrs["mask"])),
        *map(jnp.asarray, common), jnp.float32(f2),
        jnp.asarray(skew2, jnp.float32), jnp.asarray(bg, jnp.float32), **kw,
    ))
    got = traycast.render_mono(
        *map(torch.from_numpy, (arrs["rgb"], arrs["disp"], arrs["mask"])),
        *common, f2, np.asarray(skew2, np.float32), bg, **kw,
    ).numpy()
    assert got.shape == (h, w, 4)
    assert ref.psnr(golden, got) > 40.0
    assert ref.psnr(jax_img, got) > 60.0
