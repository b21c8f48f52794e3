"""The plane-sweep tier (lif_tpu_torch.ops.sweep_fast) and its plane
tables against lif_tpu (CPU).

The same seeded layers go through lif_tpu.ops.sweep_fast (JAX on the CPU)
and lif_tpu_torch.ops.sweep_fast (plain torch on CPU tensors). Gates, max
abs over the RGBA frame (sRGB): 1e-5 where the plane positions are given
(the renderer always gives its table) and for every first-crossing solve
(exact_color, solve_depth_aligned, render_rotated); 2e-3 for the soft
composite on the default uniform planes, which XLA computes with a fused
multiply-add: a plane one float32 step away shifts a bf16 resample weight
across a rounding boundary (2^-8 relative). The tables are equal bit for
bit (lif_tpu's numpy host code).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu.core import pose as jpose
from lif_tpu.models import renderer as jrenderer
from lif_tpu.ops import sweep_fast as jsf
from lif_tpu_torch.models import renderer as trenderer
from lif_tpu_torch.ops import sweep_fast as tsf

from . import reference_renderer as ref
from .scenes import layers_to_arrays, make_layer, smooth_noise

torch.set_num_threads(1)


def _layer(rng, h=48, w=64):
    arrs = layers_to_arrays([make_layer(rng, h, w)])
    return arrs["rgb"][0], arrs["disp"][0], arrs["mask"][0]


def _planes(n=24):
    """A descending, unevenly spaced plane table inside [0.2, 2.0]."""
    return (0.2 + 1.8 * np.linspace(1.0, 0.0, n) ** 1.3).astype(np.float32)


@pytest.mark.parametrize("c1,f2", [([0.2, 0.0, 0.0], 0.78),
                                   ([0.15, -0.05, 0.1], 0.7)])
@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("exact_color", [False, True])
def test_render_sweep_aligned_matches_lif_tpu(rng, c1, f2, tables,
                                              exact_color):
    """render_sweep_aligned, soft and exact_color, on the default uniform
    planes and on a given table, lateral and xyz poses, a zoomed camera
    and an output smaller than the source."""
    rgb, disp, mask = _layer(rng)
    w = disp.shape[1]
    planes = _planes() if tables else None
    kw = dict(out_w=56, out_h=40, num_planes=24 if tables else 32, chunk=3,
              exact_color=exact_color)
    want = np.asarray(jsf.render_sweep_aligned(
        jnp.asarray(rgb), jnp.asarray(disp), jnp.asarray(mask), 2.0, 0.2,
        jnp.asarray(c1, jnp.float32), jnp.float32(f2 * w),
        jnp.zeros(4, jnp.float32), focal1=jnp.float32(0.78 * w),
        plane_invz=None if planes is None else jnp.asarray(planes), **kw))
    got = tsf.render_sweep_aligned(
        torch.tensor(rgb), torch.tensor(disp), torch.tensor(mask), 2.0, 0.2,
        np.float32(c1), f2 * w, np.zeros(4, np.float32), focal1=0.78 * w,
        plane_invz=None if planes is None else torch.tensor(planes), **kw)
    assert got.shape == want.shape == (40, 56, 4)
    tol = 2e-3 if not (tables or exact_color) else 1e-5
    assert np.abs(got.numpy() - want).max() < tol
    assert want[..., 3].mean() > 0.5


def test_sweep_aligned_matches_the_march(rng):
    """The port's sweep against the float64 reference march (lif_tpu's own
    gate, tests/test_sweep_fast.py::test_matches_march_translation)."""
    h, w = 48, 64
    layer = make_layer(rng, h, w)
    arrs = layers_to_arrays([layer])
    for c1 in ([0.2, 0, 0], [0, 0.2, 0], [0, 0, 0.2], [0.15, -0.05, 0.1]):
        golden = ref.render_mono_reference(
            [layer], (0, 0), c1, np.eye(3), 0.78 * w, (0, 0), w, h)
        img = tsf.render_sweep_aligned(
            *(torch.tensor(arrs[k][0]) for k in ("rgb", "disp", "mask")),
            2.0, 0.2, np.float32(c1), 0.78 * w, np.zeros(4, np.float32),
            out_w=w, out_h=h, focal1=0.78 * w, num_planes=80)
        assert ref.psnr(golden, img.numpy()) > 40.0, c1


@pytest.mark.parametrize("case", ["scene", "flat"])
def test_solve_depth_aligned_matches_lif_tpu(rng, case):
    """solve_depth_aligned equals lif_tpu's (max abs < 1e-5, the same found
    pixels); on a flat disparity the solved invZ* is the decoded surface
    (tests/test_sweep_fast.py::test_solve_depth_aligned, rtol 2e-3)."""
    h, w = 32, 48
    disp = (np.full((h, w), 0.25, np.float32) if case == "flat"
            else _layer(rng, h, w)[1])
    c1 = np.float32([0.1, 0.0, 0.0] if case == "flat" else [0.1, 0.02, 0.05])
    kw = dict(out_w=w, out_h=h, num_planes=64, chunk=5)
    want = np.asarray(jsf.solve_depth_aligned(
        jnp.asarray(disp), 2.0, 0.2, jnp.asarray(c1), jnp.float32(0.78 * w),
        **kw))
    got = tsf.solve_depth_aligned(torch.tensor(disp), 2.0, 0.2, c1,
                                  0.78 * w, **kw).numpy()
    assert np.array_equal(got > 0, want > 0)
    assert np.abs(got - want).max() < 1e-5
    if case == "flat":
        np.testing.assert_allclose(got[4:-4, 4:-4], 0.2 + 1.8 * 0.25,
                                   rtol=2e-3)
    else:
        assert (want > 0).mean() > 0.9


@pytest.mark.parametrize("theta,phi,radius", [(0.12, 0.05, 0.8),
                                              (-0.2, 0.0, 1.0),
                                              (0.05, -0.1, 0.6)])
def test_render_rotated_matches_lif_tpu(rng, theta, phi, radius):
    """render_rotated (phase A at the 1.35-widened FOV, phase B's two
    fetches) equals lif_tpu's (max abs < 1e-5) and holds lif_tpu's gate
    against the float64 march (> 40 dB at 80 planes,
    tests/test_sweep_fast.py::test_rotated_matches_march) where the orbit
    stays near the axis."""
    h, w = 48, 64
    layer = make_layer(rng, h, w)
    arrs = layers_to_arrays([layer])
    pos, rot = jpose.orbit_pose([0, 0, -radius], radius, theta=theta,
                                phi=phi)
    c1, rot1 = jpose.relative_view_pose(np.zeros(3), np.eye(3), pos, rot)
    want = np.asarray(jsf.render_rotated(
        *(jnp.asarray(arrs[k][0]) for k in ("rgb", "disp", "mask")),
        2.0, 0.2, jnp.asarray(c1, jnp.float32), jnp.asarray(rot1, jnp.float32),
        jnp.float32(0.78 * w), jnp.zeros(4, jnp.float32), out_w=w, out_h=h,
        focal1=jnp.float32(0.78 * w), num_planes=80, chunk=6))
    got = tsf.render_rotated(
        *(torch.tensor(arrs[k][0]) for k in ("rgb", "disp", "mask")),
        2.0, 0.2, c1, rot1, 0.78 * w, np.zeros(4, np.float32), out_w=w,
        out_h=h, focal1=0.78 * w, num_planes=80, chunk=6).numpy()
    assert np.abs(got - want).max() < 1e-5
    assert want[..., 3].mean() > 0.5
    if radius == 0.8:
        golden = ref.render_mono_reference([layer], (0, 0), c1, rot1,
                                           0.78 * w, (0, 0), w, h)
        assert ref.psnr(golden, got) > 40.0


@pytest.mark.parametrize("mode", ["uniform", "hybrid"])
@pytest.mark.parametrize("num_planes", [7, 12, 40])
def test_plane_table_bit_equal(rng, mode, num_planes):
    """_plane_table is lif_tpu's host numpy: equal bit for bit, on a
    disparity with a flat region (the hybrid table's dedupe)."""
    disp = smooth_noise(rng, 40, 56).astype(np.float32)
    disp[5:20, 10:30] = 0.5
    args = (disp, 2.0 / 0.045, 0.0001 / 0.045, num_planes)
    want = jrenderer._plane_table(*args, mode=mode)
    got = trenderer._plane_table(*args, mode=mode)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert (np.diff(got) < 0).all()


def _ldi_pair(rng, h=32, w=48):
    back = make_layer(rng, h + 8, w + 16, invz_min=0.5, invz_max=0.1)
    jp = lif_tpu.projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32),
        smooth_noise(rng, h, w).astype(np.float32),
        focal_px=0.78 * w, invz_min=2.0, invz_max=0.6, baseline=0.5,
        extra_layers=[dict(rgb=back["rgb"], disp=back["disp"],
                           focal_px=0.7 * w, invz_min=0.5, invz_max=0.1)],
    )
    return jp, lif_tpu_torch.projector_from_reference(jp, device="cpu")


def test_sweep_tables_equal_lif_tpus_prepared_tables(rng):
    """The renderer's per-layer hybrid tables (_sweep_tables, from each
    layer's logical extent and baseline-normalized range) equal lif_tpu's
    _prepared_fast tables bit for bit, on an LDI with an outpainted back
    layer; a repeat call is a cache hit."""
    jp, tp = _ldi_pair(rng)
    tex = trenderer._prepared_textures(tp)
    got = trenderer._sweep_tables(tp, tex, 40)
    want = [lay["plane_invz"] for lay in
            jrenderer._prepared_fast(jp, 40, plane_mode="hybrid")["layers"]]
    assert len(got) == len(want) == 2
    for g, w_ in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w_))
    assert trenderer._sweep_tables(tp, tex, 40) is got


def test_sweep_table_cache_tracks_in_place_writes(rng):
    """The plane-table cache keys on the disparity's identity and version
    counter: an in-place write (a fit writing into the same tensor)
    rebuilds the tables from the new values, equal to lif_tpu's tables of
    the written disparity, and renders follow it."""
    jp, tp = _ldi_pair(rng)
    cam = lif_tpu_torch.Camera.create(48, 32, focal_px=0.78 * 48,
                                      position=[0.02, 0.01, 0.0])
    before = trenderer._sweep_tables(tp, trenderer._prepared_textures(tp),
                                     40)
    img = lif_tpu_torch.render_fast_batch(tp, [cam], method="sweep")
    with torch.no_grad():
        tp.disp.mul_(0.5)
    after = trenderer._sweep_tables(tp, trenderer._prepared_textures(tp), 40)
    assert after is not before
    jp2 = lif_tpu.projector_from_arrays(
        np.asarray(jp.rgb[0, :32, :48]), np.asarray(jp.disp[0, :32, :48]) * 0.5,
        focal_px=0.78 * 48, invz_min=2.0, invz_max=0.6, baseline=0.5)
    want = jrenderer._prepared_fast(jp2, 40, plane_mode="hybrid")
    assert np.array_equal(after[0].numpy(),
                          np.asarray(want["layers"][0]["plane_invz"]))
    assert not np.array_equal(after[0].numpy(), before[0].numpy())
    again = lif_tpu_torch.render_fast_batch(tp, [cam], method="sweep")
    assert (again - img).abs().max().item() > 1e-3
