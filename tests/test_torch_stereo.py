"""The exact stereo path against lif_tpu (CPU): view_weight,
erode_mask_for_stereo, raycast_layer's stereo mode and render_stereo_view.

The same seeded numpy inputs go through lif_tpu (JAX on the CPU, its
rolled march loop) and through lif_tpu_torch (CPU tensors). Gates:
view_weight within 1e-7; the eroded mask equal; raycast_layer within
1e-5 (rgba, invz2) with equal 0/1 confidence; render_stereo_view
tests/test_stereo.py's decisive-pixel rule (fewer than 2% of the pixels
flip between transparent and not) and max abs <= 1e-4 on the rest. The
mono march (the 'multiply' and 'none' modes) is held bit for bit to a
frozen copy of the march before the stereo mode was added.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lif_tpu
import lif_tpu_torch
from lif_tpu.ops import raycast as jraycast
from lif_tpu.ops import stereo as jstereo
from lif_tpu.ops import sweep_march as jsm
from lif_tpu_torch.core.transforms import (inv3, mat_from_focal,
                                           mat_from_skew, mm,
                                           shader_rotation)
from lif_tpu_torch.ops import raycast as traycast
from lif_tpu_torch.ops import stereo as tstereo
from lif_tpu_torch.ops import sweep_march as tsm
from lif_tpu_torch.ops.sampling import bilinear_sample, read_disp

from .scenes import make_layer, smooth_noise

torch.set_num_threads(1)


@pytest.mark.parametrize("c,c1,c2", [
    ([0.0, 0.0, 0.0], [-0.5, 0.0, 0.0], [0.5, 0.0, 0.0]),  # mid: 0.5
    ([-0.5, 0.0, 0.0], [-0.5, 0.0, 0.0], [0.5, 0.0, 0.0]),  # at left: 0
    ([0.5, 0.0, 0.0], [-0.5, 0.0, 0.0], [0.5, 0.0, 0.0]),  # at right: 1
    ([0.3, -0.2, 0.1], [-0.11, 0.02, 0.0], [0.37, -0.05, 0.04]),
    ([0.2, 0.1, 0.0], [0.04, 0.0, 0.0], [0.04, 0.0, 0.0]),  # coincident
])
def test_view_weight_matches_lif_tpu(c, c1, c2):
    """lif_tpu's cases (tests/test_stereo.py:58), an off-axis camera and
    a coincident baseline (weight 0, not NaN), and the same five as one
    batch."""
    ref = float(jstereo.view_weight(jnp.asarray(c, jnp.float32),
                                    jnp.asarray(c1, jnp.float32),
                                    jnp.asarray(c2, jnp.float32)))
    got = tstereo.view_weight(c, c1, c2)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - ref) <= 1e-7
    batch = tstereo.view_weight(np.zeros((3, 3)), np.stack([c1] * 3),
                                np.stack([c2] * 3) + [[0.0, 0, 0], [0.1, 0, 0],
                                                      [0, 0.2, 0]])
    assert batch.shape == (3,) and torch.isfinite(batch).all()


@pytest.mark.parametrize("kind", ["binary", "soft"])
def test_erode_mask_matches_lif_tpu(rng, kind):
    """erode_mask_for_stereo on a binary and a soft mask whose top and
    bottom rows are masked: equal to lif_tpu's (edge-clamped shifts; a
    wrap would carry the masked rows across)."""
    m = smooth_noise(rng, 24, 40, octaves=2)
    m = (m > 0.4).astype(np.float32) if kind == "binary" else m
    m = m.astype(np.float32)
    m[:2] = 0.0
    m[-1] = 0.0
    ref = np.asarray(jsm.erode_mask_for_stereo(jnp.asarray(m)))
    got = tsm.erode_mask_for_stereo(torch.from_numpy(m))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)
    assert (got.numpy()[-3:] <= 0.5).all()  # clamped: the masked edge erodes


def _layer_inputs(rng, h=40, w=56, with_mask=True):
    """One masked layer with a hard near box (its edges kill the march's
    confidence), a skewed rotated source and a skewed camera: (textures,
    FSKR1, c1, FSKR2)."""
    layer = make_layer(rng, h, w, with_mask=with_mask)
    layer["disp"][h // 3 : h // 2, w // 3 : w // 2] = 0.95
    tex = dict(rgb=layer["rgb"].astype(np.float32),
               disp=layer["disp"].astype(np.float32),
               mask=layer["mask"].astype(np.float32))
    rot = lif_tpu.orbit_pose([0, 0, -1], 1.0, 0.04, 0.02)[1]
    fskr1 = mm(mat_from_focal(np.float32(0.78 * w) / np.float32(w),
                              np.float32(0.78 * w) / np.float32(h)),
               mm(mat_from_skew(0.01, -0.02), shader_rotation(rot)))
    fskr2 = mm(mat_from_focal(np.float32(0.8 * w) / np.float32(w),
                              np.float32(0.8 * w) / np.float32(h)),
               mat_from_skew(0.005, 0.0))
    c1 = np.array([0.08, -0.03, 0.05], np.float32)
    return tex, fskr1, c1, fskr2


def _grid(h, w):
    u = (torch.arange(w, dtype=torch.float32) + 0.5) / w
    v = (torch.arange(h, dtype=torch.float32) + 0.5) / h
    return u[None, :].expand(h, w) - 0.5, v[:, None].expand(h, w) - 0.5


@pytest.mark.parametrize("mask_mode", ["dilated_discard", "multiply", "none"])
def test_raycast_layer_matches_lif_tpu(rng, mask_mode):
    """raycast_layer's three outputs in each mask mode against lif_tpu's:
    rgba and invz2 within 1e-5, confidence equal where it is 0 or 1 (the
    stereo mode keeps it on a miss, the mono modes zero it there; the
    'multiply' mode's hit returns its taper, within 1e-5)."""
    h, w = 40, 56
    tex, fskr1, c1, fskr2 = _layer_inputs(rng, h, w)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    ref = jraycast.raycast_layer(
        *(jnp.asarray(a) for a in _grid_np(h, w)), jnp.asarray(fskr1.numpy()),
        jnp.asarray(c1), jnp.asarray(fskr2.numpy()), jnp.zeros(3),
        jnp.asarray(tex["rgb"]), jnp.asarray(tex["disp"]),
        jnp.asarray(tex["mask"]), jnp.float32(2.0), jnp.float32(0.2),
        jnp.float32(w), jnp.float32(h), jnp.asarray(bg), 0.1,
        num_steps=40, mask_mode=mask_mode, unroll=False)
    s2x, s2y = _grid(h, w)
    got = traycast.raycast_layer(
        s2x, s2y, mm(fskr1, inv3(fskr2)), fskr1 @ -torch.from_numpy(c1),
        torch.from_numpy(tex["rgb"]), torch.from_numpy(tex["disp"]),
        torch.from_numpy(tex["mask"]), 2.0, 0.2, float(w), float(h),
        torch.from_numpy(bg), 0.1, num_steps=40, mask_mode=mask_mode)
    rgba, invz2, conf = (np.asarray(a) for a in ref)
    assert np.abs(got[0].numpy() - rgba).max() < 1e-5
    assert np.abs(got[1].numpy() - invz2).max() < 1e-5
    if mask_mode == "multiply":  # a hit's confidence is the taper
        assert np.abs(got[2].numpy() - conf).max() < 1e-5
    else:
        assert np.array_equal(got[2].numpy(), conf)
    hit = rgba[..., 3] > 0
    assert 0.2 < hit.mean() < 1.0 and (conf == 0).any()
    if mask_mode == "dilated_discard":
        assert (conf[~hit] == 1).any()  # a miss keeps its confidence


def _grid_np(h, w):
    return tuple(t.numpy() for t in _grid(h, w))


def _mono_march_before_stereo(s2x, s2y, p, c, rgb, disp, mask, invz_min,
                              invz_max, res_w, res_h, background_rgb,
                              feathering, num_steps, mask_mode):
    """A frozen copy of lif_tpu_torch's raycast_layer as it was before the
    stereo mode, its confidence and its invz2 output were added: the mono
    output must not move."""
    f32 = np.float32
    (p00, p01, p02), (p10, p11, p12), (p20, p21, p22) = p.tolist()
    c_x, c_y, c_z = c.tolist()
    denom = p20 * s2x + p21 * s2y + p22
    qx = (p00 * s2x + p01 * s2y + p02) / denom
    qy = (p10 * s2x + p11 * s2y + p12) / denom
    izmin, izmax = f32(invz_min), f32(invz_max)
    dinvz0 = (izmin - izmax) / f32(num_steps)
    invz = torch.full_like(denom, float(izmin + dinvz0))
    dinvz = torch.full_like(denom, float(dinvz0))
    s1x = c_x * invz + (1.0 - c_z * invz) * qx
    s1y = c_y * invz + (1.0 - c_z * invz) * qy
    ds1x = (c_x - c_z * qx) * dinvz
    ds1y = (c_y - c_z * qy) * dinvz
    invz2 = torch.zeros_like(denom)
    for _ in range(num_steps):
        invz = invz - dinvz
        s1x = s1x - ds1x
        s1y = s1y - ds1y
        disp_v = read_disp(disp, s1x + 0.5, s1y + 0.5, invz_min, invz_max,
                           res_w, res_h)
        invz2 = invz * denom / (1.0 - c_z * invz)
        below = (disp_v > invz) & (invz2 > 0.0)
        invz = torch.where(below, invz + dinvz, invz)
        s1x = torch.where(below, s1x + ds1x, s1x)
        s1y = torch.where(below, s1y + ds1y, s1y)
        dinvz = torch.where(below, dinvz * 0.5, dinvz)
        ds1x = torch.where(below, ds1x * 0.5, ds1x)
        ds1y = torch.where(below, ds1y * 0.5, ds1y)
    hit = ((torch.abs(s1x) < 0.5) & (torch.abs(s1y) < 0.5)
           & (invz2 > 0.0) & (invz > 0.0))
    u1, v1 = s1x + 0.5, s1y + 0.5
    color = bilinear_sample(rgb, u1, v1, res_w, res_h)
    alpha = traycast.taper(u1, v1, feathering)
    if mask_mode == "multiply":
        alpha = alpha * bilinear_sample(mask, u1, v1, res_w, res_h)
    out_rgb = torch.where(hit[..., None], color, background_rgb)
    out_a = torch.where(hit, alpha, 0.0)
    return torch.cat([out_rgb, out_a[..., None]], dim=-1)


@pytest.mark.parametrize("mask_mode", ["multiply", "none"])
def test_mono_march_unchanged(rng, mask_mode):
    """The mono march's rgba equals the frozen copy bit for bit, layer by
    layer, and so does render_mono_view's frame (a 2-layer skewed LDI at a
    rotated, translated pose) against the frozen copy composited the same
    way."""
    h, w = 40, 56
    tex, fskr1, c1, fskr2 = _layer_inputs(rng, h, w)
    s2x, s2y = _grid(h, w)
    args = (s2x, s2y, mm(fskr1, inv3(fskr2)), fskr1 @ -torch.from_numpy(c1),
            torch.from_numpy(tex["rgb"]), torch.from_numpy(tex["disp"]),
            torch.from_numpy(tex["mask"]), 2.0, 0.2, float(w), float(h),
            torch.tensor([0.1, 0.2, 0.3]), 0.1)
    got = traycast.raycast_layer(*args, num_steps=40, mask_mode=mask_mode)[0]
    assert torch.equal(got, _mono_march_before_stereo(
        *args, num_steps=40, mask_mode=mask_mode))


def _stereo_pair(rng, h, w, layers):
    """lif_tpu and port projectors of a masked pair at x = -+0.2 with
    `layers` layers each (tests/test_stereo.py's scenes)."""
    ranges = ((3.0, 1.0), (1.2, 0.3), (0.4, 0.1))[:layers]
    out = []
    for x in (-0.2, 0.2):
        ls = [make_layer(rng, h, w, invz_min=a, invz_max=b, with_mask=True)
              for a, b in ranges]
        jp = lif_tpu.projector_from_arrays(
            ls[0]["rgb"], ls[0]["disp"], ls[0]["mask"], focal_px=0.78 * w,
            invz_min=ranges[0][0], invz_max=ranges[0][1], baseline=1.0,
            position=(x, 0.0, 0.0),
            extra_layers=[dict(rgb=l["rgb"], disp=l["disp"], mask=l["mask"],
                               focal_px=0.78 * w, invz_min=a, invz_max=b)
                          for l, (a, b) in zip(ls[1:], ranges[1:])])
        out.append((jp, lif_tpu_torch.projector_from_reference(
            jp, device="cpu")))
    return out


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("steps", [40, 160])
def test_render_stereo_view_matches_lif_tpu(rng, layers, steps):
    """render_stereo_view on 1- and 3-layer masked pairs at a pose off the
    baseline (tests/test_stereo.py's multilayer pose), against lif_tpu's:
    the decisive-pixel rule, then max abs <= 1e-4; render(mode='stereo')
    is the same call."""
    h, w = 40, 48
    (jl, tl), (jr, tr) = _stereo_pair(rng, h, w, layers)
    kw = dict(position=[0.03, 0.05, 0.1], skew=(0.01, 0.0))
    ref = np.asarray(lif_tpu.render_stereo_view(
        jl, jr, lif_tpu.Camera.create(w, h, focal_px=0.78 * w, **kw),
        num_steps=steps, background=(0.0, 0.0, 0.0, 0.0)))
    cam = lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w, **kw)
    got = lif_tpu_torch.render_stereo_view(
        tl, tr, cam, num_steps=steps, background=(0.0, 0.0, 0.0, 0.0))
    assert got.shape == (h, w, 4)
    assert torch.equal(got, lif_tpu_torch.render(
        [tl, tr], cam, mode="stereo", num_steps=steps,
        background=(0.0, 0.0, 0.0, 0.0)))
    got = got.numpy()
    flips = (ref[..., 3] <= 1e-6) != (got[..., 3] <= 1e-6)
    assert flips.mean() < 0.02
    assert np.abs(got - ref)[~flips].max() <= 1e-4
    assert 0.3 < (got[..., 3] > 0.5).mean()
