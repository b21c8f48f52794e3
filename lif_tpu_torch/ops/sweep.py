"""Soft plane sweep: the differentiable renderer the scene fit trains with.

The counterpart of lif_tpu.ops.sweep. The ray march (ops/raycast.py) is
exact but its surface crossings are discrete decisions, with zero
gradient with respect to the depth map. The plane sweep evaluates a
FIXED set of inverse-depth planes invZ_k (k = 1..K, from invz_min toward
invz_max, the range the march scans): at plane k every output pixel
samples the source at

    s1_k = C.xy * invZ_k + (1 - C.z * invZ_k) * q(s2),

a position field that does not depend on the data. Occupancy per plane is
a soft surface test, composited front to back like a multiplane image:

    o_k = sigmoid((d_k - invZ_k) * sharpness / range)
    w_k = o_k * prod_{j<k} (1 - o_j), weighted by border x taper x mask.

Every step is a differentiable torch op, so autograd carries gradients to
the depth map (through the bilinear reads' texels) and to the pose
(through the sample positions and the 3x3 transforms); in the hard limit
(sharpness -> inf) it converges to the march's front surface.
reference semantics approximated: rayCastMonoLDI.glsl:219-297.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.transforms import inv3, mat_from_focal, mat_from_skew, mm, shader_rotation
from . import composite as _composite
from .raycast import _pixel_grid, taper, target_transform
from .sampling import bilinear_sample, read_disp

__all__ = ["DEFAULT_PLANES", "render_sweep"]

DEFAULT_PLANES = 40  # the march's step count

_F32 = np.float32


def render_sweep(
    rgb,
    disp,
    mask,
    layer_res,
    invz_min,
    invz_max,
    focal,
    skew1,
    c1,
    rot1,
    f2,
    skew2,
    background,
    out_w: int,
    out_h: int,
    num_layers: int,
    num_planes: int = DEFAULT_PLANES,
    sharpness: float = 120.0,
    feathering: float = 0.1,
    to_srgb: bool = True,
    full_w: int | None = None,
    full_h: int | None = None,
    row_start=0,
    col_start=0,
):
    """Soft plane-sweep render (differentiable), lif_tpu's render_sweep.

    Arguments as ops.raycast.render_mono's: rgb (L, Hs, Ws, 3), disp and
    mask (L, Hs, Ws) tensors on the render device (disp may require
    grad); layer_res (L, 2), invz_min/invz_max (L,) baseline-normalized,
    focal (L,), skew1 (2,), f2, skew2 (2,) and background (4,) host
    numbers. c1 (3,) or (B, 3) and rot1 (3, 3) or (B, 3, 3): the
    camera-local projector poses (shader convention), tensors that may
    require grad; a batch broadcasts through every op. `sharpness` is the
    softness of the surface test in units of the inverse-depth range.
    full_w/full_h/row_start/col_start render the (out_h, out_w) tile of a
    larger framebuffer. Returns (out_h, out_w, 4), or (B, out_h, out_w, 4)
    for a batch, on disp's device."""
    dev = disp.device
    s2x, s2y = _pixel_grid(out_w, out_h, dev, full_w=full_w, full_h=full_h,
                           row_start=row_start, col_start=col_start)
    fb_w = float(out_w if full_w is None else full_w)
    fb_h = float(out_h if full_h is None else full_h)
    c1 = torch.as_tensor(c1, dtype=torch.float32, device=dev)
    rot1 = torch.as_tensor(rot1, dtype=torch.float32, device=dev)
    skr1 = mm(mat_from_skew(_F32(skew1[0]), _F32(skew1[1])).to(dev),
              shader_rotation(rot1))
    inv2 = inv3(target_transform(f2, fb_w, fb_h, skew2)).to(dev)
    layer_res = np.asarray(layer_res, np.float32)
    invz_min = np.asarray(invz_min, np.float32)
    invz_max = np.asarray(invz_max, np.float32)
    focal = np.asarray(focal, np.float32)
    fracs = (np.arange(num_planes, dtype=np.float32) + _F32(0.5)) / _F32(
        num_planes)

    def bc(x):
        return x[..., None, None]

    out_rgb = out_a = None
    for i in range(num_layers):
        res_w, res_h = layer_res[i]
        fskr1 = mm(mat_from_focal(focal[i] / res_w, focal[i] / res_h).to(dev),
                   skr1)
        p = mm(fskr1, inv2)
        c = torch.matmul(fskr1, (-c1)[..., None])[..., 0]
        denom = (bc(p[..., 2, 0]) * s2x + bc(p[..., 2, 1]) * s2y
                 + bc(p[..., 2, 2]))
        qx = (bc(p[..., 0, 0]) * s2x + bc(p[..., 0, 1]) * s2y
              + bc(p[..., 0, 2])) / denom
        qy = (bc(p[..., 1, 0]) * s2x + bc(p[..., 1, 1]) * s2y
              + bc(p[..., 1, 2])) / denom
        c_x, c_y, c_z = bc(c[..., 0]), bc(c[..., 1]), bc(c[..., 2])
        izmin, izmax = invz_min[i], invz_max[i]
        sharp = float(_F32(sharpness) / np.maximum(izmin - izmax, _F32(1e-9)))
        res_w, res_h = float(res_w), float(res_h)

        shape = denom.shape
        transmittance = torch.ones(shape, device=dev)
        acc_rgb = torch.zeros(shape + (3,), device=dev)
        acc_a = torch.zeros(shape, device=dev)
        for frac in fracs:
            invz_k = float(izmin + (izmax - izmin) * frac)  # near -> far
            s1x = c_x * invz_k + (1.0 - c_z * invz_k) * qx
            s1y = c_y * invz_k + (1.0 - c_z * invz_k) * qy
            u1 = s1x + 0.5
            v1 = s1y + 0.5
            d_k = read_disp(disp[i], u1, v1, izmin, izmax, res_w, res_h)
            inside = ((s1x.abs() < 0.5) & (s1y.abs() < 0.5)).to(torch.float32)
            # occupancy CONSUMES the ray even out of bounds (the march's
            # crossing against the edge-clamped surface also stops the ray
            # and reports a miss there); visibility only scales the
            # contribution
            occ = torch.sigmoid((d_k - invz_k) * sharp)
            vis = (inside * bilinear_sample(mask[i], u1, v1, res_w, res_h)
                   * taper(u1, v1, feathering))
            col_k = bilinear_sample(rgb[i], u1, v1, res_w, res_h)
            w_k = transmittance * occ
            acc_rgb = acc_rgb + (w_k * vis)[..., None] * col_k
            acc_a = acc_a + w_k * vis
            transmittance = transmittance * (1.0 - occ)
        if out_rgb is None:
            out_rgb, out_a = acc_rgb, acc_a
        else:  # front-to-back over the layers in front
            out_rgb = out_rgb + (1.0 - out_a[..., None]) * acc_rgb
            out_a = out_a + (1.0 - out_a) * acc_a
    return _composite.finish_over_background(out_rgb, out_a, background,
                                             to_srgb)
