"""Plain-PyTorch reference of the fast stereo path on a two-view layered
depth image: the frames that render_stereo_fast_batch gives for two
unrotated, unskewed LDI views (layers outpainted by an even margin,
centred, at the eyes' focal) on the x axis and x-only eye cameras, every
layer of both views on the lateral march.

Per layer (rayCastStereoLDI.glsl:368-436), for each view: ldi.py's
lateral march of the eye over the view's layer (its own snap ladder sized
over the call's cameras, its outpaint crop), marching the layer's stereo
discard mask in place of its mask; the hit test and edge taper in the
whole outpainted layer's coordinates; the dilated hard discard, a hit
kept where the marched discard mask reads at least 0.5 (:304-305); the
stretch-mark confidence of the march (:236, 265-267). Then the occlusion
fill in the shader's order, L from R, then R from the already filled L
(:372-381); the blend with the smoothstepped projection of the eye on
the baseline (:165-170); the front-to-back over of the blended layers
(:385-436), the transparent background and the sRGB curve. A frozen copy
of what the program does, written here so that a change to the program
cannot move the yardstick; it imports nothing of the program.

Where it departs from the shader, as the program does:

- the discard mask is the layer's mask eroded once (eroded_mask): the
  least of the texel and, towards each of the 8 neighbours, the mean of
  the texels 1 and 2 out, edge-clamped. A read 1.5 texels out is that
  mean, so the marched, eroded mask below 0.5 stands for isMaskAround's
  9 bilinear reads (:147-158), exactly on binary masks away from their
  1-texel bleed band;
- the confidence of the fast march is read at the solved crossing and
  one production step dv = range / 40 in front of it along the ray, and
  dies on hit pixels where the two disparities differ by more than 2.8
  dv (0.02 * 140 a step, the shader's gradient threshold); it is
  evaluated at every 4th pixel (else 2nd, else every one, as the output
  size divides), at each block's first pixel, and repeated over the
  block.

Scope: march_refine 0, snap planes of stride 1, a transparent
background, output widths divisible by 8, no frustum skew. `dtype` sets
the precision of every device tensor; the benchmark's control runs it in
bfloat16.

render_slot is what the harness calls: one sampled frame's reference and
the work of its marches, each eye-layer counted as a source (lateral.py's
march_work), which the kernels' roofline reader counts.
"""

from __future__ import annotations

import numpy as np
import torch

from .exact import bilinear
from .lateral import (F32, _edge_pad, finish, ladder_size, march_work,
                      smoothstep, snap_plane_table)
from .ldi import Layer, Plan, crop_rows, march

STEPS = 40  # production steps over a layer's range
SLOPE = 2.8  # the gradient threshold, 0.02 * 140, in steps


def eroded_mask(mask):
    """The stereo discard mask of a layer's mask (H, W): float32."""
    m = mask.to(torch.float32)
    h, w = m.shape
    p = _edge_pad(m, 2, 2, 2, 2)

    def shift(dy, dx):
        return p[2 + dy:2 + dy + h, 2 + dx:2 + dx + w]

    out = m
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out = torch.minimum(
                    out, 0.5 * (shift(dy, dx) + shift(2 * dy, 2 * dx)))
    return out


def with_mask(layer, mask):
    """The layer with another mask (the same textures and constants)."""
    out = Layer.__new__(Layer)
    out.__dict__.update(vars(layer))
    out.mask = mask
    return out


def hard_alpha(layer, found, invz_star, mask_star, cx, feathering):
    """The hit test and edge taper at the solved source position, in the
    whole (outpainted) layer's coordinates, then the hard discard: (hit,
    alpha), (out_h, out_w) each."""
    out_h, out_w = found.shape
    src_h, src_w = layer.disp.shape
    dev, dt = found.device, found.dtype
    bx = (src_w - out_w) / 2.0
    top = crop_rows(layer, out_h)
    jx = torch.arange(out_w, dtype=dt, device=dev)[None, :]
    iy = torch.arange(out_h, dtype=dt, device=dev)[:, None]
    gx = jx + bx - float(F32(layer.focal) * F32(cx)) * invz_star
    u = (gx + 0.5) / src_w
    v = (iy + top + 0.5) / src_h
    inside = ((u > 0.0) & (u < 1.0) & (v > 0.0) & (v < 1.0)).to(dt)
    f = max(float(feathering), 1e-6)
    taper = (smoothstep(0.0, f, u) * (1.0 - smoothstep(1.0 - f, 1.0, u))
             * smoothstep(0.0, f, v) * (1.0 - smoothstep(1.0 - f, 1.0, v)))
    hit = found * inside
    keep = (mask_star >= 0.5).to(dt)
    return hit * keep, hit * taper * keep


def block(out_w, out_h):
    """The side of the confidence's blocks: 4, else 2, else 1."""
    for ds in (4, 2):
        if out_h % ds == 0 and out_w % ds == 0:
            return ds
    return 1


def read_disp(layer, u, v):
    """The layer's inverse depth at uv, read as the shader's readDisp
    reads it: uv clamped 2 texels inside, bilinear, decoded."""
    h, w = layer.disp.shape
    izmin, izmax = F32(layer.izmin), F32(layer.izmax)
    bu, bv = float(F32(2.0) / F32(w)), float(F32(2.0) / F32(h))
    uc = torch.clamp(u, bu, float(F32(1.0) - F32(bu)))
    vc = torch.clamp(v, bv, float(F32(1.0) - F32(bv)))
    tex = bilinear(layer.disp.to(u.dtype), uc, vc, w, h)
    return tex * float(izmin - izmax) + float(izmax)


def confidence(layer, cx, hit, invz_star, f2):
    """The stretch-mark confidence (out_h, out_w) of the eye's march at
    x offset cx from the view: 0 or 1. The view's pixel (j, i) reads the
    layer at q = P s2, P = FS1 inv(FS2) in float32 as the shader's
    closed-form (adjugate) inverse gives it, and the ray moves along x by
    FS1 (C2 - C1) per unit of inverse depth."""
    out_h, out_w = hit.shape
    src_h, src_w = layer.disp.shape
    dev, dt = hit.device, invz_star.dtype
    f1, f2 = F32(layer.focal), F32(f2)
    a, b = f2 / F32(out_w), f2 / F32(out_h)
    det = a * b
    fx1, fy1 = f1 / F32(src_w), f1 / F32(src_h)
    px, py = fx1 * (b / det), fy1 * (a / det)
    dsx = float(fx1 * -F32(cx))
    ds = block(out_w, out_h)
    jx = (torch.arange(out_w // ds, dtype=torch.float32, device=dev) * ds
          + 0.5) / out_w - 0.5
    iy = (torch.arange(out_h // ds, dtype=torch.float32, device=dev) * ds
          + 0.5) / out_h - 0.5
    qx = (float(px) * jx[None, :]).to(dt)
    qy = (float(py) * iy[:, None]).to(dt)
    dv = (F32(layer.izmin) - F32(layer.izmax)) / F32(STEPS)

    def disp_at(z):
        return read_disp(layer, qx + z * dsx + 0.5, qy + 0.5)

    z = invz_star[::ds, ::ds]
    kill = (torch.abs(disp_at(z) - disp_at(z + float(dv)))
            > float(F32(SLOPE) * dv))
    kill = kill.repeat_interleave(ds, 0).repeat_interleave(ds, 1)
    return torch.where(kill & (hit > 0.5), 0.0, 1.0).to(dt)


def view_weight(cx_l, cx_r):
    """The right view's weight at an eye whose views sit at x offsets
    cx_l, cx_r: the eye's projection on the baseline, smoothstepped, in
    float32; coincident views weigh 0."""
    lx, rx = F32(cx_l), F32(cx_r)
    d = rx - lx
    den = d * d
    if den < F32(1e-12):
        return F32(0.0)
    t = np.clip((d * -lx) / den, F32(0.0), F32(1.0)).astype(F32)
    return t * t * (F32(3.0) - F32(2.0) * t)


def march_eye(layer, cam_x, batch_xs, out_w, out_h, feathering, f2, dtype):
    """One view's layer seen from the eye at cam_x in a call whose eyes
    sit at batch_xs: (straight RGBA (H, W, 4), confidence (H, W)) and the
    march (found, invz*, planes) for the work counts."""
    cx = layer.offset(cam_x)
    cxs = [layer.offset(x) for x in batch_xs]
    k = ladder_size(layer.focal, cxs, layer.izmin, layer.izmax)
    planes, _ = snap_plane_table(layer.focal, cx, layer.izmin, layer.izmax,
                                 num_planes=k)
    src_w = layer.disp.shape[1]
    plan = Plan(src_w, out_w, min(
        layer.focal * max(abs(c) for c in cxs) * layer.izmin,
        float(src_w + out_w)))
    found, izs, rgba = march(with_mask(layer, eroded_mask(layer.mask)), cx,
                             planes, plan, out_w, out_h, dtype)
    hit, alpha = hard_alpha(layer, found, izs, rgba[..., 3], F32(cx),
                            feathering)
    conf = confidence(layer, cx, hit, izs, f2)
    view = torch.cat([rgba[..., :3], alpha[..., None]], dim=-1)
    return view, conf, (found, izs, planes)


def occlusion_blend(left, right, conf_l, conf_r, w_r):
    """One layer of both views filled and blended (straight RGBA)."""
    fill_l = ((conf_l == 0.0) & (conf_r == 1.0)) | (
        left[..., 3] < right[..., 3] - 0.1)
    left = torch.where(fill_l[..., None], right, left)
    fill_r = ((conf_r == 0.0) & (conf_l == 1.0)) | (
        right[..., 3] < left[..., 3] - 0.1)
    right = torch.where(fill_r[..., None], left, right)
    return float(F32(1.0) - w_r) * left + float(w_r) * right


def render(views, cam_x, batch_xs, out_w, out_h, f2, feathering=0.1,
           dtype=torch.float32):
    """The frame of the eye at cam_x rendered from the two views (left,
    right; each its layers, front first) in a call whose eyes sit at
    batch_xs: (H, W, 4) sRGB RGBA, and each eye-layer's (source, march)
    for the work counts."""
    left, right = views
    w_r = view_weight(left[0].offset(cam_x), right[0].offset(cam_x))
    rgb = a = None
    marches = []
    for lay_l, lay_r in zip(left, right):
        (v_l, c_l, m_l), (v_r, c_r, m_r) = (
            march_eye(lay, cam_x, batch_xs, out_w, out_h, feathering, f2,
                      dtype) for lay in (lay_l, lay_r))
        blend = occlusion_blend(v_l, v_r, c_l, c_r, w_r)
        la = blend[..., 3]
        if rgb is None:
            rgb, a = blend[..., :3] * la[..., None], la
        else:
            rgb = rgb + (1.0 - a[..., None]) * la[..., None] * blend[..., :3]
            a = la + a * (1.0 - la)
        marches += [(lay_l, m_l), (lay_r, m_r)]
    return finish(rgb, a, True).float(), marches


def render_slot(srcs, slot, config, options, dtype=torch.float32):
    """The reference of one sampled frame (slot: its frame, its index j in
    the call and the call's poses) from the two views srcs (left, right;
    each its layers, front first), and the work of its marches,
    {"lateral_march": counts}. options["ladder"] must be "call": each
    layer's ladder is sized over the whole call, as the program sizes
    it."""
    rc = config["render_config"]
    if (rc.get("plane_mode", "snap") != "snap" or rc.get("march_refine", 0)
            or rc.get("march_stride", 1) != 1):
        raise ValueError("the stereo reference marches snap planes of "
                         "stride 1 without refinement")
    if any(rc.get("background", (0.0,) * 4)):
        raise ValueError("the stereo reference composites over a "
                         "transparent background")
    if options.get("ladder") != "call":
        raise ValueError("the stereo reference sizes each ladder over the "
                         "call")
    if config["mask_mode"] != "hard":
        raise ValueError("the stereo reference discards on the eroded mask")
    pos = np.asarray(slot.poses["position"], np.float64)
    rot = slot.poses.get("rotation")
    if pos[:, 1:].any() or (rot is not None
                            and not np.allclose(rot, np.eye(3))):
        raise ValueError("the stereo reference takes x-only, unrotated "
                         "cameras")
    xs = [float(v) for v in pos[:, 0]]
    f2 = config["focal_ratio"] * config["width"]
    frame, marches = render(srcs, xs[slot.j], xs, config["width"],
                            config["height"], f2, rc["feathering"], dtype)
    sources, counted = zip(*marches)
    return frame, {"lateral_march": march_work(sources, counted)}
