"""Plain-PyTorch exact ray march of a two-view layered depth image: the
image-quality yardstick of a stereo LDI cell.

exact_ldi.py's march (the reference shader's per-pixel inverse-depth
march with step-back-and-halve refinement, readDisp's 2-texel interior
clamp, clamp-to-edge bilinear reads, the edge taper, each layer in its
own coordinates) with rayCastStereoLDI.glsl's changes: the march's
confidence, 0 where a step that went below the surface saw a disparity
jump above the gradient threshold 0.02 * range * 140 / steps (:236,
265-267); a hit needs invZ2 >= 0 (:298); and the dilated discard, any of
9 bilinear mask reads on a 3 x 3 grid 1.5 texels apart below 0.5
dropping the hit's colour and alpha (isMaskAround, :147-158, 304-305).
Per layer both views are marched, filled and blended as stereo_ldi.py
does it (the fill :372-381, the weight :165-170), then composited front
to back (:385-436) over a transparent background and put through the
sRGB curve. NUM_STEPS steps a layer, for unrotated eyes only translated
from the views. psnr_db compares the timed path's frames with it,
through render_slot. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .exact_ldi import NUM_STEPS, bilinear, linear_to_srgb, smoothstep
from .stereo_ldi import occlusion_blend, view_weight

F32 = np.float32


def march_layer(layer, cam, out_w, out_h, feathering=0.1,
                num_steps=NUM_STEPS):
    """One layer's exact stereo march for the eye at world position cam
    (x, y, z) into an out_w x out_h view: (straight RGBA (H, W, 4),
    confidence (H, W))."""
    rgb, disp, mask = layer.rgb, layer.disp, layer.mask
    h, w = disp.shape
    dev = disp.device
    f = F32(layer.focal)
    # the view's position in the eye's frame, z negated
    c1 = np.array([F32(layer.x) - F32(cam[0]), -F32(cam[1]), F32(cam[2])],
                  F32)
    fs = np.array([f / F32(w), f / F32(h), F32(1.0)], F32)
    c = -fs * c1  # FSKR1 @ (C2 - C1) with C2 = 0
    # P = FSKR1 inv(FSKR2): the view's grid in the layer's coordinates
    px = float(F32(f / F32(w)) / F32(f / F32(out_w)))
    py = float(F32(f / F32(h)) / F32(f / F32(out_h)))
    u = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / out_w
    v = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) / out_h
    qx = ((u[None, :] - 0.5) * px).expand(out_h, out_w)
    qy = ((v[:, None] - 0.5) * py).expand(out_h, out_w)
    izmin, izmax = F32(layer.izmin), F32(layer.izmax)
    dinvz0 = (izmin - izmax) / F32(num_steps)
    grad_thr = float(F32(0.02) * (izmin - izmax) * F32(140.0)
                     / F32(num_steps))
    cx, cy, cz = (float(t) for t in c)
    invz = torch.full((out_h, out_w), float(izmin + dinvz0), device=dev)
    dinvz = torch.full((out_h, out_w), float(dinvz0), device=dev)
    s1x = cx * invz + (1.0 - cz * invz) * qx
    s1y = cy * invz + (1.0 - cz * invz) * qy
    ds1x = (cx - cz * qx) * dinvz
    ds1y = (cy - cz * qy) * dinvz
    bu, bv = float(F32(2.0) / F32(w)), float(F32(2.0) / F32(h))
    dsc = float(izmin - izmax)
    invz2 = torch.zeros_like(invz)
    old = torch.zeros_like(invz)
    conf = torch.ones_like(invz)
    for _ in range(num_steps):
        invz = invz - dinvz
        s1x = s1x - ds1x
        s1y = s1y - ds1y
        uc = torch.clamp(s1x + 0.5, bu, 1.0 - bu)
        vc = torch.clamp(s1y + 0.5, bv, 1.0 - bv)
        d = bilinear(disp, uc, vc, w, h) * dsc + float(izmax)
        grad, old = d - old, d
        invz2 = invz / (1.0 - cz * invz)
        below = (d > invz) & (invz2 > 0.0)
        conf = torch.where(below & (torch.abs(grad) > grad_thr), 0.0, conf)
        invz = torch.where(below, invz + dinvz, invz)
        s1x = torch.where(below, s1x + ds1x, s1x)
        s1y = torch.where(below, s1y + ds1y, s1y)
        dinvz = torch.where(below, dinvz * 0.5, dinvz)
        ds1x = torch.where(below, ds1x * 0.5, ds1x)
        ds1y = torch.where(below, ds1y * 0.5, ds1y)
    hit = ((torch.abs(s1x) < 0.5) & (torch.abs(s1y) < 0.5) & (invz2 >= 0.0)
           & (invz > 0.0))
    u1, v1 = s1x + 0.5, s1y + 0.5
    color = bilinear(rgb, u1, v1, w, h)
    fe = max(float(feathering), 1e-6)
    alpha = (smoothstep(0.0, fe, u1) * (1.0 - smoothstep(1.0 - fe, 1.0, u1))
             * smoothstep(0.0, fe, v1) * (1.0 - smoothstep(1.0 - fe, 1.0, v1)))
    masked = torch.zeros_like(hit)
    for dy in (-1.0, 0.0, 1.0):
        for dx in (-1.0, 0.0, 1.0):
            mv = bilinear(mask, u1 + float(F32(1.5 * dx) / F32(w)),
                          v1 + float(F32(1.5 * dy) / F32(h)), w, h)
            masked = masked | (mv < 0.5)
    keep = hit & ~masked
    rgba = torch.cat([torch.where(keep[..., None], color, 0.0),
                      torch.where(keep, alpha, 0.0)[..., None]], dim=-1)
    return rgba, conf


def render(views, cam, out_w, out_h, feathering=0.1, num_steps=NUM_STEPS):
    """The exact frame of the eye at cam from the two views (left, right;
    each its layers, front first): (H, W, 4) sRGB RGBA over a transparent
    background."""
    left, right = views
    w_r = view_weight(left[0].offset(cam[0]), right[0].offset(cam[0]))
    rgb = a = None
    for lay_l, lay_r in zip(left, right):
        (v_l, c_l), (v_r, c_r) = (
            march_layer(lay, cam, out_w, out_h, feathering, num_steps)
            for lay in (lay_l, lay_r))
        blend = occlusion_blend(v_l, v_r, c_l, c_r, w_r)
        la = blend[..., 3]
        if rgb is None:
            rgb, a = blend[..., :3] * la[..., None], la
        else:
            rgb = rgb + (1.0 - a[..., None]) * la[..., None] * blend[..., :3]
            a = la + a * (1.0 - la)
    return torch.cat([linear_to_srgb(rgb), a[..., None]], dim=-1)


def render_slot(srcs, slot, config):
    """The exact frame of one sampled frame's eye (slot: its index j in
    the call and the call's poses), from the two views srcs."""
    if slot.poses.get("rotation") is not None:
        raise ValueError("the exact stereo march takes an unrotated eye")
    cam = tuple(float(v) for v in slot.poses["position"][slot.j])
    return render(srcs, cam, config["width"], config["height"],
                  config["render_config"]["feathering"])
