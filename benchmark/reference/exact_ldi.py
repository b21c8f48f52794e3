"""Plain-PyTorch exact ray march of a layered depth image: the
image-quality yardstick of an LDI cell.

exact.py's march (the reference shader rayCastMonoLDI.glsl's per-pixel
inverse-depth march with step-back-and-halve refinement, the 2-texel
interior clamp of readDisp, clamp-to-edge bilinear reads, the edge taper)
run on each layer in that layer's own coordinates: a layer larger than
the view (outpainted, centred, at the view's focal) reads the view's
pixel grid scaled by view size / layer size (rayCastMonoLDI.glsl:332 at
matched focal). Each layer's alpha is multiplied by its bilinear mask
(:291, mask mode 'multiply'), the layers are composited front to back
with the over operator (:338-358), then the transparent background and
the sRGB curve. NUM_STEPS steps a layer, for an unrotated camera only
translated from the projector. psnr_db compares the timed path's frames
with it, through render_slot. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .exact import NUM_STEPS, bilinear
from .lateral import linear_to_srgb, smoothstep

F32 = np.float32


def march_layer(layer, cam, out_w, out_h, feathering=0.1,
                num_steps=NUM_STEPS):
    """One layer's exact march for the camera at world position cam
    (x, y, z) into an out_w x out_h view: (colour (H, W, 3) premultiplied
    by alpha, alpha (H, W)), linear."""
    rgb, disp = layer.rgb, layer.disp
    h, w = disp.shape
    dev = disp.device
    f = F32(layer.focal)
    # the projector's position in the camera frame, z negated
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
    for _ in range(num_steps):
        invz = invz - dinvz
        s1x = s1x - ds1x
        s1y = s1y - ds1y
        uc = torch.clamp(s1x + 0.5, bu, 1.0 - bu)
        vc = torch.clamp(s1y + 0.5, bv, 1.0 - bv)
        d = bilinear(disp, uc, vc, w, h) * dsc + float(izmax)
        invz2 = invz / (1.0 - cz * invz)
        below = (d > invz) & (invz2 > 0.0)
        invz = torch.where(below, invz + dinvz, invz)
        s1x = torch.where(below, s1x + ds1x, s1x)
        s1y = torch.where(below, s1y + ds1y, s1y)
        dinvz = torch.where(below, dinvz * 0.5, dinvz)
        ds1x = torch.where(below, ds1x * 0.5, ds1x)
        ds1y = torch.where(below, ds1y * 0.5, ds1y)
    hit = ((torch.abs(s1x) < 0.5) & (torch.abs(s1y) < 0.5) & (invz2 > 0.0)
           & (invz > 0.0))
    u1, v1 = s1x + 0.5, s1y + 0.5
    color = bilinear(rgb, u1, v1, w, h)
    fe = max(float(feathering), 1e-6)
    alpha = (smoothstep(0.0, fe, u1) * (1.0 - smoothstep(1.0 - fe, 1.0, u1))
             * smoothstep(0.0, fe, v1) * (1.0 - smoothstep(1.0 - fe, 1.0, v1))
             * bilinear(layer.mask, u1, v1, w, h))
    a = torch.where(hit, alpha, 0.0)
    return torch.where(hit[..., None], color, 0.0) * a[..., None], a


def render(layers, cam, out_w, out_h, feathering=0.1, num_steps=NUM_STEPS):
    """The exact frame of the camera at cam from the LDI `layers` (front
    first): (H, W, 4) sRGB RGBA over a transparent background."""
    rgb = a = None
    for layer in layers:
        lr, la = march_layer(layer, cam, out_w, out_h, feathering,
                             num_steps)
        if rgb is None:
            rgb, a = lr, la
        else:
            rgb = rgb + (1.0 - a[..., None]) * lr
            a = a + (1.0 - a) * la
    return torch.cat([linear_to_srgb(rgb), a[..., None]], dim=-1)


def render_slot(srcs, slot, config):
    """The exact frame of one sampled frame's camera (slot: its index j in
    the call and the call's poses), from the LDI srcs (its layers, front
    first)."""
    if slot.poses.get("rotation") is not None:
        raise ValueError("the exact LDI march takes an unrotated camera")
    cam = tuple(float(v) for v in slot.poses["position"][slot.j])
    return render(srcs, cam, config["width"], config["height"],
                  config["render_config"]["feathering"])
