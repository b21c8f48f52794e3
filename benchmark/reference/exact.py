"""Plain-PyTorch exact ray march: the image-quality yardstick.

The semantics of the reference shader rayCastMonoLDI.glsl (its per-pixel
inverse-depth march with step-back-and-halve refinement, the 2-texel
interior clamp of readDisp, clamp-to-edge bilinear reads, the edge taper
and the sRGB curve), for one single-layer projector and a camera that is
only translated from it, at NUM_STEPS steps, where the march has
converged. psnr_db compares the timed path's frames with it, through
render_slot. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .lateral import linear_to_srgb, smoothstep

F32 = np.float32
NUM_STEPS = 640


def bilinear(tex, u, v, w, h):
    """Clamp-to-edge bilinear read of tex (H, W[, C]) at uv in [0, 1]."""
    sx, sy = u * w - 0.5, v * h - 0.5
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0, y0 = x0.long(), y0.long()
    ix0, ix1 = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    iy0, iy1 = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    if tex.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    top = tex[iy0, ix0] + (tex[iy0, ix1] - tex[iy0, ix0]) * fx
    bot = tex[iy1, ix0] + (tex[iy1, ix1] - tex[iy1, ix0]) * fx
    return top + (bot - top) * fy


def render(src, cam, feathering=0.1, num_steps=NUM_STEPS):
    """The exact march of the camera at world position cam (x, y, z) from
    the projector src (lateral.Source, at the origin's height and depth):
    (H, W, 4) sRGB RGBA over a transparent background."""
    rgb, disp = src.rgb, src.disp
    h, w = disp.shape
    dev = disp.device
    f = F32(src.focal)
    # the projector's position in the camera frame, z negated
    c1 = np.array([F32(src.x) - F32(cam[0]), -F32(cam[1]), F32(cam[2])],
                  F32)
    fs = np.array([f / F32(w), f / F32(h), F32(1.0)], F32)
    c = -fs * c1  # FSKR1 @ (C2 - C1) with C2 = 0
    u = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    v = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    qx = (u[None, :] - 0.5).expand(h, w)
    qy = (v[:, None] - 0.5).expand(h, w)
    izmin, izmax = F32(src.izmin), F32(src.izmax)
    dinvz0 = (izmin - izmax) / F32(num_steps)
    cx, cy, cz = (float(t) for t in c)
    invz = torch.full((h, w), float(izmin + dinvz0), device=dev)
    dinvz = torch.full((h, w), float(dinvz0), device=dev)
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
             * smoothstep(0.0, fe, v1) * (1.0 - smoothstep(1.0 - fe, 1.0, v1)))
    a = torch.where(hit, alpha, 0.0)
    out = torch.where(hit[..., None], color, 0.0) * a[..., None]
    return torch.cat([linear_to_srgb(out), a[..., None]], dim=-1)


def render_slot(srcs, slot, config):
    """The exact frame of one sampled frame's camera (slot: its index j in
    the call and the call's poses), from the one projector srcs[0]."""
    if len(srcs) != 1 or slot.poses.get("rotation") is not None:
        raise ValueError("the exact march takes one projector and an "
                         "unrotated camera")
    cam = tuple(float(v) for v in slot.poses["position"][slot.j])
    return render(srcs[0], cam, config["render_config"]["feathering"])
