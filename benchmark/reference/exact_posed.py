"""Plain-PyTorch exact ray march of a posed camera: the image-quality
yardstick of cells whose cameras turn.

reference/exact.py's march (the semantics of the reference shader
rayCastMonoLDI.glsl: the per-pixel inverse-depth march with
step-back-and-halve refinement, the 2-texel interior clamp of readDisp,
clamp-to-edge bilinear reads, the edge taper and the sRGB curve, at
NUM_STEPS steps), for one single-layer projector and a camera that may
also be rotated: each target pixel's ray goes through the homography
P = FSKR1 inv(FSKR2) of the relative pose, as the program's exact march
ops/raycast.py::render_mono does. The pose's transforms are worked out in
float64 and rounded to float32 once, so an unrotated camera marches
exactly as reference/exact.py's does. psnr_db compares the timed path's
frames with it, through render_slot. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .exact import NUM_STEPS, bilinear
from .lateral import linear_to_srgb, smoothstep

F32 = np.float32
FLIP = np.diag([1.0, 1.0, -1.0])


def transforms(src, position, rotation, out_w, out_h, f2):
    """(P (3, 3), C (3,)) float32 of the projector src seen from a camera
    at `position` with `rotation` (world, float32 as the program stores
    them): P = FSKR1 inv(FSKR2), C = FSKR1 (-c1), with c1 the projector's
    position in the camera frame, z negated."""
    cam_p = np.asarray(position, F32).astype(np.float64)
    cam_r = np.asarray(rotation, F32).astype(np.float64)
    view_p = np.array([src.x, 0.0, 0.0], F32).astype(np.float64)
    c1 = ((cam_r.T @ (view_p - cam_p)) * np.array([1.0, 1.0, -1.0])).astype(
        F32)
    h, w = src.disp.shape
    f1 = F32(src.focal)
    fs = np.array([f1 / F32(w), f1 / F32(h), F32(1.0)], F32)
    skr1 = FLIP @ cam_r @ FLIP  # flipZ R1^T flipZ with R1 = R_cam^T
    fskr1 = fs.astype(np.float64)[:, None] * skr1
    fskr2 = np.diag([float(F32(f2) / F32(out_w)), float(F32(f2) / F32(out_h)),
                     1.0])
    p = (fskr1 @ np.linalg.inv(fskr2)).astype(F32)
    return p, (fskr1 @ -c1.astype(np.float64)).astype(F32)


def render(src, position, rotation, out_w, out_h, f2, feathering=0.1,
           num_steps=NUM_STEPS):
    """The exact march of a camera at `position` with `rotation` from the
    projector src (lateral.Source, at the origin's height and depth):
    (out_h, out_w, 4) sRGB RGBA over a transparent background."""
    rgb, disp = src.rgb, src.disp
    h, w = disp.shape
    dev = disp.device
    p, c = transforms(src, position, rotation, out_w, out_h, f2)
    (p00, p01, p02), (p10, p11, p12), (p20, p21, p22) = (
        [float(x) for x in row] for row in p)
    cx, cy, cz = (float(t) for t in c)
    u = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / out_w
    v = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) / out_h
    sx = (u[None, :] - 0.5).expand(out_h, out_w)
    sy = (v[:, None] - 0.5).expand(out_h, out_w)
    den = p20 * sx + p21 * sy + p22
    qx = (p00 * sx + p01 * sy + p02) / den
    qy = (p10 * sx + p11 * sy + p12) / den
    izmin, izmax = F32(src.izmin), F32(src.izmax)
    dinvz0 = (izmin - izmax) / F32(num_steps)
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
        invz2 = invz * den / (1.0 - cz * invz)
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
    the call and the call's poses, with or without "rotation"), from the
    one projector srcs[0]."""
    if len(srcs) != 1:
        raise ValueError("the exact march takes one projector")
    rots = slot.poses.get("rotation")
    rot = np.eye(3) if rots is None else rots[slot.j]
    w, h = config["width"], config["height"]
    return render(srcs[0], slot.poses["position"][slot.j], rot, w, h,
                  config["focal_ratio"] * w,
                  config["render_config"]["feathering"])
