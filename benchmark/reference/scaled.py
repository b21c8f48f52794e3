"""Plain-PyTorch reference of the scaled tier: the frames that
render_fast_batch(method="auto") gives for an unrotated pose batch that
moves off the lateral line (a zoom or dolly along z, a y offset) of a
one-layer, unskewed projector.

A frozen copy of the program's plain twin (the plan's displacement clips
and pad origins, the per-pose ladders stepped by parallax, the warp
tables, the depth-only scaled march with its refine-2 secant bracket,
the packed colour fetch at the solved position, the edge taper,
over-compositing and the sRGB curve), written here so that a change to
the program cannot move the yardstick. It imports nothing of the
program: the plan, the ladders and the tables are worked out again from
the benchmark's inputs. The plan's budgets (the candidate counts and the
y window's chunks) only decide whether a batch takes this tier and are
left out: where the program routes a batch to another tier, its frames
differ from these.

Frozen RenderConfig values (configs/sfmoma-camera-path.json states them,
and reference/camera-path.py refuses others): rotated_step_px 1.0
(STEP_PX) and rotated_refine 2 (REFINE), the ladder's bucket of 64
planes and its cap of 1024. Scope: mask mode 'none' (a
one-layer projector), output widths divisible by 8 (no width pad), no
frustum skew. `dtype` sets the precision of the textures, the taps and
the differences (positions and tables stay float32); the benchmark's
control runs it in bfloat16.

render is what reference/camera-path.py calls: one frame and the work of
its march, which the tier's roofline reader counts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .target import (
    F32, SLACK, composite, edge_alpha, fetch, pack_rgbm, relative_pose,
    secant, start_plane, tdiv, work,
)

STEP_PX = 1.0
REFINE = 2
BUCKET = 64
MAX_PLANES = 1024
CHUNK = 128  # the plan's y window is counted in chunks of rows


class Plan:
    """The plan's geometry for a batch: the x displacement clip [-pad_x,
    span_x - pad_x], the y clip [-my_lo, my_hi], the pads' origins
    (pad_x, pad_y) and the centring offsets (bx, by)."""

    def __init__(self, src_w, src_h, out_w, out_h, f1, fr, cx_max, cy_max,
                 cz_lo, cz_hi, izmin, izmax):
        self.src_w, self.src_h, self.out_w, self.out_h = (src_w, src_h,
                                                          out_w, out_h)
        self.bx = (src_w - out_w) / 2.0
        self.by = (src_h - out_h) / 2.0
        es = [fr * (1.0 + cz * v) - 1.0 for cz in (cz_lo, cz_hi)
              for v in (izmax, izmin)]
        e_abs = max(abs(min(es)), abs(max(es)))
        shift = f1 * cx_max * izmin
        scale = e_abs * ((out_w - 1) / 2.0)
        cap = float(src_w + out_w)
        d_lo = max(self.bx - shift - scale, -cap)
        d_hi = min(self.bx + shift + scale, cap)
        self.pad_x = max(0, int(math.ceil(-d_lo)) + 1)
        self.span_x = int(math.ceil(d_hi)) + self.pad_x + 2
        yshift = f1 * cy_max * izmin
        yscale = e_abs * ((out_h - 1) / 2.0)
        self.my_lo = max(0, int(math.ceil(-(self.by - yshift - yscale))) + 1)
        self.my_hi = max(0, int(math.ceil(self.by + yshift + yscale)) + 2)
        self.pad_y = -(-self.my_lo // CHUNK) * CHUNK


def ladder(f1, c1s, fr, out_w, out_h, izmin, izmax):
    """The batch's shared ladder: K planes uniform over [izmax, izmin]
    (float32, descending), K the bucketed largest count at which no
    pose's displacement moves more than STEP_PX pixels a plane."""
    def count(c):
        cx, cy, cz = (float(c[0]), float(c[1]), float(c[2]))
        gx = abs(f1 * cx) + abs(fr * cz) * (out_w - 1) / 2.0
        gy = abs(f1 * cy) + abs(fr * cz) * (out_h - 1) / 2.0
        g = max(gx, gy, 1e-9)
        k = min(int(math.ceil((izmin - izmax) * g / STEP_PX)) + 2,
                MAX_PLANES)
        return max(BUCKET, -(-k // BUCKET) * BUCKET)

    k = max(count(c) for c in c1s)
    return np.linspace(izmin, izmax, k, dtype=np.float64).astype(F32), k


def tables(plan, grid, c1, f1, fr, device):
    """(5, K) float32 rows [tx, ex, ty, ey, invz] on `device`: the
    displacement at the image centre and its slope a pixel, dx(j) = tx +
    ex (j - cx0), in the program's order of operations."""
    v = torch.as_tensor(grid, dtype=torch.float32, device=device)[None]
    c = torch.as_tensor(c1, dtype=torch.float32, device=device)[None]
    f1, fr = float(F32(f1)), float(F32(fr))
    e = fr * (1.0 + c[..., 2:3] * v) - 1.0
    tx = plan.bx - (c[..., 0:1] * f1) * v + 0.0
    ty = plan.by - (c[..., 1:2] * f1) * v + 0.0
    return torch.stack([tx, e, ty, e, v], dim=1)[0]


def centred(plan, device):
    """((j - cx0) (1, W), j (1, W)) and ((i - cy0) (H, 1), i (H, 1))."""
    jx = torch.arange(plan.out_w, dtype=torch.float32, device=device)[None]
    iy = torch.arange(plan.out_h, dtype=torch.float32,
                      device=device)[:, None]
    return ((jx - (plan.out_w - 1) / 2.0, jx),
            (iy - (plan.out_h - 1) / 2.0, iy))


def taps(g, pad, n):
    """The two source texels and the fraction at padded coordinate g: the
    padded index p reads texel clamp(p - pad, 0, n - 1)."""
    f0 = torch.floor(g)
    i0 = f0.to(torch.int64) - pad
    return i0.clamp(0, n - 1), (i0 + 1).clamp(0, n - 1), g - f0


def warp(img, tx, ex, ty, ey, plan, xc, yc):
    """Bilinear read of img (H, W) at the clipped separable displacement
    of tables (tx, ex, ty, ey), numbers or per-pixel tensors."""
    h, w = img.shape
    dxv = torch.clamp(tx + ex * xc[0], -float(plan.pad_x),
                      float(plan.span_x - plan.pad_x))
    dyv = torch.clamp(ty + ey * yc[0], -float(plan.my_lo), float(plan.my_hi))
    gx = (xc[1] + dxv) + float(plan.pad_x)
    gy = (yc[1] + dyv) + float(plan.pad_y)
    x0, x1, fx = taps(gx, plan.pad_x, w)
    y0, y1, fy = taps(gy, plan.pad_y, h)
    fx, fy = fx.to(img.dtype), fy.to(img.dtype)
    top = img[y0, x0] * (1.0 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1.0 - fx) + img[y1, x1] * fx
    return top * (1.0 - fy) + bot * fy


def march(disp, izmin, izmax, tab, plan, dtype=torch.float32):
    """The depth-only scaled march of one pose over its tables (5, K):
    per pixel the first plane k* (-1: none) whose decoded inverse depth
    lies in front of it, and invz* from the secant in the 1/(REFINE + 1)
    sub-bracket of [k*-1, k*] where the sub-sweep finds the crossing (0
    where none). Returns (k*, found, invz*)."""
    dev = disp.device
    dd = disp.to(dtype)
    iz0, iz1 = F32(izmin), F32(izmax)
    rng, iz1 = float(iz0 - iz1), float(iz1)
    xc, yc = centred(plan, dev)
    rows = tab.tolist()

    def diff_at(tx, ex, ty, ey, v):
        return (warp(dd, tx, ex, ty, ey, plan, xc, yc) * rng + iz1) - v

    shape = (plan.out_h, plan.out_w)
    zeros = torch.zeros(shape, dtype=dtype, device=dev)
    kstar = torch.full(shape, -1, dtype=torch.int64, device=dev)
    pdiffc, diffc, pdiff = zeros, zeros, zeros
    for k in range(tab.shape[1]):
        diff = diff_at(*(r[k] for r in rows))
        crossed = (kstar < 0) & (diff > 0.0)
        kstar = torch.where(crossed, k, kstar)
        pdiffc = torch.where(crossed, pdiff, pdiffc)
        diffc = torch.where(crossed, diff, diffc)
        pdiff = diff
    found = kstar >= 0
    t0 = tab[:, torch.clamp(kstar - 1, min=0)]
    t1 = tab[:, torch.clamp(kstar, min=0)]
    step = 1.0 / (REFINE + 1)
    slo, pd2, d2 = torch.zeros(shape, device=dev), pdiffc, diffc
    sfound = torch.zeros(shape, dtype=torch.bool, device=dev)
    prev_g, prev_s = pdiffc, 0.0
    for jr in range(1, REFINE + 1):
        s = jr * step
        g = diff_at(*(t0[c] + s * (t1[c] - t0[c]) for c in range(5)))
        csub = ~sfound & (g > 0.0)
        slo = torch.where(csub, prev_s, slo)
        pd2 = torch.where(csub, prev_g, pd2)
        d2 = torch.where(csub, g, d2)
        sfound = sfound | csub
        prev_g, prev_s = g, s
    slo = torch.where(sfound, slo, prev_s)
    pd2 = torch.where(sfound, pd2, prev_g)
    s_star = torch.where(kstar == 0, 1.0, slo + step * secant(pd2, d2))
    vstar = torch.where(found, t0[4] + s_star * (t1[4] - t0[4]), 0.0)
    return kstar, found.to(torch.float32), vstar


def render(src, j, positions, rotations, config, dtype=torch.float32):
    """The frame of camera j of a batch of unrotated cameras at
    `positions` (B, 3), rendered from one projector
    (reference.lateral.Source) on the scaled tier: (H, W, 4) sRGB RGBA and
    the work of its march."""
    out_w, out_h = config["width"], config["height"]
    f2 = float(F32(config["focal_ratio"] * out_w))
    h_s, w_s = src.disp.shape
    if out_w % 8:
        raise ValueError("the scaled reference renders widths divisible "
                         "by 8")
    if not np.allclose(np.asarray(rotations, F32), np.eye(3), atol=1e-5):
        raise ValueError("the scaled tier takes unrotated cameras")
    c1s = np.stack([relative_pose(src, p, r)[0]
                    for p, r in zip(positions, rotations)])
    f1, fr = src.focal, src.focal / f2
    plan = Plan(w_s, h_s, out_w, out_h, f1, fr, float(np.abs(c1s[:, 0]).max()),
                float(np.abs(c1s[:, 1]).max()), float(min(c1s[:, 2].min(), 0.0)),
                float(max(c1s[:, 2].max(), 0.0)), src.izmin, src.izmax)
    grid, k = ladder(f1, c1s, fr, out_w, out_h, src.izmin, src.izmax)
    dev = src.disp.device
    tab = tables(plan, grid, c1s[j], f1, fr, dev)
    kstar, found, vstar = march(src.disp, src.izmin, src.izmax, tab, plan,
                                dtype)
    # the solved position's normalized source coordinates
    c = torch.as_tensor(c1s[j], dtype=torch.float32, device=dev)[None]
    f1cx, f1cy, cz = (c[..., i, None, None] for i in range(3))
    f1cx, f1cy = f1cx * float(F32(f1)), f1cy * float(F32(f1))
    (xc, jx), (yc, iy) = centred(plan, dev)
    izs = torch.where(found > 0.5, vstar, 0.0)[None]
    e = float(F32(fr)) * (1.0 + cz * izs) - 1.0
    gx = jx + plan.bx + 0.0 - f1cx * izs + e * xc
    gy = iy + plan.by + 0.0 - f1cy * izs + e * yc
    u = tdiv(gx + 0.5, w_s)[0]
    v = tdiv(gy + 0 + 0.5, h_s)[0]
    rgba = fetch(pack_rgbm(src.rgb, torch.ones_like(src.disp)), u, v, w_s,
                 h_s, dtype)
    alpha = edge_alpha(found, u, v, config["render_config"]["feathering"])
    # the first plane whose depth a decoded texel can reach
    iz0, iz1 = F32(src.izmin), F32(src.izmax)
    a = F32(float(src.disp.min())) * (iz0 - iz1)
    b = F32(float(src.disp.max())) * (iz0 - iz1)
    top = (max(a, b) + iz1 + (max(abs(a), abs(b)) + abs(iz1)) * F32(SLACK)
           + F32(1e-30))
    return composite(rgba, alpha), work(kstar, found, start_plane(grid, top),
                                        k, src.disp.numel())
