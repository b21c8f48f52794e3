"""Plain-PyTorch reference of the target tier: the frames that
render_fast_batch(method="auto") gives for a rotated yaw-family pose
batch (an orbit) of a one-layer, unskewed projector.

A frozen copy of the program's plain twin (the per-pose ladders and pose
packs of its planner, the depth-only target-ray march with its secant,
the packed colour fetch at the solved position with 10 bits a colour,
the edge taper, over-compositing and the sRGB curve), written here so
that a change to the program cannot move the yardstick. It imports
nothing of the program: every ladder and pose pack is worked out again
from the benchmark's inputs. The planner's window extents and budgets
only decide whether a batch takes this tier and are left out: where the
program routes a batch to another tier, its frames differ from these.

Frozen RenderConfig values (configs/sfmoma-camera-path.json states them,
and reference/camera-path.py refuses others): target_step_px 1.0
(STEP_PX), target_refine 0, the ladder's bucket of 64 planes and its cap
of 1024. Scope: mask mode 'none' (a one-layer
projector, whose mask is all ones), output widths divisible by 128 (the
tier's own condition), no frustum skew. `dtype` sets the precision of
the textures, the taps and the differences (positions stay float32); the
benchmark's control runs it in bfloat16.

render is what reference/camera-path.py calls: one frame and the work of
its march, which the tier's roofline reader counts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .lateral import finish, smoothstep

F32 = np.float32
STEP_PX = 1.0
BUCKET = 64
MAX_PLANES = 1024
# a disparity bound's slack (the kernel's start plane)
SLACK = 1.52587890625e-05
FLIP = np.diag([1.0, 1.0, -1.0])


def tdiv(x, d):
    """x / d by true float32 division (on the card a division by a Python
    number multiplies by its reciprocal, which the program avoids)."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def relative_pose(src, position, rotation):
    """The projector's position (z negated) and rotation in the camera's
    frame, float64 of the float32 poses the program stores: (c1 (3,),
    rot1 (3, 3))."""
    view_p = np.array([src.x, 0.0, 0.0], F32).astype(np.float64)
    view_r = np.eye(3, dtype=F32).astype(np.float64)
    cam_p = np.asarray(position, F32).astype(np.float64)
    cam_r = np.asarray(rotation, F32).astype(np.float64)
    c1 = (cam_r.T @ (view_p - cam_p)) * np.array([1.0, 1.0, -1.0])
    return c1, cam_r.T @ view_r


def pose_fields(rot1, c1, f1, f2, out_w, out_h, src_w, src_h):
    """The pose's homography p_ts (3, 3) and c_vec (3,), float64, one pose
    at a time (the pose pack's arithmetic)."""
    skr1 = FLIP @ np.asarray(rot1, np.float64).T @ FLIP
    fskr1 = np.diag([f1 / src_w, f1 / src_h, 1.0]) @ skr1
    fskr2 = np.diag([f2 / out_w, f2 / out_h, 1.0])
    return (fskr1 @ np.linalg.inv(fskr2),
            fskr1 @ (-np.asarray(c1, np.float64)))


def pose_pack(rot1, c1, f1, f2, out_w, out_h, src_w, src_h):
    """(16,) float32: p_ts row-major, c_vec, four zeros."""
    p_ts, c_vec = pose_fields(rot1, c1, f1, f2, out_w, out_h, src_w, src_h)
    out = np.zeros(16, np.float64)
    out[:9] = p_ts.reshape(-1)
    out[9:12] = c_vec
    return out.astype(F32)


def ladders(rots, c1s, f1, f2, out_w, out_h, src_w, src_h, izmin, izmax):
    """The batch's per-pose ladders at one shared K: ((B, K) float32,
    descending, K). Each pose steps at most STEP_PX pixels of source
    position (|DX| + |DY| over the image corners) a plane, its ladder
    padded above izmin to K; the corners' fields are worked out for the
    whole batch at once, as the planner does."""
    rot = np.stack([np.asarray(r, np.float64) for r in rots])
    s = np.array([1.0, 1.0, -1.0])
    skr1 = s[None, :, None] * s[None, None, :] * np.swapaxes(rot, 1, 2)
    fskr1 = np.array([f1 / src_w, f1 / src_h, 1.0])[None, :, None] * skr1
    p_ts = fskr1 * np.array([out_w / f2, out_h / f2, 1.0])[None, None, :]
    c_vec = np.einsum("bij,bj->bi", fskr1,
                      -np.stack([np.asarray(c, np.float64) for c in c1s]))
    sx = np.array([-0.5, 0.5, -0.5, 0.5])
    sy = np.array([-0.5, -0.5, 0.5, 0.5])
    den = (p_ts[:, 2, 0, None] * sx + p_ts[:, 2, 1, None] * sy
           + p_ts[:, 2, 2, None])
    qx = (p_ts[:, 0, 0, None] * sx + p_ts[:, 0, 1, None] * sy
          + p_ts[:, 0, 2, None]) / den
    qy = (p_ts[:, 1, 0, None] * sx + p_ts[:, 1, 1, None] * sy
          + p_ts[:, 1, 2, None]) / den
    dx = np.abs(c_vec[:, 0, None] - c_vec[:, 2, None] * qx) * src_w
    dy = np.abs(c_vec[:, 1, None] - c_vec[:, 2, None] * qy) * src_h
    ks = [min(MAX_PLANES,
              max(2, int(math.ceil(d * (izmin - izmax) / STEP_PX)) + 2))
          for d in (dx + dy).max(axis=1)]
    k = max(BUCKET, -(-max(ks) // BUCKET) * BUCKET)
    grids = []
    for k_pose in ks:
        k_real = min(k_pose, k)
        grid = np.linspace(izmin, izmax, k_real)
        if k > k_real:
            step = grid[0] - grid[1] if k_real > 1 else (izmin - izmax)
            top = izmin + step * np.arange(k - k_real, 0, -1,
                                           dtype=np.float64)
            grid = np.concatenate([top, grid])
        grids.append(grid)
    return np.stack(grids).astype(F32), k


def fields(pack, out_w, out_h, src_w, src_h, device):
    """Per output pixel the source position's affine coefficients AX, DX,
    AY, DY (each (out_h, out_w) float32): X = AX + v DX, Y = AY + v DY."""
    p = torch.as_tensor(pack, dtype=torch.float32, device=device)
    p = p[:12, None, None]
    jx = tdiv(torch.arange(out_w, dtype=torch.float32, device=device) + 0.5,
              out_w) - 0.5
    iy = tdiv(torch.arange(out_h, dtype=torch.float32, device=device) + 0.5,
              out_h) - 0.5
    sx, sy = jx[None, :], iy[:, None]
    den = p[6] * sx + p[7] * sy + p[8]
    qx = (p[0] * sx + p[1] * sy + p[2]) / den
    qy = (p[3] * sx + p[4] * sy + p[5]) / den
    ax = (qx + 0.5) * src_w - 0.5
    ay = (qy + 0.5) * src_h - 0.5
    dx = (p[9] - p[11] * qx) * src_w
    dy = (p[10] - p[11] * qy) * src_h
    return ax, dx, ay, dy


def bil(img, px, py):
    """Bilinear read of img (H, W) at float32 positions: the tap origin
    clamped to [0, W-2] x [0, H-2], the fractions to [0, 1], the four
    taps summed in this order; in img's precision."""
    h, w = img.shape
    x0 = torch.clamp(torch.floor(px), 0, w - 2)
    y0 = torch.clamp(torch.floor(py), 0, h - 2)
    fx = torch.clamp(px - x0, 0.0, 1.0).to(img.dtype)
    fy = torch.clamp(py - y0, 0.0, 1.0).to(img.dtype)
    xi, yi = x0.to(torch.int64), y0.to(torch.int64)
    return (img[yi, xi] * (1 - fx) * (1 - fy)
            + img[yi, xi + 1] * fx * (1 - fy)
            + img[yi + 1, xi] * (1 - fx) * fy
            + img[yi + 1, xi + 1] * fx * fy)


def secant(pd, d):
    """pd / min(pd - d, -1e-12), clipped to [0, 1]."""
    return torch.clamp(pd / torch.clamp(pd - d, max=-1e-12), 0.0, 1.0)


def march(disp, izmin, izmax, pack, ladder, out_w, out_h,
          dtype=torch.float32):
    """The depth-only target-ray march of one pose over its ladder (K,):
    per pixel the first plane k* (-1: none) whose texel lies in front of
    the plane's threshold, and invz* from the secant in [k*-1, k*] (0
    where none). Returns (k*, found, invz*)."""
    dev = disp.device
    dd = disp.to(dtype)
    h_s, w_s = disp.shape
    ax, dxf, ay, dyf = fields(pack, out_w, out_h, w_s, h_s, dev)
    vg = torch.as_tensor(ladder, dtype=torch.float32, device=dev)
    iz0, iz1 = F32(izmin), F32(izmax)
    tk = tdiv(vg - float(iz1), float(iz0 - iz1))
    zeros = torch.zeros((out_h, out_w), dtype=dtype, device=dev)
    kstar = torch.full((out_h, out_w), -1, dtype=torch.int64, device=dev)
    pdiffc, diffc, pdiff = zeros, zeros, zeros
    for k, (v, t) in enumerate(zip(vg.tolist(), tk.tolist())):
        diff = bil(dd, ax + v * dxf, ay + v * dyf) - t
        crossed = (kstar < 0) & (diff > 0.0)
        kstar = torch.where(crossed, k, kstar)
        pdiffc = torch.where(crossed, pdiff, pdiffc)
        diffc = torch.where(crossed, diff, diffc)
        pdiff = diff
    t = torch.where(kstar == 0, 1.0, secant(pdiffc, diffc))
    found = kstar >= 0
    v0 = vg[torch.clamp(kstar - 1, min=0)]
    v1 = vg[torch.clamp(kstar, min=0)]
    vstar = torch.where(found, v0 + t * (v1 - v0), 0.0)
    return kstar, found.to(torch.float32), vstar


def pack_rgbm(rgb, mask):
    """(H, W) int32: 10 bits a colour channel (rounded half to even) and
    one mask bit, as the program's fetch reads its source."""
    q = torch.clamp(torch.round(rgb.to(torch.float32) * 1023.0), 0, 1023)
    q = q.to(torch.int32)
    m = (mask > 0.5).to(torch.int32)
    return (q[..., 0] << 21) | (q[..., 1] << 11) | (q[..., 2] << 1) | m


def unpack_rgbm(packed, dtype):
    scale = torch.full((), 1023.0, dtype=torch.float32, device=packed.device)
    chans = [((packed >> s) & 1023).to(torch.float32) / scale
             for s in (21, 11, 1)]
    chans.append((packed & 1).to(torch.float32))
    return torch.stack(chans, dim=-1).to(dtype)


def fetch(packed, u, v, w, h, dtype=torch.float32):
    """Bilinear read of the packed source at normalized (u, v), clamped
    to the edge, a lerp weight zeroed where both taps clamp onto one
    texel: (..., 4) [r, g, b, mask]."""
    sx, sy = u * w - 0.5, v * h - 0.5
    fl_x, fl_y = torch.floor(sx), torch.floor(sy)
    x0, y0 = fl_x.to(torch.int64), fl_y.to(torch.int64)
    fx = torch.where((x0 >= 0) & (x0 < w - 1), sx - fl_x, 0.0)
    fy = torch.where((y0 >= 0) & (y0 < h - 1), sy - fl_y, 0.0)
    fx, fy = fx[..., None].to(dtype), fy[..., None].to(dtype)
    ix0, iy0 = torch.clamp(x0, 0, w - 1), torch.clamp(y0, 0, h - 1)
    ix1, iy1 = torch.clamp(x0 + 1, 0, w - 1), torch.clamp(y0 + 1, 0, h - 1)
    t00 = unpack_rgbm(packed[iy0, ix0], dtype)
    t01 = unpack_rgbm(packed[iy0, ix1], dtype)
    t10 = unpack_rgbm(packed[iy1, ix0], dtype)
    t11 = unpack_rgbm(packed[iy1, ix1], dtype)
    top = t00 + (t01 - t00) * fx
    bot = t10 + (t11 - t10) * fx
    return top + (bot - top) * fy


def edge_alpha(found, u, v, feathering):
    """The hit test and the edge taper at the solved source position
    (mask mode 'none')."""
    inside = ((u > 0.0) & (u < 1.0) & (v > 0.0) & (v < 1.0)).to(
        torch.float32)
    f = max(float(feathering), 1e-6)
    tap = (smoothstep(0.0, f, u) * (1.0 - smoothstep(1.0 - f, 1.0, u))
           * smoothstep(0.0, f, v) * (1.0 - smoothstep(1.0 - f, 1.0, v)))
    return found * inside * tap


def composite(rgba, alpha):
    """The layer premultiplied over a transparent black background, then
    over the background again with the sRGB curve (one layer): (H, W, 4)
    float32."""
    layer = finish(rgba[..., :3] * alpha[..., None], alpha, False)
    return finish(layer[..., :3], layer[..., 3], True).float()


def start_plane(ladder, top) -> int:
    """The first plane a march visits: one before the first plane whose
    threshold or depth (descending ladder) is not above `top`."""
    reach = np.flatnonzero(~(np.asarray(ladder) > top))
    return max(int(reach[0]) - 1 if len(reach) else len(ladder) - 1, 0)


def work(kstar, found, k_start, k, source_texels) -> dict:
    """The work of one frame's march: the planes a first-crossing walk
    from k_start visits (through each pixel's crossing, or every plane
    from k_start where it finds none), pixels, crossings, the source
    texels and the output pixels."""
    walked = torch.where(kstar >= 0, kstar - k_start + 1, k - k_start)
    return {"planes": int(walked.clamp(1, k).sum()),
            "pixels": int(kstar.numel()), "found": int(found.sum()),
            "source_texels": int(source_texels),
            "out_px": int(kstar.numel())}


def render(src, j, positions, rotations, config, dtype=torch.float32):
    """The frame of camera j of a batch of cameras at `positions` (B, 3)
    with `rotations` (B, 3, 3), rendered from one projector
    (reference.lateral.Source) on the target tier: (H, W, 4) sRGB RGBA
    and the work of its march."""
    out_w, out_h = config["width"], config["height"]
    f2 = float(F32(config["focal_ratio"] * out_w))
    h_s, w_s = src.disp.shape
    if out_w % 128:
        raise ValueError("the target tier renders widths divisible by 128")
    poses = [relative_pose(src, p, r) for p, r in zip(positions, rotations)]
    c1s, rots = zip(*poses)
    grids, k = ladders(rots, c1s, src.focal, f2, out_w, out_h, w_s, h_s,
                       src.izmin, src.izmax)
    pack = pose_pack(rots[j], c1s[j], src.focal, f2, out_w, out_h, w_s, h_s)
    kstar, found, vstar = march(src.disp, src.izmin, src.izmax, pack,
                                grids[j], out_w, out_h, dtype)
    ax, dxf, ay, dyf = fields(pack, out_w, out_h, w_s, h_s, src.disp.device)
    iz0, iz1 = F32(src.izmin), F32(src.izmax)
    vc = torch.clamp(vstar, float(iz1), float(iz0))
    u = tdiv(ax + vc * dxf + 0.5, w_s)
    v = tdiv(ay + vc * dyf + 0.5, h_s)
    rgba = fetch(pack_rgbm(src.rgb, torch.ones_like(src.disp)), u, v, w_s,
                 h_s, dtype)
    alpha = edge_alpha(found, u, v, config["render_config"]["feathering"])
    m = float(src.disp.max())
    top = F32(m) + F32(abs(m)) * F32(SLACK) + F32(1e-30)
    tk = (grids[j] - iz1) / (iz0 - iz1)
    return composite(rgba, alpha), work(kstar, found, start_plane(tk, top),
                                        k, src.disp.numel())
