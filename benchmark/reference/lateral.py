"""Plain-PyTorch reference of the lateral fast tier: the frames that
render_fast_batch(method="march"), render_fast_view and
render_fused_fast_batch give for unrotated, unskewed single-layer
projectors and x-only camera offsets.

A frozen copy of the program's plain twin (the snap-plane ladder, the
translation plan, the first-crossing march with its secant and colour
lerp, the hit test, the edge taper, over-compositing, the
nearest-surface fusion merge and the sRGB curve), written here so that a
change to the program cannot move the yardstick. It imports nothing of
the program: every plane table, plan and padded source is worked out
again from the inputs the benchmark made.

Scope: march_refine 0, snap planes of stride 1, mask mode 'none' (a
one-layer projector), output widths divisible by 8, no frustum skew, no
outpaint margin. `dtype` sets the precision of every device tensor; the
benchmark's control runs it in bfloat16.

render_slot is what the harness calls: one sampled frame's reference and
the work of its marches, which the kernels' roofline reader counts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = np.float32
SNAP_BUCKET = 64
SNAP_MAX_PLANES = 1024


def snap_plane_table(f1, cx, izmin, izmax, num_planes=None,
                     bucket=SNAP_BUCKET, max_planes=SNAP_MAX_PLANES):
    """Planes (descending inverse depth, float32) where the warp shift
    f1*|cx|*invz is an integer number of pixels, plus the range ends,
    padded above izmin to K planes (K bucketed to `bucket` unless given).
    Returns (planes (K,), K)."""
    a = -float(f1) * float(cx)
    r = izmin - izmax
    cap = min(max_planes, num_planes) if num_planes else max_planes
    if abs(a) * r < 1.0 or cap < 4:
        grid = [izmin, izmax]
    else:
        s_lo, s_hi = sorted((a * izmax, a * izmin))
        m_lo, m_hi = math.ceil(s_lo), math.floor(s_hi)
        stride = 1
        while (m_hi - m_lo) // stride + 3 > cap:
            stride *= 2
        vals = np.arange(m_lo, m_hi + 1, stride, dtype=np.float64) / a
        vals = np.sort(vals)[::-1]
        eps = r * 1e-7
        grid = [izmin] + [float(v) for v in vals
                          if izmax + eps < v < izmin - eps] + [izmax]
    k_real = len(grid)
    k_tot = num_planes or max(bucket, -(-k_real // bucket) * bucket)
    step_top = grid[0] - grid[1]
    top = izmin + step_top * np.arange(k_tot - k_real, 0, -1,
                                       dtype=np.float64)
    return (np.concatenate([top, np.asarray(grid, np.float64)]).astype(F32),
            k_tot)


def ladder_size(f1, cxs, izmin, izmax):
    """The K that a batch of lateral offsets cxs shares: the largest
    bucketed ladder of any of them."""
    return max(snap_plane_table(f1, cx, izmin, izmax)[1] for cx in cxs)


def _bucket(n, q=64):
    return int(math.ceil(max(n, 1) / q)) * q


class Plan:
    """The padded source's geometry for shifts up to max_shift pixels:
    the left and top pads and the spans of the window starts."""

    def __init__(self, w, h, max_shift):
        sx = _bucket(int(math.ceil(abs(max_shift))) + 2)
        sy = _bucket(2)
        self.w, self.h = w, h
        self.pad_lo_x, self.pad_lo_y = sx, sy
        self.span_x, self.span_y = 2 * sx, 2 * sy
        self.pad_hi_x = max(0, self.span_x + -(-(w + 1) // 128) * 128 - w
                            - sx)
        self.pad_hi_y = max(0, h + self.span_y + 16 - h - sy)


def plan_for(f1, izmin, w, h, max_cx):
    """The plan of a batch whose largest |x offset| is max_cx."""
    return Plan(w, h, min(f1 * max_cx * izmin, float(w + w)))


def _edge_pad(a, lo_y, hi_y, lo_x, hi_x):
    h, w = a.shape[-2], a.shape[-1]
    rows = torch.clamp(torch.arange(-lo_y, h + hi_y, device=a.device), 0,
                       h - 1)
    cols = torch.clamp(torch.arange(-lo_x, w + hi_x, device=a.device), 0,
                       w - 1)
    return a.index_select(-2, rows).index_select(-1, cols)


def _window_starts(plan, planes, cx, f1):
    """Per-plane integer window starts and fractions of the x warp, in
    float32 at any working precision; the y warp is 0 for a lateral
    pose, so its start is the top pad."""
    invz = planes.float()
    fc = float(F32(f1) * F32(cx))
    tx = 0.0 - fc * invz + plan.pad_lo_x
    tx_r = torch.round(tx)
    tx = torch.where(torch.abs(tx - tx_r) < 1e-3, tx_r, tx)
    tx = torch.clamp(tx, 0.0, plan.span_x - 1e-3)
    ix = torch.floor(tx)
    frac = tx - ix
    # the warp is read at t = ix + fx rounded to the working precision
    t = ix + frac
    i = torch.floor(t)
    return i.to(torch.int64).tolist(), (t - i).tolist()


def march(rgb, disp, izmin, izmax, cx, f1, planes, plan, dtype=torch.float32):
    """First-crossing march of one pose over its ladder `planes` (K,):
    (found, invz*, rgba*) with rgba* the colour (and mask) lerped at the
    secant's crossing. rgb (H, W, 3), disp (H, W) in [0, 1]."""
    dev = disp.device
    h, w = disp.shape
    planes_t = torch.as_tensor(planes, device=dev)
    ix, fx = _window_starts(plan, planes_t, cx, f1)
    iy = plan.pad_lo_y
    izmin32, izmax32 = F32(izmin), F32(izmax)
    dsc = float(izmin32 - izmax32)
    pads = (plan.pad_lo_y, plan.pad_hi_y, plan.pad_lo_x, plan.pad_hi_x)
    src = torch.cat([rgb.permute(2, 0, 1), torch.ones_like(disp)[None],
                     disp[None]]).to(dtype)
    src = _edge_pad(src, *pads)  # (5, Hp, Wp): r, g, b, mask, disp
    rows = src[:, iy:iy + h]
    iz_h = torch.as_tensor(planes).to(dtype).float().numpy()

    def warp(k):
        i, f = ix[k], F32(fx[k])
        w0, w1 = float(F32(1.0) - f), float(f)
        tex = rows[:, :, i:i + w] * w0 + rows[:, :, i + 1:i + 1 + w] * w1
        return tex[4] * dsc + float(izmax32), tex[:4]

    zeros = torch.zeros((h, w), dtype=dtype, device=dev)
    found, invz_star = zeros.clone(), zeros.clone()
    rgba_star = torch.zeros((4, h, w), dtype=dtype, device=dev)
    prev_diff, prev_rgba = zeros.clone(), rgba_star.clone()
    for k in range(len(iz_h)):
        d, rgba = warp(k)
        diff = d - float(iz_h[k])
        crossed = (found < 0.5) & (diff > 0.0)
        t = torch.clamp(prev_diff / torch.clamp(prev_diff - diff,
                                                max=-1e-12), 0.0, 1.0)
        s_star = torch.ones_like(t) if k == 0 else t
        rgba_c = prev_rgba + s_star[None] * (rgba - prev_rgba)
        prev_iz = iz_h[max(k - 1, 0)]
        iz_c = float(prev_iz) + s_star * float(iz_h[k] - prev_iz)
        invz_star = torch.where(crossed, iz_c, invz_star)
        rgba_star = torch.where(crossed[None], rgba_c, rgba_star)
        found = torch.maximum(found, crossed.to(dtype))
        prev_diff, prev_rgba = diff, rgba
    return found, invz_star, rgba_star.permute(1, 2, 0)


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def hit_alpha(found, invz_star, cx, f1, feathering):
    """The hit test and the edge taper at the solved source position
    (mask mode 'none')."""
    h, w = found.shape
    dev, dt = found.device, found.dtype
    jx = torch.arange(w, dtype=dt, device=dev)[None, :]
    iy = torch.arange(h, dtype=dt, device=dev)[:, None]
    gx = jx - float(F32(f1) * F32(cx)) * invz_star
    u = (gx + 0.5) / w
    v = (iy + 0.5) / h
    inside = ((u > 0.0) & (u < 1.0) & (v > 0.0) & (v < 1.0)).to(dt)
    f = max(float(feathering), 1e-6)
    taper = (smoothstep(0.0, f, u) * (1.0 - smoothstep(1.0 - f, 1.0, u))
             * smoothstep(0.0, f, v) * (1.0 - smoothstep(1.0 - f, 1.0, v)))
    return found * inside * taper


def linear_to_srgb(x):
    return torch.where(
        x <= 0.0031308, x * 12.92,
        1.055 * torch.pow(torch.clamp(x, min=1e-12), 1.0 / 2.4) - 0.055)


def finish(rgb_premult, alpha, to_srgb):
    """Over a transparent black background, then the sRGB curve:
    (H, W, 4)."""
    out_rgb = 0.0 * (1.0 - alpha[..., None]) + rgb_premult
    out_a = 0.0 + alpha * (1.0 - 0.0)
    if to_srgb:
        out_rgb = linear_to_srgb(out_rgb)
    return torch.cat([out_rgb, out_a[..., None]], dim=-1)


class Source:
    """One projector's textures and constants as the reference reads
    them: rgb (H, W, 3) linear, disp (H, W) in [0, 1], the focal in
    pixels, the world x position and the baseline-normalized inverse
    depth range."""

    def __init__(self, rgb, disp, focal, x, invz_near, invz_far, baseline):
        self.rgb, self.disp = rgb, disp
        self.focal, self.x = float(F32(focal)), float(x)
        # the ranges divided in float64, the x positions stored in float32
        b = float(F32(baseline))
        self.izmin = float(F32(invz_near)) / b
        self.izmax = float(F32(invz_far)) / b

    def offset(self, cam_x):
        """The projector's x in the camera's frame (float64 of the float32
        positions); the device arithmetic rounds it to float32."""
        return float(F32(self.x)) - float(F32(cam_x))

    def layer(self, cam_x, batch_xs, dtype):
        """This projector's march of the camera at cam_x, in a batch of
        cameras at batch_xs (None: a single view, whose ladder is sized
        alone): (found, invz*, rgba*, planes)."""
        cx = self.offset(cam_x)
        if batch_xs is None:
            cxs, k = [cx], None
        else:
            cxs = [self.offset(x) for x in batch_xs]
            k = ladder_size(self.focal, cxs, self.izmin, self.izmax)
        planes, _ = snap_plane_table(self.focal, cx, self.izmin, self.izmax,
                                     num_planes=k)
        h, w = self.disp.shape
        plan = plan_for(self.focal, self.izmin, w, h,
                        max(abs(c) for c in cxs))
        found, izs, rgba = march(self.rgb, self.disp, self.izmin, self.izmax,
                                 cx, self.focal, planes, plan, dtype)
        return found, izs, rgba, planes


def render(src, cam_x, batch_xs, feathering=0.1, dtype=torch.float32):
    """The frame of the camera at cam_x rendered from one projector, in a
    call whose cameras sit at batch_xs: (H, W, 4) sRGB RGBA and the march
    (found, invz*, planes) the work counts read."""
    found, izs, rgba, planes = src.layer(cam_x, batch_xs, dtype)
    alpha = hit_alpha(found, izs, F32(src.offset(cam_x)), src.focal,
                      feathering)
    layer = finish(rgba[..., :3] * alpha[..., None], alpha, False)
    frame = finish(layer[..., :3], layer[..., 3], True)
    return frame.float(), [(found, izs, planes)]


def fusion_weights(key, best, hit, tol):
    """Triangular weights in relative inverse-depth distance from the
    frontmost hit: 1 at the front, 0 at best*(1 - tol); non-hits 0."""
    if tol <= 0.0:
        return (hit & (key >= best)).to(key.dtype)
    edge = torch.abs(best) * tol
    gap = best - key
    w = 1.0 - gap / torch.clamp(edge, min=1e-30)
    w = torch.where(torch.isfinite(key), torch.clamp(w, 0.0, 1.0), 0.0)
    return torch.where(hit, w, 0.0)


def render_fused(srcs, cam_x, batch_xs, fuse_tol, feathering=0.1,
                 dtype=torch.float32):
    """The fused frame of the camera at cam_x from every projector of
    srcs: each projector's march and alpha, then the nearest-surface
    merge with tolerance fuse_tol. Returns (frame, marches)."""
    rgbs, alphas, fronts, marches = [], [], [], []
    for src in srcs:
        found, izs, rgba, planes = src.layer(cam_x, batch_xs, dtype)
        alpha = hit_alpha(found, izs, F32(src.offset(cam_x)), src.focal,
                          feathering)
        rgbs.append(alpha[..., None] * rgba[..., :3])
        alphas.append(alpha)
        fronts.append(torch.where(alpha > 0.0, izs, 0.0))
        marches.append((found, izs, planes))
    rgb_s, a_s = torch.stack(rgbs), torch.stack(alphas)
    hit = a_s > 0.0
    key = torch.where(hit, torch.stack(fronts), -torch.inf)
    best = key.amax(dim=0)
    w = fusion_weights(key, best, hit, fuse_tol)
    wsum = torch.clamp(w.sum(dim=0), min=1e-12)
    color = (w[..., None] * rgb_s).sum(dim=0) / wsum[..., None]
    alpha = (w * a_s).sum(dim=0) / wsum
    alpha = torch.where(torch.isfinite(best), alpha, 0.0)
    return finish(color, alpha, True).float(), marches


def render_slot(srcs, slot, config, options, dtype=torch.float32):
    """The reference of one sampled frame (slot: its frame, its index j in
    the call and the call's poses) and the work of its marches,
    {"lateral_march": counts}. options["ladder"]: "call" where the entry
    sizes the ladder over the whole call (the batches), "view" where each
    view sizes its own."""
    rc = config["render_config"]
    if (rc.get("plane_mode", "snap") != "snap" or rc.get("march_refine", 0)
            or rc.get("march_stride", 1) != 1):
        raise ValueError("the lateral reference marches snap planes of "
                         "stride 1 without refinement")
    pos = np.asarray(slot.poses["position"], np.float64)
    rot = slot.poses.get("rotation")
    if pos[:, 1:].any() or (rot is not None
                            and not np.allclose(rot, np.eye(3))):
        raise ValueError("the lateral reference takes x-only, unrotated "
                         "cameras")
    x = float(pos[slot.j, 0])
    xs = [float(v) for v in pos[:, 0]] if options["ladder"] == "call" else None
    if len(srcs) == 1:
        frame, marches = render(srcs[0], x, xs, rc["feathering"], dtype)
    else:
        frame, marches = render_fused(srcs, x, xs, rc["fuse_tol"],
                                      rc["feathering"], dtype)
    return frame, {"lateral_march": march_work(srcs, marches)}


def planes_walked(found, invz, planes, v_top) -> int:
    """Planes a first-crossing march visits over one (H, W) pose, from
    the plane before the first one a texel can reach (inverse depth at
    most v_top) through the crossing, or every reachable plane where it
    finds none."""
    k = planes.shape[0]
    asc = torch.sort(torch.as_tensor(planes, device=invz.device)
                     .float()).values
    top = torch.tensor([float(v_top)], device=asc.device)
    skipped = k - int(torch.searchsorted(asc, top, right=True))
    above = k - torch.searchsorted(asc, invz.reshape(-1).float().contiguous(),
                                   right=True)
    walked = torch.where(found.reshape(-1) > 0, above + 1, k) - skipped
    return int(walked.clamp(1, k).sum())


def march_work(srcs, marches) -> dict:
    """The work of one output frame's marches, summed over its
    projectors: planes visited, pixels, pixels that found a crossing,
    the source texels read and the output pixels written."""
    counts = {"planes": 0, "pixels": 0, "found": 0, "source_texels": 0,
              "out_px": int(marches[0][0].numel())}
    for src, (found, invz, planes) in zip(srcs, marches):
        v_top = src.izmax + float(src.disp.max()) * (src.izmin - src.izmax)
        counts["planes"] += planes_walked(found, invz, planes, v_top)
        counts["pixels"] += int(found.numel())
        counts["found"] += int((found > 0).sum())
        counts["source_texels"] += int(src.disp.numel())
    return counts
