"""Connected-mesh triangle rasterizer: the reference's default mesh mode.

The counterpart of lif_tpu.ops.mesh (reference: src/shaders/holoVertex.glsl
:68-102 corner depths, :155-163 corner unprojection, :192-229 gradient
cull; topology from src/HoloRenderer.ts:809-858 — a (W+1)x(H+1) corner
grid, each pixel quad split into triangles (TL, BL, TR) and (TR, BL, BR)).

Dense PyTorch on any device, in lif_tpu's three passes over every
triangle's max_quad_px x max_quad_px candidate window: a scatter-min of the
depth key (-q, q = 1/w), a scatter-min of the candidate id among the depth
winners, then the unique winner adds its perspective-correct colour with
index_add_ (the only nonzero addend of its pixel, so the sum is exact in
any order, atomics included). Corner depths and colours are the 4-pixel
averages of ops.splat's decoded depth and the source colour. Quads whose
projection exceeds the window are culled, as in lif_tpu (module docstring
there). Float32 with tensor divisors, as ops.splat.
"""

from __future__ import annotations

import torch

from ..core.color import linear_to_srgb
from .splat import _decode_depth, _f32, _floor_index, _invz_range, view_arguments

__all__ = ["render_connected_mesh", "render_mesh_connected_view"]

# triangles of the quad (TL=(0,0), TR=(0,1), BL=(1,0), BR=(1,1)):
# (TL, BL, TR) and (TR, BL, BR). HoloRenderer.ts:842-848.
_TRIS = (
    ((0, 0), (1, 0), (0, 1)),
    ((0, 1), (1, 0), (1, 1)),
)
_NO_ID = 2**31 - 1


def _corner_average(field):
    """(H, W, ...) pixel-centre field -> (H+1, W+1, ...) corner field: the
    mean of the <=4 adjacent pixels, edge-clamped
    (reference: holoVertex.glsl:68-102)."""
    h, w = field.shape[:2]
    rows = torch.arange(-1, h + 1, device=field.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=field.device).clamp(0, w - 1)
    f = field.index_select(0, rows).index_select(1, cols)
    return 0.25 * (f[:-1, :-1] + f[:-1, 1:] + f[1:, :-1] + f[1:, 1:])


def render_connected_mesh(
    rgb,
    disp,
    invz_min,
    invz_max,
    baseline,
    fx,
    fy,
    cx,
    cy,
    rel_rotation,
    rel_position,
    f2,
    out_w: int,
    out_h: int,
    background,
    delta_invz_threshold=0.0,
    max_quad_px: int = 4,
    to_srgb: bool = True,
    show_depth=False,
):
    """Rasterize one source layer as a connected triangle mesh.

    Args as ops.splat.forward_splat, with max_quad_px the candidate window
    (quads projecting larger are culled) in place of the footprint. The
    gradient cull drops VERTICES whose 5-sample invZ range exceeds the
    threshold, and with them the triangles using them.

    Returns (out_h, out_w, 4) float32, GL-oriented, on rgb's device.
    """
    dev = disp.device
    dtype = torch.float32
    h, w = disp.shape
    disp = disp.to(dtype)
    S = max_quad_px
    invz_min, invz_max = _f32(invz_min, dev), _f32(invz_max, dev)
    fx, fy, f2 = _f32(fx, dev), _f32(fy, dev), _f32(f2, dev)
    cx, cy = _f32(cx, dev), _f32(cy, dev)

    depth = _decode_depth(disp, invz_min, invz_max, _f32(baseline, dev))
    cdepth = _corner_average(depth)  # (H+1, W+1)
    if show_depth:
        ccolor = _corner_average(disp)[..., None].expand(h + 1, w + 1, 3)
    else:
        ccolor = _corner_average(rgb.to(dtype))  # (H+1, W+1, 3)

    # corner unprojection at the corner coordinate (no +0.5);
    # reference: holoVertex.glsl:155-163
    gx = torch.arange(w + 1, dtype=dtype, device=dev)[None, :]
    gy = torch.arange(h + 1, dtype=dtype, device=dev)[:, None]
    x_cam = (gx - cx) * cdepth / fx
    y_cam = (gy - cy) * cdepth / fy
    z_cam = -cdepth

    r = _f32(rel_rotation, dev)
    t = _f32(rel_position, dev)
    xv = r[0, 0] * x_cam + r[0, 1] * y_cam + r[0, 2] * z_cam + t[0]
    yv = r[1, 0] * x_cam + r[1, 1] * y_cam + r[1, 2] * z_cam + t[1]
    zv = r[2, 0] * x_cam + r[2, 1] * y_cam + r[2, 2] * z_cam + t[2]

    vvalid = zv < -0.001  # reference: holoVertex.glsl:187-189
    if delta_invz_threshold is not None:
        # corner (i, j) takes pixel (min(i, H-1), min(j, W-1))
        delta = _invz_range(disp, invz_min, invz_max)
        delta_c = torch.nn.functional.pad(
            delta[None, None], (0, 1, 0, 1), mode="replicate")[0, 0]
        thr = _f32(delta_invz_threshold, dev)
        vvalid = vvalid & ((thr <= 0.0) | (delta_c <= thr))

    # perspective projection; q = 1/w (positive in front of the camera)
    q = _f32(1.0, dev) / torch.clamp(-zv, min=1e-9)
    u = f2 * xv * q + out_w / 2.0
    v = f2 * yv * q + out_h / 2.0

    def gv(a, di, dj):  # corner grid -> per-quad vertex arrays (H, W, ...)
        return a[di : di + h, dj : dj + w]

    def cover(us, vs, px, py):
        """Edge-function barycentrics at pixel centre (px, py)."""
        ax, ay, bx, by, cx_, cy_ = us[0], vs[0], us[1], vs[1], us[2], vs[2]
        area = (bx - ax) * (cy_ - ay) - (by - ay) * (cx_ - ax)
        w0 = (cx_ - bx) * (py - by) - (cy_ - by) * (px - bx)
        w1 = (ax - cx_) * (py - cy_) - (ay - cy_) * (px - cx_)
        w2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        denom = torch.where(area.abs() < 1e-12, 1.0, area)
        l0, l1, l2 = w0 / denom, w1 / denom, w2 / denom
        # small negative tolerance: a pixel centre exactly on the shared
        # diagonal must not fall through both triangles to rounding
        eps = -1e-4
        inside = ((area.abs() > 1e-12) & (l0 >= eps) & (l1 >= eps)
                  & (l2 >= eps))
        return inside, (l0, l1, l2)

    # per triangle: its vertex arrays and S x S candidate window anchor
    per_tri = []
    for tri in _TRIS:
        us = [gv(u, *c) for c in tri]
        vs = [gv(v, *c) for c in tri]
        qs = [gv(q, *c) for c in tri]
        cs = [gv(ccolor, *c) for c in tri]
        ok = gv(vvalid, *tri[0]) & gv(vvalid, *tri[1]) & gv(vvalid, *tri[2])
        umin = torch.minimum(torch.minimum(us[0], us[1]), us[2])
        umax = torch.maximum(torch.maximum(us[0], us[1]), us[2])
        vmin = torch.minimum(torch.minimum(vs[0], vs[1]), vs[2])
        vmax = torch.maximum(torch.maximum(vs[0], vs[1]), vs[2])
        fits = (umax - umin < S) & (vmax - vmin < S)
        # first pixel centre >= umin: floor(umin - 0.5) + 1
        iu0 = _floor_index(umin - 0.5) + 1
        iv0 = _floor_index(vmin - 0.5) + 1
        per_tri.append((us, vs, qs, cs, iu0, iv0, ok & fits))

    def candidates():
        """Every (triangle, window offset) candidate: its coverage,
        barycentrics, interpolated q, flat target index and candidate id,
        in lif_tpu's order (recomputed per pass, as there)."""
        tri_id = torch.arange(h * w, device=dev).reshape(h, w)
        for ti, (us, vs, qs, cs, iu0, iv0, tok) in enumerate(per_tri):
            for dy in range(S):
                for dx in range(S):
                    px = iu0.to(dtype) + dx + 0.5
                    py = iv0.to(dtype) + dy + 0.5
                    inside, (l0, l1, l2) = cover(us, vs, px, py)
                    qi = l0 * qs[0] + l1 * qs[1] + l2 * qs[2]
                    pu, pv = iu0 + dx, iv0 + dy
                    inb = (pu >= 0) & (pu < out_w) & (pv >= 0) & (pv < out_h)
                    live = tok & inside & inb & (qi > 0.0)
                    fi = (pv.clamp(0, out_h - 1) * out_w
                          + pu.clamp(0, out_w - 1)).reshape(-1)
                    cid = ((tri_id * len(_TRIS) + ti) * (S * S) + dy * S
                           + dx).reshape(-1)
                    yield live, fi, qi, cid, (l0, l1, l2), qs, cs

    n_out = out_h * out_w
    # pass 1: z-buffer scatter-min (key = -q: the nearer target surface has
    # the larger q, like the GPU's depth test, monotone in 1/w)
    zbuf = torch.full((n_out,), torch.inf, dtype=dtype, device=dev)
    for live, fi, qi, *_ in candidates():
        key = torch.where(live, -qi, torch.inf).reshape(-1)
        zbuf.scatter_reduce_(0, fi, key, "amin", include_self=True)

    # pass 2: deterministic winner id (the lowest candidate id among ties)
    idbuf = torch.full((n_out,), _NO_ID, dtype=torch.int64, device=dev)
    for live, fi, qi, cid, *_ in candidates():
        key = torch.where(live, -qi, torch.inf).reshape(-1)
        won = (key <= zbuf[fi]) & torch.isfinite(key)
        idbuf.scatter_reduce_(0, fi, torch.where(won, cid, _NO_ID), "amin",
                              include_self=True)

    # pass 3: the unique winner adds its perspective-correct colour
    out_rgb = torch.zeros((n_out, 3), dtype=dtype, device=dev)
    for live, fi, qi, cid, (l0, l1, l2), qs, cs in candidates():
        sel = live.reshape(-1) & (idbuf[fi] == cid)
        qsafe = torch.clamp(qi, min=1e-12)
        # c = sum(l c q) / sum(l q)
        col = (
            l0[..., None] * cs[0] * qs[0][..., None]
            + l1[..., None] * cs[1] * qs[1][..., None]
            + l2[..., None] * cs[2] * qs[2][..., None]
        ) / qsafe[..., None]
        out_rgb.index_add_(0, fi, torch.where(sel[:, None],
                                              col.reshape(-1, 3), 0.0))

    hit = idbuf < _NO_ID
    bg = _f32(background, dev)
    rgb_img = torch.where(hit[:, None], out_rgb, bg[:3] * bg[3])
    a_img = torch.where(hit, 1.0, bg[3])
    if to_srgb:
        rgb_img = linear_to_srgb(rgb_img)
    return torch.cat(
        [rgb_img.reshape(out_h, out_w, 3), a_img.reshape(out_h, out_w, 1)],
        dim=-1,
    )


def render_mesh_connected_view(
    projector,
    camera,
    background=(0.0, 0.0, 0.0, 0.0),
    delta_invz_threshold=0.0,
    max_quad_px: int = 4,
    to_srgb: bool = True,
    show_depth=False,
):
    """Connected-mesh render of a Projector into a Camera (layer 0, like
    the reference's mesh mode; HoloRenderer.ts:186-189), on the
    projector's device. Returns (H, W, 4) GL-oriented."""
    return render_connected_mesh(
        *view_arguments(projector, camera),
        out_w=camera.width, out_h=camera.height, background=background,
        delta_invz_threshold=delta_invz_threshold, max_quad_px=max_quad_px,
        to_srgb=to_srgb, show_depth=show_depth,
    )
