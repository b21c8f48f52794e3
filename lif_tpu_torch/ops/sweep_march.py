"""Gather-free first-crossing plane march for translated views.

The counterpart of lif_tpu.ops.sweep_march: the production fast renderer.
For an ALIGNED view (no relative rotation or skew) with matched focal
(f1 == f2), the source coordinate of the ray through output pixel j at
inverse depth invZ is

    gx(j, invZ) = j + (w1 - out_w)/2 - f1 * c1.x * invZ      (pixels)

— a PURE TRANSLATION of the source image per inverse-depth plane.
Sweeping K planes near -> far and detecting the FIRST crossing of the
warped disparity over the plane's inverse depth reproduces the exact ray
march's root; the crossing is refined by a secant between the
bracketing planes, and the color is the matching lerp of the two
planes' warped colors. On integer-parallax snap planes
(snap_plane_table) every warp is an exact integer translate, so the
sweep solves the continuous first-crossing problem for bilinear sources
exactly (up to f32).

Two implementations share the plan and tables:
  * march_translation_plain — a Python loop over planes in plain torch,
    the kernel's plain version; with _finalize it is the twin
    render_translation_plain of lif_tpu's XLA oracle, the CPU path;
  * lif_tpu_torch.ops.cuda.sweep_march — the hand-written CUDA kernel
    (csrc/sweep_march.cu), the path of every CUDA tensor.
render_translation_batch dispatches on the device of the textures.

Border semantics: the source is edge-replicate padded (the kernel clamps
its column index instead, which reads the same values).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import composite as _composite
from .sweep_target import SKIP_SLACK, WARP

__all__ = [
    "TranslationPlan",
    "hit_and_alpha",
    "march_translation_plain",
    "march_translation_skip_plain",
    "pad_sources",
    "plane_tables",
    "preshift_source",
    "render_translation",
    "render_translation_batch",
    "render_translation_plain",
    "row_skip_tables",
    "snap_plane_table",
    "snap_plane_tables_batch",
    "translation_plan",
]

_F32 = np.float32


def snap_plane_table(
    f1: float,
    cx: float,
    izmin: float,
    izmax: float,
    num_planes: int | None = None,
    bucket: int = 64,
    max_planes: int = 1024,
    phase_px: float = 0.0,
    stride: int = 1,
):
    """Integer-parallax plane grid for one lateral pose (host math).

    Planes are placed where the warp shift f1*|cx|*invz is an INTEGER
    number of pixels, plus the range endpoints. At integer shifts the
    bilinear warp degenerates to an exact copy, and a warp at any
    fractional shift t+f IS (1-f)*T_t + f*T_{t+1} of the neighbouring
    integer translates — so between adjacent planes the warped disparity
    is exactly linear in the sweep parameter, the first-crossing secant
    is exact, and the color lerp equals the bilinear fetch at the solved
    position.

    Returns (plane_invz float32 (K,), K) with K bucketed up to a multiple
    of `bucket`; padding planes are prepended ABOVE izmin (their texel
    thresholds exceed 1, so no pixel ever crosses there). If the integer
    count would exceed max_planes, integers are subsampled at 2-, 4-, ...
    pixel stride (still phase-aligned, so warps stay exact; only bracket
    width grows). When num_planes is given it overrides the bucketed size
    (must be >= the snap count after subsampling).
    """
    a = -float(f1) * float(cx)  # total shift(invz) = a*invz + phase_px
    s = abs(a)
    r = izmin - izmax
    cap = min(max_planes, num_planes) if num_planes else max_planes
    if s * r < 1.0 or cap < 4:
        # sub-pixel total parallax: the endpoints alone are exact (the
        # whole range is one linear bracket)
        grid = [izmin, izmax]
    else:
        # planes where the TOTAL shift a*invz + phase_px is an integer
        s_lo, s_hi = sorted((a * izmax + phase_px, a * izmin + phase_px))
        m_lo = math.ceil(s_lo)
        m_hi = math.floor(s_hi)
        stride = max(1, int(stride))
        while (m_hi - m_lo) // stride + 3 > cap:
            stride *= 2
        vals = (
            np.arange(m_lo, m_hi + 1, stride, dtype=np.float64) - phase_px
        ) / a
        vals = np.sort(vals)[::-1]  # descending invz
        grid = [izmin]
        eps = r * 1e-7
        for v in vals:
            if izmax + eps < v < izmin - eps:
                grid.append(float(v))
        grid.append(izmax)
    k_real = len(grid)
    k_tot = num_planes if num_planes else max(bucket, _round_up(k_real, bucket))
    # pad above izmin, continuing the integer spacing upward (thresholds
    # land > 1: never crossed)
    pad = k_tot - k_real
    step_top = (grid[0] - grid[1]) if len(grid) > 1 else r / 64.0
    top = izmin + step_top * np.arange(pad, 0, -1, dtype=np.float64)
    plane = np.concatenate([top, np.asarray(grid, np.float64)])
    return plane.astype(np.float32), k_tot


def snap_plane_tables_batch(
    f1: float,
    cxs,
    izmin: float,
    izmax: float,
    num_planes: int | None = None,
    bucket: int = 64,
    max_planes: int = 1024,
    phase_px: float = 0.0,
    stride: int = 1,
):
    """Per-pose snap grids padded to one shared bucketed K.
    Returns (plane_invz float32 (B, K), K)."""
    if num_planes:
        k = num_planes
    else:
        k = max(
            snap_plane_table(f1, cx, izmin, izmax, bucket=bucket,
                             max_planes=max_planes, phase_px=phase_px,
                             stride=stride)[1]
            for cx in cxs
        )
    tabs = [
        snap_plane_table(f1, cx, izmin, izmax, num_planes=k, bucket=bucket,
                         max_planes=max_planes, phase_px=phase_px,
                         stride=stride)[0]
        for cx in cxs
    ]
    return np.stack(tabs), k


class TranslationPlan(NamedTuple):
    """Static geometry of the padded source and the sliceable windows.

    All fields are host ints. tab_span_x/y bound the per-plane integer
    window starts: ix in [0, tab_span_x], iy in [0, tab_span_y]. The pads
    are sized so that a window of the output's shape (plus one lerp tap)
    fits at any such start. The sizes match lif_tpu's plan exactly, so
    both packages address the same padded source.
    """

    src_w: int
    src_h: int
    out_w: int
    out_h: int
    pad_lo_x: int  # left pad of the source, pixels
    pad_hi_x: int
    pad_lo_y: int
    pad_hi_y: int
    tab_span_x: int
    tab_span_y: int

    @property
    def padded_w(self) -> int:
        return self.src_w + self.pad_lo_x + self.pad_hi_x

    @property
    def padded_h(self) -> int:
        return self.src_h + self.pad_lo_y + self.pad_hi_y


def _bucket(n: int, q: int = 64) -> int:
    return int(math.ceil(max(n, 1) / q)) * q


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


def translation_plan(
    src_w: int,
    src_h: int,
    out_w: int,
    out_h: int,
    max_shift_x: float,
    max_shift_y: float,
) -> TranslationPlan:
    """Build the static plan from host-known shift bounds.

    max_shift_*: bound on |f1 * c1 * invZ| in pixels over the poses this
    plan will serve (f1 * |c1| * invz_min), bucketed to multiples of 64.
    """
    bx = (src_w - out_w) / 2.0
    by = (src_h - out_h) / 2.0
    sx = _bucket(int(math.ceil(abs(max_shift_x))) + 2)
    sy = _bucket(int(math.ceil(abs(max_shift_y))) + 2)
    pad_lo_x = max(0, int(math.ceil(sx - bx)))
    pad_lo_y = max(0, int(math.ceil(sy - by)))
    tab_span_x = int(math.ceil(bx + sx)) + pad_lo_x
    tab_span_y = int(math.ceil(by + sy)) + pad_lo_y
    # lif_tpu's TPU windows round out_w + 1 up to 128 lanes and add 16
    # rows; the pads keep that size so the two plans stay identical
    ww = _round_up(out_w + 1, 128)
    pad_hi_x = max(0, tab_span_x + ww - src_w - pad_lo_x)
    pad_hi_y = max(0, out_h + tab_span_y + 16 - src_h - pad_lo_y)
    return TranslationPlan(
        src_w, src_h, out_w, out_h, pad_lo_x, pad_hi_x, pad_lo_y, pad_hi_y,
        tab_span_x, tab_span_y,
    )


def plane_tables(plan: TranslationPlan, plane_invz, c1, f1: float, dx=0.0):
    """Per-plane window tables: integer starts + bilinear fractions.

    plane_invz: (..., K) float32 tensor; c1: (..., 3) float32 tensor with
    the same leading dims; f1: source focal (a float32 value).
    dx: constant extra x-shift in pixels (the width-pad / skew fold).
    Returns (ix, fx, iy, fy), each (..., K); ix/iy int32 window starts
    into the padded source, fx/fy float32 fractional offsets.
    """
    invz = plane_invz
    bx = (plan.src_w - plan.out_w) / 2.0
    by = (plan.src_h - plan.out_h) / 2.0
    tx = bx - f1 * c1[..., 0:1] * invz + dx + plan.pad_lo_x
    ty = by - f1 * c1[..., 1:2] * invz + plan.pad_lo_y
    # snap near-integer shifts to EXACT integers: snap grids place planes
    # at integer parallax, but the f32 table arithmetic drifts the
    # product by ~1e-4 px. round() is half-to-even, as jnp.round.
    tx_r = torch.round(tx)
    ty_r = torch.round(ty)
    tx = torch.where(torch.abs(tx - tx_r) < 1e-3, tx_r, tx)
    ty = torch.where(torch.abs(ty - ty_r) < 1e-3, ty_r, ty)
    # saturate out-of-plan shifts at the pad border (edge clamp;
    # visibility is zero out there anyway)
    tx = torch.clamp(tx, 0.0, plan.tab_span_x - 1e-3)
    ty = torch.clamp(ty, 0.0, plan.tab_span_y - 1e-3)
    ix = torch.floor(tx)
    iy = torch.floor(ty)
    return ix.to(torch.int32), tx - ix, iy.to(torch.int32), ty - iy


def warp_shifts(ix_t, fx_t):
    """The (integer, fraction) split at which the warp is evaluated:
    t = ix + fx rounded to float32, then split again — the arithmetic of
    lif_tpu's XLA oracle, shared by the plain twin and the CUDA kernel so
    that the two agree bit for bit."""
    t = ix_t.to(torch.float32) + fx_t
    i = torch.floor(t)
    return i.to(torch.int32), t - i


def _edge_pad(a, pad_y, pad_x):
    """Edge-replicate pad of the last two dims by (lo, hi) each."""
    h, w = a.shape[-2], a.shape[-1]
    rows = torch.clamp(
        torch.arange(-pad_y[0], h + pad_y[1], device=a.device), 0, h - 1
    )
    cols = torch.clamp(
        torch.arange(-pad_x[0], w + pad_x[1], device=a.device), 0, w - 1
    )
    return a.index_select(-2, rows).index_select(-1, cols)


def pad_sources(plan: TranslationPlan, rgb, disp, mask):
    """Edge-replicate pad; returns (dpad (Hp, Wp), cpad (4, Hp, Wp)) with
    color+mask stacked channel-major."""
    pads = ((plan.pad_lo_y, plan.pad_hi_y), (plan.pad_lo_x, plan.pad_hi_x))
    dpad = _edge_pad(disp.to(torch.float32), *pads)
    rgbm = torch.cat(
        [rgb.to(torch.float32), mask.to(torch.float32)[..., None]], dim=-1
    )
    cpad = _edge_pad(rgbm.permute(2, 0, 1), *pads)
    return dpad, cpad


def preshift_source(arr, dx: float, dy: float):
    """Constant bilinear shift with edge clamp: out(x, y) = arr(x+dx, y+dy)
    (sampling positions clamped to the array).

    Folds the CONSTANT part of a warp — the frustum-skew term
    -f1*(sk1-sk2) — into the source once, so the per-plane warps stay
    pure parallax translations. arr: (H, W) or (H, W, C)."""
    a = arr.to(torch.float32)
    if a.ndim not in (2, 3):
        raise ValueError(a.shape)
    h, w = a.shape[:2]
    ix = math.floor(_F32(dx))
    iy = math.floor(_F32(dy))
    fx = float(_F32(dx) - _F32(ix))
    fy = float(_F32(dy) - _F32(iy))
    dev = a.device
    xs = torch.clamp(torch.arange(w, device=dev) + ix, 0, w - 1)
    xs1 = torch.clamp(xs + 1, 0, w - 1)
    ys = torch.clamp(torch.arange(h, device=dev) + iy, 0, h - 1)
    ys1 = torch.clamp(ys + 1, 0, h - 1)
    g = a[:, xs] * (1.0 - fx) + a[:, xs1] * fx
    return g[ys] * (1.0 - fy) + g[ys1] * fy


def hit_and_alpha(
    plan: TranslationPlan,
    found,
    invz_star,
    rgba_star,
    c1,
    f1: float,
    feathering: float,
    mask_mode: str,
    offset=(0.0, 0.0),
    crop_y: int = 0,
):
    """Hit validity + composite alpha for the solved surface.

    Mirrors raycast_layer's hit handling for the aligned case: the final
    source position follows from invz*. found/invz_star: (..., H, W);
    rgba_star: (..., H, W, 4); c1: (..., 3) float32 tensor. Returns
    (hit, alpha). mask_mode: 'multiply', 'none' or 'hard' (see
    composite.edge_alpha)."""
    dev = found.device
    jx = torch.arange(plan.out_w, dtype=torch.float32, device=dev)[None, :]
    iy = torch.arange(plan.out_h, dtype=torch.float32, device=dev)[:, None]
    bx = (plan.src_w - plan.out_w) / 2.0
    by = (plan.src_h - plan.out_h) / 2.0
    sx = (f1 * c1[..., 0])[..., None, None]
    sy = (f1 * c1[..., 1])[..., None, None]
    # offset: the constant shift folded into the source; validity must
    # test the TRUE source position
    gx = jx + bx - sx * invz_star + offset[0]
    gy = iy + by - sy * invz_star + offset[1]
    # crop_y: validity/taper live in the UNCROPPED (outpainted) layer
    u1 = (gx + 0.5) / plan.src_w
    v1 = (gy + crop_y + 0.5) / (plan.src_h + 2 * crop_y)
    return _composite.edge_alpha(
        found, u1, v1, feathering, rgba_star[..., 3], mask_mode
    )


def _finalize(
    plan: TranslationPlan,
    found,
    invz_star,
    rgba_star,
    c1,
    f1: float,
    background,
    feathering: float,
    mask_mode: str,
    to_srgb: bool,
    raw: bool = False,
    offset=(0.0, 0.0),
    crop_y: int = 0,
):
    """Hit validity, taper, mask, premultiply, background blend.

    raw=True skips the premultiply/background/gamma stages and returns
    (rgba_star, alpha, hit, invz_star)."""
    hit, alpha = hit_and_alpha(
        plan, found, invz_star, rgba_star, c1, f1, feathering, mask_mode,
        offset=offset, crop_y=crop_y,
    )
    if raw:
        return rgba_star, alpha, hit, invz_star
    return _composite.finish_over_background(
        rgba_star[..., :3] * alpha[..., None], alpha, background, to_srgb
    )


def march_translation_plain(
    rgb,
    disp,
    mask,
    invz_min: float,
    invz_max: float,
    c1,
    f1: float,
    plane_invz,
    plan: TranslationPlan,
    num_planes: int,
    refine: int = 0,
    offset=(0.0, 0.0),
):
    """The plain march of one pose: a Python loop over planes.

    Returns the march's raw solution — found (H, W) 0/1, invz* (H, W) the
    secant-refined crossing (0 where none), rgba* (H, W, 4) the color
    lerped at it — which the CUDA kernel computes for lateral poses.

    Args:
      rgb: (H, W, 3) linear source colors, GL-oriented, on any device.
      disp: (H, W) normalized inverse depth. mask: (H, W) alpha mask.
      invz_min/invz_max: baseline-normalized inverse-depth range.
      c1: (3,) projector position in the camera frame (host array).
      f1: source focal in pixels; must equal the render focal f2.
      plane_invz: (num_planes,) descending (near -> far) plane positions.
      plan: TranslationPlan covering the shift range.
      refine: number of interior SUB-PLANE evaluations inside the crossing
        bracket (0 = plain secant between the bracketing planes); the
        disparity and color are re-warped at s = j/(refine+1) between
        the bracketing planes and the secant runs in the sub-bracket of
        the first crossing.
    """
    dev = disp.device
    izmin, izmax = _F32(invz_min), _F32(invz_max)
    dsc = float(izmin - izmax)
    c1_t = torch.as_tensor(np.asarray(c1, np.float32), device=dev)
    invz = torch.as_tensor(plane_invz, dtype=torch.float32, device=dev)
    ix_t, fx_t, iy_t, fy_t = plane_tables(
        plan, invz, c1_t, f1, dx=offset[0]
    )
    # the warp positions live on the host: slicing needs Python ints
    tx_t = (ix_t.to(torch.float32) + fx_t).cpu().numpy()
    ty_t = (iy_t.to(torch.float32) + fy_t).cpu().numpy()
    iz_h = invz.cpu().numpy()
    dpad, cpad = pad_sources(plan, rgb, disp, mask)
    src = torch.cat([cpad, dpad[None]], dim=0)  # (5, Hp, Wp)
    oh, ow = plan.out_h, plan.out_w

    def warp_at(tx, ty):
        """Bilinear 2-D translation at fractional offsets (tx, ty):
        returns (decoded invz (oh, ow), rgba (4, oh, ow))."""
        ix, iy = math.floor(tx), math.floor(ty)
        fx, fy = tx - _F32(ix), ty - _F32(iy)
        # float32 weights, rounded as the kernel rounds them
        wx0, wx1 = float(_F32(1.0) - fx), float(fx)
        wy0, wy1 = float(_F32(1.0) - fy), float(fy)

        def win(dy, dx):
            return src[:, iy + dy : iy + dy + oh, ix + dx : ix + dx + ow]

        top = win(0, 0) * wx0 + win(0, 1) * wx1
        bot = win(1, 0) * wx0 + win(1, 1) * wx1
        tex = top * wy0 + bot * wy1
        return tex[4] * dsc + float(izmax), tex[:4]

    zeros = torch.zeros((oh, ow), dtype=torch.float32, device=dev)
    found = zeros.clone()
    invz_star = zeros.clone()
    rgba_star = torch.zeros((4, oh, ow), dtype=torch.float32, device=dev)
    prev_diff = zeros.clone()
    prev_rgba = torch.zeros((4, oh, ow), dtype=torch.float32, device=dev)
    for k in range(num_planes):
        d, rgba = warp_at(tx_t[k], ty_t[k])
        izk = iz_h[k]
        km1 = max(k - 1, 0)
        prev_iz = iz_h[km1]
        diff = d - float(izk)
        crossed = (found < 0.5) & (diff > 0.0)

        if refine == 0:
            t = torch.clamp(
                prev_diff / torch.clamp(prev_diff - diff, max=-1e-12),
                0.0, 1.0,
            )
            # k == 0 snaps BEFORE the color lerp (a first-plane crossing
            # has prev_diff == 0 -> t == 0 -> the un-snapped lerp would
            # return the zero-init prev color)
            s_star = torch.ones_like(t) if k == 0 else t
            rgba_c = prev_rgba + s_star[None] * (rgba - prev_rgba)
        else:
            slo = zeros.clone()
            pd2, d2 = prev_diff, diff
            c_lo, c_hi = prev_rgba, rgba
            sfound = torch.zeros((oh, ow), dtype=torch.bool, device=dev)
            prev_g, prev_c, prev_s = prev_diff, prev_rgba, 0.0
            step = 1.0 / (refine + 1)
            for j in range(1, refine + 2):
                s = _F32(j * step)
                if j <= refine:
                    tx_s = tx_t[km1] + s * (tx_t[k] - tx_t[km1])
                    ty_s = ty_t[km1] + s * (ty_t[k] - ty_t[km1])
                    iz_s = prev_iz + s * (izk - prev_iz)
                    g_s, c_s = warp_at(tx_s, ty_s)
                    g = g_s - float(iz_s)
                else:
                    g, c_s = diff, rgba  # the k plane itself
                csub = (~sfound) & (g > 0.0)
                slo = torch.where(csub, float(prev_s), slo)
                pd2 = torch.where(csub, prev_g, pd2)
                d2 = torch.where(csub, g, d2)
                c_lo = torch.where(csub[None], prev_c, c_lo)
                c_hi = torch.where(csub[None], c_s, c_hi)
                sfound = sfound | csub
                prev_g, prev_c, prev_s = g, c_s, s
            slo = torch.where(sfound, slo, float(prev_s))
            pd2 = torch.where(sfound, pd2, prev_g)
            t2 = torch.clamp(
                pd2 / torch.clamp(pd2 - d2, max=-1e-12), 0.0, 1.0
            )
            s_star = slo + float(_F32(step)) * t2
            # k == 0 snaps to the first plane; the sub-bracket color lerp
            # snaps with it
            rgba_c = rgba if k == 0 else c_lo + t2[None] * (c_hi - c_lo)
            if k == 0:
                s_star = torch.ones_like(s_star)

        iz_c = float(prev_iz) + s_star * float(izk - prev_iz)
        invz_star = torch.where(crossed, iz_c, invz_star)
        rgba_star = torch.where(crossed[None], rgba_c, rgba_star)
        found = torch.maximum(found, crossed.to(torch.float32))
        prev_diff, prev_rgba = diff, rgba
    return found, invz_star, rgba_star.permute(1, 2, 0)


# ---------------------------------------------------------------------------
# The CUDA kernel's exact plane skip: its row tables and its walk in plain
# torch
# ---------------------------------------------------------------------------

LATERAL_RUN = 16  # planes a warp skips at once (csrc/sweep_march.cu kRun)
ROW_CELLS = (8, 32)  # the coarse row tables' cells, in tap origins
LATERAL_GROUP = 4  # planes a lane reads together (csrc/sweep_march.cu)


def decodes_down(invz_min, invz_max) -> bool:
    """True where the decode texel * (izmin - izmax) + izmax falls as the
    texel rises (izmin < izmax in float32): the skip tables then bound
    -disp from above, which bounds disp from below."""
    return bool(np.float32(invz_min) < np.float32(invz_max))


def _row_cell_max(r: torch.Tensor, c: int) -> torch.Tensor:
    """Maxima of each row of r over c-texel cells (the ragged end padded
    with -inf)."""
    pad = torch.nn.functional.pad(r, (0, -r.shape[1] % c), value=-math.inf)
    return pad.reshape(r.shape[0], -1, c).amax(-1).contiguous()


def row_skip_tables(disp, invz_min, invz_max):
    """The lateral kernel's skip bounds, (r0, r8, r32), for a decode of
    range (invz_min, invz_max). r0 (H, W) bounds every lerp of row y whose
    tap origin is x (taps x and min(x + 1, W - 1); a lerp's origin is its
    first tap clamped to [0, W - 1]): the larger tap plus max|tap|·2^-16 +
    1e-30, since a lerp is a convex combination of its taps up to a few
    roundings; a NaN tap gives +inf. r8 and r32 are maxima of r0 over 8-
    and 32-texel cells of a row. Where the decode falls as the texel rises
    (decodes_down), the tables are those of -disp."""
    d = disp.to(torch.float32)
    if decodes_down(invz_min, invz_max):
        d = -d
    nxt = torch.cat([d[:, 1:], d[:, -1:]], dim=1)
    hi, lo = torch.maximum(d, nxt), torch.minimum(d, nxt)
    r0 = hi + torch.maximum(hi.abs(), lo.abs()) * SKIP_SLACK + 1e-30
    r0 = torch.where(torch.isnan(r0), math.inf, r0).contiguous()
    r8 = _row_cell_max(r0, ROW_CELLS[0])
    return r0, r8, _row_cell_max(r8, ROW_CELLS[1] // ROW_CELLS[0])


def row_window_bound(r8, r32, xa, xb):
    """Per warp, the larger bound of the row cells covering the tap-origin
    window [xa, xb] of its row (r8/r32 rows already picked, (..., n)):
    8-texel cells where at most 32 cover it (one a lane), else 32-texel
    cells, else +inf."""
    lanes = torch.arange(WARP, device=xa.device)
    out = torch.full(xa.shape, math.inf, device=xa.device)
    done = torch.zeros(xa.shape, dtype=torch.bool, device=xa.device)
    for table, c in zip((r8, r32), ROW_CELLS):
        ca, cb = xa // c, xb // c
        use = ~done & (cb - ca < WARP)
        cx = ca[..., None] + lanes
        vals = table.gather(-1, cx.clamp(0, table.shape[-1] - 1))
        vals = torch.where(cx <= cb[..., None], vals, -math.inf).amax(-1)
        out = torch.where(use, vals, out)
        done = done | use
    return out


def lateral_skip_walk(src, ix, fx, izt, klo, khi, izmin, izmax, pad_lo_x,
                      tw, rows, run=LATERAL_RUN, stats=None):
    """The lateral kernel's walk for ONE pose, in plain torch: the first
    crossing k* (-1 where none) of every pixel and its secant bracket
    (pd at k* - 1, d at k*), reached through the kernel's exact skips.

    src (5, H, W), ix/fx/izt (K,), klo/khi (nb, Hc) the kernel's inputs
    for the pose (ops.cuda.sweep_march.lateral_kernel_inputs); rows the
    (r8, r32) of row_skip_tables. A warp is 32 neighbouring columns of a
    row; each lane searches its cell's plane range [k_lo, k_hi). Runs of
    `run` planes are aligned at multiples of `run`. A run's tap origins
    lie, for the warp's searching lanes, in the window [jmin - pad + min
    ix, jmax - pad + max ix] of the row (clamped), whose row-cell bound,
    decoded with the kernel's rounded operations, is not above the run's
    smallest plane invz where no lane can cross: the run is skipped whole.
    Otherwise the lanes read planes LATERAL_GROUP at a time. A lane stops
    at its first crossing; where the plane before it was not read, its
    difference is read afresh for the secant bracket.

    `stats`, if given, gathers counts of the walk: warp runs tested and
    skipped, planes the warps walk (whole groups), lane plane reads,
    bracket refreshes, crossings at the first plane after a skipped run,
    and the previous design's one-thread walk (from k_lo - 1 through the
    crossing) per lane and as its warp's slowest lane."""
    dev = src.device
    _, h, w = src.shape
    n_k = ix.shape[0]
    dd = src[4]
    izmin, izmax = np.float32(izmin), np.float32(izmax)
    dsc = float(izmin - izmax)
    down = dsc < 0.0
    ixl = ix.tolist()
    ow = klo.shape[0] * tw
    nw = -(-ow // WARP)
    owp = nw * WARP
    j = torch.arange(owp, device=dev)
    valid = (j < ow)[None, :].expand(h, owp)
    jc = j.clamp(max=ow - 1)
    rows_i = torch.arange(h, device=dev)
    k_lo = torch.where(valid, klo[(jc // tw)[None, :],
                                  (rows_i // 128)[:, None]].long(), n_k)
    k_hi = torch.where(valid, khi[(jc // tw)[None, :],
                                  (rows_i // 128)[:, None]].long(), 0)
    x0 = (j - pad_lo_x)[None, :]
    r8, r32 = rows

    def diff_at(k):
        a = (x0 + ixl[k]).clamp(0, w - 1).expand(h, owp)
        b = (x0 + ixl[k] + 1).clamp(0, w - 1).expand(h, owp)
        f = fx[k]
        tex = dd.gather(1, a) * (1.0 - f) + dd.gather(1, b) * f
        return (tex * dsc + float(izmax)) - izt[k]

    def warps(x):
        return x.reshape(h, nw, WARP)

    active = valid & (k_lo < k_hi)
    kstar = torch.full((h, owp), -1, dtype=torch.int64, device=dev)
    zeros = torch.zeros((h, owp), dtype=torch.float32, device=dev)
    pd, pdc, dc = zeros, zeros, zeros
    pk = torch.full((h, owp), -1, dtype=torch.int64, device=dev)
    count = dict(runs=0, runs_skipped=0, warp_steps=0, lane_reads=0,
                 refreshes=0, after_skip=0)
    prev_skip = torch.zeros((h, nw), dtype=torch.bool, device=dev)
    big = 1 << 40
    kw0 = warps(torch.where(active, k_lo, n_k)).amin(-1)
    kw1 = warps(torch.where(active, k_hi, 0)).amax(-1)
    for kb in range(0, n_k, run):
        ke = min(kb + run, n_k)
        active = active & (k_hi > kb)
        live = warps(active).any(-1) & (kw0 < kb + run) & (kw1 > kb)
        if not bool(live.any()):
            if bool((kw1 > kb).any()):
                continue
            break
        seg = ixl[kb:ke]
        tmin = min((t for t in izt[kb:ke].tolist() if t == t),
                   default=math.inf)
        jw = j[None, :].expand(h, owp)
        jlo = warps(torch.where(active, jw, big)).amin(-1)
        jhi = warps(torch.where(active, jw, -big)).amax(-1)
        xa = (jlo - pad_lo_x + min(seg)).clamp(0, w - 1)
        xb = (jhi - pad_lo_x + max(seg)).clamp(0, w - 1)
        m = row_window_bound(r8[:, None, :].expand(h, nw, -1),
                             r32[:, None, :].expand(h, nw, -1), xa, xb)
        mv = -m if down else m
        walk = (m == math.inf) | (((mv * dsc + float(izmax)) - tmin) > 0.0)
        skip = live & ~walk
        count["runs"] += int(live.sum())
        count["runs_skipped"] += int(skip.sum())
        after_skip = prev_skip[..., None].expand(h, nw, WARP).reshape(h, owp)
        prev_skip = skip
        lane_walk = (live & walk)[..., None].expand(h, nw, WARP).reshape(
            h, owp)
        for c in range(kb, ke, LATERAL_GROUP):
            # a warp's first group is the one that holds its first plane
            searching = warps(active & lane_walk).any(-1)
            if not bool(searching.any()):
                break
            going = searching & (kw0 < c + LATERAL_GROUP)
            count["warp_steps"] += int(going.sum()) * min(LATERAL_GROUP,
                                                          ke - c)
            on = going[..., None].expand(h, nw, WARP).reshape(h, owp)
            for cc in range(c, min(c + LATERAL_GROUP, ke)):
                lane = active & lane_walk & on
                active = active & ~(lane & (cc >= k_hi))
                lane = lane & (cc < k_hi) & (cc >= k_lo)
                if not bool(lane.any()):
                    continue
                count["lane_reads"] += int(lane.sum())
                d = diff_at(cc)
                crossed = lane & (d > 0.0)
                if bool(crossed.any()):
                    fresh = crossed & (pk != cc - 1)
                    count["refreshes"] += int(fresh.sum())
                    if cc == kb:
                        count["after_skip"] += int((crossed & after_skip)
                                                   .sum())
                    prev = diff_at(cc - 1) if cc > 0 else zeros
                    pdc = torch.where(crossed, torch.where(fresh, prev, pd),
                                      pdc)
                    dc = torch.where(crossed, d, dc)
                    kstar = torch.where(crossed, cc, kstar)
                    active = active & ~crossed
                keep = lane & ~crossed
                pd = torch.where(keep, d, pd)
                pk = torch.where(keep, cc, pk)
    if stats is not None:
        # the previous design: one thread per pixel from k_lo - 1 (its
        # bracket seed) through the crossing or k_hi
        seed = (k_lo > 0) & (k_lo < k_hi)
        visits = torch.where(kstar >= 0, kstar - k_lo + 1,
                             (k_hi - k_lo).clamp(min=0)) + seed
        visits = torch.where(valid, visits, 0)
        count["old_lane_visits"] = int(visits.sum())
        count["old_warp_visits"] = int(warps(visits).amax(-1).sum()) * WARP
        for key, val in count.items():
            stats[key] = stats.get(key, 0) + val
    return kstar[:, :ow], pdc[:, :ow], dc[:, :ow]


def _secant(pd, d):
    """pd / min(pd - d, -1e-12), clipped to [0, 1]."""
    return torch.clamp(pd / torch.clamp(pd - d, max=-1e-12), 0.0, 1.0)


def lateral_bracket(src, ix, fx, izt, kstar, pdc, dc, izmin, izmax,
                    pad_lo_x, refine=0):
    """found, invz* and rgba* of every pixel of ONE pose from its first
    crossing k* (-1 where none) and secant bracket (pdc, dc), with the
    lateral kernel's arithmetic, which is march_translation_plain's: the
    secant (or, with refine > 0, the in-bracket sub-planes at exactly
    lerped shifts and depths, then the secant in the sub-bracket of their
    first crossing) and the colour lerp between the bracket's warps; a
    crossing at plane 0 takes that plane."""
    dev = src.device
    _, h, w = src.shape
    ow = kstar.shape[1]
    dsc = float(np.float32(izmin) - np.float32(izmax))
    x0 = (torch.arange(ow, device=dev) - pad_lo_x)[None, :].expand(h, ow)
    found = kstar >= 0
    k1 = kstar.clamp(min=0)
    k0 = (kstar - 1).clamp(min=0)
    tx = ix.to(torch.float32) + fx  # the warp shifts, exactly

    def lerp_at(t):
        """(5, h, ow): every channel of src lerped at the per-pixel
        shifts t."""
        i = torch.floor(t)
        f = t - i
        a = (x0 + i.long()).clamp(0, w - 1)[None].expand(5, h, ow)
        b = (x0 + i.long() + 1).clamp(0, w - 1)[None].expand(5, h, ow)
        return src.gather(2, a) * (1.0 - f) + src.gather(2, b) * f

    cur = lerp_at(tx[k1])[:4]
    prev = torch.where(kstar > 0, lerp_at(tx[k0])[:4], 0.0)
    iz0, iz1 = izt[k0], izt[k1]
    if refine == 0:
        t = _secant(pdc, dc)
        s_star = torch.where(kstar > 0, t, 1.0)
        rgba = prev + s_star * (cur - prev)
    else:
        step = 1.0 / (refine + 1)
        zeros = torch.zeros((h, ow), dtype=torch.float32, device=dev)
        slo, pd2, d2, c_lo, c_hi = zeros, pdc, dc, prev, cur
        sfound = torch.zeros((h, ow), dtype=torch.bool, device=dev)
        prev_g, prev_c, prev_s = pdc, prev, 0.0
        for jj in range(1, refine + 2):
            s = float(np.float32(jj * step))
            if jj <= refine:
                sub = lerp_at(tx[k0] + s * (tx[k1] - tx[k0]))
                g = (sub[4] * dsc + float(np.float32(izmax))) - (
                    iz0 + s * (iz1 - iz0))
                c_s = sub[:4]
            else:
                g, c_s = dc, cur
            csub = ~sfound & (g > 0.0)
            slo = torch.where(csub, prev_s, slo)
            pd2 = torch.where(csub, prev_g, pd2)
            d2 = torch.where(csub, g, d2)
            c_lo = torch.where(csub[None], prev_c, c_lo)
            c_hi = torch.where(csub[None], c_s, c_hi)
            sfound = sfound | csub
            prev_g, prev_c, prev_s = g, c_s, s
        slo = torch.where(sfound, slo, prev_s)
        pd2 = torch.where(sfound, pd2, prev_g)
        t2 = _secant(pd2, d2)
        s_star = torch.where(kstar > 0, slo + float(np.float32(step)) * t2,
                             1.0)
        rgba = torch.where(kstar[None] > 0, c_lo + t2 * (c_hi - c_lo), cur)
    invz = iz0 + s_star * (iz1 - iz0)
    return (found.to(torch.float32), torch.where(found, invz, 0.0),
            torch.where(found[None], rgba, 0.0).permute(1, 2, 0))


def march_translation_skip_plain(
    rgb,
    disp,
    mask,
    invz_min: float,
    invz_max: float,
    c1,
    f1: float,
    plane_invz,
    plan: TranslationPlan,
    num_planes: int,
    refine: int = 0,
    offset=(0.0, 0.0),
    run: int = LATERAL_RUN,
    stats: dict | None = None,
):
    """The lateral CUDA kernel's walk for ONE pose, in plain torch:
    march_translation_plain's found, invz* and rgba*, bit for bit,
    reached through the kernel's inputs (ops.cuda.sweep_march's source
    stack, warp shifts and plane-range tables) and its exact skips
    (lateral_skip_walk, lateral_bracket). The source must have the
    output's height; c1 is x-only. An oracle and a counter (`stats`, see
    lateral_skip_walk), never on a render path."""
    from .cuda.sweep_march import (
        _pick_tw,
        lateral_kernel_inputs,
        prepare_translation_src,
    )

    plane = torch.as_tensor(plane_invz, dtype=torch.float32,
                            device=disp.device)
    src, ix, fx, izt, klo, khi, izmin, izmax, _ = lateral_kernel_inputs(
        prepare_translation_src(rgb, disp, mask, plan), invz_min, invz_max,
        np.asarray(c1, np.float32)[None], f1, plane[None], plan, num_planes,
        offset=offset,
    )
    rows = row_skip_tables(src[4], izmin, izmax)[1:]
    kstar, pdc, dc = lateral_skip_walk(
        src, ix[0], fx[0], izt[0], klo[0], khi[0], izmin, izmax,
        plan.pad_lo_x, _pick_tw(plan.out_w), rows, run=run, stats=stats)
    return lateral_bracket(src, ix[0], fx[0], izt[0], kstar, pdc, dc, izmin,
                           izmax, plan.pad_lo_x, refine=refine)


def render_translation_plain(
    rgb,
    disp,
    mask,
    invz_min: float,
    invz_max: float,
    c1,
    f1: float,
    plane_invz,
    background,
    plan: TranslationPlan,
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 0,
    raw: bool = False,
    offset=(0.0, 0.0),
    crop_y: int = 0,
):
    """The plain twin of one pose (lif_tpu's render_translation_xla):
    march_translation_plain + _finalize. Returns (H, W, 4), or with
    raw=True the (rgba*, alpha, hit, invz*) tuple."""
    found, invz_star, rgba_star = march_translation_plain(
        rgb, disp, mask, invz_min, invz_max, c1, f1, plane_invz, plan,
        num_planes, refine=refine, offset=offset,
    )
    c1_t = torch.as_tensor(np.asarray(c1, np.float32), device=disp.device)
    return _finalize(
        plan, found, invz_star, rgba_star, c1_t, f1, background, feathering,
        mask_mode, to_srgb, raw=raw, offset=offset, crop_y=crop_y,
    )


def render_translation_batch(
    rgb,
    disp,
    mask,
    invz_min: float,
    invz_max: float,
    c1,
    f1: float,
    plane_invz,
    background,
    plan: TranslationPlan,
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 0,
    raw: bool = False,
    offset=(0.0, 0.0),
    crop_y: int = 0,
    prepared=None,
    skip_rows=None,
):
    """Pose-batched march, dispatched on the device of the textures: a
    CUDA tensor launches the lateral kernel (ONE launch for the batch),
    a CPU tensor takes the plain twin pose by pose.

    c1: (B, 3) per-pose positions (host array); the CUDA kernel serves
    the LATERAL case (x-only). plane_invz may be (K,) shared or (B, K)
    per-pose (snap grids). prepared: optional hoisted source pack from
    ops.cuda.sweep_march.prepare_translation_src, skip_rows the kernel's
    (r8, r32) row_skip_tables of the same rows (CUDA path only).
    Returns (B, H, W, 4), or the raw tuple with a leading B axis."""
    c1 = np.asarray(c1, np.float32)
    plane = torch.as_tensor(plane_invz, dtype=torch.float32)
    if plane.ndim == 1:
        plane = plane.expand(len(c1), plane.shape[0])
    if disp.device.type == "cuda":
        from .cuda.sweep_march import render_translation_batch_cuda

        return render_translation_batch_cuda(
            rgb, disp, mask, invz_min, invz_max, c1, f1, plane, background,
            plan, num_planes, feathering=feathering, mask_mode=mask_mode,
            to_srgb=to_srgb, refine=refine, raw=raw, offset=offset,
            crop_y=crop_y, prepared=prepared, rows=skip_rows,
        )
    if disp.device.type != "cpu":
        raise NotImplementedError(
            f"the lateral march runs on CUDA or CPU tensors, not "
            f"{disp.device.type}"
        )
    outs = [
        render_translation_plain(
            rgb, disp, mask, invz_min, invz_max, cc, f1, pp, background,
            plan, num_planes, feathering=feathering, mask_mode=mask_mode,
            to_srgb=to_srgb, refine=refine, raw=raw, offset=offset,
            crop_y=crop_y,
        )
        for cc, pp in zip(c1, plane)
    ]
    if raw:
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def render_translation(rgb, disp, mask, invz_min, invz_max, c1, f1,
                       plane_invz, background, plan, num_planes, **kw):
    """Single-pose march: a batch of one through render_translation_batch.
    Returns (H, W, 4), or the raw tuple."""
    out = render_translation_batch(
        rgb, disp, mask, invz_min, invz_max, np.asarray(c1)[None], f1,
        torch.as_tensor(plane_invz, dtype=torch.float32)[None], background,
        plan, num_planes, **kw,
    )
    if kw.get("raw"):
        return tuple(o[0] for o in out)
    return out[0]
