"""Scaled first-crossing plane march for ALIGNED novel views: host
planning, the plain PyTorch twin, the fetch epilogue and the device
dispatch.

The counterpart of lif_tpu.ops.sweep_scaled. For a view with no relative
rotation, translation (cx, cy, cz) and focal ratio fr = f1/f2, the source
position of output pixel (j, i) at inverse depth v is separable-affine per
axis (reference semantics: src/shaders/rayCastMonoLDI.glsl:249):

    gx(j) = j + dx(j; v),  dx = tx(v) + ex(v) * (j - cx0)
    gy(i) = i + dy(i; v),  dy = ty(v) + ey(v) * (i - cy0)

    ex(v) = ey(v) = fr * (1 + cz * v) - 1
    tx(v) = bx - f1 * cx * v + dx_user,   ty(v) = by - f1 * cy * v + dy_user

with bx = (src_w - out_w)/2 and cx0 = (out_w - 1)/2 (and the y analogues).
Planes are walked near -> far; the first plane where the bilinear decoded
inverse depth at (gx, gy) lies in front of the plane is the crossing,
refined by a secant in its bracket (and, with refine > 0, by an in-bracket
sub-sweep at exactly lerped tables: all four table entries are affine in
v).

The march works in INVERSE-DEPTH space, as lif_tpu's twin
render_scaled_xla does: d = texel * (izmin - izmax) + izmax and
diff = d - v_k. (lif_tpu's TPU kernel compares texels against texel
thresholds instead; the two agree up to rounding at grazing crossings.)

Host planning (the plan, the parallax-step grids) is float64 numpy copied
from lif_tpu, so routing cannot drift; the TPU budgets (mx_cap, ky_cap,
the candidate counts) stay as routing gates. Two implementations of the
march share the tables (scaled_table_stack):
  * march_scaled_plain: a Python loop over planes in plain torch, the
    kernel's plain version; render_scaled_plain is the twin of lif_tpu's
    render_scaled_xla, the CPU path;
  * lif_tpu_torch.ops.cuda.sweep_scaled: the hand-written CUDA kernel
    (csrc/sweep_scaled.cu), the path of every CUDA tensor.
render_scaled_batch and render_scaled_fetch_batch dispatch on the device
of the textures.

The displacement clips of lif_tpu's plan ([-pad_lo_x, tab_span_x -
pad_lo_x] in x, [-my_lo, my_hi] in y) are kept; lif_tpu reads the clipped
samples from an edge-replicated padded stack, the port reads the
unpadded source with its tap indices clamped to the edge, which picks the
same texels (_tap_rows).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import composite as _composite
from .sampling import bilinear_sample_packed, pack_rgbm
from .sweep_target import _rgbm_stack, _secant, _tdiv

__all__ = [
    "ScaledPlan",
    "scaled_plan",
    "scaled_tables",
    "scaled_table_stack",
    "parallax_step_grid",
    "parallax_step_grids_batch",
    "march_scaled_plain",
    "render_scaled_plain",
    "render_scaled_batch",
    "render_scaled_fetch_batch",
    "finalize_scaled",
    "hit_and_alpha_scaled",
]

_LC = 128  # lif_tpu's y-chunk height: the y window is planned in chunks


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


class ScaledPlan(NamedTuple):
    """Static geometry of the scaled march (host ints), field for field
    lif_tpu's plan. Displacements are CLIPPED to [-pad_lo_x, tab_span_x -
    pad_lo_x] in x and [-my_lo, my_hi] in y; clipped samples read border
    texels and visibility gates them to ~0 alpha. The band and candidate
    fields (tw, mx, ky_lo, ky_hi, my) describe lif_tpu's TPU tiling; here
    they only decide routing (scaled_plan raises where lif_tpu's kernel
    could not cover the batch) and place the y origin (pad_lo_y)."""

    src_w: int
    src_h: int
    out_w: int
    out_h: int
    pad_lo_x: int      # left x pad; x displacement clip low = -pad_lo_x
    tab_span_x: int    # max padded x displacement (clip high + margin)
    tw: int            # x band width
    mx: int            # x candidate count
    ky_lo: int         # y window chunks below the output chunk
    ky_hi: int         # y window chunks above
    my_lo: int         # y displacement clip low (>= 0, magnitude)
    my_hi: int         # y displacement clip high
    my: int            # y candidate count

    @property
    def pad_lo_y(self) -> int:
        """Rows of lif_tpu's edge pad below the source: the origin of its
        padded y coordinate, which the port keeps so that sample positions
        round the same way."""
        return self.ky_lo * _LC


def _ex_bounds(fr: float, cz_lo: float, cz_hi: float,
               izmin: float, izmax: float):
    """Range of the per-plane scale-minus-one over v in [izmax, izmin]
    and cz in [cz_lo, cz_hi] (all four corners; e is bilinear in (cz, v))."""
    es = [
        fr * (1.0 + cz * v) - 1.0
        for cz in (cz_lo, cz_hi)
        for v in (izmax, izmin)
    ]
    return min(es), max(es)


def scaled_plan(
    src_w: int,
    src_h: int,
    out_w: int,
    out_h: int,
    f1: float,
    fr: float,
    cx_max: float,
    cy_max: float,
    cz_lo: float,
    cz_hi: float,
    izmin: float,
    izmax: float,
    dx_user: float = 0.0,
    dy_user: float = 0.0,
    mx_cap: int = 8,
    ky_cap: int = 2,
) -> ScaledPlan:
    """Build the plan from host-known pose bounds (lif_tpu's, float64).

    Raises ValueError when the pose family exceeds lif_tpu's TPU budgets
    (scale spread needing > mx_cap candidates even at tw=8, or a y
    displacement beyond ky_cap 128-row chunks): the renderer then routes
    the batch to the sweep, as lif_tpu does."""
    if out_w % 8 != 0:
        raise ValueError(f"out_w must be 8-divisible, got {out_w}")
    bx = (src_w - out_w) / 2.0
    by = (src_h - out_h) / 2.0
    cx0 = (out_w - 1) / 2.0
    cy0 = (out_h - 1) / 2.0
    e_lo, e_hi = _ex_bounds(fr, cz_lo, cz_hi, izmin, izmax)
    e_abs = max(abs(e_lo), abs(e_hi))

    # x displacement interval over poses/planes/pixels
    shift_span = f1 * cx_max * izmin  # |translation| bound (v <= izmin)
    scale_span = e_abs * cx0
    d_lo = bx + dx_user - shift_span - scale_span
    d_hi = bx + dx_user + shift_span + scale_span
    # cap at one source+output width: beyond that every sample saturates
    # at the border and is alpha-gated (same cap as the lateral plan)
    cap = float(src_w + out_w)
    d_lo = max(d_lo, -cap)
    d_hi = min(d_hi, cap)
    pad_lo_x = max(0, int(math.ceil(-d_lo)) + 1)
    tab_span_x = int(math.ceil(d_hi)) + pad_lo_x + 2

    # tile width: the widest divisor of out_w whose per-band scale spread
    # fits the candidate budget
    tw = None
    for cand in (128, 64, 32, 16, 8):
        if out_w % cand == 0 and int(math.ceil(e_abs * (cand - 1))) + 2 <= mx_cap:
            tw = cand
            break
    if tw is None:
        raise ValueError(
            f"scale spread too large for the candidate budget: |e|max="
            f"{e_abs:.4f} needs >{mx_cap} candidates even at tw=8"
        )
    mx = int(math.ceil(e_abs * (tw - 1))) + 2

    # y displacement interval
    yshift_span = f1 * cy_max * izmin
    yscale_span = e_abs * cy0
    dy_lo = by + dy_user - yshift_span - yscale_span
    dy_hi = by + dy_user + yshift_span + yscale_span
    my_lo = max(0, int(math.ceil(-dy_lo)) + 1)
    my_hi = max(0, int(math.ceil(dy_hi)) + 2)
    my = int(math.ceil(e_abs * (_LC - 1))) + 2
    ky_lo = -(-my_lo // _LC)
    ky_hi = -(-(my_hi + my + 23) // _LC)
    if ky_lo > ky_cap or ky_hi > ky_cap:
        raise ValueError(
            f"y displacement range [{-my_lo}, {my_hi}] exceeds the "
            f"{ky_cap}-chunk window budget"
        )
    return ScaledPlan(
        src_w, src_h, out_w, out_h, pad_lo_x, tab_span_x, tw, mx,
        ky_lo, ky_hi, my_lo, my_hi, my,
    )


def parallax_step_grid(
    f1: float,
    c1,
    fr: float,
    out_w: int,
    out_h: int,
    izmin: float,
    izmax: float,
    step_px: float = 1.0,
    bucket: int = 64,
    max_planes: int = 1024,
    num_planes: int | None = None,
):
    """Uniform inverse-depth grid stepped so the maximum displacement
    change between adjacent planes is <= step_px pixels (host math, as
    lif_tpu). The bucketed count spreads uniformly over [izmax, izmin].
    Returns (plane_invz float32 (K,) descending, K)."""
    cx, cy, cz = (float(c1[0]), float(c1[1]), float(c1[2]))
    gx = abs(f1 * cx) + abs(fr * cz) * (out_w - 1) / 2.0
    gy = abs(f1 * cy) + abs(fr * cz) * (out_h - 1) / 2.0
    g = max(gx, gy, 1e-9)
    r = izmin - izmax
    cap = min(max_planes, num_planes) if num_planes else max_planes
    k_real = min(int(math.ceil(r * g / step_px)) + 2, cap)
    k_tot = num_planes if num_planes else max(bucket, _round_up(k_real, bucket))
    grid = np.linspace(izmin, izmax, k_tot, dtype=np.float64)
    return grid.astype(np.float32), k_tot


def parallax_step_grids_batch(
    f1: float,
    c1s,
    fr: float,
    out_w: int,
    out_h: int,
    izmin: float,
    izmax: float,
    step_px: float = 1.0,
    bucket: int = 64,
    max_planes: int = 1024,
    num_planes: int | None = None,
):
    """Per-pose grids padded to one shared bucketed K: (B, K) f32, K."""
    if num_planes:
        k = num_planes
    else:
        k = max(
            parallax_step_grid(f1, c, fr, out_w, out_h, izmin, izmax,
                               step_px=step_px, bucket=bucket,
                               max_planes=max_planes)[1]
            for c in c1s
        )
    tabs = [
        parallax_step_grid(f1, c, fr, out_w, out_h, izmin, izmax,
                           step_px=step_px, bucket=bucket,
                           max_planes=max_planes, num_planes=k)[0]
        for c in c1s
    ]
    return np.stack(tabs), k


# ---------------------------------------------------------------------------
# Per-plane tables and the plain twin (dense torch): the kernel's plain
# version
# ---------------------------------------------------------------------------


def _f32(x) -> float:
    """A host scalar rounded to float32, as jax's weak types round it."""
    return float(np.float32(x))


def _as_f32(x, device) -> torch.Tensor:
    """Host arrays or tensors as float32 on `device` (float64 rounds to
    nearest, as numpy's and jax's casts do)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def scaled_tables(plan: ScaledPlan, plane_invz, c1, f1, fr,
                  dx_user=0.0, dy_user=0.0):
    """Per-plane warp tables (tx, ex, ty, ey), each shaped like
    plane_invz (..., K) with c1 (..., 3): displacement at the image center
    and slope per pixel, dx(j) = tx + ex*(j - cx0). Float32, in lif_tpu's
    order of operations; NOT clipped (the march clips per pixel)."""
    v = torch.as_tensor(plane_invz, dtype=torch.float32)
    c1 = torch.as_tensor(c1, dtype=torch.float32, device=v.device)
    f1, fr = _f32(f1), _f32(fr)
    bx = (plan.src_w - plan.out_w) / 2.0
    by = (plan.src_h - plan.out_h) / 2.0
    e = fr * (1.0 + c1[..., 2:3] * v) - 1.0
    tx = bx - (c1[..., 0:1] * f1) * v + _f32(dx_user)
    ty = by - (c1[..., 1:2] * f1) * v + _f32(dy_user)
    return tx, e, ty, e


def scaled_table_stack(plan: ScaledPlan, plane_invz, c1_b, f1, fr,
                       dx_user=0.0, dy_user=0.0):
    """(B, 5, K) float32 rows [tx, ex, ty, ey, invz] for a pose batch
    c1_b (B, 3) and ladders (K,) shared or (B, K): what the plain march
    and the kernel both read, so both see the same table bits."""
    c1_b = torch.as_tensor(c1_b, dtype=torch.float32)
    v = torch.as_tensor(plane_invz, dtype=torch.float32, device=c1_b.device)
    if v.ndim == 1:
        v = v.expand(c1_b.shape[0], v.shape[0])
    tx, ex, ty, ey = scaled_tables(plan, v, c1_b, f1, fr, dx_user, dy_user)
    return torch.stack([tx, ex, ty, ey, v], dim=1).contiguous()


def _tap_rows(g, pad: int, n: int):
    """Bilinear taps at padded coordinate g: the two source indices and
    the fraction. The padded index p reads source texel clamp(p - pad, 0,
    n - 1), the texel an edge-replicated pad of `pad` holds there."""
    f0 = torch.floor(g)
    frac = g - f0
    i0 = f0.to(torch.int64) - pad
    return i0.clamp(0, n - 1), (i0 + 1).clamp(0, n - 1), frac


def _warp(img, tx, ex, ty, ey, plan: ScaledPlan, xc, yc):
    """Bilinear read of img (..., H, W) at the plan-clipped separable
    displacement of tables (tx, ex, ty, ey) — scalars, or per-pixel
    (H, W) tensors. lif_tpu's render_scaled_xla.warp_at, summed in its
    order: top = c00*(1-fx) + c10*fx, out = top*(1-fy) + bot*fy."""
    h, w = img.shape[-2:]
    jx, iy = xc[1], yc[1]
    dxv = torch.clamp(tx + ex * xc[0], -float(plan.pad_lo_x),
                      float(plan.tab_span_x - plan.pad_lo_x))
    dyv = torch.clamp(ty + ey * yc[0], -float(plan.my_lo), float(plan.my_hi))
    gx = (jx + dxv) + float(plan.pad_lo_x)
    gy = (iy + dyv) + float(plan.pad_lo_y)
    x0, x1, fx = _tap_rows(gx, plan.pad_lo_x, w)
    y0, y1, fy = _tap_rows(gy, plan.pad_lo_y, h)
    top = img[..., y0, x0] * (1.0 - fx) + img[..., y0, x1] * fx
    bot = img[..., y1, x0] * (1.0 - fx) + img[..., y1, x1] * fx
    return top * (1.0 - fy) + bot * fy


def _centered(plan: ScaledPlan, device):
    """((j - cx0) (1, W), j (1, W)) and ((i - cy0) (H, 1), i (H, 1))."""
    jx = torch.arange(plan.out_w, dtype=torch.float32, device=device)[None, :]
    iy = torch.arange(plan.out_h, dtype=torch.float32, device=device)[:, None]
    return ((jx - (plan.out_w - 1) / 2.0, jx),
            (iy - (plan.out_h - 1) / 2.0, iy))


def march_scaled_plain(disp, invz_min, invz_max, tables, plan: ScaledPlan,
                       refine: int = 0, rgbm=None):
    """The plain scaled march of one pose: a Python loop over planes.

    Returns found (H, W) 0/1 and invz* (H, W), the secant-refined
    crossing (0 where none); with rgbm (4, Hs, Ws) also rgba* (H, W, 4),
    the lerp at the crossing's s* between the [r, g, b, mask] warps at
    planes k*-1 and k* (zeros where none). A crossing at k* == 0 takes
    s* = 1. The CUDA kernel computes the same.

    Args:
      disp: (Hs, Ws) normalized inverse depth, GL-oriented.
      invz_min/invz_max: baseline-normalized inverse-depth range.
      tables: (5, K) scaled_table_stack row [tx, ex, ty, ey, invz].
      refine: interior sub-plane evaluations inside the crossing bracket.
    """
    dev = disp.device
    dd = disp.to(torch.float32)
    izmin, izmax = np.float32(invz_min), np.float32(invz_max)
    rng = float(izmin - izmax)
    izmax = float(izmax)
    xc, yc = _centered(plan, dev)
    tab = torch.as_tensor(tables, dtype=torch.float32, device=dev)
    rows = tab.tolist()
    oh, ow = plan.out_h, plan.out_w

    def diff_at(tx, ex, ty, ey, v):
        return (_warp(dd, tx, ex, ty, ey, plan, xc, yc) * rng + izmax) - v

    zeros = torch.zeros((oh, ow), dtype=torch.float32, device=dev)
    kstar = torch.full((oh, ow), -1, dtype=torch.int64, device=dev)
    pdiffc, diffc, pdiff = zeros, zeros, zeros
    for k in range(tab.shape[1]):
        diff = diff_at(*(r[k] for r in rows))
        crossed = (kstar < 0) & (diff > 0.0)
        kstar = torch.where(crossed, k, kstar)
        pdiffc = torch.where(crossed, pdiff, pdiffc)
        diffc = torch.where(crossed, diff, diffc)
        pdiff = diff

    found = kstar >= 0
    km1 = torch.clamp(kstar - 1, min=0)
    kc = torch.clamp(kstar, min=0)
    t0, t1 = tab[:, km1], tab[:, kc]  # (5, H, W) per-pixel bracket tables
    if refine == 0:
        s_star = _secant(pdiffc, diffc)
    else:
        # sub-bracket first-crossing search at exactly lerped tables; the
        # secant then runs in the 1/(refine+1) sub-bracket
        step = 1.0 / (refine + 1)
        slo, pd2, d2 = zeros, pdiffc, diffc
        sfound = torch.zeros((oh, ow), dtype=torch.bool, device=dev)
        prev_g, prev_s = pdiffc, 0.0
        for jr in range(1, refine + 1):
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
        s_star = slo + step * _secant(pd2, d2)
    s_star = torch.where(kstar == 0, 1.0, s_star)
    vstar = torch.where(found, t0[4] + s_star * (t1[4] - t0[4]), 0.0)
    if rgbm is None:
        return found.to(torch.float32), vstar
    c1 = _warp(rgbm, *t1[:4], plan, xc, yc)
    c0 = torch.where(kstar > 0, _warp(rgbm, *t0[:4], plan, xc, yc), 0.0)
    rgba = torch.where(found, c0 + s_star * (c1 - c0), 0.0)
    return found.to(torch.float32), vstar, rgba.permute(1, 2, 0)


# ---------------------------------------------------------------------------
# Epilogue
# ---------------------------------------------------------------------------


def _solved_uv(plan: ScaledPlan, invz_star, c1, f1, fr, dx_user=0.0,
               dy_user=0.0, crop_y: int = 0):
    """Normalized source coordinates (u1, v1) of the solved positions
    (lif_tpu's finalize / fetch arithmetic); c1 (..., 3) batches."""
    dev = invz_star.device
    c1 = torch.as_tensor(c1, dtype=torch.float32, device=dev)
    f1cx, f1cy, cz = (c1[..., i, None, None] for i in range(3))
    f1cx, f1cy = f1cx * _f32(f1), f1cy * _f32(f1)
    (xc, jx), (yc, iy) = _centered(plan, dev)
    bx = (plan.src_w - plan.out_w) / 2.0
    by = (plan.src_h - plan.out_h) / 2.0
    e = _f32(fr) * (1.0 + cz * invz_star) - 1.0
    gx = jx + bx + _f32(dx_user) - f1cx * invz_star + e * xc
    gy = iy + by + _f32(dy_user) - f1cy * invz_star + e * yc
    u1 = _tdiv(gx + 0.5, plan.src_w)
    v1 = _tdiv(gy + crop_y + 0.5, plan.src_h + 2 * crop_y)
    return u1, v1


def hit_and_alpha_scaled(plan: ScaledPlan, found, invz_star, rgba_star, c1,
                         f1, fr, feathering: float, mask_mode: str,
                         dx_user=0.0, dy_user=0.0, crop_y: int = 0):
    """Hit validity + composite alpha at the solved surface (the scaled
    generalization of sweep_march.hit_and_alpha; same mask semantics)."""
    u1, v1 = _solved_uv(plan, invz_star, c1, f1, fr, dx_user, dy_user,
                        crop_y)
    return _composite.edge_alpha(found, u1, v1, feathering,
                                 rgba_star[..., 3], mask_mode)


def _finish(invz_star, rgba_star, hit_alpha, background, to_srgb, raw):
    hit, alpha = hit_alpha
    if raw:
        return rgba_star, alpha, hit, invz_star
    return _composite.finish_over_background(
        rgba_star[..., :3] * alpha[..., None], alpha, background, to_srgb
    )


def finalize_scaled(plan: ScaledPlan, found, invz_star, rgba_star, c1, f1,
                    fr, background, feathering: float, mask_mode: str,
                    to_srgb: bool, raw: bool = False, dx_user=0.0,
                    dy_user=0.0, crop_y: int = 0):
    """Validity, taper, mask, premultiply, background, gamma — the scaled
    twin of sweep_march._finalize (raw=True returns the (rgba*, alpha,
    hit, invz*) tuple). A leading pose axis on found/invz*/rgba* and c1
    batches."""
    ha = hit_and_alpha_scaled(plan, found, invz_star, rgba_star, c1, f1, fr,
                              feathering, mask_mode, dx_user, dy_user, crop_y)
    return _finish(invz_star, rgba_star, ha, background, to_srgb, raw)


def _check_plan(plan: ScaledPlan, disp):
    h, w = disp.shape
    if (plan.src_w, plan.src_h) != (w, h):
        raise ValueError(f"plan {plan} does not match a {w}x{h} source")


def render_scaled_plain(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    c1,  # (3,) aligned-frame projector position (shader convention)
    f1,
    fr,
    plane_invz,  # (K,) near -> far
    background,
    plan: ScaledPlan,
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 0,
    raw: bool = False,
    dx_user: float = 0.0,
    dy_user: float = 0.0,
    crop_y: int = 0,
    depth_only: bool = False,
):
    """The plain twin of one pose (lif_tpu's render_scaled_xla).

    depth_only=True returns (found (H, W), invz* (H, W)) with no color
    pass and no finalize. Otherwise the bracket color lerp runs and the
    result is finalized: (H, W, 4), or with raw=True the (rgba*, alpha,
    hit, invz*) tuple."""
    _check_plan(plan, disp)
    if len(plane_invz) != num_planes:
        raise ValueError(f"{len(plane_invz)} planes, expected {num_planes}")
    c1_t = _as_f32(c1, disp.device)
    tab = scaled_table_stack(plan, torch.as_tensor(
        plane_invz, dtype=torch.float32, device=disp.device), c1_t[None],
        f1, fr, dx_user, dy_user)[0]
    if depth_only:
        return march_scaled_plain(disp, invz_min, invz_max, tab, plan,
                                  refine=refine)
    found, vstar, rgba = march_scaled_plain(
        disp, invz_min, invz_max, tab, plan, refine=refine,
        rgbm=_rgbm_stack(rgb, mask),
    )
    return finalize_scaled(plan, found, vstar, rgba, c1_t, f1, fr,
                           background, feathering, mask_mode, to_srgb,
                           raw=raw, dx_user=dx_user, dy_user=dy_user,
                           crop_y=crop_y)


# ---------------------------------------------------------------------------
# Device dispatch
# ---------------------------------------------------------------------------


def _march_batch(disp, invz_min, invz_max, tabs, plan: ScaledPlan,
                 refine: int, rgbm=None):
    """The pose-batched march, on the device of `disp`: a CUDA tensor
    launches the kernel (one launch for the batch), a CPU tensor takes
    the plain twin pose by pose. Returns found and invz* (B, H, W) and,
    with rgbm, rgba* (B, H, W, 4)."""
    if disp.device.type == "cuda":
        from .cuda.sweep_scaled import march_scaled_cuda

        return march_scaled_cuda(disp, invz_min, invz_max, tabs, plan,
                                 refine=refine, rgbm=rgbm)
    if disp.device.type != "cpu":
        raise NotImplementedError(
            f"the scaled march runs on CUDA or CPU tensors, not "
            f"{disp.device.type}"
        )
    outs = [
        march_scaled_plain(disp, invz_min, invz_max, tab, plan,
                           refine=refine, rgbm=rgbm)
        for tab in tabs
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def render_scaled_batch(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    c1_b,  # (B, 3)
    f1,
    fr,
    plane_invz,  # (K,) shared or (B, K) per pose
    background,
    plan: ScaledPlan,
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 0,
    raw: bool = False,
    dx_user: float = 0.0,
    dy_user: float = 0.0,
    crop_y: int = 0,
    depth_only: bool = False,
):
    """The scaled march of a pose batch, dispatched on the device of the
    textures (one kernel launch on CUDA). depth_only returns found and
    invz* (B, H, W); otherwise the in-kernel bracket color lerp is
    finalized into (B, H, W, 4), or the raw tuple with a leading pose
    axis."""
    _check_plan(plan, disp)
    dev = disp.device
    c1_t = _as_f32(c1_b, dev)
    tabs = scaled_table_stack(plan, torch.as_tensor(
        plane_invz, dtype=torch.float32, device=dev), c1_t, f1, fr,
        dx_user, dy_user)
    if tabs.shape[2] != num_planes:
        raise ValueError(f"{tabs.shape[2]} planes, expected {num_planes}")
    if depth_only:
        return _march_batch(disp, invz_min, invz_max, tabs, plan, refine)
    found, vstar, rgba = _march_batch(disp, invz_min, invz_max, tabs, plan,
                                      refine, rgbm=_rgbm_stack(rgb, mask))
    return finalize_scaled(plan, found, vstar, rgba, c1_t, f1, fr,
                           background, feathering, mask_mode, to_srgb,
                           raw=raw, dx_user=dx_user, dy_user=dy_user,
                           crop_y=crop_y)


def render_scaled_fetch_batch(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    c1_b,  # (B, 3)
    f1,
    fr,
    plane_invz,
    background,
    plan: ScaledPlan,
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 1,
    raw: bool = False,
    dx_user: float = 0.0,
    dy_user: float = 0.0,
    crop_y: int = 0,
):
    """PRODUCTION scaled tier: the depth-only march + ONE packed bilinear
    color fetch (10-bit color, 1-bit mask) at the solved position, then
    the epilogue. Fetching at the solved position is exact where the
    bracket color lerp of the non-snap grid is only approximate. Returns
    (B, H, W, 4), or raw (rgba, alpha, hit, invz) tuples."""
    h, w = disp.shape
    dev = disp.device
    found, izs = render_scaled_batch(
        rgb, disp, mask, invz_min, invz_max, c1_b, f1, fr, plane_invz,
        None, plan, num_planes, refine=refine, dx_user=dx_user,
        dy_user=dy_user, depth_only=True,
    )
    invz_star = torch.where(found > 0.5, izs, 0.0)
    c1_t = _as_f32(c1_b, dev)
    u1, v1 = _solved_uv(plan, invz_star, c1_t, f1, fr, dx_user, dy_user,
                        crop_y)
    sampled = bilinear_sample_packed(pack_rgbm(rgb, mask), u1, v1, w, h)
    ha = _composite.edge_alpha(found, u1, v1, feathering, sampled[..., 3],
                               mask_mode)
    return _finish(invz_star, sampled, ha, background, to_srgb, raw)
