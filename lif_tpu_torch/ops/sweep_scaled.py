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

from ..utils import profiling
from . import composite as _composite
from .sampling import bilinear_sample_packed, pack_rgbm
from .sweep_march import decodes_down
from .sweep_target import (
    SKIP_TILE,
    WARP,
    _box_bound,
    _rgbm_stack,
    _secant,
    _tdiv,
    skip_tables,
)

__all__ = [
    "ScaledPlan",
    "scaled_plan",
    "scaled_tables",
    "scaled_table_stack",
    "parallax_step_grid",
    "parallax_step_grids_batch",
    "march_scaled_plain",
    "march_scaled_skip_plain",
    "scaled_skip_tables",
    "skip_pack",
    "render_scaled",
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
    tab = torch.as_tensor(tables, dtype=torch.float32, device=dev)
    rows = tab.tolist()
    diff_at = _decoded_diff(dd, invz_min, invz_max, plan)
    zeros = torch.zeros((plan.out_h, plan.out_w), dtype=torch.float32,
                        device=dev)
    kstar = torch.full((plan.out_h, plan.out_w), -1, dtype=torch.int64,
                       device=dev)
    pdiffc, diffc, pdiff = zeros, zeros, zeros
    for k in range(tab.shape[1]):
        diff = diff_at(*(r[k] for r in rows))
        crossed = (kstar < 0) & (diff > 0.0)
        kstar = torch.where(crossed, k, kstar)
        pdiffc = torch.where(crossed, pdiff, pdiffc)
        diffc = torch.where(crossed, diff, diffc)
        pdiff = diff
    return _bracket(dd, tab, kstar, pdiffc, diffc, diff_at, plan, refine,
                    rgbm)


def _decoded_diff(dd, invz_min, invz_max, plan: ScaledPlan):
    """diff_at(tx, ex, ty, ey, v): the decoded inverse depth of the warp
    of dd at those tables minus v, (warp * (izmin - izmax) + izmax) - v,
    over the output pixels."""
    izmin, izmax = np.float32(invz_min), np.float32(invz_max)
    rng, izmax = float(izmin - izmax), float(izmax)
    xc, yc = _centered(plan, dd.device)

    def diff_at(tx, ex, ty, ey, v):
        return (_warp(dd, tx, ex, ty, ey, plan, xc, yc) * rng + izmax) - v

    return diff_at


def _bracket(dd, tab, kstar, pdiffc, diffc, diff_at, plan: ScaledPlan,
             refine: int, rgbm):
    """The march's outputs from each pixel's first crossing k* (-1 where
    none) and secant bracket (pdiffc at k* - 1, diffc at k*): found,
    invz* (the secant, or the refine sub-sweep) and, with rgbm, rgba*."""
    dev = dd.device
    oh, ow = plan.out_h, plan.out_w
    zeros = torch.zeros((oh, ow), dtype=torch.float32, device=dev)
    xc, yc = _centered(plan, dev)
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
# The CUDA kernel's exact plane skip: its tables and its walk in plain torch
# ---------------------------------------------------------------------------

SCALED_RUN = 16  # planes a warp skips at once (csrc/sweep_scaled.cu kRun)


def scaled_skip_tables(disp, invz_min, invz_max):
    """The scaled kernel's skip bounds (b0, b8, b32): ops.sweep_target's
    skip_tables, which bound every bilinear read with tap origin (x, y),
    of disp, or of -disp where the decode texel * (izmin - izmax) + izmax
    falls as the texel rises (the kernel then negates them). A scaled
    read's taps clamp each index on its own, so its origin is its first
    tap index clamped to [0, n - 2] and b0 there covers it."""
    d = disp.to(torch.float32)
    return skip_tables(-d if decodes_down(invz_min, invz_max) else d)


def skip_pack(disp, invz_min, invz_max, target=None):
    """What the scaled kernel reads besides the source and the pose
    tables, built once per texture: (the skip tables flattened into one
    float32 buffer, (2,) the smallest and largest disparity texel).
    target: the target kernel's buffer of the same disparity
    (ops.cuda.sweep_target.skip_table_buffer), where already built: it
    is the scaled kernel's too unless the decode falls."""
    d = disp.to(torch.float32)
    flat = target
    if flat is None or decodes_down(invz_min, invz_max):
        flat = torch.cat([t.reshape(-1)
                          for t in scaled_skip_tables(d, invz_min, invz_max)])
    return flat, torch.stack(torch.aminmax(d)).contiguous()


def _origin_at(p, dv, lo, hi, pad, n):
    """One axis of the clipped separable warp (_warp, _tap_rows) at the
    unclipped displacement dv: the bilinear tap origin, the first tap
    index clamped to [0, n - 2], as int64."""
    g = (p + torch.clamp(dv, lo, hi)) + float(pad)
    return (torch.floor(g).to(torch.int64) - pad).clamp(0, n - 2)


def _axis_taps(t, e, pc, p, lo, hi, pad, n):
    """The tap origin along one axis at table entries (t, e)."""
    return _origin_at(p, t + e * pc, lo, hi, pad, n)


def run_box(run_tab, pc, p, lo, hi, pad, n):
    """Per pixel, the tap origins (lowest, highest) along one axis over
    every plane of a run, from the run's smallest and largest table
    entries (tlo, thi, elo, ehi): each rounded step of the warp is
    monotone in each of its arguments, so these bound the origins of any
    tables in between, with no assumption on how they vary along the
    run."""
    tlo, thi, elo, ehi = run_tab
    ea, eb = elo * pc, ehi * pc
    return (_origin_at(p, tlo + torch.minimum(ea, eb), lo, hi, pad, n),
            _origin_at(p, thi + torch.maximum(ea, eb), lo, hi, pad, n))


def march_scaled_skip_plain(disp, invz_min, invz_max, tables,
                            plan: ScaledPlan, refine: int = 0, rgbm=None,
                            run: int = SCALED_RUN,
                            stats: dict | None = None):
    """The scaled CUDA kernel's walk for ONE pose, in plain torch:
    march_scaled_plain's outputs, bit for bit, reached through the
    kernel's exact skips (an oracle and a counter, never on a render path).

    A warp (an 8 x 4 tile of output pixels) starts one plane before the
    first plane whose depth any decoded texel can reach and walks the
    ladder in runs of `run` planes. A run's tap origins lie, per lane,
    within run_box of the run's table ranges; the box of the warp's
    searching lanes is looked up in the coarse tables (scaled_skip_tables)
    and where that bound, decoded with the kernel's rounded operations,
    is not above the run's smallest plane depth no lane can cross in the
    run, which is skipped whole (a run with a non-finite table entry
    takes the whole source). Otherwise each searching lane tests each
    plane with one read of b0 at its tap origin and reads the four taps
    only where the decoded bound exceeds the plane (a candidate). A lane
    stops at its first crossing; where the plane before it was skipped,
    its difference is read afresh for the secant bracket.

    `stats`, if given, gathers march_target_skip_plain's counts of the
    walk (warp runs tested and skipped, planes walked per warp, candidate
    rounds, lane b0 tests, bilinear reads, bracket refreshes, crossings
    right after a skipped run) and the previous design's one-thread walk
    from the start plane (per lane and as the slowest lane of a warp of
    32 columns of a row)."""
    dev = disp.device
    dd = disp.to(torch.float32)
    h_s, w_s = dd.shape
    izmin, izmax = np.float32(invz_min), np.float32(invz_max)
    rng = float(izmin - izmax)
    down = rng < 0.0
    tab = torch.as_tensor(tables, dtype=torch.float32, device=dev)
    rows = tab.tolist()
    n_k = tab.shape[1]
    oh, ow = plan.out_h, plan.out_w
    diff_at = _decoded_diff(dd, invz_min, invz_max, plan)
    b0, b8, b32 = scaled_skip_tables(dd, invz_min, invz_max)
    (xc, jx), (yc, iy) = _centered(plan, dev)
    xc, jx = xc.expand(oh, ow), jx.expand(oh, ow)
    yc, iy = yc.expand(oh, ow), iy.expand(oh, ow)
    clip_x = (-float(plan.pad_lo_x), float(plan.tab_span_x - plan.pad_lo_x))
    clip_y = (-float(plan.my_lo), float(plan.my_hi))

    def origins(k):
        return (_axis_taps(rows[0][k], rows[1][k], xc, jx, *clip_x,
                           plan.pad_lo_x, w_s),
                _axis_taps(rows[2][k], rows[3][k], yc, iy, *clip_y,
                           plan.pad_lo_y, h_s))

    def crosses(bound, v):
        """Can a read bounded by `bound` (decoded with the kernel's
        rounded operations) lie in front of plane depth v?"""
        bv = -bound if down else bound
        return (bound == math.inf) | (((bv * rng + float(izmax)) - v) > 0.0)

    # the start skip (sweep_scaled.cu): one plane before the first plane
    # whose depth is not above every decoded texel, with its slack
    dlim = torch.stack(torch.aminmax(dd))
    a, b = dlim[0] * rng, dlim[1] * rng
    top = torch.maximum(a, b) + float(izmax)
    bound = top + (torch.maximum(a.abs(), b.abs()) + abs(float(izmax))) * (
        1.52587890625e-05) + 1e-30
    reach = torch.nonzero(~(tab[4] > bound))
    k_start = max(int(reach[0, 0]) - 1 if len(reach) else n_k - 1, 0)

    tx, ty = SKIP_TILE
    n_h, n_w = -(-oh // ty), -(-ow // tx)

    def lanes(x, fill):
        x = torch.nn.functional.pad(
            x, (0, n_w * tx - ow, 0, n_h * ty - oh), value=fill)
        return x.reshape(n_h, ty, n_w, tx).transpose(1, 2).reshape(
            n_h, n_w, WARP)

    def cols(x):
        x = x.reshape(n_h, n_w, ty, tx).transpose(1, 2)
        return x.reshape(n_h * ty, n_w * tx)[:oh, :ow]

    active = torch.ones((oh, ow), dtype=torch.bool, device=dev)
    kstar = torch.full((oh, ow), -1, dtype=torch.int64, device=dev)
    zeros = torch.zeros((oh, ow), dtype=torch.float32, device=dev)
    pd, pdc, dc = zeros, zeros, zeros
    pk = torch.full((oh, ow), -1, dtype=torch.int64, device=dev)
    vl = rows[4]
    count = dict(runs=0, runs_skipped=0, warp_steps=0, warp_bil_steps=0,
                 warp_bil_rounds=0, lane_tests=0, bil_reads=0, refreshes=0,
                 after_skip=0)
    prev_skip = torch.zeros((n_h, n_w), dtype=torch.bool, device=dev)
    big = 1 << 40
    for k in range(k_start, n_k, run):
        ke = min(k + run, n_k) - 1
        live = lanes(active, False).any(-1)
        if not bool(live.any()):
            break
        seg = [r[k:ke + 1] for r in rows]
        sane = all(math.isfinite(x) for r in seg[:4] for x in r)
        vmin = min((v for v in seg[4] if v == v), default=math.inf)
        if sane:
            xa, xb = run_box((min(seg[0]), max(seg[0]), min(seg[1]),
                              max(seg[1])), xc, jx, *clip_x, plan.pad_lo_x,
                             w_s)
            ya, yb = run_box((min(seg[2]), max(seg[2]), min(seg[3]),
                              max(seg[3])), yc, iy, *clip_y, plan.pad_lo_y,
                             h_s)
        else:
            xa, xb = torch.zeros_like(kstar), torch.full_like(kstar, w_s - 2)
            ya, yb = torch.zeros_like(kstar), torch.full_like(kstar, h_s - 2)
        box = [lanes(torch.where(active, v, fill), fill).amin(-1) if lo
               else lanes(torch.where(active, v, fill), fill).amax(-1)
               for v, lo, fill in zip((xa, xb, ya, yb),
                                      (True, False, True, False),
                                      (big, -1, big, -1))]
        skip = live & ~crosses(_box_bound((b0, b8, b32), box), vmin)
        count["runs"] += int(live.sum())
        count["runs_skipped"] += int(skip.sum())
        walk = cols((live & ~skip)[..., None].expand(n_h, n_w, WARP))
        after_skip = cols(prev_skip[..., None].expand(n_h, n_w, WARP))
        prev_skip = skip
        candidates = torch.zeros((oh, ow), dtype=torch.int64, device=dev)
        for kk in range(k, ke + 1):
            lane = active & walk
            steps = lanes(lane, False).any(-1)
            if not bool(steps.any()):
                break
            count["warp_steps"] += int(steps.sum())
            count["lane_tests"] += int(lane.sum())
            ox, oy = origins(kk)
            need = lane & crosses(b0[oy, ox], vl[kk])
            count["bil_reads"] += int(need.sum())
            count["warp_bil_steps"] += int(lanes(need, False).any(-1).sum())
            candidates = candidates + need
            d = diff_at(*(r[kk] for r in rows))
            crossed = need & (d > 0.0)
            if bool(crossed.any()):
                fresh = crossed & (pk != kk - 1)
                count["refreshes"] += int(fresh.sum())
                count["bil_reads"] += int(fresh.sum())
                if kk == k:
                    count["after_skip"] += int((crossed & after_skip).sum())
                prev = diff_at(*(r[kk - 1] for r in rows)) if kk > 0 \
                    else zeros
                pdc = torch.where(crossed, torch.where(fresh, prev, pd), pdc)
                dc = torch.where(crossed, d, dc)
                kstar = torch.where(crossed, kk, kstar)
                active = active & ~crossed
            keep = need & ~crossed
            pd = torch.where(keep, d, pd)
            pk = torch.where(keep, kk, pk)
        count["warp_bil_rounds"] += int(lanes(candidates, 0).amax(-1).sum())
    if stats is not None:
        visits = torch.where(kstar >= 0, kstar - k_start + 1, n_k - k_start)
        count["old_lane_visits"] = int(visits.sum())
        # that walk's warps were 32 neighbouring columns of a row
        rows_w = torch.nn.functional.pad(visits, (0, -ow % WARP))
        count["old_warp_visits"] = int(
            rows_w.reshape(oh, -1, WARP).amax(-1).sum()) * WARP
        count["k_start"] = k_start
        for key, val in count.items():
            stats[key] = stats.get(key, 0) + val
    return _bracket(dd, tab, kstar, pdc, dc, diff_at, plan, refine, rgbm)


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
                 refine: int, rgbm=None, skip_tables=None):
    """The pose-batched march, on the device of `disp`: a CUDA tensor
    launches the kernel (one launch for the batch; `skip_tables` its
    skip_pack, cached with the textures), a CPU tensor takes the plain
    twin pose by pose. Returns found and invz* (B, H, W) and, with rgbm,
    rgba* (B, H, W, 4)."""
    if disp.device.type == "cuda":
        from .cuda.sweep_scaled import march_scaled_cuda

        with profiling.span("lif.kernel.scaled"):
            return march_scaled_cuda(disp, invz_min, invz_max, tabs, plan,
                                     refine=refine, rgbm=rgbm,
                                     skip_tables=skip_tables)
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


def render_scaled(rgb, disp, mask, invz_min, invz_max, c1, f1, fr,
                  plane_invz, background, plan: ScaledPlan, num_planes: int,
                  skip_tables=None, **kw):
    """The scaled march of one pose, dispatched on the device of the
    textures (lif_tpu's render_scaled): a CUDA tensor launches the kernel
    as a batch of one (render_scaled_batch, which needs `skip_tables`, the
    kernel's skip_pack), a CPU tensor takes the plain twin
    (render_scaled_plain). c1 (3,), plane_invz (K,); kw as
    render_scaled_plain's. Returns what render_scaled_plain returns."""
    if disp.device.type == "cpu":
        return render_scaled_plain(rgb, disp, mask, invz_min, invz_max, c1,
                                   f1, fr, plane_invz, background, plan,
                                   num_planes, **kw)
    out = render_scaled_batch(
        rgb, disp, mask, invz_min, invz_max, _as_f32(c1, disp.device)[None],
        f1, fr, plane_invz, background, plan, num_planes,
        skip_tables=skip_tables, **kw)
    return tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]


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
    skip_tables=None,
):
    """The scaled march of a pose batch, dispatched on the device of the
    textures (one kernel launch on CUDA, which needs skip_tables, the
    kernel's skip_pack; the CPU ignores it). depth_only returns found and
    invz* (B, H, W); otherwise the in-kernel bracket color lerp is
    finalized into (B, H, W, 4), or the raw tuple with a leading pose
    axis."""
    _check_plan(plan, disp)
    dev = disp.device
    c1_t = _as_f32(c1_b, dev)
    if not isinstance(c1_b, torch.Tensor):
        profiling.host_sync("sync.upload.poses", dev)
    tabs = scaled_table_stack(plan, torch.as_tensor(
        plane_invz, dtype=torch.float32, device=dev), c1_t, f1, fr,
        dx_user, dy_user)
    if tabs.shape[2] != num_planes:
        raise ValueError(f"{tabs.shape[2]} planes, expected {num_planes}")
    if depth_only:
        return _march_batch(disp, invz_min, invz_max, tabs, plan, refine,
                            skip_tables=skip_tables)
    found, vstar, rgba = _march_batch(disp, invz_min, invz_max, tabs, plan,
                                      refine, rgbm=_rgbm_stack(rgb, mask),
                                      skip_tables=skip_tables)
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
    skip_tables=None,
):
    """PRODUCTION scaled tier: the depth-only march + ONE packed bilinear
    color fetch (10-bit color, 1-bit mask) at the solved position, then
    the epilogue. Fetching at the solved position is exact where the
    bracket color lerp of the non-snap grid is only approximate.
    skip_tables: the kernel's skip_pack, cached with the textures (CUDA
    only). Returns
    (B, H, W, 4), or raw (rgba, alpha, hit, invz) tuples."""
    h, w = disp.shape
    dev = disp.device
    found, izs = render_scaled_batch(
        rgb, disp, mask, invz_min, invz_max, c1_b, f1, fr, plane_invz,
        None, plan, num_planes, refine=refine, dx_user=dx_user,
        dy_user=dy_user, depth_only=True, skip_tables=skip_tables,
    )
    with profiling.span("lif.epilogue.scaled"):
        invz_star = torch.where(found > 0.5, izs, 0.0)
        c1_t = _as_f32(c1_b, dev)
        if not isinstance(c1_b, torch.Tensor):
            profiling.host_sync("sync.upload.poses", dev)
        u1, v1 = _solved_uv(plan, invz_star, c1_t, f1, fr, dx_user, dy_user,
                            crop_y)
        with profiling.span("lif.fetch"):
            sampled = bilinear_sample_packed(pack_rgbm(rgb, mask), u1, v1,
                                             w, h)
        ha = _composite.edge_alpha(found, u1, v1, feathering,
                                   sampled[..., 3], mask_mode)
        return _finish(invz_star, sampled, ha, background, to_srgb, raw)
