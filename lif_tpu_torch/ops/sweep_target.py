"""Single-phase TARGET-RAY march for rotated novel views: host planning,
the plain PyTorch twin, the fetch epilogue and the device dispatch.

The counterpart of lif_tpu.ops.sweep_target. Every target pixel p marches
the full-resolution source directly along its own ray (reference
semantics: src/shaders/rayCastMonoLDI.glsl:219-297). With the
target-frame relative pose (rot1, c1) and focals (f1, f2),

    q       = homography(rot1, f1, f2) applied to the target pixel
    c_vec   = FSKR1 @ (-c1)
    s1(v)   = c_vec * v + (1 - c_vec_z * v) * q        (glsl:249)

so the SOURCE PIXEL position at inverse depth v is affine in v with
per-pixel coefficients:

    X(p, v) = AX(p) + v * DX(p)    AX = (qx + 0.5) * w - 0.5   [index]
    Y(p, v) = AY(p) + v * DY(p)    DX = (c_x - c_z * qx) * w   [px / v]

Planes are walked near -> far; the first plane where the bilinear
disparity at (X, Y) lies in front of the plane is the crossing, refined
by a secant in its bracket (and, with refine > 0, by an in-bracket
sub-sweep).

Host planning (extents, the yaw gate, plans, per-pose ladders and pose
packs) is float64 numpy, lif_tpu's own code copied here, so that routing
cannot drift from the reference. Two implementations of the march share it:
  * march_target_plain: a Python loop over planes in plain torch, the
    kernel's plain version; render_target_plain is the twin of
    lif_tpu's render_target_xla, the CPU path;
  * lif_tpu_torch.ops.cuda.sweep_target: the hand-written CUDA kernel
    (csrc/sweep_target.cu), the path of every CUDA tensor, which skips
    planes exactly with the max tables of skip_tables;
    march_target_skip_plain is the plain mirror of its walk.
render_target_batch and render_target_fetch_batch dispatch on the
device of the textures.

Eligibility: X must not depend on the target ROW (exact for yaw-only
relative rotations — the orbit family); target_extents measures the
row-dependence and raises beyond a fraction of a pixel. Pitch-family
rotations go through the renderer's transpose route.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiling
from . import composite as _composite
from .sampling import bilinear_sample_packed, pack_rgbm

__all__ = [
    "TargetPlan",
    "TargetExtents",
    "plan_target",
    "target_extents",
    "bucket_extents",
    "plan_from_extents",
    "target_pose_scalars",
    "target_plane_grids",
    "march_target_plain",
    "march_target_skip_plain",
    "render_target_batch",
    "render_target_fetch_batch",
    "render_target_plain",
    "finalize_target",
    "skip_tables",
]

# lif_tpu's tiling constants. The plan below keeps lif_tpu's geometry
# (its 128-column groups, 8-column bands, 128-row chunks) because the
# same numbers decide which pose batches this tier accepts; the CUDA
# kernel itself does not use that tiling.
_LC = 128  # y-chunk height
_TW = 8  # band width in target columns
_G = 16  # bands per group: 16 * 8 = 128 output columns
_COARSE_CELL = 8  # skip-table cell width in source px
_TWX_CELLS = 4  # x-stage slab reach in cells


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


class TargetPlan(NamedTuple):
    """Static geometry of the target-ray march (host ints), field for
    field lif_tpu's plan. The window fields (pads, bw, ylen, candidate
    counts, skip-table span) describe lif_tpu's TPU kernel, whose
    (group, chunk) programs hold a (C, bw, ylen) source window; here they
    only decide routing (plan_from_extents). The CUDA kernel reads
    src_w, src_h, out_w and out_h."""

    src_w: int
    src_h: int
    out_w: int
    out_h: int
    pad_x: int  # symmetric x padding of the source (edge-replicated)
    pad_y: int  # symmetric y padding
    bw: int  # resident window width (sublanes), multiple of 8
    ylen: int  # resident window height (lanes), multiple of 128
    nxc: int  # max x hat candidates (static unroll cap, diagonal slide)
    nyc: int  # max y hat candidates
    hp_out: int  # padded output height (lane grid)
    gspan: int  # skip-table sliding span in 8-px source cells
    cm_ylims: tuple  # per-chunk (lo, hi) padded-source row range the
    # skip table must max over — exact bounds of the window table


def _pose_fields_np(rot1, c1, f1, f2, out_w, out_h, src_w, src_h):
    """Float64 host twins of the kernel's pose fields: the full p_ts
    homography matrix and c_vec (matches rotated_march.pose_maps)."""
    skr1 = _shader_rotation_np(np.asarray(rot1, np.float64))
    fskr1 = _mat_from_focal_np(f1 / src_w, f1 / src_h) @ skr1
    fskr2 = _mat_from_focal_np(f2 / out_w, f2 / out_h)
    p_ts = fskr1 @ np.linalg.inv(fskr2)
    c_vec = fskr1 @ (-np.asarray(c1, np.float64))
    return p_ts, c_vec


def _shader_rotation_np(rot):
    """Numpy twin of core.transforms.shader_rotation (z-flip conjugation)."""
    flip = np.diag([1.0, 1.0, -1.0])
    return flip @ np.asarray(rot, np.float64).T @ flip


def _pose_fields_batch_np(rot_b, c1_b, f1, f2, out_w, out_h, src_w, src_h):
    """Vectorized _pose_fields_np over the pose batch: (B, 3, 3) p_ts and
    (B, 3) c_vec without a Python loop (plan_target's per-pose numpy loop
    measured ~1 ms/pose — 120 ms of host time per 120-pose plan call).
    The diagonal focal matrices become row/column scalings; the z-flip
    conjugation is a sign pattern on the transposed rotation. Values are
    fp-equivalent (not bit-identical: inv(diag(f2/w)) vs w/f2 rounds
    once, not twice) — plan_target's ±2 px slack dwarfs the ~1e-13
    relative difference, and the kernel-facing scalars
    (target_pose_scalars) still use the exact per-pose path."""
    rot = np.asarray(rot_b, np.float64)  # (B, 3, 3)
    s = np.array([1.0, 1.0, -1.0])
    skr1 = s[None, :, None] * s[None, None, :] * np.swapaxes(rot, 1, 2)
    row = np.array([f1 / src_w, f1 / src_h, 1.0])
    fskr1 = row[None, :, None] * skr1
    col = np.array([out_w / f2, out_h / f2, 1.0])
    p_ts = fskr1 * col[None, None, :]
    c_vec = np.einsum("bij,bj->bi", fskr1, -np.asarray(c1_b, np.float64))
    return p_ts, c_vec


def _mat_from_focal_np(fx, fy):
    return np.diag([fx, fy, 1.0])


def target_pose_scalars(rot1, c1, f1, f2, out_w, out_h, src_w, src_h):
    """(16,) f32 per-pose scalar pack for the kernel: row-major p_ts (9),
    c_vec (3), and 4 spare zeros."""
    p_ts, c_vec = _pose_fields_np(rot1, c1, f1, f2, out_w, out_h,
                                  src_w, src_h)
    out = np.zeros(16, np.float64)
    out[:9] = p_ts.reshape(-1)
    out[9:12] = c_vec
    return out.astype(np.float32)


def target_plane_grids(rot_list, c1_list, f1, f2, out_w, out_h,
                       src_w, src_h, izmin, izmax, step_px=1.0,
                       num_planes=None, bucket=64, max_planes=1024):
    """Per-pose inverse-depth ladders with one shared bucketed K.

    Plane density: at most `step_px` pixels of source-position change per
    plane for ANY target pixel, measured as the L1 path length |DX|+|DY|
    over the four image corners — a diagonal sample path crosses texel
    boundaries on BOTH axes, and each boundary is a kink in the
    piecewise-linear bilinear read that the bracket secant cannot see
    (measured: the per-axis-max bound leaves y-dominant poses at ~34 dB
    on random textures where the L1 bound restores >=40; x-dominant
    orbit poses have |DY| ~ 0 so their ladders are unchanged). Padding
    planes continue ABOVE izmin (texel thresholds > 1: never crossed,
    pruned by the skip test). Returns ((B, K) f32 descending, K)."""
    # vectorized over the pose batch (the per-pose numpy loop measured
    # ~1 ms/pose — interactive novel-pose planning pays this every frame)
    p_ts, c_vec = _pose_fields_batch_np(
        np.stack([np.asarray(r, np.float64) for r in rot_list]),
        np.stack([np.asarray(c, np.float64) for c in c1_list]),
        f1, f2, out_w, out_h, src_w, src_h,
    )
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
    dm = (dx + dy).max(axis=1)  # (B,)
    ks = [
        min(max_planes,
            max(2, int(math.ceil(d * (izmin - izmax) / step_px)) + 2))
        for d in dm
    ]
    k_shared = num_planes or max(bucket, _round_up(max(ks), bucket))
    grids = []
    for k_pose, dmax in zip(ks, dm):
        k_real = min(k_pose, k_shared)
        grid = np.linspace(izmin, izmax, k_real)
        pad = k_shared - k_real
        if pad:
            step = grid[0] - grid[1] if k_real > 1 else (izmin - izmax)
            top = izmin + step * np.arange(pad, 0, -1, dtype=np.float64)
            grid = np.concatenate([top, grid])
        grids.append(grid)
    return np.stack(grids).astype(np.float32), k_shared


class TargetExtents(NamedTuple):
    """Pose-batch-unioned window extents of the target-ray march, in
    UNPADDED source pixel coordinates (int64 host arrays). A plan built
    from any SUPERSET of these extents renders every pose in the batch
    correctly, so extents can be widened (bucket_extents) to make one
    compiled plan serve a pose NEIGHBORHOOD — the interactive-pose
    answer to the reference's per-frame ~0.12 ms pose-update budget
    (ROTATION-MATRIX-API.md:229-241): computing extents for a novel
    pose is vectorized sub-ms numpy, and a bucketed-extent cache hit
    reuses the compiled kernel plus its window tables outright."""

    xlo: np.ndarray  # (ng,) group window x starts (already -2 slack)
    xhi: np.ndarray  # (ng,) exclusive-ish ends (+2 slack)
    ylo: np.ndarray  # (ng, nc)
    yhi: np.ndarray  # (ng, nc)
    nx_need: int
    ny_need: int
    gspan_px: int

    def key(self):
        """Hashable identity for plan caching."""
        return (
            self.xlo.tobytes(), self.xhi.tobytes(),
            self.ylo.tobytes(), self.yhi.tobytes(),
            self.nx_need, self.ny_need, self.gspan_px,
        )


def bucket_extents(ext: TargetExtents, qxy: int = 64,
                   qn: int = 2) -> TargetExtents:
    """Widen extents outward to a coarse lattice: window starts floor to
    qxy, ends ceil to qxy, candidate counts / skip span ceil to qn. Any
    pose whose true extents bucket to the same lattice cell shares the
    plan AND the compiled kernel — correctness by construction, since
    the bucketed extents are a superset of the true ones."""

    def _dn(a):
        return (np.asarray(a, np.int64) // qxy) * qxy

    def _up(a):
        return -(-np.asarray(a, np.int64) // qxy) * qxy

    return TargetExtents(
        xlo=_dn(ext.xlo), xhi=_up(ext.xhi),
        ylo=_dn(ext.ylo), yhi=_up(ext.yhi),
        nx_need=-(-ext.nx_need // qn) * qn,
        ny_need=-(-ext.ny_need // qn) * qn,
        gspan_px=-(-ext.gspan_px // qn) * qn,
    )


def target_extents(
    src_w: int,
    src_h: int,
    out_w: int,
    out_h: int,
    f1: float,
    f2: float,
    rot_list,
    c1_list,
    izmin: float,
    izmax: float,
    yaw_tol_px: float = 0.35,
) -> TargetExtents:
    """Measure the pose batch's window extents (vectorized host numpy,
    sub-ms per pose). Raises ValueError for non-yaw-family rotations
    (row-dependent x positions beyond `yaw_tol_px`)."""
    gw = _G * _TW
    if out_w % gw:
        raise ValueError(f"out_w {out_w} must be divisible by {gw}")
    nb = out_w // _TW
    ng = out_w // gw
    hp_out = _round_up(out_h, _LC)
    nc = hp_out // _LC
    b_n = len(rot_list)

    ylo_all = np.zeros((b_n, ng, nc), np.int64)
    yhi_all = np.zeros((b_n, ng, nc), np.int64)
    nx_need = 0
    ny_need = 0
    gspan_px = 0

    # batched pose fields: (B, 3, 3) / (B, 3); every per-pose quantity
    # below carries a leading batch axis instead of a Python loop
    p_ts, c_vec = _pose_fields_batch_np(
        np.stack([np.asarray(r, np.float64) for r in rot_list]),
        np.stack([np.asarray(c, np.float64) for c in c1_list]),
        f1, f2, out_w, out_h, src_w, src_h,
    )

    def _proj_b(sx, sy):
        """The batch's homographies at sx (n,) (or (B, n)), sy scalar ->
        (B, n) normalized source coords."""
        den = (p_ts[:, 2, 0, None] * sx + p_ts[:, 2, 1, None] * sy
               + p_ts[:, 2, 2, None])
        qx = (p_ts[:, 0, 0, None] * sx + p_ts[:, 0, 1, None] * sy
              + p_ts[:, 0, 2, None]) / den
        qy = (p_ts[:, 1, 0, None] * sx + p_ts[:, 1, 1, None] * sy
              + p_ts[:, 1, 2, None]) / den
        return qx, qy

    # yaw gate: X must not depend on the target row
    jg = (np.arange(nb + 1) * _TW).astype(np.float64)
    sxg = (jg + 0.5) / out_w - 0.5  # band edges (+ right edge)
    qx_m, _ = _proj_b(sxg, 0.0)
    for syg in (-0.5, 0.5):
        qx_t, _ = _proj_b(sxg, syg)
        dxv = np.abs(qx_t - qx_m) * src_w
        dvx = np.abs(c_vec[:, 2, None] * (qx_t - qx_m)) * src_w * izmin
        if (dxv + dvx).max() > yaw_tol_px:
            raise ValueError(
                "rotation has row-dependent x positions "
                f"(max {float((dxv + dvx).max()):.2f} px > "
                f"{yaw_tol_px}); not a yaw-family pose"
            )
    # band-edge positions: X(j, v) = AX + v DX, monotone in j; v in
    # {izmax, izmin} covers the v range (affine in v)
    ax_e = (qx_m + 0.5) * src_w - 0.5  # (B, nb + 1)
    dx_e = (c_vec[:, 0, None] - c_vec[:, 2, None] * qx_m) * src_w
    # per-band x candidate need, DIAGONAL: candidates ride the
    # target column (slab[o + j], the scaled kernel's slide), so the
    # span is the deviation of (pos(j) - j) across a band — the
    # band's footprint only enters through |scale - 1|
    for v in (izmax, izmin):
        diag = ax_e + v * dx_e - jg[None]
        span_b = np.abs(diag[:, 1:] - diag[:, :-1])
        nx_need = max(nx_need, int(np.ceil(span_b.max())) + 3)
    # group x extents and skip-table span (group edges: X monotone)
    ge = np.arange(0, nb + 1, _G)  # group edge indices into ax_e
    gl_b = np.full((b_n, ng), np.inf)
    gh_b = np.full((b_n, ng), -np.inf)
    for v in (izmax, izmin):
        pos = ax_e + v * dx_e
        gl = np.minimum(pos[:, ge[:-1]], pos[:, ge[1:]])
        gh = np.maximum(pos[:, ge[:-1]], pos[:, ge[1:]])
        gl_b = np.minimum(gl_b, gl)
        gh_b = np.maximum(gh_b, gh)
        gspan_px = max(gspan_px, int(np.ceil((gh - gl).max())))
    xlo_all = np.floor(gl_b).astype(np.int64) - 2
    xhi_all = np.ceil(gh_b).astype(np.int64) + 2
    # per (group, chunk) y extents from the 4 tile corners (AY - i
    # and DY are each corner-extremal in (x, y) — qy is a Möbius map
    # in each variable; the kernel bounds the per-plane span by the
    # sum of corner bounds (rlo = r_min + v*d_min), so the plan
    # budgets exactly that decomposition)
    ig = np.minimum(np.arange(nc + 1) * _LC, out_h).astype(np.float64)
    gx_l = sxg[ge[:-1]]
    gx_r = sxg[ge[1:]]
    for ci in range(nc):
        rows = np.array([ig[ci], max(ig[ci], min(ig[ci + 1], out_h)
                                     - 1.0)])
        sy_c = (rows + 0.5) / out_h - 0.5
        a_lo = np.full((b_n, ng), np.inf)
        a_hi = np.full((b_n, ng), -np.inf)
        d_lo = np.full((b_n, ng), np.inf)
        d_hi = np.full((b_n, ng), -np.inf)
        abs_lo = np.full((b_n, ng), np.inf)
        abs_hi = np.full((b_n, ng), -np.inf)
        for sxe in (gx_l, gx_r):
            for rw, sye in zip(rows, sy_c):
                _, qy_c = _proj_b(sxe, sye)  # (B, ng)
                ay_c = (qy_c + 0.5) * src_h - 0.5
                dy_c = (c_vec[:, 1, None] - c_vec[:, 2, None] * qy_c) * src_h
                a_lo = np.minimum(a_lo, ay_c - (rw - ig[ci]))
                a_hi = np.maximum(a_hi, ay_c - (rw - ig[ci]))
                d_lo = np.minimum(d_lo, dy_c)
                d_hi = np.maximum(d_hi, dy_c)
                for v in (izmax, izmin):
                    pos = ay_c + v * dy_c
                    abs_lo = np.minimum(abs_lo, pos)
                    abs_hi = np.maximum(abs_hi, pos)
        ylo_all[:, :, ci] = np.floor(abs_lo).astype(np.int64) - 2
        yhi_all[:, :, ci] = np.ceil(abs_hi).astype(np.int64) + 2
        for v in (izmax, izmin):
            span_v = (a_hi + v * d_hi) - (a_lo + v * d_lo)
            ny_need = max(ny_need, int(np.ceil(span_v.max())) + 3)

    return TargetExtents(
        xlo=xlo_all.min(axis=0), xhi=xhi_all.max(axis=0),
        ylo=ylo_all.min(axis=0), yhi=yhi_all.max(axis=0),
        nx_need=nx_need, ny_need=ny_need, gspan_px=gspan_px,
    )


def plan_from_extents(
    src_w: int,
    src_h: int,
    out_w: int,
    out_h: int,
    ext: TargetExtents,
    nxc_cap: int = 14,
    nyc_cap: int = 80,
    bw_cap: int = 2048,
    channels: int = 1,
):
    """Build the static plan + window tables from (possibly widened)
    extents. Raises ValueError when the extents leave the TPU kernel's
    budgets (candidate spans beyond the caps, window wider than
    `bw_cap`, VMEM blowout) — the renderer then routes the batch to the
    two-phase rotated tier.

    The caps (nxc_cap, nyc_cap, bw_cap, the 13 MiB window budget) are
    lif_tpu's TPU budgets, kept unchanged as ROUTING GATES so that this
    tier accepts exactly the pose batches lif_tpu sends to it. The CUDA
    kernel has no window and reads only src_w, src_h, out_w and out_h
    from the plan.

    Returns (plan, xlo (ng,) i32, ylo (ng, nc) i32) where xlo/ylo are
    lif_tpu's PADDED-source window origins per group / per (group,
    chunk); the port computes them for parity and does not use them."""
    hp_out = _round_up(out_h, _LC)
    nc = hp_out // _LC
    nx_need, ny_need, gspan_px = ext.nx_need, ext.ny_need, ext.gspan_px
    xlo_sh, xhi_sh = ext.xlo, ext.xhi  # (ng,)
    ylo_sh, yhi_sh = ext.ylo, ext.yhi  # (ng, nc)
    if nx_need > nxc_cap:
        raise ValueError(f"x candidate span {nx_need} > cap {nxc_cap}")
    if ny_need > nyc_cap:
        raise ValueError(f"y candidate span {ny_need} > cap {nyc_cap}")

    # bw covers the extent plus the slab reach (o8 never clips: the
    # 8-aligned slab base + _TWX sublanes always fit)
    bw_need = int((xhi_sh - xlo_sh).max()) + 32 + 16
    bw = _round_up(bw_need, 8)
    if bw > bw_cap:
        raise ValueError(f"window width {bw} > cap {bw_cap}")
    # skip-table sliding span in 8-px cells: a plane's slabs reach at
    # most gspan_px + _TWX + 8 source px from the group's per-plane
    # minimum base cell
    gspan = gspan_px // _COARSE_CELL + _TWX_CELLS + 3
    # DMA lane offsets must be 128-aligned: origins floor to 128, so the
    # window height carries up to 127 rows of slack on top of the span
    ylen_need = int((yhi_sh - ylo_sh).max()) + ny_need + 8 + 128
    ylen = _round_up(max(ylen_need, 2 * _LC), _LC)
    # VMEM budget: the resident window plus the xa16 slab (GW x ylen)
    # and fixed state must fit a 16 MB core. The PRODUCTION tier
    # (render_target_fetch_batch) marches depth_only — a 1-channel
    # window (`channels` default) — so wide pose unions that would blow
    # a 5-channel budget still ride the kernel; callers of the
    # full-color debug mode must plan with channels=5. A pose batch
    # whose union window exceeds the budget must fall back (two-phase
    # tier) rather than fail at compile.
    # kernel fixed scratch: xa16 is (GW, xap) with xap = pow2 pad of the
    # per-plane 384-lane y window; the transposed slab is a (256, GW)
    # value (ops/pallas/sweep_target.py v4 layout)
    xap = 256 if min(ylen, 384) <= 256 else 512
    vmem_bytes = (channels * bw * ylen + _G * _TW * (xap + 256)) * 4
    if vmem_bytes > 13 * 1024 * 1024:
        raise ValueError(
            f"pose-union window needs {vmem_bytes / 1e6:.1f} MB VMEM "
            "(> 13 MiB budget); split the pose batch or fall back"
        )

    # padded-source origins (before alignment). Pads bucket to 64/128 —
    # they are jit STATICS (the padded-source shape), so a drifting
    # interactive camera must not recompile every few pixels of window
    # motion; a bucket step costs only edge-padding memory.
    pad_x = max(0, int(-xlo_sh.min()), int((xlo_sh + bw).max()) - src_w)
    pad_x = _round_up(pad_x, 64)
    xlo_pad = ((xlo_sh + pad_x) // 8) * 8
    # pad_y must be FINAL before computing padded origins (the kernel's
    # yoff uses plan.pad_y); flooring origins to 128 costs <= 127 rows,
    # already budgeted in ylen. pad_y >= ylo_sh.max() + ylen - src_h
    # guarantees window bottoms stay inside the padded image.
    pad_y = _round_up(
        max(0, int(-ylo_sh.min()), int(ylo_sh.max()) + ylen - src_h), 128
    )
    ylo_pad = ((ylo_sh + pad_y) // 128) * 128
    # hp_src in the kernel wrapper is h + 2*pad_y rounded to _LC; ensure
    # every window row exists there
    hp_src = _round_up(src_h + 2 * pad_y, _LC)
    assert int((ylo_pad + ylen).max()) <= hp_src, (ylo_pad.max(), ylen,
                                                  hp_src)

    # cm_ylims is a jit static too: bucket outward to 256-row steps
    # (clamped to the padded source) so window drift rarely re-traces
    hp_src_b = _round_up(src_h + 2 * pad_y, _LC)
    cm_ylims = tuple(
        (
            max(0, (int(ylo_pad[:, c].min()) // 256) * 256),
            min(hp_src_b,
                _round_up(int(ylo_pad[:, c].max()) + ylen, 256)),
        )
        for c in range(nc)
    )
    plan = TargetPlan(
        src_w=src_w, src_h=src_h, out_w=out_w, out_h=out_h,
        pad_x=pad_x, pad_y=pad_y, bw=bw, ylen=ylen,
        nxc=nx_need, nyc=ny_need, hp_out=hp_out, gspan=gspan,
        cm_ylims=cm_ylims,
    )
    assert xlo_pad.min() >= 0 and ylo_pad.min() >= 0
    assert int((xlo_pad + bw).max()) <= src_w + 2 * pad_x + 8
    return (
        plan,
        xlo_pad.astype(np.int32),
        ylo_pad.astype(np.int32),
    )


def plan_target(
    src_w: int,
    src_h: int,
    out_w: int,
    out_h: int,
    f1: float,
    f2: float,
    rot_list,
    c1_list,
    izmin: float,
    izmax: float,
    yaw_tol_px: float = 0.35,
    nxc_cap: int = 14,
    nyc_cap: int = 80,
    bw_cap: int = 2048,
    channels: int = 1,
):
    """Exact-extent plan for a pose batch: target_extents +
    plan_from_extents (see those for the contract). The renderer's
    interactive path instead buckets the extents (bucket_extents) so a
    plan serves a pose neighborhood."""
    ext = target_extents(
        src_w, src_h, out_w, out_h, f1, f2, rot_list, c1_list,
        izmin, izmax, yaw_tol_px=yaw_tol_px,
    )
    return plan_from_extents(
        src_w, src_h, out_w, out_h, ext,
        nxc_cap=nxc_cap, nyc_cap=nyc_cap, bw_cap=bw_cap,
        channels=channels,
    )


# ---------------------------------------------------------------------------
# The plain twin (dense torch): the kernel's plain version
# ---------------------------------------------------------------------------


def _tdiv(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d by true float32 division. On CUDA, dividing a tensor by a
    Python number multiplies by its reciprocal, which rounds differently
    from the division the kernel and lif_tpu perform."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def plane_thresholds(plane_invz: torch.Tensor, invz_min, invz_max):
    """Texel-space plane thresholds tk = (v - izmax) / (izmin - izmax):
    texel > tk  <=>  decoded inverse depth > v. Shared by the plain twin
    and the kernel's wrapper, so both compare against the same bits."""
    izmin, izmax = np.float32(invz_min), np.float32(invz_max)
    return _tdiv(plane_invz - float(izmax), float(izmin - izmax))


def _fields(pose_sc, out_w: int, out_h: int, src_w: int, src_h: int):
    """Per-pixel AX, DX, AY, DY, qx, qy from (..., 16) pose packs, each
    (..., out_h, out_w) float32, in lif_tpu's _fields order of
    operations (the kernel evaluates the same sequence)."""
    dev = pose_sc.device
    p = pose_sc.to(torch.float32)[..., :12, None, None]
    jx = _tdiv(torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5,
               out_w) - 0.5
    iy = _tdiv(torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5,
               out_h) - 0.5
    sx, sy = jx[None, :], iy[:, None]
    den = p[..., 6, :, :] * sx + p[..., 7, :, :] * sy + p[..., 8, :, :]
    qx = (p[..., 0, :, :] * sx + p[..., 1, :, :] * sy + p[..., 2, :, :]) / den
    qy = (p[..., 3, :, :] * sx + p[..., 4, :, :] * sy + p[..., 5, :, :]) / den
    ax = (qx + 0.5) * src_w - 0.5
    ay = (qy + 0.5) * src_h - 0.5
    dx = (p[..., 9, :, :] - p[..., 11, :, :] * qx) * src_w
    dy = (p[..., 10, :, :] - p[..., 11, :, :] * qy) * src_h
    return ax, dx, ay, dy, qx, qy


def _bil(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Bilinear read of img (..., H, W) at (px, py), with the tap origin
    clamped to [0, W-2] x [0, H-2] and the fractions to [0, 1]: the
    edge rule of lif_tpu's _bil, summed in its order."""
    h, w = img.shape[-2:]
    x0 = torch.clamp(torch.floor(px), 0, w - 2)
    y0 = torch.clamp(torch.floor(py), 0, h - 2)
    fx = torch.clamp(px - x0, 0.0, 1.0)
    fy = torch.clamp(py - y0, 0.0, 1.0)
    xi = x0.to(torch.int64)
    yi = y0.to(torch.int64)
    return (
        img[..., yi, xi] * (1 - fx) * (1 - fy)
        + img[..., yi, xi + 1] * fx * (1 - fy)
        + img[..., yi + 1, xi] * (1 - fx) * fy
        + img[..., yi + 1, xi + 1] * fx * fy
    )


def _secant(pd, d):
    """Bracket fraction of the first crossing: pd / (pd - d), clipped to
    [0, 1], with the denominator kept strictly negative."""
    return torch.clamp(pd / torch.clamp(pd - d, max=-1e-12), 0.0, 1.0)


def _rgbm_stack(rgb, mask):
    """(4, H, W) float32 channel planes [r, g, b, mask]."""
    return torch.cat(
        [rgb.to(torch.float32).permute(2, 0, 1),
         mask.to(torch.float32)[None]], dim=0,
    ).contiguous()


def march_target_plain(
    disp,
    invz_min: float,
    invz_max: float,
    pose_sc,
    plane_invz,
    out_w: int,
    out_h: int,
    refine: int = 0,
    rgbm=None,
):
    """The plain target-ray march of one pose: a Python loop over planes.

    Returns found (H, W) 0/1 and invz* (H, W), the secant-refined
    crossing (0 where none); with rgbm (4, Hs, Ws) also rgba* (H, W, 4),
    the bracket lerp of the [r, g, b, mask] samples at planes k*-1 and
    k* (k* == 0 snaps to t = 1). The CUDA kernel computes the same.

    Args:
      disp: (Hs, Ws) normalized inverse depth, GL-oriented.
      invz_min/invz_max: baseline-normalized inverse-depth range.
      pose_sc: (16,) target_pose_scalars pack.
      plane_invz: (K,) descending ladder (target_plane_grids row).
      refine: interior sub-plane evaluations inside the crossing bracket
        (positions are affine in invz, so sub-plane samples are exact).
    """
    dev = disp.device
    dd = disp.to(torch.float32)
    ps = torch.as_tensor(pose_sc, dtype=torch.float32, device=dev)
    ax, dxf, ay, dyf, _, _ = _fields(ps, out_w, out_h, dd.shape[1],
                                     dd.shape[0])
    vg = torch.as_tensor(plane_invz, dtype=torch.float32, device=dev)
    tk = plane_thresholds(vg, invz_min, invz_max)

    zeros = torch.zeros((out_h, out_w), dtype=torch.float32, device=dev)
    kstar = torch.full((out_h, out_w), -1, dtype=torch.int64, device=dev)
    pdiffc, diffc, pdiff = zeros, zeros, zeros
    for k, (v, tkk) in enumerate(zip(vg.tolist(), tk.tolist())):
        diff = _bil(dd, ax + v * dxf, ay + v * dyf) - tkk
        crossed = (kstar < 0) & (diff > 0.0)
        kstar = torch.where(crossed, k, kstar)
        pdiffc = torch.where(crossed, pdiff, pdiffc)
        diffc = torch.where(crossed, diff, diffc)
        pdiff = diff
    return _bracket(dd, (ax, dxf, ay, dyf), vg, tk, kstar, pdiffc, diffc,
                    refine, rgbm)


def _bracket(dd, fields, vg, tk, kstar, pdiffc, diffc, refine, rgbm):
    """The march's outputs from its first crossing kstar (-1: none) and
    the differences at planes kstar-1 and kstar: the secant (with the
    refine sub-sweep) and, with rgbm, the bracket colour lerp."""
    ax, dxf, ay, dyf = fields
    dev = dd.device
    zeros = torch.zeros_like(ax)
    t = torch.where(kstar == 0, 1.0, _secant(pdiffc, diffc))
    found = kstar >= 0
    km1 = torch.clamp(kstar - 1, min=0)
    kc = torch.clamp(kstar, min=0)
    v0, v1 = vg[km1], vg[kc]
    if refine > 0:
        # sub-bracket first-crossing search at exactly lerped invz; the
        # secant then runs in the 1/(refine+1) sub-bracket
        th0, th1 = tk[km1], tk[kc]
        step_s = 1.0 / (refine + 1)
        slo, pd2, d2 = zeros, pdiffc, diffc
        sfound = torch.zeros(ax.shape, dtype=torch.bool, device=dev)
        prev_g, prev_s = pdiffc, 0.0
        for j in range(1, refine + 1):
            s = j * step_s
            vs = v0 + s * (v1 - v0)
            g = _bil(dd, ax + vs * dxf, ay + vs * dyf) - (th0 + s * (th1 - th0))
            csub = ~sfound & (g > 0.0)
            slo = torch.where(csub, prev_s, slo)
            pd2 = torch.where(csub, prev_g, pd2)
            d2 = torch.where(csub, g, d2)
            sfound = sfound | csub
            prev_g, prev_s = g, s
        slo = torch.where(sfound, slo, prev_s)
        pd2 = torch.where(sfound, pd2, prev_g)
        t = slo + step_s * _secant(pd2, d2)
        t = torch.where(kstar == 0, 1.0, t)
    vstar = torch.where(found, v0 + t * (v1 - v0), 0.0)
    found = found.to(torch.float32)
    if rgbm is None:
        return found, vstar
    c0 = _bil(rgbm, ax + v0 * dxf, ay + v0 * dyf)
    c1 = _bil(rgbm, ax + v1 * dxf, ay + v1 * dyf)
    rgba = torch.where(kstar == 0, c1, c0 + t * (c1 - c0))
    return found, vstar, rgba.permute(1, 2, 0)


# ---------------------------------------------------------------------------
# The CUDA kernel's exact plane skip: its tables and its walk in plain torch
# ---------------------------------------------------------------------------

SKIP_SLACK = 2.0 ** -16  # a bound's slack, relative to its largest |tap|
SKIP_RUN = 24  # planes a warp skips at once (csrc/sweep_target.cu kRun)
SKIP_CELLS = (8, 32)  # the coarse tables' cells, in tap origins
SKIP_TILE = (8, 4)  # a warp's output pixels: columns x rows
WARP = 32


def _cell_max(b: torch.Tensor, c: int) -> torch.Tensor:
    """Maxima of b over c x c cells (the ragged edge padded with -inf)."""
    h, w = b.shape
    pad = torch.nn.functional.pad(b, (0, -w % c, 0, -h % c),
                                  value=-math.inf)
    return pad.reshape((h + c - 1) // c, c, (w + c - 1) // c, c).amax((1, 3))


def skip_tables(disp):
    """The target kernel's skip bounds, built once per launch in plain
    torch: (b0, b8, b32). b0 (Hs-1, Ws-1) bounds every bilinear read whose
    tap origin is (x, y) (_bil clamps origins into that range): a read is
    a convex combination of its four taps up to a few roundings, so it is
    at most their max plus max|tap|·2^-16 + 1e-30. b8 and b32 are maxima
    of b0 over 8x8 and 32x32 cells of origins. A NaN tap bounds its reads
    by +inf (they are never skipped)."""
    d = disp.to(torch.float32)
    taps = (d[:-1, :-1], d[:-1, 1:], d[1:, :-1], d[1:, 1:])
    hi = torch.maximum(torch.maximum(taps[0], taps[1]),
                       torch.maximum(taps[2], taps[3]))
    lo = torch.minimum(torch.minimum(taps[0], taps[1]),
                       torch.minimum(taps[2], taps[3]))
    b0 = hi + torch.maximum(hi.abs(), lo.abs()) * SKIP_SLACK + 1e-30
    b0 = torch.where(torch.isnan(b0), math.inf, b0).contiguous()
    b8 = _cell_max(b0, SKIP_CELLS[0])
    return b0, b8, _cell_max(b8, SKIP_CELLS[1] // SKIP_CELLS[0])


def _origin(p: torch.Tensor, n: int) -> torch.Tensor:
    """_bil's tap origin along an axis of n texels, as int64 (NaN -> 0,
    as the clamp of floor(NaN) gives on the card)."""
    o = torch.clamp(torch.floor(p), 0, n - 2)
    return torch.where(torch.isnan(o), 0.0, o).to(torch.int64)


def _box_bound(tables, box):
    """Per warp, the larger bound of the cells covering the origin box
    (x0, x1, y0, y1): 8x8 cells where at most 8 wide and 4 tall cover it
    (one a lane), else such 32x32 cells, else +inf; an empty box (no
    searching lane) gives -inf."""
    x0, x1, y0, y1 = box
    lanes = torch.arange(WARP, device=x0.device)
    out = torch.full(x0.shape, math.inf, device=x0.device)
    done = torch.zeros(x0.shape, dtype=torch.bool, device=x0.device)
    for table, c in zip(tables[1:], SKIP_CELLS):
        cx0, cy0, cx1, cy1 = x0 // c, y0 // c, x1 // c, y1 // c
        use = ~done & (cx1 - cx0 < 8) & (cy1 - cy0 < 4)
        cx = cx0[..., None] + lanes % 8
        cy = cy0[..., None] + lanes // 8
        cover = (cx <= cx1[..., None]) & (cy <= cy1[..., None])
        vals = table[cy.clamp(0, table.shape[0] - 1),
                     cx.clamp(0, table.shape[1] - 1)]
        vals = torch.where(cover, vals, -math.inf).amax(-1)
        out = torch.where(use, vals, out)
        done = done | use
    return torch.where(x1 < x0, -math.inf, out)


def march_target_skip_plain(disp, invz_min: float, invz_max: float, pose_sc,
                            plane_invz, out_w: int, out_h: int,
                            refine: int = 0, rgbm=None, run: int = SKIP_RUN,
                            stats: dict | None = None):
    """The CUDA kernel's walk for ONE pose, in plain torch: march_target_plain's
    outputs, bit for bit, reached through the kernel's exact skips.

    A warp (an 8 x 4 tile of output pixels) starts one plane before the
    first plane whose threshold any texel can reach (the ladder's padding)
    and walks the ladder in runs of `run` planes. A run's source positions
    lie, per lane, between those at the run's smallest and largest invz
    (positions are affine in invz and rounding is monotone); the box of
    their tap origins over the warp's searching lanes is looked up in the
    coarse tables (skip_tables), and where that bound is not above the
    run's lowest threshold no lane can cross in the run, which is skipped
    whole. Otherwise each searching lane tests each plane with one read of
    b0 at its tap origin and reads the four taps only where b0 exceeds the
    threshold (a candidate). A lane stops at its first crossing; where the
    plane before it was skipped, its difference is read afresh for the
    secant bracket.

    `stats`, if given, gathers counts of the walk: warp runs tested and
    skipped, the planes the warps walk (those where a lane has a
    candidate, and the kernel's candidate rounds: per walked run the most
    candidates of a lane), lane b0 tests, bilinear reads (bracket and
    refresh), bracket refreshes, crossings at the first plane after a
    skipped run, and the plain one-thread-per-pixel walk's lane and
    warp-max plane visits (the walk of the kernel's previous design, whose
    warps were rows of 32 pixels)."""
    dev = disp.device
    dd = disp.to(torch.float32)
    h_s, w_s = dd.shape
    ps = torch.as_tensor(pose_sc, dtype=torch.float32, device=dev)
    ax, dxf, ay, dyf, _, _ = _fields(ps, out_w, out_h, w_s, h_s)
    vg = torch.as_tensor(plane_invz, dtype=torch.float32, device=dev)
    tk = plane_thresholds(vg, invz_min, invz_max)
    n_k = vg.shape[0]
    tables = skip_tables(dd)
    # the padding skip (sweep_target.cu): start one plane before the first
    # plane whose threshold is not above max(disp) with its slack
    m = dd.max()
    bound = m + m.abs() * 1.52587890625e-05 + 1e-30
    reach = torch.nonzero(~(tk > bound))
    k_start = max(int(reach[0, 0]) - 1 if len(reach) else n_k - 1, 0)

    # lanes as (warp row, warp column, lane): the image padded to whole
    # SKIP_TILE tiles, a lane's pixel (lane % tx, lane // tx) in its tile
    tx, ty = SKIP_TILE
    n_h, n_w = -(-out_h // ty), -(-out_w // tx)

    def lanes(x, fill):
        x = torch.nn.functional.pad(
            x, (0, n_w * tx - out_w, 0, n_h * ty - out_h), value=fill)
        return x.reshape(n_h, ty, n_w, tx).transpose(1, 2).reshape(
            n_h, n_w, WARP)

    def cols(x):
        x = x.reshape(n_h, n_w, ty, tx).transpose(1, 2)
        return x.reshape(n_h * ty, n_w * tx)[:out_h, :out_w]

    sane = (torch.isfinite(ax) & torch.isfinite(dxf) & torch.isfinite(ay)
            & torch.isfinite(dyf))
    active = torch.ones((out_h, out_w), dtype=torch.bool, device=dev)
    kstar = torch.full((out_h, out_w), -1, dtype=torch.int64, device=dev)
    zeros = torch.zeros((out_h, out_w), dtype=torch.float32, device=dev)
    pd, pdc, dc = zeros, zeros, zeros
    pk = torch.full((out_h, out_w), -1, dtype=torch.int64, device=dev)
    vl, tl = vg.tolist(), tk.tolist()
    count = dict(runs=0, runs_skipped=0, warp_steps=0, warp_bil_steps=0,
                 warp_bil_rounds=0, lane_tests=0, bil_reads=0, refreshes=0,
                 after_skip=0)
    prev_skip = torch.zeros((n_h, n_w), dtype=torch.bool, device=dev)

    def diff_at(k):
        return _bil(dd, ax + vl[k] * dxf, ay + vl[k] * dyf) - tl[k]

    for k in range(k_start, n_k, run):
        ke = min(k + run, n_k) - 1
        live = lanes(active, False).any(-1)  # warps still searching
        if not bool(live.any()):
            break
        seg = [v for v in vl[k:ke + 1] if v == v]
        vlo, vhi = (min(seg), max(seg)) if seg else (math.inf, -math.inf)
        tmin = min((t for t in tl[k:ke + 1] if t == t), default=math.inf)
        ends = [(ax + vlo * dxf, ay + vlo * dyf),
                (ax + vhi * dxf, ay + vhi * dyf)]
        bad = ~sane
        for px, py in ends:
            bad = bad | torch.isnan(px) | torch.isnan(py)
        ox = [_origin(px, w_s) for px, _ in ends]
        oy = [_origin(py, h_s) for _, py in ends]
        box = (torch.where(bad, 0, torch.minimum(*ox)),
               torch.where(bad, w_s - 2, torch.maximum(*ox)),
               torch.where(bad, 0, torch.minimum(*oy)),
               torch.where(bad, h_s - 2, torch.maximum(*oy)))
        big = 1 << 40
        box = [lanes(torch.where(active, b, fill), fill).amin(-1) if lo
               else lanes(torch.where(active, b, fill), fill).amax(-1)
               for b, lo, fill in zip(box, (True, False, True, False),
                                      (big, -1, big, -1))]
        skip = live & ~(_box_bound(tables, box) > tmin)
        count["runs"] += int(live.sum())
        count["runs_skipped"] += int(skip.sum())
        walk = cols((live & ~skip)[..., None].expand(n_h, n_w, WARP))
        after_skip = cols(prev_skip[..., None].expand(n_h, n_w, WARP))
        prev_skip = skip
        candidates = torch.zeros((out_h, out_w), dtype=torch.int64,
                                 device=dev)
        for kk in range(k, ke + 1):
            lane = active & walk
            steps = lanes(lane, False).any(-1)
            if not bool(steps.any()):
                break
            count["warp_steps"] += int(steps.sum())
            count["lane_tests"] += int(lane.sum())
            px, py = ax + vl[kk] * dxf, ay + vl[kk] * dyf
            need = lane & (tables[0][_origin(py, h_s), _origin(px, w_s)]
                           > tl[kk])
            count["bil_reads"] += int(need.sum())
            count["warp_bil_steps"] += int(lanes(need, False).any(-1).sum())
            candidates = candidates + need
            d = _bil(dd, px, py) - tl[kk]
            crossed = need & (d > 0.0)
            if bool(crossed.any()):
                fresh = crossed & (pk != kk - 1)
                count["refreshes"] += int(fresh.sum())
                count["bil_reads"] += int(fresh.sum())
                if kk == k:
                    count["after_skip"] += int((crossed & after_skip).sum())
                prev = diff_at(kk - 1) if kk > 0 else zeros
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
        rows = torch.nn.functional.pad(visits, (0, -out_w % WARP))
        count["old_warp_visits"] = int(
            rows.reshape(out_h, -1, WARP).amax(-1).sum()) * WARP
        count["k_start"] = k_start
        for key, val in count.items():
            stats[key] = stats.get(key, 0) + val
    return _bracket(dd, (ax, dxf, ay, dyf), vg, tk, kstar, pdc, dc, refine,
                    rgbm)


def _solved_uv(pose_b, vstar, izmin, izmax, out_w, out_h, src_w, src_h):
    """Normalized source coordinates (u1, v1) of the solved positions,
    with invz* clipped to the range."""
    ax, dxf, ay, dyf, _, _ = _fields(pose_b, out_w, out_h, src_w, src_h)
    v = torch.clamp(vstar, float(izmax), float(izmin))
    return (_tdiv(ax + v * dxf + 0.5, src_w),
            _tdiv(ay + v * dyf + 0.5, src_h))


def _finish(found, vstar, rgba, u1, v1, background, feathering, mask_mode,
            to_srgb, raw):
    hit, alpha = _composite.edge_alpha(
        found, u1, v1, feathering, rgba[..., 3], mask_mode
    )
    if raw:
        return rgba, alpha, hit, torch.where(found > 0.0, vstar, 0.0)
    return _composite.finish_over_background(
        rgba[..., :3] * alpha[..., None], alpha, background, to_srgb
    )


def finalize_target(
    pose_sc, found, vstar, rgba, background, izmin, izmax,
    out_w, out_h, src_w, src_h, feathering, mask_mode, to_srgb, raw,
):
    """Shared epilogue: visibility taper at the solved position, mask
    gating, background blend, gamma (reference: rayCastMonoLDI.glsl taper
    + main). pose_sc (..., 16) with found/vstar (..., H, W) and rgba
    (..., H, W, 4); a leading pose axis batches."""
    pose_sc = torch.as_tensor(pose_sc, dtype=torch.float32,
                              device=found.device)
    u1, v1 = _solved_uv(pose_sc, vstar, np.float32(izmin),
                        np.float32(izmax), out_w, out_h, src_w, src_h)
    return _finish(found, vstar, rgba, u1, v1, background, feathering,
                   mask_mode, to_srgb, raw)


def render_target_plain(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    pose_sc,  # (16,) target_pose_scalars
    plane_invz,  # (K,) descending
    background,
    num_planes: int,
    out_w: int,
    out_h: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    raw: bool = False,
    depth_only: bool = False,
    refine: int = 0,
):
    """The plain twin of one pose (lif_tpu's render_target_xla).

    depth_only=True returns (found (H, W), invz* (H, W)) with no color
    pass and no finalize, the fetch path's input. Otherwise the bracket
    color lerp runs and the result is finalized: (H, W, 4), or with
    raw=True the (rgba*, alpha, hit, invz*) tuple."""
    if len(plane_invz) != num_planes:
        raise ValueError(f"{len(plane_invz)} planes, expected {num_planes}")
    if depth_only:
        return march_target_plain(disp, invz_min, invz_max, pose_sc,
                                  plane_invz, out_w, out_h, refine=refine)
    found, vstar, rgba = march_target_plain(
        disp, invz_min, invz_max, pose_sc, plane_invz, out_w, out_h,
        refine=refine, rgbm=_rgbm_stack(rgb, mask),
    )
    h, w = disp.shape
    return finalize_target(
        pose_sc, found, vstar, rgba, background, invz_min, invz_max,
        out_w, out_h, w, h, feathering, mask_mode, to_srgb, raw,
    )


# ---------------------------------------------------------------------------
# Device dispatch
# ---------------------------------------------------------------------------


def _march_batch(disp, invz_min, invz_max, pose_b, plane_invz,
                 plan: TargetPlan, num_planes: int, refine: int, rgbm=None,
                 skip_tables=None):
    """The pose-batched march, on the device of `disp`: a CUDA tensor
    launches the kernel (one launch for the batch; `skip_tables` its flat
    skip tables, cached with the textures), a CPU tensor takes the plain twin
    pose by pose. Returns found and invz* (B, H, W) and, with rgbm, rgba*
    (B, H, W, 4)."""
    h, w = disp.shape
    if (plan.src_w, plan.src_h) != (w, h):
        raise ValueError(f"plan {plan} does not match a {w}x{h} source")
    plane = torch.as_tensor(plane_invz, dtype=torch.float32,
                            device=disp.device)
    pose = torch.as_tensor(pose_b, dtype=torch.float32, device=disp.device)
    if tuple(plane.shape) != (pose.shape[0], num_planes):
        raise ValueError(
            f"plane ladders {tuple(plane.shape)} do not match "
            f"{pose.shape[0]} poses x {num_planes} planes"
        )
    if disp.device.type == "cuda":
        from .cuda.sweep_target import march_target_cuda

        with profiling.span("lif.kernel.target"):
            return march_target_cuda(disp, invz_min, invz_max, pose, plane,
                                     plan, refine=refine, rgbm=rgbm,
                                     tables=skip_tables)
    if disp.device.type != "cpu":
        raise NotImplementedError(
            f"the target march runs on CUDA or CPU tensors, not "
            f"{disp.device.type}"
        )
    outs = [
        march_target_plain(disp, invz_min, invz_max, ps, pv, plan.out_w,
                           plan.out_h, refine=refine, rgbm=rgbm)
        for ps, pv in zip(pose, plane)
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def render_target_batch(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    pose_b,  # (B, 16) target_pose_scalars rows
    plane_invz,  # (B, K) descending per-pose ladders
    background,
    plan: TargetPlan,
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 0,
    raw: bool = False,
    skip_tables=None,
):
    """Full-color target-ray march of a pose batch (the in-kernel bracket
    color lerp), dispatched on the device of the textures (on CUDA with
    skip_tables, the kernel's flat skip tables). Returns (B, out_h,
    out_w, 4), or the raw tuple with a leading pose axis. lif_tpu's
    window tables (xlo, ylo) are TPU DMA origins and have no counterpart
    here."""
    found, vstar, rgba = _march_batch(
        disp, invz_min, invz_max, pose_b, plane_invz, plan, num_planes,
        refine, rgbm=_rgbm_stack(rgb, mask), skip_tables=skip_tables,
    )
    h, w = disp.shape
    return finalize_target(
        pose_b, found, vstar, rgba, background, invz_min, invz_max,
        plan.out_w, plan.out_h, w, h, feathering, mask_mode, to_srgb, raw,
    )


def render_target_fetch_batch(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    pose_b,  # (B, 16)
    plane_invz,  # (B, K)
    background,
    plan: TargetPlan,
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    raw: bool = False,
    refine: int = 0,
    skip_tables=None,
):
    """PRODUCTION target tier: depth-only target-ray march + ONE packed
    bilinear color fetch (10-bit color, 1-bit mask) at the solved
    position, then the epilogue. The bracket color lerp is only
    approximate off the snap grid; fetching at the solved position is
    exact (lif_tpu measured +7..13 dB from it). skip_tables: the kernel's
    flat skip tables, cached with the textures (CUDA only). Returns
    (B, out_h, out_w, 4), or raw (rgba, alpha, hit, invz) tuples."""
    h, w = disp.shape
    izmin, izmax = np.float32(invz_min), np.float32(invz_max)
    found, vstar = _march_batch(disp, izmin, izmax, pose_b, plane_invz,
                                plan, num_planes, refine,
                                skip_tables=skip_tables)
    with profiling.span("lif.epilogue.target"):
        pose = torch.as_tensor(pose_b, dtype=torch.float32,
                               device=disp.device)
        u1, v1 = _solved_uv(pose, vstar, izmin, izmax, plan.out_w,
                            plan.out_h, w, h)
        with profiling.span("lif.fetch"):
            rgba = bilinear_sample_packed(pack_rgbm(rgb, mask), u1, v1, w, h)
        return _finish(found, vstar, rgba, u1, v1, background, feathering,
                       mask_mode, to_srgb, raw)
