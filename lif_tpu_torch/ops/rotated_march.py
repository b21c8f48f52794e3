"""Two-phase march for ROTATED (and zoomed) novel views.

The counterpart of lif_tpu.ops.rotated_march, the fallback of the target
tier: rotated pose batches outside the yaw family (yaw + pitch together,
roll) and skewed frustums. A rotation about the camera center never
changes which surface a ray hits, only the image-plane parameterization
(reference: src/shaders/rayCastMonoLDI.glsl:219-297). So:

  Phase A: solve the surface inverse depth with the SCALED first-crossing
    march (ops.sweep_scaled, depth only; on CUDA the kernel
    csrc/sweep_scaled.cu) in an intermediate frame with the target's
    position but the projector's orientation and focal, where every
    plane's warp is separable-affine. Its extent (wi, hi) covers the
    target frustum's corner rays plus a guard.

  Phase B (plain torch, as lif_tpu's is plain XLA): per target pixel, map
    its ray into the intermediate image (a pure rotation homography),
    read the 2x2 corner invz of the intermediate lattice, BRACKET the
    crossing with the corner min/max, run the reference march recurrence
    over that bracket against the original source disparity
    (_bracket_march), then fetch the color at the exact projective source
    coordinate of the solved invz (one packed bilinear fetch).

With no parallax (|c1| ~ 0: pure rotation or zoom) phase A is skipped:
the decoded source disparity is the intermediate depth map.

Host planning (intermediate_extent, plan_rotated) is float64 numpy copied
from lif_tpu, so routing cannot drift.
"""

from __future__ import annotations

import numpy as np
import torch

from . import composite as _composite
from ..core.transforms import inv3, mat_from_focal, mat_from_skew, mm, shader_rotation
from .sampling import bilinear_sample_packed, pack_rgbm, read_disp
from .sweep_scaled import (
    ScaledPlan,
    parallax_step_grids_batch,
    render_scaled_batch,
    scaled_plan,
)
from .sweep_target import _tdiv

__all__ = [
    "intermediate_extent",
    "plan_rotated",
    "render_rotated_march_batch",
]

_F32 = np.float32


def intermediate_extent(rot_list, f1, f2, out_w, out_h, guard_px=16.0,
                        bucket=64, sk1=(0.0, 0.0), sk2=(0.0, 0.0)):
    """Host math (lif_tpu's): intermediate image extents covering every
    target corner ray across the pose batch, at the SOURCE focal f1.

    For each rotation R the target corner rays d2 = (±out_w/(2 f2) +
    sk2.x, ±out_h/(2 f2) + sk2.y, 1) land in the aligned frame at R^T d2;
    their image coordinates at focal f1 bound the extent, plus the
    intermediate frustum's own sk1 shift. Returns (wi, hi), wi bucketed
    to 128 and hi to `bucket`."""
    half_w = out_w / (2.0 * float(f2))
    half_h = out_h / (2.0 * float(f2))
    corners = np.array(
        [[sx * half_w + sk2[0], sy * half_h + sk2[1], 1.0]
         for sx in (-1, 1) for sy in (-1, 1)]
    )
    max_x = max_y = 0.0
    for rot in rot_list:
        r = np.asarray(rot, np.float64)
        d = corners @ r  # rows: R^T @ corner
        z = np.maximum(d[:, 2], 1e-6)
        max_x = max(max_x, float(np.max(np.abs(d[:, 0] / z))))
        max_y = max(max_y, float(np.max(np.abs(d[:, 1] / z))))
    wi = 2.0 * (max_x + abs(sk1[0])) * float(f1) + 2.0 * guard_px
    hi = 2.0 * (max_y + abs(sk1[1])) * float(f1) + 2.0 * guard_px
    wi = max(128, -int(-wi // 128) * 128)
    hi = max(bucket, -int(-hi // bucket) * bucket)
    return wi, hi


def plan_rotated(
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
    step_px: float = 1.0,
    guard_px: float = 16.0,
    wi_cap_factor: float = 4.0,
    num_planes: int | None = None,
    sk1=(0.0, 0.0),
    sk2=(0.0, 0.0),
):
    """Host-side setup (lif_tpu's): intermediate extent, aligned-frame
    poses, the scaled plan and per-pose plane grids. Raises ValueError
    when the pose family exceeds lif_tpu's budgets (the renderer then
    routes the batch to the sweep).

    Frustum skew: the intermediate frame keeps the SOURCE skew sk1, so
    phase A stays a pure translation; its effect C = F1 S(sk1) (-c) folds
    into the position, c' = c - sk1 * c_z. Phase B puts S(sk1)/S(sk2) in
    their reference slots (rayCastMonoLDI.glsl:316-332).

    Returns (plan, wi, hi, c1_aligned (B, 3) f64, grids (B, K) f32, K,
    skip_phase_a)."""
    wi, hi = intermediate_extent(
        rot_list, f1, f2, out_w, out_h, guard_px=guard_px, sk1=sk1, sk2=sk2,
    )
    if wi > wi_cap_factor * max(out_w, src_w) or hi > wi_cap_factor * max(
        out_h, src_h
    ):
        raise ValueError(
            f"rotation too large: intermediate extent {wi}x{hi}"
        )
    flip = np.array([1.0, 1.0, -1.0])
    aligned = np.stack(
        [
            flip * (np.asarray(r, np.float64).T
                    @ (flip * np.asarray(c, np.float64)))
            for r, c in zip(rot_list, c1_list)
        ]
    )
    # source-skew fold for the skewed aligned frame (see docstring)
    aligned[:, 0] -= sk1[0] * aligned[:, 2]
    aligned[:, 1] -= sk1[1] * aligned[:, 2]
    skip_phase_a = bool(np.abs(aligned).max() * izmin * f1 < 0.25)
    if skip_phase_a:
        # no parallax: the source itself is the intermediate depth map
        return None, src_w, src_h, aligned, None, 0, True
    plan = scaled_plan(
        src_w, src_h, wi, hi, f1, 1.0,
        float(np.abs(aligned[:, 0]).max()), float(np.abs(aligned[:, 1]).max()),
        float(min(aligned[:, 2].min(), 0.0)),
        float(max(aligned[:, 2].max(), 0.0)), izmin, izmax,
    )
    grids, k = parallax_step_grids_batch(
        f1, aligned, 1.0, wi, hi, izmin, izmax, step_px=step_px,
        num_planes=num_planes,
    )
    return plan, wi, hi, aligned, grids, k, False


def _proj_apply(p, sx, sy):
    """Homography p (B, 3, 3) applied to (sx, sy): (x, y, den), each
    (B, H, W)."""
    def el(r, c):
        return p[:, r, c, None, None]

    den = el(2, 0) * sx + el(2, 1) * sy + el(2, 2)
    return (
        (el(0, 0) * sx + el(0, 1) * sy + el(0, 2)) / den,
        (el(1, 0) * sx + el(1, 1) * sy + el(1, 2)) / den,
        den,
    )


def _corner_quad(izmaps, u, v):
    """The 2x2 intermediate-lattice corner invz around (u, v) in [0, 1]
    of each pose's (Hi, Wi) map, stacked [t(y,x), t(y,x+1), t(y+1,x),
    t(y+1,x+1)] on the last axis: four direct gathers with lif_tpu's
    clip rules (the corner index clamped into the map, its +1 neighbour
    clamped to the map's last row/column, as the edge-replicated 2x2
    patch table of lif_tpu reads)."""
    b_n, h_i, w_i = izmaps.shape
    x0 = torch.floor(u * w_i - 0.5).to(torch.int64).clamp(0, w_i - 1)
    y0 = torch.floor(v * h_i - 0.5).to(torch.int64).clamp(0, h_i - 1)
    x1 = (x0 + 1).clamp(max=w_i - 1)
    y1 = (y0 + 1).clamp(max=h_i - 1)
    flat = izmaps.reshape(b_n, h_i * w_i)
    pose = torch.arange(b_n, device=izmaps.device)[:, None, None]
    return torch.stack(
        [flat[pose, y * w_i + x] for y, x in ((y0, x0), (y0, x1), (y1, x0),
                                              (y1, x1))],
        dim=-1,
    )


def _bracket_march(disp, qx, qy, den, c_vec, quad, izmin, izmax, res_w,
                   res_h, num_steps: int):
    """Per-target-ray first-crossing march over a LATTICE-SEEDED bracket
    (lif_tpu's _bracket_march): the corner depths `quad` (0 = that lattice
    ray found no surface) bracket each ray's crossing, and the reference
    march recurrence (rayCastMonoLDI.glsl:253-274: fixed steps, step back
    and halve on crossing) runs over that bracket against the original
    source disparity, along the exact per-ray source path
    s1(v) = q + v * (c - c_z * q). A fixed num_steps loop of elementwise
    ops. Returns (invz*, invz2)."""
    valid = quad > 0.0
    nvalid = valid.sum(dim=-1)
    v_front = torch.where(valid, quad, -1e9).amax(dim=-1)
    v_back = torch.where(valid, quad, 1e9).amin(dim=-1)
    spread = torch.where(nvalid > 0, v_front - v_back, 0.0)
    margin = float(_F32(0.02) * (izmin - izmax)) + 0.25 * spread
    v_start = torch.clamp(v_front + margin, max=float(izmin))
    v_end = torch.clamp(v_back - margin, min=float(izmax))
    v_end = torch.where(nvalid < 4, float(izmax), v_end)
    # all-miss: degenerate bracket at the far plane (reference miss
    # semantics: sample at izmax, validity decides alpha)
    v_start = torch.where(nvalid == 0, float(izmax), v_start)
    v_end = torch.where(nvalid == 0, float(izmax), v_end)

    cx, cy, cz = (c_vec[:, i, None, None] for i in range(3))
    dsx = cx - cz * qx
    dsy = cy - cz * qy
    dinvz = _tdiv(v_start - v_end, num_steps)
    invz = v_start + dinvz  # step back once before the loop, like the
    # reference (:251): the first iteration lands exactly on v_start
    for _ in range(num_steps):
        invz = invz - dinvz
        disp_v = read_disp(disp, qx + invz * dsx + 0.5, qy + invz * dsy + 0.5,
                           float(izmin), float(izmax), res_w, res_h)
        invz2 = invz * den / (1.0 - cz * invz)
        below = (disp_v > invz) & (invz2 > 0.0)
        invz = torch.where(below, invz + dinvz, invz)
        dinvz = torch.where(below, dinvz * 0.5, dinvz)
    return invz, invz * den / (1.0 - cz * invz)


def _pose_maps(f1, f2, w, h, out_w, out_h, wi, hi, rot_b, c1_b, sk1, sk2):
    """Per-pose float32 matrices on the host CPU (lif_tpu's pose_maps):
    p_ts (target -> source), p_ti (target -> intermediate) (B, 3, 3) and
    c_vec = FSKR1 @ (-c1) (B, 3)."""
    f1, f2 = _F32(f1), _F32(f2)
    skr1 = shader_rotation(np.asarray(rot_b, np.float32))
    if tuple(sk1) != (0.0, 0.0):
        skr1 = mm(mat_from_skew(sk1[0], sk1[1]), skr1)
    fskr1 = mm(mat_from_focal(f1 / _F32(w), f1 / _F32(h)), skr1)
    fskr2 = mat_from_focal(f2 / _F32(out_w), f2 / _F32(out_h))
    if tuple(sk2) != (0.0, 0.0):
        fskr2 = mm(fskr2, mat_from_skew(sk2[0], sk2[1]))
    inv2 = inv3(fskr2)
    p_ts = mm(fskr1, inv2)
    c1 = torch.as_tensor(np.asarray(c1_b, np.float32))
    c_vec = torch.matmul(fskr1, (-c1)[..., None])[..., 0]
    p_ti = mm(mm(mat_from_focal(f1 / _F32(wi), f1 / _F32(hi)), skr1), inv2)
    return p_ts, p_ti, c_vec


def render_rotated_march_batch(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    f1,
    c1_b,  # (B, 3) target-frame projector positions (shader convention)
    rot_b,  # (B, 3, 3) camera-local projector rotations
    c1_aligned_b,  # (B, 3) aligned-frame positions (plan_rotated)
    f2,
    plane_grids,  # (B, K) aligned-frame ladders
    background,
    plan: ScaledPlan,
    num_planes: int,
    out_w: int,
    out_h: int,
    wi: int,
    hi: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 1,
    raw: bool = False,
    skip_phase_a: bool = False,
    bracket_steps: int = 10,
    sk1=(0.0, 0.0),
    sk2=(0.0, 0.0),
):
    """Two-phase rotated/zoom render of a pose batch on the device of the
    textures. Returns (B, out_h, out_w, 4) with premultiplied rgb over
    `background` (raw=True: the (rgba, alpha, hit, invz) tuple).

    skip_phase_a: the |c1| ~ 0 case — the decoded source disparity IS the
    intermediate depth map (wi/hi must then equal the source dims and
    plane_grids is unused)."""
    h, w = disp.shape
    dev = disp.device
    izmin, izmax = _F32(invz_min), _F32(invz_max)
    b_n = len(c1_b)

    # ---- Phase A ----
    if skip_phase_a:
        if (wi, hi) != (w, h):
            raise ValueError(f"skip_phase_a needs wi x hi = {w}x{h}")
        dec = disp.to(torch.float32) * float(izmin - izmax) + float(izmax)
        izmap = dec[None].expand(b_n, hi, wi)
    else:
        found, izs = render_scaled_batch(
            rgb, disp, mask, izmin, izmax, c1_aligned_b, f1, 1.0,
            plane_grids, None, plan, num_planes, refine=refine,
            depth_only=True,
        )
        izmap = torch.where(found > 0.5, izs, 0.0)

    # ---- Phase B ----
    p_ts, p_ti, c_vec = (
        t.to(dev) for t in _pose_maps(f1, f2, w, h, out_w, out_h, wi, hi,
                                      rot_b, c1_b, sk1, sk2)
    )
    jx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    iy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    s2x = (_tdiv(jx + 0.5, out_w) - 0.5).expand(out_h, out_w)
    s2y = (_tdiv(iy + 0.5, out_h) - 0.5).expand(out_h, out_w)
    six, siy, _ = _proj_apply(p_ti, s2x, s2y)
    qx, qy, den = _proj_apply(p_ts, s2x, s2y)

    quad = _corner_quad(izmap, six + 0.5, siy + 0.5)
    covered = (torch.abs(six) < 0.5) & (torch.abs(siy) < 0.5)
    invz_hat, invz2 = _bracket_march(disp.to(torch.float32), qx, qy, den,
                                     c_vec, quad, izmin, izmax, w, h,
                                     bracket_steps)
    found_hat = ((quad > 0.0).any(dim=-1)) & (invz2 > 0.0)

    cx, cy, cz = (c_vec[:, i, None, None] for i in range(3))
    u1 = cx * invz_hat + (1.0 - cz * invz_hat) * qx + 0.5
    v1 = cy * invz_hat + (1.0 - cz * invz_hat) * qy + 0.5
    sampled = bilinear_sample_packed(pack_rgbm(rgb, mask), u1, v1, w, h)
    hit, alpha = _composite.edge_alpha(
        (found_hat & covered).to(torch.float32), u1, v1, feathering,
        sampled[..., 3], mask_mode,
    )
    if raw:
        return sampled, alpha, hit, torch.where(found_hat, invz_hat, 0.0)
    return _composite.finish_over_background(
        sampled[..., :3] * alpha[..., None], alpha, background, to_srgb
    )
