"""Gather-free plane sweep for aligned views, and the two-phase rotated sweep.

The counterpart of lif_tpu.ops.sweep_fast: the fast renderer's 'sweep'
tier, which takes the poses and layers no march tier covers. In a
SOURCE-ALIGNED frame (the camera shares the projector's orientation;
position and focal may differ) every inverse-depth plane's warp is a
uniform scale + shift of the image, s1 = C.xy*invZ + (1 - C.z*invZ)*s2. A
uniform resample is a banded linear operator per axis, so each plane's
warp is two dense (n_out x n_in) bilinear matrices applied as batched
matrix products; occupancy and compositing are elementwise passes,
streamed over chunks of planes. A rotation about the camera centre is a
homography of the image plane, applied once at the end (render_rotated).

Precision, as lif_tpu computes it:
  * colour (rgb + mask): the row product bf16 x bf16 -> bf16, the column
    product bf16 inputs with float32 accumulation (the bf16 operands are
    upcast first, which is exact, and multiplied in float32);
  * disparity: both products in full float32. Their result feeds the
    occupancy sigmoid at a sharpness of about 400, where coarser mantissas
    visibly quantize the surface, so no TF32 may reach them: the products
    run under torch's default float32 matmul precision ('highest', TF32
    off), which nothing in this package changes.

The plane tables come from the renderer (models/renderer.py:
_sweep_plane_table, the 'hybrid' quantile placement); every function here
is plain torch on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.transforms import inv3, mat_from_focal, mm, shader_rotation
from . import composite as _composite
from .composite import smoothstep
from .rotated_march import _proj_apply
from .sampling import bilinear_sample, bilinear_sample_packed, pack_rgbm

__all__ = ["render_rotated", "render_sweep_aligned", "solve_depth_aligned"]

_F32 = np.float32


def _f32(x, device) -> torch.Tensor:
    """A float32 tensor on `device` (host numbers and arrays round to
    float32 as jnp.asarray(x, float32) does)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _axis_visibility(scale, shift_px, n_out: int, n_in: int, feathering):
    """Separable per-axis visibility: the inside-the-source indicator times
    the feathering taper at each output position's source uv. (K, n_out)."""
    j = torch.arange(n_out, dtype=torch.float32, device=scale.device)
    g = (scale[:, None] * (j[None, :] - (n_out - 1) / 2.0)
         + (n_in - 1) / 2.0 + shift_px[:, None])
    u = (g + 0.5) / n_in  # source uv in [0, 1]
    inside = ((u - 0.5).abs() < 0.5).to(torch.float32)
    f = max(float(feathering), 1e-6)
    return inside * smoothstep(0.0, f, u) * (1.0 - smoothstep(1.0 - f, 1.0, u))


def _resample_matrices(scale, shift_px, n_out: int, n_in: int,
                       dtype=torch.bfloat16, clamp_lo: float = 0.0,
                       clamp_hi: float | None = None) -> torch.Tensor:
    """Banded bilinear resample matrices for a batch of uniform maps.

    Row j of M holds the bilinear weights of output position
    g(j) = scale * (j - c_out) + c_in + shift_px (centres aligned), so
    out = M @ src. scale/shift_px: (K,). Returns (K, n_out, n_in).

    clamp_lo/clamp_hi: the sample-position clamp. The default is
    clamp-to-edge (GL); the disparity texture takes the march's 2-texel
    interior clamp [1.5, n - 2.5] (readDisp, rayCastMonoLDI.glsl:59-61)."""
    j = torch.arange(n_out, dtype=torch.float32, device=scale.device)
    g = (scale[:, None] * (j[None, :] - (n_out - 1) / 2.0)
         + (n_in - 1) / 2.0 + shift_px[:, None])
    g = g.clamp(clamp_lo, (n_in - 1.0) if clamp_hi is None else clamp_hi)
    src = torch.arange(n_in, dtype=torch.float32, device=scale.device)
    m = torch.clamp(1.0 - (g[:, :, None] - src).abs(), min=0.0)
    return m.to(dtype)


def _plane_setup(disp, invz_min, invz_max, c1, f2, focal1, num_planes,
                 plane_invz):
    """The sweep's per-plane constants on disp's device, float32: the
    planes invz (K,) near -> far (uniform over the range when plane_invz
    is None), each plane's uniform warp (scale, shift_x, shift_y) and the
    range ends izmin, izmax."""
    dev = disp.device
    izmin, izmax = _f32(invz_min, dev), _f32(invz_max, dev)
    c1 = _f32(c1, dev)
    f2 = _f32(f2, dev)
    f1 = f2 if focal1 is None else _f32(focal1, dev)
    if plane_invz is None:
        ks = (torch.arange(num_planes, dtype=torch.float32, device=dev)
              + 0.5) / num_planes
        invz = izmin + (izmax - izmin) * ks  # near -> far
    else:
        invz = _f32(plane_invz, dev)
    scale = (1.0 + c1[2] * invz) * (f1 / f2)  # C.z = -c1.z
    shift_x = -f1 * c1[0] * invz
    shift_y = -f1 * c1[1] * invz
    return invz, scale, shift_x, shift_y, izmin, izmax, c1, f1, f2


def _disp_planes(disp_wh, scale, shift_x, shift_y, izmin, izmax, lo: int,
                 hi: int, out_w: int, out_h: int) -> torch.Tensor:
    """The warped, decoded disparity of planes lo:hi, (kb, out_h, out_w):
    the row and column products in full float32 with the 2-texel interior
    clamp, then decoded to inverse depth."""
    w, h = disp_wh.shape
    mx = _resample_matrices(scale[lo:hi], shift_x[lo:hi], out_w, w,
                            dtype=torch.float32, clamp_lo=1.5,
                            clamp_hi=w - 2.5)
    my = _resample_matrices(scale[lo:hi], shift_y[lo:hi], out_h, h,
                            dtype=torch.float32, clamp_lo=1.5,
                            clamp_hi=h - 2.5)
    drow = torch.matmul(mx, disp_wh)  # (kb, W', H)
    dcol = torch.matmul(my, drow.transpose(1, 2))  # (kb, H', W')
    return izmax + (izmin - izmax) * dcol


def _color_planes(tex_whc, scale, shift_x, shift_y, lo: int, hi: int,
                  out_w: int, out_h: int, h: int) -> torch.Tensor:
    """The warped colour + mask of planes lo:hi, (kb, out_h, out_w, 4): the
    row product bf16 x bf16 -> bf16 on the (W, H*4) texture layout, then
    the column product of the bf16 operands upcast to float32 (exact) with
    float32 accumulation."""
    w = tex_whc.shape[0]
    kb = hi - lo
    mx = _resample_matrices(scale[lo:hi], shift_x[lo:hi], out_w, w)
    my = _resample_matrices(scale[lo:hi], shift_y[lo:hi], out_h, h)
    row = torch.matmul(mx, tex_whc)  # (kb, W', H*4), bf16
    row = row.reshape(kb, out_w, h, 4).permute(0, 2, 1, 3).reshape(
        kb, h, out_w * 4)
    return torch.matmul(my.float(), row.float()).reshape(kb, out_h, out_w, 4)


class _SoftComposite:
    """The sweep's streamed front-to-back composite: per plane, a sigmoid
    occupancy of the warped disparity against the plane, weighted by the
    transmittance so far and by the visibility (inside x taper x mask) of
    the warped colour."""

    def __init__(self, out_h: int, out_w: int, device):
        self.transmittance = torch.ones((out_h, out_w), device=device)
        self.rgb = torch.zeros((out_h, out_w, 3), device=device)
        self.alpha = torch.zeros((out_h, out_w), device=device)

    def chunk(self, d_k, invz, sharp, warped, vis_x, vis_y):
        """Composite a chunk of planes: d_k (kb, H', W') warped inverse
        depth, invz/sharp (kb,) the planes and their sigmoid sharpness,
        warped (kb, H', W', 4) colour + mask, vis_x (kb, W') / vis_y
        (kb, H') the separable visibility."""
        occ = torch.sigmoid((d_k - invz[:, None, None]) * sharp[:, None, None])
        vis = (vis_y[:, :, None] * vis_x[:, None, :]
               * warped[..., 3].clamp(0.0, 1.0))
        for k in range(d_k.shape[0]):
            w_k = self.transmittance * occ[k]
            self.rgb = (self.rgb
                        + (w_k * vis[k])[..., None] * warped[k, ..., :3])
            self.alpha = self.alpha + w_k * vis[k]
            self.transmittance = self.transmittance * (1.0 - occ[k])


class _FirstCrossing:
    """The march's first-crossing solve over a sweep of planes: the surface
    is where diff = d(invZ) - invZ turns positive marching near -> far,
    interpolated between the bracketing planes (the march's step halving
    converges to the same root)."""

    def __init__(self, out_h: int, out_w: int, device):
        self.found = torch.zeros((out_h, out_w), dtype=torch.bool,
                                 device=device)
        self.invz_star = torch.zeros((out_h, out_w), device=device)
        self.prev_diff = torch.zeros((out_h, out_w), device=device)
        self.prev_invz = torch.zeros((), device=device)
        self.first = True

    def step(self, d_k: torch.Tensor, invz_k: torch.Tensor):
        diff = d_k - invz_k
        crossed = ~self.found & (diff > 0.0)
        if self.first:
            # no bracket yet (prev_invz is a zero placeholder): snap the
            # crossing to the plane itself (t = 1), not to invz = 0
            t = torch.ones_like(diff)
            self.first = False
        else:
            t = self.prev_diff / torch.clamp(self.prev_diff - diff,
                                             max=-1e-12)
            t = t.clamp(0.0, 1.0)
        cand = self.prev_invz + t * (invz_k - self.prev_invz)
        self.invz_star = torch.where(crossed, cand, self.invz_star)
        self.found = self.found | crossed
        self.prev_diff = diff
        self.prev_invz = invz_k


def _edge_tap(u1, v1, feathering):
    """Inside-the-source indicator times the feathering taper at (u1, v1)."""
    inside = ((u1 > 0.0) & (u1 < 1.0) & (v1 > 0.0) & (v1 < 1.0)).to(
        torch.float32)
    f = max(float(feathering), 1e-6)
    return inside * (
        smoothstep(0.0, f, u1) * (1.0 - smoothstep(1.0 - f, 1.0, u1))
        * smoothstep(0.0, f, v1) * (1.0 - smoothstep(1.0 - f, 1.0, v1))
    )


def render_sweep_aligned(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    c1,
    f2,
    background,
    out_w: int,
    out_h: int,
    focal1=None,
    num_planes: int = 40,
    softness: float = 0.5,
    chunk: int = 8,
    feathering: float = 0.1,
    to_srgb: bool = True,
    plane_invz=None,
    exact_color: bool = False,
):
    """Render a translated (rotation-free) novel view without gathers.

    With no relative rotation or skew, the plane-k warp is a uniform map in
    pixel space (any focal/resolution combination):

        scale_k = (1 + c1.z * invZ_k) * f1 / f2
        shift_k = -f1 * c1.xy * invZ_k       (pixels, both axes)

    Args:
      rgb: (H, W, 3) linear source colours, GL-oriented, on the render
        device. disp: (H, W) normalized inverse depth. mask: (H, W) alpha
        mask (ones when absent).
      invz_min/invz_max: baseline-normalized inverse-depth range.
      c1: (3,) projector position in the camera frame, shader convention
        (Z negated); the camera shares the projector's ORIENTATION.
      f2: render focal in output pixels. focal1: source focal in source
        pixels (defaults to f2). background: (4,) linear RGBA.
      num_planes: planes swept near -> far. softness: the occupancy
        sigmoid's width as a fraction of the LOCAL plane spacing. chunk:
        planes per batched product. plane_invz: optional (K,) plane
        positions, near -> far (descending); default linear over the range.
      exact_color: instead of the soft composite, solve the first crossing
        (the march's semantics) and fetch the colour once, bilinearly, at
        the solved parallax position.

    Returns (out_h, out_w, 4), GL-oriented, on disp's device.
    """
    h, w = disp.shape
    dev = disp.device
    invz, scale, shift_x, shift_y, izmin, izmax, c1, f1, f2 = _plane_setup(
        disp, invz_min, invz_max, c1, f2, focal1, num_planes, plane_invz)
    num_planes = invz.shape[0]
    # per-plane sigmoid sharpness from the LOCAL spacing
    spacing = torch.diff(invz).abs()
    spacing = torch.cat([spacing[:1], spacing])
    sharp = 1.0 / torch.clamp(spacing * softness, min=1e-9)

    disp_wh = disp.to(torch.float32).T  # (W, H)
    if exact_color:
        solve = _FirstCrossing(out_h, out_w, dev)
    else:
        # colour + mask warp in bf16 in a (W, H*4) layout for the row pass
        tex4 = torch.cat([rgb, mask[..., None]], dim=-1).to(torch.bfloat16)
        tex_whc = tex4.permute(1, 0, 2).reshape(w, h * 4)
        acc = _SoftComposite(out_h, out_w, dev)
        vis_x = _axis_visibility(scale, shift_x, out_w, w, feathering)
        vis_y = _axis_visibility(scale, shift_y, out_h, h, feathering)

    for lo in range(0, num_planes, chunk):
        hi = min(lo + chunk, num_planes)
        d_k = _disp_planes(disp_wh, scale, shift_x, shift_y, izmin, izmax,
                           lo, hi, out_w, out_h)
        # occupancy CONSUMES the ray (even beyond the border, like the march
        # crossing the edge-clamped surface); visibility (inside x taper x
        # mask) scales the contribution only
        if exact_color:
            for k in range(hi - lo):
                solve.step(d_k[k], invz[lo + k])
            continue
        acc.chunk(
            d_k, invz[lo:hi], sharp[lo:hi],
            _color_planes(tex_whc, scale, shift_x, shift_y, lo, hi, out_w,
                          out_h, h),
            vis_x[lo:hi], vis_y[lo:hi],
        )

    if exact_color:
        # ONE bilinear fetch of [rgb, mask] at the solved parallax position
        invz_hat = solve.invz_star
        scale_hat = (1.0 + c1[2] * invz_hat) * (f1 / f2)
        jx = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
        iy = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
        gx = (scale_hat * (jx - (out_w - 1) / 2.0) + (w - 1) / 2.0
              - f1 * c1[0] * invz_hat)
        gy = (scale_hat * (iy - (out_h - 1) / 2.0) + (h - 1) / 2.0
              - f1 * c1[1] * invz_hat)
        u1 = (gx + 0.5) / w
        v1 = (gy + 0.5) / h
        sampled = bilinear_sample_packed(pack_rgbm(rgb, mask), u1, v1, w, h)
        acc_a = (solve.found.to(torch.float32) * _edge_tap(u1, v1, feathering)
                 * sampled[..., 3].clamp(0.0, 1.0))
        return _composite.finish_over_background(
            sampled[..., :3] * acc_a[..., None], acc_a, background, to_srgb)
    return _composite.finish_over_background(acc.rgb, acc.alpha, background,
                                             to_srgb)


def solve_depth_aligned(
    disp,
    invz_min,
    invz_max,
    c1,
    f2,
    out_w: int,
    out_h: int,
    focal1=None,
    num_planes: int = 40,
    chunk: int = 8,
    plane_invz=None,
):
    """Solve the per-pixel surface inverse depth (source-frame units) of an
    ALIGNED view, gather-free: the float32 matrix-product plane warps of
    the disparity texture plus the first-crossing interpolation. Returns
    (out_h, out_w) invZ*, 0 where the ray found no surface.

    invZ* is the source projector's inverse depth of the hit, independent
    of the render camera's ORIENTATION: the basis of render_rotated."""
    invz, scale, shift_x, shift_y, izmin, izmax, _, _, _ = _plane_setup(
        disp, invz_min, invz_max, c1, f2, focal1, num_planes, plane_invz)
    num_planes = invz.shape[0]
    disp_wh = disp.to(torch.float32).T
    solve = _FirstCrossing(out_h, out_w, disp.device)
    for lo in range(0, num_planes, chunk):
        hi = min(lo + chunk, num_planes)
        d_k = _disp_planes(disp_wh, scale, shift_x, shift_y, izmin, izmax,
                           lo, hi, out_w, out_h)
        for k in range(hi - lo):
            solve.step(d_k[k], invz[lo + k])
    return torch.where(solve.found, solve.invz_star, 0.0)


def render_rotated(
    rgb,
    disp,
    mask,
    invz_min,
    invz_max,
    c1,
    rot1,
    f2,
    background,
    out_w: int,
    out_h: int,
    focal1=None,
    num_planes: int = 40,
    chunk: int = 8,
    feathering: float = 0.1,
    to_srgb: bool = True,
    plane_invz=None,
    fov_margin: float = 1.35,
):
    """Fast render of a ROTATED novel view (two phases, two fetches).

    A camera rotation about its own centre does not change which surface
    point each ray hits, only the image-plane parameterization. So:

      Phase A (gather-free): solve_depth_aligned in an intermediate frame
        with the target camera's POSITION and the projector's ORIENTATION,
        at a FOV widened by fov_margin so it covers every target ray.
      Phase B (elementwise + 2 fetches): map each target pixel's ray into
        the intermediate image (a pure rotation homography), fetch invZ*
        (one float32 bilinear fetch), compute the exact source coordinate
        from the full projective raycast geometry and fetch the colour
        (one packed bilinear fetch).

    Arguments as render_sweep_aligned's plus rot1: the (3, 3) camera-local
    projector rotation (R_cam^T R_proj, scene convention). The 3x3 algebra
    runs on the host in float32; the per-pixel work on disp's device.
    """
    c1_h, rot1_h = _f32(c1, "cpu"), _f32(rot1, "cpu")
    f2 = _F32(f2)
    f1 = f2 if focal1 is None else _F32(focal1)

    # ---- Phase A: the aligned depth solve in the intermediate frame ----
    # c1 is the target-frame (Z-negated) value: undo the negation, rotate
    # into the projector's orientation, negate again
    flip = torch.tensor([1.0, 1.0, -1.0])
    c1_aligned = (rot1_h.T @ (c1_h * flip)) * flip
    f_i = f2 / _F32(fov_margin)  # widened intermediate FOV
    invz_map = solve_depth_aligned(
        disp, invz_min, invz_max, c1_aligned, f_i, out_w=out_w, out_h=out_h,
        focal1=f1, num_planes=num_planes, chunk=chunk, plane_invz=plane_invz,
    )
    return _rotated_phase_b(rgb, mask, invz_map, c1_h, rot1_h, f1, f2, f_i,
                            out_w, out_h, feathering, background, to_srgb)


def _rotated_phase_b(rgb, mask, invz_map, c1, rot1, f1, f2, f_i, out_w: int,
                     out_h: int, feathering, background, to_srgb: bool):
    """render_rotated's phase B: per target pixel, the rotation homography
    into the intermediate image, the float32 bilinear fetch of invZ*
    there, the exact projective source coordinate of that depth and the
    packed colour fetch. The 3x3 algebra (c1, rot1: host float32 tensors)
    on the host; the pixels on invz_map's device."""
    h, w = rgb.shape[:2]
    dev = invz_map.device
    skr1 = shader_rotation(rot1)  # flipZ rot1^T flipZ
    fskr1 = mm(mat_from_focal(f1 / _F32(w), f1 / _F32(h)), skr1)
    inv2 = inv3(mat_from_focal(f2 / _F32(out_w), f2 / _F32(out_h)))
    p_ts = mm(fskr1, inv2)  # target s2 -> source q
    c_vec = torch.matmul(fskr1, (-c1)[:, None])[:, 0]
    # target s2 -> intermediate s_I (a pure rotation homography)
    p_ti = mm(mm(mat_from_focal(f_i / _F32(out_w), f_i / _F32(out_h)), skr1),
              inv2)

    s2x = ((torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5)
           / out_w - 0.5)[None, :].expand(out_h, out_w)
    s2y = ((torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5)
           / out_h - 0.5)[:, None].expand(out_h, out_w)
    six, siy, _ = (t[0] for t in _proj_apply(p_ti[None].to(dev), s2x, s2y))
    invz_hat = bilinear_sample(invz_map, six + 0.5, siy + 0.5, out_w, out_h)
    qx, qy, _ = (t[0] for t in _proj_apply(p_ts[None].to(dev), s2x, s2y))
    cx, cy, cz = (float(v) for v in c_vec)
    s1x = cx * invz_hat + (1.0 - cz * invz_hat) * qx
    s1y = cy * invz_hat + (1.0 - cz * invz_hat) * qy
    u1, v1 = s1x + 0.5, s1y + 0.5
    sampled = bilinear_sample_packed(pack_rgbm(rgb, mask), u1, v1, w, h)
    # intermediate-image coverage: rays outside the widened FOV are unknown
    covered = ((six.abs() < 0.5) & (siy.abs() < 0.5)).to(torch.float32)
    alpha = ((invz_hat > 0.0).to(torch.float32) * covered
             * _edge_tap(u1, v1, feathering)
             * sampled[..., 3].clamp(0.0, 1.0))
    return _composite.finish_over_background(
        sampled[..., :3] * alpha[..., None], alpha, background, to_srgb)
