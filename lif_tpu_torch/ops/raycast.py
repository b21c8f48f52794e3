"""Per-pixel inverse-depth ray march (the exact novel-view renderer).

The counterpart of lif_tpu.ops.raycast, and the fidelity oracle of the
fast path (at 640 steps it is the converged march). It re-designs the
reference's raycast fragment shader (reference:
src/shaders/rayCastMonoLDI.glsl:219-381) as dense (H, W) tensors: a
Python loop over the march steps carries the state of every pixel at
once, each step reading the disparity texture bilinearly.

Conventions (all faithful to the reference):
  * s2 = uv - 0.5, uv in [0,1]^2 GL-oriented (v up).
  * source transform FSKR1 = focal(f1/iRes) @ skew(sk1) @ flipZ R1^T flipZ,
    target FSKR2 = focal(f2/oRes) @ skew(sk2) @ flipZ R2^T flipZ.
  * P = FSKR1 @ inv(FSKR2), C = FSKR1 @ (C2 - C1); the source coordinate of
    the ray at inverse depth invZ is
    s1(invZ) = C.xy*invZ + (1 - C.z*invZ) * (Pxyxy s2 + Pxyz)/(Pzxy.s2 + Pzz).
  * March from invZmin toward invZmax in `num_steps` linear steps; on
    surface crossing (disp > invZ && invZ2 > 0) step back and halve the
    step (fused march + binary refinement).
  * invZ values are in baseline-normalized units.

Scalars (the 3x3 transforms, ranges, steps) are computed on the host in
float32 and enter the device arithmetic as Python numbers holding those
float32 values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.transforms import inv3, mat_from_focal, mat_from_skew, mm, shader_rotation
from . import composite as _composite
from .composite import smoothstep
from .sampling import bilinear_sample, read_disp

__all__ = ["NUM_STEPS", "blend_background", "build_fskr2", "build_skr1",
           "cast_view", "compose_layers", "raycast_layer", "render_mono",
           "taper", "target_transform"]

NUM_STEPS = 40  # reference: rayCastMonoLDI.glsl:223

_F32 = np.float32


def taper(u, v, feathering):
    """Edge feathering window. reference: rayCastMonoLDI.glsl:49-53."""
    f = max(float(feathering), 1e-6)
    return (
        smoothstep(0.0, f, u)
        * (1.0 - smoothstep(1.0 - f, 1.0, u))
        * smoothstep(0.0, f, v)
        * (1.0 - smoothstep(1.0 - f, 1.0, v))
    )


def raycast_layer(
    s2x,
    s2y,
    p,
    c,
    rgb,
    disp,
    mask,
    invz_min: float,
    invz_max: float,
    res_w: float,
    res_h: float,
    background_rgb,
    feathering: float,
    num_steps: int = NUM_STEPS,
    mask_mode: str = "multiply",
):
    """Ray-march one source layer for every output pixel.

    Args:
      s2x, s2y: (H, W) target coordinates (uv - 0.5), GL-oriented.
      p: (3, 3) float32 CPU tensor, FSKR1 @ inv(FSKR2).
      c: (3,) float32 CPU tensor, FSKR1 @ (C2 - C1).
      rgb: (Hs, Ws, 3) linear-light source colors on the render device.
      disp: (Hs, Ws) disparity texture in [0, 1].
      mask: (Hs, Ws) layer mask in [0, 1].
      invz_min, invz_max: baseline-normalized inverse-depth range.
      res_w, res_h: logical layer resolution.
      background_rgb: (3,) returned in the miss branch (alpha 0).
      mask_mode: 'multiply' -> alpha *= bilinear mask (mono LDI,
        rayCastMonoLDI.glsl:291); 'dilated_discard' -> the stereo march:
        a hit needs invZ2 >= 0 (rayCastStereoLDI.glsl:298) and any of 9
        bilinear mask reads on a 3x3 grid 1.5 texels apart below 0.5
        discards it, colour included (isMaskAround, :147-158, :304-305);
        'none' -> taper only (non-LDI, rayCastMonoLDI.glsl:277-279).

    Returns (rgba, invz2, confidence), each (H, W[, 4]): rgba with the
    premultiplication NOT applied; invz2 the hit's inverse depth in
    target space (0 on a miss); confidence the shader's out-param, 0
    where a crossing step saw a disparity jump above grad_thr
    (rayCastMonoLDI.glsl:236, :265-267). A miss zeroes confidence except
    in the stereo mode, whose miss branch leaves it; a mono hit returns
    the taper as confidence in the 'multiply' mode.
    """
    if mask_mode not in ("multiply", "dilated_discard", "none"):
        raise ValueError(f"unknown mask_mode: {mask_mode}")
    (p00, p01, p02), (p10, p11, p12), (p20, p21, p22) = p.tolist()
    c_x, c_y, c_z = c.tolist()

    denom = p20 * s2x + p21 * s2y + p22  # Pzxy.s2 + Pzz
    qx = (p00 * s2x + p01 * s2y + p02) / denom
    qy = (p10 * s2x + p11 * s2y + p12) / denom

    izmin, izmax = _F32(invz_min), _F32(invz_max)
    dinvz0 = (izmin - izmax) / _F32(num_steps)
    invz = torch.full_like(denom, float(izmin + dinvz0))  # step back once
    dinvz = torch.full_like(denom, float(dinvz0))
    grad_thr = float(_F32(0.02) * (izmin - izmax) * _F32(140.0)
                     / _F32(num_steps))

    s1x = c_x * invz + (1.0 - c_z * invz) * qx
    s1y = c_y * invz + (1.0 - c_z * invz) * qy
    ds1x = (c_x - c_z * qx) * dinvz
    ds1y = (c_y - c_z * qy) * dinvz
    invz2 = torch.zeros_like(denom)
    old_disp = torch.zeros_like(denom)
    confidence = torch.ones_like(denom)

    for _ in range(num_steps):
        invz = invz - dinvz
        s1x = s1x - ds1x
        s1y = s1y - ds1y
        disp_v = read_disp(
            disp, s1x + 0.5, s1y + 0.5, invz_min, invz_max, res_w, res_h
        )
        grad_disp = disp_v - old_disp
        old_disp = disp_v
        invz2 = invz * denom / (1.0 - c_z * invz)
        below = (disp_v > invz) & (invz2 > 0.0)
        confidence = torch.where(below & (torch.abs(grad_disp) > grad_thr),
                                 0.0, confidence)
        invz = torch.where(below, invz + dinvz, invz)
        s1x = torch.where(below, s1x + ds1x, s1x)
        s1y = torch.where(below, s1y + ds1y, s1y)
        dinvz = torch.where(below, dinvz * 0.5, dinvz)
        ds1x = torch.where(below, ds1x * 0.5, ds1x)
        ds1y = torch.where(below, ds1y * 0.5, ds1y)

    # hit validity (rayCastMonoLDI.glsl:275, rayCastStereoLDI.glsl:298);
    # the animation gate invz > invz_min * (1 - t) is invz > 0 at t = 1
    stereo = mask_mode == "dilated_discard"
    hit = (
        (torch.abs(s1x) < 0.5) & (torch.abs(s1y) < 0.5)
        & ((invz2 >= 0.0) if stereo else (invz2 > 0.0)) & (invz > 0.0)
    )
    u1 = s1x + 0.5
    v1 = s1y + 0.5
    color = bilinear_sample(rgb, u1, v1, res_w, res_h)
    alpha = taper(u1, v1, feathering)
    hit_confidence = confidence
    if mask_mode == "multiply":
        hit_confidence = alpha
        alpha = alpha * bilinear_sample(mask, u1, v1, res_w, res_h)
    elif stereo:
        masked = torch.zeros_like(hit)
        for dy in (-1.0, 0.0, 1.0):
            for dx in (-1.0, 0.0, 1.0):
                # u1 + 1.5 * dx / res_w, the offset in float32 as lif_tpu
                mv = bilinear_sample(
                    mask, u1 + float(_F32(1.5 * dx) / _F32(res_w)),
                    v1 + float(_F32(1.5 * dy) / _F32(res_h)), res_w, res_h,
                )
                masked = masked | (mv < 0.5)
        alpha = torch.where(masked, 0.0, alpha)
        color = torch.where(masked[..., None], 0.0, color)
    out_rgb = torch.where(hit[..., None], color, background_rgb)
    out_a = torch.where(hit, alpha, 0.0)
    out_invz2 = torch.where(hit, invz2, 0.0)
    if not stereo:
        hit_confidence = torch.where(hit, hit_confidence, 0.0)
    return (torch.cat([out_rgb, out_a[..., None]], dim=-1), out_invz2,
            hit_confidence)


def _pixel_grid(out_w: int, out_h: int, device, full_w=None, full_h=None,
                row_start=0, col_start=0):
    """GL-oriented pixel-center uv grid minus 0.5 (the s2 coordinates).

    With full_w/full_h set, the (out_h, out_w) tile of the larger
    (full_h, full_w) grid starting at (row_start, col_start): each tile of
    a split framebuffer renders its part of the same virtual image."""
    fw = out_w if full_w is None else full_w
    fh = out_h if full_h is None else full_h
    u = (torch.arange(out_w, dtype=torch.float32, device=device) + 0.5
         + col_start) / fw
    v = (torch.arange(out_h, dtype=torch.float32, device=device) + 0.5
         + row_start) / fh
    s2x = u[None, :].expand(out_h, out_w) - 0.5
    s2y = v[:, None].expand(out_h, out_w) - 0.5
    return s2x, s2y


def target_transform(f2: float, out_w: int, out_h: int, skew2):
    """FSKR2 = focal(f2/oRes) @ skew(sk2), the render camera's transform
    (rayCastMonoLDI.glsl:332), built on the host in float32."""
    return mm(
        mat_from_focal(_F32(f2) / _F32(out_w), _F32(f2) / _F32(out_h)),
        mat_from_skew(skew2[0], skew2[1]),
    )


def build_skr1(skew1, rot1):
    """The skew and rotation part of the source transform, skew(sk1) @
    flipZ R1^T flipZ (the focal is applied per layer), on the host in
    float32 (rayCastMonoLDI.glsl:316-326)."""
    return mm(mat_from_skew(skew1[0], skew1[1]), shader_rotation(rot1))


def build_fskr2(f2: float, out_w, out_h, skew2, rot2=None):
    """The full target transform (rayCastMonoLDI.glsl:332): target_transform,
    times flipZ R2^T flipZ when the render camera carries a rotation rot2
    in the march's frame."""
    m = target_transform(f2, out_w, out_h, skew2)
    return m if rot2 is None else mm(m, shader_rotation(rot2))


def cast_view(rgb, disp, mask, layer_res, invz_min, invz_max, focal, skew1,
              c1, rot1, fskr2, s2x, s2y, background_rgb, num_layers: int,
              feathering: float, num_steps: int, mask_mode: str):
    """raycast_layer over the first num_layers layers of one projector,
    front layer first: yields each layer's (rgba, invz2, confidence). The
    per-layer source transform FSKR1 = focal(f1/iRes) @ skew(sk1) @
    flipZ R1^T flipZ is built on the host (rayCastMonoLDI.glsl:316-326);
    arguments as render_mono's, fskr2 from target_transform."""
    skr1 = build_skr1(skew1, rot1)
    c_rel = -torch.as_tensor(np.asarray(c1, np.float32))  # c2 = 0
    layer_res = np.asarray(layer_res, np.float32)
    for i in range(num_layers):
        res_w, res_h = float(layer_res[i, 0]), float(layer_res[i, 1])
        fi = _F32(focal[i])
        fskr1 = mm(mat_from_focal(fi / _F32(res_w), fi / _F32(res_h)), skr1)
        yield raycast_layer(
            s2x, s2y, mm(fskr1, inv3(fskr2)), fskr1 @ c_rel,
            rgb[i], disp[i], mask[i],
            float(invz_min[i]), float(invz_max[i]), res_w, res_h,
            background_rgb, feathering,
            num_steps=num_steps, mask_mode=mask_mode,
        )


def render_mono(
    rgb,
    disp,
    mask,
    layer_res,
    invz_min,
    invz_max,
    focal,
    skew1,
    c1,
    rot1,
    f2: float,
    skew2,
    background,
    out_w: int,
    out_h: int,
    num_layers: int,
    feathering: float = 0.1,
    num_steps: int = NUM_STEPS,
    mask_mode: str = "multiply",
    to_srgb: bool = True,
    full_w: int | None = None,
    full_h: int | None = None,
    row_start: int = 0,
    col_start: int = 0,
):
    """Render a novel view of one (possibly multi-layer) projector.

    Mirrors rayCastMonoLDI's main() (reference rayCastMonoLDI.glsl:299-381):
    per-layer ray march, front-to-back LDI compositing, background blend,
    optional linear->sRGB.

    Args:
      rgb: (L, Hs, Ws, 3) linear-light layer colours on the render device.
      disp: (L, Hs, Ws) disparity textures. mask: (L, Hs, Ws) masks.
      layer_res: (L, 2) logical (w, h) per layer (host array).
      invz_min/invz_max: (L,) baseline-normalized inverse-depth range (host).
      focal: (L,) focal length in source pixels (host).
      skew1: (2,) source frustum skew. c1: (3,) projector position,
        camera-local with Z negated. rot1: (3, 3) projector rotation,
        camera-local. f2: render focal in output pixels. skew2: (2,)
        render frustum skew. background: (4,) linear-light RGBA.
      out_w/out_h: output resolution. num_layers: layer count (<= L).
      full_w/full_h/row_start/col_start: render the (out_h, out_w) tile
        of a larger (full_h, full_w) framebuffer starting at (row_start,
        col_start), GL-oriented: the unit of image-space sharding
        (parallel.sharding.render_view_tiled). The focal normalization
        f2/oRes always uses the full framebuffer.

    Returns (out_h, out_w, 4) GL-oriented image (row 0 = bottom) on rgb's
    device.
    """
    device = rgb.device
    s2x, s2y = _pixel_grid(out_w, out_h, device, full_w=full_w,
                           full_h=full_h, row_start=row_start,
                           col_start=col_start)
    fb_w = out_w if full_w is None else full_w
    fb_h = out_h if full_h is None else full_h
    background = torch.as_tensor(
        np.asarray(background, np.float32), device=device
    )
    acc = None
    for layer, _, _ in cast_view(
        rgb, disp, mask, layer_res, invz_min, invz_max, focal, skew1, c1,
        rot1, target_transform(f2, fb_w, fb_h, skew2), s2x, s2y,
        background[:3], num_layers, feathering, num_steps, mask_mode,
    ):
        acc = _composite.over(acc, layer)
    return _composite.finish_over_background(*acc, background, to_srgb)


def compose_layers(layers_rgba, num_layers: int):
    """Front-to-back over-compositing of straight-alpha raycast layers
    (L, H, W, 4), the first num_layers of them (rayCastMonoLDI.glsl:
    338-358; the shader's early-outs at alpha 1 are the identity).
    Returns (H, W, 3) premultiplied rgb and (H, W) alpha."""
    acc = None
    for i in range(num_layers):
        acc = _composite.over(acc, layers_rgba[i])
    return acc


def blend_background(rgb, alpha, background):
    """The premultiplied composite over the (4,) background colour
    (rayCastMonoLDI.glsl:361-362), without the gamma curve. Returns
    (rgb, alpha)."""
    out = _composite.finish_over_background(rgb, alpha, background,
                                            to_srgb=False)
    return out[..., :3], out[..., 3]
