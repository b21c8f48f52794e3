"""Forward-warp splat renderer: the billboard mode as a scatter rasterizer.

The counterpart of lif_tpu.ops.splat (reference: src/shaders/holoVertex.glsl
+ holoFragment.glsl, billboard mode): every source pixel is unprojected
with its decoded depth, moved into the target view and splatted with a
square footprint into a z-buffered image. Plain PyTorch on any device:
the two scatter-mins (depth key, then the lowest source id among the
depth winners) are Tensor.scatter_reduce_(..., "amin"), which is exact in
any order, and one gather fetches the winner's colour. lif_tpu computes
this outside any Pallas kernel too; the production billboard path for
lateral poses is ops.splat_march (a hand-written kernel on CUDA), held to
this scatter as its oracle.

Float32 throughout, in lif_tpu's order of operations. Every division has
a tensor divisor: on CUDA, PyTorch divides a tensor by a Python number as
a multiply by its reciprocal, which would round differently from lif_tpu
and from the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.color import linear_to_srgb
from ..core.pose import relative_view_pose

__all__ = ["forward_splat", "render_mesh_view"]

EPSILON = 1e-8  # reference: holoVertex.glsl:44
INF_Z = 1e6  # reference: holoVertex.glsl:45


def _f32(x, device) -> torch.Tensor:
    """A float32 tensor of `x` (a number, array or tensor) on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _decode_depth(disp, invz_min, invz_max, baseline):
    """texel -> depth: invZ = mix(invZmax, invZmin, texel); depth =
    baseline/invZ; invZ ~ 0 => 1e6. reference: holoVertex.glsl:57-64."""
    invz = invz_max + (invz_min - invz_max) * disp
    return torch.where(invz.abs() < EPSILON, INF_Z, baseline / invz)


def _invz_range(disp, invz_min, invz_max):
    """The gradient cull's per-pixel invZ range over the 4-neighbourhood
    and the centre, edge-clamped (reference: holoVertex.glsl:192-229)."""
    invz_tex = invz_max + (invz_min - invz_max) * disp
    pad = torch.nn.functional.pad(invz_tex[None, None], (1, 1, 1, 1),
                                  mode="replicate")[0, 0]
    neigh = torch.stack([
        invz_tex, pad[1:-1, :-2], pad[1:-1, 2:], pad[:-2, 1:-1],
        pad[2:, 1:-1],
    ])
    return neigh.amax(0) - neigh.amin(0)


def _floor_index(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int64, saturated far outside any image (a footprint
    there is out of bounds either way)."""
    return torch.floor(x).clamp(-2.0**30, 2.0**30).to(torch.int64)


def forward_splat(
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
    point_size=1.0,
    footprint: int = 2,
    to_srgb: bool = True,
    show_depth=False,
):
    """Splat one source layer into a novel view with z-buffering.

    Args (lif_tpu.ops.splat.forward_splat's):
      rgb: (H, W, 3) linear source colours, GL-oriented, on the render
        device. disp: (H, W) normalized inverse depth (point sampled).
      invz_min/invz_max/baseline: depth decode parameters (LIF units).
      fx, fy, cx, cy: source intrinsics in pixels (GL-oriented cy).
      rel_rotation: (3, 3) camera-local projector rotation.
      rel_position: (3,) camera-local projector position, scene convention
        (-Z forward).
      f2: target focal in pixels (centered target principal point).
      out_w/out_h: output size. background: (4,) linear RGBA for unhit
        pixels.
      delta_invz_threshold: gradient cull threshold (0 disables; None
        skips the test).
      point_size: footprint scale (holoVertex.glsl:264). footprint: the
        splat kernel's width in target pixels.
      show_depth: the winning disparity texel as grey.

    Returns (out_h, out_w, 4) float32, GL-oriented, on rgb's device.
    """
    dev = disp.device
    dtype = torch.float32
    h, w = disp.shape
    disp = disp.to(dtype)
    invz_min, invz_max = _f32(invz_min, dev), _f32(invz_max, dev)
    fx, fy, f2 = _f32(fx, dev), _f32(fy, dev), _f32(f2, dev)
    cx, cy = _f32(cx, dev), _f32(cy, dev)
    depth = _decode_depth(disp, invz_min, invz_max, _f32(baseline, dev))

    # pixel centres (i + 0.5, j + 0.5); reference: holoVertex.glsl:139,165-170
    px = (torch.arange(w, dtype=dtype, device=dev) + 0.5)[None, :]
    py = (torch.arange(h, dtype=dtype, device=dev) + 0.5)[:, None]
    x_cam = (px - cx) * depth / fx
    y_cam = (py - cy) * depth / fy
    z_cam = -depth

    # projector -> camera-local: R_rel @ p + t_rel
    r = _f32(rel_rotation, dev)
    t = _f32(rel_position, dev)
    xv = r[0, 0] * x_cam + r[0, 1] * y_cam + r[0, 2] * z_cam + t[0]
    yv = r[1, 0] * x_cam + r[1, 1] * y_cam + r[1, 2] * z_cam + t[1]
    zv = r[2, 0] * x_cam + r[2, 1] * y_cam + r[2, 2] * z_cam + t[2]

    valid = zv < -0.001  # behind-camera discard, holoVertex.glsl:187-189
    if delta_invz_threshold is not None:
        delta = _invz_range(disp, invz_min, invz_max)
        thr = _f32(delta_invz_threshold, dev)
        valid = valid & ((thr <= 0.0) | (delta <= thr))

    # project into the target pinhole (centered pp), pixel coordinates
    inv_zv = _f32(1.0, dev) / torch.clamp(zv, max=-1e-9)
    u = f2 * (xv * -inv_zv) + out_w / 2.0
    v = f2 * (yv * -inv_zv) + out_h / 2.0
    zkey = torch.where(valid, -zv, torch.inf).reshape(-1)

    # screen-space footprint (holoVertex.glsl:252-264)
    dist = torch.sqrt(x_cam * x_cam + y_cam * y_cam + z_cam * z_cam)
    su = (dist / fx) * f2 * (-inv_zv) * point_size
    sv = (dist / fy) * f2 * (-inv_zv) * point_size
    half_u = torch.clamp(su, min=1.0) * 0.5
    half_v = torch.clamp(sv, min=1.0) * 0.5

    n_out = out_h * out_w
    iu = _floor_index(u - 0.5 * (footprint - 1))
    iv = _floor_index(v - 0.5 * (footprint - 1))

    def splat_key(dy, dx):
        """Flat target index + depth key of one footprint offset: a target
        pixel is covered iff its centre lies inside the projected quad."""
        pu, pv = iu + dx, iv + dy
        covered = ((pu.to(dtype) + 0.5 - u).abs() <= half_u) & (
            (pv.to(dtype) + 0.5 - v).abs() <= half_v)
        inb = (pu >= 0) & (pu < out_w) & (pv >= 0) & (pv < out_h)
        fi = (pv.clamp(0, out_h - 1) * out_w + pu.clamp(0, out_w - 1))
        key = torch.where(inb & covered, zkey.reshape(h, w), torch.inf)
        return fi.reshape(-1), key.reshape(-1)

    keys = [splat_key(dy, dx) for dy in range(footprint)
            for dx in range(footprint)]
    zbuf = torch.full((n_out,), torch.inf, dtype=dtype, device=dev)
    for fi, key in keys:
        zbuf.scatter_reduce_(0, fi, key, "amin", include_self=True)

    # the lowest source id among the depth winners resolves exact ties
    n_src = h * w
    src_id = torch.arange(n_src, device=dev)
    idbuf = torch.full((n_out,), n_src, dtype=torch.int64, device=dev)
    for fi, key in keys:
        won = (key <= zbuf[fi]) & torch.isfinite(key)
        idbuf.scatter_reduce_(0, fi, torch.where(won, src_id, n_src), "amin",
                              include_self=True)

    hit = idbuf < n_src
    win_id = idbuf.clamp(0, n_src - 1)
    if show_depth:
        gray = disp.reshape(-1)[win_id]
        out_rgb = torch.stack([gray] * 3, dim=-1)
    else:
        out_rgb = rgb.to(dtype).reshape(-1, 3)[win_id]
    bg = _f32(background, dev)
    rgb_img = torch.where(hit[:, None], out_rgb, bg[:3] * bg[3])
    a_img = torch.where(hit, 1.0, bg[3])
    if to_srgb:
        rgb_img = linear_to_srgb(rgb_img)
    return torch.cat(
        [rgb_img.reshape(out_h, out_w, 3), a_img.reshape(out_h, out_w, 1)],
        dim=-1,
    )


def view_arguments(projector, camera):
    """The mesh modes' per-view inputs of layer 0 (lif_tpu renders only
    the first projector layer in mesh mode; HoloRenderer.ts:186-189):
    (rgb, disp, invz_min, invz_max, baseline, fx, fy, cx, cy_gl, rotation,
    position, f2), with the relative pose in scene convention (the shader
    Z negation undone) and cy flipped to the arrays' bottom-origin frame.
    As in lif_tpu, the stored (padded) layer-0 arrays are passed whole."""
    pos, rot = relative_view_pose(
        projector.position, projector.rotation, camera.position,
        camera.rotation,
    )
    pos = pos * np.array([1.0, 1.0, -1.0])
    intr = projector.intrinsics
    return (
        projector.rgb[0], projector.disp[0], projector.invz_min[0],
        projector.invz_max[0], projector.baseline, intr["fx"], intr["fy"],
        intr["cx"], projector.height - intr["cy"], rot, pos,
        camera.focal_px,
    )


def render_mesh_view(
    projector,
    camera,
    background=(0.0, 0.0, 0.0, 0.0),
    delta_invz_threshold=0.0,
    point_size=1.0,
    footprint: int = 2,
    to_srgb: bool = True,
    show_depth=False,
):
    """Billboard-mode render of a Projector into a Camera (layer 0), on
    the projector's device. Returns (H, W, 4) GL-oriented."""
    return forward_splat(
        *view_arguments(projector, camera),
        out_w=camera.width, out_h=camera.height, background=background,
        delta_invz_threshold=delta_invz_threshold, point_size=point_size,
        footprint=footprint, to_srgb=to_srgb, show_depth=show_depth,
    )
