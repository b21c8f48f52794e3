"""Plain-PyTorch reference of the lateral fast tier on a layered depth
image: the frames that render_fast_batch(method="march") gives for an
unrotated, unskewed LDI projector whose layers may be outpainted (larger
than the view by an even margin, centred) and x-only camera offsets.

Each layer is marched as lateral.py marches a projector, on its own snap
ladder (sized over the call's cameras with the layer's own range), over
its own source: the layer's rows cropped to the view's height about the
centre, read through an x window that starts at the outpaint margin.
Then, per layer, the hit test and edge taper in the whole outpainted
layer's coordinates, the mask multiplied into alpha (mask mode
'multiply', rayCastMonoLDI.glsl:291, the program's default for an LDI), the
front-to-back over of the premultiplied layers (rayCastMonoLDI.glsl:
338-358), the transparent background and the sRGB curve. A frozen copy
of what the program does, written here so that a change to the program
cannot move the yardstick; it imports nothing of the program.

Scope: march_refine 0, snap planes of stride 1, output widths divisible
by 8, no frustum skew, every layer at the view's focal. `dtype` sets the
precision of every device tensor; the benchmark's control runs it in
bfloat16.

render_slot is what the harness calls: one sampled frame's reference and
the work of its marches, each layer counted as a source (lateral.py's
march_work), which the kernels' roofline reader counts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .lateral import (F32, Source, _bucket, _edge_pad, finish, ladder_size,
                      march_work, smoothstep, snap_plane_table)


class Layer(Source):
    """One LDI layer as the reference reads it: lateral.Source's textures
    and constants (rgb (Hl, Wl, 3) linear, disp (Hl, Wl) in [0, 1], the
    focal, the projector's x and the baseline-normalized range) and its
    mask (Hl, Wl) in [0, 1]."""

    def __init__(self, rgb, disp, mask, focal, x, invz_near, invz_far,
                 baseline):
        super().__init__(rgb, disp, focal, x, invz_near, invz_far, baseline)
        self.mask = mask


class Plan:
    """The padded source's x geometry for a layer src_w wide seen in an
    out_w-wide view (the outpaint margin bx = (src_w - out_w) / 2 on each
    side), for shifts up to max_shift pixels: the left pad, the span of
    the window starts and the right pad."""

    def __init__(self, src_w, out_w, max_shift):
        sx = _bucket(int(math.ceil(abs(max_shift))) + 2)
        self.bx = (src_w - out_w) / 2.0
        self.pad_lo_x = max(0, int(math.ceil(sx - self.bx)))
        self.span_x = int(math.ceil(self.bx + sx)) + self.pad_lo_x
        self.pad_hi_x = max(0, self.span_x + -(-(out_w + 1) // 128) * 128
                            - src_w - self.pad_lo_x)


def window_starts(plan, planes, cx, f1):
    """Per-plane integer window starts and fractions of the x warp, in
    float32 at any working precision: the start bx - f1*cx*invz, moved by
    the left pad, snapped to an integer within 1e-3 and clamped to the
    span."""
    invz = planes.float()
    fc = float(F32(f1) * F32(cx))
    tx = plan.bx - fc * invz + plan.pad_lo_x
    tx_r = torch.round(tx)
    tx = torch.where(torch.abs(tx - tx_r) < 1e-3, tx_r, tx)
    tx = torch.clamp(tx, 0.0, plan.span_x - 1e-3)
    ix = torch.floor(tx)
    t = ix + (tx - ix)
    i = torch.floor(t)
    return i.to(torch.int64).tolist(), (t - i).tolist()


def crop_rows(layer, out_h):
    """The first row of the view's rows in the layer, centred."""
    return (layer.disp.shape[0] - out_h) // 2


def march(layer, cx, planes, plan, out_w, out_h, dtype=torch.float32):
    """First-crossing march of one pose over its ladder `planes` (K,) on
    one layer: (found, invz*, rgba*), (out_h, out_w) each and rgba* the
    colour and mask lerped at the secant's crossing."""
    dev = layer.disp.device
    top = crop_rows(layer, out_h)
    rows = slice(top, top + out_h)
    planes_t = torch.as_tensor(planes, device=dev)
    ix, fx = window_starts(plan, planes_t, cx, layer.focal)
    izmin32, izmax32 = F32(layer.izmin), F32(layer.izmax)
    dsc = float(izmin32 - izmax32)
    src = torch.cat([layer.rgb[rows].permute(2, 0, 1),
                     layer.mask[rows][None], layer.disp[rows][None]]
                    ).to(dtype)
    src = _edge_pad(src, 0, 0, plan.pad_lo_x, plan.pad_hi_x)
    iz_h = torch.as_tensor(planes).to(dtype).float().numpy()

    def warp(k):
        i, f = ix[k], F32(fx[k])
        w0, w1 = float(F32(1.0) - f), float(f)
        tex = src[:, :, i:i + out_w] * w0 + src[:, :, i + 1:i + 1 + out_w] * w1
        return tex[4] * dsc + float(izmax32), tex[:4]

    zeros = torch.zeros((out_h, out_w), dtype=dtype, device=dev)
    found, invz_star = zeros.clone(), zeros.clone()
    rgba_star = torch.zeros((4, out_h, out_w), dtype=dtype, device=dev)
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


def layer_alpha(layer, found, invz_star, mask_star, cx, feathering):
    """The hit test and edge taper at the solved source position, in the
    whole (outpainted) layer's coordinates, times the mask: alpha
    (out_h, out_w)."""
    out_h, out_w = found.shape
    src_h, src_w = layer.disp.shape
    dev, dt = found.device, found.dtype
    bx = (src_w - out_w) / 2.0
    top = crop_rows(layer, out_h)
    jx = torch.arange(out_w, dtype=dt, device=dev)[None, :]
    iy = torch.arange(out_h, dtype=dt, device=dev)[:, None]
    gx = jx + bx - float(F32(layer.focal) * F32(cx)) * invz_star
    u = (gx + 0.5) / src_w
    v = (iy + top + 0.5) / src_h
    inside = ((u > 0.0) & (u < 1.0) & (v > 0.0) & (v < 1.0)).to(dt)
    f = max(float(feathering), 1e-6)
    taper = (smoothstep(0.0, f, u) * (1.0 - smoothstep(1.0 - f, 1.0, u))
             * smoothstep(0.0, f, v) * (1.0 - smoothstep(1.0 - f, 1.0, v)))
    return found * inside * taper * torch.clamp(mask_star, 0.0, 1.0)


def render(layers, cam_x, batch_xs, out_w, out_h, feathering=0.1,
           dtype=torch.float32):
    """The frame of the camera at cam_x rendered from the LDI `layers`
    (front first), in a call whose cameras sit at batch_xs: (H, W, 4)
    sRGB RGBA, and each layer's march (found, invz*, planes) for the work
    counts."""
    rgb = a = None
    marches = []
    for layer in layers:
        cx = layer.offset(cam_x)
        cxs = [layer.offset(x) for x in batch_xs]
        k = ladder_size(layer.focal, cxs, layer.izmin, layer.izmax)
        planes, _ = snap_plane_table(layer.focal, cx, layer.izmin,
                                     layer.izmax, num_planes=k)
        src_w = layer.disp.shape[1]
        plan = Plan(src_w, out_w, min(
            layer.focal * max(abs(c) for c in cxs) * layer.izmin,
            float(src_w + out_w)))
        found, izs, rgba = march(layer, cx, planes, plan, out_w, out_h,
                                 dtype)
        alpha = layer_alpha(layer, found, izs, rgba[..., 3], F32(cx),
                            feathering)
        prem = finish(rgba[..., :3] * alpha[..., None], alpha, False)
        if rgb is None:
            rgb, a = prem[..., :3], prem[..., 3]
        else:
            rgb = rgb + (1.0 - a[..., None]) * prem[..., :3]
            a = a + (1.0 - a) * prem[..., 3]
        marches.append((found, izs, planes))
    return finish(rgb, a, True).float(), marches


def render_slot(srcs, slot, config, options, dtype=torch.float32):
    """The reference of one sampled frame (slot: its frame, its index j in
    the call and the call's poses) from the LDI srcs (its layers, front
    first), and the work of its marches, {"lateral_march": counts}.
    options["ladder"] must be "call": each layer's ladder is sized over
    the whole call, as render_fast_batch sizes it."""
    rc = config["render_config"]
    if (rc.get("plane_mode", "snap") != "snap" or rc.get("march_refine", 0)
            or rc.get("march_stride", 1) != 1):
        raise ValueError("the LDI reference marches snap planes of stride 1 "
                         "without refinement")
    if options.get("ladder") != "call":
        raise ValueError("the LDI reference sizes each ladder over the call")
    if config["mask_mode"] != "multiply":
        raise ValueError("the LDI reference multiplies each layer's mask")
    pos = np.asarray(slot.poses["position"], np.float64)
    rot = slot.poses.get("rotation")
    if pos[:, 1:].any() or (rot is not None
                            and not np.allclose(rot, np.eye(3))):
        raise ValueError("the LDI reference takes x-only, unrotated cameras")
    xs = [float(v) for v in pos[:, 0]]
    frame, marches = render(srcs, xs[slot.j], xs, config["width"],
                            config["height"], rc["feathering"], dtype)
    return frame, {"lateral_march": march_work(srcs, marches)}
