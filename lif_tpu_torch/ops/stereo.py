"""Two-view (stereo) LDI rendering: view weighting, occlusion fill, blend.

The counterpart of lif_tpu.ops.stereo, the stereo raycast kernel
(reference: src/shaders/rayCastStereoLDI.glsl:321-450) as dense tensors:
both views' ray marches share the output grid; the baseline-projection
weight, the sequential occlusion fill and the front-to-back LDI
compositing are elementwise selects. occlusion_blend is shared with the
fast stereo path (models.renderer.render_stereo_fast_batch), which feeds
it the march tiers' raw outputs instead of the exact march's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import composite as _composite
from .raycast import NUM_STEPS, _pixel_grid, cast_view, target_transform

__all__ = ["occlusion_blend", "render_stereo", "view_weight"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def view_weight(c, c1, c2) -> torch.Tensor:
    """Blend weight of the right view: the projection of the render camera
    c onto the stereo baseline c1 -> c2, smoothstepped to [0, 1]; float32
    on the host, broadcast over leading dims. Coincident views (a
    degenerate baseline) weigh 0, all left, where the raw formula gives
    NaN. reference: rayCastStereoLDI.glsl:165-170."""
    c, c1, c2 = _f32(c), _f32(c1), _f32(c2)
    d = c2 - c1
    den = (d * d).sum(-1)
    t = torch.clamp((d * (c - c1)).sum(-1) / torch.clamp(den, min=1e-12),
                    0.0, 1.0)
    t = torch.where(den < 1e-12, 0.0, t)
    return t * t * (3.0 - 2.0 * t)


def occlusion_blend(rgba_l, rgba_r, conf_l, conf_r, w_r):
    """One layer of both views, (…, 4) straight alpha, filled and blended
    (rayCastStereoLDI.glsl:372-386): L takes R where L's confidence died
    and R's survived or L's alpha is notably (> 0.1) lower; then the
    symmetric test fills R from the ALREADY FILLED L (the GLSL's
    aliasing); the result is (1 - w_r) * L + w_r * R. w_r: a float or a
    tensor that broadcasts against the layer."""
    fill_l = ((conf_l == 0.0) & (conf_r == 1.0)) | (
        rgba_l[..., 3] < rgba_r[..., 3] - 0.1
    )
    rgba_l = torch.where(fill_l[..., None], rgba_r, rgba_l)
    fill_r = ((conf_r == 0.0) & (conf_l == 1.0)) | (
        rgba_r[..., 3] < rgba_l[..., 3] - 0.1
    )
    rgba_r = torch.where(fill_r[..., None], rgba_l, rgba_r)
    return (1.0 - w_r) * rgba_l + w_r * rgba_r


def render_stereo(
    rgb_l,
    disp_l,
    mask_l,
    layer_res_l,
    invz_min_l,
    invz_max_l,
    focal_l,
    skew1_l,
    c1_l,
    rot1_l,
    rgb_r,
    disp_r,
    mask_r,
    layer_res_r,
    invz_min_r,
    invz_max_r,
    focal_r,
    skew1_r,
    c1_r,
    rot1_r,
    f2: float,
    skew2,
    background,
    out_w: int,
    out_h: int,
    num_layers: int,
    feathering: float = 0.1,
    num_steps: int = NUM_STEPS,
    to_srgb: bool = True,
):
    """Render a novel view blending two source projectors (L and R).

    Per layer (reference: rayCastStereoLDI.glsl:368-436): both views'
    exact ray march with the stereo mask semantics (raycast_layer's
    'dilated_discard'), then occlusion_blend with the view_weight of the
    render camera (at the origin of its own frame); front-to-back
    over-compositing across layers, the background blend and the final
    gamma.

    Inputs mirror ops.raycast.render_mono's, once per view (textures on
    the render device, the rest on the host); invz ranges already
    baseline-normalized. Returns (H, W, 4), GL-oriented.
    """
    device = rgb_l.device
    s2x, s2y = _pixel_grid(out_w, out_h, device)
    fskr2 = target_transform(f2, out_w, out_h, skew2)
    background = torch.as_tensor(
        np.asarray(background, np.float32), device=device
    )
    w_r = float(view_weight(np.zeros(3), c1_l, c1_r))
    common = (fskr2, s2x, s2y, background[:3], num_layers, feathering,
              num_steps, "dilated_discard")
    casts = (
        cast_view(rgb_l, disp_l, mask_l, layer_res_l, invz_min_l, invz_max_l,
                  focal_l, skew1_l, c1_l, rot1_l, *common),
        cast_view(rgb_r, disp_r, mask_r, layer_res_r, invz_min_r, invz_max_r,
                  focal_r, skew1_r, c1_r, rot1_r, *common),
    )
    acc = None
    for (rgba_l, _, conf_l), (rgba_r, _, conf_r) in zip(*casts):
        acc = _composite.over(acc, occlusion_blend(
            rgba_l, rgba_r, conf_l, conf_r, w_r))
    return _composite.finish_over_background(*acc, background, to_srgb)
