"""Multi-projector fusion on the exact ray march, in one process.

The counterpart of lif_tpu.parallel.sharding's render_fused_projectors
and _fuse_across_views. lif_tpu gives each device of a mesh one
projector and merges the views with pmax/psum collectives; here the
views are rendered in turn on the projectors' device and stacked on a
leading view axis, pmax becomes amax over it and psum a sum. The merge is
render_fused_fast_batch's (models.renderer._fuse_views), so this is its
fidelity oracle: the same merge on the exact march.
The mesh, tile and frame sharding of lif_tpu come with multi-device
support.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT_CONFIG
from ..core.pose import relative_view_pose
from ..models.renderer import _fuse_views
from ..ops import raycast as _raycast
from ..ops.composite import finish_over_background

__all__ = ["render_fused_projectors"]


def _fuse_across_views(rgba, front_inv_depth, background,
                       to_srgb: bool = True, fuse_tol: float | None = None):
    """Tolerance-blended nearest-surface merge across the stacked view
    axis (lif_tpu's, with its pmax/psum as amax/sum over axis 0).

    rgba: (V, H, W, 4) each view's composited LDI render, colour
    premultiplied; front_inv_depth: (V, H, W) its frontmost hit's ABSOLUTE
    inverse depth (comparable across projectors with different
    baselines), 0 where nothing was hit. fuse_tol=0 is the hard
    nearest-wins merge with tie averaging."""
    tol = DEFAULT_CONFIG.fuse_tol if fuse_tol is None else fuse_tol
    color, alpha = _fuse_views(rgba[..., :3], rgba[..., 3], front_inv_depth,
                               tol)
    return finish_over_background(color, alpha, background, to_srgb=to_srgb)


def render_fused_projectors(
    projectors,
    camera,
    background=(0.0, 0.0, 0.0, 0.0),
    mask_mode: str | None = None,
    to_srgb: bool = True,
    fuse_tol: float | None = None,
    num_steps: int = _raycast.NUM_STEPS,
):
    """Fuse several projectors into one view on the exact march. Returns
    (H, W, 4) on the projectors' device (GL-oriented).

    Each projector's FULL LDI stack is ray-marched (ops.raycast.cast_view)
    and composited front to back with the reference's mask semantics,
    keeping the frontmost hit's inverse depth; the views are then merged
    at the frontmost surface with the triangular weights of
    models.renderer._fusion_weights (_fuse_across_views). This is the
    multi-projector fusion the reference lacks (it renders only the first
    projector; HoloRenderer.ts:186-189), and the oracle of
    render_fused_fast_batch for any pose.

    As in lif_tpu: the projectors must share their dimensions; the edge
    feathering is fixed at 0.1 and the miss colour is background[:3];
    mask_mode None takes the reference default per projector ('multiply'
    for an LDI, else 'none'), and where those differ every view uses
    'multiply' (lif_tpu traces one program for all views). A projector's
    march runs on its baseline-normalized range, so the hit's invz2 is
    already absolute and is compared as is."""
    p0 = projectors[0]
    for p in projectors:
        if (p.height, p.width) != (p0.height, p0.width):
            raise ValueError("fused projectors must share dimensions")
    modes = {mask_mode or ("multiply" if p.num_layers > 1 else "none")
             for p in projectors}
    mode = modes.pop() if len(modes) == 1 else "multiply"
    device = p0.device
    s2x, s2y = _raycast._pixel_grid(camera.width, camera.height, device)
    fskr2 = _raycast.target_transform(float(camera.focal_px), camera.width,
                                      camera.height, camera.skew)
    bg = torch.as_tensor(np.asarray(background, np.float32), device=device)
    views, fronts = [], []
    for p in projectors:
        pos, rot = relative_view_pose(p.position, p.rotation,
                                      camera.position, camera.rotation)
        baseline = np.float32(p.baseline)
        acc_rgb = torch.zeros((camera.height, camera.width, 3),
                              dtype=torch.float32, device=device)
        acc_a = torch.zeros((camera.height, camera.width),
                            dtype=torch.float32, device=device)
        front = torch.zeros_like(acc_a)
        for rgba, invz2, _ in _raycast.cast_view(
            p.rgb, p.disp, p.mask, p.layer_res,
            np.asarray(p.invz_min, np.float32) / baseline,
            np.asarray(p.invz_max, np.float32) / baseline,
            p.focal, p.skew, np.asarray(pos, np.float32),
            np.asarray(rot, np.float32), fskr2, s2x, s2y, bg[:3],
            p.num_layers, 0.1, num_steps, mode,
        ):
            a = rgba[..., 3]
            acc_rgb = (acc_rgb
                       + (1.0 - acc_a[..., None]) * a[..., None] * rgba[..., :3])
            new_hit = (a > 0.0) & (front == 0.0)
            front = torch.where(new_hit, invz2, front)
            acc_a = acc_a + (1.0 - acc_a) * a
        views.append(torch.cat([acc_rgb, acc_a[..., None]], dim=-1))
        fronts.append(front)
    return _fuse_across_views(torch.stack(views), torch.stack(fronts), bg,
                              to_srgb=to_srgb, fuse_tol=fuse_tol)
