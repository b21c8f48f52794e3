"""Shared compositing epilogue: hit alpha, background blend + gamma.

The counterpart of lif_tpu.ops.composite. The reference applies the same
final stage in every mode — blend the premultiplied composite over the
(premultiplied) background color, then linear->sRGB
(rayCastMonoLDI.glsl:361-369).
"""

from __future__ import annotations

import torch

from ..core.color import linear_to_srgb
from ..utils import profiling

__all__ = ["edge_alpha", "finish_over_background", "fuse_views",
           "fusion_weights", "over", "over_into", "smoothstep"]


def smoothstep(e0, e1, x: torch.Tensor) -> torch.Tensor:
    """GLSL smoothstep (reference: rayCastMonoLDI.glsl:49-53 taper)."""
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def edge_alpha(found, u1, v1, feathering, mask_alpha, mask_mode: str):
    """Hit validity + composite alpha at a solved source position
    (reference: rayCastMonoLDI.glsl:49-53, :275, :284-291; stereo hard
    discard rayCastStereoLDI.glsl:304-305).

    found: 0/1 march hit; u1/v1 normalized source coords of the solved
    position; mask_alpha the sampled mask channel. Returns (hit, alpha)."""
    inside = ((u1 > 0.0) & (u1 < 1.0) & (v1 > 0.0) & (v1 < 1.0)).to(
        torch.float32
    )
    f = max(float(feathering), 1e-6)
    tap = (
        smoothstep(0.0, f, u1) * (1.0 - smoothstep(1.0 - f, 1.0, u1))
        * smoothstep(0.0, f, v1) * (1.0 - smoothstep(1.0 - f, 1.0, v1))
    )
    hit = found * inside
    alpha = hit * tap
    if mask_mode == "multiply":
        alpha = alpha * torch.clamp(mask_alpha, 0.0, 1.0)
    elif mask_mode == "hard":
        keep = (mask_alpha >= 0.5).to(torch.float32)
        alpha = alpha * keep
        hit = hit * keep
    elif mask_mode != "none":
        raise ValueError(f"unsupported mask_mode: {mask_mode}")
    return hit, alpha


def finish_over_background(rgb_premult, alpha, background, to_srgb: bool):
    """(…, 3) premultiplied rgb + (…,) alpha over a (4,) background.
    Returns (…, 4)."""
    bg = torch.as_tensor(background, dtype=torch.float32, device=alpha.device)
    if not (isinstance(background, torch.Tensor)
            and background.device == alpha.device):
        profiling.host_sync("sync.upload.background", alpha.device)
    out_rgb = bg[:3] * bg[3] * (1.0 - alpha[..., None]) + rgb_premult
    out_a = bg[3] + alpha * (1.0 - bg[3])
    if to_srgb:
        out_rgb = linear_to_srgb(out_rgb)
    return torch.cat([out_rgb, out_a[..., None]], dim=-1)


def over(acc, layer):
    """Front-to-back over-compositing of one straight-alpha (…, 4) layer
    onto acc = (premultiplied rgb, alpha), None before the first layer
    (rayCastMonoLDI.glsl:338-358). Returns the new (rgb, alpha)."""
    la = layer[..., 3]
    if acc is None:
        return layer[..., :3] * la[..., None], la
    rgb, a = acc
    return (rgb + (1.0 - a[..., None]) * la[..., None] * layer[..., :3],
            la + a * (1.0 - la))


def over_into(layer, out, background, to_srgb: bool, *, first: bool,
              last: bool):
    """The renderer's LDI chain for one (B, H, W, 4) layer, premultiplied
    over a zero background, written into `out`, the caller's (B, H,
    W_true, 4) frames (W_true <= W): the front-to-back over onto the
    layers in front held in `out` (unless `first`), finish_over_background
    (if `last`), then the true width into `out`. It runs at the layer's
    width, as the renderer's chain does: on the CPU a vectorised pow
    rounds by its place in the loop, so the layout is part of the result.
    The epilogue kernels' plain versions end here. Returns out."""
    w_true = out.shape[2]
    if first:
        rgb, a = layer[..., :3], layer[..., 3]
    else:
        acc = torch.nn.functional.pad(out, (0, 0, 0, layer.shape[2] - w_true))
        rgb = acc[..., :3] + (1.0 - acc[..., 3][..., None]) * layer[..., :3]
        a = acc[..., 3] + (1.0 - acc[..., 3]) * layer[..., 3]
    if last:
        done = finish_over_background(rgb, a, background, to_srgb)
    else:
        done = torch.cat([rgb, a[..., None]], dim=-1)
    out.copy_(done[:, :, :w_true])
    return out


def fuse_views(rgb_s, a_s, front_s, tol: float, reduce_max=None,
               reduce_sum=None):
    """The merge across the view axis of multi-projector fusion, shared by
    the fast and the exact fusion, in one process and over a mesh
    (lif_tpu's, its pmax/psum as reduce_max/reduce_sum): rgb_s (V, ..., 3)
    each view's premultiplied composite, a_s (V, ...) its alpha, front_s
    (V, ...) its frontmost hit's absolute inverse depth. The reductions
    default to amax/sum over axis 0 of the stacked views; the mesh form
    (parallel.sharding) passes all_reduce closures over the view group,
    each rank holding its one view without the V axis. Returns the merged
    (premultiplied colour, alpha), alpha 0 where no view hit."""
    if reduce_max is None:
        def reduce_max(t):
            return t.amax(dim=0)
    if reduce_sum is None:
        def reduce_sum(t):
            return t.sum(dim=0)
    hit = a_s > 0.0
    key = torch.where(hit, front_s, -torch.inf)
    best = reduce_max(key)
    w = fusion_weights(key, best, hit, tol)
    wsum = torch.clamp(reduce_sum(w), min=1e-12)
    color = reduce_sum(w[..., None] * rgb_s) / wsum[..., None]
    alpha = reduce_sum(w * a_s) / wsum
    return color, torch.where(torch.isfinite(best), alpha, 0.0)


def fusion_weights(key, best, hit, tol: float):
    """Per-candidate merge weights of multi-projector fusion (lif_tpu's
    _fusion_weights). Triangular in relative inverse-depth distance from
    the frontmost: w = 1 at key == best, 0 at key <= best*(1 - tol);
    non-hit candidates weigh 0. tol <= 0 is the hard nearest-wins merge
    (exact ties weigh 1 each). Where both key and best are -inf the gap is
    NaN, which the clamp keeps and the isfinite(key) guard removes."""
    if tol <= 0.0:
        return (hit & (key >= best)).to(torch.float32)
    edge = torch.abs(best) * tol
    gap = best - key  # >= 0; +inf for a non-hit
    w = 1.0 - gap / torch.clamp(edge, min=1e-30)
    w = torch.where(torch.isfinite(key), torch.clamp(w, 0.0, 1.0), 0.0)
    # an exact tie at best == 0 (edge 0): gap 0 gives w = 1 - 0/eps = 1
    return torch.where(hit, w, 0.0)
