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

__all__ = ["edge_alpha", "finish_over_background", "over", "smoothstep"]


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
