"""sRGB conversion (the IEC 61966-2-1 piecewise curve).

reference: src/shaders/rayCastMonoLDI.glsl:100-107 (linear -> sRGB); its
inverse decodes 8-bit sRGB images to the linear light the march blends.
"""

from __future__ import annotations

import torch

__all__ = ["linear_to_srgb", "srgb_to_linear"]


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    """Piecewise sRGB OETF, elementwise."""
    return torch.where(
        linear <= 0.0031308,
        linear * 12.92,
        1.055 * torch.pow(torch.clamp(linear, min=1e-12), 1.0 / 2.4) - 0.055,
    )


def srgb_to_linear(srgb) -> torch.Tensor:
    """Piecewise sRGB EOTF, elementwise (inverse of linear_to_srgb)."""
    srgb = torch.as_tensor(srgb)
    return torch.where(
        srgb <= 0.04045,
        srgb / 12.92,
        torch.pow(torch.clamp((srgb + 0.055) / 1.055, min=1e-12), 2.4),
    )
