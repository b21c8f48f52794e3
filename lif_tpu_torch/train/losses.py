"""Losses and image metrics for differentiable rendering (lif_tpu's)."""

from __future__ import annotations

import torch

__all__ = ["l1_loss", "l2_loss", "psnr"]


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor, peak=1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB (the BASELINE.json fidelity
    metric)."""
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(peak * peak / torch.clamp(mse, min=1e-12))
