"""Losses and image-quality metrics for super-resolution training
(counterpart of reve_tpu/train/losses.py)."""

from __future__ import annotations

import torch


def charbonnier(pred: torch.Tensor, target: torch.Tensor,
                eps: float = 1e-3) -> torch.Tensor:
    """Charbonnier (smooth L1), the standard Real-ESRGAN pixel loss."""
    return torch.mean(torch.sqrt((pred - target) ** 2 + eps * eps))


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB."""
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(max_val * max_val / torch.clamp_min(mse, 1e-12))
