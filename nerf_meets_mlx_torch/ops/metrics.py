"""Image-quality metrics on tensors (counterpart of
``nerf_meets_mlx_tpu/ops/metrics.py``). MSE and PSNR only; SSIM and LPIPS
come with a later slice of the port."""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def psnr(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """PSNR = 10 log10(max^2 / MSE)."""
    return 10.0 * torch.log10(max_val**2 / mse(pred, gt))

