"""Image-quality metrics on tensors (counterpart of
``nerf_meets_mlx_tpu/ops/metrics.py``): MSE, PSNR and SSIM. LPIPS comes
with a later slice of the port."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def psnr(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """PSNR = 10 log10(max^2 / MSE)."""
    return 10.0 * torch.log10(max_val**2 / mse(pred, gt))


def mse_to_psnr(x: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(x)


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(
    pred: torch.Tensor,  # [H, W, C] in [0, max_val]
    gt: torch.Tensor,
    max_val: float = 1.0,
    window_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM over the image (Wang et al. 2004): an 11x11 Gaussian
    window, valid padding, averaged over the channels. The depthwise
    convolutions run in full fp32 (no TF32 on the card): conv(x²) − μ²
    cancels, and TF32's rounding would dwarf c2."""
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2

    def to_nchw(x):
        x = torch.as_tensor(x, dtype=torch.float32)
        if x.ndim == 2:
            x = x[..., None]
        return x.permute(2, 0, 1)[None]

    p, g = to_nchw(pred), to_nchw(gt).to(pred.device)
    C = p.shape[1]
    win = torch.as_tensor(_gaussian_window(window_size, sigma), device=p.device)
    kern = win[None, None].expand(C, 1, window_size, window_size).contiguous()

    def conv(x):
        return F.conv2d(x, kern, groups=C)

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        mu_p, mu_g = conv(p), conv(g)
        mu_pp, mu_gg, mu_pg = mu_p * mu_p, mu_g * mu_g, mu_p * mu_g
        sig_pp = conv(p * p) - mu_pp
        sig_gg = conv(g * g) - mu_gg
        sig_pg = conv(p * g) - mu_pg
    num = (2.0 * mu_pg + c1) * (2.0 * sig_pg + c2)
    den = (mu_pp + mu_gg + c1) * (sig_pp + sig_gg + c2)
    return torch.mean(num / den)
