"""Sinusoidal (NeRF positional) encoding on tensors.

Counterpart of ``nerf_meets_mlx_tpu/encoding/sinusoidal.py`` with both band
modes: ``"canonical"`` (bands = 2**linspace(min_exp, max_exp, n)) and
``"reference_squared"`` (bands = linspace(0, max_exp, n)**2). The feature
layout is the same: all sin(x_i·f_j) (i-major, j-minor), then all cosines
taken as sin(x_i·f_j + π/2), then the raw input last when ``include_input``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from nerf_meets_mlx_torch.utils.tensors import linspace


def frequency_bands(
    n_freqs: int,
    min_freq_exp: float = 0.0,
    max_freq_exp: Optional[float] = None,
    band_mode: str = "canonical",
    device=None,
) -> torch.Tensor:
    if max_freq_exp is None:
        max_freq_exp = float(n_freqs - 1)
    lin = linspace(min_freq_exp, max_freq_exp, n_freqs, device=device)
    if band_mode == "canonical":
        return torch.pow(2.0, lin)
    if band_mode == "reference_squared":
        return lin**2.0
    raise ValueError(f"unknown band_mode: {band_mode}")


def sinusoidal_encode(
    x: torch.Tensor, bands: torch.Tensor, include_input: bool = False
) -> torch.Tensor:
    """Encode [..., D] -> [..., D·2·n_freqs (+D)]."""
    scaled = (x[..., None] * bands).reshape(*x.shape[:-1], -1)  # [..., D·F]
    phases = torch.cat([scaled, scaled + math.pi / 2.0], dim=-1)
    out = torch.sin(phases)
    if include_input:
        out = torch.cat([out, x], dim=-1)
    return out


@dataclasses.dataclass(frozen=True)
class SinusoidalEncoding:
    in_dim: int
    n_freqs: int
    min_freq_exp: float = 0.0
    max_freq_exp: Optional[float] = None
    include_input: bool = False
    band_mode: str = "canonical"

    @property
    def out_dim(self) -> int:
        d = self.in_dim * self.n_freqs * 2
        if self.include_input:
            d += self.in_dim
        return d

    def bands(self, device=None) -> torch.Tensor:
        return frequency_bands(
            self.n_freqs, self.min_freq_exp, self.max_freq_exp, self.band_mode,
            device=device,
        )

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return sinusoidal_encode(x, self.bands(x.device), self.include_input)
