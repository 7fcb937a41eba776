"""Depth (z) samplers along rays.

Counterpart of ``nerf_meets_mlx_tpu/sampling/stratified.py``: uniform and
linear-in-disparity spacing, and the stratified jitter with an injectable
uniform draw ``t`` (or a ``torch.Generator``).
"""

from __future__ import annotations

from typing import Optional

import torch

from nerf_meets_mlx_torch.utils.tensors import linspace


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def sample_z_uniform(near, far, n_samples: int):
    """Linearly spaced z in [near, far]; near/far scalars or [B, 1]."""
    t = linspace(0.0, 1.0, n_samples, device=_device_of(near, far))
    return near * (1.0 - t) + far * t


def sample_z_lindisp(near, far, n_samples: int):
    """Linear-in-disparity spacing: 1/z interpolates linearly."""
    t = linspace(0.0, 1.0, n_samples, device=_device_of(near, far))
    return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)


def stratified_jitter(
    z_vals: torch.Tensor,
    strength: float = 1.0,
    t: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Jitter each z within its stratified bin [lower, upper] (bin
    midpoints, endpoints kept). ``t`` overrides the uniform draw (shape
    z_vals.shape); otherwise it is drawn from ``generator``. Strength 0
    returns z_vals unchanged."""
    if strength <= 0.0:
        return z_vals
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    if t is None:
        t = torch.rand(
            z_vals.shape, generator=generator, dtype=z_vals.dtype,
            device=z_vals.device,
        )
    return lower + (upper - lower) * (t * strength)
