"""Volume-rendering compositor (the transmittance scan) on tensors.

Counterpart of ``nerf_meets_mlx_tpu/rendering/volume.py``:

* ``mode="reference"``: no sigmoid on rgb, alpha = 1 - exp(-relu(δ·σ)),
  transmittance = exp(-exclusive_cumsum(δ·σ)) WITHOUT relu inside the
  cumsum (negative raw densities amplify transmittance);
* ``mode="canonical"``: rgb = sigmoid(raw), σ = softplus or relu of the raw
  density, alpha = -expm1(-σ·δ), transmittance = exp(-exclusive_cumsum(σ·δ)).

Both use delta distances with a 1e10 terminal bin scaled by ||rays_d||,
weights = alpha·T, and white-background completion rgb += 1 - acc.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (= logaddexp(x, 0)) without ``F.softplus``'s
    linear switch above 20, so both frameworks round alike."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cat(
        [torch.zeros_like(x[..., :1]), torch.cumsum(x[..., :-1], dim=-1)], dim=-1
    )


def raw2outputs(
    raw: torch.Tensor,        # [B, S, 4] un-activated [rgb, sigma]
    z_vals: torch.Tensor,     # [B, S]
    rays_d: torch.Tensor,     # [B, 3] (unnormalized)
    mode: str = "canonical",
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
    density_activation: str = "softplus",
    noise: Optional[torch.Tensor] = None,  # unit normals [B, S]
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Composite raw network outputs into rgb/depth/disp/acc maps + weights.

    With ``raw_noise_std > 0`` the density noise is ``noise`` (if given) or
    unit normals drawn from ``generator``, scaled by ``raw_noise_std``."""
    raw_rgb = raw[..., :3]
    raw_sigma = raw[..., 3]

    if raw_noise_std > 0.0:
        if noise is None:
            noise = torch.randn(
                raw_sigma.shape, generator=generator, dtype=raw_sigma.dtype,
                device=raw_sigma.device,
            )
        raw_sigma = raw_sigma + noise * raw_noise_std

    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], 1e10)], dim=-1)
    deltas = deltas * torch.linalg.vector_norm(rays_d[..., None, :], dim=-1)

    if mode == "reference":
        dd = deltas * raw_sigma
        alphas = 1.0 - torch.exp(-torch.relu(dd))
        transmittance = torch.exp(-exclusive_cumsum(dd))  # NB: no relu
        rgb = raw_rgb
    elif mode == "canonical":
        if density_activation == "softplus":
            sigma = softplus(raw_sigma)
        elif density_activation == "relu":
            sigma = torch.relu(raw_sigma)
        else:
            raise ValueError(f"unknown density_activation: {density_activation}")
        tau = sigma * deltas
        alphas = -torch.expm1(-tau)
        transmittance = torch.exp(-exclusive_cumsum(tau))
        rgb = torch.sigmoid(raw_rgb)
    else:
        raise ValueError(f"unknown compositing mode: {mode}")

    weights = alphas * transmittance
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map, acc_map, disp_map = maps_from_weights(weights, z_vals)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    return {
        "rgb_map": rgb_map,
        "depth_map": depth_map,
        "disp_map": disp_map,
        "acc_map": acc_map,
        "weights": weights,
    }


def maps_from_weights(weights: torch.Tensor, z_vals: torch.Tensor):
    """(depth, acc, disp) maps from dense sample weights [B, S]."""
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp_min(
        depth_map / torch.clamp_min(acc_map, 1e-10), 1e-10
    )
    return depth_map, acc_map, disp_map
