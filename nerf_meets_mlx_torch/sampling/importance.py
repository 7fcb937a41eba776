"""Inverse-CDF (hierarchical importance) sampling on tensors.

Counterpart of ``nerf_meets_mlx_tpu/sampling/importance.py`` with the same
semantics: histogram padding +0.01, eps renormalization, cdf = min(1,
cumsum) with a leading 0, right-searchsorted, endpoint-padded z midpoints,
a ``denom < eps`` guard, then nan_to_num and a clip. The JAX package
replaced the searchsorted by a [B, n+1, n_imp] compare cube because per-row
gathers are slow on a TPU; here ``torch.searchsorted`` and ``gather`` are
the natural form. Runs under ``no_grad``: the fine pass never backprops
into the coarse weights.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerf_meets_mlx_torch.utils.tensors import linspace


@torch.no_grad()
def sample_pdf(
    z_vals: torch.Tensor,      # [B, n]
    weights: torch.Tensor,     # [B, n]
    n_importance: int,
    eps: float = 1e-5,
    deterministic: bool = False,
    u: Optional[torch.Tensor] = None,           # [B, n_importance]
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Draw ``n_importance`` z values per ray from the weights' inverse CDF.

    deterministic=True queries linspace(0, 1); otherwise ``u`` (if given)
    or uniform draws from ``generator``. Returns [B, n_importance],
    unsorted."""
    B, n = weights.shape
    w = weights + 0.01
    w_sum = w.sum(dim=-1, keepdim=True)
    padding = torch.relu(eps - w_sum)
    w = w + padding / n
    w_sum = w_sum + padding

    pdf = w / w_sum
    cdf = torch.clamp_max(torch.cumsum(pdf, dim=-1), 1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [B, n+1]

    if deterministic:
        u = linspace(0.0, 1.0, n_importance, device=cdf.device, dtype=cdf.dtype)
        u = u.expand(B, n_importance).contiguous()
    elif u is None:
        u = torch.rand(
            (B, n_importance), generator=generator, dtype=cdf.dtype,
            device=cdf.device,
        )
    else:
        u = u.to(cdf.dtype).contiguous()

    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, 0, n)
    above = torch.clamp(inds, 0, n)

    # endpoint-padded bin midpoints: [m0, m0..m_{n-2}, m_{n-2}] -> [B, n+1]
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_mid = torch.cat([z_mid[..., :1], z_mid, z_mid[..., -1:]], dim=-1)

    cdf_from = torch.gather(cdf, 1, below)
    cdf_to = torch.gather(cdf, 1, above)
    z_from = torch.gather(z_mid, 1, below)
    z_to = torch.gather(z_mid, 1, above)

    denom = cdf_to - cdf_from
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = torch.nan_to_num((u - cdf_from) / denom, nan=0.0)
    t = torch.clamp(t, 0.0, 1.0)
    return z_from + t * (z_to - z_from)


def merge_z(z_vals: torch.Tensor, z_importance: torch.Tensor) -> torch.Tensor:
    """Sort-merge coarse and importance z values along the sample axis."""
    return torch.sort(torch.cat([z_vals, z_importance], dim=-1), dim=-1).values
