"""Full-frame (eval) rendering.

Counterpart of ``nerf_meets_mlx_tpu/rendering/renderer.py``: the rays of
the whole frame are generated on the model's device, padded to a chunk
multiple (zero origins, unit directions, as the JAX package pads), and
swept chunk by chunk under ``no_grad``, so device memory holds one chunk's
intermediates at a time.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Iterator, Optional

import numpy as np
import torch

from nerf_meets_mlx_torch.cameras.rays import get_rays, ndc_rays

if TYPE_CHECKING:  # avoid a circular import (factory -> rendering.volume)
    from nerf_meets_mlx_torch.models.factory import NeRFModel

_MAP_KEYS = ("rgb_map", "disp_map", "acc_map", "depth_map")


@torch.no_grad()
def render_image(
    model: "NeRFModel",
    H: int,
    W: int,
    K,
    c2w,
    chunk: Optional[int] = None,
    occ_grid: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Render one H x W frame from camera-to-world matrix ``c2w``; maps stay
    on the model's device. Pass the train state's ``occ_grid`` so that the
    frame gets the learned interval tightening training used (None: the
    full intervals)."""
    chunk = min(chunk or model.cfg.render.ray_chunk, H * W)
    dev = model.device
    rays_o, rays_d = get_rays(H, W, K, c2w, device=dev)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    # the view head sees pre-NDC world directions
    viewdirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    if model.cfg.render.ndc:
        K = torch.as_tensor(K, dtype=torch.float32)
        rays_o, rays_d = ndc_rays(H, W, float(K[0, 0]), 1.0, rays_o, rays_d)

    n = rays_o.shape[0]
    n_pad = (-n) % chunk
    rays_o = torch.cat([rays_o, rays_o.new_zeros((n_pad, 3))])
    rays_d = torch.cat([rays_d, rays_d.new_ones((n_pad, 3))])
    viewdirs = torch.cat([viewdirs, viewdirs.new_ones((n_pad, 3))])

    parts: Dict[str, list] = {k: [] for k in _MAP_KEYS}
    for s in range(0, n + n_pad, chunk):
        out = model.render_rays(
            rays_o[s : s + chunk], rays_d[s : s + chunk], train=False,
            viewdirs=viewdirs[s : s + chunk], occ_grid=occ_grid,
        )
        for k in _MAP_KEYS:
            parts[k].append(out[k])
    maps = {k: torch.cat(v)[:n] for k, v in parts.items()}
    return {
        "rgb_map": maps["rgb_map"].reshape(H, W, 3),
        "disp_map": maps["disp_map"].reshape(H, W),
        "acc_map": maps["acc_map"].reshape(H, W),
        "depth_map": maps["depth_map"].reshape(H, W),
    }


def to8b(rgb) -> np.ndarray:
    """[..., 3] floats in [0, 1] -> uint8, as the JAX package's frames."""
    rgb = rgb.detach().cpu().numpy() if isinstance(rgb, torch.Tensor) else np.asarray(rgb)
    return (np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)


def render_orbit(
    model: "NeRFModel",
    H: int,
    W: int,
    K,
    poses: np.ndarray,
    chunk: Optional[int] = None,
    occ_grid: Optional[torch.Tensor] = None,
) -> Iterator[np.ndarray]:
    """Render a pose path; yields uint8 [H, W, 3] frames."""
    for c2w in poses:
        out = render_image(model, H, W, K, np.asarray(c2w)[:3, :4], chunk, occ_grid)
        yield to8b(out["rgb_map"])
