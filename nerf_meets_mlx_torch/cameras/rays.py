"""Pinhole ray generation, AABB slab test and NDC reprojection on tensors.

Counterpart of ``nerf_meets_mlx_tpu/cameras/rays.py``. Conventions match
NeRF: the camera looks down -z, +x right, +y up; pixel (i, j) maps to the
camera-space direction ((i-cx)/fx, -(j-cy)/fy, -1). Rays are generated on
the device of ``K``/``c2w`` (or ``device``), never on the host.
"""

from __future__ import annotations

import torch


def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _rotate(dirs: torch.Tensor, c2w: torch.Tensor) -> torch.Tensor:
    """sum_k dirs[..., k] · R[:, k] in full fp32 (no TF32 on the card)."""
    R = c2w[:3, :3]
    return dirs[..., 0:1] * R[:, 0] + dirs[..., 1:2] * R[:, 1] + dirs[..., 2:3] * R[:, 2]


def get_rays(H: int, W: int, K, c2w, device=None):
    """World-space rays for every pixel of an H x W pinhole camera.

    Returns rays_o, rays_d, each [H, W, 3]. Directions are NOT normalized
    (the norm scales the delta distances in compositing)."""
    K = _as_f32(K, device)
    c2w = _as_f32(c2w, K.device)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=K.device),
        torch.arange(W, dtype=torch.float32, device=K.device),
        indexing="ij",
    )
    dirs = torch.stack(
        [(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1], -torch.ones_like(i)],
        dim=-1,
    )
    rays_d = _rotate(dirs, c2w)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_for_pixels(K, c2w, px, py, device=None):
    """Rays for a flat list of pixel coordinates: each [N, 3]."""
    K = _as_f32(K, device)
    c2w = _as_f32(c2w, K.device)
    px = _as_f32(px, K.device)
    py = _as_f32(py, K.device)
    dirs = torch.stack(
        [(px - K[0, 2]) / K[0, 0], -(py - K[1, 2]) / K[1, 1], -torch.ones_like(px)],
        dim=-1,
    )
    rays_d = _rotate(dirs, c2w)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def intersect_aabb(rays_o, rays_d, box_min, box_max, near, far, eps: float = 1e-6):
    """Per-ray slab intersection with a scene AABB: tightened [near, far],
    each [B, 1]. Rays that miss the box keep the original [near, far]."""
    dev = rays_o.device
    box_min = _as_f32(box_min, dev)
    box_max = _as_f32(box_max, dev)
    d = torch.where(
        rays_d.abs() < eps,
        torch.where(rays_d < 0, torch.full_like(rays_d, -eps), torch.full_like(rays_d, eps)),
        rays_d,
    )
    inv = 1.0 / d
    t0 = (box_min - rays_o) * inv
    t1 = (box_max - rays_o) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1, keepdim=True)
    tmax = torch.maximum(t0, t1).amin(dim=-1, keepdim=True)
    near = _as_f32(near, dev).expand(tmin.shape)
    far = _as_f32(far, dev).expand(tmax.shape)
    hit = tmax > torch.clamp_min(tmin, 0.0)
    near_t = torch.where(hit, torch.minimum(torch.maximum(tmin, near), far), near)
    far_t = torch.where(hit, torch.minimum(torch.maximum(tmax, near), far), far)
    return near_t, torch.maximum(far_t, near_t + eps)


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """Reproject rays into NDC space (NeRF appendix C, eqs. 25/26): shift
    origins to the z = -near plane, then apply the projective map."""
    t_n = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t_n[..., None] * rays_d

    o_x, o_y, o_z = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    d_x, d_y, d_z = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]

    o0 = (-focal / (0.5 * W)) * (o_x / o_z)
    o1 = (-focal / (0.5 * H)) * (o_y / o_z)
    o2 = 1.0 + 2.0 * near / o_z

    d0 = (-focal / (0.5 * W)) * (d_x / d_z - o_x / o_z)
    d1 = (-focal / (0.5 * H)) * (d_y / d_z - o_y / o_z)
    d2 = -2.0 * near / o_z

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)
