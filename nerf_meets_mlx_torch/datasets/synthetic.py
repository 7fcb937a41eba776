"""Procedural Blender-format scene generator on tensors.

Counterpart of ``nerf_meets_mlx_tpu/datasets/synthetic.py``: an analytic
emission-absorption volume — the smooth Gaussian "blobs" scene or the
"hard" scene (sharp CSG solids, occlusion, high-frequency texture) —
rendered to ground-truth images by a dense ray march on the device. The
poses come from the same numpy generator as in the JAX package, so a seed
gives both packages the same cameras. Writing the scene out as PNGs needs
``imageio`` and comes with the Blender loader in a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_meets_mlx_torch.cameras.pose import orbit_poses, pose_spherical
from nerf_meets_mlx_torch.cameras.rays import get_rays
from nerf_meets_mlx_torch.datasets.blender import BlenderDataset
from nerf_meets_mlx_torch.utils.tensors import linspace, resolve_device

# blob scene: centers [K,3], radii [K], colors [K,3], peak densities [K]
_BLOBS = dict(
    centers=np.array(
        [
            [0.0, 0.0, 0.0],
            [0.55, 0.0, 0.25],
            [-0.45, 0.35, -0.2],
            [0.0, -0.55, 0.3],
            [-0.2, -0.15, 0.55],
        ],
        np.float32,
    ),
    radii=np.array([0.38, 0.22, 0.25, 0.2, 0.16], np.float32),
    colors=np.array(
        [
            [0.9, 0.25, 0.2],
            [0.2, 0.7, 0.95],
            [0.95, 0.85, 0.2],
            [0.3, 0.85, 0.35],
            [0.7, 0.3, 0.85],
        ],
        np.float32,
    ),
    densities=np.array([28.0, 40.0, 35.0, 38.0, 45.0], np.float32),
)

CAMERA_ANGLE_X = 0.6911112070083618  # lego's fov


def scene_density_color_blobs(pts: torch.Tensor):
    """Analytic sigma(x) [...] and color(x) [..., 3] of the blob scene."""
    dev = pts.device
    c = torch.as_tensor(_BLOBS["centers"], device=dev)
    r = torch.as_tensor(_BLOBS["radii"], device=dev)
    col = torch.as_tensor(_BLOBS["colors"], device=dev)
    den = torch.as_tensor(_BLOBS["densities"], device=dev)
    d2 = torch.sum((pts[..., None, :] - c) ** 2, dim=-1)  # [..., K]
    g = den * torch.exp(-0.5 * d2 / (r**2))
    sigma = torch.sum(g, dim=-1)
    color = torch.sum(g[..., None] * col, dim=-2) / (sigma[..., None] + 1e-8)
    return sigma, torch.clamp(color, 0.0, 1.0)


_HARD_ROT = 0.5235987755982988  # 30 deg: center cube misaligned with axes


def _hard_pieces(pts: torch.Tensor):
    """Per-piece (indicator, color) of the hard scene. pts [..., 3]."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    co, si = float(np.cos(_HARD_ROT)), float(np.sin(_HARD_ROT))
    pieces = []

    # 1. central cube, rotated 30 deg about z, half-size 0.45, 3-D checker
    xr = co * x + si * y
    yr = -si * x + co * y
    inside_cube = (xr.abs() <= 0.45) & (yr.abs() <= 0.45) & (z.abs() <= 0.45)
    checker = torch.remainder(
        torch.floor(xr / 0.12) + torch.floor(yr / 0.12) + torch.floor(z / 0.12), 2.0
    )
    cube_col = torch.stack(
        [0.95 - 0.75 * checker, 0.45 - 0.25 * checker, 0.15 + 0.65 * checker], dim=-1
    )
    pieces.append((inside_cube, cube_col))

    # 2. ground slab with fine stripes along x (period 0.08)
    inside_slab = (x.abs() <= 1.1) & (y.abs() <= 1.1) & (z >= -0.75) & (z <= -0.62)
    stripe = torch.remainder(torch.floor(x / 0.08), 2.0)
    slab_col = torch.stack(
        [0.85 - 0.5 * stripe, 0.85 - 0.5 * stripe, 0.9 - 0.45 * stripe], dim=-1
    )
    pieces.append((inside_slab, slab_col))

    # 3. three solid pillars around the cube (strong cross-view occlusion)
    for ang, col in (
        (0.4, (0.9, 0.2, 0.25)),
        (2.5, (0.2, 0.75, 0.3)),
        (4.6, (0.25, 0.4, 0.95)),
    ):
        cx, cy = float(0.85 * np.cos(ang)), float(0.85 * np.sin(ang))
        inside_p = (
            ((x - cx).abs() <= 0.1) & ((y - cy).abs() <= 0.1)
            & (z >= -0.62) & (z <= 0.55)
        )
        pieces.append(
            (inside_p, torch.tensor(col, dtype=torch.float32, device=pts.device).expand(pts.shape))
        )

    # 4. striped sphere floating above (thin occluder with hf texture)
    d2 = (x - 0.45) ** 2 + (y - 0.5) ** 2 + (z - 0.75) ** 2
    inside_s = d2 <= 0.28**2
    sphere_stripe = torch.remainder(torch.floor((x + y) / 0.07), 2.0)
    sph_col = torch.stack(
        [0.95 - 0.15 * sphere_stripe, 0.8 * sphere_stripe + 0.15, 0.2 + 0.1 * sphere_stripe],
        dim=-1,
    )
    pieces.append((inside_s, sph_col))
    return pieces


def scene_density_color_hard(pts: torch.Tensor):
    """sigma/color of the hard scene: solid interiors (sigma 90), hard
    edges, first-listed piece wins color where solids would overlap."""
    sigma = torch.zeros(pts.shape[:-1], dtype=torch.float32, device=pts.device)
    color = torch.zeros(pts.shape[:-1] + (3,), dtype=torch.float32, device=pts.device)
    claimed = torch.zeros(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    for ind, col in _hard_pieces(pts):
        take = ind & ~claimed
        sigma = torch.where(take, torch.full_like(sigma, 90.0), sigma)
        color = torch.where(take[..., None], col, color)
        claimed = claimed | ind
    return sigma, color


_SCENES = {"blobs": scene_density_color_blobs, "hard": scene_density_color_hard}


def _march_gt(rays_o, rays_d, n_samples: int = 256, scene: str = "blobs"):
    """Dense ray march of the analytic scene over a ray block [..., 3]:
    [..., 4] = (rgb, acc)."""
    near, far = 2.0, 6.0
    t = linspace(near, far, n_samples, device=rays_o.device)
    pts = rays_o[..., None, :] + t[:, None] * rays_d[..., None, :]
    sigma, color = _SCENES[scene](pts)
    delta = (far - near) / (n_samples - 1) * torch.linalg.vector_norm(
        rays_d, dim=-1, keepdim=True
    )
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.exp(
        torch.cat(
            [
                torch.zeros_like(alpha[..., :1]),
                torch.cumsum(torch.log(1.0 - alpha + 1e-10), dim=-1)[..., :-1],
            ],
            dim=-1,
        )
    )
    w = alpha * trans
    rgb = torch.sum(w[..., None] * color, dim=-2)
    acc = torch.sum(w, dim=-1, keepdim=True)
    return torch.cat([rgb, acc], dim=-1)


@torch.no_grad()
def render_gt_image(
    H: int, W: int, K, c2w, n_samples: int = 256, scene: str = "blobs", device=None
) -> np.ndarray:
    """Ground-truth RGBA render of the analytic scene (float32 in [0, 1]),
    marched in row slabs of at most ~32M points. The hard scene uses 512
    samples by default: its densities are step functions."""
    if scene == "hard" and n_samples == 256:
        n_samples = 512
    rays_o, rays_d = get_rays(H, W, K, c2w, device=resolve_device(device))
    rows = max(1, min(H, (32_000_000 // max(W * n_samples, 1)) or 1))
    outs = [
        _march_gt(rays_o[r0 : r0 + rows], rays_d[r0 : r0 + rows], n_samples, scene).cpu()
        for r0 in range(0, H, rows)
    ]
    return torch.cat(outs).numpy().astype(np.float32)


def _split_poses(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    thetas = rng.uniform(-180.0, 180.0, n)
    phis = rng.uniform(-60.0, -10.0, n)
    return np.stack([pose_spherical(t, p, 4.0) for t, p in zip(thetas, phis)])


def make_synthetic_scene(
    n_train: int = 20,
    n_val: int = 4,
    n_test: int = 4,
    resolution: int = 64,
    seed: int = 0,
    white_bkgd: bool = True,
    scene: str = "blobs",
    device=None,
) -> BlenderDataset:
    """An in-memory BlenderDataset of the analytic scene; the ground truth
    is marched on ``device`` (``cuda`` unless the caller names another)."""
    H = W = resolution
    focal = 0.5 * W / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)

    poses = np.concatenate(
        [_split_poses(n_train, seed), _split_poses(n_val, seed + 1), _split_poses(n_test, seed + 2)]
    )
    rgba = np.stack(
        [render_gt_image(H, W, K, p[:3, :4], scene=scene, device=device) for p in poses]
    )
    images = rgba[..., :3] + (1.0 - rgba[..., 3:]) if white_bkgd else rgba[..., :3]

    n = n_train + n_val + n_test
    return BlenderDataset(
        images=np.ascontiguousarray(images, np.float32),
        poses=poses,
        render_poses=orbit_poses(160),
        H=H,
        W=W,
        focal=float(focal),
        i_train=np.arange(n_train),
        i_val=np.arange(n_train, n_train + n_val),
        i_test=np.arange(n_train + n_val, n),
    )
