"""Learned occupancy grid: per-ray [near, far] tightening beyond the static
scene AABB.

Counterpart of ``nerf_meets_mlx_tpu/acceleration/occupancy.py``. A density
grid over the AABB is EMA-max updated from the network (one jittered point
per cell, Instant-NGP's rule) every ``occ_update_every`` train steps; each
ray probes it at ``n_probes`` points and shrinks its interval to bracket the
first and last occupied probe. Shapes stay static: only the interval moves,
never the sample count. Rays with no occupied probe, and every ray while the
warmup gate is off, keep their incoming interval.

The cell jitter ``u`` [R³, 3] may be injected, so that a test can feed both
packages the same numbers; otherwise it is drawn from a ``torch.Generator``.
The grid's density forward runs through ``model.query``, which on CUDA is
the fused MLP kernel (``kernels/fused_mlp.py``) when the model routes there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nerf_meets_mlx_torch.rendering.volume import softplus


def init_occupancy_grid(resolution: int, device=None) -> torch.Tensor:
    """Empty float density grid [R, R, R]."""
    return torch.zeros((resolution,) * 3, dtype=torch.float32, device=device)


def _cell_points(
    resolution: int,
    lo: torch.Tensor,
    hi: torch.Tensor,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """One uniformly-jittered point per grid cell, [R³, 3], cells in (i, j,
    k) row-major order; ``u`` [R³, 3] in [0, 1) is the jitter (drawn from
    ``generator`` when not given)."""
    r = resolution
    dev = lo.device
    ar = torch.arange(r, device=dev)
    ii = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1).reshape(-1, 3)
    if u is None:
        u = torch.rand(ii.shape, generator=generator, dtype=torch.float32, device=dev)
    u = (ii.to(torch.float32) + u.to(device=dev, dtype=torch.float32)) / r
    return lo + u * (hi - lo)


@torch.no_grad()
def update_occupancy_grid(
    model,
    grid: torch.Tensor,
    decay: float = 0.95,
    u: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> torch.Tensor:
    """grid <- max(grid · decay, sigma(one jittered point per cell)), as a
    new tensor. The density comes from the finest network with the
    configured activation (relu in reference mode or with
    density_activation="relu", else softplus), at zero view directions."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded grid update comes with the parallel/ slice (ROADMAP.md Queue 1)"
        )
    rcfg = model.cfg.render
    if rcfg.aabb is None:
        raise ValueError("the occupancy grid requires render.aabb")
    dev = grid.device
    lo = torch.tensor(rcfg.aabb[:3], dtype=torch.float32, device=dev)
    hi = torch.tensor(rcfg.aabb[3:], dtype=torch.float32, device=dev)
    r = grid.shape[0]
    pts = _cell_points(r, lo, hi, u, generator)[:, None, :]           # [R³, 1, 3]
    level = "fine" if model.fine is not None else "coarse"
    dirs = torch.zeros((pts.shape[0], 3), dtype=torch.float32, device=dev)
    raw_sigma = model.query(level, pts, dirs)[:, 0, 3]
    if rcfg.compositing == "reference" or rcfg.density_activation == "relu":
        sigma = torch.relu(raw_sigma)
    else:
        sigma = softplus(raw_sigma)
    return torch.maximum(grid * decay, sigma.reshape(grid.shape))


def occupancy_binary(grid: torch.Tensor, threshold: float) -> torch.Tensor:
    """Threshold, then a 3³ dilation (a ±1 shift-OR along each axis in
    turn): conservative boolean occupancy."""
    occ = grid > threshold
    for axis in range(3):
        n = occ.shape[axis]
        z = torch.zeros_like(occ.narrow(axis, 0, 1))
        up = torch.cat([occ.narrow(axis, 1, n - 1), z], dim=axis)
        dn = torch.cat([z, occ.narrow(axis, 0, n - 1)], dim=axis)
        occ = occ | up | dn
    return occ


def tighten_near_far(
    grid: torch.Tensor,
    rays_o: torch.Tensor,   # [B, 3]
    rays_d: torch.Tensor,   # [B, 3]
    near: torch.Tensor,     # [B, 1]
    far: torch.Tensor,      # [B, 1]
    aabb,                   # (x0, y0, z0, x1, y1, z1)
    threshold: float,
    n_probes: int,
    active: bool = True,    # the warmup gate, decided on the host
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe the grid at ``n_probes`` points per ray and shrink [near, far]
    to bracket the first and last occupied probe, one probe spacing of
    margin each side. The probe cells are computed in the JAX package's
    order of operations (float32, a truncating cast, then the clip)."""
    if not active:
        return near, far
    dev = rays_o.device
    lo = torch.tensor(aabb[:3], dtype=torch.float32, device=dev)
    hi = torch.tensor(aabb[3:], dtype=torch.float32, device=dev)
    r = grid.shape[0]

    frac = (torch.arange(n_probes, dtype=torch.float32, device=dev) + 0.5) / n_probes
    t = near + (far - near) * frac[None, :]                          # [B, P]
    pts = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]     # [B, P, 3]

    u = (pts - lo) / (hi - lo)
    inside = ((u >= 0.0) & (u < 1.0)).all(dim=-1)                   # [B, P]
    idx = torch.clamp((u * r).to(torch.int32), 0, r - 1).to(torch.int64)
    flat = (idx[..., 0] * r + idx[..., 1]) * r + idx[..., 2]

    occ = occupancy_binary(grid, threshold).reshape(-1)[flat] & inside

    i = torch.arange(n_probes, dtype=torch.int32, device=dev)
    first = torch.where(occ, i, n_probes).amin(dim=-1)
    last = torch.where(occ, i, -1).amax(dim=-1)
    any_occ = (last >= 0)[:, None]

    dt = (far - near) / n_probes
    t0 = near + torch.clamp_min(first[:, None] - 1, 0) * dt
    t1 = near + torch.clamp_max(last[:, None] + 2, n_probes) * dt

    return torch.where(any_occ, t0, near), torch.where(any_occ, t1, far)
