"""Real spherical-harmonics direction encoding, degrees 0..4.

Counterpart of ``nerf_meets_mlx_tpu/encoding/spherical_harmonics.py``: the
same constants and the same order of terms, stacked on the last axis. It
has no parameters.
"""

from __future__ import annotations

import dataclasses

import torch


def sh_encode(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """The real SH basis of unit vectors ``dirs`` [..., 3]: [..., (degree+1)²]."""
    if not 0 <= degree <= 4:
        raise ValueError(f"degree must be in [0, 4], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z

    comps = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 1:
        comps += [
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
        ]
    if degree >= 2:
        comps += [
            1.0925484305920792 * xy,
            1.0925484305920792 * yz,
            0.9461746957575601 * zz - 0.31539156525252,
            1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
        ]
    if degree >= 3:
        comps += [
            0.5900435899266435 * y * (3 * xx - yy),
            2.890611442640554 * xy * z,
            0.4570457994644658 * y * (5 * zz - 1),
            0.3731763325901154 * z * (5 * zz - 3),
            0.4570457994644658 * x * (5 * zz - 1),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3 * yy),
        ]
    if degree >= 4:
        comps += [
            2.5033429417967046 * xy * (xx - yy),
            1.7701307697799304 * yz * (3 * xx - yy),
            0.9461746957575601 * xy * (7 * zz - 1),
            0.6690465435572892 * yz * (7 * zz - 3),
            0.10578554691520431 * (35 * zz * zz - 30 * zz + 3),
            0.6690465435572892 * xz * (7 * zz - 3),
            0.47308734787878004 * (xx - yy) * (7 * zz - 1),
            1.7701307697799304 * xz * (xx - 3 * yy),
            0.6258357354491761 * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)


@dataclasses.dataclass(frozen=True)
class SphericalHarmonicsEncoding:
    in_dim: int
    degree: int = 4

    @property
    def out_dim(self) -> int:
        return (self.degree + 1) ** 2

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return sh_encode(x, self.degree)
