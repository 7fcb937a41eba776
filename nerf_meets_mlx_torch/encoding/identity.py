"""Pass-through encoding (counterpart of ``nerf_meets_mlx_tpu/encoding/identity.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class IdentityEncoding:
    in_dim: int

    @property
    def out_dim(self) -> int:
        return self.in_dim

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x
