"""Instant-NGP multiresolution hash-grid encoding (Müller et al. 2022).

Counterpart of ``nerf_meets_mlx_tpu/encoding/hash_grid.py``. All L hash
tables live in one [L, T, F] parameter, ``tables``, so that ``parameters()``,
``state_dict()`` (the checkpoint) and ``.to()`` carry them. Per level l the
grid has N_l = floor(N_min · b^l) cells a side, b = exp((ln N_max − ln
N_min)/(L − 1)); the 8 corners floor / floor + 1 of a point's cell are
hashed with the Lehmer primes (1, 2654435761, 805459861) as

    h = ((ix·p0) ^ (iy·p1) ^ (iz·p2)) mod 2^32, masked to T − 1,

and the corner rows are blended by their trilinear weights.

``apply`` is the plain version of the hash encode (the CUDA kernels of
``kernels/hash_encode.py`` and ``kernels/fused_ingp_train.py`` are held
against it). It follows the JAX XLA ``apply`` term for term: divide by the
box size, clip to [0, 1], the corner bits c = bx | by<<1 | bz<<2, the
weight (wx·wy)·wz, corners summed in the order 0..7. Autograd through the
row gather gives the table gradient (a scatter-add).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# Lehmer-style hash primes, as the JAX package's
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _level_resolutions(n_levels: int, min_res: int, max_res: int) -> np.ndarray:
    """N_l per level as int32, computed in float64 numpy exactly as the JAX
    package does: floor(16·b^l) lies close to integers, and float32 would
    round some levels to another grid."""
    if n_levels > 1:
        b = np.exp((np.log(max_res) - np.log(min_res)) / (n_levels - 1))
    else:
        b = 1.0
    return np.floor(min_res * b ** np.arange(n_levels)).astype(np.int32)


def corner_hash(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor, table_size: int) -> torch.Tensor:
    """The table row of the integer grid corner (ix, iy, iz) (int64
    tensors): the products wrap mod 2^32 as uint32 arithmetic does, then the
    row is masked to the table size."""
    h = (ix * _PRIMES[0]) ^ (iy * _PRIMES[1]) ^ (iz * _PRIMES[2])
    return (h & _U32) & (table_size - 1)


class HashGridEncoding(nn.Module):
    def __init__(
        self,
        in_dim: int = 3,
        n_levels: int = 16,
        min_res: int = 16,
        max_res: int = 512,
        features_per_level: int = 2,
        log2_table_size: int = 19,
        init_scale: float = 1e-4,
        bbox_min: float = -1.5,
        bbox_max: float = 1.5,
        compute_dtype: str = "float32",
        device=None,
    ):
        super().__init__()
        if in_dim != 3:
            raise ValueError("the hash grid encodes 3-D points")
        self.in_dim = in_dim
        self.n_levels = n_levels
        self.min_res = min_res
        self.max_res = max_res
        self.features_per_level = features_per_level
        self.log2_table_size = log2_table_size
        self.init_scale = init_scale
        self.bbox_min = bbox_min
        self.bbox_max = bbox_max
        # the JAX package's GEMM operand dtype for its Pallas fast path; the
        # plain version always reads the tables in float32
        self.compute_dtype = compute_dtype
        # storage only: init(generator) or a checkpoint fills it
        self.tables = nn.Parameter(torch.empty(
            (n_levels, self.table_size, features_per_level), dtype=torch.float32,
            device="cpu" if device is None else device,
        ))

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.features_per_level

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def resolutions(self) -> np.ndarray:
        return _level_resolutions(self.n_levels, self.min_res, self.max_res)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "HashGridEncoding":
        """U(-init_scale, init_scale), drawn from ``generator`` (on its own
        device) and copied into the tables."""
        u = torch.rand(self.tables.shape, generator=generator, device=generator.device)
        self.tables.copy_((u * 2.0 - 1.0) * self.init_scale)
        return self

    def corners(self, x: torch.Tensor):
        """The 8 cell corners of points ``x`` [N, 3] at every level, in the
        order c = bx | by<<1 | bz<<2: a list of (rows [N, L] int64, trilinear
        weights [N, L]), as ``apply`` blends them."""
        # a true division: PyTorch's CUDA division by a host scalar multiplies
        # by its reciprocal, which rounds some points into another cell
        brange = torch.tensor(self.bbox_max - self.bbox_min, dtype=torch.float32, device=x.device)
        u = torch.clamp((x - self.bbox_min) / brange, 0.0, 1.0)
        res = torch.as_tensor(self.resolutions, dtype=torch.float32, device=x.device)
        scaled = u[:, None, :] * res[None, :, None]          # [N, L, 3]
        floor = torch.floor(scaled)
        frac = scaled - floor
        base = floor.to(torch.int64)
        fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
        out = []
        for c in range(8):
            bx, by, bz = c & 1, (c >> 1) & 1, (c >> 2) & 1
            h = corner_hash(base[..., 0] + bx, base[..., 1] + by, base[..., 2] + bz,
                            self.table_size)
            w = (fx if bx else 1.0 - fx) * (fy if by else 1.0 - fy) * (fz if bz else 1.0 - fz)
            out.append((h, w))
        return out

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Encode world positions [..., 3] -> [..., L·F], feature l·F + f.
        (The encodings' ``apply``; it stands in for ``nn.Module.apply``,
        which nothing in the port calls.)"""
        tables = self.tables
        lead = x.shape[:-1]
        x = x.reshape(-1, 3)
        level = torch.arange(self.n_levels, device=x.device)[None, :]
        feats = torch.zeros(
            (x.shape[0], self.n_levels, self.features_per_level), dtype=torch.float32,
            device=x.device,
        )
        for h, w in self.corners(x):
            feats = feats + tables[level, h] * w[..., None]     # [N, L, F]
        return feats.reshape(*lead, self.out_dim)
