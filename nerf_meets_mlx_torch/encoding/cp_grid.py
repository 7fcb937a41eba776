"""CP-decomposed low-rank grid encoding (TensoRF-style, Chen et al. 2022).

Counterpart of ``nerf_meets_mlx_tpu/encoding/cp_grid.py``. Each of the L
levels stores three 1-D factor lines, one ``nn.Parameter`` [3, R_l, C] a
level (``lines``; separate leaves, as the levels' resolutions differ), and
a point's feature c at that level is the product of the three lines, each
linearly interpolated at the point's coordinate on its axis:

    u = clip((x − bbox_min) / (bbox_max − bbox_min), 0, 1)
    t = u · (R_l − 1)                          (align corners)
    f_a[c] = Σ_i relu(1 − |t_a − i|) · line_a[i, c]
    feat[l·C + c] = f_0[c] · f_1[c] · f_2[c]

``apply`` is the JAX package's XLA ``apply`` term for term. The hat matrix
has two non-zero taps a row, so it is computed as two gathered rows,
i0 = min(floor(t), R − 2) and i0 + 1, weighted by the same hat expressions.
With ``compute_dtype == "bfloat16"`` (the default, as in JAX) the weights
and the lines are rounded to bf16 and the products taken in fp32; a
bf16 × bf16 product is exact in fp32 and the zero taps add nothing, so the
two-tap sum equals JAX's bf16 GEMM with fp32 accumulation bit for bit.
Autograd through ``.to(bfloat16).float()`` rounds the line gradient to bf16
once, as JAX's transposed dot does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nerf_meets_mlx_torch.encoding.hash_grid import _level_resolutions
from nerf_meets_mlx_torch.utils.tensors import round_bf16


def two_taps(t: torch.Tensor, r: int):
    """The two non-zero hat taps of grid coordinates ``t`` (any shape) on a
    line of ``r`` nodes: (i0 int64, w0, w1) with i0 = min(floor(t), r − 2)
    and w_k = relu(1 − |t − (i0 + k)|), the XLA hat expression."""
    i0f = torch.clamp(torch.floor(t), max=float(r - 2))
    w0 = torch.relu(1.0 - torch.abs(t - i0f))
    w1 = torch.relu(1.0 - torch.abs(t - (i0f + 1.0)))
    return i0f.to(torch.int64), w0, w1


class CPGridEncoding(nn.Module):
    def __init__(
        self,
        in_dim: int = 3,
        n_levels: int = 4,
        min_res: int = 64,
        max_res: int = 512,
        n_components: int = 16,
        init_scale: float = 0.2,
        bbox_min: float = -1.5,
        bbox_max: float = 1.5,
        compute_dtype: str = "bfloat16",
        device=None,
    ):
        super().__init__()
        if in_dim != 3:
            raise ValueError("the CP grid encodes 3-D points")
        if compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype is bfloat16 or float32, not {compute_dtype!r}")
        self.in_dim = in_dim
        self.n_levels = n_levels
        self.min_res = min_res
        self.max_res = max_res
        self.n_components = n_components
        self.init_scale = init_scale
        self.bbox_min = bbox_min
        self.bbox_max = bbox_max
        self.compute_dtype = compute_dtype
        if int(self.resolutions.min()) < 2:
            raise ValueError("every CP level needs at least 2 nodes a line")
        # storage only: init(generator) or a checkpoint fills it
        self.lines = nn.ParameterList([
            nn.Parameter(torch.empty(
                (3, int(r), n_components), dtype=torch.float32,
                device="cpu" if device is None else device,
            ))
            for r in self.resolutions
        ])

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_components

    @property
    def resolutions(self) -> np.ndarray:
        return _level_resolutions(self.n_levels, self.min_res, self.max_res)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "CPGridEncoding":
        """init_scale · N(0, 1) for every level, drawn from ``generator`` (on
        its own device) in level order and copied into the lines."""
        for line in self.lines:
            z = torch.randn(line.shape, generator=generator, device=generator.device)
            line.copy_(z * self.init_scale)
        return self

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Encode world positions [..., 3] -> [..., L·C], feature l·C + c.
        (The encodings' ``apply``; it stands in for ``nn.Module.apply``,
        which nothing in the port calls.)"""
        lead = x.shape[:-1]
        x = x.reshape(-1, 3)
        # a true division, as the XLA apply divides (PyTorch's CUDA division
        # by a host scalar multiplies by its reciprocal)
        brange = torch.tensor(self.bbox_max - self.bbox_min, dtype=torch.float32, device=x.device)
        u = torch.clamp((x - self.bbox_min) / brange, 0.0, 1.0)
        bf16 = self.compute_dtype == "bfloat16"
        feats = []
        for r, lines in zip(self.resolutions, self.lines):
            r = int(r)
            i0, w0, w1 = two_taps(u * (r - 1), r)             # [N, 3] each
            level = None
            for a in range(3):
                line = round_bf16(lines[a]) if bf16 else lines[a]      # [R, C]
                wa0, wa1 = w0[:, a : a + 1], w1[:, a : a + 1]
                if bf16:
                    wa0, wa1 = round_bf16(wa0), round_bf16(wa1)
                f = wa0 * line[i0[:, a]] + wa1 * line[i0[:, a] + 1]  # [N, C]
                level = f if level is None else level * f
            feats.append(level)
        return torch.cat(feats, dim=-1).reshape(*lead, self.out_dim)
