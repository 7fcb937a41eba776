"""The NeRF MLP as an ``nn.Module``.

Counterpart of ``nerf_meets_mlx_tpu/models/nerf_mlp.py``:

* D dense layers of width W on the encoded position, ReLU activations,
  with the encoded input concatenated (input-first) after every layer index
  in ``skips``;
* view-dependent head: alpha (W->1) + feature (W->W), concat encoded
  viewdir, one W/2 hidden layer, rgb (W/2->3); output is [rgb, alpha];
* non-viewdir head: a single output projection.

No activation is applied to rgb or alpha at the output — the compositor
(rendering/volume.py) owns the activation policy.

Parameters live in ``nn.Linear`` modules, whose ``weight`` is the JAX
pytree's ``w`` transposed ([fan_out, fan_in]); ``interop.py`` carries them
across. ``compute_dtype="bfloat16"`` casts the matmul operands and keeps
the sums and outputs in float32, as the JAX path does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nerf_meets_mlx_torch.config import MLPConfig


def _linear(fan_in: int, fan_out: int, device) -> nn.Linear:
    # storage only: NeRFMLP.init fills every parameter from a generator
    return nn.Linear(fan_in, fan_out, device="meta").to_empty(
        device="cpu" if device is None else device
    )


class NeRFMLP(nn.Module):
    def __init__(
        self,
        cfg: MLPConfig,
        in_dim: int,
        in_dim_views: int = 0,
        device=None,
    ):
        super().__init__()
        self.cfg = cfg
        self.in_dim = in_dim
        self.in_dim_views = in_dim_views
        D, W = cfg.net_depth, cfg.net_width
        fans = []
        for idx in range(D):
            if idx == 0:
                fans.append(in_dim)
            elif (idx - 1) in cfg.skips:
                fans.append(W + in_dim)
            else:
                fans.append(W)
        self.pos_linears = nn.ModuleList([_linear(f, W, device) for f in fans])
        if cfg.use_viewdirs:
            self.alpha_linear = _linear(W, 1, device)
            self.feature_linear = _linear(W, W, device)
            self.dir_linear = _linear(W + in_dim_views, W // 2, device)
            self.rgb_linear = _linear(W // 2, 3, device)
        else:
            self.output_linear = _linear(W, cfg.out_channels, device)

    def linears(self):
        """(name, nn.Linear) in the JAX pytree's order (``init_nerf_mlp``)."""
        out = [(f"pos_linears.{i}", lin) for i, lin in enumerate(self.pos_linears)]
        if self.cfg.use_viewdirs:
            out += [
                ("alpha_linear", self.alpha_linear),
                ("feature_linear", self.feature_linear),
                ("dir_linear", self.dir_linear),
                ("rgb_linear", self.rgb_linear),
            ]
        else:
            out.append(("output_linear", self.output_linear))
        return out

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "NeRFMLP":
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for W and b, drawn from
        ``generator`` (on its own device) and copied into the parameters, so
        one seed gives the same weights on every device."""
        for _, lin in self.linears():
            bound = 1.0 / math.sqrt(lin.in_features)
            for p in (lin.weight, lin.bias):
                u = torch.rand(p.shape, generator=generator, device=generator.device)
                p.copy_((u * 2.0 - 1.0) * bound)
        return self

    def _dense(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.compute_dtype == "bfloat16":
            y = x.to(torch.bfloat16) @ lin.weight.to(torch.bfloat16).t()
            return y.float() + lin.bias
        return x @ lin.weight.t() + lin.bias

    def forward(
        self, x_pos: torch.Tensor, x_dir: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Raw [..., 4] ([rgb, alpha], un-activated), or [..., out_channels]
        for the non-viewdir head."""
        lead = x_pos.shape[:-1]
        x_pos = x_pos.reshape(-1, x_pos.shape[-1])
        h = x_pos
        for idx, lin in enumerate(self.pos_linears):
            h = torch.relu(self._dense(lin, h))
            if idx in self.cfg.skips:
                h = torch.cat([x_pos, h], dim=-1)  # input-first
        if self.cfg.use_viewdirs:
            if x_dir is None:
                raise ValueError("use_viewdirs=True requires encoded viewdirs")
            x_dir = x_dir.reshape(-1, x_dir.shape[-1])
            alpha = self._dense(self.alpha_linear, h)
            feature = self._dense(self.feature_linear, h)
            h = torch.relu(self._dense(self.dir_linear, torch.cat([feature, x_dir], dim=-1)))
            out = torch.cat([self._dense(self.rgb_linear, h), alpha], dim=-1)
        else:
            out = self._dense(self.output_linear, h)
        return out.reshape(*lead, out.shape[-1])
