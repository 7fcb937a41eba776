"""Train state and optimizer.

Counterpart of ``nerf_meets_mlx_tpu/engine/train_state.py``: one Adam over
every parameter of the model (coarse and fine MLPs), per-parameter moments,
and the learning-rate schedule

    lr(count) = lrate · 0.1 ** (count / (lrate_decay · 1000))

(continuous decay, constant when ``lrate_decay <= 0``), evaluated at the
number of updates already applied, as optax's ``exponential_decay`` is:
the first update uses ``lrate``. ``torch.optim.Adam`` computes optax's
``adam`` (bias-corrected moments, eps 1e-8 outside the square root).

The JAX package's ``encoding_weight_decay`` is a decoupled decay on the
learned encoding parameters only (hash tables, CP lines), not scaled by the
lr, so it is not ``AdamW``. The port's encodings have no parameters yet,
so a non-zero value raises instead of decaying nothing.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nerf_meets_mlx_torch.config import TrainConfig

ADAM_EPS = 1e-8


def lr_at(cfg: TrainConfig, count: int) -> float:
    """The learning rate of the update that follows ``count`` updates."""
    if cfg.lrate_decay <= 0:
        return cfg.lrate
    return cfg.lrate * 0.1 ** (count / (cfg.lrate_decay * 1000))


class TrainState:
    """The model, its optimizer, the host-side count of applied updates
    (``step``) and the learned occupancy grid (``occ_grid``, None when
    ``render.occupancy`` is off). Parameters are updated in place."""

    def __init__(self, model: nn.Module, cfg: TrainConfig,
                 occ_grid: Optional[torch.Tensor] = None):
        if cfg.encoding_weight_decay > 0.0:
            raise ValueError(
                "encoding_weight_decay decays learned encoding parameters (hash "
                "tables, CP lines); this model's encodings have none"
            )
        self.model = model
        self.cfg = cfg
        self.step = 0
        self.occ_grid = occ_grid
        self.optimizer = torch.optim.Adam(
            model.parameters(), lr=lr_at(cfg, 0), betas=(cfg.adam_b1, cfg.adam_b2),
            eps=ADAM_EPS,
        )

    def apply_gradients(self) -> None:
        """One Adam update from the parameters' ``.grad``, at the scheduled
        lr; clears the gradients and advances ``step``."""
        lr = lr_at(self.cfg, self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
