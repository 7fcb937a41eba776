"""Train state and optimizer.

Counterpart of ``nerf_meets_mlx_tpu/engine/train_state.py``: one Adam over
every parameter of the model (coarse and fine MLPs), per-parameter moments,
and the learning-rate schedule

    lr(count) = lrate · 0.1 ** (count / (lrate_decay · 1000))

(continuous decay, constant when ``lrate_decay <= 0``), evaluated at the
number of updates already applied, as optax's ``exponential_decay`` is:
the first update uses ``lrate``. ``torch.optim.Adam`` computes optax's
``adam`` (bias-corrected moments, eps 1e-8 outside the square root).

``encoding_weight_decay`` is the JAX package's
``optax.chain(adam, add_decayed_weights(-wd, mask=pos_enc))``: after the
Adam step, every parameter of the position encoding (the hash tables or the
CP lines; the MLPs are never decayed) loses ``wd`` times its value from before the
update, not scaled by the lr. So it is not ``torch.optim.AdamW``, whose
decay is lr-scaled. A model whose position encoding has no parameters has
nothing to decay, and a non-zero value raises there.
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
        pos_enc = getattr(model, "pos_enc", None)
        self.decayed = list(pos_enc.parameters()) if isinstance(pos_enc, nn.Module) else []
        if cfg.encoding_weight_decay > 0.0 and not self.decayed:
            raise ValueError(
                "encoding_weight_decay decays learned encoding parameters (hash "
                "tables, CP lines); this model's position encoding has none"
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
        lr, then the encoding weight decay on the position encoding's
        parameters (their values before the update); clears the gradients
        and advances ``step``."""
        lr = lr_at(self.cfg, self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        wd = self.cfg.encoding_weight_decay
        decay = [wd * p.detach() for p in self.decayed] if wd > 0.0 else []
        self.optimizer.step()
        with torch.no_grad():
            for p, d in zip(self.decayed, decay):
                p.sub_(d)
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
