"""Checkpoint save/restore with ``torch.save``.

Counterpart of ``nerf_meets_mlx_tpu/engine/checkpoint.py`` with the same
``<ckpt_dir>/step_XXXXXXXX`` naming: each step is a directory holding
``state.pt`` — the model's parameters (and, once the trainer is ported, its
optimizer state). Orbax checkpoints of the JAX package are not read here;
they cross over as numpy through ``interop.params_from_numpy``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch
from torch import nn

_STATE = "state.pt"


def _ckpt_path(ckpt_dir: str | Path, step: int) -> Path:
    return Path(ckpt_dir).absolute() / f"step_{step:08d}"


def save_checkpoint(ckpt_dir: str | Path, model: nn.Module, step: int) -> Path:
    path = _ckpt_path(ckpt_dir, step)
    path.mkdir(parents=True, exist_ok=True)
    state = {"step": step, "params": {k: v.cpu() for k, v in model.state_dict().items()}}
    torch.save(state, path / _STATE)
    return path


def restore_checkpoint(ckpt_dir: str | Path, model: nn.Module, step: int) -> nn.Module:
    """Load the parameters of ``step`` into ``model`` (shapes must match);
    they are copied onto the device the model's parameters live on."""
    state = torch.load(_ckpt_path(ckpt_dir, step) / _STATE, weights_only=True)
    model.load_state_dict(state["params"])
    return model


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.is_dir():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in d.iterdir()
        if p.name.startswith("step_") and p.is_dir()
    ]
    return max(steps) if steps else None
