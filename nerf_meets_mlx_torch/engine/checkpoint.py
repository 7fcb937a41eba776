"""Checkpoint save/restore with ``torch.save``.

Counterpart of ``nerf_meets_mlx_tpu/engine/checkpoint.py`` with the same
``<ckpt_dir>/step_XXXXXXXX`` naming: each step is a directory holding
``state.pt`` with the step, the model's parameters (the MLPs and, for a
hash-grid model, its [L, T, F] tables, for a CP-grid model its per-level
[3, R_l, C] lines) and, for a training checkpoint, the optimizer's state
(Adam moments and counts, the encoding's included) and the
train step's random-generator state, so a resumed run continues where it
stopped, and the learned occupancy grid when the config has one.
``render_only`` reads the parameters alone. Orbax checkpoints of
the JAX package are not read here; they cross over as numpy through
``interop.params_from_numpy``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

import torch
from torch import nn

_STATE = "state.pt"


def _ckpt_path(ckpt_dir: str | Path, step: int) -> Path:
    return Path(ckpt_dir).absolute() / f"step_{step:08d}"


def _to_cpu(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def save_checkpoint(
    ckpt_dir: str | Path,
    model: nn.Module,
    step: int,
    optimizer: Optional[torch.optim.Optimizer] = None,
    generator: Optional[torch.Generator] = None,
    occ_grid: Optional[torch.Tensor] = None,
) -> Path:
    path = _ckpt_path(ckpt_dir, step)
    path.mkdir(parents=True, exist_ok=True)
    state = {"step": step, "params": _to_cpu(model.state_dict())}
    if optimizer is not None:
        state["optimizer"] = _to_cpu(optimizer.state_dict())
    if generator is not None:
        state["rng"] = generator.get_state()
    if occ_grid is not None:
        state["occ_grid"] = _to_cpu(occ_grid)
    tmp = path / f"{_STATE}.tmp"
    torch.save(state, tmp)
    tmp.replace(path / _STATE)
    return path


def restore_checkpoint(
    ckpt_dir: str | Path,
    model: nn.Module,
    step: int,
    optimizer: Optional[torch.optim.Optimizer] = None,
    generator: Optional[torch.Generator] = None,
    occ_grid: Optional[torch.Tensor] = None,
) -> int:
    """Load the parameters of ``step`` into ``model`` (shapes must match;
    they are copied onto the device the parameters live on) and, when given
    and saved, the optimizer's and the generator's state. ``occ_grid`` (the
    caller's grid, given when its config has ``render.occupancy`` on) is
    filled in place from the checkpoint's grid; a checkpoint without one
    raises then. Returns the step the checkpoint was saved at."""
    state = torch.load(_ckpt_path(ckpt_dir, step) / _STATE, weights_only=True)
    model.load_state_dict(state["params"])
    if optimizer is not None:
        if "optimizer" not in state:
            raise ValueError(f"checkpoint step {step} holds no optimizer state")
        optimizer.load_state_dict(state["optimizer"])
    if generator is not None and "rng" in state:
        generator.set_state(state["rng"])
    if occ_grid is not None:
        if "occ_grid" not in state:
            raise ValueError(
                f"checkpoint step {step} holds no occupancy grid, and the config uses one"
            )
        with torch.no_grad():
            occ_grid.copy_(state["occ_grid"])
    return int(state["step"])


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
