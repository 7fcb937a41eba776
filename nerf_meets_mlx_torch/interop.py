"""Carries weights between the JAX package's params pytree and the port.

The JAX pytree (``nerf_meets_mlx_tpu/models/factory.py`` ``init`` and
``models/nerf_mlp.py`` ``init_nerf_mlp``) is

    {"coarse": mlp, "fine": mlp, "pos_enc": {}, "dir_enc": {}}
    mlp = {"pos_linears": [{"w": [fan_in, fan_out], "b": [fan_out]}, ...],
           "alpha_linear": ..., "feature_linear": ..., "dir_linear": ...,
           "rgb_linear": ...}              # or "output_linear"

as numpy arrays. ``nn.Linear.weight`` is ``w.T``. The concatenations keep
their order: the skip layer's input is [encoded position, h] and the
direction layer's is [feature, encoded direction], so the first rows of
those ``w`` belong to the encoding and the feature respectively, in both
packages alike. Only parameter-free encodings exist in this slice, so
``pos_enc`` and ``dir_enc`` are empty. The learned occupancy grid crosses
as a numpy [R, R, R] array (``occ_grid_from_numpy`` / ``occ_grid_to_numpy``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nerf_meets_mlx_torch.models.nerf_mlp import NeRFMLP


def _mlp_from_numpy(tree: Dict[str, Any], mlp: NeRFMLP) -> None:
    for name, lin in mlp.linears():
        if name.startswith("pos_linears."):
            p = tree["pos_linears"][int(name.split(".")[1])]
        else:
            p = tree[name]
        w = torch.from_numpy(np.array(p["w"], np.float32))
        b = torch.from_numpy(np.array(p["b"], np.float32))
        if tuple(w.shape) != (lin.in_features, lin.out_features):
            raise ValueError(
                f"{name}: w is {tuple(w.shape)}, the model wants "
                f"{(lin.in_features, lin.out_features)}"
            )
        with torch.no_grad():
            lin.weight.copy_(w.t())
            lin.bias.copy_(b)


def _mlp_to_numpy(mlp: NeRFMLP) -> Dict[str, Any]:
    out: Dict[str, Any] = {"pos_linears": []}
    for name, lin in mlp.linears():
        p = {
            "w": lin.weight.detach().t().cpu().numpy().copy(),
            "b": lin.bias.detach().cpu().numpy().copy(),
        }
        if name.startswith("pos_linears."):
            out["pos_linears"].append(p)
        else:
            out[name] = p
    return out


def params_from_numpy(tree: Dict[str, Any], model) -> Any:
    """Load a JAX params pytree (numpy leaves) into a port ``NeRFModel``;
    returns the model."""
    for enc in ("pos_enc", "dir_enc"):
        if tree.get(enc):
            raise NotImplementedError(f"learned {enc} parameters are not ported yet")
    _mlp_from_numpy(tree["coarse"], model.coarse)
    if model.fine is not None:
        _mlp_from_numpy(tree["fine"], model.fine)
    return model


def params_to_numpy(model) -> Dict[str, Any]:
    """The inverse of ``params_from_numpy``: the JAX pytree as numpy."""
    tree: Dict[str, Any] = {
        "coarse": _mlp_to_numpy(model.coarse),
        "pos_enc": {},
        "dir_enc": {},
    }
    if model.fine is not None:
        tree["fine"] = _mlp_to_numpy(model.fine)
    return tree


def occ_grid_from_numpy(grid, device=None) -> torch.Tensor:
    """A JAX occupancy grid ([R, R, R] density, same (i, j, k) cell order in
    both packages) as a float32 tensor on ``device``."""
    a = np.asarray(grid, np.float32)
    if a.ndim != 3 or len(set(a.shape)) != 1:
        raise ValueError(f"an occupancy grid is [R, R, R], not {a.shape}")
    return torch.tensor(a, device=device)


def occ_grid_to_numpy(grid: torch.Tensor) -> np.ndarray:
    """The inverse of ``occ_grid_from_numpy``."""
    return grid.detach().cpu().numpy().copy()
