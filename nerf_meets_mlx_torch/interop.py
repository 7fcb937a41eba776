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
packages alike. A hash-grid position encoding carries its tables as
``tree["pos_enc"]["tables"]`` [L, T, F] (the canonical JAX leaf, not the
TPU-packed [L, T/128, F·128] layout) into ``HashGridEncoding.tables``, and
a CP-grid position encoding its per-level lines as
``tree["pos_enc"]["lines"]``, a list of [3, R_l, C] arrays, into
``CPGridEncoding.lines``; the parameter-free encodings' entries are empty,
as ``dir_enc`` always is. The
learned occupancy grid crosses as a numpy [R, R, R] array
(``occ_grid_from_numpy`` / ``occ_grid_to_numpy``).
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


def _pos_enc_from_numpy(pos: Dict[str, Any], enc) -> None:
    tables = getattr(enc, "tables", None)
    lines = getattr(enc, "lines", None)
    want = {"tables"} if tables is not None else {"lines"} if lines is not None else set()
    if set(pos) != want:
        raise ValueError(
            f"pos_enc holds {sorted(pos)}, the model's position encoding wants {sorted(want)}"
        )
    if tables is not None:
        t = torch.from_numpy(np.array(pos["tables"], np.float32))
        if tuple(t.shape) != tuple(tables.shape):
            raise ValueError(f"tables are {tuple(t.shape)}, the model wants {tuple(tables.shape)}")
        with torch.no_grad():
            tables.copy_(t)
    if lines is not None:
        if len(pos["lines"]) != len(lines):
            raise ValueError(
                f"pos_enc holds {len(pos['lines'])} CP levels, the model wants {len(lines)}"
            )
        for li, (src, dst) in enumerate(zip(pos["lines"], lines)):
            t = torch.from_numpy(np.array(src, np.float32))
            if tuple(t.shape) != tuple(dst.shape):
                raise ValueError(
                    f"CP level {li} lines are {tuple(t.shape)}, the model wants {tuple(dst.shape)}"
                )
            with torch.no_grad():
                dst.copy_(t)


def params_from_numpy(tree: Dict[str, Any], model) -> Any:
    """Load a JAX params pytree (numpy leaves) into a port ``NeRFModel``;
    returns the model."""
    if tree.get("dir_enc"):
        raise ValueError("the port's direction encodings have no parameters")
    _pos_enc_from_numpy(tree.get("pos_enc") or {}, model.pos_enc)
    _mlp_from_numpy(tree["coarse"], model.coarse)
    if model.fine is not None:
        _mlp_from_numpy(tree["fine"], model.fine)
    return model


def _pos_enc_to_numpy(enc) -> Dict[str, Any]:
    tables = getattr(enc, "tables", None)
    if tables is not None:
        return {"tables": tables.detach().cpu().numpy().copy()}
    lines = getattr(enc, "lines", None)
    if lines is not None:
        return {"lines": [p.detach().cpu().numpy().copy() for p in lines]}
    return {}


def params_to_numpy(model) -> Dict[str, Any]:
    """The inverse of ``params_from_numpy``: the JAX pytree as numpy."""
    tree: Dict[str, Any] = {
        "coarse": _mlp_to_numpy(model.coarse),
        "pos_enc": _pos_enc_to_numpy(model.pos_enc),
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
