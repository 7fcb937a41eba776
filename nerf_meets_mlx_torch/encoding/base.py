"""Encoding abstraction (counterpart of ``nerf_meets_mlx_tpu/encoding/base.py``).

An encoding exposes ``out_dim`` and ``apply(x)``. The sinusoidal, identity
and spherical-harmonics kinds hold no parameters; the hash grid (its
[L, T, F] tables) and the CP grid (its per-level [3, R_l, C] lines) are
``nn.Module``s, so a model that holds one as a submodule carries its
parameters in ``parameters()`` and the checkpoint.
"""

from __future__ import annotations

from typing import Protocol

import torch

from nerf_meets_mlx_torch.config import EncodingConfig


class Encoding(Protocol):
    out_dim: int

    def apply(self, x: torch.Tensor) -> torch.Tensor: ...


def make_encoding(cfg: EncodingConfig, device=None) -> "Encoding":
    """Build an encoding from config (dispatch on ``cfg.kind``); learned
    encodings allocate their parameters on ``device`` (not filled)."""
    from nerf_meets_mlx_torch.encoding.identity import IdentityEncoding
    from nerf_meets_mlx_torch.encoding.sinusoidal import SinusoidalEncoding

    if cfg.kind == "identity":
        return IdentityEncoding(cfg.in_dim)
    if cfg.kind == "sinusoidal":
        return SinusoidalEncoding(
            in_dim=cfg.in_dim,
            n_freqs=cfg.n_freqs,
            min_freq_exp=cfg.min_freq_exp,
            max_freq_exp=cfg.max_freq_exp,
            include_input=cfg.include_input,
            band_mode=cfg.frequency_bands,
        )
    if cfg.kind == "spherical_harmonics":
        from nerf_meets_mlx_torch.encoding.spherical_harmonics import (
            SphericalHarmonicsEncoding,
        )

        return SphericalHarmonicsEncoding(cfg.in_dim, cfg.sh_degree)
    if cfg.kind == "hash_grid":
        from nerf_meets_mlx_torch.encoding.hash_grid import HashGridEncoding

        return HashGridEncoding(
            in_dim=cfg.in_dim,
            n_levels=cfg.hash_n_levels,
            min_res=cfg.hash_min_res,
            max_res=cfg.hash_max_res,
            features_per_level=cfg.hash_features_per_level,
            log2_table_size=cfg.hash_log2_table_size,
            init_scale=cfg.hash_init_scale,
            compute_dtype=cfg.hash_compute_dtype,
            device=device,
        )
    if cfg.kind == "cp_grid":
        from nerf_meets_mlx_torch.encoding.cp_grid import CPGridEncoding

        # no compute_dtype: the CP grid interpolates in bf16, as in JAX
        return CPGridEncoding(
            in_dim=cfg.in_dim,
            n_levels=cfg.cp_n_levels,
            min_res=cfg.cp_min_res,
            max_res=cfg.cp_max_res,
            n_components=cfg.cp_n_components,
            init_scale=cfg.cp_init_scale,
            device=device,
        )
    raise ValueError(f"unknown encoding kind: {cfg.kind}")
