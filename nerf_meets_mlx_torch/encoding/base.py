"""Encoding abstraction (counterpart of ``nerf_meets_mlx_tpu/encoding/base.py``).

An encoding exposes ``out_dim`` and ``apply(x)``. The sinusoidal, identity
and spherical-harmonics kinds hold no parameters; the hash grid is an
``nn.Module`` whose one parameter is its [L, T, F] tables, so a model that
holds it as a submodule carries the tables in ``parameters()`` and the
checkpoint. The CP grid comes with a later slice of the port.
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
        raise NotImplementedError(
            f"encoding kind {cfg.kind!r} is not ported yet (ROADMAP.md Queue 1)"
        )
    raise ValueError(f"unknown encoding kind: {cfg.kind}")
