"""Encoding abstraction (counterpart of ``nerf_meets_mlx_tpu/encoding/base.py``).

An encoding is a stateless object exposing ``out_dim`` and ``apply(x)``.
The sinusoidal and identity kinds hold no parameters; learned encodings
(hash grid, CP grid) and spherical harmonics come with later slices of the
port.
"""

from __future__ import annotations

from typing import Protocol

import torch

from nerf_meets_mlx_torch.config import EncodingConfig


class Encoding(Protocol):
    out_dim: int

    def apply(self, x: torch.Tensor) -> torch.Tensor: ...


def make_encoding(cfg: EncodingConfig) -> "Encoding":
    """Build an encoding from config (dispatch on ``cfg.kind``)."""
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
    if cfg.kind in ("spherical_harmonics", "hash_grid", "cp_grid"):
        raise NotImplementedError(
            f"encoding kind {cfg.kind!r} is not ported yet (ROADMAP.md Queue 1)"
        )
    raise ValueError(f"unknown encoding kind: {cfg.kind}")
