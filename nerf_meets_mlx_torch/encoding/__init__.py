from nerf_meets_mlx_torch.encoding.base import Encoding, make_encoding
from nerf_meets_mlx_torch.encoding.sinusoidal import (
    SinusoidalEncoding,
    frequency_bands,
    sinusoidal_encode,
)
from nerf_meets_mlx_torch.encoding.identity import IdentityEncoding

__all__ = [
    "Encoding",
    "make_encoding",
    "SinusoidalEncoding",
    "frequency_bands",
    "sinusoidal_encode",
    "IdentityEncoding",
]
