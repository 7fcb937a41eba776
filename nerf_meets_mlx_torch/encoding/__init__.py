from nerf_meets_mlx_torch.encoding.base import Encoding, make_encoding
from nerf_meets_mlx_torch.encoding.sinusoidal import (
    SinusoidalEncoding,
    frequency_bands,
    sinusoidal_encode,
)
from nerf_meets_mlx_torch.encoding.identity import IdentityEncoding
from nerf_meets_mlx_torch.encoding.hash_grid import HashGridEncoding
from nerf_meets_mlx_torch.encoding.cp_grid import CPGridEncoding
from nerf_meets_mlx_torch.encoding.spherical_harmonics import (
    SphericalHarmonicsEncoding,
    sh_encode,
)

__all__ = [
    "Encoding",
    "make_encoding",
    "SinusoidalEncoding",
    "frequency_bands",
    "sinusoidal_encode",
    "IdentityEncoding",
    "HashGridEncoding",
    "CPGridEncoding",
    "SphericalHarmonicsEncoding",
    "sh_encode",
]
