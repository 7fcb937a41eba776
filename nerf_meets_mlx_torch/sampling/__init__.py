from nerf_meets_mlx_torch.sampling.stratified import (
    sample_z_uniform,
    sample_z_lindisp,
    stratified_jitter,
)
from nerf_meets_mlx_torch.sampling.importance import merge_z, sample_pdf

__all__ = [
    "sample_z_uniform",
    "sample_z_lindisp",
    "stratified_jitter",
    "sample_pdf",
    "merge_z",
]
