from nerf_meets_mlx_torch.datasets.blender import BlenderDataset
from nerf_meets_mlx_torch.datasets.synthetic import make_synthetic_scene

__all__ = ["BlenderDataset", "make_synthetic_scene"]
