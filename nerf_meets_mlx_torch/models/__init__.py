from nerf_meets_mlx_torch.models.nerf_mlp import NeRFMLP
from nerf_meets_mlx_torch.models.factory import NeRFModel, create_nerf

__all__ = ["NeRFMLP", "NeRFModel", "create_nerf"]
