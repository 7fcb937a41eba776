from nerf_meets_mlx_torch.entrypoints.image_learning import image_learning
from nerf_meets_mlx_torch.entrypoints.render_only import render_only
from nerf_meets_mlx_torch.entrypoints.train_nerf import train_nerf

__all__ = ["image_learning", "render_only", "train_nerf"]
