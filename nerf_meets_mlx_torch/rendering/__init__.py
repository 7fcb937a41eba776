from nerf_meets_mlx_torch.rendering.volume import raw2outputs
from nerf_meets_mlx_torch.rendering.renderer import render_image, render_orbit

__all__ = ["raw2outputs", "render_image", "render_orbit"]
