from nerf_meets_mlx_torch.entrypoints.render_only import render_only

__all__ = ["render_only"]
