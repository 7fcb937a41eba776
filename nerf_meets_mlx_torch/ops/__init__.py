from nerf_meets_mlx_torch.ops.metrics import mse, psnr

__all__ = ["mse", "psnr"]
