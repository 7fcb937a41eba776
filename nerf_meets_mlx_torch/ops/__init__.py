from nerf_meets_mlx_torch.ops.metrics import mse, mse_to_psnr, psnr, ssim

__all__ = ["mse", "mse_to_psnr", "psnr", "ssim"]
