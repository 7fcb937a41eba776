from nerf_meets_mlx_torch.datasets.blender import BlenderDataset
from nerf_meets_mlx_torch.datasets.image import load_image_2d, make_test_image, pixel_dataset
from nerf_meets_mlx_torch.datasets.synthetic import make_synthetic_scene

__all__ = [
    "BlenderDataset", "load_image_2d", "make_synthetic_scene", "make_test_image", "pixel_dataset",
]
