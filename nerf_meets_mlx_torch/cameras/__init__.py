from nerf_meets_mlx_torch.cameras.rays import get_rays, ndc_rays
from nerf_meets_mlx_torch.cameras.pose import pose_spherical, orbit_poses

__all__ = ["get_rays", "ndc_rays", "pose_spherical", "orbit_poses"]
