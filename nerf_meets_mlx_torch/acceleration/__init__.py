from nerf_meets_mlx_torch.acceleration.occupancy import (
    init_occupancy_grid,
    occupancy_binary,
    tighten_near_far,
    update_occupancy_grid,
)

__all__ = [
    "init_occupancy_grid",
    "occupancy_binary",
    "tighten_near_far",
    "update_occupancy_grid",
]
