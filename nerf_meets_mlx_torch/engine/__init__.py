from nerf_meets_mlx_torch.engine.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from nerf_meets_mlx_torch.engine.train_state import TrainState, lr_at
from nerf_meets_mlx_torch.engine.trainer import (
    Trainer,
    make_image_train_step,
    make_nerf_train_step,
    maybe_update_occupancy,
    nerf_loss_fn,
    sample_train_rays,
)

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "TrainState",
    "lr_at",
    "Trainer",
    "make_image_train_step",
    "make_nerf_train_step",
    "maybe_update_occupancy",
    "nerf_loss_fn",
    "sample_train_rays",
]
