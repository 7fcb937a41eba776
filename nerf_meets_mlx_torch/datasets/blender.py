"""The Blender-synthetic dataset container (counterpart of the
``BlenderDataset`` of ``nerf_meets_mlx_tpu/datasets/blender.py``). Loading
the PNG scenes from disk comes with a later slice of the port."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BlenderDataset:
    images: np.ndarray        # [N, H, W, 3] float32 (bkgd composited)
    poses: np.ndarray         # [N, 4, 4] float32
    render_poses: np.ndarray  # [160, 4, 4]
    H: int
    W: int
    focal: float
    i_train: np.ndarray
    i_val: np.ndarray
    i_test: np.ndarray
    near: float = 2.0
    far: float = 6.0

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [
                [self.focal, 0, 0.5 * self.W],
                [0, self.focal, 0.5 * self.H],
                [0, 0, 1],
            ],
            dtype=np.float32,
        )
