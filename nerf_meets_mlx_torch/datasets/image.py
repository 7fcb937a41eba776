"""2-D image dataset for the image-learning task.

Counterpart of ``nerf_meets_mlx_tpu/datasets/image.py``: a procedural RGB
image (the default) and its pixels as normalized coordinates + colours for
MLP regression. The procedural image is made with numpy from a seed, so
both packages get the same pixels. Reading an image file needs
``imageio`` and comes with the PNG loaders in a later slice (ROADMAP.md
Queue 1 item 1).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def make_test_image(size: int = 400, seed: int = 0) -> np.ndarray:
    """Procedural target image [H, W, 3] float32 in [0, 1]: smooth
    low-frequency gradients, rings, a sharp checker patch in one corner and
    slight noise, so that both low and high frequency bands of the encoding
    have work."""
    H = W = size
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    u, v = x / W, y / H
    rng = np.random.default_rng(seed)
    r = np.sqrt((u - 0.5) ** 2 + (v - 0.5) ** 2)
    img = np.stack(
        [
            0.5 + 0.5 * np.sin(6.0 * np.pi * u) * np.cos(4.0 * np.pi * v),
            0.5 + 0.5 * np.cos(10.0 * np.pi * r),
            np.clip(1.5 * v - 0.5 * np.sin(8.0 * np.pi * u), 0, 1),
        ],
        axis=-1,
    )
    checker = ((x // 16 + y // 16) % 2)[..., None]
    mask = ((u < 0.3) & (v < 0.3))[..., None]
    img = np.where(mask, checker * np.array([1.0, 0.2, 0.2]) + (1 - checker) * 0.1, img)
    img += rng.normal(0, 0.005, img.shape)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def load_image_2d(path: Optional[str | Path] = None, size: int = 400) -> np.ndarray:
    """The RGB image [H, W, 3] float32 in [0, 1]: the procedural one when no
    path is given. Reading a file is not ported yet."""
    if path is None:
        return make_test_image(size)
    raise NotImplementedError(
        "reading an image file needs imageio, which the port does not use yet "
        "(ROADMAP.md Queue 1 item 1); omit the path for the procedural image"
    )


def pixel_dataset(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten an image into (coords [N, 2] in [0, 1], colors [N, 3]):
    coordinates (x, y), each divided by the image's width or height."""
    H, W = img.shape[:2]
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    coords = np.stack([x.ravel() / W, y.ravel() / H], axis=-1)
    colors = img.reshape(-1, 3).astype(np.float32)
    return coords, colors
