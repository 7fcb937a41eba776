"""2-D image-learning entrypoint.

Counterpart of ``nerf_meets_mlx_tpu/entrypoints/image_learning.py``: trains
the ``image2d`` MLP (2-D sinusoidal encoding, 8×256 MLP, Adam at lr 1e-3)
to reproduce an RGB image, predicting the whole image every
``frame_every`` steps. It runs on ``cuda`` unless the caller passes
``device``, and raises when CUDA is asked for and absent. On a CUDA device
it turns ``use_fused_kernel`` on, as the port's other entry points do for
their presets: every step launches the image train kernel once and every
frame the image forward kernel (``kernels/fused_image.py``); on the CPU the
standard route runs. The progress frames go to ``progress_frames.npy`` and
the final prediction to ``final.npy`` (uint8); the video writer and the
live viewer come with a later slice.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerf_meets_mlx_torch.config import image2d
from nerf_meets_mlx_torch.datasets.image import load_image_2d, pixel_dataset
from nerf_meets_mlx_torch.engine import Trainer, make_image_train_step
from nerf_meets_mlx_torch.models import create_nerf
from nerf_meets_mlx_torch.ops import psnr as psnr_fn
from nerf_meets_mlx_torch.rendering.renderer import to8b
from nerf_meets_mlx_torch.utils.tensors import resolve_device


def image_learning(
    image_path: Optional[str] = None,
    size: int = 400,
    max_iters: int = 1000,
    log_dir: Optional[str] = None,
    frame_every: int = 50,
    viewer_port: Optional[int] = None,
    device=None,
) -> dict:
    """Overfit the MLP to one image; returns ``{"final_psnr", "steps"}``."""
    if viewer_port is not None:
        raise NotImplementedError("the live viewer is not ported yet (ROADMAP.md Queue 1)")
    dev = resolve_device(device)
    cfg = image2d()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, max_iters=max_iters))
    if dev.type == "cuda":
        cfg = cfg.replace(use_fused_kernel=True)
    img = load_image_2d(image_path, size)
    H, W = img.shape[:2]
    coords, colors = (torch.as_tensor(a, device=dev) for a in pixel_dataset(img))

    model = create_nerf(cfg, device=dev)
    trainer = Trainer(cfg, model, make_image_train_step(model), (coords, colors), log_dir=log_dir)

    @torch.no_grad()
    def predict() -> torch.Tensor:
        if cfg.use_fused_kernel:
            from nerf_meets_mlx_torch.kernels.fused_image import fused_image_apply

            pred = fused_image_apply(model.coarse, model.pos_enc, coords)
        else:
            pred = model.query("coarse", coords[:, None, :], None)[:, 0, :]
        return pred.reshape(H, W, 3)

    frames = []
    while trainer.step < max_iters:
        trainer.run(min(frame_every, max_iters - trainer.step))
        frames.append(to8b(predict()))

    pred = predict()
    final_psnr = float(psnr_fn(pred, torch.as_tensor(img, device=dev)))
    trainer.logger.log(step=trainer.step, final_psnr=final_psnr)
    out_dir = Path(trainer.log_dir)
    if frames:
        np.save(out_dir / "progress_frames.npy", np.stack(frames))
    np.save(out_dir / "final.npy", to8b(pred))
    return {"final_psnr": final_psnr, "steps": trainer.step}
