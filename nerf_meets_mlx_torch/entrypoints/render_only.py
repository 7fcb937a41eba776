"""Render-only entrypoint: load a checkpoint, render test poses or the orbit.

Counterpart of ``nerf_meets_mlx_tpu/entrypoints/render_only.py`` — the
serving path. It runs on ``cuda`` unless the caller passes ``device``, and
raises when CUDA is asked for and absent. On a CUDA device the sinusoidal
presets route through the fused eval kernel (``use_fused_kernel=True``), as
the JAX trainer routes them on a TPU; on the CPU they take the standard
route. The orbit frames are written as ``orbit_frames.npy`` (uint8
[N, H, W, 3]); the video writer comes with a later slice.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerf_meets_mlx_torch.config import PRESETS, ExperimentConfig
from nerf_meets_mlx_torch.engine.checkpoint import latest_step, restore_checkpoint
from nerf_meets_mlx_torch.models import create_nerf
from nerf_meets_mlx_torch.ops import psnr as psnr_fn
from nerf_meets_mlx_torch.ops import ssim as ssim_fn
from nerf_meets_mlx_torch.rendering import render_image
from nerf_meets_mlx_torch.rendering.renderer import to8b
from nerf_meets_mlx_torch.utils.tensors import resolve_device


def _load_dataset(cfg: ExperimentConfig, device):
    d = cfg.data
    if d.dataset_type == "synthetic":
        from nerf_meets_mlx_torch.datasets.synthetic import make_synthetic_scene

        return make_synthetic_scene(
            d.synth_n_train, d.synth_n_val, d.synth_n_test, d.synth_resolution,
            white_bkgd=cfg.render.white_bkgd, scene=d.synth_scene, device=device,
        )
    raise NotImplementedError(
        f"dataset_type {d.dataset_type!r} is not ported yet: the port loads "
        "only the procedural synthetic scene (ROADMAP.md Queue 1)"
    )


def _uses_fused_route(cfg: ExperimentConfig) -> bool:
    return (
        cfg.pos_encoding.kind == "sinusoidal"
        and cfg.dir_encoding is not None
        and cfg.dir_encoding.kind == "sinusoidal"
    )


def render_only(
    preset: str = "lego_hierarchical",
    log_dir: str = "",
    data_dir: Optional[str] = None,
    render_test: bool = False,
    out_dir: Optional[str] = None,
    n_orbit: int = 160,
    spherify: bool = False,
    dv_shape: Optional[str] = None,
    device=None,
    synth_resolution: Optional[int] = None,
) -> dict:
    """Render from the latest checkpoint under ``log_dir``.

    render_test=True renders and scores the held-out test views (PSNR and
    SSIM); otherwise the first ``n_orbit`` orbit poses go to
    ``orbit_frames.npy``. With ``render.occupancy`` the checkpoint's grid is
    restored and every frame is tightened by it.
    ``synth_resolution`` sets the procedural scene's H = W. The result
    holds the host-clock seconds of every rendered frame (each ends in a
    copy to the host, which waits for the device)."""
    dev = resolve_device(device)
    cfg = PRESETS[preset]()
    if dv_shape is not None:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, dv_shape=dv_shape))
    if spherify:
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, spherify=True),
            render=dataclasses.replace(cfg.render, ndc=False),
        )
    if data_dir:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, data_dir=data_dir))
    elif not cfg.data.data_dir:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset_type="synthetic"))
    if synth_resolution:
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, synth_resolution=synth_resolution)
        )
    if dev.type == "cuda" and _uses_fused_route(cfg):
        cfg = cfg.replace(use_fused_kernel=True)

    ds = _load_dataset(cfg, dev)
    if not cfg.render.ndc and hasattr(ds, "near"):
        cfg = cfg.replace(
            render=dataclasses.replace(cfg.render, near=ds.near, far=ds.far)
        )
    model = create_nerf(cfg, device=dev)

    ckpt_dir = Path(log_dir) / "ckpt"
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    occ = None
    if cfg.render.occupancy:
        from nerf_meets_mlx_torch.acceleration.occupancy import init_occupancy_grid

        occ = init_occupancy_grid(cfg.render.occ_resolution, device=dev)
    restore_checkpoint(ckpt_dir, model, step, occ_grid=occ)
    model.eval()
    out_path = Path(out_dir or (Path(log_dir) / f"render_only_{step}"))
    out_path.mkdir(parents=True, exist_ok=True)

    result: dict = {"step": step, "device": str(dev)}
    frame_seconds = []
    if render_test:
        psnrs, ssims = [], []
        for i in ds.i_test:
            t0 = time.perf_counter()
            out = render_image(model, ds.H, ds.W, ds.K, ds.poses[i, :3, :4], occ_grid=occ)
            rgb = out["rgb_map"].cpu()
            frame_seconds.append(time.perf_counter() - t0)
            gt = torch.as_tensor(ds.images[i])
            psnrs.append(float(psnr_fn(rgb, gt)))
            ssims.append(float(ssim_fn(rgb, gt)))
        result["test_psnr_mean"] = float(np.mean(psnrs))
        result["test_ssim_mean"] = float(np.mean(ssims))
        result["test_psnrs"] = psnrs
    else:
        frames = []
        for c2w in ds.render_poses[:n_orbit]:
            t0 = time.perf_counter()
            out = render_image(model, ds.H, ds.W, ds.K, np.asarray(c2w)[:3, :4], occ_grid=occ)
            frames.append(to8b(out["rgb_map"]))
            frame_seconds.append(time.perf_counter() - t0)
        path = out_path / "orbit_frames.npy"
        np.save(path, np.stack(frames))
        result["frames"] = str(path)
    result["frame_seconds"] = frame_seconds
    return result
