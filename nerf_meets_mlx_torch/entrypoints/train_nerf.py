"""NeRF volume-learning entrypoint.

Counterpart of ``nerf_meets_mlx_tpu/entrypoints/train_nerf.py``: the train
step, checkpoint/resume, JSONL metrics, periodic held-out renders, the final
test-set PSNR and SSIM, and the orbit frames. It runs on ``cuda`` unless the
caller passes ``device``, and raises when CUDA is asked for and absent. On a
CUDA device the sinusoidal and hash-grid presets route through the fused
CUDA kernels (``use_fused_kernel=True``): each train step launches the train
kernel (``fused_train`` or, for ``lego_ingp`` / ``lego_ingp_occ``,
``fused_ingp``) once per level and the renders launch the eval kernel; a
hash grid past the INGP kernel's bounds (``config_txt`` with the paper's
16 × 2^19 tables, or more than 256 samples) trains on the "feats" route
(the hash encode, then ``fused_feat`` per level) and renders on the
standard route; on the CPU they take the standard route. With ``render.occupancy``
(``lego_occ``, ``lego_ingp_occ``) the train step keeps the learned grid up
to date (one launch of the fused MLP forward kernel, or of the hash-encode
forward kernel, per update on CUDA) and every render takes it. Held-out renders are written as ``render_XXXXXXXX.npy`` and
the orbit as ``orbit_frames.npy`` (uint8 frames); the image and video
writers come with a later slice.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerf_meets_mlx_torch.config import PRESETS, ExperimentConfig, config_from_text
from nerf_meets_mlx_torch.engine import Trainer, make_nerf_train_step
from nerf_meets_mlx_torch.entrypoints.render_only import _load_dataset, _uses_fused_route
from nerf_meets_mlx_torch.models import create_nerf
from nerf_meets_mlx_torch.ops import psnr as psnr_fn
from nerf_meets_mlx_torch.ops import ssim as ssim_fn
from nerf_meets_mlx_torch.rendering import render_image
from nerf_meets_mlx_torch.rendering.renderer import render_orbit, to8b
from nerf_meets_mlx_torch.utils.tensors import resolve_device


def _write_args(out_dir: Path, cfg: ExperimentConfig, config_txt: Optional[str]) -> None:
    """The resolved config as sorted ``key = value`` lines (args.txt), and
    a copy of the text overlay (config.txt)."""
    flat = []

    def walk(prefix, obj):
        for k, v in sorted(obj.items()):
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            else:
                flat.append(f"{prefix}{k} = {v}")

    walk("", dataclasses.asdict(cfg))
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "args.txt").write_text("\n".join(flat) + "\n")
    if config_txt:
        (out_dir / "config.txt").write_text(Path(config_txt).read_text())


def train_nerf(
    preset: str = "lego_hierarchical",
    data_dir: Optional[str] = None,
    config_txt: Optional[str] = None,
    max_iters: Optional[int] = None,
    log_dir: Optional[str] = None,
    resume: bool = True,
    render_video: bool = True,
    nan_check: bool = False,
    profile_dir: Optional[str] = None,
    synth_resolution: Optional[int] = None,
    synth_scene: Optional[str] = None,
    precrop_iters: Optional[int] = None,
    viewer_port: Optional[int] = None,
    llff_factor: Optional[int] = None,
    spherify: bool = False,
    dv_shape: Optional[str] = None,
    shard: bool = True,
    inner: int = 1,
    device=None,
) -> dict:
    """Train a NeRF; returns the last step's metrics with the held-out test
    PSNR and SSIM (``test_psnr_mean``, ``test_ssim_mean``).

    nan_check raises at the first non-finite loss (it reads the loss every
    step); profile_dir writes a ``torch.profiler`` trace of 10 steps after
    10 warm ones. One device trains: with several CUDA devices visible,
    ``shard=True`` asks for the data-parallel step, which is not ported."""
    if viewer_port is not None:
        raise NotImplementedError("the live viewer is not ported yet (ROADMAP.md Queue 1)")
    dev = resolve_device(device)
    if shard and dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "the sharded (multi-GPU) train step is not ported yet (ROADMAP.md "
            "Queue 1); pass shard=False (--no-shard) to train on one device"
        )
    cfg = PRESETS[preset]()
    if config_txt:
        cfg = config_from_text(config_txt, cfg)
    if data_dir:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, data_dir=data_dir))
    elif cfg.data.dataset_type in ("llff", "deepvoxels"):
        raise ValueError(f"the {preset} preset requires --data-dir")
    elif not cfg.data.data_dir:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset_type="synthetic"))
    if max_iters:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, max_iters=max_iters))
    if synth_resolution:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, synth_resolution=synth_resolution))
    if synth_scene:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, synth_scene=synth_scene))
    if llff_factor is not None:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, llff_factor=llff_factor))
    if dv_shape is not None:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, dv_shape=dv_shape))
    if spherify:
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, spherify=True),
            render=dataclasses.replace(cfg.render, ndc=False),
        )
    if precrop_iters is not None:
        # a precrop window longer than the run leaves everything outside the
        # central crop untrained: short runs must shrink it
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, precrop_iters=precrop_iters))
    if dev.type == "cuda" and _uses_fused_route(cfg):
        cfg = cfg.replace(use_fused_kernel=True)

    ds = _load_dataset(cfg, dev)
    if not cfg.render.ndc and hasattr(ds, "near"):
        cfg = cfg.replace(render=dataclasses.replace(cfg.render, near=ds.near, far=ds.far))
    model = create_nerf(cfg, device=dev)
    images = torch.as_tensor(ds.images[ds.i_train], device=dev)
    poses = torch.as_tensor(ds.poses[ds.i_train, :3, :4], device=dev)
    step_fn = make_nerf_train_step(model, ds.H, ds.W, ds.focal, n_inner=max(1, inner))
    trainer = Trainer(cfg, model, step_fn, (images, poses), log_dir=log_dir, nan_check=nan_check)
    if resume:
        trainer.restore()
    out_dir = trainer.log_dir
    tcfg = cfg.train
    _write_args(out_dir, cfg, config_txt)

    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        trainer.run(10)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            trainer.run(10)
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(profile_dir) / "train_trace.json"))

    view_i = int(ds.i_test[len(ds.i_test) // 2]) if len(ds.i_test) else 0
    # resuming a finished run skips the loop: keep `metrics` bound
    metrics: dict = {"step": trainer.step}
    while trainer.step < tcfg.max_iters:
        n = min(tcfg.i_testset or tcfg.max_iters, tcfg.max_iters - trainer.step)
        metrics = trainer.run(n)
        # periodic held-out render
        out = render_image(
            model, ds.H, ds.W, ds.K, ds.poses[view_i, :3, :4], occ_grid=trainer.state.occ_grid
        )
        gt = torch.as_tensor(ds.images[view_i], device=dev)
        trainer.logger.log(step=trainer.step, test_psnr=float(psnr_fn(out["rgb_map"], gt)))
        np.save(out_dir / f"render_{trainer.step:08d}.npy", to8b(out["rgb_map"]))
    trainer.save()

    psnrs, ssims = [], []
    for i in ds.i_test:
        out = render_image(
            model, ds.H, ds.W, ds.K, ds.poses[i, :3, :4], occ_grid=trainer.state.occ_grid
        )
        gt = torch.as_tensor(ds.images[i], device=dev)
        psnrs.append(float(psnr_fn(out["rgb_map"], gt)))
        ssims.append(float(ssim_fn(out["rgb_map"], gt)))
    result = {
        **metrics,
        "test_psnr_mean": float(np.mean(psnrs)),
        "test_ssim_mean": float(np.mean(ssims)),
        "step": trainer.step,
        "log_dir": str(out_dir),
    }
    trainer.logger.log(
        step=trainer.step,
        test_psnr_mean=result["test_psnr_mean"],
        test_ssim_mean=result["test_ssim_mean"],
    )
    if render_video:
        frames = np.stack(list(render_orbit(
            model, ds.H, ds.W, ds.K, ds.render_poses, occ_grid=trainer.state.occ_grid
        )))
        np.save(out_dir / "orbit_frames.npy", frames)
    return result
