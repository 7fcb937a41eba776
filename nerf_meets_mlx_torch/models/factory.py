"""Model assembly: encodings + coarse/fine MLPs + the hierarchical
ray-rendering pipeline.

Counterpart of ``nerf_meets_mlx_tpu/models/factory.py``. ``NeRFModel`` is an
``nn.Module`` holding the coarse (and fine) ``NeRFMLP``; ``render_rays(
train=False)`` runs

    coarse samples -> coarse level -> deterministic inverse-CDF importance
    samples -> fine level

on one of two routes:

* the fused-eval route (``_fused_train_mode == "sinusoidal"``): each level
  is one ``kernels.fused_train.fused_eval_apply`` call, which launches the
  CUDA kernel for CUDA tensors and runs its plain version on the CPU; the
  depth/disp/acc maps are reductions over the dense weights;
* the standard route (``use_fused_kernel`` off): ``query`` (encode, then
  the MLP) and ``raw2outputs``.

Training (``render_rays(train=True)``, ``render_rays_train``) is the next
slice of the port.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from nerf_meets_mlx_torch.config import ExperimentConfig
from nerf_meets_mlx_torch.encoding.base import make_encoding
from nerf_meets_mlx_torch.models.nerf_mlp import NeRFMLP
from nerf_meets_mlx_torch.rendering.volume import maps_from_weights, raw2outputs
from nerf_meets_mlx_torch.sampling.importance import merge_z, sample_pdf
from nerf_meets_mlx_torch.sampling.stratified import (
    sample_z_lindisp,
    sample_z_uniform,
)

_TRAIN_SLICE = "slice 2"


class NeRFModel(nn.Module):
    """Encodings (parameter-free here) and the coarse/fine MLPs."""

    def __init__(self, cfg: ExperimentConfig, pos_enc, dir_enc, device=None):
        super().__init__()
        self.cfg = cfg
        self.pos_enc = pos_enc
        self.dir_enc = dir_enc
        dir_dim = dir_enc.out_dim if dir_enc is not None else 0
        self.coarse = NeRFMLP(cfg.mlp, pos_enc.out_dim, dir_dim, device=device)
        self.fine = (
            NeRFMLP(cfg.mlp_fine, pos_enc.out_dim, dir_dim, device=device)
            if cfg.mlp_fine is not None
            else None
        )

    @property
    def device(self) -> torch.device:
        return self.coarse.pos_linears[0].weight.device

    # -- init ---------------------------------------------------------------

    def init(self, generator: torch.Generator) -> "NeRFModel":
        """Fill every parameter from ``generator`` (see ``NeRFMLP.init``)."""
        self.coarse.init(generator)
        if self.fine is not None:
            self.fine.init(generator)
        return self

    def _mlp(self, level: str) -> NeRFMLP:
        return self.fine if level == "fine" and self.fine is not None else self.coarse

    def _mlp_cfg(self, level: str):
        return self.cfg.mlp if level == "coarse" else (self.cfg.mlp_fine or self.cfg.mlp)

    # -- point query --------------------------------------------------------

    def _use_fused(self, mlp_cfg) -> bool:
        cfg = self.cfg
        return (
            cfg.use_fused_kernel
            and mlp_cfg.use_viewdirs
            and cfg.pos_encoding.kind == "sinusoidal"
            and cfg.dir_encoding is not None
            and cfg.dir_encoding.kind == "sinusoidal"
        )

    def query(
        self,
        level: str,                          # "coarse" | "fine"
        pts: torch.Tensor,                   # [B, S, 3]
        viewdirs: Optional[torch.Tensor],    # [B, 3] normalized
    ) -> torch.Tensor:
        """Encode points (and directions broadcast per sample), then run the
        MLP: raw [B, S, 4]. The point-major fused kernel the JAX package
        uses here (``fused_mlp._fwd_kernel``) is the next slice; this is the
        unfused route."""
        mlp_cfg = self._mlp_cfg(level)
        x_pos = self.pos_enc.apply(pts)
        x_dir = None
        if mlp_cfg.use_viewdirs and self.dir_enc is not None:
            dirs = viewdirs[..., None, :].expand(*pts.shape[:-1], viewdirs.shape[-1])
            x_dir = self.dir_enc.apply(dirs)
        return self._mlp(level)(x_pos, x_dir)

    # -- per-ray interval + coarse z samples ---------------------------------

    def _coarse_z(self, rays_o: torch.Tensor, rays_d: torch.Tensor, train: bool) -> torch.Tensor:
        """[near, far] (AABB slab-tightened when configured) and the coarse
        z samples [B, S]. Stratified jitter and the occupancy grid belong to
        training and come with its slice."""
        if train:
            raise NotImplementedError(_TRAIN_SLICE)
        rcfg = self.cfg.render
        if rcfg.occupancy:
            raise NotImplementedError(
                "occupancy-grid tightening is not ported yet (ROADMAP.md)"
            )
        B = rays_o.shape[0]
        near = torch.full((B, 1), rcfg.near, dtype=torch.float32, device=rays_o.device)
        far = torch.full((B, 1), rcfg.far, dtype=torch.float32, device=rays_o.device)
        if rcfg.aabb is not None:
            from nerf_meets_mlx_torch.cameras.rays import intersect_aabb

            near, far = intersect_aabb(
                rays_o, rays_d, rcfg.aabb[:3], rcfg.aabb[3:], near, far
            )
        sample_fn = sample_z_lindisp if rcfg.lindisp else sample_z_uniform
        return sample_fn(near, far, rcfg.n_samples)

    # -- full hierarchical ray rendering ------------------------------------

    @torch.no_grad()
    def render_rays(
        self,
        rays_o: torch.Tensor,                    # [B, 3]
        rays_d: torch.Tensor,                    # [B, 3] (unnormalized)
        train: bool = False,
        viewdirs: Optional[torch.Tensor] = None,  # [B, 3] normalized
    ) -> Dict[str, torch.Tensor]:
        """Render a batch of rays; coarse + (optional) fine pass. Returns the
        rgb/disp/acc/depth maps of both passes ("rgb_map" etc. alias the
        finest), the coarse z_vals and weights."""
        if train:
            raise NotImplementedError(_TRAIN_SLICE)
        rcfg = self.cfg.render
        if viewdirs is None:
            viewdirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
        z_vals = self._coarse_z(rays_o, rays_d, train)

        if self._fused_train_mode == "sinusoidal":
            return self._render_rays_eval_fused(rays_o, rays_d, viewdirs, z_vals)

        pts = rays_o[..., None, :] + z_vals[..., :, None] * rays_d[..., None, :]
        out_c = raw2outputs(
            self.query("coarse", pts, viewdirs), z_vals, rays_d,
            mode=rcfg.compositing, white_bkgd=rcfg.white_bkgd,
            density_activation=rcfg.density_activation,
        )
        ret = {
            "rgb_coarse": out_c["rgb_map"],
            "disp_coarse": out_c["disp_map"],
            "acc_coarse": out_c["acc_map"],
            "depth_coarse": out_c["depth_map"],
            "z_vals": z_vals,
            "weights": out_c["weights"],
            "rgb_map": out_c["rgb_map"],
            "disp_map": out_c["disp_map"],
            "acc_map": out_c["acc_map"],
            "depth_map": out_c["depth_map"],
        }
        if rcfg.n_importance > 0:
            z_imp = sample_pdf(
                z_vals, out_c["weights"], rcfg.n_importance, deterministic=True
            )
            z_all = merge_z(z_vals, z_imp)
            pts_f = rays_o[..., None, :] + z_all[..., :, None] * rays_d[..., None, :]
            out_f = raw2outputs(
                self.query("fine", pts_f, viewdirs), z_all, rays_d,
                mode=rcfg.compositing, white_bkgd=rcfg.white_bkgd,
                density_activation=rcfg.density_activation,
            )
            ret.update(
                rgb_fine=out_f["rgb_map"],
                disp_fine=out_f["disp_map"],
                acc_fine=out_f["acc_map"],
                depth_fine=out_f["depth_map"],
                rgb_map=out_f["rgb_map"],
                disp_map=out_f["disp_map"],
                acc_map=out_f["acc_map"],
                depth_map=out_f["depth_map"],
            )
        return ret

    def _render_rays_eval_fused(
        self,
        rays_o: torch.Tensor,     # [B, 3]
        rays_d: torch.Tensor,     # [B, 3]
        viewdirs: torch.Tensor,   # [B, 3] normalized
        z_vals: torch.Tensor,     # [B, S] coarse depths
    ) -> Dict[str, torch.Tensor]:
        """Eval-mode hierarchical render through ``fused_eval_apply``: per
        level one call runs point construction, encode, MLP and compositing.
        Same outputs and keys as the standard route."""
        from nerf_meets_mlx_torch.kernels.fused_train import (
            TrainSpec,
            eval_block,
            fused_eval_apply,
        )

        rcfg = self.cfg.render
        dnorm = torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)

        def deltas_of(z):
            d = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
            return d * dnorm

        def run_level(level, z, n_samples):
            tspec = TrainSpec(
                n_samples=n_samples,
                rays_block=eval_block(n_samples),
                mode=rcfg.compositing,
                density_activation=rcfg.density_activation,
                white_bkgd=rcfg.white_bkgd,
            )
            return fused_eval_apply(
                self._mlp(level), self.pos_enc, self.dir_enc, tspec,
                rays_o, rays_d, viewdirs, z, deltas_of(z),
            )

        rgb_c, w_c = run_level("coarse", z_vals, rcfg.n_samples)
        depth_c, acc_c, disp_c = maps_from_weights(w_c, z_vals)
        ret = {
            "rgb_coarse": rgb_c,
            "disp_coarse": disp_c,
            "acc_coarse": acc_c,
            "depth_coarse": depth_c,
            "z_vals": z_vals,
            "weights": w_c,
            "rgb_map": rgb_c,
            "disp_map": disp_c,
            "acc_map": acc_c,
            "depth_map": depth_c,
        }
        if rcfg.n_importance > 0:
            z_imp = sample_pdf(z_vals, w_c, rcfg.n_importance, deterministic=True)
            z_all = merge_z(z_vals, z_imp)
            rgb_f, w_f = run_level("fine", z_all, rcfg.n_samples + rcfg.n_importance)
            depth_f, acc_f, disp_f = maps_from_weights(w_f, z_all)
            ret.update(
                rgb_fine=rgb_f,
                disp_fine=disp_f,
                acc_fine=acc_f,
                depth_fine=depth_f,
                rgb_map=rgb_f,
                disp_map=disp_f,
                acc_map=acc_f,
                depth_map=depth_f,
            )
        return ret

    # -- routing -------------------------------------------------------------

    @property
    def _fused_train_mode(self) -> Optional[str]:
        """Which fused kernel covers this config: "sinusoidal" (the 8x256-class
        sinusoidal presets, kernels/fused_train.py) or None (unfused route).
        The hash-grid modes ("ingp", "feats") come with the INGP slice."""
        cfg = self.cfg
        if not (cfg.use_fused_kernel and cfg.use_fused_train):
            return None
        n_total = cfg.render.n_samples + cfg.render.n_importance
        fine_mlp = cfg.mlp_fine or cfg.mlp
        if self._use_fused(cfg.mlp) and (
            cfg.render.n_importance == 0 or self._use_fused(fine_mlp)
        ):
            from nerf_meets_mlx_torch.kernels.fused_train import max_fused_samples

            # shared-memory guard: past the bound the unfused route runs
            if n_total <= max_fused_samples():
                return "sinusoidal"
        return None

    def render_rays_train(self, *args, **kwargs):
        raise NotImplementedError(_TRAIN_SLICE)


def create_nerf(cfg: ExperimentConfig, device=None) -> NeRFModel:
    """Build a NeRFModel from config. Its parameters are allocated on
    ``device`` but not filled: call ``init(generator)`` or load a checkpoint
    (``engine/checkpoint.py``) or JAX weights (``interop.params_from_numpy``)."""
    pos_enc = make_encoding(cfg.pos_encoding)
    dir_enc = make_encoding(cfg.dir_encoding) if cfg.dir_encoding else None
    return NeRFModel(cfg, pos_enc, dir_enc, device=device)
