"""Model assembly: encodings + coarse/fine MLPs + the hierarchical
ray-rendering pipeline.

Counterpart of ``nerf_meets_mlx_tpu/models/factory.py``. ``NeRFModel`` is an
``nn.Module`` holding the coarse (and fine) ``NeRFMLP`` and, for a learned
encoding (the hash grid, the CP grid), the position encoding with its
tables or lines;
``render_rays`` runs

    coarse samples -> coarse level -> inverse-CDF importance samples
    (detached) -> fine level

on one of two routes:

* the fused route (``_fused_train_mode`` "sinusoidal", "ingp" or
  "feats"): in eval each level is one ``kernels.fused_train.fused_eval_apply``
  call (sinusoidal) or one ``kernels.fused_ingp_train.fused_ingp_eval_apply``
  call (hash grid + spherical harmonics), and the depth/disp/acc maps are
  reductions over the dense weights ("feats" evaluates on the standard
  route, as the JAX package does); in training ``render_rays_train``
  makes each level one ``fused_train_apply`` / ``fused_ingp_train_apply``
  call, which returns the level's SSE and, on CUDA, its gradient in the
  same launch, or ("feats") the hash encode followed by one
  ``kernels.fused_feat_train.fused_feat_train_apply`` call, whose gradient
  of the features goes back through the encode. They launch their CUDA
  kernel for CUDA tensors and run their plain version on the CPU;
* the standard route (``use_fused_kernel`` off, or ``use_fused_train``
  off): ``query`` and ``raw2outputs``, differentiable by autograd in
  training. ``query`` is encode-then-MLP, or, with ``use_fused_kernel``, one
  ``kernels.fused_mlp.fused_mlp_apply`` call (the point-major CUDA kernels)
  for sinusoidal models, and the hash encode through
  ``kernels.hash_encode.hash_encode_apply`` (forward and table-gradient
  CUDA kernels) for hash-grid models. A CP-grid model (``lego_cp``) takes
  no fused mode and encodes with the plain ``CPGridEncoding.apply``, as the
  JAX model leaves it to XLA; ``kernels.cp_encode.cp_encode_apply`` is its
  drop-in, which no config turns on.

With ``render.occupancy`` every route takes the learned grid
(``occ_grid``, ``occ_active``) and tightens each ray's interval before the
coarse samples (``acceleration/occupancy.py``).

Training draws (stratified jitter ``t``, density noise ``noise_c`` /
``noise_f`` as unit normals, importance queries ``u``) come from a
``torch.Generator`` or are injected through ``draws``, so a test can feed
both packages the same numbers.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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
    stratified_jitter,
)

Draws = Mapping[str, torch.Tensor]


def _draw(draws: Optional[Draws], key: str, shape, kind: str, generator, device):
    """The injected draw ``key`` if given, else a fresh one from
    ``generator``: "uniform" on [0, 1) or "normal" (unit normals)."""
    if draws is not None and key in draws:
        return draws[key].to(device=device, dtype=torch.float32)
    fn = torch.rand if kind == "uniform" else torch.randn
    return fn(shape, generator=generator, dtype=torch.float32, device=device)


class NeRFModel(nn.Module):
    """The encodings and the coarse/fine MLPs. A position encoding with
    parameters (the hash grid, the CP grid) is a submodule, ``pos_enc``, so
    its tables or lines are in ``parameters()`` and ``state_dict()``; the
    parameter-free encodings are plain attributes and add no state."""

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
        """Fill every parameter from ``generator`` (see ``NeRFMLP.init``):
        the coarse MLP, the fine MLP, then the position encoding's tables or
        lines."""
        self.coarse.init(generator)
        if self.fine is not None:
            self.fine.init(generator)
        if isinstance(self.pos_enc, nn.Module):
            self.pos_enc.init(generator)
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

    def _use_hash_kernel(self) -> bool:
        """Route the hash-grid encode through ``hash_encode_apply`` (the CUDA
        forward and table-gradient kernels) on the JAX package's condition:
        ``use_fused_kernel``, a hash grid, and its packed tables within the
        TPU kernel's VMEM budget (``HashEncodeSpec.vmem_ok``), so that a
        config routes alike in both packages."""
        pcfg = self.cfg.pos_encoding
        if not (self.cfg.use_fused_kernel and pcfg.kind == "hash_grid"):
            return False
        T = 1 << pcfg.hash_log2_table_size
        packed_bytes = pcfg.hash_n_levels * T * pcfg.hash_features_per_level * 4
        return (
            pcfg.hash_log2_table_size >= 7
            and packed_bytes <= 6 * 1024 * 1024
            and T // 128 <= 1024
        )

    def _encode_pos(self, pts: torch.Tensor) -> torch.Tensor:
        # the points are data or detached z-samples: no dX on either path
        if self._use_hash_kernel():
            from nerf_meets_mlx_torch.kernels.hash_encode import hash_encode_apply

            return hash_encode_apply(self.pos_enc, pts)
        return self.pos_enc.apply(pts)

    def query(
        self,
        level: str,                          # "coarse" | "fine"
        pts: torch.Tensor,                   # [B, S, 3]
        viewdirs: Optional[torch.Tensor],    # [B, 3] normalized
    ) -> torch.Tensor:
        """Encode points (and directions broadcast per sample), then run the
        MLP: raw [B, S, 4]. With ``use_fused_kernel`` on a sinusoidal
        view-direction model this is one ``fused_mlp_apply`` call (the CUDA
        forward kernel, and its backward kernel under autograd) whatever
        route the render takes, as the JAX model's query does; on a
        hash-grid model the encode is ``hash_encode_apply`` (``_encode_pos``)
        and the MLP runs in plain torch, as the JAX model leaves it to XLA.
        The points are data there, so no dX is computed."""
        mlp_cfg = self._mlp_cfg(level)
        if self._use_fused(mlp_cfg):
            from nerf_meets_mlx_torch.kernels.fused_mlp import fused_mlp_apply

            dirs = viewdirs[..., None, :].expand(*pts.shape[:-1], 3)
            raw = fused_mlp_apply(
                self._mlp(level), self.pos_enc, self.dir_enc,
                pts.reshape(-1, 3), dirs.reshape(-1, 3), compute_dx=False,
            )
            return raw.reshape(*pts.shape[:-1], 4)
        x_pos = self._encode_pos(pts)
        x_dir = None
        if mlp_cfg.use_viewdirs and self.dir_enc is not None:
            dirs = viewdirs[..., None, :].expand(*pts.shape[:-1], viewdirs.shape[-1])
            x_dir = self.dir_enc.apply(dirs)
        return self._mlp(level)(x_pos, x_dir)

    # -- per-ray interval + coarse z samples ---------------------------------

    def _coarse_z(
        self,
        rays_o: torch.Tensor,
        rays_d: torch.Tensor,
        train: bool,
        draws: Optional[Draws] = None,
        generator: Optional[torch.Generator] = None,
        occ_grid: Optional[torch.Tensor] = None,
        occ_active=True,
    ) -> torch.Tensor:
        """[near, far] (AABB slab-tightened when configured, then tightened
        to the occupied cells of ``occ_grid`` when ``render.occupancy`` is on
        and a grid is given; ``occ_active`` gates the grid during warmup)
        and the coarse z samples [B, S], stratified-jittered in training
        (the uniform draw ``draws["t"]`` or one from ``generator``)."""
        rcfg = self.cfg.render
        B = rays_o.shape[0]
        near = torch.full((B, 1), rcfg.near, dtype=torch.float32, device=rays_o.device)
        far = torch.full((B, 1), rcfg.far, dtype=torch.float32, device=rays_o.device)
        if rcfg.aabb is not None:
            from nerf_meets_mlx_torch.cameras.rays import intersect_aabb

            near, far = intersect_aabb(
                rays_o, rays_d, rcfg.aabb[:3], rcfg.aabb[3:], near, far
            )
        if rcfg.occupancy and occ_grid is not None:
            from nerf_meets_mlx_torch.acceleration.occupancy import tighten_near_far

            near, far = tighten_near_far(
                occ_grid, rays_o, rays_d, near, far, rcfg.aabb,
                rcfg.occ_threshold, rcfg.occ_n_probes, active=occ_active,
            )
        sample_fn = sample_z_lindisp if rcfg.lindisp else sample_z_uniform
        z_vals = sample_fn(near, far, rcfg.n_samples)
        if train and rcfg.perturb > 0.0:
            t = _draw(draws, "t", z_vals.shape, "uniform", generator, z_vals.device)
            z_vals = stratified_jitter(z_vals, rcfg.perturb, t=t)
        return z_vals

    # -- full hierarchical ray rendering ------------------------------------

    def render_rays(
        self,
        rays_o: torch.Tensor,                    # [B, 3]
        rays_d: torch.Tensor,                    # [B, 3] (unnormalized)
        train: bool = False,
        viewdirs: Optional[torch.Tensor] = None,  # [B, 3] normalized
        draws: Optional[Draws] = None,
        generator: Optional[torch.Generator] = None,
        occ_grid: Optional[torch.Tensor] = None,  # [R, R, R] learned density
        occ_active: bool = True,                  # warmup gate (host bool)
    ) -> Dict[str, torch.Tensor]:
        """Render a batch of rays; coarse + (optional) fine pass. Returns the
        rgb/disp/acc/depth maps of both passes ("rgb_map" etc. alias the
        finest), the coarse z_vals and weights.

        Eval (``train=False``) runs under ``no_grad`` on the fused route
        when it is configured, whose eval op has no backward (as JAX's
        fused eval op stops gradients); on the standard route it keeps
        them, as JAX's does. Training runs the standard route with
        autograd: jittered coarse samples, density noise (when
        ``raw_noise_std > 0``) and random importance queries, each from
        ``draws`` ("t", "noise_c", "u", "noise_f") or ``generator``.
        ``occ_grid`` tightens each ray's interval when ``render.occupancy``
        is on (``_coarse_z``)."""
        occ = (occ_grid, occ_active)
        if train:
            return self._render_rays(rays_o, rays_d, True, viewdirs, draws, generator, occ)
        if self._fused_train_mode in ("sinusoidal", "ingp"):
            with torch.no_grad():
                return self._render_rays(rays_o, rays_d, False, viewdirs, None, None, occ)
        return self._render_rays(rays_o, rays_d, False, viewdirs, None, None, occ)

    def _render_rays(self, rays_o, rays_d, train, viewdirs, draws, generator, occ):
        rcfg = self.cfg.render
        dev = rays_o.device
        if viewdirs is None:
            viewdirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
        z_vals = self._coarse_z(rays_o, rays_d, train, draws, generator, *occ)

        if not train and self._fused_train_mode in ("sinusoidal", "ingp"):
            return self._render_rays_eval_fused(rays_o, rays_d, viewdirs, z_vals)

        noise_std = rcfg.raw_noise_std if train else 0.0

        def noise(key, shape):
            if noise_std <= 0.0:
                return None
            return _draw(draws, key, shape, "normal", generator, dev)

        pts = rays_o[..., None, :] + z_vals[..., :, None] * rays_d[..., None, :]
        out_c = raw2outputs(
            self.query("coarse", pts, viewdirs), z_vals, rays_d,
            mode=rcfg.compositing, raw_noise_std=noise_std,
            white_bkgd=rcfg.white_bkgd,
            density_activation=rcfg.density_activation,
            noise=noise("noise_c", z_vals.shape),
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
            u = None
            if train:
                u = _draw(draws, "u", (z_vals.shape[0], rcfg.n_importance), "uniform",
                          generator, dev)
            z_imp = sample_pdf(
                z_vals, out_c["weights"], rcfg.n_importance, deterministic=not train, u=u
            )
            z_all = merge_z(z_vals, z_imp)
            pts_f = rays_o[..., None, :] + z_all[..., :, None] * rays_d[..., None, :]
            out_f = raw2outputs(
                self.query("fine", pts_f, viewdirs), z_all, rays_d,
                mode=rcfg.compositing, raw_noise_std=noise_std,
                white_bkgd=rcfg.white_bkgd,
                density_activation=rcfg.density_activation,
                noise=noise("noise_f", z_all.shape),
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
        """Eval-mode hierarchical render through ``fused_eval_apply``
        (sinusoidal) or ``fused_ingp_eval_apply`` (hash grid; the spherical
        harmonics are computed per ray outside the kernel, [B, 25]): per
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

        def tspec_of(n_samples, rays_block):
            return TrainSpec(
                n_samples=n_samples,
                rays_block=rays_block,
                mode=rcfg.compositing,
                density_activation=rcfg.density_activation,
                white_bkgd=rcfg.white_bkgd,
            )

        if self._fused_train_mode == "ingp":
            from nerf_meets_mlx_torch.kernels.fused_ingp_train import (
                fused_ingp_eval_apply,
                ingp_rays_block,
            )

            sh = self.dir_enc.apply(viewdirs)

            def run_level(level, z, n_samples):
                return fused_ingp_eval_apply(
                    self._mlp(level), self.pos_enc, sh,
                    tspec_of(n_samples, ingp_rays_block(n_samples)),
                    rays_o, rays_d, z, deltas_of(z),
                )
        else:

            def run_level(level, z, n_samples):
                return fused_eval_apply(
                    self._mlp(level), self.pos_enc, self.dir_enc,
                    tspec_of(n_samples, eval_block(n_samples)),
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
        """Which fused kernel covers this config, on the JAX package's
        conditions:

        * "sinusoidal": the 8x256-class sinusoidal presets
          (kernels/fused_train.py);
        * "ingp": hash grid + spherical harmonics with view heads, at most
          256 samples per ray and tables within ``_use_hash_kernel``'s
          budget (kernels/fused_ingp_train.py: points, hash encode, MLP,
          compositing and, in training, the backward with the table
          gradient, in one call per level);
        * "feats": the other hash-grid configs, up to 2048 samples per ray
          (tables past that budget, such as the Instant-NGP paper's 16
          levels of 2^19 entries, or more than 256 samples): in training
          the hash encode (``_encode_pos``), then
          kernels/fused_feat_train.py (MLP, compositing and the backward,
          with the gradient of the features, in one call per level); in
          eval the standard route;
        * None: the unfused route.
        """
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
        if (
            cfg.pos_encoding.kind == "hash_grid"
            and cfg.dir_encoding is not None
            and cfg.dir_encoding.kind == "spherical_harmonics"
            and cfg.mlp.use_viewdirs
            and fine_mlp.use_viewdirs
            and n_total <= 2048
        ):
            if n_total <= 256 and self._use_hash_kernel():
                return "ingp"
            return "feats"
        return None

    @property
    def supports_fused_train(self) -> bool:
        """True when training runs through the one-call forward + composite +
        loss + backward op of each level (``render_rays_train``)."""
        return self._fused_train_mode is not None

    def render_rays_train(
        self,
        rays_o: torch.Tensor,                     # [B, 3]
        rays_d: torch.Tensor,                     # [B, 3] (unnormalized)
        target: torch.Tensor,                     # [B, 3]
        viewdirs: Optional[torch.Tensor] = None,  # [B, 3] normalized
        draws: Optional[Draws] = None,
        generator: Optional[torch.Generator] = None,
        occ_grid: Optional[torch.Tensor] = None,
        occ_active=True,
    ) -> Dict[str, torch.Tensor]:
        """Train-mode hierarchical render through ``fused_train_apply``
        (sinusoidal) or ``fused_ingp_train_apply`` (hash grid): per level one
        call runs encode + MLP, the transmittance scan and the colour
        composite, the squared error against ``target`` and (on CUDA) its
        whole backward, the hash tables' gradient included. On the "feats"
        route each level encodes its points first (``_encode_pos``: the
        hash kernels, or the plain gather past their budget) and packs the
        features with the rays' spherical harmonics, deltas and noise for
        ``fused_feat_train_apply``, whose d(sse)/d(feats) reaches the
        tables through the encode's backward. The two levels' table
        gradients add up through autograd (one set of tables).

        Returns {"sse_coarse", "rgb_coarse", "z_vals", "weights"
        [, "sse_fine", "rgb_fine"]}. Differentiable only through sse_*
        (loss = (sse_coarse + sse_fine) / target.numel()); the maps and
        weights are detached, as the importance sampler wants them. Draws
        ("t", "noise_c", "u", "noise_f") come from ``draws`` or
        ``generator``; the noise is unit normals scaled here by
        ``raw_noise_std``."""
        from nerf_meets_mlx_torch.kernels.fused_train import (
            TrainSpec,
            default_group,
            default_rays_block,
            fused_train_apply,
        )

        mode = self._fused_train_mode
        if mode not in ("sinusoidal", "ingp", "feats"):
            raise ValueError("render_rays_train needs the fused route (supports_fused_train)")
        rcfg = self.cfg.render
        dev = rays_o.device
        B = rays_o.shape[0]
        if viewdirs is None:
            viewdirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
        z_vals = self._coarse_z(rays_o, rays_d, True, draws, generator, occ_grid, occ_active)
        dnorm = torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
        if mode == "ingp":
            from nerf_meets_mlx_torch.kernels.fused_ingp_train import (
                fused_ingp_train_apply,
                ingp_group,
                ingp_rays_block,
            )
        elif mode == "feats":
            from nerf_meets_mlx_torch.kernels.fused_feat_train import (
                feat_group,
                feat_rays_block,
                fused_feat_train_apply,
                pack_feat_inputs,
            )
        if mode in ("ingp", "feats"):
            sh = self.dir_enc.apply(viewdirs)

        def tspec_of(S, rb, group):
            return TrainSpec(
                n_samples=S, rays_block=rb, mode=rcfg.compositing,
                density_activation=rcfg.density_activation,
                white_bkgd=rcfg.white_bkgd, group=group,
            )

        def run_level(level, z, noise_key):
            S = z.shape[1]
            deltas = torch.cat(
                [z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1
            ) * dnorm
            if rcfg.raw_noise_std > 0.0:
                noise = _draw(draws, noise_key, z.shape, "normal", generator, dev)
                noise = noise * rcfg.raw_noise_std
            else:
                noise = torch.zeros_like(z)
            if mode == "ingp":
                rb = ingp_rays_block(S)
                return fused_ingp_train_apply(
                    self._mlp(level), self.pos_enc, sh, tspec_of(S, rb, ingp_group(S, rb)),
                    rays_o, rays_d, z, deltas, noise, target,
                )
            if mode == "feats":
                rb = feat_rays_block(S)
                pts = rays_o[..., None, :] + z[..., :, None] * rays_d[..., None, :]
                x = pack_feat_inputs(self._encode_pos(pts), sh, deltas, noise)
                return fused_feat_train_apply(
                    self._mlp(level), tspec_of(S, rb, feat_group(S, rb)), x, target
                )
            rb = default_rays_block(S)
            tspec = tspec_of(S, rb, default_group(S, rb))
            return fused_train_apply(
                self._mlp(level), self.pos_enc, self.dir_enc, tspec,
                rays_o, rays_d, viewdirs, z, deltas, noise, target,
            )

        sse_c, rgb_c, weights = run_level("coarse", z_vals, "noise_c")
        ret = {"sse_coarse": sse_c, "rgb_coarse": rgb_c, "z_vals": z_vals, "weights": weights}
        if rcfg.n_importance > 0:
            u = _draw(draws, "u", (B, rcfg.n_importance), "uniform", generator, dev)
            z_imp = sample_pdf(z_vals, weights, rcfg.n_importance, deterministic=False, u=u)
            z_all = merge_z(z_vals, z_imp)
            sse_f, rgb_f, _ = run_level("fine", z_all, "noise_f")
            ret.update(sse_fine=sse_f, rgb_fine=rgb_f)
        return ret


def create_nerf(cfg: ExperimentConfig, device=None) -> NeRFModel:
    """Build a NeRFModel from config. Its parameters are allocated on
    ``device`` but not filled: call ``init(generator)`` or load a checkpoint
    (``engine/checkpoint.py``) or JAX weights (``interop.params_from_numpy``)."""
    pos_enc = make_encoding(cfg.pos_encoding, device=device)
    dir_enc = make_encoding(cfg.dir_encoding, device=device) if cfg.dir_encoding else None
    return NeRFModel(cfg, pos_enc, dir_enc, device=device)
