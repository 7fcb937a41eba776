"""Training engine.

Counterpart of ``nerf_meets_mlx_tpu/engine/trainer.py``. One train step:

    pixel sampling on the device -> rays -> coarse level -> detached
    inverse-CDF importance samples -> fine level -> joint loss
    MSE(coarse) + MSE(fine) -> gradients -> Adam update.

On the fused route (``model.supports_fused_train``) each level is one
``fused_train_apply`` call, which returns the level's SSE and, on CUDA,
computes its gradient in the same kernel launch; otherwise the standard
route runs with autograd. Random draws come from a ``torch.Generator`` on
the device, or are injected (``draws``) so that a test can replay the JAX
package's threefry draws.

The host never waits for the device inside a step: the step count lives on
the host, the lr is computed there, and ``Trainer.run`` reads a scalar only
every ``sync_every`` steps and at the logging cadence.

``make_image_train_step`` is the 2-D image task's step (pixel batch ->
MLP -> MSE -> Adam), run by the same ``Trainer``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from nerf_meets_mlx_torch.cameras.rays import get_rays_for_pixels, ndc_rays
from nerf_meets_mlx_torch.config import ExperimentConfig
from nerf_meets_mlx_torch.engine.train_state import TrainState
from nerf_meets_mlx_torch.models.factory import Draws
from nerf_meets_mlx_torch.ops.metrics import mse_to_psnr
from nerf_meets_mlx_torch.utils.logging import MetricsLogger


def _get(draws: Optional[Draws], key: str):
    return None if draws is None else draws.get(key)


def sample_train_rays(
    cfg: ExperimentConfig,
    step: int,
    images: torch.Tensor,   # [N, H, W, 3] on the device
    poses: torch.Tensor,    # [N, 3, 4] on the device
    K: torch.Tensor,        # [3, 3] on the device
    H: int,
    W: int,
    n_rand: int,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Draws] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A random training image, ``n_rand`` of its pixels (inside the central
    crop while ``step < precrop_iters``) and their rays: (rays_o, rays_d,
    target), each [n_rand, 3].

    "replacement" draws x and y uniformly; "no_replacement" ranks one
    uniform score per pixel (pixels outside the window get 2) and takes the
    ``n_rand`` smallest, as the JAX package's top-k does. The image index
    ("img_i"), the pixel draws ("px", "py") or the scores ("scores", [H·W])
    may be injected through ``draws``."""
    dev = images.device
    img_i = _get(draws, "img_i")
    if img_i is None:
        img_i = torch.randint(0, images.shape[0], (), generator=generator, device=dev)
    target_img = images[img_i]
    c2w = poses[img_i]

    h_lo, h_hi, w_lo, w_hi = 0, H, 0, W
    if cfg.train.precrop_iters > 0 and step < cfg.train.precrop_iters:
        frac = cfg.train.precrop_frac
        h_lo, h_hi = int(H * (0.5 - frac / 2)), int(H * (0.5 + frac / 2))
        w_lo, w_hi = int(W * (0.5 - frac / 2)), int(W * (0.5 + frac / 2))
    if cfg.train.pixel_sampling == "no_replacement":
        scores = _get(draws, "scores")
        if scores is None:
            scores = torch.rand((H * W,), generator=generator, device=dev)
        flat = torch.arange(H * W, device=dev)
        ys, xs = flat // W, flat % W
        valid = (ys >= h_lo) & (ys < h_hi) & (xs >= w_lo) & (xs < w_hi)
        scores = torch.where(valid, scores, torch.full_like(scores, 2.0))
        pick = torch.topk(-scores, n_rand).indices
        px, py = pick % W, pick // W
    elif cfg.train.pixel_sampling == "replacement":
        px, py = _get(draws, "px"), _get(draws, "py")
        if px is None:
            px = torch.randint(w_lo, w_hi, (n_rand,), generator=generator, device=dev)
        if py is None:
            py = torch.randint(h_lo, h_hi, (n_rand,), generator=generator, device=dev)
    else:
        raise ValueError(f"unknown pixel_sampling: {cfg.train.pixel_sampling}")
    rays_o, rays_d = get_rays_for_pixels(K, c2w, px, py, device=dev)
    return rays_o, rays_d, target_img[py, px]


def nerf_loss_fn(
    model,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    target: torch.Tensor,
    viewdirs: Optional[torch.Tensor] = None,
    fused_train: bool = False,
    draws: Optional[Draws] = None,
    generator: Optional[torch.Generator] = None,
    occ_grid: Optional[torch.Tensor] = None,
    occ_active=True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics): loss = MSE(coarse) + MSE(fine); on the fused route
    the levels return SSEs and each MSE is its SSE / target.numel()."""
    occ = {"occ_grid": occ_grid, "occ_active": occ_active}
    if fused_train:
        out = model.render_rays_train(
            rays_o, rays_d, target, viewdirs=viewdirs, draws=draws, generator=generator, **occ
        )
        denom = float(target.numel())
        loss_c = out["sse_coarse"] / denom
        loss_f = out["sse_fine"] / denom if "sse_fine" in out else None
    else:
        out = model.render_rays(
            rays_o, rays_d, train=True, viewdirs=viewdirs, draws=draws, generator=generator,
            **occ,
        )
        loss_c = torch.mean((out["rgb_coarse"] - target) ** 2)
        loss_f = torch.mean((out["rgb_fine"] - target) ** 2) if "rgb_fine" in out else None
    aux = {"loss_coarse": loss_c}
    loss = loss_c
    if loss_f is not None:
        loss = loss_c + loss_f
        aux["loss_fine"] = loss_f
    aux["psnr"] = mse_to_psnr(loss_f if loss_f is not None else loss_c)
    aux["loss"] = loss
    return loss, aux


def maybe_update_occupancy(
    model, state: TrainState, generator: Optional[torch.Generator] = None,
    draws: Optional[Draws] = None,
):
    """The occupancy grid's upkeep inside a train step: every
    ``occ_update_every`` steps (step 0 included) the grid is EMA-updated from
    the parameters as they stand before this step's update, and its use is
    gated on ``step >= occ_warmup``. Both are decided from the host-side
    step, so the host never waits for the device. The cell jitter is
    ``draws["occ_u"]`` or a draw from ``generator``. Returns (occ_grid,
    occ_active); (None, True) when the grid is off."""
    rcfg = model.cfg.render
    if not rcfg.occupancy or state.occ_grid is None:
        return None, True
    if state.step % rcfg.occ_update_every == 0:
        from nerf_meets_mlx_torch.acceleration.occupancy import update_occupancy_grid

        state.occ_grid = update_occupancy_grid(
            model, state.occ_grid, rcfg.occ_decay, u=_get(draws, "occ_u"), generator=generator
        )
    return state.occ_grid, state.step >= rcfg.occ_warmup


def make_nerf_train_step(model, H: int, W: int, focal: float, n_inner: int = 1) -> Callable:
    """step(state, images [N,H,W,3], poses [N,3,4], generator, draws=None)
    -> metrics: ``n_inner`` optimizer steps (a plain loop), each sampling
    its rays on the device; returns the last step's metrics as device
    scalars. The state's parameters and optimizer are updated in place."""
    cfg = model.cfg
    fused_train = model.supports_fused_train
    # on the device once: a host tensor per step would wait for the device
    K = torch.tensor(
        [[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
        dtype=torch.float32, device=model.device,
    )

    def body(state: TrainState, images, poses, generator, draws):
        rays_o, rays_d, target = sample_train_rays(
            cfg, state.step, images, poses, K, H, W, cfg.train.n_rand, generator, draws
        )
        viewdirs = None
        if cfg.render.ndc:
            # forward-facing captures: train in NDC, the view head sees the
            # world-space directions
            viewdirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
            rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
        occ_grid, occ_active = maybe_update_occupancy(model, state, generator, draws)
        loss, aux = nerf_loss_fn(
            model, rays_o, rays_d, target, viewdirs, fused_train=fused_train,
            draws=draws, generator=generator, occ_grid=occ_grid, occ_active=occ_active,
        )
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in aux.items()}

    def step(state: TrainState, images, poses, generator=None, draws=None):
        aux = {}
        for _ in range(max(1, n_inner)):
            aux = body(state, images, poses, generator, draws)
        return aux

    return step


# ---------------------------------------------------------------------------
# 2-D image-learning train step
# ---------------------------------------------------------------------------


def make_image_train_step(model) -> Callable:
    """step(state, coords [N, 2], colors [N, 3], generator=None, draws=None)
    -> metrics: one optimizer step on ``n_rand`` pixels drawn uniformly
    with replacement (``draws["idx"]`` or from ``generator``), regressing
    their colours directly. With ``use_fused_kernel`` (a sinusoidal
    non-viewdir model) the loss is one ``fused_image_train`` call (on CUDA
    the train kernel returns the gradient in the same launch), loss =
    sse / y.numel(); otherwise ``model.query`` and the MSE by autograd. Adam
    as ``TrainState`` configures it (the image task's lr 1e-3, b2 0.99,
    constant lr)."""
    cfg = model.cfg
    batch = cfg.train.n_rand
    use_fused = (
        cfg.use_fused_kernel
        and not cfg.mlp.use_viewdirs
        and cfg.pos_encoding.kind == "sinusoidal"
    )

    def step(state: TrainState, coords, colors, generator=None, draws=None):
        idx = _get(draws, "idx")
        if idx is None:
            idx = torch.randint(0, coords.shape[0], (batch,), generator=generator,
                                device=coords.device)
        idx = idx.to(coords.device)
        xb, y = coords[idx], colors[idx]
        if use_fused:
            from nerf_meets_mlx_torch.kernels.fused_image import fused_image_train

            loss = fused_image_train(model.coarse, model.pos_enc, xb, y) / float(y.numel())
        else:
            pred = model.query("coarse", xb[:, None, :], None)[:, 0, :]
            loss = torch.mean((pred - y) ** 2)
        loss.backward()
        state.apply_gradients()
        loss = loss.detach()
        return {"loss": loss, "psnr": mse_to_psnr(loss)}

    return step


class Trainer:
    """Host loop: owns the train state and the draws' generator, runs the
    step function, and handles the logging cadence, checkpoints and
    resume."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        model,
        step_fn: Callable,
        step_args: Tuple,
        log_dir: Optional[str | Path] = None,
        save_secs: float = 300.0,
        nan_check: bool = False,
    ):
        self.cfg = cfg
        self.model = model
        self.step_fn = step_fn
        self.step_args = step_args
        # wall-clock checkpoint cadence beside i_weights; 0 disables
        self.save_secs = save_secs
        self.nan_check = nan_check
        model.init(torch.Generator().manual_seed(cfg.train.seed))
        occ = None
        if cfg.render.occupancy:
            from nerf_meets_mlx_torch.acceleration.occupancy import init_occupancy_grid

            occ = init_occupancy_grid(cfg.render.occ_resolution, device=model.device)
        self.state = TrainState(model, cfg.train, occ_grid=occ)
        self.generator = torch.Generator(device=model.device).manual_seed(cfg.train.seed + 1)
        self.log_dir = Path(log_dir or Path(cfg.train.log_dir) / cfg.train.exp_name)
        self.logger = MetricsLogger(self.log_dir / "metrics.jsonl")
        self._t_saved = time.perf_counter()
        self._t_last = time.perf_counter()
        self._steps_last = 0

    @property
    def step(self) -> int:
        return self.state.step

    def restore(self) -> int:
        """Resume from the latest checkpoint in log_dir, if any."""
        from nerf_meets_mlx_torch.engine.checkpoint import latest_step, restore_checkpoint

        s = latest_step(self.log_dir / "ckpt")
        if s is not None:
            self.state.step = restore_checkpoint(
                self.log_dir / "ckpt", self.model, s, self.state.optimizer, self.generator,
                occ_grid=self.state.occ_grid,
            )
            self._steps_last = self.step
        return self.step

    def save(self):
        from nerf_meets_mlx_torch.engine.checkpoint import save_checkpoint

        save_checkpoint(
            self.log_dir / "ckpt", self.model, self.step, self.state.optimizer, self.generator,
            occ_grid=self.state.occ_grid,
        )

    def run(
        self,
        n_steps: int,
        log_every: Optional[int] = None,
        sync_every: int = 50,
    ) -> Dict[str, float]:
        """Run n_steps; returns the last metrics as floats.

        One scalar is read every ``sync_every`` steps, which bounds how far
        the host runs ahead of the device, and all metrics are read at the
        logging cadence (``i_print``)."""
        log_every = log_every or self.cfg.train.i_print
        metrics: Dict[str, torch.Tensor] = {}
        target = self.step + n_steps
        while self.step < target:
            prev = self.step
            metrics = self.step_fn(self.state, *self.step_args, self.generator)
            step = self.step
            if self.nan_check and not bool(torch.isfinite(metrics["loss"])):
                raise FloatingPointError(f"non-finite loss at step {step}")
            if sync_every and (step // sync_every) > (prev // sync_every):
                float(metrics["loss"])
            if log_every and (step // log_every) > (prev // log_every):
                floats = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                rate = (step - self._steps_last) / max(now - self._t_last, 1e-9)
                self._t_last, self._steps_last = now, step
                self.logger.log(step=step, steps_per_sec=rate, **floats)
            i_w = self.cfg.train.i_weights
            if i_w and (step // i_w) > (prev // i_w):
                self.save()
                self._t_saved = time.perf_counter()
            elif self.save_secs and time.perf_counter() - self._t_saved > self.save_secs:
                self.save()
                self._t_saved = time.perf_counter()
        return {k: float(v) for k, v in metrics.items()}
