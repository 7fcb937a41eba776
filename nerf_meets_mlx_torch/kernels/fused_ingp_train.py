"""Fused Instant-NGP ops of one level each: points → hash encode → MLP →
compositing (eval), and the same plus the MSE loss and its whole backward,
the hash tables' gradient included (train).

Counterpart of ``nerf_meets_mlx_tpu/kernels/fused_ingp_train.py``. The
kernels are ``csrc/fused_ingp.cu``: ``ingp_eval_kernel`` (the Pallas
``_ingp_eval_kernel``) and ``ingp_rays_kernel`` with its dW GEMM (the Pallas
``_ingp_train_kernel``). This module holds their wrappers and plain PyTorch
versions.

* ``fused_ingp_eval_apply`` / ``fused_ingp_train_apply`` launch their kernel
  for CUDA tensors (or raise) and run ``fused_ingp_eval_reference`` /
  ``fused_ingp_train_reference`` for CPU tensors. There is no other
  fallback.
* The plain versions are the XLA composition that the JAX package's
  ``fused_ingp_train_reference`` describes: the hash encode in the
  kernels' compute type (``hash_encode_reference``: the gather encode in
  fp32, the Pallas kernel's roundings in bf16), the ``NeRFMLP`` over
  [features, sh], and the compositing of ``kernels/fused_train.py``; the
  train version is differentiable by autograd with respect to the MLP and
  the tables.
* Shapes: a width that is a multiple of 16 from 32 to 256, 1..32 levels of
  1, 2, 4 or 8 features, at most 128 feature channels. Width 32 or 64 with
  1..16 levels of 1, 2 or 4 features runs in a register build, one for each
  (width, PP) pair, PP the smallest of 16, 32, 64 that holds the L·F
  features; every other shape runs in the runtime-shape build
  (``kernel_defines``), where the MLP's activations live in local memory.
  Past these bounds the wrapper raises, naming them.
* The spherical harmonics come in per ray, [R, DD], as the JAX op takes
  them. The weights are taken as the ``nn.Linear`` modules hold them and the
  tables as [L, T, F]; the JAX package's packed layouts are a TPU's.
* ``LAUNCHES["ingp_eval"]`` / ``LAUNCHES["ingp_train"]`` (the dict shared
  with ``fused_train``) count kernel launches, one per CUDA call.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from nerf_meets_mlx_torch.kernels.fused_train import (
    LAUNCHES,
    TrainSpec,
    _alpha_terms,
    _checked_inputs,
    _pack_flat,
)
from nerf_meets_mlx_torch.rendering.volume import exclusive_cumsum

# Points per CUDA block: the block keeps the MLP's weights (48.6 KB at
# lego_ingp) and 28 bytes a point of compositing terms in shared memory, so
# ~512 points make ~63 KB and three blocks fit an SM; 4096 rays x 96 samples
# make 820 blocks.
INGP_TARGET_POINTS = 512
# dW = X^T dZ is summed over the points in splits of about this many points:
# the fine level's 393,216 points give 96 splits x 7 tiles = 672 GEMM blocks.
INGP_SPLIT_POINTS = 4096
# the register builds of csrc/fused_ingp.cu: (width, layer-0 columns) pairs
# of up to MAX_LEVELS levels of 1, 2 or 4 features
WIDTHS = (32, 64)
PP_SIZES = (16, 32, 64)
MAX_LEVELS = 16
# the bounds of its runtime-shape build (INGP_W = 0)
MIN_WIDTH, MAX_WIDTH = 32, 256
RT_LEVELS = 32
RT_FEATURES = (1, 2, 4, 8)
MAX_CHANNELS = 128


def ingp_rays_block(n_samples: int) -> int:
    """Rays per CUDA block of the INGP kernels."""
    return max(1, INGP_TARGET_POINTS // n_samples)


def ingp_group(n_samples: int, rays_block: int) -> int:
    """Blocks of rays whose points one partial of the dW reduction sums."""
    return max(1, INGP_SPLIT_POINTS // (rays_block * n_samples))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _composite(tspec: TrainSpec, raw: torch.Tensor, deltas: torch.Tensor, noise=None):
    raw_sigma = raw[..., 3] if noise is None else raw[..., 3] + noise
    q, alpha = _alpha_terms(tspec, raw_sigma, deltas)
    w = alpha * torch.exp(-exclusive_cumsum(q))
    c = torch.sigmoid(raw[..., :3]) if tspec.mode == "canonical" else raw[..., :3]
    rgb_map = torch.sum(w[..., None] * c, dim=1)
    if tspec.white_bkgd:
        rgb_map = rgb_map + (1.0 - torch.sum(w, dim=1, keepdim=True))
    return rgb_map, w


def _raw(mlp, pos_enc, sh, rays_o, rays_d, z_vals) -> torch.Tensor:
    from nerf_meets_mlx_torch.kernels.hash_encode import hash_encode_reference

    R, S = z_vals.shape
    pts = rays_o[:, None, :] + z_vals[..., None] * rays_d[:, None, :]
    feats = hash_encode_reference(pos_enc, pts.reshape(R * S, 3))
    shb = sh[:, None, :].expand(R, S, sh.shape[-1]).reshape(R * S, sh.shape[-1])
    return mlp(feats, shb).reshape(R, S, 4)


def fused_ingp_eval_reference(
    mlp, pos_enc, sh, tspec: TrainSpec, rays_o, rays_d, z_vals, deltas,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval kernel's function in plain torch: (rgb_map [R, 3], weights
    [R, S])."""
    return _composite(tspec, _raw(mlp, pos_enc, sh, rays_o, rays_d, z_vals), deltas)


def fused_ingp_train_reference(
    mlp, pos_enc, sh, tspec: TrainSpec, rays_o, rays_d, z_vals, deltas, noise, target,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The train kernel's function in plain torch, differentiable by
    autograd: (sse, rgb_map [R, 3], weights [R, S]) with the pre-scaled
    density ``noise`` [R, S] added to the raw densities and
    sse = Σ_rays ‖rgb_map − target‖²."""
    rgb_map, w = _composite(
        tspec, _raw(mlp, pos_enc, sh, rays_o, rays_d, z_vals), deltas, noise
    )
    return torch.sum((rgb_map - target) ** 2), rgb_map, w


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def pack_weights(mlp, rows0: int = 0) -> Tuple[torch.Tensor, List[int]]:
    """One flat fp32 buffer with every weight as [fan_in, fan_out] (the JAX
    pytree's ``w``, i.e. ``nn.Linear.weight`` transposed) and its bias, in
    ``mlp.linears()`` order (trunk, alpha, feature, view, rgb), each piece
    on a 16-byte boundary, and the piece offsets. With ``rows0`` the first
    layer's weight is padded with zero rows to ``rows0`` (the INGP kernels'
    layer-0 register width PP: they multiply all PP columns, the padding
    ones zero). The train kernel's dW buffer has the same layout; its
    padding rows are not read back."""
    pieces: List[torch.Tensor] = []
    for i, (_, lin) in enumerate(mlp.linears()):
        w = lin.weight.t()
        if i == 0 and rows0 > w.shape[0]:
            w = torch.cat([w, w.new_zeros((rows0 - w.shape[0], w.shape[1]))])
        pieces += [w, lin.bias]
    return _pack_flat(pieces)


def kernel_defines(net_width: int, n_levels: int, features_per_level: int):
    """The build of ``csrc/fused_ingp.cu`` that takes this shape: the
    width and the smallest layer-0 register width PP that holds the L·F
    hash features, or the runtime-shape build (``INGP_W = INGP_PP = 0``)
    past the register builds."""
    n_features = n_levels * features_per_level
    if (net_width not in WIDTHS or n_levels > MAX_LEVELS or features_per_level not in (1, 2, 4)
            or n_features > PP_SIZES[-1]):
        return {"INGP_W": 0, "INGP_PP": 0}
    pp = next(p for p in PP_SIZES if n_features <= p)
    return {"INGP_W": net_width, "INGP_PP": pp}


def _defines(mlp, pos_enc):
    return kernel_defines(mlp.cfg.net_width, pos_enc.n_levels, pos_enc.features_per_level)


def _layer0_rows(mlp, pos_enc) -> int:
    return _defines(mlp, pos_enc)["INGP_PP"]


def _ingp_lib(mlp, pos_enc):
    from nerf_meets_mlx_torch.kernels import _build

    lib = _build.load_library("fused_ingp", _defines(mlp, pos_enc))
    if not getattr(lib, "_typed", False):
        vp, ci, cf, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.fused_ingp_eval_launch.argtypes = (
            [vp] * 8 + [ci] * 2 + [vp] * 2 + [ci] * 10 + [vp, cf, cf] + [ci] * 3 + [vp]
        )
        lib.fused_ingp_eval_launch.restype = ci
        lib.fused_ingp_train_launch.argtypes = (
            [vp] * 10 + [ci] * 2 + [vp] * 6 + [ci] * 10 + [vp, cf, cf] + [ci] * 4 + [vp]
        )
        lib.fused_ingp_train_launch.restype = ci
        lib.fused_ingp_smem_bytes.argtypes = [ci] * 7
        lib.fused_ingp_smem_bytes.restype = cll
        lib.fused_ingp_workspace_floats.argtypes = [ci] * 9
        lib.fused_ingp_workspace_floats.restype = cll
        lib._typed = True
    return lib


def _check_ingp_config(mlp, pos_enc, sh, kernel: str) -> None:
    from nerf_meets_mlx_torch.kernels.hash_encode import check_hash_encoding

    cfg = mlp.cfg
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"the CUDA INGP {kernel} kernel computes the MLP in fp32 only; bf16 MLP compute "
            "is queued in ROADMAP.md (the plain path runs it on the CPU)"
        )
    check_hash_encoding(pos_enc)
    L, F, W = pos_enc.n_levels, pos_enc.features_per_level, cfg.net_width
    if (W % 16 or not MIN_WIDTH <= W <= MAX_WIDTH or not 1 <= L <= RT_LEVELS
            or F not in RT_FEATURES or L * F > MAX_CHANNELS):
        raise ValueError(
            f"the fused INGP kernels take a net_width that is a multiple of 16 from "
            f"{MIN_WIDTH} to {MAX_WIDTH}, 1..{RT_LEVELS} levels of {RT_FEATURES} features "
            f"and at most {MAX_CHANNELS} feature channels, not width {W}, {L} levels of {F}"
        )
    if not cfg.use_viewdirs or cfg.skips or not 1 <= cfg.net_depth <= 8:
        raise ValueError(
            "the fused INGP kernels take a view-direction MLP of depth 1..8 without skips"
        )
    if sh.shape[-1] != mlp.in_dim_views or sh.shape[-1] > 64:
        raise ValueError(f"sh has {sh.shape[-1]} channels, the MLP takes {mlp.in_dim_views}")
    for name, p in (("MLP", mlp.pos_linears[0].weight), ("tables", pos_enc.tables)):
        if p.device != sh.device:
            raise ValueError(f"the {name} parameters must be on the rays' device")


def _common_args(mlp, pos_enc, tspec: TrainSpec, R: int, S: int):
    from nerf_meets_mlx_torch.kernels.hash_encode import _geometry

    cfg = mlp.cfg
    L, F, log2_t, c_res, bmin, brange, bf16 = _geometry(pos_enc)
    return (
        R, S, tspec.rays_block, cfg.net_depth, cfg.net_width, L, F, bf16, mlp.in_dim_views,
        log2_t, c_res, bmin, brange, 0 if tspec.mode == "canonical" else 1,
        int(tspec.density_activation == "relu"), int(tspec.white_bkgd),
    )


def _check_smem(lib, mlp, pos_enc, n_w: int, tspec: TrainSpec, S: int, train: bool):
    smem = lib.fused_ingp_smem_bytes(
        mlp.cfg.net_width, pos_enc.n_levels, pos_enc.features_per_level, n_w, S,
        tspec.rays_block, int(train),
    )
    if not 0 < smem <= 232448:
        raise ValueError(
            f"S={S} with rays_block={tspec.rays_block} needs {smem} bytes of shared memory "
            "per block (at most 232448)"
        )


@torch.no_grad()
def fused_ingp_eval_apply(
    mlp, pos_enc, sh, tspec: TrainSpec, rays_o, rays_d, z_vals, deltas,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-only INGP render op: (rgb_map [R, 3], weights [R, S]).

    rays_o/rays_d [R, 3]; sh [R, DD] the rays' spherical harmonics; z_vals
    and deltas [R, S] (deltas already scaled by ||rays_d||, terminal bin
    1e10·||rays_d||). CPU tensors run the plain version; CUDA tensors launch
    ``csrc/fused_ingp.cu`` or raise. Not differentiable (the kernel has no
    backward), so it runs under ``no_grad``."""
    dev = rays_o.device
    if dev.type == "cpu":
        return fused_ingp_eval_reference(mlp, pos_enc, sh, tspec, rays_o, rays_d, z_vals, deltas)
    if dev.type != "cuda":
        raise ValueError(f"fused_ingp_eval_apply runs on cuda or cpu tensors, not {dev}")
    _check_ingp_config(mlp, pos_enc, sh, "eval")
    R, S = z_vals.shape
    args = _checked_inputs(dev, tspec, R, S, (
        ("rays_o", rays_o, (R, 3)), ("rays_d", rays_d, (R, 3)),
        ("sh", sh, (R, sh.shape[-1])), ("z_vals", z_vals, (R, S)), ("deltas", deltas, (R, S)),
    ))
    lib = _ingp_lib(mlp, pos_enc)
    wbuf, offs = pack_weights(mlp, _layer0_rows(mlp, pos_enc))
    _check_smem(lib, mlp, pos_enc, wbuf.numel(), tspec, S, train=False)
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    wts = torch.empty((R, S), dtype=torch.float32, device=dev)
    c_offs = (ctypes.c_int * len(offs))(*offs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_ingp_eval_launch(
            *(t.data_ptr() for t in args), pos_enc.tables.data_ptr(), wbuf.data_ptr(),
            c_offs, len(offs), wbuf.numel(), rgb.data_ptr(), wts.data_ptr(),
            *_common_args(mlp, pos_enc, tspec, R, S), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_ingp eval launch failed with cudaError {err}")
    LAUNCHES["ingp_eval"] += 1
    return rgb, wts


def _train_launch(mlp, pos_enc, tspec: TrainSpec, args):
    """One call of the train kernel: (sse, rgb, weights, grads) with grads =
    d(sse)/d(weight, bias) of every ``mlp.linears()`` entry, then
    d(sse)/d(tables) [L, T, F]."""
    dev = args[0].device
    R, S = args[3].shape
    cfg = mlp.cfg
    lib = _ingp_lib(mlp, pos_enc)
    wbuf, offs = pack_weights(mlp, _layer0_rows(mlp, pos_enc))
    n_w = wbuf.numel()
    _check_smem(lib, mlp, pos_enc, n_w, tspec, S, train=True)
    pts_per_split = tspec.group * tspec.rays_block * S
    n_ws = lib.fused_ingp_workspace_floats(
        R, S, tspec.rays_block, cfg.net_depth, cfg.net_width, pos_enc.out_dim,
        mlp.in_dim_views, pts_per_split, n_w,
    )
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    wts = torch.empty((R, S), dtype=torch.float32, device=dev)
    sse = torch.empty((1,), dtype=torch.float32, device=dev)
    dw = torch.empty((n_w,), dtype=torch.float32, device=dev)
    dG = torch.zeros(pos_enc.tables.shape, dtype=torch.float32, device=dev)
    c_offs = (ctypes.c_int * len(offs))(*offs)
    common = _common_args(mlp, pos_enc, tspec, R, S)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_ingp_train_launch(
            *(t.data_ptr() for t in args), pos_enc.tables.data_ptr(), wbuf.data_ptr(),
            c_offs, len(offs), n_w, rgb.data_ptr(), wts.data_ptr(), sse.data_ptr(),
            dw.data_ptr(), dG.data_ptr(), ws.data_ptr(), *common, pts_per_split, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_ingp train launch failed with cudaError {err}")
    LAUNCHES["ingp_train"] += 1
    grads = []
    for i, (_, lin) in enumerate(mlp.linears()):
        o_w, o_b = offs[2 * i], offs[2 * i + 1]
        fi, fo = lin.in_features, lin.out_features
        grads.append(dw[o_w : o_w + fi * fo].view(fi, fo).t().contiguous())
        grads.append(dw[o_b : o_b + fo])
    grads.append(dG)
    return sse[0], rgb, wts, grads


class _FusedIngpTrain(torch.autograd.Function):
    """sse as a function of the MLP's parameters and the hash tables. The
    forward runs the kernel, which returns d(sse)/d(every parameter) beside
    the values; the backward scales those by the incoming sse cotangent, as
    the JAX op's VJP does. rgb_map and weights are not differentiable."""

    @staticmethod
    def forward(ctx, launch, *params):
        sse, rgb, wts, grads = launch()
        ctx.save_for_backward(*grads)
        ctx.mark_non_differentiable(rgb, wts)
        return sse, rgb, wts

    @staticmethod
    def backward(ctx, dsse, _drgb, _dwts):
        return (None, *(dsse * g for g in ctx.saved_tensors))


def fused_ingp_train_apply(
    mlp, pos_enc, sh, tspec: TrainSpec, rays_o, rays_d, z_vals, deltas, noise, target,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-call INGP train op of a level: (sse, rgb_map [R, 3], weights
    [R, S]).

    Inputs as ``fused_ingp_eval_apply``'s plus the pre-scaled density noise
    [R, S] (zeros when off) and the target colours [R, 3]. sse is the only
    differentiable output, with respect to the MLP's parameters and
    ``pos_enc.tables``; rgb_map and weights come back detached. CPU tensors
    run the plain version (autograd gives the gradient); CUDA tensors launch
    ``csrc/fused_ingp.cu``, which computes the gradient in the same call, or
    raise."""
    dev = rays_o.device
    if dev.type == "cpu":
        sse, rgb, wts = fused_ingp_train_reference(
            mlp, pos_enc, sh, tspec, rays_o, rays_d, z_vals, deltas, noise, target,
        )
        return sse, rgb.detach(), wts.detach()
    if dev.type != "cuda":
        raise ValueError(f"fused_ingp_train_apply runs on cuda or cpu tensors, not {dev}")
    _check_ingp_config(mlp, pos_enc, sh, "train")
    if tspec.group < 1:
        raise ValueError(f"group must be at least 1, not {tspec.group}")
    R, S = z_vals.shape
    args = _checked_inputs(dev, tspec, R, S, (
        ("rays_o", rays_o, (R, 3)), ("rays_d", rays_d, (R, 3)),
        ("sh", sh, (R, sh.shape[-1])), ("z_vals", z_vals, (R, S)), ("deltas", deltas, (R, S)),
        ("noise", noise, (R, S)), ("target", target, (R, 3)),
    ))
    params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]
    return _FusedIngpTrain.apply(
        lambda: _train_launch(mlp, pos_enc, tspec, args), *params, pos_enc.tables
    )
