"""Fused Instant-NGP ops of one level each: points → hash encode → MLP →
compositing (eval), and the same plus the MSE loss and its whole backward,
the hash tables' gradient included (train).

Counterpart of ``nerf_meets_mlx_tpu/kernels/fused_ingp_train.py``. The
kernels: for the Pallas ``_ingp_eval_kernel``, ``csrc/ingp_eval_tc.cu``
(the MLP on ``wgmma`` in 3xTF32, the hash encode of the next tile beside
it) for the shapes it takes; for the Pallas ``_ingp_train_kernel``,
``csrc/ingp_train_tc.cu`` (the MLP on the tensor cores in 3xTF32, a tile's
activations and dW on chip) for the shapes it takes; ``csrc/fused_ingp.cu``
(``ingp_eval_kernel``, ``ingp_rays_kernel`` with its dW GEMM: width,
levels and features at run time) for the others. This module holds their
wrappers and plain PyTorch versions.

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
  1, 2, 4 or 8 features, at most 128 feature channels. ``eval_build`` and
  ``train_build`` route by the shape alone, before the launch: width 32 or
  64, depth 1..8, 1..16 levels of 1, 2 or 4 features (L·F <= 64) and at
  most 64 SH channels evaluate in ``csrc/ingp_eval_tc.cu`` at any sample
  count, and train in ``csrc/ingp_train_tc.cu`` where a tile of whole
  rays fits its shared memory (``tc_rays_per_tile``: at most 96 points);
  every other shape runs in ``csrc/fused_ingp.cu``. Past these bounds the
  wrapper raises, naming them.
* The spherical harmonics come in per ray, [R, DD], as the JAX op takes
  them. The weights are taken as the ``nn.Linear`` modules hold them and the
  tables as [L, T, F]; the JAX package's packed layouts are a TPU's.
* ``LAUNCHES["ingp_eval"]`` / ``LAUNCHES["ingp_train"]`` (the dict shared
  with ``fused_train``) count kernel launches, one per CUDA call.
"""

from __future__ import annotations

import ctypes
import functools
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

# Points per CUDA block of csrc/fused_ingp.cu: the block keeps the MLP's
# weights (48.6 KB at lego_ingp) and 28 bytes a point of compositing terms
# in shared memory, so ~512 points make ~63 KB and three blocks fit an SM;
# 4096 rays x 96 samples make 820 blocks.
INGP_TARGET_POINTS = 512
# dW = X^T dZ is summed over the points in splits of about this many points:
# the fine level's 393,216 points give 96 splits x 7 tiles = 672 GEMM blocks.
INGP_SPLIT_POINTS = 4096
# csrc/fused_ingp.cu, every shape the tensor-core kernels do not take: its
# bounds
RT_SOURCE = "fused_ingp"
MIN_WIDTH, MAX_WIDTH = 32, 256
RT_LEVELS = 32
RT_FEATURES = (1, 2, 4, 8)
MAX_CHANNELS = 128
# the tensor-core kernels' shapes: csrc/ingp_eval_tc.cu (eval, any sample
# count) and csrc/ingp_train_tc.cu (train, where a tile of whole rays of at
# most TC_MAX_POINTS points, a 16-row MMA tile for each of its 6 warp pairs,
# and at most TC_MAX_RAYS rays fits the block's shared memory)
EVAL_SOURCE = "ingp_eval_tc"
TC_SOURCE = "ingp_train_tc"
TC_WIDTHS = (32, 64)
MAX_LEVELS = 16
TC_FEATURES = (1, 2, 4)
TC_MAX_FEATURES = 64
TC_MAX_DEPTH = 8
TC_MAX_SH = 64
TC_MAX_POINTS = 96
TC_MAX_RAYS = 16
SMEM_LIMIT = 232448


def ingp_rays_block(n_samples: int) -> int:
    """Rays per CUDA block of the INGP kernels."""
    return max(1, INGP_TARGET_POINTS // n_samples)


def ingp_group(n_samples: int, rays_block: int) -> int:
    """Blocks of rays whose points one partial of the dW reduction sums."""
    return max(1, INGP_SPLIT_POINTS // (rays_block * n_samples))


def _ru(x: int, m: int) -> int:
    return -(-x // m) * m


def tc_smem_bytes(width: int, depth: int, n_features: int, n_channels: int, n_samples: int,
                  rays: int, points: bool = True) -> int:
    """Shared-memory bytes of one block of ``csrc/ingp_train_tc.cu``
    (``smem_layout`` there, piece by piece): the swizzled weights, heads and
    biases, the view weight's SH rows; per point of the tile its layer-0
    inputs (``n_features``: the hash features, or the feat kernel's feature
    columns), every layer's output, the compositing terms and, unless
    ``points`` is false (the feat kernel), the point; per ray its SH and
    the view layer's SH term; the dW partial."""
    W, WH, D, E = width, width // 2, depth, n_features
    sww, swh, tp = W + 8, WH + 8, _ru(rays * n_samples, 16)
    shapes = [(E, W)] + [(W, W)] * (D - 1) + [(W, 1), (W, W), (W + n_channels, WH), (WH, 3)]
    pieces = (
        _ru(E, 8) * sww, (D - 1) * W * sww, W * sww, W * swh, W, 3 * WH, D * W, W, 1, 3,
        tp * (_ru(E, 16) + 8), D * tp * sww, tp * sww, tp * swh, 3 * tp, tp, tp, tp, tp,
        3 * tp if points else 0, rays * WH, rays, _dw_layout(tuple(shapes))[1],
        n_channels * WH, rays * n_channels,
    )
    return 4 * sum(_ru(n, 4) for n in pieces)


def tc_tile_rays(width: int, depth: int, n_features: int, n_channels: int, n_samples: int,
                 points: bool = True) -> int:
    """The most whole rays, up to TC_MAX_RAYS, whose tile holds at most
    TC_MAX_POINTS points and fits the block's shared memory
    (``tc_smem_bytes``); 0 where not even one ray's does."""
    if not 1 <= n_samples <= TC_MAX_POINTS:
        return 0
    rays = min(TC_MAX_RAYS, TC_MAX_POINTS // n_samples)
    while rays >= 1 and tc_smem_bytes(width, depth, n_features, n_channels, n_samples, rays,
                                      points) > SMEM_LIMIT:
        rays -= 1
    return rays


def tc_shape(width: int, depth: int, n_levels: int, features: int, n_channels: int) -> bool:
    """Whether the tensor-core kernels take this MLP and encoding: width 32
    or 64, depth 1..8, 1..16 levels of 1, 2 or 4 features (L·F <= 64), at
    most 64 SH channels."""
    return (width in TC_WIDTHS and 1 <= depth <= TC_MAX_DEPTH and 1 <= n_levels <= MAX_LEVELS
            and features in TC_FEATURES and n_levels * features <= TC_MAX_FEATURES
            and 0 <= n_channels <= TC_MAX_SH)


def tc_rays_per_tile(width: int, depth: int, n_levels: int, features: int, n_channels: int,
                     n_samples: int) -> int:
    """Rays a tile of ``csrc/ingp_train_tc.cu`` at this shape
    (``tc_tile_rays``); 0 where that kernel does not take the shape (it
    then trains in ``csrc/fused_ingp.cu``)."""
    if not tc_shape(width, depth, n_levels, features, n_channels):
        return 0
    return tc_tile_rays(width, depth, n_levels * features, n_channels, n_samples)


def train_build(width: int, depth: int, n_levels: int, features: int, n_channels: int,
                n_samples: int):
    """(source, defines) of the build that trains this shape, decided from
    the shape alone: ``csrc/ingp_train_tc.cu`` where ``tc_rays_per_tile``
    takes it, else ``csrc/fused_ingp.cu``."""
    if tc_rays_per_tile(width, depth, n_levels, features, n_channels, n_samples):
        return TC_SOURCE, {}
    return RT_SOURCE, {}


def eval_build(width: int, depth: int, n_levels: int, features: int, n_channels: int):
    """(source, defines) of the build that evaluates this shape, decided
    from the shape alone: ``csrc/ingp_eval_tc.cu`` where ``tc_shape`` takes
    it (at any sample count: a ray longer than its tile is walked in
    segments, and the weight images that do not fit its shared memory are
    streamed), else ``csrc/fused_ingp.cu``."""
    if tc_shape(width, depth, n_levels, features, n_channels):
        return EVAL_SOURCE, {}
    return RT_SOURCE, {}


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


def pack_weights(mlp) -> Tuple[torch.Tensor, List[int]]:
    """One flat fp32 buffer with every weight as [fan_in, fan_out] (the JAX
    pytree's ``w``, i.e. ``nn.Linear.weight`` transposed) and its bias, in
    ``mlp.linears()`` order (trunk, alpha, feature, view, rgb), each piece
    on a 16-byte boundary, and the piece offsets: the weights as
    ``csrc/fused_ingp.cu`` reads them. Its train call's dW buffer has the
    same layout."""
    pieces: List[torch.Tensor] = []
    for _, lin in mlp.linears():
        pieces += [lin.weight.t(), lin.bias]
    return _pack_flat(pieces)


def _rt_lib():
    """The loaded ``csrc/fused_ingp.cu``."""
    from nerf_meets_mlx_torch.kernels import _build

    lib = _build.load_library(RT_SOURCE)
    if not getattr(lib, "_typed", False):
        vp, ci, cf, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.fused_ingp_eval_launch.argtypes = (
            [vp] * 8 + [ci] * 2 + [vp] * 2 + [ci] * 10 + [vp, cf, cf] + [ci] * 3 + [vp]
        )
        lib.fused_ingp_eval_launch.restype = ci
        lib.fused_ingp_smem_bytes.argtypes = [ci] * 7
        lib.fused_ingp_smem_bytes.restype = cll
        lib.fused_ingp_train_launch.argtypes = (
            [vp] * 10 + [ci] * 2 + [vp] * 6 + [ci] * 10 + [vp, cf, cf] + [ci] * 4 + [vp]
        )
        lib.fused_ingp_train_launch.restype = ci
        lib.fused_ingp_workspace_floats.argtypes = [ci] * 9
        lib.fused_ingp_workspace_floats.restype = cll
        lib._typed = True
    return lib


def type_eval_lib(lib):
    """``lib``, a build of csrc/ingp_eval_tc.cu, with its C functions typed."""
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ingp_eval_tc_launch.argtypes = [vp] * 7 + [cf, cf, vp]
        lib.ingp_eval_tc_launch.restype = ci
        lib.ingp_eval_tc_smem_bytes.argtypes = [ci] * 5 + [ctypes.POINTER(ci)]
        lib.ingp_eval_tc_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _eval_lib():
    """The loaded ``csrc/ingp_eval_tc.cu``."""
    from nerf_meets_mlx_torch.kernels import _build

    return type_eval_lib(_build.load_library(EVAL_SOURCE))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``: the eval kernel's persistent grid,
    one block an SM."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tc_lib():
    """The loaded ``csrc/ingp_train_tc.cu``."""
    from nerf_meets_mlx_torch.kernels import _build

    return type_tc_lib(_build.load_library(TC_SOURCE))


def type_tc_lib(lib):
    """``lib``, a build of csrc/ingp_train_tc.cu, with its C functions (the
    INGP and the feat kernel's) typed."""
    if not getattr(lib, "_typed", False):
        vp, ci, cf, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.ingp_tc_train_launch.argtypes = [vp] * 12 + [cf, cf, vp]
        lib.ingp_tc_train_launch.restype = ci
        lib.ingp_tc_smem_bytes.argtypes = [ci] * 7
        lib.ingp_tc_smem_bytes.restype = cll
        lib.feat_tc_train_launch.argtypes = [vp] * 13
        lib.feat_tc_train_launch.restype = ci
        lib.feat_tc_smem_bytes.argtypes = [ci] * 6
        lib.feat_tc_smem_bytes.restype = cll
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


def _eval_tc_launch(mlp, pos_enc, tspec: TrainSpec, args, lib=None):
    """``csrc/ingp_eval_tc.cu``: a persistent grid of one block an SM over
    the rays, reading the parameters where they are; its outputs are the
    call's only allocations. ``lib`` is another typed build of the source
    (``type_eval_lib``): tools/ingp_kernel_probe.py's timing variants and
    the one-pass control of tests/test_torch_ingp_eval.py; the package's
    route (``_eval_launch``) leaves it at the library's own."""
    from nerf_meets_mlx_torch.kernels.hash_encode import _geometry

    dev = args[0].device
    R, S = args[3].shape
    cfg = mlp.cfg
    lins = [lin for _, lin in mlp.linears()]
    if any(p.dtype != torch.float32 or not p.is_contiguous()
           for lin in lins for p in (lin.weight, lin.bias)):
        raise ValueError("the INGP eval kernel reads contiguous fp32 parameters")
    lib = _eval_lib() if lib is None else lib
    L, F, log2_t, c_res, bmin, brange, bf16 = _geometry(pos_enc)
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    wts = torch.empty((R, S), dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    shape = (ci * 13)(
        R, S, cfg.net_width, cfg.net_depth, L, F, mlp.in_dim_views, log2_t, bf16,
        0 if tspec.mode == "canonical" else 1, int(tspec.density_activation == "relu"),
        int(tspec.white_bkgd), _sm_count(dev.index),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ingp_eval_tc_launch(
            (vp * 6)(*(t.data_ptr() for t in args), pos_enc.tables.data_ptr()),
            (vp * len(lins))(*(lin.weight.data_ptr() for lin in lins)),
            (vp * len(lins))(*(lin.bias.data_ptr() for lin in lins)),
            rgb.data_ptr(), wts.data_ptr(), shape, c_res, bmin, brange, stream,
        )
    if err != 0:
        raise RuntimeError(f"ingp_eval_tc launch failed with cudaError {err}")
    LAUNCHES["ingp_eval"] += 1
    return rgb, wts


def _rt_eval_launch(mlp, pos_enc, tspec: TrainSpec, args):
    """``csrc/fused_ingp.cu``'s eval kernel over blocks of
    ``tspec.rays_block`` rays, on the weights packed for it."""
    dev = args[0].device
    R, S = args[3].shape
    lib = _rt_lib()
    wbuf, offs = pack_weights(mlp)
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


def _eval_launch(mlp, pos_enc, tspec: TrainSpec, args):
    """One eval call of the build that takes this shape (``eval_build``):
    (rgb, weights)."""
    cfg = mlp.cfg
    build = eval_build(cfg.net_width, cfg.net_depth, pos_enc.n_levels,
                       pos_enc.features_per_level, mlp.in_dim_views)[0]
    if build == EVAL_SOURCE:
        return _eval_tc_launch(mlp, pos_enc, tspec, args)
    return _rt_eval_launch(mlp, pos_enc, tspec, args)


@torch.no_grad()
def fused_ingp_eval_apply(
    mlp, pos_enc, sh, tspec: TrainSpec, rays_o, rays_d, z_vals, deltas,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-only INGP render op: (rgb_map [R, 3], weights [R, S]).

    rays_o/rays_d [R, 3]; sh [R, DD] the rays' spherical harmonics; z_vals
    and deltas [R, S] (deltas already scaled by ||rays_d||, terminal bin
    1e10·||rays_d||). CPU tensors run the plain version; CUDA tensors launch
    the kernel of the shape (``eval_build``) or raise: at the presets'
    shapes ``csrc/ingp_eval_tc.cu``, which allocates nothing but the two
    outputs and launches nothing else. Not differentiable (the kernel has
    no backward), so it runs under ``no_grad``."""
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
    return _eval_launch(mlp, pos_enc, tspec, args)


def _train_launch(mlp, pos_enc, tspec: TrainSpec, args):
    """One call of the train kernel that takes this shape: (sse, rgb,
    weights, grads) with grads = d(sse)/d(weight, bias) of every
    ``mlp.linears()`` entry, then d(sse)/d(tables) [L, T, F]."""
    cfg = mlp.cfg
    S = args[3].shape[1]
    rays = tc_rays_per_tile(cfg.net_width, cfg.net_depth, pos_enc.n_levels,
                            pos_enc.features_per_level, mlp.in_dim_views, S)
    if rays:
        return _tc_launch(mlp, pos_enc, tspec, args, rays)
    return _rt_launch(mlp, pos_enc, tspec, args)


@functools.lru_cache(maxsize=None)
def _dw_layout(shapes: Tuple[Tuple[int, int], ...]):
    """(offsets, floats) of the tensor-core kernel's gradient buffer: for
    each (fan_in, fan_out) linear its weight as [fan_out, fan_in] (the
    parameter's layout) and its bias, each piece on 16 bytes."""
    offs, n = [], 0
    for fi, fo in shapes:
        offs.append(n)
        n += _ru(fi * fo, 4)
        offs.append(n)
        n += _ru(fo, 4)
    return tuple(offs), n


def _tc_buffers(lins, R: int, S: int, rays: int, dev):
    """What a call of csrc/ingp_train_tc.cu (either kernel) writes besides
    its own outputs: (offsets and floats of the gradient buffer, blocks of
    the persistent grid, each block's dW partial and sse, rgb, weights,
    sse, the gradient buffer). The linears' parameters must be contiguous
    fp32, read where they are."""
    params = [p for lin in lins for p in (lin.weight, lin.bias)]
    if any(p.dtype != torch.float32 or not p.is_contiguous() for p in params):
        raise ValueError("the tensor-core train kernels take contiguous fp32 parameters")
    offs, n_dw = _dw_layout(tuple((lin.in_features, lin.out_features) for lin in lins))
    blocks = min(-(-R // rays), _sm_count(dev.index))
    part = torch.empty(blocks * (n_dw + 1), dtype=torch.float32, device=dev)
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    wts = torch.empty((R, S), dtype=torch.float32, device=dev)
    sse = torch.empty((1,), dtype=torch.float32, device=dev)
    dw = torch.empty((n_dw,), dtype=torch.float32, device=dev)
    return offs, n_dw, blocks, part, rgb, wts, sse, dw


def _tc_grads(lins, offs, dw) -> List[torch.Tensor]:
    """Each linear's weight [out, in] and bias gradient, as views of dw."""
    grads = []
    for i, lin in enumerate(lins):
        fi, fo = lin.in_features, lin.out_features
        grads.append(dw[offs[2 * i] : offs[2 * i] + fi * fo].view(fo, fi))
        grads.append(dw[offs[2 * i + 1] : offs[2 * i + 1] + fo])
    return grads


def _tc_launch(mlp, pos_enc, tspec: TrainSpec, args, rays: int, lib=None):
    """``csrc/ingp_train_tc.cu``: a persistent grid of one block an SM over
    tiles of ``rays`` rays, reading the parameters where they are; the
    gradients come back as views of one buffer. ``lib`` is another typed
    build of the source (``type_tc_lib``), for tools/ingp_kernel_probe.py's
    variants; every caller in the package leaves it at the library's own."""
    from nerf_meets_mlx_torch.kernels.hash_encode import _geometry

    dev = args[0].device
    R, S = args[3].shape
    cfg = mlp.cfg
    lins = [lin for _, lin in mlp.linears()]
    if pos_enc.tables.dtype != torch.float32 or not pos_enc.tables.is_contiguous():
        raise ValueError("the INGP train kernel takes contiguous fp32 tables")
    offs, n_dw, blocks, part, rgb, wts, sse, dw = _tc_buffers(lins, R, S, rays, dev)
    lib = _tc_lib() if lib is None else lib
    dG = torch.zeros(pos_enc.tables.shape, dtype=torch.float32, device=dev)
    L, F, log2_t, c_res, bmin, brange, bf16 = _geometry(pos_enc)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    shape = (ci * 15)(
        R, S, cfg.net_width, cfg.net_depth, L, F, mlp.in_dim_views, log2_t, bf16,
        0 if tspec.mode == "canonical" else 1, int(tspec.density_activation == "relu"),
        int(tspec.white_bkgd), rays, blocks, n_dw,
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ingp_tc_train_launch(
            (vp * 8)(*(t.data_ptr() for t in args), pos_enc.tables.data_ptr()),
            (vp * len(lins))(*(lin.weight.data_ptr() for lin in lins)),
            (vp * len(lins))(*(lin.bias.data_ptr() for lin in lins)),
            (ci * len(offs))(*offs), rgb.data_ptr(), wts.data_ptr(), sse.data_ptr(),
            dw.data_ptr(), dG.data_ptr(), part.data_ptr(), shape, c_res, bmin, brange, stream,
        )
    if err != 0:
        raise RuntimeError(f"ingp_train_tc launch failed with cudaError {err}")
    LAUNCHES["ingp_train"] += 1
    return sse[0], rgb, wts, _tc_grads(lins, offs, dw) + [dG]


def _rt_launch(mlp, pos_enc, tspec: TrainSpec, args):
    """``csrc/fused_ingp.cu``: the ray kernel over blocks of
    ``tspec.rays_block`` rays, its dW GEMM in splits of ``tspec.group``
    blocks, the fixed-order reduce."""
    dev = args[0].device
    R, S = args[3].shape
    cfg = mlp.cfg
    lib = _rt_lib()
    wbuf, offs = pack_weights(mlp)
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
    the train kernel of the shape (``train_build``), which computes the
    gradient in the same call, or raise. ``tspec.rays_block`` and
    ``tspec.group`` shape ``csrc/fused_ingp.cu``'s blocks; the
    tensor-core kernel sizes its tiles from the shape
    (``tc_rays_per_tile``)."""
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
