"""Fused train op over precomputed features, one level at a time: the small
NeRF MLP on [feats | sh] → compositing → the MSE loss and its whole
backward, with the gradient of the features.

Counterpart of ``nerf_meets_mlx_tpu/kernels/fused_feat_train.py``. The
Pallas ``_feat_train_kernel`` has two ports, and ``train_build`` picks one
from the shape alone, before the launch: ``csrc/ingp_train_tc.cu``'s
``feat_tc_kernel`` (the INGP train kernel's tile: the MLP on the tensor
cores in 3xTF32, a tile's activations and dW on chip; widths 32 and 64,
depth 1..8, at most 64 feature and 64 SH channels, wherever a tile of
whole rays of at most 96 points fits), and ``csrc/fused_feat.cu``
(``feat_rays_kernel`` with its dW GEMM and reduction) for every other
shape. This module holds their wrappers and the plain PyTorch version.
The hash-grid configs past the fused INGP kernel's bounds (paper-size
tables, or more than 256 samples a ray) train through it
(``models/factory.py``, the "feats" route): the encoding runs outside the
op, and d(sse)/d(feats) goes back to it through autograd.

* ``fused_feat_train_apply`` launches the kernel for CUDA tensors (or
  raises) and runs ``fused_feat_train_reference`` for CPU tensors. There is
  no other fallback.
* The input is the JAX op's packed tile, x [R·S, P + D + 2] = [feats | sh
  per point | delta | noise] (``pack_feat_inputs``); the weights are taken
  as the ``nn.Linear`` modules hold them, as ``fused_ingp_train`` takes
  them. The rows of a ray must carry the ray's SH, as ``pack_feat_inputs``
  makes them: the tensor-core kernel reads each ray's SH from its first
  row (``fused_feat_train_apply`` states the precondition).
* ``LAUNCHES["feat_train"]`` (the dict shared with ``fused_train``) counts
  kernel launches, one per CUDA call.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from nerf_meets_mlx_torch.kernels import fused_ingp_train as fi
from nerf_meets_mlx_torch.kernels.fused_ingp_train import _composite, pack_weights
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES, TrainSpec, _checked_inputs

# Points per CUDA block: the block keeps the MLP's weights (53.9 KB at
# P = 32) and 28 bytes a point of compositing terms in shared memory; a ray
# longer than this gets a block of its own (2048 samples: 111 KB).
FEAT_TARGET_POINTS = 512
# dW = X^T dZ is summed over the points in splits of about this many points.
FEAT_SPLIT_POINTS = 4096
# the most samples a ray the kernel takes, as the JAX op's bound
MAX_FEAT_SAMPLES = 2048
# the register builds of csrc/fused_feat.cu: width 32 or 64, and up to 64
# feature channels, each build holding them in PP = 16, 32 or 64 registers;
# every other width that is a multiple of 16 up to MAX_WIDTH, and up to
# MAX_CHANNELS channels, runs in its runtime-shape build (FEAT_W = 0)
WIDTHS = (32, 64)
PP_SIZES = (16, 32, 64)
MIN_WIDTH, MAX_WIDTH = 32, 256
MAX_CHANNELS = 128
# the tensor-core kernel (csrc/ingp_train_tc.cu's feat_tc_kernel): the INGP
# train kernel's widths, depth, SH channels and tiles, up to TC_MAX_CHANNELS
# feature channels
TC_SOURCE = fi.TC_SOURCE
TC_MAX_CHANNELS = fi.TC_MAX_FEATURES


def tc_smem_bytes(width: int, depth: int, p_dim: int, n_channels: int, n_samples: int,
                  rays: int) -> int:
    """Shared-memory bytes of one block of the tensor-core feat kernel
    (``feat_tc_smem_bytes`` in csrc/ingp_train_tc.cu): the INGP kernel's
    budget with the ``p_dim`` feature columns as layer 0's input and no
    points."""
    return fi.tc_smem_bytes(width, depth, p_dim, n_channels, n_samples, rays, points=False)


def tc_rays_per_tile(width: int, depth: int, p_dim: int, n_channels: int, n_samples: int) -> int:
    """Rays a tile of the tensor-core feat kernel at this shape: the most
    whole rays, up to 16, that fill at most 96 points and fit the block's
    shared memory; 0 where that kernel does not take the shape."""
    if (width not in fi.TC_WIDTHS or not 1 <= depth <= fi.TC_MAX_DEPTH
            or not 1 <= p_dim <= TC_MAX_CHANNELS or not 0 <= n_channels <= fi.TC_MAX_SH):
        return 0
    return fi.tc_tile_rays(width, depth, p_dim, n_channels, n_samples, points=False)


def train_build(width: int, depth: int, p_dim: int, n_channels: int, n_samples: int):
    """(source, defines) of the build that trains this shape, decided from
    the shape alone: ``csrc/ingp_train_tc.cu`` where ``tc_rays_per_tile``
    takes it, else the ``csrc/fused_feat.cu`` build of ``kernel_defines``."""
    if tc_rays_per_tile(width, depth, p_dim, n_channels, n_samples):
        return TC_SOURCE, {}
    return "fused_feat", kernel_defines(width, p_dim)


def kernel_defines(net_width: int, p_dim: int):
    """The build of ``csrc/fused_feat.cu`` that takes this shape: the width
    and the smallest layer-0 register width PP that holds ``p_dim``, or the
    runtime-shape build (``FEAT_W = FEAT_PP = 0``) past the register builds."""
    if net_width not in WIDTHS or p_dim > PP_SIZES[-1]:
        return {"FEAT_W": 0, "FEAT_PP": 0}
    pp = next(p for p in PP_SIZES if p_dim <= p)
    return {"FEAT_W": net_width, "FEAT_PP": pp}


def feat_rays_block(n_samples: int) -> int:
    """Rays per CUDA block; raises past ``MAX_FEAT_SAMPLES``, as the JAX op
    does, where the unfused route is the way."""
    if n_samples > MAX_FEAT_SAMPLES:
        raise ValueError(
            f"n_samples={n_samples} exceeds the feat train kernel's bound "
            f"({MAX_FEAT_SAMPLES}); use the unfused path"
        )
    return max(1, FEAT_TARGET_POINTS // n_samples)


def feat_group(n_samples: int, rays_block: int) -> int:
    """Blocks of rays whose points one partial of the dW reduction sums."""
    return max(1, FEAT_SPLIT_POINTS // (rays_block * n_samples))


def pack_feat_inputs(
    feats: torch.Tensor,    # [B, S, P]
    sh: torch.Tensor,       # [B, D] per-ray spherical harmonics
    deltas: torch.Tensor,   # [B, S] pre-scaled by ||rays_d||, 1e10 terminal
    noise: torch.Tensor,    # [B, S] pre-scaled density noise (zeros if off)
) -> torch.Tensor:
    """The op's input tile [B·S, P + D + 2]. Differentiable through
    ``feats``: the op's backward gives the feature columns their gradient."""
    B, S, P = feats.shape
    shb = sh[:, None, :].expand(B, S, sh.shape[-1])
    x = torch.cat([feats, shb, deltas[..., None], noise[..., None]], dim=-1)
    return x.reshape(B * S, P + sh.shape[-1] + 2)


def _split(mlp, x: torch.Tensor):
    P, D = mlp.in_dim, mlp.in_dim_views
    return x[:, :P], x[:, P : P + D], x[:, P + D], x[:, P + D + 1]


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def fused_feat_train_reference(
    mlp, tspec: TrainSpec, x: torch.Tensor, target: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch, differentiable by autograd with
    respect to the MLP and ``x``: (sse, rgb_map [R, 3], weights [R, S])
    with sse = Σ_rays ‖rgb_map − target‖²."""
    R, S = target.shape[0], tspec.n_samples
    feats, sh, delta, noise = _split(mlp, x)
    raw = mlp(feats, sh).reshape(R, S, 4)
    rgb_map, w = _composite(tspec, raw, delta.reshape(R, S), noise.reshape(R, S))
    return torch.sum((rgb_map - target) ** 2), rgb_map, w


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------


def _feat_lib(net_width: int, p_dim: int):
    from nerf_meets_mlx_torch.kernels import _build

    lib = _build.load_library("fused_feat", kernel_defines(net_width, p_dim))
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_feat_train_launch.argtypes = (
            [vp] * 4 + [ci] * 2 + [vp] * 6 + [ci] * 11 + [vp]
        )
        lib.fused_feat_train_launch.restype = ci
        lib.fused_feat_smem_bytes.argtypes = [ci] * 5
        lib.fused_feat_smem_bytes.restype = cll
        lib.fused_feat_workspace_floats.argtypes = [ci] * 7
        lib.fused_feat_workspace_floats.restype = cll
        lib._typed = True
    return lib


def _check_feat_config(mlp) -> None:
    cfg = mlp.cfg
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "the CUDA feat train kernel computes in fp32 only; bf16 compute is queued in "
            "ROADMAP.md (the plain path runs it on the CPU)"
        )
    W = cfg.net_width
    if W % 16 or not MIN_WIDTH <= W <= MAX_WIDTH or not 1 <= mlp.in_dim <= MAX_CHANNELS:
        raise ValueError(
            f"the feat train kernel takes a net_width that is a multiple of 16 from "
            f"{MIN_WIDTH} to {MAX_WIDTH} and 1..{MAX_CHANNELS} feature channels, not "
            f"width {W} with {mlp.in_dim}"
        )
    if not cfg.use_viewdirs or cfg.skips or not 1 <= cfg.net_depth <= 8:
        raise ValueError(
            "the feat train kernel takes a view-direction MLP of depth 1..8 without skips"
        )
    if mlp.in_dim_views > 64:
        raise ValueError(f"the feat train kernel takes at most 64 sh channels, not "
                         f"{mlp.in_dim_views}")


def _train_launch(mlp, tspec: TrainSpec, x: torch.Tensor, target: torch.Tensor):
    """One call of the kernel that takes this shape (``train_build``):
    (sse, rgb, weights, grads, dfeats) with grads = d(sse)/d(weight, bias)
    of every ``mlp.linears()`` entry and dfeats = d(sse)/d(feats) [R·S, P]."""
    cfg = mlp.cfg
    rays = tc_rays_per_tile(cfg.net_width, cfg.net_depth, mlp.in_dim, mlp.in_dim_views,
                            tspec.n_samples)
    if rays:
        return _tc_launch(mlp, tspec, x, target, rays)
    return _simt_launch(mlp, tspec, x, target)


def _tc_launch(mlp, tspec: TrainSpec, x: torch.Tensor, target: torch.Tensor, rays: int,
               lib=None):
    """``csrc/ingp_train_tc.cu``'s feat kernel: a persistent grid of one
    block an SM over tiles of ``rays`` rays, reading the parameters where
    they are; the gradients come back as views of one buffer. ``lib`` is
    another typed build of the source (``fused_ingp_train.type_tc_lib``),
    for tools/ingp_kernel_probe.py's variants; every caller in the package
    leaves it at the library's own."""
    dev = x.device
    R, S, P = target.shape[0], tspec.n_samples, mlp.in_dim
    cfg = mlp.cfg
    lins = [lin for _, lin in mlp.linears()]
    offs, n_dw, blocks, part, rgb, wts, sse, dw = fi._tc_buffers(lins, R, S, rays, dev)
    lib = fi._tc_lib() if lib is None else lib
    dfeats = torch.empty((R * S, P), dtype=torch.float32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    shape = (ci * 12)(
        R, S, cfg.net_width, cfg.net_depth, P, mlp.in_dim_views,
        0 if tspec.mode == "canonical" else 1, int(tspec.density_activation == "relu"),
        int(tspec.white_bkgd), rays, blocks, n_dw,
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.feat_tc_train_launch(
            x.data_ptr(), target.data_ptr(),
            (vp * len(lins))(*(lin.weight.data_ptr() for lin in lins)),
            (vp * len(lins))(*(lin.bias.data_ptr() for lin in lins)),
            (ci * len(offs))(*offs), rgb.data_ptr(), wts.data_ptr(), sse.data_ptr(),
            dw.data_ptr(), dfeats.data_ptr(), part.data_ptr(), shape, stream,
        )
    if err != 0:
        raise RuntimeError(f"feat_tc_train launch failed with cudaError {err}")
    LAUNCHES["feat_train"] += 1
    return sse[0], rgb, wts, fi._tc_grads(lins, offs, dw), dfeats


def _simt_launch(mlp, tspec: TrainSpec, x: torch.Tensor, target: torch.Tensor):
    """``csrc/fused_feat.cu``: the ray kernel over blocks of
    ``tspec.rays_block`` rays, its dW GEMM in splits of ``tspec.group``
    blocks, the fixed-order reduce."""
    dev = x.device
    R, S = target.shape[0], tspec.n_samples
    cfg = mlp.cfg
    lib = _feat_lib(cfg.net_width, mlp.in_dim)
    wbuf, offs = pack_weights(mlp)
    n_w = wbuf.numel()
    smem = lib.fused_feat_smem_bytes(cfg.net_width, mlp.in_dim, n_w, S, tspec.rays_block)
    if not 0 < smem <= 232448:
        raise ValueError(
            f"S={S} with rays_block={tspec.rays_block} needs {smem} bytes of shared memory "
            "per block (at most 232448)"
        )
    pts_per_split = tspec.group * tspec.rays_block * S
    n_ws = lib.fused_feat_workspace_floats(
        R, S, tspec.rays_block, cfg.net_depth, cfg.net_width, pts_per_split, n_w
    )
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    wts = torch.empty((R, S), dtype=torch.float32, device=dev)
    sse = torch.empty((1,), dtype=torch.float32, device=dev)
    dw = torch.empty((n_w,), dtype=torch.float32, device=dev)
    dfeats = torch.empty((R * S, mlp.in_dim), dtype=torch.float32, device=dev)
    c_offs = (ctypes.c_int * len(offs))(*offs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_feat_train_launch(
            x.data_ptr(), target.data_ptr(), wbuf.data_ptr(), c_offs, len(offs), n_w,
            rgb.data_ptr(), wts.data_ptr(), sse.data_ptr(), dw.data_ptr(), dfeats.data_ptr(),
            ws.data_ptr(), R, S, tspec.rays_block, cfg.net_depth, cfg.net_width, mlp.in_dim,
            mlp.in_dim_views, 0 if tspec.mode == "canonical" else 1,
            int(tspec.density_activation == "relu"), int(tspec.white_bkgd), pts_per_split,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_feat train launch failed with cudaError {err}")
    LAUNCHES["feat_train"] += 1
    grads = []
    for i, (_, lin) in enumerate(mlp.linears()):
        o_w, o_b = offs[2 * i], offs[2 * i + 1]
        fi, fo = lin.in_features, lin.out_features
        grads.append(dw[o_w : o_w + fi * fo].view(fi, fo).t().contiguous())
        grads.append(dw[o_b : o_b + fo])
    return sse[0], rgb, wts, grads, dfeats


class _FusedFeatTrain(torch.autograd.Function):
    """sse as a function of x and the MLP's parameters. The forward runs the
    kernel, which returns d(sse)/d(every parameter) and d(sse)/d(feats)
    beside the values; the backward scales them by the incoming sse
    cotangent, as the JAX op's VJP does: x's feature columns get
    dsse·dfeats, its sh, delta and noise columns zero (they are data).
    rgb_map and weights are not differentiable."""

    @staticmethod
    def forward(ctx, launch, x, *params):
        sse, rgb, wts, grads, dfeats = launch()
        ctx.save_for_backward(dfeats, *grads)
        ctx.n_cols = x.shape[1]
        ctx.mark_non_differentiable(rgb, wts)
        return sse, rgb, wts

    @staticmethod
    def backward(ctx, dsse, _drgb, _dwts):
        dfeats, *grads = ctx.saved_tensors
        dx = torch.nn.functional.pad(dsse * dfeats, (0, ctx.n_cols - dfeats.shape[1]))
        return (None, dx, *(dsse * g for g in grads))


def fused_feat_train_apply(
    mlp, tspec: TrainSpec, x: torch.Tensor, target: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-call feat train op of a level: (sse, rgb_map [R, 3], weights
    [R, S]).

    x [R·S, P + D + 2] from ``pack_feat_inputs``; target [R, 3]. sse is the
    only differentiable output, with respect to the MLP's parameters and
    x's feature columns (chain them to the encoding); rgb_map and weights
    come back detached. CPU tensors run the plain version (autograd gives
    the gradient); CUDA tensors launch the kernel of the shape
    (``train_build``), which computes the gradient in the same call, or
    raise. ``tspec.rays_block`` and ``tspec.group`` shape
    ``csrc/fused_feat.cu``'s blocks; the tensor-core kernel sizes its tiles
    from the shape (``tc_rays_per_tile``).

    Precondition: the S rows of a ray carry the same SH (x's D columns are
    the ray's view direction encoded once, repeated per point, as
    ``pack_feat_inputs`` makes them). The tensor-core kernel reads each
    ray's SH from its first row only and forms the view layer's SH term
    once a ray; where a ray's rows differ there, a CUDA call of a shape it
    takes computes with the first row's SH for the whole ray, while the
    plain version and ``csrc/fused_feat.cu`` read the SH of every row. The
    call does not check it: that would read the SH columns once more."""
    dev = x.device
    if dev.type == "cpu":
        sse, rgb, wts = fused_feat_train_reference(mlp, tspec, x, target)
        return sse, rgb.detach(), wts.detach()
    if dev.type != "cuda":
        raise ValueError(f"fused_feat_train_apply runs on cuda or cpu tensors, not {dev}")
    _check_feat_config(mlp)
    if tspec.group < 1:
        raise ValueError(f"group must be at least 1, not {tspec.group}")
    R, S = target.shape[0], tspec.n_samples
    if S > MAX_FEAT_SAMPLES:
        raise ValueError(f"n_samples={S} exceeds the feat train kernel's bound "
                         f"({MAX_FEAT_SAMPLES})")
    C = mlp.in_dim + mlp.in_dim_views + 2
    (target,) = _checked_inputs(dev, tspec, R, S, (("target", target, (R, 3)),))
    if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != (R * S, C):
        raise ValueError(
            f"x: expected float32 {(R * S, C)} on {dev}, got {x.dtype} {tuple(x.shape)} "
            f"on {x.device}"
        )
    if mlp.pos_linears[0].weight.device != dev:
        raise ValueError("the MLP's parameters must be on the rays' device")
    xk = x.detach().contiguous()
    if xk.data_ptr() % 16:  # csrc/fused_feat.cu's dW GEMM reads x's rows as float4
        xk = xk.clone()
    params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]
    return _FusedFeatTrain.apply(lambda: _train_launch(mlp, tspec, xk, target), x, *params)
