"""Fused 2-D image-learning MLP: the train step's sse with its gradient, and
the forward alone.

Counterpart of ``nerf_meets_mlx_tpu/kernels/fused_image.py``. The kernels
are ``csrc/fused_image.cu``: ``image_train_kernel`` with its split-K dW GEMM
and reduction (the Pallas ``_train_kernel``) and ``image_fwd_kernel`` (the
Pallas ``_fwd_kernel``). This module holds their wrappers and their plain
PyTorch version. The function is the image task's model: sinusoidal encode
of pixel coordinates, then the non-viewdir NeRF MLP (``NeRFMLP`` with its
output head).

* ``fused_image_train`` (sse = Σ (out − target)² over the rows and
  ``out_channels`` columns, differentiable with respect to the MLP) and
  ``fused_image_apply`` (the output [N, out_channels]) launch their kernel
  for CUDA tensors (or raise) and run ``fused_image_reference`` for CPU
  tensors. There is no other fallback.
* The weights are taken as the ``nn.Linear`` modules hold them; the JAX
  package's band matrix, zero-extended skip rows and [N, 8] padded input
  and output are a TPU layout and are not carried over.
* ``LAUNCHES["image_train"]`` / ``LAUNCHES["image_fwd"]`` (the dict shared
  with ``fused_train``) count kernel launches, one per CUDA call.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from nerf_meets_mlx_torch.kernels.fused_train import KERNEL_WIDTHS, LAUNCHES, _pack_flat

# Points per CUDA block of the forward kernel: 8 tiles of 64; a 400 x 400
# frame makes 313 blocks (one block of ~170 KB shared memory per SM).
IMAGE_FWD_BLOCK_POINTS = 512
# Points per CUDA block of the train kernel: one tile, so that a step's 4096
# pixels make 64 blocks.
IMAGE_TRAIN_BLOCK_POINTS = 64
# dW = X^T dZ is summed over the points in partials of this many points:
# 4096 pixels give 8 partials of the 36 GEMM tiles at image2d's width.
IMAGE_SPLIT_POINTS = 512


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def fused_image_reference(mlp, pos_enc, x: torch.Tensor) -> torch.Tensor:
    """The kernels' function in plain torch, differentiable by autograd:
    the output [N, out_channels] of ``mlp`` on the encoded coordinates
    ``x`` [N, in_dim]."""
    return mlp(pos_enc.apply(x))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _pieces(mlp, pos_enc, backward: bool) -> List[torch.Tensor]:
    cfg = mlp.cfg
    dev = mlp.pos_linears[0].weight.device
    pieces: List[torch.Tensor] = []
    for _, lin in mlp.linears():
        pieces += [lin.weight.t(), lin.bias]
    pieces.append(pos_enc.bands(dev))
    if backward:
        for j in range(1, cfg.net_depth):
            w = mlp.pos_linears[j].weight
            pieces.append(w[:, mlp.in_dim:] if (j - 1) in cfg.skips else w)
    return pieces


def pack_image_weights(mlp, pos_enc, backward: bool = False) -> Tuple[torch.Tensor, List[int]]:
    """One flat fp32 buffer, each piece on a 16-byte boundary, and the piece
    offsets: every weight as [fan_in, fan_out] (``nn.Linear.weight``
    transposed) and its bias, for the trunk layers and the output head (the
    skip layers' rows are [encoded input, h], input first), then the
    frequency bands (offset 2·D + 2); with ``backward`` also the hidden-input
    part of every trunk layer j ≥ 1 as ``nn.Linear.weight`` holds it (the
    transposed matrix the backward's GEMMs read; offset 2·D + 3 + j − 1).
    The train kernel's dW buffer has the layout of the first 2·D + 2
    pieces."""
    return _pack_flat(_pieces(mlp, pos_enc, backward))


def _image_lib():
    from nerf_meets_mlx_torch.kernels import _build

    lib = _build.load_library("fused_image")
    if not getattr(lib, "_typed", False):
        vp, ci, cll, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
        lib.fused_image_fwd_launch.argtypes = (
            [vp] * 3 + [ci, vp, cll] + [ci] * 3 + [cu] + [ci] * 4 + [vp]
        )
        lib.fused_image_fwd_launch.restype = ci
        lib.fused_image_train_launch.argtypes = (
            [vp] * 4 + [ci] + [vp] * 3 + [cll] + [ci] * 3 + [cu] + [ci] * 6 + [vp]
        )
        lib.fused_image_train_launch.restype = ci
        lib.fused_image_smem_bytes.argtypes = [ci] * 2
        lib.fused_image_smem_bytes.restype = cll
        lib.fused_image_workspace_floats.argtypes = [cll] + [ci] * 7
        lib.fused_image_workspace_floats.restype = cll
        lib._typed = True
    return lib


def _check_config(mlp, pos_enc, x: torch.Tensor) -> None:
    cfg = mlp.cfg
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "the CUDA image kernels compute in fp32 only; bf16 compute is queued in "
            "ROADMAP.md (the plain path runs it on the CPU)"
        )
    if cfg.use_viewdirs or not hasattr(pos_enc, "bands"):
        raise ValueError("the image kernels take a sinusoidal encoding and the output head")
    if cfg.net_width not in KERNEL_WIDTHS or not 1 <= cfg.net_depth <= 20:
        raise ValueError(
            f"the image kernels take net_width in {KERNEL_WIDTHS} and depth 1..20, not "
            f"{cfg.net_width} and {cfg.net_depth}"
        )
    if any(not 0 <= s < cfg.net_depth - 1 for s in cfg.skips):
        raise ValueError(f"unsupported skips {cfg.skips} at depth {cfg.net_depth}")
    if not 1 <= cfg.out_channels <= 4 or not 1 <= pos_enc.in_dim <= 3 or pos_enc.out_dim > 128:
        raise ValueError(
            "the image kernels take 1..4 output channels, 1..3 input dimensions and at most "
            "128 encoded features"
        )
    N = x.shape[0]
    if x.dtype != torch.float32 or tuple(x.shape) != (N, pos_enc.in_dim):
        raise ValueError(f"x: expected float32 [N, {pos_enc.in_dim}], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if mlp.pos_linears[0].weight.device != x.device:
        raise ValueError("the MLP's parameters must be on the coordinates' device")


def _common(mlp, pos_enc):
    cfg = mlp.cfg
    return (
        cfg.net_depth, cfg.net_width, sum(1 << (s + 1) for s in cfg.skips), pos_enc.in_dim,
        pos_enc.n_freqs, int(pos_enc.include_input), cfg.out_channels,
    )


def _check_smem(lib, mlp, pos_enc):
    smem = lib.fused_image_smem_bytes(mlp.cfg.net_width, pos_enc.out_dim)
    if not 0 < smem <= 232448:
        raise ValueError(f"the image kernels need {smem} bytes of shared memory per block")


@torch.no_grad()
def fused_image_apply(mlp, pos_enc, x: torch.Tensor) -> torch.Tensor:
    """Forward-only image MLP: the output [N, out_channels] of the encoded
    coordinates x [N, in_dim]. CPU tensors run the plain version; CUDA
    tensors launch ``image_fwd_kernel`` of ``csrc/fused_image.cu`` or raise.
    Not differentiable (the kernel has no backward), so it runs under
    ``no_grad``."""
    dev = x.device
    if dev.type == "cpu":
        return fused_image_reference(mlp, pos_enc, x)
    if dev.type != "cuda":
        raise ValueError(f"fused_image_apply runs on cuda or cpu tensors, not {dev}")
    _check_config(mlp, pos_enc, x)
    x = x.contiguous()
    N = x.shape[0]
    lib = _image_lib()
    _check_smem(lib, mlp, pos_enc)
    wbuf, offs = pack_image_weights(mlp, pos_enc)
    out = torch.empty((N, mlp.cfg.out_channels), dtype=torch.float32, device=dev)
    c_offs = (ctypes.c_int * len(offs))(*offs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_image_fwd_launch(
            x.data_ptr(), wbuf.data_ptr(), c_offs, len(offs), out.data_ptr(), N,
            IMAGE_FWD_BLOCK_POINTS, *_common(mlp, pos_enc), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_image forward launch failed with cudaError {err}")
    LAUNCHES["image_fwd"] += 1
    return out


def _train_launch(mlp, pos_enc, x: torch.Tensor, target: torch.Tensor):
    """One call of ``image_train_kernel`` and its dW GEMM: (sse, grads) with
    grads = d(sse)/d(weight, bias) of every ``mlp.linears()`` entry."""
    dev = x.device
    N = x.shape[0]
    cfg = mlp.cfg
    lib = _image_lib()
    _check_smem(lib, mlp, pos_enc)
    wbuf, offs = pack_image_weights(mlp, pos_enc, backward=True)
    n_dw = offs[2 * cfg.net_depth + 2]
    n_ws = lib.fused_image_workspace_floats(
        N, cfg.net_depth, cfg.net_width, pos_enc.out_dim, cfg.out_channels,
        IMAGE_TRAIN_BLOCK_POINTS, IMAGE_SPLIT_POINTS, n_dw,
    )
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    sse = torch.empty((1,), dtype=torch.float32, device=dev)
    dw = torch.empty((n_dw,), dtype=torch.float32, device=dev)
    c_offs = (ctypes.c_int * len(offs))(*offs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_image_train_launch(
            x.data_ptr(), target.data_ptr(), wbuf.data_ptr(), c_offs, len(offs), sse.data_ptr(),
            dw.data_ptr(), ws.data_ptr(), N, IMAGE_TRAIN_BLOCK_POINTS, *_common(mlp, pos_enc),
            IMAGE_SPLIT_POINTS, n_dw, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_image train launch failed with cudaError {err}")
    LAUNCHES["image_train"] += 1
    grads = []
    for i, (_, lin) in enumerate(mlp.linears()):
        o_w, o_b = offs[2 * i], offs[2 * i + 1]
        fi, fo = lin.in_features, lin.out_features
        grads.append(dw[o_w : o_w + fi * fo].view(fi, fo).t().contiguous())
        grads.append(dw[o_b : o_b + fo])
    return sse[0], grads


class _FusedImageTrain(torch.autograd.Function):
    """sse as a function of the MLP's parameters. The forward runs the
    kernel, which returns d(sse)/d(every parameter) beside the value; the
    backward scales those by the incoming sse cotangent, as the JAX op's
    VJP does (the coordinates and colours are data)."""

    @staticmethod
    def forward(ctx, launch, *params):
        sse, grads = launch()
        ctx.save_for_backward(*grads)
        return sse

    @staticmethod
    def backward(ctx, dsse):
        return (None, *(dsse * g for g in ctx.saved_tensors))


def fused_image_train(mlp, pos_enc, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """sse = Σ over the N rows and the ``out_channels`` columns of
    (out − target)², out the MLP's output on the encoded coordinates x
    [N, in_dim]; target [N, out_channels]. Differentiable with respect to
    the MLP's parameters only. CPU tensors run the plain version (autograd
    gives the gradient); CUDA tensors launch ``image_train_kernel``, which
    computes the gradient in the same call, or raise."""
    dev = x.device
    if dev.type == "cpu":
        return torch.sum((fused_image_reference(mlp, pos_enc, x) - target) ** 2)
    if dev.type != "cuda":
        raise ValueError(f"fused_image_train runs on cuda or cpu tensors, not {dev}")
    _check_config(mlp, pos_enc, x)
    N, oc = x.shape[0], mlp.cfg.out_channels
    if target.device != dev or target.dtype != torch.float32 or tuple(target.shape) != (N, oc):
        raise ValueError(f"target: expected float32 {(N, oc)} on {dev}, got {target.dtype} "
                         f"{tuple(target.shape)} on {target.device}")
    xk, tk = x.detach().contiguous(), target.detach().contiguous()
    params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]
    return _FusedImageTrain.apply(lambda: _train_launch(mlp, pos_enc, xk, tk), *params)
