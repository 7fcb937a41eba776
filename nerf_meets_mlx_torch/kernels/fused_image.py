"""Fused 2-D image-learning MLP: the train step's sse with its gradient, and
the forward alone.

Counterpart of ``nerf_meets_mlx_tpu/kernels/fused_image.py``. The kernels
are ``csrc/image_train_tc.cu`` (the Pallas ``_train_kernel``: the tile
kernel on the tensor cores, its split-K dW GEMM and the reduction) and
``csrc/image_fwd_tc.cu`` (the Pallas ``_fwd_kernel``: a pack launch that
writes the weight images, then the ``wgmma`` tile walk). This module holds
their wrappers and their plain PyTorch version. The function is the image
task's model: sinusoidal encode of pixel coordinates, then the non-viewdir
NeRF MLP (``NeRFMLP`` with its output head).

* ``fused_image_train`` (sse = Σ (out − target)² over the rows and
  ``out_channels`` columns, differentiable with respect to the MLP) and
  ``fused_image_apply`` (the output [N, out_channels]) launch their kernel
  for CUDA tensors (or raise) and run ``fused_image_reference`` for CPU
  tensors. There is no other fallback.
* The train kernel reads each ``nn.Linear`` weight and bias where the
  module holds it and writes the gradients into one flat buffer in the
  same layout (``grad_layout``), which the call returns as views; the
  frequency bands and the workspace are built once per shape
  (``_train_plan``). A call launches the three kernels of
  ``csrc/image_train_tc.cu`` and nothing else; its backward scales the
  gradients by the incoming cotangent.
* The forward call launches the pack, which writes every layer's TF32
  weight images from the ``nn.Linear`` weights by pointer into a buffer of
  the shape's plan (``_fwd_plan``: the segment table ``fwd_segments``, the
  bands, the buffer), then the tile walk, which reads the biases and the
  head by pointer; a later call of the shape allocates only its output.
  The JAX package's band matrix, zero-extended skip rows and [N, 8] padded
  input and output are a TPU layout and are not carried over.
* ``LAUNCHES["image_train"]`` / ``LAUNCHES["image_fwd"]`` (the dict shared
  with ``fused_train``) count kernel launches, one per CUDA call.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

from nerf_meets_mlx_torch.kernels.fused_train import (
    LAUNCHES,
    MAX_WIDTH,
    MIN_WIDTH,
    width_defines,
    width_ok,
)

# The kernels' sources (one build per width set, as fused_train's)
TRAIN_SOURCE = "image_train_tc"
FWD_SOURCE = "image_fwd_tc"
# the shapes whose plans (_fwd_plan, _train_plan) a wrapper keeps: the newest few
_MAX_PLANS = 4


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


def grad_layout(mlp) -> List[Tuple[int, Tuple[int, ...]]]:
    """(offset, shape) of every parameter of ``mlp.linears()`` in the train
    kernel's flat gradient buffer, in order: each weight [fan_out, fan_in]
    as ``nn.Linear`` holds it, then its bias, packed back to back."""
    out, o = [], 0
    for _, lin in mlp.linears():
        for p in (lin.weight, lin.bias):
            out.append((o, tuple(p.shape)))
            o += p.numel()
    return out


def train_build(width: int):
    """(source, defines) of the build that trains an image MLP of this
    width: ``csrc/image_train_tc.cu``, which takes every shape the plain
    version's checks admit."""
    return TRAIN_SOURCE, width_defines(width)


def type_fwd_lib(lib):
    """``lib``, a build of csrc/image_fwd_tc.cu, with its C functions typed."""
    if not getattr(lib, "_typed", False):
        vp, ci, cll, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
        lib.image_fwd_tc_launch.argtypes = (
            [vp] * 5 + [ci, vp, cll, vp, cll] + [ci] * 3 + [cu] + [ci] * 4 + [vp]
        )
        lib.image_fwd_tc_launch.restype = ci
        lib.image_fwd_tc_smem_bytes.argtypes = [ci]
        lib.image_fwd_tc_smem_bytes.restype = cll
        lib._typed = True
    return lib


def _fwd_lib(width: int):
    from nerf_meets_mlx_torch.kernels import _build

    return type_fwd_lib(_build.load_library(FWD_SOURCE, width_defines(width)))


def _train_lib(width: int):
    from nerf_meets_mlx_torch.kernels import _build

    lib = _build.load_library(*train_build(width))
    if not getattr(lib, "_typed", False):
        vp, ci, cll, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
        lib.image_train_tc_launch.argtypes = [vp] * 7 + [cll] + [ci] * 2 + [cu] + [ci] * 4 + [vp]
        lib.image_train_tc_launch.restype = ci
        lib.image_train_tc_workspace_floats.argtypes = [cll, ci, ci, cu] + [ci] * 4
        lib.image_train_tc_workspace_floats.restype = cll
        lib.image_train_tc_smem_bytes.argtypes = [ci] * 3
        lib.image_train_tc_smem_bytes.restype = cll
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
    if not width_ok(cfg.net_width) or not 1 <= cfg.net_depth <= 20:
        raise ValueError(
            f"the image kernels take a net_width that is a multiple of 16 from {MIN_WIDTH} to "
            f"{MAX_WIDTH} and depth 1..20, not {cfg.net_width} and {cfg.net_depth}"
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
    if any(p.dtype != torch.float32 or not p.is_contiguous()
           for _, lin in mlp.linears() for p in (lin.weight, lin.bias)):
        raise ValueError("the image kernels read contiguous float32 parameters")


def _common(mlp, pos_enc):
    cfg = mlp.cfg
    return (
        cfg.net_depth, cfg.net_width, sum(1 << (s + 1) for s in cfg.skips), pos_enc.in_dim,
        pos_enc.n_freqs, int(pos_enc.include_input), cfg.out_channels,
    )


def fwd_segments(mlp, pos_enc) -> List[Tuple[int, int, int, int]]:
    """The forward kernel's segment table: (linear, first column, row
    stride, columns) of every input segment whose weight images its pack
    launch writes, in the order its tile walk streams them: layer 0's
    encoding, then per layer j > 0 the encoding when j is a skip layer
    ([encoded input, h], input first) and its h. ``linear`` indexes
    ``mlp.linears()``; the segment is ``weight[:, first : first + columns]``."""
    cfg = mlp.cfg
    W, P = cfg.net_width, pos_enc.out_dim
    segs = [(0, 0, P, P)]
    for j in range(1, cfg.net_depth):
        if (j - 1) in cfg.skips:
            segs += [(j, 0, P + W, P), (j, P, P + W, W)]
        else:
            segs.append((j, 0, W, W))
    return segs


def fwd_image_offsets(segments, width: int) -> List[int]:
    """Floats of the forward kernel's weight images before each segment of
    ``segments``, then their total: per k-step of 8 columns the TF32 hi and
    lo images of 8 x width floats each."""
    offs = [0]
    for *_, k in segments:
        offs.append(offs[-1] + -(-k // 8) * 16 * width)
    return offs


def fwd_smem_bytes(width: int) -> int:
    """Shared-memory bytes of a forward block (csrc/image_fwd_tc.cu's
    smem_bytes): 4 weight stages of 16 x width floats, the 128 x (width + 8)
    activation tile, 8 mbarriers, 128 x 4 floats of coordinates and as
    many of output staging."""
    return 4 * (4 * 16 * width + 128 * (width + 8)) + 8 * 8 + 2 * 4 * 128 * 4


class _FwdPlan(NamedTuple):
    img: torch.Tensor     # the weight images, rewritten by every call's pack launch
    bands: torch.Tensor
    segs: ctypes.Array    # fwd_segments, 4 ints a segment
    blocks: int           # the device's SMs: one persistent block each


# (device, stream, shape) -> the forward's plan, the newest few kept
_FWD_PLANS: Dict[tuple, _FwdPlan] = {}


def _fwd_plan(mlp, pos_enc, dev, stream: int) -> _FwdPlan:
    """The weight-image buffer, bands and segment table of a forward shape,
    made at its first call. The buffer is the shape's on one stream, whose
    calls run in order."""
    key = (dev, stream, _common(mlp, pos_enc), pos_enc)
    plan = _FWD_PLANS.get(key)
    if plan is None:
        segs = fwd_segments(mlp, pos_enc)
        n_img = fwd_image_offsets(segs, mlp.cfg.net_width)[-1]
        flat = [v for seg in segs for v in seg]
        plan = _FwdPlan(torch.empty(n_img, dtype=torch.float32, device=dev),
                        pos_enc.bands(dev).to(torch.float32).contiguous(),
                        (ctypes.c_int * len(flat))(*flat),
                        torch.cuda.get_device_properties(dev).multi_processor_count)
        if len(_FWD_PLANS) >= _MAX_PLANS:
            _FWD_PLANS.pop(next(iter(_FWD_PLANS)))
        _FWD_PLANS[key] = plan
    return plan


def _fwd_launch(mlp, pos_enc, x: torch.Tensor, lib=None) -> torch.Tensor:
    """One call of csrc/image_fwd_tc.cu (``lib``: a build of it, by default
    the one of the MLP's width): the pack launch, then the tile walk; the
    output [N, out_channels]."""
    dev = x.device
    N = x.shape[0]
    W = mlp.cfg.net_width
    lib = lib or _fwd_lib(W)
    smem = lib.image_fwd_tc_smem_bytes(W)
    if smem != fwd_smem_bytes(W) or smem > 232448:
        raise ValueError(f"the image forward kernel's build says {smem} bytes of shared memory "
                         f"a block, the wrapper {fwd_smem_bytes(W)}")
    lins = [lin for _, lin in mlp.linears()]
    ptrs = ctypes.c_void_p * len(lins)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        plan = _fwd_plan(mlp, pos_enc, dev, stream)
        out = torch.empty((N, mlp.cfg.out_channels), dtype=torch.float32, device=dev)
        err = lib.image_fwd_tc_launch(
            x.data_ptr(), ptrs(*[lin.weight.data_ptr() for lin in lins]),
            ptrs(*[lin.bias.data_ptr() for lin in lins]), plan.bands.data_ptr(), plan.segs,
            len(plan.segs) // 4, plan.img.data_ptr(), plan.img.numel(), out.data_ptr(), N,
            plan.blocks, *_common(mlp, pos_enc), stream,
        )
    if err != 0:
        raise RuntimeError(f"the image forward launch failed with cudaError {err}")
    LAUNCHES["image_fwd"] += 1
    return out


@torch.no_grad()
def fused_image_apply(mlp, pos_enc, x: torch.Tensor) -> torch.Tensor:
    """Forward-only image MLP: the output [N, out_channels] of the encoded
    coordinates x [N, in_dim]. CPU tensors run the plain version; CUDA
    tensors launch csrc/image_fwd_tc.cu's pack and tile walk or raise.
    Not differentiable (the kernel has no backward), so it runs under
    ``no_grad``."""
    dev = x.device
    if dev.type == "cpu":
        return fused_image_reference(mlp, pos_enc, x)
    if dev.type != "cuda":
        raise ValueError(f"fused_image_apply runs on cuda or cpu tensors, not {dev}")
    _check_config(mlp, pos_enc, x)
    return _fwd_launch(mlp, pos_enc, x.contiguous())


class _TrainPlan(NamedTuple):
    lib: ctypes.CDLL
    workspace: torch.Tensor  # the kernels' scratch, reused by every call of the shape
    bands: torch.Tensor
    layout: List[Tuple[int, Tuple[int, ...]]]
    n_dw: int


# (device, stream, N, shape) -> plan
_PLANS: Dict[tuple, _TrainPlan] = {}


def _train_plan(mlp, pos_enc, dev, stream: int, N: int) -> _TrainPlan:
    """The library, workspace, bands and gradient layout of a shape, built
    at its first call: a later call of the shape allocates and launches
    nothing besides its kernels and its two outputs (``torch.empty``). The
    workspace is the shape's on one stream, whose calls run in order."""
    key = (dev, stream, N, _common(mlp, pos_enc), pos_enc)
    plan = _PLANS.get(key)
    if plan is None:
        cfg = mlp.cfg
        lib = _train_lib(cfg.net_width)
        smem = lib.image_train_tc_smem_bytes(cfg.net_width, cfg.net_depth, pos_enc.out_dim)
        if not 0 < smem <= 232448:
            raise ValueError(f"the image train kernel needs {smem} bytes of shared memory a block")
        n_ws = lib.image_train_tc_workspace_floats(N, *_common(mlp, pos_enc))
        if n_ws <= 0:
            raise ValueError(f"the image train kernel does not take this shape: {key[3]}")
        layout = grad_layout(mlp)
        n_dw = layout[-1][0] + math.prod(layout[-1][1])
        plan = _TrainPlan(lib, torch.empty(n_ws, dtype=torch.float32, device=dev),
                          pos_enc.bands(dev).contiguous(), layout, n_dw)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.pop(next(iter(_PLANS)))
        _PLANS[key] = plan
    return plan


def _train_launch(mlp, pos_enc, x: torch.Tensor, target: torch.Tensor, params):
    """One call of ``csrc/image_train_tc.cu``'s three kernels: (sse, grads)
    with grads = d(sse)/d(params), the weights and biases of
    ``mlp.linears()`` in order, views of one fresh buffer."""
    dev = x.device
    N = x.shape[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        plan = _train_plan(mlp, pos_enc, dev, stream, N)
        c_params = (ctypes.c_void_p * len(params))(*[p.data_ptr() for p in params])
        sse = torch.empty((1,), dtype=torch.float32, device=dev)
        dw = torch.empty((plan.n_dw,), dtype=torch.float32, device=dev)
        err = plan.lib.image_train_tc_launch(
            x.data_ptr(), target.data_ptr(), plan.bands.data_ptr(), c_params, sse.data_ptr(),
            dw.data_ptr(), plan.workspace.data_ptr(), N, *_common(mlp, pos_enc), stream,
        )
    if err != 0:
        raise RuntimeError(f"the image train launch failed with cudaError {err}")
    LAUNCHES["image_train"] += 1
    grads = [dw[o : o + math.prod(shape)].view(shape) for o, shape in plan.layout]
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
    gives the gradient); CUDA tensors launch the train kernels, which
    compute the gradient in the same call (``csrc/image_train_tc.cu``), or
    raise."""
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
    return _FusedImageTrain.apply(lambda: _train_launch(mlp, pos_enc, xk, tk, params), *params)
