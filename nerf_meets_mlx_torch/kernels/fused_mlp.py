"""Fused point-major encode + NeRF MLP: raw [N, 4] from points and view
directions, with its gradient.

Counterpart of ``nerf_meets_mlx_tpu/kernels/fused_mlp.py``. The kernels are
``csrc/mlp_fwd_tc.cu``'s ``mlp_fwd_tc_kernel`` (the Pallas ``_fwd_kernel``,
on ``wgmma`` in 3xTF32) and ``csrc/fused_mlp.cu``'s ``mlp_bwd_kernel`` with
its split-K dW GEMM (the Pallas ``_bwd_kernel``). This module holds their
wrapper and their plain PyTorch version.

* ``fused_mlp_apply`` runs ``fused_mlp_reference`` for CPU tensors; for CUDA
  tensors it goes through ``_FusedMLP``, a ``torch.autograd.Function`` whose
  forward launches the forward kernel and whose backward launches the
  backward kernel, or it raises. There is no other fallback.
* The forward takes the weights as the sinusoidal eval kernel does: the
  biases, heads and bands in ``fused_train.pack_eval_weights``' buffer and
  the dense layers' TF32 hi / lo images from ``fused_train.pack_eval_wgmma``,
  both packed on the device once per call; the backward reads
  ``pack_train_weights``' layout. The JAX package's packed 128-lane tile and
  its [N, 8] padded input and output are a TPU layout and are not carried
  over.
* The forward saves only its inputs; the backward kernel recomputes the
  forward in fp32, as the Pallas backward recomputes.
* ``LAUNCHES["mlp_fwd"]`` / ``LAUNCHES["mlp_bwd"]`` (the dict shared with
  ``fused_train``) count kernel launches, one per CUDA call.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from nerf_meets_mlx_torch.kernels.fused_train import (
    LAUNCHES,
    DW_SPLIT_POINTS,
    _check_kernel_config,
    _forward_pieces,
    _pack_flat,
    _train_pieces,
    pack_eval_wgmma,
    width_defines,
)

# Points per CUDA block of the backward: 8 tiles of 64. The fine level's
# 393,216 points make 768 blocks (one block of ~182 KB shared memory per
# SM, 132 SMs).
MLP_BLOCK_POINTS = 512
# the forward kernel's source (csrc/mlp_fwd_tc.cu): one persistent block an
# SM walks tiles of 128 points
FWD_SOURCE = "mlp_fwd_tc"


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def fused_mlp_reference(mlp, pos_enc, dir_enc, pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """The kernels' function in plain torch, differentiable by autograd:
    raw [N, 4] (rgb, sigma, un-activated) of ``mlp`` on the encoded points
    [N, 3] and view directions [N, 3]."""
    return mlp(pos_enc.apply(pts), dir_enc.apply(dirs))


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------


def _dx_pieces(mlp, pos_enc, dir_enc) -> List[torch.Tensor]:
    """The encoding rows of layer 0, of each skip layer (in layer order) and
    of the view layer, transposed (slices of ``nn.Linear.weight``) and
    zero-padded to a multiple of 64 columns: the matrices the backward's dS
    GEMMs read."""
    cfg = mlp.cfg
    P, Dd, W = pos_enc.out_dim, dir_enc.out_dim, cfg.net_width

    def padded(w):
        cols = -(-w.shape[1] // 64) * 64
        return torch.nn.functional.pad(w, (0, cols - w.shape[1]))

    layers = [0] + [s + 1 for s in sorted(cfg.skips)]
    pieces = [padded(mlp.pos_linears[j].weight[:, :P]) for j in layers]
    pieces.append(padded(mlp.dir_linear.weight[:, W : W + Dd]))
    return pieces


def pack_mlp_weights(mlp, pos_enc, dir_enc, backward: bool = False,
                     compute_dx: bool = False) -> Tuple[torch.Tensor, List[int]]:
    """One flat fp32 buffer and its piece offsets. The forward reads the
    forward pieces (``fused_train.pack_eval_weights``' layout); the backward
    reads ``fused_train.pack_train_weights``' layout and, with compute_dx,
    the dX pieces after it (``_dx_pieces``)."""
    if not backward:
        return _pack_flat(_forward_pieces(mlp, pos_enc, dir_enc))
    pieces = _train_pieces(mlp, pos_enc, dir_enc)
    if compute_dx:
        pieces += _dx_pieces(mlp, pos_enc, dir_enc)
    return _pack_flat(pieces)


def _bwd_lib(width: int):
    from nerf_meets_mlx_torch.kernels import _build

    lib = _build.load_library("fused_mlp", width_defines(width))
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_mlp_bwd_launch.argtypes = (
            [vp] * 5 + [ci] + [vp] * 3 + [cll] + [ci] * 3 + [ctypes.c_uint] + [ci] * 6 + [vp]
        )
        lib.fused_mlp_bwd_launch.restype = ci
        lib.fused_mlp_smem_bytes.argtypes = [ci] * 3
        lib.fused_mlp_smem_bytes.restype = cll
        lib.fused_mlp_workspace_floats.argtypes = [cll] + [ci] * 6
        lib.fused_mlp_workspace_floats.restype = cll
        lib._typed = True
    return lib


def type_fwd_lib(lib):
    """``lib``, a build of csrc/mlp_fwd_tc.cu, with its C functions typed."""
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mlp_fwd_tc_launch.argtypes = (
            [vp] * 5 + [ci, vp, cll] + [ci] * 3 + [ctypes.c_uint] + [ci] * 4 + [vp]
        )
        lib.mlp_fwd_tc_launch.restype = ci
        lib.mlp_fwd_tc_smem_bytes.argtypes = [ci]
        lib.mlp_fwd_tc_smem_bytes.restype = cll
        lib.mlp_fwd_tc_image_floats.argtypes = [ci, ci, ctypes.c_uint, ci, ci]
        lib.mlp_fwd_tc_image_floats.restype = cll
        lib._typed = True
    return lib


def _fwd_lib(width: int):
    from nerf_meets_mlx_torch.kernels import _build

    return type_fwd_lib(_build.load_library(FWD_SOURCE, width_defines(width)))


def _common(mlp, pos_enc, dir_enc):
    cfg = mlp.cfg
    return (
        cfg.net_depth, cfg.net_width, sum(1 << (s + 1) for s in cfg.skips),
        pos_enc.n_freqs, int(pos_enc.include_input), dir_enc.n_freqs, int(dir_enc.include_input),
    )


def _check_smem(lib, mlp, pos_enc, dir_enc):
    smem = lib.fused_mlp_smem_bytes(mlp.cfg.net_width, pos_enc.out_dim, dir_enc.out_dim)
    if not 0 < smem <= 232448:
        raise ValueError(f"the fused MLP backward needs {smem} bytes of shared memory per block")


def _fwd_launch(mlp, pos_enc, dir_enc, pts, dirs, lib=None) -> torch.Tensor:
    """One call of ``mlp_fwd_tc_kernel`` (``lib``: a build of
    csrc/mlp_fwd_tc.cu, by default the one of the MLP's width): raw [N, 4]."""
    dev = pts.device
    N = pts.shape[0]
    raw = torch.empty((N, 4), dtype=torch.float32, device=dev)
    D, W, skip_mask, pf, pi, df, di = _common(mlp, pos_enc, dir_enc)
    lib = lib or _fwd_lib(W)
    smem = lib.mlp_fwd_tc_smem_bytes(W)
    if not 0 < smem <= 232448:
        raise ValueError(f"the fused MLP forward needs {smem} bytes of shared memory per block")
    wbuf, offs = pack_mlp_weights(mlp, pos_enc, dir_enc)
    wimg = pack_eval_wgmma(mlp, pos_enc, dir_enc)
    want = lib.mlp_fwd_tc_image_floats(D, W, skip_mask, pos_enc.out_dim, dir_enc.out_dim)
    if wimg.numel() != want:
        raise RuntimeError(f"pack_eval_wgmma wrote {wimg.numel()} floats, the kernel reads {want}")
    c_offs = (ctypes.c_int * len(offs))(*offs)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mlp_fwd_tc_launch(
            pts.data_ptr(), dirs.data_ptr(), wimg.data_ptr(), wbuf.data_ptr(), c_offs, len(offs),
            raw.data_ptr(), N, blocks, D, W, skip_mask, pf, pi, df, di, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mlp forward launch failed with cudaError {err}")
    LAUNCHES["mlp_fwd"] += 1
    return raw


def _bwd_launch(mlp, pos_enc, dir_enc, pts, dirs, dout, compute_dx: bool):
    """One call of ``mlp_bwd_kernel`` and its dW GEMM: (grads, dx) with
    grads = d(dout · raw)/d(weight, bias) of every ``mlp.linears()`` entry
    and dx [N, 6] (None without compute_dx)."""
    dev = pts.device
    N = pts.shape[0]
    lib = _bwd_lib(mlp.cfg.net_width)
    _check_smem(lib, mlp, pos_enc, dir_enc)
    wbuf, offs = pack_mlp_weights(mlp, pos_enc, dir_enc, backward=True, compute_dx=compute_dx)
    D, W, skip_mask, pf, pi, df, di = _common(mlp, pos_enc, dir_enc)
    n_dw = offs[2 * D + 8]
    n_ws = lib.fused_mlp_workspace_floats(
        N, D, W, pos_enc.out_dim, dir_enc.out_dim, DW_SPLIT_POINTS, n_dw
    )
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    dw = torch.empty((n_dw,), dtype=torch.float32, device=dev)
    dx = torch.empty((N, 6), dtype=torch.float32, device=dev) if compute_dx else None
    c_offs = (ctypes.c_int * len(offs))(*offs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_mlp_bwd_launch(
            pts.data_ptr(), dirs.data_ptr(), dout.data_ptr(), wbuf.data_ptr(), c_offs, len(offs),
            dw.data_ptr(), dx.data_ptr() if compute_dx else None, ws.data_ptr(),
            N, MLP_BLOCK_POINTS, D, W, skip_mask, pf, pi, df, di, DW_SPLIT_POINTS, n_dw, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mlp backward launch failed with cudaError {err}")
    LAUNCHES["mlp_bwd"] += 1
    grads = []
    for i, (_, lin) in enumerate(mlp.linears()):
        o_w, o_b = offs[2 * i], offs[2 * i + 1]
        fi, fo = lin.in_features, lin.out_features
        grads.append(dw[o_w : o_w + fi * fo].view(fi, fo).t().contiguous())
        grads.append(dw[o_b : o_b + fo])
    return grads, dx


class _FusedMLP(torch.autograd.Function):
    """raw as a function of the points, the directions and the MLP's
    parameters. The forward launches the forward kernel and keeps only its
    inputs; the backward launches the backward kernel, which recomputes the
    forward. The points and directions get a gradient only with
    compute_dx."""

    @staticmethod
    def forward(ctx, modules, compute_dx, pts, dirs, *params):
        mlp, pos_enc, dir_enc = modules
        ctx.modules, ctx.compute_dx = modules, compute_dx
        ctx.save_for_backward(pts, dirs, *params)
        return _fwd_launch(mlp, pos_enc, dir_enc, pts, dirs)

    @staticmethod
    def backward(ctx, dout):
        pts, dirs = ctx.saved_tensors[:2]  # the parameters' versions are checked here
        mlp, pos_enc, dir_enc = ctx.modules
        grads, dx = _bwd_launch(
            mlp, pos_enc, dir_enc, pts, dirs, dout.contiguous(), ctx.compute_dx
        )
        dpts = ddirs = None
        if dx is not None:
            dpts, ddirs = dx[:, :3], dx[:, 3:]
        return (None, None, dpts, ddirs, *grads)


def fused_mlp_apply(mlp, pos_enc, dir_enc, pts: torch.Tensor, dirs: torch.Tensor,
                    compute_dx: bool = False) -> torch.Tensor:
    """Fused encode + MLP: raw [N, 4] (rgb, sigma, un-activated) from points
    [N, 3] and view directions [N, 3], differentiable with respect to the
    MLP's parameters and, with compute_dx, to the points and directions
    (the model path passes data there and leaves it off, as the JAX model
    does). CPU tensors run the plain version; CUDA tensors launch
    ``csrc/mlp_fwd_tc.cu`` (and, under autograd, ``csrc/fused_mlp.cu``'s
    backward) through ``_FusedMLP`` or raise."""
    dev = pts.device
    if not compute_dx:
        pts, dirs = pts.detach(), dirs.detach()
    if dev.type == "cpu":
        return fused_mlp_reference(mlp, pos_enc, dir_enc, pts, dirs)
    if dev.type != "cuda":
        raise ValueError(f"fused_mlp_apply runs on cuda or cpu tensors, not {dev}")
    # offsets passed by value: 2·depth + 10 ≤ 44 forward, 3·depth + 11 + the
    # dX pieces ≤ 80 backward
    _check_kernel_config(mlp, pos_enc, dir_enc, kernel="MLP", max_depth=17)
    if mlp.cfg.net_depth < 2:
        raise ValueError("the fused MLP kernels need at least two trunk layers")
    if compute_dx and max(pos_enc.out_dim, dir_enc.out_dim) > 128:
        raise ValueError("the fused MLP backward computes dX for encodings of at most 128 features")
    N = pts.shape[0]
    for name, t in (("pts", pts), ("dirs", dirs)):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (N, 3):
            raise ValueError(
                f"{name}: expected float32 ({N}, 3) on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
    if mlp.pos_linears[0].weight.device != dev:
        raise ValueError("the MLP's parameters must be on the points' device")
    params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]
    return _FusedMLP.apply(
        (mlp, pos_enc, dir_enc), compute_dx, pts.contiguous(), dirs.contiguous(), *params
    )
