"""Fused point-major encode + NeRF MLP: raw [N, 4] from points and view
directions, with its gradient.

Counterpart of ``nerf_meets_mlx_tpu/kernels/fused_mlp.py``. The kernels are
``csrc/mlp_fwd_tc.cu``'s ``mlp_fwd_tc_kernel`` (the Pallas ``_fwd_kernel``)
and ``csrc/mlp_bwd_tc.cu``'s pack, tile, dW and reduce kernels (the Pallas
``_bwd_kernel``), both on ``wgmma`` in 3xTF32. This module holds their
wrapper and their plain PyTorch version.

* ``fused_mlp_apply`` runs ``fused_mlp_reference`` for CPU tensors; for CUDA
  tensors it goes through ``_FusedMLP``, a ``torch.autograd.Function`` whose
  forward launches the forward kernel and whose backward launches the
  backward's kernels, or it raises. There is no other fallback.
* The forward takes the weights as the sinusoidal eval kernel does: the
  biases, heads and bands in ``fused_train.pack_eval_weights``' buffer and
  the dense layers' TF32 hi / lo images from ``fused_train.pack_eval_wgmma``,
  both packed on the device once per call. The backward packs nothing on
  the host: it hands the kernels the ``nn.Linear`` tensors' pointers, its
  first kernel writes the weight images from them, and its last writes the
  gradients in ``nn.Linear``'s layout into one buffer whose views it
  returns. The JAX package's packed 128-lane tile and its [N, 8] padded
  input and output are a TPU layout and are not carried over.
* The forward saves only its inputs; the backward recomputes the forward,
  as the Pallas backward recomputes.
* ``LAUNCHES["mlp_fwd"]`` / ``LAUNCHES["mlp_bwd"]`` (the dict shared with
  ``fused_train``) count calls that launch, one per CUDA call.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from nerf_meets_mlx_torch.kernels.fused_train import (
    LAUNCHES,
    DW_SPLIT_POINTS,
    _check_kernel_config,
    _forward_pieces,
    _pack_flat,
    pack_eval_wgmma,
    width_defines,
)

# the forward kernel's source (csrc/mlp_fwd_tc.cu): one persistent block an
# SM walks tiles of 128 points
FWD_SOURCE = "mlp_fwd_tc"
# the backward's source (csrc/mlp_bwd_tc.cu): the same tile walk, then dW
# over point ranges of DW_SPLIT_POINTS
BWD_SOURCE = "mlp_bwd_tc"


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def fused_mlp_reference(mlp, pos_enc, dir_enc, pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """The kernels' function in plain torch, differentiable by autograd:
    raw [N, 4] (rgb, sigma, un-activated) of ``mlp`` on the encoded points
    [N, 3] and view directions [N, 3]."""
    return mlp(pos_enc.apply(pts), dir_enc.apply(dirs))


def relu_reference(mlp, pos_enc, dir_enc, pts: torch.Tensor, dirs: torch.Tensor,
                   masks: List[torch.Tensor]) -> torch.Tensor:
    """``fused_mlp_reference`` with its relu decisions given: each relu (the
    D trunk layers, then the view layer) taken as z · mask for the bool
    ``masks`` [N, W] / [N, W/2], in the dtype of the inputs and the MLP.
    Run in float64 with the backward kernel's decisions
    (``workspace_masks``), it is what the card checks hold the backward's
    arithmetic to, apart from the decisions that rounding takes either way
    (``relu_decisions``)."""
    cfg = mlp.cfg
    xp, xd = pos_enc.apply(pts), dir_enc.apply(dirs)

    def dense(lin, x):
        return x @ lin.weight.t() + lin.bias

    h = xp
    for j, lin in enumerate(mlp.pos_linears):
        h = dense(lin, h) * masks[j]
        if j in cfg.skips:
            h = torch.cat([xp, h], dim=-1)
    alpha = dense(mlp.alpha_linear, h)
    hd = dense(mlp.dir_linear, torch.cat([dense(mlp.feature_linear, h), xd], -1)) * masks[-1]
    return torch.cat([dense(mlp.rgb_linear, hd), alpha], -1)


@torch.no_grad()
def relu_decisions(mlp, pos_enc, dir_enc, pts: torch.Tensor, dirs: torch.Tensor,
                   margin: float) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per relu layer of the plain version (the D trunk layers, then the
    view layer), in the dtype of the inputs and the MLP: (z > 0, whether
    |z| exceeds ``margin`` times the sum of its terms' magnitudes Σ|x w| +
    |b|, i.e. whether a sum rounded to that relative error takes the same
    side)."""
    cfg = mlp.cfg
    xp, xd = pos_enc.apply(pts), dir_enc.apply(dirs)
    out = []

    def relu(lin, x):
        z = x @ lin.weight.t() + lin.bias
        terms = x.abs() @ lin.weight.abs().t() + lin.bias.abs()
        out.append((z > 0, z.abs() > margin * terms))
        return torch.relu(z)

    h = xp
    for j, lin in enumerate(mlp.pos_linears):
        h = relu(lin, h)
        if j in cfg.skips:
            h = torch.cat([xp, h], dim=-1)
    feature = h @ mlp.feature_linear.weight.t() + mlp.feature_linear.bias
    relu(mlp.dir_linear, torch.cat([feature, xd], -1))
    return out


# ---------------------------------------------------------------------------
# The backward's gradient criterion
# ---------------------------------------------------------------------------

# A relu input further than RELU_MARGIN of its terms' magnitudes (Σ|x w| +
# |b|) from 0 has one side in any sum rounded to fp32's relative error: the
# backward's relu decisions must be float64's there.
RELU_MARGIN = 1e-5
# An array that misses the caller's bound against the fp32 plain version
# (DW_REL: a unit whose relu input lies within rounding of 0 in the kernel's
# sum and not in cuBLAS's moves ~1/sqrt(N) of an array under a random dout)
# must lie within GRAD_TIGHT of the plain version in float64 taken with the
# kernel's own decisions. On an H100 the 3xTF32 build reads at most 4.1e-6
# there on such an array and 1.7e-5 on any (dX at width 32); its one-pass
# control 2.1e-4 to 8.0e-4 on every dW (PERF.md).
GRAD_TIGHT = 5e-5
# The kernel's decisions apart from float64's, all inside the margin, may
# number at most NEAR_FACTOR times the fp32 plain version's at the same
# inputs plus NEAR_SLACK. On an H100 the two counts are alike (83 and 83,
# 258 and 257, 20 and 18, 2 and 1); the one-pass control's are ~300 times
# the plain version's (PERF.md).
NEAR_FACTOR, NEAR_SLACK = 1.5, 8


def _params(mlp) -> List[torch.Tensor]:
    return [q for _, lin in mlp.linears() for q in (lin.weight, lin.bias)]


def grad_criteria(g_k, g_p, g64, apart: int, near: int, plain_near: int, rel: float,
                  tight: float = GRAD_TIGHT) -> Tuple[List[str], List[float], List[float]]:
    """The backward's criterion for its gradient arrays ``g_k`` (dW, db of
    every linear, then dX with compute_dx): per array "i" within ``rel`` of
    the fp32 plain version's ``g_p`` (of its largest value), else "ii"
    within ``tight`` of ``g64``, the plain version in float64 taken with the
    kernel's relu decisions, where ``apart`` (the decisions apart from
    float64's beyond RELU_MARGIN) is 0 and ``near`` (those apart in all) at
    most NEAR_FACTOR · ``plain_near`` (the fp32 plain version's) +
    NEAR_SLACK; else "no", as for any array not finite. Returns ("i" / "ii"
    / "no", the ratios against ``g_p``, against ``g64``)."""
    decided = apart == 0 and near <= NEAR_FACTOR * plain_near + NEAR_SLACK
    by, r32, r64 = [], [], []
    for a, b, c in zip(g_k, g_p, g64):
        r32.append(float((a - b).abs().max() / b.abs().max()))
        r64.append(float((a.double() - c).abs().max() / c.abs().max()))
        if not bool(torch.isfinite(a).all()):
            by.append("no")
        elif r32[-1] <= rel:
            by.append("i")
        else:
            by.append("ii" if decided and r64[-1] <= tight else "no")
    return by, r32, r64


def grad_reference(mlp, pos_enc, dir_enc, pts, dirs, dout, compute_dx: bool,
                   masks: List[torch.Tensor], margin: float = RELU_MARGIN):
    """(the gradients of Σ dout · raw of the plain version in float64 with
    the relu decisions ``masks``, as ``grad_criteria``'s ``g64``; the
    decisions of ``masks`` apart from float64's beyond ``margin`` and in
    all; the fp32 plain version's apart from float64's)."""
    import copy

    mlp64 = copy.deepcopy(mlp).double()
    p64, d64 = pts.double(), dirs.double()
    apart = near = plain_near = 0
    for m, (on32, _), (on, sure) in zip(masks, relu_decisions(mlp, pos_enc, dir_enc, pts, dirs, margin),
                                        relu_decisions(mlp64, pos_enc, dir_enc, p64, d64, margin)):
        apart += int(((m != on) & sure).sum())
        near += int((m != on).sum())
        plain_near += int((on32 != on).sum())
    p64.requires_grad_(compute_dx)
    d64.requires_grad_(compute_dx)
    out64 = relu_reference(mlp64, pos_enc, dir_enc, p64, d64, masks)
    g64 = torch.autograd.grad((out64 * dout.double()).sum(),
                              _params(mlp64) + ([p64, d64] if compute_dx else []))
    return list(g64), apart, near, plain_near


class GradCheck:
    """``grad_check``'s reading: ``by``, ``r32``, ``r64`` as
    ``grad_criteria`` returns them; ``apart``, ``near``, ``plain_near`` as
    ``grad_reference``; ``err32`` the largest |kernel − fp32 plain| of any
    array; ``same`` whether a second call was bit-identical."""

    def __init__(self, by, r32, r64, apart, near, plain_near, err32, same):
        self.by, self.r32, self.r64 = by, r32, r64
        self.apart, self.near, self.plain_near = apart, near, plain_near
        self.err32, self.same = err32, same

    @property
    def ok(self) -> bool:
        return self.same and "no" not in self.by

    def describe(self) -> str:
        return (f"held by {' '.join(self.by)}; max|g-plain|/max|plain| per array "
                + " ".join(f"{r:.1e}" for r in self.r32)
                + "; against float64 with the kernel's relu decisions "
                + " ".join(f"{r:.1e}" for r in self.r64)
                + f" (GRAD_TIGHT {GRAD_TIGHT:g}); relu decisions apart from float64: {self.near}, "
                f"the fp32 plain version's {self.plain_near} (at most {NEAR_FACTOR}x + "
                f"{NEAR_SLACK}), {self.apart} beyond {RELU_MARGIN:g} of their terms; a second "
                f"call bit-identical: {self.same}")


def grad_check(mlp, pos_enc, dir_enc, pts, dirs, dout, compute_dx: bool, g_k, rel: float,
               lib=None) -> GradCheck:
    """The backward's gradients ``g_k`` of Σ dout · raw (dW, db of every
    ``mlp.linears()`` entry, then dX of the points and the directions with
    compute_dx), from a call on the card, held to ``grad_criteria`` with
    ``rel``: against autograd through the fp32 plain version, and against
    ``grad_reference`` with the relu decisions of a second call (of ``lib``,
    by default the MLP's width's build), read back from its workspace."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("grad_check counts the fp32 plain version's relu decisions: "
                         "torch.backends.cuda.matmul.allow_tf32 must be off")
    p = pts.clone().requires_grad_(compute_dx)
    d = dirs.clone().requires_grad_(compute_dx)
    out = fused_mlp_reference(mlp, pos_enc, dir_enc, p, d)
    g_p = torch.autograd.grad((out * dout).sum(), _params(mlp) + ([p, d] if compute_dx else []))
    del out
    N = pts.shape[0]
    scratch = torch.empty(bwd_scratch_floats(mlp, pos_enc, dir_enc, N, compute_dx, pts.device, lib),
                          device=pts.device)
    g_2, dx = _bwd_launch(mlp, pos_enc, dir_enc, pts, dirs, dout, compute_dx, lib=lib,
                          scratch=scratch)
    g_2 = list(g_2) + ([dx[:, :3], dx[:, 3:]] if compute_dx else [])
    masks = workspace_masks(mlp, pos_enc, dir_enc, N, scratch, compute_dx, lib)
    del scratch
    same = all(torch.equal(a, b) for a, b in zip(g_k, g_2))
    g64, apart, near, plain_near = grad_reference(mlp, pos_enc, dir_enc, pts, dirs, dout,
                                                  compute_dx, masks)
    by, r32, r64 = grad_criteria(g_k, g_p, g64, apart, near, plain_near, rel)
    err32 = max(float((a - b).abs().max()) for a, b in zip(g_k, g_p))
    return GradCheck(by, r32, r64, apart, near, plain_near, err32, same)


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------


def pack_mlp_weights(mlp, pos_enc, dir_enc) -> Tuple[torch.Tensor, List[int]]:
    """The forward's flat fp32 buffer (``fused_train.pack_eval_weights``'
    layout: the weights as [fan_in, fan_out], the biases, the bands) and
    its piece offsets."""
    return _pack_flat(_forward_pieces(mlp, pos_enc, dir_enc))


def type_bwd_lib(lib):
    """``lib``, a build of csrc/mlp_bwd_tc.cu, with its C functions typed."""
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mlp_bwd_tc_launch.argtypes = (
            [vp] * 9 + [ci, vp, vp, cll] + [ci] * 3 + [ctypes.c_uint] + [ci] * 5 + [vp]
        )
        lib.mlp_bwd_tc_launch.restype = ci
        lib.mlp_bwd_tc_smem_bytes.argtypes = [ci]
        lib.mlp_bwd_tc_smem_bytes.restype = cll
        lib.mlp_bwd_tc_image_floats.argtypes = [ci, ci, ctypes.c_uint, ci, ci, ci]
        lib.mlp_bwd_tc_image_floats.restype = cll
        lib.mlp_bwd_tc_scratch_floats.argtypes = (
            [cll] + [ci] * 3 + [ctypes.c_uint] + [ci] * 5
        )
        lib.mlp_bwd_tc_scratch_floats.restype = cll
        lib._typed = True
    return lib


def _bwd_lib(width: int):
    from nerf_meets_mlx_torch.kernels import _build

    return type_bwd_lib(_build.load_library(BWD_SOURCE, width_defines(width)))


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


# the encodings' frequency bands on each device, made once: the backward
# kernels read them by pointer
_BANDS: Dict[tuple, torch.Tensor] = {}


def _bands(enc, dev) -> torch.Tensor:
    key = (enc, str(dev))
    if key not in _BANDS:
        _BANDS[key] = enc.bands(dev).to(torch.float32).contiguous()
    return _BANDS[key]


def grad_offsets(mlp) -> Tuple[List[int], int]:
    """Where the backward writes each gradient in its flat buffer: per
    ``mlp.linears()`` entry the weight ([fan_out, fan_in], ``nn.Linear``'s
    layout) at ``offs[2i]`` and the bias at ``offs[2i + 1]``, back to back;
    and the buffer's length."""
    offs, n = [], 0
    for _, lin in mlp.linears():
        offs += [n, n + lin.weight.numel()]
        n += lin.weight.numel() + lin.bias.numel()
    return offs, n


def bwd_ws_rows(mlp, pos_enc, dir_enc) -> Tuple[Dict[str, int], int]:
    """The backward's workspace rows (csrc/mlp_bwd_tc.cu's make_plan), each
    N rounded up to whole 128-point tiles long, feature-major: where each
    block starts, and the row count."""
    D, W = mlp.cfg.net_depth, mlp.cfg.net_width
    rows, r = {}, 0
    for name, n in (("encP", -(-pos_enc.out_dim // 8) * 8), ("encD", -(-dir_enc.out_dim // 8) * 8),
                    ("h", D * W), ("feat", W), ("hd", W // 2), ("dz", D * W), ("dfeat", W),
                    ("ddir", W // 2), ("dout", 4)):
        rows[name], r = r, r + n
    return rows, r


def bwd_scratch_floats(mlp, pos_enc, dir_enc, N: int, compute_dx: bool, dev, lib=None) -> int:
    """Floats of device scratch one backward call of N points needs."""
    D, W, skip_mask = _common(mlp, pos_enc, dir_enc)[:3]
    lib = lib or _bwd_lib(W)
    n = lib.mlp_bwd_tc_scratch_floats(
        N, torch.cuda.get_device_properties(dev).multi_processor_count, D, W, skip_mask,
        pos_enc.out_dim, dir_enc.out_dim, int(compute_dx), DW_SPLIT_POINTS, grad_offsets(mlp)[1],
    )
    if n <= 0:
        raise ValueError("the fused MLP backward does not take this shape")
    return n


def workspace_masks(mlp, pos_enc, dir_enc, N: int, scratch: torch.Tensor, compute_dx: bool,
                    lib=None) -> List[torch.Tensor]:
    """The relu decisions a backward call took, read back from the
    workspace of its ``scratch`` (``_bwd_launch``): per trunk layer h > 0
    [N, W], then the view layer's [N, W/2]."""
    D, W, skip_mask = _common(mlp, pos_enc, dir_enc)[:3]
    lib = lib or _bwd_lib(W)
    img = lib.mlp_bwd_tc_image_floats(D, W, skip_mask, pos_enc.out_dim, dir_enc.out_dim,
                                      int(compute_dx))
    rows, n_rows = bwd_ws_rows(mlp, pos_enc, dir_enc)
    npad = -(-N // 128) * 128
    ws = scratch[-(-img // 32) * 32 :][: n_rows * npad].view(n_rows, npad)
    masks = [ws[rows["h"] + j * W : rows["h"] + (j + 1) * W, :N].t() > 0 for j in range(D)]
    return masks + [ws[rows["hd"] : rows["hd"] + W // 2, :N].t() > 0]


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


def _bwd_launch(mlp, pos_enc, dir_enc, pts, dirs, dout, compute_dx: bool, lib=None,
                scratch=None):
    """One call of csrc/mlp_bwd_tc.cu (``lib``: a build of it, by default
    the one of the MLP's width): (grads, dx) with grads = d(dout · raw)/d(
    weight, bias) of every ``mlp.linears()`` entry, views of one buffer, and
    dx [N, 6] (None without compute_dx). ``scratch``: the fp32 device
    buffer to work in (``workspace_masks`` reads it back), by default one
    made for the call."""
    dev = pts.device
    N = pts.shape[0]
    D, W, skip_mask, pf, pi, df, di = _common(mlp, pos_enc, dir_enc)
    lib = lib or _bwd_lib(W)
    smem = lib.mlp_bwd_tc_smem_bytes(W)
    if not 0 < smem <= 232448:
        raise ValueError(f"the fused MLP backward needs {smem} bytes of shared memory per block")
    lins = [lin for _, lin in mlp.linears()]
    for lin in lins:
        for p in (lin.weight, lin.bias):
            if p.dtype != torch.float32 or not p.is_contiguous() or p.device != dev:
                raise ValueError("the fused MLP backward reads contiguous fp32 parameters on "
                                 "the points' device")
    offs, n_dw = grad_offsets(mlp)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    n_scratch = bwd_scratch_floats(mlp, pos_enc, dir_enc, N, compute_dx, dev, lib)
    if scratch is None:
        scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    elif (scratch.dtype != torch.float32 or scratch.device != dev or not scratch.is_contiguous()
          or scratch.numel() < n_scratch):
        raise ValueError(f"scratch: expected >= {n_scratch} contiguous fp32 floats on {dev}")
    grads_flat = torch.empty(n_dw, dtype=torch.float32, device=dev)
    dx = torch.empty((N, 6), dtype=torch.float32, device=dev) if compute_dx else None
    ptrs = ctypes.c_void_p * len(lins)
    weights = ptrs(*[lin.weight.data_ptr() for lin in lins])
    biases = ptrs(*[lin.bias.data_ptr() for lin in lins])
    c_offs = (ctypes.c_int * len(offs))(*offs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mlp_bwd_tc_launch(
            pts.data_ptr(), dirs.data_ptr(), dout.data_ptr(), weights, biases,
            _bands(pos_enc, dev).data_ptr(), _bands(dir_enc, dev).data_ptr(),
            grads_flat.data_ptr(), c_offs, n_dw, dx.data_ptr() if compute_dx else None,
            scratch.data_ptr(), N, blocks, D, W, skip_mask, pf, pi, df, di, DW_SPLIT_POINTS, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_mlp backward launch failed with cudaError {err}")
    LAUNCHES["mlp_bwd"] += 1
    grads = []
    for i, lin in enumerate(lins):
        grads.append(grads_flat[offs[2 * i] : offs[2 * i] + lin.weight.numel()].view_as(lin.weight))
        grads.append(grads_flat[offs[2 * i + 1] : offs[2 * i + 1] + lin.bias.numel()])
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
    ``csrc/mlp_fwd_tc.cu`` (and, under autograd, ``csrc/mlp_bwd_tc.cu``)
    through ``_FusedMLP`` or raise."""
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
