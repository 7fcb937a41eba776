"""Fused NeRF ops of one level each: points → encode → MLP → compositing
(eval), and the same plus the MSE loss and its whole backward (train).

Counterpart of ``nerf_meets_mlx_tpu/kernels/fused_train.py``. The kernels
are ``csrc/fused_eval.cu`` (the Pallas ``_eval_kernel``) and
``csrc/fused_train.cu`` (the Pallas ``_train_kernel``); this module holds
their wrappers, their plain PyTorch versions and the shared compositing
math.

* ``fused_eval_apply`` / ``fused_train_apply`` launch their kernel for CUDA
  tensors (or raise) and run ``fused_eval_reference`` /
  ``fused_train_reference`` for CPU tensors. There is no other fallback.
* The plain versions are the same functions in plain torch, point-major
  (the counterparts of the JAX twins); ``fused_train_reference`` is
  differentiable by autograd.
* ``LAUNCHES["eval"]`` / ``LAUNCHES["train"]`` count kernel launches, one
  per CUDA call; the dict also holds the counts of ``kernels/fused_mlp.py``,
  ``kernels/hash_encode.py``, ``kernels/fused_ingp_train.py``,
  ``kernels/fused_feat_train.py`` and ``kernels/fused_image.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from nerf_meets_mlx_torch.rendering.volume import exclusive_cumsum, softplus

# kernel launches per wrapper, of this module and of kernels/fused_mlp.py,
# kernels/hash_encode.py, kernels/fused_ingp_train.py,
# kernels/fused_feat_train.py and kernels/fused_image.py; a run sets them to
# 0 and reads them after
# MLP widths of the default builds of csrc/fused_eval.cu, fused_train.cu,
# mlp_fwd_tc.cu, mlp_bwd_tc.cu and image_fwd_tc.cu; every other multiple of 16
# from 32 to 256 is a build of its own (width_defines)
KERNEL_WIDTHS = (32, 64, 128, 256)
MIN_WIDTH, MAX_WIDTH = 32, 256


def width_ok(width: int) -> bool:
    """Whether the sinusoidal and image kernels take this MLP width."""
    return width % 16 == 0 and MIN_WIDTH <= width <= MAX_WIDTH


def width_defines(width: int):
    """The ``-D`` defines of the build that instantiates ``width``: none
    for the default widths, ``KW`` for the others."""
    return None if width in KERNEL_WIDTHS else {"KW": width}

LAUNCHES: Dict[str, int] = {
    "eval": 0, "train": 0, "mlp_fwd": 0, "mlp_bwd": 0,
    "hash_fwd": 0, "hash_bwd": 0, "ingp_eval": 0, "ingp_train": 0,
    "feat_train": 0, "image_train": 0, "image_fwd": 0, "cp_fwd": 0, "cp_bwd": 0,
    "hash_grid_fwd": 0, "hash_grid_bwd": 0, "hash_dx_fwd": 0, "hash_dx_bwd": 0,
}


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Static description of the compositing stage of one level."""

    n_samples: int            # S: depth samples per ray
    rays_block: int           # rays per CUDA block (eval_block / default_rays_block)
    mode: str                 # "canonical" | "reference" (rendering/volume.py)
    density_activation: str   # "softplus" | "relu" (canonical mode only)
    white_bkgd: bool
    # train kernel: CUDA blocks of rays whose points one partial of the dW
    # reduction sums (default_group); the eval kernel ignores it
    group: int = 1


# Points per block: the kernel keeps (rgb, q, alpha) of every point of its
# rays in shared memory (20 bytes a point) beside 204,864 bytes of weight
# ring, 128-point activation tile and the tile's points at W=256, so a block
# holds about 512 points' worth of rays, four tiles (215,104 bytes in all
# at S=64).
EVAL_TARGET_POINTS = 512


def eval_block(n_samples: int) -> int:
    """Rays per CUDA block for the eval kernel."""
    return max(1, EVAL_TARGET_POINTS // n_samples)


def max_fused_samples() -> int:
    """Largest per-ray sample count routed to the fused kernels. A block
    needs 20·S (eval) or 28·S (train) bytes per ray of shared memory beside
    its 204,864 (eval) or 192,000 (train) bytes of tiles; at one ray per
    block S = 1024 still fits the 232,448 bytes a block may use (225,344
    for the eval kernel, 220,676 for the train kernel)."""
    return 1024


# Train kernel: the eval kernel's tiles with the tensor-core strides (rows
# of 72 points, weight slices of 264 columns) plus 28 bytes a point
# (colour, q, alpha, the two alpha derivatives) beside them, so a block
# again holds about 512 points' worth of rays (206,368 bytes at S=64) and
# runs alone on its SM; 4096 rays make 512 blocks (S=64) or 2048 (S=192).
TRAIN_TARGET_POINTS = 512
# dW = X^T dZ is summed over the points in partials of about this many
# points: at lego width a partial is 42 blocks of 128 x 128 outputs, one
# block an SM, so the coarse level's 262,144 points give 32 partials
# (1,344 blocks, 10.2 waves on 132 SMs) and the fine level's 786,432 give
# 98 (4,116 blocks, 31.2 waves); the partial buffer (2.4 MB each) stays
# small beside the stored activations.
DW_SPLIT_POINTS = 8192


def default_rays_block(n_samples: int) -> int:
    """Rays per CUDA block of the train kernel."""
    if n_samples > max_fused_samples():
        raise ValueError(
            f"n_samples={n_samples} exceeds the fused kernels' shared-memory "
            f"bound ({max_fused_samples()})"
        )
    return max(1, TRAIN_TARGET_POINTS // n_samples)


def default_group(n_samples: int, rays_block: int) -> int:
    """Blocks of rays whose points one partial of the dW reduction sums."""
    return max(1, DW_SPLIT_POINTS // (rays_block * n_samples))


def _alpha_terms(tspec: TrainSpec, raw_sigma: torch.Tensor, delta: torch.Tensor):
    """(q, alpha): q is what the transmittance prefix-sums, alpha the
    per-sample opacity. Alpha is 1 - exp(-q), as the kernel computes it
    (not -expm1)."""
    if tspec.mode == "canonical":
        if tspec.density_activation == "softplus":
            sigma = softplus(raw_sigma)
        elif tspec.density_activation == "relu":
            sigma = torch.relu(raw_sigma)
        else:
            raise ValueError(tspec.density_activation)
        q = sigma * delta
        return q, 1.0 - torch.exp(-q)
    if tspec.mode == "reference":
        # raw densities in the prefix sum, relu only inside alpha
        q = delta * raw_sigma
        return q, 1.0 - torch.exp(-torch.relu(q))
    raise ValueError(tspec.mode)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def fused_eval_reference(
    mlp, pos_enc, dir_enc, tspec: TrainSpec,
    rays_o, rays_d, viewdirs, z_vals, deltas,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch: (rgb_map [R, 3], weights [R, S])."""
    R, S = z_vals.shape
    pts = rays_o[:, None, :] + z_vals[..., None] * rays_d[:, None, :]
    x_pos = pos_enc.apply(pts.reshape(R * S, 3))
    dirs = viewdirs[:, None, :].expand(R, S, 3).reshape(R * S, 3)
    raw = mlp(x_pos, dir_enc.apply(dirs)).reshape(R, S, 4)
    q, alpha = _alpha_terms(tspec, raw[..., 3], deltas)
    w = alpha * torch.exp(-exclusive_cumsum(q))
    c = torch.sigmoid(raw[..., :3]) if tspec.mode == "canonical" else raw[..., :3]
    rgb_map = torch.sum(w[..., None] * c, dim=1)
    if tspec.white_bkgd:
        rgb_map = rgb_map + (1.0 - torch.sum(w, dim=1, keepdim=True))
    return rgb_map, w


def fused_train_reference(
    mlp, pos_enc, dir_enc, tspec: TrainSpec,
    rays_o, rays_d, viewdirs, z_vals, deltas, noise, target,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The train kernel's function in plain torch, differentiable by
    autograd: (sse, rgb_map [R, 3], weights [R, S]) with the pre-scaled
    density ``noise`` [R, S] added to the raw densities and
    sse = Σ_rays ‖rgb_map − target‖²."""
    R, S = z_vals.shape
    pts = rays_o[:, None, :] + z_vals[..., None] * rays_d[:, None, :]
    x_pos = pos_enc.apply(pts.reshape(R * S, 3))
    dirs = viewdirs[:, None, :].expand(R, S, 3).reshape(R * S, 3)
    raw = mlp(x_pos, dir_enc.apply(dirs)).reshape(R, S, 4)
    q, alpha = _alpha_terms(tspec, raw[..., 3] + noise, deltas)
    w = alpha * torch.exp(-exclusive_cumsum(q))
    c = torch.sigmoid(raw[..., :3]) if tspec.mode == "canonical" else raw[..., :3]
    rgb_map = torch.sum(w[..., None] * c, dim=1)
    if tspec.white_bkgd:
        rgb_map = rgb_map + (1.0 - torch.sum(w, dim=1, keepdim=True))
    sse = torch.sum((rgb_map - target) ** 2)
    return sse, rgb_map, w


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _pack_flat(tensors: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, List[int]]:
    """The tensors flattened into one fp32 buffer, each piece starting on a
    16-byte boundary (zero padding between), and the piece offsets."""
    pieces: List[torch.Tensor] = []
    offs: List[int] = []
    n = 0
    for t in tensors:
        flat = t.detach().to(torch.float32).reshape(-1)
        pad = (-flat.numel()) % 4
        offs.append(n)
        pieces.append(flat)
        if pad:
            pieces.append(flat.new_zeros(pad))
        n += flat.numel() + pad
    return torch.cat(pieces).contiguous(), offs


def _forward_pieces(mlp, pos_enc, dir_enc) -> List[torch.Tensor]:
    dev = mlp.pos_linears[0].weight.device
    pieces: List[torch.Tensor] = []
    for _, lin in mlp.linears():
        pieces += [lin.weight.t(), lin.bias]
    return pieces + [pos_enc.bands(dev), dir_enc.bands(dev)]


def pack_eval_weights(mlp, pos_enc, dir_enc) -> Tuple[torch.Tensor, torch.Tensor]:
    """One flat fp32 buffer with every weight as [fan_in, fan_out] (the JAX
    pytree's ``w``, i.e. ``nn.Linear.weight`` transposed), the biases and the
    frequency bands, each piece starting on a 16-byte boundary; and the
    int32 offsets the kernel reads them by: (w, b) for each position layer,
    then alpha, feature, dir and rgb, then the position and direction bands."""
    wbuf, offs = _pack_flat(_forward_pieces(mlp, pos_enc, dir_enc))
    return wbuf, torch.tensor(offs, dtype=torch.int32, device=wbuf.device)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` and the kernels' ``split_tf32`` round."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


# K order inside a k-step of 8: the wgmma's K index 0..3 holds features 0,
# 2, 4, 6 of the step and 4..7 features 1, 3, 5, 7, so that a lane loads its
# two features of a row (2t, 2t + 1) as one 64-bit word
WGMMA_K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _wgmma_image(w: torch.Tensor, segments: Sequence[int]) -> torch.Tensor:
    """The shared-memory images the eval kernel's wgmmas read as B for
    one dense layer, ``w`` = ``nn.Linear.weight`` [N, K]: its input
    ``segments`` (column counts, in order) each padded with zero columns to
    a multiple of 8, then per k-step of 8 columns (in ``WGMMA_K_ORDER``)
    the TF32 hi half, then the lo half (hi = tf32(w), lo = tf32(w - hi)),
    each as core matrices [K half (2)][N / 8][8 rows of N][4 of K]: 16·N
    floats a k-step, one stage of the kernel's ring."""
    n = w.shape[0]
    cols, a = [], 0
    for width in segments:
        cols.append(w[:, a : a + width])
        if width % 8:
            cols.append(w.new_zeros((n, 8 - width % 8)))
        a += width
    if a != w.shape[1]:
        raise ValueError(f"segments {segments} do not cover {w.shape[1]} inputs")
    wp = torch.cat(cols, 1).to(torch.float32)
    steps = wp.shape[1] // 8
    x = wp.reshape(n, steps, 8)[:, :, list(WGMMA_K_ORDER)]
    x = x.reshape(n // 8, 8, steps, 2, 4).permute(2, 3, 0, 1, 4)  # [step, K half, N/8, 8, 4]
    hi = _tf32(x)
    return torch.stack([hi, _tf32(x - hi)], 1).reshape(-1)


@torch.no_grad()
def pack_eval_wgmma(mlp, pos_enc, dir_enc) -> torch.Tensor:
    """One flat fp32 buffer of every dense layer's B images for the eval
    kernel (``_wgmma_image``), k-step after k-step in the order the kernel
    consumes them: the D trunk layers (a skip layer's input is [encoded
    position, h]), the feature layer, then the view layer ([feature,
    encoded direction]). The alpha and rgb heads, the biases and the bands
    stay in ``pack_eval_weights``' buffer. Packed on the parameters' device,
    once per launch."""
    cfg = mlp.cfg
    W, P = cfg.net_width, pos_enc.out_dim
    pieces = []
    for j, lin in enumerate(mlp.pos_linears):
        segs = [P] if j == 0 else ([P, W] if (j - 1) in cfg.skips else [W])
        pieces.append(_wgmma_image(lin.weight.detach(), segs))
    pieces.append(_wgmma_image(mlp.feature_linear.weight.detach(), [W]))
    pieces.append(_wgmma_image(mlp.dir_linear.weight.detach(), [W, dir_enc.out_dim]))
    return torch.cat(pieces)


def _kernel_lib(width: int):
    from nerf_meets_mlx_torch.kernels import _build

    return type_eval_lib(_build.load_library("fused_eval", width_defines(width)))


def type_eval_lib(lib):
    """``lib``, a build of csrc/fused_eval.cu, with its C functions typed."""
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_eval_launch.argtypes = [vp] * 10 + [ci] * 5 + [ctypes.c_uint] + [ci] * 7 + [vp]
        lib.fused_eval_launch.restype = ci
        lib.fused_eval_smem_bytes.argtypes = [ci] * 3
        lib.fused_eval_smem_bytes.restype = ctypes.c_longlong
        lib.fused_eval_image_floats.argtypes = [ci, ci, ctypes.c_uint, ci, ci]
        lib.fused_eval_image_floats.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _check_kernel_config(mlp, pos_enc, dir_enc, kernel: str = "eval", max_depth: int = 31):
    cfg = mlp.cfg
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"the CUDA {kernel} kernel computes in fp32 only; bf16 compute is "
            "queued in ROADMAP.md (the plain path runs it on the CPU)"
        )
    if not cfg.use_viewdirs:
        raise ValueError(f"the fused {kernel} kernel covers the view-direction head")
    if not width_ok(cfg.net_width):
        raise ValueError(
            f"the fused {kernel} kernel takes a net_width that is a multiple of 16 from "
            f"{MIN_WIDTH} to {MAX_WIDTH}, not {cfg.net_width}"
        )
    if cfg.net_depth > max_depth or any(not 0 <= s < cfg.net_depth - 1 for s in cfg.skips):
        raise ValueError(f"unsupported depth/skips: {cfg.net_depth}, {cfg.skips}")
    for enc in (pos_enc, dir_enc):
        if not hasattr(enc, "bands") or enc.in_dim != 3:
            raise ValueError(f"the fused {kernel} kernel takes 3-D sinusoidal encodings")


def _checked_inputs(dev, tspec: TrainSpec, R: int, S: int, named) -> List[torch.Tensor]:
    """Contiguous copies of the (name, tensor, shape) inputs after checking
    device, dtype and shape, and the spec's sample count and modes."""
    if S != tspec.n_samples:
        raise ValueError(f"z_vals has {S} samples, tspec says {tspec.n_samples}")
    if tspec.mode not in ("canonical", "reference"):
        raise ValueError(tspec.mode)
    if tspec.density_activation not in ("softplus", "relu"):
        raise ValueError(tspec.density_activation)
    out = []
    for name, t, shape in named:
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected float32 {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
        out.append(t.contiguous())
    return out


@torch.no_grad()
def fused_eval_apply(
    mlp, pos_enc, dir_enc, tspec: TrainSpec,
    rays_o, rays_d, viewdirs, z_vals, deltas,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-only render op: (rgb_map [R, 3], weights [R, S]).

    rays_o/rays_d/viewdirs [R, 3]; z_vals and deltas [R, S] (deltas already
    scaled by ||rays_d||, terminal bin 1e10·||rays_d||). CPU tensors run the
    plain version; CUDA tensors launch ``csrc/fused_eval.cu`` or raise.
    Not differentiable (the kernel has no backward), so it runs under
    ``no_grad``, as the JAX op stops the gradient."""
    dev = rays_o.device
    if dev.type == "cpu":
        return fused_eval_reference(
            mlp, pos_enc, dir_enc, tspec, rays_o, rays_d, viewdirs, z_vals, deltas
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_eval_apply runs on cuda or cpu tensors, not {dev}")
    _check_kernel_config(mlp, pos_enc, dir_enc)
    R, S = z_vals.shape
    args = _checked_inputs(dev, tspec, R, S, (
        ("rays_o", rays_o, (R, 3)), ("rays_d", rays_d, (R, 3)),
        ("viewdirs", viewdirs, (R, 3)), ("z_vals", z_vals, (R, S)),
        ("deltas", deltas, (R, S)),
    ))
    if mlp.pos_linears[0].weight.device != dev:
        raise ValueError("the MLP's parameters must be on the rays' device")

    cfg = mlp.cfg
    lib = _kernel_lib(cfg.net_width)
    smem = lib.fused_eval_smem_bytes(cfg.net_width, S, tspec.rays_block)
    if not 0 < smem <= 232448:
        raise ValueError(
            f"S={S} with rays_block={tspec.rays_block} needs {smem} bytes of "
            "shared memory per block (at most 232448)"
        )
    skip_mask = sum(1 << (s + 1) for s in cfg.skips)
    wbuf, offs = pack_eval_weights(mlp, pos_enc, dir_enc)
    wimg = pack_eval_wgmma(mlp, pos_enc, dir_enc)
    want = lib.fused_eval_image_floats(
        cfg.net_depth, cfg.net_width, skip_mask, pos_enc.out_dim, dir_enc.out_dim
    )
    if wimg.numel() != want:
        raise RuntimeError(f"pack_eval_wgmma wrote {wimg.numel()} floats, the kernel reads {want}")
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    wts = torch.empty((R, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_eval_launch(
            *(t.data_ptr() for t in args), wimg.data_ptr(), wbuf.data_ptr(), offs.data_ptr(),
            rgb.data_ptr(), wts.data_ptr(),
            R, S, tspec.rays_block, cfg.net_depth, cfg.net_width, skip_mask,
            pos_enc.n_freqs, int(pos_enc.include_input),
            dir_enc.n_freqs, int(dir_enc.include_input),
            0 if tspec.mode == "canonical" else 1,
            int(tspec.density_activation == "relu"), int(tspec.white_bkgd),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_eval launch failed with cudaError {err}")
    LAUNCHES["eval"] += 1
    return rgb, wts


# ---------------------------------------------------------------------------
# Train kernel
# ---------------------------------------------------------------------------


def _train_pieces(mlp, pos_enc, dir_enc) -> List[torch.Tensor]:
    cfg = mlp.cfg
    pieces = _forward_pieces(mlp, pos_enc, dir_enc)
    for j in range(1, cfg.net_depth):
        w = mlp.pos_linears[j].weight
        pieces.append(w[:, mlp.in_dim:] if (j - 1) in cfg.skips else w)
    pieces.append(torch.cat([mlp.feature_linear.weight, mlp.alpha_linear.weight], dim=0))
    pieces.append(mlp.dir_linear.weight[:, : cfg.net_width])
    return pieces


def pack_train_weights(mlp, pos_enc, dir_enc) -> Tuple[torch.Tensor, List[int]]:
    """The eval kernel's buffer (offsets 0 .. 2·D+9: the forward weights as
    [fan_in, fan_out], the biases, the bands) followed by the backward's
    matrices, each the forward one transposed, i.e. a slice of
    ``nn.Linear.weight``: the hidden-input part of every trunk layer j ≥ 1
    (offset 2·D+10+j−1), the feature weight with the alpha row under it
    (3·D+9), and the view layer's feature part (3·D+10). The kernel's dW
    buffer has the layout of the forward part (its first 2·D+8 pieces)."""
    return _pack_flat(_train_pieces(mlp, pos_enc, dir_enc))


def _train_lib(width: int):
    from nerf_meets_mlx_torch.kernels import _build

    lib = _build.load_library("fused_train", width_defines(width))
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_train_launch.argtypes = (
            [vp] * 9 + [ci] + [vp] * 5 + [ci] * 5 + [ctypes.c_uint] + [ci] * 9 + [vp]
        )
        lib.fused_train_launch.restype = ci
        lib.fused_train_smem_bytes.argtypes = [ci] * 5
        lib.fused_train_smem_bytes.restype = ctypes.c_longlong
        lib.fused_train_workspace_floats.argtypes = [ci] * 9
        lib.fused_train_workspace_floats.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _train_launch(mlp, pos_enc, dir_enc, tspec: TrainSpec, args):
    """One call of ``csrc/fused_train.cu``: (sse, rgb, weights, grads) with
    grads = d(sse)/d(weight, bias) of every ``mlp.linears()`` entry."""
    rays_o = args[0]
    dev = rays_o.device
    R, S = args[3].shape
    cfg = mlp.cfg
    lib = _train_lib(cfg.net_width)
    smem = lib.fused_train_smem_bytes(
        cfg.net_width, S, tspec.rays_block, pos_enc.out_dim, dir_enc.out_dim
    )
    if not 0 < smem <= 232448:
        raise ValueError(
            f"S={S} with rays_block={tspec.rays_block} needs {smem} bytes of "
            "shared memory per block (at most 232448)"
        )
    wbuf, offs = pack_train_weights(mlp, pos_enc, dir_enc)
    n_dw = offs[2 * cfg.net_depth + 8]
    pts_per_split = tspec.group * tspec.rays_block * S
    n_ws = lib.fused_train_workspace_floats(
        R, S, tspec.rays_block, cfg.net_depth, cfg.net_width,
        pos_enc.out_dim, dir_enc.out_dim, pts_per_split, n_dw,
    )
    ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    wts = torch.empty((R, S), dtype=torch.float32, device=dev)
    sse = torch.empty((1,), dtype=torch.float32, device=dev)
    dw = torch.empty((n_dw,), dtype=torch.float32, device=dev)
    c_offs = (ctypes.c_int * len(offs))(*offs)
    skip_mask = sum(1 << (s + 1) for s in cfg.skips)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_train_launch(
            *(t.data_ptr() for t in args), wbuf.data_ptr(), c_offs, len(offs),
            rgb.data_ptr(), wts.data_ptr(), sse.data_ptr(), dw.data_ptr(), ws.data_ptr(),
            R, S, tspec.rays_block, cfg.net_depth, cfg.net_width, skip_mask,
            pos_enc.n_freqs, int(pos_enc.include_input),
            dir_enc.n_freqs, int(dir_enc.include_input),
            0 if tspec.mode == "canonical" else 1,
            int(tspec.density_activation == "relu"), int(tspec.white_bkgd),
            pts_per_split, n_dw, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_train launch failed with cudaError {err}")
    LAUNCHES["train"] += 1
    grads = []
    for i, (_, lin) in enumerate(mlp.linears()):
        o_w, o_b = offs[2 * i], offs[2 * i + 1]
        fi, fo = lin.in_features, lin.out_features
        grads.append(dw[o_w : o_w + fi * fo].view(fi, fo).t().contiguous())
        grads.append(dw[o_b : o_b + fo])
    return sse[0], rgb, wts, grads


class _FusedTrain(torch.autograd.Function):
    """sse as a function of the MLP's parameters. The forward runs the
    kernel, which returns d(sse)/d(every parameter) beside the values; the
    backward scales those by the incoming sse cotangent. rgb_map and
    weights are not differentiable (the JAX op stops their gradient)."""

    @staticmethod
    def forward(ctx, launch, *params):
        sse, rgb, wts, grads = launch()
        ctx.save_for_backward(*grads)
        ctx.mark_non_differentiable(rgb, wts)
        return sse, rgb, wts

    @staticmethod
    def backward(ctx, dsse, _drgb, _dwts):
        return (None, *(dsse * g for g in ctx.saved_tensors))


def fused_train_apply(
    mlp, pos_enc, dir_enc, tspec: TrainSpec,
    rays_o, rays_d, viewdirs, z_vals, deltas, noise, target,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-call train op of a level: (sse, rgb_map [R, 3], weights [R, S]).

    Inputs as ``fused_eval_apply``'s plus the pre-scaled density noise
    [R, S] (zeros when off) and the target colours [R, 3]. sse is the only
    differentiable output, with respect to the MLP's parameters; rgb_map
    and weights come back detached. CPU tensors run the plain version
    (autograd gives the gradient); CUDA tensors launch
    ``csrc/fused_train.cu``, which computes the gradient in the same call,
    or raise."""
    dev = rays_o.device
    if dev.type == "cpu":
        sse, rgb, wts = fused_train_reference(
            mlp, pos_enc, dir_enc, tspec,
            rays_o, rays_d, viewdirs, z_vals, deltas, noise, target,
        )
        return sse, rgb.detach(), wts.detach()
    if dev.type != "cuda":
        raise ValueError(f"fused_train_apply runs on cuda or cpu tensors, not {dev}")
    # offsets passed by value: 3·depth + 11 ≤ 64
    _check_kernel_config(mlp, pos_enc, dir_enc, kernel="train", max_depth=17)
    if mlp.cfg.net_depth < 2:
        raise ValueError("the fused train kernel needs at least two trunk layers")
    R, S = z_vals.shape
    args = _checked_inputs(dev, tspec, R, S, (
        ("rays_o", rays_o, (R, 3)), ("rays_d", rays_d, (R, 3)),
        ("viewdirs", viewdirs, (R, 3)), ("z_vals", z_vals, (R, S)),
        ("deltas", deltas, (R, S)), ("noise", noise, (R, S)),
        ("target", target, (R, 3)),
    ))
    if mlp.pos_linears[0].weight.device != dev:
        raise ValueError("the MLP's parameters must be on the rays' device")
    if tspec.group < 1:
        raise ValueError(f"group must be at least 1, not {tspec.group}")
    params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]
    return _FusedTrain.apply(
        lambda: _train_launch(mlp, pos_enc, dir_enc, tspec, args), *params
    )
