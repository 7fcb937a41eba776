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
# MLP widths that csrc/fused_eval.cu, fused_train.cu, fused_mlp.cu and
# fused_image.cu instantiate
KERNEL_WIDTHS = (32, 64, 128, 256)

LAUNCHES: Dict[str, int] = {
    "eval": 0, "train": 0, "mlp_fwd": 0, "mlp_bwd": 0,
    "hash_fwd": 0, "hash_bwd": 0, "ingp_eval": 0, "ingp_train": 0,
    "feat_train": 0, "image_train": 0, "image_fwd": 0, "cp_fwd": 0, "cp_bwd": 0,
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
# rays in shared memory (20 bytes a point) beside 181,760 bytes of activation
# and weight tiles at W=256, so a block holds about 512 points' worth of rays
# (192,000 bytes in all at S=64).
EVAL_TARGET_POINTS = 512


def eval_block(n_samples: int) -> int:
    """Rays per CUDA block for the eval kernel."""
    return max(1, EVAL_TARGET_POINTS // n_samples)


def max_fused_samples() -> int:
    """Largest per-ray sample count routed to the fused kernels. A block
    needs 20·S (eval) or 28·S (train) bytes per ray of shared memory beside
    its 181,760 bytes of tiles; at one ray per block S = 1024 still fits the
    232,448 bytes a block may use."""
    return 1024


# Train kernel: the same tiles as the eval kernel plus 28 bytes a point
# (colour, q, alpha, the two alpha derivatives) beside them, so a block
# again holds about 512 points' worth of rays (196,128 bytes at S=64) and
# runs alone on its SM; 4096 rays make 512 blocks (S=64) or 2048 (S=192).
TRAIN_TARGET_POINTS = 512
# dW = X^T dZ is summed over the points in partials of about this many
# points: at lego width a partial is 42 blocks of 128 x 128 outputs, one
# block per SM, so the coarse level's 262,144 points give 32 partials
# (1,344 blocks, 10.2 waves on 132 SMs) and the fine level's 786,432 give
# 98 (31 waves), so the last wave's idle SMs cost little; the partial
# buffer (2.4 MB each) stays small beside the stored activations.
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


def _kernel_lib():
    from nerf_meets_mlx_torch.kernels import _build

    lib = _build.load_library("fused_eval")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_eval_launch.argtypes = [vp] * 9 + [ci] * 5 + [ctypes.c_uint] + [ci] * 7 + [vp]
        lib.fused_eval_launch.restype = ci
        lib.fused_eval_smem_bytes.argtypes = [ci] * 5
        lib.fused_eval_smem_bytes.restype = ctypes.c_longlong
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
    if cfg.net_width not in KERNEL_WIDTHS:
        raise ValueError(
            f"the fused {kernel} kernel takes net_width in {KERNEL_WIDTHS}, not {cfg.net_width}"
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

    lib = _kernel_lib()
    cfg = mlp.cfg
    smem = lib.fused_eval_smem_bytes(
        cfg.net_width, S, tspec.rays_block, pos_enc.out_dim, dir_enc.out_dim
    )
    if not 0 < smem <= 232448:
        raise ValueError(
            f"S={S} with rays_block={tspec.rays_block} needs {smem} bytes of "
            "shared memory per block (at most 232448)"
        )
    wbuf, offs = pack_eval_weights(mlp, pos_enc, dir_enc)
    rgb = torch.empty((R, 3), dtype=torch.float32, device=dev)
    wts = torch.empty((R, S), dtype=torch.float32, device=dev)
    skip_mask = sum(1 << (s + 1) for s in cfg.skips)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_eval_launch(
            *(t.data_ptr() for t in args), wbuf.data_ptr(), offs.data_ptr(),
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


def _train_lib():
    from nerf_meets_mlx_torch.kernels import _build

    lib = _build.load_library("fused_train")
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
    lib = _train_lib()
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
