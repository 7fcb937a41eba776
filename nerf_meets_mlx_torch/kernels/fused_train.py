"""Forward-only fused eval op: points → encode → MLP → compositing, one CUDA
launch per level.

Counterpart of the eval half of ``nerf_meets_mlx_tpu/kernels/fused_train.py``
(``fused_eval_apply`` over the Pallas ``_eval_kernel``). The kernel is
``csrc/fused_eval.cu``; this module holds its wrapper, its plain PyTorch
version and the shared compositing math.

* ``fused_eval_apply`` launches the kernel for CUDA tensors (or raises) and
  runs ``fused_eval_reference`` for CPU tensors. There is no other fallback.
* ``fused_eval_reference`` is the same function in plain torch, point-major
  (the counterpart of the JAX twin ``_reference_from_x``).
* ``LAUNCHES["eval"]`` counts kernel launches, one per CUDA call.

The train kernel (``_train_kernel``, rgb/weights plus the closed-form
backward) is the next slice of the port and is not here yet.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Tuple

import torch

from nerf_meets_mlx_torch.rendering.volume import exclusive_cumsum, softplus

# kernel launches per wrapper; a run sets them to 0 and reads them after
LAUNCHES: Dict[str, int] = {"eval": 0}


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """Static description of the compositing stage of one level."""

    n_samples: int            # S: depth samples per ray
    rays_block: int           # rays per CUDA block (eval_block)
    mode: str                 # "canonical" | "reference" (rendering/volume.py)
    density_activation: str   # "softplus" | "relu" (canonical mode only)
    white_bkgd: bool


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
    needs 20·S bytes per ray of shared memory beside its 181,760 bytes of
    tiles; at one ray per block S = 1024 still fits the 232,448 bytes a
    block may use."""
    return 1024


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


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------


def pack_eval_weights(mlp, pos_enc, dir_enc) -> Tuple[torch.Tensor, torch.Tensor]:
    """One flat fp32 buffer with every weight as [fan_in, fan_out] (the JAX
    pytree's ``w``, i.e. ``nn.Linear.weight`` transposed), the biases and the
    frequency bands, each piece starting on a 16-byte boundary; and the
    int32 offsets the kernel reads them by: (w, b) for each position layer,
    then alpha, feature, dir and rgb, then the position and direction bands."""
    dev = mlp.pos_linears[0].weight.device
    pieces: List[torch.Tensor] = []
    offs: List[int] = []
    n = 0

    def put(t: torch.Tensor):
        nonlocal n
        flat = t.detach().to(torch.float32).reshape(-1)
        pad = (-flat.numel()) % 4
        offs.append(n)
        pieces.append(flat)
        if pad:
            pieces.append(flat.new_zeros(pad))
        n += flat.numel() + pad

    for _, lin in mlp.linears():
        put(lin.weight.t())
        put(lin.bias)
    put(pos_enc.bands(dev))
    put(dir_enc.bands(dev))
    wbuf = torch.cat(pieces).contiguous()
    return wbuf, torch.tensor(offs, dtype=torch.int32, device=dev)


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


def _check_kernel_config(mlp, pos_enc, dir_enc):
    cfg = mlp.cfg
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "the CUDA eval kernel computes in fp32 only; bf16 compute is queued "
            "in ROADMAP.md (the plain path runs it on the CPU)"
        )
    if not cfg.use_viewdirs:
        raise ValueError("the fused eval kernel covers the view-direction head")
    if cfg.net_width not in (128, 256):
        raise ValueError(f"the fused eval kernel takes net_width 128 or 256, not {cfg.net_width}")
    if cfg.net_depth > 31 or any(not 0 <= s < cfg.net_depth - 1 for s in cfg.skips):
        raise ValueError(f"unsupported depth/skips: {cfg.net_depth}, {cfg.skips}")
    for enc in (pos_enc, dir_enc):
        if not hasattr(enc, "bands") or enc.in_dim != 3:
            raise ValueError("the fused eval kernel takes 3-D sinusoidal encodings")


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
    if S != tspec.n_samples:
        raise ValueError(f"z_vals has {S} samples, tspec says {tspec.n_samples}")
    if tspec.mode not in ("canonical", "reference"):
        raise ValueError(tspec.mode)
    if tspec.density_activation not in ("softplus", "relu"):
        raise ValueError(tspec.density_activation)
    args = []
    for name, t, shape in (
        ("rays_o", rays_o, (R, 3)), ("rays_d", rays_d, (R, 3)),
        ("viewdirs", viewdirs, (R, 3)), ("z_vals", z_vals, (R, S)),
        ("deltas", deltas, (R, S)),
    ):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected float32 {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
        args.append(t.contiguous())
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
