"""CP-grid encode and its line gradient: feats [N, L·C] from points.

Counterpart of ``nerf_meets_mlx_tpu/kernels/cp_encode.py``. The kernels are
``csrc/cp_encode.cu``: ``cp_fwd_kernel`` (the Pallas ``_fwd_grid_kernel``)
and ``cp_bwd_kernel`` (the Pallas ``_bwd_grid_kernel``). The TPU formulation
(a [block, R_max] hat matrix from an iota compare, contracted on the MXU
against lines padded to 128 rows) is not carried over: a point reads the
two non-zero taps of each axis, and the lines stay [3, R_l, C] a level, in
one flat buffer.

The Pallas kernels' semantics, which the plain versions here reproduce and
the CUDA kernels are held to:

* normalise as ``(x − bbox_min) · f32(1 / (bbox_max − bbox_min))``, clipped
  to [0, 1] (the XLA ``CPGridEncoding.apply`` divides instead; the two
  differ by an ulp on some points);
* t = u·(R_l − 1), taps i0 = min(floor(t), R_l − 2) and i0 + 1 with the hat
  weights relu(1 − |t − i|) in fp32, rounded to bf16 with the lines in bf16
  mode; each axis' two products summed in fp32; the axes multiplied
  f0·f1·f2;
* the backward recomputes f0, f1, f2 and, per axis a, df_a = d · ∏_{b≠a} f_b
  in fp32 (``[f1·f2, f0·f2, f0·f1]``), rounds df_a to bf16 in bf16 mode,
  and adds bf16(w) · df_a into dLines in fp32. dLines is *not* rounded at
  the end, unlike the XLA path's autograd (one bf16 rounding of the sum).

``float32`` compute skips every rounding.

* ``cp_encode_apply(enc, x)`` is the drop-in for ``enc.apply(x)`` (JAX's
  ``cp_encode_apply(enc, params, x)``): CPU tensors run the plain twin
  ``cp_encode_reference`` (``cp_fwd_reference`` forward, ``cp_bwd_reference``
  backward); CUDA tensors launch the kernels through ``_CPEncode`` or
  raise.
* The points get no gradient: they are data or detached samples.
* ``LAUNCHES["cp_fwd"]`` / ``LAUNCHES["cp_bwd"]`` (the dict shared with
  ``fused_train``) count kernel launches, one per CUDA call.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from nerf_meets_mlx_torch.encoding.cp_grid import two_taps
from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES
from nerf_meets_mlx_torch.utils.tensors import round_bf16

# csrc/cp_encode.cu's bounds: levels; nodes a line (indices exact in fp32)
MAX_LEVELS = 16
MAX_NODES = 1 << 24
# the kernels' grids (csrc/cp_encode.cu, fwd_plan and bwd_plan): the
# forward's threads a block; the backward's threads a block, blocks an SM it
# is built for, points a lane group walks at least and at most; bytes of
# shared memory a block may use on sm_90
FWD_THREADS = 1024
BWD_THREADS = 256
BWD_MIN_BLOCKS = 2
BWD_MIN_STRETCH = 16
BWD_MAX_STRETCH = 64
MAX_SMEM = 232448


@dataclasses.dataclass(frozen=True)
class CPEncodeSpec:
    """Static description of the CP encode (hashable)."""

    n_levels: int
    resolutions: Tuple[int, ...]
    n_components: int
    bbox_min: float
    bbox_max: float
    compute_dtype: str

    @staticmethod
    def from_encoding(enc) -> "CPEncodeSpec":
        return CPEncodeSpec(
            n_levels=enc.n_levels,
            resolutions=tuple(int(r) for r in enc.resolutions),
            n_components=enc.n_components,
            bbox_min=float(enc.bbox_min),
            bbox_max=float(enc.bbox_max),
            compute_dtype=enc.compute_dtype,
        )

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_components

    @property
    def inv_range(self) -> float:
        """f32(1 / (bbox_max − bbox_min)), as the Pallas kernels take it."""
        return float(np.float32(1.0 / (self.bbox_max - self.bbox_min)))

    @property
    def bf16(self) -> bool:
        return self.compute_dtype == "bfloat16"


# ---------------------------------------------------------------------------
# Plain versions (the Pallas kernels' semantics)
# ---------------------------------------------------------------------------


def _taps(spec: CPEncodeSpec, x: torch.Tensor, r: int):
    """(i0 [N, 3], w0, w1) of one level, the weights bf16-rounded in bf16
    mode."""
    u = torch.clamp((x - spec.bbox_min) * spec.inv_range, 0.0, 1.0)
    i0, w0, w1 = two_taps(u * (r - 1), r)
    if spec.bf16:
        w0, w1 = round_bf16(w0), round_bf16(w1)
    return i0, w0, w1


def _axis_values(spec, lines_l, i0, w0, w1) -> List[torch.Tensor]:
    """f_a [N, C] for the three axes of one level."""
    fs = []
    for a in range(3):
        line = round_bf16(lines_l[a]) if spec.bf16 else lines_l[a]
        fs.append(w0[:, a : a + 1] * line[i0[:, a]] + w1[:, a : a + 1] * line[i0[:, a] + 1])
    return fs


@torch.no_grad()
def cp_fwd_reference(spec: CPEncodeSpec, lines: Sequence[torch.Tensor], x: torch.Tensor):
    """The forward kernel's function in plain torch: x [N, 3] -> [N, L·C]."""
    feats = []
    for r, lines_l in zip(spec.resolutions, lines):
        f0, f1, f2 = _axis_values(spec, lines_l, *_taps(spec, x, r))
        feats.append((f0 * f1) * f2)
    return torch.cat(feats, dim=-1)


@torch.no_grad()
def cp_bwd_reference(
    spec: CPEncodeSpec, lines: Sequence[torch.Tensor], x: torch.Tensor, dout: torch.Tensor
) -> List[torch.Tensor]:
    """The backward kernel's function in plain torch: the per-level dLines
    [3, R_l, C] of Σ dout · feats (fp32 sums of bf16(w) · bf16(df_a))."""
    C = spec.n_components
    out = []
    for li, (r, lines_l) in enumerate(zip(spec.resolutions, lines)):
        i0, w0, w1 = _taps(spec, x, r)
        f0, f1, f2 = _axis_values(spec, lines_l, i0, w0, w1)
        d = dout[:, li * C : (li + 1) * C]
        others = (f1 * f2, f0 * f2, f0 * f1)
        dl = torch.zeros((3, r, C), dtype=torch.float32, device=x.device)
        for a in range(3):
            df = d * others[a]
            if spec.bf16:
                df = round_bf16(df)
            dl[a].index_add_(0, i0[:, a], w0[:, a : a + 1] * df)
            dl[a].index_add_(0, i0[:, a] + 1, w1[:, a : a + 1] * df)
        out.append(dl)
    return out


class _CPEncodePlain(torch.autograd.Function):
    """feats as a function of the lines, in plain torch."""

    @staticmethod
    def forward(ctx, spec, x, *lines):
        ctx.spec = spec
        ctx.save_for_backward(x, *lines)
        return cp_fwd_reference(spec, lines, x)

    @staticmethod
    def backward(ctx, dout):
        x, *lines = ctx.saved_tensors
        return (None, None, *cp_bwd_reference(ctx.spec, lines, x, dout.contiguous()))


def cp_encode_reference(enc, x: torch.Tensor) -> torch.Tensor:
    """The kernels' function in plain torch, differentiable with respect to
    ``enc.lines``: x [..., 3] -> [..., L·C] (the CPU path of
    ``cp_encode_apply``)."""
    spec = CPEncodeSpec.from_encoding(enc)
    flat_x = x.detach().reshape(-1, 3).contiguous()
    return _CPEncodePlain.apply(spec, flat_x, *enc.lines).reshape(*x.shape[:-1], spec.out_dim)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _cp_lib():
    from nerf_meets_mlx_torch.kernels import _build

    lib = _build.load_library("cp_encode")
    if not getattr(lib, "_typed", False):
        vp, ci, cll, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        tail = [cll] + [ci] * 2 + [vp, vp, cf, cf, ci, vp]
        lib.cp_fwd_launch.argtypes = [vp] * 3 + tail
        lib.cp_bwd_launch.argtypes = [vp] * 4 + tail
        for fn in (lib.cp_fwd_launch, lib.cp_bwd_launch):
            fn.restype = ci
        lib.cp_plans.argtypes = [cll, ci, ci, cll, ci, vp]
        lib.cp_plans.restype = None
        lib._typed = True
    return lib


def check_cp_encoding(spec: CPEncodeSpec) -> None:
    """Raise unless the CUDA CP kernels take this encoding."""
    C = spec.n_components
    if not 1 <= spec.n_levels <= MAX_LEVELS or C % 4 or not 4 <= C <= 64:
        raise ValueError(
            f"the CUDA CP kernels take 1..{MAX_LEVELS} levels and 4..64 components in "
            f"multiples of 4, not {spec.n_levels} and {C}"
        )
    if max(spec.resolutions) > MAX_NODES:
        raise ValueError(
            f"the CUDA CP kernels take at most 2^24 nodes a line (node indices exact in "
            f"fp32), not R = {max(spec.resolutions)}"
        )


def group_width(n_components: int) -> int:
    """Lanes a (point, level) in the forward and a (stretch, level) in the
    backward: C/4 rounded up to a power of two (csrc/cp_encode.cu's
    group_width)."""
    return 1 << max(0, (n_components // 4 - 1).bit_length())


def line_floats(spec: CPEncodeSpec) -> int:
    """Floats of the flat lines: 3 · R_l · C a level."""
    return 3 * sum(spec.resolutions) * spec.n_components


def fwd_plan(spec: CPEncodeSpec, n_points: int, n_sm: int):
    """(staged, smem bytes, blocks, block_points) of ``cp_fwd_kernel``: blocks
    of FWD_THREADS walk the points, ``block_points`` a turn, block b taking
    turns b, b + blocks, ...; where the lines fit in a block's shared memory
    they are staged there and a block runs on each SM, else they are read
    through L1 and two blocks share an SM (the C launcher's fwd_plan, which
    ``cp_plans`` exports)."""
    block_points = FWD_THREADS // (spec.n_levels * group_width(spec.n_components))
    nbytes = 4 * line_floats(spec)
    staged = nbytes <= MAX_SMEM
    want = n_sm if staged else 2 * n_sm
    blocks = max(1, min(want, -(-n_points // block_points)))
    return staged, nbytes if staged else 0, blocks, block_points


def bwd_plan(n_points: int, n_levels: int, n_components: int, n_sm: int):
    """(ranges, block_points, stretch) of ``cp_bwd_kernel``: block b works
    points b · block_points onwards at every level; its BWD_THREADS / (L ·
    GW) stretches of ``stretch`` points are each walked in order by L lane
    groups, one a level. Stretches are BWD_MIN_STRETCH .. BWD_MAX_STRETCH
    points, as short as fill BWD_MIN_BLOCKS blocks an SM once (the C
    launcher's bwd_plan, which ``cp_plans`` exports)."""
    stretches = BWD_THREADS // (n_levels * group_width(n_components))
    fill = n_sm * BWD_MIN_BLOCKS * stretches
    stretch = min(BWD_MAX_STRETCH, max(BWD_MIN_STRETCH, -(-n_points // fill)))
    ranges = max(1, -(-n_points // (stretches * stretch)))
    return ranges, stretches * stretch, stretch


def kernel_plans(spec: CPEncodeSpec, n_points: int, n_sm: int):
    """The C launchers' (fwd_plan, bwd_plan) for these shapes, from the
    built library (``cp_plans``), as ``fwd_plan`` and ``bwd_plan`` give
    them."""
    out = (ctypes.c_longlong * 7)()
    _cp_lib().cp_plans(n_points, spec.n_levels, spec.n_components, line_floats(spec), n_sm, out)
    return (bool(out[0]), out[1], out[2], out[3]), (out[4], out[5], out[6])


def _geometry(spec: CPEncodeSpec):
    """Host int32 resolutions and float offsets of each level's lines in
    the flat buffer."""
    res = spec.resolutions
    offs = np.cumsum([0] + [3 * r * spec.n_components for r in res[:-1]])
    return (ctypes.c_int * len(res))(*res), (ctypes.c_longlong * len(res))(*(int(o) for o in offs))


def _launch(fn_name: str, spec: CPEncodeSpec, x, *tensors):
    """One launch of ``fn_name`` on x and ``tensors`` (the flat lines, [the
    cotangent,] the output)."""
    dev = x.device
    c_res, c_offs = _geometry(spec)
    lib = _cp_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(
            x.data_ptr(), *(t.data_ptr() for t in tensors), x.shape[0], spec.n_levels,
            spec.n_components, c_res, c_offs, spec.bbox_min, spec.inv_range, int(spec.bf16),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"cp_encode {fn_name} failed with cudaError {err}")


def cp_fwd_launch(spec: CPEncodeSpec, flat_lines: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One call of ``cp_fwd_kernel``: feats [N, L·C] from x [N, 3] and the
    lines flattened level after level (``flatten_lines``)."""
    feats = torch.empty((x.shape[0], spec.out_dim), dtype=torch.float32, device=x.device)
    _launch("cp_fwd_launch", spec, x, flat_lines, feats)
    LAUNCHES["cp_fwd"] += 1
    return feats


def cp_bwd_launch(spec: CPEncodeSpec, flat_lines: torch.Tensor, x: torch.Tensor,
                  dout: torch.Tensor) -> torch.Tensor:
    """One call of ``cp_bwd_kernel``: the flat dLines of Σ dout · feats."""
    dflat = torch.zeros_like(flat_lines)
    _launch("cp_bwd_launch", spec, x, flat_lines, dout, dflat)
    LAUNCHES["cp_bwd"] += 1
    return dflat


def flatten_lines(lines: Sequence[torch.Tensor]) -> torch.Tensor:
    """The per-level [3, R_l, C] lines as one contiguous fp32 buffer."""
    return torch.cat([p.detach().reshape(-1) for p in lines]).contiguous()


def split_lines(spec: CPEncodeSpec, flat: torch.Tensor) -> List[torch.Tensor]:
    """The inverse of ``flatten_lines``: views [3, R_l, C] a level."""
    C = spec.n_components
    sizes = [3 * r * C for r in spec.resolutions]
    return [p.view(3, r, C) for p, r in zip(torch.split(flat, sizes), spec.resolutions)]


class _CPEncode(torch.autograd.Function):
    """feats as a function of the lines. The forward launches the forward
    kernel and keeps the points and the flat lines; the backward launches
    the dLines kernel, which recomputes the taps and the three axes."""

    @staticmethod
    def forward(ctx, spec, x, *lines):
        flat = flatten_lines(lines)
        ctx.spec = spec
        ctx.save_for_backward(x, flat, *lines)  # the lines' versions are checked in backward
        return cp_fwd_launch(spec, flat, x)

    @staticmethod
    def backward(ctx, dout):
        x, flat, *_ = ctx.saved_tensors
        dflat = cp_bwd_launch(ctx.spec, flat, x, dout.contiguous())
        return (None, None, *split_lines(ctx.spec, dflat))


def cp_encode_apply(enc, x: torch.Tensor) -> torch.Tensor:
    """CP-grid encode of points ``x`` [..., 3] -> [..., L·C] (feature
    l·C + c) with the Pallas kernels' semantics, differentiable with respect
    to ``enc.lines`` only. CPU tensors run the plain versions; CUDA tensors
    launch ``csrc/cp_encode.cu`` or raise."""
    x = x.detach()
    dev = x.device
    if dev.type == "cpu":
        return cp_encode_reference(enc, x)
    spec = CPEncodeSpec.from_encoding(enc)
    lead = x.shape[:-1]
    flat_x = x.reshape(-1, 3).contiguous()
    if dev.type != "cuda":
        raise ValueError(f"cp_encode_apply runs on cuda or cpu tensors, not {dev}")
    check_cp_encoding(spec)
    if x.dtype != torch.float32 or x.shape[-1] != 3:
        raise ValueError(f"x: expected float32 [..., 3], got {x.dtype} {tuple(x.shape)}")
    for p in enc.lines:
        if p.device != dev or p.dtype != torch.float32:
            raise ValueError("the CP lines must be float32 on the points' device")
    return _CPEncode.apply(spec, flat_x, *enc.lines).reshape(*lead, spec.out_dim)
