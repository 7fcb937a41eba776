"""Hash-grid encode and its gradients: feats [N, L·F] from points.

Counterpart of ``nerf_meets_mlx_tpu/kernels/hash_encode.py``. The kernels
are ``csrc/hash_encode.cu``, one for each of the six Pallas kernels:
``hash_fwd_kernel`` (the Pallas ``_fwd_body_kernel``; with
``levels_in_body=False`` ``_fwd_grid_kernel``; with ``compute_dx=True``
``_fwd_kernel``: one kernel, a thread a point and 32 bytes of its feats
row, a warp one level at a time over 32 consecutive points),
``hash_bwd_kernel``, the scatter-add into the tables
(``_bwd_body_kernel`` and ``_bwd_grid_kernel``, which give the same dG: a
block works one level over a range of points, summing the terms of a run
of points in one cell, or in face-neighbouring cells, before it adds them,
on ``bwd_plan``'s plan), and
``hash_dx_bwd_kernel`` (``_bwd_kernel``: dG and dX). The TPU formulation
(one-hot GEMM lookups into [L, T/128, F·128] packed tables) is not carried
over: the tables stay [L, T, F] and the kernels gather their rows.

* ``hash_encode_apply`` runs ``hash_encode_reference`` (the plain version)
  for CPU tensors; for CUDA tensors it goes through ``_HashEncode``, a
  ``torch.autograd.Function`` whose forward launches the forward kernel and
  whose backward launches the dG kernel, or it raises. There is no other
  fallback.
* ``compute_dtype`` (the ``hash_compute_dtype`` key) is the Pallas kernels'
  GEMM operand type. In fp32 the plain version is ``HashGridEncoding.apply``
  (autograd gives dG). In bf16 it is ``_HashEncodeBf16Plain``, which rounds
  where the Pallas body kernels round (JAX ``hash_encode.py:340-426``): the
  forward's one-hot GEMM takes bf16(w) and bf16(table) and its output is
  cast to bf16, so a corner adds bf16(bf16(w)·bf16(g)), and the 8 corners
  are summed in fp32; the backward's transposed GEMM takes bf16(w) and
  bf16(dout) (the cotangent's plane-broadcast GEMM output is cast to bf16)
  and accumulates their exact products in fp32, so dG is never rounded.
  The model's plain encode (``HashGridEncoding.apply``) reads the tables in
  fp32 in either mode, as JAX's XLA apply does.
* ``levels_in_body=False`` (the JAX spec's field; only probes set it)
  launches the one-level-per-grid-step pair, whose numbers are the body
  kernels'; its plain version is ``hash_encode_reference`` too.
* By default the points get no gradient: they are data or detached samples
  on every path of the model, as in the JAX package (whose op returns a
  zero dX there; here x is detached and gets none). ``compute_dx=True``
  makes feats differentiable with respect to x as well, as JAX's
  ``compute_dx`` does: that path computes in fp32 whatever
  ``compute_dtype`` says (the Pallas ``_fwd_kernel`` / ``_bwd_kernel`` never
  read it), and normalises as the Pallas kernels do, multiplying by
  inv = f32(1/(bbox_max − bbox_min)) where ``HashGridEncoding.apply``
  divides; the clip's gradient mask is 0 ≤ t ≤ 1, inclusive at both ends
  (``torch.clamp``'s backward agrees). Its plain version is
  ``hash_encode_dx_reference``, autograd through that formula.
* Shapes: 1..32 levels of 1, 2, 4 or 8 features, at most 128 feature
  channels (``check_hash_encoding``).
* ``LAUNCHES["hash_fwd"]`` / ``["hash_bwd"]``, ``["hash_grid_fwd"]`` /
  ``["hash_grid_bwd"]`` and ``["hash_dx_fwd"]`` / ``["hash_dx_bwd"]`` (the
  dict shared with ``fused_train``) count kernel launches, one per CUDA
  call.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES
from nerf_meets_mlx_torch.utils.tensors import round_bf16


def _hash_lib():
    from nerf_meets_mlx_torch.kernels import _build

    lib = _build.load_library("hash_encode")
    if not getattr(lib, "_typed", False):
        vp, ci, cll, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        for fn in (lib.hash_fwd_launch, lib.hash_fwd_grid_launch):
            fn.argtypes = [vp] * 3 + [cll] + [ci] * 3 + [vp, cf, cf, ci, vp]
            fn.restype = ci
        for fn in (lib.hash_bwd_launch, lib.hash_bwd_grid_launch):
            fn.argtypes = [vp] * 3 + [cll] + [ci] * 3 + [vp, cf, cf, ci, ci, cll, vp]
            fn.restype = ci
        lib.hash_dx_fwd_launch.argtypes = [vp] * 3 + [cll] + [ci] * 3 + [vp, cf, cf, vp]
        lib.hash_dx_fwd_launch.restype = ci
        lib.hash_dx_bwd_launch.argtypes = [vp] * 5 + [cll] + [ci] * 3 + [vp, cf, cf, vp]
        lib.hash_dx_bwd_launch.restype = ci
        lib._typed = True
    return lib


# the shapes csrc/hash_encode.cu takes
MAX_LEVELS = 32
FEATURES = (1, 2, 4, 8)
MAX_CHANNELS = 128


# the table gradient's plan (csrc/hash_encode.cu's hash_bwd_kernel)
BWD_THREADS = 512          # its 128 registers a thread fill an SM's 65,536
MIN_THREAD_POINTS = 8      # fewer ranges where the points would give a thread fewer


def bwd_plan(n_levels: int, n_points: int, n_sm: int):
    """(ranges, block_points) of ``hash_bwd_kernel``: a block works one
    level over one of ``ranges`` contiguous ranges of ``block_points``
    points, one block an SM. The SMs are shared equally by the levels,
    since every level takes every point."""
    ranges = max(1, min(n_sm // n_levels,
                        -(-n_points // (BWD_THREADS * MIN_THREAD_POINTS))))
    return ranges, max(1, -(-n_points // ranges))


def check_hash_encoding(enc) -> None:
    """Raise unless the CUDA hash kernels take this encoding."""
    if enc.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"hash compute_dtype is float32 or bfloat16, not {enc.compute_dtype!r}")
    L, F = enc.n_levels, enc.features_per_level
    if F not in FEATURES or not 1 <= L <= MAX_LEVELS or L * F > MAX_CHANNELS:
        raise ValueError(
            f"the CUDA hash kernels take {FEATURES} features a level, 1..{MAX_LEVELS} levels "
            f"and at most {MAX_CHANNELS} feature channels, not {L} levels of {F}"
        )
    if enc.tables.dtype != torch.float32 or not enc.tables.is_contiguous():
        raise ValueError("the hash tables must be contiguous float32")


def _geometry(enc):
    """(levels, features, log2 T, host int32 resolutions, bbox min, box size,
    bf16 flag) as the kernels take them: the box size in float32, as the
    plain version divides by it."""
    res = enc.resolutions
    c_res = (ctypes.c_int * len(res))(*(int(r) for r in res))
    brange = float(torch.tensor(enc.bbox_max - enc.bbox_min, dtype=torch.float32))
    return (enc.n_levels, enc.features_per_level, enc.log2_table_size, c_res,
            float(enc.bbox_min), brange, int(enc.compute_dtype == "bfloat16"))


def _inv(enc) -> float:
    """The Pallas kernels' normaliser, f32(1 / (bbox_max − bbox_min)) (JAX
    rounds the Python float to the points' float32)."""
    return float(torch.tensor(1.0 / (enc.bbox_max - enc.bbox_min), dtype=torch.float32))


def _fwd_launch(enc, x: torch.Tensor, grid: bool = False) -> torch.Tensor:
    """One call of ``hash_fwd_kernel`` (``grid``: through the
    one-level-per-grid-step entry point): feats [N, L·F]."""
    dev = x.device
    N = x.shape[0]
    L, F, log2_t, c_res, bmin, brange, bf16 = _geometry(enc)
    feats = torch.empty((N, L * F), dtype=torch.float32, device=dev)
    lib = _hash_lib()
    launch = lib.hash_fwd_grid_launch if grid else lib.hash_fwd_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            x.data_ptr(), enc.tables.data_ptr(), feats.data_ptr(), N, L, F, log2_t, c_res,
            bmin, brange, bf16, stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_encode forward launch failed with cudaError {err}")
    LAUNCHES["hash_grid_fwd" if grid else "hash_fwd"] += 1
    return feats


def _bwd_launch(enc, x: torch.Tensor, dout: torch.Tensor, grid: bool = False) -> torch.Tensor:
    """One call of ``hash_bwd_kernel`` on ``bwd_plan``'s plan (``grid``:
    through the one-level-per-grid-step entry point): dG [L, T, F] of
    Σ dout · feats."""
    dev = x.device
    N = x.shape[0]
    L, F, log2_t, c_res, bmin, brange, bf16 = _geometry(enc)
    ranges, block_points = bwd_plan(
        L, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    dG = torch.zeros(enc.tables.shape, dtype=torch.float32, device=dev)
    lib = _hash_lib()
    launch = lib.hash_bwd_grid_launch if grid else lib.hash_bwd_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            x.data_ptr(), dout.data_ptr(), dG.data_ptr(), N, L, F, log2_t, c_res,
            bmin, brange, bf16, ranges, block_points, stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_encode backward launch failed with cudaError {err}")
    LAUNCHES["hash_grid_bwd" if grid else "hash_bwd"] += 1
    return dG


def _dx_fwd_launch(enc, x: torch.Tensor) -> torch.Tensor:
    """One call of the compute_dx forward: feats [N, L·F] in fp32."""
    dev = x.device
    N = x.shape[0]
    L, F, log2_t, c_res, bmin, _, _ = _geometry(enc)
    feats = torch.empty((N, L * F), dtype=torch.float32, device=dev)
    lib = _hash_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hash_dx_fwd_launch(
            x.data_ptr(), enc.tables.data_ptr(), feats.data_ptr(), N, L, F, log2_t, c_res,
            bmin, _inv(enc), stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_encode compute_dx forward launch failed with cudaError {err}")
    LAUNCHES["hash_dx_fwd"] += 1
    return feats


def _dx_bwd_launch(enc, x: torch.Tensor, dout: torch.Tensor):
    """One call of ``hash_dx_bwd_kernel``: (dX [N, 3], dG [L, T, F]) of
    Σ dout · feats."""
    dev = x.device
    N = x.shape[0]
    L, F, log2_t, c_res, bmin, _, _ = _geometry(enc)
    dG = torch.zeros(enc.tables.shape, dtype=torch.float32, device=dev)
    dX = torch.empty((N, 3), dtype=torch.float32, device=dev)
    lib = _hash_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hash_dx_bwd_launch(
            x.data_ptr(), enc.tables.data_ptr(), dout.data_ptr(), dG.data_ptr(), dX.data_ptr(),
            N, L, F, log2_t, c_res, bmin, _inv(enc), stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_encode compute_dx backward launch failed with cudaError {err}")
    LAUNCHES["hash_dx_bwd"] += 1
    return dX, dG


class _HashEncodeBf16Plain(torch.autograd.Function):
    """The bf16-mode plain version: feats [N, L·F] as a function of the
    tables, rounded as the Pallas kernels round (module docstring)."""

    @staticmethod
    def forward(ctx, enc, x, tables):
        ctx.enc = enc
        ctx.save_for_backward(x, tables)
        level = torch.arange(enc.n_levels, device=x.device)[None, :]
        tb = round_bf16(tables)
        feats = torch.zeros((x.shape[0], enc.n_levels, enc.features_per_level),
                            dtype=torch.float32, device=x.device)
        for h, w in enc.corners(x):
            feats = feats + round_bf16(tb[level, h] * round_bf16(w)[..., None])
        return feats.reshape(x.shape[0], enc.out_dim)

    @staticmethod
    def backward(ctx, dout):
        x, tables = ctx.saved_tensors
        enc = ctx.enc
        L, T, F = tables.shape
        d = round_bf16(dout.reshape(-1, L, F))
        level = torch.arange(L, device=x.device)[None, :]
        dG = torch.zeros_like(tables)
        flat = dG.view(L * T, F)
        for h, w in enc.corners(x):
            flat.index_add_(0, (level * T + h).reshape(-1),
                            (round_bf16(w)[..., None] * d).reshape(-1, F))
        return None, None, dG


def hash_encode_reference(enc, x: torch.Tensor) -> torch.Tensor:
    """The hash kernels' function in plain torch, differentiable with respect
    to the tables: ``enc.apply`` in fp32, ``_HashEncodeBf16Plain`` in bf16."""
    if enc.compute_dtype != "bfloat16":
        return enc.apply(x)
    lead = x.shape[:-1]
    feats = _HashEncodeBf16Plain.apply(enc, x.reshape(-1, 3), enc.tables)
    return feats.reshape(*lead, enc.out_dim)


def hash_encode_dx_reference(enc, x: torch.Tensor) -> torch.Tensor:
    """The ``compute_dx`` kernels' function in plain torch, differentiable by
    autograd with respect to x and the tables: the fp32 encode (whatever
    ``enc.compute_dtype`` says) of u = clip((x − bbox_min)·inv, 0, 1), inv =
    f32(1/(bbox_max − bbox_min)), as the Pallas kernels normalise."""
    lead = x.shape[:-1]
    x = x.reshape(-1, 3)
    inv = torch.tensor(_inv(enc), dtype=torch.float32, device=x.device)
    u = torch.clamp((x - enc.bbox_min) * inv, 0.0, 1.0)
    level = torch.arange(enc.n_levels, device=x.device)[None, :]
    feats = torch.zeros((x.shape[0], enc.n_levels, enc.features_per_level),
                        dtype=torch.float32, device=x.device)
    for h, w in enc.corners(x, u=u):
        feats = feats + enc.tables[level, h] * w[..., None]
    return feats.reshape(*lead, enc.out_dim)


class _HashEncode(torch.autograd.Function):
    """feats as a function of the tables. The forward launches the forward
    kernel (``grid``: the one-level-per-grid-step instance) and keeps the
    points; the backward launches the dG kernel of the same layout, which
    recomputes the corners and their weights."""

    @staticmethod
    def forward(ctx, enc, grid, x, tables):
        ctx.enc, ctx.grid = enc, grid
        ctx.save_for_backward(x, tables)  # the tables' version is checked in backward
        return _fwd_launch(enc, x, grid)

    @staticmethod
    def backward(ctx, dout):
        x, _ = ctx.saved_tensors
        return None, None, None, _bwd_launch(ctx.enc, x, dout.contiguous(), ctx.grid)


class _HashEncodeDx(torch.autograd.Function):
    """feats as a function of the points and the tables (``compute_dx``):
    the forward launches the fp32 compute_dx forward; the backward launches
    ``hash_dx_bwd_kernel``, which gathers the corners again and returns dX
    and dG."""

    @staticmethod
    def forward(ctx, enc, x, tables):
        ctx.enc = enc
        ctx.save_for_backward(x, tables)
        return _dx_fwd_launch(enc, x)

    @staticmethod
    def backward(ctx, dout):
        x, _ = ctx.saved_tensors
        dX, dG = _dx_bwd_launch(ctx.enc, x, dout.contiguous())
        return None, dX, dG


def hash_encode_apply(enc, x: torch.Tensor, *, compute_dx: bool = False,
                      levels_in_body: bool = True) -> torch.Tensor:
    """Hash-grid encode of points ``x`` [..., 3] -> [..., L·F] (feature
    l·F + f), differentiable with respect to ``enc.tables``, and with
    ``compute_dx`` with respect to ``x`` too (in fp32; see the module
    docstring). Without ``compute_dx`` x is detached, where JAX's op gives
    it a zero gradient. ``levels_in_body=False`` takes the
    one-level-per-grid-step kernels (the same function). CPU tensors run the
    plain version (``hash_encode_dx_reference`` or
    ``hash_encode_reference``); CUDA tensors launch ``csrc/hash_encode.cu``
    or raise."""
    if not compute_dx:
        x = x.detach()
    dev = x.device
    if dev.type == "cpu":
        return hash_encode_dx_reference(enc, x) if compute_dx else hash_encode_reference(enc, x)
    if dev.type != "cuda":
        raise ValueError(f"hash_encode_apply runs on cuda or cpu tensors, not {dev}")
    check_hash_encoding(enc)
    if x.dtype != torch.float32 or x.shape[-1] != 3:
        raise ValueError(f"x: expected float32 [..., 3], got {x.dtype} {tuple(x.shape)}")
    if enc.tables.device != dev:
        raise ValueError("the hash tables must be on the points' device")
    lead = x.shape[:-1]
    flat = x.reshape(-1, 3).contiguous()
    if compute_dx:
        feats = _HashEncodeDx.apply(enc, flat, enc.tables)
    else:
        feats = _HashEncode.apply(enc, not levels_in_body, flat, enc.tables)
    return feats.reshape(*lead, enc.out_dim)
