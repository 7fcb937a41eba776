"""Hash-grid encode and its table gradient: feats [N, L·F] from points.

Counterpart of ``nerf_meets_mlx_tpu/kernels/hash_encode.py``. The kernels
are ``csrc/hash_encode.cu``: ``hash_fwd_kernel`` (the Pallas
``_fwd_body_kernel``) and ``hash_bwd_kernel``, an atomic scatter-add into
the tables (the Pallas ``_bwd_body_kernel``). The TPU formulation (one-hot
GEMM lookups into [L, T/128, F·128] packed tables) is not carried over: the
tables stay [L, T, F] and the kernels gather their rows.

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
* The points get no gradient (dX is not computed): they are data or
  detached samples on every path of the model, as in the JAX package.
* ``LAUNCHES["hash_fwd"]`` / ``LAUNCHES["hash_bwd"]`` (the dict shared
  with ``fused_train``) count kernel launches, one per CUDA call.
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
        for fn in (lib.hash_fwd_launch, lib.hash_bwd_launch):
            fn.argtypes = [vp] * 3 + [cll] + [ci] * 3 + [vp, cf, cf, ci, vp]
            fn.restype = ci
        lib._typed = True
    return lib


def check_hash_encoding(enc) -> None:
    """Raise unless the CUDA hash kernels take this encoding."""
    if enc.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"hash compute_dtype is float32 or bfloat16, not {enc.compute_dtype!r}")
    if enc.features_per_level not in (1, 2, 4) or not 1 <= enc.n_levels <= 32:
        raise ValueError(
            f"the CUDA hash kernels take 1, 2 or 4 features and 1..32 levels, not "
            f"{enc.features_per_level} and {enc.n_levels}"
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


def _fwd_launch(enc, x: torch.Tensor) -> torch.Tensor:
    """One call of ``hash_fwd_kernel``: feats [N, L·F]."""
    dev = x.device
    N = x.shape[0]
    L, F, log2_t, c_res, bmin, brange, bf16 = _geometry(enc)
    feats = torch.empty((N, L * F), dtype=torch.float32, device=dev)
    lib = _hash_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hash_fwd_launch(
            x.data_ptr(), enc.tables.data_ptr(), feats.data_ptr(), N, L, F, log2_t, c_res,
            bmin, brange, bf16, stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_encode forward launch failed with cudaError {err}")
    LAUNCHES["hash_fwd"] += 1
    return feats


def _bwd_launch(enc, x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """One call of ``hash_bwd_kernel``: dG [L, T, F] of Σ dout · feats."""
    dev = x.device
    N = x.shape[0]
    L, F, log2_t, c_res, bmin, brange, bf16 = _geometry(enc)
    dG = torch.zeros(enc.tables.shape, dtype=torch.float32, device=dev)
    lib = _hash_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hash_bwd_launch(
            x.data_ptr(), dout.data_ptr(), dG.data_ptr(), N, L, F, log2_t, c_res,
            bmin, brange, bf16, stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_encode backward launch failed with cudaError {err}")
    LAUNCHES["hash_bwd"] += 1
    return dG


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


class _HashEncode(torch.autograd.Function):
    """feats as a function of the tables. The forward launches the forward
    kernel and keeps the points; the backward launches the dG kernel, which
    recomputes the corners and their weights."""

    @staticmethod
    def forward(ctx, enc, x, tables):
        ctx.enc = enc
        ctx.save_for_backward(x, tables)  # the tables' version is checked in backward
        return _fwd_launch(enc, x)

    @staticmethod
    def backward(ctx, dout):
        x, _ = ctx.saved_tensors
        return None, None, _bwd_launch(ctx.enc, x, dout.contiguous())


def hash_encode_apply(enc, x: torch.Tensor) -> torch.Tensor:
    """Hash-grid encode of points ``x`` [..., 3] -> [..., L·F] (feature
    l·F + f), differentiable with respect to ``enc.tables`` only. CPU tensors
    run the plain version (``hash_encode_reference``); CUDA tensors launch
    ``csrc/hash_encode.cu`` through ``_HashEncode`` or raise."""
    x = x.detach()
    dev = x.device
    if dev.type == "cpu":
        return hash_encode_reference(enc, x)
    if dev.type != "cuda":
        raise ValueError(f"hash_encode_apply runs on cuda or cpu tensors, not {dev}")
    check_hash_encoding(enc)
    if x.dtype != torch.float32 or x.shape[-1] != 3:
        raise ValueError(f"x: expected float32 [..., 3], got {x.dtype} {tuple(x.shape)}")
    if enc.tables.device != dev:
        raise ValueError("the hash tables must be on the points' device")
    lead = x.shape[:-1]
    feats = _HashEncode.apply(enc, x.reshape(-1, 3).contiguous(), enc.tables)
    return feats.reshape(*lead, enc.out_dim)
