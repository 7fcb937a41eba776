"""Hash-grid encode and its table gradient: feats [N, L·F] from points.

Counterpart of ``nerf_meets_mlx_tpu/kernels/hash_encode.py``. The kernels
are ``csrc/hash_encode.cu``: ``hash_fwd_kernel`` (the Pallas
``_fwd_body_kernel``) and ``hash_bwd_kernel``, an atomic scatter-add into
the tables (the Pallas ``_bwd_body_kernel``). The TPU formulation (one-hot
GEMM lookups into [L, T/128, F·128] packed tables) is not carried over: the
tables stay [L, T, F] and the kernels gather their rows.

* ``hash_encode_apply`` runs ``HashGridEncoding.apply`` (the plain
  version, differentiable by autograd) for CPU tensors; for CUDA tensors it
  goes through ``_HashEncode``, a ``torch.autograd.Function`` whose forward
  launches the forward kernel and whose backward launches the dG kernel, or
  it raises. There is no other fallback.
* The points get no gradient (dX is not computed): they are data or
  detached samples on every path of the model, as in the JAX package.
* ``LAUNCHES["hash_fwd"]`` / ``LAUNCHES["hash_bwd"]`` (the dict shared
  with ``fused_train``) count kernel launches, one per CUDA call.
"""

from __future__ import annotations

import ctypes

import torch

from nerf_meets_mlx_torch.kernels.fused_train import LAUNCHES


def _hash_lib():
    from nerf_meets_mlx_torch.kernels import _build

    lib = _build.load_library("hash_encode")
    if not getattr(lib, "_typed", False):
        vp, ci, cll, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        for fn in (lib.hash_fwd_launch, lib.hash_bwd_launch):
            fn.argtypes = [vp] * 3 + [cll] + [ci] * 3 + [vp, cf, cf, vp]
            fn.restype = ci
        lib._typed = True
    return lib


def check_hash_encoding(enc) -> None:
    """Raise unless the CUDA hash kernels take this encoding."""
    if getattr(enc, "compute_dtype", "float32") != "float32":
        raise NotImplementedError(
            "the CUDA hash kernels read the tables in fp32 only; bf16 compute is queued "
            "in ROADMAP.md (the plain path runs it on the CPU)"
        )
    if enc.features_per_level not in (1, 2, 4) or not 1 <= enc.n_levels <= 32:
        raise ValueError(
            f"the CUDA hash kernels take 1, 2 or 4 features and 1..32 levels, not "
            f"{enc.features_per_level} and {enc.n_levels}"
        )
    if enc.tables.dtype != torch.float32 or not enc.tables.is_contiguous():
        raise ValueError("the hash tables must be contiguous float32")


def _geometry(enc):
    """(levels, features, log2 T, host int32 resolutions, bbox min, box size)
    as the kernels take them: the box size in float32, as the plain version
    divides by it."""
    res = enc.resolutions
    c_res = (ctypes.c_int * len(res))(*(int(r) for r in res))
    brange = float(torch.tensor(enc.bbox_max - enc.bbox_min, dtype=torch.float32))
    return (enc.n_levels, enc.features_per_level, enc.log2_table_size, c_res,
            float(enc.bbox_min), brange)


def _fwd_launch(enc, x: torch.Tensor) -> torch.Tensor:
    """One call of ``hash_fwd_kernel``: feats [N, L·F]."""
    dev = x.device
    N = x.shape[0]
    L, F, log2_t, c_res, bmin, brange = _geometry(enc)
    feats = torch.empty((N, L * F), dtype=torch.float32, device=dev)
    lib = _hash_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hash_fwd_launch(
            x.data_ptr(), enc.tables.data_ptr(), feats.data_ptr(), N, L, F, log2_t, c_res,
            bmin, brange, stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_encode forward launch failed with cudaError {err}")
    LAUNCHES["hash_fwd"] += 1
    return feats


def _bwd_launch(enc, x: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """One call of ``hash_bwd_kernel``: dG [L, T, F] of Σ dout · feats."""
    dev = x.device
    N = x.shape[0]
    L, F, log2_t, c_res, bmin, brange = _geometry(enc)
    dG = torch.zeros(enc.tables.shape, dtype=torch.float32, device=dev)
    lib = _hash_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hash_bwd_launch(
            x.data_ptr(), dout.data_ptr(), dG.data_ptr(), N, L, F, log2_t, c_res,
            bmin, brange, stream,
        )
    if err != 0:
        raise RuntimeError(f"hash_encode backward launch failed with cudaError {err}")
    LAUNCHES["hash_bwd"] += 1
    return dG


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
    run the plain version (``enc.apply``); CUDA tensors launch
    ``csrc/hash_encode.cu`` through ``_HashEncode`` or raise."""
    x = x.detach()
    dev = x.device
    if dev.type == "cpu":
        return enc.apply(x)
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
