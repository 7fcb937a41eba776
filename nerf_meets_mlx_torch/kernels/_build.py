"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, under ``nerf_meets_mlx_torch/build/``
(listed in ``.gitignore``), keyed by a hash of the source and the flags:
a changed source is rebuilt, an unchanged one is loaded as it is. A source
that instantiates its kernels per shape takes preprocessor ``defines`` (as
``-DNAME=value``): each set of defines is its own translation unit and
library, so the shapes a run needs build in parallel and no build compiles
shapes that it does not use. Nothing here runs at import time; the CPU
tests never reach it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills of every kernel, kept in BUILD_LOG
    "-Xptxas", "-v",
]

Defines = Optional[Mapping[str, int]]

_LIBS: Dict[Tuple[str, Tuple[Tuple[str, int], ...]], ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: Dict[str, str] = {}  # variant name -> nvcc's stderr (ptxas report)


def _flags(defines: Defines) -> List[str]:
    return [f"-D{k}={v}" for k, v in sorted((defines or {}).items())]


def variant_name(name: str, defines: Defines = None) -> str:
    """``name`` with its defines, e.g. ``fused_ingp_INGP_PP16_INGP_W64``."""
    return "_".join([name] + [f"{k}{v}" for k, v in sorted((defines or {}).items())])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # the toolkit torch found

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")


def library_path(name: str, defines: Defines = None) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + _flags(defines)).encode())
    return BUILD_DIR / f"lib{variant_name(name, defines)}_{h.hexdigest()[:16]}.so"


def build(name: str, defines: Defines = None) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``defines``) unless an up-to-date
    library exists."""
    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd: List[str] = [
        _nvcc(), *NVCC_FLAGS, *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu"),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {variant_name(name, defines)}:\n{proc.stderr}")
    BUILD_LOG[variant_name(name, defines)] = proc.stderr
    os.replace(tmp, out)
    return out


def load_library(name: str, defines: Defines = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` with ``defines``, built on
    first use."""
    key = (name, tuple(sorted((defines or {}).items())))
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, defines)))
            _LIBS[key] = lib
        return lib
