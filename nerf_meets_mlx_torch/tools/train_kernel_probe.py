"""Where the sinusoidal train kernel's time goes, and how close it is to float64, on one card.

    python nerf_meets_mlx_torch/tools/train_kernel_probe.py

Three parts, each printed as lines starting with ``[rate]``, ``[time]`` or
``[f64]``:

* ``[rate]``: the card's mma.sync m16n8k8 TF32 rate, from a kernel in which
  every warp issues independent mmas on register operands (no loads), at 8
  and 16 warps an SM.
* ``[time]``: ``csrc/fused_train.cu`` and two variants of it built from its
  source text, at lego_hierarchical's coarse (4096 x 64) and fine
  (4096 x 192) levels: the kernel as it is, ``no_mma`` (every mma replaced
  by an empty statement that keeps its operands live: the loads, splits,
  adds, stores and barriers alone) and ``one_pass`` (hi * hi only: one TF32
  mma per product instead of three). Each with its three launches apart
  (torch.profiler). The variants compute wrong results; they only time.
* ``[f64]``: the kernel and the fp32 plain version (cuBLAS, TF32 off)
  against the plain version in float64, at widths 128 and 256, both levels'
  MLPs, every compositing mode (1000 rays x 64 samples): the largest dW
  error of each over the largest float64 value of its array, and the
  kernel's against the plain version's (the card's check: 1e-3).
"""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / ".runs" / "train_kernel_probe"  # gitignored: the variants' sources and builds

RATE_SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void mma_rate(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = a[2]; b[1] = a[3];
  float c[16][4];
  for (int j = 0; j < 16; ++j) for (int k = 0; k < 4; ++k) c[j][k] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j) for (int k = 0; k < 4; ++k) s += c[j][k];
  if (s == 123.f) out[0] = s;  // keeps the mmas live
}
extern "C" int mma_rate_launch(float* out, int blocks, int threads, int iters, void* stream) {
  mma_rate<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""

EMPTY_MMA = """__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
"""


def variant_sources() -> dict:
    """{name: source text} of the kernel and its timing variants, each with
    csrc/tf32x3.cuh (its mma helpers) written in place of its include."""
    csrc = ROOT / "nerf_meets_mlx_torch" / "csrc"
    src = (csrc / "fused_train.cu").read_text().replace(
        '#include "tf32x3.cuh"', (csrc / "tf32x3.cuh").read_text())
    start = src.index("__device__ __forceinline__ void mma_tf32(")
    mma = src[start:src.index("}\n", start) + 2]
    cross = "  mma_tf32(c, al, bh);\n  mma_tf32(c, ah, bl);\n"
    out = {"kernel": src, "no_mma": src.replace(mma, EMPTY_MMA),
           "one_pass": src.replace(cross, "")}
    for name, text in out.items():
        if name != "kernel" and text == src:
            raise RuntimeError(f"the {name} substitution no longer matches csrc/fused_train.cu")
    return out


def nvcc(name: str, text: str) -> Path:
    from nerf_meets_mlx_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    return lib


def train_lib(path: Path):
    """A build of csrc/fused_train.cu typed as kernels/fused_train.py types it."""
    lib = ctypes.CDLL(str(path))
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


def rate(lib_path: Path):
    import torch

    from chip_smoke import cuda_time_ms

    lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for blocks, threads in ((sms, 256), (2 * sms, 256), (sms, 512)):
        def run():
            if lib.mma_rate_launch(out.data_ptr(), blocks, threads, iters, stream) != 0:
                raise RuntimeError("mma_rate launch failed")

        ms = cuda_time_ms(run, 1)
        flop = blocks * threads // 32 * iters * 16 * 2 * 16 * 8 * 8
        print(f"[rate] mma.sync m16n8k8 tf32, {blocks} blocks x {threads} threads: {ms:.3f} ms, "
              f"{flop / ms / 1e9:.1f} TFLOP/s", flush=True)


def lego_levels(dev, seed=2, n_rays=4096):
    """lego_hierarchical's train-step shapes: 4096 rays of a 400 x 400 view
    (or ``n_rays``), 64 and 192 sorted depths in [2, 6], unit density
    noise."""
    import numpy as np
    import torch

    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.cameras.rays import get_rays
    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X

    g = torch.Generator(device=dev).manual_seed(seed)
    res = 400
    focal = 0.5 * res / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, res / 2], [0, focal, res / 2], [0, 0, 1]], np.float32)
    ro, rd = get_rays(res, res, K, orbit_poses(160)[0][:3, :4], device=dev)
    pick = torch.randperm(res * res, generator=g, device=dev)[:n_rays]
    ro, rd = ro.reshape(-1, 3)[pick], rd.reshape(-1, 3)[pick]
    vd = rd / torch.linalg.vector_norm(rd, dim=-1, keepdim=True)
    target = torch.rand((n_rays, 3), generator=g, device=dev)
    levels = []
    for S in (64, 192):
        z = torch.sort(torch.rand((n_rays, S), generator=g, device=dev) * 4.0 + 2.0, -1).values
        dl = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
        dl = dl * torch.linalg.vector_norm(rd, dim=-1, keepdim=True)
        levels.append((z, dl, torch.randn((n_rays, S), generator=g, device=dev)))
    return (ro, rd, vd), target, levels


def times(libs: dict):
    import torch

    from chip_smoke import TRAIN_KERNELS, cuda_time_ms, kernel_split_ms
    from nerf_meets_mlx_torch.config import lego_hierarchical
    from nerf_meets_mlx_torch.kernels import fused_train as ft
    from nerf_meets_mlx_torch.models import create_nerf

    dev = torch.device("cuda")
    model = create_nerf(lego_hierarchical().replace(use_fused_kernel=True), device=dev)
    model.init(torch.Generator(device=dev).manual_seed(0))
    (ro, rd, vd), target, levels = lego_levels(dev)
    own = ft._train_lib
    try:
        for name, lib in libs.items():
            ft._train_lib = lambda width, lib=lib: lib
            for level, mlp, (z, dl, nz) in zip(("coarse", "fine"), (model.coarse, model.fine),
                                               levels):
                S = z.shape[1]
                rb = ft.default_rays_block(S)
                spec = ft.TrainSpec(n_samples=S, rays_block=rb, mode="canonical",
                                    density_activation="softplus", white_bkgd=True,
                                    group=ft.default_group(S, rb))
                args = (mlp, model.pos_enc, model.dir_enc, spec, ro, rd, vd, z, dl, nz, target)

                def call(args=args):
                    with torch.no_grad():
                        ft.fused_train_apply(*args)

                ms = cuda_time_ms(call, 5)
                split = kernel_split_ms(call, TRAIN_KERNELS, 3)
                print(f"[time] {name:8s} {level:6s} 4096 x {S}: {ms:.3f} ms; "
                      + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()), flush=True)
    finally:
        ft._train_lib = own


def f64_errors():
    import numpy as np
    import torch

    from nerf_meets_mlx_torch.config import lego_hierarchical
    from nerf_meets_mlx_torch.kernels import fused_train as ft
    from nerf_meets_mlx_torch.models import create_nerf

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    R, S = 1000, 64
    arrays = [rng.normal(size=(R, 3)), rng.normal(size=(R, 3))]
    arrays.append(arrays[1] / np.linalg.norm(arrays[1], axis=-1, keepdims=True))
    arrays += [np.sort(rng.uniform(0.5, 4.0, size=(R, S)), -1), rng.uniform(0.01, 0.1, size=(R, S)),
               rng.normal(size=(R, S)) * 0.1, rng.uniform(size=(R, 3))]
    arrays = [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]
    arrays[0] *= 0.3
    modes = (("canonical", "softplus", True), ("canonical", "relu", False),
             ("reference", "softplus", False), ("reference", "softplus", True))
    for width in (128, 256):
        cfg = lego_hierarchical()
        m = dataclasses.replace(cfg.mlp, net_width=width)
        tm = create_nerf(cfg.replace(mlp=m, mlp_fine=m), device=dev)
        tm.init(torch.Generator().manual_seed(0))
        rb = ft.default_rays_block(S)
        for level in ("coarse", "fine"):
            mlp = getattr(tm, level)
            params = [p for _, lin in mlp.linears() for p in (lin.weight, lin.bias)]
            for mode, act, white in modes:
                spec = ft.TrainSpec(n_samples=S, rays_block=rb, mode=mode, density_activation=act,
                                    white_bkgd=white, group=ft.default_group(S, rb))
                sse = ft.fused_train_apply(mlp, tm.pos_enc, tm.dir_enc, spec, *arrays)[0]
                g_k = torch.autograd.grad(sse, params)
                sse = ft.fused_train_reference(mlp, tm.pos_enc, tm.dir_enc, spec, *arrays)[0]
                g_p = torch.autograd.grad(sse, params)
                mlp.double()
                sse = ft.fused_train_reference(mlp, tm.pos_enc, tm.dir_enc, spec,
                                               *(a.double() for a in arrays))[0]
                g_64 = torch.autograd.grad(sse, params)
                mlp.float()

                def worst(gs, ref):
                    return max(float((a.double() - b.double()).abs().max() / b.abs().max())
                               for a, b in zip(gs, ref))

                print(f"[f64] width {width} {level:6s} {mode:9s} {act:8s} white={int(white)}: "
                      f"dW vs float64: kernel {worst(g_k, g_64):.2e}, plain {worst(g_p, g_64):.2e}; "
                      f"kernel vs plain {worst(g_k, g_p):.2e}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("train_kernel_probe needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    jobs = dict(variant_sources(), mma_rate=RATE_SRC)
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip(jobs, ex.map(lambda kv: nvcc(*kv), jobs.items())))
    rate(built.pop("mma_rate"))
    times({name: train_lib(path) for name, path in built.items()})
    f64_errors()
    return 0


if __name__ == "__main__":
    sys.exit(main())
