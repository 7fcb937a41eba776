"""Where the sinusoidal eval kernel's time goes, on one card.

    python nerf_meets_mlx_torch/tools/eval_kernel_probe.py

``csrc/fused_eval.cu`` and variants of it built from its source text, each
timed with CUDA events at lego_hierarchical's render chunk (32,768 rays x
64 and x 192 samples, 8 x 256 MLPs), printed as ``[time]`` lines beside
the launch's 3xTF32 bound and the weight bytes it reads from L2; first, as
``[rate]``, the card's wgmma m64n256k8 TF32 rate from a kernel whose
warpgroups issue products on fixed register and shared-memory operands,
one group kept in flight, one and two warpgroups an SM; and, as ``[sass]``,
the tensor-core (HGMMA), bulk-copy (UBLKCP) and register-reallocation
(USETMAXREG) instructions of each width of the kernel's build, from
``cuobjdump -sass``. The variants:

* ``kernel``: as it is;
* ``no_copy``: the producer issues no bulk copy (it arrives on the stage's
  barrier without transactions), so the weights never leave L2: the
  launch without its L2 traffic;
* ``no_mma``: every wgmma removed (its operands kept live): the loads,
  splits, encodes, barriers, epilogues and compositing alone;
* ``one_pass``: hi * hi only, one TF32 product per MAC instead of three;
* ``no_setmaxnreg``: the consumers keep the 168 registers a thread of 384
  threads at entry (the producer's 40 are not handed over);
* ``in_flight``: one wgmma group kept in flight per warpgroup
  (``wait_group 1``, two A register sets, the finished group's stage
  released), and ``in_flight_240`` the same with the consumers at 240
  registers and the producer at 24;
* ``two_steps``: two k-steps (two stages) a wgmma group.

``no_copy``, ``no_mma`` and ``one_pass`` compute wrong results and only
time; the other variants compute the kernel's function, and
``[check]`` lines hold them to the plain version at the card's tolerance.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / ".runs" / "eval_kernel_probe"  # gitignored: the variants' sources and builds

COPY = """          mbar_arrive_expect_tx(&ring.full[ring.stage], 64 * n);
          bulk_copy_g2s(ring.buf + ring.stage * stage_floats(W), src, 64 * n,
                        &ring.full[ring.stage]);
"""
MMA = """  wgmma_tf32<N>(acc, al, dh, first ? 0 : 1);
  wgmma_tf32<N>(acc, ah, dl, 1);
  wgmma_tf32<N>(acc, ah, dh, 1);
"""
RATE_SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>
#include "tf32x3.cuh"
__global__ void __launch_bounds__(256, 1) wgmma_rate(float* out, int iters) {
  __shared__ __align__(128) float B[16 * 256];
  for (int i = threadIdx.x; i < 16 * 256; i += blockDim.x) B[i] = 1e-3f * (i & 255);
  __syncthreads();
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  float acc[128];
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  const uint64_t d = wgmma_desc(B, 16 * 256, 128);
  wgmma_fence();
  for (int it = 0; it < iters; ++it) {
    wgmma_tf32<256>(acc, a, d, 1);
    wgmma_tf32<256>(acc, a, d, 1);
    wgmma_tf32<256>(acc, a, d, 1);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs<128>(acc);
  float s = 0.f;
  for (int i = 0; i < 128; ++i) s += acc[i];
  if (s == 123.f) out[0] = s;  // keeps the products live
}
extern "C" int wgmma_rate_launch(float* out, int blocks, int threads, int iters, void* stream) {
  wgmma_rate<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""

STEP = "// One k-step of an N-column layer"
EPILOGUE = "// act(b + acc)"
REGS = "constexpr int CONS_REGS = 232, PROD_REGS = 40;"
SETMAXNREG = ("    regs_lower<PROD_REGS>();\n", "  regs_raise<CONS_REGS>();\n")
IN_FLIGHT = r"""// k-step s issued behind s - 1, which is then waited for and its stage
// (`held`) released
template <int N, int W, class Src>
__device__ __forceinline__ void mma_step(float* acc, Ring& ring, Src& src, int s,
                                         uint32_t (&ah)[4], uint32_t (&al)[4], int& held,
                                         int lane) {
  float a[4];
  src(s, a);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  const float* B = ring.buf + ring.stage * stage_floats(W);
  const uint64_t dh = wgmma_desc(B, 16 * N, 128), dl = wgmma_desc(B + 8 * N, 16 * N, 128);
  mbar_wait(&ring.full[ring.stage], ring.phase);
  __syncwarp();
  wgmma_fence();
  wgmma_tf32<N>(acc, al, dh, s == 0 ? 0 : 1);
  wgmma_tf32<N>(acc, ah, dl, 1);
  wgmma_tf32<N>(acc, ah, dh, 1);
  wgmma_commit();
  wgmma_wait<1>();
  if (held >= 0 && lane == 0) mbar_arrive(&ring.empty[held]);
  held = ring.stage;
  ring.advance();
}

template <int N, int W, class Src1, class Src2>
__device__ __forceinline__ void gemm(float* acc, Ring& ring, int n1, Src1 src1, int n2, Src2 src2,
                                     int lane) {
  auto src = [&](int s, float (&a)[4]) {
    if (s < n1) src1(s, a); else src2(s - n1, a);
  };
  uint32_t h0[4], l0[4], h1[4], l1[4];  // the A halves of two k-steps in flight
  int held = -1;
  const int n = n1 + n2;
  for (int s = 0; s < n; s += 2) {
    mma_step<N, W>(acc, ring, src, s, h0, l0, held, lane);
    if (s + 1 < n) mma_step<N, W>(acc, ring, src, s + 1, h1, l1, held, lane);
  }
  wgmma_wait<0>();
  fence_regs<N / 2>(acc);
  if (lane == 0) mbar_arrive(&ring.empty[held]);
}

"""
TWO_STEPS = r"""// two k-steps (two stages) a wgmma group
template <int N, int W, class Src1, class Src2>
__device__ __forceinline__ void gemm(float* acc, Ring& ring, int n1, Src1 src1, int n2, Src2 src2,
                                     int lane) {
  auto src = [&](int s, float (&a)[4]) {
    if (s < n1) src1(s, a); else src2(s - n1, a);
  };
  const int n = n1 + n2;
  for (int s = 0; s < n; s += 2) {
    const bool two = s + 1 < n;
    float a0[4], a1[4] = {0.f, 0.f, 0.f, 0.f};
    src(s, a0);
    if (two) src(s + 1, a1);
    uint32_t h0[4], l0[4], h1[4], l1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split_tf32(a0[i], h0[i], l0[i]);
      split_tf32(a1[i], h1[i], l1[i]);
    }
    const int st0 = ring.stage;
    const float* B0 = ring.buf + st0 * stage_floats(W);
    mbar_wait(&ring.full[st0], ring.phase);
    ring.advance();
    const int st1 = ring.stage;
    const float* B1 = ring.buf + st1 * stage_floats(W);
    if (two) {
      mbar_wait(&ring.full[st1], ring.phase);
      ring.advance();
    }
    __syncwarp();
    wgmma_fence();
    {
      const uint64_t dh = wgmma_desc(B0, 16 * N, 128), dl = wgmma_desc(B0 + 8 * N, 16 * N, 128);
      wgmma_tf32<N>(acc, l0, dh, s == 0 ? 0 : 1);
      wgmma_tf32<N>(acc, h0, dl, 1);
      wgmma_tf32<N>(acc, h0, dh, 1);
    }
    if (two) {
      const uint64_t dh = wgmma_desc(B1, 16 * N, 128), dl = wgmma_desc(B1 + 8 * N, 16 * N, 128);
      wgmma_tf32<N>(acc, l1, dh, 1);
      wgmma_tf32<N>(acc, h1, dl, 1);
      wgmma_tf32<N>(acc, h1, dh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<N / 2>(acc);
    if (lane == 0) {
      mbar_arrive(&ring.empty[st0]);
      if (two) mbar_arrive(&ring.empty[st1]);
    }
  }
}

"""
KEEP_LIVE = """  asm volatile("" ::"r"(ah[0]), "r"(ah[1]), "r"(ah[2]), "r"(ah[3]), "r"(al[0]), "r"(al[1]),
               "r"(al[2]), "r"(al[3]), "l"(dh), "l"(dl), "r"((int)first));
"""


def variant_sources() -> dict:
    """{name: source text} of the kernel and its timing variants, each with
    csrc/tf32x3.cuh written in place of its include."""
    csrc = ROOT / "nerf_meets_mlx_torch" / "csrc"
    src = (csrc / "fused_eval.cu").read_text().replace(
        '#include "tf32x3.cuh"', (csrc / "tf32x3.cuh").read_text())
    steps = src[src.index(STEP):src.index(EPILOGUE)]
    in_flight = src.replace(steps, IN_FLIGHT)
    out = {
        "kernel": src,
        "no_copy": src.replace(COPY, "          mbar_arrive(&ring.full[ring.stage]);\n"),
        "no_mma": src.replace(MMA, KEEP_LIVE),
        "one_pass": src.replace(MMA, "  wgmma_tf32<N>(acc, ah, dh, first ? 0 : 1);\n"),
        "no_setmaxnreg": src.replace(SETMAXNREG[0], "").replace(SETMAXNREG[1], ""),
        "in_flight": in_flight,
        "in_flight_240": in_flight.replace(REGS, "constexpr int CONS_REGS = 240, PROD_REGS = 24;"),
        "two_steps": src.replace(steps, TWO_STEPS),
    }
    for name, text in out.items():
        if name != "kernel" and text == src:
            raise RuntimeError(f"the {name} substitution no longer matches csrc/fused_eval.cu")
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
    for line in proc.stderr.splitlines():  # the ptxas report of each width
        if any(k in line for k in ("Compiling entry", "registers", "spill", "arning")):
            print(f"[build] {name}: {line.strip()}", flush=True)
    return lib


def sass(lib_path: Path):
    """The instruction counts of each kernel in the build's SASS."""
    from nerf_meets_mlx_torch.kernels import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"HGMMA": 0, "UBLKCP": 0, "USETMAXREG": 0, "FFMA": 0}
        elif name is not None:
            for op in counts[name]:
                if f" {op}" in line:
                    counts[name][op] += 1
    for name, c in counts.items():
        print(f"[sass] {name}: " + ", ".join(f"{k} {v}" for k, v in c.items()), flush=True)
    print("[sass] shapes: " + ", ".join(sorted({"HGMMA." + w.split()[0] for w in text.split("HGMMA.")[1:]})), flush=True)


def rate(lib_path: Path):
    import torch

    from chip_smoke import cuda_time_ms

    lib = ctypes.CDLL(str(lib_path))
    lib.wgmma_rate_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 2048
    for threads in (128, 256):
        def run():
            if lib.wgmma_rate_launch(out.data_ptr(), sms, threads, iters, stream) != 0:
                raise RuntimeError("wgmma_rate launch failed")

        ms = cuda_time_ms(run, 3)
        flop = sms * threads // 128 * iters * 3 * 2 * 64 * 256 * 8
        print(f"[rate] wgmma m64n256k8 tf32, {sms} blocks x {threads} threads: {ms:.3f} ms, "
              f"{flop / ms / 1e9:.1f} TFLOP/s", flush=True)


EXACT = ("kernel", "no_setmaxnreg", "in_flight", "in_flight_240", "two_steps")


def _model(dev):
    import torch

    from nerf_meets_mlx_torch.config import lego_hierarchical
    from nerf_meets_mlx_torch.models import create_nerf

    model = create_nerf(lego_hierarchical().replace(use_fused_kernel=True), device=dev)
    return model.init(torch.Generator(device=dev).manual_seed(0))


def check(libs: dict):
    """Each variant in ``libs`` against the plain version at 4096 rays of
    both levels, canonical and reference compositing, values within the
    card's tolerance (chip_smoke.py's ATOL + RTOL)."""
    import torch

    from chip_smoke import ATOL, RTOL
    from nerf_meets_mlx_torch.kernels import fused_train as ft
    from nerf_meets_mlx_torch.tools.train_kernel_probe import lego_levels

    dev = torch.device("cuda")
    model = _model(dev)
    (ro, rd, vd), _, levels = lego_levels(dev)
    own = ft._kernel_lib
    try:
        for name, lib in libs.items():
            ft._kernel_lib = lambda width, lib=lib: lib
            for z, dl, _ in levels:
                for mode in ("canonical", "reference"):
                    S = z.shape[1]
                    spec = ft.TrainSpec(n_samples=S, rays_block=ft.eval_block(S), mode=mode,
                                        density_activation="softplus", white_bkgd=True)
                    args = (model.fine, model.pos_enc, model.dir_enc, spec, ro, rd, vd, z, dl)
                    with torch.no_grad():
                        got = ft.fused_eval_apply(*args)
                        want = ft.fused_eval_reference(*args)
                    ok = all(bool(((g - w).abs() <= ATOL + RTOL * w.abs()).all())
                             for g, w in zip(got, want))
                    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                    print(f"[check] {name:13s} S={S} {mode:9s}: max abs {err:.3e} "
                          f"{'ok' if ok else 'FAIL'}", flush=True)
    finally:
        ft._kernel_lib = own


def times(libs: dict):
    import torch

    from chip_smoke import TF32_FLOPS, cuda_time_ms, mlp_macs
    from nerf_meets_mlx_torch.kernels import fused_train as ft
    from nerf_meets_mlx_torch.tools.train_kernel_probe import lego_levels

    dev = torch.device("cuda")
    model = _model(dev)
    (ro, rd, vd), _, levels = lego_levels(dev, n_rays=32768)
    img = ft.pack_eval_wgmma(model.fine, model.pos_enc, model.dir_enc)
    own = ft._kernel_lib
    try:
        for name, lib in libs.items():
            ft._kernel_lib = lambda width, lib=lib: lib
            for level, (z, dl, _) in zip(("coarse", "fine"), levels):
                R, S = z.shape
                spec = ft.TrainSpec(n_samples=S, rays_block=ft.eval_block(S), mode="canonical",
                                    density_activation="softplus", white_bkgd=True)
                args = (model.fine, model.pos_enc, model.dir_enc, spec, ro, rd, vd, z, dl)
                with torch.no_grad():
                    ms = cuda_time_ms(lambda args=args: ft.fused_eval_apply(*args), 5)
                flops = 2.0 * mlp_macs(model.fine.cfg, model.pos_enc.out_dim,
                                       model.dir_enc.out_dim) * R * S
                tiles = -(-R // spec.rays_block) * -(-spec.rays_block * S // 128)
                l2 = 4.0 * img.numel() * tiles
                print(f"[time] {name:8s} {level:6s} {R} x {S}: {ms:.3f} ms; 3xTF32 bound "
                      f"{3 * flops / TF32_FLOPS * 1e3:.3f} ms ({3 * flops / (ms * 1e9):.1f} "
                      f"TFLOP/s); weights from L2 {l2 / 1e9:.1f} GB ({l2 / (ms * 1e9):.2f} TB/s)",
                      flush=True)
    finally:
        ft._kernel_lib = own


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("eval_kernel_probe needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    from nerf_meets_mlx_torch.kernels import fused_train as ft

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    header = (ROOT / "nerf_meets_mlx_torch" / "csrc" / "tf32x3.cuh").read_text()
    jobs = dict(variant_sources(), wgmma_rate=RATE_SRC.replace('#include "tf32x3.cuh"', header))
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip(jobs, ex.map(lambda kv: nvcc(*kv), jobs.items())))
    rate(built.pop("wgmma_rate"))
    sass(built["kernel"])
    libs = {name: ft.type_eval_lib(ctypes.CDLL(str(path))) for name, path in built.items()}
    check({name: libs[name] for name in EXACT})
    times(dict(libs, kernel_again=libs["kernel"]))  # a drift of the card shows as the two apart
    return 0


if __name__ == "__main__":
    sys.exit(main())
