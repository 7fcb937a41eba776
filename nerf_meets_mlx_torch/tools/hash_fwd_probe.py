"""Probes the hash forward (``csrc/hash_encode.cu``'s ``hash_fwd_kernel``) on one card.

    python nerf_meets_mlx_torch/tools/hash_fwd_probe.py [--base <parent checkout>] [--no-head]

At lego_ingp's tables (8 levels of 2^14 x 2, N(0, 0.1)) and at the seven
batches the main paths give the forward: the grid update's 262,144 cell
points (one jittered point a cell of the 64^3 grid, in cell order),
lego_ingp's train batches (4096 rays x 48 / 96 samples), the long-ray
route's (4096 x 128 / 384) and the long-ray frame's chunks (32,768 rays x
128 / 384, the middle chunk of a 400 x 400 orbit frame, as render_image
chunks it). The train batches' rays are 4096 random pixels of that frame;
every batch but the grid's is in ray order, depths sorted uniform in [2,
6], some points outside the box. At 2^14 x 4 (a level of 256 KB) and in
bf16 at lego_ingp's tables it takes the long-ray batches. For each build
it checks the features against the plain version (``hash_encode_reference``:
equal, atol 0) and times the call's device time (torch.profiler: every
kernel it launches) and its CUDA-event time, in turns (each build in order,
then in reverse):

* ``this``: this checkout's kernel;
* each form in ``FORMS`` (this checkout's source with the forward kernel
  and its launcher replaced), the forms the redesign weighed: ``level_smem``,
  form (a), a block one level over a range of points, its table staged in
  shared memory, blocks ordered so that a range's levels run together,
  each thread a point, its F features stored straight into feats;
  ``level_l1``, the same gathering through L1 (no staging); ``tile``, form
  (b), a block a tile of 128 points at every level, its warps taking
  levels, the rows gathered in shared memory and copied out whole, a
  barrier between the phases;
* each edit in ``EDITS`` (variants of this checkout's kernel);
* ``base``: with ``--base``, the base checkout's kernel.

It prints each build's ptxas report of the forward kernels and the memory
instructions of their SASS (``[ptxas]``), the card's name and power
limit, and last one JSON object of every time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HEAD = Path(__file__).resolve().parents[2]
OUT = HEAD / ".runs" / "hash_fwd_probe"
# (name, rays, samples); "grid": the 64^3 cell points
BATCHES = (("grid", 0, 0), ("coarse", 4096, 48), ("fine", 4096, 96), ("long_coarse", 4096, 128),
           ("long_fine", 4096, 384), ("frame_coarse", 32768, 128), ("frame_fine", 32768, 384))
FRAME_RES = 400

# form (a): a block works one level over a range of points (ranges x L
# blocks, block b: level b % L, range b / L, as bwd_plan orders the dG
# blocks), the level's table staged in shared memory with 16-byte loads
# where SMEM_TABLE says so and it fits; a thread a point at a time, its F
# features stored straight into feats [N, L*F]
LEVEL_FORM = r'''constexpr int LEVEL_THREADS = 1024;

template <int F, int MAP>
__global__ void __launch_bounds__(LEVEL_THREADS) hash_fwd_level_kernel(
    const __grid_constant__ HashArgs A, long long block_points, int staged) {
  extern __shared__ float4 level_table[];
  const int l = (int)(blockIdx.x % (unsigned)A.L);
  const long long n0 = (long long)(blockIdx.x / (unsigned)A.L) * block_points;
  if (n0 >= A.N) return;
  const long long n1 = n0 + block_points < A.N ? n0 + block_points : A.N;
  const float* tl = A.tables + (size_t)l * A.T * F;
  if (staged) {
    const float4* src = reinterpret_cast<const float4*>(tl);
    const int n4 = (int)(A.T * F / 4);
    for (int i = threadIdx.x; i < n4; i += LEVEL_THREADS) level_table[i] = __ldg(src + i);
    __syncthreads();
  }
  const float r = (float)A.res[l];
  for (long long n = n0 + threadIdx.x; n < n1; n += LEVEL_THREADS) {
    unsigned b[3];
    float f[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float u = unit_of<MAP>(A, __ldg(A.x + n * 3 + a));
      u = fminf(fmaxf(u, 0.f), 1.f);
      const float s = __fmul_rn(u, r);
      const float fl = floorf(s);
      b[a] = (unsigned)fl;
      f[a] = __fsub_rn(s, fl);
    }
    float acc[F];
#pragma unroll
    for (int k = 0; k < F; ++k) acc[k] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const unsigned h = corner_row(A, b, c);
      const float w = corner_weight(f, c);
      float g[F];
      if (staged) {
        if constexpr (F >= 4) {
#pragma unroll
          for (int q = 0; q < F / 4; ++q) {
            const float4 a0 = level_table[h * (F / 4) + q];
            g[4 * q] = a0.x; g[4 * q + 1] = a0.y; g[4 * q + 2] = a0.z; g[4 * q + 3] = a0.w;
          }
        } else if constexpr (F == 2) {
          const float2 a0 = reinterpret_cast<const float2*>(level_table)[h];
          g[0] = a0.x; g[1] = a0.y;
        } else {
          g[0] = reinterpret_cast<const float*>(level_table)[h];
        }
      } else {
        load_row<F>(tl + (size_t)h * F, g);
      }
      if (MAP != DX && A.bf16) {
        const float wb = rb(w, 1);
#pragma unroll
        for (int k = 0; k < F; ++k) acc[k] = __fadd_rn(acc[k], rb(__fmul_rn(rb(g[k], 1), wb), 1));
      } else {
#pragma unroll
        for (int k = 0; k < F; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(g[k], w));
      }
    }
    float* o = A.out + (size_t)n * A.L * F + (size_t)l * F;
#pragma unroll
    for (int k = 0; k < F; ++k) o[k] = acc[k];
  }
}

template <int F, int MAP>
int launch_level_f(const HashArgs& a, cudaStream_t st) {
  int dev = 0, optin = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  // bwd_plan's ranges: the SMs shared by the levels, 4096 points a range at least
  const long long want = (a.N + 4095) / 4096, even = n_sm / a.L > 1 ? n_sm / a.L : 1;
  const long long ranges = want < even ? (want > 1 ? want : 1) : even;
  const long long block_points = (a.N + ranges - 1) / ranges;
  const size_t bytes = (size_t)a.T * F * sizeof(float);
  const int staged = SMEM_TABLE && bytes <= (size_t)optin;
  const size_t smem = staged ? bytes : 0;
  const cudaError_t e = cudaFuncSetAttribute(
      hash_fwd_level_kernel<F, MAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  hash_fwd_level_kernel<F, MAP><<<(unsigned)(ranges * a.L), LEVEL_THREADS, smem, st>>>(
      a, block_points, staged);
  return (int)cudaGetLastError();
}

template <int MAP>
int launch_level(const HashArgs& a, cudaStream_t st) {
  switch (a.F) {
    case 1: return launch_level_f<1, MAP>(a, st);
    case 2: return launch_level_f<2, MAP>(a, st);
    case 4: return launch_level_f<4, MAP>(a, st);
    default: return launch_level_f<8, MAP>(a, st);
  }
}

int launch_fwd(const HashArgs& a, bool dx, cudaStream_t st) {
  return dx ? launch_level<DX>(a, st) : launch_level<BODY>(a, st);
}
'''

# form (b): a block walks tiles of TILE consecutive points (blocks: 6 an
# SM); per tile it loads x coalesced and normalises each coordinate once
# into shared memory, then its warps take (level, 32 points) items, each
# lane's F sums written into the tile's rows in shared memory (an odd row
# stride), then the block copies the rows, contiguous in feats, with
# 16-byte stores; a barrier between the phases
TILE_FORM = r'''constexpr int TILE_THREADS = 256, TILE_WARPS = 8, TILE = 128;

template <int F, int MAP>
__global__ void __launch_bounds__(TILE_THREADS, 6) hash_fwd_tile_kernel(
    const __grid_constant__ HashArgs A, int stride, unsigned long long magic) {
  extern __shared__ float tile_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = A.L, LF = L * F;
  float* us = tile_smem;
  float* rows = tile_smem + TILE * 3;
  const long long tiles = (A.N + TILE - 1) / TILE;
  const int groups = TILE / 32;
  const int l0 = warp % L, g0 = warp / L, gstep = TILE_WARPS / L, lstep = TILE_WARPS % L;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long n0 = t * TILE;
    const int np = A.N - n0 < TILE ? (int)(A.N - n0) : TILE;
    for (int i = threadIdx.x; i < np * 3; i += TILE_THREADS) {
      const float u = unit_of<MAP>(A, __ldg(A.x + n0 * 3 + i));
      us[i] = fminf(fmaxf(u, 0.f), 1.f);
    }
    __syncthreads();
    for (int l = l0, g = g0; g < groups;) {
      const int p = g * 32 + lane;
      if (p < np) {
        const float u[3] = {us[p * 3], us[p * 3 + 1], us[p * 3 + 2]};
        float acc[F];
        level_features<F, MAP>(A, u, l, A.tables + (size_t)l * A.T * F, acc);
#pragma unroll
        for (int k = 0; k < F; ++k) rows[p * stride + l * F + k] = acc[k];
      }
      l += lstep;
      g += gstep;
      if (l >= L) {
        l -= L;
        ++g;
      }
    }
    __syncthreads();
    float* dst = A.out + n0 * LF;
    const int total = np * LF, quads = total / 4;
    for (int q = threadIdx.x; q < quads; q += TILE_THREADS) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned e = 4 * q + j, pt = (unsigned)((e * magic) >> 32);
        v[j] = rows[pt * stride + (e - pt * LF)];
      }
      reinterpret_cast<float4*>(dst)[q] = make_float4(v[0], v[1], v[2], v[3]);
    }
    for (int e = 4 * quads + threadIdx.x; e < total; e += TILE_THREADS) {
      const unsigned pt = (unsigned)((e * magic) >> 32);
      dst[e] = rows[pt * stride + (e - pt * LF)];
    }
  }
}

template <int F, int MAP>
int launch_tile_f(const HashArgs& a, cudaStream_t st) {
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int LF = a.L * F, stride = LF | 1;
  const long long tiles = (a.N + TILE - 1) / TILE;
  const unsigned blocks = (unsigned)(tiles < 6LL * n_sm ? tiles : 6LL * n_sm);
  const size_t smem = (size_t)TILE * (3 + stride) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      hash_fwd_tile_kernel<F, MAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  hash_fwd_tile_kernel<F, MAP><<<blocks, TILE_THREADS, smem, st>>>(
      a, stride, (0x100000000ULL + LF - 1) / LF);
  return (int)cudaGetLastError();
}

template <int MAP>
int launch_tile(const HashArgs& a, cudaStream_t st) {
  switch (a.F) {
    case 1: return launch_tile_f<1, MAP>(a, st);
    case 2: return launch_tile_f<2, MAP>(a, st);
    case 4: return launch_tile_f<4, MAP>(a, st);
    default: return launch_tile_f<8, MAP>(a, st);
  }
}

int launch_fwd(const HashArgs& a, bool dx, cudaStream_t st) {
  return dx ? launch_tile<DX>(a, st) : a.bf16 ? launch_tile<BF16>(a, st) : launch_tile<BODY>(a, st);
}
'''

# forms that replace this checkout's forward launcher (from FORM_START to
# FORM_END; form (b) keeps this checkout's level_features), built with their
# -D defines
FORMS = {
    "level_smem": (LEVEL_FORM, ("-DSMEM_TABLE=1",)),
    "level_l1": (LEVEL_FORM, ("-DSMEM_TABLE=0",)),
    "tile": (TILE_FORM, ()),
}
FORM_START = ("template <int F, int MAP>\n"
              "__global__ void __launch_bounds__(FWD_THREADS, FWD_MIN_BLOCKS)")
FORM_END = "// ---- end of the forward"

# edits of this checkout's source, each built as a variant of its own;
# the TIMING_ONLY ones give wrong features and are timed, not checked
EDITS = {
    # 6 blocks an SM in __launch_bounds__ (40 registers; this checkout's: 8,
    # 32 registers)
    "min_blocks6": [("constexpr int FWD_MIN_BLOCKS = 8;", "constexpr int FWD_MIN_BLOCKS = 6;")],
    # a level's F floats stored at a time (no 32-byte chunks of a row)
    "level_stores": [("  constexpr int K = FWD_CHUNK / F;  // levels a chunk",
                      "  constexpr int K = 1;"),
                     ("  if ((L * F) % 4 == 0 && l0 + K <= L) {", "  if (false) {"),
                     ("  const int K = FWD_CHUNK / a.F;", "  const int K = 1;")],
    # every gather within one 32-byte sector of its level
    "rows_sector": [("    table_row<F>(tl, corner_row(A, b, c), g);",
                     "    table_row<F>(tl, corner_row(A, b, c) & 3u, g);")],
}
TIMING_ONLY = ("rows_sector",)


def _form_source(src: str, form: str) -> str:
    start, end = src.index(FORM_START), src.index(FORM_END)
    return src[:start] + form + src[end:]


def _build(tag: str, cu: Path, csrc: Path, defines=()):
    """(tag, library, ptxas lines of the forward kernels)."""
    from nerf_meets_mlx_torch.kernels import _build as b

    lib = OUT / f"lib{tag}.so"
    proc = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, *defines, "-I", str(csrc), "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr[-4000:]}")
    lines = proc.stderr.splitlines()
    ptxas = []
    for i, line in enumerate(lines):
        found = re.search(r"Compiling entry function '(\S*hash_fwd\S*)'", line)
        if found:
            rep = [x.strip() for x in lines[i + 1:i + 4]
                   if "registers" in x or "spill" in x or "smem" in x]
            ptxas.append(f"{found.group(1)}: {' | '.join(rep)}")
    # the memory instructions of each forward kernel's SASS
    cuobjdump = Path(b._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name, rest = body.split("\n", 1)
        if re.search(r"hash_fwd\w*kernel", name):
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s*(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", rest)
            counts = {op: ops.count(op) for op in ("LDG", "STG", "LDL", "STL", "LDS", "STS", "BAR")}
            ptxas.append(f"{name.strip()}: SASS {len(ops)} instructions, "
                         + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    return tag, ctypes.CDLL(str(lib)), ptxas


def _type(lib):
    vp, ci, cll, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.hash_fwd_launch.argtypes = [vp] * 3 + [cll] + [ci] * 3 + [vp, cf, cf, ci, vp]
    lib.hash_fwd_launch.restype = ci


def _device_ms(fn, n):
    """Device ms a call of everything ``fn`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            us += float(getattr(e, "self_cuda_time_total", 0.0) if t is None else t)
    return us / 1e3 / n


def _event_ms(fn, n):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--base", help="the parent checkout's root (its kernel timed beside)")
    p.add_argument("--no-head", action="store_true",
                   help="time the base checkout's kernel alone (with --base)")
    a = p.parse_args()
    sys.path.insert(0, str(HEAD))
    import numpy as np
    import torch

    from nerf_meets_mlx_torch.acceleration.occupancy import _cell_points
    from nerf_meets_mlx_torch.cameras.pose import orbit_poses
    from nerf_meets_mlx_torch.cameras.rays import get_rays
    from nerf_meets_mlx_torch.datasets.synthetic import CAMERA_ANGLE_X
    from nerf_meets_mlx_torch.encoding.hash_grid import HashGridEncoding
    from nerf_meets_mlx_torch.kernels import _build as b
    from nerf_meets_mlx_torch.kernels import hash_encode as he

    if not torch.cuda.is_available():
        print("no CUDA device: the probe times the kernels on the card", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    if not a.no_head:
        src = (b.CSRC / "hash_encode.cu").read_text()
        jobs.append(("this", b.CSRC / "hash_encode.cu", b.CSRC, ()))
        for tag, (form, defines) in FORMS.items():
            (OUT / f"{tag}.cu").write_text(_form_source(src, form))
            jobs.append((tag, OUT / f"{tag}.cu", b.CSRC, defines))
        for tag, edits in EDITS.items():
            edited = src
            for old, new in edits:
                if edited.count(old) != 1:
                    raise RuntimeError(f"{tag}: the source does not hold {old!r} once")
                edited = edited.replace(old, new)
            (OUT / f"{tag}.cu").write_text(edited)
            jobs.append((tag, OUT / f"{tag}.cu", b.CSRC, ()))
    if a.base:
        base_csrc = Path(a.base).resolve() / "nerf_meets_mlx_torch" / "csrc"
        jobs.append(("base", base_csrc / "hash_encode.cu", base_csrc, ()))
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = [f.result() for f in [ex.submit(_build, *j) for j in jobs]]
    libs = {}
    for tag, lib, ptxas in built:
        _type(lib)
        libs[tag] = lib
        for line in ptxas:
            print(f"[ptxas] {tag} {line}", flush=True)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    focal = 0.5 * FRAME_RES / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, FRAME_RES / 2], [0, focal, FRAME_RES / 2], [0, 0, 1]], np.float32)
    ro, rd = get_rays(FRAME_RES, FRAME_RES, K, orbit_poses(160)[0][:3, :4], device=dev)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    pick = torch.randperm(FRAME_RES * FRAME_RES, generator=g, device=dev)[:4096]
    chunk = slice(2 * 32768, 3 * 32768)  # the frame's middle chunk

    def points(name, R, S):
        if name == "grid":
            return _cell_points(64, torch.full((3,), -1.5, device=dev),
                                torch.full((3,), 1.5, device=dev), generator=g)
        o, d = (ro[chunk], rd[chunk]) if R == 32768 else (ro[pick], rd[pick])
        z = torch.sort(torch.rand((R, S), generator=g, device=dev) * 4.0 + 2.0, -1).values
        return (o[:, None] + z[..., None] * d[:, None]).reshape(-1, 3).contiguous()

    def encoding(F, log2_t, dtype):
        enc = HashGridEncoding(n_levels=8, min_res=16, max_res=256, features_per_level=F,
                               log2_table_size=log2_t, compute_dtype=dtype, device=dev)
        enc.init(torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            enc.tables.add_(torch.randn(enc.tables.shape, generator=g, device=dev) * 0.1)
        return enc

    def launch(lib, tag, enc, x, feats):
        L, F, log2_t, c_res, bmin, brange, bf16 = he._geometry(enc)
        err = lib.hash_fwd_launch(x.data_ptr(), enc.tables.data_ptr(), feats.data_ptr(),
                                  x.shape[0], L, F, log2_t, c_res, bmin, brange, bf16,
                                  torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{tag}: cudaError {err}")

    out, ok = {}, True
    shapes = [("lego_ingp", 2, 14, "float32", [n for n, _, _ in BATCHES]),
              ("F4", 4, 14, "float32", ["long_coarse", "long_fine", "frame_fine"]),
              ("bf16", 2, 14, "bfloat16", ["long_coarse", "long_fine"])]
    for shape, F, log2_t, dtype, names in shapes:
        enc = encoding(F, log2_t, dtype)
        runs = list(libs.items())
        for name, R, S in BATCHES:
            if name not in names:
                continue
            x = points(name, R, S)
            N = x.shape[0]
            with torch.no_grad():
                want = he.hash_encode_reference(enc, x)
            feats = torch.empty((N, enc.out_dim), device=dev)
            for tag, lib in runs:
                feats.fill_(float("nan"))
                launch(lib, tag, enc, x, feats)
                torch.cuda.synchronize()
                if tag in TIMING_ONLY:
                    continue
                good = bool(torch.equal(feats, want))
                ok &= good
                print(f"[check] {shape} {name} N={N} {tag}: max|feats-plain| "
                      f"{float((feats - want).abs().max()):.3e}: {'ok' if good else 'FAIL'}",
                      flush=True)
            reps = max(10, int(20_000_000 // N))
            dev_t, ev_t = {t: [] for t, _ in runs}, {t: [] for t, _ in runs}
            for tag, lib in runs + list(reversed(runs)):
                fn = (lambda tag=tag, lib=lib: launch(lib, tag, enc, x, feats))
                dev_t[tag].append(_device_ms(fn, reps))
                ev_t[tag].append(_event_ms(fn, reps))
            # bytes it must move: x in, feats out, the tables once
            nbytes = 4 * (3 * N + enc.out_dim * N) + 4 * enc.tables.numel()
            bound = nbytes / 3.35e12 * 1e3
            for tag in dev_t:
                out[f"{shape}_{name}_{tag}"] = {"device": dev_t[tag], "events": ev_t[tag]}
            out[f"{shape}_{name}_bound"] = bound
            del x, want, feats
    print(f"[probe] all checks {'ok' if ok else 'FAILED'}", flush=True)
    print(json.dumps({"card": smi, "ms": out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
