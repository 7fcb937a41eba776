"""Probes the hash table gradient (``csrc/hash_encode.cu``'s ``hash_bwd_kernel``) on one card.

    python nerf_meets_mlx_torch/tools/hash_bwd_probe.py [--base <parent checkout>]

On ray-ordered points (4096 rays of a 400 x 400 orbit frame, depths sorted
uniform in [2, 6]) at the four batches the training routes give the kernel
(4096 x 48 / 96, lego_ingp's value_and_grad route; 4096 x 128 / 384, the
long-ray feats route), with a random dout, at lego_ingp's tables (8 levels
of 2^14 x 2), at 2^10 x 2 and at 2^14 x 4, it builds, checks against the
plain version (max |dG - plain| within 1e-4 of max |plain|, as
chip_smoke.py holds it; every entry no point touches exactly 0) and times
with CUDA events in turns (each in order, then in reverse):

* ``this``: this checkout's kernel (a thread's stretch of points in order,
  runs of one cell summed in registers and slid to face neighbours,
  vector atomics into dG);
* ``no_slide``: the same with every run flushed whole (``EDITS``);
* ``shared``: the runs added into a shared-memory copy of the level's dG
  slice with shared float atomics, then the slice into dG (``EDITS``;
  2 features);
* ``warp``: ``WARP_FORM``, 32 consecutive points a warp step, a segmented
  shuffle sum over the lanes in one cell, the segment's first lane adding
  it (this checkout's source with ``merge_runs`` replaced);
* ``no_flush``: without the flushes (timing only: its dG is wrong);
* ``base``: with ``--base``, the base checkout's kernel;

and at lego_ingp's tables also this checkout's kernel at 8, 16 and 32
ranges a level (fine and long-ray fine batches) and one level at a time
(``L = 1`` launches on the level's dout columns, long-ray fine). It prints
each build's ptxas report and the atomics in each ``hash_bwd_kernel``'s
SASS (``[sass]``: ``ATOMS`` shared, ``REDG`` global), the card's name and
power limit, and last one JSON object of every time.
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
OUT = HEAD / ".runs" / "hash_bwd_probe"
BATCHES = (("coarse", 48), ("fine", 96), ("long_coarse", 128), ("long_fine", 384))
RAYS = 4096

# merge_runs as a warp's segmented sum: 32 consecutive points a warp step,
# a segment of lanes in one cell summed by shuffles into its first lane
WARP_FORM = r'''template <int F>
__device__ __forceinline__ void merge_runs(const HashArgs& A, int l, long long n0, long long n1,
                                           float* gl, float*) {
  constexpr int WARPS = BWD_THREADS / 32;
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long per = ((n1 - n0 + WARPS - 1) / WARPS + 31) / 32 * 32;
  const long long w0 = n0 + warp * per;
  const long long w1 = w0 + per < n1 ? w0 + per : n1;
  for (long long base = w0; base < w1; base += 32) {
    const long long n = base + lane;
    float d[F];
    unsigned b[3] = {~0u, ~0u, ~0u};
    float f[3] = {0.f, 0.f, 0.f};
    bool live = false;
    if (n < w1) {
      load_row<F>(A.dout + (size_t)n * A.L * F + (size_t)l * F, d);
#pragma unroll
      for (int k = 0; k < F; ++k) {
        d[k] = rb(d[k], A.bf16);
        live |= d[k] != 0.f;
      }
    }
    if (live) {
      const float p[3] = {__ldg(A.x + n * 3), __ldg(A.x + n * 3 + 1), __ldg(A.x + n * 3 + 2)};
      cell_of(A, p, l, b, f);
    } else {
#pragma unroll
      for (int k = 0; k < F; ++k) d[k] = 0.f;
    }
    const unsigned q0 = __shfl_up_sync(FULL, b[0], 1), q1 = __shfl_up_sync(FULL, b[1], 1),
                   q2 = __shfl_up_sync(FULL, b[2], 1);
    const bool head = lane == 0 || b[0] != q0 || b[1] != q1 || b[2] != q2;
    const unsigned after = __ballot_sync(FULL, head) & ~((2u << lane) - 1u);
    const int end = after ? __ffs(after) - 1 : 32;
    const bool flush = head && live;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float w = live ? rb(corner_weight(f, c), A.bf16) : 0.f;
      float v[F];
#pragma unroll
      for (int k = 0; k < F; ++k) v[k] = __fmul_rn(w, d[k]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int k = 0; k < F; ++k) {
          const float o = __shfl_down_sync(FULL, v[k], off);
          if (lane + off < end) v[k] = __fadd_rn(v[k], o);
        }
      }
      if (flush) add_row<F>(gl, corner_row(A, b, c), v);
    }
  }
}
'''


# edits of this checkout's source, each built as a variant of its own
EDITS = {
    # every run flushed whole (no slide to a face neighbour)
    "no_slide": [
        ("  const int d0 = (int)(b[0] - cur[0]), d1 = (int)(b[1] - cur[1]), d2 = (int)(b[2] - cur[2]);",
         "  const int d0 = 9, d1 = 9, d2 = 9;"),
    ],
    # the shared-memory form: the runs added with shared float atomics (a
    # compare-and-swap loop each on sm_90, ATOMS.CAST.SPIN) into a copy of the
    # level's dG slice after the staging rows, which the block then adds to
    # dG, a float2 atomic a row that holds a non-zero value (F = 2 only)
    "shared": [
        ("  float* p = gl + (size_t)row * F;\n  if constexpr (F == 1) {",
         "  float* p = gl + (size_t)row * F;\n  if constexpr (true) {\n"
         "    for (int k = 0; k < F; ++k) atomicAdd(p + k, v[k]);\n"
         "  } else if constexpr (F == 1) {"),
        ("  merge_runs<F>(A, l, n0, n1, A.out + (size_t)l * A.T * F, stage);\n}",
         """  const size_t TF = (size_t)A.T * F;
  float* slice = stage + stage_bytes(F) / sizeof(float);
  for (size_t i = threadIdx.x; i < TF; i += BWD_THREADS) slice[i] = 0.f;
  __syncthreads();
  merge_runs<F>(A, l, n0, n1, slice, stage);
  __syncthreads();
  float* gl = A.out + (size_t)l * TF;
  for (size_t r = threadIdx.x; r < (size_t)A.T; r += BWD_THREADS) {
    const float v0 = slice[r * F], v1 = slice[r * F + F - 1];
    if (v0 != 0.f || v1 != 0.f) atomicAdd(reinterpret_cast<float2*>(gl + r * F), make_float2(v0, v1));
  }
}"""),
        ("cudaFuncAttributeMaxDynamicSharedMemorySize, (int)stage_bytes(F));",
         "cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
         "      (int)(stage_bytes(F) + (size_t)P.A.T * F * 4));"),
        ("BWD_THREADS, stage_bytes(F), st>>>(P);",
         "BWD_THREADS, stage_bytes(F) + (size_t)P.A.T * F * 4, st>>>(P);"),
    ],
    # timing only (wrong results, not checked): without the flushes
    "no_flush": [
        ("  if (open) flush_run<F>(A, cur, acc, gl);\n}",
         "  if (open && acc[0][0] == 1234.5f) flush_run<F>(A, cur, acc, gl);\n}"),
        ("        open = next_cell<F>(A, cur, b, acc, gl);",
         "        open = acc[0][0] == 1234.5f && next_cell<F>(A, cur, b, acc, gl);"),
    ],
}
TIMING_ONLY = ("no_flush",)


def _warp_source(src: str) -> str:
    """This checkout's source with ``merge_runs`` replaced by ``WARP_FORM``."""
    start = src.index("template <int F>\n__device__ __forceinline__ void merge_runs(")
    end = src.index("\n}\n", start) + 3
    return src[:start] + WARP_FORM + src[end:]


def _build(tag: str, cu: Path, csrc: Path):
    """(tag, library, ptxas lines of the backward kernels, SASS atomics)."""
    from nerf_meets_mlx_torch.kernels import _build as b

    lib = OUT / f"lib{tag}.so"
    proc = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr[-4000:]}")
    lines = proc.stderr.splitlines()
    ptxas = []
    for i, line in enumerate(lines):
        found = re.search(r"Compiling entry function '(\S*hash_bwd_kernel\S*)'", line)
        if found:
            rep = [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
            ptxas.append(f"{found.group(1)}: {' | '.join(rep)}")
    cuobjdump = Path(b._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    atomics = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name, rest = body.split("\n", 1)
        found = re.search(r"hash_bwd_kernelILi\d+E(Li\d+E)?", name)
        if found:
            ops = re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]*)", rest)
            atomics[found.group(0)] = {op: ops.count(op) for op in sorted(set(ops))}
    return tag, ctypes.CDLL(str(lib)), ptxas, atomics


def _type(lib, planned: bool):
    vp, ci, cll, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.hash_bwd_launch.argtypes = ([vp] * 3 + [cll] + [ci] * 3 + [vp, cf, cf, ci]
                                    + ([ci, cll] if planned else []) + [vp])
    lib.hash_bwd_launch.restype = ci


def _ms(fn, n):
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
    a = p.parse_args()
    sys.path.insert(0, str(HEAD))
    import numpy as np
    import torch

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
    src = (b.CSRC / "hash_encode.cu").read_text()
    (OUT / "warp.cu").write_text(_warp_source(src))
    jobs = [("this", b.CSRC / "hash_encode.cu", b.CSRC), ("warp", OUT / "warp.cu", b.CSRC)]
    for tag, edits in EDITS.items():
        edited = src
        for old, new in edits:
            if edited.count(old) != 1:
                raise RuntimeError(f"{tag}: the source does not hold {old!r} once")
            edited = edited.replace(old, new)
        (OUT / f"{tag}.cu").write_text(edited)
        jobs.append((tag, OUT / f"{tag}.cu", b.CSRC))
    if a.base:
        base_csrc = Path(a.base).resolve() / "nerf_meets_mlx_torch" / "csrc"
        jobs.append(("base", base_csrc / "hash_encode.cu", base_csrc))
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = [f.result() for f in [ex.submit(_build, *j) for j in jobs]]
    libs = {}
    for tag, lib, ptxas, atomics in built:
        _type(lib, tag != "base")
        libs[tag] = lib
        for line in ptxas:
            print(f"[ptxas] {tag} {line}", flush=True)
        for k, ops in sorted(atomics.items()):
            print(f"[sass] {tag} {k}: {ops}", flush=True)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    focal = 0.5 * 400 / np.tan(0.5 * CAMERA_ANGLE_X)
    K = np.array([[focal, 0, 200], [0, focal, 200], [0, 0, 1]], np.float32)
    ro, rd = get_rays(400, 400, K, orbit_poses(160)[0][:3, :4], device=dev)
    pick = torch.randperm(400 * 400, generator=g, device=dev)[:RAYS]
    ro, rd = ro.reshape(-1, 3)[pick], rd.reshape(-1, 3)[pick]

    def points(S):
        z = torch.sort(torch.rand((RAYS, S), generator=g, device=dev) * 4.0 + 2.0, -1).values
        return (ro[:, None] + z[..., None] * rd[:, None]).reshape(-1, 3).contiguous()

    def encoding(F, log2_t):
        enc = HashGridEncoding(n_levels=8, min_res=16, max_res=256, features_per_level=F,
                               log2_table_size=log2_t, device=dev)
        return enc.init(torch.Generator(device=dev).manual_seed(0))

    def launch(lib, tag, enc, x, dout, ranges=None, levels=None):
        """dG of one launch of ``tag``'s kernel; ``levels``: (l, res) for an
        L = 1 launch of level l."""
        L, F, log2_t, c_res, bmin, brange, bf16 = he._geometry(enc)
        if levels is not None:
            l, r = levels
            L, c_res = 1, (ctypes.c_int * 1)(r)
        dG = torch.zeros((L, 1 << log2_t, F), device=dev)
        N = x.shape[0]
        args = [x.data_ptr(), dout.data_ptr(), dG.data_ptr(), N, L, F, log2_t, c_res, bmin,
                brange, bf16]
        if tag != "base":
            rr, bp = he.bwd_plan(L, N, n_sm)
            if ranges is not None:
                rr, bp = ranges, -(-N // ranges)
            args += [rr, bp]
        err = lib.hash_bwd_launch(*args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{tag}: cudaError {err}")
        return dG

    out, ok = {}, True
    # (name, F, log2 T, [(tag, library)])
    shapes = [
        ("lego_ingp", 2, 14, [("this", "this"), ("no_slide", "no_slide"), ("shared", "shared"),
                              ("warp", "warp"), ("no_flush", "no_flush"), ("base", "base")]),
        ("T2^10", 2, 10, [("this", "this"), ("shared", "shared")]),
        ("F4", 4, 14, [("this", "this"), ("no_slide", "no_slide"), ("warp", "warp"),
                       ("base", "base")]),
    ]
    for shape, F, log2_t, variants in shapes:
        enc = encoding(F, log2_t)
        runs = [(tag, libs[lib]) for tag, lib in variants if lib in libs]
        for name, S in BATCHES:
            if shape == "T2^10" and name in ("coarse", "long_coarse"):
                continue
            x = points(S)
            N = x.shape[0]
            dout = torch.randn((N, 8 * F), generator=g, device=dev)
            (g_p,) = torch.autograd.grad((enc.apply(x) * dout).sum(), enc.tables)
            touched = g_p != 0
            reps = max(5, int(2_000_000 // N))
            for tag, lib in runs:
                if tag.startswith(TIMING_ONLY):
                    continue
                g_k = launch(lib, tag, enc, x, dout)
                torch.cuda.synchronize()
                err = float((g_k - g_p).abs().max())
                good = bool(torch.isfinite(g_k).all()) and err <= 1e-4 * float(g_p.abs().max())
                good &= bool((g_k[~touched] == 0).all())
                ok &= good
                print(f"[check] {shape} {name} N={N} {tag}: max|dG-plain| {err:.3e} "
                      f"(1e-4 max|plain| {1e-4 * float(g_p.abs().max()):.3e}), untouched "
                      f"entries 0: {'ok' if good else 'FAIL'}", flush=True)
            times = {t: [] for t, _ in runs}
            for tag, lib in runs + list(reversed(runs)):
                times[tag].append(_ms(lambda tag=tag, lib=lib: launch(lib, tag, enc, x, dout),
                                      reps))
            plain = _ms(lambda: torch.autograd.grad((enc.apply(x) * dout).sum(), enc.tables),
                        max(2, reps // 10))
            for tag, t in times.items():
                out[f"{shape}_{name}_{tag}"] = t
            out[f"{shape}_{name}_plain_fwd_bwd"] = plain
            print(f"[time] {shape} {name} N={N}: "
                  + "; ".join(f"{t} {v[0]:.4f} / {v[1]:.4f} ms" for t, v in times.items())
                  + f"; plain fwd+bwd {plain:.3f} ms", flush=True)
            if shape == "lego_ingp" and name in ("fine", "long_fine"):
                for ranges in (8, 16, 32):
                    t = _ms(lambda r=ranges: launch(libs["this"], "this", enc, x, dout, r), reps)
                    out[f"{shape}_{name}_ranges{ranges}"] = t
                    print(f"[ranges] {name} {ranges} ranges a level: {t:.4f} ms", flush=True)
            if shape == "lego_ingp" and name == "long_fine":
                ranges = he.bwd_plan(8, N, n_sm)[0]  # the full launch's a level
                for l, r in enumerate(enc.resolutions):
                    d_l = dout[:, l * F:(l + 1) * F].contiguous()
                    t = _ms(lambda d_l=d_l, l=l, r=r: launch(
                        libs["this"], "this", enc, x, d_l, ranges, levels=(l, int(r))), reps)
                    out[f"{shape}_long_fine_level{l}"] = t
                    print(f"[level] long_fine level {l} (res {int(r)}): {t:.4f} ms", flush=True)
    print(f"[probe] all checks {'ok' if ok else 'FAILED'}", flush=True)
    print(json.dumps({"card": smi, "ms": out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
