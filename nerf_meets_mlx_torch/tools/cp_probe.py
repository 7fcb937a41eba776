"""Probes the CP encode's two kernels (``csrc/cp_encode.cu``) on one card.

    python nerf_meets_mlx_torch/tools/cp_probe.py [--base <other checkout>] [--no-head]

At lego_cp's lines (4 levels of 64..512 nodes, C = 16, seeded init) and at
the batches the kernel route gives them (``kernel_ab.cp_batches``): a train
step's coarse and fine points (4096 rays x 48 / 96 samples), a 400 x 400
frame's coarse and fine chunks (32,768 rays x 48 / 96), all in ray order
as ``chip_smoke.py``'s ``cp_point_sets`` makes them, and 393,216 uniform
random points in and around the box. In bf16 (lego_cp's compute) and in
fp32, for each build it holds the features and dLines against the plain
versions (``cp_fwd_reference`` / ``cp_bwd_reference``: features within
atol 1e-6 + rtol 1e-5, reported bit for bit; dLines within 1e-4 of the
largest plain value) and times each kernel's device time (torch.profiler,
the kernel alone) and each call's CUDA-event time (the backward's with the
zeroing of dLines), in turns (each build in order, then in reverse):

* ``head``: this checkout's kernels;
* each form in ``FORMS``: this checkout's source with the backward kernel
  replaced (the forms the redesign weighed);
* each edit in ``EDITS``: a text edit of the head's or the base's source;
  the ``TIMING_ONLY`` ones give wrong results and are timed, not checked
  (a ``-D`` define may restrict one to one compute type);
* ``base``: with ``--base``, that checkout's kernels (``--no-head``: the
  base and its edits alone).

It prints each build's ptxas report of the CP kernels (``[ptxas]``), the
card's name and power limit, a line a measurement, and last one JSON
object of every time.
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
OUT = HEAD / ".runs" / "cp_probe"

# the parent's kernels (a block's level summed with shared-memory atomics):
# timing edits that show what bounds them
BASE_EDITS = {
    # the shared-memory float atomics of the backward as plain (racy) adds
    "no_atomics": [(
        "  atomicAdd(row + 0, __fmul_rn(w, df.x));\n  atomicAdd(row + 1, __fmul_rn(w, df.y));\n"
        "  atomicAdd(row + 2, __fmul_rn(w, df.z));\n  atomicAdd(row + 3, __fmul_rn(w, df.w));",
        "  row[0] += __fmul_rn(w, df.x);\n  row[1] += __fmul_rn(w, df.y);\n"
        "  row[2] += __fmul_rn(w, df.z);\n  row[3] += __fmul_rn(w, df.w);")],
    # no flush of the block's sums into dLines (the sums are still read)
    "no_flush": [("    if (v != 0.f) atomicAdd(g + i, v);", "    if (v == 12345.f) g[i] = v;")],
    # every line gather from rows 0 and 1 (always in L1)
    "no_gathers": [("line + (size_t)T.i0 * A.C + c0", "line + c0"),
                   ("line + (size_t)(T.i0 + 1) * A.C + c0", "line + A.C + c0")],
    # the bf16 rounding fixed at compile time (bf16 only)
    "bf16_const": [("  return on ? __bfloat162float(__float2bfloat16_rn(v)) : v;",
                    "  return CP_RB ? __bfloat162float(__float2bfloat16_rn(v)) : v;")],
}
# this checkout's kernels: variants (checked) and timing edits
HEAD_EDITS = {
    # resident blocks an SM the backward's grid and registers are built for
    "blocks3": [("constexpr int BWD_MIN_BLOCKS = 2;", "constexpr int BWD_MIN_BLOCKS = 3;")],
    # stretches of up to 256 points
    "stretch256": [("constexpr int BWD_MAX_STRETCH = 64; ",
                    "constexpr int BWD_MAX_STRETCH = 256;")],
    # the forward's lines read through L1 whatever their size
    "fwd_unstaged": [("  P.staged = line_floats * (long long)sizeof(float) <= MAX_SMEM;",
                      "  P.staged = 0;")],
    # the backward's row adds as a plain store that never happens
    "no_atomics": [("    atomicAdd(reinterpret_cast<float4*>(row), v);",
                    "    if (v.x == 12345.f) row[0] = v.y;")],
    # every line gather from rows 0 and 1 of its axis (always in L1)
    "no_gathers": [("lv + ((size_t)a * r + T[a].i0) * C", "lv + (size_t)a * r * C")],
    # the backward's cotangent read from its stretch's first point (in L1)
    "no_dout": [("    const float4 d = __ldg(dp + n * row_quads);",
                 "    const float4 d = __ldg(dp + s0 * row_quads);")],
    # the backward at the coarsest or at the finest level alone
    "only_coarse": [("  if (s0 >= s1) return;\n  const int r = A.res[l];\n",
                     "  if (s0 >= s1 || l != 0) return;\n  const int r = A.res[l];\n")],
    "only_fine": [("  if (s0 >= s1) return;\n  const int r = A.res[l];\n",
                   "  if (s0 >= s1 || l != A.L - 1) return;\n  const int r = A.res[l];\n")],
}

# form (b) of the backward: a block works one level over a range of points;
# each of its W warps owns a private copy of the level's 3*R*C dLines in
# shared memory (W = 8, or as many copies as fit) and walks a stretch of the
# range one point at a time, lane (k, c) summing tap k's channel c of each
# axis in a register while the tap's row stays, then adding it to its copy
# with a plain read-modify-write (the lanes' entries differ; no atomic).
# At the end the block sums its copies and adds each entry that is not 0 to
# dLines with one atomic. C = 16 only.
PRIVATE_FORM = r"""constexpr int PRIV_SMEM = 232448;

template <bool BF16>
__global__ void __launch_bounds__(BWD_THREADS) cp_bwd_private_kernel(
    const __grid_constant__ CPArgs A, long long block_points) {
  extern __shared__ float copies[];
  const int l = (int)(blockIdx.x % (unsigned)A.L);
  const long long n0 = (long long)(blockIdx.x / (unsigned)A.L) * block_points;
  const long long e = n0 + block_points < A.N ? n0 + block_points : A.N;
  const int r = A.res[l], C = 16, n_line = 3 * r * C;
  int W = PRIV_SMEM / 4 / n_line;
  if (W > BWD_THREADS / 32) W = BWD_THREADS / 32;
  for (int i = threadIdx.x; i < W * n_line; i += BWD_THREADS) copies[i] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < W && n0 < e) {
    float* mine = copies + warp * n_line;
    const int c = lane & 15, k = lane >> 4;
    const long long per = (e - n0 + W - 1) / W;
    const long long s0 = n0 + warp * per, s1 = s0 + per < e ? s0 + per : e;
    const float* lv = A.lines + A.offs[l] + c;
    int row[3] = {-1, -1, -1};
    float acc[3] = {0.f, 0.f, 0.f};
    for (long long n = s0; n < s1; ++n) {
      const float d = __ldg(A.dout + (size_t)n * A.L * C + (size_t)l * C + c);
      Tap T[3];
      float f[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        T[a] = tap_of<BF16>(A, __ldg(A.x + n * 3 + a), r);
        const float* la = lv + (size_t)a * r * C;
        f[a] = __fadd_rn(__fmul_rn(T[a].w0, rb<BF16>(__ldg(la + (size_t)T[a].i0 * C))),
                         __fmul_rn(T[a].w1, rb<BF16>(__ldg(la + (size_t)(T[a].i0 + 1) * C))));
      }
      const float others[3] = {__fmul_rn(f[1], f[2]), __fmul_rn(f[0], f[2]),
                               __fmul_rn(f[0], f[1])};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float df = rb<BF16>(__fmul_rn(d, others[a]));
        const int my = T[a].i0 + k;
        if (my != row[a]) {  // the same for every lane: the taps are the point's
          if (row[a] >= 0) {
            float* m = mine + ((size_t)a * r + row[a]) * C + c;
            *m = __fadd_rn(*m, acc[a]);
          }
          acc[a] = 0.f;
          row[a] = my;
        }
        acc[a] = __fadd_rn(acc[a], __fmul_rn(k ? T[a].w1 : T[a].w0, df));
      }
      __syncwarp();
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (row[a] >= 0) {
        float* m = mine + ((size_t)a * r + row[a]) * C + c;
        *m = __fadd_rn(*m, acc[a]);
      }
    }
  }
  __syncthreads();
  float* g = A.out + A.offs[l];
  for (int i = threadIdx.x; i < n_line; i += BWD_THREADS) {
    float v = 0.f;
    for (int w = 0; w < W; ++w) v = __fadd_rn(v, copies[w * n_line + i]);
    if (v != 0.f) atomicAdd(g + i, v);
  }
}

template <bool BF16>
int launch_bwd(const CPArgs& a, const BwdPlan&, long long, cudaStream_t st) {
  if (a.C != 16) return (int)cudaErrorInvalidValue;
  long long ranges = sm_count() / a.L, most = (a.N + 1023) / 1024;
  ranges = ranges < most ? ranges : most;
  if (ranges < 1) ranges = 1;
  const long long block_points = (a.N + ranges - 1) / ranges;
  const cudaError_t err = cudaFuncSetAttribute(
      cp_bwd_private_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, PRIV_SMEM);
  if (err != cudaSuccess) return (int)err;
  cp_bwd_private_kernel<BF16><<<(unsigned)(ranges * a.L), BWD_THREADS, PRIV_SMEM, st>>>(
      a, block_points);
  return (int)cudaGetLastError();
}
"""

FORMS = {
    "private": ("template <bool BF16>\n__global__ void __launch_bounds__(BWD_THREADS, "
                "BWD_MIN_BLOCKS)", "// ---- end of the backward", PRIVATE_FORM),
}
TIMING_ONLY = ("no_atomics", "no_flush", "no_gathers", "bf16_const", "only_coarse",
               "only_fine", "no_dout")
# builds that take -D defines, and the compute types they are timed in
DEFINES = {"bf16_const": ("-DCP_RB=1",)}
DTYPES_OF = {"bf16_const": ("bfloat16",)}


def _build(tag: str, cu: Path, csrc: Path, defines=()):
    """(tag, library, ptxas lines of the CP kernels)."""
    from nerf_meets_mlx_torch.kernels import _build as b

    lib = OUT / f"lib{tag}.so"
    proc = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, *defines, "-I", str(csrc), "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr[-4000:]}")
    lines = proc.stderr.splitlines()
    ptxas = []
    for i, line in enumerate(lines):
        found = re.search(r"Compiling entry function '(\S*cp_\S*)'", line)
        if found:
            rep = [x.strip() for x in lines[i + 1:i + 4]
                   if "registers" in x or "spill" in x or "smem" in x]
            ptxas.append(f"{found.group(1)}: {' | '.join(rep)}")
    return tag, ctypes.CDLL(str(lib)), ptxas


def _type(lib):
    vp, ci, cll, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    tail = [cll] + [ci] * 2 + [vp, vp, cf, cf, ci, vp]
    lib.cp_fwd_launch.argtypes = [vp] * 3 + tail
    lib.cp_bwd_launch.argtypes = [vp] * 4 + tail
    for fn in (lib.cp_fwd_launch, lib.cp_bwd_launch):
        fn.restype = ci


def _edited(src: str, tag: str, edits) -> str:
    for old, new in edits:
        if src.count(old) < 1:
            raise RuntimeError(f"{tag}: the source does not hold {old!r}")
        src = src.replace(old, new)
    return src


def _jobs(a):
    """(tag, source file, its csrc, defines, the edit or form it is) of
    every build."""
    from nerf_meets_mlx_torch.kernels import _build as b

    jobs = []
    roots = []
    if not a.no_head:
        roots.append(("head", b.CSRC, HEAD_EDITS, FORMS))
    if a.base:
        roots.append(("base", Path(a.base).resolve() / "nerf_meets_mlx_torch" / "csrc",
                      BASE_EDITS, {}))
    for root_tag, csrc, edits, forms in roots:
        src = (csrc / "cp_encode.cu").read_text()
        jobs.append((root_tag, csrc / "cp_encode.cu", csrc, (), root_tag))
        for tag, (start, end, body) in forms.items():
            i, j = src.index(start), src.index(end)
            (OUT / f"{tag}.cu").write_text(src[:i] + body + src[j:])
            jobs.append((tag, OUT / f"{tag}.cu", csrc, DEFINES.get(tag, ()), tag))
        for tag, ed in edits.items():
            name = f"{root_tag}_{tag}"
            (OUT / f"{name}.cu").write_text(_edited(src, name, ed))
            jobs.append((name, OUT / f"{name}.cu", csrc, DEFINES.get(tag, ()), tag))
    return jobs


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--base", help="another checkout's root (its kernels timed beside)")
    p.add_argument("--no-head", action="store_true",
                   help="time the base checkout's kernels and their edits alone (with --base)")
    a = p.parse_args()
    sys.path.insert(0, str(HEAD))
    import torch

    from nerf_meets_mlx_torch.config import lego_cp
    from nerf_meets_mlx_torch.kernels import cp_encode as ce
    from nerf_meets_mlx_torch.models import create_nerf
    from nerf_meets_mlx_torch.tools.kernel_ab import _device_ms, _ms, cp_batches

    if not torch.cuda.is_available():
        print("no CUDA device: the probe times the kernels on the card", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = _jobs(a)
    kind = {j[0]: j[4] for j in jobs}
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = [f.result() for f in [ex.submit(_build, *j[:4]) for j in jobs]]
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
    enc = create_nerf(lego_cp(), device=dev).init(torch.Generator().manual_seed(0)).pos_enc
    g = torch.Generator(device=dev).manual_seed(7)
    out, ok = {}, True
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, x in cp_batches(dev):
        N = x.shape[0]
        dout = torch.randn((N, enc.out_dim), generator=g, device=dev)
        for dtype in ("bfloat16", "float32"):
            enc.compute_dtype = dtype
            spec = ce.CPEncodeSpec.from_encoding(enc)
            flat = ce.flatten_lines(enc.lines)
            c_res, c_offs = ce._geometry(spec)
            args = (N, spec.n_levels, spec.n_components, c_res, c_offs, spec.bbox_min,
                    spec.inv_range, int(spec.bf16), stream)
            feats = torch.empty((N, spec.out_dim), device=dev)
            dflat = torch.zeros_like(flat)
            with torch.no_grad():
                f_p = ce.cp_fwd_reference(spec, enc.lines, x)
                d_p = ce.cp_bwd_reference(spec, enc.lines, x, dout)
            runs = [(t, lib) for t, lib in libs.items()
                    if dtype in DTYPES_OF.get(kind[t], (dtype,))]

            def fwd(lib):
                err = lib.cp_fwd_launch(x.data_ptr(), flat.data_ptr(), feats.data_ptr(), *args)
                if err:
                    raise RuntimeError(f"cp_fwd_launch: cudaError {err}")

            def bwd(lib):
                dflat.zero_()
                err = lib.cp_bwd_launch(x.data_ptr(), flat.data_ptr(), dout.data_ptr(),
                                        dflat.data_ptr(), *args)
                if err:
                    raise RuntimeError(f"cp_bwd_launch: cudaError {err}")

            for tag, lib in runs:
                feats.fill_(float("nan"))
                fwd(lib)
                bwd(lib)
                torch.cuda.synchronize()
                if kind[tag] in TIMING_ONLY:
                    continue
                f_err = float((feats - f_p).abs().max())
                f_ok = bool(((feats - f_p).abs() <= 1e-6 + 1e-5 * f_p.abs()).all())
                ratios = [float((u - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                          for u, v in zip(ce.split_lines(spec, dflat), d_p)]
                good = f_ok and max(ratios) <= 1e-4 and bool(torch.isfinite(dflat).all())
                ok &= good
                print(f"[check] {name} N={N} {dtype} {tag}: features max abs {f_err:.3e} "
                      f"(equal: {bool(torch.equal(feats, f_p))}); dLines/max|plain| per level "
                      + " ".join(f"{r:.1e}" for r in ratios) + (" ok" if good else " FAIL"),
                      flush=True)
            reps = max(5, int(20_000_000 // N))
            times = {}
            for tag, lib in runs + list(reversed(runs)):
                t = times.setdefault(tag, {"fwd_device": [], "fwd_events": [], "bwd_device": [],
                                           "bwd_events": []})
                t["fwd_device"].append(_device_ms(lambda: fwd(lib), reps, key="cp_"))
                t["fwd_events"].append(_ms(lambda: fwd(lib), reps))
                t["bwd_device"].append(_device_ms(lambda: bwd(lib), reps, key="cp_"))
                t["bwd_events"].append(_ms(lambda: bwd(lib), reps))
            # bytes each must move: x and the features (or the cotangent) a
            # point, the lines once (and dLines written once)
            io, lb = N * (12 + 4 * spec.out_dim), 4 * flat.numel()
            out[f"{name}_{dtype}_bound"] = {"fwd": (io + lb) / 3.35e12 * 1e3,
                                            "bwd": (io + 2 * lb) / 3.35e12 * 1e3}
            for tag, t in times.items():
                out[f"{name}_{dtype}_{tag}"] = t
                print(f"[time] {name} N={N} {dtype} {tag}: fwd device "
                      + " / ".join(f"{v:.4f}" for v in t["fwd_device"]) + " events "
                      + " / ".join(f"{v:.4f}" for v in t["fwd_events"]) + " | bwd device "
                      + " / ".join(f"{v:.4f}" for v in t["bwd_device"]) + " events "
                      + " / ".join(f"{v:.4f}" for v in t["bwd_events"]) + " ms", flush=True)
            del feats, dflat, f_p, d_p
        del x, dout
    print(f"[probe] all checks {'ok' if ok else 'FAILED'}", flush=True)
    print(json.dumps({"card": smi, "ms": out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
