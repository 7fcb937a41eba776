"""Probes the hash encode's compute_dx backward (``csrc/hash_encode.cu``'s
``hash_dx_bwd_launch``) on one card.

    python nerf_meets_mlx_torch/tools/hash_dx_probe.py [--base <other checkout>] [--no-head]

At the batches ``kernel_ab.hash_dx_batches`` makes (lego_ingp's tables, 8
levels of 2^14 x 2, with a train step's ray-ordered coarse and fine points,
4096 rays x 48 / 96 samples; the fine points under the Instant-NGP paper's
tables, 16 levels of 2^19 x 2; 393,216 uniform random points in and around
the box at lego_ingp's tables), with a random dout, it builds, holds each
build against autograd through ``hash_encode_dx_reference`` (dX within 1e-4
of the largest plain value, dG within 1e-3, every dG entry no point touches
exactly 0) and times each call's device time (torch.profiler: every device
event of the call, the zeroing of dG and of any workspace included, and
each hash kernel alone) and its CUDA-event time, in turns (each build in
order, then in reverse):

* ``head``: this checkout's backward (the dG walk and the dX kernel);
* each form in ``FORMS``: this checkout's source with the dX kernel or the
  whole backward replaced (the forms the redesign weighed);
* each edit in ``HEAD_EDITS`` / ``BASE_EDITS``: a text edit of the head's or
  the base's source (``BASE_EDITS`` edit the first port's kernel, a thread
  a point adding dG with scalar atomics, which only a checkout from before
  the redesign holds); the ``TIMING_ONLY`` ones give wrong results and are
  timed, not checked;
* each plan in ``PLANS``: the head's build with more ranges a level;
* ``base``: with ``--base``, that checkout's backward (``--no-head``: the
  base and its edits alone).

It prints each build's ptxas report of the backward's kernels (``[ptxas]``),
the card's name and power limit, a line a measurement, and last one JSON
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
OUT = HEAD / ".runs" / "hash_dx_probe"

# the first port's kernel (a thread a point over every level, 8·F scalar
# atomics a level): timing edits that show what bounds it
BASE_EDITS = {
    # the dG atomics as a store that never happens (the products kept)
    "no_atomics": [("        atomicAdd(grow + k, __fmul_rn(C.w[c], d[k]));",
                    "        if (__fmul_rn(C.w[c], d[k]) == 12345.f) grow[k] = 0.f;")],
    # no dX arithmetic past s = sum_f d * v (the gathers kept) and no store
    "no_dx": [
        ("      const float wx = bx ? fr[0] : __fsub_rn(1.f, fr[0]);\n"
         "      const float wy = by ? fr[1] : __fsub_rn(1.f, fr[1]);\n"
         "      const float wz = bz ? fr[2] : __fsub_rn(1.f, fr[2]);\n"
         "      gx = __fadd_rn(gx, __fmul_rn(__fmul_rn(s, bx ? r : -r), __fmul_rn(wy, wz)));\n"
         "      gy = __fadd_rn(gy, __fmul_rn(__fmul_rn(s, by ? r : -r), __fmul_rn(wx, wz)));\n"
         "      gz = __fadd_rn(gz, __fmul_rn(__fmul_rn(s, bz ? r : -r), __fmul_rn(wx, wy)));",
         "      gx = __fadd_rn(gx, s);"),
        ("    A.dx[n * 3 + a] = t[a] >= 0.f && t[a] <= 1.f ? __fmul_rn(g[a], A.inv) : 0.f;",
         "    if (g[a] == 12345.f) A.dx[n * 3 + a] = t[a];"),
    ],
    # every table row read from rows 0..7 of its level (always in L1)
    "no_gathers": [("      load_row<F>(tl + (size_t)C.h[c] * F, g);",
                    "      load_row<F>(tl + (size_t)c * F, g);")],
}
# this checkout's backward: timing edits
HEAD_EDITS = {
    # the dG walk without its row atomics (the runs still summed)
    "no_flush": [
        ("  if (open) flush_run<F>(A, cur, acc, gl);\n}",
         "  if (open && acc[0][0] == 1234.5f) flush_run<F>(A, cur, acc, gl);\n}"),
        ("        open = next_cell<F>(A, cur, b, acc, gl);",
         "        open = acc[0][0] == 1234.5f && next_cell<F>(A, cur, b, acc, gl);"),
    ],
    # the dX kernel's table rows from rows 0..7 of the level (always in L1)
    "dx_no_gathers": [("    table_row<F>(tl, corner_row(A, b, c), v);",
                       "    table_row<F>(tl, (unsigned)c, v);")],
}

# form (a-ii) of the dX kernel: a thread a point and a chunk of 8 / F
# levels (the forward's grid: block b takes chunk b % chunks of the points
# from (b / chunks) * DX_THREADS), its part of dX added to the point's row
# with scalar atomics (dX zeroed first)
CHUNK_FORM = r"""template <int F>
__global__ void __launch_bounds__(DX_THREADS) hash_dx_kernel(const __grid_constant__ HashArgs A,
                                                             int vec, unsigned chunks) {
  constexpr int K = DX_CHUNK / F;
  const unsigned group = blockIdx.x / chunks;
  const long long n = (long long)group * DX_THREADS + threadIdx.x;
  if (n >= A.N) return;
  const int L = A.L, l0 = (int)(blockIdx.x - group * chunks) * K;
  float t[3], u[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    t[a] = unit_of<DX>(A, __ldg(A.x + n * 3 + a));
    u[a] = fminf(fmaxf(t[a], 0.f), 1.f);
  }
  float g[3] = {0.f, 0.f, 0.f};
  const float* row = A.dout + (size_t)n * L * F;
  float d[DX_CHUNK];
  if (vec && l0 + K <= L) {
    const float4* q = reinterpret_cast<const float4*>(row + l0 * F);
#pragma unroll
    for (int j = 0; j < DX_CHUNK / 4; ++j) {
      const float4 v = __ldg(q + j);
      d[4 * j] = v.x; d[4 * j + 1] = v.y; d[4 * j + 2] = v.z; d[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < DX_CHUNK; ++k) d[k] = l0 * F + k < L * F ? __ldg(row + l0 * F + k) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (l0 + j < L) level_dx<F>(A, u, l0 + j, d + j * F, g);
#pragma unroll
  for (int a = 0; a < 3; ++a)
    if (t[a] >= 0.f && t[a] <= 1.f && g[a] != 0.f)
      atomicAdd(A.dx + n * 3 + a, __fmul_rn(g[a], A.inv));
}

"""
CHUNK_LAUNCH = r"""int launch_dx(const HashArgs& a, cudaStream_t st) {
  const int K = DX_CHUNK / a.F;
  const unsigned chunks = (unsigned)((a.L + K - 1) / K);
  const long long blocks = (a.N + DX_THREADS - 1) / DX_THREADS * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t z = cudaMemsetAsync(a.dx, 0, (size_t)a.N * 3 * sizeof(float), st);
  if (z != cudaSuccess) return (int)z;
  const int vec = (a.L * a.F) % 4 == 0 && reinterpret_cast<uintptr_t>(a.dout) % 16 == 0;
  const unsigned g = (unsigned)blocks;
  switch (a.F) {
    case 1: hash_dx_kernel<1><<<g, DX_THREADS, 0, st>>>(a, vec, chunks); break;
    case 2: hash_dx_kernel<2><<<g, DX_THREADS, 0, st>>>(a, vec, chunks); break;
    case 4: hash_dx_kernel<4><<<g, DX_THREADS, 0, st>>>(a, vec, chunks); break;
    default: hash_dx_kernel<8><<<g, DX_THREADS, 0, st>>>(a, vec, chunks); break;
  }
  return (int)cudaGetLastError();
}

"""

# form (b): one launch. The dG walk also takes dX: a run in one cell shares
# its 8 corner rows, gathered once a run (a slide to a face neighbour keeps
# the 4 shared rows and gathers the other 4); each live (point, level) adds
# its level's part of dX, chained through the clip, to a padded [N, 4]
# workspace with one 16-byte vector atomic (the workspace zeroed first)
ONE_LAUNCH = r"""template <int F, int AXIS, bool UP>
__device__ __forceinline__ void slide_rows(const HashArgs& A, const float* tl,
                                           const unsigned (&b)[3], float (&v)[8][F]) {
  constexpr int bit = 1 << AXIS;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if ((c & bit) == (UP ? 0 : bit)) {
#pragma unroll
      for (int k = 0; k < F; ++k) v[c][k] = v[c ^ bit][k];
      table_row<F>(tl, corner_row(A, b, c ^ bit), v[c ^ bit]);
    }
  }
}

template <int F>
__global__ void __launch_bounds__(BWD_THREADS)
    hash_dx_dg_kernel(const __grid_constant__ BwdArgs P) {
  extern __shared__ float stage[];
  const HashArgs& A = P.A;
  const int l = (int)(blockIdx.x % (unsigned)A.L);
  const long long n0 = (long long)(blockIdx.x / (unsigned)A.L) * P.block_points;
  if (n0 >= A.N) return;
  const long long n1 = n0 + P.block_points < A.N ? n0 + P.block_points : A.N;
  float* gl = A.out + (size_t)l * A.T * F;
  const float* tl = A.tables + (size_t)l * A.T * F;
  const float r = (float)A.res[l];
  constexpr int PP = stage_points(F), SX = stage_x(F), SD = stage_d(F);
  const int lane = threadIdx.x & 31;
  const long long per = (n1 - n0 + BWD_THREADS - 1) / BWD_THREADS;
  const long long wbase = n0 + (long long)(threadIdx.x - lane) * per;
  float* xs = stage + (threadIdx.x - lane) * SX;
  float* ds = stage + BWD_THREADS * SX + (threadIdx.x - lane) * SD;
  const long long s0 = wbase + lane * per;
  float acc[8][F], v[8][F];
  unsigned cur[3] = {0u, 0u, 0u};
  bool open = false;
  for (long long j = 0; j < per; j += PP) {
    float vx[3 * PP], vd[PP * F];
    stage_load<F>(A, l, wbase, per, n1, j, vx, vd);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 3 * PP; ++k) {
      const int e = k * 32 + lane, sl = e / (3 * PP);
      xs[sl * SX + e - sl * 3 * PP] = vx[k];
    }
#pragma unroll
    for (int k = 0; k < PP * F; ++k) {
      const int e = k * 32 + lane, sl = e / (PP * F);
      ds[sl * SD + e - sl * PP * F] = vd[k];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < PP; ++i) {
      if (s0 + j + i >= n1 || j + i >= per) break;
      float d[F];
      bool any = false;
#pragma unroll
      for (int k = 0; k < F; ++k) {
        d[k] = ds[lane * SD + i * F + k];
        any |= d[k] != 0.f;
      }
      if (!any) continue;
      const float p[3] = {xs[lane * SX + 3 * i], xs[lane * SX + 3 * i + 1],
                          xs[lane * SX + 3 * i + 2]};
      unsigned b[3];
      float f[3];
      cell_of<DX>(A, p, l, b, f);
      if (open && (b[0] != cur[0] || b[1] != cur[1] || b[2] != cur[2])) {
        const int d0 = (int)(b[0] - cur[0]), d1 = (int)(b[1] - cur[1]), d2 = (int)(b[2] - cur[2]);
        open = next_cell<F>(A, cur, b, acc, gl);
        if (open) {
          if (d0 == 1) slide_rows<F, 0, true>(A, tl, b, v);
          else if (d0 == -1) slide_rows<F, 0, false>(A, tl, b, v);
          else if (d1 == 1) slide_rows<F, 1, true>(A, tl, b, v);
          else if (d1 == -1) slide_rows<F, 1, false>(A, tl, b, v);
          else if (d2 == 1) slide_rows<F, 2, true>(A, tl, b, v);
          else slide_rows<F, 2, false>(A, tl, b, v);
        }
        cur[0] = b[0]; cur[1] = b[1]; cur[2] = b[2];
      }
      if (!open) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int k = 0; k < F; ++k) acc[c][k] = 0.f;
          table_row<F>(tl, corner_row(A, b, c), v[c]);
        }
        cur[0] = b[0]; cur[1] = b[1]; cur[2] = b[2];
        open = true;
      }
      float g[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
        const float w = corner_weight(f, c);
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < F; ++k) {
          acc[c][k] = __fadd_rn(acc[c][k], __fmul_rn(w, d[k]));
          s = __fadd_rn(s, __fmul_rn(d[k], v[c][k]));
        }
        const float wx = bx ? f[0] : __fsub_rn(1.f, f[0]);
        const float wy = by ? f[1] : __fsub_rn(1.f, f[1]);
        const float wz = bz ? f[2] : __fsub_rn(1.f, f[2]);
        g[0] = __fadd_rn(g[0], __fmul_rn(__fmul_rn(s, bx ? r : -r), __fmul_rn(wy, wz)));
        g[1] = __fadd_rn(g[1], __fmul_rn(__fmul_rn(s, by ? r : -r), __fmul_rn(wx, wz)));
        g[2] = __fadd_rn(g[2], __fmul_rn(__fmul_rn(s, bz ? r : -r), __fmul_rn(wx, wy)));
      }
      float o[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t = unit_of<DX>(A, p[a]);
        o[a] = t >= 0.f && t <= 1.f ? __fmul_rn(g[a], A.inv) : 0.f;
      }
      atomicAdd(reinterpret_cast<float4*>(A.dx) + (s0 + j + i), make_float4(o[0], o[1], o[2], 0.f));
    }
  }
  if (open) flush_run<F>(A, cur, acc, gl);
}

"""
# (first text replaced, the text the replacement ends before, the
# replacement) of each form
FORMS = {
    "level_chunks": [
        ("template <int F>\n__global__ void __launch_bounds__(DX_THREADS) hash_dx_kernel(",
         "HashArgs make_args(", CHUNK_FORM),
        ("int launch_dx(const HashArgs& a, cudaStream_t st) {", "}  // namespace", CHUNK_LAUNCH),
    ],
    "one_launch": [
        ("template <int F>\n__global__ void __launch_bounds__(BWD_THREADS)\n    hash_dx_dg_kernel(",
         "// ---- the forward: hash_fwd_kernel", ""),
        ("template <int F>\n__global__ void __launch_bounds__(DX_THREADS) hash_dx_kernel(",
         "HashArgs make_args(", ONE_LAUNCH),
        ("// ceil(N / DX_THREADS) blocks\nint launch_dx(", "}  // namespace", ""),
        ("  const int e = launch_bwd<DX>(a, ranges, block_points, st);\n"
         "  return e != 0 ? e : launch_dx(a, st);",
         "\n}", "  const cudaError_t z = cudaMemsetAsync(dX, 0, (size_t)N * 4 * sizeof(float), st);\n"
         "  if (z != cudaSuccess) return (int)z;\n"
         "  return launch_bwd<DX>(a, ranges, block_points, st);"),
    ],
}
TIMING_ONLY = ("no_atomics", "no_dx", "no_gathers", "no_flush", "dx_no_gathers")
# floats a point's row of the dX buffer holds, where a form pads it
DX_WIDTH = {"one_launch": 4}
# the head's dG walk on more ranges a level than bwd_plan gives it
PLANS = {"ranges2": 2, "ranges4": 4}


def _build(tag: str, cu: Path, csrc: Path):
    """(tag, library, ptxas lines of the compute_dx backward's kernels)."""
    from nerf_meets_mlx_torch.kernels import _build as b

    lib = OUT / f"lib{tag}.so"
    proc = subprocess.run([b._nvcc(), *b.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr[-4000:]}")
    lines = proc.stderr.splitlines()
    ptxas = []
    for i, line in enumerate(lines):
        found = re.search(r"Compiling entry function '(\S*hash_dx\S*)'", line)
        if found:
            rep = [x.strip() for x in lines[i + 1:i + 4]
                   if "registers" in x or "spill" in x or "smem" in x]
            ptxas.append(f"{found.group(1)}: {' | '.join(rep)}")
    return tag, ctypes.CDLL(str(lib)), ptxas


def _type(lib, planned: bool):
    vp, ci, cll, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.hash_dx_bwd_launch.argtypes = ([vp] * 5 + [cll] + [ci] * 3 + [vp, cf, cf]
                                       + ([ci, cll] if planned else []) + [vp])
    lib.hash_dx_bwd_launch.restype = ci


def _edited(src: str, tag: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{tag}: the source does not hold {old!r} once")
        src = src.replace(old, new)
    return src


def _jobs(a):
    """(tag, source file, its csrc, the root it comes from) of every build."""
    from nerf_meets_mlx_torch.kernels import _build as b

    jobs = []
    roots = []
    if not a.no_head:
        roots.append(("head", b.CSRC, HEAD_EDITS, FORMS))
    if a.base:
        roots.append(("base", Path(a.base).resolve() / "nerf_meets_mlx_torch" / "csrc",
                      BASE_EDITS, {}))
    for root_tag, csrc, edits, forms in roots:
        src = (csrc / "hash_encode.cu").read_text()
        jobs.append((root_tag, csrc / "hash_encode.cu", csrc, root_tag))
        for tag, parts in forms.items():
            form = src
            for start, end, body in parts:
                if form.count(start) != 1:
                    raise RuntimeError(f"{tag}: the source does not hold {start!r} once")
                i = form.index(start)
                j = form.index(end, i)
                form = form[:i] + body + form[j:]
            (OUT / f"{tag}.cu").write_text(form)
            jobs.append((tag, OUT / f"{tag}.cu", csrc, root_tag))
        for tag, ed in edits.items():
            name = f"{root_tag}_{tag}"
            (OUT / f"{name}.cu").write_text(_edited(src, name, ed))
            jobs.append((name, OUT / f"{name}.cu", csrc, root_tag))
    return jobs


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--base", help="another checkout's root (its backward timed beside)")
    p.add_argument("--no-head", action="store_true",
                   help="time the base checkout's backward and its edits alone (with --base)")
    a = p.parse_args()
    sys.path.insert(0, str(HEAD))
    import torch

    from nerf_meets_mlx_torch.kernels import hash_encode as he
    from nerf_meets_mlx_torch.tools.kernel_ab import _device_ms, _ms, hash_dx_batches

    if not torch.cuda.is_available():
        print("no CUDA device: the probe times the kernels on the card", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = _jobs(a)
    root = {j[0]: j[3] for j in jobs}
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = [f.result() for f in [ex.submit(_build, *j[:3]) for j in jobs]]
    libs = {}
    for tag, lib, ptxas in built:
        _type(lib, root[tag] == "head")
        libs[tag] = lib
        for line in ptxas:
            print(f"[ptxas] {tag} {line}", flush=True)
    runs = [(tag, tag, None) for tag in libs]
    runs += [(f"head_{name}", "head", factor) for name, factor in PLANS.items() if "head" in libs]

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(41)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out, ok = {}, True
    for name, enc, x in hash_dx_batches(dev):
        N = x.shape[0]
        L, F, log2_t, c_res, bmin, _, _ = he._geometry(enc)
        inv = he._inv(enc)
        dout = torch.randn((N, enc.out_dim), generator=g, device=dev)
        xg = x.clone().requires_grad_(True)
        gx_p, gt_p = torch.autograd.grad((he.hash_encode_dx_reference(enc, xg) * dout).sum(),
                                         [xg, enc.tables])
        touched = gt_p != 0
        dG = torch.zeros(enc.tables.shape, device=dev)
        bufs = {w: torch.zeros((N, w), device=dev) for w in {3, *DX_WIDTH.values()}}

        def call(tag, lib_tag, factor):
            dX = bufs[DX_WIDTH.get(lib_tag, 3)]
            dG.zero_()
            args = [x.data_ptr(), enc.tables.data_ptr(), dout.data_ptr(), dG.data_ptr(),
                    dX.data_ptr(), N, L, F, log2_t, c_res, bmin, inv]
            if root[lib_tag] == "head":
                ranges, bp = he.bwd_plan(L, N, n_sm)
                if factor:
                    ranges = ranges * factor
                    bp = -(-N // ranges)
                args += [ranges, bp]
            err = libs[lib_tag].hash_dx_bwd_launch(*args, stream)
            if err != 0:
                raise RuntimeError(f"{tag}: cudaError {err}")
            return dX[:, :3]

        for tag, lib_tag, factor in runs:
            dX = call(tag, lib_tag, factor)
            torch.cuda.synchronize()
            if any(tag.endswith(t) for t in TIMING_ONLY):
                continue
            rx = float((dX - gx_p).abs().max()) / float(gx_p.abs().max())
            rg = float((dG - gt_p).abs().max()) / float(gt_p.abs().max())
            good = (rx <= 1e-4 and rg <= 1e-3 and bool(torch.isfinite(dX).all())
                    and bool(torch.isfinite(dG).all()) and not bool(dG[~touched].any()))
            ok &= good
            print(f"[check] {name} N={N} {tag}: max|dX-plain|/max|plain| {rx:.2e}, "
                  f"max|dG-plain|/max|plain| {rg:.2e}, untouched dG 0 "
                  + ("ok" if good else "FAIL"), flush=True)
        reps = max(5, int(4_000_000 // N))
        times = {}
        for tag, lib_tag, factor in runs + list(reversed(runs)):
            t = times.setdefault(tag, {"device": [], "events": [], "kernels": []})

            def fn(tag=tag, lib_tag=lib_tag, factor=factor):
                call(tag, lib_tag, factor)

            t["device"].append(_device_ms(fn, reps))
            t["events"].append(_ms(fn, reps))
            t["kernels"].append(_kernel_split(fn, reps))
        # the row's byte bound: x, dout and dX a point, the tables read and
        # dG written once
        tb = 4 * enc.tables.numel()
        out[f"{name}_bound"] = (4 * N * (3 + L * F + 3) + 2 * tb) / 3.35e12 * 1e3
        for tag, t in times.items():
            out[f"{name}_{tag}"] = t
            print(f"[time] {name} N={N} {tag}: device "
                  + " / ".join(f"{v:.4f}" for v in t["device"]) + " events "
                  + " / ".join(f"{v:.4f}" for v in t["events"]) + " ms; kernels "
                  + json.dumps(t["kernels"][0]), flush=True)
        del dG, bufs, dout, xg, gx_p, gt_p
    print(f"[probe] all checks {'ok' if ok else 'FAILED'}", flush=True)
    print(json.dumps({"card": smi, "ms": out}), flush=True)
    return 0 if ok else 1


def _kernel_split(fn, n):
    """{kernel name: device ms a call} of the hash kernels ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "hash_" in e.name:
            key = re.sub(r"^.*?(hash_\w+?)(<.*|\(.*)?$", r"\1", e.name)
            t = getattr(e, "self_device_time_total", None)
            us = float(getattr(e, "self_cuda_time_total", 0.0) if t is None else t)
            split[key] = round(split.get(key, 0.0) + us / 1e3 / n, 5)
    return split


if __name__ == "__main__":
    sys.exit(main())
