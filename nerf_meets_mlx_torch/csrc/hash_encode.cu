// Multiresolution hash-grid encode and its gradients, for Hopper (sm_90a).
//
// Replaces six kernels of nerf_meets_mlx_tpu/kernels/hash_encode.py:
//
//   hash_fwd_kernel<F, BODY|BF16> ::_fwd_body_kernel (the forward, all
//                                 levels in one body; BF16: bf16 compute)
//                                 and ::_fwd_grid_kernel (levels_in_body=
//                                 False: one level per grid step; the same
//                                 numbers, one kernel)
//   hash_bwd_kernel<F>            ::_bwd_body_kernel and ::_bwd_grid_kernel
//                                 (the scatter-add of the cotangent into the
//                                 tables; the two give the same dG)
//   hash_fwd_kernel<F, DX>        ::_fwd_kernel (compute_dx=True)
//   hash_dx_bwd_kernel<F>         ::_bwd_kernel (compute_dx=True: dG and dX)
//
// Per point x [N,3] and level l:
//
//   u  = clip((x - bbox_min) / (bbox_max - bbox_min), 0, 1)
//   s  = u * res_l,  i = floor(s),  f = s - i
//   feats[n][l*F + k] = sum over corners c = bx | by<<1 | bz<<2, in order 0..7,
//                       of tables[l][h_c][k] * (wx*wy)*wz
//   h_c = ((ix+bx)*1 ^ (iy+by)*2654435761 ^ (iz+bz)*805459861) mod 2^32 & (T-1)
//
// exactly as encoding/hash_grid.py's plain version computes it (uint32
// arithmetic gives the wrap; the division is IEEE, and products and sums are
// rounded one by one, with no contraction into FMAs, so the features agree
// with the plain version's to the last bit). The backward adds
// w_c * dout[n][l*F + k] into dG[l][h_c][k].
//
// bf16 mode (hash_compute_dtype = "bfloat16") rounds where the Pallas body
// kernels round (hash_encode.py:340-375, :376-426): the trilinear weight
// and the table value are rounded to bf16 and their product (exact in
// fp32) is rounded to bf16 again (the one-hot GEMM's output cast), and the
// 8 corners are summed in fp32; the backward adds bf16(w_c) * bf16(dout),
// exact in fp32, in fp32 (the transposed GEMM's fp32 accumulation).
//
// The gathers: a point reads 8 corners x L levels table rows of F floats
// at hashed (random) rows, 64 lookups at the lego_ingp shape (L = 8, F = 2:
// one 8-byte float2 each); the tables are L*T*F*4 = 1 MB and stay in the 50
// MB L2. The bytes a call must move are the points in and the features out
// (and the tables once): 12 + 4*L*F bytes a point.
//
// The forward (hash_fwd_kernel, one kernel for the three Pallas forwards,
// below): a thread a point and 32 bytes of its row, a warp one level at a
// time over 32 consecutive points; it writes feats [N, L*F] in place, where
// the Pallas grid kernel writes [L, N, F] and transposes. Its numbers are
// the plain version's to the last bit in every instance. A level's table in
// shared memory (a block a level, or a cluster of L blocks assembling rows
// in distributed shared memory), tiles of points with their rows staged in
// shared memory, and a block walking a range of points were all right and
// slower (tools/hash_fwd_probe.py, PERF.md). The resolutions come
// from the host as the int32 values of _level_resolutions.
//
// The table gradient (hash_bwd_kernel, both Pallas backwards): one
// scalar atomic a term, 8*F a (point, level), would be 128 a point at
// lego_ingp, and on the coarse levels (16^3 .. 35^3 cells) they contend for
// a few thousand rows. But the points come in rays ([rays, samples]
// flattened), so consecutive points share a coarse cell, often ten or more
// at 384 samples a ray, and their 8 corner rows with it; and a ray moves
// from a cell to a face neighbour, which shares 4 of its corners. So a
// block works one level over a contiguous range of points (the grid: one
// block an SM, the SMs shared equally by the levels, as every level takes
// every point), each thread a stretch of it in order, and the terms of a
// run of points in one cell are summed in registers, kept for the shared
// corners when the run slides to a face neighbour, and added to dG once a
// row with sm_90's vector atomics (see merge_runs). A copy of the level's
// dG slice in shared memory (128 KB at lego_ingp) measured slower at every
// batch: sm_90 has no fp32 add on shared memory, so each add is a
// compare-and-swap loop (tools/hash_bwd_probe.py). Only the grouping of
// the sums differs from the plain scatter-add: each term is w_c * d
// (bf16(w_c) * bf16(d) in bf16 mode, exact in fp32), summed in fp32; a row
// no point touches stays exactly 0; the atomics' order changes from run to
// run, so dG agrees with the plain version's to rounding, not bit for bit.
// What bounds it: at every level the walk reads a point's x (12 bytes) and
// the 32-byte sector of its dout row that holds the level's features, 44
// bytes a (point, level) where the byte bound counts 12 + 4*L*F a point;
// and the atomics, one REDG a row added (two at F = 8).
//
// compute_dx (DX and hash_dx_bwd_kernel) computes in fp32 whatever
// hash_compute_dtype says, and normalises as the Pallas kernels do,
// u = clip((x - bbox_min) * inv, 0, 1) with inv = f32(1 / (bbox_max -
// bbox_min)), where the body kernels divide. The forward is the fp32 body
// forward under that normalisation. The backward takes one thread per
// point over every level: dG[l][h_c][f] += w_c * d[n][l*F + f] (fp32
// products, atomics), and for each corner s = sum_f d * v_raw, adding
// s * (+-res_l) * (wy*wz) to the x gradient (likewise y and z), then
// chaining through the clip with the mask 0 <= t <= 1, inclusive at both
// ends. The Pallas forward stashes every corner's raw table value [N,
// L*8*F] so that its backward spares the MXU a one-hot GEMM; here the
// backward gathers the 8 corners again: the stash would be 512 bytes a
// point at lego_ingp (201 MB at 393,216 points) written and read back
// through device memory, while the re-gather reads tables that stay in the
// 50 MB L2 (1 MB at lego_ingp). Either gives the same dX. Its bytes: x and
// d in (12 + 4*L*F a point), dX out (12).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_LEVELS = 32;
constexpr int MAX_CHANNELS = 128;  // L*F

// which Pallas kernel an instance stands for
enum Map { BODY, BF16, DX };  // BF16: BODY rounding as the bf16 compute

struct HashArgs {
  const float* x;        // [N, 3]
  const float* tables;   // [L, T, F]
  const float* dout;     // [N, L*F] (backward)
  float* out;            // feats [N, L*F] (forward) or dG [L, T, F] (backward)
  float* dx;             // [N, 3] (compute_dx backward)
  long long N;
  int L, F;
  unsigned mask;         // T - 1
  long long T;
  float bmin, brange;    // the body kernels divide by brange
  float inv;             // compute_dx multiplies by inv = f32(1 / brange)
  int bf16;              // 1: round as the Pallas kernels' bf16 compute
  int res[MAX_LEVELS];
};

__device__ __forceinline__ float rb(float v, int on) {
  return on ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

struct Corners {
  unsigned h[8];
  float w[8];
};

// the normalised coordinate t = (x - bbox_min) / range (DX: * inv), before
// the clip
template <int MAP>
__device__ __forceinline__ float unit_of(const HashArgs& A, float x) {
  const float d = __fsub_rn(x, A.bmin);
  return MAP == DX ? __fmul_rn(d, A.inv) : __fdiv_rn(d, A.brange);
}

template <int MAP>
__device__ __forceinline__ Corners corners_of(const HashArgs& A, long long n, int l) {
  const float* p = A.x + n * 3;
  const float r = (float)A.res[l];
  unsigned b[3];
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float u = unit_of<MAP>(A, __ldg(p + a));
    u = fminf(fmaxf(u, 0.f), 1.f);
    const float s = __fmul_rn(u, r);
    const float fl = floorf(s);
    b[a] = (unsigned)fl;
    f[a] = __fsub_rn(s, fl);
  }
  Corners C;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
    C.h[c] = (((b[0] + bx) * 1u) ^ ((b[1] + by) * 2654435761u) ^ ((b[2] + bz) * 805459861u)) &
             A.mask;
    const float wx = bx ? f[0] : __fsub_rn(1.f, f[0]);
    const float wy = by ? f[1] : __fsub_rn(1.f, f[1]);
    const float wz = bz ? f[2] : __fsub_rn(1.f, f[2]);
    C.w[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
  }
  return C;
}

// F-float row of a table
template <int F>
__device__ __forceinline__ void load_row(const float* row, float (&g)[F]) {
  if constexpr (F == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
    g[0] = a.x; g[1] = a.y; g[2] = a.z; g[3] = a.w;
    g[4] = b.x; g[5] = b.y; g[6] = b.z; g[7] = b.w;
  } else if constexpr (F == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row));
    g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
  } else if constexpr (F == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(row));
    g[0] = v.x; g[1] = v.y;
  } else {
    g[0] = __ldg(row);
  }
}

// ---- the table gradient: hash_bwd_kernel --------------------------------
//
// A block works one level l over a contiguous range of points; its threads
// split the range into stretches, one a thread, each walked in the points'
// order. While consecutive points of the stretch fall in the same cell
// (ix, iy, iz), their 8 corners' F-vectors w_c * d are summed in registers
// (a run). When the next point's cell is a face neighbour, the run slides:
// the 4 corners the two cells share keep their sums, and only the other 4
// are added to dG; any other move, and the stretch's end, add all 8. A row
// is added with sm_90's vector atomics (float2 / float4 atomicAdd: one
// REDG a row for F <= 4). A point whose dout is all zero adds nothing and
// does not end a run. A warp stages its lanes' next points (x and the
// level's dout) in shared memory with coalesced loads.

constexpr int BWD_THREADS = 512;

struct BwdArgs {
  HashArgs A;
  long long block_points;  // points a block; block b takes range b / L of level b % L
};

// the cell and its fractions of a loaded point at level l, as corners_of
// computes them
__device__ __forceinline__ void cell_of(const HashArgs& A, const float (&p)[3], int l,
                                        unsigned (&b)[3], float (&f)[3]) {
  const float r = (float)A.res[l];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float u = unit_of<BODY>(A, p[a]);
    u = fminf(fmaxf(u, 0.f), 1.f);
    const float s = __fmul_rn(u, r);
    const float fl = floorf(s);
    b[a] = (unsigned)fl;
    f[a] = __fsub_rn(s, fl);
  }
}

__device__ __forceinline__ float corner_weight(const float (&f)[3], int c) {
  const float wx = (c & 1) ? f[0] : __fsub_rn(1.f, f[0]);
  const float wy = ((c >> 1) & 1) ? f[1] : __fsub_rn(1.f, f[1]);
  const float wz = ((c >> 2) & 1) ? f[2] : __fsub_rn(1.f, f[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

__device__ __forceinline__ unsigned corner_row(const HashArgs& A, const unsigned (&b)[3], int c) {
  const unsigned bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
  return (((b[0] + bx) * 1u) ^ ((b[1] + by) * 2654435761u) ^ ((b[2] + bz) * 805459861u)) & A.mask;
}

// a run's F sums added to one row of dG's level gl, a vector atomic a chunk
// of up to 4 floats
template <int F>
__device__ __forceinline__ void add_row(float* gl, unsigned row, const float (&v)[F]) {
  float* p = gl + (size_t)row * F;
  if constexpr (F == 1) {
    atomicAdd(p, v[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int k = 0; k < F; k += 4)
      atomicAdd(reinterpret_cast<float4*>(p + k), make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
  }
}

// a run's sums at its cell's 8 corner rows
template <int F>
__device__ __forceinline__ void flush_run(const HashArgs& A, const unsigned (&b)[3],
                                          const float (&acc)[8][F], float* gl) {
#pragma unroll
  for (int c = 0; c < 8; ++c) add_row<F>(gl, corner_row(A, b, c), acc[c]);
}

// the run moves from cell b to its face neighbour one step along AXIS (UP:
// +1): the 4 corners the two cells share keep their sums (renamed to the
// new cell's corners), the other 4 are added to dG, and the new cell's own
// 4 start from 0
template <int F, int AXIS, bool UP>
__device__ __forceinline__ void slide_run(const HashArgs& A, const unsigned (&b)[3],
                                          float (&acc)[8][F], float* gl) {
  constexpr int bit = 1 << AXIS;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if ((c & bit) == (UP ? 0 : bit)) {
      add_row<F>(gl, corner_row(A, b, c), acc[c]);
#pragma unroll
      for (int k = 0; k < F; ++k) {
        acc[c][k] = acc[c ^ bit][k];
        acc[c ^ bit][k] = 0.f;
      }
    }
  }
}

// the run leaves cell cur for cell b: a slide where b is a face neighbour
// of cur, else a flush of all 8 corners; false after a flush
template <int F>
__device__ __forceinline__ bool next_cell(const HashArgs& A, const unsigned (&cur)[3],
                                          const unsigned (&b)[3], float (&acc)[8][F],
                                          float* gl) {
  const int d0 = (int)(b[0] - cur[0]), d1 = (int)(b[1] - cur[1]), d2 = (int)(b[2] - cur[2]);
  if (d1 == 0 && d2 == 0 && (d0 == 1 || d0 == -1)) {
    d0 > 0 ? slide_run<F, 0, true>(A, cur, acc, gl) : slide_run<F, 0, false>(A, cur, acc, gl);
  } else if (d0 == 0 && d2 == 0 && (d1 == 1 || d1 == -1)) {
    d1 > 0 ? slide_run<F, 1, true>(A, cur, acc, gl) : slide_run<F, 1, false>(A, cur, acc, gl);
  } else if (d0 == 0 && d1 == 0 && (d2 == 1 || d2 == -1)) {
    d2 > 0 ? slide_run<F, 2, true>(A, cur, acc, gl) : slide_run<F, 2, false>(A, cur, acc, gl);
  } else {
    flush_run<F>(A, cur, acc, gl);
    return false;
  }
  return true;
}

// points a lane takes from its stretch at a time: its warp stages them
// (x and the level's dout) in shared memory with coalesced loads, in rows of
// an odd number of floats a lane, so that the lanes' reads miss each other's
// banks
__host__ __device__ constexpr int stage_points(int F) { return F <= 2 ? 8 : 16 / F; }
__host__ __device__ constexpr int stage_x(int F) { return 3 * stage_points(F) + 1; }
__host__ __device__ constexpr int stage_d(int F) { return stage_points(F) * F + 1; }
__host__ __device__ constexpr size_t stage_bytes(int F) {
  return (size_t)BWD_THREADS * (stage_x(F) + stage_d(F)) * sizeof(float);
}

// the warp's 32 stretches' points j .. j + P - 1 (lane s's stretch from
// wbase + s * per, up to n1) into registers, coalesced: x into vx, the level's
// dout into vd, each lane a share of them (0 past a stretch's end)
template <int F>
__device__ __forceinline__ void stage_load(const HashArgs& A, int l, long long wbase,
                                           long long per, long long n1, long long j,
                                           float (&vx)[3 * stage_points(F)],
                                           float (&vd)[stage_points(F) * F]) {
  constexpr int P = stage_points(F);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 3 * P; ++k) {
    const int e = k * 32 + lane, sl = e / (3 * P), o = e - sl * 3 * P;
    const long long first = wbase + sl * per + j, end = wbase + (sl + 1) * per;
    vx[k] = first + o / 3 < (end < n1 ? end : n1) ? __ldg(A.x + first * 3 + o) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < P * F; ++k) {
    const int e = k * 32 + lane, sl = e / (P * F), o = e - sl * P * F;
    const long long n = wbase + sl * per + j + o / F, end = wbase + (sl + 1) * per;
    vd[k] = n < (end < n1 ? end : n1)
                ? __ldg(A.dout + (size_t)n * A.L * F + (size_t)l * F + o % F)
                : 0.f;
  }
}

// this thread's stretch of the block's points [n0, n1) at level l, walked
// in order, its runs merged and added to dG's level gl; stage: the block's
// staging rows
template <int F>
__device__ __forceinline__ void merge_runs(const HashArgs& A, int l, long long n0, long long n1,
                                           float* gl, float* stage) {
  constexpr int P = stage_points(F), SX = stage_x(F), SD = stage_d(F);
  const int lane = threadIdx.x & 31;
  const long long per = (n1 - n0 + BWD_THREADS - 1) / BWD_THREADS;
  const long long wbase = n0 + (long long)(threadIdx.x - lane) * per;
  float* xs = stage + (threadIdx.x - lane) * SX;
  float* ds = stage + BWD_THREADS * SX + (threadIdx.x - lane) * SD;
  const long long s0 = wbase + lane * per;
  float acc[8][F];
  unsigned cur[3] = {0u, 0u, 0u};
  bool open = false;
  for (long long j = 0; j < per; j += P) {
    // every load of the warp's next points issued before any store
    float vx[3 * P], vd[P * F];
    stage_load<F>(A, l, wbase, per, n1, j, vx, vd);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 3 * P; ++k) {
      const int e = k * 32 + lane, sl = e / (3 * P);
      xs[sl * SX + e - sl * 3 * P] = vx[k];
    }
#pragma unroll
    for (int k = 0; k < P * F; ++k) {
      const int e = k * 32 + lane, sl = e / (P * F);
      ds[sl * SD + e - sl * P * F] = vd[k];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (s0 + j + i >= n1 || j + i >= per) break;
      float d[F];
      bool any = false;
#pragma unroll
      for (int k = 0; k < F; ++k) {
        d[k] = rb(ds[lane * SD + i * F + k], A.bf16);
        any |= d[k] != 0.f;
      }
      if (!any) continue;  // adds nothing (padded rows, dead samples)
      const float p[3] = {xs[lane * SX + 3 * i], xs[lane * SX + 3 * i + 1],
                          xs[lane * SX + 3 * i + 2]};
      unsigned b[3];
      float f[3];
      cell_of(A, p, l, b, f);
      if (open && (b[0] != cur[0] || b[1] != cur[1] || b[2] != cur[2])) {
        open = next_cell<F>(A, cur, b, acc, gl);
        cur[0] = b[0]; cur[1] = b[1]; cur[2] = b[2];
      }
      if (!open) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int k = 0; k < F; ++k) acc[c][k] = 0.f;
        cur[0] = b[0]; cur[1] = b[1]; cur[2] = b[2];
        open = true;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float w = rb(corner_weight(f, c), A.bf16);
#pragma unroll
        for (int k = 0; k < F; ++k) acc[c][k] = __fadd_rn(acc[c][k], __fmul_rn(w, d[k]));
      }
    }
  }
  if (open) flush_run<F>(A, cur, acc, gl);
}

template <int F>
__global__ void __launch_bounds__(BWD_THREADS) hash_bwd_kernel(const __grid_constant__ BwdArgs P) {
  extern __shared__ float stage[];  // the warps' staging rows
  const HashArgs& A = P.A;
  const int l = (int)(blockIdx.x % (unsigned)A.L);
  const long long n0 = (long long)(blockIdx.x / (unsigned)A.L) * P.block_points;
  if (n0 >= A.N) return;
  const long long n1 = n0 + P.block_points < A.N ? n0 + P.block_points : A.N;
  merge_runs<F>(A, l, n0, n1, A.out + (size_t)l * A.T * F, stage);
}

// compute_dx backward: a thread per point over every level; dG by atomics
// (fp32 products), dX [N, 3] from the re-gathered corners (see the header)
template <int F>
__global__ void __launch_bounds__(NTHREADS) hash_dx_bwd_kernel(const __grid_constant__ HashArgs A) {
  const long long n = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (n >= A.N) return;
  const float* p = A.x + n * 3;
  float t[3], u[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    t[a] = unit_of<DX>(A, __ldg(p + a));
    u[a] = fminf(fmaxf(t[a], 0.f), 1.f);
  }
  float gx = 0.f, gy = 0.f, gz = 0.f;
  for (int l = 0; l < A.L; ++l) {
    float d[F];
    const float* dp = A.dout + (size_t)n * A.L * F + (size_t)l * F;
    bool any = false;
#pragma unroll
    for (int k = 0; k < F; ++k) {
      d[k] = __ldg(dp + k);
      any |= d[k] != 0.f;
    }
    if (!any) continue;  // adds nothing to dG or dX
    const Corners C = corners_of<DX>(A, n, l);
    // the cell fractions again, for the weights' derivatives
    const float r = (float)A.res[l];
    float fr[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float s = __fmul_rn(u[a], r);
      fr[a] = __fsub_rn(s, floorf(s));
    }
    const float* tl = A.tables + (size_t)l * A.T * F;
    float* gl = A.out + (size_t)l * A.T * F;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
      float* grow = gl + (size_t)C.h[c] * F;
      float g[F];
      load_row<F>(tl + (size_t)C.h[c] * F, g);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < F; ++k) {
        atomicAdd(grow + k, __fmul_rn(C.w[c], d[k]));
        s = __fadd_rn(s, __fmul_rn(d[k], g[k]));
      }
      const float wx = bx ? fr[0] : __fsub_rn(1.f, fr[0]);
      const float wy = by ? fr[1] : __fsub_rn(1.f, fr[1]);
      const float wz = bz ? fr[2] : __fsub_rn(1.f, fr[2]);
      gx = __fadd_rn(gx, __fmul_rn(__fmul_rn(s, bx ? r : -r), __fmul_rn(wy, wz)));
      gy = __fadd_rn(gy, __fmul_rn(__fmul_rn(s, by ? r : -r), __fmul_rn(wx, wz)));
      gz = __fadd_rn(gz, __fmul_rn(__fmul_rn(s, bz ? r : -r), __fmul_rn(wx, wy)));
    }
  }
  // chain through u = clip(t, 0, 1): zero where t lies outside [0, 1]
  const float g[3] = {gx, gy, gz};
#pragma unroll
  for (int a = 0; a < 3; ++a)
    A.dx[n * 3 + a] = t[a] >= 0.f && t[a] <= 1.f ? __fmul_rn(g[a], A.inv) : 0.f;
}

// ---- the forward: hash_fwd_kernel ----------------------------------------
//
// A thread takes one point and a chunk of its levels, K = FWD_CHUNK / F of
// them from l0: the chunk's FWD_CHUNK floats are 32 bytes of the point's
// feats row, stored with two 16-byte stores (where the row's length L*F is
// a multiple of 4; else float by float), so that one thread writes each
// sector of feats whole (storing a level's F floats at a time took twice as
// long). A warp takes one chunk of 32 consecutive points, so that it works
// one level at a time over them: where points along a ray share a cell, its
// lanes' corner rows coincide. The thread normalises each coordinate once
// for its K levels and indexes with one 32-bit division by the chunk count.
// Block b takes chunk b % chunks of the FWD_THREADS points from (b /
// chunks) * FWD_THREADS, so that a block reads K levels' tables only, which
// L1 reuses along coherent rays (blocks whose warps spanned every level
// were 30% slower at a frame's chunk). The bf16 rounding is an instance of
// its own (BF16), not a branch, which cost ~25% at every batch. 32
// registers, 8 blocks an SM, no shared memory: L1 keeps all of it. What
// bounds it: the gathers' L1 and L2 traffic (with every row of a level in
// one sector it runs 1.6-2.6x faster). tools/hash_fwd_probe.py measures
// these choices.

constexpr int FWD_THREADS = 256;
constexpr int FWD_CHUNK = 8;       // floats a thread stores: a 32-byte sector
constexpr int FWD_MIN_BLOCKS = 8;  // blocks an SM: at most 32 registers a thread

struct FwdArgs {
  HashArgs A;
  unsigned chunks;  // chunks a point: ceil(L / (FWD_CHUNK / F))
};

// row h of a level's table tl (F floats), indexed as F-float vectors so
// that the address is one multiply-add off the level's base
template <int F>
__device__ __forceinline__ void table_row(const float* tl, unsigned h, float (&g)[F]) {
  if constexpr (F >= 4) {
    const float4* row = reinterpret_cast<const float4*>(tl) + (size_t)h * (F / 4);
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 v = row[q];
      g[4 * q] = v.x; g[4 * q + 1] = v.y; g[4 * q + 2] = v.z; g[4 * q + 3] = v.w;
    }
  } else if constexpr (F == 2) {
    const float2 v = reinterpret_cast<const float2*>(tl)[h];
    g[0] = v.x; g[1] = v.y;
  } else {
    g[0] = tl[h];
  }
}

// the F features of level l of the point whose clipped unit coordinates
// are u, from the level's table tl: corners_of's cell, rows and weights,
// the 8 corners summed in order
template <int F, int MAP>
__device__ __forceinline__ void level_features(const HashArgs& A, const float (&u)[3], int l,
                                               const float* tl, float* acc) {
  const float r = (float)A.res[l];
  unsigned b[3];
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s = __fmul_rn(u[a], r);
    const float fl = floorf(s);
    b[a] = (unsigned)fl;
    f[a] = __fsub_rn(s, fl);
  }
#pragma unroll
  for (int k = 0; k < F; ++k) acc[k] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float g[F];
    table_row<F>(tl, corner_row(A, b, c), g);
    const float w = corner_weight(f, c);
    if constexpr (MAP == BF16) {
      const float wb = rb(w, 1);
#pragma unroll
      for (int k = 0; k < F; ++k) acc[k] = __fadd_rn(acc[k], rb(__fmul_rn(rb(g[k], 1), wb), 1));
    } else {
#pragma unroll
      for (int k = 0; k < F; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(g[k], w));
    }
  }
}

template <int F, int MAP>
__global__ void __launch_bounds__(FWD_THREADS, FWD_MIN_BLOCKS)
    hash_fwd_kernel(const __grid_constant__ FwdArgs P) {
  constexpr int K = FWD_CHUNK / F;  // levels a chunk
  const HashArgs& A = P.A;
  const unsigned group = blockIdx.x / P.chunks;
  const long long n = (long long)group * FWD_THREADS + threadIdx.x;
  if (n >= A.N) return;
  const int L = A.L, l0 = (int)(blockIdx.x - group * P.chunks) * K;
  float u[3];  // the point's clipped unit coordinates
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t = unit_of<MAP>(A, __ldg(A.x + n * 3 + a));
    u[a] = fminf(fmaxf(t, 0.f), 1.f);
  }
  float v[FWD_CHUNK];
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (l0 + j < L)
      level_features<F, MAP>(A, u, l0 + j, A.tables + (size_t)(l0 + j) * A.T * F, v + j * F);
  float* d = A.out + n * L * F + l0 * F;
  if ((L * F) % 4 == 0 && l0 + K <= L) {
#pragma unroll
    for (int q = 0; q < FWD_CHUNK / 4; ++q)
      reinterpret_cast<float4*>(d)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                    v[4 * q + 3]);
  } else {
    const int valid = (L - l0 < K ? L - l0 : K) * F;
#pragma unroll
    for (int k = 0; k < FWD_CHUNK; ++k)
      if (k < valid) d[k] = v[k];
  }
}

template <int MAP>
int launch_fwd_map(const HashArgs& a, cudaStream_t st) {
  const int K = FWD_CHUNK / a.F;
  const unsigned chunks = (unsigned)((a.L + K - 1) / K);
  const long long blocks = (a.N + FWD_THREADS - 1) / FWD_THREADS * chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const FwdArgs P{a, chunks};
  const unsigned g = (unsigned)blocks;
  switch (a.F) {
    case 1: hash_fwd_kernel<1, MAP><<<g, FWD_THREADS, 0, st>>>(P); break;
    case 2: hash_fwd_kernel<2, MAP><<<g, FWD_THREADS, 0, st>>>(P); break;
    case 4: hash_fwd_kernel<4, MAP><<<g, FWD_THREADS, 0, st>>>(P); break;
    default: hash_fwd_kernel<8, MAP><<<g, FWD_THREADS, 0, st>>>(P); break;
  }
  return (int)cudaGetLastError();
}

// chunks x ceil(N / FWD_THREADS) blocks; feats on a 16-byte boundary. The
// levels-in-body and one-level-per-grid-step calls launch the same
// instance (the same numbers): BF16 where a.bf16 says so, else BODY.
int launch_fwd(const HashArgs& a, bool dx, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(a.out) % 16 != 0) return (int)cudaErrorInvalidValue;
  return dx ? launch_fwd_map<DX>(a, st)
            : a.bf16 ? launch_fwd_map<BF16>(a, st) : launch_fwd_map<BODY>(a, st);
}

// ---- end of the forward -------------------------------------------------

HashArgs make_args(const float* x, const float* tables, const float* dout, float* out, float* dx,
                   long long N, int L, int F, int log2_T, const int* res, float bmin,
                   float brange, float inv, int bf16) {
  HashArgs a{};
  a.x = x; a.tables = tables; a.dout = dout; a.out = out; a.dx = dx;
  a.N = N; a.L = L; a.F = F;
  a.T = 1ll << log2_T;
  a.mask = (unsigned)(a.T - 1);
  a.bmin = bmin; a.brange = brange; a.inv = inv; a.bf16 = bf16;
  for (int l = 0; l < L; ++l) a.res[l] = res[l];
  return a;
}

bool valid(long long N, int L, int F, int log2_T) {
  return N >= 0 && L >= 1 && L <= MAX_LEVELS && (F == 1 || F == 2 || F == 4 || F == 8) &&
         L * F <= MAX_CHANNELS && log2_T >= 1 && log2_T <= 31;
}

template <int F>
int launch_bwd_f(const BwdArgs& P, int ranges, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      hash_bwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)stage_bytes(F));
  if (e != cudaSuccess) return (int)e;
  hash_bwd_kernel<F><<<(unsigned)(ranges * P.A.L), BWD_THREADS, stage_bytes(F), st>>>(P);
  return (int)cudaGetLastError();
}

// the plan (ranges, block_points) comes from kernels/hash_encode.py's
// bwd_plan; it must cover the points
int launch_bwd(const HashArgs& a, int ranges, long long block_points, cudaStream_t st) {
  if (ranges < 1 || block_points < 1 || (long long)ranges * block_points < a.N ||
      (long long)ranges * a.L > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const BwdArgs P{a, block_points};
  switch (a.F) {
    case 1: return launch_bwd_f<1>(P, ranges, st);
    case 2: return launch_bwd_f<2>(P, ranges, st);
    case 4: return launch_bwd_f<4>(P, ranges, st);
    default: return launch_bwd_f<8>(P, ranges, st);
  }
}

}  // namespace

// feats [N, L*F] from points x [N, 3] and tables [L, 2^log2_T, F]; res: the
// L int32 resolutions (host array); bf16: round as the Pallas kernel's bf16
// compute; feats on a 16-byte boundary. hash_fwd_launch is the
// levels-in-body kernel, hash_fwd_grid_launch the one-level-per-grid-step
// kernel (the same numbers: one kernel). Return the first cudaError_t.
extern "C" int hash_fwd_launch(const float* x, const float* tables, float* feats, long long N,
                               int L, int F, int log2_T, const int* res, float bmin, float brange,
                               int bf16, void* stream) {
  if (!valid(N, L, F, log2_T)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return launch_fwd(make_args(x, tables, nullptr, feats, nullptr, N, L, F, log2_T, res, bmin,
                             brange, 0.f, bf16),
                    false, static_cast<cudaStream_t>(stream));
}

extern "C" int hash_fwd_grid_launch(const float* x, const float* tables, float* feats,
                                    long long N, int L, int F, int log2_T, const int* res,
                                    float bmin, float brange, int bf16, void* stream) {
  return hash_fwd_launch(x, tables, feats, N, L, F, log2_T, res, bmin, brange, bf16, stream);
}

// dG [L, 2^log2_T, F] += the scatter of dout [N, L*F]; dG must be zeroed by
// the caller. The levels-in-body and the
// one-level-per-grid-step entry points launch the same kernel (the two Pallas
// kernels give the same dG) on the plan (ranges, block_points). Return the
// first cudaError_t.
extern "C" int hash_bwd_launch(const float* x, const float* dout, float* dG, long long N, int L,
                               int F, int log2_T, const int* res, float bmin, float brange,
                               int bf16, int ranges, long long block_points, void* stream) {
  if (!valid(N, L, F, log2_T)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return launch_bwd(make_args(x, nullptr, dout, dG, nullptr, N, L, F, log2_T, res, bmin, brange,
                              0.f, bf16),
                    ranges, block_points, static_cast<cudaStream_t>(stream));
}

extern "C" int hash_bwd_grid_launch(const float* x, const float* dout, float* dG, long long N,
                                    int L, int F, int log2_T, const int* res, float bmin,
                                    float brange, int bf16, int ranges, long long block_points,
                                    void* stream) {
  return hash_bwd_launch(x, dout, dG, N, L, F, log2_T, res, bmin, brange, bf16, ranges,
                         block_points, stream);
}

// compute_dx forward: feats [N, L*F] in fp32, normalised by multiplying
// with inv. Returns the first cudaError_t.
extern "C" int hash_dx_fwd_launch(const float* x, const float* tables, float* feats, long long N,
                                  int L, int F, int log2_T, const int* res, float bmin, float inv,
                                  void* stream) {
  if (!valid(N, L, F, log2_T)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return launch_fwd(make_args(x, tables, nullptr, feats, nullptr, N, L, F, log2_T, res, bmin, 0.f,
                             inv, 0),
                    true, static_cast<cudaStream_t>(stream));
}

// compute_dx backward: dG [L, 2^log2_T, F] += the fp32 scatter of dout
// (zeroed by the caller) and dX [N, 3]. Returns the first cudaError_t.
extern "C" int hash_dx_bwd_launch(const float* x, const float* tables, const float* dout,
                                  float* dG, float* dX, long long N, int L, int F, int log2_T,
                                  const int* res, float bmin, float inv, void* stream) {
  if (!valid(N, L, F, log2_T)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const HashArgs a =
      make_args(x, tables, dout, dG, dX, N, L, F, log2_T, res, bmin, 0.f, inv, 0);
  const unsigned blocks = (unsigned)((N + NTHREADS - 1) / NTHREADS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 1: hash_dx_bwd_kernel<1><<<blocks, NTHREADS, 0, st>>>(a); break;
    case 2: hash_dx_bwd_kernel<2><<<blocks, NTHREADS, 0, st>>>(a); break;
    case 4: hash_dx_bwd_kernel<4><<<blocks, NTHREADS, 0, st>>>(a); break;
    default: hash_dx_bwd_kernel<8><<<blocks, NTHREADS, 0, st>>>(a); break;
  }
  return (int)cudaGetLastError();
}
