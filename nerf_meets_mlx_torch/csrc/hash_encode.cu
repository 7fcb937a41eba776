// Multiresolution hash-grid encode and its table gradient, for Hopper (sm_90a).
//
// Replaces nerf_meets_mlx_tpu/kernels/hash_encode.py::_fwd_body_kernel (the
// forward, all levels in one body) and ::_bwd_body_kernel (the scatter-add
// of the cotangent into the tables). Per point x [N,3] and level l:
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
// What bounds it on this card: the gathers. A point reads 8 corners x L
// levels table rows of F floats at hashed (random) rows, 64 lookups at the
// lego_ingp shape (L = 8, F = 2: one 8-byte float2 each); the tables are
// L*T*F*4 = 1 MB and stay in the 50 MB L2, so the lookups are L2 hits and
// the kernel is bound by L2 transactions (one 32-byte sector per lookup),
// not by device memory. The bytes it must move are the points in and the
// features out (and the tables once): 12 + 4*L*F bytes a point.
//
// Design: one thread per (point, level), the level fastest, so that a warp's
// threads write neighbouring features and share their points' loads. The
// resolutions come from the host as the int32 values of
// _level_resolutions. The backward uses atomicAdd into a dG that the
// wrapper zeroes: on the coarse levels (16^3 .. 35^3 cells) hundreds of
// thousands of points land on a few thousand rows, so those atomics contend
// and their order changes from run to run (dG agrees with the plain
// version's scatter-add to rounding, not bit for bit). Staging a level's
// 128 KB table in shared memory, and a segmented reduction in place of the
// contended atomics, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_LEVELS = 32;

struct HashArgs {
  const float* x;        // [N, 3]
  const float* tables;   // [L, T, F]
  const float* dout;     // [N, L*F] (backward)
  float* out;            // feats [N, L*F] (forward) or dG [L, T, F] (backward)
  long long N;
  int L, F;
  unsigned mask;         // T - 1
  long long T;
  float bmin, brange;
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

__device__ __forceinline__ Corners corners_of(const HashArgs& A, long long n, int l) {
  const float* p = A.x + n * 3;
  const float r = (float)A.res[l];
  unsigned b[3];
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float u = __fdiv_rn(__fsub_rn(__ldg(p + a), A.bmin), A.brange);
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

template <int F>
__global__ void __launch_bounds__(NTHREADS) hash_fwd_kernel(const __grid_constant__ HashArgs A) {
  const long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (t >= A.N * A.L) return;
  const long long n = t / A.L;
  const int l = (int)(t - n * A.L);
  const Corners C = corners_of(A, n, l);
  const float* tl = A.tables + (size_t)l * A.T * F;
  float acc[F];
#pragma unroll
  for (int k = 0; k < F; ++k) acc[k] = 0.f;
  if (A.bf16) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float* row = tl + (size_t)C.h[c] * F;
      const float w = rb(C.w[c], 1);
#pragma unroll
      for (int k = 0; k < F; ++k)
        acc[k] = __fadd_rn(acc[k], rb(__fmul_rn(rb(__ldg(row + k), 1), w), 1));
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float* row = tl + (size_t)C.h[c] * F;
      if constexpr (F == 2) {
        const float2 g = __ldg(reinterpret_cast<const float2*>(row));
        acc[0] = __fadd_rn(acc[0], __fmul_rn(g.x, C.w[c]));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(g.y, C.w[c]));
      } else {
#pragma unroll
        for (int k = 0; k < F; ++k)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(__ldg(row + k), C.w[c]));
      }
    }
  }
  float* o = A.out + (size_t)n * A.L * F + (size_t)l * F;
#pragma unroll
  for (int k = 0; k < F; ++k) o[k] = acc[k];
}

template <int F>
__global__ void __launch_bounds__(NTHREADS) hash_bwd_kernel(const __grid_constant__ HashArgs A) {
  const long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (t >= A.N * A.L) return;
  const long long n = t / A.L;
  const int l = (int)(t - n * A.L);
  float d[F];
  const float* dp = A.dout + (size_t)n * A.L * F + (size_t)l * F;
#pragma unroll
  for (int k = 0; k < F; ++k) d[k] = rb(__ldg(dp + k), A.bf16);
  bool any = false;
#pragma unroll
  for (int k = 0; k < F; ++k) any |= d[k] != 0.f;
  if (!any) return;  // adds nothing (padded rows, dead samples)
  const Corners C = corners_of(A, n, l);
  float* gl = A.out + (size_t)l * A.T * F;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float* row = gl + (size_t)C.h[c] * F;
#pragma unroll
    for (int k = 0; k < F; ++k) atomicAdd(row + k, __fmul_rn(rb(C.w[c], A.bf16), d[k]));
  }
}

HashArgs make_args(const float* x, const float* tables, const float* dout, float* out, long long N,
                   int L, int F, int log2_T, const int* res, float bmin, float brange, int bf16) {
  HashArgs a{};
  a.x = x; a.tables = tables; a.dout = dout; a.out = out;
  a.N = N; a.L = L; a.F = F;
  a.T = 1ll << log2_T;
  a.mask = (unsigned)(a.T - 1);
  a.bmin = bmin; a.brange = brange; a.bf16 = bf16;
  for (int l = 0; l < L; ++l) a.res[l] = res[l];
  return a;
}

bool valid(long long N, int L, int F, int log2_T) {
  return N >= 0 && L >= 1 && L <= MAX_LEVELS && (F == 1 || F == 2 || F == 4) && log2_T >= 1 &&
         log2_T <= 31;
}

}  // namespace

// feats [N, L*F] from points x [N, 3] and tables [L, 2^log2_T, F]; res: the
// L int32 resolutions (host array); bf16: round as the Pallas kernel's bf16
// compute. Returns the first cudaError_t.
extern "C" int hash_fwd_launch(const float* x, const float* tables, float* feats, long long N,
                               int L, int F, int log2_T, const int* res, float bmin, float brange,
                               int bf16, void* stream) {
  if (!valid(N, L, F, log2_T)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const HashArgs a =
      make_args(x, tables, nullptr, feats, N, L, F, log2_T, res, bmin, brange, bf16);
  const long long threads = N * L;
  const unsigned blocks = (unsigned)((threads + NTHREADS - 1) / NTHREADS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F == 1) hash_fwd_kernel<1><<<blocks, NTHREADS, 0, st>>>(a);
  else if (F == 2) hash_fwd_kernel<2><<<blocks, NTHREADS, 0, st>>>(a);
  else hash_fwd_kernel<4><<<blocks, NTHREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// dG [L, 2^log2_T, F] += the scatter of dout [N, L*F]; dG must be zeroed by
// the caller. Returns the first cudaError_t.
extern "C" int hash_bwd_launch(const float* x, const float* dout, float* dG, long long N, int L,
                               int F, int log2_T, const int* res, float bmin, float brange,
                               int bf16, void* stream) {
  if (!valid(N, L, F, log2_T)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const HashArgs a = make_args(x, nullptr, dout, dG, N, L, F, log2_T, res, bmin, brange, bf16);
  const long long threads = N * L;
  const unsigned blocks = (unsigned)((threads + NTHREADS - 1) / NTHREADS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (F == 1) hash_bwd_kernel<1><<<blocks, NTHREADS, 0, st>>>(a);
  else if (F == 2) hash_bwd_kernel<2><<<blocks, NTHREADS, 0, st>>>(a);
  else hash_bwd_kernel<4><<<blocks, NTHREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
