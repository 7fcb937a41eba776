// Multiresolution hash-grid encode and its gradients, for Hopper (sm_90a).
//
// Replaces six kernels of nerf_meets_mlx_tpu/kernels/hash_encode.py:
//
//   hash_fwd_kernel<F, BODY>      ::_fwd_body_kernel (the forward, all
//                                 levels in one body)
//   hash_bwd_kernel<F, BODY>      ::_bwd_body_kernel (the scatter-add of the
//                                 cotangent into the tables)
//   hash_fwd_kernel<F, GRID>      ::_fwd_grid_kernel (levels_in_body=False:
//   hash_bwd_kernel<F, GRID>      ::_bwd_grid_kernel  one level per grid step)
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
// What bounds it on this card: the gathers. A point reads 8 corners x L
// levels table rows of F floats at hashed (random) rows, 64 lookups at the
// lego_ingp shape (L = 8, F = 2: one 8-byte float2 each); the tables are
// L*T*F*4 = 1 MB and stay in the 50 MB L2, so the lookups are L2 hits and
// the kernel is bound by L2 transactions (one 32-byte sector per lookup),
// not by device memory. The bytes it must move are the points in and the
// features out (and the tables once): 12 + 4*L*F bytes a point.
//
// Design: one thread per (point, level). BODY: the level fastest, so that a
// warp's threads write neighbouring features and share their points'
// loads. GRID: the launch grid runs over (point block, level), so a block
// touches one level's table only, as the Pallas grid (L, nblocks) does;
// its numbers are the body kernels' (the same roundings, in both compute
// types), and it writes feats [N, L*F] in place, where the Pallas kernel
// writes [L, N, F] and transposes. Staging a level's table in shared
// memory (128 KB at lego_ingp's 2^14 x 2) is later work: a 256-point block
// makes 2,048 lookups, a sixteenth of the table's rows. The resolutions
// come from the host as the int32 values of _level_resolutions. The
// backward uses atomicAdd into a dG that the
// wrapper zeroes: on the coarse levels (16^3 .. 35^3 cells) hundreds of
// thousands of points land on a few thousand rows, so those atomics contend
// and their order changes from run to run (dG agrees with the plain
// version's scatter-add to rounding, not bit for bit). A segmented
// reduction in place of the contended atomics is later work.
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
enum Map { BODY = 0, GRID = 1, DX = 2 };

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

// the (point, level) of this thread; false past the last point
template <int MAP>
__device__ __forceinline__ bool item_of(const HashArgs& A, long long& n, int& l) {
  if (MAP == GRID) {
    l = blockIdx.y;
    n = (long long)blockIdx.x * NTHREADS + threadIdx.x;
    return n < A.N;
  }
  const long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  n = t / A.L;
  l = (int)(t - n * A.L);
  return t < A.N * A.L;
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

template <int F, int MAP>
__global__ void __launch_bounds__(NTHREADS) hash_fwd_kernel(const __grid_constant__ HashArgs A) {
  long long n;
  int l;
  if (!item_of<MAP>(A, n, l)) return;
  const Corners C = corners_of<MAP>(A, n, l);
  const float* tl = A.tables + (size_t)l * A.T * F;
  float acc[F];
#pragma unroll
  for (int k = 0; k < F; ++k) acc[k] = 0.f;
  if (MAP != DX && A.bf16) {
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
      float g[F];
      load_row<F>(tl + (size_t)C.h[c] * F, g);
#pragma unroll
      for (int k = 0; k < F; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(g[k], C.w[c]));
    }
  }
  float* o = A.out + (size_t)n * A.L * F + (size_t)l * F;
#pragma unroll
  for (int k = 0; k < F; ++k) o[k] = acc[k];
}

template <int F, int MAP>
__global__ void __launch_bounds__(NTHREADS) hash_bwd_kernel(const __grid_constant__ HashArgs A) {
  long long n;
  int l;
  if (!item_of<MAP>(A, n, l)) return;
  float d[F];
  const float* dp = A.dout + (size_t)n * A.L * F + (size_t)l * F;
#pragma unroll
  for (int k = 0; k < F; ++k) d[k] = rb(__ldg(dp + k), A.bf16);
  bool any = false;
#pragma unroll
  for (int k = 0; k < F; ++k) any |= d[k] != 0.f;
  if (!any) return;  // adds nothing (padded rows, dead samples)
  const Corners C = corners_of<MAP>(A, n, l);
  float* gl = A.out + (size_t)l * A.T * F;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float* row = gl + (size_t)C.h[c] * F;
#pragma unroll
    for (int k = 0; k < F; ++k) atomicAdd(row + k, __fmul_rn(rb(C.w[c], A.bf16), d[k]));
  }
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

// a thread per (point, level): blocks over N*L (BODY, DX) or (N, L) (GRID)
dim3 grid_of(int map, long long N, int L) {
  if (map == GRID) return dim3((unsigned)((N + NTHREADS - 1) / NTHREADS), (unsigned)L);
  return dim3((unsigned)((N * L + NTHREADS - 1) / NTHREADS));
}

template <int MAP>
int launch_fwd(const HashArgs& a, cudaStream_t st) {
  const dim3 g = grid_of(MAP, a.N, a.L);
  switch (a.F) {
    case 1: hash_fwd_kernel<1, MAP><<<g, NTHREADS, 0, st>>>(a); break;
    case 2: hash_fwd_kernel<2, MAP><<<g, NTHREADS, 0, st>>>(a); break;
    case 4: hash_fwd_kernel<4, MAP><<<g, NTHREADS, 0, st>>>(a); break;
    default: hash_fwd_kernel<8, MAP><<<g, NTHREADS, 0, st>>>(a); break;
  }
  return (int)cudaGetLastError();
}

template <int MAP>
int launch_bwd(const HashArgs& a, cudaStream_t st) {
  const dim3 g = grid_of(MAP, a.N, a.L);
  switch (a.F) {
    case 1: hash_bwd_kernel<1, MAP><<<g, NTHREADS, 0, st>>>(a); break;
    case 2: hash_bwd_kernel<2, MAP><<<g, NTHREADS, 0, st>>>(a); break;
    case 4: hash_bwd_kernel<4, MAP><<<g, NTHREADS, 0, st>>>(a); break;
    default: hash_bwd_kernel<8, MAP><<<g, NTHREADS, 0, st>>>(a); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// feats [N, L*F] from points x [N, 3] and tables [L, 2^log2_T, F]; res: the
// L int32 resolutions (host array); bf16: round as the Pallas kernel's bf16
// compute. hash_fwd_launch is the levels-in-body kernel, hash_fwd_grid_launch
// the one-level-per-grid-step kernel (the same numbers). Return the first
// cudaError_t.
extern "C" int hash_fwd_launch(const float* x, const float* tables, float* feats, long long N,
                               int L, int F, int log2_T, const int* res, float bmin, float brange,
                               int bf16, void* stream) {
  if (!valid(N, L, F, log2_T)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return launch_fwd<BODY>(make_args(x, tables, nullptr, feats, nullptr, N, L, F, log2_T, res,
                                    bmin, brange, 0.f, bf16),
                          static_cast<cudaStream_t>(stream));
}

extern "C" int hash_fwd_grid_launch(const float* x, const float* tables, float* feats,
                                    long long N, int L, int F, int log2_T, const int* res,
                                    float bmin, float brange, int bf16, void* stream) {
  if (!valid(N, L, F, log2_T)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return launch_fwd<GRID>(make_args(x, tables, nullptr, feats, nullptr, N, L, F, log2_T, res,
                                    bmin, brange, 0.f, bf16),
                          static_cast<cudaStream_t>(stream));
}

// dG [L, 2^log2_T, F] += the scatter of dout [N, L*F]; dG must be zeroed by
// the caller. The levels-in-body and the one-level-per-grid-step kernels.
// Return the first cudaError_t.
extern "C" int hash_bwd_launch(const float* x, const float* dout, float* dG, long long N, int L,
                               int F, int log2_T, const int* res, float bmin, float brange,
                               int bf16, void* stream) {
  if (!valid(N, L, F, log2_T)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return launch_bwd<BODY>(make_args(x, nullptr, dout, dG, nullptr, N, L, F, log2_T, res, bmin,
                                    brange, 0.f, bf16),
                          static_cast<cudaStream_t>(stream));
}

extern "C" int hash_bwd_grid_launch(const float* x, const float* dout, float* dG, long long N,
                                    int L, int F, int log2_T, const int* res, float bmin,
                                    float brange, int bf16, void* stream) {
  if (!valid(N, L, F, log2_T)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return launch_bwd<GRID>(make_args(x, nullptr, dout, dG, nullptr, N, L, F, log2_T, res, bmin,
                                    brange, 0.f, bf16),
                          static_cast<cudaStream_t>(stream));
}

// compute_dx forward: feats [N, L*F] in fp32, normalised by multiplying
// with inv. Returns the first cudaError_t.
extern "C" int hash_dx_fwd_launch(const float* x, const float* tables, float* feats, long long N,
                                  int L, int F, int log2_T, const int* res, float bmin, float inv,
                                  void* stream) {
  if (!valid(N, L, F, log2_T)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  return launch_fwd<DX>(make_args(x, tables, nullptr, feats, nullptr, N, L, F, log2_T, res, bmin,
                                  0.f, inv, 0),
                        static_cast<cudaStream_t>(stream));
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
