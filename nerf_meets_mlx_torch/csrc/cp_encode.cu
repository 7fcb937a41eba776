// CP-grid (TensoRF-style) encode and its line gradient, for Hopper (sm_90a).
//
// Replaces nerf_meets_mlx_tpu/kernels/cp_encode.py::_fwd_grid_kernel (the
// forward) and ::_bwd_grid_kernel (dLines by the product rule). Per point x
// [N,3], level l (R_l nodes a line, lines [3][R_l][C] at float offset
// off_l of one flat buffer) and axis a:
//
//   u  = clip((x_a - bbox_min) * inv_range, 0, 1),  t = u * (R_l - 1)
//   i0 = min(floor(t), R_l - 2),  w0 = 1 - |t - i0|,  w1 = 1 - |t - i0 - 1|
//   f_a[c] = w0 * line_a[i0][c] + w1 * line_a[i0 + 1][c]
//   feats[n][l*C + c] = (f_0[c] * f_1[c]) * f_2[c]
//
// the Pallas hat matrix relu(1 - |t - i|) with its two non-zero taps read
// directly (there is no [N, R] matrix). In bf16 mode the weights and the
// line values are rounded to bf16 (nearest even) before the products, which
// are then exact in fp32, and the two taps are summed in fp32: the Pallas
// kernel's bf16 GEMM with fp32 accumulation. The backward recomputes f_a and
// adds, per axis, bf16(w) * bf16(df_a), df_a = d * prod_{b != a} f_b (fp32,
// as [f1*f2, f0*f2, f0*f1]), into dLines in fp32, never rounding the sum.
// fp32 mode rounds nothing. Products and sums are rounded one by one
// (__fmul_rn / __fadd_rn), with no contraction into FMAs, as the plain
// version in kernels/cp_encode.py computes them.
//
// What bounds it on this card: device memory. A point reads 12 bytes and
// writes L*C*4 bytes (256 at lego_cp's L = 4, C = 16); the lines are 184 KB
// and stay in L1/L2. The forward is a thread per (point, level, 4
// channels): neighbouring threads write neighbouring 16-byte pieces of the
// output row. The backward reads the 256-byte cotangent instead of writing
// the features, and scatters 6 products a channel into the lines: at the
// coarse level (R = 64) 393,216 points land on 64 rows an axis, so device
// atomics would contend on a few KB. Each block therefore owns one level
// and a run of points, sums that level's 3*R_l*C dLines in shared memory
// (at most 3*512*16*4 = 96 KB at lego_cp) with shared-memory atomics, and
// flushes them with one device atomicAdd per entry. The order of the
// atomics changes from run to run, so dLines agrees with the plain version
// to rounding, not bit for bit. Faster forms (a warp per row segment, a
// sorted reduction) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_LEVELS = 16;
constexpr int BWD_POINTS = 4096;  // points a block of the backward sums
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

struct CPArgs {
  const float* x;      // [N, 3]
  const float* lines;  // flat: level l's [3][R_l][C] at offs[l]
  const float* dout;   // [N, L*C] (backward)
  float* out;          // feats [N, L*C] (forward) or the flat dLines (backward)
  long long N;
  int L, C;
  float bmin, inv;
  int bf16;
  int res[MAX_LEVELS];
  long long offs[MAX_LEVELS];
};

__device__ __forceinline__ float rb(float v, int on) {
  return on ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

struct Tap {
  int i0;
  float w0, w1;
};

// the two taps of point n on axis a at a level of r nodes
__device__ __forceinline__ Tap tap_of(const CPArgs& A, long long n, int a, int r) {
  float u = __fmul_rn(__fsub_rn(__ldg(A.x + n * 3 + a), A.bmin), A.inv);
  u = fminf(fmaxf(u, 0.f), 1.f);
  const float t = __fmul_rn(u, (float)(r - 1));
  const float i0f = fminf(floorf(t), (float)(r - 2));
  Tap T;
  T.i0 = (int)i0f;
  T.w0 = rb(fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(t, i0f))), 0.f), A.bf16);
  T.w1 = rb(fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(t, __fadd_rn(i0f, 1.f)))), 0.f), A.bf16);
  return T;
}

// f_a for channels c0..c0+3 of one axis
__device__ __forceinline__ float4 axis_value(const CPArgs& A, const float* line, const Tap& T,
                                             int c0) {
  const float4 g0 = __ldg(reinterpret_cast<const float4*>(line + (size_t)T.i0 * A.C + c0));
  const float4 g1 = __ldg(reinterpret_cast<const float4*>(line + (size_t)(T.i0 + 1) * A.C + c0));
  float4 f;
  f.x = __fadd_rn(__fmul_rn(T.w0, rb(g0.x, A.bf16)), __fmul_rn(T.w1, rb(g1.x, A.bf16)));
  f.y = __fadd_rn(__fmul_rn(T.w0, rb(g0.y, A.bf16)), __fmul_rn(T.w1, rb(g1.y, A.bf16)));
  f.z = __fadd_rn(__fmul_rn(T.w0, rb(g0.z, A.bf16)), __fmul_rn(T.w1, rb(g1.z, A.bf16)));
  f.w = __fadd_rn(__fmul_rn(T.w0, rb(g0.w, A.bf16)), __fmul_rn(T.w1, rb(g1.w, A.bf16)));
  return f;
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

// one thread per (point, level, 4 channels), the channels fastest
__global__ void __launch_bounds__(NTHREADS) cp_fwd_kernel(const __grid_constant__ CPArgs A) {
  const int C4 = A.C / 4;
  const long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (t >= A.N * A.L * C4) return;
  const int c0 = 4 * (int)(t % C4);
  const long long nl = t / C4;
  const int l = (int)(nl % A.L);
  const long long n = nl / A.L;
  const int r = A.res[l];
  const float* lv = A.lines + A.offs[l];
  float4 f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float4 fa = axis_value(A, lv + (size_t)a * r * A.C, tap_of(A, n, a, r), c0);
    f = a == 0 ? fa : mul4(f, fa);
  }
  *reinterpret_cast<float4*>(A.out + (size_t)n * A.L * A.C + (size_t)l * A.C + c0) = f;
}

__device__ __forceinline__ void scatter4(float* row, float w, float4 df) {
  atomicAdd(row + 0, __fmul_rn(w, df.x));
  atomicAdd(row + 1, __fmul_rn(w, df.y));
  atomicAdd(row + 2, __fmul_rn(w, df.z));
  atomicAdd(row + 3, __fmul_rn(w, df.w));
}

// grid (point runs of BWD_POINTS, levels): a block sums its level's dLines
// over its points in shared memory, then adds them to the device buffer
__global__ void __launch_bounds__(NTHREADS) cp_bwd_kernel(const __grid_constant__ CPArgs A) {
  extern __shared__ __align__(16) float sdl[];  // [3][R_l][C]
  const int l = blockIdx.y;
  const int r = A.res[l];
  const int C = A.C, C4 = C / 4;
  const int n_line = 3 * r * C;
  for (int i = threadIdx.x; i < n_line; i += NTHREADS) sdl[i] = 0.f;
  __syncthreads();

  const float* lv = A.lines + A.offs[l];
  const long long p0 = (long long)blockIdx.x * BWD_POINTS;
  const long long pe = min(A.N, p0 + BWD_POINTS);
  const long long items = (pe - p0) * C4;
  for (long long it = threadIdx.x; it < items; it += NTHREADS) {
    const long long n = p0 + it / C4;
    const int c0 = 4 * (int)(it % C4);
    const float4 d =
        __ldg(reinterpret_cast<const float4*>(A.dout + (size_t)n * A.L * C + (size_t)l * C + c0));
    Tap T[3];
    float4 f[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      T[a] = tap_of(A, n, a, r);
      f[a] = axis_value(A, lv + (size_t)a * r * C, T[a], c0);
    }
    const float4 others[3] = {mul4(f[1], f[2]), mul4(f[0], f[2]), mul4(f[0], f[1])};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float4 df = mul4(d, others[a]);
      df = make_float4(rb(df.x, A.bf16), rb(df.y, A.bf16), rb(df.z, A.bf16), rb(df.w, A.bf16));
      float* la = sdl + (size_t)a * r * C;
      scatter4(la + (size_t)T[a].i0 * C + c0, T[a].w0, df);
      scatter4(la + (size_t)(T[a].i0 + 1) * C + c0, T[a].w1, df);
    }
  }
  __syncthreads();
  float* g = A.out + A.offs[l];
  for (int i = threadIdx.x; i < n_line; i += NTHREADS) {
    const float v = sdl[i];
    if (v != 0.f) atomicAdd(g + i, v);
  }
}

CPArgs make_args(const float* x, const float* lines, const float* dout, float* out, long long N,
                 int L, int C, const int* res, const long long* offs, float bmin, float inv,
                 int bf16) {
  CPArgs a{};
  a.x = x; a.lines = lines; a.dout = dout; a.out = out;
  a.N = N; a.L = L; a.C = C;
  a.bmin = bmin; a.inv = inv; a.bf16 = bf16;
  for (int l = 0; l < L; ++l) {
    a.res[l] = res[l];
    a.offs[l] = offs[l];
  }
  return a;
}

bool valid(long long N, int L, int C, const int* res) {
  if (N < 0 || L < 1 || L > MAX_LEVELS || C < 4 || C > 64 || (C & 3)) return false;
  for (int l = 0; l < L; ++l)
    if (res[l] < 2 || (size_t)3 * res[l] * C * sizeof(float) > (size_t)MAX_SMEM) return false;
  return true;
}

}  // namespace

// feats [N, L*C] from points x [N, 3] and the flat lines; res: the L int32
// resolutions, offs: the L float offsets of the levels' lines (host
// arrays); bf16: round as the Pallas kernel's bf16 compute. Returns the
// first cudaError_t.
extern "C" int cp_fwd_launch(const float* x, const float* lines, float* feats, long long N, int L,
                             int C, const int* res, const long long* offs, float bmin, float inv,
                             int bf16, void* stream) {
  if (!valid(N, L, C, res)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const CPArgs a = make_args(x, lines, nullptr, feats, N, L, C, res, offs, bmin, inv, bf16);
  const long long threads = N * L * (C / 4);
  const unsigned blocks = (unsigned)((threads + NTHREADS - 1) / NTHREADS);
  cp_fwd_kernel<<<blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// dLines (flat, the lines' layout; zeroed by the caller) += the line
// gradient of sum(dout * feats), dout [N, L*C]. Returns the first
// cudaError_t.
extern "C" int cp_bwd_launch(const float* x, const float* lines, const float* dout, float* dlines,
                             long long N, int L, int C, const int* res, const long long* offs,
                             float bmin, float inv, int bf16, void* stream) {
  if (!valid(N, L, C, res)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const CPArgs a = make_args(x, lines, dout, dlines, N, L, C, res, offs, bmin, inv, bf16);
  int r_max = 0;
  for (int l = 0; l < L; ++l) r_max = res[l] > r_max ? res[l] : r_max;
  const int smem = (int)(3 * (size_t)r_max * C * sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(cp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + BWD_POINTS - 1) / BWD_POINTS), (unsigned)L);
  cp_bwd_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
