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
// version in kernels/cp_encode.py computes them. The bf16 rounding is a
// compile-time instance of each kernel (BF16), not a branch in its loop.
//
// What bounds them on this card: device memory in principle. A point reads
// 12 bytes and writes L*C*4 bytes of features (256 at lego_cp's L = 4, C =
// 16), or reads as many of the cotangent; the lines (184 KB at lego_cp) stay
// on chip. In practice the lanes' arithmetic and, in the backward, the row
// atomics (tools/cp_probe.py, PERF.md).
//
// The forward (cp_fwd_kernel): a block of 1024 threads walks the points, a
// group of GW lanes (C/4 rounded up to a power of two) a (point, level), a
// lane 4 channels: it computes its three taps, gathers its 16 bytes of the
// 6 line rows and stores its float4 of the point's row, so that a warp's
// store covers whole sectors (512 contiguous bytes at lego_cp). Where the
// lines fit in a block's shared memory (STAGED) they are staged there once
// a block, bf16-rounded in bf16 mode, and a block runs on each SM; else
// they are read through L1, two blocks an SM (fwd_plan). There is no
// 64-bit division.
//
// The backward (cp_bwd_kernel): one scalar atomic a term would be 96 a
// (point, level) at C = 16, and on the coarse lines (64 rows an axis) they
// contend. But the points come in rays ([rays, samples] flattened), and a
// ray's coordinate on an axis is monotone in its depth, so consecutive
// points of a ray touch the same rows of a line, or the next ones, until
// they leave them for good. So a lane group walks a stretch of 16-64
// consecutive points in order, one group a level, a lane 4 channels (the
// lanes of a warp: stretches x levels x quads, so that its loads of the
// cotangent cover whole rows), and for each axis the lane keeps the sums of
// the two open rows (i0 and i0 + 1) in registers. A point adds its w0 *
// df_a and w1 * df_a to them; when its taps move one row on, the row it
// left is added to dLines and the other is carried; any other move adds
// both. A row is added with one vector atomic (red.global.add.v4.f32) of
// the lane's 4 channels, the group's 4 lanes covering 64 contiguous bytes,
// and only where its sum is not 0, so the device atomics scale with the
// rows a stretch touched, not with 3*R*C. Stretches are as short as fill
// two blocks an SM (bwd_plan), since a lane's walk is a chain of dependent
// work. The caller zeroes dLines. Only the grouping of the fp32 sums
// differs from the plain scatter-add, and the atomics' order changes from
// run to run, so dLines agrees with the plain version to rounding, not bit
// for bit. The parent's form (a block summing its level's 3*R*C dLines with
// shared-memory float atomics, a compare-and-swap loop on sm_90, then
// flushing them all), a warp-private copy of the level in shared memory
// with lanes owning (tap, channel) entries, long stretches walked by few
// warps, and two quads a lane were measured against it (PERF.md). There
// is no shared memory, so no bound on R but the one of fp32 node indices
// (MAX_NODES).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int MAX_SMEM = 232448;        // bytes a block may use on sm_90
constexpr int BWD_THREADS = 256;
constexpr int BWD_MIN_BLOCKS = 2;       // blocks an SM the backward is built for
constexpr int BWD_MIN_STRETCH = 16;     // points a lane group walks: at least,
constexpr int BWD_MAX_STRETCH = 64;     // and at most
constexpr long long MAX_NODES = 1 << 24;  // node indices exact in fp32

struct CPArgs {
  const float* x;      // [N, 3]
  const float* lines;  // flat: level l's [3][R_l][C] at offs[l]
  const float* dout;   // [N, L*C] (backward)
  float* out;          // feats [N, L*C] (forward) or the flat dLines (backward)
  long long N;
  int L, C;
  float bmin, inv;
  int res[MAX_LEVELS];
  long long offs[MAX_LEVELS];
};

template <bool BF16>
__device__ __forceinline__ float rb(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <bool BF16>
__device__ __forceinline__ float4 rb4(float4 v) {
  return make_float4(rb<BF16>(v.x), rb<BF16>(v.y), rb<BF16>(v.z), rb<BF16>(v.w));
}

struct Tap {
  int i0;
  float w0, w1;
};

// the two taps of coordinate xa on a line of r nodes
template <bool BF16>
__device__ __forceinline__ Tap tap_of(const CPArgs& A, float xa, int r) {
  float u = __fmul_rn(__fsub_rn(xa, A.bmin), A.inv);
  u = fminf(fmaxf(u, 0.f), 1.f);
  const float t = __fmul_rn(u, (float)(r - 1));
  const float i0f = fminf(floorf(t), (float)(r - 2));
  Tap T;
  T.i0 = (int)i0f;
  T.w0 = rb<BF16>(fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(t, i0f))), 0.f));
  T.w1 = rb<BF16>(fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn(t, __fadd_rn(i0f, 1.f)))), 0.f));
  return T;
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

// f_a for 4 channels from the taps' two rows (bf16-rounded where BF16)
__device__ __forceinline__ float4 interp(const Tap& T, float4 g0, float4 g1) {
  return make_float4(__fadd_rn(__fmul_rn(T.w0, g0.x), __fmul_rn(T.w1, g1.x)),
                     __fadd_rn(__fmul_rn(T.w0, g0.y), __fmul_rn(T.w1, g1.y)),
                     __fadd_rn(__fmul_rn(T.w0, g0.z), __fmul_rn(T.w1, g1.z)),
                     __fadd_rn(__fmul_rn(T.w0, g0.w), __fmul_rn(T.w1, g1.w)));
}

// GW: lanes a (point, level) in the forward and a (stretch, level) in the
// backward, C/4 rounded up to a power of two
__host__ __device__ constexpr int group_width(int C) {
  return C <= 4 ? 1 : C <= 8 ? 2 : C <= 16 ? 4 : C <= 32 ? 8 : 16;
}

__host__ __device__ constexpr int log2_of(int v) {
  return v <= 1 ? 0 : 1 + log2_of(v / 2);
}

int sm_count() {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  return n_sm;
}

// ---- the forward: cp_fwd_kernel -------------------------------------------
//
// A block of FWD_THREADS walks the points: thread t takes point t / (L*GW)
// of each of its turns' FWD_THREADS / (L*GW) points, level (t / GW) % L,
// channels 4 * (t % GW); lanes past C/4 have none.
// STAGED: the lines (bf16-rounded where BF16) are staged in shared memory
// once a block, where they fit; else they are read through L1.

constexpr int FWD_THREADS = 1024;

template <bool BF16, bool STAGED>
__global__ void __launch_bounds__(FWD_THREADS) cp_fwd_kernel(const __grid_constant__ CPArgs A,
                                                             int block_points, int quads) {
  extern __shared__ float4 staged[];
  if constexpr (STAGED) {
    for (int i = threadIdx.x; i < quads; i += FWD_THREADS)
      staged[i] = rb4<BF16>(__ldg(reinterpret_cast<const float4*>(A.lines) + i));
    __syncthreads();
  }
  const int gw = group_width(A.C), lg = log2_of(gw), slots = A.L << lg;
  const int p = (int)threadIdx.x / slots;
  if (p >= block_points) return;
  const int s = (int)threadIdx.x - p * slots, l = s >> lg, q = s & (gw - 1);
  const int r = A.res[l], C = A.C;
  if (4 * q >= C) return;  // a lane of no channels
  const size_t off = (size_t)A.offs[l] + 4 * q;
  const float* lv = STAGED ? reinterpret_cast<const float*>(staged) + off : A.lines + off;
  const long long step = (long long)gridDim.x * block_points;
  for (long long n = (long long)blockIdx.x * block_points + p; n < A.N; n += step) {
    Tap T[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) T[a] = tap_of<BF16>(A, __ldg(A.x + n * 3 + a), r);
    float4 f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float* row = lv + ((size_t)a * r + T[a].i0) * C;
      float4 g0, g1;
      if constexpr (STAGED) {
        g0 = *reinterpret_cast<const float4*>(row);
        g1 = *reinterpret_cast<const float4*>(row + C);
      } else {
        g0 = rb4<BF16>(__ldg(reinterpret_cast<const float4*>(row)));
        g1 = rb4<BF16>(__ldg(reinterpret_cast<const float4*>(row + C)));
      }
      const float4 fa = interp(T[a], g0, g1);
      f = a == 0 ? fa : mul4(f, fa);
    }
    *reinterpret_cast<float4*>(A.out + (size_t)n * A.L * C + (size_t)l * C + 4 * q) = f;
  }
}

// the forward's grid: blocks of FWD_THREADS, each block_points points a
// turn; staged where the lines fit in a block's shared memory (smem bytes),
// then a block an SM, else two (as kernels/cp_encode.py's fwd_plan)
struct FwdPlan {
  int staged, block_points;
  long long smem, blocks;
};

FwdPlan fwd_plan(long long N, int L, int C, long long line_floats, int n_sm) {
  FwdPlan P;
  P.block_points = FWD_THREADS / (L * group_width(C));
  P.staged = line_floats * (long long)sizeof(float) <= MAX_SMEM;
  P.smem = P.staged ? line_floats * (long long)sizeof(float) : 0;
  const long long want = P.staged ? n_sm : 2LL * n_sm;
  const long long most = (N + P.block_points - 1) / P.block_points;
  P.blocks = want < most ? want : most;
  if (P.blocks < 1) P.blocks = 1;
  return P;
}

long long line_floats(const CPArgs& a) {
  return a.offs[a.L - 1] + 3LL * a.res[a.L - 1] * a.C;
}

template <bool BF16>
int launch_fwd(const CPArgs& a, cudaStream_t st) {
  const long long floats = line_floats(a);
  const FwdPlan P = fwd_plan(a.N, a.L, a.C, floats, sm_count());
  if (P.staged) {
    const cudaError_t err = cudaFuncSetAttribute(
        cp_fwd_kernel<BF16, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.smem);
    if (err != cudaSuccess) return (int)err;
    cp_fwd_kernel<BF16, true><<<(unsigned)P.blocks, FWD_THREADS, (size_t)P.smem, st>>>(
        a, P.block_points, (int)(floats / 4));
  } else {
    cp_fwd_kernel<BF16, false><<<(unsigned)P.blocks, FWD_THREADS, 0, st>>>(a, P.block_points, 0);
  }
  return (int)cudaGetLastError();
}
// ---- end of the forward

// ---- the line gradient: cp_bwd_kernel -------------------------------------

struct BwdPlan {
  long long block_points;  // points a block; block b takes range b at every level
  long long stretch;       // points a lane group walks
};

// the backward's grid: a block a range of block_points points at every
// level, its BWD_THREADS / (L * GW) lane-group rows each a stretch of it;
// stretches of BWD_MIN_STRETCH .. BWD_MAX_STRETCH points, as short as fill
// BWD_MIN_BLOCKS blocks an SM once (as kernels/cp_encode.py's bwd_plan)
BwdPlan bwd_plan(long long N, int L, int C, int n_sm, long long* ranges) {
  const long long stretches = BWD_THREADS / (L * group_width(C));
  const long long fill = (long long)n_sm * BWD_MIN_BLOCKS * stretches;
  long long stretch = (N + fill - 1) / fill;
  stretch = stretch < BWD_MIN_STRETCH ? BWD_MIN_STRETCH
                                      : stretch > BWD_MAX_STRETCH ? BWD_MAX_STRETCH : stretch;
  *ranges = (N + stretches * stretch - 1) / (stretches * stretch);
  if (*ranges < 1) *ranges = 1;
  BwdPlan P;
  P.block_points = stretches * stretch;
  P.stretch = stretch;
  return P;
}

// a row's 4 channels added to dLines, unless they are all 0
__device__ __forceinline__ void add_row(float* row, float4 v) {
  if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
    atomicAdd(reinterpret_cast<float4*>(row), v);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 scale4(float w, float4 v) {
  return make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y), __fmul_rn(w, v.z), __fmul_rn(w, v.w));
}

// thread t of a block: stretch t / (L*GW) of the block's range, level
// (t / GW) % L, channels 4 * (t % GW), so that a warp's loads of the
// cotangent cover whole rows of it
template <bool BF16>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
    cp_bwd_kernel(const __grid_constant__ CPArgs A, const BwdPlan P) {
  const int gw = group_width(A.C), lg = log2_of(gw), slots = A.L << lg, C = A.C;
  const int g = (int)threadIdx.x / slots;
  const int sl = (int)threadIdx.x - g * slots, l = sl >> lg, q = sl & (gw - 1);
  if (g >= BWD_THREADS / slots || 4 * q >= C) return;  // a lane of no channels
  const long long s0 = (long long)blockIdx.x * P.block_points + g * P.stretch;
  const long long s1 = s0 + P.stretch < A.N ? s0 + P.stretch : A.N;
  if (s0 >= s1) return;
  const int r = A.res[l];
  const float* lv = A.lines + A.offs[l] + 4 * q;
  float* gl = A.out + A.offs[l] + 4 * q;
  const float4* dp = reinterpret_cast<const float4*>(A.dout + (size_t)l * C + 4 * q);
  const size_t row_quads = (size_t)A.L * C / 4;
  int open[3] = {-2, -2, -2};  // the open rows i0 (i0 + 1) of each axis
  float4 acc0[3], acc1[3];     // their sums
#pragma unroll
  for (int a = 0; a < 3; ++a) acc0[a] = acc1[a] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long n = s0; n < s1; ++n) {
    const float4 d = __ldg(dp + n * row_quads);
    Tap T[3];
    float4 f[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      T[a] = tap_of<BF16>(A, __ldg(A.x + n * 3 + a), r);
      const float4* row = reinterpret_cast<const float4*>(lv + ((size_t)a * r + T[a].i0) * C);
      f[a] = interp(T[a], rb4<BF16>(__ldg(row)), rb4<BF16>(__ldg(row + C / 4)));
    }
    const float4 others[3] = {mul4(f[1], f[2]), mul4(f[0], f[2]), mul4(f[0], f[1])};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float4 df = rb4<BF16>(mul4(d, others[a]));
      const int mv = T[a].i0 - open[a];
      if (mv != 0) {
        // the rows left are added to dLines; a one-row move carries the
        // shared row's sum
        float* la = gl + (size_t)a * r * C;
        if (open[a] >= 0) {
          if (mv != -1) add_row(la + (size_t)open[a] * C, acc0[a]);
          if (mv != 1) add_row(la + (size_t)(open[a] + 1) * C, acc1[a]);
        }
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f), kept0 = acc0[a], kept1 = acc1[a];
        acc0[a] = mv == 1 ? kept1 : zero;
        acc1[a] = mv == -1 ? kept0 : zero;
        open[a] = T[a].i0;
      }
      acc0[a] = add4(acc0[a], scale4(T[a].w0, df));
      acc1[a] = add4(acc1[a], scale4(T[a].w1, df));
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float* la = gl + (size_t)a * r * C;
    add_row(la + (size_t)open[a] * C, acc0[a]);
    add_row(la + (size_t)(open[a] + 1) * C, acc1[a]);
  }
}

template <bool BF16>
int launch_bwd(const CPArgs& a, const BwdPlan& P, long long ranges, cudaStream_t st) {
  cp_bwd_kernel<BF16><<<(unsigned)ranges, BWD_THREADS, 0, st>>>(a, P);
  return (int)cudaGetLastError();
}
// ---- end of the backward

CPArgs make_args(const float* x, const float* lines, const float* dout, float* out, long long N,
                 int L, int C, const int* res, const long long* offs, float bmin, float inv) {
  CPArgs a{};
  a.x = x; a.lines = lines; a.dout = dout; a.out = out;
  a.N = N; a.L = L; a.C = C;
  a.bmin = bmin; a.inv = inv;
  for (int l = 0; l < L; ++l) {
    a.res[l] = res[l];
    a.offs[l] = offs[l];
  }
  return a;
}

bool valid(long long N, int L, int C, const int* res) {
  if (N < 0 || L < 1 || L > MAX_LEVELS || C < 4 || C > 64 || (C & 3)) return false;
  for (int l = 0; l < L; ++l)
    if (res[l] < 2 || res[l] > MAX_NODES) return false;
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
  const CPArgs a = make_args(x, lines, nullptr, feats, N, L, C, res, offs, bmin, inv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fwd<true>(a, st) : launch_fwd<false>(a, st);
}

// dLines (flat, the lines' layout; zeroed by the caller) += the line
// gradient of sum(dout * feats), dout [N, L*C]. Returns the first
// cudaError_t.
extern "C" int cp_bwd_launch(const float* x, const float* lines, const float* dout, float* dlines,
                             long long N, int L, int C, const int* res, const long long* offs,
                             float bmin, float inv, int bf16, void* stream) {
  if (!valid(N, L, C, res)) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const CPArgs a = make_args(x, lines, dout, dlines, N, L, C, res, offs, bmin, inv);
  long long ranges = 0;
  const BwdPlan P = bwd_plan(N, L, C, sm_count(), &ranges);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bwd<true>(a, P, ranges, st) : launch_bwd<false>(a, P, ranges, st);
}

// the kernels' plans for N points, n_sm SMs and lines of line_floats
// floats: plan[0..3] the forward's staged, shared-memory bytes, blocks and
// points a block's turn; plan[4..6] the backward's ranges, points a range and
// points a stretch (kernels/cp_encode.py's fwd_plan and bwd_plan are their
// twins)
extern "C" void cp_plans(long long N, int L, int C, long long line_floats, int n_sm,
                         long long* plan) {
  const FwdPlan F = fwd_plan(N, L, C, line_floats, n_sm);
  long long ranges = 0;
  const BwdPlan B = bwd_plan(N, L, C, n_sm, &ranges);
  const long long out[7] = {F.staged, F.smem, F.blocks, F.block_points, ranges, B.block_points,
                            B.stretch};
  for (int i = 0; i < 7; ++i) plan[i] = out[i];
}
