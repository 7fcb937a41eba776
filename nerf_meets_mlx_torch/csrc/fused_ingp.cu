// Fused Instant-NGP render and train kernels for Hopper (sm_90a).
//
// Replaces nerf_meets_mlx_tpu/kernels/fused_ingp_train.py::_ingp_eval_kernel
// (eval) and, for the shapes that csrc/ingp_train_tc.cu does not take,
// ::_ingp_train_kernel (train). Per level of the hierarchical render, one
// call takes rays (origin, direction), their spherical harmonics sh [R,DD]
// (computed per ray outside), sample depths z [R,S] and deltas [R,S]
// (already scaled by |d|, terminal bin 1e10*|d|), and runs
//
//   points o + z*d -> hash encode (L levels x 8 corners of the [L,T,F]
//   tables) -> the NeRF MLP over [features | sh] (depth D, width W, view
//   head) -> compositing (exclusive transmittance scan, both modes, white
//   background) -> rgb [R,3], weights [R,S];
//
// the train call adds pre-scaled density noise [R,S] and target colours
// [R,3] and also writes sse = sum over rays |rgb - target|^2, d(sse)/d(every
// weight and bias) laid out like the weights (fused_ingp_train.pack_weights)
// and d(sse)/d(tables) [L,T,F].
//
// Shapes. A build instantiates one (W, PP) pair, chosen by the macros
// INGP_W (32 or 64) and INGP_PP (16, 32 or 64): the MLP's width and the
// register width of its layer-0 input. The levels L (1..16) and features
// per level F (1, 2 or 4) are runtime values with L*F <= PP; layer 0's
// input columns past L*F are zero, and so are its weight rows there (the
// wrapper pads them: fused_ingp_train.pack_weights(rows0=PP)), so layer 0
// is a branch-free PP x W product. The
// wrapper builds each pair it meets as its own library (kernels/_build.py),
// so the pairs compile as separate translation units, in parallel. These
// register builds hold the eval kernel only: their shapes train in
// csrc/ingp_train_tc.cu, or, where a tile of that kernel does not fit on
// chip (fused_ingp_train.train_build), in the runtime-shape build.
//
// Every other shape -- a width that is a multiple of 16 from 32 to 256,
// 1..32 levels of 1, 2, 4 or 8 features, at most 128 feature channels --
// runs in one more build, INGP_W = INGP_PP = 0, whose kernels take the
// width and the channels as runtime values, in eval and in train. Past
// width 64 a thread-per-point
// MLP no longer fits in registers (one 256-wide layer is 256 KB of fp32
// weights, more than a block's 227 KB of shared memory), so this form keeps
// a point's activations in local memory (L1/L2) and computes each layer 16
// output columns at a time in registers (csrc/mlp_rt.cuh), reading the weights from shared
// memory where they fit beside the compositing terms (to width ~128 at
// lego_ingp's depth) and through L1/L2 from device memory otherwise; all
// threads of a warp read the same weight, so each load is a broadcast. The
// same form takes F = 8 and more than 16 levels, which the register bodies
// would need another instance for.
//
// bf16 hash compute (hash_compute_dtype = "bfloat16") rounds where the
// Pallas kernel rounds (fused_ingp_train.py:165-175 forward, :246-262 table
// scatter), as csrc/hash_encode.cu does: a corner adds
// bf16(bf16(w) * bf16(g)), the corners summed in fp32, and the table
// gradient adds bf16(w) * bf16(d(features)) in fp32. The MLP stays fp32.
//
// What bounds it on this card, at lego_ingp's shapes (L = 8, W = 64, D = 2,
// 12,452 parameters, 4096 rays, 48 + 48 samples): neither the bytes of its
// inputs and outputs (~40 bytes a point) nor its arithmetic (12,452 MACs a
// point forward, 0.15 ms at the 67 TFLOP/s fp32 peak at the fine level's
// 393,216 points), but the 64 hashed table lookups a point (L2 hits: the
// tables are 1 MB) and the latency of a thread-per-point MLP that reads its
// weights from shared memory. The runtime-shape build's train call also
// writes every layer's input and cotangent (~2 KB a point) for its dW GEMM,
// and adds the table gradient with atomics, which contend on the coarse
// levels' few thousand rows (see kernels/hash_encode.py).
//
// Design (simple first; csrc/ingp_train_tc.cu is the tensor-core form):
//
// 1. ingp_eval_kernel / ingp_rays_kernel: a block of NT = 128 threads owns
//    `rays_block` rays (~512 points) and first copies the MLP's weights
//    (48.6 KB at lego_ingp: over the 48 KB static limit, so dynamic shared
//    memory with cudaFuncAttributeMaxDynamicSharedMemorySize) into shared
//    memory. Phase A, a thread per point: the point, its hash features
//    (float2 lookups through the read-only cache), and the MLP in registers,
//    layer by layer (fully unrolled over the width; every thread reads the
//    same weight, a broadcast). Raw rgb and sigma go to shared memory; the
//    train kernel also writes each layer's input, point-major, to device
//    memory. Phase B, a thread per ray: the scan and composite as in
//    fused_eval.cu / fused_train.cu, and for training the squared error and
//    the closed-form compositing backward (the reverse suffix sum
//    dq_t = dw_t*T_t*alpha'_t - sum_{s>t} dw_s*w_s). Phase C (train), a
//    thread per point: the MLP backward (relu masks read back from phase
//    A's stores), every layer's pre-activation cotangent written out, and
//    d(features) scattered into dG by atomicAdd over the 8 corners of each
//    level (the corners are recomputed, the tables not read).
// 2. dw_gemm_kernel: dW = X^T dZ (and db = colsum dZ) of every layer as a
//    split-K GEMM of 64 x 64 tiles into per-split partials.
// 3. reduce_kernel: sums the splits, and the per-block SSE partials, in a
//    fixed order (deterministic; only dG's atomics are not).
//
// The TPU kernel's one-hot-GEMM radix lookup, [L,T/128,F*128] packed tables,
// U/E/A selector GEMMs and 768-point sub-blocks are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mlp_rt.cuh"

namespace {

constexpr int NT = 128;           // threads per block of the ray kernels
constexpr int MAX_LEVELS = 16;    // of the register (W, PP) builds
constexpr int RT_LEVELS = 32;     // of the runtime-shape build
constexpr int RT_WIDTH = 256;     // its widest MLP
constexpr int RT_FEATS = 128;     // its most feature channels (L*F)
constexpr int RT_DD = 64;         // its most sh channels
constexpr int MAX_DEPTH = 8;
constexpr int N_OFFS = 2 * (MAX_DEPTH + 4);
#if INGP_W == 0  // the train call's dW GEMM (runtime-shape build)
constexpr int GT = 64;            // dW tile edge
constexpr int KB = 16;            // points per staged dW slice
constexpr int GEMM_THREADS = 256;
constexpr int MAX_JOBS = MAX_DEPTH + 6;
#endif
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

#ifndef INGP_W
#define INGP_W 64
#endif
#ifndef INGP_PP
#define INGP_PP 16
#endif
static_assert(INGP_W == 0 || INGP_W == 32 || INGP_W == 64, "INGP_W is 0, 32 or 64");
static_assert(INGP_W == 0 ? INGP_PP == 0 : (INGP_PP == 16 || INGP_PP == 32 || INGP_PP == 64),
              "INGP_PP is 16, 32 or 64 (0 with INGP_W = 0: the runtime-shape build)");

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Args {
  const float* rays_o;   // [R, 3]
  const float* rays_d;   // [R, 3]
  const float* sh;       // [R, DD]
  const float* z;        // [R, S]
  const float* deltas;   // [R, S]
  const float* noise;    // [R, S] pre-scaled density noise (train)
  const float* target;   // [R, 3] (train)
  const float* tables;   // [L, T, F]
  const float* wbuf;     // the weights, [fan_in][fan_out] pieces (pack_weights)
  float* rgb;            // [R, 3]
  float* weights;        // [R, S]
  // train only
  float* sse_part;       // [n_blocks]
  float* dG;             // [L, T, F], zeroed by the caller
  float* enc;            // [P][PP]    layer 0's input, zero-padded
  float* hs;             // [D][P][W]  trunk outputs (post-relu)
  float* feat;           // [P][W]     feature layer output
  float* shp;            // [P][SHP]   sh per point, zero-padded
  float* hd;             // [P][W/2]   view layer output (post-relu)
  float* dzs;            // [D][P][W]  trunk pre-activation cotangents
  float* dalpha;         // [P]
  float* dfeat;          // [P][W]
  float* ddir;           // [P][W/2]
  float* drgb;           // [P][3]
  long long P;
  int R, S, rays_block, depth, dd, shp_ld, n_w;
  int L, F;              // levels, features a level; L*F <= PP
  int W;                 // the MLP's width (read by the runtime-shape build)
  int enc_ld;            // row stride of `enc`: PP, or L*F rounded up to 4
  int n_ws;              // floats of weights staged in shared memory: n_w or 0
  int bf16;              // 1: hash compute rounds as the Pallas kernel's bf16
  unsigned mask;         // T - 1
  long long T;
  float bmin, brange;
  int mode;              // 0 canonical, 1 reference
  int relu_density;      // canonical: 0 softplus, 1 relu
  int white_bkgd;
  int res[RT_LEVELS];
  int offs[N_OFFS];      // float offsets of the pieces in wbuf
};

// hash corners of point (x0, x1, x2) at level l, as csrc/hash_encode.cu
struct Corners {
  unsigned h[8];
  float w[8];
};

__device__ __forceinline__ Corners corners_of(const Args& A, const float (&x)[3], int l) {
  const float r = (float)A.res[l];
  unsigned b[3];
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float u = __fdiv_rn(__fsub_rn(x[a], A.bmin), A.brange);
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

// the point of global sample index gi (ray = gi / S): o + z*d, rounded as
// the plain version's broadcast product and sum
__device__ __forceinline__ void point_of(const Args& A, long long gi, float (&x)[3]) {
  const long long ray = gi / A.S;
  const float zz = __ldg(A.z + gi);
#pragma unroll
  for (int a = 0; a < 3; ++a)
    x[a] = __fadd_rn(__ldg(A.rays_o + ray * 3 + a), __fmul_rn(zz, __ldg(A.rays_d + ray * 3 + a)));
}

__device__ __forceinline__ float rb(float v, int on) {
  return on ? __bfloat162float(__float2bfloat16_rn(v)) : v;
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

// levels that a PP-wide input can hold at F features a level
template <int F, int PP>
__host__ __device__ constexpr int levels_of() { return PP / F < MAX_LEVELS ? PP / F : MAX_LEVELS; }

// Every level that a PP-wide input holds at F features a level is computed
// without a branch, so that the compiler keeps several levels' lookups in
// flight (the lookups' latency bounds the kernel); a level l >= L re-reads
// level L - 1 and is zeroed. BF16 rounds as the Pallas kernel does.
template <int F, int PP, bool BF16>
__device__ __forceinline__ void level_features(const Args& A, const float (&x)[3],
                                               float (&e)[PP]) {
#pragma unroll
  for (int l = 0; l < levels_of<F, PP>(); ++l) {
    const int lc = min(l, A.L - 1);
    const Corners C = corners_of(A, x, lc);
    const float* tl = A.tables + (size_t)lc * A.T * F;
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float g[F];
      load_row<F>(tl + (size_t)C.h[c] * F, g);
      if constexpr (BF16) {
        const float w = rb(C.w[c], 1);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], rb(__fmul_rn(rb(g[f], 1), w), 1));
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(g[f], C.w[c]));
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) e[l * F + f] = l < A.L ? acc[f] : 0.f;
  }
}

template <int F, int PP>
__device__ __forceinline__ void features_of(const Args& A, const float (&x)[3], float (&e)[PP]) {
  if (A.bf16)
    level_features<F, PP, true>(A, x, e);
  else
    level_features<F, PP, false>(A, x, e);
}

// e[l*F + f] = the point's hash features, zero past L*F. F selects a body
// whose register indices are compile-time; only the F that can fill PP
// columns with at most MAX_LEVELS levels are compiled.
template <int PP>
__device__ __forceinline__ void hash_features(const Args& A, const float (&x)[3], float (&e)[PP]) {
#pragma unroll
  for (int k = 0; k < PP; ++k) e[k] = 0.f;
  if constexpr (4 * MAX_LEVELS >= PP)
    if (A.F == 4) features_of<4, PP>(A, x, e);
  if constexpr (2 * MAX_LEVELS >= PP)
    if (A.F == 2) features_of<2, PP>(A, x, e);
  if constexpr (MAX_LEVELS >= PP)
    if (A.F == 1) features_of<1, PP>(A, x, e);
}

// acc[j] = b[j] (N a multiple of 4; b on 16 bytes)
template <int N>
__device__ __forceinline__ void load_bias(float (&acc)[N], const float* b) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(b + j);
    acc[j] = v.x; acc[j + 1] = v.y; acc[j + 2] = v.z; acc[j + 3] = v.w;
  }
}

// acc[j] += sum_k in[k] * Wm[k][j], Wm row-major [K][N] in shared memory
template <int K, int N>
__device__ __forceinline__ void gemv(float (&acc)[N], const float (&in)[K], const float* Wm) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float x = in[k];
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 w = *reinterpret_cast<const float4*>(Wm + k * N + j);
      acc[j] = fmaf(x, w.x, acc[j]);
      acc[j + 1] = fmaf(x, w.y, acc[j + 1]);
      acc[j + 2] = fmaf(x, w.z, acc[j + 2]);
      acc[j + 3] = fmaf(x, w.w, acc[j + 3]);
    }
  }
}

// The eval kernel's phase A for one point of the register builds: raw rgb
// (3) and raw sigma of the MLP on the point's hash features and its ray's
// sh.
template <int W, int PP>
__device__ __forceinline__ void point_forward(const Args& A, const float* sw, long long gi,
                                              float (&rgb)[3], float& sigma) {
  constexpr int WH = W / 2;
  const int D = A.depth;
  float x[3];
  point_of(A, gi, x);
  float e[PP];
  hash_features<PP>(A, x, e);

  float h[W], acc[W];
  load_bias<W>(acc, sw + A.offs[1]);
  gemv<PP, W>(acc, e, sw + A.offs[0]);
#pragma unroll
  for (int j = 0; j < W; ++j) h[j] = fmaxf(acc[j], 0.f);
  for (int l = 1; l < D; ++l) {
    load_bias<W>(acc, sw + A.offs[2 * l + 1]);
    gemv<W, W>(acc, h, sw + A.offs[2 * l]);
#pragma unroll
    for (int j = 0; j < W; ++j) h[j] = fmaxf(acc[j], 0.f);
  }
  // alpha head (W -> 1)
  {
    const float* wa = sw + A.offs[2 * D];
    float a = sw[A.offs[2 * D + 1]];
#pragma unroll
    for (int k = 0; k < W; ++k) a = fmaf(h[k], wa[k], a);
    sigma = a;
  }
  // feature (W -> W, no activation)
  float f[W];
  load_bias<W>(f, sw + A.offs[2 * D + 3]);
  gemv<W, W>(f, h, sw + A.offs[2 * D + 2]);
  // view layer on [feature, sh] (W + DD -> W/2, relu)
  float hd[WH];
  const float* wd = sw + A.offs[2 * D + 4];
  load_bias<WH>(hd, sw + A.offs[2 * D + 5]);
  gemv<W, WH>(hd, f, wd);
  const float* shr = A.sh + (gi / A.S) * A.dd;
  for (int k = 0; k < A.dd; ++k) {
    const float s = __ldg(shr + k);
    const float* wrow = wd + (W + k) * WH;
#pragma unroll
    for (int j = 0; j < WH; j += 4) {
      const float4 w = *reinterpret_cast<const float4*>(wrow + j);
      hd[j] = fmaf(s, w.x, hd[j]);
      hd[j + 1] = fmaf(s, w.y, hd[j + 1]);
      hd[j + 2] = fmaf(s, w.z, hd[j + 2]);
      hd[j + 3] = fmaf(s, w.w, hd[j + 3]);
    }
  }
#pragma unroll
  for (int j = 0; j < WH; ++j) hd[j] = fmaxf(hd[j], 0.f);
  // rgb head (W/2 -> 3)
  const float* wr = sw + A.offs[2 * D + 6];
  const float* br = sw + A.offs[2 * D + 7];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = br[c];
#pragma unroll
    for (int k = 0; k < WH; ++k) v = fmaf(hd[k], wr[k * 3 + c], v);
    rgb[c] = v;
  }
}

// ---------------------------------------------------------------------------
// The runtime-shape build (INGP_W = 0): width, levels and features at run
// time; a point's vectors live in local memory, 16 output columns at a time
// in registers
// ---------------------------------------------------------------------------

// e[l*F + f] for every level l < L, as level_features
template <int F, bool BF16>
__device__ __forceinline__ void rt_levels(const Args& A, const float (&x)[3], float* e) {
  for (int l = 0; l < A.L; ++l) {
    const Corners C = corners_of(A, x, l);
    const float* tl = A.tables + (size_t)l * A.T * F;
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float g[F];
      load_row<F>(tl + (size_t)C.h[c] * F, g);
      if constexpr (BF16) {
        const float w = rb(C.w[c], 1);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], rb(__fmul_rn(rb(g[f], 1), w), 1));
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(g[f], C.w[c]));
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) e[l * F + f] = acc[f];
  }
}

template <bool BF16>
__device__ __forceinline__ void rt_features_of(const Args& A, const float (&x)[3], float* e) {
  switch (A.F) {
    case 1: rt_levels<1, BF16>(A, x, e); break;
    case 2: rt_levels<2, BF16>(A, x, e); break;
    case 4: rt_levels<4, BF16>(A, x, e); break;
    default: rt_levels<8, BF16>(A, x, e); break;
  }
}

// dG[l][h_c][f] += w_c * de[l*F + f], as level_scatter
template <int F, bool BF16>
__device__ __forceinline__ void rt_scatter_levels(const Args& A, const float (&x)[3],
                                                  const float* de) {
  for (int l = 0; l < A.L; ++l) {
    float d[F];
    bool any = false;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      d[f] = rb(de[l * F + f], BF16);
      any |= d[f] != 0.f;
    }
    if (!any) continue;
    const Corners C = corners_of(A, x, l);
    float* gl = A.dG + (size_t)l * A.T * F;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float w = rb(C.w[c], BF16);
#pragma unroll
      for (int f = 0; f < F; ++f) atomicAdd(gl + (size_t)C.h[c] * F + f, __fmul_rn(w, d[f]));
    }
  }
}

template <bool BF16>
__device__ __forceinline__ void rt_scatter_of(const Args& A, const float (&x)[3],
                                              const float* de) {
  switch (A.F) {
    case 1: rt_scatter_levels<1, BF16>(A, x, de); break;
    case 2: rt_scatter_levels<2, BF16>(A, x, de); break;
    case 4: rt_scatter_levels<4, BF16>(A, x, de); break;
    default: rt_scatter_levels<8, BF16>(A, x, de); break;
  }
}

// point_forward of the runtime-shape build; sw: the weights (shared or
// device memory)
template <bool STASH>
__device__ __forceinline__ void point_forward_rt(const Args& A, const float* sw, long long gi,
                                                 float (&rgb)[3], float& sigma) {
  const int W = A.W, WH = W / 2, D = A.depth, E = A.L * A.F;
  const size_t P = (size_t)A.P;
  float x[3];
  point_of(A, gi, x);
  float e[RT_FEATS], u[RT_WIDTH + RT_DD], v[RT_WIDTH + RT_DD];
  if (A.bf16)
    rt_features_of<true>(A, x, e);
  else
    rt_features_of<false>(A, x, e);
  if (STASH) {
    float* dst = A.enc + (size_t)gi * A.enc_ld;
    for (int k = 0; k < A.enc_ld; ++k) dst[k] = k < E ? e[k] : 0.f;
  }
  float* h = u;
  float* g = v;
  rt_dense(h, e, E, sw + A.offs[0], sw + A.offs[1], W, true);
  if (STASH) rt_store(A.hs + (size_t)gi * W, h, W);
  for (int l = 1; l < D; ++l) {
    rt_dense(g, h, W, sw + A.offs[2 * l], sw + A.offs[2 * l + 1], W, true);
    if (STASH) rt_store(A.hs + (size_t)l * P * W + (size_t)gi * W, g, W);
    float* t = h; h = g; g = t;
  }
  // alpha head (W -> 1)
  {
    const float* wa = sw + A.offs[2 * D];
    float a = sw[A.offs[2 * D + 1]];
    for (int k = 0; k < W; ++k) a = fmaf(h[k], wa[k], a);
    sigma = a;
  }
  // feature (W -> W, no activation), then [feature, sh] in g
  rt_dense(g, h, W, sw + A.offs[2 * D + 2], sw + A.offs[2 * D + 3], W, false);
  if (STASH) rt_store(A.feat + (size_t)gi * W, g, W);
  const float* shr = A.sh + (gi / A.S) * A.dd;
  for (int k = 0; k < A.dd; ++k) g[W + k] = __ldg(shr + k);
  if (STASH) {
    float* shp = A.shp + (size_t)gi * A.shp_ld;
    for (int k = 0; k < A.shp_ld; ++k) shp[k] = k < A.dd ? g[W + k] : 0.f;
  }
  // view layer on [feature, sh] (W + DD -> W/2, relu)
  rt_dense(h, g, W + A.dd, sw + A.offs[2 * D + 4], sw + A.offs[2 * D + 5], WH, true);
  if (STASH) rt_store(A.hd + (size_t)gi * WH, h, WH);
  // rgb head (W/2 -> 3)
  const float* wr = sw + A.offs[2 * D + 6];
  const float* br = sw + A.offs[2 * D + 7];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float o = br[c];
    for (int k = 0; k < WH; ++k) o = fmaf(h[k], wr[k * 3 + c], o);
    rgb[c] = o;
  }
}

#if INGP_W == 0
// phase C for one point in the runtime-shape build: the MLP backward from
// d(raw rgb) and d(raw sigma), every layer's cotangent stored, d(features)
// scattered into dG
__device__ __forceinline__ void point_backward_rt(const Args& A, const float* sw, long long gi,
                                                  const float (&dr)[3], float dsig) {
  const int W = A.W, WH = W / 2, D = A.depth, E = A.L * A.F;
  const size_t P = (size_t)A.P;
  float a[RT_WIDTH], b[RT_WIDTH];
  // rgb head: d(hd) = (Wr d(raw rgb)) * (hd > 0)
  {
    const float* wr = sw + A.offs[2 * D + 6];
    const float* hdr = A.hd + (size_t)gi * WH;
    for (int k = 0; k < WH; ++k) {
      const float s = fmaf(dr[2], wr[k * 3 + 2], fmaf(dr[1], wr[k * 3 + 1], dr[0] * wr[k * 3]));
      a[k] = hdr[k] > 0.f ? s : 0.f;
    }
    rt_store(A.ddir + (size_t)gi * WH, a, WH);
  }
  // feature output: d(feat) = Wd[:W] d(hd) (no activation)
  rt_dense_t(b, a, WH, sw + A.offs[2 * D + 4], W);
  rt_store(A.dfeat + (size_t)gi * W, b, W);
  // last trunk layer: dZ = (Wf d(feat) + wa d(alpha)) * (h > 0)
  rt_dense_t(a, b, W, sw + A.offs[2 * D + 2], W);
  {
    const float* wa = sw + A.offs[2 * D];
    const size_t o = (size_t)(D - 1) * P * W + (size_t)gi * W;
    for (int k = 0; k < W; ++k) {
      const float dh = fmaf(wa[k], dsig, a[k]);
      a[k] = A.hs[o + k] > 0.f ? dh : 0.f;
    }
    rt_store(A.dzs + o, a, W);
  }
  float* dz = a;
  float* t = b;
  for (int l = D - 1; l >= 1; --l) {
    rt_dense_t(t, dz, W, sw + A.offs[2 * l], W);
    const size_t o = (size_t)(l - 1) * P * W + (size_t)gi * W;
    for (int k = 0; k < W; ++k) t[k] = A.hs[o + k] > 0.f ? t[k] : 0.f;
    rt_store(A.dzs + o, t, W);
    float* tmp = dz; dz = t; t = tmp;
  }
  // d(features) = W0 dZ_0, scattered into the tables' rows
  float de[RT_FEATS];
  rt_dense_t(de, dz, W, sw + A.offs[0], E);
  float x[3];
  point_of(A, gi, x);
  if (A.bf16)
    rt_scatter_of<true>(A, x, de);
  else
    rt_scatter_of<false>(A, x, de);
}

#endif  // INGP_W == 0

// per-point compositing terms of fused_train.cu (_alpha_terms): q, alpha,
// d(alpha)/dq and dq/d(raw sigma)
__device__ __forceinline__ void alpha_terms(const Args& A, float raw, float delta, float& q,
                                            float& alpha, float& da, float& dqd) {
  if (A.mode == 0) {
    float sigma, dsig;
    if (A.relu_density) {
      sigma = fmaxf(raw, 0.f);
      dsig = raw > 0.f ? 1.f : 0.f;
    } else {
      sigma = fmaxf(raw, 0.f) + log1pf(expf(-fabsf(raw)));
      dsig = 1.f / (1.f + expf(-raw));
    }
    q = sigma * delta;
    const float e = expf(-q);
    alpha = 1.f - e;
    da = e;
    dqd = delta * dsig;
  } else {
    q = delta * raw;  // raw density in the prefix sum: T may exceed 1
    const float e = expf(-fmaxf(q, 0.f));
    alpha = 1.f - e;
    da = q > 0.f ? e : 0.f;
    dqd = delta;
  }
}

__device__ __forceinline__ void load_weights(const Args& A, float* sw) {
  const int n4 = A.n_ws / 4;
  for (int i = threadIdx.x; i < n4; i += NT)
    reinterpret_cast<float4*>(sw)[i] = __ldg(reinterpret_cast<const float4*>(A.wbuf) + i);
  __syncthreads();
}

template <int W, int PP>
__global__ void __launch_bounds__(NT, 2) ingp_eval_kernel(const __grid_constant__ Args A) {
  extern __shared__ __align__(16) float smem[];
  const int S = A.S, RB = A.rays_block;
  float* sw = smem;                      // [n_ws] weights
  float* pc = sw + A.n_ws;               // [RB*S][3] raw rgb -> colour
  float* pq = pc + RB * S * 3;           // raw sigma -> q
  float* pa = pq + RB * S;               // alpha
  const int r0 = blockIdx.x * RB;
  const int nr = min(RB, A.R - r0);
  if (nr <= 0) return;
  const int npts = nr * S;
  const long long gbase = (long long)r0 * S;
  load_weights(A, sw);
  // the runtime-shape build reads its weights from device memory where
  // they do not fit in shared memory
  const float* wts = W == 0 && A.n_ws == 0 ? A.wbuf : sw;

  for (int i = threadIdx.x; i < npts; i += NT) {
    float rgb[3], sigma;
    if constexpr (W == 0)
      point_forward_rt<false>(A, wts, gbase + i, rgb, sigma);
    else
      point_forward<W, PP>(A, wts, gbase + i, rgb, sigma);
    float q, alpha, da, dqd;
    alpha_terms(A, sigma, __ldg(A.deltas + gbase + i), q, alpha, da, dqd);
    pq[i] = q;
    pa[i] = alpha;
#pragma unroll
    for (int c = 0; c < 3; ++c) pc[i * 3 + c] = A.mode == 0 ? 1.f / (1.f + expf(-rgb[c])) : rgb[c];
  }
  __syncthreads();

  for (int rr = threadIdx.x; rr < nr; rr += NT) {
    const int ray = r0 + rr;
    const int b = rr * S;
    float* wout = A.weights + (size_t)ray * S;
    float excl = 0.f, acc = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const int i = b + s;
      const float w = pa[i] * expf(-excl);
      wout[s] = w;
      c0 = fmaf(w, pc[3 * i + 0], c0);
      c1 = fmaf(w, pc[3 * i + 1], c1);
      c2 = fmaf(w, pc[3 * i + 2], c2);
      acc += w;
      excl += pq[i];
    }
    if (A.white_bkgd) {
      const float bgc = 1.f - acc;
      c0 += bgc; c1 += bgc; c2 += bgc;
    }
    A.rgb[(size_t)ray * 3 + 0] = c0;
    A.rgb[(size_t)ray * 3 + 1] = c1;
    A.rgb[(size_t)ray * 3 + 2] = c2;
  }
}

#if INGP_W == 0
// the train call's ray kernel (the runtime-shape build only)
__global__ void __launch_bounds__(NT, 2) ingp_rays_kernel(const __grid_constant__ Args A) {
  extern __shared__ __align__(16) float smem[];
  const int S = A.S, RB = A.rays_block;
  float* sw = smem;                      // [n_ws] weights
  float* pc = sw + A.n_ws;               // [RB*S][3] raw rgb -> colour -> d(raw rgb)
  float* pq = pc + RB * S * 3;           // raw sigma -> q -> d(raw sigma)
  float* pa = pq + RB * S;               // alpha -> weight
  float* pda = pa + RB * S;              // d(alpha)/dq -> T * d(alpha)/dq
  float* pdq = pda + RB * S;             // dq / d(raw sigma)
  float* rsse = pdq + RB * S;            // [RB] squared error per ray
  const int r0 = blockIdx.x * RB;
  const int nr = min(RB, A.R - r0);
  if (nr <= 0) return;
  const int npts = nr * S;
  const long long gbase = (long long)r0 * S;
  load_weights(A, sw);
  // weights from device memory where they do not fit in shared memory
  const float* wts = A.n_ws == 0 ? A.wbuf : sw;

  // ---------------- phase A: forward, a thread per point ----------------
  for (int i = threadIdx.x; i < npts; i += NT) {
    const long long gi = gbase + i;
    float rgb[3], sigma;
    point_forward_rt<true>(A, wts, gi, rgb, sigma);
    float q, alpha, da, dqd;
    alpha_terms(A, sigma + __ldg(A.noise + gi), __ldg(A.deltas + gi), q, alpha, da, dqd);
    pq[i] = q;
    pa[i] = alpha;
    pda[i] = da;
    pdq[i] = dqd;
#pragma unroll
    for (int c = 0; c < 3; ++c) pc[i * 3 + c] = A.mode == 0 ? 1.f / (1.f + expf(-rgb[c])) : rgb[c];
  }
  __syncthreads();

  // ---------------- phase B: per ray, scan, composite, loss, backward ----------------
  for (int rr = threadIdx.x; rr < nr; rr += NT) {
    const int ray = r0 + rr;
    const int b = rr * S;
    float* wout = A.weights + (size_t)ray * S;
    float excl = 0.f, acc = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const int i = b + s;
      const float T = expf(-excl);
      const float w = pa[i] * T;
      wout[s] = w;
      c0 = fmaf(w, pc[3 * i + 0], c0);
      c1 = fmaf(w, pc[3 * i + 1], c1);
      c2 = fmaf(w, pc[3 * i + 2], c2);
      acc += w;
      excl += pq[i];
      pa[i] = w;
      pda[i] *= T;
    }
    if (A.white_bkgd) {
      const float bgc = 1.f - acc;
      c0 += bgc; c1 += bgc; c2 += bgc;
    }
    A.rgb[(size_t)ray * 3 + 0] = c0;
    A.rgb[(size_t)ray * 3 + 1] = c1;
    A.rgb[(size_t)ray * 3 + 2] = c2;
    const float* tg = A.target + (size_t)ray * 3;
    const float e0 = c0 - tg[0], e1 = c1 - tg[1], e2 = c2 - tg[2];
    rsse[rr] = e0 * e0 + e1 * e1 + e2 * e2;
    const float g0 = 2.f * e0, g1 = 2.f * e1, g2 = 2.f * e2;
    const float gs = A.white_bkgd ? g0 + g1 + g2 : 0.f;
    float suffix = 0.f;  // sum_{s>t} dw_s * w_s
    for (int s = S - 1; s >= 0; --s) {
      const int i = b + s;
      const float x0 = pc[3 * i + 0], x1 = pc[3 * i + 1], x2 = pc[3 * i + 2];
      const float w = pa[i];
      const float dw = x0 * g0 + x1 * g1 + x2 * g2 - gs;
      const float dq = dw * pda[i] - suffix;
      suffix = fmaf(dw, w, suffix);
      pq[i] = dq * pdq[i];
      float d0 = w * g0, d1 = w * g1, d2 = w * g2;
      if (A.mode == 0) {
        d0 *= x0 * (1.f - x0);
        d1 *= x1 * (1.f - x1);
        d2 *= x2 * (1.f - x2);
      }
      pc[3 * i + 0] = d0;
      pc[3 * i + 1] = d1;
      pc[3 * i + 2] = d2;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int rr = 0; rr < nr; ++rr) s += rsse[rr];
    A.sse_part[blockIdx.x] = s;
  }

  // ---------------- phase C: MLP backward and dG, a thread per point ----------------
  for (int i = threadIdx.x; i < npts; i += NT) {
    const long long gi = gbase + i;
    const float dr[3] = {pc[3 * i + 0], pc[3 * i + 1], pc[3 * i + 2]};
    const float dsig = pq[i];
    A.dalpha[gi] = dsig;
#pragma unroll
    for (int c = 0; c < 3; ++c) A.drgb[gi * 3 + c] = dr[c];
    point_backward_rt(A, wts, gi, dr, dsig);
  }
}

// ---------------------------------------------------------------------------
// dW = X^T dZ, split over the points
// ---------------------------------------------------------------------------

struct Job {              // C[k][n] = sum_p a[p][k] * b[p][n] for k < K, n < N
  const float* a;         // [P][lda] the layer's input
  const float* b;         // [P][ldb] the layer's pre-activation cotangent
  int lda, ldb, K, N;
  int c_off, ldc;         // where C's rows start in the dW layout, row stride
  int bias_off;           // db = colsum(b) goes here; -1: none
  int tile0, tiles_n;     // first tile of this job, tiles along n
};

struct GemmArgs {
  Job jobs[MAX_JOBS];
  int n_jobs;
  long long P;
  int pts_per_split;
  long long part_stride;  // floats per split of `part`
  float* part;            // [n_splits][part_stride]
};

// a slice of KB points x GT columns of an operand, 4 values a thread
__device__ __forceinline__ float4 load_slice(const float* src, int ld, int c0, int lim,
                                             long long p0, long long pe) {
  const int tid = threadIdx.x;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if ((ld & 3) == 0) {
    const int pp = tid / (GT / 4), c = 4 * (tid % (GT / 4));
    const long long p = p0 + pp;
    if (p < pe) {
      if (c0 + c + 3 < lim) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src + p * ld + c0 + c));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + c + j < lim) v[j] = __ldg(src + p * ld + c0 + c + j);
      }
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  // narrow rows (dalpha, drgb): four scalars, column-fastest
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int idx = tid + j * GEMM_THREADS;
    const int pp = idx / GT, col = idx % GT;
    const long long p = p0 + pp;
    v[j] = (p < pe && c0 + col < lim) ? __ldg(src + p * ld + c0 + col) : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void stash_slice(float* dst, float4 v, int ld) {
  const int tid = threadIdx.x;
  if ((ld & 3) == 0) {
    reinterpret_cast<float4*>(dst)[tid] = v;  // [pp][c..c+3]
  } else {
    dst[tid] = v.x;
    dst[tid + GEMM_THREADS] = v.y;
    dst[tid + 2 * GEMM_THREADS] = v.z;
    dst[tid + 3 * GEMM_THREADS] = v.w;
  }
}

__global__ void __launch_bounds__(GEMM_THREADS) dw_gemm_kernel(const __grid_constant__ GemmArgs G) {
  __shared__ __align__(16) float As[KB * GT];
  __shared__ __align__(16) float Bs[KB * GT];
  const int t = blockIdx.x;
  int jn = 0;
  while (jn + 1 < G.n_jobs && G.jobs[jn + 1].tile0 <= t) ++jn;
  const Job& J = G.jobs[jn];
  const int local = t - J.tile0;
  const int k0 = (local / J.tiles_n) * GT, n0 = (local % J.tiles_n) * GT;
  const long long pb = (long long)blockIdx.y * G.pts_per_split;
  const long long pe = min(G.P, pb + (long long)G.pts_per_split);
  float* out = G.part + (size_t)blockIdx.y * G.part_stride;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const bool bias = J.bias_off >= 0 && k0 == 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bsum[4] = {0.f, 0.f, 0.f, 0.f};

  float4 sa = load_slice(J.a, J.lda, k0, J.K, pb, pe);
  float4 sb = load_slice(J.b, J.ldb, n0, J.N, pb, pe);
  for (long long p0 = pb; p0 < pe; p0 += KB) {
    __syncthreads();
    stash_slice(As, sa, J.lda);
    stash_slice(Bs, sb, J.ldb);
    __syncthreads();
    if (p0 + KB < pe) {
      sa = load_slice(J.a, J.lda, k0, J.K, p0 + KB, pe);
      sb = load_slice(J.b, J.ldb, n0, J.N, p0 + KB, pe);
    }
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(As + kk * GT + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(Bs + kk * GT + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) bsum[j] += bv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
    if (k >= J.K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < J.N) out[J.c_off + (size_t)k * J.ldc + n] = acc[i][j];
    }
  }
  if (bias && ty == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < J.N) out[J.bias_off + n] = bsum[j];
    }
  }
}

// dw[i] = sum over splits of part[split][i], in split order; sse = sum of
// the per-block partials, in block order.
__global__ void reduce_kernel(const float* __restrict__ part, long long stride, int n_splits,
                              float* __restrict__ dw, int n_dw,
                              const float* __restrict__ sse_part, int n_blocks,
                              float* __restrict__ sse) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_dw) {
    float s = 0.f;
    for (int k = 0; k < n_splits; ++k) s += part[(size_t)k * stride + i];
    dw[i] = s;
  }
  if (i == 0) {
    float s = 0.f;
    for (int b = 0; b < n_blocks; ++b) s += sse_part[b];
    *sse = s;
  }
}

#endif  // INGP_W == 0

size_t smem_bytes(int n_ws, int S, int rays_block, bool train) {
  const size_t pts = (size_t)rays_block * S;
  return sizeof(float) * ((size_t)n_ws + pts * (train ? 7 : 5) + (train ? (size_t)rays_block : 0));
}

// floats of weights a block stages in shared memory: all of them in the
// register builds; in the runtime-shape build, all where they fit beside
// the compositing terms, else none (read from device memory)
int staged_weights(int n_w, int S, int rays_block, bool train) {
  if (INGP_W != 0 || smem_bytes(n_w, S, rays_block, train) <= (size_t)MAX_SMEM) return n_w;
  return 0;
}

#if INGP_W == 0
struct Layout {
  size_t enc, hs, feat, shp, hd, dzs, dalpha, dfeat, ddir, drgb, sse_part, part, total;
  long long part_stride;
  int n_blocks, n_splits;
};

Layout layout(int R, int S, int rays_block, int depth, int W, int E, int shp_ld,
              int pts_per_split, int n_dw) {
  Layout Lo{};
  const size_t P = (size_t)R * S;
  size_t o = 0;
  auto take = [&](size_t n) {
    const size_t at = o;
    o += (n + 3) / 4 * 4;  // every piece starts on 16 bytes
    return at;
  };
  Lo.enc = take(P * E);
  Lo.hs = take((size_t)depth * P * W);
  Lo.feat = take(P * W);
  Lo.shp = take(P * shp_ld);
  Lo.hd = take(P * (W / 2));
  Lo.dzs = take((size_t)depth * P * W);
  Lo.dalpha = take(P);
  Lo.dfeat = take(P * W);
  Lo.ddir = take(P * (W / 2));
  Lo.drgb = take(P * 3);
  Lo.n_blocks = (R + rays_block - 1) / rays_block;
  Lo.sse_part = take((size_t)Lo.n_blocks);
  Lo.n_splits = (int)((P + pts_per_split - 1) / pts_per_split);
  Lo.part_stride = (n_dw + 3) / 4 * 4;
  Lo.part = take((size_t)Lo.n_splits * Lo.part_stride);
  Lo.total = o;
  return Lo;
}

#endif  // INGP_W == 0

// this build's (width, layer-0 columns) pair, or the runtime-shape build's
// bounds
bool shape_ok(int W, int L, int F) {
  if (INGP_W == 0)
    return W % 16 == 0 && W >= 32 && W <= RT_WIDTH && L >= 1 && L <= RT_LEVELS &&
           (F == 1 || F == 2 || F == 4 || F == 8) && L * F <= RT_FEATS;
  return W == INGP_W && L >= 1 && L <= MAX_LEVELS && (F == 1 || F == 2 || F == 4) &&
         L * F <= INGP_PP;
}

// the row stride of layer 0's stored input
int enc_ld_of(int E) { return INGP_W == 0 ? round_up(E, 4) : INGP_PP; }

int shp_ld_of(int dd) { return round_up(dd, 4); }

bool valid(int R, int S, int rays_block, int depth, int W, int L, int F, int dd, int log2_T,
           int n_offs) {
  return R >= 0 && S > 0 && rays_block > 0 && depth >= 1 && depth <= MAX_DEPTH &&
         shape_ok(W, L, F) && dd >= 0 && dd <= 64 && log2_T >= 1 && log2_T <= 31 &&
         n_offs == 2 * (depth + 4);
}

Args base_args(const float* rays_o, const float* rays_d, const float* sh, const float* z,
               const float* deltas, const float* tables, const float* wbuf, const int* offs,
               int n_offs, int n_w, float* rgb, float* weights, int R, int S, int rays_block,
               int depth, int dd, int log2_T, const int* res, int L, int F, int bf16, float bmin,
               float brange, int mode, int relu_density, int white_bkgd) {
  Args a{};
  a.rays_o = rays_o; a.rays_d = rays_d; a.sh = sh; a.z = z; a.deltas = deltas;
  a.tables = tables; a.wbuf = wbuf; a.rgb = rgb; a.weights = weights;
  a.P = (long long)R * S;
  a.R = R; a.S = S; a.rays_block = rays_block; a.depth = depth; a.dd = dd;
  a.shp_ld = shp_ld_of(dd); a.n_w = n_w;
  a.L = L; a.F = F; a.bf16 = bf16;
  a.enc_ld = enc_ld_of(L * F);
  a.T = 1ll << log2_T;
  a.mask = (unsigned)(a.T - 1);
  a.bmin = bmin; a.brange = brange;
  a.mode = mode; a.relu_density = relu_density; a.white_bkgd = white_bkgd;
  for (int l = 0; l < L; ++l) a.res[l] = res[l];
  for (int i = 0; i < n_offs; ++i) a.offs[i] = offs[i];
  return a;
}

}  // namespace

// Shared-memory bytes one block needs (0 if this build does not take the
// (width, levels, features) shape).
extern "C" long long fused_ingp_smem_bytes(int width, int levels, int features, int n_w, int S,
                                           int rays_block, int train) {
  if (!shape_ok(width, levels, features)) return 0;
  return (long long)smem_bytes(staged_weights(n_w, S, rays_block, train != 0), S, rays_block,
                               train != 0);
}

#if INGP_W == 0
// Floats of device scratch the train launch needs (runtime-shape build).
extern "C" long long fused_ingp_workspace_floats(int R, int S, int rays_block, int depth,
                                                 int width, int n_features, int dd,
                                                 int pts_per_split, int n_dw) {
  if (R <= 0 || S <= 0 || rays_block <= 0 || pts_per_split <= 0) return 0;
  return (long long)layout(R, S, rays_block, depth, width, enc_ld_of(n_features), shp_ld_of(dd),
                           pts_per_split, n_dw)
      .total;
}
#endif  // INGP_W == 0

// rgb [R,3] and weights [R,S] of one level. offs: the 2*(depth+4) float
// offsets of pack_weights (host array); n_w: floats of wbuf (a multiple of
// 4); res: the L int32 resolutions; bf16: the hash compute type. Returns
// the first cudaError_t.
extern "C" int fused_ingp_eval_launch(const float* rays_o, const float* rays_d, const float* sh,
                                      const float* z, const float* deltas, const float* tables,
                                      const float* wbuf, const int* offs, int n_offs, int n_w,
                                      float* rgb, float* weights, int R, int S, int rays_block,
                                      int depth, int width, int levels, int features, int bf16,
                                      int dd, int log2_T, const int* res, float bmin,
                                      float brange, int mode, int relu_density, int white_bkgd,
                                      void* stream) {
  if (!valid(R, S, rays_block, depth, width, levels, features, dd, log2_T, n_offs) || (n_w & 3))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const int n_ws = staged_weights(n_w, S, rays_block, false);
  const size_t smem = smem_bytes(n_ws, S, rays_block, false);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  Args a = base_args(rays_o, rays_d, sh, z, deltas, tables, wbuf, offs, n_offs, n_w, rgb,
                     weights, R, S, rays_block, depth, dd, log2_T, res, levels, features,
                     bf16, bmin, brange, mode, relu_density, white_bkgd);
  a.W = width;
  a.n_ws = n_ws;
  void (*kernel)(Args) = ingp_eval_kernel<INGP_W, INGP_PP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((R + rays_block - 1) / rays_block);
  kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

#if INGP_W == 0
// The train call of one level (runtime-shape build): rgb, weights, sse [1],
// dw [n_dw] (the weights' layout) and dG [L,T,F] (zeroed by the caller);
// workspace: fused_ingp_workspace_floats floats. Returns the first
// cudaError_t.
extern "C" int fused_ingp_train_launch(const float* rays_o, const float* rays_d, const float* sh,
                                       const float* z, const float* deltas, const float* noise,
                                       const float* target, const float* tables,
                                       const float* wbuf, const int* offs, int n_offs, int n_w,
                                       float* rgb, float* weights, float* sse, float* dw,
                                       float* dG, float* workspace, int R, int S, int rays_block,
                                       int depth, int width, int levels, int features, int bf16,
                                       int dd, int log2_T, const int* res, float bmin,
                                       float brange, int mode, int relu_density, int white_bkgd,
                                       int pts_per_split, void* stream) {
  if (!valid(R, S, rays_block, depth, width, levels, features, dd, log2_T, n_offs) ||
      (n_w & 3) || pts_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const int n_ws = staged_weights(n_w, S, rays_block, true);
  const size_t smem = smem_bytes(n_ws, S, rays_block, true);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int W = width, WH = width / 2, E = levels * features, D = depth;
  const int n_dw = n_w;
  const Layout Lo =
      layout(R, S, rays_block, depth, W, enc_ld_of(E), shp_ld_of(dd), pts_per_split, n_dw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  Args a = base_args(rays_o, rays_d, sh, z, deltas, tables, wbuf, offs, n_offs, n_w, rgb, weights,
                     R, S, rays_block, depth, dd, log2_T, res, levels, features, bf16, bmin,
                     brange, mode, relu_density, white_bkgd);
  a.noise = noise; a.target = target; a.dG = dG;
  a.W = width;
  a.n_ws = n_ws;
  a.sse_part = workspace + Lo.sse_part;
  a.enc = workspace + Lo.enc; a.hs = workspace + Lo.hs; a.feat = workspace + Lo.feat;
  a.shp = workspace + Lo.shp; a.hd = workspace + Lo.hd; a.dzs = workspace + Lo.dzs;
  a.dalpha = workspace + Lo.dalpha; a.dfeat = workspace + Lo.dfeat;
  a.ddir = workspace + Lo.ddir; a.drgb = workspace + Lo.drgb;

  void (*kernel)(Args) = ingp_rays_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<Lo.n_blocks, NT, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // one dW job per (layer input segment); the view layer takes two inputs
  // ([feature, sh]), so it has two jobs writing disjoint rows
  GemmArgs G{};
  const size_t P = (size_t)R * S;
  int nj = 0, tiles = 0;
  auto add = [&](const float* A_, int lda, const float* B_, int ldb, int K, int N, int c_off,
                 int ldc, int bias_off) {
    Job& J = G.jobs[nj++];
    J.a = A_; J.lda = lda; J.b = B_; J.ldb = ldb; J.K = K; J.N = N;
    J.c_off = c_off; J.ldc = ldc; J.bias_off = bias_off;
    J.tile0 = tiles;
    J.tiles_n = (N + GT - 1) / GT;
    tiles += ((K + GT - 1) / GT) * J.tiles_n;
  };
  add(a.enc, a.enc_ld, a.dzs, W, E, W, offs[0], W, offs[1]);
  for (int j = 1; j < D; ++j)
    add(a.hs + (size_t)(j - 1) * P * W, W, a.dzs + (size_t)j * P * W, W, W, W, offs[2 * j], W,
        offs[2 * j + 1]);
  const float* h_last = a.hs + (size_t)(D - 1) * P * W;
  add(h_last, W, a.dalpha, 1, W, 1, offs[2 * D], 1, offs[2 * D + 1]);
  add(h_last, W, a.dfeat, W, W, W, offs[2 * D + 2], W, offs[2 * D + 3]);
  add(a.feat, W, a.ddir, WH, W, WH, offs[2 * D + 4], WH, offs[2 * D + 5]);
  if (dd > 0) add(a.shp, a.shp_ld, a.ddir, WH, dd, WH, offs[2 * D + 4] + W * WH, WH, -1);
  add(a.hd, WH, a.drgb, 3, WH, 3, offs[2 * D + 6], 3, offs[2 * D + 7]);
  G.n_jobs = nj;
  G.P = (long long)P;
  G.pts_per_split = pts_per_split;
  G.part_stride = Lo.part_stride;
  G.part = workspace + Lo.part;
  dw_gemm_kernel<<<dim3((unsigned)tiles, (unsigned)Lo.n_splits), GEMM_THREADS, 0, st>>>(G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  reduce_kernel<<<(n_dw + 255) / 256, 256, 0, st>>>(workspace + Lo.part, Lo.part_stride,
                                                    Lo.n_splits, dw, n_dw,
                                                    workspace + Lo.sse_part, Lo.n_blocks, sse);
  return (int)cudaGetLastError();
}
#endif  // INGP_W == 0
