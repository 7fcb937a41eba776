// Fused feature-input NeRF train kernel for Hopper (sm_90a).
//
// Replaces nerf_meets_mlx_tpu/kernels/fused_feat_train.py::_feat_train_kernel.
// Per level of the hierarchical render, one call takes the packed points
// x [R*S, C] = [feats (P) | per-point sh (DD) | delta | noise], C = P+DD+2
// (fused_feat_train.pack_feat_inputs: the features come from an encoding
// computed outside, the deltas are scaled by |d| with a terminal bin of
// 1e10*|d|, the density noise is pre-scaled), and the target colours
// [R,3], and runs
//
//   the NeRF MLP over [feats | sh] (depth D, width W, no skips, view head)
//   -> compositing (exclusive transmittance scan, both modes, white
//   background) -> rgb [R,3], weights [R,S], sse = sum |rgb - target|^2
//   -> the closed-form compositing backward and the MLP backward ->
//   d(sse)/d(every weight and bias), laid out like the weights
//   (fused_feat_train.pack_weights), and dfeats [R*S, P] = d(sse)/d(feats).
//
// The caller's encoding takes dfeats on (the hash dG kernel, or autograd
// through the plain gather).
//
// Shapes. A build instantiates one (W, PP) pair, chosen by the macros
// FEAT_W (32 or 64) and FEAT_PP (16, 32 or 64): the MLP's width and the
// register width of layer 0's input. The feature channels P (1..PP) are a
// runtime value; the columns past P are zero and layer 0's weight rows past
// P are not read. The wrapper builds each pair it meets as its own library
// (kernels/_build.py), so the pairs compile as separate translation units,
// in parallel. Every other shape -- a width that is a multiple of 16 from 32
// to 256, up to 128 feature channels -- runs in one more build, FEAT_W =
// FEAT_PP = 0, whose kernel takes the width and P at run time, as
// csrc/fused_ingp.cu's runtime-shape build does and for its reasons: a
// point's activations in local memory, 16 output columns at a time in
// registers (csrc/mlp_rt.cuh), the weights in shared memory where they fit and read through
// L1/L2 from device memory otherwise.
//
// What bounds it on this card, at the hash presets' shapes (W = 64, D = 2,
// P = 16 or 32, DD = 25): its arithmetic. At P = 32 a point costs 13,280
// MACs forward and about as many again for dW and for the cotangents: ~31
// GFLOP for the 393,216 points of a 4096 x 96 fine level, 0.47 ms at the
// 67 TFLOP/s fp32 peak, against ~0.04 ms for its bytes (x, dfeats and
// weights). In practice the latency of a thread-per-point MLP that reads
// its weights from shared memory, and the ~1.8 KB a point of activations
// and cotangents it writes for its dW GEMM, bound it (as csrc/fused_ingp.cu).
//
// Design (simple first; tensor cores and TMA are later work). The MLP
// device code is a copy of csrc/fused_ingp.cu's, kept apart so that that
// file's measured times stay its baseline:
//
// 1. feat_rays_kernel: a block of NT = 128 threads owns `rays_block` rays
//    (~512 points; one ray of up to 2048 points when S > 512) and copies the
//    MLP's weights into dynamic shared memory. Phase A, a thread per point:
//    the MLP in registers from the point's row of x, every layer's output
//    stored point-major in a device workspace. Phase B, a warp per ray: the
//    exclusive prefix of q along the ray as warp scans of 32 samples with a
//    carry from chunk to chunk (a ray may be longer than the block), the
//    composite by warp sums, the squared error, then the backward's
//    exclusive suffix sum sum_{s>t} dw_s*w_s as reverse warp scans with a
//    carry. Phase C, a thread per point: the MLP backward in registers,
//    every layer's pre-activation cotangent stored, and dfeats = W0 dZ_0
//    written with plain stores.
// 2. dw_gemm_kernel: dW = X^T dZ (and db = colsum dZ) of every layer as a
//    split-K GEMM of 64 x 64 tiles into per-split partials; layer 0 and the
//    view layer's sh rows read their inputs straight from x.
// 3. reduce_kernel: sums the splits and the per-block SSE partials in a
//    fixed order: deterministic, no atomics anywhere. The dW sums run over
//    every point of the level (393,216 at 4096 x 96), and the alpha head's
//    terms d(raw sigma) cancel, so the sums are compensated (Kahan) from
//    slice to slice and from split to split.
//
// The TPU kernel's [RBS, RBS] scan matrix CS and its U / U_first selector
// GEMMs were MXU workarounds and are not carried over.

#include <cuda_runtime.h>

#include "mlp_rt.cuh"

namespace {

constexpr int NT = 128;           // threads per block of the ray kernel
constexpr int RT_WIDTH = 256;     // the runtime-shape build's widest MLP
constexpr int RT_FEATS = 128;     // its most feature channels
constexpr int RT_DD = 64;         // its most sh channels
constexpr int NWARPS = NT / 32;
constexpr int MAX_DEPTH = 8;
constexpr int N_OFFS = 2 * (MAX_DEPTH + 4);
constexpr int GT = 64;            // dW tile edge
constexpr int KB = 16;            // points per staged dW slice
constexpr int GEMM_THREADS = 256;
constexpr int MAX_JOBS = MAX_DEPTH + 6;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr unsigned FULL = 0xffffffffu;

#ifndef FEAT_W
#define FEAT_W 64
#endif
#ifndef FEAT_PP
#define FEAT_PP 32
#endif
static_assert(FEAT_W == 0 || FEAT_W == 32 || FEAT_W == 64, "FEAT_W is 0, 32 or 64");
static_assert(FEAT_W == 0 ? FEAT_PP == 0 : (FEAT_PP == 16 || FEAT_PP == 32 || FEAT_PP == 64),
              "FEAT_PP is 16, 32 or 64 (0 with FEAT_W = 0: the runtime-shape build)");

struct Args {
  const float* x;        // [Ptot, C] feats | sh | delta | noise
  const float* target;   // [R, 3]
  const float* wbuf;     // the weights, [fan_in][fan_out] pieces (pack_weights)
  float* rgb;            // [R, 3]
  float* weights;        // [R, S]
  float* dfeats;         // [Ptot, P]
  float* sse_part;       // [n_blocks]
  float* hs;             // [D][Ptot][W]  trunk outputs (post-relu)
  float* feat;           // [Ptot][W]     feature layer output
  float* hd;             // [Ptot][W/2]   view layer output (post-relu)
  float* dzs;            // [D][Ptot][W]  trunk pre-activation cotangents
  float* dalpha;         // [Ptot]
  float* dfeat;          // [Ptot][W]
  float* ddir;           // [Ptot][W/2]
  float* drgb;           // [Ptot][3]
  long long Ptot;
  int R, S, rays_block, depth, dd, C, n_w;
  int p;                 // feature channels, <= PP
  int W;                 // the MLP's width (read by the runtime-shape build)
  int n_ws;              // floats of weights staged in shared memory: n_w or 0
  int mode;              // 0 canonical, 1 reference
  int relu_density;      // canonical: 0 softplus, 1 relu
  int white_bkgd;
  int offs[N_OFFS];      // float offsets of the pieces in wbuf
};

// acc[j] = b[j] (N a multiple of 4; b on 16 bytes)
template <int N>
__device__ __forceinline__ void load_bias(float (&acc)[N], const float* b) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(b + j);
    acc[j] = v.x; acc[j + 1] = v.y; acc[j + 2] = v.z; acc[j + 3] = v.w;
  }
}

// acc[j] += sum_k in[k] * Wm[k][j] for k < kmax (K by default), Wm
// row-major [kmax][N] in shared memory
template <int K, int N>
__device__ __forceinline__ void gemv(float (&acc)[N], const float (&in)[K], const float* Wm,
                                     int kmax = K) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k >= kmax) break;
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

// out[k] = sum_j Wm[k][j] * d[j] for k < kmax (K by default), 0 past it:
// the cotangent of a layer's input
template <int K, int N>
__device__ __forceinline__ void gemv_t(float (&out)[K], const float (&d)[N], const float* Wm,
                                       int kmax = K) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    if (k >= kmax) {
      out[k] = 0.f;
      continue;
    }
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 w = *reinterpret_cast<const float4*>(Wm + k * N + j);
      s = fmaf(w.x, d[j], s);
      s = fmaf(w.y, d[j + 1], s);
      s = fmaf(w.z, d[j + 2], s);
      s = fmaf(w.w, d[j + 3], s);
    }
    out[k] = s;
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4)
    *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
}

// out[j] = d[j] where the stored relu output hrow[j] > 0, else 0
template <int N>
__device__ __forceinline__ void relu_mask(float (&out)[N], const float (&d)[N], const float* hrow) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 h = *reinterpret_cast<const float4*>(hrow + j);
    out[j] = h.x > 0.f ? d[j] : 0.f;
    out[j + 1] = h.y > 0.f ? d[j + 1] : 0.f;
    out[j + 2] = h.z > 0.f ? d[j + 2] : 0.f;
    out[j + 3] = h.w > 0.f ? d[j + 3] : 0.f;
  }
}

// Phase A for one point: raw rgb (3) and raw sigma of the MLP on the
// point's row of x; every layer's output goes to the workspace at row gi.
template <int W, int PP>
__device__ __forceinline__ void point_forward(const Args& A, const float* sw, long long gi,
                                              float (&rgb)[3], float& sigma) {
  constexpr int WH = W / 2;
  const int D = A.depth;
  const size_t Pt = (size_t)A.Ptot;
  const float* xr = A.x + (size_t)gi * A.C;
  float e[PP];
#pragma unroll
  for (int k = 0; k < PP; ++k) e[k] = k < A.p ? __ldg(xr + k) : 0.f;

  float h[W], acc[W];
  load_bias<W>(acc, sw + A.offs[1]);
  gemv<PP, W>(acc, e, sw + A.offs[0], A.p);
#pragma unroll
  for (int j = 0; j < W; ++j) h[j] = fmaxf(acc[j], 0.f);
  store_row<W>(A.hs + (size_t)gi * W, h);
  for (int l = 1; l < D; ++l) {
    load_bias<W>(acc, sw + A.offs[2 * l + 1]);
    gemv<W, W>(acc, h, sw + A.offs[2 * l]);
#pragma unroll
    for (int j = 0; j < W; ++j) h[j] = fmaxf(acc[j], 0.f);
    store_row<W>(A.hs + (size_t)l * Pt * W + (size_t)gi * W, h);
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
  store_row<W>(A.feat + (size_t)gi * W, f);
  // view layer on [feature, sh] (W + DD -> W/2, relu)
  float hd[WH];
  const float* wd = sw + A.offs[2 * D + 4];
  load_bias<WH>(hd, sw + A.offs[2 * D + 5]);
  gemv<W, WH>(hd, f, wd);
  for (int k = 0; k < A.dd; ++k) {
    const float s = __ldg(xr + A.p + k);
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
  store_row<WH>(A.hd + (size_t)gi * WH, hd);
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
// The runtime-shape build (FEAT_W = 0): width and feature channels at run
// time; a point's vectors live in local memory, 16 output columns at a time
// in registers (as csrc/fused_ingp.cu)
// ---------------------------------------------------------------------------

// point_forward of the runtime-shape build; sw: the weights (shared or
// device memory)
__device__ __forceinline__ void point_forward_rt(const Args& A, const float* sw, long long gi,
                                                 float (&rgb)[3], float& sigma) {
  const int W = A.W, WH = W / 2, D = A.depth;
  const size_t Pt = (size_t)A.Ptot;
  const float* xr = A.x + (size_t)gi * A.C;
  float e[RT_FEATS], u[RT_WIDTH + RT_DD], v[RT_WIDTH + RT_DD];
  for (int k = 0; k < A.p; ++k) e[k] = __ldg(xr + k);
  float* h = u;
  float* g = v;
  rt_dense(h, e, A.p, sw + A.offs[0], sw + A.offs[1], W, true);
  rt_store(A.hs + (size_t)gi * W, h, W);
  for (int l = 1; l < D; ++l) {
    rt_dense(g, h, W, sw + A.offs[2 * l], sw + A.offs[2 * l + 1], W, true);
    rt_store(A.hs + (size_t)l * Pt * W + (size_t)gi * W, g, W);
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
  rt_store(A.feat + (size_t)gi * W, g, W);
  for (int k = 0; k < A.dd; ++k) g[W + k] = __ldg(xr + A.p + k);
  // view layer on [feature, sh] (W + DD -> W/2, relu)
  rt_dense(h, g, W + A.dd, sw + A.offs[2 * D + 4], sw + A.offs[2 * D + 5], WH, true);
  rt_store(A.hd + (size_t)gi * WH, h, WH);
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

// phase C for one point in the runtime-shape build: the MLP backward,
// every layer's cotangent stored, dfeats written
__device__ __forceinline__ void point_backward_rt(const Args& A, const float* sw, long long gi,
                                                  const float (&dr)[3], float dsig) {
  const int W = A.W, WH = W / 2, D = A.depth;
  const size_t Pt = (size_t)A.Ptot;
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
    const size_t o = (size_t)(D - 1) * Pt * W + (size_t)gi * W;
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
    const size_t o = (size_t)(l - 1) * Pt * W + (size_t)gi * W;
    for (int k = 0; k < W; ++k) t[k] = A.hs[o + k] > 0.f ? t[k] : 0.f;
    rt_store(A.dzs + o, t, W);
    float* tmp = dz; dz = t; t = tmp;
  }
  // d(feats) = W0 dZ_0
  float de[RT_FEATS];
  rt_dense_t(de, dz, W, sw + A.offs[0], A.p);
  float* dst = A.dfeats + (size_t)gi * A.p;
  for (int k = 0; k < A.p; ++k) dst[k] = de[k];
}

// phase C for one point of the register builds: the MLP backward, every
// layer's cotangent stored, dfeats written
template <int W, int PP>
__device__ __forceinline__ void point_backward(const Args& A, const float* sw, long long gi,
                                               const float (&dr)[3], float dsig) {
  constexpr int WH = W / 2;
  const int D = A.depth;
  const size_t Pt = (size_t)A.Ptot;
  // rgb head: d(hd) = (Wr d(raw rgb)) * (hd > 0)
  float dhd[WH];
  {
    float s[WH];
    const float* wr = sw + A.offs[2 * D + 6];
#pragma unroll
    for (int k = 0; k < WH; ++k)
      s[k] = fmaf(dr[2], wr[k * 3 + 2], fmaf(dr[1], wr[k * 3 + 1], dr[0] * wr[k * 3]));
    relu_mask<WH>(dhd, s, A.hd + (size_t)gi * WH);
    store_row<WH>(A.ddir + (size_t)gi * WH, dhd);
  }
  // feature output: d(feat) = Wd[:W] d(hd) (no activation)
  float df[W];
  gemv_t<W, WH>(df, dhd, sw + A.offs[2 * D + 4]);
  store_row<W>(A.dfeat + (size_t)gi * W, df);
  // last trunk layer: dZ = (Wf d(feat) + wa d(alpha)) * (h > 0)
  float dz[W], dh[W];
  gemv_t<W, W>(dh, df, sw + A.offs[2 * D + 2]);
  {
    const float* wa = sw + A.offs[2 * D];
#pragma unroll
    for (int k = 0; k < W; ++k) dh[k] = fmaf(wa[k], dsig, dh[k]);
    const size_t o = (size_t)(D - 1) * Pt * W + (size_t)gi * W;
    relu_mask<W>(dz, dh, A.hs + o);
    store_row<W>(A.dzs + o, dz);
  }
  for (int l = D - 1; l >= 1; --l) {
    gemv_t<W, W>(dh, dz, sw + A.offs[2 * l]);
    const size_t o = (size_t)(l - 1) * Pt * W + (size_t)gi * W;
    relu_mask<W>(dz, dh, A.hs + o);
    store_row<W>(A.dzs + o, dz);
  }
  // d(feats) = W0 dZ_0
  float de[PP];
  gemv_t<PP, W>(de, dz, sw + A.offs[0], A.p);
  float* dst = A.dfeats + (size_t)gi * A.p;
#pragma unroll
  for (int k = 0; k < PP; ++k)
    if (k < A.p) dst[k] = de[k];
}

// per-point compositing terms (fused_train._alpha_terms): q, alpha,
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int W, int PP>
__global__ void __launch_bounds__(NT, 2) feat_rays_kernel(const __grid_constant__ Args A) {
  extern __shared__ __align__(16) float smem[];
  const int S = A.S, RB = A.rays_block, C = A.C;
  float* sw = smem;                      // [n_ws] weights
  float* pc = sw + A.n_ws;               // [RB*S][3] raw rgb -> colour -> d(raw rgb)
  float* pq = pc + RB * S * 3;           // q -> d(raw sigma)
  float* pa = pq + RB * S;               // alpha -> weight
  float* pda = pa + RB * S;              // d(alpha)/dq -> T * d(alpha)/dq
  float* pdq = pda + RB * S;             // dq / d(raw sigma)
  float* rsse = pdq + RB * S;            // [RB] squared error per ray
  const int r0 = blockIdx.x * RB;
  const int nr = min(RB, A.R - r0);
  if (nr <= 0) return;
  const int npts = nr * S;
  const long long gbase = (long long)r0 * S;
  {
    const int n4 = A.n_ws / 4;
    for (int i = threadIdx.x; i < n4; i += NT)
      reinterpret_cast<float4*>(sw)[i] = __ldg(reinterpret_cast<const float4*>(A.wbuf) + i);
    __syncthreads();
  }
  // the runtime-shape build reads its weights from device memory where
  // they do not fit in shared memory
  const float* wts = W == 0 && A.n_ws == 0 ? A.wbuf : sw;

  // ---------------- phase A: forward, a thread per point ----------------
  for (int i = threadIdx.x; i < npts; i += NT) {
    const long long gi = gbase + i;
    float rgb[3], sigma;
    if constexpr (W == 0)
      point_forward_rt(A, wts, gi, rgb, sigma);
    else
      point_forward<W, PP>(A, wts, gi, rgb, sigma);
    const float* xr = A.x + (size_t)gi * C + A.p + A.dd;
    float q, alpha, da, dqd;
    alpha_terms(A, sigma + __ldg(xr + 1), __ldg(xr), q, alpha, da, dqd);
    pq[i] = q;
    pa[i] = alpha;
    pda[i] = da;
    pdq[i] = dqd;
#pragma unroll
    for (int c = 0; c < 3; ++c) pc[i * 3 + c] = A.mode == 0 ? 1.f / (1.f + expf(-rgb[c])) : rgb[c];
  }
  __syncthreads();

  // ---------------- phase B: a warp per ray, scans with a carry ----------------
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rr = warp; rr < nr; rr += NWARPS) {
    const int ray = r0 + rr;
    const int b = rr * S;
    float* wout = A.weights + (size_t)ray * S;
    // forward: T_s = exp(-sum_{t<s} q_t), w_s = alpha_s T_s, chunks of 32
    float carry = 0.f, acc = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const bool in = s < S;
      const int i = b + s;
      const float q = in ? pq[i] : 0.f;
      float incl = q;  // inclusive prefix within the chunk
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = 0.f;
      excl += carry;
      carry += __shfl_sync(FULL, incl, 31);
      if (in) {
        const float T = expf(-excl);
        const float w = pa[i] * T;
        wout[s] = w;
        c0 = fmaf(w, pc[3 * i + 0], c0);
        c1 = fmaf(w, pc[3 * i + 1], c1);
        c2 = fmaf(w, pc[3 * i + 2], c2);
        acc += w;
        pa[i] = w;
        pda[i] *= T;
      }
    }
    c0 = warp_sum(c0);
    c1 = warp_sum(c1);
    c2 = warp_sum(c2);
    acc = warp_sum(acc);
    if (A.white_bkgd) {
      const float bgc = 1.f - acc;
      c0 += bgc; c1 += bgc; c2 += bgc;
    }
    const float* tg = A.target + (size_t)ray * 3;
    const float e0 = c0 - __ldg(tg), e1 = c1 - __ldg(tg + 1), e2 = c2 - __ldg(tg + 2);
    if (lane == 0) {
      A.rgb[(size_t)ray * 3 + 0] = c0;
      A.rgb[(size_t)ray * 3 + 1] = c1;
      A.rgb[(size_t)ray * 3 + 2] = c2;
      rsse[rr] = e0 * e0 + e1 * e1 + e2 * e2;
    }
    const float g0 = 2.f * e0, g1 = 2.f * e1, g2 = 2.f * e2;
    const float gs = A.white_bkgd ? g0 + g1 + g2 : 0.f;
    // backward: dq_t = dw_t T_t alpha'_t - sum_{s>t} dw_s w_s, chunks from the end
    carry = 0.f;
    for (int s0 = ((S - 1) / 32) * 32; s0 >= 0; s0 -= 32) {
      const int s = s0 + lane;
      const bool in = s < S;
      const int i = b + s;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f, w = 0.f, dw = 0.f;
      if (in) {
        x0 = pc[3 * i + 0]; x1 = pc[3 * i + 1]; x2 = pc[3 * i + 2];
        w = pa[i];
        dw = x0 * g0 + x1 * g1 + x2 * g2 - gs;
      }
      const float v = in ? dw * w : 0.f;
      float sfx = v;  // inclusive suffix within the chunk
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(FULL, sfx, o);
        if (lane + o < 32) sfx += t;
      }
      float after = __shfl_down_sync(FULL, sfx, 1);
      if (lane == 31) after = 0.f;
      after += carry;
      carry += __shfl_sync(FULL, sfx, 0);
      if (in) {
        const float dq = dw * pda[i] - after;
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
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int rr = 0; rr < nr; ++rr) s += rsse[rr];
    A.sse_part[blockIdx.x] = s;
  }

  // ---------------- phase C: MLP backward and dfeats, a thread per point ----------------
  for (int i = threadIdx.x; i < npts; i += NT) {
    const long long gi = gbase + i;
    const float dr[3] = {pc[3 * i + 0], pc[3 * i + 1], pc[3 * i + 2]};
    const float dsig = pq[i];
    A.dalpha[gi] = dsig;
#pragma unroll
    for (int c = 0; c < 3; ++c) A.drgb[gi * 3 + c] = dr[c];
    if constexpr (W == 0)
      point_backward_rt(A, wts, gi, dr, dsig);
    else
      point_backward<W, PP>(A, wts, gi, dr, dsig);
  }
}

// ---------------------------------------------------------------------------
// dW = X^T dZ, split over the points (as csrc/fused_ingp.cu)
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
  // rows of another length (x, dalpha, drgb): four scalars, column-fastest
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

// s += v with the rounding error carried in c (Kahan); the _rn intrinsics
// keep the compiler from contracting or reassociating the steps
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = __fsub_rn(v, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
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

  // each slice's KB products are summed plainly, then added to the split's
  // running sums with compensation (Kahan): the alpha head's dW and db sum
  // d(raw sigma) over every point, terms of both signs that mostly cancel
  float acc[4][4], cmp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = cmp[i][j] = 0.f;
  float bsum[4] = {0.f, 0.f, 0.f, 0.f}, bcmp[4] = {0.f, 0.f, 0.f, 0.f};

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
    float t[4][4], tb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) t[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(As + kk * GT + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(Bs + kk * GT + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) t[i][j] = fmaf(av[i], bv[j], t[i][j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) tb[j] += bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) kahan_add(acc[i][j], cmp[i][j], t[i][j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) kahan_add(bsum[j], bcmp[j], tb[j]);
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

// dw[i] = sum over splits of part[split][i], in split order (compensated);
// sse = sum of the per-block partials, in block order.
__global__ void reduce_kernel(const float* __restrict__ part, long long stride, int n_splits,
                              float* __restrict__ dw, int n_dw,
                              const float* __restrict__ sse_part, int n_blocks,
                              float* __restrict__ sse) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_dw) {
    float s = 0.f, c = 0.f;
    for (int k = 0; k < n_splits; ++k) kahan_add(s, c, part[(size_t)k * stride + i]);
    dw[i] = s;
  }
  if (i == 0) {
    float s = 0.f;
    for (int b = 0; b < n_blocks; ++b) s += sse_part[b];
    *sse = s;
  }
}

size_t smem_bytes(int n_ws, int S, int rays_block) {
  const size_t pts = (size_t)rays_block * S;
  return sizeof(float) * ((size_t)n_ws + pts * 7 + (size_t)rays_block);
}

// floats of weights a block stages in shared memory: all of them in the
// register builds; in the runtime-shape build, all where they fit beside
// the compositing terms, else none (read from device memory)
int staged_weights(int n_w, int S, int rays_block) {
  if (FEAT_W != 0 || smem_bytes(n_w, S, rays_block) <= (size_t)MAX_SMEM) return n_w;
  return 0;
}

struct Layout {
  size_t hs, feat, hd, dzs, dalpha, dfeat, ddir, drgb, sse_part, part, total;
  long long part_stride;
  int n_blocks, n_splits;
};

Layout layout(int R, int S, int rays_block, int depth, int W, int pts_per_split, int n_dw) {
  Layout Lo{};
  const size_t P = (size_t)R * S;
  size_t o = 0;
  auto take = [&](size_t n) {
    const size_t at = o;
    o += (n + 3) / 4 * 4;  // every piece starts on 16 bytes
    return at;
  };
  Lo.hs = take((size_t)depth * P * W);
  Lo.feat = take(P * W);
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

// this build's kernel, if it takes the (width, feature channels) shape
using Kernel = void (*)(Args);

Kernel kernel_for(int W, int P) {
  if (FEAT_W == 0 && W % 16 == 0 && W >= 32 && W <= RT_WIDTH && P >= 1 && P <= RT_FEATS)
    return feat_rays_kernel<FEAT_W, FEAT_PP>;
  if (FEAT_W != 0 && W == FEAT_W && P >= 1 && P <= FEAT_PP)
    return feat_rays_kernel<FEAT_W, FEAT_PP>;
  return nullptr;
}

}  // namespace

// Shared-memory bytes one block needs (0 if this build does not take
// (width, p_dim)).
extern "C" long long fused_feat_smem_bytes(int width, int p_dim, int n_w, int S, int rays_block) {
  if (kernel_for(width, p_dim) == nullptr) return 0;
  return (long long)smem_bytes(staged_weights(n_w, S, rays_block), S, rays_block);
}

// Floats of device scratch the train launch needs.
extern "C" long long fused_feat_workspace_floats(int R, int S, int rays_block, int depth,
                                                 int width, int pts_per_split, int n_dw) {
  if (R <= 0 || S <= 0 || rays_block <= 0 || pts_per_split <= 0) return 0;
  return (long long)layout(R, S, rays_block, depth, width, pts_per_split, n_dw).total;
}

// The train call of one level: rgb [R,3], weights [R,S], sse [1], dw
// [n_dw] (the weights' layout) and dfeats [R*S, p_dim]; x [R*S, p_dim+dd+2]
// on 16 bytes; offs: the 2*(depth+4) float offsets of pack_weights (host
// array); n_w: floats of wbuf (a multiple of 4); workspace:
// fused_feat_workspace_floats floats. Returns the first cudaError_t.
extern "C" int fused_feat_train_launch(const float* x, const float* target, const float* wbuf,
                                       const int* offs, int n_offs, int n_w, float* rgb,
                                       float* weights, float* sse, float* dw, float* dfeats,
                                       float* workspace, int R, int S, int rays_block, int depth,
                                       int width, int p_dim, int dd, int mode, int relu_density,
                                       int white_bkgd, int pts_per_split, void* stream) {
  Kernel kernel = kernel_for(width, p_dim);
  if (kernel == nullptr || R < 0 || S <= 0 || rays_block <= 0 || depth < 1 ||
      depth > MAX_DEPTH || dd < 0 || dd > 64 || n_offs != 2 * (depth + 4) || (n_w & 3) ||
      pts_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const int n_ws = staged_weights(n_w, S, rays_block);
  const size_t smem = smem_bytes(n_ws, S, rays_block);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int W = width, WH = width / 2, D = depth, C = p_dim + dd + 2;
  const int n_dw = n_w;
  const Layout Lo = layout(R, S, rays_block, depth, W, pts_per_split, n_dw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  Args a{};
  a.x = x; a.target = target; a.wbuf = wbuf; a.rgb = rgb; a.weights = weights; a.dfeats = dfeats;
  a.Ptot = (long long)R * S;
  a.R = R; a.S = S; a.rays_block = rays_block; a.depth = depth; a.dd = dd; a.C = C; a.n_w = n_w;
  a.p = p_dim;
  a.W = width;
  a.n_ws = n_ws;
  a.mode = mode; a.relu_density = relu_density; a.white_bkgd = white_bkgd;
  for (int i = 0; i < n_offs; ++i) a.offs[i] = offs[i];
  a.sse_part = workspace + Lo.sse_part;
  a.hs = workspace + Lo.hs; a.feat = workspace + Lo.feat; a.hd = workspace + Lo.hd;
  a.dzs = workspace + Lo.dzs; a.dalpha = workspace + Lo.dalpha; a.dfeat = workspace + Lo.dfeat;
  a.ddir = workspace + Lo.ddir; a.drgb = workspace + Lo.drgb;

  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<Lo.n_blocks, NT, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // one dW job per (layer input segment); layer 0 reads the feats columns
  // of x and the view layer its sh columns, beside the feature output
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
  add(x, C, a.dzs, W, p_dim, W, offs[0], W, offs[1]);
  for (int j = 1; j < D; ++j)
    add(a.hs + (size_t)(j - 1) * P * W, W, a.dzs + (size_t)j * P * W, W, W, W, offs[2 * j], W,
        offs[2 * j + 1]);
  const float* h_last = a.hs + (size_t)(D - 1) * P * W;
  add(h_last, W, a.dalpha, 1, W, 1, offs[2 * D], 1, offs[2 * D + 1]);
  add(h_last, W, a.dfeat, W, W, W, offs[2 * D + 2], W, offs[2 * D + 3]);
  add(a.feat, W, a.ddir, WH, W, WH, offs[2 * D + 4], WH, offs[2 * D + 5]);
  if (dd > 0) add(x + p_dim, C, a.ddir, WH, dd, WH, offs[2 * D + 4] + W * WH, WH, -1);
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
