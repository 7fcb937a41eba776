// Fused NeRF train kernel for Hopper (sm_90a).
//
// Replaces nerf_meets_mlx_tpu/kernels/fused_train.py::_train_kernel (the
// Pallas kernel of fused_train_apply). Per level of the hierarchical train
// step, one call takes rays (origin, direction, view direction), sample
// depths z [R,S], deltas [R,S] (already scaled by |d|, terminal bin
// 1e10*|d|), pre-scaled density noise [R,S] and target colours [R,3], and
// writes
//
//   rgb [R,3], weights [R,S]   the forward composite (as fused_eval.cu),
//   sse                        sum over rays of |rgb - target|^2,
//   dW, db                     d(sse)/d(every weight and bias) of the MLP,
//                              one flat buffer laid out like the weights
//                              ([fan_in][fan_out] pieces, see
//                              fused_train.pack_train_weights).
//
// What bounds it: arithmetic. At the lego_hierarchical shapes a point costs
// 593,280 MACs forward, as many for dW, and ~558,000 for the cotangents of
// the hidden layers (dX of every layer but the first, without the skip's
// and the view head's encoding rows): ~3.49 MFLOP a point, 0.92 TFLOP for
// the coarse level (4096 x 64 points) and 2.74 TFLOP for the fine one
// (4096 x 192), i.e. 13.7 ms and 41.0 ms at the 67 TFLOP/s fp32 peak.
//
// Design: three launches per call, all hand-written here.
//
// 1. train_rays_kernel: a block owns `rays_block` rays and walks their
//    points in tiles of TILE = 64, exactly as fused_eval.cu does (encode in
//    registers, each dense layer a register-tiled fp32 GEMM over [feature]
//    [point] shared-memory tiles, weights staged in 16-row slices). A
//    point's activations (~2,500 floats) do not fit in shared memory for a
//    whole block, so every layer's input is also written to device memory,
//    point-major. After the last tile each ray is composited by one thread
//    (exclusive transmittance scan), its squared error and its closed-form
//    cotangents formed (g = 2*resid; dweight; the reverse suffix sum
//    dq_t = dw_t*T_t*alpha'_t - sum_{s>t} dw_s*w_s), then each tile is
//    backpropagated through the heads and the trunk (W^T GEMMs with the
//    relu masks read back from device memory), and every layer's
//    pre-activation cotangent dZ is written out, point-major.
// 2. dw_gemm_kernel: dW_l = X_l^T dZ_l (and db_l = colsum dZ_l) for every
//    layer at once, as a split-K GEMM: a block computes one 128 x 128 tile
//    of one layer over one split of the points (16 points per staged
//    slice, loaded as float4 where rows allow, 8 x 8 outputs per thread)
//    into a partial buffer.
// 3. reduce_kernel: sums the splits in a fixed order (deterministic, no
//    atomics), and the per-block SSE partials.
//
// Storing the activations costs ~20 KB a point (15.6 GB at the fine level),
// written once and read ~2-4 times: ~10 ms of the card's 3.35 TB/s at the
// fine level against the 41 ms arithmetic bound. The TPU kernel's U/E
// selector GEMMs, [S,S] scan matrix and 128-lane band packing are not
// carried over. Plain fp32 FMAs only; tensor cores are later work.
// Numerics as fused_eval.cu: sinf without fast math, phases rounded twice.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;          // points per MLP tile
constexpr int LD = TILE + 4;      // row stride of the [feature][point] tiles
constexpr int KB = 16;            // rows per staged slice
constexpr int NTHREADS = 256;
constexpr int GT = 128;           // dW tile edge (fan_in rows x fan_out cols)
constexpr int MAX_OFFS = 64;      // 3*depth + 11 weight-buffer offsets
constexpr int MAX_JOBS = 48;
constexpr float HALF_PI = 1.57079632679489662f;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

enum { EPI_NONE = 0, EPI_RELU = 1, EPI_MASK = 2 };

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Args {
  const float* rays_o;    // [R, 3]
  const float* rays_d;    // [R, 3]
  const float* viewdirs;  // [R, 3]
  const float* z;         // [R, S]
  const float* deltas;    // [R, S]
  const float* noise;     // [R, S] pre-scaled density noise
  const float* target;    // [R, 3]
  const float* wbuf;      // weights, biases, bands, transposed copies
  float* rgb;             // [R, 3]
  float* weights;         // [R, S]
  float* sse_part;        // [n_blocks]
  // point-major stores, P = R*S rows each
  float* encP;            // [P][pos_pad] encoded position
  float* encD;            // [P][dir_pad] encoded view direction
  float* hs;              // [depth][P][W] trunk outputs (post-relu)
  float* feat;            // [P][W] feature layer output
  float* hd;              // [P][W/2] view layer output (post-relu)
  float* dzs;             // [depth][P][W] trunk pre-activation cotangents
  float* dfeat;           // [P][W]
  float* dalpha;          // [P]
  float* ddir;            // [P][W/2]
  float* drgb;            // [P][3]
  long long P;
  int R, S, rays_block, depth;
  unsigned skip_mask;     // bit j set: layer j takes [encoded position, h]
  int pos_freqs, pos_inc, dir_freqs, dir_inc;
  int mode;               // 0 canonical, 1 reference
  int relu_density;       // canonical: 0 softplus, 1 relu
  int white_bkgd;
  int offs[MAX_OFFS];     // float offsets into wbuf (pack_train_weights)
};

__device__ __forceinline__ float pick(int a, float x0, float x1, float x2) {
  return a == 0 ? x0 : (a == 1 ? x1 : x2);
}

// CW neighbouring floats at p (16-byte aligned for CW = 4, 8-byte for 2)
template <int CW>
__device__ __forceinline__ void ld_cols(const float* p, float (&v)[CW]) {
  if constexpr (CW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (CW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int CW>
__device__ __forceinline__ void ldg_cols(const float* p, float (&v)[CW]) {
  if constexpr (CW == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (CW == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int CW>
__device__ __forceinline__ void st_cols(float* p, const float (&v)[CW]) {
  if constexpr (CW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (CW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// out[col][p] = epi(b[col] + sum_k in[k][p] * Wg[k][col]) for the TILE
// points of a tile, as fused_eval.cu's dense, plus:
//  * EPI_MASK: the value is kept where mask[p][col] > 0 and zeroed
//    elsewhere (the relu derivative; mask is point-major, N per row);
//  * gout (if set): the result is also written point-major (N per row)
//    for the tile's first `nvalid` points.
// bg may be null (no bias). Input segments are padded to KB rows; rows
// past kA / kB read zero weights.
template <int N>
__device__ __forceinline__ void dense(const float* __restrict__ inA, int kA,
                                      const float* __restrict__ inB, int kB,
                                      const float* __restrict__ Wg,
                                      const float* __restrict__ bg, float* __restrict__ out,
                                      int epi, const float* __restrict__ mask,
                                      float* __restrict__ gout, int nvalid,
                                      float* __restrict__ wtile) {
  // a thread holds CW neighbouring columns of each of NG groups, column
  // 16*CW*n + CW*tx + j: 4 columns a group past 64 columns, as before, and
  // 2 or 1 for the 32 and 16 columns of the narrow widths
  constexpr int CW = N >= 64 ? 4 : N / 16;
  constexpr int NG = N / (16 * CW);
  static_assert(N % 16 == 0 && N >= 16 && N <= 256, "dense takes 16..256 columns");
  constexpr int N4 = N / 4;
  constexpr int SLICE4 = KB * N4;
  constexpr int LOADS = (SLICE4 + NTHREADS - 1) / NTHREADS;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nA = round_up(kA, KB) / KB;
  const int nT = nA + round_up(kB, KB) / KB;

  float acc[4][CW * NG];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int c = 0; c < CW * NG; ++c) acc[m][c] = 0.f;

  float4 stage[LOADS];
  auto fetch = [&](int t) {
    const bool first = t < nA;
    const int k0 = (first ? t : t - nA) * KB;
    const int kreal = first ? kA : kB;
    const int row0 = (first ? 0 : kA) + k0;
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int idx = tid + l * NTHREADS;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < SLICE4) {
        const int kk = idx / N4, c4 = idx - kk * N4;
        if (k0 + kk < kreal)
          v = __ldg(reinterpret_cast<const float4*>(Wg + (size_t)(row0 + kk) * N) + c4);
      }
      stage[l] = v;
    }
  };

  fetch(0);
  for (int t = 0; t < nT; ++t) {
    __syncthreads();
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int idx = tid + l * NTHREADS;
      if (idx < SLICE4) reinterpret_cast<float4*>(wtile)[idx] = stage[l];
    }
    __syncthreads();
    if (t + 1 < nT) fetch(t + 1);
    const float* in = t < nA ? inA + t * KB * LD : inB + (t - nA) * KB * LD;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(in + kk * LD + 4 * ty);
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        float wv[CW];
        ld_cols<CW>(wtile + kk * N + 16 * CW * n + CW * tx, wv);
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          acc[0][CW * n + j] = fmaf(a.x, wv[j], acc[0][CW * n + j]);
          acc[1][CW * n + j] = fmaf(a.y, wv[j], acc[1][CW * n + j]);
          acc[2][CW * n + j] = fmaf(a.z, wv[j], acc[2][CW * n + j]);
          acc[3][CW * n + j] = fmaf(a.w, wv[j], acc[3][CW * n + j]);
        }
      }
    }
  }

  const int p0 = 4 * ty;
#pragma unroll
  for (int n = 0; n < NG; ++n) {
    const int c0 = 16 * CW * n + CW * tx;
    float b[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) b[j] = bg ? __ldg(bg + c0 + j) : 0.f;
    float v[4][CW];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float mk[CW];
#pragma unroll
      for (int j = 0; j < CW; ++j) mk[j] = 1.f;
      if (epi == EPI_MASK) {
#pragma unroll
        for (int j = 0; j < CW; ++j) mk[j] = 0.f;
        if (p0 + m < nvalid) ldg_cols<CW>(mask + (size_t)(p0 + m) * N + c0, mk);
      }
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        float x = acc[m][CW * n + j] + b[j];
        if (epi == EPI_RELU) x = fmaxf(x, 0.f);
        if (epi == EPI_MASK) x = mk[j] > 0.f ? x : 0.f;
        v[m][j] = x;
      }
    }
#pragma unroll
    for (int j = 0; j < CW; ++j)
      *reinterpret_cast<float4*>(out + (c0 + j) * LD + p0) =
          make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
    if (gout) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (p0 + m < nvalid)
          st_cols<CW>(gout + (size_t)(p0 + m) * N + c0, v[m]);
    }
  }
  __syncthreads();
}

// Encoded features of one point: sines, cosines as sin(x*b + pi/2), then
// the raw input; rows past the feature count are zero.
__device__ __forceinline__ float encode_feature(int f, int F, int inc, const float* bands,
                                                float x0, float x1, float x2) {
  if (f < 3 * F) {
    const int a = f / F, j = f - a * F;
    return sinf(__fmul_rn(pick(a, x0, x1, x2), __ldg(bands + j)));
  }
  if (f < 6 * F) {
    const int g = f - 3 * F, a = g / F, j = g - a * F;
    return sinf(__fadd_rn(__fmul_rn(pick(a, x0, x1, x2), __ldg(bands + j)), HALF_PI));
  }
  if (inc && f < 6 * F + 3) return pick(f - 6 * F, x0, x1, x2);
  return 0.f;
}

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1) train_rays_kernel(const __grid_constant__ Args A) {
  extern __shared__ __align__(16) float smem[];
  constexpr int WH = W / 2;
  const int pos_dim = 6 * A.pos_freqs + 3 * A.pos_inc;
  const int dir_dim = 6 * A.dir_freqs + 3 * A.dir_inc;
  const int pos_pad = round_up(pos_dim, KB), dir_pad = round_up(dir_dim, KB);
  const int S = A.S, RB = A.rays_block;

  float* bufA = smem;                   // [W][LD]
  float* bufB = bufA + W * LD;          // [W][LD]
  float* encP = bufB + W * LD;          // [pos_pad][LD]; the sigma row in backward
  float* encD = encP + pos_pad * LD;    // [dir_pad][LD]
  float* wtile = encD + dir_pad * LD;   // [KB][W]
  float* pc = wtile + KB * W;           // [RB*S][3] raw rgb -> colour -> d(raw rgb)
  float* pq = pc + RB * S * 3;          // raw sigma -> q -> d(raw sigma)
  float* pa = pq + RB * S;              // alpha -> weight
  float* pda = pa + RB * S;             // d(alpha)/dq -> T * d(alpha)/dq
  float* pdq = pda + RB * S;            // dq / d(raw sigma)
  float* rsse = pdq + RB * S;           // [RB] squared error per ray

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * RB;
  const int nr = min(RB, A.R - r0);
  if (nr <= 0) return;
  const int npts = nr * S;
  const size_t P = (size_t)A.P;
  const size_t gbase = (size_t)r0 * S;  // the block's first point
  const int D = A.depth;
  const float* wb = A.wbuf;
  const float* pos_bands = wb + A.offs[2 * D + 8];
  const float* dir_bands = wb + A.offs[2 * D + 9];

  // ---------------- forward, tile by tile ----------------
  for (int t0 = 0; t0 < npts; t0 += TILE) {
    const int nv = min(TILE, npts - t0);
    const size_t g0 = gbase + t0;
    {
      const int p = tid % TILE, part = tid / TILE;
      const int i = t0 + p;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f, v0 = 0.f, v1 = 0.f, v2 = 0.f;
      if (i < npts) {
        const int ray = r0 + i / S;
        const float zz = A.z[gbase + i];
        const float* o = A.rays_o + (size_t)ray * 3;
        const float* d = A.rays_d + (size_t)ray * 3;
        const float* vd = A.viewdirs + (size_t)ray * 3;
        x0 = __fadd_rn(o[0], __fmul_rn(zz, d[0]));
        x1 = __fadd_rn(o[1], __fmul_rn(zz, d[1]));
        x2 = __fadd_rn(o[2], __fmul_rn(zz, d[2]));
        v0 = vd[0]; v1 = vd[1]; v2 = vd[2];
      }
      for (int f = part; f < pos_pad; f += NTHREADS / TILE) {
        const float e = encode_feature(f, A.pos_freqs, A.pos_inc, pos_bands, x0, x1, x2);
        encP[f * LD + p] = e;
        if (p < nv) A.encP[(g0 + p) * pos_pad + f] = e;
      }
      for (int f = part; f < dir_pad; f += NTHREADS / TILE) {
        const float e = encode_feature(f, A.dir_freqs, A.dir_inc, dir_bands, v0, v1, v2);
        encD[f * LD + p] = e;
        if (p < nv) A.encD[(g0 + p) * dir_pad + f] = e;
      }
    }
    __syncthreads();

    float* h = bufA;
    float* g = bufB;
    dense<W>(encP, pos_dim, nullptr, 0, wb + A.offs[0], wb + A.offs[1], h, EPI_RELU,
                  nullptr, A.hs + g0 * W, nv, wtile);
    for (int j = 1; j < D; ++j) {
      const float* Wj = wb + A.offs[2 * j];
      const float* bj = wb + A.offs[2 * j + 1];
      float* gout = A.hs + (size_t)j * P * W + g0 * W;
      if ((A.skip_mask >> j) & 1u)
        dense<W>(encP, pos_dim, h, W, Wj, bj, g, EPI_RELU, nullptr, gout, nv, wtile);
      else
        dense<W>(h, W, nullptr, 0, Wj, bj, g, EPI_RELU, nullptr, gout, nv, wtile);
      float* tmp = h; h = g; g = tmp;
    }
    // alpha head (W -> 1) from the last hidden layer
    if (tid < TILE) {
      const float* wa = wb + A.offs[2 * D];
      float a = __ldg(wb + A.offs[2 * D + 1]);
      for (int k = 0; k < W; ++k) a = fmaf(h[k * LD + tid], __ldg(wa + k), a);
      if (tid < nv) pq[t0 + tid] = a;
    }
    // feature (W -> W, no activation), then the view layer on
    // [feature, encoded direction] (W + dir_dim -> W/2, relu)
    dense<W>(h, W, nullptr, 0, wb + A.offs[2 * D + 2], wb + A.offs[2 * D + 3], g, EPI_NONE,
                  nullptr, A.feat + g0 * W, nv, wtile);
    dense<W / 2>(g, W, encD, dir_dim, wb + A.offs[2 * D + 4], wb + A.offs[2 * D + 5], h,
                   EPI_RELU, nullptr, A.hd + g0 * WH, nv, wtile);
    // rgb head (W/2 -> 3)
    if (tid < 3 * TILE) {
      const int p = tid % TILE, c = tid / TILE;
      const float* wr = wb + A.offs[2 * D + 6];
      float v = __ldg(wb + A.offs[2 * D + 7] + c);
      for (int k = 0; k < WH; ++k) v = fmaf(h[k * LD + p], __ldg(wr + k * 3 + c), v);
      if (p < nv) pc[(t0 + p) * 3 + c] = v;
    }
    __syncthreads();
  }

  // ---------------- per-point compositing terms (_alpha_terms) ----------------
  for (int i = tid; i < npts; i += NTHREADS) {
    const float delta = A.deltas[gbase + i];
    const float raw = pq[i] + A.noise[gbase + i];
    float q, alpha, da, dqd;
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
    pq[i] = q;
    pa[i] = alpha;
    pda[i] = da;
    pdq[i] = dqd;
    if (A.mode == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) pc[i * 3 + c] = 1.f / (1.f + expf(-pc[i * 3 + c]));
    }
  }
  __syncthreads();

  // ---------------- per ray: scan, composite, loss, closed-form backward ----------------
  for (int rr = tid; rr < nr; rr += NTHREADS) {
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
    // d(sse)/d(rgb) = 2*resid; the white background adds -sum(g) to every
    // weight's cotangent
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
  if (tid == 0) {
    float s = 0.f;
    for (int rr = 0; rr < nr; ++rr) s += rsse[rr];
    A.sse_part[blockIdx.x] = s;
  }

  // ---------------- backward, tile by tile ----------------
  const float* wr = wb + A.offs[2 * D + 6];  // rgb head [W/2][3]
  for (int t0 = 0; t0 < npts; t0 += TILE) {
    const int nv = min(TILE, npts - t0);
    const size_t g0 = gbase + t0;
    // rgb head: d(hd) = (d(raw rgb) @ Wr^T) * (hd > 0) -> bufA rows [0, W/2)
    for (int idx = tid; idx < TILE * WH; idx += NTHREADS) {
      const int p = idx / WH, c = idx - p * WH;
      float v = 0.f;
      if (p < nv) {
        const float* d = pc + (t0 + p) * 3;
        const float s = d[0] * __ldg(wr + c * 3 + 0) + d[1] * __ldg(wr + c * 3 + 1) +
                        d[2] * __ldg(wr + c * 3 + 2);
        const size_t o = (g0 + p) * WH + c;
        v = A.hd[o] > 0.f ? s : 0.f;
        A.ddir[o] = v;
      }
      bufA[c * LD + p] = v;
    }
    // the alpha head's cotangent as one input row (rows 1..KB-1 zero)
    for (int idx = tid; idx < KB * TILE; idx += NTHREADS) {
      const int r = idx / TILE, p = idx - r * TILE;
      encP[r * LD + p] = (r == 0 && p < nv) ? pq[t0 + p] : 0.f;
    }
    if (tid < nv) {
      const size_t gp = g0 + tid;
      A.dalpha[gp] = pq[t0 + tid];
#pragma unroll
      for (int c = 0; c < 3; ++c) A.drgb[gp * 3 + c] = pc[(t0 + tid) * 3 + c];
    }
    __syncthreads();
    // feature output: d(feat) = d(hd) @ Wd[:W]^T (no activation)
    dense<W>(bufA, WH, nullptr, 0, wb + A.offs[3 * D + 10], nullptr, bufB, EPI_NONE,
                  nullptr, A.dfeat + g0 * W, nv, wtile);
    // last trunk layer: dZ = (d(feat) @ Wf^T + d(alpha) * wa^T) * (h > 0)
    const size_t last = (size_t)(D - 1) * P * W + g0 * W;
    dense<W>(bufB, W, encP, 1, wb + A.offs[3 * D + 9], nullptr, bufA, EPI_MASK,
                  A.hs + last, A.dzs + last, nv, wtile);
    float* cur = bufA;
    float* nxt = bufB;
    for (int j = D - 1; j >= 1; --j) {
      // dZ_{j-1} = (dZ_j @ Wh_j^T) * (h_{j-1} > 0); the skip's encoding
      // rows get no cotangent (the encoding has no parameters)
      const size_t o = (size_t)(j - 1) * P * W + g0 * W;
      dense<W>(cur, W, nullptr, 0, wb + A.offs[2 * D + 10 + (j - 1)], nullptr, nxt, EPI_MASK,
                    A.hs + o, A.dzs + o, nv, wtile);
      float* tmp = cur; cur = nxt; nxt = tmp;
    }
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

template <bool BIAS>
__device__ __forceinline__ void dw_tile(const Job& J, int k0, int n0, long long pb, long long pe,
                                        float* __restrict__ out, float* __restrict__ As,
                                        float* __restrict__ Bs) {
  constexpr int PER = KB * GT / NTHREADS;  // staged values per thread and operand
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float bsum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bsum[j] = 0.f;

  // a slice is KB points x GT columns of an operand, staged in registers
  // while the previous slice is multiplied; rows whose length is a
  // multiple of 4 load as float4 (all but dalpha's and drgb's)
  float sa[PER], sb[PER];
  const bool va = (J.lda & 3) == 0, vb = (J.ldb & 3) == 0;
  auto load_slice = [&](float* dst, const float* src, long long ld, int c0, int lim, bool vec,
                        long long p0) {
    if (vec) {
#pragma unroll
      for (int l = 0; l < PER / 4; ++l) {
        const int idx = tid + l * NTHREADS;
        const int pp = idx / (GT / 4), c = 4 * (idx - pp * (GT / 4));
        const long long p = p0 + pp;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < pe) {
          if (c0 + c + 3 < lim) {
            v = __ldg(reinterpret_cast<const float4*>(src + p * ld + c0 + c));
          } else {
            if (c0 + c + 0 < lim) v.x = __ldg(src + p * ld + c0 + c + 0);
            if (c0 + c + 1 < lim) v.y = __ldg(src + p * ld + c0 + c + 1);
            if (c0 + c + 2 < lim) v.z = __ldg(src + p * ld + c0 + c + 2);
          }
        }
        dst[4 * l + 0] = v.x; dst[4 * l + 1] = v.y; dst[4 * l + 2] = v.z; dst[4 * l + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int l = 0; l < PER; ++l) {
        const int idx = tid + l * NTHREADS;
        const int pp = idx / GT, col = idx - pp * GT;
        const long long p = p0 + pp;
        dst[l] = (p < pe && c0 + col < lim) ? __ldg(src + p * ld + c0 + col) : 0.f;
      }
    }
  };
  auto fetch = [&](long long p0) {
    load_slice(sa, J.a, J.lda, k0, J.K, va, p0);
    load_slice(sb, J.b, J.ldb, n0, J.N, vb, p0);
  };
  auto stash = [&](float* dst, const float* src, bool vec) {
    if (vec) {
#pragma unroll
      for (int l = 0; l < PER / 4; ++l)
        reinterpret_cast<float4*>(dst)[tid + l * NTHREADS] =
            make_float4(src[4 * l], src[4 * l + 1], src[4 * l + 2], src[4 * l + 3]);
    } else {
#pragma unroll
      for (int l = 0; l < PER; ++l) dst[tid + l * NTHREADS] = src[l];
    }
  };

  fetch(pb);
  for (long long p0 = pb; p0 < pe; p0 += KB) {
    __syncthreads();
    stash(As, sa, va);
    stash(Bs, sb, vb);
    __syncthreads();
    if (p0 + KB < pe) fetch(p0 + KB);
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * GT + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * GT + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * GT + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * GT + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if (BIAS) {
#pragma unroll
        for (int j = 0; j < 8; ++j) bsum[j] += bv[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (k >= J.K) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (n < J.N) out[J.c_off + (size_t)k * J.ldc + n] = acc[i][j];
    }
  }
  if (BIAS && ty == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (n < J.N) out[J.bias_off + n] = bsum[j];
    }
  }
}

__global__ void __launch_bounds__(NTHREADS) dw_gemm_kernel(const __grid_constant__ GemmArgs G) {
  __shared__ __align__(16) float As[KB * GT];
  __shared__ __align__(16) float Bs[KB * GT];
  const int t = blockIdx.x;
  int j = 0;
  while (j + 1 < G.n_jobs && G.jobs[j + 1].tile0 <= t) ++j;
  const Job& J = G.jobs[j];
  const int local = t - J.tile0;
  const int k0 = (local / J.tiles_n) * GT, n0 = (local % J.tiles_n) * GT;
  const long long pb = (long long)blockIdx.y * G.pts_per_split;
  const long long pe = min(G.P, pb + (long long)G.pts_per_split);
  float* out = G.part + (size_t)blockIdx.y * G.part_stride;
  if (J.bias_off >= 0 && k0 == 0)
    dw_tile<true>(J, k0, n0, pb, pe, out, As, Bs);
  else
    dw_tile<false>(J, k0, n0, pb, pe, out, As, Bs);
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

bool width_ok(int w) { return w == 32 || w == 64 || w == 128 || w == 256; }

size_t smem_bytes(int W, int S, int rays_block, int pos_dim, int dir_dim) {
  return sizeof(float) * ((size_t)(2 * W + round_up(pos_dim, KB) + round_up(dir_dim, KB)) * LD +
                          (size_t)KB * W + (size_t)rays_block * S * 7 + (size_t)rays_block);
}

struct Layout {
  size_t encP, encD, hs, feat, hd, dzs, dfeat, dalpha, ddir, drgb, sse_part, part, total;
  long long part_stride;
  int n_blocks, n_splits;
};

Layout layout(int R, int S, int rays_block, int depth, int W, int pos_dim, int dir_dim,
              int pts_per_split, int n_dw) {
  Layout L{};
  const size_t P = (size_t)R * S;
  size_t o = 0;
  auto take = [&](size_t n) {
    const size_t at = o;
    o += (n + 3) / 4 * 4;  // every piece starts on 16 bytes
    return at;
  };
  L.encP = take(P * round_up(pos_dim, KB));
  L.encD = take(P * round_up(dir_dim, KB));
  L.hs = take((size_t)depth * P * W);
  L.feat = take(P * W);
  L.hd = take(P * (W / 2));
  L.dzs = take((size_t)depth * P * W);
  L.dfeat = take(P * W);
  L.dalpha = take(P);
  L.ddir = take(P * (W / 2));
  L.drgb = take(P * 3);
  L.n_blocks = (R + rays_block - 1) / rays_block;
  L.sse_part = take((size_t)L.n_blocks);
  L.n_splits = (int)((P + pts_per_split - 1) / pts_per_split);
  L.part_stride = (n_dw + 3) / 4 * 4;
  L.part = take((size_t)L.n_splits * L.part_stride);
  L.total = o;
  return L;
}

}  // namespace

// Shared-memory bytes one block of train_rays_kernel needs (0 if the width
// is not supported); lets the wrapper check a shape before launching.
extern "C" long long fused_train_smem_bytes(int width, int S, int rays_block, int pos_dim,
                                            int dir_dim) {
  if (!width_ok(width)) return 0;
  return (long long)smem_bytes(width, S, rays_block, pos_dim, dir_dim);
}

// Floats of device scratch the launch below needs.
extern "C" long long fused_train_workspace_floats(int R, int S, int rays_block, int depth,
                                                  int width, int pos_dim, int dir_dim,
                                                  int pts_per_split, int n_dw) {
  if (R <= 0 || S <= 0 || rays_block <= 0 || pts_per_split <= 0) return 0;
  return (long long)layout(R, S, rays_block, depth, width, pos_dim, dir_dim, pts_per_split, n_dw)
      .total;
}

// Launches the three kernels on `stream`; returns the first cudaError_t.
// offs: the 3*depth + 11 float offsets of pack_train_weights (host array).
extern "C" int fused_train_launch(const float* rays_o, const float* rays_d, const float* viewdirs,
                                  const float* z, const float* deltas, const float* noise,
                                  const float* target, const float* wbuf, const int* offs,
                                  int n_offs, float* rgb, float* weights, float* sse, float* dw,
                                  float* workspace, int R, int S, int rays_block, int depth,
                                  int width, unsigned skip_mask, int pos_freqs, int pos_inc,
                                  int dir_freqs, int dir_inc, int mode, int relu_density,
                                  int white_bkgd, int pts_per_split, int n_dw, void* stream) {
  if (R <= 0) return 0;
  if (S <= 0 || rays_block <= 0 || depth <= 1 || pts_per_split <= 0 || n_dw <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_offs != 3 * depth + 11 || n_offs > MAX_OFFS) return (int)cudaErrorInvalidValue;
  if (!width_ok(width)) return (int)cudaErrorInvalidValue;
  const int W = width;
  const int pos_dim = 6 * pos_freqs + 3 * pos_inc, dir_dim = 6 * dir_freqs + 3 * dir_inc;
  const size_t smem = smem_bytes(W, S, rays_block, pos_dim, dir_dim);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const Layout L = layout(R, S, rays_block, depth, W, pos_dim, dir_dim, pts_per_split, n_dw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  Args a{};
  a.rays_o = rays_o; a.rays_d = rays_d; a.viewdirs = viewdirs;
  a.z = z; a.deltas = deltas; a.noise = noise; a.target = target; a.wbuf = wbuf;
  a.rgb = rgb; a.weights = weights; a.sse_part = workspace + L.sse_part;
  a.encP = workspace + L.encP; a.encD = workspace + L.encD; a.hs = workspace + L.hs;
  a.feat = workspace + L.feat; a.hd = workspace + L.hd; a.dzs = workspace + L.dzs;
  a.dfeat = workspace + L.dfeat; a.dalpha = workspace + L.dalpha;
  a.ddir = workspace + L.ddir; a.drgb = workspace + L.drgb;
  a.P = (long long)R * S;
  a.R = R; a.S = S; a.rays_block = rays_block; a.depth = depth; a.skip_mask = skip_mask;
  a.pos_freqs = pos_freqs; a.pos_inc = pos_inc; a.dir_freqs = dir_freqs; a.dir_inc = dir_inc;
  a.mode = mode; a.relu_density = relu_density; a.white_bkgd = white_bkgd;
  for (int i = 0; i < n_offs; ++i) a.offs[i] = offs[i];

  void (*kernel)(Args) = W == 256   ? train_rays_kernel<256>
                         : W == 128 ? train_rays_kernel<128>
                         : W == 64  ? train_rays_kernel<64>
                                    : train_rays_kernel<32>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<L.n_blocks, NTHREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // one dW job per (layer input segment); the skip layer and the view layer
  // take two inputs each, so they have two jobs writing disjoint rows
  GemmArgs G{};
  const size_t P = (size_t)R * S;
  const int D = depth, WH = W / 2;
  const int pos_pad = round_up(pos_dim, KB), dir_pad = round_up(dir_dim, KB);
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
  if (D + 6 + __builtin_popcount(skip_mask) > MAX_JOBS) return (int)cudaErrorInvalidValue;
  add(a.encP, pos_pad, a.dzs, W, pos_dim, W, offs[0], W, offs[1]);
  for (int j = 1; j < D; ++j) {
    const float* dz = a.dzs + (size_t)j * P * W;
    const float* hprev = a.hs + (size_t)(j - 1) * P * W;
    if ((skip_mask >> j) & 1u) {
      add(a.encP, pos_pad, dz, W, pos_dim, W, offs[2 * j], W, offs[2 * j + 1]);
      add(hprev, W, dz, W, W, W, offs[2 * j] + pos_dim * W, W, -1);
    } else {
      add(hprev, W, dz, W, W, W, offs[2 * j], W, offs[2 * j + 1]);
    }
  }
  const float* h_last = a.hs + (size_t)(D - 1) * P * W;
  add(h_last, W, a.dalpha, 1, W, 1, offs[2 * D], 1, offs[2 * D + 1]);
  add(h_last, W, a.dfeat, W, W, W, offs[2 * D + 2], W, offs[2 * D + 3]);
  add(a.feat, W, a.ddir, WH, W, WH, offs[2 * D + 4], WH, offs[2 * D + 5]);
  add(a.encD, dir_pad, a.ddir, WH, dir_dim, WH, offs[2 * D + 4] + W * WH, WH, -1);
  add(a.hd, WH, a.drgb, 3, WH, 3, offs[2 * D + 6], 3, offs[2 * D + 7]);
  G.n_jobs = nj;
  G.P = (long long)P;
  G.pts_per_split = pts_per_split;
  G.part_stride = L.part_stride;
  G.part = workspace + L.part;
  dw_gemm_kernel<<<dim3((unsigned)tiles, (unsigned)L.n_splits), NTHREADS, 0, st>>>(G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  reduce_kernel<<<(n_dw + NTHREADS - 1) / NTHREADS, NTHREADS, 0, st>>>(
      workspace + L.part, L.part_stride, L.n_splits, dw, n_dw, workspace + L.sse_part, L.n_blocks,
      sse);
  return (int)cudaGetLastError();
}
