// Fused point-major sinusoidal encode + NeRF MLP for Hopper (sm_90a): the
// backward.
//
// Replaces nerf_meets_mlx_tpu/kernels/fused_mlp.py::_bwd_kernel (the
// Pallas kernel of fused_apply's custom VJP; the forward, ::_fwd_kernel, is
// csrc/mlp_fwd_tc.cu). The op takes points [N,3] and view directions
// [N,3], one of each per point, whose raw network output [N,4] (rgb,
// sigma) is
//
//   sinusoidal encode of the point and the direction
//   ->  D x W MLP with the skip and the view-direction head,
//
// and dout [N,4], and writes d(dout . raw)/d(every weight and bias) into
// one flat buffer laid out like the forward weights ([fan_in][fan_out]
// pieces, see fused_mlp.pack_mlp_weights) and, when asked (compute_dx),
// dX [N,6] = d/d(point, direction).
//
// What bounds it: arithmetic. At lego width (D=8, W=256, skip after layer
// 4, 10/4 bands with the raw input) a point costs the forward again
// (593,408 MACs, 1.19 MFLOP), dW (as many MACs) and the cotangents of the
// hidden layers (~3.49 MFLOP a point in all), against 40 bytes of input
// and 24 of output a point.
//
// Design, as csrc/fused_train.cu's first port (the GEMM code is a copy,
// kept apart so that its timings stay the baselines):
//
// * mlp_bwd_kernel: a block owns `block_pts` points and walks them in tiles
//   of TILE = 64. Per tile, the forward again (the Pallas backward
//   recomputes too; no activation is kept between the two calls): the
//   encoding is computed in registers and stored transposed ([feature]
//   [point]) in shared memory, each layer is a register-tiled fp32 GEMM
//   over [W][TILE] ping-pong tiles with the weights staged in 16-row
//   slices, and every layer's input goes to a device-memory workspace (a
//   point's activations, ~2,500 floats at W=256, do not fit a block's
//   shared memory); then the tile's backward from dout: the rgb and alpha
//   heads' cotangents, W^T GEMMs with the relu masks read back, each
//   layer's pre-activation cotangent dZ stored point-major. With
//   compute_dx the encoding cotangents dS are summed in shared memory
//   (layer 0, the skip layers, the view layer) and dX = (cos(T) dS) .
//   bands is written per point. A ragged last tile is computed on zero
//   inputs and masked on the way out.
// * dw_gemm_kernel: dW_l = X_l^T dZ_l and db_l = colsum(dZ_l) for every
//   layer as one split-K GEMM over the points (128 x 128 tiles), and
//   reduce_kernel sums the splits in a fixed order: deterministic, no
//   atomics (the TPU kernel summed dW in grid-invariant VMEM blocks, which
//   needs its sequential grid).
//
// The TPU kernel's 128-lane packed tile, its band matrix M and its [N,8]
// padded input and output were MXU/VMEM layouts and are not carried over.
// Plain fp32 FMAs only; tensor cores are later work. Numerics as
// fused_eval.cu: sinf/cosf without fast math, phases rounded twice.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;          // points per MLP tile
constexpr int LD = TILE + 4;      // row stride of the [feature][point] tiles
constexpr int KB = 16;            // rows per staged slice
constexpr int NTHREADS = 256;
constexpr int GT = 128;           // dW tile edge (fan_in rows x fan_out cols)
constexpr int MAX_OFFS = 80;      // 3*depth + 11 (+ dX pieces) weight-buffer offsets
constexpr int MAX_JOBS = 48;
constexpr float HALF_PI = 1.57079632679489662f;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

enum { EPI_NONE = 0, EPI_RELU = 1, EPI_MASK = 2, EPI_ADD = 3 };

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Args {
  const float* pts;       // [N, 3]
  const float* dirs;      // [N, 3]
  const float* dout;      // [N, 4]
  const float* wbuf;      // weights, biases, bands, transposed copies
  float* dx;              // [N, 6] (with compute_dx)
  // point-major stores of the backward, N rows each
  float* encP;            // [N][pos_pad] encoded position
  float* encD;            // [N][dir_pad] encoded view direction
  float* hs;              // [depth][N][W] trunk outputs (post-relu)
  float* feat;            // [N][W] feature layer output
  float* hd;              // [N][W/2] view layer output (post-relu)
  float* dzs;             // [depth][N][W] trunk pre-activation cotangents
  float* dfeat;           // [N][W]
  float* ddir;            // [N][W/2]
  long long N;
  int block_pts, depth;
  unsigned skip_mask;     // bit j set: layer j takes [encoded position, h]
  int pos_freqs, pos_inc, dir_freqs, dir_inc;
  int compute_dx;
  int offs[MAX_OFFS];     // float offsets into wbuf (fused_mlp.pack_mlp_weights)
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
// points of a tile and the first `nout` columns:
//  * EPI_RELU: max(x, 0); EPI_ADD: out += x (no activation);
//  * EPI_MASK: x where mask[p][col] > 0, else 0 (the relu derivative; mask
//    is point-major, N per row, read for the first `nvalid` points);
//  * gout (if set): the result is also written point-major (N per row) for
//    the tile's first `nvalid` points.
// bg may be null (no bias). The input is up to two shared-memory segments
// (kA rows of inA, then kB of inB), each padded to KB rows; rows past kA /
// kB read zero weights.
template <int N>
__device__ __forceinline__ void dense(const float* __restrict__ inA, int kA,
                                      const float* __restrict__ inB, int kB,
                                      const float* __restrict__ Wg,
                                      const float* __restrict__ bg, float* __restrict__ out,
                                      int nout, int epi, const float* __restrict__ mask,
                                      float* __restrict__ gout, int nvalid,
                                      float* __restrict__ wtile) {
  // a thread holds CW neighbouring columns of each of NG groups, column
  // 16*CW*n + CW*tx + j, of the N columns rounded up to NP, a multiple of
  // 16: CW is 4 where NP/16 allows it (every power of two from 64 on), else
  // 2 or 1. A group at or past N (the W/2 head of a width such as 48 has 24
  // columns) reads zero weights, computes zeros and stores nothing to
  // device memory.
  constexpr int NP = (N + 15) / 16 * 16;
  constexpr int CW = (NP / 16) % 4 == 0 ? 4 : ((NP / 16) % 2 == 0 ? 2 : 1);
  constexpr int NG = NP / (16 * CW);
  static_assert(N % 8 == 0 && N >= 8 && N <= 256, "dense takes 8..256 columns, a multiple of 8");
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
    __syncthreads();  // every thread is done with the previous slice
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int idx = tid + l * NTHREADS;
      if (idx < SLICE4) reinterpret_cast<float4*>(wtile)[idx] = stage[l];
    }
    __syncthreads();
    if (t + 1 < nT) fetch(t + 1);  // in flight during this slice's FMAs
    const float* in = t < nA ? inA + t * KB * LD : inB + (t - nA) * KB * LD;
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(in + kk * LD + 4 * ty);
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        float wv[CW] = {};
        if (N % 16 == 0 || 16 * CW * n + CW * tx < N)
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
    const bool live = N % 16 == 0 || c0 < N;
    float b[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) b[j] = bg && live ? __ldg(bg + c0 + j) : 0.f;
    float v[4][CW];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float mk[CW];
#pragma unroll
      for (int j = 0; j < CW; ++j) mk[j] = 1.f;
      if (epi == EPI_MASK) {
        // plain loads: the mask was written earlier in this launch
#pragma unroll
        for (int j = 0; j < CW; ++j) mk[j] = 0.f;
        if (live && p0 + m < nvalid) ld_cols<CW>(mask + (size_t)(p0 + m) * N + c0, mk);
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
    for (int j = 0; j < CW; ++j) {
      if (c0 + j >= nout) continue;
      float4* o = reinterpret_cast<float4*>(out + (c0 + j) * LD + p0);
      float4 r = make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
      if (epi == EPI_ADD) {
        const float4 old = *o;
        r.x += old.x; r.y += old.y; r.z += old.z; r.w += old.w;
      }
      *o = r;
    }
    if (gout) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (live && p0 + m < nvalid)
          st_cols<CW>(gout + (size_t)(p0 + m) * N + c0, v[m]);
    }
  }
  __syncthreads();
}

// dense<1> or dense<2> by the padded column count (the dX pieces)
__device__ __forceinline__ void dense_narrow(int ng, const float* in, int k, const float* Wg,
                                             float* out, int nout, int epi, float* wtile) {
  if (ng == 1)
    dense<64>(in, k, nullptr, 0, Wg, nullptr, out, nout, epi, nullptr, nullptr, 0, wtile);
  else
    dense<128>(in, k, nullptr, 0, Wg, nullptr, out, nout, epi, nullptr, nullptr, 0, wtile);
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

struct Smem {
  float *bufA, *bufB, *encP, *encD, *wtile;
};

template <int W>
__device__ __forceinline__ Smem carve(float* smem, int pos_pad, int dir_pad) {
  Smem s;
  s.bufA = smem;                     // [W][LD]
  s.bufB = s.bufA + W * LD;          // [W][LD]
  s.encP = s.bufB + W * LD;          // [pos_pad][LD]; alpha row, then dS (position)
  s.encD = s.encP + pos_pad * LD;    // [dir_pad][LD]; then dS (direction)
  s.wtile = s.encD + dir_pad * LD;   // [KB][W]
  return s;
}

// The forward of one tile (points g0 .. g0 + nv - 1), writing every
// layer's input point-major to the workspace; the two heads are left out
// (their inputs are stored, their outputs not needed).
template <int W>
__device__ __forceinline__ void forward_tile(const Args& A, const Smem& s, size_t g0, int nv) {
  constexpr int WH = W / 2;
  const int tid = threadIdx.x;
  const int pos_dim = 6 * A.pos_freqs + 3 * A.pos_inc;
  const int dir_dim = 6 * A.dir_freqs + 3 * A.dir_inc;
  const int pos_pad = round_up(pos_dim, KB), dir_pad = round_up(dir_dim, KB);
  const size_t N = (size_t)A.N;
  const int D = A.depth;
  const float* wb = A.wbuf;
  {
    const int p = tid % TILE, part = tid / TILE;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f, v0 = 0.f, v1 = 0.f, v2 = 0.f;
    if (p < nv) {
      const float* x = A.pts + (g0 + p) * 3;
      const float* v = A.dirs + (g0 + p) * 3;
      x0 = x[0]; x1 = x[1]; x2 = x[2];
      v0 = v[0]; v1 = v[1]; v2 = v[2];
    }
    const float* pos_bands = wb + A.offs[2 * D + 8];
    const float* dir_bands = wb + A.offs[2 * D + 9];
    for (int f = part; f < pos_pad; f += NTHREADS / TILE) {
      const float e = encode_feature(f, A.pos_freqs, A.pos_inc, pos_bands, x0, x1, x2);
      s.encP[f * LD + p] = e;
      if (p < nv) A.encP[(g0 + p) * pos_pad + f] = e;
    }
    for (int f = part; f < dir_pad; f += NTHREADS / TILE) {
      const float e = encode_feature(f, A.dir_freqs, A.dir_inc, dir_bands, v0, v1, v2);
      s.encD[f * LD + p] = e;
      if (p < nv) A.encD[(g0 + p) * dir_pad + f] = e;
    }
  }
  __syncthreads();

  float* h = s.bufA;
  float* g = s.bufB;
  dense<W>(s.encP, pos_dim, nullptr, 0, wb + A.offs[0], wb + A.offs[1], h, W, EPI_RELU,
                nullptr, A.hs + g0 * W, nv, s.wtile);
  for (int j = 1; j < D; ++j) {
    const float* Wj = wb + A.offs[2 * j];
    const float* bj = wb + A.offs[2 * j + 1];
    float* gout = A.hs + (size_t)j * N * W + g0 * W;
    if ((A.skip_mask >> j) & 1u)
      dense<W>(s.encP, pos_dim, h, W, Wj, bj, g, W, EPI_RELU, nullptr, gout, nv, s.wtile);
    else
      dense<W>(h, W, nullptr, 0, Wj, bj, g, W, EPI_RELU, nullptr, gout, nv, s.wtile);
    float* tmp = h; h = g; g = tmp;
  }
  // feature (W -> W, no activation), then the view layer on
  // [feature, encoded direction] (W + dir_dim -> W/2, relu)
  dense<W>(h, W, nullptr, 0, wb + A.offs[2 * D + 2], wb + A.offs[2 * D + 3], g, W, EPI_NONE,
                nullptr, A.feat + g0 * W, nv, s.wtile);
  dense<W / 2>(g, W, s.encD, dir_dim, wb + A.offs[2 * D + 4], wb + A.offs[2 * D + 5], h, WH,
                 EPI_RELU, nullptr, A.hd + g0 * WH, nv, s.wtile);
}

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1) mlp_bwd_kernel(const __grid_constant__ Args A) {
  extern __shared__ __align__(16) float smem[];
  constexpr int WH = W / 2;
  constexpr int WHP = round_up(WH, KB);
  const int pos_dim = 6 * A.pos_freqs + 3 * A.pos_inc;
  const int dir_dim = 6 * A.dir_freqs + 3 * A.dir_inc;
  const int pos_pad = round_up(pos_dim, KB), dir_pad = round_up(dir_dim, KB);
  const Smem s = carve<W>(smem, pos_pad, dir_pad);
  const int tid = threadIdx.x;
  const size_t N = (size_t)A.N;
  const int D = A.depth;
  const float* wb = A.wbuf;
  const float* wr = wb + A.offs[2 * D + 6];  // rgb head [W/2][3]
  // dX pieces (compute_dx): the encoding rows of layer 0 and of each skip
  // layer, then of the view layer, each [rows][64 * ng] (transposed)
  const int ngp = (pos_dim + 63) / 64, ngd = (dir_dim + 63) / 64;
  const int o_dx = 3 * D + 11;
  const long long b0 = (long long)blockIdx.x * A.block_pts;
  const int npts = (int)min((long long)A.block_pts, A.N - b0);

  for (int t0 = 0; t0 < npts; t0 += TILE) {
    const int nv = min(TILE, npts - t0);
    const size_t g0 = (size_t)(b0 + t0);
    forward_tile<W>(A, s, g0, nv);

    // rgb head: d(hd) = (dout[:, :3] @ Wr^T) * (hd > 0) -> bufA rows [0, W/2)
    // (rows up to W/2 rounded up to KB: the next layers read whole slices)
    for (int idx = tid; idx < TILE * WHP; idx += NTHREADS) {
      const int p = idx / WHP, c = idx - p * WHP;
      float v = 0.f;
      if (p < nv && c < WH) {
        const float* d = A.dout + (g0 + p) * 4;
        const float sum = d[0] * __ldg(wr + c * 3 + 0) + d[1] * __ldg(wr + c * 3 + 1) +
                          d[2] * __ldg(wr + c * 3 + 2);
        const size_t o = (g0 + p) * WH + c;
        v = A.hd[o] > 0.f ? sum : 0.f;
        A.ddir[o] = v;
      }
      s.bufA[c * LD + p] = v;
    }
    // the alpha head's cotangent as one input row (rows 1..KB-1 zero)
    for (int idx = tid; idx < KB * TILE; idx += NTHREADS) {
      const int r = idx / TILE, p = idx - r * TILE;
      s.encP[r * LD + p] = (r == 0 && p < nv) ? A.dout[(g0 + p) * 4 + 3] : 0.f;
    }
    __syncthreads();
    // dS of the encoded direction = d(hd) @ Wd[W:]^T
    if (A.compute_dx)
      dense_narrow(ngd, s.bufA, WH, wb + A.offs[o_dx + 1 + __popc(A.skip_mask)], s.encD, dir_dim,
                   EPI_NONE, s.wtile);
    // feature output: d(feat) = d(hd) @ Wd[:W]^T (no activation)
    dense<W>(s.bufA, WH, nullptr, 0, wb + A.offs[3 * D + 10], nullptr, s.bufB, W, EPI_NONE,
                  nullptr, A.dfeat + g0 * W, nv, s.wtile);
    // last trunk layer: dZ = (d(feat) @ Wf^T + d(alpha) * wa^T) * (h > 0)
    const size_t last = (size_t)(D - 1) * N * W + g0 * W;
    dense<W>(s.bufB, W, s.encP, 1, wb + A.offs[3 * D + 9], nullptr, s.bufA, W, EPI_MASK,
                  A.hs + last, A.dzs + last, nv, s.wtile);
    float* cur = s.bufA;
    float* nxt = s.bufB;
    int dS_epi = EPI_NONE;  // the first dS contribution sets, the others add
    for (int j = D - 1; j >= 1; --j) {
      if (A.compute_dx && ((A.skip_mask >> j) & 1u)) {
        const int k = __popc(A.skip_mask & ((2u << j) - 1u));
        dense_narrow(ngp, cur, W, wb + A.offs[o_dx + k], s.encP, pos_dim, dS_epi, s.wtile);
        dS_epi = EPI_ADD;
      }
      // dZ_{j-1} = (dZ_j @ Wh_j^T) * (h_{j-1} > 0)
      const size_t o = (size_t)(j - 1) * N * W + g0 * W;
      dense<W>(cur, W, nullptr, 0, wb + A.offs[2 * D + 10 + (j - 1)], nullptr, nxt, W,
                    EPI_MASK, A.hs + o, A.dzs + o, nv, s.wtile);
      float* tmp = cur; cur = nxt; nxt = tmp;
    }
    if (A.compute_dx) {
      dense_narrow(ngp, cur, W, wb + A.offs[o_dx], s.encP, pos_dim, dS_epi, s.wtile);
      // dX = sum over bands of b * (cos(x b) dS_sin + cos(x b + pi/2) dS_cos) + dS_raw
      for (int idx = tid; idx < TILE * 6; idx += NTHREADS) {
        const int p = idx % TILE, a = idx / TILE;
        if (p >= nv) continue;
        const bool pos = a < 3;
        const int ax = pos ? a : a - 3;
        const int F = pos ? A.pos_freqs : A.dir_freqs;
        const int inc = pos ? A.pos_inc : A.dir_inc;
        const float* dS = pos ? s.encP : s.encD;
        const float* bands = wb + A.offs[2 * D + (pos ? 8 : 9)];
        const float x = (pos ? A.pts : A.dirs)[(g0 + p) * 3 + ax];
        float sum = inc ? dS[(6 * F + ax) * LD + p] : 0.f;
        for (int j = 0; j < F; ++j) {
          const float b = __ldg(bands + j);
          const float ph = __fmul_rn(x, b);
          const float c = cosf(ph) * dS[(ax * F + j) * LD + p] +
                          cosf(__fadd_rn(ph, HALF_PI)) * dS[(3 * F + ax * F + j) * LD + p];
          sum = fmaf(b, c, sum);
        }
        A.dx[(g0 + p) * 6 + a] = sum;
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// dW = X^T dZ, split over the points (as csrc/fused_train.cu)
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
  // multiple of 4 load as float4 where the columns allow
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

// dw[i] = sum over splits of part[split][i], in split order
__global__ void reduce_kernel(const float* __restrict__ part, long long stride, int n_splits,
                              float* __restrict__ dw, int n_dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_dw) {
    float s = 0.f;
    for (int k = 0; k < n_splits; ++k) s += part[(size_t)k * stride + i];
    dw[i] = s;
  }
}

// The MLP widths a build instantiates: 32, 64, 128 and 256, or with
// -DKW=<width> that width alone, any multiple of 16 from 32 to 256
// (kernels/fused_train.py::width_defines): a width the presets do not use
// is a build of its own and adds nothing to the others' compile time.
#ifdef KW
static_assert(KW % 16 == 0 && KW >= 32 && KW <= 256, "KW is a multiple of 16 in 32..256");
bool width_ok(int w) { return w == KW; }
#define PICK_WIDTH(K, w) ((w) == KW ? K<KW> : nullptr)
#else
bool width_ok(int w) { return w == 32 || w == 64 || w == 128 || w == 256; }
#define PICK_WIDTH(K, w)                                                                    \
  ((w) == 256 ? K<256> : (w) == 128 ? K<128> : (w) == 64 ? K<64> : (w) == 32 ? K<32> : nullptr)
#endif

// the weight tile holds KB rows of the widest dense: W columns, or the dX
// pieces' up to 128
size_t smem_bytes(int W, int pos_dim, int dir_dim) {
  return sizeof(float) * ((size_t)(2 * W + round_up(pos_dim, KB) + round_up(dir_dim, KB)) * LD +
                          (size_t)KB * (W > 128 ? W : 128));
}

struct Layout {
  size_t encP, encD, hs, feat, hd, dzs, dfeat, ddir, part, total;
  long long part_stride;
  int n_splits;
};

Layout layout(long long N, int depth, int W, int pos_dim, int dir_dim, int pts_per_split,
              int n_dw) {
  Layout L{};
  const size_t P = (size_t)N;
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
  L.ddir = take(P * (W / 2));
  L.n_splits = (int)((P + pts_per_split - 1) / pts_per_split);
  L.part_stride = (n_dw + 3) / 4 * 4;
  L.part = take((size_t)L.n_splits * L.part_stride);
  L.total = o;
  return L;
}

bool valid_common(long long N, int block_pts, int depth, int width, int n_offs) {
  return N > 0 && block_pts > 0 && block_pts % TILE == 0 && depth >= 2 && n_offs <= MAX_OFFS &&
         width_ok(width);
}

Args make_args(const float* pts, const float* dirs, const float* wbuf, const int* offs,
               int n_offs, long long N, int block_pts, int depth, unsigned skip_mask,
               int pos_freqs, int pos_inc, int dir_freqs, int dir_inc) {
  Args a{};
  a.pts = pts; a.dirs = dirs; a.wbuf = wbuf;
  a.N = N; a.block_pts = block_pts; a.depth = depth; a.skip_mask = skip_mask;
  a.pos_freqs = pos_freqs; a.pos_inc = pos_inc; a.dir_freqs = dir_freqs; a.dir_inc = dir_inc;
  for (int i = 0; i < n_offs; ++i) a.offs[i] = offs[i];
  return a;
}

}  // namespace

// Shared-memory bytes one block of mlp_bwd_kernel needs (0 if the width is
// not supported); lets the wrapper check a shape before launching.
extern "C" long long fused_mlp_smem_bytes(int width, int pos_dim, int dir_dim) {
  if (!width_ok(width)) return 0;
  return (long long)smem_bytes(width, pos_dim, dir_dim);
}

// Floats of device scratch the backward launch needs.
extern "C" long long fused_mlp_workspace_floats(long long N, int depth, int width, int pos_dim,
                                                int dir_dim, int pts_per_split, int n_dw) {
  if (N <= 0 || pts_per_split <= 0) return 0;
  return (long long)layout(N, depth, width, pos_dim, dir_dim, pts_per_split, n_dw).total;
}

// Backward: dw (n_dw floats, the forward weights' layout) and, when dx is
// not null, dX [N, 6]. offs: the 3*depth + 11 offsets of pack_train_weights,
// then (with dx) those of the dX pieces. Launches the three kernels on
// `stream`; returns the first cudaError_t.
extern "C" int fused_mlp_bwd_launch(const float* pts, const float* dirs, const float* dout,
                                    const float* wbuf, const int* offs, int n_offs, float* dw,
                                    float* dx, float* workspace, long long N, int block_pts,
                                    int depth, int width, unsigned skip_mask, int pos_freqs,
                                    int pos_inc, int dir_freqs, int dir_inc, int pts_per_split,
                                    int n_dw, void* stream) {
  if (N == 0) return 0;
  const int n_skips = __builtin_popcount(skip_mask);
  const int want_offs = 3 * depth + 11 + (dx ? 2 + n_skips : 0);
  if (!valid_common(N, block_pts, depth, width, n_offs) || n_offs != want_offs ||
      pts_per_split <= 0 || n_dw <= 0)
    return (int)cudaErrorInvalidValue;
  const int W = width;
  const int pos_dim = 6 * pos_freqs + 3 * pos_inc, dir_dim = 6 * dir_freqs + 3 * dir_inc;
  if (dx && (pos_dim > 128 || dir_dim > 128)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(W, pos_dim, dir_dim);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const Layout L = layout(N, depth, W, pos_dim, dir_dim, pts_per_split, n_dw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  Args a = make_args(pts, dirs, wbuf, offs, n_offs, N, block_pts, depth, skip_mask, pos_freqs,
                     pos_inc, dir_freqs, dir_inc);
  a.dout = dout; a.dx = dx; a.compute_dx = dx != nullptr;
  a.encP = workspace + L.encP; a.encD = workspace + L.encD; a.hs = workspace + L.hs;
  a.feat = workspace + L.feat; a.hd = workspace + L.hd; a.dzs = workspace + L.dzs;
  a.dfeat = workspace + L.dfeat; a.ddir = workspace + L.ddir;

  void (*kernel)(Args) = PICK_WIDTH(mlp_bwd_kernel, W);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((N + block_pts - 1) / block_pts), NTHREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // one dW job per (layer input segment); the skip layers and the view
  // layer take two inputs each, so they have two jobs writing disjoint rows;
  // the heads' cotangents are dout's columns (row stride 4)
  GemmArgs G{};
  const size_t P = (size_t)N;
  const int D = depth, WH = W / 2;
  const int pos_pad = round_up(pos_dim, KB), dir_pad = round_up(dir_dim, KB);
  int nj = 0, tiles = 0;
  auto add = [&](const float* A_, int lda, const float* B_, int ldb, int K, int Nc, int c_off,
                 int ldc, int bias_off) {
    Job& J = G.jobs[nj++];
    J.a = A_; J.lda = lda; J.b = B_; J.ldb = ldb; J.K = K; J.N = Nc;
    J.c_off = c_off; J.ldc = ldc; J.bias_off = bias_off;
    J.tile0 = tiles;
    J.tiles_n = (Nc + GT - 1) / GT;
    tiles += ((K + GT - 1) / GT) * J.tiles_n;
  };
  if (D + 6 + n_skips > MAX_JOBS) return (int)cudaErrorInvalidValue;
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
  add(h_last, W, dout + 3, 4, W, 1, offs[2 * D], 1, offs[2 * D + 1]);
  add(h_last, W, a.dfeat, W, W, W, offs[2 * D + 2], W, offs[2 * D + 3]);
  add(a.feat, W, a.ddir, WH, W, WH, offs[2 * D + 4], WH, offs[2 * D + 5]);
  add(a.encD, dir_pad, a.ddir, WH, dir_dim, WH, offs[2 * D + 4] + W * WH, WH, -1);
  add(a.hd, WH, dout, 4, WH, 3, offs[2 * D + 6], 3, offs[2 * D + 7]);
  G.n_jobs = nj;
  G.P = (long long)P;
  G.pts_per_split = pts_per_split;
  G.part_stride = L.part_stride;
  G.part = workspace + L.part;
  dw_gemm_kernel<<<dim3((unsigned)tiles, (unsigned)L.n_splits), NTHREADS, 0, st>>>(G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  reduce_kernel<<<(n_dw + NTHREADS - 1) / NTHREADS, NTHREADS, 0, st>>>(
      workspace + L.part, L.part_stride, L.n_splits, dw, n_dw);
  return (int)cudaGetLastError();
}
