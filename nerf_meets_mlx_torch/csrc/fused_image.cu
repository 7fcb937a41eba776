// Fused 2-D image-learning MLP for Hopper (sm_90a): the train step's
// forward + loss + backward, and the forward alone.
//
// Replaces nerf_meets_mlx_tpu/kernels/fused_image.py::_train_kernel (train)
// and ::_fwd_kernel (forward). The op takes pixel coordinates x [N, d]
// (d = 2 for the image task) and runs
//
//   sinusoidal encode (sin of x_a*b_j, a-major; then the cosines as
//   sin(x_a*b_j + pi/2); then x itself when include_input)
//   -> D x W relu MLP with the encoded input concatenated (input-first) at
//   the skip layers -> output head W -> out_ch (no activation),
//
// writing the output [N, out_ch] (forward), or, given target colours
// [N, out_ch], sse = sum over the N rows and out_ch columns of
// (out - target)^2 and d(sse)/d(every weight and bias) in one flat buffer
// laid out like the forward weights (fused_image.pack_image_weights). The
// encoding has no parameters and gets no gradient.
//
// What bounds it: arithmetic. At image2d's shapes (D = 8, W = 256, skip
// after layer 4, 10 bands of 2 axes, no raw input: 40 features) a pixel
// costs 480,000 MACs forward; the train call adds dW (as many) and the
// hidden layers' cotangents (~0.46M): ~2.9 MFLOP a pixel, 11.8 GFLOP at
// 4096 pixels (0.18 ms at the 67 TFLOP/s fp32 peak), against 20 bytes of
// input a pixel; a 400 x 400 frame forward is ~154 GFLOP (2.3 ms).
//
// Design: the register-tiled fp32 GEMM over shared-memory point tiles, the
// split-K dW GEMM and the fixed-order reduction are copies of
// csrc/fused_mlp.cu's, kept apart so that that file's measured times stay
// its baseline:
//
// * image_fwd_kernel: a block owns `block_pts` points and walks them in
//   tiles of TILE = 64. The encoding is computed per point in registers and
//   stored transposed ([feature][point]) in shared memory; each layer is a
//   GEMM over [W][TILE] ping-pong tiles with the weights staged in 16-row
//   slices. Nothing but the output leaves the chip.
// * image_train_kernel: per tile, the same forward, storing the encoding
//   and every layer's output point-major in a device-memory workspace; the
//   output head and the squared error against the target (ragged rows
//   masked), dout = 2 (out - target); then the backward: the head's
//   cotangent through the last relu, and W^T GEMMs with the relu masks read
//   back, each layer's pre-activation cotangent dZ stored point-major. The
//   per-block sse is summed in a fixed order.
// * dw_gemm_kernel: dW_l = X_l^T dZ_l and db_l = colsum(dZ_l) for every
//   layer as one split-K GEMM over the points (128 x 128 tiles), and
//   reduce_kernel sums the splits and the block sse in a fixed order:
//   deterministic, no atomics.
//
// The TPU kernel's band matrix M [8, SW] with its phase row, the
// zero-extended skip rows and the [N, 8] padded input, target and output
// were MXU/VMEM layouts and are not carried over. Plain fp32 FMAs;
// sinf without fast math, phases rounded as the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;          // points per MLP tile
constexpr int LD = TILE + 4;      // row stride of the [feature][point] tiles
constexpr int KB = 16;            // rows per staged slice
constexpr int NTHREADS = 256;
constexpr int GT = 128;           // dW tile edge (fan_in rows x fan_out cols)
constexpr int MAX_OFFS = 64;      // 3*depth + 2 weight-buffer offsets
constexpr int MAX_JOBS = 48;
constexpr int MAX_OUT = 4;        // output channels
constexpr int MAX_ENC = 128;      // encoded features
constexpr float HALF_PI = 1.57079632679489662f;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

enum { EPI_NONE = 0, EPI_RELU = 1, EPI_MASK = 2 };

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Args {
  const float* x;         // [N, in_dim]
  const float* target;    // [N, out_ch] (train)
  const float* wbuf;      // weights, biases, bands, transposed copies
  float* out;             // [N, out_ch] (forward)
  float* sse_part;        // [n_blocks] (train)
  // point-major stores of the train kernel, N rows each
  float* enc;             // [N][enc_pad] encoded input
  float* hs;              // [depth][N][W] trunk outputs (post-relu)
  float* dzs;             // [depth][N][W] trunk pre-activation cotangents
  float* dout;            // [N][out_ch] d(sse)/d(out)
  long long N;
  int block_pts, depth, in_dim, n_freqs, include_input, out_ch;
  unsigned skip_mask;     // bit j set: layer j takes [encoded input, h]
  int offs[MAX_OFFS];     // float offsets into wbuf (fused_image.pack_image_weights)
};

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
//  * EPI_RELU: max(x, 0);
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
        // plain loads: the mask was written earlier in this launch
#pragma unroll
        for (int j = 0; j < CW; ++j) mk[j] = 0.f;
        if (p0 + m < nvalid) ld_cols<CW>(mask + (size_t)(p0 + m) * N + c0, mk);
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
      *reinterpret_cast<float4*>(out + (c0 + j) * LD + p0) =
          make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
    }
    if (gout) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (p0 + m < nvalid)
          st_cols<CW>(gout + (size_t)(p0 + m) * N + c0, v[m]);
    }
  }
  __syncthreads();
}

// Encoded feature f of one point (coordinates xs[0..d)): sines, cosines as
// sin(x*b + pi/2), then the raw input; rows past the feature count are zero.
__device__ __forceinline__ float encode_feature(int f, int d, int F, int inc, const float* bands,
                                                const float (&xs)[3]) {
  if (f < d * F) {
    const int a = f / F, j = f - a * F;
    return sinf(__fmul_rn(xs[a], __ldg(bands + j)));
  }
  if (f < 2 * d * F) {
    const int g = f - d * F, a = g / F, j = g - a * F;
    return sinf(__fadd_rn(__fmul_rn(xs[a], __ldg(bands + j)), HALF_PI));
  }
  if (inc && f < 2 * d * F + d) return xs[f - 2 * d * F];
  return 0.f;
}

__host__ __device__ inline int enc_dim_of(int d, int F, int inc) { return 2 * d * F + (inc ? d : 0); }

struct Smem {
  float *bufA, *bufB, *enc, *wtile, *dsm, *red;
};

template <int W>
__device__ __forceinline__ Smem carve(float* smem, int enc_pad) {
  Smem s;
  s.bufA = smem;                     // [W][LD]
  s.bufB = s.bufA + W * LD;          // [W][LD]
  s.enc = s.bufB + W * LD;           // [enc_pad][LD]
  s.wtile = s.enc + enc_pad * LD;    // [KB][W]
  s.dsm = s.wtile + KB * W;          // [TILE][MAX_OUT] d(sse)/d(out)
  s.red = s.dsm + TILE * MAX_OUT;    // [NTHREADS] sse partials
  return s;
}

// The forward of one tile (points g0 .. g0 + nv - 1). TRAIN: store the
// encoding and every layer's output point-major, and turn the output head
// into the tile's squared error (added to sse) and dout; otherwise write
// the output [nv, out_ch].
template <int W, bool TRAIN>
__device__ __forceinline__ void forward_tile(const Args& A, const Smem& s, size_t g0, int nv,
                                             float& sse) {
  const int tid = threadIdx.x;
  const int d = A.in_dim, F = A.n_freqs, oc = A.out_ch;
  const int enc_dim = enc_dim_of(d, F, A.include_input), enc_pad = round_up(enc_dim, KB);
  const size_t N = (size_t)A.N;
  const int D = A.depth;
  const float* wb = A.wbuf;
  {
    const int p = tid % TILE, part = tid / TILE;
    float xs[3] = {0.f, 0.f, 0.f};
    if (p < nv)
      for (int a = 0; a < d; ++a) xs[a] = __ldg(A.x + (g0 + p) * d + a);
    const float* bands = wb + A.offs[2 * D + 2];
    for (int f = part; f < enc_pad; f += NTHREADS / TILE) {
      const float e = encode_feature(f, d, F, A.include_input, bands, xs);
      s.enc[f * LD + p] = e;
      if (TRAIN && p < nv) A.enc[(g0 + p) * enc_pad + f] = e;
    }
  }
  __syncthreads();

  float* h = s.bufA;
  float* g = s.bufB;
  dense<W>(s.enc, enc_dim, nullptr, 0, wb + A.offs[0], wb + A.offs[1], h, W, EPI_RELU,
                nullptr, TRAIN ? A.hs + g0 * W : nullptr, nv, s.wtile);
  for (int j = 1; j < D; ++j) {
    const float* Wj = wb + A.offs[2 * j];
    const float* bj = wb + A.offs[2 * j + 1];
    float* gout = TRAIN ? A.hs + (size_t)j * N * W + g0 * W : nullptr;
    if ((A.skip_mask >> j) & 1u)
      dense<W>(s.enc, enc_dim, h, W, Wj, bj, g, W, EPI_RELU, nullptr, gout, nv, s.wtile);
    else
      dense<W>(h, W, nullptr, 0, Wj, bj, g, W, EPI_RELU, nullptr, gout, nv, s.wtile);
    float* tmp = h; h = g; g = tmp;
  }
  // output head (W -> out_ch, no activation)
  const float* wo = wb + A.offs[2 * D];
  const float* bo = wb + A.offs[2 * D + 1];
  for (int idx = tid; idx < TILE * oc; idx += NTHREADS) {
    const int p = idx % TILE, c = idx / TILE;
    float v = __ldg(bo + c);
    for (int k = 0; k < W; ++k) v = fmaf(h[k * LD + p], __ldg(wo + k * oc + c), v);
    if (!TRAIN) {
      if (p < nv) A.out[(g0 + p) * oc + c] = v;
    } else {
      const float err = p < nv ? v - __ldg(A.target + (g0 + p) * oc + c) : 0.f;
      sse = fmaf(err, err, sse);
      s.dsm[p * MAX_OUT + c] = 2.f * err;
      if (p < nv) A.dout[(g0 + p) * oc + c] = 2.f * err;
    }
  }
  __syncthreads();
}

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1) image_fwd_kernel(const __grid_constant__ Args A) {
  extern __shared__ __align__(16) float smem[];
  const int enc_pad = round_up(enc_dim_of(A.in_dim, A.n_freqs, A.include_input), KB);
  const Smem s = carve<W>(smem, enc_pad);
  const long long b0 = (long long)blockIdx.x * A.block_pts;
  const int npts = (int)min((long long)A.block_pts, A.N - b0);
  float unused = 0.f;
  for (int t0 = 0; t0 < npts; t0 += TILE)
    forward_tile<W, false>(A, s, (size_t)(b0 + t0), min(TILE, npts - t0), unused);
}

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1) image_train_kernel(const __grid_constant__ Args A) {
  extern __shared__ __align__(16) float smem[];
  const int enc_pad = round_up(enc_dim_of(A.in_dim, A.n_freqs, A.include_input), KB);
  const Smem s = carve<W>(smem, enc_pad);
  const int tid = threadIdx.x, oc = A.out_ch;
  const size_t N = (size_t)A.N;
  const int D = A.depth;
  const float* wb = A.wbuf;
  const float* wo = wb + A.offs[2 * D];  // output head [W][out_ch]
  const long long b0 = (long long)blockIdx.x * A.block_pts;
  const int npts = (int)min((long long)A.block_pts, A.N - b0);
  float sse = 0.f;

  for (int t0 = 0; t0 < npts; t0 += TILE) {
    const int nv = min(TILE, npts - t0);
    const size_t g0 = (size_t)(b0 + t0);
    forward_tile<W, true>(A, s, g0, nv, sse);

    // last trunk layer: dZ = (dout @ Wo^T) * (h > 0) -> bufA
    const size_t last = (size_t)(D - 1) * N * W + g0 * W;
    for (int idx = tid; idx < TILE * W; idx += NTHREADS) {
      const int p = idx / W, c = idx - p * W;
      float v = 0.f;
      if (p < nv) {
        float sum = 0.f;
        for (int o = 0; o < oc; ++o) sum = fmaf(s.dsm[p * MAX_OUT + o], __ldg(wo + c * oc + o), sum);
        const size_t at = last + (size_t)p * W + c;
        v = A.hs[at] > 0.f ? sum : 0.f;
        A.dzs[at] = v;
      }
      s.bufA[c * LD + p] = v;
    }
    __syncthreads();
    float* cur = s.bufA;
    float* nxt = s.bufB;
    for (int j = D - 1; j >= 1; --j) {
      // dZ_{j-1} = (dZ_j @ Wh_j^T) * (h_{j-1} > 0)
      const size_t o = (size_t)(j - 1) * N * W + g0 * W;
      dense<W>(cur, W, nullptr, 0, wb + A.offs[2 * D + 3 + (j - 1)], nullptr, nxt, W,
                    EPI_MASK, A.hs + o, A.dzs + o, nv, s.wtile);
      float* tmp = cur; cur = nxt; nxt = tmp;
    }
  }
  s.red[tid] = sse;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int i = 0; i < NTHREADS; ++i) total += s.red[i];
    A.sse_part[blockIdx.x] = total;
  }
}

// ---------------------------------------------------------------------------
// dW = X^T dZ, split over the points (as csrc/fused_mlp.cu)
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

size_t smem_bytes(int W, int enc_dim) {
  return sizeof(float) * ((size_t)(2 * W + round_up(enc_dim, KB)) * LD + (size_t)KB * W +
                          TILE * MAX_OUT + NTHREADS);
}

struct Layout {
  size_t enc, hs, dzs, dout, sse_part, part, total;
  long long part_stride;
  int n_blocks, n_splits;
};

Layout layout(long long N, int depth, int W, int enc_dim, int out_ch, int block_pts,
              int pts_per_split, int n_dw) {
  Layout L{};
  const size_t P = (size_t)N;
  size_t o = 0;
  auto take = [&](size_t n) {
    const size_t at = o;
    o += (n + 3) / 4 * 4;  // every piece starts on 16 bytes
    return at;
  };
  L.enc = take(P * round_up(enc_dim, KB));
  L.hs = take((size_t)depth * P * W);
  L.dzs = take((size_t)depth * P * W);
  L.dout = take(P * out_ch);
  L.n_blocks = (int)((N + block_pts - 1) / block_pts);
  L.sse_part = take((size_t)L.n_blocks);
  L.n_splits = (int)((P + pts_per_split - 1) / pts_per_split);
  L.part_stride = (n_dw + 3) / 4 * 4;
  L.part = take((size_t)L.n_splits * L.part_stride);
  L.total = o;
  return L;
}

// n_offs: 2*depth + 3 for the forward, 3*depth + 2 for the train call
bool valid_common(long long N, int block_pts, int depth, int width, unsigned skip_mask,
                  int in_dim, int n_freqs, int inc, int out_ch, int n_offs, bool train) {
  return N > 0 && block_pts > 0 && block_pts % TILE == 0 && depth >= 1 &&
         n_offs == (train ? 3 * depth + 2 : 2 * depth + 3) && n_offs <= MAX_OFFS &&
         width_ok(width) &&
         (skip_mask & 1u) == 0 && (skip_mask >> depth) == 0 && in_dim >= 1 && in_dim <= 3 &&
         n_freqs >= 0 && out_ch >= 1 && out_ch <= MAX_OUT &&
         enc_dim_of(in_dim, n_freqs, inc) >= 1 && enc_dim_of(in_dim, n_freqs, inc) <= MAX_ENC;
}

Args make_args(const float* x, const float* wbuf, const int* offs, int n_offs, long long N,
               int block_pts, int depth, unsigned skip_mask, int in_dim, int n_freqs, int inc,
               int out_ch) {
  Args a{};
  a.x = x; a.wbuf = wbuf;
  a.N = N; a.block_pts = block_pts; a.depth = depth; a.skip_mask = skip_mask;
  a.in_dim = in_dim; a.n_freqs = n_freqs; a.include_input = inc; a.out_ch = out_ch;
  for (int i = 0; i < n_offs; ++i) a.offs[i] = offs[i];
  return a;
}

}  // namespace

// Shared-memory bytes one block of either kernel needs (0 if the width is
// not supported); lets the wrapper check a shape before launching.
extern "C" long long fused_image_smem_bytes(int width, int enc_dim) {
  if (!width_ok(width)) return 0;
  return (long long)smem_bytes(width, enc_dim);
}

// Floats of device scratch the train launch needs.
extern "C" long long fused_image_workspace_floats(long long N, int depth, int width, int enc_dim,
                                                  int out_ch, int block_pts, int pts_per_split,
                                                  int n_dw) {
  if (N <= 0 || block_pts <= 0 || pts_per_split <= 0) return 0;
  return (long long)layout(N, depth, width, enc_dim, out_ch, block_pts, pts_per_split, n_dw).total;
}

// Forward: out [N, out_ch]. offs: the 2*depth + 3 float offsets of
// pack_image_weights (host array). Returns the cudaError_t of the launch.
extern "C" int fused_image_fwd_launch(const float* x, const float* wbuf, const int* offs,
                                      int n_offs, float* out, long long N, int block_pts,
                                      int depth, int width, unsigned skip_mask, int in_dim,
                                      int n_freqs, int include_input, int out_ch, void* stream) {
  if (N == 0) return 0;
  if (!valid_common(N, block_pts, depth, width, skip_mask, in_dim, n_freqs, include_input,
                    out_ch, n_offs, false))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(width, enc_dim_of(in_dim, n_freqs, include_input));
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  Args a = make_args(x, wbuf, offs, n_offs, N, block_pts, depth, skip_mask, in_dim, n_freqs,
                     include_input, out_ch);
  a.out = out;
  void (*kernel)(Args) = width == 256   ? image_fwd_kernel<256>
                         : width == 128 ? image_fwd_kernel<128>
                         : width == 64  ? image_fwd_kernel<64>
                                        : image_fwd_kernel<32>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((N + block_pts - 1) / block_pts);
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Train: sse [1] and dw (n_dw floats, the forward weights' layout, without
// the bands). offs: the 3*depth + 2 offsets of pack_image_weights(backward)
// (host array). Launches the three kernels on `stream`; returns the first
// cudaError_t.
extern "C" int fused_image_train_launch(const float* x, const float* target, const float* wbuf,
                                        const int* offs, int n_offs, float* sse, float* dw,
                                        float* workspace, long long N, int block_pts, int depth,
                                        int width, unsigned skip_mask, int in_dim, int n_freqs,
                                        int include_input, int out_ch, int pts_per_split,
                                        int n_dw, void* stream) {
  if (N == 0) return 0;
  if (!valid_common(N, block_pts, depth, width, skip_mask, in_dim, n_freqs, include_input,
                    out_ch, n_offs, true) ||
      pts_per_split <= 0 || n_dw <= 0)
    return (int)cudaErrorInvalidValue;
  const int W = width, D = depth;
  const int enc_dim = enc_dim_of(in_dim, n_freqs, include_input);
  const size_t smem = smem_bytes(W, enc_dim);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const Layout L = layout(N, depth, W, enc_dim, out_ch, block_pts, pts_per_split, n_dw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  Args a = make_args(x, wbuf, offs, n_offs, N, block_pts, depth, skip_mask, in_dim, n_freqs,
                     include_input, out_ch);
  a.target = target;
  a.sse_part = workspace + L.sse_part;
  a.enc = workspace + L.enc; a.hs = workspace + L.hs; a.dzs = workspace + L.dzs;
  a.dout = workspace + L.dout;

  void (*kernel)(Args) = W == 256   ? image_train_kernel<256>
                         : W == 128 ? image_train_kernel<128>
                         : W == 64  ? image_train_kernel<64>
                                    : image_train_kernel<32>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)L.n_blocks, NTHREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // one dW job per (layer input segment); the skip layers take two inputs
  // ([encoded input, h]), so they have two jobs writing disjoint rows
  GemmArgs G{};
  const size_t P = (size_t)N;
  const int enc_pad = round_up(enc_dim, KB);
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
  if (2 * D + 1 > MAX_JOBS) return (int)cudaErrorInvalidValue;
  add(a.enc, enc_pad, a.dzs, W, enc_dim, W, offs[0], W, offs[1]);
  for (int j = 1; j < D; ++j) {
    const float* dz = a.dzs + (size_t)j * P * W;
    const float* hprev = a.hs + (size_t)(j - 1) * P * W;
    if ((skip_mask >> j) & 1u) {
      add(a.enc, enc_pad, dz, W, enc_dim, W, offs[2 * j], W, offs[2 * j + 1]);
      add(hprev, W, dz, W, W, W, offs[2 * j] + enc_dim * W, W, -1);
    } else {
      add(hprev, W, dz, W, W, W, offs[2 * j], W, offs[2 * j + 1]);
    }
  }
  add(a.hs + (size_t)(D - 1) * P * W, W, a.dout, out_ch, W, out_ch, offs[2 * D], out_ch,
      offs[2 * D + 1]);
  G.n_jobs = nj;
  G.P = (long long)P;
  G.pts_per_split = pts_per_split;
  G.part_stride = L.part_stride;
  G.part = workspace + L.part;
  dw_gemm_kernel<<<dim3((unsigned)tiles, (unsigned)L.n_splits), NTHREADS, 0, st>>>(G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  reduce_kernel<<<(n_dw + NTHREADS - 1) / NTHREADS, NTHREADS, 0, st>>>(
      workspace + L.part, L.part_stride, L.n_splits, dw, n_dw, workspace + L.sse_part,
      L.n_blocks, sse);
  return (int)cudaGetLastError();
}
