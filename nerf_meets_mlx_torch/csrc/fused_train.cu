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
// Precision: every GEMM of the MLP (the dense layers forward, their
// cotangents, dW = X^T dZ) runs on the tensor cores in 3xTF32. Each fp32
// operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and
// the products lo*hi + hi*lo, then hi*hi are summed (CUTLASS's 3xTF32;
// lo*lo is dropped). mma reads a .tf32 operand by truncating its low 13
// bits, so both halves are rounded to nearest (ties away) first, in integer
// ops. The tensor cores add with truncation: a sum kept in their
// accumulator over a whole layer (96 truncating adds at width 256) lands
// ~100 ulp from the fp32 plain version's, and flips relu decisions near
// zero that the plain version does not. So each k-step's three products
// (dense tiles) or each 32-point slice's (dW) start from zero and are
// added to the sum in fp32, rounded to nearest. The kernel is then as far
// from a float64 reference as the fp32 plain version is, and is held to it
// at atol 1e-4 + rtol 1e-4 (values) and 1e-3 of the largest plain
// gradient (dW); one TF32 pass (10 mantissa bits) misses both.
//
// What bounds it. At the lego_hierarchical shapes a point costs 593,280
// MACs forward, as many for dW, and ~558,000 for the cotangents of the
// hidden layers: ~3.49 MFLOP a point, 0.915 TFLOP for the coarse level
// (4096 x 64 points) and 2.745 TFLOP for the fine one (4096 x 192). In
// 3xTF32 that is three times as many tensor-core operations: 3 x 0.915 /
// 495 TFLOP/s = 5.6 ms and 16.6 ms (8.5 / 25.6 ms at the ~320 TFLOP/s
// that mma.sync m16n8k8 TF32 reaches on an H100,
// tools/train_kernel_probe.py). The activations stored for the backward
// and dW (~20 KB a point, written once, read 2-3 times) take ~5 ms and
// ~16 ms of the card's 3.35 TB/s. (The fp32 CUDA-core bound of the same
// work is 13.7 / 41.0 ms.) What holds it back today is neither: the
// instructions around the mmas (fragment loads from shared memory, the
// hi/lo splits, the fp32 adds of each k-step's sum) take as long as the
// mmas themselves, and with one 8-warp block an SM (its tiles fill shared
// memory) the two do not overlap (PERF.md).
//
// Design: three launches per call, all hand-written here.
//
// 1. train_rays_kernel: a block owns `rays_block` rays and walks their
//    points in tiles of TILE = 64, as fused_eval.cu does (encode in
//    registers, activations in [feature][point] shared-memory tiles of row
//    stride LD = 72, weights staged in 16-row slices through registers,
//    the next slice's loads in flight while the current one is
//    multiplied). Each dense layer is a warp-level mma.sync m16n8k8 TF32
//    GEMM: the 8 warps split the 64 points in two and the N/8 column tiles
//    in four (ragged where N/8 is not a multiple of 4, as the 24-column
//    W/2 head at width 48); fragments are loaded by hand from shared
//    memory and split there, and the strides (LD = 72, weight rows N + 8
//    where N is a multiple of 16) make every fragment load conflict-free.
//    The epilogues (bias, relu, the relu mask read back, point-major
//    stores) work on the accumulator fragments. Every layer's input is
//    also written to device memory, point-major, since a point's ~2,500
//    activations do not fit on chip for a whole block. After the last tile
//    each ray is composited by one thread (exclusive transmittance scan),
//    its squared error and its closed-form cotangents formed (g =
//    2*resid; dweight; the reverse suffix sum dq_t = dw_t*T_t*alpha'_t -
//    sum_{s>t} dw_s*w_s), then each tile is backpropagated through the
//    heads and the trunk (W^T GEMMs with the relu masks read back), and
//    every layer's pre-activation cotangent dZ is written out,
//    point-major. The alpha (W -> 1) and rgb (W/2 -> 3) heads stay on the
//    CUDA cores.
// 2. dw_gemm_kernel: dW_l = X_l^T dZ_l (and db_l = colsum dZ_l) for every
//    layer at once, as a split-K GEMM over the points: a block computes one
//    128 x 128 tile of one layer over one split of the points into a
//    partial buffer. Slices of 32 points of X and dZ are staged
//    [point][feature] (row stride 136) by cp.async in three stages, so that
//    two slices are in flight while one is multiplied; each warp owns a
//    64 x 32 block of the tile (4 x 4 m16n8k8 tiles), one block an SM.
//    The narrow jobs (the alpha head's N = 1 and the rgb head's N = 3)
//    stay on the CUDA cores: a thread per row of X.
// 3. reduce_kernel: sums the splits in a fixed order (deterministic, no
//    atomics), and the per-block SSE partials: two launches on the same
//    inputs give bit-identical results.
//
// Tried and measured slower on the card (PERF.md): splitting each
// operand once into (hi, lo) pairs in shared memory (64-bit fragment loads
// and one more barrier cost more than the splits they save), staging the
// weights by cp.async in two buffers, 512 threads a block (spills).
// Left for later: wgmma (it takes TF32 operands K-major only, and both dW
// operands are stored point-major, i.e. M/N-major; the forward tiles' A is
// M-major too), TMA loads, warp specialisation so that the splits of one
// warp group overlap the mmas of another, and a persistent schedule over
// the dW tiles. The TPU kernel's U/E selector GEMMs, [S,S] scan matrix and
// 128-lane band packing are not carried over. Numerics of the encode as
// fused_eval.cu: sinf without fast math, phases rounded twice.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int TILE = 64;          // points per MLP tile
constexpr int LD = TILE + 8;      // row stride of the [feature][point] tiles (8 mod 32)
constexpr int KB = 16;            // rows per staged weight slice
constexpr int NTHREADS = 256;     // threads of a dW block: 8 warps
constexpr int RT = 256;           // threads of a train_rays_kernel block
constexpr int WN = RT / 64;       // warps along a dense tile's columns (two along its points)
constexpr int GT = 128;           // dW tile edge (fan_in rows x fan_out cols)
constexpr int KP = 32;            // points per staged dW slice
constexpr int GS = GT + 8;        // row stride of a staged dW slice (8 mod 32)
constexpr int DW_STAGES = 3;      // cp.async stages of the dW slices
constexpr int DW_SMEM = DW_STAGES * 2 * KP * GS * (int)sizeof(float);  // X and dZ a stage
constexpr int NARROW = 4;         // dW jobs of at most this many columns run on CUDA cores
constexpr int MAX_OFFS = 64;      // 3*depth + 11 weight-buffer offsets
constexpr int MAX_JOBS = 48;
constexpr float HALF_PI = 1.57079632679489662f;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

enum { EPI_NONE = 0, EPI_RELU = 1, EPI_MASK = 2 };

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Row stride of a staged N-column weight slice: 8 or 24 mod 32, so that the
// 4 rows x 8 columns of a B fragment fall in 32 distinct banks.
__host__ __device__ constexpr int wstride(int n) { return n % 16 == 0 ? n + 8 : n; }

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

// The A fragment (16 x 8) of an m16n8k8 tile whose element (m, k) is at
// p[k * ld + m], split into hi and lo. Lane (g = lane / 4, t = lane % 4)
// holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
__device__ __forceinline__ void load_a(const float* p, int ld, int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* q = p + t * ld + g;
  split_tf32(q[0], hi[0], lo[0]);
  split_tf32(q[8], hi[1], lo[1]);
  split_tf32(q[4 * ld], hi[2], lo[2]);
  split_tf32(q[4 * ld + 8], hi[3], lo[3]);
}

// The B fragment (8 x 8) whose element (k, n) is at p[k * ld + n]: lane
// (g, t) holds (t, g) and (t + 4, g).
__device__ __forceinline__ void load_b(const float* p, int ld, int g, int t, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const float* q = p + t * ld + g;
  split_tf32(q[0], hi[0], lo[0]);
  split_tf32(q[4 * ld], hi[1], lo[1]);
}

// out[col][p] = epi(b[col] + sum_k in[k][p] * Wg[k][col]) for the TILE
// points of a tile (in: kA rows of inA, then kB rows of inB), plus:
//  * EPI_MASK: the value is kept where mask[p][col] > 0 and zeroed
//    elsewhere (the relu derivative; mask is point-major, N per row);
//  * gout (if set): the result is also written point-major (N per row)
//    for the tile's first `nvalid` points.
// bg may be null (no bias). Input segments are padded to KB rows; rows
// past kA / kB read zero weights. Warp w computes points 32 * (w % 2) .. +32
// (two m16 tiles) and the column tiles w / 2 + WN j of the N / 8; output
// rows from N up to the KB padding are zeroed (the 24-column W/2 head of
// width 48). The weights come in KB-row slices, loaded into registers while
// the previous slice is multiplied and stored to wtile; both operands are
// split as their fragments are loaded. Each
// k-step's three products go into a fresh accumulator, added to the tile's
// sum in fp32: the tensor cores add with truncation, so a sum kept in their
// accumulator over a whole layer drifts from the fp32 plain version's by
// ~100 ulp, and relu decisions near zero with it.
template <int N>
__device__ __forceinline__ void dense(const float* __restrict__ inA, int kA,
                                      const float* __restrict__ inB, int kB,
                                      const float* __restrict__ Wg,
                                      const float* __restrict__ bg, float* __restrict__ out,
                                      int epi, const float* __restrict__ mask,
                                      float* __restrict__ gout, int nvalid,
                                      float* __restrict__ wtile) {
  static_assert(N % 8 == 0 && N >= 8 && N <= 256, "dense takes 8..256 columns, a multiple of 8");
  constexpr int NT = N / 8;                // column tiles
  constexpr int NTW = (NT + WN - 1) / WN;  // column tiles a warp owns (at most)
  constexpr int NS = wstride(N);
  constexpr int N4 = N / 4;
  constexpr int SLICE4 = KB * N4;
  constexpr int LOADS = (SLICE4 + RT - 1) / RT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int pm = 32 * (warp & 1), wn = warp >> 1;
  const int nA = round_up(kA, KB) / KB;
  const int nT = nA + round_up(kB, KB) / KB;
  auto owns = [&](int j) { return NT % WN == 0 || wn + WN * j < NT; };

  float acc[2][NTW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  float4 stage[LOADS];
  auto fetch = [&](int t) {
    const bool first = t < nA;
    const int k0 = (first ? t : t - nA) * KB;
    const int kreal = first ? kA : kB;
    const int row0 = (first ? 0 : kA) + k0;
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int idx = tid + l * RT;
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
      const int idx = tid + l * RT;
      if (idx < SLICE4) {
        const int kk = idx / N4, c4 = idx - kk * N4;
        *reinterpret_cast<float4*>(wtile + kk * NS + 4 * c4) = stage[l];
      }
    }
    __syncthreads();
    if (t + 1 < nT) fetch(t + 1);
    const float* in = t < nA ? inA + t * KB * LD : inB + (t - nA) * KB * LD;
#pragma unroll
    for (int k8 = 0; k8 < KB; k8 += 8) {
      uint32_t bh[NTW][2], bl[NTW][2];
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        if (owns(j)) load_b(wtile + k8 * NS + 8 * (wn + WN * j), NS, g, t4, bh[j], bl[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t ah[4], al[4];
        load_a(in + k8 * LD + pm + 16 * i, LD, g, t4, ah, al);
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          if (owns(j)) mma_3xtf32_add(acc[i][j], ah, al, bh[j], bl[j]);
      }
    }
  }

  // accumulator (i, j): rows pm + 16 i + g (+ 8), columns 8 (wn + WN j) + 2 t4 (+ 1)
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    if (!owns(j)) continue;
    const int col = 8 * (wn + WN * j) + 2 * t4;
    const float b0 = bg ? __ldg(bg + col) : 0.f;
    const float b1 = bg ? __ldg(bg + col + 1) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = pm + 16 * i + g + 8 * h;
        float v0 = acc[i][j][2 * h] + b0;
        float v1 = acc[i][j][2 * h + 1] + b1;
        if (epi == EPI_RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (epi == EPI_MASK) {
          float2 mk = make_float2(0.f, 0.f);
          if (p < nvalid) mk = __ldg(reinterpret_cast<const float2*>(mask + (size_t)p * N + col));
          v0 = mk.x > 0.f ? v0 : 0.f;
          v1 = mk.y > 0.f ? v1 : 0.f;
        }
        out[col * LD + p] = v0;
        out[(col + 1) * LD + p] = v1;
        if (gout && p < nvalid)
          *reinterpret_cast<float2*>(gout + (size_t)p * N + col) = make_float2(v0, v1);
      }
    }
  }
  if constexpr (N % KB != 0) {
    for (int idx = tid; idx < (KB - N % KB) * TILE; idx += RT)
      out[(N + idx / TILE) * LD + idx % TILE] = 0.f;
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
__global__ void __launch_bounds__(RT, 1) train_rays_kernel(const __grid_constant__ Args A) {
  extern __shared__ __align__(16) float smem[];
  constexpr int WH = W / 2;
  constexpr int WHP = round_up(WH, KB);
  const int pos_dim = 6 * A.pos_freqs + 3 * A.pos_inc;
  const int dir_dim = 6 * A.dir_freqs + 3 * A.dir_inc;
  const int pos_pad = round_up(pos_dim, KB), dir_pad = round_up(dir_dim, KB);
  const int S = A.S, RB = A.rays_block;

  float* bufA = smem;                   // [W][LD]
  float* bufB = bufA + W * LD;          // [W][LD]
  float* encP = bufB + W * LD;          // [pos_pad][LD]; the sigma row in backward
  float* encD = encP + pos_pad * LD;    // [dir_pad][LD]
  float* wtile = encD + dir_pad * LD;   // [KB][wstride(W)]
  float* pc = wtile + KB * wstride(W);  // [RB*S][3] raw rgb -> colour -> d(raw rgb)
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
      for (int f = part; f < pos_pad; f += RT / TILE) {
        const float e = encode_feature(f, A.pos_freqs, A.pos_inc, pos_bands, x0, x1, x2);
        encP[f * LD + p] = e;
        if (p < nv) A.encP[(g0 + p) * pos_pad + f] = e;
      }
      for (int f = part; f < dir_pad; f += RT / TILE) {
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
  for (int i = tid; i < npts; i += RT) {
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
  for (int rr = tid; rr < nr; rr += RT) {
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
    // (rows up to W/2 rounded up to KB: the next layers read whole slices)
    for (int idx = tid; idx < TILE * WHP; idx += RT) {
      const int p = idx / WHP, c = idx - p * WHP;
      float v = 0.f;
      if (p < nv && c < WH) {
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
    for (int idx = tid; idx < KB * TILE; idx += RT) {
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

// One 128 x 128 tile of C over the points [pb, pe) on the tensor cores,
// into out; with BIAS also db[n] = sum_p b[p][n] (fp32, CUDA cores, fixed
// order). Warp w owns rows 64 * (w % 2) .. +64 and columns 32 * (w / 2) ..
// +32 of the tile. The tensor cores add with truncation, so a slice's
// products are summed in a fresh accumulator and the slices' sums in fp32
// (round to nearest): the sum over thousands of points stays as close to
// the fp32 plain version's as an fp32 FMA chain.
template <bool BIAS>
__device__ __forceinline__ void dw_tile(const Job& J, int k0, int n0, long long pb, long long pe,
                                        float* __restrict__ out, float* __restrict__ smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = 64 * (warp & 1), wn = 32 * (warp >> 1);
  float tot[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) tot[i][j][c] = 0.f;
  float bsum = 0.f;

  // stage s: X slice [KP][GS] then dZ slice [KP][GS]; a 16-byte chunk of a
  // row is copied whole or not at all (lda, ldb are multiples of 4), rows
  // past pe and columns past the row length read zeros
  auto load = [&](int s, long long p0) {
    float* As = smem + s * 2 * KP * GS;
    float* Bs = As + KP * GS;
#pragma unroll
    for (int l = 0; l < KP * GT / 4 / NTHREADS; ++l) {
      const int idx = tid + l * NTHREADS;
      const int pp = idx / (GT / 4), c = 4 * (idx % (GT / 4));
      const long long p = p0 + pp;
      const bool va = p < pe && k0 + c < J.lda;
      const bool vb = p < pe && n0 + c < J.ldb;
      cp_async16(As + pp * GS + c, va ? J.a + p * J.lda + k0 + c : J.a, va);
      cp_async16(Bs + pp * GS + c, vb ? J.b + p * J.ldb + n0 + c : J.b, vb);
    }
  };

  const int n_sl = (int)((pe - pb + KP - 1) / KP);
#pragma unroll
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < n_sl) load(s, pb + (long long)s * KP);
    cp_async_commit();
  }
  for (int t = 0; t < n_sl; ++t) {
    cp_async_wait<DW_STAGES - 2>();  // slice t has landed (this thread's copies)
    __syncthreads();  // ... and every thread's; slice t - 1's stage is free
    const int nx = t + DW_STAGES - 1;
    if (nx < n_sl) load(nx % DW_STAGES, pb + (long long)nx * KP);
    cp_async_commit();
    const float* As = smem + (t % DW_STAGES) * 2 * KP * GS;
    const float* Bs = As + KP * GS;
    if (BIAS) {  // column tid % GT over half the slice's points
      const int c = tid & (GT - 1), h = tid / GT;
#pragma unroll
      for (int pp = 0; pp < KP / 2; ++pp) bsum += Bs[(h * (KP / 2) + pp) * GS + c];
    }
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < KP; k8 += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) load_b(Bs + k8 * GS + wn + 8 * j, GS, g, t4, bh[j], bl[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t ah[4], al[4];
        load_a(As + k8 * GS + wm + 16 * i, GS, g, t4, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_3xtf32(acc[i][j], ah, al, bh[j], bl[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) tot[i][j][c] += acc[i][j][c];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + wm + 16 * i + g + 8 * h;
        const int n = n0 + wn + 8 * j + 2 * t4;  // even, and N is even
        if (k < J.K && n < J.N)
          *reinterpret_cast<float2*>(out + J.c_off + (size_t)k * J.ldc + n) =
              make_float2(tot[i][j][2 * h], tot[i][j][2 * h + 1]);
      }
  if (BIAS) {
    __syncthreads();  // every warp is done with the stages (only empty copy groups remain)
    smem[tid] = bsum;
    __syncthreads();
    if (tid < GT && n0 + tid < J.N) out[J.bias_off + n0 + tid] = smem[tid] + smem[tid + GT];
  }
}

// A job of at most NARROW columns (the alpha head's dW, N = 1; the rgb
// head's, N = 3) on the CUDA cores: thread t owns row k0 + t % GT over
// every other point of [pb, pe); a point's N cotangents are the same
// address for every thread of a half (a broadcast).
__device__ __forceinline__ void dw_narrow(const Job& J, int k0, long long pb, long long pe,
                                          float* __restrict__ out, float* __restrict__ smem) {
  const int tid = threadIdx.x, r = tid & (GT - 1), h = tid / GT;
  const int k = k0 + r;
  const bool live = k < J.K;
  float acc[NARROW], bsum[NARROW];
#pragma unroll
  for (int n = 0; n < NARROW; ++n) acc[n] = bsum[n] = 0.f;
#pragma unroll 4
  for (long long p = pb + h; p < pe; p += 2) {
    const float x = live ? __ldg(J.a + p * J.lda + k) : 0.f;
#pragma unroll
    for (int n = 0; n < NARROW; ++n) {
      if (n < J.N) {
        const float d = __ldg(J.b + p * J.ldb + n);
        acc[n] = fmaf(x, d, acc[n]);
        bsum[n] += d;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NARROW; ++n) smem[(h * GT + r) * NARROW + n] = acc[n];
  if (r == 0) {
#pragma unroll
    for (int n = 0; n < NARROW; ++n) smem[2 * GT * NARROW + h * NARROW + n] = bsum[n];
  }
  __syncthreads();
  if (h == 0 && live) {
    for (int n = 0; n < J.N; ++n)
      out[J.c_off + (size_t)k * J.ldc + n] =
          smem[r * NARROW + n] + smem[(GT + r) * NARROW + n];
  }
  if (tid == 0 && J.bias_off >= 0 && k0 == 0) {
    for (int n = 0; n < J.N; ++n)
      out[J.bias_off + n] = smem[2 * GT * NARROW + n] + smem[2 * GT * NARROW + NARROW + n];
  }
}

__global__ void __launch_bounds__(NTHREADS, 1) dw_gemm_kernel(const __grid_constant__ GemmArgs G) {
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  int j = 0;
  while (j + 1 < G.n_jobs && G.jobs[j + 1].tile0 <= t) ++j;
  const Job& J = G.jobs[j];
  const int local = t - J.tile0;
  const int k0 = (local / J.tiles_n) * GT, n0 = (local % J.tiles_n) * GT;
  const long long pb = (long long)blockIdx.y * G.pts_per_split;
  const long long pe = min(G.P, pb + (long long)G.pts_per_split);
  float* out = G.part + (size_t)blockIdx.y * G.part_stride;
  if (J.N <= NARROW)
    dw_narrow(J, k0, pb, pe, out, smem);
  else if (J.bias_off >= 0 && k0 == 0)
    dw_tile<true>(J, k0, n0, pb, pe, out, smem);
  else
    dw_tile<false>(J, k0, n0, pb, pe, out, smem);
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

size_t smem_bytes(int W, int S, int rays_block, int pos_dim, int dir_dim) {
  return sizeof(float) * ((size_t)(2 * W + round_up(pos_dim, KB) + round_up(dir_dim, KB)) * LD +
                          (size_t)KB * wstride(W) + (size_t)rays_block * S * 7 +
                          (size_t)rays_block);
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

  void (*kernel)(Args) = PICK_WIDTH(train_rays_kernel, W);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<L.n_blocks, RT, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // one dW job per (layer input segment); the skip layer and the view layer
  // take two inputs each, so they have two jobs writing disjoint rows
  GemmArgs G{};
  const size_t P = (size_t)R * S;
  const int D = depth, WH = W / 2;
  const int pos_pad = round_up(pos_dim, KB), dir_pad = round_up(dir_dim, KB);
  int nj = 0, tiles = 0;
  bool shapes_ok = true;
  auto add = [&](const float* A_, int lda, const float* B_, int ldb, int K, int N, int c_off,
                 int ldc, int bias_off) {
    Job& J = G.jobs[nj++];
    J.a = A_; J.lda = lda; J.b = B_; J.ldb = ldb; J.K = K; J.N = N;
    J.c_off = c_off; J.ldc = ldc; J.bias_off = bias_off;
    J.tile0 = tiles;
    J.tiles_n = (N + GT - 1) / GT;
    tiles += ((K + GT - 1) / GT) * J.tiles_n;
    // the tensor-core tile copies 16-byte chunks and stores float2 pairs
    if (N > NARROW)
      shapes_ok &= lda % 4 == 0 && ldb % 4 == 0 && N % 2 == 0 && ldc % 2 == 0 && c_off % 2 == 0;
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
  if (!shapes_ok) return (int)cudaErrorInvalidValue;
  G.n_jobs = nj;
  G.P = (long long)P;
  G.pts_per_split = pts_per_split;
  G.part_stride = L.part_stride;
  G.part = workspace + L.part;
  err = cudaFuncSetAttribute(dw_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  dw_gemm_kernel<<<dim3((unsigned)tiles, (unsigned)L.n_splits), NTHREADS, DW_SMEM, st>>>(G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  reduce_kernel<<<(n_dw + NTHREADS - 1) / NTHREADS, NTHREADS, 0, st>>>(
      workspace + L.part, L.part_stride, L.n_splits, dw, n_dw, workspace + L.sse_part, L.n_blocks,
      sse);
  return (int)cudaGetLastError();
}
