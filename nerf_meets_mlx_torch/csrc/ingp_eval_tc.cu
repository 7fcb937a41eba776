// Fused Instant-NGP render kernel for Hopper (sm_90a): the MLP on wgmma in
// 3xTF32, the hash encode of the next tile overlapped with it.
//
// Replaces nerf_meets_mlx_tpu/kernels/fused_ingp_train.py::_ingp_eval_kernel
// (pallas_call at :451) for the shapes listed below; every other shape runs
// csrc/fused_ingp.cu (kernels/fused_ingp_train.py::eval_build routes by shape
// before the launch). Per level of the hierarchical render one launch takes
// the rays (origin, direction), their spherical harmonics sh [R,DD], sample
// depths z [R,S] and deltas [R,S] (scaled by |d|, terminal bin 1e10*|d|), the
// hash tables [L,T,F] and the MLP's nn.Linear parameters as PyTorch holds
// them ([out][in] weights), and writes
//
//   points o + z*d -> hash encode (L levels x 8 corners) -> the NeRF MLP over
//   [features | sh] (depth D, width W, view head) -> compositing (exclusive
//   transmittance scan, both modes, relu or softplus density, white
//   background) -> rgb [R,3], weights [R,S].
//
// Shapes taken: width W = 32 or 64 (a template argument); depth 1..8; 1..16
// levels of 1, 2 or 4 features, L*F <= 64; at most 64 SH channels; any S.
//
// What bounds it, at lego_ingp's coarse level on a 32,768-ray chunk (W 64,
// D 2, 8 x 2 features, 25 SH channels, 1,572,864 points): of the table's
// rates, the tensor cores. The dense layers cost 16*64 + 64*64 + 64*64 +
// 64*32 = 11,264 MACs a point, three TF32 products each: 106 GFLOP, 0.21
// ms at 495 TFLOP/s (0.43 ms at the fine level's 96 samples). The bytes
// (the rays' ~0.2 KB, z, deltas and the weights out, ~12 bytes a point;
// the 1 MB tables from L2) take ~0.01 ms. What has no peak rate in the
// table: 64 hashed 8-byte lookups a point (the standalone hash forward
// takes ~0.3 ms for these points), which is why the encode runs beside the
// products rather than before them; on an H100 those lookups bound a
// launch (PERF.md).
//
// Design: one 512-thread block an SM, persistent over a contiguous range of
// the rays (rays R * b / grid .. R * (b + 1) / grid, so every block starts
// at a ray), walked in tiles of TILE = 192 consecutive points (fewer for
// rays of fewer than 6 samples, so that a tile meets at most MAX_RAYS rays):
// whole rays at every preset's S (4 x 48, 2 x 96, 6 x 32, 3 x 64).
// * Warp specialisation: warpgroup 3 (the encoder) computes tile k + 1's
//   points, their hash features (a thread per (point, level), ITEMS of them
//   at a time with their corner rows loaded together) and, per ray, the
//   view layer's SH term sh . W_view[:, W:] + b_view into one of two
//   buffers, while warpgroups 0..2 (the consumers, 64 points each) run
//   tile k's MLP. Two mbarriers a buffer hand it over: `full` (the
//   encoder's 128 threads arrive) and `empty` (the consumers' 12 warps
//   arrive once they have read it). Every thread has 128 registers, the
//   SM's 65,536 over 512 threads: no setmaxnreg (ITEMS below).
// * The dense layers on the tensor cores: wgmma.mma_async m64nNk8 in TF32
//   (tf32x3.cuh), N = W for the trunk and the feature layer, W/2 for the
//   view layer (its SH columns come in as the ray's term); layer 0's K is
//   L*F rounded up to 8. A comes from registers, split once into TF32 hi
//   and lo (split_tf32); B from shared memory by descriptor: each block
//   writes the TF32 hi and lo images of every weight, in wgmma's
//   core-matrix layout (as fused_train.pack_eval_wgmma lays them out for
//   csrc/fused_eval.cu), straight from the nn.Linear parameters, once for
//   the launch: no host pack, no copy. Within a k-step of 8 the K order is
//   permuted (index i holds feature 2i for i < 4, 2(i - 4) + 1 above), so
//   that a layer's accumulator fragment is the next layer's A fragment as
//   it stands: the activations never leave the registers. Where the images
//   do not fit beside the tile's buffers (deep trunks at W 64, or 64 hash
//   channels) the layers that do not fit are streamed: before such a layer
//   the consumers write its image into one stage of shared memory, between
//   two of their barriers, every tile.
// * Each layer's products lo*hi + hi*lo + hi*hi (lo*lo dropped) go into one
//   accumulator, started from zero at its first k-step: eval sets no
//   cotangent, so the truncating adds need no per-k-step fp32 sums (the
//   CPU emulation, tests/test_torch_ingp_eval.py, holds this form within
//   the value tolerance atol 1e-4 + rtol 1e-4 at lego_ingp's shapes).
// * The alpha head (N = 1) and the rgb head (N = 3) stay on the CUDA
//   cores, in the epilogues: dot products over a thread's columns summed
//   across the 4 lanes of a row. Each point's q, alpha and colour go to
//   shared memory (two buffers); after a barrier of the consumers a warp a
//   ray segment composites: the exclusive transmittance scan as warp scans
//   over chunks of 32 samples. A ray that continues into the next tile
//   (S not dividing the tile, or S > 192) carries its exclusive sum and its
//   four sums there. No atomics: rgb and weights are bit-identical from
//   launch to launch.
//
// bf16 hash compute (hash_compute_dtype = "bfloat16") rounds where the
// Pallas kernel rounds, as csrc/fused_ingp.cu does. The hash front end is a
// copy of csrc/ingp_train_tc.cu's (ROADMAP.md, "Duplicated device code").
// The TPU kernel's one-hot-GEMM lookups, selector GEMMs and 768-point
// sub-blocks are not carried over.
//
// Controls. INGP_EVAL_ONE_PASS: hi*hi alone, one TF32 product where the
// kernel takes three, the lower-precision build that the gpu test
// test_cuda_eval_kernel_runs_three_tf32_passes must see fail the tight
// tolerance the kernel meets. Timing only, wrong results, for
// tools/ingp_kernel_probe.py --eval: INGP_EVAL_NO_MMA (the products
// skipped), INGP_EVAL_NO_HASH (the features read from the points, no
// lookups); INGP_EVAL_CLOCKS writes block
// 0's cycles by phase over rgb's first entries: consumer thread 0's (the
// wait for the encoder's buffer, layer 0's fragments, the products, the
// epilogues, the wait at the consumers' barrier, the compositing), then
// encoder thread 0's (the wait for a free buffer, the points, the
// features, the SH terms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

// warpgroups 0..2 consume, warpgroup 3 encodes (two and two measured
// slower: PERF.md)
constexpr int NTHREADS = 512;
constexpr int NCONS = 384;               // consumer threads
constexpr int NENC = NTHREADS - NCONS;   // encoder threads
constexpr int NCWARP = NCONS / 32;       // consumer warps
constexpr int TILE = 192;                // points a tile: 64 a consumer warpgroup
constexpr int MAX_RAYS = 33;             // rays a tile meets at most
constexpr int MAX_LEVELS = 16;
constexpr int MAX_FEATS = 64;            // L*F
constexpr int MAX_DEPTH = 8;
constexpr int MAX_DD = 64;
constexpr int MAX_LIN = MAX_DEPTH + 4;   // linears(): trunk, alpha, feature, view, rgb
constexpr int MAX_DENSE = MAX_DEPTH + 2; // the wgmma layers: trunk, feature, view
constexpr int MAX_STEPS = 8;             // k-steps of a dense layer (K <= 64)
constexpr int MAX_SMEM = 232448;         // bytes a block may use on sm_90
// (point, level) items an encoder thread keeps in flight at 1 or 2
// features a level (half at 4). 128 registers a thread for every
// warpgroup and 3 items measured fastest of the splits that do not spill
// (PERF.md): where the encoder has too few registers for its items,
// its loads no longer overlap.
constexpr int ITEMS = 3;
constexpr int BAR_CONS = 1, BAR_ENC = 2;       // named barriers
constexpr unsigned FULL = 0xFFFFFFFFu;

// INGP_EVAL_CLOCKS: one thread adds the cycles since its last mark to phase k
#ifdef INGP_EVAL_CLOCKS
constexpr int N_CONS_PHASES = 6, N_ENC_PHASES = 4;
#define EVAL_CLOCK(on, k)                 \
  if (on) {                               \
    const long long now_ = clock64();     \
    clk[k] += now_ - clk_last;            \
    clk_last = now_;                      \
  }
#else
#define EVAL_CLOCK(on, k)
#endif

__host__ __device__ constexpr int ru(int x, int m) { return (x + m - 1) / m * m; }

// Float offsets of the pieces of a block's shared memory; img[i] < 0: dense
// layer i (trunk 0..D-1, feature D, view D+1) is streamed through `stage`.
struct Smem {
  int bars;             // mbarriers full[2], empty[2]
  int img[MAX_DENSE];   // per k-step 16*N floats: hi [K half][N/8][8][4], then lo
  int stage;            // the streamed layers' image, one at a time
  int feats, se;        // [2][TILE][se] layer 0's input, zero past L*F
  int vsh;              // [2][MAX_RAYS][W/2] the view layer's SH term per ray
  int pts;              // [TILE][3] the encoder's points, as their position in the box
  int pq, pa, pc;       // [2][TILE] q, alpha; [2][TILE][3] colour
  int carry;            // [2][8] a ray continuing into the next tile: excl, rgb, weight sums
  int wsh;              // [DD][W/2] the view weight's SH columns, [in][out]
  int bt, bf, bv;       // biases: trunk [D][W], feature [W], view [W/2]
  int wa, wr, ba, br;   // alpha head [W], rgb head [3][W/2], their biases
  int total;
};

struct Args {
  const float* rays_o;  // [R, 3]
  const float* rays_d;  // [R, 3]
  const float* sh;      // [R, DD]
  const float* z;       // [R, S]
  const float* deltas;  // [R, S]
  const float* tables;  // [L, T, F]
  const float* w[MAX_LIN];  // nn.Linear weights [out][in], linears() order
  const float* b[MAX_LIN];
  float* rgb;           // [R, 3]
  float* weights;       // [R, S]
  long long T;
  unsigned mask;        // T - 1
  int R, S, L, F, E, D, DD;
  int bf16, mode, relu_density, white_bkgd;
  int tile_pts;         // points a tile
  float bmin, brange;
  int res[MAX_LEVELS];
  Smem M;
};

__host__ __device__ inline int take(int& o, int n) {
  const int at = o;
  o += ru(n, 4);  // every piece on 16 bytes
  return at;
}

// k-steps and columns of dense layer i
__host__ __device__ inline int dense_steps(int i, int W, int D, int E) {
  return i == 0 ? ru(E, 8) / 8 : W / 8;
}

__host__ __device__ inline int dense_n(int i, int W, int D) { return i == D + 1 ? W / 2 : W; }

__host__ __device__ inline int image_floats(int i, int W, int D, int E) {
  return dense_steps(i, W, D, E) * 16 * dense_n(i, W, D);
}

// The layout of a block's shared memory: the tile's buffers first, then
// every dense layer's image where they all fit; otherwise a stage for the
// streamed ones and, in the order view, feature, trunk 0, 1, ..., each
// image that still fits.
__host__ __device__ inline Smem smem_layout(int W, int D, int E, int DD) {
  Smem M{};
  int o = 0;
  const int WH = W / 2;
  M.bars = take(o, 8);
  M.se = ru(E, 16) + 8;  // 8 or 24 mod 32: a half-warp's 64-bit row loads hit 32 banks
  M.feats = take(o, 2 * TILE * M.se);
  M.vsh = take(o, 2 * MAX_RAYS * WH);
  M.pts = take(o, TILE * 3);
  M.pq = take(o, 2 * TILE);
  M.pa = take(o, 2 * TILE);
  M.pc = take(o, 2 * TILE * 3);
  M.carry = take(o, 16);
  M.wsh = take(o, DD * WH);
  M.bt = take(o, D * W);
  M.bf = take(o, W);
  M.bv = take(o, WH);
  M.wa = take(o, W);
  M.wr = take(o, 3 * WH);
  M.ba = take(o, 1);
  M.br = take(o, 3);
  const int n_dense = D + 2;
  int all = 0, biggest = 0;
  for (int i = 0; i < n_dense; ++i) {
    all += image_floats(i, W, D, E);
    biggest = image_floats(i, W, D, E) > biggest ? image_floats(i, W, D, E) : biggest;
  }
  const int room = MAX_SMEM / 4;
  if (o + all <= room) {
    for (int i = 0; i < n_dense; ++i) M.img[i] = take(o, image_floats(i, W, D, E));
    M.stage = -1;
  } else {
    M.stage = take(o, biggest);
    for (int i = 0; i < n_dense; ++i) M.img[i] = -1;
    for (int k = 0; k < n_dense; ++k) {
      const int i = k == 0 ? D + 1 : k == 1 ? D : k - 2;  // view, feature, trunk 0, 1, ...
      if (o + image_floats(i, W, D, E) <= room) M.img[i] = take(o, image_floats(i, W, D, E));
    }
  }
  for (int i = n_dense; i < MAX_DENSE; ++i) M.img[i] = -1;
  M.total = o;
  return M;
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float rb(float v, int on) {
  return on ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// the generic-proxy writes of this thread to shared memory (the weight
// images) are seen by the async proxy (wgmma's descriptor reads) after the
// next barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ float warp_scan_up(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// sum of v over the 4 lanes of a row (t = lane % 4)
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// ---------------------------------------------------------------------------
// The weight images
// ---------------------------------------------------------------------------

// Dense layer i's nn.Linear weight, its row stride and its input columns on
// the tensor cores (the view layer's first W; its SH columns are the ray's
// term).
__device__ __forceinline__ void dense_weight(const Args& A, int i, int W, const float*& w,
                                             int& ld, int& kin) {
  if (i < A.D) {
    w = A.w[i];
    ld = kin = i == 0 ? A.E : W;
  } else if (i == A.D) {
    w = A.w[A.D + 1];
    ld = kin = W;
  } else {
    w = A.w[A.D + 2];
    ld = W + A.DD;
    kin = W;
  }
}

// Writes dense layer i's TF32 hi and lo images at dst, threads tid of nthr:
// per k-step s the hi image, then the lo one, each as core matrices [K half
// (2)][N/8][8 rows of N][4 of K]; K index q of a step holds input column
// 8s + 2q (q < 4) or 8s + 2(q - 4) + 1, zero past the layer's inputs.
__device__ __forceinline__ void put_image(const Args& A, int i, int W, float* dst, int tid,
                                          int nthr) {
  const float* w;
  int ld, kin;
  dense_weight(A, i, W, w, ld, kin);
  const int N = dense_n(i, W, A.D), K = 8 * dense_steps(i, W, A.D, A.E);
  for (int idx = tid; idx < N * K; idx += nthr) {
    const int n = idx / K, k = idx - n * K;  // k fastest: a weight row read in order
    const float x = k < kin ? __ldg(w + (size_t)n * ld + k) : 0.f;
    const int s = k >> 3, f = k & 7;
    const int q = (f & 1) ? 4 + (f >> 1) : (f >> 1);
    const int o = s * 16 * N + (q >> 2) * 4 * N + (n >> 3) * 32 + (n & 7) * 4 + (q & 3);
    const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
    const uint32_t lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
    dst[o] = __uint_as_float(hi);
    dst[o + 8 * N] = __uint_as_float(lo);
  }
}

// Everything a block keeps for the launch: the resident images, the biases,
// the heads and the view weight's SH columns.
template <int W>
__device__ __forceinline__ void load_weights(const Args& A, float* sm) {
  constexpr int WH = W / 2;
  const Smem& M = A.M;
  const int tid = threadIdx.x, D = A.D;
  for (int i = 0; i < D + 2; ++i)
    if (M.img[i] >= 0) put_image(A, i, W, sm + M.img[i], tid, NTHREADS);
  for (int idx = tid; idx < D * W; idx += NTHREADS) {
    const int l = idx / W;
    sm[M.bt + idx] = __ldg(A.b[l] + idx - l * W);
  }
  for (int j = tid; j < W; j += NTHREADS) {
    sm[M.bf + j] = __ldg(A.b[D + 1] + j);
    sm[M.wa + j] = __ldg(A.w[D] + j);
  }
  for (int j = tid; j < WH; j += NTHREADS) sm[M.bv + j] = __ldg(A.b[D + 2] + j);
  for (int j = tid; j < 3 * WH; j += NTHREADS) sm[M.wr + j] = __ldg(A.w[D + 3] + j);
  for (int idx = tid; idx < WH * A.DD; idx += NTHREADS) {
    const int j = idx / A.DD, k = idx - j * A.DD;
    sm[M.wsh + k * WH + j] = __ldg(A.w[D + 2] + (size_t)j * (W + A.DD) + W + k);
  }
  if (tid == 0) sm[M.ba] = __ldg(A.b[D]);
  if (tid < 3) sm[M.br + tid] = __ldg(A.b[D + 3] + tid);
}

// ---------------------------------------------------------------------------
// The encoder: points, hash features, the view layer's SH term per ray
// ---------------------------------------------------------------------------

// hash cell of a point at level l, as csrc/ingp_train_tc.cu's cell_of, from
// the point's position in the box u = clamp((x - bmin) / box size, 0, 1),
// which the encoder computes once a point (the same operations)
struct Cell {
  unsigned b[3];
  float f[3];
};

__device__ __forceinline__ Cell cell_of(const Args& A, const float* u, int l) {
  const float r = (float)A.res[l];
  Cell C;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s = __fmul_rn(u[a], r);
    const float fl = floorf(s);
    C.b[a] = (unsigned)fl;
    C.f[a] = __fsub_rn(s, fl);
  }
  return C;
}

__device__ __forceinline__ unsigned corner_row(const Args& A, const Cell& C, int c) {
  const unsigned bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
  return (((C.b[0] + bx) * 1u) ^ ((C.b[1] + by) * 2654435761u) ^ ((C.b[2] + bz) * 805459861u)) &
         A.mask;
}

__device__ __forceinline__ float corner_weight(const Cell& C, int c) {
  const float wx = (c & 1) ? C.f[0] : __fsub_rn(1.f, C.f[0]);
  const float wy = ((c >> 1) & 1) ? C.f[1] : __fsub_rn(1.f, C.f[1]);
  const float wz = ((c >> 2) & 1) ? C.f[2] : __fsub_rn(1.f, C.f[2]);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

template <int F>
__device__ __forceinline__ void load_row(const float* row, float (&g)[F]) {
  if constexpr (F == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row));
    g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
  } else if constexpr (F == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(row));
    g[0] = v.x; g[1] = v.y;
  } else {
    g[0] = __ldg(row);
  }
}

// the hash features of every (point, level) of the tile into fb, zero for
// the points past n: a thread per (point, level), points fastest (the lanes
// of a warp take neighbouring samples, which share cells on the coarse
// levels), U items at a time so that 8U corner rows are in flight
template <int F, int U>
__device__ __forceinline__ void tile_features(const Args& A, const float* pts, float* fb, int n,
                                              int etid) {
  const int se = A.M.se, total = TILE * A.L;
  for (int i0 = etid; i0 < total; i0 += NENC * U) {
    int l[U], p[U];
    float acc[U][F];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = min(i0 + NENC * u, total - 1);
      l[u] = idx / TILE;
      p[u] = idx - l[u] * TILE;
#pragma unroll
      for (int f = 0; f < F; ++f) acc[u][f] = 0.f;
    }
#ifdef INGP_EVAL_NO_HASH
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[u][f] = pts[3 * p[u] + (f + l[u]) % 3];
#else
    Cell C[U];
    float g[U][8][F];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      C[u] = cell_of(A, pts + 3 * p[u], l[u]);
      const float* tl = A.tables + (size_t)l[u] * A.T * F;
#pragma unroll
      for (int c = 0; c < 8; ++c) load_row<F>(tl + (size_t)corner_row(A, C[u], c) * F, g[u][c]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float w = corner_weight(C[u], c);
        if (A.bf16) {
          const float wb = rb(w, 1);
#pragma unroll
          for (int f = 0; f < F; ++f)
            acc[u][f] = __fadd_rn(acc[u][f], rb(__fmul_rn(rb(g[u][c][f], 1), wb), 1));
        } else {
#pragma unroll
          for (int f = 0; f < F; ++f) acc[u][f] = __fadd_rn(acc[u][f], __fmul_rn(g[u][c][f], w));
        }
      }
    }
#endif
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + NENC * u < total) {
#pragma unroll
        for (int f = 0; f < F; ++f) fb[p[u] * se + l[u] * F + f] = p[u] < n ? acc[u][f] : 0.f;
      }
    }
  }
}

template <int W>
__device__ __forceinline__ void encoder(const Args& A, float* sm, long long r_begin, int np,
                                        int ntiles, uint64_t* full,
                                        uint64_t* empty) {
  constexpr int WH = W / 2;
  const Smem& M = A.M;
  const int etid = threadIdx.x - NCONS, S = A.S, E = A.E, K0 = ru(E, 8);
  float* pts = sm + M.pts;
#ifdef INGP_EVAL_CLOCKS
  const bool timed = blockIdx.x == 0 && etid == 0;
  long long clk[N_ENC_PHASES] = {}, clk_last = clock64();
#endif
  for (int j = 0; j < ntiles; ++j) {
    const int b = j & 1;
    const int lo = j * A.tile_pts, n = min(A.tile_pts, np - lo);
    mbar_wait(&empty[b], ((j >> 1) & 1) ^ 1u);
    EVAL_CLOCK(timed, 0);
    named_barrier(BAR_ENC, NENC);  // every encoder thread done with the last tile's points
    // each point's position in the box: x = o + z*d rounded as the plain
    // version's broadcast product and sum, then (x - bmin) / box size
    for (int p = etid; p < TILE; p += NENC) {
      float* u = pts + 3 * p;
      if (p < n) {
        const long long ray = r_begin + (lo + p) / S, gi = r_begin * S + lo + p;
        const float zz = __ldg(A.z + gi);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float x = __fadd_rn(__ldg(A.rays_o + ray * 3 + a),
                                    __fmul_rn(zz, __ldg(A.rays_d + ray * 3 + a)));
          u[a] = fminf(fmaxf(__fdiv_rn(__fsub_rn(x, A.bmin), A.brange), 0.f), 1.f);
        }
      } else {
        u[0] = u[1] = u[2] = 0.f;
      }
    }
    named_barrier(BAR_ENC, NENC);
    EVAL_CLOCK(timed, 1);
    float* fb = sm + M.feats + b * TILE * M.se;
    if (A.F == 4)
      tile_features<4, (ITEMS + 1) / 2>(A, pts, fb, n, etid);
    else if (A.F == 2)
      tile_features<2, ITEMS>(A, pts, fb, n, etid);
    else
      tile_features<1, ITEMS>(A, pts, fb, n, etid);
    for (int idx = etid; idx < TILE * (K0 - E); idx += NENC) {
      const int p = idx / (K0 - E);
      fb[p * M.se + E + idx - p * (K0 - E)] = 0.f;
    }
    EVAL_CLOCK(timed, 2);
    // the view layer's SH term of each ray the tile meets
    const int lra = lo / S, nr = (lo + n - 1) / S - lra + 1;
    float* vs = sm + M.vsh + b * MAX_RAYS * WH;
    for (int idx = etid; idx < nr * WH; idx += NENC) {
      const int r = idx / WH, jj = idx - r * WH;
      const float* shr = A.sh + (r_begin + lra + r) * A.DD;
      float s = sm[M.bv + jj];
      for (int k = 0; k < A.DD; ++k) s = fmaf(__ldg(shr + k), sm[M.wsh + k * WH + jj], s);
      vs[idx] = s;
    }
    mbar_arrive(&full[b]);
    EVAL_CLOCK(timed, 3);
  }
#ifdef INGP_EVAL_CLOCKS
  if (timed)
    for (int k = 0; k < N_ENC_PHASES; ++k) A.rgb[N_CONS_PHASES + k] = (float)clk[k];
#endif
}

// ---------------------------------------------------------------------------
// The consumers: the MLP on wgmma, the heads, the compositing
// ---------------------------------------------------------------------------

// acc = A x B of a dense layer of N columns for the warpgroup's 64 rows: its
// STEPS k-steps' fragments (ah, al), B's images at img (per k-step hi then
// lo), lo*hi + hi*lo + hi*hi a k-step, the layer in one accumulator
template <int N, int STEPS>
__device__ __forceinline__ void dense(float* acc, const uint32_t (&ah)[MAX_STEPS][4],
                                      const uint32_t (&al)[MAX_STEPS][4], const float* img) {
#ifdef INGP_EVAL_NO_MMA
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    acc[i] = __uint_as_float((ah[0][i & 3] ^ al[STEPS - 1][i & 3]) & 0x3FFFFFFFu) +
             (img[i] > 1e30f ? 1.f : 0.f);
#else
  // the descriptor of k-step s's hi image, advanced a step at a time (its
  // address field counts 16 bytes; the lo image is 8N floats further): the
  // empty asm keeps each update beside its wgmmas, so that the compiler
  // does not hold all 2 x STEPS descriptors in registers at once
  uint64_t dh = wgmma_desc(img, 16 * N, 128);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    asm volatile("" : "+l"(dh));
#ifdef INGP_EVAL_ONE_PASS
    wgmma_tf32<N>(acc, ah[s], dh, s == 0 ? 0 : 1);
#else
    wgmma_tf32<N>(acc, al[s], dh, s == 0 ? 0 : 1);
    wgmma_tf32<N>(acc, ah[s], dh + 2 * N, 1);
    wgmma_tf32<N>(acc, ah[s], dh, 1);
#endif
    dh += 4 * N;
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<N / 2>(acc);
#endif
}

// layer 0: its k-steps (L*F / 8, rounded up) as a compile-time count
template <int N>
__device__ __forceinline__ void dense0(float* acc, const uint32_t (&ah)[MAX_STEPS][4],
                                       const uint32_t (&al)[MAX_STEPS][4], int steps,
                                       const float* img) {
  switch (steps) {
    case 1: dense<N, 1>(acc, ah, al, img); break;
    case 2: dense<N, 2>(acc, ah, al, img); break;
    case 3: dense<N, 3>(acc, ah, al, img); break;
    case 4: dense<N, 4>(acc, ah, al, img); break;
    case 5: dense<N, 5>(acc, ah, al, img); break;
    case 6: dense<N, 6>(acc, ah, al, img); break;
    case 7: dense<N, 7>(acc, ah, al, img); break;
    default: dense<N, 8>(acc, ah, al, img); break;
  }
}

// act(acc + bias) of the thread's two rows, kept in acc, and split into the
// next layer's A fragments: the accumulator's (row g, column 8j + 2t),
// (g + 8, 8j + 2t), (g, 8j + 2t + 1), (g + 8, 8j + 2t + 1) are k-step j's
// A fragment in the permuted K order
template <int N>
__device__ __forceinline__ void act_split(float* acc, const float* bias, bool relu, int t,
                                          uint32_t (&ah)[MAX_STEPS][4],
                                          uint32_t (&al)[MAX_STEPS][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 bb = lds2(bias + 8 * j + 2 * t);
    float v[4] = {acc[4 * j] + bb.x, acc[4 * j + 2] + bb.x, acc[4 * j + 1] + bb.y,
                  acc[4 * j + 3] + bb.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (relu) v[i] = fmaxf(v[i], 0.f);
      split_tf32(v[i], ah[j][i], al[j][i]);
    }
    acc[4 * j] = v[0]; acc[4 * j + 2] = v[1]; acc[4 * j + 1] = v[2]; acc[4 * j + 3] = v[3];
  }
}

// dense layer i's image: resident, or written into the stage by the
// consumers between two of their barriers
template <int W>
__device__ __forceinline__ const float* layer_image(const Args& A, float* sm, int i) {
  if (A.M.img[i] >= 0) return sm + A.M.img[i];
  named_barrier(BAR_CONS, NCONS);  // every consumer done with the stage's last layer
  put_image(A, i, W, sm + A.M.stage, threadIdx.x, NCONS);
  fence_proxy_async();
  named_barrier(BAR_CONS, NCONS);
  return sm + A.M.stage;
}

// q and alpha of a point (fused_train._alpha_terms)
__device__ __forceinline__ void alpha_terms(const Args& A, float raw, float delta, float& q,
                                            float& alpha) {
  if (A.mode == 0) {
    const float sigma = A.relu_density ? fmaxf(raw, 0.f)
                                       : fmaxf(raw, 0.f) + log1pf(expf(-fabsf(raw)));
    q = sigma * delta;
    alpha = 1.f - expf(-q);
  } else {
    q = delta * raw;  // raw density in the prefix sum: T may exceed 1
    alpha = 1.f - expf(-fmaxf(q, 0.f));
  }
}

template <int W>
__device__ __forceinline__ void consumer(const Args& A, float* sm, long long r_begin, int np,
                                         int ntiles, uint64_t* full,
                                         uint64_t* empty) {
  constexpr int WH = W / 2;
  const Smem& M = A.M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = 64 * (tid >> 7) + 16 * (warp & 3) + g, row1 = row0 + 8;
  const int S = A.S, D = A.D, n0 = ru(A.E, 8) / 8;
#ifdef INGP_EVAL_CLOCKS
  const bool timed = blockIdx.x == 0 && tid == 0;
  long long clk[N_CONS_PHASES] = {}, clk_last = clock64();
#endif
  for (int j = 0; j < ntiles; ++j) {
    const int b = j & 1;
    // the tile's points lo .. lo + n - 1 of the block's, from its ray lra
    // (block-local 32-bit indices; the block's first point is r_begin * S)
    const int lo = j * A.tile_pts, n = min(A.tile_pts, np - lo), lra = lo / S;
    const long long g0 = r_begin * S + lo;
    mbar_wait(&full[b], (j >> 1) & 1);
    EVAL_CLOCK(timed, 0);

    // ---------------- the MLP: the trunk, the alpha head, the feature layer ----------------
    uint32_t ah[MAX_STEPS][4], al[MAX_STEPS][4];
    {
      const float* fb = sm + M.feats + b * TILE * M.se;
      const float* f0 = fb + row0 * M.se + 2 * t;
      const float* f1 = fb + row1 * M.se + 2 * t;
#pragma unroll
      for (int s = 0; s < MAX_STEPS; ++s) {
        if (s < n0) {
          const float2 u = lds2(f0 + 8 * s), v = lds2(f1 + 8 * s);
          split_tf32(u.x, ah[s][0], al[s][0]);
          split_tf32(v.x, ah[s][1], al[s][1]);
          split_tf32(u.y, ah[s][2], al[s][2]);
          split_tf32(v.y, ah[s][3], al[s][3]);
        }
      }
    }
    float acc[W / 2];
    EVAL_CLOCK(timed, 1);
    dense0<W>(acc, ah, al, n0, layer_image<W>(A, sm, 0));
    EVAL_CLOCK(timed, 2);
    for (int l = 1; l < D; ++l) {
      act_split<W>(acc, sm + M.bt + (l - 1) * W, true, t, ah, al);
      EVAL_CLOCK(timed, 3);
      dense<W, W / 8>(acc, ah, al, layer_image<W>(A, sm, l));
      EVAL_CLOCK(timed, 2);
    }
    act_split<W>(acc, sm + M.bt + (D - 1) * W, true, t, ah, al);
    float sg0 = 0.f, sg1 = 0.f;  // the alpha head on the last trunk output
#pragma unroll
    for (int q = 0; q < W / 8; ++q) {
      const float2 wv = lds2(sm + M.wa + 8 * q + 2 * t);
      sg0 = fmaf(acc[4 * q + 1], wv.y, fmaf(acc[4 * q], wv.x, sg0));
      sg1 = fmaf(acc[4 * q + 3], wv.y, fmaf(acc[4 * q + 2], wv.x, sg1));
    }
    sg0 = row_sum(sg0) + sm[M.ba];
    sg1 = row_sum(sg1) + sm[M.ba];
    EVAL_CLOCK(timed, 3);
    dense<W, W / 8>(acc, ah, al, layer_image<W>(A, sm, D));
    EVAL_CLOCK(timed, 2);
    act_split<W>(acc, sm + M.bf, false, t, ah, al);

    // ---------------- the view layer on [feature, sh], the rgb head ----------------
    float c0[3] = {0.f, 0.f, 0.f}, c1[3] = {0.f, 0.f, 0.f};
    {
      float acc2[W / 4];
      EVAL_CLOCK(timed, 3);
      dense<WH, W / 8>(acc2, ah, al, layer_image<W>(A, sm, D + 1));
      EVAL_CLOCK(timed, 2);
      const float* vs = sm + M.vsh + b * MAX_RAYS * WH;
      const float* vs0 = vs + (row0 < n ? (lo + row0) / S - lra : 0) * WH;
      const float* vs1 = vs + (row1 < n ? (lo + row1) / S - lra : 0) * WH;
#pragma unroll
      for (int q = 0; q < WH / 8; ++q) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * q + 2 * t + e;
          const float h0 = fmaxf(acc2[4 * q + e] + vs0[col], 0.f);
          const float h1 = fmaxf(acc2[4 * q + 2 + e] + vs1[col], 0.f);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float w = sm[M.wr + c * WH + col];
            c0[c] = fmaf(h0, w, c0[c]);
            c1[c] = fmaf(h1, w, c1[c]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      c0[c] = row_sum(c0[c]) + sm[M.br + c];
      c1[c] = row_sum(c1[c]) + sm[M.br + c];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[b]);  // the warp is done with the encoder's buffer

    // ---------------- each point's q, alpha and colour ----------------
    {
      const int r = t == 0 ? row0 : row1;
      if (t < 2 && r < n) {
        float q, alpha;
        alpha_terms(A, t == 0 ? sg0 : sg1, __ldg(A.deltas + g0 + r), q, alpha);
        sm[M.pq + b * TILE + r] = q;
        sm[M.pa + b * TILE + r] = alpha;
        float* pc = sm + M.pc + (b * TILE + r) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float raw = t == 0 ? c0[c] : c1[c];
          pc[c] = A.mode == 0 ? 1.f / (1.f + expf(-raw)) : raw;
        }
      }
    }
    EVAL_CLOCK(timed, 3);
    named_barrier(BAR_CONS, NCONS);
    EVAL_CLOCK(timed, 4);

    // ---------------- a warp per ray segment: scan and composite ----------------
    const int nseg = (lo + n - 1) / S - lra + 1;
    const float* pq = sm + M.pq + b * TILE;
    const float* pa = sm + M.pa + b * TILE;
    const float* pc = sm + M.pc + b * TILE * 3;
    for (int sg = warp; sg < nseg; sg += NCWARP) {
      const int lray = lra + sg;  // its points ps .. pe - 1 of the tile's, block-local
      const int ps = max(lo, lray * S), pe = min(lo + n, (lray + 1) * S);
      float carry = 0.f, tot[4] = {0.f, 0.f, 0.f, 0.f};  // excl; rgb and weight sums
      if (lray * S < lo) {  // continued from the block's last tile
        const float* cr = sm + M.carry + ((j - 1) & 1) * 8;
        carry = cr[0];
#pragma unroll
        for (int c = 0; c < 4; ++c) tot[c] = cr[1 + c];
      }
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      for (int p0 = ps; p0 < pe; p0 += 32) {
        const int p = p0 + lane;
        const bool in = p < pe;
        const int r = p - lo;
        const float incl = warp_scan_up(in ? pq[r] : 0.f, lane);
        float excl = __shfl_up_sync(FULL, incl, 1);
        excl = carry + (lane == 0 ? 0.f : excl);
        carry += __shfl_sync(FULL, incl, 31);
        if (in) {
          const float w = pa[r] * expf(-excl);
          A.weights[g0 + r] = w;
#pragma unroll
          for (int c = 0; c < 3; ++c) part[c] = fmaf(w, pc[3 * r + c], part[c]);
          part[3] += w;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) tot[c] += warp_sum(part[c]);
      if (lane == 0) {
        if ((lray + 1) * S > lo + n) {  // continues in the next tile
          float* cw = sm + M.carry + (j & 1) * 8;
          cw[0] = carry;
#pragma unroll
          for (int c = 0; c < 4; ++c) cw[1 + c] = tot[c];
        } else {
          const float bg = A.white_bkgd ? 1.f - tot[3] : 0.f;
#pragma unroll
          for (int c = 0; c < 3; ++c) A.rgb[(r_begin + lray) * 3 + c] = tot[c] + bg;
        }
      }
    }
    EVAL_CLOCK(timed, 5);
  }
#ifdef INGP_EVAL_CLOCKS
  if (timed)
    for (int k = 0; k < N_CONS_PHASES; ++k) A.rgb[k] = (float)clk[k];
#endif
}

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1) ingp_eval_tc_kernel(const __grid_constant__ Args A) {
  extern __shared__ __align__(128) float sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + A.M.bars);
  uint64_t* empty = full + 2;
  // the block's rays, and their points in tiles
  const long long r_begin = (long long)A.R * blockIdx.x / gridDim.x;
  const long long r_end = (long long)A.R * (blockIdx.x + 1) / gridDim.x;
  const int np = (int)(r_end - r_begin) * A.S;  // the block's points
  const int ntiles = (np + A.tile_pts - 1) / A.tile_pts;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full[i], NENC);
      mbar_init(&empty[i], NCWARP);
    }
    mbar_fence_init();
  }
  load_weights<W>(A, sm);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x >= NCONS)
    encoder<W>(A, sm, r_begin, np, ntiles, full, empty);
  else
    consumer<W>(A, sm, r_begin, np, ntiles, full, empty);
}

bool shape_ok(int W, int D, int L, int F, int DD) {
  return (W == 32 || W == 64) && D >= 1 && D <= MAX_DEPTH && L >= 1 && L <= MAX_LEVELS &&
         (F == 1 || F == 2 || F == 4) && L * F <= MAX_FEATS && DD >= 0 && DD <= MAX_DD;
}

// points a tile: TILE, or for rays of fewer than 6 samples as many as keep
// the rays a tile meets within MAX_RAYS
int tile_points(int S) { return S * (MAX_RAYS - 1) < TILE ? S * (MAX_RAYS - 1) : TILE; }

}  // namespace

// Shared-memory bytes of one block for this shape (0 if the kernel does not
// take it) and, in *streamed, the dense layers whose images are streamed.
extern "C" long long ingp_eval_tc_smem_bytes(int width, int depth, int levels, int features,
                                             int dd, int* streamed) {
  if (!shape_ok(width, depth, levels, features, dd)) return 0;
  const Smem M = smem_layout(width, depth, levels * features, dd);
  int n = 0;
  for (int i = 0; i < depth + 2; ++i) n += M.img[i] < 0;
  if (streamed != nullptr) *streamed = n;
  return 4ll * M.total;
}

// The eval call of one level. tensors: rays_o, rays_d, sh, z, deltas,
// tables; weights / biases: the nn.Linear parameters in linears() order
// (depth + 4); shape: R, S, width, depth, levels, features, dd, log2_T,
// bf16, mode, relu_density, white_bkgd, blocks; res: the L resolutions.
// Returns the first cudaError_t.
extern "C" int ingp_eval_tc_launch(const float* const* tensors, const float* const* weights,
                                   const float* const* biases, float* rgb, float* wts,
                                   const int* shape, const int* res, float bmin, float brange,
                                   void* stream) {
  const int R = shape[0], S = shape[1], W = shape[2], D = shape[3], L = shape[4], F = shape[5];
  const int DD = shape[6], log2_T = shape[7], blocks = shape[12];
  if (!shape_ok(W, D, L, F, DD) || R < 0 || S < 1 || log2_T < 1 || log2_T > 31 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  Args a{};
  a.rays_o = tensors[0]; a.rays_d = tensors[1]; a.sh = tensors[2]; a.z = tensors[3];
  a.deltas = tensors[4]; a.tables = tensors[5];
  for (int l = 0; l < D + 4; ++l) {
    a.w[l] = weights[l];
    a.b[l] = biases[l];
  }
  a.rgb = rgb; a.weights = wts;
  a.T = 1ll << log2_T;
  a.mask = (unsigned)(a.T - 1);
  a.R = R; a.S = S; a.L = L; a.F = F; a.E = L * F; a.D = D; a.DD = DD;
  a.bf16 = shape[8]; a.mode = shape[9]; a.relu_density = shape[10]; a.white_bkgd = shape[11];
  a.tile_pts = tile_points(S);
  a.bmin = bmin; a.brange = brange;
  for (int l = 0; l < L; ++l) a.res[l] = res[l];
  a.M = smem_layout(W, D, a.E, DD);
  const size_t smem = 4 * (size_t)a.M.total;
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  void (*kernel)(Args) = W == 64 ? ingp_eval_tc_kernel<64> : ingp_eval_tc_kernel<32>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = blocks < R ? blocks : R;
  kernel<<<(unsigned)grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
