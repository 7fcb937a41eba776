// Fused point-major sinusoidal encode + NeRF MLP backward for Hopper
// (sm_90a): every dense product on wgmma in 3xTF32.
//
// Replaces nerf_meets_mlx_tpu/kernels/fused_mlp.py::_bwd_kernel (pallas_call
// at :557), the backward of fused_apply's custom VJP (the forward is
// csrc/mlp_fwd_tc.cu). The op takes points [N,3] and view directions [N,3],
// one of each per point, whose raw network output [N,4] (rgb, sigma) is
//
//   sinusoidal encode of the point and the direction
//   ->  D x W MLP with the skips, the alpha head and the view-direction head,
//
// and dout [N,4], and writes d(dout . raw)/d(every weight and bias) in
// nn.Linear's layout ([fan_out][fan_in] weights, then the bias, layer after
// layer in mlp.linears() order, at the offsets the caller gives) and, when
// asked (compute_dx), dX [N,6] = d/d(point, direction) for encodings of at
// most 128 features.
//
// What bounds it: the tensor cores, then the workspace. At lego width (D =
// 8, W = 256, skip after layer 4, 10 / 4 bands with the raw input) a point
// costs the forward again (593,280 MACs), the cotangents of the hidden
// layers (~560,000) and dW (as many MACs as the forward): ~3.49 MFLOP, three
// TF32 products each in 3xTF32, 2.77 / 8.31 ms over 495 TFLOP/s at a
// lego_occ step's 131,072 / 393,216 points. dW sums over the points, so
// every layer's input X and pre-activation cotangent dZ goes through device
// memory: ~2,500 + ~2,450 floats a point written, then read back, ~39.6 KB
// a point, 1.5 / 4.7 ms at 3.35 TB/s.
//
// Design: four launches on the caller's stream.
// * mlp_bwd_pack_kernel writes the weight images the tile kernel streams,
//   from the nn.Linear weights themselves (no host pack): per dense product
//   and per k-step of 8 rows of K, its B operand's TF32 hi and lo halves in
//   the exact shared-memory layout the wgmmas read (core matrices of 8 rows
//   of N x 4 of K, K-major). The forward's products read B = weight
//   ([fan_out][fan_in]); the cotangent products dH = dZ . weight read B =
//   weight^T, so each layer has a second image, written the other way round.
// * mlp_bwd_tile_kernel: csrc/mlp_fwd_tc.cu's warp-specialised tile walk
//   (one persistent block an SM, 384 threads, tiles of 128 points, one
//   producer thread keeping 4 stages of cp.async.bulk in flight on
//   mbarriers, two consumer warpgroups of 64 points at setmaxnreg 232).
//   Per tile: the forward again (encodings straight into the A fragments,
//   activations in shared memory, in place), then the backward from dout:
//   the rgb head's cotangent on the CUDA cores in the view layer's
//   epilogue, dfeat, the last trunk layer's dZ with the alpha head's rank-1
//   term, then dZ_{j-1} = (dZ_j . W_j) * (h_{j-1} > 0) down the trunk. Every
//   layer's input and every dZ (with the heads' dout columns) go to the
//   workspace feature-major ([feature][point]): dW needs both K-major over
//   the points. The relu masks are kept as bits, a thread its own elements,
//   in a per-block buffer that stays in L2. With compute_dx the encoding
//   cotangents dS (layer 0, the skip layers, the view layer) are products
//   too, reduced to dX per point in their epilogues (cos(x b) b per band).
// * mlp_bwd_dw_kernel: dW = X^T dZ for every layer as one grid of 128 x
//   NT output tiles (NT = 128, 64, 32 or 8 by fan_out) and point ranges of
//   `pts_per_split`; per slice of 32 points, cp.async stages X and dZ (two
//   slices in flight, dZ straight into its B image's layout), the block
//   splits the next slice's dZ into its hi / lo halves in place while this
//   slice's products run, each consumer warpgroup splits its 64 rows of X
//   in registers; db is a row sum of dZ in fp32. mlp_bwd_reduce_kernel sums the point ranges' partials in a
//   fixed order: no atomics, two launches give bit-identical results.
//
// Precision: 3xTF32, as csrc/tf32x3.cuh: each fp32 operand x is split into
// hi = rna_tf32(x) and lo = rna_tf32(x - hi), and lo*hi + hi*lo + hi*hi is
// summed (lo*lo dropped). The tensor cores add with truncation, and a whole
// layer kept in their accumulator flips relu decisions that dW sees, so in
// the tile kernel each k-step's three products start from a zeroed
// accumulator and are added to an fp32 sum (rounded to nearest); in dW each
// slice of 32 points is. At W > 128 a k-step runs as pieces of PIECE
// columns, so that the zeroed accumulator and the fp32 sum fit the
// consumers' registers. The heads' cotangents and the alpha head's term are
// fp32 FMAs. Numerics of the encode as csrc/fused_eval.cu: sinf / cosf with
// full range reduction on x*b and x*b + pi/2 formed with __fmul_rn /
// __fadd_rn.
//
// Control: MLP_BWD_ONE_PASS builds hi*hi alone, one TF32 product where the
// kernels take three: the lower-precision build that the gpu tests must see
// miss the gradient tolerance the 3xTF32 build meets.
//
// The TPU kernel's 128-lane packed tile, its band matrix M and its [N,8]
// padded input and output were MXU/VMEM layouts and are not carried over;
// it summed dW in grid-invariant VMEM blocks, which needs its sequential grid.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int TILE = 128;                 // points per tile: 64 per consumer warpgroup
constexpr int NCONS = 256;                // consumer threads (warpgroups 0 and 1)
constexpr int NTHREADS = NCONS + 128;     // and the producer warpgroup
constexpr int NSTAGES = 4;                // weight stages in flight
constexpr int CONS_REGS = 232, PROD_REGS = 40;  // 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr int PIECE = 128;                // columns of a k-step's zeroed accumulator
constexpr int MAX_DEPTH = 17;
constexpr int MAX_SEGS = 80;              // weight images: <= 2 * depth + 4 forward, as many back
constexpr int MAX_JOBS = 48;              // dW products: <= depth + 6 + skips
constexpr int DX_MAX = 128;               // encoding features compute_dx takes
constexpr int PT = 16;                    // floats a point row: x, view dir, dout, dX partials
constexpr float HALF_PI = 1.57079632679489662f;
constexpr int MAX_SMEM = 232448;          // bytes a block may use on sm_90

constexpr int DW_THREADS = 256;           // two warpgroups
constexpr int SLICE = 32;                 // points a slice of dW (four k-steps)
constexpr int LDS = SLICE + 4;            // row stride of the staged slices (conflict-free A loads)
constexpr int DW_M = 128;                 // X rows (fan_in) a dW block: 64 a warpgroup
constexpr int DW_NMAX = 128;              // dZ rows (fan_out) a dW block at most
constexpr int DW_STAGES = 3;              // slices of X and dZ staged: this one and two in flight

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// k-steps (8 rows of K) of an input segment of `dim` features
__host__ __device__ constexpr int ksteps(int dim) { return (dim + 7) / 8; }

// columns of a dS product: an encoding's features padded to 64 or 128
__host__ __device__ constexpr int dx_cols(int dim) { return dim <= 64 ? 64 : 128; }

// x rounded to TF32 to nearest, ties away from zero (cvt.rna.tf32.f32)
__device__ __forceinline__ float rna_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// the generic-proxy writes of this thread to shared memory are seen by the
// async proxy (wgmma's descriptor reads) after the next barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---------------------------------------------------------------------------
// The weight images
// ---------------------------------------------------------------------------

// One B operand's image: B[k][n] = M(n, k) for n < n, k < k (zero past),
// np columns (a multiple of 8) and `steps` k-steps of 8 rows.
struct Seg {
  const float* src;  // M
  int ld;            // M's row stride
  int trans;         // 0: M(n, k) = src[n * ld + k] (weight); 1: src[k * ld + n] (weight^T)
  int n, k;          // real columns and rows of B
  int np, steps;
};

struct PackArgs {
  Seg seg[MAX_SEGS];
  long long off[MAX_SEGS + 1];  // image floats before each segment
  int n_segs;
  float* img;
};

// Per k-step of a segment, 16 * np floats: the hi image then the lo image,
// each [K half (2)][np / 8][8 rows of N][4 of K], the K order of a k-step
// permuted (K index q = 4 * half + kk holds row 2 * kk + half of the step)
// so that a lane's two features of a row, 2t and 2t + 1, are one 64-bit
// load of the activations (csrc/mlp_fwd_tc.cu; fused_train.WGMMA_K_ORDER).
__global__ void __launch_bounds__(256) mlp_bwd_pack_kernel(const __grid_constant__ PackArgs P) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= P.off[P.n_segs]) return;
  int lo = 0, hi = P.n_segs - 1;  // the segment holding i
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (P.off[mid] <= i) lo = mid; else hi = mid - 1;
  }
  const Seg& S = P.seg[lo];
  const long long e = i - P.off[lo];
  const int per_step = 16 * S.np;
  const int step = (int)(e / per_step);
  int r = (int)(e - (long long)step * per_step);
  const int half_lo = r >= 8 * S.np;  // 0: hi image, 1: lo image
  if (half_lo) r -= 8 * S.np;
  const int kh = r / (4 * S.np);
  r -= kh * 4 * S.np;
  const int n = 8 * (r / 32) + (r / 4) % 8;
  const int k = 8 * step + 2 * (r % 4) + kh;
  float v = 0.f;
  if (n < S.n && k < S.k) v = S.trans ? S.src[(size_t)k * S.ld + n] : S.src[(size_t)n * S.ld + k];
  const float h = rna_tf32(v);
  P.img[i] = half_lo ? rna_tf32(v - h) : h;
}

// ---------------------------------------------------------------------------
// The tile kernel: the forward again, the cotangents, the workspace
// ---------------------------------------------------------------------------

struct TileArgs {
  const float* pts;        // [N, 3]
  const float* dirs;       // [N, 3]
  const float* dout;       // [N, 4]
  const float* img;        // the B images, segment after segment (mlp_bwd_pack_kernel)
  const float* bias[MAX_DEPTH];  // the trunk layers' biases
  const float* b_feat;
  const float* b_view;
  const float* w_alpha;    // [1][W]
  const float* w_rgb;      // [3][W/2]
  const float* pos_bands;
  const float* dir_bands;
  float* ws;               // workspace rows of npad floats, feature-major
  long long npad;          // N rounded up to whole tiles
  unsigned* masks;         // [block][layer][mask word][consumer thread]
  float* dx;               // [N, 6] (compute_dx)
  long long N;
  int depth;
  unsigned skip_mask;      // bit j set: layer j takes [encoded position, h]
  int pos_freqs, pos_inc, dir_freqs, dir_inc;
  int compute_dx;
  // workspace rows: encodings, trunk outputs h_0 .. h_{D-1}, feature, view
  // layer output, dZ_0 .. dZ_{D-1}, dfeat, the view layer's dZ, dout's
  // four columns (drgb, dalpha)
  int r_encP, r_encD, r_h, r_feat, r_hd, r_dz, r_dfeat, r_ddir, r_dout;
  int n_segs;
  int2 sched[MAX_SEGS];    // (np, steps) of each image segment, the producer's walk
};

// Shared memory of a tile block: the weight ring (stages of 16 x NMAX
// floats, NMAX the widest product: W, or 128 for the dS products), the
// activation tile [128][W + 8], the ring's mbarriers, the points' rows.
template <int W>
__host__ __device__ constexpr int nmax() { return W > DX_MAX ? W : DX_MAX; }

template <int W>
__host__ __device__ constexpr size_t stage_floats() { return (size_t)16 * nmax<W>(); }

template <int W>
__host__ __device__ constexpr size_t act_offset() {
  return sizeof(float) * NSTAGES * stage_floats<W>();
}

template <int W>
__host__ __device__ constexpr size_t bar_offset() {
  return act_offset<W>() + sizeof(float) * TILE * (W + 8);
}

template <int W>
constexpr size_t tile_smem_bytes() {
  return bar_offset<W>() + 2 * NSTAGES * sizeof(uint64_t) + sizeof(float) * TILE * PT;
}

__device__ __forceinline__ float pick(int a, float x0, float x1, float x2) {
  return a == 0 ? x0 : (a == 1 ? x1 : x2);
}

// Encoded features of one point: sines, cosines as sin(x*b + pi/2), then
// the raw input; features past the count are zero.
__device__ __forceinline__ float encode_feature(int f, int F, int inc, const float* bands,
                                                const float* x) {
  if (f < 3 * F) {
    const int a = f / F, j = f - a * F;
    return sinf(__fmul_rn(pick(a, x[0], x[1], x[2]), __ldg(bands + j)));
  }
  if (f < 6 * F) {
    const int g = f - 3 * F, a = g / F, j = g - a * F;
    return sinf(__fadd_rn(__fmul_rn(pick(a, x[0], x[1], x[2]), __ldg(bands + j)), HALF_PI));
  }
  if (inc && f < 6 * F + 3) return pick(f - 6 * F, x[0], x[1], x[2]);
  return 0.f;
}

// d(feature f)/d(x[axis]) of the same encoding: b cos(x b), b cos(x b +
// pi/2), 1 for the raw input; 0 past the count
__device__ __forceinline__ float dx_coef(int f, int F, int inc, const float* bands,
                                         const float* x, int& axis) {
  axis = 0;
  if (f < 3 * F) {
    const int a = f / F, j = f - a * F;
    const float b = __ldg(bands + j);
    axis = a;
    return b * cosf(__fmul_rn(pick(a, x[0], x[1], x[2]), b));
  }
  if (f < 6 * F) {
    const int g = f - 3 * F, a = g / F, j = g - a * F;
    const float b = __ldg(bands + j);
    axis = a;
    return b * cosf(__fadd_rn(__fmul_rn(pick(a, x[0], x[1], x[2]), b), HALF_PI));
  }
  if (inc && f < 6 * F + 3) {
    axis = f - 6 * F;
    return 1.f;
  }
  return 0.f;
}

// The weight ring as one thread walks it: stage and phase parity.
struct Ring {
  float* buf;       // NSTAGES stages
  uint64_t* full;   // a stage's bytes have landed
  uint64_t* empty;  // the consumers are done with a stage
  int stage = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ void advance() {
    if (++stage == NSTAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// sum[C0/2 ..] += one k-step's products of columns C0 .. N - 1, in pieces
// of at most PIECE columns: each piece's lo*hi, hi*lo and hi*hi summed from
// zero on the tensor cores, then added to the fp32 sum
template <int N, int C0>
__device__ __forceinline__ void pieces(float* sum, const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                       uint64_t dh, uint64_t dl) {
  constexpr int P = N - C0 > PIECE ? PIECE : N - C0;
  float tmp[P / 2];
  wgmma_fence();
#ifdef MLP_BWD_ONE_PASS
  (void)al;
  (void)dl;
  wgmma_tf32<P>(tmp, ah, dh + (uint64_t)C0, 0);
#else
  wgmma_tf32<P>(tmp, al, dh + (uint64_t)C0, 0);
  wgmma_tf32<P>(tmp, ah, dl + (uint64_t)C0, 1);
  wgmma_tf32<P>(tmp, ah, dh + (uint64_t)C0, 1);
#endif
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<P / 2>(tmp);
#pragma unroll
  for (int i = 0; i < P / 2; ++i) sum[C0 / 2 + i] += tmp[i];
  if constexpr (C0 + P < N) pieces<N, C0 + P>(sum, ah, al, dh, dl);
}

// One k-step of an N-column product for a consumer warpgroup: sum += A * B
// in 3xTF32, A the thread's fragment `a` (rows 16w + g and 16w + g + 8,
// permuted K indices 2t and 2t + 1 as 0..3 and 4..7), B the ring's current
// stage. The stage is released once the products are done.
template <int N, int W>
__device__ __forceinline__ void mma_step(float* sum, Ring& ring, const float (&a)[4], int lane) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  const float* B = ring.buf + ring.stage * stage_floats<W>();
  const uint64_t dh = wgmma_desc(B, 16 * N, 128);
  const uint64_t dl = wgmma_desc(B + 8 * N, 16 * N, 128);
  mbar_wait(&ring.full[ring.stage], ring.phase);
  __syncwarp();  // the warp converged for the .aligned wgmma instructions
  pieces<N, 0>(sum, ah, al, dh, dl);
  if (lane == 0) mbar_arrive(&ring.empty[ring.stage]);
  ring.advance();
}

// sum = [segment 1, segment 2] * B: n1 k-steps whose fragments come from
// src1(s, a), then n2 from src2(s, a)
template <int N, int W, class Src1, class Src2>
__device__ __forceinline__ void gemm(float* sum, Ring& ring, int n1, Src1 src1, int n2, Src2 src2,
                                     int lane) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum[i] = 0.f;
  for (int s = 0; s < n1; ++s) {
    float a[4];
    src1(s, a);
    mma_step<N, W>(sum, ring, a, lane);
  }
  for (int s = 0; s < n2; ++s) {
    float a[4];
    src2(s, a);
    mma_step<N, W>(sum, ring, a, lane);
  }
}

// f(c, r, v) for each element of the thread's N-column sum: column c =
// 8j + 2t + e, row r (0: row, 1: row + 8), the sum's index 4j + 2r + e
template <int N, class F>
__device__ __forceinline__ void each(float* sum, int t, F f) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) f(8 * j + 2 * t + e, r, 4 * j + 2 * r + e, sum[4 * j + 2 * r + e]);
}

// sum of v over the 4 lanes of a row (t = lane % 4)
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1) mlp_bwd_tile_kernel(const __grid_constant__ TileArgs A) {
  constexpr int LDA = W + 8;  // 8 or 24 mod 32: the 64-bit loads and stores of a half-warp hit 32 banks
  constexpr int WH = W / 2;
  constexpr int MW = (WH + 31) / 32;  // relu-mask words a thread a layer
  extern __shared__ __align__(128) unsigned char smem[];
  const long long N = A.N;
  const long long npad = A.npad;
  const int ntiles = (int)(npad / TILE);

  Ring ring;
  ring.buf = reinterpret_cast<float*>(smem);
  float* act = reinterpret_cast<float*>(smem + act_offset<W>());  // [TILE][LDA]
  ring.full = reinterpret_cast<uint64_t*>(smem + bar_offset<W>());
  ring.empty = ring.full + NSTAGES;
  float* tpts = reinterpret_cast<float*>(ring.empty + NSTAGES);  // [TILE][PT]

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < NSTAGES; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], NCONS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int D = A.depth;
  const int pos_dim = 6 * A.pos_freqs + 3 * A.pos_inc;
  const int dir_dim = 6 * A.dir_freqs + 3 * A.dir_inc;
  const int pos_steps = ksteps(pos_dim), dir_steps = ksteps(dir_dim);

  if (tid >= NCONS) {
    // ---- producer: every image stage of every tile, in the consumers' order ----
    regs_lower<PROD_REGS>();
    if (tid == NCONS) {
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const float* src = A.img;
        for (int q = 0; q < A.n_segs; ++q) {
          const int n = A.sched[q].x;
          for (int s = 0; s < A.sched[q].y; ++s) {
            mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1u);
            mbar_arrive_expect_tx(&ring.full[ring.stage], 64 * n);
            bulk_copy_g2s(ring.buf + ring.stage * stage_floats<W>(), src, 64 * n,
                          &ring.full[ring.stage]);
            src += 16 * n;
            ring.advance();
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns points 64 cw .. 64 cw + 63 of a tile ----
  regs_raise<CONS_REGS>();
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + g;  // and row + 8
  float* arow = act + row * LDA + 2 * t;
  float* p0 = tpts + row * PT;  // the thread's two points: x, view dir, dout, dX partials
  float* p1 = p0 + 8 * PT;
  unsigned* mask_base = A.masks + (size_t)blockIdx.x * D * MW * NCONS + tid;
  auto wsrow = [&](int r) { return A.ws + (size_t)r * npad; };

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long i0 = (long long)tile * TILE + row, i1 = i0 + 8;
    if (t == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long i = e == 0 ? i0 : i1;
        float v[10];
#pragma unroll
        for (int c = 0; c < 10; ++c) v[c] = 0.f;
        if (i < N) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            v[c] = A.pts[i * 3 + c];
            v[3 + c] = A.dirs[i * 3 + c];
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) v[6 + c] = A.dout[i * 4 + c];
        }
        float* p = e == 0 ? p0 : p1;
#pragma unroll
        for (int c = 0; c < PT; ++c) p[c] = c < 10 ? v[c] : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) wsrow(A.r_dout + c)[i] = v[6 + c];
      }
    }
    __syncwarp();

    const float* pos_bands = A.pos_bands;
    const float* dir_bands = A.dir_bands;
    auto enc_pos = [&](int s, float (&a)[4]) {
      const int f = 8 * s + 2 * t;
      a[0] = encode_feature(f, A.pos_freqs, A.pos_inc, pos_bands, p0);
      a[1] = encode_feature(f, A.pos_freqs, A.pos_inc, pos_bands, p1);
      a[2] = encode_feature(f + 1, A.pos_freqs, A.pos_inc, pos_bands, p0);
      a[3] = encode_feature(f + 1, A.pos_freqs, A.pos_inc, pos_bands, p1);
    };
    // the same, also stored to the workspace (X of layer 0 and the skips)
    auto enc_pos_store = [&](int s, float (&a)[4]) {
      enc_pos(s, a);
      const int f = 8 * s + 2 * t;
      float* r0 = wsrow(A.r_encP + f);
      r0[i0] = a[0]; r0[i1] = a[1]; r0[npad + i0] = a[2]; r0[npad + i1] = a[3];
    };
    auto enc_dir_store = [&](int s, float (&a)[4]) {
      const int f = 8 * s + 2 * t;
      a[0] = encode_feature(f, A.dir_freqs, A.dir_inc, dir_bands, p0 + 3);
      a[1] = encode_feature(f, A.dir_freqs, A.dir_inc, dir_bands, p1 + 3);
      a[2] = encode_feature(f + 1, A.dir_freqs, A.dir_inc, dir_bands, p0 + 3);
      a[3] = encode_feature(f + 1, A.dir_freqs, A.dir_inc, dir_bands, p1 + 3);
      float* r0 = wsrow(A.r_encD + f);
      r0[i0] = a[0]; r0[i1] = a[1]; r0[npad + i0] = a[2]; r0[npad + i1] = a[3];
    };
    auto from_act = [&](int s, float (&a)[4]) {
      const float2 p = *reinterpret_cast<const float2*>(arow + 8 * s);
      const float2 q = *reinterpret_cast<const float2*>(arow + 8 * LDA + 8 * s);
      a[0] = p.x; a[1] = q.x; a[2] = p.y; a[3] = q.y;
    };
    // the element (column c, row r) of the activation tile and of a
    // workspace row block starting at row `r0`
    auto put = [&](int c, int r, float v, int r0) {
      arow[r * 8 * LDA + c - 2 * t] = v;
      wsrow(r0 + c)[r ? i1 : i0] = v;
    };
    // dS (the N-column sum of an encoding's cotangent) into the points' dX
    // partials: sum over the thread's features of d(feature)/d(x) * dS,
    // summed over the 4 lanes of a row, added at p[10 + off ..]
    auto to_dx = [&](float* s, int off, int F, int inc, const float* bands, int dim,
                     auto nc) {
      constexpr int NC = decltype(nc)::value;
      float d[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
      each<NC>(s, t, [&](int c, int r, int, float v) {
        if (c < dim) {
          int axis;
          const float k = dx_coef(c, F, inc, bands, (r ? p1 : p0) + (off ? 3 : 0), axis);
          d[r][0] += axis == 0 ? k * v : 0.f;
          d[r][1] += axis == 1 ? k * v : 0.f;
          d[r][2] += axis == 2 ? k * v : 0.f;
        }
      });
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int a = 0; a < 3; ++a) d[r][a] = row_sum(d[r][a]);
      if (t == 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          p0[10 + off + a] += d[0][a];
          p1[10 + off + a] += d[1][a];
        }
      }
    };

    float sum[nmax<W>() / 2];  // a product's fp32 sums

    // ---- the forward again ----
    for (int j = 0; j < D; ++j) {
      if (j == 0)
        gemm<W, W>(sum, ring, pos_steps, enc_pos_store, 0, from_act, lane);
      else if ((A.skip_mask >> j) & 1u)
        gemm<W, W>(sum, ring, pos_steps, enc_pos, W / 8, from_act, lane);
      else
        gemm<W, W>(sum, ring, W / 8, from_act, 0, from_act, lane);
      const float* b = A.bias[j];
      unsigned m[MW];
#pragma unroll
      for (int q = 0; q < MW; ++q) m[q] = 0u;
      each<W>(sum, t, [&](int c, int r, int i, float v) {
        const float h = fmaxf(v + __ldg(b + c), 0.f);
        put(c, r, h, A.r_h + j * W);
        if (h > 0.f) m[i / 32] |= 1u << (i % 32);
      });
#pragma unroll
      for (int q = 0; q < MW; ++q) mask_base[(j * MW + q) * NCONS] = m[q];
      __syncwarp();
    }
    // feature (W -> W, no activation)
    gemm<W, W>(sum, ring, W / 8, from_act, 0, from_act, lane);
    each<W>(sum, t, [&](int c, int r, int, float v) { put(c, r, v + __ldg(A.b_feat + c), A.r_feat); });
    __syncwarp();
    // view layer on [feature, encoded direction] (W + dir_dim -> W/2, relu);
    // its epilogue starts the backward: d(view output) = (drgb . Wr) * (z > 0)
    gemm<WH, W>(sum, ring, W / 8, from_act, dir_steps, enc_dir_store, lane);
    each<WH>(sum, t, [&](int c, int r, int, float v) {
      const float z = v + __ldg(A.b_view + c);
      const float* d = (r ? p1 : p0) + 6;
      float dd = 0.f;
      if (z > 0.f)
        dd = fmaf(d[2], __ldg(A.w_rgb + 2 * WH + c),
                  fmaf(d[1], __ldg(A.w_rgb + WH + c), d[0] * __ldg(A.w_rgb + c)));
      wsrow(A.r_hd + c)[r ? i1 : i0] = fmaxf(z, 0.f);
      put(c, r, dd, A.r_ddir);
    });
    __syncwarp();

    // ---- the backward ----
    if (A.compute_dx) {  // dS of the encoded direction = d(view) . Wd[:, W:]
      if (dx_cols(dir_dim) == 64) {
        gemm<64, W>(sum, ring, W / 16, from_act, 0, from_act, lane);
        to_dx(sum, 3, A.dir_freqs, A.dir_inc, dir_bands, dir_dim, std::integral_constant<int, 64>());
      } else {
        gemm<128, W>(sum, ring, W / 16, from_act, 0, from_act, lane);
        to_dx(sum, 3, A.dir_freqs, A.dir_inc, dir_bands, dir_dim, std::integral_constant<int, 128>());
      }
      __syncwarp();
    }
    // d(feature) = d(view) . Wd[:, :W]
    gemm<W, W>(sum, ring, W / 16, from_act, 0, from_act, lane);
    each<W>(sum, t, [&](int c, int r, int, float v) { put(c, r, v, A.r_dfeat); });
    __syncwarp();
    // the last trunk layer: dZ = (d(feature) . Wf + dalpha wa) * (h > 0)
    gemm<W, W>(sum, ring, W / 8, from_act, 0, from_act, lane);
    {
      unsigned m[MW];
#pragma unroll
      for (int q = 0; q < MW; ++q) m[q] = mask_base[((D - 1) * MW + q) * NCONS];
      const float da0 = p0[9], da1 = p1[9];
      each<W>(sum, t, [&](int c, int r, int i, float v) {
        const float x = fmaf(r ? da1 : da0, __ldg(A.w_alpha + c), v);
        put(c, r, ((m[i / 32] >> (i % 32)) & 1u) ? x : 0.f, A.r_dz + (D - 1) * W);
      });
    }
    __syncwarp();
    for (int j = D - 1; j >= 1; --j) {
      if (A.compute_dx && ((A.skip_mask >> j) & 1u)) {  // dS of the position at a skip layer
        if (dx_cols(pos_dim) == 64) {
          gemm<64, W>(sum, ring, W / 8, from_act, 0, from_act, lane);
          to_dx(sum, 0, A.pos_freqs, A.pos_inc, pos_bands, pos_dim, std::integral_constant<int, 64>());
        } else {
          gemm<128, W>(sum, ring, W / 8, from_act, 0, from_act, lane);
          to_dx(sum, 0, A.pos_freqs, A.pos_inc, pos_bands, pos_dim, std::integral_constant<int, 128>());
        }
        __syncwarp();
      }
      // dZ_{j-1} = (dZ_j . W_j[:, hidden]) * (h_{j-1} > 0)
      gemm<W, W>(sum, ring, W / 8, from_act, 0, from_act, lane);
      unsigned m[MW];
#pragma unroll
      for (int q = 0; q < MW; ++q) m[q] = mask_base[((j - 1) * MW + q) * NCONS];
      each<W>(sum, t, [&](int c, int r, int i, float v) {
        put(c, r, ((m[i / 32] >> (i % 32)) & 1u) ? v : 0.f, A.r_dz + (j - 1) * W);
      });
      __syncwarp();
    }
    if (A.compute_dx) {  // dS of the position at layer 0, then dX
      if (dx_cols(pos_dim) == 64) {
        gemm<64, W>(sum, ring, W / 8, from_act, 0, from_act, lane);
        to_dx(sum, 0, A.pos_freqs, A.pos_inc, pos_bands, pos_dim, std::integral_constant<int, 64>());
      } else {
        gemm<128, W>(sum, ring, W / 8, from_act, 0, from_act, lane);
        to_dx(sum, 0, A.pos_freqs, A.pos_inc, pos_bands, pos_dim, std::integral_constant<int, 128>());
      }
      __syncwarp();
      if (t == 0) {
        if (i0 < N)
#pragma unroll
          for (int a = 0; a < 6; ++a) A.dx[i0 * 6 + a] = p0[10 + a];
        if (i1 < N)
#pragma unroll
          for (int a = 0; a < 6; ++a) A.dx[i1 * 6 + a] = p1[10 + a];
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// dW = X^T dZ over the points, in 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------

// dW[o][col0 + i] = sum_p X[i][p] dZ[o][p] for i < m, o < n (and db[o] =
// sum_p dZ[o][p]), X and dZ workspace rows
struct Job {
  int x_row, m;       // X: rows x_row .. x_row + m - 1 (the layer input's features)
  int z_row, n;       // dZ: rows z_row .. z_row + n - 1 (the output features' cotangents)
  int out_off, ldo, col0;  // dW[o][col0 + i] at out_off + o * ldo + col0 + i
  int bias_off;       // db[o] at bias_off + o; -1: none
  int nt;             // output columns (fan_out) a block: 8, 32, 64 or 128
  int tiles_n, tile0; // blocks along n, first block of this job
};

struct DwArgs {
  const float* ws;
  long long npad;
  float* part;        // [split][part_stride]: the grads' layout per point range
  long long part_stride;
  int pts_per_split;
  int n_jobs;
  Job jobs[MAX_JOBS];
};

// X stages [DW_STAGES][DW_M][LDS], dZ stages [DW_STAGES][4 k-steps][hi, lo]
// [8 DW_NMAX], the point rows' partial column sums [DW_THREADS]
constexpr size_t dw_smem_bytes() {
  return sizeof(float) * ((size_t)DW_STAGES * (DW_M * LDS + 64 * DW_NMAX) + DW_THREADS);
}

// One block's tile: X rows m0 .. m0 + 127 (warpgroup cw the 64 from
// m0 + 64 cw) by dZ rows n0 .. n0 + NT - 1, over points pb .. pe - 1 in
// slices of 32. cp.async keeps the next two slices of X and dZ in flight,
// dZ landing in its B image's layout (core matrices of 8 rows x 4 points,
// natural K order, each k-step's 8 NT floats followed by room for its lo
// half); while a slice's products run, the block rounds the next slice's
// dZ to its TF32 hi half in place and writes its lo half beside it, 16
// bytes at a time; each warpgroup splits its 64 rows of X in registers. A
// slice's 4 k-steps x 3 products are summed from zero on the tensor cores,
// then added to the fp32 sum. db: each thread sums one dZ row's points of
// the chunks it splits; the rows' partials are added in thread order.
template <int NT>
__device__ __forceinline__ void dw_tile(const DwArgs& G, const Job& J, int m0, int n0,
                                        long long pb, long long pe, float* out,
                                        unsigned char* smem) {
  constexpr int CHUNKS = 8 * NT;                       // 16-byte pieces of a dZ slice
  constexpr int SPLITTERS = CHUNKS < DW_THREADS ? CHUNKS : DW_THREADS;
  float* Xs = reinterpret_cast<float*>(smem);          // [DW_STAGES][DW_M][LDS]
  float* Zs = Xs + DW_STAGES * DW_M * LDS;             // [DW_STAGES][4][2][8 DW_NMAX]
  float* part = Zs + DW_STAGES * 64 * DW_NMAX;         // [DW_THREADS]
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int cw = tid >> 7;
  const int arow = 64 * cw + 16 * ((tid >> 5) & 3) + g;
  const bool bias = J.bias_off >= 0 && m0 == 0;
  const long long npad = G.npad;
  const float* X = G.ws + (size_t)J.x_row * npad;
  const float* Z = G.ws + (size_t)J.z_row * npad;
  const int slices = (int)((pe - pb) / SLICE);
  // the chunk c's place in a slice's image: dZ row r = c % NT, points
  // 4 (c / NT) .. + 3, i.e. k-step ks, K half kh
  auto chunk_at = [](int c) {
    const int r = c % NT, q = c / NT, ks = q >> 1, kh = q & 1;
    return ks * 16 * NT + (kh * (NT / 8) + r / 8) * 32 + (r % 8) * 4;
  };

  // slice q into stage q % DW_STAGES; one commit group a call, empty past the end
  auto fetch = [&](int q) {
    if (q < slices) {
      const long long p0 = pb + (long long)q * SLICE;
      const int st = q % DW_STAGES;
      for (int idx = tid; idx < DW_M * 8; idx += DW_THREADS) {
        const int r = idx >> 3, ch = idx & 7;
        const bool ok = m0 + r < J.m;
        cp_async16(Xs + (st * DW_M + r) * LDS + 4 * ch,
                   ok ? X + (size_t)(m0 + r) * npad + p0 + 4 * ch : X, ok);
      }
      float* zs = Zs + st * 64 * DW_NMAX;
      for (int c = tid; c < CHUNKS; c += DW_THREADS) {
        const int r = c % NT;
        const bool ok = n0 + r < J.n;
        cp_async16(zs + chunk_at(c), ok ? Z + (size_t)(n0 + r) * npad + p0 + 4 * (c / NT) : Z, ok);
      }
    }
    cp_async_commit();
  };
  // slice q's dZ: hi = rna(v) in place, lo = rna(v - hi) 8 NT floats on;
  // the thread's row sum of the fp32 values
  float bsum = 0.f;
  auto split = [&](int q) {
    float* zs = Zs + (q % DW_STAGES) * 64 * DW_NMAX;
    for (int c = tid; c < CHUNKS; c += DW_THREADS) {
      float4* at = reinterpret_cast<float4*>(zs + chunk_at(c));
      const float4 v = *at;
      bsum += ((v.x + v.y) + v.z) + v.w;
      const float4 h = make_float4(rna_tf32(v.x), rna_tf32(v.y), rna_tf32(v.z), rna_tf32(v.w));
      *at = h;
      at[2 * NT] = make_float4(rna_tf32(v.x - h.x), rna_tf32(v.y - h.y), rna_tf32(v.z - h.z),
                               rna_tf32(v.w - h.w));
    }
    fence_proxy_async();
  };

  float sum[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) sum[i] = 0.f;
  for (int q = 0; q < DW_STAGES; ++q) fetch(q);
  cp_async_wait<DW_STAGES - 1>();
  __syncthreads();
  split(0);
  __syncthreads();
  // both warpgroups run every slice's products, also one whose X rows lie
  // past m (zeros, its sums not stored): the wgmmas and their wait stay in
  // one uniform region, so the split of the next slice overlaps them
  for (int q = 0; q < slices; ++q) {
    float tmp[NT / 2];
    const float* xs = Xs + ((q % DW_STAGES) * DW_M + arow) * LDS;
    const float* zs = Zs + (q % DW_STAGES) * 64 * DW_NMAX;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      split_tf32(xs[8 * ks + t], ah[ks][0], al[ks][0]);
      split_tf32(xs[8 * LDS + 8 * ks + t], ah[ks][1], al[ks][1]);
      split_tf32(xs[8 * ks + t + 4], ah[ks][2], al[ks][2]);
      split_tf32(xs[8 * LDS + 8 * ks + t + 4], ah[ks][3], al[ks][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t dh = wgmma_desc(zs + ks * 16 * NT, 16 * NT, 128);
#ifdef MLP_BWD_ONE_PASS
      wgmma_tf32<NT>(tmp, ah[ks], dh, ks > 0);
#else
      const uint64_t dl = wgmma_desc(zs + ks * 16 * NT + 8 * NT, 16 * NT, 128);
      wgmma_tf32<NT>(tmp, al[ks], dh, ks > 0);
      wgmma_tf32<NT>(tmp, ah[ks], dl, 1);
      wgmma_tf32<NT>(tmp, ah[ks], dh, 1);
#endif
    }
    wgmma_commit();
    // while the products run: the next slice's images
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();  // slice q + 1 landed for every thread
    if (q + 1 < slices) split(q + 1);
    wgmma_wait<0>();
    fence_regs<NT / 2>(tmp);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) sum[i] += tmp[i];
    __syncthreads();  // slice q's stage is free, q + 1's images visible
    fetch(q + DW_STAGES);
  }
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = m0 + arow + 8 * r, o = n0 + 8 * j + 2 * t + e;
        if (i < J.m && o < J.n) out[J.out_off + (size_t)o * J.ldo + J.col0 + i] = sum[4 * j + 2 * r + e];
      }
  if (bias) {  // row r's partials: threads r, r + NT, ... below SPLITTERS, in that order
    part[tid] = bsum;
    __syncthreads();
    if (tid < NT && n0 + tid < J.n) {
      float b = 0.f;
      for (int u = tid; u < SPLITTERS; u += NT) b += part[u];
      out[J.bias_off + n0 + tid] = b;
    }
  }
}

__global__ void __launch_bounds__(DW_THREADS, 1) mlp_bwd_dw_kernel(const __grid_constant__ DwArgs G) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x;
  int j = 0;
  while (j + 1 < G.n_jobs && G.jobs[j + 1].tile0 <= b) ++j;
  const Job& J = G.jobs[j];
  const int local = b - J.tile0;
  const int m0 = (local / J.tiles_n) * DW_M, n0 = (local % J.tiles_n) * J.nt;
  const long long pb = (long long)blockIdx.y * G.pts_per_split;
  const long long pe = pb + G.pts_per_split < G.npad ? pb + G.pts_per_split : G.npad;
  float* out = G.part + (size_t)blockIdx.y * G.part_stride;
  switch (J.nt) {
    case 8: dw_tile<8>(G, J, m0, n0, pb, pe, out, smem); break;
    case 32: dw_tile<32>(G, J, m0, n0, pb, pe, out, smem); break;
    case 64: dw_tile<64>(G, J, m0, n0, pb, pe, out, smem); break;
    default: dw_tile<128>(G, J, m0, n0, pb, pe, out, smem); break;
  }
}

// dw[i] = sum over point ranges of part[range][i], in range order
__global__ void __launch_bounds__(256) mlp_bwd_reduce_kernel(const float* __restrict__ part,
                                                             long long stride, int n_splits,
                                                             float* __restrict__ dw, int n_dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_dw) {
    float s = 0.f;
    for (int k = 0; k < n_splits; ++k) s += part[(size_t)k * stride + i];
    dw[i] = s;
  }
}

// ---------------------------------------------------------------------------
// Host side: the plan of one call
// ---------------------------------------------------------------------------

// The MLP widths a build instantiates: 32, 64, 128 and 256, or with
// -DKW=<width> that width alone, any multiple of 16 from 32 to 256
// (kernels/fused_train.py::width_defines): a width the presets do not use
// is a build of its own and adds nothing to the others' compile time.
#ifdef KW
static_assert(KW % 16 == 0 && KW >= 32 && KW <= 256, "KW is a multiple of 16 in 32..256");
bool width_ok(int w) { return w == KW; }
#define PICK_WIDTH(K, w) ((w) == KW ? K<KW> : nullptr)
#define PICK_SMEM(w) ((w) == KW ? tile_smem_bytes<KW>() : 0)
#else
bool width_ok(int w) { return w == 32 || w == 64 || w == 128 || w == 256; }
#define PICK_WIDTH(K, w)                                                                    \
  ((w) == 256 ? K<256> : (w) == 128 ? K<128> : (w) == 64 ? K<64> : (w) == 32 ? K<32> : nullptr)
#define PICK_SMEM(w)                                                                        \
  ((w) == 256 ? tile_smem_bytes<256>() : (w) == 128 ? tile_smem_bytes<128>()                \
   : (w) == 64 ? tile_smem_bytes<64>() : (w) == 32 ? tile_smem_bytes<32>() : 0)
#endif

// The image segments in the order the tile kernel consumes them, and the
// workspace rows. w: the D + 4 nn.Linear weights in mlp.linears() order
// (pos_linears, alpha, feature, dir, rgb; null for sizing only).
struct Plan {
  Seg seg[MAX_SEGS];
  int n_segs = 0;
  long long img_floats = 0;
  int r_encP, r_encD, r_h, r_feat, r_hd, r_dz, r_dfeat, r_ddir, r_dout, rows;
};

bool make_plan(const float* const* w, int D, int W, unsigned skip_mask, int P, int Dd, bool dx,
               Plan& pl) {
  const float* none[MAX_DEPTH + 4] = {};
  if (w == nullptr) w = none;
  const int WH = W / 2;
  bool ok = true;
  auto add = [&](const float* src, int ld, int trans, int n, int k, int np) {
    if (pl.n_segs >= MAX_SEGS) {
      ok = false;
      return;
    }
    Seg& s = pl.seg[pl.n_segs++];
    s.src = src; s.ld = ld; s.trans = trans; s.n = n; s.k = k; s.np = np; s.steps = ksteps(k);
    pl.img_floats += (long long)s.steps * 16 * np;
  };
  auto skip = [&](int j) { return ((skip_mask >> j) & 1u) != 0; };
  // the forward: B = weight, [fan_out][fan_in]
  add(w[0], P, 0, W, P, W);
  for (int j = 1; j < D; ++j) {
    if (skip(j)) {
      add(w[j], P + W, 0, W, P, W);
      add(w[j] ? w[j] + P : nullptr, P + W, 0, W, W, W);
    } else {
      add(w[j], W, 0, W, W, W);
    }
  }
  add(w[D + 1], W, 0, W, W, W);                       // feature
  add(w[D + 2], W + Dd, 0, WH, W, WH);                // view: the feature part
  add(w[D + 2] ? w[D + 2] + W : nullptr, W + Dd, 0, WH, Dd, WH);  // and the direction part
  // the backward: B = weight^T, [fan_in][fan_out]
  if (dx) add(w[D + 2] ? w[D + 2] + W : nullptr, W + Dd, 1, Dd, WH, dx_cols(Dd));
  add(w[D + 2], W + Dd, 1, W, WH, W);                 // d(feature)
  add(w[D + 1], W, 1, W, W, W);                       // dZ of the last trunk layer
  for (int j = D - 1; j >= 1; --j) {
    if (skip(j)) {
      if (dx) add(w[j], P + W, 1, P, W, dx_cols(P));
      add(w[j] ? w[j] + P : nullptr, P + W, 1, W, W, W);
    } else {
      add(w[j], W, 1, W, W, W);
    }
  }
  if (dx) add(w[0], P, 1, P, W, dx_cols(P));
  int r = 0;
  pl.r_encP = r; r += round_up(P, 8);
  pl.r_encD = r; r += round_up(Dd, 8);
  pl.r_h = r; r += D * W;
  pl.r_feat = r; r += W;
  pl.r_hd = r; r += WH;
  pl.r_dz = r; r += D * W;
  pl.r_dfeat = r; r += W;
  pl.r_ddir = r; r += WH;
  pl.r_dout = r; r += 4;
  pl.rows = r;
  return ok;
}

struct Layout {
  size_t img, ws, masks, part, total;
  long long npad, part_stride;
  int grid, n_splits;
};

// scratch floats: the images, the workspace, the relu masks, the dW partials
Layout layout(const Plan& pl, long long N, int blocks, int depth, int W, int pts_per_split,
              int n_dw) {
  Layout L{};
  L.npad = (N + TILE - 1) / TILE * TILE;
  const long long tiles = L.npad / TILE;
  L.grid = (int)(tiles < blocks ? tiles : blocks);
  size_t o = 0;
  auto take = [&](size_t n) {
    const size_t at = o;
    o += (n + 31) / 32 * 32;  // every piece starts on 128 bytes
    return at;
  };
  L.img = take((size_t)pl.img_floats);
  L.ws = take((size_t)pl.rows * (size_t)L.npad);
  L.masks = take((size_t)L.grid * depth * ((W / 2 + 31) / 32) * NCONS);
  L.n_splits = (int)((L.npad + pts_per_split - 1) / pts_per_split);
  L.part_stride = (n_dw + 31) / 32 * 32;
  L.part = take((size_t)L.n_splits * (size_t)L.part_stride);
  L.total = o;
  return L;
}

bool valid_shape(long long N, int blocks, int depth, int W, unsigned skip_mask, int pos_dim,
                 int dir_dim, int pts_per_split) {
  return N > 0 && blocks > 0 && depth >= 2 && depth <= MAX_DEPTH && width_ok(W) &&
         (skip_mask & 1u) == 0 && (skip_mask >> depth) == 0 && pos_dim > 0 && dir_dim > 0 &&
         pts_per_split > 0 && pts_per_split % SLICE == 0;
}

}  // namespace

// Shared-memory bytes one block of the tile kernel needs (0 if the width
// is not supported); lets the wrapper check a shape before launching.
extern "C" long long mlp_bwd_tc_smem_bytes(int width) {
  if (!width_ok(width)) return 0;
  return (long long)PICK_SMEM(width);
}

// Floats of the weight images of one call (the size the pack kernel writes).
extern "C" long long mlp_bwd_tc_image_floats(int depth, int width, unsigned skip_mask, int pos_dim,
                                             int dir_dim, int compute_dx) {
  Plan pl;
  if (depth < 2 || depth > MAX_DEPTH ||
      !make_plan(nullptr, depth, width, skip_mask, pos_dim, dir_dim, compute_dx != 0, pl))
    return 0;
  return pl.img_floats;
}

// Floats of device scratch one call needs (0 for a shape it does not take).
extern "C" long long mlp_bwd_tc_scratch_floats(long long N, int blocks, int depth, int width,
                                               unsigned skip_mask, int pos_dim, int dir_dim,
                                               int compute_dx, int pts_per_split, int n_dw) {
  if (!valid_shape(N, blocks, depth, width, skip_mask, pos_dim, dir_dim, pts_per_split) || n_dw <= 0)
    return 0;
  Plan pl;
  if (!make_plan(nullptr, depth, width, skip_mask, pos_dim, dir_dim, compute_dx != 0, pl)) return 0;
  return (long long)layout(pl, N, blocks, depth, width, pts_per_split, n_dw).total;
}

// The backward of one call: grads (n_dw floats; linear i's weight at
// goffs[2i], [fan_out][fan_in], its bias at goffs[2i + 1]) and, when dx is
// not null, dX [N, 6]. weights / biases: host arrays of the depth + 4
// nn.Linear tensors' device pointers in mlp.linears() order; scratch:
// mlp_bwd_tc_scratch_floats floats. Launches the pack, tile, dW and reduce
// kernels on `stream` (the tile kernel with at most `blocks` blocks);
// returns the first cudaError_t.
extern "C" int mlp_bwd_tc_launch(const float* pts, const float* dirs, const float* dout,
                                 const float* const* weights, const float* const* biases,
                                 const float* pos_bands, const float* dir_bands, float* grads,
                                 const int* goffs, int n_dw, float* dx, float* scratch, long long N,
                                 int blocks, int depth, int width, unsigned skip_mask,
                                 int pos_freqs, int pos_inc, int dir_freqs, int dir_inc,
                                 int pts_per_split, void* stream) {
  if (N == 0) return 0;
  const int W = width, D = depth, WH = W / 2;
  const int P = 6 * pos_freqs + 3 * pos_inc, Dd = 6 * dir_freqs + 3 * dir_inc;
  if (!valid_shape(N, blocks, D, W, skip_mask, P, Dd, pts_per_split) || n_dw <= 0)
    return (int)cudaErrorInvalidValue;
  if (dx && (P > DX_MAX || Dd > DX_MAX)) return (int)cudaErrorInvalidValue;
  Plan pl;
  if (!make_plan(weights, D, W, skip_mask, P, Dd, dx != nullptr, pl))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(pl, N, blocks, D, W, pts_per_split, n_dw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = PICK_SMEM(W);
  void (*tile_kernel)(TileArgs) = PICK_WIDTH(mlp_bwd_tile_kernel, W);
  if (tile_kernel == nullptr || smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;

  // 1. the weight images
  PackArgs pk{};
  pk.n_segs = pl.n_segs;
  pk.off[0] = 0;
  for (int q = 0; q < pl.n_segs; ++q) {
    pk.seg[q] = pl.seg[q];
    pk.off[q + 1] = pk.off[q] + (long long)pl.seg[q].steps * 16 * pl.seg[q].np;
  }
  pk.img = scratch + L.img;
  mlp_bwd_pack_kernel<<<(unsigned)((pl.img_floats + 255) / 256), 256, 0, st>>>(pk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 2. the tile kernel
  TileArgs a{};
  a.pts = pts; a.dirs = dirs; a.dout = dout; a.img = scratch + L.img;
  for (int j = 0; j < D; ++j) a.bias[j] = biases[j];
  a.b_feat = biases[D + 1]; a.b_view = biases[D + 2];
  a.w_alpha = weights[D]; a.w_rgb = weights[D + 3];
  a.pos_bands = pos_bands; a.dir_bands = dir_bands;
  a.ws = scratch + L.ws; a.npad = L.npad;
  a.masks = reinterpret_cast<unsigned*>(scratch + L.masks);
  a.dx = dx; a.N = N; a.depth = D; a.skip_mask = skip_mask;
  a.pos_freqs = pos_freqs; a.pos_inc = pos_inc; a.dir_freqs = dir_freqs; a.dir_inc = dir_inc;
  a.compute_dx = dx != nullptr;
  a.r_encP = pl.r_encP; a.r_encD = pl.r_encD; a.r_h = pl.r_h; a.r_feat = pl.r_feat;
  a.r_hd = pl.r_hd; a.r_dz = pl.r_dz; a.r_dfeat = pl.r_dfeat; a.r_ddir = pl.r_ddir;
  a.r_dout = pl.r_dout;
  a.n_segs = pl.n_segs;
  for (int q = 0; q < pl.n_segs; ++q) a.sched[q] = make_int2(pl.seg[q].np, pl.seg[q].steps);
  err = cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tile_kernel<<<(unsigned)L.grid, NTHREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 3. dW: one job a (layer, input segment); X rows m, dZ rows n
  DwArgs G{};
  int nj = 0, tiles = 0;
  bool ok = true;
  auto add = [&](int x_row, int m, int z_row, int n, int lin, int ldo, int col0, bool with_bias) {
    if (nj >= MAX_JOBS) {
      ok = false;
      return;
    }
    Job& J = G.jobs[nj++];
    J.x_row = x_row; J.m = m; J.z_row = z_row; J.n = n;
    J.out_off = goffs[2 * lin]; J.ldo = ldo; J.col0 = col0;
    J.bias_off = with_bias ? goffs[2 * lin + 1] : -1;
    J.nt = n > 64 ? 128 : (n > 32 ? 64 : (n > 8 ? 32 : 8));
    J.tiles_n = (n + J.nt - 1) / J.nt;
    J.tile0 = tiles;
    tiles += ((m + DW_M - 1) / DW_M) * J.tiles_n;
  };
  add(pl.r_encP, P, pl.r_dz, W, 0, P, 0, true);
  for (int j = 1; j < D; ++j) {
    const int dz = pl.r_dz + j * W, hprev = pl.r_h + (j - 1) * W;
    if ((skip_mask >> j) & 1u) {
      add(pl.r_encP, P, dz, W, j, P + W, 0, true);
      add(hprev, W, dz, W, j, P + W, P, false);
    } else {
      add(hprev, W, dz, W, j, W, 0, true);
    }
  }
  const int h_last = pl.r_h + (D - 1) * W;
  add(h_last, W, pl.r_dout + 3, 1, D, W, 0, true);           // alpha
  add(h_last, W, pl.r_dfeat, W, D + 1, W, 0, true);          // feature
  add(pl.r_feat, W, pl.r_ddir, WH, D + 2, W + Dd, 0, true);  // view: the feature part
  add(pl.r_encD, Dd, pl.r_ddir, WH, D + 2, W + Dd, W, false);  // and the direction part
  add(pl.r_hd, WH, pl.r_dout, 3, D + 3, WH, 0, true);        // rgb
  if (!ok) return (int)cudaErrorInvalidValue;
  G.ws = scratch + L.ws; G.npad = L.npad;
  G.part = scratch + L.part; G.part_stride = L.part_stride;
  G.pts_per_split = pts_per_split; G.n_jobs = nj;
  err = cudaFuncSetAttribute(mlp_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dw_smem_bytes());
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_dw_kernel<<<dim3((unsigned)tiles, (unsigned)L.n_splits), DW_THREADS, dw_smem_bytes(), st>>>(G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 4. the partials summed in range order
  mlp_bwd_reduce_kernel<<<(n_dw + 255) / 256, 256, 0, st>>>(scratch + L.part, L.part_stride,
                                                            L.n_splits, grads, n_dw);
  return (int)cudaGetLastError();
}
