// Fused Instant-NGP and feat train kernels for Hopper (sm_90a): the MLP on
// the tensor cores in 3xTF32, each tile's activations and cotangents kept
// on chip. One tile walk (tc_tiles) serves both; they differ only before
// and after the MLP (the feat kernel is described at the end of this note).
//
// Replaces nerf_meets_mlx_tpu/kernels/fused_ingp_train.py::_ingp_train_kernel
// (pallas_call at :589) for the shapes listed below; every other shape runs
// csrc/fused_ingp.cu's runtime-shape build (kernels/fused_ingp_train.py
// routes by shape before the launch). One call takes one level's rays
// (origin, direction), their spherical harmonics sh [R,DD], sample depths z
// [R,S], deltas [R,S] (scaled by |d|, terminal bin 1e10*|d|), pre-scaled
// density noise [R,S] and target colours [R,3], the hash tables [L,T,F] and
// the MLP's nn.Linear parameters as PyTorch holds them ([out][in] weights),
// and writes rgb [R,3], weights [R,S], sse = sum over rays |rgb - target|^2,
// d(sse)/d(every weight and bias) -- one flat buffer, each weight [out][in]
// as its parameter, so that the gradients are views of it -- and
// d(sse)/d(tables) [L,T,F] (zeroed by the caller). The chain, per tile:
//
//   hash encode -> MLP forward -> compositing -> loss -> compositing
//   backward -> MLP backward -> dW and dG
//
// Shapes taken: width W = 32 or 64 (a template argument); 1..16 levels of
// 1, 2 or 4 features, L*F <= 64; depth 1..8; at most 64 SH channels; and a
// tile of whole rays that fits in shared memory: at most 96 points (S <=
// 96) and the budget below. lego_ingp (W 64, depth 2, 8 x 2 features, 16
// channels) takes 2 rays x 48 = 96 points a tile at the coarse level, 1 x
// 96 at the fine one, lego_ingp_occ 3 x 32. A deeper trunk, more feature
// channels or a longer ray get fewer rays a tile; where one ray does not
// fit (width 64 with depth 4 at S = 48, or 16 levels of 4 features at S =
// 96; S > 96) the shape runs in the runtime-shape build instead.
//
// What bounds it, at lego_ingp's fine level (393,216 points): the MLP's
// 3xTF32 work, 3 x 2 x (fwd 12,032 + dW 11,264 + dX 10,240) MACs a point,
// 0.16 ms at 495 TFLOP/s; the bytes (~48 a point in and out, the 1 MB
// tables, dG), ~0.01 ms; and what has no peak rate in the table: 64 hashed
// 8-byte lookups and 64 scattered adds into dG a point (the standalone hash
// forward and backward take 0.136 and 0.722 ms at this batch, PERF.md).
//
// Design:
//
// * A persistent grid of one 384-thread block (12 warps) an SM walks the
//   tiles in a fixed order (tile = block + k * grid). Each block first
//   copies the MLP's fp32 weights, transposed to [in][out], into shared
//   memory (53 KB at lego_ingp), once for the whole launch.
// * Per tile: the points o + z*d, their density noise and deltas, and the
//   rays' SH, into shared memory; the hash features of every (point,
//   level) (8 corner rows, float2/float4 lookups) and, per ray, the view
//   layer's SH term sh . W_view[:, W:] + b_view (once a ray, not once a
//   point). Then the MLP, a warp pair per 16-point row tile, each warp
//   computing half of a layer's output columns on the tensor cores:
//   mma.sync m16n8k8 in 3xTF32 (the products lo*hi, hi*lo, hi*hi of x =
//   hi + lo, both TF32), A read from the layer's input in shared memory (a
//   k-step's column pair as one 64-bit load, the K order permuted to
//   match the rows read from B), every layer's output stored there,
//   point-major, for the next layer, dW and the relu masks. Each k-step's
//   products are summed from zero and added in fp32, as in
//   csrc/fused_train.cu: a whole layer in the truncating accumulator errs
//   ~6x more than an fp32 sum and flips relu decisions that the plain
//   version does not, which moves a point's whole cotangent. The alpha
//   head (N = 1) and the rgb head (N = 3) run on the CUDA cores, 4 lanes a
//   point. A warp per ray composites (the exclusive transmittance scan as
//   warp scans over chunks of 32 samples) and forms its squared error and
//   the closed-form compositing backward (the reverse suffix sum
//   likewise). The backward alternates the tile's dW = X^T dZ of a layer
//   (all warps, K = the tile's points in the accumulator: dW sets no relu
//   decision) with the cotangent product dZ W^T of the layer below, which
//   writes into the buffer whose contents are dead by then (the feature
//   layer's output, then each trunk layer's), so that no cotangent lives
//   in registers across a barrier. The table gradient is scattered last, a
//   lane per (point, level), one vector atomic (float2/float4) a corner.
//   Lanes of a warp hold neighbouring samples, which on the coarse levels
//   often share a cell; such runs are summed first by a segmented warp
//   scan, and their last lane adds (3-5% of the launch, PERF.md).
// * Nothing of a tile but its outputs leaves the chip: no workspace. Each
//   block adds its tiles' dW into its own fp32 partial in shared memory (a
//   fixed thread owns each entry, no atomics), so the tensor cores'
//   truncating accumulator holds one tile's points at most, and copies it
//   to device memory once, at its end; a second launch sums the partials
//   in block order (and the per-block sse), so dW and sse are
//   bit-identical from run to run. Only dG's atomics add in a
//   run-dependent order.
// * mma.sync rather than wgmma: wgmma reads a TF32 B operand K-major only,
//   so the cotangent products dZ W^T would need a second, transposed image
//   of every weight (or hi/lo images of every activation and cotangent as
//   B), and a 64-row M tile per warpgroup; with mma.sync one fp32 copy of
//   each weight in shared memory serves both directions (the forward reads
//   a column pair of rows 2t, 2t+1, the backward a row's column pair as
//   one 64-bit load; rows whose index has bit 2 set are stored with their
//   columns XOR 8, which makes both reads free of bank conflicts), and a
//   tile is any multiple of 16 points, so whole rays of 48 or 96 samples
//   fill it. That is a budget argument, not a speed one: on the products
//   alone wgmma is faster. tools/ingp_kernel_probe.py ([forms]) times a
//   64 x 64 layer in 3xTF32 over 393,216 points on an H100 at 0.060 ms in
//   this form, 0.026 ms on wgmma m64n64k8 with a layer in the accumulator
//   and 0.030 ms with each k-step added in fp32 (PERF.md). A wgmma form
//   needs the hi/lo images of W and W^T (90 KB each at lego_ingp) beside
//   the tile's activations and the dW partial, more than a block's shared
//   memory, so its images would stream from L2 as csrc/fused_eval.cu's do.
// * Two warps a row tile: the products run latency-bound, each warp's
//   mmas nearly one after another (tools/ingp_kernel_probe.py, PERF.md);
//   splitting a layer's columns between two warps halves what a warp holds
//   and doubles the warps that run each step.
//
// Shared memory (floats): weights K0*(W+8) + (D-1)*W*(W+8) + W*(W+8) +
// W*(W/2+8) + heads and biases; per point of a tile (E16+8) + (D+1)*(W+8) +
// (W/2+8) + 10 (stored layer outputs, the compositing terms, the point);
// per ray W/2 + 1 + DD; the view weight's SH rows DD*W/2; the dW partial
// (every weight and bias). lego_ingp's coarse level (DD = 25, degree-4
// SH): 13,288 + 800 + 96 x 290 + 120 + 12,456 floats = 218,016 bytes (2
// rays a tile); its fine level 217,792 (1 ray); lego_ingp_occ 218,240 (3
// rays of 32).
//
// bf16 hash compute (hash_compute_dtype = "bfloat16") rounds where the
// Pallas kernel rounds, as csrc/fused_ingp.cu does; the MLP stays fp32
// (3xTF32). The TPU kernel's one-hot-GEMM lookups, selector GEMMs and
// 768-point sub-blocks are not carried over.
//
// The feat kernel (feat_tc_kernel) replaces
// nerf_meets_mlx_tpu/kernels/fused_feat_train.py::_feat_train_kernel
// (pallas_call at :454) for the shapes it takes; every other shape runs
// csrc/fused_feat.cu (kernels/fused_feat_train.py routes by shape). It
// takes the JAX op's packed input x [R*S, C] = [feats (P) | sh (DD) |
// delta | noise] and the target colours, and writes rgb, weights, sse,
// every dW and dfeats [R*S, P] = d(sse)/d(feats). Its front end reads the
// tile's rows of x, one contiguous chunk, into layer 0's input area (the
// P feature columns), the deltas and noise per point, and each ray's SH
// from its first row (a ray's rows repeat its SH), and prefetches the next
// tile's rows into L2 for the next pass: the load took 13% of a tile from
// device memory with two integer divisions an element, 7% from L2 without
// them (tools/ingp_kernel_probe.py --feat, PERF.md); its back end stores
// layer 0's cotangent product dZ_0 W_0 (the INGP kernel's d(features)) as
// dfeats with coalesced stores. It keeps no points: without them the
// paper tables' shape (W 64, depth 2, P = 32, DD = 25) fits 2 rays of 48 a
// tile (231,712 bytes) and 1 of 96 (231,488); the INGP layout would need
// 232,864 / 232,640. Shapes: widths 32 and 64, depth 1..8, P <= 64, DD <=
// 64, tiles of whole rays of at most 96 points that fit. No atomics:
// sse, dW and dfeats are bit-identical from run to run. What bounds it at
// the paper tables' fine level (393,216 points): the 3xTF32 work, 3 x 2 x
// 38,944 MACs a point (forward, dW and the cotangents, dfeats included),
// 0.19 ms at 495 TFLOP/s; the bytes (x's 59 floats and dfeats' 32 a
// point), 0.04 ms. The alpha head's dW is summed in plain fp32 like every
// other partial: in canonical mode its terms cancel, and csrc/fused_feat.cu
// compensated them (Kahan), but this kernel's short sums (a tile, then a
// block's tiles, then the blocks) land no further from float64 than the
// fp32 plain version does (tests/test_torch_feat_train.py emulates them;
// chip_smoke.py holds them on the card).
//
// Variants for tools/ingp_kernel_probe.py: INGP_TC_NO_ATOMICS (dG not
// written), INGP_TC_NO_MMA (products skipped), INGP_TC_NO_HASH (features
// zero, no lookups) time parts of the launch and compute wrong results;
// INGP_TC_CLOCKS writes block 0's cycles per phase over rgb. NO_MMA and
// CLOCKS apply to the feat kernel too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int NWARP = 12;
constexpr int NTHREADS = 32 * NWARP;
constexpr int MAX_TP = 16 * (NWARP / 2);  // points a tile: a 16-row MMA tile for each warp pair
constexpr int MAX_RPT = 16;         // rays a tile
constexpr int MAX_LEVELS = 16;
constexpr int MAX_FEATS = 64;       // L*F
constexpr int MAX_DEPTH = 8;
constexpr int MAX_DD = 64;
constexpr int MAX_LIN = MAX_DEPTH + 4;
constexpr int MAX_SMEM = 232448;    // bytes a block may use on sm_90
constexpr unsigned FULL = 0xFFFFFFFFu;

// INGP_TC_CLOCKS: thread 0 of each block adds the cycles since the last
// barrier to phase k (setup, features, forward, composite, heads' dW, d(hd),
// view dW, d(feature), feature dW, the last trunk layer's dZ, then per trunk
// layer its dW and the layer below's dZ (or d(features)), scatter)
constexpr int N_PHASES = 13;
#ifdef INGP_TC_CLOCKS
#define PHASE_CLOCK(k)                    \
  if (threadIdx.x == 0) {                 \
    const long long now_ = clock64();     \
    clk[k] += now_ - clk_last;            \
    clk_last = now_;                      \
  }
#else
#define PHASE_CLOCK(k)
#endif

__host__ __device__ constexpr int ru(int x, int m) { return (x + m - 1) / m * m; }

struct Args {
  const float* rays_o;    // [R, 3]
  const float* rays_d;    // [R, 3]
  const float* sh;        // [R, DD]
  const float* z;         // [R, S]
  const float* deltas;    // [R, S]
  const float* noise;     // [R, S]
  const float* target;    // [R, 3]
  const float* tables;    // [L, T, F]
  const float* w[MAX_LIN];  // nn.Linear weights [out][in]: trunk 0..D-1, alpha, feature, view, rgb
  const float* b[MAX_LIN];
  float* rgb;             // [R, 3]
  float* weights;         // [R, S]
  float* dG;              // [L, T, F]
  float* part;            // [grid][n_dw] the blocks' dW partials, each weight [in][out]
  float* sse_part;        // [grid]
  const float* x;         // feat: [R*S, C] = [feats (E) | sh (DD) | delta | noise]
  float* dfeats;          // feat: [R*S, E]
  int C;                  // feat: x's row length, E + DD + 2
  long long T;
  unsigned mask;          // T - 1
  int R, S, L, F, E, D, DD;
  int bf16, mode, relu_density, white_bkgd;
  int rpt, tp, n_tiles, n_dw;
  int woff[MAX_LIN], boff[MAX_LIN];  // float offsets of each linear's weight and bias
  float bmin, brange;
  int res[MAX_LEVELS];
};

// Float offsets of the pieces of a block's shared memory.
struct Smem {
  int w0, w1;        // trunk weights [K][W+8] (K = K0 for layer 0, else W), swizzled: layer 0,
                     // then layers 1 .. D-1 back to back (wofs)
  int wf, wv;        // feature [W][W+8], view's feature rows [W][W/2+8], swizzled
  int wa, wr;        // alpha head [W], rgb head [3][W/2]
  int bt, bf, ba, br;  // trunk biases [D][W], feature [W], alpha [1], rgb [3]
  int wsh;           // [DD][W/2] the view weight's SH rows, [in][out]
  int enc;           // [TP][E16+8] hash features, zero past E; later d(features)
  int h0;            // [D][TP][W+8] trunk outputs; later their pre-activation cotangents
  int feat;          // [TP][W+8] feature layer output; later its cotangent
  int hd;            // [TP][W/2+8] view layer output; later its pre-activation cotangent
  int pc;            // [TP][3] raw rgb -> colour -> d(raw rgb)
  int pq, pa, pda, pdq;  // [TP] raw sigma -> q -> d(raw sigma); alpha -> weight;
                         // noise -> d(alpha)/dq -> T d(alpha)/dq; delta -> dq/d(raw sigma)
  int pts;           // [TP][3] the points
  int vsh;           // [RPT][W/2] the view layer's SH term; later its cotangent's sums
  int rsse;          // [RPT]
  int shs;           // [RPT][DD] the tile's rays' SH
  int dw;            // [n_dw] the block's dW partial, each weight [in][out]
  int total;
};

__host__ __device__ inline int take(int& o, int n) {
  const int at = o;
  o += ru(n, 4);
  return at;
}

// floats of one linear's weight and bias in the dW layout, each on 16 bytes
__host__ __device__ inline int dw_piece(int fan_in, int fan_out) {
  return ru(fan_in * fan_out, 4) + ru(fan_out, 4);
}

// floats of the dW buffer: every linear in linears() order
__host__ __device__ inline int dw_floats(int W, int D, int E, int DD) {
  return dw_piece(E, W) + (D - 1) * dw_piece(W, W) + dw_piece(W, 1) + dw_piece(W, W) +
         dw_piece(W + DD, W / 2) + dw_piece(W / 2, 3);
}

// every piece is a multiple of 4 floats (16 bytes); the feat kernel keeps
// no points (points = false)
__host__ __device__ inline Smem smem_layout(int W, int D, int E, int DD, int tp, int rpt,
                                            bool points = true) {
  Smem M{};
  int o = 0;
  const int SWW = W + 8, WH = W / 2, SWH = WH + 8;
  const int K0 = ru(E, 8), SE = ru(E, 16) + 8;
  M.w0 = take(o, K0 * SWW);
  M.w1 = take(o, (D - 1) * W * SWW);
  M.wf = take(o, W * SWW);
  M.wv = take(o, W * SWH);
  M.wa = take(o, W);
  M.wr = take(o, 3 * WH);
  M.bt = take(o, D * W);
  M.bf = take(o, W);
  M.ba = take(o, 1);
  M.br = take(o, 3);
  M.wsh = take(o, DD * WH);
  M.enc = take(o, tp * SE);
  M.h0 = take(o, D * tp * SWW);
  M.feat = take(o, tp * SWW);
  M.hd = take(o, tp * SWH);
  M.pc = take(o, tp * 3);
  M.pq = take(o, tp);
  M.pa = take(o, tp);
  M.pda = take(o, tp);
  M.pdq = take(o, tp);
  M.pts = take(o, points ? tp * 3 : 0);
  M.vsh = take(o, rpt * WH);
  M.rsse = take(o, rpt);
  M.shs = take(o, rpt * DD);
  M.dw = take(o, dw_floats(W, D, E, DD));
  M.total = o;
  return M;
}

// trunk layer l's weight and stored output
__device__ __forceinline__ int wofs(const Smem& M, int l, int W) {
  return l == 0 ? M.w0 : M.w1 + (l - 1) * W * (W + 8);
}

__device__ __forceinline__ int hofs(const Smem& M, int l, int W, int tp) {
  return M.h0 + l * tp * (W + 8);
}

// the column where (row, col) of a swizzled weight is stored: rows whose
// index has bit 2 set have their columns XOR 8 (the widths are multiples of
// 16), so that both fragment reads below are free of bank conflicts
__device__ __forceinline__ int swz(int row, int col) { return col ^ ((row & 4) << 1); }

__device__ __forceinline__ float rb(float v, int on) {
  return on ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// acc[n] += a * b[n] in 3xTF32 for the first nn of the NN n-tiles of one
// k-step: each of the three products passes over all n-tiles before the
// next starts, so that consecutive mmas write different accumulators; each
// accumulator still adds lo*hi, hi*lo, then hi*hi, as mma_3xtf32 does
template <int NN>
__device__ __forceinline__ void mma_kstep(float (&acc)[NN][4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[NN][2],
                                          const uint32_t (&bl)[NN][2], int nn = NN) {
#ifdef INGP_TC_NO_MMA
#pragma unroll
  for (int n = 0; n < NN; ++n)
    if (n < nn)
      asm volatile("" : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]), "+f"(acc[n][3])
                   : "r"(ah[0]), "r"(ah[1]), "r"(ah[2]), "r"(ah[3]), "r"(al[0]), "r"(al[1]),
                     "r"(al[2]), "r"(al[3]), "r"(bh[n][0]), "r"(bh[n][1]), "r"(bl[n][0]),
                     "r"(bl[n][1]));
#else
#pragma unroll
  for (int n = 0; n < NN; ++n)
    if (n < nn) mma_tf32(acc[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < NN; ++n)
    if (n < nn) mma_tf32(acc[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < NN; ++n)
    if (n < nn) mma_tf32(acc[n], ah, bh[n]);
#endif
}

// The A fragment of a k-step whose K order is permuted to the accumulator
// fragments' column order: lane (g, t) holds (g, 2t), (g + 8, 2t),
// (g, 2t + 1), (g + 8, 2t + 1) of the 16 x 8 block, i.e. an accumulator
// fragment c of mma's m16n8 tile as {c0, c2, c1, c3}.
__device__ __forceinline__ void split_a(float a0, float a1, float a2, float a3, uint32_t (&ah)[4],
                                        uint32_t (&al)[4]) {
  split_tf32(a0, ah[0], al[0]);
  split_tf32(a1, ah[1], al[1]);
  split_tf32(a2, ah[2], al[2]);
  split_tf32(a3, ah[3], al[3]);
}

// Forward B fragment in the permuted K order: rows k0 + 2t and k0 + 2t + 1,
// column n0 + g of a swizzled [K][ld] weight.
__device__ __forceinline__ void load_b_fwd(const float* Ws, int ld, int k0, int n0, int g, int t,
                                           uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const int r0 = k0 + 2 * t, r1 = r0 + 1, c = n0 + g;
  split_tf32(Ws[r0 * ld + swz(r0, c)], bh[0], bl[0]);
  split_tf32(Ws[r1 * ld + swz(r1, c)], bh[1], bl[1]);
}

// Backward B fragment (B = W^T, K = the weight's columns j0.., N = its rows
// i0..) in the permuted K order: W[i0 + g][j0 + 2t] and W[i0 + g][j0 + 2t + 1],
// one 64-bit load.
__device__ __forceinline__ void load_b_bwd(const float* Ws, int ld, int j0, int i0, int g, int t,
                                           uint32_t (&bh)[2], uint32_t (&bl)[2]) {
  const int r = i0 + g;
  const float2 v = *reinterpret_cast<const float2*>(Ws + r * ld + swz(r, j0 + 2 * t));
  split_tf32(v.x, bh[0], bl[0]);
  split_tf32(v.y, bh[1], bl[1]);
}

// One k-step of the chain's products (forward and cotangents), which set
// the relu decisions: acc[n] += (the k-step's A) x B[n] for the first nn of
// the NN n-tiles, B read from the swizzled weight Ws, in the forward (FWD)
// rows k0 + 2t and k0 + 2t + 1 at column c0 + 8n + g (W), else row
// c0 + 8n + g at columns k0 + 2t and k0 + 2t + 1 (W^T). Four n-tiles at a time: their
// fragments loaded, their products summed from zero on the tensor cores,
// then added to acc in fp32 rounded to nearest, so that acc lands as close
// to the exact sum as an fp32 sum does; a whole layer in the truncating
// accumulator errs ~6x more and flips relu decisions that the plain
// version does not (PERF.md).
template <int NN, bool FWD>
__device__ __forceinline__ void chain_kstep(float (&acc)[NN][4], const uint32_t (&ah)[4],
                                            const uint32_t (&al)[4], const float* Ws, int ld,
                                            int k0, int g, int t, int c0, int nn) {
  constexpr int G = NN < 4 ? NN : 4;
#pragma unroll
  for (int n0 = 0; n0 < NN; n0 += G) {
    uint32_t bh[G][2], bl[G][2];
    float sum[G][4];
#pragma unroll
    for (int n = 0; n < G; ++n) {
      if (n0 + n < nn) {
        if constexpr (FWD)
          load_b_fwd(Ws, ld, k0, c0 + 8 * (n0 + n), g, t, bh[n], bl[n]);
        else
          load_b_bwd(Ws, ld, k0, c0 + 8 * (n0 + n), g, t, bh[n], bl[n]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[n][i] = 0.f;
    }
    mma_kstep<G>(sum, ah, al, bh, bl, nn - n0);
#pragma unroll
    for (int n = 0; n < G; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n0 + n][i] += sum[n][i];
  }
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void sts2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// acc[n] = in[rows p0 .. p0 + 15][0 .. K) x B[:, c0 + 8n ..] for the first
// nn of the NN n-tiles: A from the point-major input in shared memory, a
// row's column pair k0 + 2t, k0 + 2t + 1 of each k-step as one 64-bit load
// (the K order permuted as chain_kstep reads B's rows), B the swizzled
// weight Ws, W in the forward (FWD), else W^T
template <int NN, bool FWD>
__device__ __forceinline__ void rows_product(float (&acc)[NN][4], const float* in, int ld_in,
                                             int K, const float* Ws, int ld_w, int c0, int p0,
                                             int g, int t, int nn = NN) {
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  const float* r0 = in + (p0 + g) * ld_in + 2 * t;
  const float* r1 = r0 + 8 * ld_in;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float2 u = lds2(r0 + k0), v = lds2(r1 + k0);
    uint32_t ah[4], al[4];
    split_a(u.x, v.x, u.y, v.y, ah, al);
    chain_kstep<NN, FWD>(acc, ah, al, Ws, ld_w, k0, g, t, c0, nn);
  }
}

// out[rows p0 .. p0 + 15][c0 + 8n + 2t, + 1] = acc + bias there, through a
// relu when asked; acc keeps what was stored
template <int NN>
__device__ __forceinline__ void rows_store(float (&acc)[NN][4], float* out, int ld,
                                           const float* bias, int c0, int p0, int g, int t,
                                           bool relu) {
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const int col = c0 + 8 * n + 2 * t;
    const float b0 = bias[col], b1 = bias[col + 1];
    acc[n][0] += b0; acc[n][1] += b1; acc[n][2] += b0; acc[n][3] += b1;
    if (relu) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = fmaxf(acc[n][i], 0.f);
    }
    sts2(out + (p0 + g) * ld + col, acc[n][0], acc[n][1]);
    sts2(out + (p0 + g + 8) * ld + col, acc[n][2], acc[n][3]);
  }
}

// the row tile's values of acc, this warp's columns, into out
template <int NN>
__device__ __forceinline__ void rows_put(const float (&acc)[NN][4], float* out, int ld, int c0,
                                         int p0, int g, int t, int nn = NN) {
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    if (n >= nn) continue;
    const int col = c0 + 8 * n + 2 * t;
    sts2(out + (p0 + g) * ld + col, acc[n][0], acc[n][1]);
    sts2(out + (p0 + g + 8) * ld + col, acc[n][2], acc[n][3]);
  }
}

// per-point compositing terms (as csrc/fused_ingp.cu): q, alpha, d(alpha)/dq
// and dq/d(raw sigma)
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

// inclusive sums of v over the lanes up to this one / from this one up
__device__ __forceinline__ float warp_scan_up(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

__device__ __forceinline__ float warp_scan_down(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_down_sync(FULL, v, o);
    if (lane + o < 32) v += y;
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// hash cell of point x at level l, as csrc/fused_ingp.cu's corners_of: the
// base cell and the fractions
struct Cell {
  unsigned b[3];
  float f[3];
};

__device__ __forceinline__ Cell cell_of(const Args& A, const float* x, int l) {
  const float r = (float)A.res[l];
  Cell C;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float u = __fdiv_rn(__fsub_rn(x[a], A.bmin), A.brange);
    u = fminf(fmaxf(u, 0.f), 1.f);
    const float s = __fmul_rn(u, r);
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

// the hash features of every (point, level) of the tile into enc, zero
// for the padding points and past E
template <int F>
__device__ __forceinline__ void tile_features(const Args& A, const Smem& M, float* sm, int nvalid) {
  const int SE = ru(A.E, 16) + 8;
  float* enc = sm + M.enc;
  const float* pts = sm + M.pts;
  const int n = A.tp * A.L;
  for (int idx = threadIdx.x; idx < n; idx += NTHREADS) {
    const int l = idx / A.tp, p = idx - l * A.tp;
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
#ifndef INGP_TC_NO_HASH
    if (p < nvalid) {
      const Cell C = cell_of(A, pts + 3 * p, l);
      const float* tl = A.tables + (size_t)l * A.T * F;
      unsigned rows[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) rows[c] = corner_row(A, C, c);
      float g[8][F];
#pragma unroll
      for (int c = 0; c < 8; ++c) load_row<F>(tl + (size_t)rows[c] * F, g[c]);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float w = corner_weight(C, c);
        if (A.bf16) {
          const float wb = rb(w, 1);
#pragma unroll
          for (int f = 0; f < F; ++f)
            acc[f] = __fadd_rn(acc[f], rb(__fmul_rn(rb(g[c][f], 1), wb), 1));
        } else {
#pragma unroll
          for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(g[c][f], w));
        }
      }
    }
#endif
#pragma unroll
    for (int f = 0; f < F; ++f) enc[p * SE + l * F + f] = acc[f];
  }
  const int pad = ru(A.E, 16) - A.E;
  for (int idx = threadIdx.x; idx < A.tp * pad; idx += NTHREADS) {
    const int p = idx / pad;
    enc[p * SE + A.E + (idx - p * pad)] = 0.f;
  }
}

// dG[l][row][f] += w_c * d(features) over the 8 corners of each (point,
// level), a lane per point, one vector atomic a corner. Runs of lanes in
// the same cell of the same level (the neighbouring samples of a ray, on
// the coarse levels) first sum by a segmented warp scan, and their last
// lane adds.
template <int F>
__device__ __forceinline__ void tile_scatter(const Args& A, const Smem& M, const float* sm,
                                             int nvalid) {
  const int SE = ru(A.E, 16) + 8;
  const float* enc = sm + M.enc;
  const float* pts = sm + M.pts;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = A.tp * A.L;
  for (int base = 32 * warp; base < n; base += NTHREADS) {
    const int idx = base + lane;
    const int l = idx / A.tp, p = idx - l * A.tp;
    const bool valid = idx < n && p < nvalid;
    float d[F];
    bool any = false;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      d[f] = valid ? rb(enc[p * SE + l * F + f], A.bf16) : 0.f;
      any |= d[f] != 0.f;
    }
    Cell C{};
    if (valid) C = cell_of(A, pts + 3 * p, l);
    // the run of lanes in this lane's cell
    const unsigned key0 = valid ? C.b[0] : 0xFFFFFFFFu;
    const unsigned up0 = __shfl_up_sync(FULL, key0, 1);
    const unsigned up1 = __shfl_up_sync(FULL, C.b[1], 1);
    const unsigned up2 = __shfl_up_sync(FULL, C.b[2], 1);
    const int upl = __shfl_up_sync(FULL, l, 1);
    const bool head = lane == 0 || !valid || up0 != key0 || up1 != C.b[1] || up2 != C.b[2] ||
                      upl != l;
    const unsigned heads = __ballot_sync(FULL, head);
    const unsigned le = lane == 31 ? FULL : (2u << lane) - 1u;
    const int start = 31 - __clz(heads & le);
    const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
    if (!__any_sync(FULL, any)) continue;  // the whole warp: no cotangent at this level
    float* gl = A.dG + (size_t)l * A.T * F;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float w = valid ? rb(corner_weight(C, c), A.bf16) : 0.f;
      float v[F];
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] = __fmul_rn(w, d[f]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float y = __shfl_up_sync(FULL, v[f], off);
          if (lane - off >= start) v[f] += y;
        }
      }
      bool nz = false;
#pragma unroll
      for (int f = 0; f < F; ++f) nz |= v[f] != 0.f;
      if (valid && last && nz) {
#ifndef INGP_TC_NO_ATOMICS
        float* dst = gl + (size_t)corner_row(A, C, c) * F;
        if constexpr (F == 4) {
          atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
        } else if constexpr (F == 2) {
          atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
        } else {
          atomicAdd(dst, v[0]);
        }
#endif
      }
    }
  }
}

// The feat kernel's front end: the tile's rows of x [R*S][C] = [feats (E)
// | sh (DD) | delta | noise], one contiguous chunk read in order, 8 loads
// in flight a thread, a thread's (point, column) advanced by NTHREADS
// without a division: the features into enc, each point's delta and
// noise; then each ray's SH from its first row (a ray's rows repeat its
// SH; those lines are in L1 by then), and zero features for the padding
// points and past E.
__device__ __forceinline__ void tile_rows(const Args& A, const Smem& M, float* sm, long long g0,
                                          int nr, int nvalid) {
  constexpr int U = 8;
  const int C = A.C, E = A.E, S = A.S, SE = ru(E, 16) + 8, n = nvalid * C;
  const int dp = NTHREADS / C, dc = NTHREADS - dp * C;
  const float* xt = A.x + g0 * C;
  float* enc = sm + M.enc;
  int p = threadIdx.x / C, c = threadIdx.x - p * C;
  for (int base = threadIdx.x; base < n; base += U * NTHREADS) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * NTHREADS;
      v[u] = idx < n ? __ldg(xt + idx) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * NTHREADS >= n) break;
      if (c < E)
        enc[p * SE + c] = v[u];
      else if (c == C - 2)
        sm[M.pdq + p] = v[u];
      else if (c == C - 1)
        sm[M.pda + p] = v[u];
      p += dp;
      c += dc;
      if (c >= C) {
        c -= C;
        ++p;
      }
    }
  }
  for (int idx = threadIdx.x; idx < nr * A.DD; idx += NTHREADS) {
    const int r = idx / A.DD;
    sm[M.shs + idx] = __ldg(xt + (long long)r * S * C + E + idx - r * A.DD);
  }
  const int E16 = ru(E, 16), pad = E16 - E;
  for (int idx = threadIdx.x; idx < A.tp * pad; idx += NTHREADS) {
    const int q = idx / pad;
    enc[q * SE + E + idx - q * pad] = 0.f;
  }
  for (int idx = threadIdx.x; idx < (A.tp - nvalid) * E; idx += NTHREADS) {
    const int q = idx / E;
    enc[(nvalid + q) * SE + idx - q * E] = 0.f;
  }
}

// The next tile's rows of x into L2 (a line a thread), while this tile
// runs: its front end then reads them from L2 rather than device memory.
__device__ __forceinline__ void prefetch_rows(const Args& A, int tile) {
  const int r0 = tile * A.rpt, nr = min(A.rpt, A.R - r0);
  const char* src = reinterpret_cast<const char*>(A.x + (long long)r0 * A.S * A.C);
  const long long bytes = 4ll * nr * A.S * A.C;
  for (long long o = 128ll * threadIdx.x; o < bytes + 127; o += 128ll * NTHREADS) {
    const char* line = src + (o < bytes ? o : bytes - 1);
    asm volatile("prefetch.L2 [%0];" ::"l"(line));
  }
}

// The feat kernel's back end: d(features), which the layer-0 cotangent
// product left in enc, to dfeats [R*S][E], in order (coalesced stores).
__device__ __forceinline__ void tile_dfeats(const Args& A, const Smem& M, const float* sm,
                                            long long g0, int nvalid) {
  const int E = A.E, SE = ru(E, 16) + 8, n = nvalid * E;
  const float* enc = sm + M.enc;
  float* dst = A.dfeats + g0 * E;
  for (int idx = threadIdx.x; idx < n; idx += NTHREADS) {
    const int p = idx / E;
    dst[idx] = enc[p * SE + idx - p * E];
  }
}

// The tile's dW = X^T dZ of one layer (X: [TP][ldx] with K_in columns, dZ:
// [TP][ldz] with N columns) on the tensor cores, K = the tile's points in
// the accumulator, added to the block's partial at woff ([K_in][N]) in
// fp32. A warp takes 16 rows x 16 columns of dW at a time.
__device__ __forceinline__ void tile_dw(const float* X, int ldx, int K_in, const float* dZ,
                                        int ldz, int N, int tp, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int MT = (K_in + 15) / 16, NTn = N / 8, chunks = (NTn + 1) / 2;
  for (int job = warp; job < MT * chunks; job += NWARP) {
    const int mt = job % MT, ch = job / MT;
    const int i0 = 16 * mt, n0 = 16 * ch, nn = min(2, NTn - 2 * ch);
    float acc[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
    for (int k0 = 0; k0 < tp; k0 += 8) {
      const float* xa = X + (k0 + t) * ldx + i0 + g;
      const float* xb = X + (k0 + t + 4) * ldx + i0 + g;
      uint32_t ah[4], al[4];
      split_a(xa[0], xa[8], xb[0], xb[8], ah, al);
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q < nn) {
          const int c = n0 + 8 * q + g;
          split_tf32(dZ[(k0 + t) * ldz + c], bh[q][0], bl[q][0]);
          split_tf32(dZ[(k0 + t + 4) * ldz + c], bh[q][1], bl[q][1]);
        }
      }
      mma_kstep<2>(acc, ah, al, bh, bl, nn);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= nn) continue;
      const int col = n0 + 8 * q + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + g + 8 * hh;
        if (i < K_in) {
          float2* dst = reinterpret_cast<float2*>(part + i * N + col);
          float2 v = *dst;
          v.x += acc[q][2 * hh];
          v.y += acc[q][2 * hh + 1];
          *dst = v;
        }
      }
    }
  }
}

// db = the column sums of dZ over the tile's points, in point order, added
// to the partial: one thread a column, the last N threads of the block
__device__ __forceinline__ void tile_db(const float* dZ, int ldz, int N, int tp, float* part) {
  const int j = threadIdx.x - (NTHREADS - N);
  if (j < 0) return;
  float s = 0.f;
  for (int p = 0; p < tp; ++p) s += dZ[p * ldz + j];
  part[j] += s;
}

// One block's walk over its tiles: the INGP kernel (FEAT false: points,
// hash features, dG) or the feat kernel (FEAT true: x's rows, dfeats); the
// MLP, the compositing and dW between them are the same code.
template <int W, bool FEAT>
__device__ __forceinline__ void tc_tiles(const Args& A) {
  extern __shared__ __align__(16) float sm[];
  constexpr int NT = W / 8, WH = W / 2, NTH = WH / 8, SWW = W + 8, SWH = WH + 8;
  const Smem M = smem_layout(W, A.D, A.E, A.DD, A.tp, A.rpt, !FEAT);
  constexpr int NH = NT / 2, NHV = NTH / 2;  // n-tiles of a warp's half of a W / W/2 layer
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int D = A.D, S = A.S, E = A.E, K0 = ru(E, 8), SE = ru(E, 16) + 8;
  // warp pair mt takes the row tile of points p0 .. p0 + 15; half, its columns
  const int mt = warp >> 1, half = warp & 1, p0 = 16 * mt, cw = half * (W / 2);
  const bool rows = p0 < A.tp;
  const int ia = D, ifeat = D + 1, iview = D + 2, irgb = D + 3;  // linears() indices
  float* part = sm + M.dw;  // the block's dW partial, summed in fp32 over its tiles

  // ---------------- the weights, once: [in][out], swizzled ----------------
  for (int l = 0; l < D; ++l) {
    const int kin = l == 0 ? E : W, kp = l == 0 ? K0 : W;
    float* dst = sm + wofs(M, l, W);
    for (int idx = tid; idx < W * kp; idx += NTHREADS) {
      const int n = idx / kp, k = idx - n * kp;
      dst[k * SWW + swz(k, n)] = k < kin ? __ldg(A.w[l] + (size_t)n * kin + k) : 0.f;
    }
    for (int j = tid; j < W; j += NTHREADS) sm[M.bt + l * W + j] = __ldg(A.b[l] + j);
  }
  for (int idx = tid; idx < W * W; idx += NTHREADS) {
    const int n = idx / W, k = idx - n * W;
    sm[M.wf + k * SWW + swz(k, n)] = __ldg(A.w[ifeat] + idx);
  }
  for (int idx = tid; idx < WH * W; idx += NTHREADS) {
    const int n = idx / W, k = idx - n * W;
    sm[M.wv + k * SWH + swz(k, n)] = __ldg(A.w[iview] + (size_t)n * (W + A.DD) + k);
  }
  for (int j = tid; j < W; j += NTHREADS) {
    sm[M.wa + j] = __ldg(A.w[ia] + j);
    sm[M.bf + j] = __ldg(A.b[ifeat] + j);
  }
  for (int j = tid; j < 3 * WH; j += NTHREADS) sm[M.wr + j] = __ldg(A.w[irgb] + j);
  for (int idx = tid; idx < WH * A.DD; idx += NTHREADS) {
    const int j = idx / A.DD, k = idx - j * A.DD;
    sm[M.wsh + k * WH + j] = __ldg(A.w[iview] + (size_t)j * (W + A.DD) + W + k);
  }
  if (tid == 0) sm[M.ba] = __ldg(A.b[ia]);
  if (tid < 3) sm[M.br + tid] = __ldg(A.b[irgb] + tid);
  for (int i = tid; i < A.n_dw; i += NTHREADS) part[i] = 0.f;
  __syncthreads();

  float blk_sse = 0.f;  // thread 0's sum of the block's tiles, in tile order
#ifdef INGP_TC_CLOCKS
  long long clk[N_PHASES] = {}, clk_last = clock64();
#endif
  for (int tile = blockIdx.x; tile < A.n_tiles; tile += gridDim.x) {
    const int r0 = tile * A.rpt;
    const int nr = min(A.rpt, A.R - r0);
    const int nvalid = nr * S;
    const long long g0 = (long long)r0 * S;  // the tile's first sample

    if constexpr (FEAT) {
      // ---------------- x's rows: features, deltas, noise; the rays' SH ----------------
      tile_rows(A, M, sm, g0, nr, nvalid);
      if (tile + (int)gridDim.x < A.n_tiles) prefetch_rows(A, tile + gridDim.x);
      __syncthreads();
      PHASE_CLOCK(0);
    } else {
      // ---------------- the points, their noise and deltas; the rays' SH ----------------
      for (int p = tid; p < A.tp; p += NTHREADS) {
        float* x = sm + M.pts + 3 * p;
        if (p < nvalid) {
          const int ray = r0 + p / S;
          const float zz = __ldg(A.z + g0 + p);
#pragma unroll
          for (int a = 0; a < 3; ++a)
            x[a] = __fadd_rn(__ldg(A.rays_o + ray * 3 + a),
                             __fmul_rn(zz, __ldg(A.rays_d + ray * 3 + a)));
          sm[M.pda + p] = __ldg(A.noise + g0 + p);
          sm[M.pdq + p] = __ldg(A.deltas + g0 + p);
        } else {
          x[0] = x[1] = x[2] = 0.f;
        }
      }
      for (int idx = tid; idx < nr * A.DD; idx += NTHREADS)
        sm[M.shs + idx] = __ldg(A.sh + (size_t)r0 * A.DD + idx);
      __syncthreads();
      PHASE_CLOCK(0);

      // ---------------- hash features; the view layer's SH term per ray ----------------
      if (A.F == 4)
        tile_features<4>(A, M, sm, nvalid);
      else if (A.F == 2)
        tile_features<2>(A, M, sm, nvalid);
      else
        tile_features<1>(A, M, sm, nvalid);
    }
    for (int idx = tid; idx < nr * WH; idx += NTHREADS) {
      const int r = idx / WH, j = idx - r * WH;
      const float* shr = sm + M.shs + r * A.DD;
      float s = __ldg(A.b[iview] + j);
      for (int k = 0; k < A.DD; ++k) s = fmaf(shr[k], sm[M.wsh + k * WH + j], s);
      sm[M.vsh + idx] = s;
    }
    __syncthreads();
    PHASE_CLOCK(1);

    // ---------------- forward: a warp pair a 16-point row tile ----------------
    // each layer's output columns split between the pair, its input read
    // from shared memory, where every layer's output is stored
    for (int l = 0; l < D; ++l) {
      if (rows) {
        float acc[NH][4];
        if (l == 0)
          rows_product<NH, true>(acc, sm + M.enc, SE, K0, sm + M.w0, SWW, cw, p0, g, t);
        else
          rows_product<NH, true>(acc, sm + hofs(M, l - 1, W, A.tp), SWW, W, sm + wofs(M, l, W),
                                 SWW, cw, p0, g, t);
        rows_store<NH>(acc, sm + hofs(M, l, W, A.tp), SWW, sm + M.bt + l * W, cw, p0, g, t, true);
      }
      __syncthreads();
    }
    // the feature layer (no activation), then the view layer on [feature,
    // sh]: the feature rows on the tensor cores, the SH rows and the bias
    // from the ray's term
    if (rows) {
      float acc[NH][4];
      rows_product<NH, true>(acc, sm + hofs(M, D - 1, W, A.tp), SWW, W, sm + M.wf, SWW, cw, p0,
                             g, t);
      rows_store<NH>(acc, sm + M.feat, SWW, sm + M.bf, cw, p0, g, t, false);
    }
    __syncthreads();
    if (rows) {
      float acc[NHV][4];
      const int cv = half * (WH / 2);
      rows_product<NHV, true>(acc, sm + M.feat, SWW, W, sm + M.wv, SWH, cv, p0, g, t);
      const int q0 = p0 + g, q1 = p0 + g + 8;
      const float* vs0 = sm + M.vsh + (q0 < nvalid ? q0 / S : 0) * WH;
      const float* vs1 = sm + M.vsh + (q1 < nvalid ? q1 / S : 0) * WH;
      float* out = sm + M.hd;
#pragma unroll
      for (int n = 0; n < NHV; ++n) {
        const int col = cv + 8 * n + 2 * t;
        sts2(out + q0 * SWH + col, fmaxf(acc[n][0] + vs0[col], 0.f),
             fmaxf(acc[n][1] + vs0[col + 1], 0.f));
        sts2(out + q1 * SWH + col, fmaxf(acc[n][2] + vs1[col], 0.f),
             fmaxf(acc[n][3] + vs1[col + 1], 0.f));
      }
    }
    __syncthreads();
    // the alpha (W -> 1) and rgb (W/2 -> 3) heads on the CUDA cores, 4 lanes
    // a point (columns 4i + q), and the point's compositing terms; the tile
    // is a multiple of 16 points, so warps are whole
    for (int idx = tid; idx < 4 * A.tp; idx += NTHREADS) {
      const int p = idx >> 2, q = idx & 3;
      const float* hrow = sm + hofs(M, D - 1, W, A.tp) + p * SWW;
      const float* drow = sm + M.hd + p * SWH;
      float sg = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
#pragma unroll
      for (int k = q; k < W; k += 4) sg = fmaf(hrow[k], sm[M.wa + k], sg);
#pragma unroll
      for (int j = q; j < WH; j += 4) {
        const float h = drow[j];
        c0 = fmaf(h, sm[M.wr + j], c0);
        c1 = fmaf(h, sm[M.wr + WH + j], c1);
        c2 = fmaf(h, sm[M.wr + 2 * WH + j], c2);
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sg += __shfl_xor_sync(FULL, sg, o);
        c0 += __shfl_xor_sync(FULL, c0, o);
        c1 += __shfl_xor_sync(FULL, c1, o);
        c2 += __shfl_xor_sync(FULL, c2, o);
      }
      if (q == 0 && p < nvalid) {
        float qq, alpha, da, dqd;
        alpha_terms(A, sg + sm[M.ba] + sm[M.pda + p], sm[M.pdq + p], qq, alpha, da, dqd);
        sm[M.pq + p] = qq;
        sm[M.pa + p] = alpha;
        sm[M.pda + p] = da;
        sm[M.pdq + p] = dqd;
        const float raw[3] = {c0 + sm[M.br], c1 + sm[M.br + 1], c2 + sm[M.br + 2]};
#pragma unroll
        for (int c = 0; c < 3; ++c)
          sm[M.pc + 3 * p + c] = A.mode == 0 ? 1.f / (1.f + expf(-raw[c])) : raw[c];
      }
    }
    __syncthreads();
    PHASE_CLOCK(2);

    // ---------------- per ray, a warp: composite, loss, closed-form backward ----------------
    float* pc = sm + M.pc;
    float* pq = sm + M.pq;
    float* pa = sm + M.pa;
    float* pda = sm + M.pda;
    const float* pdq = sm + M.pdq;
    for (int rr = warp; rr < nr; rr += NWARP) {
      const int ray = r0 + rr;
      const int b = rr * S;
      float* wout = A.weights + (size_t)ray * S;
      // forward: lanes take samples s0 + lane; T = exp(-(exclusive sum of q))
      float carry = 0.f, acc = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
      for (int s0 = 0; s0 < S; s0 += 32) {
        const int s = s0 + lane, i = b + s;
        const bool in = s < S;
        const float incl = warp_scan_up(in ? pq[i] : 0.f, lane);
        float excl = __shfl_up_sync(FULL, incl, 1);
        excl = carry + (lane == 0 ? 0.f : excl);
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
      acc = warp_sum(acc);
      c0 = warp_sum(c0);
      c1 = warp_sum(c1);
      c2 = warp_sum(c2);
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
        sm[M.rsse + rr] = e0 * e0 + e1 * e1 + e2 * e2;
      }
      // backward, last chunk first: dq_t = dw_t T_t alpha'_t - sum_{s>t} dw_s w_s
      const float q0 = 2.f * e0, q1 = 2.f * e1, q2 = 2.f * e2;
      const float gs = A.white_bkgd ? q0 + q1 + q2 : 0.f;
      float later = 0.f;  // sum of dw_s w_s over the chunks after this one
      for (int s0 = (S - 1) / 32 * 32; s0 >= 0; s0 -= 32) {
        const int s = s0 + lane, i = b + s;
        const bool in = s < S;
        float x0 = 0.f, x1 = 0.f, x2 = 0.f, w = 0.f;
        if (in) {
          x0 = pc[3 * i + 0]; x1 = pc[3 * i + 1]; x2 = pc[3 * i + 2];
          w = pa[i];
        }
        const float dw = x0 * q0 + x1 * q1 + x2 * q2 - gs;
        const float incl = warp_scan_down(in ? dw * w : 0.f, lane);
        float suffix = __shfl_down_sync(FULL, incl, 1);
        suffix = later + (lane == 31 ? 0.f : suffix);
        later += __shfl_sync(FULL, incl, 0);
        if (in) {
          const float dq = dw * pda[i] - suffix;
          pq[i] = dq * pdq[i];
          float d0 = w * q0, d1 = w * q1, d2 = w * q2;
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
    for (int p = nvalid + tid; p < A.tp; p += NTHREADS) {  // padding points: no cotangent
      pq[p] = 0.f;
      pc[3 * p] = pc[3 * p + 1] = pc[3 * p + 2] = 0.f;
    }
    __syncthreads();
    PHASE_CLOCK(3);

    // ---------------- the narrow heads' dW on the CUDA cores; the sse ----------------
    {
      const float* hdb = sm + M.hd;
      const float* hl = sm + hofs(M, D - 1, W, A.tp);
      if (tid < 3 * WH) {  // rgb head, [in = W/2][out = 3]
        const int j = tid / 3, c = tid - 3 * j;
        float s = 0.f;
        for (int p = 0; p < A.tp; ++p) s = fmaf(hdb[p * SWH + j], pc[3 * p + c], s);
        part[A.woff[irgb] + tid] += s;
      } else if (tid < 3 * WH + W) {  // alpha head, [in = W][out = 1]
        const int k = tid - 3 * WH;
        float s = 0.f;
        for (int p = 0; p < A.tp; ++p) s = fmaf(hl[p * SWW + k], pq[p], s);
        part[A.woff[ia] + k] += s;
      } else if (tid < 3 * WH + W + 3) {
        const int c = tid - 3 * WH - W;
        float s = 0.f;
        for (int p = 0; p < A.tp; ++p) s += pc[3 * p + c];
        part[A.boff[irgb] + c] += s;
      } else if (tid == 3 * WH + W + 3) {
        float s = 0.f;
        for (int p = 0; p < A.tp; ++p) s += pq[p];
        part[A.boff[ia]] += s;
      } else if (tid == NTHREADS - 1) {
        float s = 0.f;
        for (int r = 0; r < nr; ++r) s += sm[M.rsse + r];
        blk_sse += s;
      }
    }
    __syncthreads();
    PHASE_CLOCK(4);

    // ---------------- backward ----------------
    // Each product writes its cotangent into the buffer whose contents are
    // dead by then, so that nothing lives in registers across a barrier.
    // d(hd) = (W_rgb^T d(raw rgb)) * (hd > 0), in place of hd
    for (int idx = tid; idx < A.tp * WH; idx += NTHREADS) {
      const int p = idx / WH, j = idx - p * WH;
      const float* wr = sm + M.wr;
      float* h = sm + M.hd + p * SWH + j;
      const float s =
          fmaf(pc[3 * p + 2], wr[2 * WH + j], fmaf(pc[3 * p + 1], wr[WH + j], pc[3 * p] * wr[j]));
      *h = *h > 0.f ? s : 0.f;
    }
    __syncthreads();
    PHASE_CLOCK(5);
    // the view layer's dW: the feature rows on the tensor cores; the SH rows
    // and the bias from each ray's summed cotangent
    tile_dw(sm + M.feat, SWW, W, sm + M.hd, SWH, WH, A.tp, part + A.woff[iview]);
    {
      const int j = tid - (NTHREADS - WH);
      if (j >= 0) {
        const float* dh = sm + M.hd;
        float* dsum = sm + M.vsh;
        float db = 0.f;
        for (int r = 0; r < nr; ++r) {
          float s = 0.f;
          for (int q = 0; q < S; ++q) s += dh[(r * S + q) * SWH + j];
          dsum[r * WH + j] = s;
          db += s;
        }
        part[A.boff[iview] + j] += db;
        for (int k = 0; k < A.DD; ++k) {
          float s = 0.f;
          for (int r = 0; r < nr; ++r) s = fmaf(sm[M.shs + r * A.DD + k], dsum[r * WH + j], s);
          part[A.woff[iview] + (W + k) * WH + j] += s;
        }
      }
    }
    __syncthreads();
    PHASE_CLOCK(6);
    // d(feature) = d(hd) W_view[:, :W], into feat
    if (rows) {
      float acc[NH][4];
      rows_product<NH, false>(acc, sm + M.hd, SWH, WH, sm + M.wv, SWH, cw, p0, g, t);
      rows_put<NH>(acc, sm + M.feat, SWW, cw, p0, g, t);
    }
    __syncthreads();
    PHASE_CLOCK(7);
    // the feature layer's dW, then dZ of the last trunk layer = (d(feature)
    // W_f^T + d(sigma) w_alpha) * (h > 0), into its stored output
    tile_dw(sm + hofs(M, D - 1, W, A.tp), SWW, W, sm + M.feat, SWW, W, A.tp, part + A.woff[ifeat]);
    tile_db(sm + M.feat, SWW, W, A.tp, part + A.boff[ifeat]);
    __syncthreads();
    PHASE_CLOCK(8);
    if (rows) {
      float acc[NH][4];
      rows_product<NH, false>(acc, sm + M.feat, SWW, W, sm + M.wf, SWW, cw, p0, g, t);
      float* hl = sm + hofs(M, D - 1, W, A.tp);
      const float* wa = sm + M.wa;
      const float ds0 = pq[p0 + g], ds1 = pq[p0 + g + 8];
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int col = cw + 8 * n + 2 * t;
        float* m0 = hl + (p0 + g) * SWW + col;
        float* m1 = hl + (p0 + g + 8) * SWW + col;
        const float2 h0 = lds2(m0), h1 = lds2(m1);
        sts2(m0, h0.x > 0.f ? fmaf(ds0, wa[col], acc[n][0]) : 0.f,
             h0.y > 0.f ? fmaf(ds0, wa[col + 1], acc[n][1]) : 0.f);
        sts2(m1, h1.x > 0.f ? fmaf(ds1, wa[col], acc[n][2]) : 0.f,
             h1.y > 0.f ? fmaf(ds1, wa[col + 1], acc[n][3]) : 0.f);
      }
    }
    __syncthreads();
    PHASE_CLOCK(9);

    // ---------------- the trunk, last layer first: dW, then the layer below's dZ ----------------
    for (int l = D - 1; l >= 0; --l) {
      if (l > 0)
        tile_dw(sm + hofs(M, l - 1, W, A.tp), SWW, W, sm + hofs(M, l, W, A.tp), SWW, W, A.tp,
                part + A.woff[l]);
      else
        tile_dw(sm + M.enc, SE, E, sm + M.h0, SWW, W, A.tp, part + A.woff[0]);
      tile_db(sm + hofs(M, l, W, A.tp), SWW, W, A.tp, part + A.boff[l]);
      __syncthreads();
      PHASE_CLOCK(10);
      if (rows) {
        if (l > 0) {
          // dZ_{l-1} = (dZ_l W_l^T) * (h_{l-1} > 0), into h_{l-1}
          float acc[NH][4];
          rows_product<NH, false>(acc, sm + hofs(M, l, W, A.tp), SWW, W, sm + wofs(M, l, W), SWW,
                                  cw, p0, g, t);
          float* hp = sm + hofs(M, l - 1, W, A.tp);
#pragma unroll
          for (int n = 0; n < NH; ++n) {
            const int col = cw + 8 * n + 2 * t;
            float* m0 = hp + (p0 + g) * SWW + col;
            float* m1 = hp + (p0 + g + 8) * SWW + col;
            const float2 h0 = lds2(m0), h1 = lds2(m1);
            sts2(m0, h0.x > 0.f ? acc[n][0] : 0.f, h0.y > 0.f ? acc[n][1] : 0.f);
            sts2(m1, h1.x > 0.f ? acc[n][2] : 0.f, h1.y > 0.f ? acc[n][3] : 0.f);
          }
        } else {
          // d(features) = dZ_0 W_0^T, K0 columns, into enc: the pair's first
          // half of its n-tiles to one warp, the rest to the other
          const int ne = K0 / 8, ne0 = (ne + 1) / 2;
          const int ce = half * 8 * ne0, nne = half ? ne - ne0 : ne0;
          float acc[4][4];
          rows_product<4, false>(acc, sm + M.h0, SWW, W, sm + M.w0, SWW, ce, p0, g, t, nne);
          rows_put<4>(acc, sm + M.enc, SE, ce, p0, g, t, nne);
        }
      }
      __syncthreads();
      PHASE_CLOCK(11);
    }

    // ---------------- the table gradient, or dfeats ----------------
    if constexpr (FEAT) {
      tile_dfeats(A, M, sm, g0, nvalid);
    } else {
      if (A.F == 4)
        tile_scatter<4>(A, M, sm, nvalid);
      else if (A.F == 2)
        tile_scatter<2>(A, M, sm, nvalid);
      else
        tile_scatter<1>(A, M, sm, nvalid);
    }
    __syncthreads();
    PHASE_CLOCK(12);
  }
  __syncthreads();
  float* out = A.part + (size_t)blockIdx.x * A.n_dw;
  for (int i = tid; i < A.n_dw; i += NTHREADS) out[i] = part[i];
  if (tid == NTHREADS - 1) A.sse_part[blockIdx.x] = blk_sse;
#ifdef INGP_TC_CLOCKS
  // block 0's cycles per phase, summed over its tiles, over the first
  // entries of rgb (a timing variant: the results are not read)
  if (blockIdx.x == 0 && tid == 0)
    for (int k = 0; k < N_PHASES; ++k) A.rgb[k] = (float)clk[k];
#endif
}

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1) ingp_tc_kernel(const __grid_constant__ Args A) {
  tc_tiles<W, false>(A);
}

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1) feat_tc_kernel(const __grid_constant__ Args A) {
  tc_tiles<W, true>(A);
}

struct ReduceArgs {
  const float* part;      // [n_blocks][n_dw]
  const float* sse_part;  // [n_blocks]
  float* dw;              // [n_dw]: each weight [out][in], each bias
  float* sse;
  int n_blocks, n_dw, n_lin;
  int woff[MAX_LIN], boff[MAX_LIN], fin[MAX_LIN], fout[MAX_LIN];
};

// dw = the sum of the blocks' partials in block order, each weight
// transposed to [out][in]; sse = the sum of the per-block sums in block
// order
__global__ void ingp_tc_reduce_kernel(const __grid_constant__ ReduceArgs R) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    float s = 0.f;
    for (int b = 0; b < R.n_blocks; ++b) s += R.sse_part[b];
    *R.sse = s;
  }
  if (i >= R.n_dw) return;
  int src = -1;
  for (int l = 0; l < R.n_lin; ++l) {
    const int n = R.fin[l] * R.fout[l];
    if (i >= R.woff[l] && i < R.woff[l] + n) {
      const int o = (i - R.woff[l]) / R.fin[l], k = (i - R.woff[l]) - o * R.fin[l];
      src = R.woff[l] + k * R.fout[l] + o;
    } else if (i >= R.boff[l] && i < R.boff[l] + R.fout[l]) {
      src = i;
    }
  }
  float s = 0.f;
  if (src >= 0)
    for (int b = 0; b < R.n_blocks; ++b) s += R.part[(size_t)b * R.n_dw + src];
  R.dw[i] = s;
}

bool tile_ok(int W, int D, int DD, int S, int rpt) {
  return (W == 32 || W == 64) && D >= 1 && D <= MAX_DEPTH && DD >= 0 && DD <= MAX_DD && S >= 1 &&
         rpt >= 1 && rpt <= MAX_RPT && ru(rpt * S, 16) <= MAX_TP;
}

bool shape_ok(int W, int D, int L, int F, int DD, int S, int rpt) {
  return tile_ok(W, D, DD, S, rpt) && L >= 1 && L <= MAX_LEVELS && (F == 1 || F == 2 || F == 4) &&
         L * F <= MAX_FEATS;
}

bool feat_shape_ok(int W, int D, int P, int DD, int S, int rpt) {
  return tile_ok(W, D, DD, S, rpt) && P >= 1 && P <= MAX_FEATS;
}

// a's linears: weight and bias pointers and offsets into the dW buffer
void set_linears(Args& a, int n_lin, const float* const* weights, const float* const* biases,
                 const int* dw_offs) {
  for (int l = 0; l < n_lin; ++l) {
    a.w[l] = weights[l];
    a.b[l] = biases[l];
    a.woff[l] = dw_offs[2 * l];
    a.boff[l] = dw_offs[2 * l + 1];
  }
}

// The tile kernel on a persistent grid of at most `blocks` blocks over a's
// tiles, then the reduce of the blocks' partials into dw and sse. a holds
// everything but the tiling, which this sets from a.R, a.S and a.rpt.
int launch_tiles(Args& a, void (*kernel)(Args), int W, bool points, int blocks, float* dw,
                 float* sse, void* stream) {
  a.tp = ru(a.rpt * a.S, 16);
  a.n_tiles = (a.R + a.rpt - 1) / a.rpt;
  a.sse_part = a.part + (size_t)blocks * a.n_dw;
  const size_t smem = 4 * (size_t)smem_layout(W, a.D, a.E, a.DD, a.tp, a.rpt, points).total;
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = blocks < a.n_tiles ? blocks : a.n_tiles;
  kernel<<<(unsigned)grid, NTHREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  ReduceArgs r{};
  r.part = a.part;
  r.sse_part = a.sse_part;
  r.dw = dw;
  r.sse = sse;
  r.n_blocks = grid;
  r.n_dw = a.n_dw;
  const int D = a.D, WH = W / 2, n_lin = D + 4;
  r.n_lin = n_lin;
  for (int l = 0; l < n_lin; ++l) {
    r.woff[l] = a.woff[l];
    r.boff[l] = a.boff[l];
  }
  for (int l = 0; l < D; ++l) {
    r.fin[l] = l == 0 ? a.E : W;
    r.fout[l] = W;
  }
  r.fin[D] = W;      r.fout[D] = 1;       // alpha
  r.fin[D + 1] = W;  r.fout[D + 1] = W;   // feature
  r.fin[D + 2] = W + a.DD; r.fout[D + 2] = WH;  // view
  r.fin[D + 3] = WH; r.fout[D + 3] = 3;   // rgb
  ingp_tc_reduce_kernel<<<(a.n_dw + 255) / 256, 256, 0, st>>>(r);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one block for this shape and tile of `rays` rays
// (0 if the kernel does not take the shape).
extern "C" long long ingp_tc_smem_bytes(int width, int depth, int levels, int features, int dd,
                                        int S, int rays) {
  if (!shape_ok(width, depth, levels, features, dd, S, rays)) return 0;
  return 4ll * smem_layout(width, depth, levels * features, dd, ru(rays * S, 16), rays).total;
}

// The train call of one level. tensors: rays_o, rays_d, sh, z, deltas,
// noise, target, tables; weights / biases: the nn.Linear parameters in
// linears() order (depth + 4); dw_offs: each linear's weight offset, then
// its bias offset, into dw and each block's partial; shape: R, S, width,
// depth, levels, features, dd, log2_T, bf16, mode, relu_density,
// white_bkgd, rays a tile, blocks, n_dw; res: the L resolutions. part:
// blocks * (n_dw + 1) floats of scratch. Returns the first cudaError_t.
extern "C" int ingp_tc_train_launch(const float* const* tensors, const float* const* weights,
                                    const float* const* biases, const int* dw_offs, float* rgb,
                                    float* wts, float* sse, float* dw, float* dG, float* part,
                                    const int* shape, const int* res, float bmin, float brange,
                                    void* stream) {
  const int R = shape[0], S = shape[1], W = shape[2], D = shape[3], L = shape[4], F = shape[5];
  const int DD = shape[6], log2_T = shape[7], rpt = shape[12], blocks = shape[13],
            n_dw = shape[14];
  if (!shape_ok(W, D, L, F, DD, S, rpt) || R < 0 || log2_T < 1 || log2_T > 31 || blocks < 1 ||
      n_dw != dw_floats(W, D, L * F, DD))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  Args a{};
  a.rays_o = tensors[0]; a.rays_d = tensors[1]; a.sh = tensors[2]; a.z = tensors[3];
  a.deltas = tensors[4]; a.noise = tensors[5]; a.target = tensors[6]; a.tables = tensors[7];
  set_linears(a, D + 4, weights, biases, dw_offs);
  a.rgb = rgb; a.weights = wts; a.dG = dG; a.part = part;
  a.T = 1ll << log2_T;
  a.mask = (unsigned)(a.T - 1);
  a.R = R; a.S = S; a.L = L; a.F = F; a.E = L * F; a.D = D; a.DD = DD;
  a.bf16 = shape[8]; a.mode = shape[9]; a.relu_density = shape[10]; a.white_bkgd = shape[11];
  a.rpt = rpt;
  a.n_dw = n_dw;
  a.bmin = bmin; a.brange = brange;
  for (int l = 0; l < L; ++l) a.res[l] = res[l];
  return launch_tiles(a, W == 64 ? ingp_tc_kernel<64> : ingp_tc_kernel<32>, W, true, blocks, dw,
                      sse, stream);
}

// Shared-memory bytes of one feat block for this shape (p feature
// channels) and tile of `rays` rays (0 if the kernel does not take it).
extern "C" long long feat_tc_smem_bytes(int width, int depth, int p, int dd, int S, int rays) {
  if (!feat_shape_ok(width, depth, p, dd, S, rays)) return 0;
  return 4ll * smem_layout(width, depth, p, dd, ru(rays * S, 16), rays, false).total;
}

// The feat train call of one level: x [R*S, p + dd + 2] (each ray's rows
// carry its SH), target [R, 3]; weights, biases, dw_offs as
// ingp_tc_train_launch's; dfeats [R*S, p]; shape: R, S, width, depth, p,
// dd, mode, relu_density, white_bkgd, rays a tile, blocks, n_dw. part:
// blocks * (n_dw + 1) floats of scratch. Returns the first cudaError_t.
extern "C" int feat_tc_train_launch(const float* x, const float* target,
                                    const float* const* weights, const float* const* biases,
                                    const int* dw_offs, float* rgb, float* wts, float* sse,
                                    float* dw, float* dfeats, float* part, const int* shape,
                                    void* stream) {
  const int R = shape[0], S = shape[1], W = shape[2], D = shape[3], P = shape[4], DD = shape[5];
  const int rpt = shape[9], blocks = shape[10], n_dw = shape[11];
  if (!feat_shape_ok(W, D, P, DD, S, rpt) || R < 0 || blocks < 1 ||
      n_dw != dw_floats(W, D, P, DD))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  Args a{};
  a.x = x; a.target = target; a.dfeats = dfeats; a.C = P + DD + 2;
  set_linears(a, D + 4, weights, biases, dw_offs);
  a.rgb = rgb; a.weights = wts; a.part = part;
  a.R = R; a.S = S; a.E = P; a.D = D; a.DD = DD;
  a.mode = shape[6]; a.relu_density = shape[7]; a.white_bkgd = shape[8];
  a.rpt = rpt;
  a.n_dw = n_dw;
  return launch_tiles(a, W == 64 ? feat_tc_kernel<64> : feat_tc_kernel<32>, W, false, blocks, dw,
                      sse, stream);
}
