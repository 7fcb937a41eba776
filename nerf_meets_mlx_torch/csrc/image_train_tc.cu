// Fused 2-D image-learning train step for Hopper (sm_90a): the MLP's
// forward, the squared error and its gradient, every product of the MLP on
// the tensor cores in 3xTF32.
//
// Replaces nerf_meets_mlx_tpu/kernels/fused_image.py::_train_kernel
// (pallas_call at :336) for every shape it takes. One call takes pixel
// coordinates x [N, d] (d = 2 for the image task), target colours [N, oc],
// the frequency bands and the MLP's nn.Linear parameters as PyTorch holds
// them (weights [fan_out][fan_in], one pointer each), and computes
//
//   sinusoidal encode (sin of x_a*b_j, a-major; then the cosines as
//   sin(x_a*b_j + pi/2); then x itself when include_input)
//   -> D x W relu MLP with the encoded input concatenated (input-first) at
//   the skip layers -> output head W -> oc (no activation),
//
// sse = sum over the N rows and oc columns of (out - target)^2, and
// d(sse)/d(every weight and bias) into one flat buffer: each weight
// [fan_out][fan_in] then its bias, in the order of NeRFMLP.linears(), so
// that the gradients are views of it. The encoding has no parameters and
// gets no gradient. Shapes: widths that are multiples of 16 from 32 to 256
// (a template argument: 32, 64, 128 and 256 in one build, any other with
// -DKW), depth 1..20 with any skips, 1..4 outputs, 1..3 input dimensions,
// at most 128 encoded features.
//
// Precision: every product of the MLP -- the dense layers forward, the
// cotangents dZ W, dW = dZ^T X -- runs on mma.sync m16n8k8 in 3xTF32: each
// fp32 operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
// and lo*hi + hi*lo, then hi*hi are summed (csrc/tf32x3.cuh). The tensor
// cores add with truncation, so each k-step's three products start from
// zero and are added to the sum in fp32 (a forward or cotangent product),
// or each 32-point slice's (dW), as csrc/fused_train.cu does: a whole layer
// in the truncating accumulator flips relu decisions in the backward that
// the fp32 plain version does not. The output head (W -> oc) and its
// cotangent stay on the CUDA cores, in fp32. sse and every dW are held to
// the plain version at atol 1e-4 + rtol 1e-4 and 1e-3 of each array's
// largest value; one TF32 pass misses that (tests/test_torch_image_train.py
// emulates both on the CPU).
//
// What bounds it. At image2d's shapes (D = 8, W = 256, the skip after layer
// 4, 10 bands of 2 axes: 40 features, 3 outputs) a pixel costs 480,000
// MACs forward, as many for dW and 459,520 for the hidden layers'
// cotangents: 2.84 MFLOP, 11.6 GFLOP at 4096 pixels. In 3xTF32 that is
// three tensor-core operations each, 0.071 ms at 495 TFLOP/s (0.174 ms of
// fp32 at 67 TFLOP/s). Its inputs and outputs are ~2 MB (0.6 us at 3.35
// TB/s). The workspace below and the weights each block streams from L2
// (4.2 MB a block, 540 MB a call at 4096 pixels) are what the design adds.
//
// Design: three launches a call, all hand-written here.
//
// 1. image_tc_kernel: one block of 8 warps a tile of TP = 32 points (two
//    m16 row tiles), so that a step's 4096 pixels make 128 blocks (4001:
//    126) on the 132 SMs. The block encodes its points into shared memory
//    (and, point-major, into the workspace for dW), runs the D layers, the
//    head and the loss, then the cotangents of layers D-1 .. 1. A layer's
//    N/8 column tiles are split between the warps; each warp computes them
//    for both row tiles. The weights come in slices of KS = 32 rows of the
//    reduction, straight from each nn.Linear weight by cp.async, three
//    slices in flight: in the forward a slice is [n][k] (the weight's own
//    rows, stride KS + 4), in the backward [k][n] (stride W + 8), so that
//    one fp32 copy of W is read as W and as W^T and every fragment load of
//    either is free of bank conflicts; the operands are split into hi/lo
//    as their fragments are loaded (each weight element is loaded by one
//    warp once a tile, so a split there costs what a pre-split would,
//    without its extra pass and barrier). The slices are walked in one
//    fixed order (Cursor) over the whole tile -- the forward layers'
//    input segments, then the backward layers -- so the next layer's first
//    slices are in flight while this one finishes. Activations live in two
//    [point][feature] buffers (stride W + 4); each layer's output also goes
//    to the workspace (dW reads it), and its relu mask to shared memory as
//    bits (one __ballot_sync a fragment element), which the cotangent of
//    the layer reads back: no cotangent is held in registers across a
//    barrier, no activation is read back from device memory. Each layer's
//    cotangent dZ goes to the workspace for dW. The block's squared error
//    is summed in a fixed order into its own partial. What holds it back
//    (tools/image_kernel_probe.py --variants, PERF.md): the products take
//    ~40% of its time, the weight slices' copies ~25%, the rest is
//    fragment loads, splits, epilogues and barriers, two warps a scheduler
//    issuing them in turn; two or four stages, or 16 warps a block, ran no
//    faster.
// 2. image_dw_kernel: dW_l = dZ_l^T X_l and db_l = colsum(dZ_l) for every
//    layer as one split-K GEMM over the points, written in nn.Linear's
//    layout: a block computes one 128 x 128 tile of one layer's [fan_out]
//    [fan_in] block (a skip layer is two jobs, the encoding's columns and
//    h's) over one split of the points, 32-point slices staged by cp.async
//    in three stages, 8 warps of 4 x 4 m16n8k8 tiles; the head's dW
//    (oc rows) runs on the CUDA cores, a thread a column. The split count
//    aims at four blocks an SM (DW_BLOCKS; 15 splits of 288 points at
//    4096 pixels), one block an SM at a time: its time is instructions and
//    latency more than bytes or products (tools/image_kernel_probe.py
//    --variants: without its products, its loads or its stores it keeps
//    82-97% of its time), and more, shorter blocks ran faster than two an
//    SM (0.159 against 0.196 ms).
// 3. image_reduce_kernel: sums the splits in split order and the blocks'
//    squared errors in block order. No atomics anywhere: sse and dW are
//    bit-identical from launch to launch.
//
// Timing variants (tools/image_kernel_probe.py --variants; wrong results):
// IMAGE_TC_NO_MMA and IMAGE_DW_NO_MMA skip the tile kernel's and the dW
// GEMM's tensor-core products (the fragments are still loaded and split);
// IMAGE_TC_NO_LOAD and IMAGE_DW_NO_LOAD copy no slice (the products read
// stale shared memory); IMAGE_TC_NO_STORE and IMAGE_DW_NO_STORE store no
// activation, cotangent or dW partial; IMAGE_TC_STAGES, IMAGE_DW_STAGES,
// IMAGE_DW_KP and IMAGE_TC_THREADS set the pipelines' depths, the dW
// slice and the tile block's threads; IMAGE_DW_BLOCKS the dW block count
// aimed at.
//
// Workspace (allocated once per shape by the wrapper): the encoding [N][E8]
// (E8 = the feature count rounded up to 8), every layer's output and
// cotangent [D][N][W] each, d(sse)/d(out) [N][oc], the blocks' sse and the
// dW splits. At image2d's 4096 pixels: 0.66 + 33.6 + 33.6 + 0.05 MB and 15
// splits of 482,051 floats (28.9 MB): ~97 MB a call, past the 50 MB L2, so
// it goes through HBM.
//
// The TPU kernel's band matrix, zero-extended skip rows and [N, 8] padded
// input, target and output were MXU/VMEM layouts and are not carried over.
// Numerics of the encode as csrc/fused_image.cu's: sinf without fast math,
// phases rounded as the plain version's.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int TP = 32;            // points a tile, one tile a block (two m16 row tiles)
#ifndef IMAGE_TC_THREADS
#define IMAGE_TC_THREADS 256
#endif
constexpr int TC_THREADS = IMAGE_TC_THREADS;  // a tile block's threads
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int NTHREADS = 256;     // a dW or reduce block's threads
constexpr int KS = 32;            // rows of the reduction a staged weight slice
constexpr int FS = KS + 4;        // row stride of a forward slice [n][k] (4 mod 8)
#ifndef IMAGE_TC_STAGES
#define IMAGE_TC_STAGES 3
#endif
constexpr int STAGES = IMAGE_TC_STAGES;  // cp.async stages of the weight slices
constexpr int MAX_DEPTH = 20;
constexpr int MAX_OUT = 4;        // output channels
constexpr int MAX_ENC = 128;      // encoded features
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr float HALF_PI = 1.57079632679489662f;
// dW GEMM
constexpr int GT = 128;           // dW tile edge
#ifndef IMAGE_DW_KP
#define IMAGE_DW_KP 32
#endif
#ifndef IMAGE_DW_STAGES
#define IMAGE_DW_STAGES 3
#endif
constexpr int KP = IMAGE_DW_KP;   // points a staged dW slice
constexpr int GS = GT + 8;        // row stride of a staged dW slice (8 mod 32)
constexpr int DW_STAGES = IMAGE_DW_STAGES;
constexpr int DW_SMEM = DW_STAGES * 2 * KP * GS * (int)sizeof(float);
constexpr int MAX_JOBS = 2 * MAX_DEPTH;
#ifndef IMAGE_DW_BLOCKS
#define IMAGE_DW_BLOCKS (4 * 132)
#endif
constexpr int DW_BLOCKS = IMAGE_DW_BLOCKS;  // dW blocks aimed at: four an SM of an H100

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int enc_dim_of(int d, int F, int inc) { return 2 * d * F + (inc ? d : 0); }

// Per-width constants of the tile kernel
template <int W>
struct Tile {
  static constexpr int NT = W / 8;                       // column tiles of a layer
  static constexpr int NTW = (NT + TC_WARPS - 1) / TC_WARPS;  // column tiles a warp owns (at most)
  static constexpr int LH = W + 4;                       // activation row stride (4 mod 8)
  static constexpr int BS = W + 8;                       // backward slice row stride (8 or 24 mod 32)
  static constexpr int SLICE = W * FS > KS * BS ? W * FS : KS * BS;  // floats a stage
  static __device__ __forceinline__ bool owns(int warp, int j) {
    return NT % TC_WARPS == 0 || warp + TC_WARPS * j < NT;
  }
};

struct Args {
  const float* x;                 // [N, in_dim]
  const float* target;            // [N, out_ch]
  const float* bands;             // [n_freqs]
  const float* w[MAX_DEPTH + 1];  // nn.Linear weights [fan_out][fan_in]: the trunk's, the head's
  const float* b[MAX_DEPTH + 1];  // their biases
  float* enc;                     // [N][E8] encoded input, zero-padded
  float* hs;                      // [depth][N][W] trunk outputs (post-relu)
  float* dzs;                     // [depth][N][W] trunk pre-activation cotangents
  float* dout;                    // [N][out_ch] d(sse)/d(out)
  float* sse_part;                // [n_blocks]
  long long N;
  int depth, in_dim, n_freqs, include_input, out_ch, enc_dim;
  unsigned skip_mask;             // bit j set: layer j takes [encoded input, h]
  int vec;                        // the weight slices can be copied in 16-byte chunks
};

__device__ __forceinline__ bool is_skip(const Args& A, int j) { return (A.skip_mask >> j) & 1u; }

__device__ __forceinline__ int fan_in(const Args& A, int W, int j) {
  return j == 0 ? A.enc_dim : (is_skip(A, j) ? A.enc_dim + W : W);
}

// 4 bytes from global to shared memory, asynchronously; zero where !valid
// (src must still be a valid address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// The weight slices of a tile, in the order the tile multiplies them: each
// forward layer's input segments (layer 0: the encoding; a skip layer: the
// encoding, then h), KS rows of k at a time; then the backward layers
// D-1 .. 1, KS rows of the reduction (the layer's outputs) at a time.
struct Cursor {
  int dir;    // 0 forward, 1 backward, 2 past the last slice
  int layer, seg, k0;
};

// rows of the reduction in the cursor's segment, and its first column of W_l
template <int W>
__device__ __forceinline__ int seg_len(const Args& A, const Cursor& c) {
  if (c.dir == 1) return W;
  return (c.layer == 0 || (is_skip(A, c.layer) && c.seg == 0)) ? A.enc_dim : W;
}

__device__ __forceinline__ int seg_col0(const Args& A, const Cursor& c) {
  return is_skip(A, c.layer) && (c.dir == 1 || c.seg == 1) ? A.enc_dim : 0;
}

template <int W>
__device__ __forceinline__ void advance(const Args& A, Cursor& c) {
  c.k0 += KS;
  if (c.k0 < seg_len<W>(A, c)) return;
  c.k0 = 0;
  if (c.dir == 0) {
    if (++c.seg < (c.layer > 0 && is_skip(A, c.layer) ? 2 : 1)) return;
    c.seg = 0;
    if (++c.layer < A.depth) return;
    c.dir = 1;
    c.layer = A.depth - 1;
  } else {
    --c.layer;
  }
  if (c.layer < 1 && c.dir == 1) c.dir = 2;
}

// Starts the copy of the cursor's slice into dst: forward [W rows n][FS],
// row n holding W_l[n][col0 + k0 ..]; backward [KS rows][BS], row r holding
// W_l[k0 + r][col0 ..]; zeros past the segment.
template <int W>
__device__ __forceinline__ void issue(const Args& A, const Cursor& c, float* dst) {
#ifdef IMAGE_TC_NO_LOAD
  return;
#endif
  using T = Tile<W>;
  const int tid = threadIdx.x;
  const float* Wl = A.w[c.layer];
  const int fi = fan_in(A, W, c.layer);
  const int kc = min(KS, seg_len<W>(A, c) - c.k0);
  if (c.dir == 0) {
    const float* src = Wl + seg_col0(A, c) + c.k0;
    if (A.vec) {
      constexpr int Q = W * KS / 4;
#pragma unroll
      for (int l = 0; l < (Q + TC_THREADS - 1) / TC_THREADS; ++l) {
        const int q = tid + l * TC_THREADS;
        if (Q % TC_THREADS == 0 || q < Q) {
          const int n = q / (KS / 4), k = 4 * (q % (KS / 4));
          const bool ok = k < kc;
          cp_async16(dst + n * FS + k, ok ? src + (size_t)n * fi + k : Wl, ok);
        }
      }
    } else {
      constexpr int Q = W * KS;
#pragma unroll 4
      for (int l = 0; l < (Q + TC_THREADS - 1) / TC_THREADS; ++l) {
        const int q = tid + l * TC_THREADS;
        if (Q % TC_THREADS == 0 || q < Q) {
          const int n = q / KS, k = q % KS;
          const bool ok = k < kc;
          cp_async4(dst + n * FS + k, ok ? src + (size_t)n * fi + k : Wl, ok);
        }
      }
    }
  } else {
    const float* src = Wl + (size_t)c.k0 * fi + seg_col0(A, c);
    if (A.vec) {
      constexpr int Q = KS * W / 4;
#pragma unroll
      for (int l = 0; l < (Q + TC_THREADS - 1) / TC_THREADS; ++l) {
        const int q = tid + l * TC_THREADS;
        if (Q % TC_THREADS == 0 || q < Q) {
          const int r = q / (W / 4), k = 4 * (q % (W / 4));
          const bool ok = r < kc;
          cp_async16(dst + r * T::BS + k, ok ? src + (size_t)r * fi + k : Wl, ok);
        }
      }
    } else {
      constexpr int Q = KS * W;
#pragma unroll 4
      for (int l = 0; l < (Q + TC_THREADS - 1) / TC_THREADS; ++l) {
        const int q = tid + l * TC_THREADS;
        if (Q % TC_THREADS == 0 || q < Q) {
          const int r = q / W, k = q % W;
          const bool ok = r < kc;
          cp_async4(dst + r * T::BS + k, ok ? src + (size_t)r * fi + k : Wl, ok);
        }
      }
    }
  }
}

// acc += a[:, kcol .. kcol + kc) * (the slice st) for the tile's 32 rows
// and the warp's column tiles, one fresh 3xTF32 accumulator a k-step added
// in fp32. a is [point][feature] with row stride lda (4 mod 8: the A
// fragment's 8 rows x 4 columns fall in 32 banks); FWD: st is [n][k]
// (stride FS), else [k][n] (stride BS).
template <int W, bool FWD>
__device__ __forceinline__ void mma_slice(const float* __restrict__ a, int lda, int kcol, int kc,
                                          const float* __restrict__ st,
                                          float (&acc)[2][Tile<W>::NTW][4]) {
  using T = Tile<W>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k8 = 0; k8 < KS; k8 += 8) {
    if (k8 >= kc) break;
    uint32_t bh[T::NTW][2], bl[T::NTW][2];
#pragma unroll
    for (int j = 0; j < T::NTW; ++j) {
      if (!T::owns(warp, j)) continue;
      const int n = 8 * (warp + TC_WARPS * j) + g;
      const float b0 = FWD ? st[n * FS + k8 + t] : st[(k8 + t) * T::BS + n];
      const float b1 = FWD ? st[n * FS + k8 + t + 4] : st[(k8 + t + 4) * T::BS + n];
      split_tf32(b0, bh[j][0], bl[j][0]);
      split_tf32(b1, bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* q = a + (16 * i + g) * lda + kcol + k8 + t;
      uint32_t ah[4], al[4];
      split_tf32(q[0], ah[0], al[0]);
      split_tf32(q[8 * lda], ah[1], al[1]);
      split_tf32(q[4], ah[2], al[2]);
      split_tf32(q[8 * lda + 4], ah[3], al[3]);
#ifndef IMAGE_TC_NO_MMA
#pragma unroll
      for (int j = 0; j < T::NTW; ++j)
        if (T::owns(warp, j)) mma_3xtf32_add(acc[i][j], ah, al, bh[j], bl[j]);
#else
      acc[i][0][0] += __uint_as_float(ah[0] ^ al[1] ^ ah[2] ^ al[3] ^ bh[0][0] ^ bl[0][1]);
#endif
    }
  }
}

// Accumulator element (i, j, e) of lane (g, t): row 16 i + g + 8 (e / 2),
// column 8 (warp + TC_WARPS j) + 2 t + e % 2. The relu mask of a layer is one
// 32-bit word per (row tile, column tile, e), bit = lane.

// A forward layer's epilogue: bias, relu, the mask bits, the output into
// out [point][LH] and (the tile's first nv points) gout [point][W].
template <int W>
__device__ __forceinline__ void epi_forward(const float (&acc)[2][Tile<W>::NTW][4],
                                            const float* __restrict__ bias, float* __restrict__ out,
                                            float* __restrict__ gout, uint32_t* __restrict__ mask,
                                            int nv) {
  using T = Tile<W>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < T::NTW; ++j) {
    if (!T::owns(warp, j)) continue;
    const int nt = warp + TC_WARPS * j, col = 8 * nt + 2 * t;
    const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * i + g + 8 * h;
        const float v0 = fmaxf(acc[i][j][2 * h] + b0, 0.f);
        const float v1 = fmaxf(acc[i][j][2 * h + 1] + b1, 0.f);
        const uint32_t m0 = __ballot_sync(0xffffffffu, v0 > 0.f);
        const uint32_t m1 = __ballot_sync(0xffffffffu, v1 > 0.f);
        if (lane == 0) {
          mask[(i * T::NT + nt) * 4 + 2 * h] = m0;
          mask[(i * T::NT + nt) * 4 + 2 * h + 1] = m1;
        }
        *reinterpret_cast<float2*>(out + p * T::LH + col) = make_float2(v0, v1);
#ifndef IMAGE_TC_NO_STORE
        if (p < nv) *reinterpret_cast<float2*>(gout + (size_t)p * W + col) = make_float2(v0, v1);
#endif
      }
    }
  }
}

// A cotangent's epilogue: zero where the layer's relu was off (its mask
// bits), the result into out [point][LH] and gout [point][W].
template <int W>
__device__ __forceinline__ void epi_backward(const float (&acc)[2][Tile<W>::NTW][4],
                                             float* __restrict__ out, float* __restrict__ gout,
                                             const uint32_t* __restrict__ mask, int nv) {
  using T = Tile<W>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < T::NTW; ++j) {
    if (!T::owns(warp, j)) continue;
    const int nt = warp + TC_WARPS * j, col = 8 * nt + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 16 * i + g + 8 * h;
        const uint32_t m0 = mask[(i * T::NT + nt) * 4 + 2 * h];
        const uint32_t m1 = mask[(i * T::NT + nt) * 4 + 2 * h + 1];
        const float v0 = (m0 >> lane) & 1u ? acc[i][j][2 * h] : 0.f;
        const float v1 = (m1 >> lane) & 1u ? acc[i][j][2 * h + 1] : 0.f;
        *reinterpret_cast<float2*>(out + p * T::LH + col) = make_float2(v0, v1);
#ifndef IMAGE_TC_NO_STORE
        if (p < nv) *reinterpret_cast<float2*>(gout + (size_t)p * W + col) = make_float2(v0, v1);
#endif
      }
    }
  }
}

template <int W>
__device__ __forceinline__ void zero_acc(float (&acc)[2][Tile<W>::NTW][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Tile<W>::NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Encoded feature f of a point (coordinates xs[0..d)): sines, cosines as
// sin(x*b + pi/2), then the raw input; rows past the feature count are zero.
__device__ __forceinline__ float encode_feature(int f, int d, int F, int inc, const float* bands,
                                                const float* xs) {
  if (f < d * F) {
    const int a = f / F, j = f - a * F;
    return sinf(__fmul_rn(__ldg(xs + a), __ldg(bands + j)));
  }
  if (f < 2 * d * F) {
    const int g = f - d * F, a = g / F, j = g - a * F;
    return sinf(__fadd_rn(__fmul_rn(__ldg(xs + a), __ldg(bands + j)), HALF_PI));
  }
  if (inc && f < 2 * d * F + d) return __ldg(xs + f - 2 * d * F);
  return 0.f;
}

template <int W>
__global__ void __launch_bounds__(TC_THREADS, 1) image_tc_kernel(const __grid_constant__ Args A) {
  using T = Tile<W>;
  extern __shared__ __align__(16) float smem[];
  const int E = A.enc_dim, E8 = round_up(E, 8), LE = E8 + 4;
  const int D = A.depth, oc = A.out_ch;
  float* encS = smem;                       // [TP][LE] the encoding
  float* hbuf0 = encS + TP * LE;            // [TP][LH] activations / cotangents
  float* hbuf1 = hbuf0 + TP * T::LH;
  float* stage = hbuf1 + TP * T::LH;        // [STAGES][SLICE] weight slices
  float* dsm = stage + STAGES * T::SLICE;   // [TP][MAX_OUT] d(sse)/d(out)
  uint32_t* masks = reinterpret_cast<uint32_t*>(dsm + TP * MAX_OUT);  // [D][2][NT][4]
  constexpr int MASK_WORDS = 2 * T::NT * 4;  // a layer's

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t N = (size_t)A.N;
  const size_t g0 = (size_t)blockIdx.x * TP;
  const int nv = (int)min((long long)TP, A.N - (long long)g0);

  // the first STAGES - 1 slices in flight while the tile is encoded
  Cursor ld{0, 0, 0, 0};
  int ld_slot = 0, use_slot = 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (ld.dir < 2) {
      issue<W>(A, ld, stage + ld_slot * T::SLICE);
      advance<W>(A, ld);
    }
    cp_async_commit();
    ld_slot = ld_slot + 1 == STAGES ? 0 : ld_slot + 1;
  }
  // waits for the next slice (every thread's copies, and every thread done
  // with the previous stage), starts the copy of the one STAGES - 1 ahead
  // into the stage just freed, and returns the slice's stage
  auto next_slice = [&]() -> const float* {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ld.dir < 2) {
      issue<W>(A, ld, stage + ld_slot * T::SLICE);
      advance<W>(A, ld);
    }
    cp_async_commit();
    ld_slot = ld_slot + 1 == STAGES ? 0 : ld_slot + 1;
    const float* st = stage + use_slot * T::SLICE;
    use_slot = use_slot + 1 == STAGES ? 0 : use_slot + 1;
    return st;
  };

  // ---- encode: [point][feature] in shared memory, point-major for dW ----
  {
    const int d = A.in_dim;
    for (int idx = tid; idx < TP * E8; idx += TC_THREADS) {
      const int p = idx / E8, f = idx - p * E8;
      float e = 0.f;
      if (p < nv && f < E)
        e = encode_feature(f, d, A.n_freqs, A.include_input, A.bands, A.x + (g0 + p) * d);
      encS[p * LE + f] = e;
      if (p < nv) A.enc[(g0 + p) * E8 + f] = e;
    }
  }

  // ---- forward ----
  float acc[2][T::NTW][4];
  float* hin = hbuf0;
  float* hout = hbuf1;
  for (int j = 0; j < D; ++j) {
    zero_acc<W>(acc);
    const bool skip = is_skip(A, j);
    const int nseg = j > 0 && skip ? 2 : 1;
    for (int s = 0; s < nseg; ++s) {
      const bool enc_seg = j == 0 || (skip && s == 0);
      const float* a = enc_seg ? encS : hin;
      const int lda = enc_seg ? LE : T::LH, K = enc_seg ? E : W;
      for (int k0 = 0; k0 < K; k0 += KS) {
        const float* st = next_slice();
        mma_slice<W, true>(a, lda, k0, min(KS, K - k0), st, acc);
      }
    }
    epi_forward<W>(acc, A.b[j], hout, A.hs + ((size_t)j * N + g0) * W, masks + j * MASK_WORDS,
                   nv);
    float* tmp = hin; hin = hout; hout = tmp;
  }

  // ---- output head (CUDA cores): a warp an output, lanes along W ----
  __syncthreads();  // the last layer's output is complete in hin
  const float* Wo = A.w[D];
  for (int idx = warp; idx < TP * oc; idx += TC_WARPS) {
    const int p = idx / oc, o = idx - p * oc;
    float s = 0.f;
    for (int c = lane; c < W; c += 32) s = fmaf(hin[p * T::LH + c], __ldg(Wo + (size_t)o * W + c), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      const float v = s + __ldg(A.b[D] + o);
      const float err = p < nv ? v - __ldg(A.target + (g0 + p) * oc + o) : 0.f;
      dsm[p * MAX_OUT + o] = 2.f * err;
      if (p < nv) A.dout[(g0 + p) * oc + o] = 2.f * err;
    }
  }
  __syncthreads();
  if (tid == 0) {  // the tile's squared error, in a fixed order
    float s = 0.f;
    for (int p = 0; p < nv; ++p)
      for (int o = 0; o < oc; ++o) {
        const float e = 0.5f * dsm[p * MAX_OUT + o];
        s = fmaf(e, e, s);
      }
    A.sse_part[blockIdx.x] = s;
  }

  // ---- the last layer's cotangent: dZ = (dout Wo) * relu' (CUDA cores) ----
  float* cur = hout;  // hout's contents (h_{D-2}) are dead
  float* nxt = hin;
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < T::NTW; ++j) {
      if (!T::owns(warp, j)) continue;
      const int col = 8 * (warp + TC_WARPS * j) + 2 * t;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 16 * i + g + 8 * (e >> 1), c = col + (e & 1);
          float s = 0.f;
          for (int o = 0; o < oc; ++o) s = fmaf(dsm[p * MAX_OUT + o], __ldg(Wo + (size_t)o * W + c), s);
          acc[i][j][e] = s;
        }
    }
    epi_backward<W>(acc, cur, A.dzs + ((size_t)(D - 1) * N + g0) * W,
                    masks + (D - 1) * MASK_WORDS, nv);
  }

  // ---- backward: dZ_{j-1} = (dZ_j W_j[:, h part]) * relu'(h_{j-1}) ----
  for (int j = D - 1; j >= 1; --j) {
    zero_acc<W>(acc);
    for (int k0 = 0; k0 < W; k0 += KS) {
      const float* st = next_slice();
      mma_slice<W, false>(cur, T::LH, k0, min(KS, W - k0), st, acc);
    }
    epi_backward<W>(acc, nxt, A.dzs + ((size_t)(j - 1) * N + g0) * W,
                    masks + (j - 1) * MASK_WORDS, nv);
    float* tmp = cur; cur = nxt; nxt = tmp;
  }
}

size_t tile_smem_bytes(int W, int depth, int enc_dim) {
  const int LE = round_up(enc_dim, 8) + 4, LH = W + 4, BS = W + 8;
  const int slice = W * FS > KS * BS ? W * FS : KS * BS;
  return sizeof(float) * ((size_t)TP * LE + 2 * (size_t)TP * LH + (size_t)STAGES * slice +
                          TP * MAX_OUT) +
         sizeof(uint32_t) * (size_t)depth * 2 * (W / 8) * 4;
}

// ---------------------------------------------------------------------------
// dW = dZ^T X, split over the points, in nn.Linear's layout
// ---------------------------------------------------------------------------

struct Job {              // C[k][n] = sum_p a[p][k] * b[p][n], k < K, n < N, at out[c_off + k * ldc + n]
  const float* a;         // [P][lda] the layer's cotangent (the head's: d(sse)/d(out))
  const float* b;         // [P][ldb] the layer's input, or one segment of it
  int lda, ldb, K, N;
  int c_off, ldc;
  int bias_off;           // db[k] = sum_p a[p][k] goes here; -1: none
  int tile0, tiles_n;     // first tile of this job, tiles along n
};

struct GemmArgs {
  Job jobs[MAX_JOBS];
  int n_jobs;
  long long P;
  int pts_per_split;
  long long part_stride;  // floats a split of `part`
  float* part;            // [n_splits][part_stride]
};

// The A fragment of an m16n8k8 tile whose element (m, k) is at
// p[k * ld + m], and the B fragment whose element (k, n) is at p[k * ld +
// n], split into hi and lo.
__device__ __forceinline__ void load_a(const float* p, int ld, int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* q = p + t * ld + g;
  split_tf32(q[0], hi[0], lo[0]);
  split_tf32(q[8], hi[1], lo[1]);
  split_tf32(q[4 * ld], hi[2], lo[2]);
  split_tf32(q[4 * ld + 8], hi[3], lo[3]);
}

__device__ __forceinline__ void load_b(const float* p, int ld, int g, int t, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  const float* q = p + t * ld + g;
  split_tf32(q[0], hi[0], lo[0]);
  split_tf32(q[4 * ld], hi[1], lo[1]);
}

// One 128 x 128 tile of C over the points [pb, pe) on the tensor cores into
// out; with BIAS also db[k] = sum_p a[p][k] (fp32, CUDA cores, fixed
// order). Warp w owns rows 64 (w % 2) .. +64 and columns 32 (w / 2) .. +32.
// Each 32-point slice's products start from zero and are added in fp32.
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

  // stage s: the a slice [KP][GS] then the b slice; a 16-byte chunk of a
  // row is copied whole or not at all (lda, ldb are multiples of 4), rows
  // past pe and columns past the row read zeros
  auto load = [&](int s, long long p0) {
#ifdef IMAGE_DW_NO_LOAD
    return;
#endif
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
  for (int s = 0; s < n_sl; ++s) {
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();
    const int nx = s + DW_STAGES - 1;
    if (nx < n_sl) load(nx % DW_STAGES, pb + (long long)nx * KP);
    cp_async_commit();
    const float* As = smem + (s % DW_STAGES) * 2 * KP * GS;
    const float* Bs = As + KP * GS;
    if (BIAS) {  // row tid % GT of the tile over half the slice's points
      const int c = tid & (GT - 1), h = tid / GT;
#pragma unroll
      for (int pp = 0; pp < KP / 2; ++pp) bsum += As[(h * (KP / 2) + pp) * GS + c];
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
#ifndef IMAGE_DW_NO_MMA
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_3xtf32(acc[i][j], ah, al, bh[j], bl[j]);
#else
        acc[i][0][0] += __uint_as_float(ah[0] ^ al[1] ^ ah[2] ^ al[3] ^ bh[0][0] ^ bl[3][1]);
#endif
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) tot[i][j][c] += acc[i][j][c];
  }

  // scalar stores: a skip layer's rows are enc_dim + W long, which may be odd
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + wm + 16 * i + g + 8 * (e >> 1);
        const int n = n0 + wn + 8 * j + 2 * t4 + (e & 1);
#ifndef IMAGE_DW_NO_STORE
        if (k < J.K && n < J.N) out[J.c_off + (size_t)k * J.ldc + n] = tot[i][j][e];
#else
        if (k < J.K && n < J.N && tot[i][j][e] == 1234.5f) out[J.c_off] = 0.f;
#endif
      }
  if (BIAS) {
    __syncthreads();  // every warp is done with the stages (only empty copy groups remain)
    smem[tid] = bsum;
    __syncthreads();
    if (tid < GT && k0 + tid < J.K) out[J.bias_off + k0 + tid] = smem[tid] + smem[tid + GT];
  }
}

// The head's job (K = oc <= MAX_OUT rows) on the CUDA cores: thread t owns
// column n0 + t % GT over every other point of [pb, pe); a point's oc
// cotangents are one address for the whole half (a broadcast).
__device__ __forceinline__ void dw_head(const Job& J, int n0, long long pb, long long pe,
                                        float* __restrict__ out, float* __restrict__ smem) {
  const int tid = threadIdx.x, r = tid & (GT - 1), h = tid / GT;
  const int n = n0 + r;
  const bool live = n < J.N;
  float acc[MAX_OUT], bsum[MAX_OUT];
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) acc[o] = bsum[o] = 0.f;
#pragma unroll 4
  for (long long p = pb + h; p < pe; p += 2) {
    const float xv = live ? __ldg(J.b + p * J.ldb + n) : 0.f;
#pragma unroll
    for (int o = 0; o < MAX_OUT; ++o) {
      if (o < J.K) {
        const float dv = __ldg(J.a + p * J.lda + o);
        acc[o] = fmaf(dv, xv, acc[o]);
        bsum[o] += dv;
      }
    }
  }
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) smem[(h * GT + r) * MAX_OUT + o] = acc[o];
  if (r == 0) {
#pragma unroll
    for (int o = 0; o < MAX_OUT; ++o) smem[2 * GT * MAX_OUT + h * MAX_OUT + o] = bsum[o];
  }
  __syncthreads();
  if (h == 0 && live) {
    for (int o = 0; o < J.K; ++o)
      out[J.c_off + (size_t)o * J.ldc + n] = smem[r * MAX_OUT + o] + smem[(GT + r) * MAX_OUT + o];
  }
  if (tid == 0 && J.bias_off >= 0 && n0 == 0) {
    for (int o = 0; o < J.K; ++o)
      out[J.bias_off + o] = smem[2 * GT * MAX_OUT + o] + smem[2 * GT * MAX_OUT + MAX_OUT + o];
  }
}

__global__ void __launch_bounds__(NTHREADS, 1) image_dw_kernel(const __grid_constant__ GemmArgs G) {
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
  if (J.K <= MAX_OUT)
    dw_head(J, n0, pb, pe, out, smem);
  else if (J.bias_off >= 0 && n0 == 0)
    dw_tile<true>(J, k0, n0, pb, pe, out, smem);
  else
    dw_tile<false>(J, k0, n0, pb, pe, out, smem);
}

// dw[i] = sum over splits of part[split][i], in split order; sse = sum of
// the per-block partials, in block order.
__global__ void image_reduce_kernel(const float* __restrict__ part, long long stride, int n_splits,
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
// (kernels/fused_train.py::width_defines).
#ifdef KW
static_assert(KW % 16 == 0 && KW >= 32 && KW <= 256, "KW is a multiple of 16 in 32..256");
bool width_ok(int w) { return w == KW; }
#define PICK_WIDTH(K, w) ((w) == KW ? K<KW> : nullptr)
#else
bool width_ok(int w) { return w == 32 || w == 64 || w == 128 || w == 256; }
#define PICK_WIDTH(K, w)                                                                    \
  ((w) == 256 ? K<256> : (w) == 128 ? K<128> : (w) == 64 ? K<64> : (w) == 32 ? K<32> : nullptr)
#endif

// Every shape fact the host code derives from the call's arguments.
struct Plan {
  int E, E8, n_dw, n_blocks, tiles, n_splits, pts_per_split;
  int w_off[MAX_DEPTH + 1], b_off[MAX_DEPTH + 1];  // the flat dW buffer's pieces
  size_t enc, hs, dzs, dout, sse_part, part, total;  // workspace offsets (floats)
  long long part_stride;
};

bool plan_of(long long N, int depth, int W, unsigned skip, int in_dim, int n_freqs, int inc,
             int oc, Plan& L) {
  if (N <= 0 || depth < 1 || depth > MAX_DEPTH || !width_ok(W) || (skip & 1u) ||
      (skip >> depth) || in_dim < 1 || in_dim > 3 || n_freqs < 0 || oc < 1 || oc > MAX_OUT)
    return false;
  L.E = enc_dim_of(in_dim, n_freqs, inc);
  if (L.E < 1 || L.E > MAX_ENC || tile_smem_bytes(W, depth, L.E) > (size_t)MAX_SMEM) return false;
  L.E8 = round_up(L.E, 8);
  long long n = 0;
  int tiles = 0;
  for (int j = 0; j <= depth; ++j) {
    const int fo = j < depth ? W : oc;
    const int fi = j == 0 ? L.E : (j < depth && ((skip >> j) & 1u) ? L.E + W : W);
    L.w_off[j] = (int)n;
    n += (long long)fo * fi;
    L.b_off[j] = (int)n;
    n += fo;
    if (j == depth)
      tiles += (W + GT - 1) / GT;  // the head: one row of column tiles
    else if (j > 0 && ((skip >> j) & 1u))
      tiles += (W + GT - 1) / GT * ((L.E + GT - 1) / GT + (W + GT - 1) / GT);
    else
      tiles += (W + GT - 1) / GT * ((fi + GT - 1) / GT);
  }
  L.n_dw = (int)n;
  L.tiles = tiles;
  L.n_blocks = (int)((N + TP - 1) / TP);
  const long long max_splits = (N + KP - 1) / KP;
  long long s = DW_BLOCKS / tiles;
  s = s < 1 ? 1 : (s > max_splits ? max_splits : s);
  L.pts_per_split = round_up((int)((N + s - 1) / s), KP);
  L.n_splits = (int)((N + L.pts_per_split - 1) / L.pts_per_split);
  size_t o = 0;
  auto take = [&](size_t k) {
    const size_t at = o;
    o += (k + 3) / 4 * 4;  // every piece starts on 16 bytes
    return at;
  };
  const size_t P = (size_t)N;
  L.enc = take(P * L.E8);
  L.hs = take((size_t)depth * P * W);
  L.dzs = take((size_t)depth * P * W);
  L.dout = take(P * oc);
  L.sse_part = take((size_t)L.n_blocks);
  L.part_stride = (L.n_dw + 3) / 4 * 4;
  L.part = take((size_t)L.n_splits * L.part_stride);
  L.total = o;
  return true;
}

}  // namespace

// Floats of device scratch the launch below needs (0: a shape it does not
// take); the wrapper allocates it once per shape.
extern "C" long long image_train_tc_workspace_floats(long long N, int depth, int width,
                                                     unsigned skip_mask, int in_dim, int n_freqs,
                                                     int include_input, int out_ch) {
  Plan L;
  if (!plan_of(N, depth, width, skip_mask, in_dim, n_freqs, include_input, out_ch, L)) return 0;
  return (long long)L.total;
}

// Shared-memory bytes one tile block needs (0 if the width is not built).
extern "C" long long image_train_tc_smem_bytes(int width, int depth, int enc_dim) {
  if (!width_ok(width)) return 0;
  return (long long)tile_smem_bytes(width, depth, enc_dim);
}

// sse [1] and dw (every weight [fan_out][fan_in] then its bias, in the
// order of NeRFMLP.linears()). params: the 2 * (depth + 1) weight and bias
// pointers in that order (host array). Launches the three kernels on
// `stream`; returns the first cudaError_t.
extern "C" int image_train_tc_launch(const float* x, const float* target, const float* bands,
                                     const float* const* params, float* sse, float* dw,
                                     float* workspace, long long N, int depth, int width,
                                     unsigned skip_mask, int in_dim, int n_freqs,
                                     int include_input, int out_ch, void* stream) {
  Plan L;
  if (!plan_of(N, depth, width, skip_mask, in_dim, n_freqs, include_input, out_ch, L))
    return (int)cudaErrorInvalidValue;
  const int W = width, D = depth;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  Args a{};
  a.x = x; a.target = target; a.bands = bands;
  bool aligned = L.E % 4 == 0;
  for (int j = 0; j <= D; ++j) {
    a.w[j] = params[2 * j];
    a.b[j] = params[2 * j + 1];
    aligned &= reinterpret_cast<uintptr_t>(a.w[j]) % 16 == 0;
  }
  a.vec = aligned;
  a.enc = workspace + L.enc; a.hs = workspace + L.hs; a.dzs = workspace + L.dzs;
  a.dout = workspace + L.dout; a.sse_part = workspace + L.sse_part;
  a.N = N; a.depth = D; a.in_dim = in_dim; a.n_freqs = n_freqs; a.include_input = include_input;
  a.out_ch = out_ch; a.enc_dim = L.E; a.skip_mask = skip_mask;

  void (*kernel)(Args) = PICK_WIDTH(image_tc_kernel, W);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = (int)tile_smem_bytes(W, D, L.E);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)L.n_blocks, TC_THREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // one job per layer input segment, in nn.Linear's layout: C = dZ^T X is
  // the [fan_out][fan_in] block; a skip layer's two jobs write disjoint
  // columns of its rows
  GemmArgs G{};
  const size_t P = (size_t)N;
  int nj = 0, tiles = 0;
  auto add = [&](const float* A_, int lda, const float* B_, int ldb, int K, int Nc, int c_off,
                 int ldc, int bias_off) {
    Job& J = G.jobs[nj++];
    J.a = A_; J.lda = lda; J.b = B_; J.ldb = ldb; J.K = K; J.N = Nc;
    J.c_off = c_off; J.ldc = ldc; J.bias_off = bias_off;
    J.tile0 = tiles;
    J.tiles_n = (Nc + GT - 1) / GT;
    tiles += (K <= MAX_OUT ? 1 : (K + GT - 1) / GT) * J.tiles_n;
  };
  add(a.dzs, W, a.enc, L.E8, W, L.E, L.w_off[0], L.E, L.b_off[0]);
  for (int j = 1; j < D; ++j) {
    const float* dz = a.dzs + (size_t)j * P * W;
    const float* hprev = a.hs + (size_t)(j - 1) * P * W;
    if ((skip_mask >> j) & 1u) {
      add(dz, W, a.enc, L.E8, W, L.E, L.w_off[j], L.E + W, L.b_off[j]);
      add(dz, W, hprev, W, W, W, L.w_off[j] + L.E, L.E + W, -1);
    } else {
      add(dz, W, hprev, W, W, W, L.w_off[j], W, L.b_off[j]);
    }
  }
  add(a.dout, out_ch, a.hs + (size_t)(D - 1) * P * W, W, out_ch, W, L.w_off[D], W, L.b_off[D]);
  if (tiles != L.tiles) return (int)cudaErrorInvalidValue;
  G.n_jobs = nj;
  G.P = (long long)P;
  G.pts_per_split = L.pts_per_split;
  G.part_stride = L.part_stride;
  G.part = workspace + L.part;
  err = cudaFuncSetAttribute(image_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  image_dw_kernel<<<dim3((unsigned)tiles, (unsigned)L.n_splits), NTHREADS, DW_SMEM, st>>>(G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  image_reduce_kernel<<<(L.n_dw + NTHREADS - 1) / NTHREADS, NTHREADS, 0, st>>>(
      workspace + L.part, L.part_stride, L.n_splits, dw, L.n_dw, a.sse_part, L.n_blocks, sse);
  return (int)cudaGetLastError();
}
