// Fused 2-D image-learning MLP forward for Hopper (sm_90a): the sinusoidal
// encode and the dense layers on wgmma in 3xTF32.
//
// Replaces nerf_meets_mlx_tpu/kernels/fused_image.py::_fwd_kernel
// (pallas_call at :386), the forward of fused_image_apply. One call takes
// pixel coordinates x [N, d] (d = 1..3; 2 for the image task) and writes
// the output [N, out_ch]:
//
//   sinusoidal encode (sin of x_a*b_j, a-major; then the cosines as
//   sin(x_a*b_j + pi/2); then x itself when include_input)
//   -> D x W relu MLP with the encoded input concatenated (input-first) at
//   the skip layers -> output head W -> out_ch (no activation).
//
// Shapes: widths that are multiples of 16 from 32 to 256, depth 1..20 with
// any skips, 1..3 input dimensions, up to 128 encoded features, out_ch
// 1..4, any N (a ragged last tile is computed on zero pixels and masked on
// the way out). The train step's kernels are csrc/image_train_tc.cu.
//
// What bounds it: the tensor cores. At image2d's shapes (D = 8, W = 256,
// skip after layer 4, 10 bands of 2 axes, no raw input: 40 features) a
// pixel costs 480,000 MACs against 8 bytes of input and 12 of output; in
// 3xTF32 (below) that is three tensor-core products per MAC: 3 x 0.154
// TFLOP / 495 TFLOP/s = 0.93 ms for the 160,000 pixels of a 400 x 400
// frame (2.29 ms at the 67 TFLOP/s fp32 rate). The weights (1.96 MB in
// fp32, 3.83 MB as TF32 hi and lo images) stay in L2 and are streamed
// through shared memory once per tile of TILE = 128 pixels.
//
// Design: two launches on the caller's stream.
// * image_fwd_pack_kernel writes the weight images the tile walk streams
//   from the nn.Linear weights themselves (no host pack): per input segment
//   of a layer (layer 0's encoding; a skip layer's encoding, then its h;
//   every other layer's h) and per k-step of 8 rows of K, the TF32 hi and lo
//   halves of W^T in wgmma's K-major core-matrix layout, the K order
//   permuted (fused_train.WGMMA_K_ORDER), as csrc/mlp_bwd_tc.cu's
//   mlp_bwd_pack_kernel writes them.
// * image_fwd_tc_kernel is csrc/mlp_fwd_tc.cu's tile walk on the image
//   model. Warp-specialised, one persistent block an SM (384 threads):
//   block b takes tiles b, b + grid, b + 2 grid, ... of 128 consecutive
//   pixels (a 400 x 400 frame is 1,250 tiles, ~9.5 a block). One producer
//   thread keeps NSTAGES = 4 stages of the weight ring in flight, each one
//   k-step's hi and lo images landing by one 1-D cp.async.bulk on an
//   mbarrier, over every tile the block takes; the consumers release a
//   stage (8 warps arrive) once their wgmmas on it are done. The producer
//   warpgroup gives its registers to the consumers (setmaxnreg 40 / 232).
// * The dense layers run on wgmma.mma_async m64nWk8 in TF32 (tf32x3.cuh; a
//   width such as 48 or 96 runs as pieces of powers of two). Each of the
//   two consumer warpgroups owns 64 pixels of the tile and all W columns: a
//   thread's accumulator holds 2 pixels x W/4 columns (128 registers at W =
//   256), a whole layer in one accumulator.
// * A comes from registers. The activations stay pixel-major in shared
//   memory ([pixel][feature], row stride W + 8), each layer's output written
//   in place over its input: a warp reads and writes only its own 16
//   pixels, so no barrier is needed between layers. Within a k-step the
//   eight K indices are permuted (lane t takes features 2t and 2t + 1, one
//   64-bit load a row); the encoding is computed straight into the A
//   fragments of layer 0 and of the skip layers from the tile's coordinates
//   in shared memory, so it is never stored.
// * The output head stays on the CUDA cores, in the last trunk layer's
//   epilogue: relu(acc + bias) dotted with the head's rows over a thread's
//   columns, summed across the 4 lanes of a row. A warp's 16 pixels' out_ch
//   floats are staged in shared memory and leave in one coalesced store
//   (48 floats at out_ch = 3). No atomics: two launches give bit-identical
//   output.
//
// Precision: 3xTF32, as csrc/mlp_fwd_tc.cu: each fp32 operand x is split
// into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and lo*hi + hi*lo +
// hi*hi is summed (lo*lo dropped); the tensor cores add with truncation,
// and a whole layer's products stay in one accumulator started from zero
// at the layer's first k-step. This is a forward with no gradient taken
// through its relu decisions, held to the value tolerance (atol 1e-4 +
// rtol 1e-4 of the fp32 plain version) and to the tight one that one TF32
// pass misses (IMAGE_TIGHT, atol = rtol: chip_smoke.py,
// tests/test_torch_image.py). Numerics of the encode as the plain
// version's: sinf (full range reduction, no fast-math) of x*b and of
// x*b + pi/2, each formed with __fmul_rn / __fadd_rn.
//
// Control: IMAGE_FWD_ONE_PASS builds hi*hi alone, one TF32 product where
// the kernel takes three: the lower-precision build that the gpu tests must
// see miss IMAGE_TIGHT.
//
// The TPU kernel's band matrix M [8, SW] with its phase row, the
// zero-extended skip rows and the [N, 8] padded input and output were
// MXU/VMEM layouts and are not carried over.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int TILE = 128;                 // pixels per tile: 64 per consumer warpgroup
constexpr int NCONS = 256;                // consumer threads (warpgroups 0 and 1)
constexpr int NTHREADS = NCONS + 128;     // and the producer warpgroup
constexpr int NSTAGES = 4;                // weight stages in flight
constexpr int CONS_REGS = 232, PROD_REGS = 40;  // 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr int MAX_DEPTH = 20;
constexpr int MAX_SEGS = 2 * MAX_DEPTH;   // input segments: [encoding], [h] a layer
constexpr int MAX_OUT = 4;                // output channels
constexpr int MAX_ENC = 128;              // encoded features
constexpr float HALF_PI = 1.57079632679489662f;
constexpr int MAX_SMEM = 232448;          // bytes a block may use on sm_90

// Shared memory of a block: the weight ring, the activation tile, the
// ring's mbarriers, the tile's coordinates ([pixel][4]), then each warp's
// output staging (16 pixels x 4 floats).
__host__ __device__ constexpr size_t stage_floats(int W) { return (size_t)16 * W; }

__host__ __device__ constexpr size_t act_offset(int W) {
  return sizeof(float) * NSTAGES * stage_floats(W);
}

__host__ __device__ constexpr size_t bar_offset(int W) {
  return act_offset(W) + sizeof(float) * TILE * (W + 8);
}

constexpr size_t smem_bytes(int W) {
  return bar_offset(W) + 2 * NSTAGES * sizeof(uint64_t) + 2 * sizeof(float) * TILE * 4;
}

// k-steps (8 rows of K) of an input segment of `dim` features
__host__ __device__ constexpr int ksteps(int dim) { return (dim + 7) / 8; }

// x rounded to TF32 to nearest, ties away from zero (cvt.rna.tf32.f32)
__device__ __forceinline__ float rna_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// ---------------------------------------------------------------------------
// The weight images
// ---------------------------------------------------------------------------

// One input segment of a layer, `k` of its columns from col0 on: B[r][n] =
// weight[n][col0 + r] for r < k (zero past), n < W (src = weight + col0,
// ld the weight's row stride); ksteps(k) k-steps.
struct Seg {
  const float* src;
  int ld, k;
};

struct PackArgs {
  Seg seg[MAX_SEGS];
  long long off[MAX_SEGS + 1];  // image floats before each segment
  int n_segs, width;
  float* img;
};

// Per k-step of a segment, 16 * W floats: the hi image then the lo image,
// each [K half (2)][W / 8][8 rows of N][4 of K], the K order of a k-step
// permuted (K index q = 4 * half + kk holds row 2 * kk + half of the step)
// so that a lane's two features of a row, 2t and 2t + 1, are one 64-bit
// load of the activations (fused_train.WGMMA_K_ORDER).
__global__ void __launch_bounds__(256) image_fwd_pack_kernel(const __grid_constant__ PackArgs P) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= P.off[P.n_segs]) return;
  int lo = 0, hi = P.n_segs - 1;  // the segment holding i
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (P.off[mid] <= i) lo = mid; else hi = mid - 1;
  }
  const Seg& S = P.seg[lo];
  const int W = P.width;
  const long long e = i - P.off[lo];
  const int per_step = 16 * W;
  const int step = (int)(e / per_step);
  int r = (int)(e - (long long)step * per_step);
  const int half_lo = r >= 8 * W;  // 0: hi image, 1: lo image
  if (half_lo) r -= 8 * W;
  const int kh = r / (4 * W);
  r -= kh * 4 * W;
  const int n = 8 * (r / 32) + (r / 4) % 8;
  const int k = 8 * step + 2 * (r % 4) + kh;
  const float v = k < S.k ? S.src[(size_t)n * S.ld + k] : 0.f;
  const float h = rna_tf32(v);
  P.img[i] = half_lo ? rna_tf32(v - h) : h;
}

// ---------------------------------------------------------------------------
// The tile walk
// ---------------------------------------------------------------------------

struct Args {
  const float* x;                // [N, in_dim]
  const float* img;              // the B images, segment after segment (the pack's)
  const float* bias[MAX_DEPTH];  // the trunk layers' biases
  const float* w_out;            // [out_ch][W]
  const float* b_out;            // [out_ch]
  const float* bands;            // [n_freqs]
  float* out;                    // [N, out_ch]
  long long N;
  int depth, in_dim, n_freqs, include_input, out_ch;
  unsigned skip_mask;            // bit j set: layer j takes [encoded input, h]
};

// Encoded feature f of a pixel with coordinates x[0 .. d-1]: the sines
// (axis-major), the cosines as sin(x*b + pi/2), then the raw input; features
// past the count are zero.
__device__ __forceinline__ float encode_feature(int f, int d, int F, int inc, const float* bands,
                                                const float* x) {
  const int dF = d * F;
  if (f < dF) {
    const int a = f / F, j = f - a * F;
    return sinf(__fmul_rn(x[a], __ldg(bands + j)));
  }
  if (f < 2 * dF) {
    const int g = f - dF, a = g / F, j = g - a * F;
    return sinf(__fadd_rn(__fmul_rn(x[a], __ldg(bands + j)), HALF_PI));
  }
  if (inc && f < 2 * dF + d) return x[f - 2 * dF];
  return 0.f;
}

// The weight ring as one thread walks it: stage and phase parity.
struct Ring {
  float* buf;       // NSTAGES stages of stage_floats(W)
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

// One k-step of a W-column layer for a consumer warpgroup: acc (+)= A * B
// in 3xTF32, A the thread's fragment `a` (rows 16w + g and 16w + g + 8,
// permuted K indices 2t and 2t + 1 as 0..3 and 4..7), B the ring's current
// stage (hi image, then lo image, each 8 x W). The stage is released once
// the products are done.
template <int W>
__device__ __forceinline__ void mma_step(float* acc, Ring& ring, const float (&a)[4], bool first,
                                         int lane) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  const float* B = ring.buf + ring.stage * stage_floats(W);
  const uint64_t dh = wgmma_desc(B, 16 * W, 128);
  mbar_wait(&ring.full[ring.stage], ring.phase);
  __syncwarp();  // the warp converged for the .aligned wgmma instructions
  wgmma_fence();
#ifdef IMAGE_FWD_ONE_PASS
  (void)al;
  wgmma_tf32<W>(acc, ah, dh, first ? 0 : 1);
#else
  const uint64_t dl = wgmma_desc(B + 8 * W, 16 * W, 128);
  wgmma_tf32<W>(acc, al, dh, first ? 0 : 1);
  wgmma_tf32<W>(acc, ah, dl, 1);
  wgmma_tf32<W>(acc, ah, dh, 1);
#endif
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<W / 2>(acc);
  if (lane == 0) mbar_arrive(&ring.empty[ring.stage]);
  ring.advance();
}

// acc = [segment 1, segment 2] * W_layer: n1 k-steps whose fragments come
// from src1(s, a), then n2 from src2(s, a)
template <int W, class Src1, class Src2>
__device__ __forceinline__ void gemm(float* acc, Ring& ring, int n1, Src1 src1, int n2, Src2 src2,
                                     int lane) {
  for (int s = 0; s < n1; ++s) {
    float a[4];
    src1(s, a);
    mma_step<W>(acc, ring, a, s == 0, lane);
  }
  for (int s = 0; s < n2; ++s) {
    float a[4];
    src2(s, a);
    mma_step<W>(acc, ring, a, n1 == 0 && s == 0, lane);
  }
}

// relu(acc + bias) of the thread's two rows, written over the layer's
// input (row0 = the first row's columns 2t, 2t + 1; the second row `row8`
// floats further)
template <int W>
__device__ __forceinline__ void store_rows(const float* acc, const float* bias, float* row0,
                                           int row8, int t) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * t));
    const float2 u = make_float2(fmaxf(acc[4 * j] + b.x, 0.f), fmaxf(acc[4 * j + 1] + b.y, 0.f));
    const float2 v =
        make_float2(fmaxf(acc[4 * j + 2] + b.x, 0.f), fmaxf(acc[4 * j + 3] + b.y, 0.f));
    *reinterpret_cast<float2*>(row0 + 8 * j) = u;
    *reinterpret_cast<float2*>(row0 + row8 + 8 * j) = v;
  }
}

// sum of v over the 4 lanes of a row (t = lane % 4)
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int W>
__global__ void __launch_bounds__(NTHREADS, 1) image_fwd_tc_kernel(const __grid_constant__ Args A) {
  constexpr int LDA = W + 8;  // 8 or 24 mod 32: the 64-bit loads and stores of a half-warp hit 32 banks
  extern __shared__ __align__(128) unsigned char smem[];
  const long long N = A.N;
  const int ntiles = (int)((N + TILE - 1) / TILE);

  Ring ring;
  ring.buf = reinterpret_cast<float*>(smem);
  float* act = reinterpret_cast<float*>(smem + act_offset(W));  // [TILE][LDA]
  ring.full = reinterpret_cast<uint64_t*>(smem + bar_offset(W));
  ring.empty = ring.full + NSTAGES;
  float* xs = reinterpret_cast<float*>(ring.empty + NSTAGES);  // [TILE][4]: coordinates
  float* ostage = xs + TILE * 4;                               // [8 warps][16 pixels x out_ch]

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < NSTAGES; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], NCONS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int D = A.depth, d = A.in_dim, F = A.n_freqs, inc = A.include_input, oc = A.out_ch;
  const int enc_steps = ksteps(2 * d * F + (inc ? d : 0));

  if (tid >= NCONS) {
    // ---- producer: the weight stages of every tile, in the consumers' order ----
    regs_lower<PROD_REGS>();
    if (tid == NCONS) {
      int steps = enc_steps;  // layer 0
      for (int j = 1; j < D; ++j) steps += W / 8 + (((A.skip_mask >> j) & 1u) ? enc_steps : 0);
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const float* src = A.img;
        for (int i = 0; i < steps; ++i) {
          mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1u);
          mbar_arrive_expect_tx(&ring.full[ring.stage], 64 * W);
          bulk_copy_g2s(ring.buf + ring.stage * stage_floats(W), src, 64 * W,
                        &ring.full[ring.stage]);
          src += 16 * W;
          ring.advance();
        }
      }
    }
    return;
  }

  // ---- consumers: warp w (0..7) owns pixels 16 w .. 16 w + 15 of a tile ----
  regs_raise<CONS_REGS>();
  const int lane = tid & 31, g = lane >> 2, t = lane & 3, warp = tid >> 5;
  const int row = 16 * warp + g;  // and row + 8
  float* arow = act + row * LDA + 2 * t;
  const float* x0 = xs + row * 4;  // the thread's two pixels' coordinates
  const float* x1 = x0 + 32;
  float* ost = ostage + warp * 16 * MAX_OUT;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * TILE + 16 * warp;  // the warp's first pixel
    // the warp's 16 pixels' coordinates: 16 d consecutive floats, coalesced
    for (int e = lane; e < 16 * d; e += 32) {
      const int r = e / d;
      xs[(16 * warp + r) * 4 + e - r * d] = p0 + r < N ? A.x[p0 * d + e] : 0.f;
    }
    __syncwarp();
    auto enc = [&](int s, float (&a)[4]) {
      const int f = 8 * s + 2 * t;
      a[0] = encode_feature(f, d, F, inc, A.bands, x0);
      a[1] = encode_feature(f, d, F, inc, A.bands, x1);
      a[2] = encode_feature(f + 1, d, F, inc, A.bands, x0);
      a[3] = encode_feature(f + 1, d, F, inc, A.bands, x1);
    };
    auto from_act = [&](int s, float (&a)[4]) {
      const float2 p = *reinterpret_cast<const float2*>(arow + 8 * s);
      const float2 q = *reinterpret_cast<const float2*>(arow + 8 * LDA + 8 * s);
      a[0] = p.x; a[1] = q.x; a[2] = p.y; a[3] = q.y;
    };

    // ---- the trunk: layer 0 on the encoding, then D - 1 layers ----
    float acc[W / 2];
    for (int j = 0; j < D; ++j) {
      if (j == 0)
        gemm<W>(acc, ring, enc_steps, enc, 0, from_act, lane);
      else if ((A.skip_mask >> j) & 1u)
        gemm<W>(acc, ring, enc_steps, enc, W / 8, from_act, lane);
      else
        gemm<W>(acc, ring, W / 8, from_act, 0, from_act, lane);
      if (j + 1 < D) {
        store_rows<W>(acc, A.bias[j], arow, 8 * LDA, t);
        __syncwarp();
      }
    }
    // ---- the output head (W -> out_ch) on the last layer's relu(acc + bias) ----
    {
      const float* bl = A.bias[D - 1];
      float s0[MAX_OUT] = {0.f, 0.f, 0.f, 0.f}, s1[MAX_OUT] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 b = __ldg(reinterpret_cast<const float2*>(bl + col));
        const float h00 = fmaxf(acc[4 * j] + b.x, 0.f), h01 = fmaxf(acc[4 * j + 1] + b.y, 0.f);
        const float h10 = fmaxf(acc[4 * j + 2] + b.x, 0.f), h11 = fmaxf(acc[4 * j + 3] + b.y, 0.f);
#pragma unroll
        for (int c = 0; c < MAX_OUT; ++c) {
          if (c < oc) {
            const float2 w = __ldg(reinterpret_cast<const float2*>(A.w_out + c * W + col));
            s0[c] = fmaf(h01, w.y, fmaf(h00, w.x, s0[c]));
            s1[c] = fmaf(h11, w.y, fmaf(h10, w.x, s1[c]));
          }
        }
      }
#pragma unroll
      for (int c = 0; c < MAX_OUT; ++c) {
        s0[c] = row_sum(s0[c]);
        s1[c] = row_sum(s1[c]);
      }
      // lane t = 0 stages its row g's out_ch floats, lane t = 1 its row g + 8's
#pragma unroll
      for (int c = 0; c < MAX_OUT; ++c) {
        if (c < oc && t < 2)
          ost[(g + 8 * t) * oc + c] = (t == 0 ? s0[c] : s1[c]) + __ldg(A.b_out + c);
      }
      __syncwarp();
      for (int e = lane; e < 16 * oc; e += 32)
        if (p0 + e / oc < N) A.out[p0 * oc + e] = ost[e];
      __syncwarp();
    }
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

}  // namespace

// Shared-memory bytes one block of the tile walk needs (0 if the width is
// not supported); lets the wrapper check a shape before launching.
extern "C" long long image_fwd_tc_smem_bytes(int width) {
  if (!width_ok(width)) return 0;
  return (long long)smem_bytes(width);
}

// One call: out [N, out_ch]. weights / biases: host arrays of the depth + 1
// nn.Linear tensors' device pointers in mlp.linears() order (the trunk
// layers, then the output head); segs: the wrapper's segment table, 4 ints
// a segment (linear, first column, row stride, columns), in the order the
// tile walk streams them: layer 0's encoding, then per layer j > 0 its
// encoding when j is a skip layer and its h; img: img_floats floats of
// device scratch that the pack launch writes (16 * width floats a k-step).
// Launches the pack and the tile walk (at most `blocks` blocks) on
// `stream`; returns the first cudaError_t.
extern "C" int image_fwd_tc_launch(const float* x, const float* const* weights,
                                   const float* const* biases, const float* bands,
                                   const int* segs, int n_segs, float* img, long long img_floats,
                                   float* out, long long N, int blocks, int depth, int width,
                                   unsigned skip_mask, int in_dim, int n_freqs, int include_input,
                                   int out_ch, void* stream) {
  if (N == 0) return 0;
  const int W = width, D = depth;
  const int P = 2 * in_dim * n_freqs + (include_input ? in_dim : 0);
  if (N < 0 || blocks <= 0 || D < 1 || D > MAX_DEPTH || !width_ok(W) || (skip_mask & 1u) != 0 ||
      (skip_mask >> D) != 0 || in_dim < 1 || in_dim > 3 || n_freqs < 0 || out_ch < 1 ||
      out_ch > MAX_OUT || P < 1 || P > MAX_ENC || n_segs < 1 || n_segs > MAX_SEGS)
    return (int)cudaErrorInvalidValue;
  // the segment table must be the tile walk's: (linear, col0, ld, k) of
  // layer 0's [encoding], then [encoding] (skip layers) and [h] a layer
  PackArgs pk{};
  pk.n_segs = n_segs;
  pk.width = W;
  pk.off[0] = 0;
  int q = 0;
  auto add = [&](int lin, int col0, int ld, int k) {
    if (q >= n_segs) return false;
    const int* s = segs + 4 * q;
    if (s[0] != lin || s[1] != col0 || s[2] != ld || s[3] != k) return false;
    pk.seg[q].src = weights[lin] + col0;
    pk.seg[q].ld = ld;
    pk.seg[q].k = k;
    pk.off[q + 1] = pk.off[q] + (long long)ksteps(k) * 16 * W;
    ++q;
    return true;
  };
  bool ok = add(0, 0, P, P);
  for (int j = 1; j < D && ok; ++j) {
    if ((skip_mask >> j) & 1u)
      ok = add(j, 0, P + W, P) && add(j, P, P + W, W);
    else
      ok = add(j, 0, W, W);
  }
  if (!ok || q != n_segs || pk.off[q] != img_floats) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(W);
  void (*kernel)(Args) = PICK_WIDTH(image_fwd_tc_kernel, W);
  if (kernel == nullptr || smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  // 1. the weight images
  pk.img = img;
  image_fwd_pack_kernel<<<(unsigned)((img_floats + 255) / 256), 256, 0, st>>>(pk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 2. the tile walk
  Args a{};
  a.x = x; a.img = img;
  for (int j = 0; j < D; ++j) a.bias[j] = biases[j];
  a.w_out = weights[D]; a.b_out = biases[D]; a.bands = bands; a.out = out;
  a.N = N; a.depth = D; a.in_dim = in_dim; a.n_freqs = n_freqs;
  a.include_input = include_input; a.out_ch = out_ch; a.skip_mask = skip_mask;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (N + TILE - 1) / TILE;
  const unsigned grid = (unsigned)(tiles < blocks ? tiles : blocks);
  kernel<<<grid, NTHREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}
