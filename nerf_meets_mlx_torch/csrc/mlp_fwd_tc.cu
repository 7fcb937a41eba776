// Fused point-major sinusoidal encode + NeRF MLP forward for Hopper
// (sm_90a): the dense layers on wgmma in 3xTF32.
//
// Replaces nerf_meets_mlx_tpu/kernels/fused_mlp.py::_fwd_kernel (pallas_call
// at :523), the forward of fused_apply. One launch takes points [N,3] and
// view directions [N,3], one of each per point, and writes the raw network
// output raw [N,4] (rgb, then sigma, un-activated):
//
//   sinusoidal encode of the point and the direction
//   ->  D x W MLP with the skips, the alpha head and the view-direction head.
//
// Shapes: widths that are multiples of 16 from 32 to 256, depth 1..17 with
// any skips, any bands with or without the raw input, any N (a ragged last
// tile is computed on zero points and masked on the way out). The backward
// stays in csrc/fused_mlp.cu and recomputes its own forward in fp32.
//
// What bounds it: the tensor cores. At lego width (D = 8, W = 256, skip
// after layer 4, 10 / 4 bands with the raw input) a point costs 593,280
// MACs in the dense layers (1.19 MFLOP), against 24 bytes of input and 16
// of output; in 3xTF32 (below) that is three tensor-core products per MAC:
// 3 x 0.311 TFLOP / 495 TFLOP/s = 1.89 ms for the 262,144 points of a 64^3
// occupancy-grid update, 2.83 ms for a step's 4096 x 96 fine points. The
// weights (2.37 MB in fp32, 4.74 MB as TF32 hi and lo images) stay in L2
// and are streamed through shared memory once per tile of TILE = 128
// points.
//
// Design: csrc/fused_eval.cu's tile walk (the same network, the same
// weight images, the same products), point-major and without compositing.
// * Warp-specialised, one persistent block an SM (384 threads): block b
//   takes tiles b, b + grid, b + 2 grid, ... of 128 consecutive points.
// * The dense layers run on the tensor cores: wgmma.mma_async m64nNk8 in
//   TF32 (tf32x3.cuh), N = W for the trunk and the feature layer, W/2 for
//   the view layer (a width such as 48 runs its 24 columns as n16 + n8).
//   Each of the two consumer warpgroups owns 64 points of the tile and all
//   N columns: a thread's accumulator holds 2 points x N/4 columns (128
//   registers at W = 256).
// * B is the layer's weight, K-major (W^T), read from shared memory by
//   descriptor: per k-step of 8 rows of K, the exact shared-memory image of
//   its TF32 hi and lo halves (fused_train.pack_eval_wgmma, packed on the
//   device once per call). Each stage of the weight ring is one contiguous
//   1-D cp.async.bulk that completes on an mbarrier: one producer thread
//   keeps NSTAGES = 4 stages in flight, over every tile the block takes,
//   and the consumers release a stage (8 warps arrive) once their wgmmas on
//   it are done. The producer warpgroup gives its registers to the
//   consumers (setmaxnreg 40 / 232: without it the W = 256 build of
//   fused_eval.cu spills and runs at half the speed).
// * A comes from registers. The activations stay point-major in shared
//   memory ([point][feature], row stride W + 8), each layer's output
//   written in place over its input: a warp reads and writes only its own
//   16 points, so no barrier is needed between layers. Within a k-step the
//   eight K indices are permuted (lane t takes features 2t and 2t + 1, one
//   64-bit load a row; the packed B rows follow the same order), and the
//   encodings are computed straight into the A fragments (sinf of the
//   position bands at the input and skip layers, of the direction bands at
//   the view layer), so neither is stored; the tile's points and
//   directions sit in shared memory beside the activations.
// * The narrow heads stay on the CUDA cores, in the epilogues: the alpha
//   head (W -> 1) from the last trunk layer's rows as just stored, and the
//   rgb head (W/2 -> 3) from the view layer's accumulator, each a dot
//   product over a thread's columns summed across the 4 lanes of a row;
//   sigma waits in the point's shared-memory row until its rgb is done,
//   and the point's raw leaves as one 16-byte store. No atomics: two
//   launches give bit-identical results.
//
// Precision: 3xTF32, as csrc/fused_eval.cu: each fp32 operand x is split
// into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and lo*hi + hi*lo +
// hi*hi is summed (lo*lo dropped). The tensor cores add with truncation.
// A whole layer's products stay in one accumulator, started from zero at
// the layer's first k-step (the eval kernels' form), not k-steps summed
// from zero and added in fp32 (the train kernels' form): this is a
// forward, whose values feed the occupancy grid and a loss, held to the
// value tolerance (atol 1e-4 + rtol 1e-4 of the fp32 plain version) and to
// the tight one that one TF32 pass misses (MLP_TIGHT, atol = rtol = 5e-6:
// chip_smoke.py, tests/test_torch_fused_mlp.py); no gradient is taken
// through its relu decisions (the backward kernel recomputes its own
// forward). A decision can differ from the fp32
// plain version's only where a pre-activation lies within the products'
// error of 0, and then the unit's output is that small either way: relu is
// continuous, so a flip moves no value by more than the error itself
// (tests/test_torch_fused_mlp.py counts the flips and holds the values).
// Numerics of the encode as fused_eval.cu: the phases reach ~3000 rad, so
// sinf (full range reduction, no fast-math) on x*b and x*b + pi/2 formed
// with __fmul_rn / __fadd_rn, rounding twice as the plain version does.
//
// Control: MLP_FWD_ONE_PASS builds hi*hi alone, one TF32 product where the
// kernel takes three: the lower-precision build that the gpu tests must see
// miss MLP_TIGHT.
//
// The TPU kernel's 128-lane packed tile, its band matrix M and its [N,8]
// padded input and output were MXU/VMEM layouts and are not carried over.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int TILE = 128;                 // points per tile: 64 per consumer warpgroup
constexpr int NCONS = 256;                // consumer threads (warpgroups 0 and 1)
constexpr int NTHREADS = NCONS + 128;     // and the producer warpgroup
constexpr int NSTAGES = 4;                // weight stages in flight
constexpr int CONS_REGS = 232, PROD_REGS = 40;  // 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr int MAX_OFFS = 44;              // 2 * depth + 10 weight-buffer offsets, depth <= 17
constexpr float HALF_PI = 1.57079632679489662f;
constexpr int MAX_SMEM = 232448;          // bytes a block may use on sm_90

struct Args {
  const float* pts;       // [N, 3]
  const float* dirs;      // [N, 3]
  const float* wimg;      // the dense layers' B images, k-step after k-step (pack_eval_wgmma)
  const float* wbuf;      // biases, heads and bands (16-byte aligned pieces)
  float* raw;             // [N, 4]: rgb, sigma
  long long N;
  int depth;
  unsigned skip_mask;     // bit j set: layer j takes [encoded position, h]
  int pos_freqs, pos_inc, dir_freqs, dir_inc;
  int offs[MAX_OFFS];     // float offsets into wbuf, see fused_train.pack_eval_weights
};

// Shared memory of a block: the weight ring, the activation tile, the
// ring's mbarriers, then the tile's points (position, view direction and
// sigma, 8 floats a row).
__host__ __device__ constexpr size_t stage_floats(int W) { return (size_t)16 * W; }

__host__ __device__ constexpr size_t act_offset(int W) {
  return sizeof(float) * NSTAGES * stage_floats(W);
}

__host__ __device__ constexpr size_t bar_offset(int W) {
  return act_offset(W) + sizeof(float) * TILE * (W + 8);
}

constexpr size_t smem_bytes(int W) {
  return bar_offset(W) + 2 * NSTAGES * sizeof(uint64_t) + sizeof(float) * TILE * 8;
}

// k-steps (8 rows of K) of an input segment of `dim` features
__host__ __device__ constexpr int ksteps(int dim) { return (dim + 7) / 8; }

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

// One k-step of an N-column layer for a consumer warpgroup: acc (+)= A * B
// in 3xTF32, A the thread's fragment `a` (rows 16w + g and 16w + g + 8,
// permuted K indices 2t and 2t + 1 as 0..3 and 4..7), B the ring's current
// stage (hi image, then lo image, each 8 x N). The stage is released once
// the products are done.
template <int N, int W>
__device__ __forceinline__ void mma_step(float* acc, Ring& ring, const float (&a)[4], bool first,
                                         int lane) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  const float* B = ring.buf + ring.stage * stage_floats(W);
  const uint64_t dh = wgmma_desc(B, 16 * N, 128);
  mbar_wait(&ring.full[ring.stage], ring.phase);
  __syncwarp();  // the warp converged for the .aligned wgmma instructions
  wgmma_fence();
#ifdef MLP_FWD_ONE_PASS
  (void)al;
  wgmma_tf32<N>(acc, ah, dh, first ? 0 : 1);
#else
  const uint64_t dl = wgmma_desc(B + 8 * N, 16 * N, 128);
  wgmma_tf32<N>(acc, al, dh, first ? 0 : 1);
  wgmma_tf32<N>(acc, ah, dl, 1);
  wgmma_tf32<N>(acc, ah, dh, 1);
#endif
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<N / 2>(acc);
  if (lane == 0) mbar_arrive(&ring.empty[ring.stage]);
  ring.advance();
}

// acc = [segment 1, segment 2] * W_layer: n1 k-steps whose fragments come
// from src1(s, a), then n2 from src2(s, a)
template <int N, int W, class Src1, class Src2>
__device__ __forceinline__ void gemm(float* acc, Ring& ring, int n1, Src1 src1, int n2, Src2 src2,
                                     int lane) {
  for (int s = 0; s < n1; ++s) {
    float a[4];
    src1(s, a);
    mma_step<N, W>(acc, ring, a, s == 0, lane);
  }
  for (int s = 0; s < n2; ++s) {
    float a[4];
    src2(s, a);
    mma_step<N, W>(acc, ring, a, n1 == 0 && s == 0, lane);
  }
}

// act(b + acc) of the thread's two rows, written over the layer's input
// (row0 = the first row's columns 2t, 2t + 1; the second row `row8`
// floats further)
template <int N>
__device__ __forceinline__ void store_rows(const float* acc, const float* bias, float* row0,
                                           int row8, int t, bool relu) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * t));
    float2 u = make_float2(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
    float2 v = make_float2(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
    if (relu) {
      u.x = fmaxf(u.x, 0.f); u.y = fmaxf(u.y, 0.f);
      v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
    }
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
__global__ void __launch_bounds__(NTHREADS, 1) mlp_fwd_tc_kernel(const __grid_constant__ Args A) {
  constexpr int LDA = W + 8;  // 8 or 24 mod 32: the 64-bit loads and stores of a half-warp hit 32 banks
  extern __shared__ __align__(128) unsigned char smem[];
  const long long N = A.N;
  const int ntiles = (int)((N + TILE - 1) / TILE);

  Ring ring;
  ring.buf = reinterpret_cast<float*>(smem);
  float* act = reinterpret_cast<float*>(smem + act_offset(W));  // [TILE][LDA]
  ring.full = reinterpret_cast<uint64_t*>(smem + bar_offset(W));
  ring.empty = ring.full + NSTAGES;
  float* tpts = reinterpret_cast<float*>(ring.empty + NSTAGES);  // [TILE][8]: x, view dir, sigma

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
    // ---- producer: the weight stages of every tile, in the consumers' order ----
    regs_lower<PROD_REGS>();
    if (tid == NCONS) {
      int steps = pos_steps + W / 8 + W / 8 + dir_steps;  // layer 0, feature, view
      for (int j = 1; j < D; ++j) steps += W / 8 + (((A.skip_mask >> j) & 1u) ? pos_steps : 0);
      const int view_from = steps - (W / 8 + dir_steps);
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const float* src = A.wimg;
        for (int i = 0; i < steps; ++i) {
          const int n = i < view_from ? W : W / 2;
          mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1u);
          mbar_arrive_expect_tx(&ring.full[ring.stage], 64 * n);
          bulk_copy_g2s(ring.buf + ring.stage * stage_floats(W), src, 64 * n,
                        &ring.full[ring.stage]);
          src += 16 * n;
          ring.advance();
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
  const float* wb = A.wbuf;
  const float* pos_bands = wb + A.offs[2 * D + 8];
  const float* dir_bands = wb + A.offs[2 * D + 9];
  // the thread's two points (rows row and row + 8 of the tile), kept in
  // shared memory rather than in registers beside the accumulator
  float* p0 = tpts + row * 8;
  float* p1 = p0 + 64;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long i0 = (long long)tile * TILE + row, i1 = i0 + 8;
    if (t == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long i = e == 0 ? i0 : i1;
        float xv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (i < N) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            xv[c] = A.pts[i * 3 + c];
            xv[3 + c] = A.dirs[i * 3 + c];
          }
        }
        float* p = e == 0 ? p0 : p1;
#pragma unroll
        for (int c = 0; c < 6; ++c) p[c] = xv[c];
      }
    }
    __syncwarp();
    auto enc_pos = [&](int s, float (&a)[4]) {
      const int f = 8 * s + 2 * t;
      a[0] = encode_feature(f, A.pos_freqs, A.pos_inc, pos_bands, p0);
      a[1] = encode_feature(f, A.pos_freqs, A.pos_inc, pos_bands, p1);
      a[2] = encode_feature(f + 1, A.pos_freqs, A.pos_inc, pos_bands, p0);
      a[3] = encode_feature(f + 1, A.pos_freqs, A.pos_inc, pos_bands, p1);
    };
    auto enc_dir = [&](int s, float (&a)[4]) {
      const int f = 8 * s + 2 * t;
      a[0] = encode_feature(f, A.dir_freqs, A.dir_inc, dir_bands, p0 + 3);
      a[1] = encode_feature(f, A.dir_freqs, A.dir_inc, dir_bands, p1 + 3);
      a[2] = encode_feature(f + 1, A.dir_freqs, A.dir_inc, dir_bands, p0 + 3);
      a[3] = encode_feature(f + 1, A.dir_freqs, A.dir_inc, dir_bands, p1 + 3);
    };
    auto from_act = [&](int s, float (&a)[4]) {
      const float2 p = *reinterpret_cast<const float2*>(arow + 8 * s);
      const float2 q = *reinterpret_cast<const float2*>(arow + 8 * LDA + 8 * s);
      a[0] = p.x; a[1] = q.x; a[2] = p.y; a[3] = q.y;
    };

    // ---- the trunk: layer 0 on the encoded position, then D - 1 layers ----
    float acc[W / 2];
    for (int j = 0; j < D; ++j) {
      if (j == 0)
        gemm<W, W>(acc, ring, pos_steps, enc_pos, 0, from_act, lane);
      else if ((A.skip_mask >> j) & 1u)
        gemm<W, W>(acc, ring, pos_steps, enc_pos, W / 8, from_act, lane);
      else
        gemm<W, W>(acc, ring, W / 8, from_act, 0, from_act, lane);
      store_rows<W>(acc, wb + A.offs[2 * j + 1], arow, 8 * LDA, t, true);
      __syncwarp();
    }
    // alpha head (W -> 1) on the last hidden layer, read back from the rows
    // just stored (post-relu); sigma waits in the point's row
    {
      const float* wa = wb + A.offs[2 * D];
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
      for (int j = 0; j < W / 8; ++j) {
        const float2 w = __ldg(reinterpret_cast<const float2*>(wa + 8 * j + 2 * t));
        const float2 h0 = *reinterpret_cast<const float2*>(arow + 8 * j);
        const float2 h1 = *reinterpret_cast<const float2*>(arow + 8 * LDA + 8 * j);
        s0 = fmaf(h0.y, w.y, fmaf(h0.x, w.x, s0));
        s1 = fmaf(h1.y, w.y, fmaf(h1.x, w.x, s1));
      }
      s0 = row_sum(s0);
      s1 = row_sum(s1);
      const float ba = __ldg(wb + A.offs[2 * D + 1]);
      if (t == 0) p0[6] = s0 + ba;
      if (t == 1) p1[6] = s1 + ba;
    }
    __syncwarp();
    // feature (W -> W, no activation)
    gemm<W, W>(acc, ring, W / 8, from_act, 0, from_act, lane);
    store_rows<W>(acc, wb + A.offs[2 * D + 3], arow, 8 * LDA, t, false);
    __syncwarp();
    // view layer on [feature, encoded direction] (W + dir_dim -> W/2, relu),
    // then the rgb head (W/2 -> 3) from its accumulator
    {
      float acc2[W / 4];
      gemm<W / 2, W>(acc2, ring, W / 8, from_act, dir_steps, enc_dir, lane);
      const float* bv = wb + A.offs[2 * D + 5];
      const float* wr = wb + A.offs[2 * D + 6];  // [W/2][3]
      float c0[3] = {0.f, 0.f, 0.f}, c1[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < W / 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const float b = __ldg(bv + col);
          const float h0 = fmaxf(acc2[4 * j + e] + b, 0.f);
          const float h1 = fmaxf(acc2[4 * j + 2 + e] + b, 0.f);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float w = __ldg(wr + 3 * col + c);
            c0[c] = fmaf(h0, w, c0[c]);
            c1[c] = fmaf(h1, w, c1[c]);
          }
        }
      }
      const float* br = wb + A.offs[2 * D + 7];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        c0[c] = row_sum(c0[c]);
        c1[c] = row_sum(c1[c]);
      }
      if (t == 0 && i0 < N)
        *reinterpret_cast<float4*>(A.raw + i0 * 4) =
            make_float4(c0[0] + __ldg(br), c0[1] + __ldg(br + 1), c0[2] + __ldg(br + 2), p0[6]);
      if (t == 1 && i1 < N)
        *reinterpret_cast<float4*>(A.raw + i1 * 4) =
            make_float4(c1[0] + __ldg(br), c1[1] + __ldg(br + 1), c1[2] + __ldg(br + 2), p1[6]);
    }
    __syncwarp();
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

// Shared-memory bytes one block of the launch below needs (0 if the width
// is not supported); lets the wrapper check a shape before launching.
extern "C" long long mlp_fwd_tc_smem_bytes(int width) {
  if (!width_ok(width)) return 0;
  return (long long)smem_bytes(width);
}

// Floats of the B images pack_eval_wgmma writes for this MLP: per dense
// layer (trunk, feature, view) its k-steps of 8 rows x N columns x (hi, lo).
extern "C" long long mlp_fwd_tc_image_floats(int depth, int width, unsigned skip_mask,
                                             int pos_dim, int dir_dim) {
  long long steps = ksteps(pos_dim) + width / 8;  // layer 0, feature
  for (int j = 1; j < depth; ++j) steps += width / 8 + (((skip_mask >> j) & 1u) ? ksteps(pos_dim) : 0);
  return steps * 16 * width + (long long)(width / 8 + ksteps(dir_dim)) * 16 * (width / 2);
}

// Launches the kernel on `stream` with at most `blocks` blocks (the
// device's SMs); offs: the 2 * depth + 10 float offsets of
// pack_eval_weights' buffer (host array). Returns the cudaError_t of the
// launch.
extern "C" int mlp_fwd_tc_launch(const float* pts, const float* dirs, const float* wimg,
                                 const float* wbuf, const int* offs, int n_offs, float* raw,
                                 long long N, int blocks, int depth, int width,
                                 unsigned skip_mask, int pos_freqs, int pos_inc, int dir_freqs,
                                 int dir_inc, void* stream) {
  if (N == 0) return 0;
  if (N < 0 || blocks <= 0 || depth <= 0 || n_offs != 2 * depth + 10 || n_offs > MAX_OFFS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(width);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  void (*kernel)(Args) = PICK_WIDTH(mlp_fwd_tc_kernel, width);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Args a{};
  a.pts = pts; a.dirs = dirs; a.wimg = wimg; a.wbuf = wbuf; a.raw = raw;
  a.N = N; a.depth = depth; a.skip_mask = skip_mask;
  a.pos_freqs = pos_freqs; a.pos_inc = pos_inc; a.dir_freqs = dir_freqs; a.dir_inc = dir_inc;
  for (int i = 0; i < n_offs; ++i) a.offs[i] = offs[i];
  const long long tiles = (N + TILE - 1) / TILE;
  const unsigned grid = (unsigned)(tiles < blocks ? tiles : blocks);
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
