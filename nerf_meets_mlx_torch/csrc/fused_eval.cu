// Forward-only fused NeRF eval kernel for Hopper (sm_90a).
//
// Replaces nerf_meets_mlx_tpu/kernels/fused_train.py::_eval_kernel (the
// Pallas kernel of fused_eval_apply). Per level of the hierarchical render,
// one launch takes rays (origin, direction, view direction), sample depths
// z [R,S] and deltas [R,S] (already scaled by |d|, terminal bin 1e10*|d|)
// and writes the composited colour rgb [R,3] and the sample weights
// weights [R,S]:
//
//   pts = o + z*d  ->  sinusoidal encode of pts and view direction
//   ->  D x W MLP with the skip and the view-direction head
//   ->  alpha / transmittance in "canonical" or "reference" mode
//   ->  weights = alpha * T, rgb = sum(weights * c) (+ white background).
//
// What bounds it: the tensor cores. At the lego_hierarchical shapes (D=8,
// W=256, skip after layer 4, 10 position bands and 4 direction bands, both
// with the raw input) the MLP costs
//   63*256 + 4*256^2 + 319*256 + 2*256^2 + 256 + 256^2 + 283*128 + 128*3
//   = 593,280 MACs = 1.19 MFLOP per point,
// 2.49 TFLOP for a 32,768-ray chunk at 64 samples, against ~1 KB of ray
// input and output per ray. In 3xTF32 (below) that is three tensor-core
// products per MAC: 3 x 2.49 / 495 TFLOP/s = 15.1 ms a coarse launch, 45.2
// ms a fine one (x 192 samples). The weights (2.37 MB in fp32, 4.74 MB as
// TF32 hi and lo halves) stay in L2 and are streamed through shared memory
// once per tile of TILE = 128 points: 77.8 GB from L2 a coarse launch.
// What holds it back (tools/eval_kernel_probe.py, on an H100 whose wgmma
// reaches ~480 TFLOP/s in TF32): not the L2 (a launch whose weights never
// leave it is within 2%), but the work around the wgmmas -- fragment
// loads and splits, encodes, barriers, epilogues -- which alone takes half
// of a launch's time and overlaps the tensor cores only in part.
//
// Design: warp-specialised, one block an SM (384 threads).
// * The dense layers run on the tensor cores: wgmma.mma_async m64nNk8 in
//   TF32 (tf32x3.cuh), N = W for the trunk and the feature layer, W/2 for
//   the view layer (a width such as 48 runs its 24 columns as n16 + n8).
//   Each of the two consumer warpgroups owns 64 points of the tile and all
//   N columns: a thread's accumulator holds 2 points x N/4 columns (128
//   registers at W = 256).
// * B is the layer's weight, K-major (W^T), read from shared memory by
//   descriptor. The wrapper packs it once per launch on the device
//   (fused_train.pack_eval_wgmma): per k-step of 8 rows of K, the exact
//   shared-memory image of the TF32 hi and lo halves (core matrices of
//   8 columns x 4 K, no swizzle). So each stage of the weight ring is one
//   contiguous 1-D cp.async.bulk that completes on an mbarrier: one
//   producer thread keeps NSTAGES = 4 stages (16 KB each at W = 256) in
//   flight, and the consumers release a stage (8 warps arrive) once their
//   wgmmas on it are done. The producer warpgroup gives its registers to
//   the consumers (setmaxnreg 40 / 232): without it the W = 256 build
//   spills over a kilobyte a thread and runs at half the speed.
// * Each warpgroup waits for its k-step's products before it prepares the
//   next; the two warpgroups' groups alternate on the tensor cores. (One
//   group kept in flight per warpgroup, with two A register sets, and two
//   k-steps a group both measured slower on the card: PERF.md.)
// * A comes from registers. The activations stay point-major in shared
//   memory ([point][feature], row stride W + 8), each layer's output
//   written in place over its input: a warp reads and writes only its own
//   16 points, so no barrier is needed between layers. Within a k-step the
//   eight K indices are permuted (lane t takes features 2t and 2t + 1, one
//   64-bit load a row; the packed B rows follow the same order), and the
//   encodings are computed straight into the A fragments (sinf of the
//   position and direction bands at the input layer, the skip layer and
//   the view layer), so neither is stored; the tile's points themselves sit
//   in shared memory, since at W = 256 the consumers need nearly all of
//   their 232 registers (128 of them the accumulator). Each thread splits
//   its fragment once into hi and lo (split_tf32), and the split feeds all
//   N columns.
// * The narrow jobs stay on the CUDA cores, inside the epilogues: the
//   alpha head (W -> 1) from the last trunk layer's rows as just stored,
//   and the rgb head (W/2 -> 3) from the view layer's accumulator, each a
//   dot product over a thread's columns summed across the 4 lanes of a
//   row; then, after the last tile, the per-point compositing terms and
//   one thread per ray for the sequential exclusive scan, in the same
//   order as the plain version's cumsum. No atomics: two launches give
//   bit-identical results.
//
// Precision: 3xTF32, as csrc/fused_train.cu: each fp32 operand x is split
// into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and lo*hi + hi*lo +
// hi*hi is summed (lo*lo dropped). The tensor cores add with truncation.
// Here a whole layer's products stay in one accumulator, started from zero
// at the layer's first k-step: a value within the eval's tolerance (atol
// 1e-4 + rtol 1e-4 of the fp32 plain version) needs no per-k-step fp32
// sums, which the train kernel's dW does (relu flips). The CPU emulation
// (tests/test_torch_fused_eval.py, every wgmma's add truncated) holds it
// at lego_hierarchical's 8 x 256 and both levels, one TF32 pass further
// off; on an H100 the kernel is within 1.1e-6 of the plain version
// (chip_smoke.py). Numerics of the encode: the phases reach ~3000
// rad, so it uses sinf (full range reduction, no fast-math) and forms x*b
// and x*b + pi/2 with __fmul_rn/__fadd_rn, rounding twice as the plain
// version does; the cosines are sin(x*b + pi/2) as in the JAX package.
//
// The TPU kernel's 128-lane packed band matrix, its U/E selector GEMMs and
// its [S,S] scan matrix were MXU/VMEM workarounds and are not carried over.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int TILE = 128;                 // points per tile: 64 per consumer warpgroup
constexpr int NCONS = 256;                // consumer threads (warpgroups 0 and 1)
constexpr int NTHREADS = NCONS + 128;     // and the producer warpgroup
constexpr int NSTAGES = 4;                // weight stages in flight
constexpr int CONS_REGS = 232, PROD_REGS = 40;  // 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr float HALF_PI = 1.57079632679489662f;
constexpr int MAX_SMEM = 232448;          // bytes a block may use on sm_90

struct Args {
  const float* rays_o;    // [R, 3]
  const float* rays_d;    // [R, 3]
  const float* viewdirs;  // [R, 3]
  const float* z;         // [R, S]
  const float* deltas;    // [R, S]
  const float* wimg;      // the dense layers' B images, k-step after k-step (pack_eval_wgmma)
  const float* wbuf;      // biases, heads and bands (16-byte aligned pieces)
  const int* offs;        // float offsets into wbuf, see fused_train.pack_eval_weights
  float* rgb;             // [R, 3]
  float* weights;         // [R, S]
  int R, S, rays_block, depth;
  unsigned skip_mask;     // bit j set: layer j takes [encoded position, h]
  int pos_freqs, pos_inc, dir_freqs, dir_inc;
  int mode;               // 0 canonical, 1 reference
  int relu_density;       // canonical: 0 softplus, 1 relu
  int white_bkgd;
};

// Shared memory of a block: the weight ring, the activation tile, the
// ring's mbarriers, the tile's points (position and view direction, 8
// floats a row), then (rgb, q, alpha) of each of the block's points.
__host__ __device__ constexpr size_t stage_floats(int W) { return (size_t)16 * W; }

__host__ __device__ constexpr size_t act_offset(int W) {
  return sizeof(float) * NSTAGES * stage_floats(W);
}

__host__ __device__ constexpr size_t bar_offset(int W) {
  return act_offset(W) + sizeof(float) * TILE * (W + 8);
}

size_t smem_bytes(int W, int S, int rays_block) {
  return bar_offset(W) + 2 * NSTAGES * sizeof(uint64_t) +
         sizeof(float) * ((size_t)TILE * 8 + (size_t)rays_block * S * 5);
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
  const uint64_t dh = wgmma_desc(B, 16 * N, 128), dl = wgmma_desc(B + 8 * N, 16 * N, 128);
  mbar_wait(&ring.full[ring.stage], ring.phase);
  __syncwarp();  // the warp converged for the .aligned wgmma instructions
  wgmma_fence();
  wgmma_tf32<N>(acc, al, dh, first ? 0 : 1);
  wgmma_tf32<N>(acc, ah, dl, 1);
  wgmma_tf32<N>(acc, ah, dh, 1);
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
__global__ void __launch_bounds__(NTHREADS, 1) fused_eval_kernel(Args A) {
  constexpr int LDA = W + 8;  // 8 or 24 mod 32: the 64-bit loads and stores of a half-warp hit 32 banks
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = A.S;
  const int r0 = blockIdx.x * A.rays_block;
  const int nr = min(A.rays_block, A.R - r0);
  if (nr <= 0) return;
  const int npts = nr * S;

  Ring ring;
  ring.buf = reinterpret_cast<float*>(smem);
  float* act = reinterpret_cast<float*>(smem + act_offset(W));  // [TILE][LDA]
  ring.full = reinterpret_cast<uint64_t*>(smem + bar_offset(W));
  ring.empty = ring.full + NSTAGES;
  float* tpts = reinterpret_cast<float*>(ring.empty + NSTAGES);  // [TILE][8]: x, y, z, view dir
  float* pc = tpts + TILE * 8;                                     // [npts][3] raw rgb, then colour
  float* pq = pc + A.rays_block * S * 3;                          // raw sigma, then q
  float* pa = pq + A.rays_block * S;                              // alpha

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
  const int ntiles = (npts + TILE - 1) / TILE;

  if (tid >= NCONS) {
    // ---- producer: the weight stages of every tile, in the consumers' order ----
    regs_lower<PROD_REGS>();
    if (tid == NCONS) {
      int steps = pos_steps + W / 8 + W / 8 + dir_steps;  // layer 0, feature, view
      for (int j = 1; j < D; ++j) steps += W / 8 + (((A.skip_mask >> j) & 1u) ? pos_steps : 0);
      const int view_from = steps - (W / 8 + dir_steps);
      for (int tile = 0; tile < ntiles; ++tile) {
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
  const int* offs = A.offs;
  const float* wb = A.wbuf;
  const float* pos_bands = wb + offs[2 * D + 8];
  const float* dir_bands = wb + offs[2 * D + 9];

  for (int t0 = 0; t0 < npts; t0 += TILE) {
    // the thread's two points (rows row and row + 8 of the tile), kept in
    // shared memory rather than in registers beside the accumulator
    int pid[2];
    const float* p0 = tpts + row * 8;
    const float* p1 = p0 + 64;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = t0 + row + 8 * e;
      pid[e] = i < npts ? i : -1;
      if (t == 0) {
        float xv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (i < npts) {
          const int ray = r0 + i / S;
          const float zz = A.z[(size_t)ray * S + i % S];
          const float* o = A.rays_o + (size_t)ray * 3;
          const float* d = A.rays_d + (size_t)ray * 3;
          const float* vd = A.viewdirs + (size_t)ray * 3;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            xv[c] = __fadd_rn(o[c], __fmul_rn(zz, d[c]));
            xv[3 + c] = vd[c];
          }
        }
#pragma unroll
        for (int c = 0; c < 6; ++c) tpts[(row + 8 * e) * 8 + c] = xv[c];
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
      store_rows<W>(acc, wb + offs[2 * j + 1], arow, 8 * LDA, t, true);
      __syncwarp();
    }
    // alpha head (W -> 1) on the last hidden layer, read back from the rows
    // just stored (post-relu)
    {
      const float* wa = wb + offs[2 * D];
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
      const float ba = __ldg(wb + offs[2 * D + 1]);
      if (t == 0 && pid[0] >= 0) pq[pid[0]] = s0 + ba;
      if (t == 1 && pid[1] >= 0) pq[pid[1]] = s1 + ba;
    }
    __syncwarp();
    // feature (W -> W, no activation)
    gemm<W, W>(acc, ring, W / 8, from_act, 0, from_act, lane);
    store_rows<W>(acc, wb + offs[2 * D + 3], arow, 8 * LDA, t, false);
    __syncwarp();
    // view layer on [feature, encoded direction] (W + dir_dim -> W/2, relu),
    // then the rgb head (W/2 -> 3) from its accumulator
    {
      float acc2[W / 4];
      gemm<W / 2, W>(acc2, ring, W / 8, from_act, dir_steps, enc_dir, lane);
      const float* bv = wb + offs[2 * D + 5];
      const float* wr = wb + offs[2 * D + 6];  // [W/2][3]
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
      const float* br = wb + offs[2 * D + 7];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        c0[c] = row_sum(c0[c]);
        c1[c] = row_sum(c1[c]);
      }
      if (t == 0 && pid[0] >= 0)
        for (int c = 0; c < 3; ++c) pc[pid[0] * 3 + c] = c0[c] + __ldg(br + c);
      if (t == 1 && pid[1] >= 0)
        for (int c = 0; c < 3; ++c) pc[pid[1] * 3 + c] = c1[c] + __ldg(br + c);
    }
    __syncwarp();
  }
  named_barrier(1, NCONS);

  // ---- per-point compositing terms (_alpha_terms) ----
  for (int i = tid; i < npts; i += NCONS) {
    const int ray = r0 + i / S;
    const float delta = A.deltas[(size_t)ray * S + i % S];
    const float raw = pq[i];
    float q, alpha;
    if (A.mode == 0) {
      const float sigma = A.relu_density ? fmaxf(raw, 0.f)
                                         : fmaxf(raw, 0.f) + log1pf(expf(-fabsf(raw)));
      q = sigma * delta;
      alpha = 1.f - expf(-q);
    } else {
      q = delta * raw;  // raw density in the prefix sum: T may exceed 1
      alpha = 1.f - expf(-fmaxf(q, 0.f));
    }
    pq[i] = q;
    pa[i] = alpha;
    if (A.mode == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) pc[i * 3 + c] = 1.f / (1.f + expf(-pc[i * 3 + c]));
    }
  }
  named_barrier(1, NCONS);

  // ---- per-ray exclusive scan and composite ----
  for (int rr = tid; rr < nr; rr += NCONS) {
    const int ray = r0 + rr;
    const float* q = pq + rr * S;
    const float* al = pa + rr * S;
    const float* c = pc + rr * S * 3;
    float* wout = A.weights + (size_t)ray * S;
    float excl = 0.f, acc = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = al[s] * expf(-excl);
      wout[s] = w;
      c0 = fmaf(w, c[3 * s + 0], c0);
      c1 = fmaf(w, c[3 * s + 1], c1);
      c2 = fmaf(w, c[3 * s + 2], c2);
      acc += w;
      excl += q[s];
    }
    if (A.white_bkgd) {
      const float bg = 1.f - acc;
      c0 += bg; c1 += bg; c2 += bg;
    }
    A.rgb[(size_t)ray * 3 + 0] = c0;
    A.rgb[(size_t)ray * 3 + 1] = c1;
    A.rgb[(size_t)ray * 3 + 2] = c2;
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
extern "C" long long fused_eval_smem_bytes(int width, int S, int rays_block) {
  if (!width_ok(width)) return 0;
  return (long long)smem_bytes(width, S, rays_block);
}

// Floats of the B images pack_eval_wgmma writes for this MLP: per dense
// layer (trunk, feature, view) its k-steps of 8 rows x N columns x (hi, lo).
extern "C" long long fused_eval_image_floats(int depth, int width, unsigned skip_mask, int pos_dim,
                                             int dir_dim) {
  long long steps = ksteps(pos_dim) + width / 8;  // layer 0, feature
  for (int j = 1; j < depth; ++j) steps += width / 8 + (((skip_mask >> j) & 1u) ? ksteps(pos_dim) : 0);
  return steps * 16 * width + (long long)(width / 8 + ksteps(dir_dim)) * 16 * (width / 2);
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
extern "C" int fused_eval_launch(const float* rays_o, const float* rays_d, const float* viewdirs,
                                 const float* z, const float* deltas, const float* wimg,
                                 const float* wbuf, const int* offs, float* rgb, float* weights,
                                 int R, int S, int rays_block, int depth, int width,
                                 unsigned skip_mask, int pos_freqs, int pos_inc, int dir_freqs,
                                 int dir_inc, int mode, int relu_density, int white_bkgd,
                                 void* stream) {
  if (R <= 0) return 0;
  if (S <= 0 || rays_block <= 0 || depth <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(width, S, rays_block);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  void (*kernel)(Args) = PICK_WIDTH(fused_eval_kernel, width);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Args a{rays_o,    rays_d,  viewdirs,  z,       deltas,    wimg,     wbuf,
         offs,      rgb,     weights,   R,       S,         rays_block, depth,
         skip_mask, pos_freqs, pos_inc, dir_freqs, dir_inc, mode,     relu_density,
         white_bkgd};
  const unsigned grid = (unsigned)((R + rays_block - 1) / rays_block);
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
