// Fused 2-D image-learning MLP for Hopper (sm_90a): the forward alone.
//
// Replaces nerf_meets_mlx_tpu/kernels/fused_image.py::_fwd_kernel. The op
// takes pixel coordinates x [N, d] (d = 2 for the image task) and runs
//
//   sinusoidal encode (sin of x_a*b_j, a-major; then the cosines as
//   sin(x_a*b_j + pi/2); then x itself when include_input)
//   -> D x W relu MLP with the encoded input concatenated (input-first) at
//   the skip layers -> output head W -> out_ch (no activation),
//
// writing the output [N, out_ch]. The train step's kernels (the Pallas
// _train_kernel's port) are csrc/image_train_tc.cu.
//
// What bounds it: arithmetic. At image2d's shapes (D = 8, W = 256, skip
// after layer 4, 10 bands of 2 axes, no raw input: 40 features) a pixel
// costs 480,000 MACs: a 400 x 400 frame is ~154 GFLOP (2.3 ms at the 67
// TFLOP/s fp32 peak), against 20 bytes of input a pixel.
//
// Design: the register-tiled fp32 GEMM over shared-memory point tiles is a
// copy of csrc/fused_mlp.cu's, kept apart so that that file's measured
// times stay its baseline. image_fwd_kernel: a block owns `block_pts`
// points and walks them in tiles of TILE = 64. The encoding is computed per
// point in registers and stored transposed ([feature][point]) in shared
// memory; each layer is a GEMM over [W][TILE] ping-pong tiles with the
// weights staged in 16-row slices. Nothing but the output leaves the chip.
//
// The TPU kernel's band matrix M [8, SW] with its phase row, the
// zero-extended skip rows and the [N, 8] padded input and output were
// MXU/VMEM layouts and are not carried over. Plain fp32 FMAs; sinf without
// fast math, phases rounded as the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;          // points per MLP tile
constexpr int LD = TILE + 4;      // row stride of the [feature][point] tiles
constexpr int KB = 16;            // rows per staged slice
constexpr int NTHREADS = 256;
constexpr int MAX_OFFS = 64;      // 2*depth + 3 weight-buffer offsets
constexpr int MAX_OUT = 4;        // output channels
constexpr int MAX_ENC = 128;      // encoded features
constexpr float HALF_PI = 1.57079632679489662f;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Args {
  const float* x;         // [N, in_dim]
  const float* wbuf;      // weights, biases, bands
  float* out;             // [N, out_ch]
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

// out[col][p] = max(b[col] + sum_k in[k][p] * Wg[k][col], 0) for the TILE
// points of a tile and the first `nout` columns; bg may be null (no
// bias). The input is up to two shared-memory segments
// (kA rows of inA, then kB of inB), each padded to KB rows; rows past kA /
// kB read zero weights.
template <int N>
__device__ __forceinline__ void dense(const float* __restrict__ inA, int kA,
                                      const float* __restrict__ inB, int kB,
                                      const float* __restrict__ Wg,
                                      const float* __restrict__ bg, float* __restrict__ out,
                                      int nout, float* __restrict__ wtile) {
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
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        float x = acc[m][CW * n + j] + b[j];
        x = fmaxf(x, 0.f);
        v[m][j] = x;
      }
    }
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      if (c0 + j >= nout) continue;
      *reinterpret_cast<float4*>(out + (c0 + j) * LD + p0) =
          make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
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
  float *bufA, *bufB, *enc, *wtile;
};

template <int W>
__device__ __forceinline__ Smem carve(float* smem, int enc_pad) {
  Smem s;
  s.bufA = smem;                     // [W][LD]
  s.bufB = s.bufA + W * LD;          // [W][LD]
  s.enc = s.bufB + W * LD;           // [enc_pad][LD]
  s.wtile = s.enc + enc_pad * LD;    // [KB][W]
  return s;
}

// The forward of one tile (points g0 .. g0 + nv - 1): the output [nv, out_ch].
template <int W>
__device__ __forceinline__ void forward_tile(const Args& A, const Smem& s, size_t g0, int nv) {
  const int tid = threadIdx.x;
  const int d = A.in_dim, F = A.n_freqs, oc = A.out_ch;
  const int enc_dim = enc_dim_of(d, F, A.include_input), enc_pad = round_up(enc_dim, KB);
  const int D = A.depth;
  const float* wb = A.wbuf;
  {
    const int p = tid % TILE, part = tid / TILE;
    float xs[3] = {0.f, 0.f, 0.f};
    if (p < nv)
      for (int a = 0; a < d; ++a) xs[a] = __ldg(A.x + (g0 + p) * d + a);
    const float* bands = wb + A.offs[2 * D + 2];
    for (int f = part; f < enc_pad; f += NTHREADS / TILE)
      s.enc[f * LD + p] = encode_feature(f, d, F, A.include_input, bands, xs);
  }
  __syncthreads();

  float* h = s.bufA;
  float* g = s.bufB;
  dense<W>(s.enc, enc_dim, nullptr, 0, wb + A.offs[0], wb + A.offs[1], h, W, s.wtile);
  for (int j = 1; j < D; ++j) {
    const float* Wj = wb + A.offs[2 * j];
    const float* bj = wb + A.offs[2 * j + 1];
    if ((A.skip_mask >> j) & 1u)
      dense<W>(s.enc, enc_dim, h, W, Wj, bj, g, W, s.wtile);
    else
      dense<W>(h, W, nullptr, 0, Wj, bj, g, W, s.wtile);
    float* tmp = h; h = g; g = tmp;
  }
  // output head (W -> out_ch, no activation)
  const float* wo = wb + A.offs[2 * D];
  const float* bo = wb + A.offs[2 * D + 1];
  for (int idx = tid; idx < TILE * oc; idx += NTHREADS) {
    const int p = idx % TILE, c = idx / TILE;
    float v = __ldg(bo + c);
    for (int k = 0; k < W; ++k) v = fmaf(h[k * LD + p], __ldg(wo + k * oc + c), v);
    if (p < nv) A.out[(g0 + p) * oc + c] = v;
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
  for (int t0 = 0; t0 < npts; t0 += TILE)
    forward_tile<W>(A, s, (size_t)(b0 + t0), min(TILE, npts - t0));
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

size_t smem_bytes(int W, int enc_dim) {
  return sizeof(float) * ((size_t)(2 * W + round_up(enc_dim, KB)) * LD + (size_t)KB * W);
}

}  // namespace

// Shared-memory bytes one block needs (0 if the width is not supported);
// lets the wrapper check a shape before launching.
extern "C" long long fused_image_smem_bytes(int width, int enc_dim) {
  if (!width_ok(width)) return 0;
  return (long long)smem_bytes(width, enc_dim);
}

// Forward: out [N, out_ch]. offs: the 2*depth + 3 float offsets of
// pack_image_weights (host array). Returns the cudaError_t of the launch.
extern "C" int fused_image_fwd_launch(const float* x, const float* wbuf, const int* offs,
                                      int n_offs, float* out, long long N, int block_pts,
                                      int depth, int width, unsigned skip_mask, int in_dim,
                                      int n_freqs, int include_input, int out_ch, void* stream) {
  if (N == 0) return 0;
  const int enc_dim = enc_dim_of(in_dim, n_freqs, include_input);
  if (N < 0 || block_pts <= 0 || block_pts % TILE != 0 || depth < 1 || n_offs != 2 * depth + 3 ||
      n_offs > MAX_OFFS || !width_ok(width) || (skip_mask & 1u) != 0 || (skip_mask >> depth) != 0 ||
      in_dim < 1 || in_dim > 3 || n_freqs < 0 || out_ch < 1 || out_ch > MAX_OUT || enc_dim < 1 ||
      enc_dim > MAX_ENC)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(width, enc_dim);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x; a.wbuf = wbuf; a.out = out;
  a.N = N; a.block_pts = block_pts; a.depth = depth; a.skip_mask = skip_mask;
  a.in_dim = in_dim; a.n_freqs = n_freqs; a.include_input = include_input; a.out_ch = out_ch;
  for (int i = 0; i < n_offs; ++i) a.offs[i] = offs[i];
  void (*kernel)(Args) = PICK_WIDTH(image_fwd_kernel, width);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((N + block_pts - 1) / block_pts);
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
