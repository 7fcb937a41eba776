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
// What bounds it: arithmetic. At the lego_hierarchical shapes (D=8, W=256,
// skip after layer 4, 10 position bands and 4 direction bands, both with
// the raw input) the MLP costs
//   63*256 + 4*256^2 + 319*256 + 2*256^2 + 256 + 256^2 + 283*128 + 128*3
//   = 593,280 MACs = 1.19 MFLOP per point,
// about 48.6 TFLOP for a 400x400 frame (10.24M coarse + 30.72M fine
// points), against ~1 KB of ray input and output per ray. So the design
// keeps every activation on chip and spends its effort on the GEMM chain:
//
// * A block owns `rays_block` rays and walks their rays_block*S points in
//   tiles of TILE = 64 points. The encoding is computed from the point in
//   registers and stored transposed ([feature][point]) in shared memory;
//   each layer's activations ping-pong between two [W][TILE] shared tiles.
// * Each dense layer is a register-tiled fp32 GEMM: 256 threads, each
//   holding 4 points x 4*(N/64) output columns. The weights (the port's
//   own unpacked [fan_in][fan_out] layout, ~2.4 MB, resident in L2) are
//   staged through shared memory in slices of KB = 16 rows, with the next
//   slice's global loads issued before the current slice's FMAs.
// * Only (rgb, sigma) per point is kept; after the last tile each ray is
//   composited by one thread with a sequential exclusive scan, in the same
//   order as the plain version's cumsum.
//
// The TPU kernel's 128-lane packed band matrix, its U/E selector GEMMs and
// its [S,S] scan matrix were MXU/VMEM workarounds and are not carried over.
// Plain fp32 FMAs only: tensor cores (wgmma, TF32/bf16) and TMA are later
// work. Numerics: the sinusoidal phases reach ~3000 rad, so the encode uses
// sinf (full range reduction, no fast-math) and forms x*b and x*b + pi/2
// with __fmul_rn/__fadd_rn, rounding twice as the plain version does; the
// cosines are sin(x*b + pi/2) as in the JAX package.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;          // points per MLP tile
constexpr int LD = TILE + 4;      // row stride of the [feature][point] tiles
constexpr int KB = 16;            // weight rows per staged slice
constexpr int NTHREADS = 256;
constexpr float HALF_PI = 1.57079632679489662f;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct Args {
  const float* rays_o;    // [R, 3]
  const float* rays_d;    // [R, 3]
  const float* viewdirs;  // [R, 3]
  const float* z;         // [R, S]
  const float* deltas;    // [R, S]
  const float* wbuf;      // all weights, biases and bands (16-byte aligned pieces)
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

__device__ __forceinline__ float pick(int a, float x0, float x1, float x2) {
  return a == 0 ? x0 : (a == 1 ? x1 : x2);
}

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

// out[col][p] = act(b[col] + sum_k in[k][p] * Wg[k][col]) for the TILE
// points of the tile. The input is the concatenation of up to two
// shared-memory segments (rows kA of inA, then kB of inB, each padded with
// zero rows to a multiple of KB); Wg holds kA + kB rows of N floats.
template <int N>
__device__ __forceinline__ void dense(const float* __restrict__ inA, int kA,
                                      const float* __restrict__ inB, int kB,
                                      const float* __restrict__ Wg,
                                      const float* __restrict__ bg,
                                      float* __restrict__ out, bool relu,
                                      float* __restrict__ wtile) {
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
  constexpr int SLICE4 = KB * N4;  // float4 per staged slice
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

#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int col = 16 * CW * n + CW * tx + j;
      const float b = N % 16 == 0 || col < N ? __ldg(bg + col) : 0.f;
      float4 v = make_float4(acc[0][CW * n + j] + b, acc[1][CW * n + j] + b,
                             acc[2][CW * n + j] + b, acc[3][CW * n + j] + b);
      if (relu) {
        v.x = fmaxf(v.x, 0.f); v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f); v.w = fmaxf(v.w, 0.f);
      }
      *reinterpret_cast<float4*>(out + col * LD + 4 * ty) = v;
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
__global__ void __launch_bounds__(NTHREADS, 1) fused_eval_kernel(Args A) {
  extern __shared__ __align__(16) float smem[];
  const int pos_dim = 6 * A.pos_freqs + 3 * A.pos_inc;
  const int dir_dim = 6 * A.dir_freqs + 3 * A.dir_inc;
  const int pos_pad = round_up(pos_dim, KB), dir_pad = round_up(dir_dim, KB);

  float* bufA = smem;                   // [W][LD]
  float* bufB = bufA + W * LD;          // [W][LD]
  float* encP = bufB + W * LD;          // [pos_pad][LD]
  float* encD = encP + pos_pad * LD;    // [dir_pad][LD]
  float* wtile = encD + dir_pad * LD;   // [KB][W]
  const int S = A.S;
  float* pc = wtile + KB * W;           // [rays_block*S][3] raw rgb, then colour
  float* pq = pc + A.rays_block * S * 3;  // raw sigma, then q
  float* pa = pq + A.rays_block * S;      // alpha

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * A.rays_block;
  const int nr = min(A.rays_block, A.R - r0);
  if (nr <= 0) return;
  const int npts = nr * S;
  const int* offs = A.offs;
  const int D = A.depth;
  const float* wb = A.wbuf;
  const float* pos_bands = wb + offs[2 * D + 8];
  const float* dir_bands = wb + offs[2 * D + 9];

  for (int t0 = 0; t0 < npts; t0 += TILE) {
    // ---- encode the tile's points into encP / encD ----
    {
      const int p = tid % TILE, part = tid / TILE;
      const int i = t0 + p;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f, v0 = 0.f, v1 = 0.f, v2 = 0.f;
      if (i < npts) {
        const int ray = r0 + i / S;
        const float zz = A.z[(size_t)ray * S + i % S];
        const float* o = A.rays_o + (size_t)ray * 3;
        const float* d = A.rays_d + (size_t)ray * 3;
        const float* vd = A.viewdirs + (size_t)ray * 3;
        x0 = __fadd_rn(o[0], __fmul_rn(zz, d[0]));
        x1 = __fadd_rn(o[1], __fmul_rn(zz, d[1]));
        x2 = __fadd_rn(o[2], __fmul_rn(zz, d[2]));
        v0 = vd[0]; v1 = vd[1]; v2 = vd[2];
      }
      for (int f = part; f < pos_pad; f += NTHREADS / TILE)
        encP[f * LD + p] = encode_feature(f, A.pos_freqs, A.pos_inc, pos_bands, x0, x1, x2);
      for (int f = part; f < dir_pad; f += NTHREADS / TILE)
        encD[f * LD + p] = encode_feature(f, A.dir_freqs, A.dir_inc, dir_bands, v0, v1, v2);
    }
    __syncthreads();

    // ---- the layer chain ----
    float* h = bufA;
    float* g = bufB;
    dense<W>(encP, pos_dim, nullptr, 0, wb + offs[0], wb + offs[1], h, true, wtile);
    for (int j = 1; j < D; ++j) {
      const float* Wj = wb + offs[2 * j];
      const float* bj = wb + offs[2 * j + 1];
      if ((A.skip_mask >> j) & 1u)
        dense<W>(encP, pos_dim, h, W, Wj, bj, g, true, wtile);
      else
        dense<W>(h, W, nullptr, 0, Wj, bj, g, true, wtile);
      float* tmp = h; h = g; g = tmp;
    }
    // alpha head (W -> 1) from the last hidden layer
    if (tid < TILE) {
      const float* wa = wb + offs[2 * D];
      float a = __ldg(wb + offs[2 * D + 1]);
      for (int k = 0; k < W; ++k) a = fmaf(h[k * LD + tid], __ldg(wa + k), a);
      if (t0 + tid < npts) pq[t0 + tid] = a;
    }
    // feature (W -> W, no activation), then the view-direction layer on
    // [feature, encoded direction] (W + dir_dim -> W/2, relu)
    dense<W>(h, W, nullptr, 0, wb + offs[2 * D + 2], wb + offs[2 * D + 3], g, false, wtile);
    dense<W / 2>(g, W, encD, dir_dim, wb + offs[2 * D + 4], wb + offs[2 * D + 5], h, true, wtile);
    // rgb head (W/2 -> 3)
    if (tid < 3 * TILE) {
      const int p = tid % TILE, c = tid / TILE;
      const float* wr = wb + offs[2 * D + 6];
      float v = __ldg(wb + offs[2 * D + 7] + c);
      for (int k = 0; k < W / 2; ++k) v = fmaf(h[k * LD + p], __ldg(wr + k * 3 + c), v);
      if (t0 + p < npts) pc[(t0 + p) * 3 + c] = v;
    }
    __syncthreads();
  }

  // ---- per-point compositing terms (_alpha_terms) ----
  for (int i = tid; i < npts; i += NTHREADS) {
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
  __syncthreads();

  // ---- per-ray exclusive scan and composite ----
  for (int rr = tid; rr < nr; rr += NTHREADS) {
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

size_t smem_bytes(int W, int S, int rays_block, int pos_dim, int dir_dim) {
  return sizeof(float) * ((size_t)(2 * W + round_up(pos_dim, KB) + round_up(dir_dim, KB)) * LD +
                          (size_t)KB * W + (size_t)rays_block * S * 5);
}

}  // namespace

// Shared-memory bytes one block of the launch below needs (0 if the width
// is not supported); lets the wrapper check a shape before launching.
extern "C" long long fused_eval_smem_bytes(int width, int S, int rays_block, int pos_dim,
                                           int dir_dim) {
  if (!width_ok(width)) return 0;
  return (long long)smem_bytes(width, S, rays_block, pos_dim, dir_dim);
}

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
extern "C" int fused_eval_launch(const float* rays_o, const float* rays_d, const float* viewdirs,
                                 const float* z, const float* deltas, const float* wbuf,
                                 const int* offs, float* rgb, float* weights, int R, int S,
                                 int rays_block, int depth, int width, unsigned skip_mask,
                                 int pos_freqs, int pos_inc, int dir_freqs, int dir_inc, int mode,
                                 int relu_density, int white_bkgd, void* stream) {
  if (R <= 0) return 0;
  if (S <= 0 || rays_block <= 0 || depth <= 0) return (int)cudaErrorInvalidValue;
  const int pos_dim = 6 * pos_freqs + 3 * pos_inc, dir_dim = 6 * dir_freqs + 3 * dir_inc;
  const size_t smem = smem_bytes(width, S, rays_block, pos_dim, dir_dim);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  void (*kernel)(Args) = PICK_WIDTH(fused_eval_kernel, width);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Args a{rays_o, rays_d, viewdirs, z,         deltas,    wbuf,    offs,
         rgb,    weights, R,      S,         rays_block, depth, skip_mask,
         pos_freqs, pos_inc, dir_freqs, dir_inc, mode, relu_density, white_bkgd};
  const unsigned grid = (unsigned)((R + rays_block - 1) / rays_block);
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
