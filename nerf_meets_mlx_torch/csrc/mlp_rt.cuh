// The runtime-shape MLP building blocks of csrc/fused_ingp.cu and
// csrc/fused_feat.cu: a thread's vectors live in local memory, and each
// dense layer is computed 16 (or 8) output columns at a time in registers,
// with the weights read from shared or device memory through a generic
// pointer (every thread of a warp reads the same weight: a broadcast).

#pragma once

#include <cuda_runtime.h>

namespace {

// y[j0 + c] = act(b[j0 + c] + sum_{k<K} x[k] * Wm[k][j0 + c]) for c < CH,
// Wm row-major [K][N] (rows on 16 bytes: N a multiple of 4)
template <int CH>
__device__ __forceinline__ void rt_columns(float* y, const float* x, int K, const float* Wm,
                                           const float* b, int N, int j0, bool relu) {
  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(b + j0 + c);
    acc[c] = v.x; acc[c + 1] = v.y; acc[c + 2] = v.z; acc[c + 3] = v.w;
  }
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float xv = x[k];
    const float* w = Wm + (size_t)k * N + j0;
#pragma unroll
    for (int c = 0; c < CH; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(w + c);
      acc[c] = fmaf(xv, v.x, acc[c]);
      acc[c + 1] = fmaf(xv, v.y, acc[c + 1]);
      acc[c + 2] = fmaf(xv, v.z, acc[c + 2]);
      acc[c + 3] = fmaf(xv, v.w, acc[c + 3]);
    }
  }
#pragma unroll
  for (int c = 0; c < CH; ++c) y[j0 + c] = relu ? fmaxf(acc[c], 0.f) : acc[c];
}

// y = act(b + x Wm) over N columns, N a multiple of 8 (the W/2 view layer
// of a width such as 48 ends in a chunk of 8)
__device__ __forceinline__ void rt_dense(float* y, const float* x, int K, const float* Wm,
                                         const float* b, int N, bool relu) {
  int j0 = 0;
  for (; j0 + 16 <= N; j0 += 16) rt_columns<16>(y, x, K, Wm, b, N, j0, relu);
  if (j0 < N) rt_columns<8>(y, x, K, Wm, b, N, j0, relu);
}

// dx[k] (+)= sum_{c<CH} Wm[k][j0 + c] * d[j0 + c] for k < K
template <int CH>
__device__ __forceinline__ void rt_rows(float* dx, const float* d, int N, const float* Wm, int K,
                                        int j0) {
  float dv[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) dv[c] = d[j0 + c];
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float* w = Wm + (size_t)k * N + j0;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CH; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(w + c);
      s = fmaf(v.x, dv[c], s);
      s = fmaf(v.y, dv[c + 1], s);
      s = fmaf(v.z, dv[c + 2], s);
      s = fmaf(v.w, dv[c + 3], s);
    }
    dx[k] = j0 == 0 ? s : dx[k] + s;
  }
}

// dx[k] = sum_{j<N} Wm[k][j] * d[j] for k < K: the cotangent of a layer's
// input, N a multiple of 8
__device__ __forceinline__ void rt_dense_t(float* dx, const float* d, int N, const float* Wm,
                                           int K) {
  int j0 = 0;
  for (; j0 + 16 <= N; j0 += 16) rt_rows<16>(dx, d, N, Wm, K, j0);
  if (j0 < N) rt_rows<8>(dx, d, N, Wm, K, j0);
}

// dst[0, n) = src[0, n), n a multiple of 4, dst on 16 bytes
__device__ __forceinline__ void rt_store(float* dst, const float* src, int n) {
  for (int j = 0; j < n; j += 4)
    *reinterpret_cast<float4*>(dst + j) = make_float4(src[j], src[j + 1], src[j + 2], src[j + 3]);
}

}  // namespace
