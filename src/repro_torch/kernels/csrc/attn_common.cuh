// Helpers shared by the attention kernels: f32/bf16 conversion, four
// elements read as floats, and a 16-byte-vectorised copy of a dense
// [rows, D] tile from device memory into a float tile in shared memory.
#pragma once

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

// Score of a masked key: below every real score, and never reached by
// subtraction (the online softmax tests for it and emits p = 0 instead).
constexpr float MASKED = -INFINITY;
// Running max before any key is admitted, as in the reference kernels:
// finite, so exp(NEG_INIT - NEG_INIT) = 1 keeps a masked block a no-op.
constexpr float NEG_INIT = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive elements as floats (8- or 16-byte aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// dst[r * ld + c] = float(src[r * D + c]) for r < rows, c < D.  `src` must
// be 16-byte aligned (the wrappers check every base pointer; each tile
// offset is a multiple of D * sizeof(T) >= 32 bytes).
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* __restrict__ dst, int rows,
                                          int ld) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  static_assert(D % V == 0, "head dim must be a multiple of the vector");
  constexpr int VPR = D / V;         // vectors per row
  const int n = rows * VPR;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint4 raw = __ldg(s + i);
    const T* e = reinterpret_cast<const T*>(&raw);
    float* d = dst + (i / VPR) * ld + (i % VPR) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) d[j] = to_float(e[j]);
  }
}

}  // namespace attn
