// Helpers shared by the flash attention kernels (forward, dQ, dK/dV):
// tile sizes, the admission predicate, and a row loader from a dense
// [S, D] head into a padded float tile in shared memory.
#pragma once

#include "attn_common.cuh"

namespace flash {

constexpr int kThreads = 128;
// A CTA's 128 threads form 16 row groups of 8 lanes; the 8 lanes of a
// group are consecutive lanes of one warp, so a row reduction is three
// xor-shuffles.
constexpr int KG = 8;
constexpr int RG = kThreads / KG;
constexpr int BK = 32;  // keys per tile in the forward and dQ kernels
constexpr int BM = 32;  // query rows per step of the dK/dV kernel

// Query rows per CTA of the forward and dQ kernels: 64, or 32 at D = 256,
// where 64 rows' f32 accumulators and tiles would not fit.
template <int D>
__host__ __device__ constexpr int q_rows() { return D == 256 ? 32 : 64; }
// Keys per CTA of the dK/dV kernel, for the same reason.
template <int D>
__host__ __device__ constexpr int kv_rows() { return D == 256 ? 16 : 32; }

// Query q admits key k: the reference's predicate (k < S, causal k <= q,
// window q - k < window; the non-causal windowed case admits every later
// key).  Positions are the sequence indices.
__device__ __forceinline__ bool admits(int q, int k, int S, int causal,
                                       int window) {
  return k < S && (!causal || k <= q) && (window <= 0 || q - k < window);
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < KG; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < KG; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// dst[r * ld + c] = float(src[r * D + c]) for r < valid, 0 for valid <= r
// < rows.  16-byte vector loads: the wrappers check every base pointer, and
// each row offset is a multiple of D * sizeof(T) >= 32 bytes.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          int rows, int valid,
                                          float* __restrict__ dst, int ld) {
  constexpr int V = 16 / sizeof(T);
  static_assert(D % V == 0, "head dim must be a multiple of the vector");
  constexpr int VPR = D / V;
  for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
    const int r = i / VPR, c = i % VPR;
    float* d = dst + r * ld + c * V;
    if (r < valid) {
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * D) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int x = 0; x < V; ++x) d[x] = attn::to_float(e[x]);
    } else {
#pragma unroll
      for (int x = 0; x < V; ++x) d[x] = 0.f;
    }
  }
}

// Set a kernel's dynamic shared memory limit when it needs more than the
// default 48 KB.
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace flash
