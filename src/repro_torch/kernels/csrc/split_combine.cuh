// The second pass of the split-key (flash-decoding) decode kernels, dense
// and paged: each split CTA leaves its unnormalised accumulator, running
// max m and sum l for its G query heads as f32 partials,
// o_part [B, Kv, n_split, G, D] and ml_part [B, Kv, n_split, G, 2]; this
// kernel merges the splits of every (head, row) by the logsumexp rule of
// `distributed/collectives.py::sp_decode_combine` and writes exact zeros
// where the combined l is 0 (a row no key admits, as the Pallas kernels'
// `l == 0` guard and the plain versions give).  An empty split keeps m at
// the finite NEG_INIT, so exp(m_s - m) never meets -inf - -inf.
#pragma once

#include "attn_common.cuh"

namespace attn {

// One CTA per (head, row), one thread per element of D in whole warps
// (the launch rounds D up to a multiple of 32: combine_threads).  Each warp
// reads the splits' m and l a lane a split at once and takes the max and
// the weighted sum of l by shuffles; each thread then sums its element
// over the splits in split order, the weights handed over by shuffles, so
// no load waits on a sum and nothing goes through shared memory (a kernel
// that asks for none shares the split kernel's shared-memory carve-out).
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ o_part,
                                      const float* __restrict__ ml_part,
                                      T* __restrict__ out, int H, int Kv,
                                      int D, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / Kv, kv = h / G, g = h % G;
  const size_t base = ((size_t)b * Kv + kv) * n_split;  // split 0's part
  const int d = threadIdx.x, lane = d & 31;
  const bool mine = d < D;  // lanes past D only hand weights over
  float m = NEG_INIT;
  for (int s = lane; s < n_split; s += 32)
    m = fmaxf(m, ml_part[((base + s) * G + g) * 2]);
#pragma unroll
  for (int o = 16; o; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f, a = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += 32) {
    float w = 0.f;  // split s0 + lane's weight
    if (s0 + lane < n_split) {
      const float2 ml =
          reinterpret_cast<const float2*>(ml_part)[(base + s0 + lane) * G + g];
      w = expf(ml.x - m);
      l = fmaf(w, ml.y, l);
    }
    const int n = min(32, n_split - s0);
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float wi = __shfl_sync(0xffffffffu, w, i);
      if (mine) a = fmaf(wi, o_part[((base + s0 + i) * G + g) * D + d], a);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  if (mine)
    out[((size_t)b * H + h) * D + d] = from_float<T>(l == 0.f ? 0.f : a / l);
}

// threads of a combine CTA: D rounded up to whole warps
__host__ __device__ constexpr int combine_threads(int D) {
  return (D + 31) / 32 * 32;
}

}  // namespace attn
