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

// One CTA per (head, row), one thread per element of D.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ o_part,
                                      const float* __restrict__ ml_part,
                                      T* __restrict__ out, int H, int Kv,
                                      int D, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / Kv, kv = h / G, g = h % G;
  const size_t base = ((size_t)b * Kv + kv) * n_split;  // split 0's part
  float m = NEG_INIT;
  for (int s = 0; s < n_split; ++s)
    m = fmaxf(m, ml_part[((base + s) * G + g) * 2]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t p = (base + s) * G + g;
      const float w = expf(ml_part[p * 2] - m);
      l = fmaf(w, ml_part[p * 2 + 1], l);
      a = fmaf(w, o_part[p * D + d], a);
    }
    out[((size_t)b * H + h) * D + d] = from_float<T>(l == 0.f ? 0.f : a / l);
  }
}

}  // namespace attn
