// Tile sizes and helpers shared by the tensor-core attention kernels (the
// flash forward in flash_attention.cu, dQ and dK/dV in
// flash_attention_bwd.cu, the segment kernels of segment_tc.cuh), the
// online-softmax step of the forward and segment kernels, and the route
// rule that sends a flash call to them.
#pragma once

#include "attn_common.cuh"
#include "hopper.cuh"

namespace flash_tc {

constexpr int kKeys = 64;        // keys per K/V tile (and per dK/dV CTA)
constexpr int kRows = 64;        // q rows per CTA (and per dK/dV step)
constexpr int kStages = 2;       // tiles in flight
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreadsTC = kConsumers + 32;  // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;

// The route rule: bf16 at D 64, 120 and 128 takes the tensor cores, every
// other supported call (f32 at every D, bf16 at D 16 and 256) the CUDA
// cores.  dtype: 0 = float32, 1 = bfloat16.
inline bool tensor_core_route(int D, int dtype) {
  return dtype == 1 && (D == 64 || D == 120 || D == 128);
}

// the head dim in whole 64-column chunks (D = 120 reads 128, the last 8
// columns zeros)
template <int D>
__host__ __device__ constexpr int padded() {
  return D <= 64 ? 64 : D <= 128 ? 128 : 256;
}
// bytes of one [rows, DP] bf16 tile: DP / 64 chunks of rows x 128 bytes
template <int DP>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return DP * rows * 2;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// every (q, key) pair of the tile is admitted: no mask test needed
__device__ __forceinline__ bool whole_tile(int q0, int k0, int S, int causal,
                                           int window) {
  return q0 + kRows <= S && k0 + kKeys <= S &&
         (!causal || k0 + kKeys - 1 <= q0) &&
         (window <= 0 || q0 + kRows - 1 - k0 < window);
}

// the warpgroup of this thread, warp-uniform for the compiler (which
// otherwise serialises the wgmma of the consumers' path): 0 the consumer
// warpgroup, 1 the producer warp
__device__ __forceinline__ int role() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / kConsumers, 0);
}

// One step of the online softmax over an S tile of NK keys in a consumer
// thread's accumulator layout (rows `row` and `row + 8` of the warpgroup's
// 64, columns `col + 8j` and `col + 8j + 1`; element i lies in row half
// (i / 2) % 2, key column col + 8 (i / 4) + i % 2).  Scores become log2
// units (`scale_log2` = D^-0.5 log2(e)); unless `whole`, a score for which
// `admit(row half, key column)` is false becomes -inf and gives p = 0.  A
// row's max and sum are two xor-shuffles among the 4 lanes of a quad.  On
// return st holds p (unrounded), m and l are updated, and alpha is each
// row's rescale factor for its accumulator.  m must start finite
// (NEG_INIT), so alpha is never NaN.
template <int NK, typename Admit>
__device__ __forceinline__ void softmax_step(float (&st)[NK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, bool whole,
                                             Admit admit) {
  const int col = 2 * (threadIdx.x % 4);
  float mx[2] = {attn::MASKED, attn::MASKED};
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) {
    const int e = (i / 2) % 2;
    float x = st[i] * scale_log2;
    if (!whole && !admit(e, col + 8 * (i / 4) + (i % 2))) x = attn::MASKED;
    st[i] = x;
    mx[e] = fmaxf(mx[e], x);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    const float m_new = fmaxf(m[e], mx[e]);
    alpha[e] = hopper::exp2_approx(m[e] - m_new);
    m[e] = m_new;
  }
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) {
    const int e = (i / 2) % 2;
    st[i] = hopper::exp2_approx(st[i] - m[e]);  // exp2(-inf) = 0
    sum[e] += st[i];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 1);
    sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 2);
    l[e] = alpha[e] * l[e] + sum[e];
  }
}

// acc *= alpha by row, in the same accumulator layout
template <int N>
__device__ __forceinline__ void scale_rows(float (&acc)[N],
                                           const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= alpha[(i / 2) % 2];
}

// P rounded to bf16 and packed straight from the accumulator layout into
// register A operands of the next product, 16 keys each
template <int NK>
__device__ __forceinline__ void pack_p(const float (&st)[NK / 2],
                                       uint32_t (&pa)[NK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pa[kk][x] = hopper::pack_bf16(st[8 * kk + 2 * x], st[8 * kk + 2 * x + 1]);
}

// The producer lane of a CTA that owns one q tile (the forward and dQ
// kernels): TMA loads of the K and V tiles kt_lo .. kt_lo + n_it - 1 of
// KV row `bkv`, each into stage it % kStages of the ring once the
// consumers have released that stage.
template <int DP>
__device__ __forceinline__ void stream_kv(uint8_t* k_s, uint8_t* v_s,
                                          const CUtensorMap* tm_k,
                                          const CUtensorMap* tm_v,
                                          uint64_t* full, uint64_t* empty,
                                          int kt_lo, int n_it, int bkv) {
  constexpr int KV_CHUNK = kKeys * 128;
  constexpr int KV_BYTES = tile_bytes<DP>(kKeys);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int k0 = (kt_lo + it) * kKeys;
    hopper::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(&full[s], 2 * KV_BYTES);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
      hopper::tma_load_3d(k_s + s * KV_BYTES + c * KV_CHUNK, tm_k, &full[s],
                          c * 64, k0, bkv);
      hopper::tma_load_3d(v_s + s * KV_BYTES + c * KV_CHUNK, tm_v, &full[s],
                          c * 64, k0, bkv);
    }
  }
}

}  // namespace flash_tc
