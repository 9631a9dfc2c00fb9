// Tile sizes and helpers shared by the tensor-core flash attention kernels
// (the forward in flash_attention.cu, dQ and dK/dV in
// flash_attention_bwd.cu), and the route rule that sends a call to them.
#pragma once

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
__host__ __device__ constexpr int padded() { return D <= 64 ? 64 : 128; }
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
