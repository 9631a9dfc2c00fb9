// Paged decode attention for Hopper (sm_90a): one query token per row
// against a K/V block store gathered through per-row block tables, with
// the row's table split across CTAs (flash-decoding) and the splits
// combined by a second, small kernel.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py,
// paged_decode_attention (Pallas TPU kernel `_kernel`).
//
// Bound on this card: bytes.  Per (row, KV head) the kernel reads q (G x D),
// the row's live K/V blocks (2 x T x D each) and writes G x D outputs; the
// arithmetic is 4 x G x D flops per key, about G/2 flops per byte of K/V in
// bf16, far under the ~295 flops/byte at which the tensor cores would
// become the limit.
//
// Design.  B x Kv CTAs, one per (row, KV head), are too few for 132 SMs (32
// at yi-6b's 8 decode rows x 4 KV heads), so each row's table of M entries
// is cut into `n_split` runs of `blocks_per_split` consecutive entries (the
// wrapper picks them from the shapes alone, for about two CTAs per SM) and
// each CTA takes one (split, KV head, row):
//   * it holds the G = H/Kv query heads of its group, so each K/V block is
//     read from device memory once for the whole group;
//   * its first warp reads the split's entries that hold positions in
//     [window start, q_pos] and compacts the live ones (>= 0) with a
//     ballot, so -1 entries are never loaded; an entry >= N is a
//     device-side assert, where the plain version raises IndexError;
//   * it walks the live blocks in tiles of up to 64 keys (whole blocks),
//     each tile's K and V rows brought in by 16-byte cp.async copies into a
//     two-stage ring in shared memory, so tile i + 1 arrives while tile i
//     is computed (one stage where two would not fit two CTAs on an SM);
//     rows are padded to 16 bytes past a 128-byte multiple, so a
//     quarter-warp's rows fall on distinct banks;
//   * scores are f32 dot products scaled by D^-0.5 after the dot, one
//     (query head, key) per thread; one warp per head keeps the online
//     softmax (max and sum by shuffles); the f32 probabilities meet V in
//     f32, four output columns per thread;
//   * it writes its unnormalised accumulator, running max m and sum l as
//     f32 partials to scratch the wrapper allocates.
// The combine kernel (split_combine.cuh, shared with the dense decode
// kernel), one CTA per (head, row), merges the splits with the logsumexp
// rule and writes exact zeros where no key was admitted: an idle engine
// slot (position 0, table row all -1) or a row whose live blocks all lie
// outside its window.  CUDA-core FMAs only (no wgmma/TMA).
#include "attn_common.cuh"
#include "hopper.cuh"
#include "split_combine.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileKeys = 64;                 // keys per tile, at most
constexpr size_t kTwoPerSM = 113 * 1024;      // two CTAs fit an SM
constexpr size_t kMaxSmem = 227 * 1024;       // one CTA's dynamic limit

// bytes of a K/V row in shared memory: 16 past a 128-byte multiple
template <typename T, int D>
__host__ __device__ constexpr int row_bytes() {
  return ((int)(D * sizeof(T)) + 127) / 128 * 128 + 16;
}
// floats of a q row in shared memory, by the same rule
template <int D>
__host__ __device__ constexpr int q_stride() { return (D + 31) / 32 * 32 + 4; }

template <typename T, int D>
size_t smem_bytes(int G, int tile_keys, int stages, int bps) {
  return (size_t)stages * 2 * tile_keys * row_bytes<T, D>() +
         sizeof(float) * ((size_t)G * q_stride<D>() + (size_t)G * D +
                          (size_t)G * (tile_keys + 1) + 3 * (size_t)G) +
         sizeof(int) * 2 * (size_t)bps;
}

using hopper::cp_async_commit;
using hopper::cp_async_wait;

using attn::load4;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_store,
                   const T* __restrict__ v_store,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ q_pos, float* __restrict__ o_part,
                   float* __restrict__ ml_part, int H, int Kv, int N, int Tk,
                   int M, int bps, int nb_tile, int stages, int window,
                   float scale) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int VPR = D / V;         // vectors per row
  static_assert(D % V == 0, "head dim must be a multiple of the vector");
  constexpr int RS = row_bytes<T, D>();
  constexpr int QS = q_stride<D>();
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int G = H / Kv;
  const int TK = nb_tile * Tk, PS = TK + 1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* kv_s = smem;  // [stages][K, V][TK][RS bytes]
  float* q_s = reinterpret_cast<float*>(kv_s + (size_t)stages * 2 * TK * RS);
  float* acc = q_s + G * QS;   // [G][D]
  float* p_s = acc + G * D;    // [G][PS] scores, then probabilities
  float* m_s = p_s + G * PS;   // [G] running max
  float* l_s = m_s + G;        // [G] running sum
  float* a_s = l_s + G;        // [G] rescale factor of this tile
  int* ent_s = reinterpret_cast<int*>(a_s + G);  // [bps] live entries
  int* blk_s = ent_s + bps;                      // [bps] their table index
  __shared__ int n_live_s;

  const int qp = q_pos[b];
  // this split's entries holding positions in [window start, q_pos]
  const int j_lo = max(window > 0 ? max(0, qp - window + 1) / Tk : 0,
                       split * bps);
  const int j_hi = min(qp < 0 ? -1 : min(qp / Tk, M - 1),
                       (split + 1) * bps - 1);

  for (int i = threadIdx.x; i < G * VPR; i += blockDim.x) {
    const int g = i / VPR, c = i % VPR;
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
                                q + ((size_t)b * H + (size_t)kv * G + g) * D) +
                            c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int x = 0; x < V; ++x) q_s[g * QS + c * V + x] = attn::to_float(e[x]);
  }
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) acc[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_s[g] = attn::NEG_INIT;
    l_s[g] = 0.f;
  }
  if (warp == 0) {  // compact the live entries, in table order
    int n = 0;
    for (int j0 = j_lo; j0 <= j_hi; j0 += 32) {
      const int j = j0 + lane;
      const int entry = j <= j_hi ? block_tables[(size_t)b * M + j] : -1;
      assert(entry < N);  // a stale table fails, as the plain version does
      const unsigned live = __ballot_sync(0xffffffffu, entry >= 0);
      if (entry >= 0) {
        const int at = n + __popc(live & ((1u << lane) - 1));
        ent_s[at] = entry;
        blk_s[at] = j;
      }
      n += __popc(live);
    }
    if (lane == 0) n_live_s = n;
  }
  __syncthreads();
  const int n_live = n_live_s;
  const int n_tiles = (n_live + nb_tile - 1) / nb_tile;

  // cp.async the K and V rows of tile `tile`'s live blocks into stage `st`
  auto issue = [&](int tile, int st) {
    uint8_t* ks = kv_s + (size_t)st * 2 * TK * RS;
    uint8_t* vs = ks + (size_t)TK * RS;
    const int rows = min(nb_tile, n_live - tile * nb_tile) * Tk;
    for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
      const int r = i / VPR, c = i % VPR;
      const int entry = ent_s[tile * nb_tile + r / Tk];
      const size_t off =
          (((size_t)entry * Kv + kv) * Tk + r % Tk) * D + (size_t)c * V;
      hopper::cp_async<16>(ks + r * RS + c * 16, k_store + off);
      hopper::cp_async<16>(vs + r * RS + c * 16, v_store + off);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) issue(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    if (stages == 2 && it + 1 < n_tiles) {
      issue(it + 1, (it + 1) % 2);  // its stage's readers passed the sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it has landed, every thread's copies
    const uint8_t* ks = kv_s + (size_t)(stages == 2 ? it % 2 : 0) * 2 * TK * RS;
    const uint8_t* vs = ks + (size_t)TK * RS;
    const int keys = min(nb_tile, n_live - it * nb_tile) * Tk;

    for (int i = threadIdx.x; i < G * TK; i += blockDim.x) {
      const int g = i % G, t = i / G;
      float s = attn::MASKED;
      if (t < keys) {
        const int kp = blk_s[it * nb_tile + t / Tk] * Tk + t % Tk;
        if (kp <= qp && (window <= 0 || qp - kp < window)) {
          const float4* qr = reinterpret_cast<const float4*>(q_s + g * QS);
          const uint8_t* kr = ks + t * RS;
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < VPR; ++c) {
            const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * 16);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int x = 0; x < V; x += 4) {
              const float4 a = qr[(c * V + x) / 4];
              dot = fmaf(a.x, attn::to_float(e[x]), dot);
              dot = fmaf(a.y, attn::to_float(e[x + 1]), dot);
              dot = fmaf(a.z, attn::to_float(e[x + 2]), dot);
              dot = fmaf(a.w, attn::to_float(e[x + 3]), dot);
            }
          }
          s = dot * scale;
        }
      }
      p_s[g * PS + t] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kThreads / 32) {
      float* pr = p_s + g * PS;
      const float s0 = lane < TK ? pr[lane] : attn::MASKED;
      const float s1 = lane + 32 < TK ? pr[lane + 32] : attn::MASKED;
      float mb = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mb);  // finite: m starts at NEG_INIT
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);  // -inf: 0
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane < TK) pr[lane] = p0;
      if (lane + 32 < TK) pr[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[g] = m_new;
        l_s[g] = alpha * l_s[g] + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x * 4; i < G * D; i += blockDim.x * 4) {
      const int g = i / D, d = i % D;  // D % 4 == 0: one row
      const float* pr = p_s + g * PS;
      const float al = a_s[g];
      float4 a = *reinterpret_cast<const float4*>(acc + i);
      a.x *= al;
      a.y *= al;
      a.z *= al;
      a.w *= al;
      for (int t = 0; t < keys; ++t) {  // every row of a live block landed
        const float p = pr[t];
        const float4 v = load4(reinterpret_cast<const T*>(vs + t * RS) + d);
        a.x = fmaf(p, v.x, a.x);
        a.y = fmaf(p, v.y, a.y);
        a.z = fmaf(p, v.z, a.z);
        a.w = fmaf(p, v.w, a.w);
      }
      *reinterpret_cast<float4*>(acc + i) = a;
    }
    __syncthreads();  // this stage's readers are done before it is refilled
    if (stages == 1 && it + 1 < n_tiles) issue(it + 1, 0);
  }

  const size_t part = ((size_t)b * Kv + kv) * gridDim.x + split;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    o_part[part * G * D + i] = acc[i];
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    ml_part[(part * G + g) * 2] = m_s[g];
    ml_part[(part * G + g) * 2 + 1] = l_s[g];
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bt, const void* qpos, float* o_part,
                   float* ml_part, void* out, int B, int H, int Kv, int N,
                   int Tk, int M, int bps, int n_split, int window,
                   float scale, cudaStream_t stream) {
  const int G = H / Kv;
  // the most whole blocks a tile takes, then two stages if two CTAs still
  // fit an SM, else one
  int nb = 0, stages = 0;
  for (int st = 2; st >= 1 && !nb; --st)
    for (int n = max(1, kTileKeys / Tk); n >= 1 && !nb; --n)
      if (smem_bytes<T, D>(G, n * Tk, st, bps) <=
          (st == 2 ? kTwoPerSM : kMaxSmem)) {
        nb = n;
        stages = st;
      }
  if (!nb) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, D>(G, nb * Tk, stages, bps);
  auto kern = paged_split_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(n_split, Kv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(qpos), o_part, ml_part, H, Kv, N, Tk, M, bps,
      nb, stages, window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn::decode_combine_kernel<T>
      <<<dim3(H, B), attn::combine_threads(D), 0, stream>>>(
      o_part, ml_part, static_cast<T*>(out), H, Kv, D, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* bt, const void* qpos, float* o_part,
                     float* ml_part, void* out, int B, int H, int Kv, int N,
                     int Tk, int M, int bps, int n_split, int window,
                     float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, bt, qpos, o_part, ml_part, out, B, H, Kv, N, Tk, M, bps, n_split, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, bt, qpos, o_part, ml_part, out, B, H, Kv, N, Tk, M, bps, n_split, window, scale, s);
    case 120: return launch<T, 120>(q, k, v, bt, qpos, o_part, ml_part, out, B, H, Kv, N, Tk, M, bps, n_split, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, bt, qpos, o_part, ml_part, out, B, H, Kv, N, Tk, M, bps, n_split, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, bt, qpos, o_part, ml_part, out, B, H, Kv, N, Tk, M, bps, n_split, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,D]; k/v store [N,Kv,T,D]; block_tables [B,M] int32 (-1 = hole);
// q_pos [B] int32; o_part [B,Kv,n_split,G,D] and ml_part
// [B,Kv,n_split,G,2] f32 scratch; out [B,H,D].  Split s of a row takes
// table entries [s * bps, (s + 1) * bps); n_split * bps >= M.  dtype:
// 0 = float32, 1 = bfloat16 (q, the stores and out alike).  Returns the
// launches' cudaError_t.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_store, const void* v_store,
    const void* block_tables, const void* q_pos, void* o_part, void* ml_part,
    void* out, int B, int H, int Kv, int N, int Tk, int M, int D, int bps,
    int n_split, int window, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* ml = static_cast<float*>(ml_part);
  if (Kv <= 0 || H % Kv != 0 || bps <= 0 || n_split <= 0 ||
      (long long)n_split * bps < M || Tk <= 0 || Tk > 64)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(D, q, k_store, v_store, block_tables, q_pos, op,
                           ml, out, B, H, Kv, N, Tk, M, bps, n_split, window,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k_store, v_store, block_tables,
                                   q_pos, op, ml, out, B, H, Kv, N, Tk, M,
                                   bps, n_split, window, scale, s);
  return cudaErrorInvalidValue;
}
