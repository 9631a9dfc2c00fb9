// Flash attention backward for Hopper (sm_90a): the FlashAttention-2
// gradients of the forward in flash_attention.cu, recomputing the
// probabilities from the forward's logsumexp instead of reading stored
// scores.  With s = D^-0.5 q.k, P = exp(s - lse) under the mask and
// Dsum_i = rowsum(dO_i * O_i) (computed by the wrapper):
//
//   dQ_i = D^-0.5 sum_j dS_ij k_j,  dS_ij = P_ij (dO_i . v_j - Dsum_i)
//   dV_j = sum_i P_ij dO_i,         dK_j = D^-0.5 sum_i dS_ij q_i
//
// Replaces: src/repro/kernels/flash_attention/flash_attention_bwd.py,
// flash_attention_bwd (:125): the Pallas TPU kernels `_dq_kernel` (:43)
// and `_dkv_kernel` (:76).
//
// Bound on this card: operations.  At yi-6b's training shapes (B 2, H 32,
// Kv 4, S 4096, D 128, bf16, causal) the FA2 minimum is 2.5x the
// forward's 274.9 GFLOP, 0.695 ms at the bf16 tensor-core peak; these two
// kernels, as the TPU kernels do, each recompute QK^T and dO V^T, 3.5x the
// forward, 0.973 ms.  The bytes (q, k, v, o, dO, lse, Dsum in; dq, dk, dv
// out) take ~0.08 ms at 3.35 TB/s.
//
// Two routes, a fixed dispatch on dtype and head dim in the extern "C"
// entry points (flash_attention_bwd.py's `bwd_route` states the same rule;
// it is no fallback, and a launch that fails returns its error):
//
// * Tensor cores: bf16 at D 64, 120 and 128 (`flash_dq_kernel_wgmma`,
//   `flash_dkv_kernel_wgmma`).  A CTA is one consumer warpgroup and one
//   producer warp.  The producer issues TMA loads (3-D tensor maps over
//   [B*H or B*Kv, S, D], 64-column boxes in the 128-byte swizzle, so the
//   hardware zero-fills the ragged S tail and D = 120's columns 120-127
//   without crossing into the next head) into a ring of two stages with
//   full/empty mbarriers, so the next tile arrives during the current
//   tile's products.  Every product is wgmma m64nNk16 with bf16 operands
//   and f32 accumulators: the first two (S = Q K^T, dP = dO V^T, or their
//   transposes) read both operands from shared memory K-major; P and dS
//   are formed in registers, rounded to bf16 and fed back as the A operand
//   in registers of the second products (dV += P^T dO, dK += dS^T Q,
//   dQ += dS K), whose B operand is the same shared tile read MN-major.
//   Rounding P and dS to bf16 is what FlashAttention-2/3 and SDPA do; the
//   reference keeps them in f32 (ROADMAP Queue 3 logs the difference).
//    - dK/dV: one CTA per (64 keys, KV head, batch), key tile 0 first
//      (under the causal mask it has the most work).  K and V stay in
//      shared memory; the CTA walks the group's G query heads and, for
//      each, the 64-row q tiles that admit its keys, forming
//      S^T = K Q^T, dP^T = V dO^T, P^T = exp(scale S^T - lse) under the
//      mask and dS^T = P^T (dP^T - Dsum); dK and dV accumulate in f32
//      registers across the whole group and are written once (no
//      atomics, deterministic).  The producer also stages each q tile's
//      lse and Dsum.  64 keys give 256 CTAs at one microbatch of yi-6b
//      (B 1, Kv 4, S 4096) for 132 SMs, one CTA per SM (about 230
//      registers a thread at D 128: dK, dV, S^T and dP^T in f32; two
//      CTAs per SM would cap a thread at 200).
//    - dQ: one CTA per (64 q rows, query head, batch), longest tiles
//      first, walking the admitted 64-key tiles: S = Q K^T, dP = dO V^T,
//      dS, then dQ += dS K; two CTAs per SM (about 155 registers at
//      D 128).
//   Tiles wholly inside the mask skip the mask test.
// * CUDA cores: f32 at every D (the route phase 5's card-against-CPU
//   training parity measures) and bf16 at D 16 and 256 (D 256's 64 x 256
//   f32 dK and dV accumulators exceed one warpgroup's registers).
//    - dQ: one CTA per (q tile of 64 rows, 32 at D = 256; query head;
//      batch), longest tiles first, looping over the admitted 32-key tiles
//      as the forward does.  Per tile a thread computes 4 (2) rows x 4
//      keys of s and dO V^T in one pass over D, forms dS in registers, and
//      dS goes through shared memory into dS K; dq accumulates in f32
//      registers.
//    - dK/dV: one CTA per (key tile of 32 keys, 16 at D = 256; KV head;
//      batch).  It loops over the group's query heads and, for each, the
//      32-row q tiles that admit the tile, and accumulates dk and dv in
//      f32 registers across the whole group before writing [B,Kv,S,D]
//      once.  Tiles are staged as f32 in shared memory with padded rows;
//      scalar FMAs.
// The TPU kernel computes per-query-head dk/dv in q's dtype and sums the
// group outside; both routes sum in f32 first and round once.  Any S is
// taken without padding.  Keys may be of another length Sk than the
// queries' Sq, as in the forward, without a mask only (the entry points
// refuse a causal or windowed call at Sk != Sq): dQ's CTAs and its valid
// rows, lse and Dsum follow Sq and its key loop Sk; dK/dV's CTAs follow Sk
// and its loop over q tiles Sq.
#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using flash::BK;
using flash::BM;
using flash::KG;
using flash::kThreads;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ dsum, T* __restrict__ dq, int H,
                int Kv, int Sq, int Sk, int causal, int window, float scale) {
  constexpr int BQ = flash::q_rows<D>();
  constexpr int RM = BQ / flash::RG;
  constexpr int TN = BK / KG;
  constexpr int LD = D + 1;
  constexpr int PS = BK + 1;
  constexpr int CPT = D / KG;
  const int tid = threadIdx.x;
  const int rg = tid / KG, kg = tid % KG;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int valid_q = min(BQ, Sq - q0);

  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][LD]
  float* do_s = q_s + BQ * LD;   // [BQ][LD]
  float* k_s = do_s + BQ * LD;   // [BK][LD]
  float* v_s = k_s + BK * LD;    // [BK][LD]
  float* ds_s = v_s + BK * LD;   // [BQ][PS]

  const size_t row0 = (size_t)(b * H + h) * Sq;
  const size_t krow0 = (size_t)(b * Kv + kvh) * Sk;
  flash::load_rows<T, D>(q + (row0 + q0) * D, BQ, valid_q, q_s, LD);
  flash::load_rows<T, D>(dout + (row0 + q0) * D, BQ, valid_q, do_s, LD);

  float lse_r[RM], dsum_r[RM], acc[RM][CPT];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + rg * RM + i;
    lse_r[i] = qi < Sq ? lse[row0 + qi] : 0.f;
    dsum_r[i] = qi < Sq ? dsum[row0 + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q0 + BQ) - 1 : Sk - 1;
  for (int kt = k_lo / BK; kt <= k_hi / BK; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    flash::load_rows<T, D>(k + (krow0 + k0) * D, BK, min(BK, Sk - k0), k_s,
                           LD);
    flash::load_rows<T, D>(v + (krow0 + k0) * D, BK, min(BK, Sk - k0), v_s,
                           LD);
    __syncthreads();

    float sc[RM][TN], dp[RM][TN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[RM], g[RM], kk[TN], vv[TN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        a[i] = q_s[(rg * RM + i) * LD + d];
        g[i] = do_s[(rg * RM + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        kk[j] = k_s[(kg + KG * j) * LD + d];
        vv[j] = v_s[(kg + KG * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
          dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + rg * RM + i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kj = k0 + kg + KG * j;
        const float p = flash::admits(qi, kj, Sk, causal, window) && qi < Sq
                            ? expf(sc[i][j] * scale - lse_r[i])
                            : 0.f;
        ds_s[(rg * RM + i) * PS + kg + KG * j] = p * (dp[i][j] - dsum_r[i]);
      }
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float kk[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kk[c] = k_s[j * LD + kg + KG * c];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float ds = ds_s[(rg * RM + i) * PS + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(ds, kk[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = rg * RM + i;
    if (r >= valid_q) continue;
    T* o = dq + (row0 + q0 + r) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      o[kg + KG * c] = attn::from_float<T>(acc[i][c] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int Kv, int Sq, int Sk,
                 int causal, int window, float scale) {
  constexpr int BN = flash::kv_rows<D>();
  constexpr int RM = BM / flash::RG;   // q rows per thread, score step
  constexpr int TN = BN / KG;          // keys per thread, score step
  constexpr int RN = BN / flash::RG;   // keys per thread, accumulate step
  constexpr int LD = D + 1;
  constexpr int PS = BN + 1;
  constexpr int CPT = D / KG;
  const int tid = threadIdx.x;
  const int rg = tid / KG, kg = tid % KG;
  const int k0 = blockIdx.x * BN;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kv;
  const int valid_k = min(BN, Sk - k0);

  extern __shared__ float smem[];
  float* k_s = smem;             // [BN][LD]
  float* v_s = k_s + BN * LD;    // [BN][LD]
  float* q_s = v_s + BN * LD;    // [BM][LD]
  float* do_s = q_s + BM * LD;   // [BM][LD]
  float* p_s = do_s + BM * LD;   // [BM][PS]
  float* ds_s = p_s + BM * PS;   // [BM][PS]

  const size_t krow0 = (size_t)(b * Kv + kvh) * Sk;
  flash::load_rows<T, D>(k + (krow0 + k0) * D, BN, valid_k, k_s, LD);
  flash::load_rows<T, D>(v + (krow0 + k0) * D, BN, valid_k, v_s, LD);

  float dk_acc[RN][CPT], dv_acc[RN][CPT];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // rows that admit a key of this tile: [q_lo, q_hi]
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq - 1, k0 + valid_k - 1 + window - 1)
                              : Sq - 1;
  for (int g = 0; g < G; ++g) {
    const size_t row0 = (size_t)(b * H + kvh * G + g) * Sq;
    for (int qt = q_lo / BM; qt <= q_hi / BM; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();  // the last step's readers are done
      flash::load_rows<T, D>(q + (row0 + q0) * D, BM, min(BM, Sq - q0), q_s,
                             LD);
      flash::load_rows<T, D>(dout + (row0 + q0) * D, BM, min(BM, Sq - q0),
                             do_s, LD);
      float lse_r[RM], dsum_r[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int qi = q0 + rg * RM + i;
        lse_r[i] = qi < Sq ? lse[row0 + qi] : 0.f;
        dsum_r[i] = qi < Sq ? dsum[row0 + qi] : 0.f;
      }
      __syncthreads();

      float sc[RM][TN], dp[RM][TN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float a[RM], gg[RM], kk[TN], vv[TN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          a[i] = q_s[(rg * RM + i) * LD + d];
          gg[i] = do_s[(rg * RM + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          kk[j] = k_s[(kg + KG * j) * LD + d];
          vv[j] = v_s[(kg + KG * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
            dp[i][j] = fmaf(gg[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int qi = q0 + rg * RM + i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int kj = k0 + kg + KG * j;
          const float p = flash::admits(qi, kj, Sk, causal, window) && qi < Sq
                              ? expf(sc[i][j] * scale - lse_r[i])
                              : 0.f;
          p_s[(rg * RM + i) * PS + kg + KG * j] = p;
          ds_s[(rg * RM + i) * PS + kg + KG * j] = p * (dp[i][j] - dsum_r[i]);
        }
      }
      __syncthreads();

      for (int mi = 0; mi < BM; ++mi) {
        float gq[CPT], qq[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          gq[c] = do_s[mi * LD + kg + KG * c];
          qq[c] = q_s[mi * LD + kg + KG * c];
        }
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          const float p = p_s[mi * PS + rg * RN + r];
          const float ds = ds_s[mi * PS + rg * RN + r];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            dv_acc[r][c] = fmaf(p, gq[c], dv_acc[r][c]);
            dk_acc[r][c] = fmaf(ds, qq[c], dk_acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int kr = rg * RN + r;
    if (kr >= valid_k) continue;
    T* ok = dk + (krow0 + k0 + kr) * D;
    T* ov = dv + (krow0 + k0 + kr) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      ok[kg + KG * c] = attn::from_float<T>(dk_acc[r][c] * scale);
      ov[kg + KG * c] = attn::from_float<T>(dv_acc[r][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dsum,
                      void* dq, int B, int H, int Kv, int Sq, int Sk,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  constexpr int BQ = flash::q_rows<D>();
  const size_t smem = sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (D + 1) +
                                       (size_t)BQ * (BK + 1));
  auto kern = flash_dq_kernel<T, D>;
  cudaError_t e = flash::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((Sq + BQ - 1) / BQ, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dq), H, Kv, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dk, void* dv, int B, int H, int Kv, int Sq,
                       int Sk, int causal, int window, float scale,
                       cudaStream_t stream) {
  constexpr int BN = flash::kv_rows<D>();
  const size_t smem = sizeof(float) * ((size_t)(2 * BN + 2 * BM) * (D + 1) +
                                       (size_t)2 * BM * (BN + 1));
  auto kern = flash_dkv_kernel<T, D>;
  cudaError_t e = flash::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((Sk + BN - 1) / BN, Kv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Kv, Sq, Sk, causal,
      window, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// Tensor-core route: bf16 at D 64, 120 and 128.
namespace tc {

using hopper::desc_k;
using hopper::desc_mn;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_wait;
using hopper::pack_bf16;
using hopper::smem_u32;
using hopper::tma_load_3d;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_rs;
using hopper::wgmma_ss_n64;
using hopper::wgmma_wait;

using namespace flash_tc;

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int H, int Kv,
                       int Sq, int Sk, int causal, int window, float scale) {
  constexpr int DP = padded<D>();
  constexpr int KV_CHUNK = kKeys * 128, Q_CHUNK = kRows * 128;
  constexpr int KV_BYTES = tile_bytes<DP>(kKeys);
  constexpr int Q_BYTES = tile_bytes<DP>(kRows);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align1024(smem_raw);
  uint8_t* v_s = k_s + KV_BYTES;
  uint8_t* q_s = v_s + KV_BYTES;            // [kStages][Q_BYTES]
  uint8_t* do_s = q_s + kStages * Q_BYTES;  // [kStages][Q_BYTES]
  __shared__ float lse_s[kStages][kRows];   // lse * log2(e)
  __shared__ float dsum_s[kStages][kRows];
  __shared__ __align__(8) uint64_t kv_full, full[kStages], empty[kStages];

  const int k0 = blockIdx.x * kKeys;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kv;
  const int valid_k = min(kKeys, Sk - k0);
  // q rows that admit a key of this tile: [q_lo, q_hi]
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq - 1, k0 + valid_k - 1 + window - 1)
                              : Sq - 1;
  const int qt_lo = q_lo / kRows;
  const int n_qt = q_hi / kRows - qt_lo + 1;
  const int n_it = G * n_qt;  // (query head, q tile) steps

  if (threadIdx.x == 0) {
    hopper::mbar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (role() == 1) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    if (lane == 0) {
      const int bkv = b * Kv + kvh;
      mbar_arrive_expect_tx(&kv_full, 2 * KV_BYTES);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c) {
        tma_load_3d(k_s + c * KV_CHUNK, &tm_k, &kv_full, c * 64, k0, bkv);
        tma_load_3d(v_s + c * KV_CHUNK, &tm_v, &kv_full, c * 64, k0, bkv);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int q0 = (qt_lo + it % n_qt) * kRows;
      const int bh = b * H + kvh * G + it / n_qt;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      const size_t row0 = (size_t)bh * Sq;
      for (int r = lane; r < kRows; r += 32) {
        const int qi = q0 + r;
        lse_s[s][r] = qi < Sq ? lse[row0 + qi] * kLog2e : 0.f;
        dsum_s[s][r] = qi < Sq ? dsum[row0 + qi] : 0.f;
      }
      // every lane arrives after its own lse/Dsum stores; lane 0 also
      // sets the bytes the phase waits for
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * Q_BYTES);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c) {
          tma_load_3d(q_s + s * Q_BYTES + c * Q_CHUNK, &tm_q, &full[s],
                      c * 64, q0, bh);
          tma_load_3d(do_s + s * Q_BYTES + c * Q_CHUNK, &tm_do, &full[s],
                      c * 64, q0, bh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // the consumer warpgroup: accumulator rows `row` and `row + 8` (keys),
  // columns `col + 8j` and `col + 8j + 1` (q rows of the step)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 4, col = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  mbar_wait(&kv_full, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int q0 = (qt_lo + it % n_qt) * kRows;
    const uint32_t q_addr = smem_u32(q_s + s * Q_BYTES);
    const uint32_t do_addr = smem_u32(do_s + s * Q_BYTES);
    mbar_wait(&full[s], (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T, [keys, q rows]
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16)
      wgmma_ss_n64(st, desc_k(k_addr, KV_CHUNK, kk),
                   desc_k(q_addr, Q_CHUNK, kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16)
      wgmma_ss_n64(dpt, desc_k(v_addr, KV_CHUNK, kk),
                   desc_k(do_addr, Q_CHUNK, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T, while dP^T is still in flight; keys past Sk and q rows past
    // Sq (TMA reads both as zeros) give p = 0
    const bool whole = whole_tile(q0, k0, Sq, Sk, causal, window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = col + 8 * (i / 4) + (i % 2);
      float p = hopper::exp2_approx(st[i] * scale_log2 - lse_s[s][c]);
      if (!whole) {
        const int qi = q0 + c, kj = k0 + row + 8 * ((i / 2) % 2);
        if (!(qi < Sq && flash::admits(qi, kj, Sk, causal, window))) p = 0.f;
      }
      st[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dpt);
    // dS^T = P^T (dP^T - Dsum); both rounded to bf16 as A operands
    uint32_t pa[kRows / 16][4], da[kRows / 16][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = col + 8 * (i / 4) + (i % 2);
      dpt[i] = st[i] * (dpt[i] - dsum_s[s][c]);
    }
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        pa[kk][x] = pack_bf16(st[8 * kk + 2 * x], st[8 * kk + 2 * x + 1]);
        da[kk][x] = pack_bf16(dpt[8 * kk + 2 * x], dpt[8 * kk + 2 * x + 1]);
      }

    // dV += P^T dO, dK += dS^T Q: B read MN-major from the same tiles
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_rs<DP>(dv_acc, pa[kk], desc_mn(do_addr, Q_CHUNK, 16 * kk));
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_rs<DP>(dk_acc, da[kk], desc_mn(q_addr, Q_CHUNK, 16 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    mbar_arrive(&empty[s]);  // this stage's tiles, lse and Dsum are read
  }

  const size_t krow0 = (size_t)(b * Kv + kvh) * Sk + k0;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int r = row + 8 * ((i / 2) % 2), c = col + 8 * (i / 4);
    if (r < valid_k && c < D) {
      const size_t o = (krow0 + r) * D + c;
      *reinterpret_cast<uint32_t*>(dk + o) =
          pack_bf16(dk_acc[i] * scale, dk_acc[i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 2)
flash_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dq, int H, int Kv,
                      int Sq, int Sk, int causal, int window, float scale) {
  constexpr int DP = padded<D>();
  constexpr int KV_CHUNK = kKeys * 128, Q_CHUNK = kRows * 128;
  constexpr int KV_BYTES = tile_bytes<DP>(kKeys);
  constexpr int Q_BYTES = tile_bytes<DP>(kRows);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* do_s = q_s + Q_BYTES;
  uint8_t* k_s = do_s + Q_BYTES;             // [kStages][KV_BYTES]
  uint8_t* v_s = k_s + kStages * KV_BYTES;   // [kStages][KV_BYTES]
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];

  const int n_qt = (Sq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kRows;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, bkv = b * Kv + h / (H / Kv);
  const int valid_q = min(kRows, Sq - q0);
  // admitted keys of this tile's rows: [k_lo, k_hi]
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q0 + kRows) - 1 : Sk - 1;
  const int kt_lo = k_lo / kKeys;
  const int n_it = k_hi / kKeys - kt_lo + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (role() == 1) {  // the producer warp: one lane issues
    if (threadIdx.x != kConsumers) return;
    mbar_arrive_expect_tx(&q_full, 2 * Q_BYTES);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
      tma_load_3d(q_s + c * Q_CHUNK, &tm_q, &q_full, c * 64, q0, bh);
      tma_load_3d(do_s + c * Q_CHUNK, &tm_do, &q_full, c * 64, q0, bh);
    }
    stream_kv<DP>(k_s, v_s, &tm_k, &tm_v, full, empty, kt_lo, n_it, bkv);
    return;
  }

  // the consumer warpgroup: accumulator rows `row` and `row + 8` (q rows),
  // columns `col + 8j` and `col + 8j + 1` (keys of the step)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 4, col = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  float lse2[2], ds_row[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qi = q0 + row + 8 * e;
    lse2[e] = qi < Sq ? lse[(size_t)bh * Sq + qi] * kLog2e : 0.f;
    ds_row[e] = qi < Sq ? dsum[(size_t)bh * Sq + qi] : 0.f;
  }
  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);
  mbar_wait(&q_full, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int k0 = (kt_lo + it) * kKeys;
    const uint32_t k_addr = smem_u32(k_s + s * KV_BYTES);
    const uint32_t v_addr = smem_u32(v_s + s * KV_BYTES);
    mbar_wait(&full[s], (it / kStages) & 1);

    // S = Q K^T and dP = dO V^T, [q rows, keys]
    float st[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16)
      wgmma_ss_n64(st, desc_k(q_addr, Q_CHUNK, kk),
                   desc_k(k_addr, KV_CHUNK, kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16)
      wgmma_ss_n64(dp, desc_k(do_addr, Q_CHUNK, kk),
                   desc_k(v_addr, KV_CHUNK, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    const bool whole = whole_tile(q0, k0, Sq, Sk, causal, window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = (i / 2) % 2;
      float p = hopper::exp2_approx(st[i] * scale_log2 - lse2[e]);
      if (!whole) {
        const int qi = q0 + row + 8 * e, kj = k0 + col + 8 * (i / 4) + (i % 2);
        if (!(qi < Sq && flash::admits(qi, kj, Sk, causal, window))) p = 0.f;
      }
      st[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[kKeys / 16][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = st[i] * (dp[i] - ds_row[(i / 2) % 2]);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        da[kk][x] = pack_bf16(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);

    // dQ += dS K: K read MN-major from the same tile
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs<DP>(dq_acc, da[kk], desc_mn(k_addr, KV_CHUNK, 16 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    mbar_arrive(&empty[s]);  // this stage's K and V are read
  }

  const size_t qrow0 = (size_t)bh * Sq + q0;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int r = row + 8 * ((i / 2) % 2), c = col + 8 * (i / 4);
    if (r < valid_q && c < D)
      *reinterpret_cast<uint32_t*>(dq + (qrow0 + r) * D + c) =
          pack_bf16(dq_acc[i] * scale, dq_acc[i + 1] * scale);
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dsum,
                      void* dq, int B, int H, int Kv, int Sq, int Sk,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::make_map(&mq, q, B * H, Sq, D, kRows) ||
      !hopper::make_map(&mdo, dout, B * H, Sq, D, kRows) ||
      !hopper::make_map(&mk, k, B * Kv, Sk, D, kKeys) ||
      !hopper::make_map(&mv, v, B * Kv, Sk, D, kKeys))
    return cudaErrorNotSupported;
  constexpr int DP = padded<D>();
  const size_t smem =
      1024 + 2 * tile_bytes<DP>(kRows) + 2 * kStages * tile_bytes<DP>(kKeys);
  auto kern = flash_dq_kernel_wgmma<D>;
  cudaError_t e = flash::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((Sq + kRows - 1) / kRows, H, B), kThreadsTC, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dq), H,
      Kv, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dk, void* dv, int B, int H, int Kv, int Sq,
                       int Sk, int causal, int window, float scale,
                       cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::make_map(&mq, q, B * H, Sq, D, kRows) ||
      !hopper::make_map(&mdo, dout, B * H, Sq, D, kRows) ||
      !hopper::make_map(&mk, k, B * Kv, Sk, D, kKeys) ||
      !hopper::make_map(&mv, v, B * Kv, Sk, D, kKeys))
    return cudaErrorNotSupported;
  constexpr int DP = padded<D>();
  const size_t smem =
      1024 + 2 * tile_bytes<DP>(kKeys) + 2 * kStages * tile_bytes<DP>(kRows);
  auto kern = flash_dkv_kernel_wgmma<D>;
  cudaError_t e = flash::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((Sk + kKeys - 1) / kKeys, Kv, B), kThreadsTC, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Kv, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace tc

#define FLASH_BWD_CASE(FN, DV, ...) \
  case DV:                          \
    return FN<DV>(__VA_ARGS__);

cudaError_t dispatch_dq_tc(int D, const void* q, const void* k,
                           const void* v, const void* dout, const void* lse,
                           const void* dsum, void* dq, int B, int H, int Kv,
                           int Sq, int Sk, int causal, int window,
                           float scale, cudaStream_t s) {
  switch (D) {
    FLASH_BWD_CASE(tc::launch_dq, 64, q, k, v, dout, lse, dsum, dq, B, H,
                   Kv, Sq, Sk, causal, window, scale, s)
    FLASH_BWD_CASE(tc::launch_dq, 120, q, k, v, dout, lse, dsum, dq, B, H,
                   Kv, Sq, Sk, causal, window, scale, s)
    FLASH_BWD_CASE(tc::launch_dq, 128, q, k, v, dout, lse, dsum, dq, B, H,
                   Kv, Sq, Sk, causal, window, scale, s)
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_dkv_tc(int D, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* dsum, void* dk, void* dv, int B,
                            int H, int Kv, int Sq, int Sk, int causal,
                            int window, float scale, cudaStream_t s) {
  switch (D) {
    FLASH_BWD_CASE(tc::launch_dkv, 64, q, k, v, dout, lse, dsum, dk, dv, B,
                   H, Kv, Sq, Sk, causal, window, scale, s)
    FLASH_BWD_CASE(tc::launch_dkv, 120, q, k, v, dout, lse, dsum, dk, dv, B,
                   H, Kv, Sq, Sk, causal, window, scale, s)
    FLASH_BWD_CASE(tc::launch_dkv, 128, q, k, v, dout, lse, dsum, dk, dv, B,
                   H, Kv, Sq, Sk, causal, window, scale, s)
    default: return cudaErrorInvalidValue;
  }
}

// the CUDA-core kernels: f32 at every head dim, bf16 at D 16 and 256
template <typename T>
cudaError_t dispatch_dq(int D, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dsum,
                        void* dq, int B, int H, int Kv, int Sq, int Sk,
                        int causal, int window, float scale, cudaStream_t s) {
  constexpr bool f32 = std::is_same<T, float>::value;
#define FLASH_DQ(DV) \
  return launch_dq<T, DV>(q, k, v, dout, lse, dsum, dq, B, H, Kv, Sq, Sk, causal, window, scale, s)
  switch (D) {
    case 16: FLASH_DQ(16);
    case 256: FLASH_DQ(256);
    case 64: if constexpr (f32) FLASH_DQ(64); break;
    case 120: if constexpr (f32) FLASH_DQ(120); break;
    case 128: if constexpr (f32) FLASH_DQ(128); break;
  }
#undef FLASH_DQ
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dkv(int D, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* dsum,
                         void* dk, void* dv, int B, int H, int Kv, int Sq,
                         int Sk, int causal, int window, float scale,
                         cudaStream_t s) {
  constexpr bool f32 = std::is_same<T, float>::value;
#define FLASH_DKV(DV) \
  return launch_dkv<T, DV>(q, k, v, dout, lse, dsum, dk, dv, B, H, Kv, Sq, Sk, causal, window, scale, s)
  switch (D) {
    case 16: FLASH_DKV(16);
    case 256: FLASH_DKV(256);
    case 64: if constexpr (f32) FLASH_DKV(64); break;
    case 120: if constexpr (f32) FLASH_DKV(120); break;
    case 128: if constexpr (f32) FLASH_DKV(128); break;
  }
#undef FLASH_DKV
  return cudaErrorInvalidValue;
}

bool bad_shape(int B, int H, int Kv, int Sq, int Sk, int causal,
               int window) {
  return Kv <= 0 || H % Kv != 0 || H > 65535 || Kv > 65535 || B > 65535 ||
         Sq <= 0 || Sk <= 0 || (Sk != Sq && (causal || window > 0));
}

}  // namespace

// 1 when a call of this head dim and dtype (0 = float32, 1 = bfloat16)
// takes the tensor-core kernels, 0 when it takes the CUDA-core ones.
extern "C" int flash_attention_bwd_route(int D, int dtype) {
  return flash_tc::tensor_core_route(D, dtype) ? 1 : 0;
}

// q, dout [B,H,Sq,D]; k, v [B,Kv,Sk,D]; lse, dsum [B,H,Sq] f32; dq
// [B,H,Sq,D].  causal: 0/1; window <= 0 = none; Sk != Sq only with
// neither.  dtype: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaError_t.
extern "C" int flash_attention_dq_launch(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* dsum,
                                         void* dq, int B, int H, int Kv,
                                         int Sq, int Sk, int D, int causal,
                                         int window, float scale, int dtype,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, Kv, Sq, Sk, causal, window))
    return cudaErrorInvalidValue;
  if (flash_tc::tensor_core_route(D, dtype))
    return dispatch_dq_tc(D, q, k, v, dout, lse, dsum, dq, B, H, Kv, Sq, Sk,
                          causal, window, scale, s);
  if (dtype == 0)
    return dispatch_dq<float>(D, q, k, v, dout, lse, dsum, dq, B, H, Kv, Sq,
                              Sk, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(D, q, k, v, dout, lse, dsum, dq, B, H,
                                      Kv, Sq, Sk, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

// As above; dk, dv [B,Kv,Sk,D], each group of H / Kv query heads summed.
extern "C" int flash_attention_dkv_launch(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* dsum,
                                          void* dk, void* dv, int B, int H,
                                          int Kv, int Sq, int Sk, int D,
                                          int causal, int window, float scale,
                                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, Kv, Sq, Sk, causal, window))
    return cudaErrorInvalidValue;
  if (flash_tc::tensor_core_route(D, dtype))
    return dispatch_dkv_tc(D, q, k, v, dout, lse, dsum, dk, dv, B, H, Kv, Sq,
                           Sk, causal, window, scale, s);
  if (dtype == 0)
    return dispatch_dkv<float>(D, q, k, v, dout, lse, dsum, dk, dv, B, H, Kv,
                               Sq, Sk, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(D, q, k, v, dout, lse, dsum, dk, dv, B,
                                       H, Kv, Sq, Sk, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
