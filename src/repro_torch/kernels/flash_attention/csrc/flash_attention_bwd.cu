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
// Design: two kernels, no atomics, deterministic.
//  * dQ: one CTA per (q tile of 64 rows, 32 at D = 256; query head; batch),
//    longest tiles first, looping over the admitted 32-key tiles as the
//    forward does.  Per tile a thread computes 4 (2) rows x 4 keys of s
//    and dO V^T in one pass over D, forms dS in registers, and dS goes
//    through shared memory into dS K; dq accumulates in f32 registers.
//  * dK/dV: one CTA per (key tile of 32 keys, 16 at D = 256; KV head;
//    batch).  It loops over the group's query heads and, for each, the
//    32-row q tiles that admit the tile, and accumulates dk and dv in f32
//    registers across the whole group before writing [B,Kv,S,D] once: K/V
//    is never repeated in memory and no [B,H,S,D] intermediate exists.
//    The TPU kernel computes per-query-head dk/dv in q's dtype and sums
//    the group outside; summing in f32 first rounds once (bf16 differs).
// Tiles are staged as f32 in shared memory with padded rows; CUDA-core
// FMAs (no wgmma/TMA).  Any S is taken without padding.
#include "flash_common.cuh"

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
                int Kv, int S, int causal, int window, float scale) {
  constexpr int BQ = flash::q_rows<D>();
  constexpr int RM = BQ / flash::RG;
  constexpr int TN = BK / KG;
  constexpr int LD = D + 1;
  constexpr int PS = BK + 1;
  constexpr int CPT = D / KG;
  const int tid = threadIdx.x;
  const int rg = tid / KG, kg = tid % KG;
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int valid_q = min(BQ, S - q0);

  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][LD]
  float* do_s = q_s + BQ * LD;   // [BQ][LD]
  float* k_s = do_s + BQ * LD;   // [BK][LD]
  float* v_s = k_s + BK * LD;    // [BK][LD]
  float* ds_s = v_s + BK * LD;   // [BQ][PS]

  const size_t row0 = (size_t)(b * H + h) * S;
  const size_t krow0 = (size_t)(b * Kv + kvh) * S;
  flash::load_rows<T, D>(q + (row0 + q0) * D, BQ, valid_q, q_s, LD);
  flash::load_rows<T, D>(dout + (row0 + q0) * D, BQ, valid_q, do_s, LD);

  float lse_r[RM], dsum_r[RM], acc[RM][CPT];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + rg * RM + i;
    lse_r[i] = qi < S ? lse[row0 + qi] : 0.f;
    dsum_r[i] = qi < S ? dsum[row0 + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(S, q0 + BQ) - 1 : S - 1;
  for (int kt = k_lo / BK; kt <= k_hi / BK; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    flash::load_rows<T, D>(k + (krow0 + k0) * D, BK, min(BK, S - k0), k_s,
                           LD);
    flash::load_rows<T, D>(v + (krow0 + k0) * D, BK, min(BK, S - k0), v_s,
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
        const float p = flash::admits(qi, kj, S, causal, window) && qi < S
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
                 T* __restrict__ dv, int H, int Kv, int S, int causal,
                 int window, float scale) {
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
  const int valid_k = min(BN, S - k0);

  extern __shared__ float smem[];
  float* k_s = smem;             // [BN][LD]
  float* v_s = k_s + BN * LD;    // [BN][LD]
  float* q_s = v_s + BN * LD;    // [BM][LD]
  float* do_s = q_s + BM * LD;   // [BM][LD]
  float* p_s = do_s + BM * LD;   // [BM][PS]
  float* ds_s = p_s + BM * PS;   // [BM][PS]

  const size_t krow0 = (size_t)(b * Kv + kvh) * S;
  flash::load_rows<T, D>(k + (krow0 + k0) * D, BN, valid_k, k_s, LD);
  flash::load_rows<T, D>(v + (krow0 + k0) * D, BN, valid_k, v_s, LD);

  float dk_acc[RN][CPT], dv_acc[RN][CPT];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  // rows that admit a key of this tile: [q_lo, q_hi]
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S - 1, k0 + valid_k - 1 + window - 1)
                              : S - 1;
  for (int g = 0; g < G; ++g) {
    const size_t row0 = (size_t)(b * H + kvh * G + g) * S;
    for (int qt = q_lo / BM; qt <= q_hi / BM; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();  // the last step's readers are done
      flash::load_rows<T, D>(q + (row0 + q0) * D, BM, min(BM, S - q0), q_s,
                             LD);
      flash::load_rows<T, D>(dout + (row0 + q0) * D, BM, min(BM, S - q0),
                             do_s, LD);
      float lse_r[RM], dsum_r[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int qi = q0 + rg * RM + i;
        lse_r[i] = qi < S ? lse[row0 + qi] : 0.f;
        dsum_r[i] = qi < S ? dsum[row0 + qi] : 0.f;
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
          const float p = flash::admits(qi, kj, S, causal, window) && qi < S
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
                      void* dq, int B, int H, int Kv, int S, int causal,
                      int window, float scale, cudaStream_t stream) {
  constexpr int BQ = flash::q_rows<D>();
  const size_t smem = sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * (D + 1) +
                                       (size_t)BQ * (BK + 1));
  auto kern = flash_dq_kernel<T, D>;
  cudaError_t e = flash::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((S + BQ - 1) / BQ, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dq), H, Kv, S, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dk, void* dv, int B, int H, int Kv, int S,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  constexpr int BN = flash::kv_rows<D>();
  const size_t smem = sizeof(float) * ((size_t)(2 * BN + 2 * BM) * (D + 1) +
                                       (size_t)2 * BM * (BN + 1));
  auto kern = flash_dkv_kernel<T, D>;
  cudaError_t e = flash::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((S + BN - 1) / BN, Kv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Kv, S, causal, window,
      scale);
  return cudaGetLastError();
}

#define FLASH_BWD_DISPATCH(FN, ...)                                   \
  switch (D) {                                                        \
    case 16: return FN<T, 16>(__VA_ARGS__);                           \
    case 64: return FN<T, 64>(__VA_ARGS__);                           \
    case 128: return FN<T, 128>(__VA_ARGS__);                         \
    case 256: return FN<T, 256>(__VA_ARGS__);                         \
    default: return cudaErrorInvalidValue;                            \
  }

template <typename T>
cudaError_t dispatch_dq(int D, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dsum,
                        void* dq, int B, int H, int Kv, int S, int causal,
                        int window, float scale, cudaStream_t s) {
  FLASH_BWD_DISPATCH(launch_dq, q, k, v, dout, lse, dsum, dq, B, H, Kv, S,
                     causal, window, scale, s)
}

template <typename T>
cudaError_t dispatch_dkv(int D, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* dsum,
                         void* dk, void* dv, int B, int H, int Kv, int S,
                         int causal, int window, float scale,
                         cudaStream_t s) {
  FLASH_BWD_DISPATCH(launch_dkv, q, k, v, dout, lse, dsum, dk, dv, B, H, Kv,
                     S, causal, window, scale, s)
}

bool bad_shape(int B, int H, int Kv, int S) {
  return Kv <= 0 || H % Kv != 0 || H > 65535 || Kv > 65535 || B > 65535 ||
         S <= 0;
}

}  // namespace

// q, dout [B,H,S,D]; k, v [B,Kv,S,D]; lse, dsum [B,H,S] f32; dq [B,H,S,D].
// causal: 0/1; window <= 0 = none.  dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t.
extern "C" int flash_attention_dq_launch(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* dsum,
                                         void* dq, int B, int H, int Kv,
                                         int S, int D, int causal,
                                         int window, float scale, int dtype,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, Kv, S)) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_dq<float>(D, q, k, v, dout, lse, dsum, dq, B, H, Kv, S,
                              causal, window, scale, s);
  if (dtype == 1)
    return dispatch_dq<__nv_bfloat16>(D, q, k, v, dout, lse, dsum, dq, B, H,
                                      Kv, S, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

// As above; dk, dv [B,Kv,S,D], each group of H / Kv query heads summed.
extern "C" int flash_attention_dkv_launch(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* dsum,
                                          void* dk, void* dv, int B, int H,
                                          int Kv, int S, int D, int causal,
                                          int window, float scale, int dtype,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, H, Kv, S)) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_dkv<float>(D, q, k, v, dout, lse, dsum, dk, dv, B, H, Kv,
                               S, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_dkv<__nv_bfloat16>(D, q, k, v, dout, lse, dsum, dk, dv, B,
                                       H, Kv, S, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
