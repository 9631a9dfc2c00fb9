// Flash attention forward for Hopper (sm_90a): causal, sliding-window and
// non-causal GQA self-attention, q [B,H,S,D] against k/v [B,Kv,S,D], with
// an optional logsumexp output lse [B,H,S] f32 for the backward kernels.
// Query head h reads KV head h / (H / Kv).  A query q admits key k when
// k < S, k <= q (causal) and q - k < window (window > 0).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// flash_attention (:83) and flash_attention_fwd_lse (:135), both over the
// Pallas TPU kernel `_kernel` (:31).
//
// Bound on this card: operations.  At yi-6b's training shapes (B 2, H 32,
// Kv 4, S 4096, D 128, bf16, causal) the admitted pairs need 274.9 GFLOP
// of QK^T and PV, 0.278 ms at the bf16 tensor-core peak, against ~152 MB
// of q, k, v, o and lse, 0.045 ms at 3.35 TB/s.
//
// Design: one CTA per (q tile of 64 rows, 32 at D = 256; query head;
// batch), the tiles with the most keys launched first.  The TPU kernel's
// sequential kv grid axis becomes a loop inside the CTA over the 32-key
// tiles from the window's first tile to the diagonal tile only, each
// staged in shared memory as f32 (padded rows, conflict-free reads).  The
// online softmax state lives in registers: a thread owns 4 (2) rows and 4
// keys of the score tile and the same rows times D/8 columns of the
// output, so the row max and sum are three xor-shuffles among the 8 lanes
// of a row group.  Scores are scaled by D^-0.5 after the dot, as the TPU
// kernel does; the probabilities go through shared memory into P V.  At
// the end o = acc / l (0 where l == 0) and, when lse is not null,
// lse = m + log(max(l, 1e-30)).  Any S is taken without padding.  CUDA-core
// FMAs (no wgmma/TMA): a first kernel that is right, far from its bound.
#include "flash_common.cuh"

namespace {

using flash::BK;
using flash::KG;
using flash::kThreads;

constexpr int PS = BK + 1;  // padded row stride of the probability tile
constexpr int TN = BK / KG; // keys per thread in the score step

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Kv, int S, int causal,
                 int window, float scale) {
  constexpr int BQ = flash::q_rows<D>();
  constexpr int RM = BQ / flash::RG;   // query rows per thread
  constexpr int LD = D + 1;
  constexpr int CPT = D / KG;          // output columns per thread
  const int tid = threadIdx.x;
  const int rg = tid / KG, kg = tid % KG;
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int valid_q = min(BQ, S - q0);

  extern __shared__ float smem[];
  float* q_s = smem;            // [BQ][LD]
  float* k_s = q_s + BQ * LD;   // [BK][LD]
  float* v_s = k_s + BK * LD;   // [BK][LD]
  float* p_s = v_s + BK * LD;   // [BQ][PS]

  const size_t row0 = (size_t)(b * H + h) * S;     // this head's first row
  const size_t krow0 = (size_t)(b * Kv + kvh) * S;
  flash::load_rows<T, D>(q + (row0 + q0) * D, BQ, valid_q, q_s, LD);

  float m[RM], l[RM], acc[RM][CPT];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = attn::NEG_INIT;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // admitted keys of this tile's rows: [k_lo, k_hi]
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(S, q0 + BQ) - 1 : S - 1;
  for (int kt = k_lo / BK; kt <= k_hi / BK; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's readers are done; q_s is loaded
    flash::load_rows<T, D>(k + (krow0 + k0) * D, BK, min(BK, S - k0), k_s,
                           LD);
    flash::load_rows<T, D>(v + (krow0 + k0) * D, BK, min(BK, S - k0), v_s,
                           LD);
    __syncthreads();

    float sc[RM][TN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RM], kk[TN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = q_s[(rg * RM + i) * LD + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) kk[j] = k_s[(kg + KG * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + rg * RM + i;
      float mx = attn::MASKED;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const bool ok = flash::admits(qi, k0 + kg + KG * j, S, causal, window);
        sc[i][j] = ok ? sc[i][j] * scale : attn::MASKED;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], flash::row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = sc[i][j] == attn::MASKED ? 0.f : expf(sc[i][j] - m_new);
        p_s[(rg * RM + i) * PS + kg + KG * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + flash::row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = v_s[j * LD + kg + KG * c];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = p_s[(rg * RM + i) * PS + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = rg * RM + i;
    if (r >= valid_q) continue;
    T* o = out + (row0 + q0 + r) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      o[kg + KG * c] =
          attn::from_float<T>(l[i] == 0.f ? 0.f : acc[i][c] / l[i]);
    if (lse != nullptr && kg == 0)
      lse[row0 + q0 + r] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int H, int Kv, int S, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr int BQ = flash::q_rows<D>();
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * PS);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = flash::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((S + BQ - 1) / BQ, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, Kv, S, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* out, void* lse, int B, int H, int Kv, int S,
                     int causal, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, lse, B, H, Kv, S, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, lse, B, H, Kv, S, causal, window, scale, s);
    case 120: return launch<T, 120>(q, k, v, out, lse, B, H, Kv, S, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, H, Kv, S, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, lse, B, H, Kv, S, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,S,D]; k/v [B,Kv,S,D]; out [B,H,S,D]; lse [B,H,S] f32 or null.
// causal: 0/1; window <= 0 = none.  dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out,
                                          void* lse, int B, int H, int Kv,
                                          int S, int D, int causal,
                                          int window, float scale, int dtype,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Kv <= 0 || H % Kv != 0 || H > 65535 || B > 65535 || S <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, out, lse, B, H, Kv, S, causal, window,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, out, lse, B, H, Kv, S, causal,
                                   window, scale, s);
  return cudaErrorInvalidValue;
}
