// Paged decode attention for Hopper (sm_90a): one query token per row
// against a K/V block store gathered through per-row block tables.
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
// Design: one CTA per (KV head, row).  It owns the G = H/Kv query heads that
// share the KV head, so each K/V block is read from device memory once per
// group, not once per query head.  The CTA walks its own table row — no
// scalar prefetch, no sequential grid axis — from the window start to the
// causal horizon q_pos // T only, and skips -1 entries without loading them,
// so device-memory traffic is exactly the live blocks of this row.  The
// online-softmax state (m, l, acc) stays in shared memory for the whole
// walk.  Scores are scaled by D^-0.5 after the dot, accumulation is f32,
// and the output is written in q's dtype.  A row no key admits (an idle
// engine slot: position 0, table row all -1) writes exact zeros, as the
// plain version and the Pallas kernel do.  A table entry >= N is a
// device-side assert, where the plain version raises IndexError.  Plain
// loads and CUDA-core FMAs only (no wgmma/TMA/split-K yet): with B x Kv
// CTAs a small decode batch underfills the 132 SMs.
#include "attn_common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_store,
                    const T* __restrict__ v_store,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ q_pos, T* __restrict__ out,
                    int H, int Kv, int N, int Tk, int M, int window,
                    float scale) {
  constexpr int LD = D + 1;  // padded row stride: conflict-free column reads
  const int kv = blockIdx.x, b = blockIdx.y;
  const int G = H / Kv;
  const int PS = Tk + 1;

  extern __shared__ float smem[];
  float* q_s = smem;               // [G][LD]
  float* k_s = q_s + G * LD;       // [Tk][LD]
  float* v_s = k_s + Tk * LD;      // [Tk][LD]
  float* acc = v_s + Tk * LD;      // [G][D]
  float* p_s = acc + G * D;        // [G][PS] scores, then probabilities
  float* m_s = p_s + G * PS;       // [G] running max
  float* l_s = m_s + G;            // [G] running denominator
  float* a_s = l_s + G;            // [G] rescale factor of this block

  const int qp = q_pos[b];
  attn::load_tile<T, D>(q + ((size_t)b * H + (size_t)kv * G) * D, q_s, G, LD);
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) acc[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_s[g] = attn::NEG_INIT;
    l_s[g] = 0.f;
  }
  // blocks holding positions in [window start, q_pos]
  const int j_hi = qp < 0 ? -1 : min(qp / Tk, M - 1);
  const int j_lo = window > 0 ? max(0, qp - window + 1) / Tk : 0;
  __syncthreads();

  for (int j = j_lo; j <= j_hi; ++j) {
    const int entry = block_tables[(size_t)b * M + j];
    if (entry < 0) continue;  // unallocated: nothing to load or admit
    assert(entry < N);        // a stale table fails, as the plain version does
    const size_t off = ((size_t)entry * Kv + kv) * Tk * D;
    attn::load_tile<T, D>(k_store + off, k_s, Tk, LD);
    attn::load_tile<T, D>(v_store + off, v_s, Tk, LD);
    __syncthreads();

    for (int i = threadIdx.x; i < G * Tk; i += blockDim.x) {
      const int g = i % G, t = i / G;
      const int kp = j * Tk + t;
      float s = attn::MASKED;
      if (kp <= qp && (window <= 0 || qp - kp < window)) {
        const float* qr = q_s + g * LD;
        const float* kr = k_s + t * LD;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      p_s[g * PS + t] = s;
    }
    __syncthreads();

    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      float* pr = p_s + g * PS;
      float mb = attn::NEG_INIT;
      for (int t = 0; t < Tk; ++t) mb = fmaxf(mb, pr[t]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mb);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int t = 0; t < Tk; ++t) {
        const float p = pr[t] == attn::MASKED ? 0.f : expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      m_s[g] = m_new;
      l_s[g] = alpha * l_s[g] + sum;
      a_s[g] = alpha;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
      const int g = i / D, d = i % D;
      const float* pr = p_s + g * PS;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < Tk; ++t) a = fmaf(pr[t], v_s[t * LD + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    const float l = l_s[g];
    out[((size_t)b * H + (size_t)kv * G + g) * D + d] =
        attn::from_float<T>(l == 0.f ? 0.f : acc[i] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bt, const void* qpos, void* out, int B, int H,
                   int Kv, int N, int Tk, int M, int window, float scale,
                   cudaStream_t stream) {
  const int G = H / Kv;
  const size_t smem =
      sizeof(float) * ((size_t)G * (D + 1) + 2 * (size_t)Tk * (D + 1) +
                       (size_t)G * D + (size_t)G * (Tk + 1) + 3 * (size_t)G);
  auto kern = paged_decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(Kv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(qpos), static_cast<T*>(out), H, Kv, N, Tk, M,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* bt, const void* qpos, void* out, int B,
                     int H, int Kv, int N, int Tk, int M, int window,
                     float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, bt, qpos, out, B, H, Kv, N, Tk, M, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, bt, qpos, out, B, H, Kv, N, Tk, M, window, scale, s);
    case 120: return launch<T, 120>(q, k, v, bt, qpos, out, B, H, Kv, N, Tk, M, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, bt, qpos, out, B, H, Kv, N, Tk, M, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, bt, qpos, out, B, H, Kv, N, Tk, M, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,D]; k/v store [N,Kv,T,D]; block_tables [B,M] int32 (-1 = hole);
// q_pos [B] int32; out [B,H,D].  dtype: 0 = float32, 1 = bfloat16 (q, the
// stores and out alike).  Returns the launch's cudaError_t.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_store, const void* v_store,
    const void* block_tables, const void* q_pos, void* out, int B, int H,
    int Kv, int N, int Tk, int M, int D, int window, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k_store, v_store, block_tables, q_pos, out,
                           B, H, Kv, N, Tk, M, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k_store, v_store, block_tables,
                                   q_pos, out, B, H, Kv, N, Tk, M, window,
                                   scale, s);
  return cudaErrorInvalidValue;
}
