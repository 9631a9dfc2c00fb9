// Paged segment attention for Hopper (sm_90a): one packed query stream —
// prefill chunks and length-1 decode segments of many requests back to
// back — against the K/V block store, gathered through per-slot block
// tables.  A key's position is its place in the table row, its segment is
// the row.  A query admits a key when they share a segment, the query's
// segment is >= 0, the table entry is >= 0, k_pos <= q_pos, and (with a
// window) q_pos - k_pos < window.
//
// Replaces: src/repro/kernels/segment_attention/segment_attention.py,
// paged_segment_attention (Pallas TPU kernel `_paged_kernel`).
//
// Bound on this card: bytes for decode riders and short chunks (each K/V
// block feeds at most BQ x G rows), operations for long prefill chunks,
// where each block is re-read by every q tile of the chunk and the
// CUDA-core FMAs of QK^T and PV dominate.
//
// Design: one CTA per (q tile of BQ tokens, KV head); its rows are the
// BQ x G (token, query head) pairs of the G = H/Kv heads sharing that KV
// head, at most 64 rows.  The CTA finds the distinct live segments of its
// tile and, for each, walks only that slot's table row from the window
// start of the tile's earliest query to the causal horizon of its latest,
// skipping -1 entries without loading them: work and traffic follow the
// live predicate, and a decode rider never reads another slot's cache.
// While it walks one segment's blocks, only that segment's rows do the
// softmax update and the PV product, so a tile of decode riders from many
// slots costs one row group per block, not the whole tile.
// The TPU kernel instead walks all B x M blocks for every (head, q tile)
// on a sequential grid axis.  Online-softmax state stays on chip for the
// whole walk (m, l in shared memory, acc in registers).  Scores are scaled
// by D^-0.5 after the dot, accumulation is f32, the output is written in
// q's dtype, and dead lanes (q_seg < 0) or lanes no key admits write exact
// zeros.  A segment >= B or a table entry >= N is a device-side assert,
// where the plain version raises IndexError.  Plain loads and CUDA-core
// FMAs only (no wgmma/TMA yet).
#include "attn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 64;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_segment_kernel(const T* __restrict__ q, const T* __restrict__ k_store,
                     const T* __restrict__ v_store,
                     const int* __restrict__ block_tables,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ q_seg, T* __restrict__ out,
                     int P, int H, int Kv, int N, int Tk, int B, int M,
                     int BQ, int window, float scale) {
  constexpr int LD = D + 1;  // padded row stride: conflict-free column reads
  constexpr int ACC = kMaxRows * D / kThreads;  // acc elements per thread
  static_assert(kMaxRows * D % kThreads == 0, "acc tiling");
  const int kv = blockIdx.y;
  const int p0 = blockIdx.x * BQ;
  const int G = H / Kv;
  const int R = BQ * G;       // rows: token-major (token, head) pairs
  const int PS = Tk + 1;

  extern __shared__ float smem[];
  float* q_s = smem;              // [R][LD]
  float* k_s = q_s + R * LD;      // [Tk][LD]
  float* v_s = k_s + Tk * LD;     // [Tk][LD]
  float* p_s = v_s + Tk * LD;     // [R][PS] scores, then probabilities
  float* m_s = p_s + R * PS;      // [R] running max
  float* l_s = m_s + R;           // [R] running denominator
  float* a_s = l_s + R;           // [R] rescale factor of this block
  int* tok_pos = reinterpret_cast<int*>(a_s + R);  // [BQ]
  int* tok_seg = tok_pos + BQ;    // [BQ] (-1: dead or past the stream)
  int* seg_id = tok_seg + BQ;     // [BQ] distinct live segments of the tile
  int* seg_lo = seg_id + BQ;      // [BQ] earliest q_pos of each
  int* seg_hi = seg_lo + BQ;      // [BQ] latest q_pos of each
  __shared__ int n_segs;

  for (int tp = threadIdx.x; tp < BQ; tp += blockDim.x) {
    const int p = p0 + tp;
    const int s = p < P ? q_seg[p] : -1;
    assert(s < B);  // a segment names a table row, as in the plain version
    tok_seg[tp] = s;
    tok_pos[tp] = p < P ? q_pos[p] : 0;
  }
  for (int tp = 0; tp < BQ && p0 + tp < P; ++tp)
    attn::load_tile<T, D>(q + ((size_t)(p0 + tp) * H + (size_t)kv * G) * D,
                          q_s + tp * G * LD, G, LD);
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m_s[r] = attn::NEG_INIT;
    l_s[r] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int tp = 0; tp < BQ; ++tp) {
      const int s = tok_seg[tp], pos = tok_pos[tp];
      if (s < 0) continue;
      int i = 0;
      while (i < n && seg_id[i] != s) ++i;
      if (i == n) {
        seg_id[n] = s;
        seg_lo[n] = pos;
        seg_hi[n] = pos;
        ++n;
      } else {
        seg_lo[i] = min(seg_lo[i], pos);
        seg_hi[i] = max(seg_hi[i], pos);
      }
    }
    n_segs = n;
  }
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int si = 0; si < n_segs; ++si) {
    const int s = seg_id[si];
    const int j_hi = seg_hi[si] < 0 ? -1 : min(seg_hi[si] / Tk, M - 1);
    const int j_lo = window > 0 ? max(0, seg_lo[si] - window + 1) / Tk : 0;
    for (int j = j_lo; j <= j_hi; ++j) {
      const int entry = block_tables[(size_t)s * M + j];
      if (entry < 0) continue;  // unallocated: nothing to load or admit
      assert(entry < N);        // a stale table fails, as the plain one does
      const size_t off = ((size_t)entry * Kv + kv) * Tk * D;
      attn::load_tile<T, D>(k_store + off, k_s, Tk, LD);
      attn::load_tile<T, D>(v_store + off, v_s, Tk, LD);
      __syncthreads();

      for (int i = threadIdx.x; i < R * Tk; i += blockDim.x) {
        const int r = i % R, t = i / R;
        const int tp = r / G;
        const int kp = j * Tk + t, qp = tok_pos[tp];
        float sc = attn::MASKED;
        if (tok_seg[tp] == s && kp <= qp && (window <= 0 || qp - kp < window)) {
          const float* qr = q_s + r * LD;
          const float* kr = k_s + t * LD;
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
          sc = dot * scale;
        }
        p_s[r * PS + t] = sc;
      }
      __syncthreads();

      // rows of other segments admit no key of this block: their m, l and
      // acc stay as they are, so they are skipped, not rescaled by 1
      for (int r = threadIdx.x; r < R; r += blockDim.x) {
        if (tok_seg[r / G] != s) continue;
        float* pr = p_s + r * PS;
        float mb = attn::NEG_INIT;
        for (int t = 0; t < Tk; ++t) mb = fmaxf(mb, pr[t]);
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mb);
        const float alpha = expf(m_old - m_new);
        float sum = 0.f;
        for (int t = 0; t < Tk; ++t) {
          const float p = pr[t] == attn::MASKED ? 0.f : expf(pr[t] - m_new);
          pr[t] = p;
          sum += p;
        }
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
        a_s[r] = alpha;
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int r = e / D, d = e % D;
        if (r < R && tok_seg[r / G] == s) {
          const float* pr = p_s + r * PS;
          float a = acc[i] * a_s[r];
          for (int t = 0; t < Tk; ++t) a = fmaf(pr[t], v_s[t * LD + d], a);
          acc[i] = a;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / D, d = e % D;
    const int tp = r / G, g = r % G;
    if (r < R && p0 + tp < P) {
      const float l = l_s[r];
      out[((size_t)(p0 + tp) * H + (size_t)kv * G + g) * D + d] =
          attn::from_float<T>(l == 0.f ? 0.f : acc[i] / l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bt, const void* qpos, const void* qseg,
                   void* out, int P, int H, int Kv, int N, int Tk, int B,
                   int M, int window, float scale, cudaStream_t stream) {
  const int G = H / Kv;
  if (G > kMaxRows) return cudaErrorInvalidValue;
  const int BQ = kMaxRows / G;
  const int R = BQ * G;
  const size_t smem =
      sizeof(float) * ((size_t)R * (D + 1) + 2 * (size_t)Tk * (D + 1) +
                       (size_t)R * (Tk + 1) + 3 * (size_t)R) +
      sizeof(int) * 5 * (size_t)BQ;
  auto kern = paged_segment_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((P + BQ - 1) / BQ, Kv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(bt),
      static_cast<const int*>(qpos), static_cast<const int*>(qseg),
      static_cast<T*>(out), P, H, Kv, N, Tk, B, M, BQ, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* bt, const void* qpos, const void* qseg,
                     void* out, int P, int H, int Kv, int N, int Tk, int B,
                     int M, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, bt, qpos, qseg, out, P, H, Kv, N, Tk, B, M, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, bt, qpos, qseg, out, P, H, Kv, N, Tk, B, M, window, scale, s);
    case 120: return launch<T, 120>(q, k, v, bt, qpos, qseg, out, P, H, Kv, N, Tk, B, M, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, bt, qpos, qseg, out, P, H, Kv, N, Tk, B, M, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, bt, qpos, qseg, out, P, H, Kv, N, Tk, B, M, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [P,H,D]; k/v store [N,Kv,T,D]; block_tables [B,M] int32 (-1 = hole);
// q_pos/q_seg [P] int32 (segment = table row, -1 = dead lane); out [P,H,D].
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int paged_segment_attention_launch(
    const void* q, const void* k_store, const void* v_store,
    const void* block_tables, const void* q_pos, const void* q_seg,
    void* out, int P, int H, int Kv, int N, int Tk, int B, int M, int D,
    int window, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k_store, v_store, block_tables, q_pos,
                           q_seg, out, P, H, Kv, N, Tk, B, M, window, scale,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k_store, v_store, block_tables,
                                   q_pos, q_seg, out, P, H, Kv, N, Tk, B, M,
                                   window, scale, s);
  return cudaErrorInvalidValue;
}
