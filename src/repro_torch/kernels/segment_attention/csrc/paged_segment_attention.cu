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
// block feeds at most 64 (token, query head) rows), operations for long
// prefill chunks, where each block is re-read by every q tile of the chunk.
// At yi-6b's mixed tick (bf16, H 32, Kv 4, D 128, T 16, four decode
// riders and four prompt chunks in a 2048-lane stream) the admitted pairs
// need 1.39 GFLOP, 1.4 us at the bf16 tensor-core peak, against 28.9 MB
// of q, o and the live K/V blocks, 8.6 us at 3.35 TB/s.
//
// Two routes, a fixed dispatch on dtype, head dim and block tokens in the
// extern "C" entry point (segment_tc.cuh's `paged_route`, which
// `paged_segment_attention_route` reports and segment_attention.py's
// `paged_segment_route` states again; no fallback, and a launch that fails
// returns its error):
//
// * Tensor cores: bf16 at D 64, 120, 128 and 256 with T 8, 16, 32 or 64
//   (`segment_kernel_wgmma<D, true>` in kernels/csrc/segment_tc.cuh, whose
//   header states the design).  A work item is a (q tile of 64 / G
//   tokens, KV head, live segment of the tile); a one-block plan kernel
//   lists the live ones (and asserts the indices) and a persistent grid
//   takes them, so the decode riders of a tile walk their slots' tables in
//   parallel.  A producer warp compacts the live table entries with a warp
//   ballot and TMA-loads 64 / T blocks a stage into a two-stage ring; one
//   consumer warpgroup runs the flash forward's wgmma step.  P meets V in bf16, as the flash forward's does (ROADMAP
//   Queue 3 logs the difference).
// * CUDA cores: f32 at every D, bf16 at D 16 and at T outside 8-64
//   (`paged_segment_kernel`, below).  One CTA per (q tile of BQ tokens, KV
//   head); its rows are the BQ x G (token, query head) pairs of the G =
//   H/Kv heads sharing that KV head, at most 64 rows.  The CTA finds the
//   distinct live segments of its tile and, for each, walks only that
//   slot's table row from the window start of the tile's earliest query to
//   the causal horizon of its latest, skipping -1 entries without loading
//   them.  While it walks one segment's blocks, only that segment's rows do
//   the softmax update and the PV product.  Online-softmax state stays on
//   chip for the whole walk (m, l in shared memory, acc in registers);
//   scores are scaled by D^-0.5 after the dot; plain loads and CUDA-core
//   FMAs.
// The TPU kernel instead walks all B x M blocks for every (head, q tile) on
// a sequential grid axis.  Both routes accumulate in f32, write the output
// in q's dtype, and write exact zeros for dead lanes (q_seg < 0) and lanes
// no key admits.  A segment >= B or a table entry >= N is a device-side
// assert, where the plain version raises IndexError.
#include "attn_common.cuh"
#include "segment_tc.cuh"

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

// the tensor-core route: bf16 at D 64, 120, 128 and 256, T 8 to 64
template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* bt, const void* qpos, const void* qseg,
                      void* out, void* work, int P, int H, int Kv, int N,
                      int Tk, int B, int M, int window, float scale,
                      cudaStream_t stream) {
  seg_tc::Args a{};
  a.G = H / Kv;
  seg_tc::tile_shape(a.G, &a.GC, &a.BQ);
  if (a.GC != a.G) return cudaErrorInvalidValue;  // G <= 64
  // the store as [N * Kv, T, D]: one box is one block of one KV head
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)Tk,
                              (cuuint64_t)N * Kv};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)Tk * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)Tk, 1};
  CUtensorMap mq, mk, mv;
  if (!seg_tc::make_q_map(&mq, q, P, H, D, a.GC, a.BQ) ||
      !hopper::make_map_3d(&mk, k, dims, strides, box) ||
      !hopper::make_map_3d(&mv, v, dims, strides, box))
    return cudaErrorNotSupported;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.q_pos = static_cast<const int*>(qpos);
  a.q_seg = static_cast<const int*>(qseg);
  a.tables = static_cast<const int*>(bt);
  a.P = P;
  a.H = H;
  a.Kv = Kv;
  a.N = N;
  a.T = Tk;
  a.B = B;
  a.M = M;
  a.window = window;
  a.scale = scale;
  return seg_tc::launch<D, true>(mq, mk, mv, a, static_cast<int*>(work),
                                 (P + a.BQ - 1) / a.BQ, a.BQ < B ? a.BQ : B,
                                 stream);
}

cudaError_t dispatch_tc(int D, const void* q, const void* k, const void* v,
                        const void* bt, const void* qpos, const void* qseg,
                        void* out, void* work, int P, int H, int Kv, int N,
                        int Tk, int B, int M, int window, float scale,
                        cudaStream_t s) {
  switch (D) {
    case 64: return launch_tc<64>(q, k, v, bt, qpos, qseg, out, work, P, H, Kv, N, Tk, B, M, window, scale, s);
    case 120: return launch_tc<120>(q, k, v, bt, qpos, qseg, out, work, P, H, Kv, N, Tk, B, M, window, scale, s);
    case 128: return launch_tc<128>(q, k, v, bt, qpos, qseg, out, work, P, H, Kv, N, Tk, B, M, window, scale, s);
    case 256: return launch_tc<256>(q, k, v, bt, qpos, qseg, out, work, P, H, Kv, N, Tk, B, M, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// 1 when a call of this head dim, dtype (0 = float32, 1 = bfloat16) and
// block tokens takes the tensor-core kernel, 0 when it takes the CUDA-core
// one.
extern "C" int paged_segment_attention_route(int D, int dtype, int T) {
  return seg_tc::paged_route(D, dtype, T) ? 1 : 0;
}

// q [P,H,D]; k/v store [N,Kv,T,D]; block_tables [B,M] int32 (-1 = hole);
// q_pos/q_seg [P] int32 (segment = table row, -1 = dead lane); out [P,H,D];
// work: int32 scratch of the tensor-core route, 2 + ceil(P / BQ) *
// min(BQ, B) entries (BQ = 64 / G tokens a q tile), unused (may be null)
// on the CUDA cores.  dtype: 0 = float32, 1 = bfloat16.  Returns the
// launches' cudaError_t.
extern "C" int paged_segment_attention_launch(
    const void* q, const void* k_store, const void* v_store,
    const void* block_tables, const void* q_pos, const void* q_seg,
    void* out, void* work, int P, int H, int Kv, int N, int Tk, int B, int M,
    int D, int window, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Kv <= 0 || H % Kv != 0 || Kv > 65535) return cudaErrorInvalidValue;
  if (seg_tc::paged_route(D, dtype, Tk))
    return dispatch_tc(D, q, k_store, v_store, block_tables, q_pos, q_seg,
                       out, work, P, H, Kv, N, Tk, B, M, window, scale, s);
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
