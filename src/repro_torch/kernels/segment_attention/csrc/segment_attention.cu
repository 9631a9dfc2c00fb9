// Flat-key segment attention for Hopper (sm_90a): one packed query stream —
// prefill chunks and length-1 decode segments of many requests back to
// back — against a flat key axis whose every key carries its own position
// and segment tags.  A query admits a key when they share a segment, the
// query's segment is >= 0, k_pos >= 0 (written), k_pos <= q_pos and (with
// a window) q_pos - k_pos < window.  The dense serve path passes each
// slot's ring followed by the stream's own keys; the kernel assumes no
// layout and takes any tags.
//
// Replaces: src/repro/kernels/segment_attention/segment_attention.py,
// segment_attention (Pallas TPU kernel `_kernel`).
//
// Bound on this card: bytes where a query tile admits few keys (decode
// riders, short chunks), operations for long prefill chunks, where every
// query head re-reads the chunk's keys and the CUDA-core FMAs of QK^T and
// PV dominate.
//
// Design: a first small kernel summarises every 32-key tile (the range of
// segments and positions of its keys that could be admitted at all).  Then
// one CTA per (q tile of 16 queries, query head); GQA and MQA map the head
// to its KV head as h / (H / Kv), so no K/V is repeated.  The CTA marks, in
// one parallel pass over the summaries, the key tiles whose ranges meet its
// own live queries' (a conservative test), walks only those in key order,
// loads each one's k_seg / k_pos, evaluates the exact predicate for its
// 16 x 32 pairs, and skips a tile no pair admits before loading its K/V.
// On an admitted tile it computes the scores, updates an f32 online softmax
// (m, l in shared memory, acc in registers) and accumulates P V.  The TPU
// kernel instead walks every key tile on a sequential grid axis.  Scores
// are scaled by D^-0.5 after the dot; lanes that admit no key (dead lanes,
// q_seg < 0, included) finish with l == 0 and write exact zeros.  The tile
// sizes keep a thread's share of a 16 x 256 output at 32 floats, so D = 256
// compiles without spills.  Plain loads and CUDA-core FMAs (no wgmma/TMA).
#include <limits.h>

#include "attn_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 16;              // queries per CTA
constexpr int BK = 32;              // keys per tile: one warp summarises one
constexpr int kCandWords = 16;      // candidate bits per pass, in words
constexpr int kChunk = 32 * kCandWords;  // key tiles marked per pass
constexpr int TPR = BK * BQ / kThreads;  // score pairs per thread (one row)
static_assert(BK == 32, "tile_info_kernel gives one warp to one tile");
static_assert(kChunk % kThreads == 0, "candidate pass tiling");

// info[j] = (seg_lo, seg_hi, pos_lo, pos_hi) over the keys of tile j that
// could be admitted at all (k_seg >= 0 and k_pos >= 0); a tile with none
// gets seg_lo = INT_MAX, seg_hi = -1 and meets no query range.
__global__ void tile_info_kernel(const int* __restrict__ k_pos,
                                 const int* __restrict__ k_seg, int N,
                                 int n_tiles, int4* __restrict__ info) {
  const int tile = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (tile >= n_tiles) return;  // the whole warp leaves together
  const int j = tile * BK + lane;
  const int s = j < N ? k_seg[j] : -1;
  const int p = j < N ? k_pos[j] : -1;
  const bool live = s >= 0 && p >= 0;
  const unsigned all = 0xffffffffu;
  const int seg_lo = __reduce_min_sync(all, live ? s : INT_MAX);
  const int seg_hi = __reduce_max_sync(all, live ? s : -1);
  const int pos_lo = __reduce_min_sync(all, live ? p : INT_MAX);
  const int pos_hi = __reduce_max_sync(all, live ? p : -1);
  if (lane == 0) info[tile] = make_int4(seg_lo, seg_hi, pos_lo, pos_hi);
}

// dst[r * ld + c] = float(src[r * stride + c]) for r < rows, c < D, rows at
// or past `valid` zero.  16-byte vector loads: the wrapper checks every
// base pointer, and each row offset is a multiple of D * sizeof(T) bytes.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          size_t stride, int rows, int valid,
                                          float* __restrict__ dst, int ld) {
  constexpr int V = 16 / sizeof(T);
  static_assert(D % V == 0, "head dim must be a multiple of the vector");
  constexpr int VPR = D / V;
  for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
    const int r = i / VPR, c = i % VPR;
    float* d = dst + r * ld + c * V;
    if (r < valid) {
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(src + r * stride) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int x = 0; x < V; ++x) d[x] = attn::to_float(e[x]);
    } else {
#pragma unroll
      for (int x = 0; x < V; ++x) d[x] = 0.f;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ q_pos,
               const int* __restrict__ q_seg, const int* __restrict__ k_pos,
               const int* __restrict__ k_seg,
               const int4* __restrict__ info, T* __restrict__ out, int P,
               int H, int Kv, int N, int n_tiles, int window, float scale) {
  constexpr int LD = D + 1;   // padded row stride: conflict-free reads
  constexpr int PS = BK + 1;
  // output tile ownership: a thread holds COLS columns of ROWS rows
  constexpr int CW = D < kThreads ? D : kThreads;
  constexpr int COLS = D / CW;
  constexpr int RSTRIDE = kThreads / CW;
  constexpr int ROWS = BQ / RSTRIDE;
  static_assert(BQ % RSTRIDE == 0, "row tiling");

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int hq = blockIdx.y;
  const int kvh = hq / (H / Kv);
  const int p0 = blockIdx.x * BQ;
  const int valid_q = min(BQ, P - p0);

  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][LD]
  float* k_s = q_s + BQ * LD;    // [BK][LD]
  float* v_s = k_s + BK * LD;    // [BK][LD]
  float* p_s = v_s + BK * LD;    // [BQ][PS] scores, then probabilities
  __shared__ float m_s[BQ], l_s[BQ], a_s[BQ];
  __shared__ int qpos_s[BQ], qseg_s[BQ], kpos_s[BK], kseg_s[BK];
  __shared__ unsigned cand_s[kCandWords];
  __shared__ int qrange[4];

  if (tid < BQ) {
    const int p = p0 + tid;
    qseg_s[tid] = tid < valid_q ? q_seg[p] : -1;
    qpos_s[tid] = tid < valid_q ? q_pos[p] : 0;
    m_s[tid] = attn::NEG_INIT;
    l_s[tid] = 0.f;
  }
  load_rows<T, D>(q + ((size_t)p0 * H + hq) * D, (size_t)H * D, BQ, valid_q,
                  q_s, LD);
  __syncthreads();
  if (tid == 0) {
    int slo = INT_MAX, shi = -1, plo = INT_MAX, phi = INT_MIN;
    for (int r = 0; r < BQ; ++r) {
      if (qseg_s[r] < 0) continue;
      slo = min(slo, qseg_s[r]);
      shi = max(shi, qseg_s[r]);
      plo = min(plo, qpos_s[r]);
      phi = max(phi, qpos_s[r]);
    }
    qrange[0] = slo;
    qrange[1] = shi;
    qrange[2] = plo;
    qrange[3] = phi;
  }
  __syncthreads();
  const int qs_lo = qrange[0], qs_hi = qrange[1];
  const int qp_lo = qrange[2], qp_hi = qrange[3];

  const int r_me = tid % BQ;          // score step: one row, TPR keys
  const int kg = tid / BQ;
  const int my_seg = qseg_s[r_me], my_pos = qpos_s[r_me];
  const int d0 = tid % CW, r0 = tid / CW;   // P V step
  // the threads past RSTRIDE x CW own no column (D = 120: the last 8)
  const bool pv_lane = tid < RSTRIDE * CW;
  float acc[ROWS][COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;

  // a tile with no live query admits nothing: every tile is skipped
  for (int c0 = 0; qs_hi >= 0 && c0 < n_tiles; c0 += kChunk) {
#pragma unroll
    for (int i = 0; i < kChunk / kThreads; ++i) {
      const int j = c0 + i * kThreads + tid;
      bool meets = false;
      if (j < n_tiles) {
        const int4 in = info[j];
        meets = in.x <= qs_hi && in.y >= qs_lo && in.z <= qp_hi &&
                (window <= 0 || qp_lo - in.w < window);
      }
      const unsigned bits = __ballot_sync(0xffffffffu, meets);
      if (lane == 0) cand_s[i * (kThreads / 32) + warp] = bits;
    }
    __syncthreads();
    for (int w = 0; w < kCandWords; ++w) {
      unsigned bits = cand_s[w];
      while (bits) {
        const int tile = c0 + w * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        const int k0 = tile * BK;
        if (tid < BK) {
          const int j = k0 + tid;
          kseg_s[tid] = j < N ? k_seg[j] : -1;
          kpos_s[tid] = j < N ? k_pos[j] : -1;
        }
        __syncthreads();
        unsigned admit = 0;
#pragma unroll
        for (int x = 0; x < TPR; ++x) {
          const int t = kg * TPR + x;
          const int kp = kpos_s[t];
          if (kseg_s[t] == my_seg && my_seg >= 0 && kp >= 0 &&
              kp <= my_pos && (window <= 0 || my_pos - kp < window))
            admit |= 1u << x;
        }
        if (!__syncthreads_or(admit != 0)) continue;  // no pair admitted

        const int kvalid = min(BK, N - k0);
        const size_t off = ((size_t)k0 * Kv + kvh) * D;
        load_rows<T, D>(k + off, (size_t)Kv * D, BK, kvalid, k_s, LD);
        load_rows<T, D>(v + off, (size_t)Kv * D, BK, kvalid, v_s, LD);
        __syncthreads();

        float dot[TPR];
#pragma unroll
        for (int x = 0; x < TPR; ++x) dot[x] = 0.f;
        const float* qr = q_s + r_me * LD;
        const float* kr = k_s + kg * TPR * LD;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          const float qv = qr[d];
#pragma unroll
          for (int x = 0; x < TPR; ++x)
            dot[x] = fmaf(qv, kr[x * LD + d], dot[x]);
        }
#pragma unroll
        for (int x = 0; x < TPR; ++x)
          p_s[r_me * PS + kg * TPR + x] =
              (admit >> x) & 1u ? dot[x] * scale : attn::MASKED;
        __syncthreads();

        if (tid < BQ) {
          float* pr = p_s + tid * PS;
          float mb = attn::NEG_INIT;
          for (int t = 0; t < BK; ++t) mb = fmaxf(mb, pr[t]);
          const float m_old = m_s[tid];
          const float m_new = fmaxf(m_old, mb);
          const float alpha = expf(m_old - m_new);
          float sum = 0.f;
          for (int t = 0; t < BK; ++t) {
            const float p = pr[t] == attn::MASKED ? 0.f : expf(pr[t] - m_new);
            pr[t] = p;
            sum += p;
          }
          m_s[tid] = m_new;
          l_s[tid] = alpha * l_s[tid] + sum;
          a_s[tid] = alpha;
        }
        __syncthreads();

        if (pv_lane) {
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const float a = a_s[r0 + i * RSTRIDE];
#pragma unroll
            for (int c = 0; c < COLS; ++c) acc[i][c] *= a;
          }
          for (int t = 0; t < BK; ++t) {
            float vv[COLS];
#pragma unroll
            for (int c = 0; c < COLS; ++c) vv[c] = v_s[t * LD + d0 + c * CW];
#pragma unroll
            for (int i = 0; i < ROWS; ++i) {
              const float pr = p_s[(r0 + i * RSTRIDE) * PS + t];
#pragma unroll
              for (int c = 0; c < COLS; ++c)
                acc[i][c] = fmaf(pr, vv[c], acc[i][c]);
            }
          }
        }
        // the next tile's first writes (tags) are read only after the
        // barrier that follows them, by which time this P V step is done
      }
    }
    __syncthreads();  // cand_s is rewritten by the next pass
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i * RSTRIDE;
    if (!pv_lane || r >= valid_q) continue;
    const float l = l_s[r];
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      out[((size_t)(p0 + r) * H + hq) * D + d0 + c * CW] =
          attn::from_float<T>(l == 0.f ? 0.f : acc[i][c] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* qpos, const void* qseg, const void* kpos,
                   const void* kseg, void* info, void* out, int P, int H,
                   int Kv, int N, int window, float scale,
                   cudaStream_t stream) {
  const int n_tiles = (N + BK - 1) / BK;
  tile_info_kernel<<<(n_tiles * 32 + kThreads - 1) / kThreads, kThreads, 0,
                     stream>>>(static_cast<const int*>(kpos),
                               static_cast<const int*>(kseg), N, n_tiles,
                               static_cast<int4*>(info));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * (BK + 1));
  auto kern = segment_kernel<T, D>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((P + BQ - 1) / BQ, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(qseg), static_cast<const int*>(kpos),
      static_cast<const int*>(kseg), static_cast<const int4*>(info),
      static_cast<T*>(out), P, H, Kv, N, n_tiles, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* qpos, const void* qseg, const void* kpos,
                     const void* kseg, void* info, void* out, int P, int H,
                     int Kv, int N, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, qpos, qseg, kpos, kseg, info, out, P, H, Kv, N, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, qpos, qseg, kpos, kseg, info, out, P, H, Kv, N, window, scale, s);
    case 120: return launch<T, 120>(q, k, v, qpos, qseg, kpos, kseg, info, out, P, H, Kv, N, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, qpos, qseg, kpos, kseg, info, out, P, H, Kv, N, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, qpos, qseg, kpos, kseg, info, out, P, H, Kv, N, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [P,H,D]; k/v [N,Kv,D]; q_pos/q_seg [P] and k_pos/k_seg [N] int32;
// info: int32 scratch of 4 * ceil(N / 32) entries; out [P,H,D].
// dtype: 0 = float32, 1 = bfloat16.  Returns the launches' cudaError_t.
extern "C" int segment_attention_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* q_seg, const void* k_pos, const void* k_seg, void* info,
    void* out, int P, int H, int Kv, int N, int D, int window, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % Kv != 0 || H > 65535) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, q_pos, q_seg, k_pos, k_seg, info, out,
                           P, H, Kv, N, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, q_pos, q_seg, k_pos, k_seg,
                                   info, out, P, H, Kv, N, window, scale, s);
  return cudaErrorInvalidValue;
}
