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
// Bound on this card: operations.  At recurrentgemma-9b's mixed tick (bf16,
// MQA: H 16, Kv 1, D 256; 8 x 2048 ring keys and a 4096-lane stream,
// window 2048) the admitted pairs need 82.5 GFLOP, 0.083 ms at the bf16
// tensor-core peak, against 81.4 MB of q, o and the admitted keys' K and
// V, 0.024 ms at 3.35 TB/s.
//
// Two routes, a fixed dispatch on dtype and head dim in the extern "C"
// entry point (segment_tc.cuh's `route`, which `segment_attention_route`
// reports and segment_attention.py's `segment_route` states again; no
// fallback, and a launch that fails returns its error):
//
// * Tensor cores: bf16 at D 64, 120, 128 and 256 (`segment_kernel_wgmma<D,
//   false>` in kernels/csrc/segment_tc.cuh, whose header states the
//   design).  A first small kernel summarises every 64-key tile.  A work
//   item is a (q tile of 64 / G tokens, KV head, live segment of the
//   tile), listed by a one-block plan kernel and taken by a persistent
//   grid: its 64 rows are (token, query head) pairs of one KV head, so
//   each K/V tile is read once for all G query heads (MQA's 16 at
//   recurrentgemma-9b).  A producer warp picks the candidate tiles from the
//   summaries and TMA-loads each one's K and V into a two-stage ring; one
//   consumer warpgroup runs the flash forward's wgmma step.  P meets V in
//   bf16, as the flash forward's does (ROADMAP Queue 3 logs the
//   difference).
// * CUDA cores: f32 at every D and bf16 at D 16 (`segment_kernel`, below).
//   A first small kernel summarises every 32-key tile (the range of
//   segments and positions of its keys that could be admitted at all).
//   Then one CTA per (q tile of 16 queries, query head); GQA and MQA map
//   the head to its KV head as h / (H / Kv), so no K/V is repeated.  The
//   CTA marks, in one parallel pass over the summaries, the key tiles whose
//   ranges meet its own live queries' (a conservative test), walks only
//   those in key order, loads each one's k_seg / k_pos, evaluates the exact
//   predicate for its 16 x 32 pairs, and skips a tile no pair admits before
//   loading its K/V.  On an admitted tile it computes the scores, updates an
//   f32 online softmax (m, l in shared memory, acc in registers) and
//   accumulates P V; scores are scaled by D^-0.5 after the dot.  The tile
//   sizes keep a thread's share of a 16 x 256 output at 32 floats, so
//   D = 256 compiles without spills.  Plain loads and CUDA-core FMAs.
// The TPU kernel instead walks every key tile on a sequential grid axis.
// Both routes write exact zeros for lanes that admit no key (dead lanes,
// q_seg < 0, included).
#include <limits.h>

#include <type_traits>

#include "attn_common.cuh"
#include "segment_tc.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 16;              // queries per CTA
constexpr int BK = 32;              // keys per tile
constexpr int kCandWords = 16;      // candidate bits per pass, in words
constexpr int kChunk = 32 * kCandWords;  // key tiles marked per pass
constexpr int TPR = BK * BQ / kThreads;  // score pairs per thread (one row)
static_assert(kChunk % kThreads == 0, "candidate pass tiling");

// info[j] = (seg_lo, seg_hi, pos_lo, pos_hi) over the keys of the KT-key
// tile j that could be admitted at all (k_seg >= 0 and k_pos >= 0); a tile
// with none gets seg_lo = INT_MAX, seg_hi = -1 and meets no query range.
// One warp per tile.
template <int KT>
__global__ void tile_info_kernel(const int* __restrict__ k_pos,
                                 const int* __restrict__ k_seg, int N,
                                 int n_tiles, int4* __restrict__ info) {
  static_assert(KT % 32 == 0, "a lane takes every 32nd key of the tile");
  const int tile = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (tile >= n_tiles) return;  // the whole warp leaves together
  int seg_lo = INT_MAX, seg_hi = -1, pos_lo = INT_MAX, pos_hi = -1;
#pragma unroll
  for (int x = 0; x < KT / 32; ++x) {
    const int j = tile * KT + x * 32 + lane;
    const int s = j < N ? k_seg[j] : -1;
    const int p = j < N ? k_pos[j] : -1;
    if (s >= 0 && p >= 0) {
      seg_lo = min(seg_lo, s);
      seg_hi = max(seg_hi, s);
      pos_lo = min(pos_lo, p);
      pos_hi = max(pos_hi, p);
    }
  }
  const unsigned all = 0xffffffffu;
  seg_lo = __reduce_min_sync(all, seg_lo);
  seg_hi = __reduce_max_sync(all, seg_hi);
  pos_lo = __reduce_min_sync(all, pos_lo);
  pos_hi = __reduce_max_sync(all, pos_hi);
  if (lane == 0) info[tile] = make_int4(seg_lo, seg_hi, pos_lo, pos_hi);
}

// summaries of every KT-key tile, on the stream
template <int KT>
cudaError_t summarise(const void* kpos, const void* kseg, void* info, int N,
                      cudaStream_t stream) {
  const int n_tiles = (N + KT - 1) / KT;
  tile_info_kernel<KT><<<(n_tiles * 32 + kThreads - 1) / kThreads, kThreads,
                         0, stream>>>(static_cast<const int*>(kpos),
                                      static_cast<const int*>(kseg), N,
                                      n_tiles, static_cast<int4*>(info));
  return cudaGetLastError();
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
  cudaError_t e = summarise<BK>(kpos, kseg, info, N, stream);
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

// the CUDA-core kernel: f32 at every head dim, bf16 at D 16
template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* qpos, const void* qseg, const void* kpos,
                     const void* kseg, void* info, void* out, int P, int H,
                     int Kv, int N, int window, float scale, cudaStream_t s) {
  constexpr bool f32 = std::is_same<T, float>::value;
#define SEGMENT(DV) \
  return launch<T, DV>(q, k, v, qpos, qseg, kpos, kseg, info, out, P, H, Kv, N, window, scale, s)
  switch (D) {
    case 16: SEGMENT(16);
    case 64: if constexpr (f32) SEGMENT(64); break;
    case 120: if constexpr (f32) SEGMENT(120); break;
    case 128: if constexpr (f32) SEGMENT(128); break;
    case 256: if constexpr (f32) SEGMENT(256); break;
  }
#undef SEGMENT
  return cudaErrorInvalidValue;
}

// the tensor-core route: bf16 at D 64, 120, 128 and 256
template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* qpos, const void* qseg, const void* kpos,
                      const void* kseg, void* info, void* work, void* out,
                      int P, int H, int Kv, int N, int window, float scale,
                      cudaStream_t stream) {
  constexpr int kKeys = flash_tc::kKeys;
  cudaError_t e = summarise<kKeys>(kpos, kseg, info, N, stream);
  if (e != cudaSuccess) return e;
  seg_tc::Args a{};
  a.G = H / Kv;
  seg_tc::tile_shape(a.G, &a.GC, &a.BQ);
  // k/v [N, Kv, D]: one box {64 columns, 1 KV head, 64 keys} is 64 rows
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)Kv, (cuuint64_t)N};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)Kv * D * 2};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)kKeys};
  CUtensorMap mq, mk, mv;
  if (!seg_tc::make_q_map(&mq, q, P, H, D, a.GC, a.BQ) ||
      !hopper::make_map_3d(&mk, k, dims, strides, box) ||
      !hopper::make_map_3d(&mv, v, dims, strides, box))
    return cudaErrorNotSupported;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.q_pos = static_cast<const int*>(qpos);
  a.q_seg = static_cast<const int*>(qseg);
  a.k_pos = static_cast<const int*>(kpos);
  a.k_seg = static_cast<const int*>(kseg);
  a.info = static_cast<const int4*>(info);
  a.P = P;
  a.H = H;
  a.Kv = Kv;
  a.N = N;
  a.n_tiles = (N + kKeys - 1) / kKeys;
  a.window = window;
  a.scale = scale;
  return seg_tc::launch<D, false>(mq, mk, mv, a, static_cast<int*>(work),
                                  (P + a.BQ - 1) / a.BQ, a.BQ, stream);
}

cudaError_t dispatch_tc(int D, const void* q, const void* k, const void* v,
                        const void* qpos, const void* qseg, const void* kpos,
                        const void* kseg, void* info, void* work, void* out,
                        int P, int H, int Kv, int N, int window, float scale,
                        cudaStream_t s) {
  switch (D) {
    case 64: return launch_tc<64>(q, k, v, qpos, qseg, kpos, kseg, info, work, out, P, H, Kv, N, window, scale, s);
    case 120: return launch_tc<120>(q, k, v, qpos, qseg, kpos, kseg, info, work, out, P, H, Kv, N, window, scale, s);
    case 128: return launch_tc<128>(q, k, v, qpos, qseg, kpos, kseg, info, work, out, P, H, Kv, N, window, scale, s);
    case 256: return launch_tc<256>(q, k, v, qpos, qseg, kpos, kseg, info, work, out, P, H, Kv, N, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// 1 when a call of this head dim and dtype (0 = float32, 1 = bfloat16)
// takes the tensor-core kernel, 0 when it takes the CUDA-core one.
extern "C" int segment_attention_route(int D, int dtype) {
  return seg_tc::route(D, dtype) ? 1 : 0;
}

// q [P,H,D]; k/v [N,Kv,D]; q_pos/q_seg [P] and k_pos/k_seg [N] int32;
// info: int32 scratch of 4 * ceil(N / 32) entries (one int4 summary per
// key tile: 32 keys on the CUDA cores, 64 on the tensor cores); work: int32
// scratch of the tensor-core route, 2 + ceil(P / BQ) * BQ entries (BQ =
// 64 / min(G, 64) tokens a q tile), unused (may be null) on the CUDA
// cores; out [P,H,D].
// dtype: 0 = float32, 1 = bfloat16.  Returns the launches' cudaError_t.
extern "C" int segment_attention_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* q_seg, const void* k_pos, const void* k_seg, void* info,
    void* work, void* out, int P, int H, int Kv, int N, int D, int window,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Kv <= 0 || H % Kv != 0 || H > 65535) return cudaErrorInvalidValue;
  if (seg_tc::route(D, dtype))
    return dispatch_tc(D, q, k, v, q_pos, q_seg, k_pos, k_seg, info, work,
                       out, P, H, Kv, N, window, scale, s);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, q_pos, q_seg, k_pos, k_seg, info, out,
                           P, H, Kv, N, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, q_pos, q_seg, k_pos, k_seg,
                                   info, out, P, H, Kv, N, window, scale, s);
  return cudaErrorInvalidValue;
}
