// Segment attention on Hopper's tensor cores (sm_90a): the bf16 body shared
// by the flat kernel (segment_attention.cu: keys k/v [N, Kv, D], each tagged
// with k_pos / k_seg) and the paged one (paged_segment_attention.cu: keys in
// the block store [N, Kv, T, D], read through per-slot block tables, a key's
// position its place in the table row, its segment the row).  A query
// admits a key when they share a segment, the query's segment is >= 0, the
// key is written (k_pos >= 0; a table entry >= 0), k_pos <= q_pos and (with
// a window) q_pos - k_pos < window.
//
// Rows.  A CTA's 64 rows (the wgmma M tile) are (token, query head) pairs
// of one KV head, token-major: BQ = 64 / GC tokens times the GC = min(G, 64)
// query heads of a head chunk (G = H / Kv; one chunk unless G > 64).  A
// token's heads are contiguous in q [P, H, D], so one 3-D TMA box {64
// columns, GC heads, BQ tokens} lands the tile in the 128-byte swizzle, and
// each K/V tile is read once for all of a KV head's query heads.  When GC
// does not divide 64 the last 64 - BQ GC rows are zero and never written.
//
// Work items.  Rows of different segments never share a key, so each
// (q tile, KV head and head chunk, live segment of the tile) is a work item
// of its own, with no combine.  Item z of a tile takes the segment of the
// tile's z-th token that opens a segment, in stream order, and writes only
// that segment's rows; item 0 also writes the zeros of the tile's dead
// lanes (q_seg < 0), or the whole tile's when no lane is live; a row no key
// admits comes out as zeros from its own item (l = 0).  So every output
// row is written exactly once, and a tile of decode riders from several
// slots becomes that many items, each walking its own slot's keys.
// (segment_attention.py's `segment_grid` and `tile_items` state the same
// split in Python, and the tests hold it.)  A tile holds at most S_max
// items (BQ, or min(BQ, B) paged: a pure function of the shapes), but a
// mixed tick's tiles mostly hold one, and a grid of (tiles, Kv x chunks,
// S_max) CTAs spent most of its time starting CTAs that exit at once.  So
// a one-block plan kernel lists the live (tile, z) pairs in tile order,
// and a persistent grid (as many CTAs as fit on the card at once, at most
// one per possible item) takes items from an atomic ticket, each CTA one
// item after another: no host sync, and no CTA without work.
//
// Producer warp.  It loads the Q tile, then streams 64-key K and V tiles
// through a two-stage full/empty mbarrier ring by TMA, writing each key's
// position into the stage (-1: not admissible, another segment's or
// unwritten) and whether the predicate admits the whole tile for every
// row; a last stage flagged kEnd closes the walk.
//   * Paged: the slot's table row from the window start of the item's
//     earliest query to the causal horizon of its latest, 32 entries at a
//     time, the live ones (>= 0) compacted with a warp ballot, so a -1
//     entry is never loaded; each stage holds 64 / T blocks, each one TMA
//     box of T rows of the store viewed as [N * Kv, T, D] (T a multiple of
//     8 dividing 64, so the boxes stack on the swizzle's 1024-byte atoms as
//     one 64-row box would); the run's last partial stage reloads its first
//     block into the missing slots with positions -1, so no unset row of
//     shared memory meets the product.  A segment >= B or an entry >= N
//     anywhere in the tables is a device-side assert of the plan kernel
//     (below), where the plain version raises IndexError.
//   * Flat: the 64-key tile summaries (segment and position ranges of the
//     live keys, from tile_info_kernel) that meet the item's segment and
//     position range, then each candidate's own tags; a tile where no key
//     is of the segment and inside [window start, latest query] is skipped
//     before its K and V are read.
// Consumer warpgroup: the flash forward's step (flash_tc.cuh).  S = Q K^T
// by wgmma from shared memory (both K-major), the online softmax in
// registers in the log2 domain (D^-0.5 log2 e folded into one scale, masked
// scores -inf; a tile the predicate fills whole skips the test), P rounded
// to bf16 and packed in place as the register A operand of O += P V, which
// reads the same V tile MN-major; l sums the unrounded P.  f32
// accumulation; o = acc / l in bf16 (0 where l = 0).  D = 120 reads 128
// columns, the last 8 zeros.  At D = 256 the 64 x 256 f32 O accumulator is
// 128 registers a thread, so one CTA per SM (32 KB of Q and two 64 KB K/V
// stages) with the register limit at 255; at D <= 128 two CTAs per SM.
#pragma once

#include <limits.h>

#include "flash_tc.cuh"

namespace seg_tc {

using namespace flash_tc;

constexpr int kEnd = -1;  // stage flag: the walk is over
constexpr unsigned kAll = 0xffffffffu;

// The route rules: bf16 at D 64, 120, 128 and 256 takes the tensor cores
// (dtype 0 = float32, 1 = bfloat16); the paged kernel also needs block
// tokens T that stack whole into 64-key tiles on the swizzle's 8-row atoms.
inline bool route(int D, int dtype) {
  return dtype == 1 && (D == 64 || D == 120 || D == 128 || D == 256);
}
inline bool paged_route(int D, int dtype, int T) {
  return route(D, dtype) && (T == 8 || T == 16 || T == 32 || T == 64);
}

// Everything a launch passes besides the tensor maps.
struct Args {
  __nv_bfloat16* out;      // [P, H, D]
  const int* q_pos;        // [P]
  const int* q_seg;        // [P]
  int P, H, Kv, G, GC, BQ, window;
  float scale;
  // flat keys: tags [N] and the 64-key tile summaries
  const int* k_pos;
  const int* k_seg;
  const int4* info;
  int N, n_tiles;          // (paged: N = store blocks)
  // paged keys: tables [B, M]
  const int* tables;
  int T, B, M;
};

struct Shared {
  uint64_t q_full, full[kStages], empty[kStages];
  int tok_seg[kRows], tok_pos[kRows];  // the tile's tokens (-1: dead)
  int kpos[kStages][kKeys];            // key positions of a stage (-1: no)
  int flag[kStages];                   // 1: admitted whole; kEnd: no more
  unsigned opens[2];                   // tokens that open a segment
  int seg, lo, hi, n_mine;             // the item's segment and its range
  int ticket, pair;                    // the next item and its (tile, z)
};

// a stage's first use finds it free; afterwards the consumers release it
__device__ __forceinline__ void wait_free(Shared& sh, int it) {
  hopper::mbar_wait(&sh.empty[it % kStages], ((it / kStages) & 1) ^ 1);
}

// the walk's last stage: no keys, flagged kEnd
__device__ __forceinline__ void close_walk(Shared& sh, int& it) {
  if (threadIdx.x % 32 == 0) {
    wait_free(sh, it);
    sh.flag[it % kStages] = kEnd;
    hopper::mbar_arrive(&sh.full[it % kStages]);
  }
  ++it;
}

template <int DP>
__device__ __forceinline__ void produce_paged(const Args& a,
                                              const CUtensorMap* tm_k,
                                              const CUtensorMap* tm_v,
                                              Shared& sh, uint8_t* k_s,
                                              uint8_t* v_s, int kv, int seg,
                                              int lo, int hi, bool all_mine,
                                              int& it) {
  constexpr int KV_CHUNK = kKeys * 128;
  constexpr int KV_BYTES = tile_bytes<DP>(kKeys);
  const int lane = threadIdx.x % 32;
  const int T = a.T, NB = kKeys / T;
  const int j_lo = (a.window > 0 ? max(0, lo - a.window + 1) : 0) / T;
  const int j_hi = hi < 0 ? -1 : min(hi / T, a.M - 1);
  // lane b holds the table entry and index of the stage's block b
  int nb = 0, my_e = 0, my_j = 0;
  auto fill = [&]() {
    const int s = it % kStages;
    if (lane == 0) wait_free(sh, it);
    __syncwarp();
    const int b0 = lane / T, b1 = (lane + 32) / T;
    const int j0 = __shfl_sync(kAll, my_j, b0);
    const int j1 = __shfl_sync(kAll, my_j, b1);
    const int j_first = __shfl_sync(kAll, my_j, 0);
    const int j_last = __shfl_sync(kAll, my_j, nb - 1);
    const int e_first = __shfl_sync(kAll, my_e, 0);
    sh.kpos[s][lane] = b0 < nb ? j0 * T + lane % T : -1;
    sh.kpos[s][lane + 32] = b1 < nb ? j1 * T + (lane + 32) % T : -1;
    __syncwarp();
    if (lane == 0) {
      sh.flag[s] = all_mine && nb == NB && j_last * T + T - 1 <= lo &&
                   (a.window <= 0 || hi - j_first * T < a.window);
      hopper::mbar_arrive_expect_tx(&sh.full[s], 2 * KV_BYTES);
    }
    __syncwarp();
    if (lane < NB) {
      // a slot past the run's end reloads the first block (masked by -1)
      const int row = (lane < nb ? my_e : e_first) * a.Kv + kv;
#pragma unroll
      for (int c = 0; c < DP / 64; ++c) {
        const int off = s * KV_BYTES + c * KV_CHUNK + lane * T * 128;
        hopper::tma_load_3d(k_s + off, tm_k, &sh.full[s], c * 64, 0, row);
        hopper::tma_load_3d(v_s + off, tm_v, &sh.full[s], c * 64, 0, row);
      }
    }
    ++it;
    nb = 0;
  };
  for (int jb = j_lo; jb <= j_hi; jb += 32) {
    const int j = jb + lane;
    const int e = j <= j_hi ? a.tables[(size_t)seg * a.M + j] : -1;
    unsigned live = __ballot_sync(kAll, e >= 0);
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const int ee = __shfl_sync(kAll, e, src);
      if (lane == nb) {
        my_e = ee;
        my_j = jb + src;
      }
      if (++nb == NB) fill();
    }
  }
  if (nb > 0) fill();
  close_walk(sh, it);
}

// the item's view of key j: its position if it is of segment `seg` and
// written, else -1
__device__ __forceinline__ int flat_key(const Args& a, int j, int seg) {
  return j < a.N && a.k_seg[j] == seg ? a.k_pos[j] : -1;
}

template <int DP>
__device__ __forceinline__ void produce_flat(const Args& a,
                                             const CUtensorMap* tm_k,
                                             const CUtensorMap* tm_v,
                                             Shared& sh, uint8_t* k_s,
                                             uint8_t* v_s, int kv, int seg,
                                             int lo, int hi, bool all_mine,
                                             int& it) {
  constexpr int KV_CHUNK = kKeys * 128;
  constexpr int KV_BYTES = tile_bytes<DP>(kKeys);
  const int lane = threadIdx.x % 32;
  const int w = a.window;
  // some query of the item could admit a key at position k
  auto near = [&](int k) { return k >= 0 && k <= hi && (w <= 0 || lo - k < w); };
  for (int c0 = 0; c0 < a.n_tiles; c0 += 32) {
    bool meets = false;
    if (c0 + lane < a.n_tiles) {
      const int4 in = a.info[c0 + lane];
      meets = in.x <= seg && in.y >= seg && in.z <= hi && (w <= 0 || lo - in.w < w);
    }
    unsigned cand = __ballot_sync(kAll, meets);
    while (cand) {
      const int k0 = (c0 + __ffs(cand) - 1) * kKeys;
      cand &= cand - 1;
      const int ka = flat_key(a, k0 + lane, seg);
      const int kb = flat_key(a, k0 + lane + 32, seg);
      if (!__any_sync(kAll, near(ka) || near(kb))) continue;
      const bool all_live = __all_sync(kAll, ka >= 0 && kb >= 0);
      const int k_min = __reduce_min_sync(kAll, min(ka, kb));
      const int k_max = __reduce_max_sync(kAll, max(ka, kb));
      const int s = it % kStages;
      if (lane == 0) wait_free(sh, it);
      __syncwarp();
      sh.kpos[s][lane] = ka;
      sh.kpos[s][lane + 32] = kb;
      __syncwarp();
      if (lane == 0) {
        sh.flag[s] = all_mine && all_live && k_max <= lo && (w <= 0 || hi - k_min < w);
        hopper::mbar_arrive_expect_tx(&sh.full[s], 2 * KV_BYTES);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c) {
          const int off = s * KV_BYTES + c * KV_CHUNK;
          hopper::tma_load_3d(k_s + off, tm_k, &sh.full[s], c * 64, kv, k0);
          hopper::tma_load_3d(v_s + off, tm_v, &sh.full[s], c * 64, kv, k0);
        }
      }
      ++it;
    }
  }
  close_walk(sh, it);
}

constexpr int kPlanThreads = 1024;

// The plan: one block lists the call's work items before the kernel runs.
// For each q tile, its distinct live segments (at least 1: a tile of dead
// lanes keeps item 0, which writes its zeros), as (tile, z) pairs encoded
// tile * s_max + z, in tile order from work[2]; then work[0] = the pairs
// and work[1] = 0, the ticket the kernel's CTAs take items from.  A round
// takes the tokens of 1024 / BQ whole tiles: a token opens an item when no
// earlier token of its tile has its segment, and a block scan of the
// tiles' counts places their pairs.  The paged route also checks its
// indices here: every live segment names a table row and every table entry
// a block of the store, as the plain version's gather requires (it raises
// IndexError); a call (the assert's) in the wgmma kernel would make ptxas
// serialise its products.
template <bool kPaged>
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const Args a, int n_tiles, int s_max, int* __restrict__ work) {
  __shared__ int seg_s[kPlanThreads];
  __shared__ int cnt_s[kPlanThreads];
  __shared__ int warp_sum[kPlanThreads / 32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if constexpr (kPaged)
    for (int i = tid; i < a.B * a.M; i += kPlanThreads)
      assert(a.tables[i] < a.N);  // a stale table fails, as the plain one does
  if (tid == 0) carry = 0;
  const int per = kPlanThreads / a.BQ;  // tiles a round
  for (int t0 = 0; t0 < n_tiles; t0 += per) {
    const int tl = tid / a.BQ, p = t0 * a.BQ + tid;
    const bool mine = tl < per && t0 + tl < n_tiles;
    int s = -1;
    if (mine && p < a.P) {
      s = a.q_seg[p];
      if constexpr (kPaged)
        assert(s < a.B);  // a segment names a table row, as in the plain one
    }
    seg_s[tid] = s;
    cnt_s[tid] = 0;
    __syncthreads();
    if (mine && s >= 0) {
      bool opens = true;
      for (int j = tid - 1; j >= tl * a.BQ && opens; --j) opens = seg_s[j] != s;
      if (opens) atomicAdd(&cnt_s[tl], 1);
    }
    __syncthreads();
    // exclusive scan of the round's item counts: warps, then warp sums
    const int c = tid < per && t0 + tid < n_tiles ? max(1, cnt_s[tid]) : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int base = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x - c;
    for (int z = 0; z < c; ++z) work[2 + base + z] = (t0 + tid) * s_max + z;
    __syncthreads();  // carry and warp_sum are read
    if (tid == 0) carry += warp_sum[kPlanThreads / 32 - 1];
  }
  __syncthreads();
  if (tid == 0) {
    work[0] = carry;
    work[1] = 0;
  }
}

template <int D, bool kPaged>
__global__ void __launch_bounds__(kThreadsTC, D == 256 ? 1 : 2)
segment_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Args a,
                     int* __restrict__ work, int s_max) {
  constexpr int DP = padded<D>();
  constexpr int KV_CHUNK = kKeys * 128, Q_CHUNK = kRows * 128;
  constexpr int KV_BYTES = tile_bytes<DP>(kKeys);
  constexpr int Q_BYTES = tile_bytes<DP>(kRows);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* k_s = q_s + Q_BYTES;             // [kStages][KV_BYTES]
  uint8_t* v_s = k_s + kStages * KV_BYTES;  // [kStages][KV_BYTES]
  __shared__ Shared sh;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_hc = (a.G + a.GC - 1) / a.GC;
  const int kvc = a.Kv * n_hc;  // items of a (tile, z) pair
  const int R = a.BQ * a.GC;    // rows holding a (token, head)
  const int n_items = work[0] * kvc;
  const bool producer = role() == 1;

  if (R < kRows) {  // the rows past the tile's (token, head) pairs: zeros
    constexpr int V16 = 128 / 16;  // 16-byte vectors of a 128-byte row
    const int n = (DP / 64) * (kRows - R) * V16;
    for (int i = tid; i < n; i += blockDim.x) {
      const int c = i / ((kRows - R) * V16), rest = i % ((kRows - R) * V16);
      *reinterpret_cast<uint4*>(q_s + c * Q_CHUNK + (R + rest / V16) * 128 +
                                (rest % V16) * 16) = make_uint4(0, 0, 0, 0);
    }
    hopper::fence_proxy_async();  // before wgmma reads them
  }
  // the producer lane takes the tickets: this item's now, the next one's
  // while it walks this one's keys
  auto take = [&](int t) {
    sh.ticket = t;
    sh.pair = t < n_items ? work[2 + t / kvc] : 0;
  };
  if (tid == kConsumers) {
    hopper::mbar_init(&sh.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&sh.full[s], 1);
      hopper::mbar_init(&sh.empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
    take(atomicAdd(&work[1], 1));
  }
  int it = 0;            // stages this thread's role has passed, all items
  uint32_t q_phase = 0;  // parity of the next Q load

  for (;;) {
    if (tid == 0) {
      sh.lo = INT_MAX;
      sh.hi = INT_MIN;
      sh.n_mine = 0;
    }
    __syncthreads();  // the last item is done; this one's ticket is set
    const int item = sh.ticket;
    if (item >= n_items) break;
    const int pair = sh.pair, y = item % kvc;
    const int tile = pair / s_max, z = pair % s_max;
    const int kv = y / n_hc, hc = y % n_hc;
    const int p0 = tile * a.BQ;
    const int h0 = kv * a.G + hc * a.GC;        // the chunk's first query head
    const int gv = min(a.GC, a.G - hc * a.GC);  // its heads (of GC rows)

    if (tid < a.BQ) {
      const int p = p0 + tid;
      sh.tok_seg[tid] = p < a.P ? a.q_seg[p] : -1;
      sh.tok_pos[tid] = p < a.P ? a.q_pos[p] : 0;
    }
    __syncthreads();
    if (warp < 2) {  // a live token whose segment no earlier token has
      bool opens = false;
      if (tid < a.BQ) {
        const int s = sh.tok_seg[tid];
        opens = s >= 0;
        for (int j = tid - 1; j >= 0 && opens; --j) opens = sh.tok_seg[j] != s;
      }
      const unsigned bits = __ballot_sync(kAll, opens);
      if (lane == 0) sh.opens[warp] = bits;
    }
    __syncthreads();
    const unsigned o0 = sh.opens[0], o1 = sh.opens[1];
    if (o0 == 0 && o1 == 0) {  // every lane dead: item 0 writes the zeros
      for (int i = tid; i < R * (D / 2); i += blockDim.x) {
        const int r = i / (D / 2), c = 2 * (i % (D / 2));
        const int t = r / a.GC, g = r % a.GC;
        if (g < gv && p0 + t < a.P)
          *reinterpret_cast<uint32_t*>(
              a.out + ((size_t)(p0 + t) * a.H + h0 + g) * D + c) = 0u;
      }
      if (tid == kConsumers) take(atomicAdd(&work[1], 1));
      continue;
    }
    if (tid < a.BQ) {
      const unsigned bits = tid < 32 ? o0 : o1;
      const int b = tid % 32;
      const int rank =
          (tid < 32 ? 0 : __popc(o0)) + __popc(bits & ((1u << b) - 1));
      if ((bits >> b) & 1u && rank == z) sh.seg = sh.tok_seg[tid];
    }
    __syncthreads();
    const int seg = sh.seg;
    if (tid < a.BQ && sh.tok_seg[tid] == seg) {
      atomicMin(&sh.lo, sh.tok_pos[tid]);
      atomicMax(&sh.hi, sh.tok_pos[tid]);
      atomicAdd(&sh.n_mine, 1);
    }
    __syncthreads();
    const int lo = sh.lo, hi = sh.hi;
    // every row is this item's, so a tile the predicate fills needs no mask
    const bool all_mine = R == kRows && gv == a.GC && sh.n_mine == a.BQ;

    if (producer) {
      int next = 0;
      if (lane == 0) {
        next = atomicAdd(&work[1], 1);
        hopper::mbar_arrive_expect_tx(&sh.q_full, (DP / 64) * R * 128);
#pragma unroll
        for (int c = 0; c < DP / 64; ++c)
          hopper::tma_load_3d(q_s + c * Q_CHUNK, &tm_q, &sh.q_full, c * 64,
                              h0, p0);
      }
      if constexpr (kPaged)
        produce_paged<DP>(a, &tm_k, &tm_v, sh, k_s, v_s, kv, seg, lo, hi,
                          all_mine, it);
      else
        produce_flat<DP>(a, &tm_k, &tm_v, sh, k_s, v_s, kv, seg, lo, hi,
                         all_mine, it);
      if (lane == 0) take(next);
      q_phase ^= 1;
      continue;
    }

    // the consumer warpgroup: accumulator rows `row` and `row + 8`, columns
    // `col + 8j` and `col + 8j + 1`
    const int row = warp * 16 + lane / 4, col = 2 * (lane % 4);
    bool mine[2];
    int qp[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row + 8 * e, t = r / a.GC;
      mine[e] = r < R && r % a.GC < gv && sh.tok_seg[t] == seg;
      qp[e] = r < R ? sh.tok_pos[t] : 0;
    }
    const int w = a.window;
    const float scale_log2 = a.scale * kLog2e;
    float m[2] = {attn::NEG_INIT, attn::NEG_INIT};  // running max, log2 units
    float l[2] = {0.f, 0.f};                        // running sum of p
    float o_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o_acc[i] = 0.f;
    const uint32_t q_addr = hopper::smem_u32(q_s);
    hopper::mbar_wait(&sh.q_full, q_phase);
    q_phase ^= 1;

    for (;; ++it) {
      const int s = it % kStages;
      hopper::mbar_wait(&sh.full[s], (it / kStages) & 1);
      const int flag = sh.flag[s];
      if (flag == kEnd) {
        hopper::mbar_arrive(&sh.empty[s]);
        ++it;
        break;
      }
      const uint32_t k_addr = hopper::smem_u32(k_s + s * KV_BYTES);
      const uint32_t v_addr = hopper::smem_u32(v_s + s * KV_BYTES);

      // S = Q K^T, [rows, keys]
      float st[kKeys / 2];
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) st[i] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16)
        hopper::wgmma_ss_n64(st, hopper::desc_k(q_addr, Q_CHUNK, kk),
                             hopper::desc_k(k_addr, KV_CHUNK, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);

      const int* kpos = sh.kpos[s];
      float alpha[2];
      softmax_step<kKeys>(st, m, l, alpha, scale_log2, flag == 1,
                          [&](int e, int kj) {
                            const int k = kpos[kj];
                            return mine[e] && k >= 0 && k <= qp[e] &&
                                   (w <= 0 || qp[e] - k < w);
                          });
      scale_rows(o_acc, alpha);
      uint32_t pa[kKeys / 16][4];
      pack_p<kKeys>(st, pa);

      // O += P V: V read MN-major from the same tile
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        hopper::wgmma_rs<DP>(o_acc, pa[kk],
                             hopper::desc_mn(v_addr, KV_CHUNK, 16 * kk));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o_acc);
      hopper::mbar_arrive(&sh.empty[s]);  // this stage's K and V are read
    }

    // this item's rows: acc / l (0 where l = 0); item 0 also the dead lanes
    __nv_bfloat16* dst[2];
    float inv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row + 8 * e, t = r / a.GC, g = r % a.GC;
      const bool dead = z == 0 && r < R && g < gv && sh.tok_seg[t] < 0 &&
                        p0 + t < a.P;
      dst[e] = mine[e] || dead
                   ? a.out + ((size_t)(p0 + t) * a.H + h0 + g) * D
                   : nullptr;
      inv[e] = mine[e] && l[e] != 0.f ? 1.f / l[e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int e = (i / 2) % 2, c = col + 8 * (i / 4);
      if (dst[e] != nullptr && c < D)
        *reinterpret_cast<uint32_t*>(dst[e] + c) =
            mine[e]
                ? hopper::pack_bf16(o_acc[i] * inv[e], o_acc[i + 1] * inv[e])
                : 0u;
    }
  }
}

// Launch one instance: the plan kernel, then the persistent grid, with
// dynamic shared memory for Q and the K/V ring (plus the 1024-byte
// alignment).  `work` holds 2 + n_tiles * s_max ints.
template <int D, bool kPaged>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, const Args& a, int* work,
                   int n_tiles, int s_max, cudaStream_t stream) {
  constexpr int DP = padded<D>();
  const size_t smem =
      1024 + tile_bytes<DP>(kRows) + 2 * kStages * tile_bytes<DP>(kKeys);
  auto kern = segment_kernel_wgmma<D, kPaged>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  static int per_sm = 0;  // CTAs of this instance an SM holds at once
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreadsTC, smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  plan_kernel<kPaged><<<1, kPlanThreads, 0, stream>>>(a, n_tiles, s_max,
                                                       work);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int kvc = a.Kv * ((a.G + a.GC - 1) / a.GC);
  const long long items = (long long)n_tiles * s_max * kvc;
  const int grid = (int)(items < (long long)sms * per_sm ? items
                                                         : (long long)sms * per_sm);
  kern<<<grid, kThreadsTC, smem, stream>>>(mq, mk, mv, a, work, s_max);
  return cudaGetLastError();
}

// q [P, H, D] as a tensor map read in boxes {64 columns, GC heads, BQ
// tokens}: rows token-major, tokens past P and columns past D zeros.
inline bool make_q_map(CUtensorMap* map, const void* q, int P, int H, int D,
                       int GC, int BQ) {
  return hopper::make_map_3d(
      map, q, {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)P},
      {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2},
      {64, (cuuint32_t)GC, (cuuint32_t)BQ});
}

// Rows of a work item: GC = min(G, 64) query heads per chunk and BQ = 64 /
// GC tokens per q tile; a tile holds at most s_max items.
inline void tile_shape(int G, int* GC, int* BQ) {
  *GC = G < kRows ? G : kRows;
  *BQ = kRows / *GC;
}

}  // namespace seg_tc
