// Dense decode attention for Hopper (sm_90a): one query token per row
// against a dense, positioned KV cache, with the keys split across CTAs
// (flash-decoding) and the splits combined by a second, small kernel.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py,
// decode_attention (Pallas TPU kernel `_kernel`).
//
// Bound on this card: bytes.  A call reads q (B x H x D), k_pos, and the
// K and V rows of every admitted key (2 x D each per KV head), and writes
// B x H x D outputs; the arithmetic is 4 x G x D flops per key and KV head,
// about G/2 flops per byte of K/V in bf16, far under the ~295 flops/byte
// at which the tensor cores would become the limit.  Scores and P V stay
// f32 on the CUDA cores, as the Pallas kernel keeps P in f32.
//
// Design.  The TPU kernel walks a sequential grid of 512-key blocks per
// (row, KV head) with its online-softmax state in VMEM scratch.  Hopper has
// no sequential grid, and B x Kv CTAs are too few to fill 132 SMs (32 at
// yi-6b's 8 x 4, 8 at recurrentgemma's MQA), so the key axis is cut into
// `n_split` splits of `split_len` slots (the wrapper's `split_len`: one
// wave of CTAs at the CTAs per SM the shared memory allows) and each CTA
// takes one (key split, KV head and chunk of up to 16 query heads, row):
//   * live keys first: the CTA reads its split's k_pos once, votes each
//     slot in by a ballot (written, causal, in the window) and compacts the
//     admitted slots into a list in shared memory, so unwritten slots,
//     future positions and keys outside the window are never loaded (a row
//     no key admits loads no K or V at all);
//   * the list is walked in tiles of `tk` keys (64 where three stages fit,
//     else 32 or 16) through a three-stage cp.async ring of K and V rows
//     in their own dtype (bf16 is widened in registers, not in shared
//     memory): tiles i + 1 and i + 2 are in flight while tile i is
//     computed, one __syncthreads a tile.  A row takes the power of two of
//     bytes that holds it: each lane reads its own columns of a row, so
//     rows need no padding for the banks, and a row's address is a shift;
//   * eight warps, each on its own: a warp takes up to NH of the chunk's
//     heads (g = w % 4, + 4, ...) over one key part of each tile (two parts
//     of 32 keys; with G < 4, 8 / G parts), and lane l holds columns
//     4 (l + 32 c) .. + 3 of each key, of q and of the P V accumulators.
//     Scores go in batches of 8 or 4 keys (part_scores): each lane's partial
//     dot products meet by shuffles whose register pattern needs no select,
//     key l's score ending in lane l; q is read from shared memory once a
//     tile, each K element once a warp.  The online softmax runs across
//     the lanes (max by one integer reduction, sum by shuffles), p goes
//     through shared memory to every lane, and P V adds each key's V row
//     into the registers; no warp waits on another inside a tile;
//   * after the last tile the key parts are merged in shared memory by the
//     logsumexp rule and the CTA writes one unnormalised accumulator,
//     running max m and sum l per head as f32 partials to scratch the
//     wrapper allocates.
// The combine kernel (split_combine.cuh, shared with the paged decode
// kernel), one CTA per (head, row), merges the splits with the logsumexp
// rule and writes exact zeros where no key was admitted.  Any S, no
// padding.  CUDA-core FMAs only.
#include "attn_common.cuh"
#include "hopper.cuh"
#include "split_combine.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;
constexpr int kHeadChunk = 16;       // query heads a CTA holds, at most
constexpr size_t kMaxSmem = 232448;  // one CTA's dynamic limit (227 KB)

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// bytes of a K/V row in shared memory: the power of two that holds it (a
// lane reads its own columns of a row, so rows need no padding for the
// banks, and a row's offset is a shift)
__host__ __device__ constexpr int row_bytes(int esz, int d) {
  int r = 16;
  while (r < d * esz) r *= 2;
  return r;
}
// key parts a tile is cut into, one per warp of a head: two parts for
// G >= 4 (the warps' heads repeat every four), else 8 / G
__host__ __device__ constexpr int key_parts(int g) {
  return g >= 4 ? 2 : kWarps / g;
}
// NH, the most heads a warp takes, as instantiated: 1, 2 or 4
__host__ __device__ constexpr int warp_heads(int g) {
  return g <= 4 ? 1 : g <= 8 ? 2 : 4;
}
// the ring, which after the last tile holds the key parts' partials
// [parts][heads][D + 4] for the merge
__host__ __device__ constexpr size_t ring_bytes(int esz, int d, int g,
                                                int tk) {
  const size_t ring = (size_t)kStages * 2 * tk * row_bytes(esz, d);
  const size_t merge =
      4 * (size_t)key_parts(g) * imin(g, kHeadChunk) * (d + 4);
  return ring > merge ? ring : merge;
}
// dynamic shared memory of one split CTA: ring, q [heads][D] f32, p
// [warps][keys a part][NH] f32, the live list and its ballot masks, n_live
// (the wrapper's `smem_bytes`)
__host__ __device__ constexpr size_t smem_bytes(int esz, int d, int g, int tk,
                                                int split_len) {
  return ring_bytes(esz, d, g, tk) + 4 * (size_t)imin(g, kHeadChunk) * d +
         4 * (size_t)kWarps * (tk / key_parts(g)) * warp_heads(g) +
         4 * (size_t)split_len + 4 * (size_t)((split_len + 31) / 32) + 16;
}

// The scores of one warp's key part against its NH heads: lane l leaves
// with the f32 dot product of key l (keys at or past `kn` score 0).  Lane
// l holds columns 4 (l + 32 c) .. + 3 of q and of each key.  The keys go
// in batches of NB (8, or 4 where four heads must fit 128 registers), a
// loop unrolled only as far as the registers allow (batches must not pile
// up in them): register r of lane l sums lane l's columns of batch key
// r ^ (l % NB); log2 NB shuffle levels (register r + m to lane l ^ m, added
// into its register r) leave register 0 of lane l the sum of key l % NB
// over the NB lanes l ^ 0..NB-1, with no select, and the levels from NB to
// 16 add the other lanes.  Lane l keeps batch l / NB's sum.
template <int M, int NB, int NH>
__device__ __forceinline__ void scatter(float (&part)[NH][NB]) {
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int r = 0; r < M; ++r)
      part[h][r] += __shfl_xor_sync(0xffffffffu, part[h][r + M], M);
  if constexpr (M > 1) scatter<M / 2>(part);
}

template <typename T, int D, int VL, int NH, int NB>
__device__ __forceinline__ void part_scores(const uint8_t* ks, int kn,
                                            int lane, const float* q_rows,
                                            float (&s)[NH]) {
  constexpr int C4 = D / 4;
  constexpr int RS = row_bytes(sizeof(T), D);
  float4 q[NH][VL];  // the heads' rows are four apart
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    s[h] = 0.f;
#pragma unroll
    for (int c = 0; c < VL; ++c)
      q[h][c] = C4 % 32 == 0 || lane + 32 * c < C4
                    ? reinterpret_cast<const float4*>(q_rows + 4 * h * D)
                          [lane + 32 * c]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const uint8_t* col = ks + lane * 4 * (int)sizeof(T);
  const int sub = lane % NB;
  // more batches in flight where their registers allow it
  constexpr int UNROLL = NH * VL > 2 ? 1 : sizeof(T) == 2 ? 4 : 2;
#pragma unroll UNROLL
  for (int b = 0; b < (kn + NB - 1) / NB; ++b) {
    float part[NH][NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      const int t = NB * b + (r ^ sub);
      float4 kk[VL];
#pragma unroll
      for (int c = 0; c < VL; ++c)
        kk[c] = t < kn && (C4 % 32 == 0 || lane + 32 * c < C4)
                    ? attn::load4(reinterpret_cast<const T*>(
                          col + t * RS + 32 * c * 4 * (int)sizeof(T)))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < VL; ++c) {
          d = fmaf(q[h][c].x, kk[c].x, d);
          d = fmaf(q[h][c].y, kk[c].y, d);
          d = fmaf(q[h][c].z, kk[c].z, d);
          d = fmaf(q[h][c].w, kk[c].w, d);
        }
        part[h][r] = d;
      }
    }
    scatter<NB / 2>(part);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      float sum = part[h][0];
#pragma unroll
      for (int m = NB; m < 32; m *= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, m);
      s[h] = b == lane / NB ? sum : s[h];
    }
  }
}

// The largest of a warp's 32 floats (no NaN) in one integer reduction:
// flipping the magnitude bits of negative floats orders them as ints.
__device__ __forceinline__ float warp_max(float x) {
  int i = __float_as_int(x);
  i ^= (i >> 31) & 0x7fffffff;
  i = __reduce_max_sync(0xffffffffu, i);
  i ^= (i >> 31) & 0x7fffffff;
  return __int_as_float(i);
}

// NH probabilities of one key as one vector
template <int NH> struct Probs;
template <> struct Probs<1> { float p[1]; };
template <> struct __align__(8) Probs<2> { float p[2]; };
template <> struct __align__(16) Probs<4> { float p[4]; };

// two CTAs an SM below D 256 (at most 128 registers a thread), one at it
template <typename T, int D, int NH>
__global__ void __launch_bounds__(kThreads, D < 256 ? 2 : 1)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ k_pos,
                    const int* __restrict__ q_pos, float* __restrict__ o_part,
                    float* __restrict__ ml_part, int H, int Kv, int S,
                    int split_len, int tk, long long sb, long long sh,
                    long long ss, int window, float scale) {
  constexpr int V = 16 / sizeof(T);      // elements per 16-byte copy
  constexpr int VPR = D / V;             // copies per row
  static_assert(D % V == 0, "head dim must be a multiple of the vector");
  constexpr int RS = row_bytes(sizeof(T), D);
  constexpr int C4 = D / 4;              // groups of four columns
  constexpr int VL = (C4 + 31) / 32;     // column groups a lane holds
  // keys of P V in flight: more at D 256, where a CTA has every register
  constexpr int PV_UNROLL = D == 256 ? 8 : 4;
  const int G = H / Kv;
  const int n_hc = (G + kHeadChunk - 1) / kHeadChunk;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kv = blockIdx.y / n_hc, hc = blockIdx.y % n_hc;
  const int g0 = hc * kHeadChunk, gc = imin(kHeadChunk, G - g0);
  const int kparts = key_parts(G);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this warp's first head, key part and number of heads (g = gw + 4h)
  const int gw = G >= 4 ? warp % 4 : warp % G;
  const int part = G >= 4 ? warp / 4 : warp / G;
  const int nh = part >= kparts || gw >= gc ? 0
                 : G >= 4                   ? (gc - gw + 3) / 4
                                            : 1;
  const int tkw = tk / kparts, k0 = part * tkw;  // this part of each tile

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;  // [stage][K, V][tk][RS bytes]
  float* q_s = reinterpret_cast<float*>(smem + ring_bytes(sizeof(T), D, G, tk));
  Probs<NH>* p_all =
      reinterpret_cast<Probs<NH>*>(q_s + imin(G, kHeadChunk) * D);
  Probs<NH>* p_s = p_all + warp * tkw;  // [tkw]: this warp's p by key
  int* live_s = reinterpret_cast<int*>(p_all + kWarps * tkw);
  unsigned* mask_s = reinterpret_cast<unsigned*>(live_s + split_len);
  int* n_live_s = reinterpret_cast<int*>(mask_s + (split_len + 31) / 32);

  const int qp = q_pos[b];
  const int lo = split * split_len;
  const int hi = imin(S, lo + split_len);
  const int n32 = (hi - lo + 31) / 32;
  const int* pb = k_pos + (size_t)b * S;
  // the split's admitted slots, 32 a ballot
  for (int c = warp; c < n32; c += kWarps) {
    const int t = lo + 32 * c + lane;
    bool ok = false;
    if (t < hi) {
      const int kp = pb[t];
      ok = kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
    }
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) mask_s[c] = m;
  }
  // q rows of this CTA's heads, as f32
  for (int i = threadIdx.x; i < gc * VPR; i += kThreads) {
    const int g = i / VPR, c = i % VPR;
    const uint4 raw = __ldg(
        reinterpret_cast<const uint4*>(
            q + ((size_t)b * H + (size_t)kv * G + g0 + g) * D) + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int x = 0; x < V; ++x) q_s[g * D + c * V + x] = attn::to_float(e[x]);
  }
  __syncthreads();
  // compact: each ballot's slots land after the earlier ballots' count
  for (int c = warp; c < n32; c += kWarps) {
    int before = 0;
    for (int j = lane; j < c; j += 32) before += __popc(mask_s[j]);
#pragma unroll
    for (int o = 16; o; o >>= 1)
      before += __shfl_xor_sync(0xffffffffu, before, o);
    const unsigned m = mask_s[c];
    if (m >> lane & 1u)
      live_s[before + __popc(m & ((1u << lane) - 1u))] = lo + 32 * c + lane;
  }
  if (threadIdx.x == 0) {
    int n = 0;
    for (int c = 0; c < n32; ++c) n += __popc(mask_s[c]);
    *n_live_s = n;
  }
  __syncthreads();
  const int n_live = *n_live_s;
  const int n_tiles = (n_live + tk - 1) / tk;

  const T* kb = k + (size_t)b * sb + (size_t)kv * sh;
  const T* vb = v + (size_t)b * sb + (size_t)kv * sh;
  // cp.async tile `tile`'s K and V rows into its stage (an empty group
  // past the last tile, so every iteration waits on the same count)
  auto issue = [&](int tile) {
    if (tile < n_tiles) {
      uint8_t* ks = ring + (size_t)(tile % kStages) * 2 * tk * RS;
      uint8_t* vs = ks + (size_t)tk * RS;
      const int j0 = tile * tk, rows = imin(tk, n_live - j0);
      for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
        const int r = i / VPR, c = i % VPR;
        const size_t off = (size_t)live_s[j0 + r] * ss + (size_t)c * V;
        hopper::cp_async<16>(ks + r * RS + c * 16, kb + off);
        hopper::cp_async<16>(vs + r * RS + c * 16, vb + off);
      }
    }
    hopper::cp_async_commit();
  };

  float m_r[NH], l_r[NH];
  float4 acc[NH][VL];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    m_r[h] = attn::NEG_INIT;
    l_r[h] = 0.f;
#pragma unroll
    for (int c = 0; c < VL; ++c) acc[h][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  issue(0);
  issue(1);
  for (int it = 0; it < n_tiles; ++it) {
    hopper::cp_async_wait<1>();  // tile it, this thread's copies
    // tile it is visible to every thread, and tile it - 1's stage is free
    __syncthreads();
    issue(it + 2);
    const uint8_t* ks = ring + (size_t)(it % kStages) * 2 * tk * RS + k0 * RS;
    const uint8_t* vs = ks + (size_t)tk * RS;
    const int kn = imin(tkw, n_live - it * tk - k0);  // this warp's keys
    if (nh == 0 || kn <= 0) continue;

    // scores: key l of this part in lane l
    float s_own[NH];
    part_scores<T, D, VL, NH, NH == 4 && D < 256 ? 4 : 8>(ks, kn, lane,
                                                       q_s + gw * D, s_own);

    // the online softmax of each head over this part's keys, key l in
    // lane l
    const bool has = lane < kn;
    Probs<NH> pr;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      pr.p[h] = 0.f;
      if (h < nh) {
        const float sc = has ? s_own[h] * scale : attn::MASKED;
        const float m_new = fmaxf(m_r[h], warp_max(sc));  // m starts finite
        const float p = expf(sc - m_new);        // a masked lane: 0
        float sum = p;
#pragma unroll
        for (int o = 16; o; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float alpha = expf(m_r[h] - m_new);
        m_r[h] = m_new;
        l_r[h] = fmaf(alpha, l_r[h], sum);
        pr.p[h] = p;
#pragma unroll
        for (int c = 0; c < VL; ++c) {
          acc[h][c].x *= alpha;
          acc[h][c].y *= alpha;
          acc[h][c].z *= alpha;
          acc[h][c].w *= alpha;
        }
      }
    }
    if (lane < tkw) p_s[lane] = pr;
    __syncwarp();

    // P V: each key's V row, at this lane's columns, into every head
#pragma unroll
    for (int c = 0; c < VL; ++c) {
      const int cg = lane + 32 * c;
      if (C4 % 32 == 0 || cg < C4) {
        const uint8_t* vc = vs + cg * 4 * (int)sizeof(T);
#pragma unroll PV_UNROLL
        for (int t = 0; t < kn; ++t) {
          const Probs<NH> pp = p_s[t];
          const float4 x = attn::load4(reinterpret_cast<const T*>(vc + t * RS));
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            acc[h][c].x = fmaf(pp.p[h], x.x, acc[h][c].x);
            acc[h][c].y = fmaf(pp.p[h], x.y, acc[h][c].y);
            acc[h][c].z = fmaf(pp.p[h], x.z, acc[h][c].z);
            acc[h][c].w = fmaf(pp.p[h], x.w, acc[h][c].w);
          }
        }
      }
    }
  }

  // merge the key parts: each warp leaves its heads' partials in the ring
  __syncthreads();  // every warp is past its last tile; no copy in flight
  float* mg = reinterpret_cast<float*>(ring);  // [kparts][gc][D + 4]
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    if (h < nh) {
      float* slot = mg + ((size_t)part * gc + gw + 4 * h) * (D + 4);
#pragma unroll
      for (int c = 0; c < VL; ++c) {
        const int cg = lane + 32 * c;
        if (cg < C4) reinterpret_cast<float4*>(slot)[cg] = acc[h][c];
      }
      if (lane == 0) {
        slot[D] = m_r[h];
        slot[D + 1] = l_r[h];
      }
    }
  }
  __syncthreads();
  // one thread a head: the parts' max m and sum l, and each part's weight
  // exp(m_p - m) in place of its m (an empty part: m_p, l_p = NEG_INIT, 0)
  const size_t base = (((size_t)b * Kv + kv) * gridDim.x + split) * G + g0;
  if (threadIdx.x < gc) {
    const int g = threadIdx.x;
    float m = attn::NEG_INIT, l = 0.f;
    for (int p = 0; p < kparts; ++p)
      m = fmaxf(m, mg[((size_t)p * gc + g) * (D + 4) + D]);
    for (int p = 0; p < kparts; ++p) {
      float* slot = mg + ((size_t)p * gc + g) * (D + 4);
      const float w = expf(slot[D] - m);
      l = fmaf(w, slot[D + 1], l);
      slot[D] = w;
    }
    ml_part[(base + g) * 2] = m;
    ml_part[(base + g) * 2 + 1] = l;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gc * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float a = 0.f;
    for (int p = 0; p < kparts; ++p) {
      const float* slot = mg + ((size_t)p * gc + g) * (D + 4);
      a = fmaf(slot[D], slot[d], a);
    }
    o_part[(base + g) * D + d] = a;
  }
}

template <typename T, int D, int NH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kpos, const void* qpos, float* o_part,
                   float* ml_part, void* out, int B, int H, int Kv, int S,
                   int split_len, int n_split, int tk, long long sb,
                   long long sh, long long ss, int window, float scale,
                   cudaStream_t stream) {
  const int G = H / Kv;
  const size_t smem = smem_bytes(sizeof(T), D, G, tk, split_len);
  if (smem > kMaxSmem || tk % key_parts(G) || tk / key_parts(G) > 32)
    return cudaErrorInvalidValue;
  auto kern = decode_split_kernel<T, D, NH>;
  // above 48 KB a kernel needs leave to take more: given once per device,
  // for the most any launch of this instance takes (a call's host work
  // counts when a decode step is this short)
  static unsigned long long allowed = 0;  // bit d: granted on device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && !(allowed >> dev & 1ull)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
    if (e != cudaSuccess) return e;
    allowed |= 1ull << dev;
  }
  const int n_hc = (G + kHeadChunk - 1) / kHeadChunk;
  kern<<<dim3(n_split, Kv * n_hc, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kpos),
      static_cast<const int*>(qpos), o_part, ml_part, H, Kv, S, split_len, tk,
      sb, sh, ss, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn::decode_combine_kernel<T>
      <<<dim3(H, B), attn::combine_threads(D), 0, stream>>>(
      o_part, ml_part, static_cast<T*>(out), H, Kv, D, n_split);
  return cudaGetLastError();
}

// NH, the most heads a warp takes (warp_heads)
template <typename T, int D>
cudaError_t by_heads(int nh, const void* q, const void* k, const void* v,
                     const void* kpos, const void* qpos, float* o_part,
                     float* ml_part, void* out, int B, int H, int Kv, int S,
                     int split_len, int n_split, int tk, long long sb,
                     long long sh, long long ss, int window, float scale,
                     cudaStream_t s) {
  if (nh <= 1)
    return launch<T, D, 1>(q, k, v, kpos, qpos, o_part, ml_part, out, B, H,
                           Kv, S, split_len, n_split, tk, sb, sh, ss, window,
                           scale, s);
  if (nh == 2)
    return launch<T, D, 2>(q, k, v, kpos, qpos, o_part, ml_part, out, B, H,
                           Kv, S, split_len, n_split, tk, sb, sh, ss, window,
                           scale, s);
  return launch<T, D, 4>(q, k, v, kpos, qpos, o_part, ml_part, out, B, H, Kv,
                         S, split_len, n_split, tk, sb, sh, ss, window, scale,
                         s);
}

template <typename T>
cudaError_t dispatch(int D, int nh, const void* q, const void* k,
                     const void* v, const void* kpos, const void* qpos,
                     float* o_part, float* ml_part, void* out, int B, int H,
                     int Kv, int S, int split_len, int n_split, int tk,
                     long long sb, long long sh, long long ss, int window,
                     float scale, cudaStream_t s) {
  switch (D) {
    case 16: return by_heads<T, 16>(nh, q, k, v, kpos, qpos, o_part, ml_part, out, B, H, Kv, S, split_len, n_split, tk, sb, sh, ss, window, scale, s);
    case 64: return by_heads<T, 64>(nh, q, k, v, kpos, qpos, o_part, ml_part, out, B, H, Kv, S, split_len, n_split, tk, sb, sh, ss, window, scale, s);
    case 120: return by_heads<T, 120>(nh, q, k, v, kpos, qpos, o_part, ml_part, out, B, H, Kv, S, split_len, n_split, tk, sb, sh, ss, window, scale, s);
    case 128: return by_heads<T, 128>(nh, q, k, v, kpos, qpos, o_part, ml_part, out, B, H, Kv, S, split_len, n_split, tk, sb, sh, ss, window, scale, s);
    case 256: return by_heads<T, 256>(nh, q, k, v, kpos, qpos, o_part, ml_part, out, B, H, Kv, S, split_len, n_split, tk, sb, sh, ss, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of one split CTA for element size `esz`, head dim
// d, G query heads a KV head, tk keys a tile and split_len slots a split
// (the wrapper's `smem_bytes`, held equal to it on the card).
extern "C" long long decode_attention_smem_bytes(int esz, int d, int g,
                                                 int tk, int split_len) {
  return (long long)smem_bytes(esz, d, g, tk, split_len);
}

// q [B,H,D] contiguous; k, v [B,Kv,S,D] with D contiguous and element
// strides sb, sh, ss (shared by k and v); k_pos [B,S] int32; q_pos [B]
// int32; o_part [B,Kv,n_split,G,D] and ml_part [B,Kv,n_split,G,2] f32
// scratch; out [B,H,D]; tk keys a tile (64, 32 or 16).  dtype: 0 =
// float32, 1 = bfloat16 (q, k, v and out alike).  Returns the launches'
// cudaError_t.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_pos,
    const void* q_pos, void* o_part, void* ml_part, void* out, int B, int H,
    int Kv, int S, int D, int split_len, int n_split, int tk, long long sb,
    long long sh, long long ss, int window, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* ml = static_cast<float*>(ml_part);
  const int nh = warp_heads(H / Kv);
  if (dtype == 0)
    return dispatch<float>(D, nh, q, k, v, k_pos, q_pos, op, ml, out, B, H,
                           Kv, S, split_len, n_split, tk, sb, sh, ss, window,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, nh, q, k, v, k_pos, q_pos, op, ml, out,
                                   B, H, Kv, S, split_len, n_split, tk, sb,
                                   sh, ss, window, scale, s);
  return cudaErrorInvalidValue;
}
