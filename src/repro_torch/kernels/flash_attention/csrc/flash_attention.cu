// Flash attention forward for Hopper (sm_90a): causal, sliding-window and
// non-causal GQA attention, q [B,H,Sq,D] against k/v [B,Kv,Sk,D], with an
// optional logsumexp output lse [B,H,Sq] f32 for the backward kernels.
// Query head h reads KV head h / (H / Kv).  A query q admits key k when
// k < Sk, k <= q (causal) and q - k < window (window > 0).  Self-attention
// has Sk = Sq; keys of another length (cross-attention, an encoder's
// frames) come without a mask, and the entry point refuses a causal or
// windowed call at Sk != Sq.  The q tiles and their valid rows follow Sq,
// the key loop, its ragged last tile and the mask follow Sk.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// flash_attention (:83) and flash_attention_fwd_lse (:135), both over the
// Pallas TPU kernel `_kernel` (:31).
//
// Bound on this card: operations.  At yi-6b's training shapes (B 2, H 32,
// Kv 4, S 4096, D 128, bf16, causal) the admitted pairs need 274.9 GFLOP
// of QK^T and PV, 0.278 ms at the bf16 tensor-core peak, against ~152 MB
// of q, k, v, o and lse, 0.045 ms at 3.35 TB/s.  At recurrentgemma-9b's
// (B 2, H 16, Kv 1, S 4096, D 256, causal, window 2048) 206.2 GFLOP,
// 0.2085 ms at 989 TFLOP/s.  The tensor-core kernels keep every operand
// of the products in shared memory or registers and run them on wgmma; at
// D 256 a CTA owns 128 q rows, which halves the K/V fills a row needs.
//
// Two routes, a fixed dispatch on dtype and head dim in the extern "C"
// entry point (flash_tc.cuh's `tensor_core_route`, which
// `flash_attention_fwd_route` reports and flash_attention.py's
// `fwd_route` states again; it is no fallback, and a launch that fails
// returns its error):
//
// * Tensor cores: bf16 at D 64, 120, 128 and 256.  At D <= 128
//   (`flash_fwd_kernel_wgmma`) one CTA per (64 q rows, query head,
//   batch), the tiles with the most keys launched first, two CTAs per SM.
//   A CTA is one consumer warpgroup and one producer warp.  The producer
//   loads the Q tile once and streams 64-key K and V tiles, from the
//   window's first tile to the diagonal tile only, through a two-stage
//   full/empty mbarrier ring, by TMA (3-D tensor maps over [B*H or B*Kv,
//   S, D], 64-column boxes in the 128-byte swizzle: the hardware
//   zero-fills the ragged S tail and D = 120's columns 120-127 without
//   crossing into the next head).  The consumer computes S = Q K^T by
//   wgmma from shared memory (both operands K-major) into f32 registers
//   and keeps the online softmax there: a thread holds 2 rows x 16 keys
//   of S, so a row's max and sum are two xor-shuffles among the 4 lanes
//   of a quad; scores are taken in the log2 domain (D^-0.5 log2(e) folded
//   into one scale, ex2.approx), a masked score is -inf and gives p = 0,
//   and tiles wholly inside the mask skip the mask test.  P is rounded to
//   bf16 and packed straight from the accumulator layout into register A
//   operands of O += P V, whose B operand is the same V tile read
//   MN-major: nothing goes back to shared memory.  P meets V in bf16, as
//   FlashAttention-2/3 and SDPA do; the reference keeps P in f32 (ROADMAP
//   Queue 3 logs the difference).  The epilogue writes o = acc / l (0
//   where l == 0) and, when lse is not null, lse = (m2 + log2(max(l,
//   1e-30))) / log2(e) in natural-log units (m2 the running max in the
//   log2 domain).
//   At D 256 (`flash_fwd2_kernel_wgmma`, FlashAttention-3's forward shape)
//   the 64 x 256 f32 O accumulator is 128 registers a thread, so one CTA
//   an SM, and it owns 128 q rows: two consumer warpgroups, 64 rows each,
//   run the same step on their own accumulator, m and l, and read every
//   stage of one K/V ring, so a stage's fill serves 128 rows; while one
//   warpgroup runs its softmax the other's products keep the tensor cores
//   busy (the two run unsynchronised against the ring).  A producer
//   warpgroup loads both Q halves once (the upper one only if it holds a
//   q row) and streams the union of the halves' admitted key tiles, from
//   the lower half's window start to the upper half's diagonal; a
//   warpgroup whose rows a stage's keys cannot reach (under the window
//   the upper half's first tiles, the lower half's last) and one with no
//   row below Sq waits for the stage and releases it without a product,
//   so the empty barrier counts both warpgroups every stage.  A row's
//   arithmetic, and the tiles it takes, follow from its own warpgroup's
//   rows alone: the same bits at any H, B or other half.  384 threads
//   leave 168 registers a thread, where the accumulator spills, so the
//   producer warpgroup hands its registers to the consumers
//   (`setmaxnreg`, flash_tc.cuh's kProducerRegs / kConsumerRegs); Q (2 x
//   32 KB) and two K/V stages (2 x 64 KB) take 193 KB of shared memory.
// * CUDA cores: f32 at every D (the route phase 5's card-against-CPU
//   parity measures) and bf16 at D 16 (`flash_fwd_kernel`).  One CTA per
//   (q tile of 64 rows, 32 at D = 256; query head; batch), the tiles with
//   the most keys launched first.  The TPU kernel's sequential kv grid
//   axis becomes a loop inside the CTA over the 32-key tiles from the
//   window's first tile to the diagonal tile only, each staged in shared
//   memory as f32 (padded rows, conflict-free reads).  The online softmax
//   state lives in registers: a thread owns 4 (2) rows and 4 keys of the
//   score tile and the same rows times D/8 columns of the output, so the
//   row max and sum are three xor-shuffles among the 8 lanes of a row
//   group.  Scores are scaled by D^-0.5 after the dot, as the TPU kernel
//   does; the probabilities go through shared memory into P V.  At the
//   end o = acc / l (0 where l == 0) and, when lse is not null, lse = m +
//   log(max(l, 1e-30)).  Scalar FMAs.
// Any Sq and Sk are taken without padding.
#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"

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
                 float* __restrict__ lse, int H, int Kv, int Sq, int Sk,
                 int causal, int window, float scale) {
  constexpr int BQ = flash::q_rows<D>();
  constexpr int RM = BQ / flash::RG;   // query rows per thread
  constexpr int LD = D + 1;
  constexpr int CPT = D / KG;          // output columns per thread
  const int tid = threadIdx.x;
  const int rg = tid / KG, kg = tid % KG;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kv);
  const int valid_q = min(BQ, Sq - q0);

  extern __shared__ float smem[];
  float* q_s = smem;            // [BQ][LD]
  float* k_s = q_s + BQ * LD;   // [BK][LD]
  float* v_s = k_s + BK * LD;   // [BK][LD]
  float* p_s = v_s + BK * LD;   // [BQ][PS]

  const size_t row0 = (size_t)(b * H + h) * Sq;    // this head's first row
  const size_t krow0 = (size_t)(b * Kv + kvh) * Sk;
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
  const int k_hi = causal ? min(Sk, q0 + BQ) - 1 : Sk - 1;
  for (int kt = k_lo / BK; kt <= k_hi / BK; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's readers are done; q_s is loaded
    flash::load_rows<T, D>(k + (krow0 + k0) * D, BK, min(BK, Sk - k0), k_s,
                           LD);
    flash::load_rows<T, D>(v + (krow0 + k0) * D, BK, min(BK, Sk - k0), v_s,
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
        const bool ok = flash::admits(qi, k0 + kg + KG * j, Sk, causal, window);
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
                   void* lse, int B, int H, int Kv, int Sq, int Sk,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr int BQ = flash::q_rows<D>();
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * PS);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = flash::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((Sq + BQ - 1) / BQ, H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, Kv, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// Tensor-core route: bf16 at D 64, 120, 128 and 256.
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
__global__ void __launch_bounds__(kThreadsTC, 2)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int H, int Kv, int Sq,
                       int Sk, int causal, int window, float scale) {
  constexpr int DP = padded<D>();
  constexpr int KV_CHUNK = kKeys * 128, Q_CHUNK = kRows * 128;
  constexpr int KV_BYTES = tile_bytes<DP>(kKeys);
  constexpr int Q_BYTES = tile_bytes<DP>(kRows);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* k_s = q_s + Q_BYTES;              // [kStages][KV_BYTES]
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
    mbar_arrive_expect_tx(&q_full, Q_BYTES);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
      tma_load_3d(q_s + c * Q_CHUNK, &tm_q, &q_full, c * 64, q0, bh);
    stream_kv<DP>(k_s, v_s, &tm_k, &tm_v, full, empty, kt_lo, n_it, bkv);
    return;
  }

  // the consumer warpgroup: accumulator rows `row` and `row + 8` (q rows),
  // columns `col + 8j` and `col + 8j + 1` (keys of the step, or columns of
  // the output); element i of an accumulator lies in row row + 8((i/2)%2)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 4, col = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  float m[2] = {attn::NEG_INIT, attn::NEG_INIT};  // running max, log2 units
  float l[2] = {0.f, 0.f};                        // running sum of p
  float o_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o_acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s);
  mbar_wait(&q_full, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int k0 = (kt_lo + it) * kKeys;
    const uint32_t k_addr = smem_u32(k_s + s * KV_BYTES);
    const uint32_t v_addr = smem_u32(v_s + s * KV_BYTES);
    mbar_wait(&full[s], (it / kStages) & 1);

    // S = Q K^T, [q rows, keys]
    float st[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16)
      wgmma_ss_n64(st, desc_k(q_addr, Q_CHUNK, kk),
                   desc_k(k_addr, KV_CHUNK, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);

    // online softmax in the log2 domain; a masked score is -inf (p = 0),
    // keys past Sk among them (TMA reads them as zeros)
    float alpha[2];
    softmax_step<kKeys>(st, m, l, alpha, scale_log2,
                        whole_tile(q0, k0, Sq, Sk, causal, window),
                        [&](int e, int kj) {
                          return flash::admits(q0 + row + 8 * e, k0 + kj, Sk,
                                               causal, window);
                        });
    scale_rows(o_acc, alpha);
    uint32_t pa[kKeys / 16][4];
    pack_p<kKeys>(st, pa);

    // O += P V: V read MN-major from the same tile
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs<DP>(o_acc, pa[kk], desc_mn(v_addr, KV_CHUNK, 16 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);
    mbar_arrive(&empty[s]);  // this stage's K and V are read
  }

  const size_t qrow0 = (size_t)bh * Sq + q0;
  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) inv[e] = l[e] == 0.f ? 0.f : 1.f / l[e];
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int e = (i / 2) % 2;
    const int r = row + 8 * e, c = col + 8 * (i / 4);
    if (r < valid_q && c < D)
      *reinterpret_cast<uint32_t*>(out + (qrow0 + r) * D + c) =
          pack_bf16(o_acc[i] * inv[e], o_acc[i + 1] * inv[e]);
  }
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (row + 8 * e < valid_q)
        lse[qrow0 + row + 8 * e] =
            (m[e] + log2f(fmaxf(l[e], 1e-30f))) / kLog2e;
  }
}

// D 256: q rows per CTA, two warpgroups' 64 each
constexpr int kPairRows = 2 * kRows;

// One CTA per (128 q rows, query head, batch), the tiles with the most
// keys first; warpgroups 0 and 1 each own 64 of the rows (q rows past Sq
// run no products) and take every stage of one K/V ring, warpgroup 2 is
// the producer (see the header).
template <int D>
__global__ void __launch_bounds__(kThreadsPair, 1)
flash_fwd2_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int H, int Kv, int Sq,
                        int Sk, int causal, int window, float scale) {
  constexpr int DP = padded<D>();
  constexpr int KV_CHUNK = kKeys * 128, Q_CHUNK = kRows * 128;
  constexpr int KV_BYTES = tile_bytes<DP>(kKeys);
  constexpr int Q_BYTES = tile_bytes<DP>(kRows);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);        // [2 warpgroups][Q_BYTES]
  uint8_t* k_s = q_s + 2 * Q_BYTES;          // [kStages][KV_BYTES]
  uint8_t* v_s = k_s + kStages * KV_BYTES;   // [kStages][KV_BYTES]
  __shared__ __align__(8) uint64_t q_full, full[kStages], empty[kStages];

  const int n_qt = (Sq + kPairRows - 1) / kPairRows;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kPairRows;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, bkv = b * Kv + h / (H / Kv);
  // admitted keys of both warpgroups' rows: [k_lo, k_hi], from the lower
  // one's window start to the upper one's diagonal
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Sk, q0 + kPairRows) - 1 : Sk - 1;
  const int kt_lo = k_lo / kKeys;
  const int n_it = k_hi / kKeys - kt_lo + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kPairConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = role();
  if (wg == 2) {  // the producer warpgroup: one lane issues
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != kPairConsumers) return;
    const int halves = Sq - q0 > kRows ? 2 : 1;  // those holding a q row
    mbar_arrive_expect_tx(&q_full, halves * Q_BYTES);
    for (int x = 0; x < halves; ++x)
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        tma_load_3d(q_s + x * Q_BYTES + c * Q_CHUNK, &tm_q, &q_full, c * 64,
                    q0 + x * kRows, bh);
    stream_kv<DP>(k_s, v_s, &tm_k, &tm_v, full, empty, kt_lo, n_it, bkv);
    return;
  }

  // a consumer warpgroup: accumulator rows `row` and `row + 8` of its 64
  // q rows, columns `col + 8j` and `col + 8j + 1` (keys of the step, or
  // columns of the output)
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x - wg * kConsumers;
  const int warp = tid / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 4, col = 2 * (lane % 4);
  const int qw = q0 + wg * kRows;            // this warpgroup's first q row
  const int valid_q = min(kRows, Sq - qw);   // <= 0: none
  // the steps whose key tile admits one of this warpgroup's rows:
  // [it_lo, it_hi], empty without rows; the others it only releases
  const int it_lo =
      (window > 0 ? max(0, qw - window + 1) : 0) / kKeys - kt_lo;
  const int it_hi = valid_q <= 0 ? -1
                    : (causal ? min(Sk, qw + kRows) - 1 : Sk - 1) / kKeys -
                          kt_lo;
  const float scale_log2 = scale * kLog2e;
  float m[2] = {attn::NEG_INIT, attn::NEG_INIT};  // running max, log2 units
  float l[2] = {0.f, 0.f};                        // running sum of p
  float o_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o_acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s + wg * Q_BYTES);
  mbar_wait(&q_full, 0);

  int it = 0;
  for (; it < min(it_lo, n_it); ++it) {  // a stage before this one's keys
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    mbar_arrive(&empty[it % kStages]);
  }
  for (; it <= it_hi; ++it) {
    const int s = it % kStages;
    const int k0 = (kt_lo + it) * kKeys;
    const uint32_t k_addr = smem_u32(k_s + s * KV_BYTES);
    const uint32_t v_addr = smem_u32(v_s + s * KV_BYTES);
    mbar_wait(&full[s], (it / kStages) & 1);

    // S = Q K^T, [q rows, keys]
    float st[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16)
      wgmma_ss_n64(st, desc_k(q_addr, Q_CHUNK, kk),
                   desc_k(k_addr, KV_CHUNK, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);

    // online softmax in the log2 domain; a masked score is -inf (p = 0),
    // keys past Sk among them (TMA reads them as zeros)
    float alpha[2];
    softmax_step<kKeys>(st, m, l, alpha, scale_log2,
                        whole_tile(qw, k0, Sq, Sk, causal, window),
                        [&](int e, int kj) {
                          return flash::admits(qw + row + 8 * e, k0 + kj, Sk,
                                               causal, window);
                        });
    scale_rows(o_acc, alpha);
    uint32_t pa[kKeys / 16][4];
    pack_p<kKeys>(st, pa);

    // O += P V: V read MN-major from the same tile
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs<DP>(o_acc, pa[kk], desc_mn(v_addr, KV_CHUNK, 16 * kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);
    mbar_arrive(&empty[s]);  // this stage's K and V are read
  }
  for (; it < n_it; ++it) {  // a stage past this one's keys
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    mbar_arrive(&empty[it % kStages]);
  }

  const size_t qrow0 = (size_t)bh * Sq + qw;
  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) inv[e] = l[e] == 0.f ? 0.f : 1.f / l[e];
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int e = (i / 2) % 2;
    const int r = row + 8 * e, c = col + 8 * (i / 4);
    if (r < valid_q && c < D)
      *reinterpret_cast<uint32_t*>(out + (qrow0 + r) * D + c) =
          pack_bf16(o_acc[i] * inv[e], o_acc[i + 1] * inv[e]);
  }
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (row + 8 * e < valid_q)
        lse[qrow0 + row + 8 * e] =
            (m[e] + log2f(fmaxf(l[e], 1e-30f))) / kLog2e;
  }
}

// the dynamic shared memory of a launch: 1024 bytes of alignment slack,
// the Q tile (both warpgroups' halves at D 256) and the K/V ring
template <int D>
constexpr size_t fwd_smem() {
  return 1024 + (D == 256 ? 2 : 1) * tile_bytes<padded<D>()>(kRows) +
         2 * kStages * tile_bytes<padded<D>()>(kKeys);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int H, int Kv, int Sq, int Sk,
                   int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!hopper::make_map(&mq, q, B * H, Sq, D, kRows) ||
      !hopper::make_map(&mk, k, B * Kv, Sk, D, kKeys) ||
      !hopper::make_map(&mv, v, B * Kv, Sk, D, kKeys))
    return cudaErrorNotSupported;
  constexpr bool pair = D == 256;
  constexpr int rows = pair ? kPairRows : kRows;
  const size_t smem = fwd_smem<D>();
  auto go = [&](auto kern, int threads) {
    cudaError_t e = flash::allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3((Sq + rows - 1) / rows, H, B), threads, smem, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(lse), H, Kv, Sq, Sk, causal, window, scale);
    return cudaGetLastError();
  };
  if constexpr (pair)
    return go(flash_fwd2_kernel_wgmma<D>, kThreadsPair);
  else
    return go(flash_fwd_kernel_wgmma<D>, kThreadsTC);
}

}  // namespace tc

cudaError_t dispatch_tc(int D, const void* q, const void* k, const void* v,
                        void* out, void* lse, int B, int H, int Kv, int Sq,
                        int Sk, int causal, int window, float scale,
                        cudaStream_t s) {
  switch (D) {
    case 64: return tc::launch<64>(q, k, v, out, lse, B, H, Kv, Sq, Sk, causal, window, scale, s);
    case 120: return tc::launch<120>(q, k, v, out, lse, B, H, Kv, Sq, Sk, causal, window, scale, s);
    case 128: return tc::launch<128>(q, k, v, out, lse, B, H, Kv, Sq, Sk, causal, window, scale, s);
    case 256: return tc::launch<256>(q, k, v, out, lse, B, H, Kv, Sq, Sk, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// the CUDA-core kernel: f32 at every head dim, bf16 at D 16
template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* out, void* lse, int B, int H, int Kv, int Sq,
                     int Sk, int causal, int window, float scale,
                     cudaStream_t s) {
  constexpr bool f32 = std::is_same<T, float>::value;
#define FLASH_FWD(DV) \
  return launch<T, DV>(q, k, v, out, lse, B, H, Kv, Sq, Sk, causal, window, scale, s)
  switch (D) {
    case 16: FLASH_FWD(16);
    case 64: if constexpr (f32) FLASH_FWD(64); break;
    case 120: if constexpr (f32) FLASH_FWD(120); break;
    case 128: if constexpr (f32) FLASH_FWD(128); break;
    case 256: if constexpr (f32) FLASH_FWD(256); break;
  }
#undef FLASH_FWD
  return cudaErrorInvalidValue;
}

}  // namespace

// 1 when a call of this head dim and dtype (0 = float32, 1 = bfloat16)
// takes the tensor-core kernel, 0 when it takes the CUDA-core one.
extern "C" int flash_attention_fwd_route(int D, int dtype) {
  return flash_tc::tensor_core_route(D, dtype) ? 1 : 0;
}

// The dynamic shared memory a tensor-core launch sets; 0 off the
// tensor-core head dims.
extern "C" long long flash_attention_fwd_tc_smem(int D) {
  switch (D) {
    case 64: return tc::fwd_smem<64>();
    case 120: return tc::fwd_smem<120>();
    case 128: return tc::fwd_smem<128>();
    case 256: return tc::fwd_smem<256>();
  }
  return 0;
}

// q [B,H,Sq,D]; k/v [B,Kv,Sk,D]; out [B,H,Sq,D]; lse [B,H,Sq] f32 or
// null.  causal: 0/1; window <= 0 = none; Sk != Sq only with neither.
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out,
                                          void* lse, int B, int H, int Kv,
                                          int Sq, int Sk, int D, int causal,
                                          int window, float scale, int dtype,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Kv <= 0 || H % Kv != 0 || H > 65535 || B > 65535 || Sq <= 0 ||
      Sk <= 0 || (Sk != Sq && (causal || window > 0)))
    return cudaErrorInvalidValue;
  if (flash_tc::tensor_core_route(D, dtype))
    return dispatch_tc(D, q, k, v, out, lse, B, H, Kv, Sq, Sk, causal,
                       window, scale, s);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, out, lse, B, H, Kv, Sq, Sk, causal,
                           window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, out, lse, B, H, Kv, Sq, Sk,
                                   causal, window, scale, s);
  return cudaErrorInvalidValue;
}
