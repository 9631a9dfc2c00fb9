// RWKV-6 WKV scan for Hopper (sm_90a): the per-head recurrence of the time
// mix with data-dependent decay,
//
//     y_t[j]  = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
//     S[i, j] <- exp(logw_t[i]) * S[i, j] + k_t[i] * v_t[j]
//
// over r, k, v, logw: [BH, S, 64] f32, bonus u [BH, 64] f32 and state
// s0 [BH, 64, 64] f32 (row i indexes k and w, column j indexes v).  Returns
// every y_t [BH, S, 64] beside the state after the last step,
// s_out [BH, 64, 64].  Any S: nothing is padded to a time chunk.
//
// Replaces: src/repro/kernels/rwkv6/rwkv6.py, rwkv6_scan_state (Pallas TPU
// kernel `_kernel`; `rwkv6_scan` is its zero-state wrapper).
//
// Bound on this card: bytes.  Per (row, step) the kernel reads 4 x 64
// inputs and writes 64 outputs (1280 bytes) for ~5 * 64^2 = 20480 f32
// flops; at 3.35 TB/s and 67 TFLOP/s (f32 outside the tensor cores) the
// byte time is ~1.26x the flop time.  In practice the step's f32
// instructions are what the card runs short of (the chunks' loads alone
// take well under half the kernel's time), so the design spends as few of
// them a step as the recurrence allows and keeps every scheduler fed.
//
// Design: the step recurrence on the CUDA cores in f32 (a chunked matrix
// form on the tensor cores would need TF32, and its decay factors
// exp(+-cumsum logw) overflow f32 within a chunk for strong decays; the TPU
// kernel takes that form for its MXU).
//   * Four warps a bh row, one row per CTA.  Thread (warp w, lane l) holds
//     the four columns 16w + 4 (l % 4) .. + 3 of S for the eight rows
//     4g .. 4g + 3 and 32 + 4g .. 32 + 4g + 3 (g = l / 4): 32 f32
//     registers, so S never touches memory between s0 and s_out.  y[j] is
//     the sum of eight row groups' partial dot products, joined by a
//     reduce-scatter of shuffles.  A quarter-warp's row reads fall on two
//     bank groups (the row groups interleave in 4-row blocks), so no
//     padding is needed.  512 rows make 2048 warps, four per scheduler of
//     the card's 528.
//   * Steps go in pairs that both run off the state before the pair
//     (see `prepare`): per element of S a pair costs two FMAs for the two
//     y's and three for the state, five instead of six.  Only products of
//     decays enter (never their inverses), so nothing overflows; the sums
//     come out within a few f32 ulps of the step-by-step order.
//   * Time advances in chunks of 16 steps through a ring of three stages
//     in shared memory (16 KB of r, k, v, logw each): chunk c + 2 streams
//     in by cp.async while chunk c + 1 is prepared (exp(logw) once per
//     element, the bonus dot product sum_i r_i u_i k_i once per step, the
//     pairs' products and cross term) and chunk c is computed.  One
//     __syncthreads a chunk.
//   * Three stages and 128 threads fit four CTAs on an SM, so every row of
//     the 512 at rwkv6-7b's mixed tick is resident at once.
// The inputs need only 8-byte alignment: where a base pointer is not
// 16-byte aligned the copies take 8 bytes (COPY = 8).
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kN = 64;            // head dim
constexpr int kThreads = 128;     // four warps a bh row
constexpr int kChunk = 16;        // time steps a stage holds
constexpr int kStages = 3;
constexpr int kArray = kChunk * kN;                // floats of one input
// r, k, w, v, then the steps' bonus sums and pair sums
constexpr int kStageFloats = 4 * kArray + 2 * kChunk;

template <int COPY>
__global__ void __launch_bounds__(kThreads, 4)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_out, int S) {
  extern __shared__ __align__(16) float smem[];    // [kStages][kStageFloats]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 2;                        // row group
  const int c0 = 16 * warp + 4 * (lane & 3);       // first owned column
  const size_t row = blockIdx.x;
  const size_t state = row * kN * kN;
  const size_t base = row * (size_t)S * kN;

  // S[i, c0 .. c0 + 3] for rows i = 32 blk + 4 rg + e at [4 blk + e]
  float sm[8][4];
#pragma unroll
  for (int blk = 0; blk < 2; ++blk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* src = s0 + state + (32 * blk + 4 * rg + e) * kN + c0;
      const float2 lo = *reinterpret_cast<const float2*>(src);
      const float2 hi = *reinterpret_cast<const float2*>(src + 2);
      sm[4 * blk + e][0] = lo.x;
      sm[4 * blk + e][1] = lo.y;
      sm[4 * blk + e][2] = hi.x;
      sm[4 * blk + e][3] = hi.y;
    }
  // the preparation of a chunk: thread tid takes rows 4 (tid % 16) .. + 3
  // of the step pair tid / 16, and their bonus weights u
  const int p_pair = tid >> 4, p_at = 4 * (tid & 15);
  const float4 u4 = make_float4(u[row * kN + p_at], u[row * kN + p_at + 1],
                                u[row * kN + p_at + 2], u[row * kN + p_at + 3]);

  const int n_chunks = (S + kChunk - 1) / kChunk;
  // chunk c's four inputs into its stage (an empty group past the end)
  auto issue = [&](int c) {
    if (c < n_chunks) {
      float* st = smem + (c % kStages) * kStageFloats;
      const int t0 = c * kChunk, n = min(kChunk, S - t0);
      constexpr int F = COPY / 4;                  // floats a copy
      constexpr int PER_STEP = kN / F;
#pragma unroll
      for (int a = 0; a < 4; ++a) {                // r, k, logw, v
        const float* g = (a == 0 ? r : a == 1 ? k : a == 2 ? logw : v) +
                         base + (size_t)t0 * kN;
        for (int i = tid; i < n * PER_STEP; i += kThreads)
          hopper::cp_async<COPY>(st + a * kArray + i * F, g + i * F);
      }
    }
    hopper::cp_async_commit();
  };
  // Chunk c has landed and every thread sees it.  For each pair of steps
  // (a, b = a + 1) the pair's work is rewritten in place, so that both
  // steps run off the state before a (S_a):
  //   y_a = r_a . S_a + ruk_a v_a
  //   y_b = (r_b * w_a) . S_a + c_b v_a + ruk_b v_b
  //   S_b+1 = (w_a * w_b) * S_a + (k_a * w_b) v_a + k_b v_b
  // with w = exp(logw) (once per element), ruk = sum_i r_i u_i k_i and
  // c_b = sum_i r_b,i k_a,i: r_b becomes r_b * w_a, k_a becomes k_a * w_b,
  // w_a becomes w_a * w_b.  Only products of decays appear (never their
  // inverses), so nothing overflows.  A chunk's last step without a pair
  // keeps its r, k and exp(logw).
  auto prepare = [&](int c) {
    if (c >= n_chunks) return;
    float* st = smem + (c % kStages) * kStageFloats;
    const int n = min(kChunk, S - c * kChunk);
    const int ta = 2 * p_pair, tb = ta + 1;
    float pa = 0.f, pb = 0.f, pc = 0.f;
    if (ta < n) {
      float* ra = st + ta * kN + p_at;
      float* ka = ra + kArray;
      float* wa = ra + 2 * kArray;
      const float4 r4 = *reinterpret_cast<float4*>(ra);
      const float4 k4 = *reinterpret_cast<float4*>(ka);
      float4 w4 = *reinterpret_cast<float4*>(wa);
      w4 = make_float4(expf(w4.x), expf(w4.y), expf(w4.z), expf(w4.w));
      pa = fmaf(r4.x * u4.x, k4.x, fmaf(r4.y * u4.y, k4.y,
           fmaf(r4.z * u4.z, k4.z, r4.w * u4.w * k4.w)));
      if (tb < n) {
        float* rb = ra + kN;
        float* kb = ka + kN;
        float* wb = wa + kN;
        const float4 r5 = *reinterpret_cast<float4*>(rb);
        const float4 k5 = *reinterpret_cast<float4*>(kb);
        float4 w5 = *reinterpret_cast<float4*>(wb);
        w5 = make_float4(expf(w5.x), expf(w5.y), expf(w5.z), expf(w5.w));
        pb = fmaf(r5.x * u4.x, k5.x, fmaf(r5.y * u4.y, k5.y,
             fmaf(r5.z * u4.z, k5.z, r5.w * u4.w * k5.w)));
        pc = fmaf(r5.x, k4.x, fmaf(r5.y, k4.y, fmaf(r5.z, k4.z, r5.w * k4.w)));
        *reinterpret_cast<float4*>(rb) = make_float4(
            r5.x * w4.x, r5.y * w4.y, r5.z * w4.z, r5.w * w4.w);
        *reinterpret_cast<float4*>(ka) = make_float4(
            k4.x * w5.x, k4.y * w5.y, k4.z * w5.z, k4.w * w5.w);
        w4 = make_float4(w4.x * w5.x, w4.y * w5.y, w4.z * w5.z, w4.w * w5.w);
      }
      *reinterpret_cast<float4*>(wa) = w4;
    }
    // the pair's 16 threads are lanes 0-15 or 16-31 of one warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      pa += __shfl_xor_sync(0xffffffffu, pa, off);
      pb += __shfl_xor_sync(0xffffffffu, pb, off);
      pc += __shfl_xor_sync(0xffffffffu, pc, off);
    }
    float* ruk = st + 4 * kArray;
    float* cb = ruk + kChunk;
    if ((tid & 15) == 0 && ta < n) {
      ruk[ta] = pa;
      if (tb < n) {
        ruk[tb] = pb;
        cb[tb] = pc;
      }
    }
  };

  issue(0);
  issue(1);
  hopper::cp_async_wait<1>();
  __syncthreads();
  prepare(0);
  // lane bits 4, 3, 2 pick the value a lane ends with in y's sums
  const bool b2 = lane & 16, b1 = lane & 8, b0 = lane & 4;
  for (int c = 0; c < n_chunks; ++c) {
    hopper::cp_async_wait<0>();         // chunk c + 1, this thread's copies
    // every copy of chunk c + 1 and every write of prepare(c) is visible,
    // and chunk c - 1's stage is no longer read
    __syncthreads();
    issue(c + 2);
    prepare(c + 1);
    const float* st = smem + (c % kStages) * kStageFloats;
    // this lane's rows of r (then k at + kArray, w at + 2 kArray), its
    // columns of v, and the bonus and pair sums
    const float* rows = st + 4 * rg;
    const float* cols = st + 3 * kArray + c0;
    const float* vcol = st + 3 * kArray;
    const float* ruk = st + 4 * kArray;
    const float* cb = ruk + kChunk;
    const int n = min(kChunk, S - c * kChunk);
    float* yc = y + base + (size_t)c * kChunk * kN;
    int t = 0;
    for (; t + 1 < n; t += 2) {
      const float4 va4 = *reinterpret_cast<const float4*>(cols + t * kN);
      const float4 vb4 = *reinterpret_cast<const float4*>(cols + t * kN + kN);
      const float va[4] = {va4.x, va4.y, va4.z, va4.w};
      const float vb[4] = {vb4.x, vb4.y, vb4.z, vb4.w};
      float ys[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // y_a, y_b
#pragma unroll
      for (int blk = 0; blk < 2; ++blk) {
        const float* at = rows + t * kN + 32 * blk;
        const float4 ra4 = *reinterpret_cast<const float4*>(at);
        const float4 rb4 = *reinterpret_cast<const float4*>(at + kN);
        const float4 ka4 = *reinterpret_cast<const float4*>(at + kArray);
        const float4 kb4 = *reinterpret_cast<const float4*>(at + kArray + kN);
        const float4 w4 = *reinterpret_cast<const float4*>(at + 2 * kArray);
        const float ra[4] = {ra4.x, ra4.y, ra4.z, ra4.w};
        const float rb[4] = {rb4.x, rb4.y, rb4.z, rb4.w};
        const float ka[4] = {ka4.x, ka4.y, ka4.z, ka4.w};
        const float kb[4] = {kb4.x, kb4.y, kb4.z, kb4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float& sij = sm[4 * blk + e][j];
            ys[j] = fmaf(ra[e], sij, ys[j]);
            ys[4 + j] = fmaf(rb[e], sij, ys[4 + j]);
            sij = fmaf(ww[e], sij, fmaf(ka[e], va[j], kb[e] * vb[j]));
          }
      }
      // reduce-scatter of the eight sums over the row groups: lanes l and
      // l ^ 16 trade the step the other keeps, l and l ^ 8 a column pair,
      // l and l ^ 4 a column; lane l ends with step t + b2, column
      // c0 + 2 b1 + b0
      float h4[4], h2[2];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        h4[q] = (b2 ? ys[4 + q] : ys[q]) +
                __shfl_xor_sync(0xffffffffu, b2 ? ys[q] : ys[4 + q], 16);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        h2[q] = (b1 ? h4[2 + q] : h4[q]) +
                __shfl_xor_sync(0xffffffffu, b1 ? h4[q] : h4[2 + q], 8);
      float sum = (b0 ? h2[1] : h2[0]) +
                  __shfl_xor_sync(0xffffffffu, b0 ? h2[0] : h2[1], 4);
      const int col = c0 + (b1 ? 2 : 0) + (b0 ? 1 : 0);
      const int ts = t + (b2 ? 1 : 0);
      // the bonus term of step ts, and for b, c_b v_a
      sum = fmaf(b2 ? cb[ts] : 0.f, vcol[t * kN + col], sum);
      yc[ts * kN + col] = fmaf(ruk[ts], vcol[ts * kN + col], sum);
    }
    if (t < n) {  // a last step without a pair: plain r, k, exp(logw)
      const float4 v4 = *reinterpret_cast<const float4*>(cols + t * kN);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
      float ys[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int blk = 0; blk < 2; ++blk) {
        const float* at = rows + t * kN + 32 * blk;
        const float4 r4 = *reinterpret_cast<const float4*>(at);
        const float4 k4 = *reinterpret_cast<const float4*>(at + kArray);
        const float4 w4 = *reinterpret_cast<const float4*>(at + 2 * kArray);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float& sij = sm[4 * blk + e][j];
            ys[j] = fmaf(rr[e], sij, ys[j]);  // S before the update
            sij = fmaf(ww[e], sij, kk[e] * vv[j]);
          }
      }
      float h2[2];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        h2[q] = (b2 ? ys[2 + q] : ys[q]) +
                __shfl_xor_sync(0xffffffffu, b2 ? ys[q] : ys[2 + q], 16);
      float sum = (b1 ? h2[1] : h2[0]) +
                  __shfl_xor_sync(0xffffffffu, b1 ? h2[0] : h2[1], 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const int col = c0 + (b2 ? 2 : 0) + (b1 ? 1 : 0);
      if (!b0) yc[t * kN + col] = fmaf(ruk[t], vcol[t * kN + col], sum);
    }
  }
#pragma unroll
  for (int blk = 0; blk < 2; ++blk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float* dst = s_out + state + (32 * blk + 4 * rg + e) * kN + c0;
      const int i = 4 * blk + e;
      *reinterpret_cast<float2*>(dst) = make_float2(sm[i][0], sm[i][1]);
      *reinterpret_cast<float2*>(dst + 2) = make_float2(sm[i][2], sm[i][3]);
    }
}
template <int COPY>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* logw, const float* u, const float* s0,
                   float* y, float* s_out, int BH, int S,
                   cudaStream_t stream) {
  const int smem = kStages * kStageFloats * (int)sizeof(float);
  auto kern = rwkv6_scan_kernel<COPY>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<BH, kThreads, smem, stream>>>(r, k, v, logw, u, s0, y, s_out, S);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one CTA (the wrapper's `smem_bytes`).
extern "C" int rwkv6_scan_smem_bytes() {
  return kStages * kStageFloats * (int)sizeof(float);
}

// r, k, v, logw, y: [BH, S, 64] f32; u: [BH, 64] f32; s0, s_out:
// [BH, 64, 64] f32; every base pointer 8-byte aligned, and r, k, v and logw
// 16-byte aligned when copy_bytes is 16 (else 8).  Returns the launch's
// cudaError_t.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* logw, const void* u,
                                 const void* s0, void* y, void* s_out, int BH,
                                 int S, int copy_bytes, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (copy_bytes == 16)
    return launch<16>(f(r), f(k), f(v), f(logw), f(u), f(s0),
                      static_cast<float*>(y), static_cast<float*>(s_out), BH,
                      S, s);
  if (copy_bytes == 8)
    return launch<8>(f(r), f(k), f(v), f(logw), f(u), f(s0),
                     static_cast<float*>(y), static_cast<float*>(s_out), BH, S,
                     s);
  return cudaErrorInvalidValue;
}
