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
// byte time is ~1.26x the flop time.
//
// Design: one warp per bh row, one row per CTA.  Lane l owns columns
// 2l and 2l+1 of S: 128 f32 in registers for the whole sequence, so S
// never touches memory between s0 and s_out.  Time advances in chunks of
// kChunk steps staged in shared memory with coalesced 8-byte loads; the
// decay exp(logw) is taken once per element while staging, and the bonus
// dot product sum_i r_i u_i k_i once per step (a warp shuffle reduction),
// so the per-step loop is, per element of S, one FMA into y, one multiply
// k_i v_j and one FMA into S, with r, k and w read as 16-byte shared
// broadcasts.  The TPU kernel instead takes a chunked matrix form (decay
// kernel D[t, s, i] over 32-step chunks, S in VMEM scratch) shaped for the
// MXU; here the plain step recurrence on CUDA cores keeps S in registers
// and does 5 N^2 flops per step instead of the chunked form's more.
#include <cuda_runtime.h>

namespace {

constexpr int kN = 64;       // head dim; lane l owns columns 2l, 2l+1
constexpr int kLanes = 32;   // one warp per bh row
constexpr int kChunk = 32;   // time steps staged in shared memory at once

__global__ void __launch_bounds__(kLanes)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_out, int S) {
  __shared__ __align__(16) float sr[kChunk][kN];
  __shared__ __align__(16) float sk[kChunk][kN];
  __shared__ __align__(16) float sw[kChunk][kN];   // exp(logw)
  __shared__ __align__(16) float sv[kChunk][kN];
  __shared__ float sruk[kChunk];                   // sum_i r_i u_i k_i

  const int lane = threadIdx.x;
  const int c = 2 * lane;                          // first owned column
  const size_t row = blockIdx.x;
  const size_t state = row * kN * kN;

  // S[i, c] and S[i, c + 1]: each row i of s0 is 64 consecutive floats,
  // read by the warp as one coalesced 256-byte segment
  float sa[kN], sb[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float2 s = *reinterpret_cast<const float2*>(s0 + state + i * kN + c);
    sa[i] = s.x;
    sb[i] = s.y;
  }
  const float2 uu = *reinterpret_cast<const float2*>(u + row * kN + c);

  const size_t base = row * (size_t)S * kN;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();               // the previous chunk is fully consumed
#pragma unroll 8
    for (int t = 0; t < n; ++t) {
      const size_t g = base + (size_t)(t0 + t) * kN + c;
      *reinterpret_cast<float2*>(&sr[t][c]) =
          __ldg(reinterpret_cast<const float2*>(r + g));
      *reinterpret_cast<float2*>(&sk[t][c]) =
          __ldg(reinterpret_cast<const float2*>(k + g));
      *reinterpret_cast<float2*>(&sv[t][c]) =
          __ldg(reinterpret_cast<const float2*>(v + g));
      const float2 lw = __ldg(reinterpret_cast<const float2*>(logw + g));
      *reinterpret_cast<float2*>(&sw[t][c]) = make_float2(expf(lw.x),
                                                          expf(lw.y));
    }
    __syncthreads();
    // the bonus term's dot product, one warp reduction per step
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      float p = sr[t][c] * uu.x * sk[t][c] + sr[t][c + 1] * uu.y * sk[t][c + 1];
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) sruk[t] = p;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float2 vv = *reinterpret_cast<const float2*>(&sv[t][c]);
      float ya[4] = {0.f, 0.f, 0.f, 0.f}, yb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kN; i += 4) {
        const float4 rr = *reinterpret_cast<const float4*>(&sr[t][i]);
        const float4 kk = *reinterpret_cast<const float4*>(&sk[t][i]);
        const float4 ww = *reinterpret_cast<const float4*>(&sw[t][i]);
        // y reads S before this step's update
        ya[0] = fmaf(rr.x, sa[i], ya[0]);
        ya[1] = fmaf(rr.y, sa[i + 1], ya[1]);
        ya[2] = fmaf(rr.z, sa[i + 2], ya[2]);
        ya[3] = fmaf(rr.w, sa[i + 3], ya[3]);
        yb[0] = fmaf(rr.x, sb[i], yb[0]);
        yb[1] = fmaf(rr.y, sb[i + 1], yb[1]);
        yb[2] = fmaf(rr.z, sb[i + 2], yb[2]);
        yb[3] = fmaf(rr.w, sb[i + 3], yb[3]);
        sa[i] = fmaf(ww.x, sa[i], kk.x * vv.x);
        sa[i + 1] = fmaf(ww.y, sa[i + 1], kk.y * vv.x);
        sa[i + 2] = fmaf(ww.z, sa[i + 2], kk.z * vv.x);
        sa[i + 3] = fmaf(ww.w, sa[i + 3], kk.w * vv.x);
        sb[i] = fmaf(ww.x, sb[i], kk.x * vv.y);
        sb[i + 1] = fmaf(ww.y, sb[i + 1], kk.y * vv.y);
        sb[i + 2] = fmaf(ww.z, sb[i + 2], kk.z * vv.y);
        sb[i + 3] = fmaf(ww.w, sb[i + 3], kk.w * vv.y);
      }
      const float ruk = sruk[t];
      const float2 out =
          make_float2((ya[0] + ya[1]) + (ya[2] + ya[3]) + ruk * vv.x,
                      (yb[0] + yb[1]) + (yb[2] + yb[3]) + ruk * vv.y);
      *reinterpret_cast<float2*>(y + base + (size_t)(t0 + t) * kN + c) = out;
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i)
    *reinterpret_cast<float2*>(s_out + state + i * kN + c) =
        make_float2(sa[i], sb[i]);
}

}  // namespace

// r, k, v, logw, y: [BH, S, 64] f32; u: [BH, 64] f32; s0, s_out:
// [BH, 64, 64] f32; every base pointer 8-byte aligned.  Returns the
// launch's cudaError_t.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* logw, const void* u,
                                 const void* s0, void* y, void* s_out, int BH,
                                 int S, void* stream) {
  rwkv6_scan_kernel<<<BH, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), S);
  return cudaGetLastError();
}
