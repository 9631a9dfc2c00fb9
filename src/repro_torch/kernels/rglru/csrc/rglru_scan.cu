// RG-LRU scan for Hopper (sm_90a): the diagonal linear recurrence
//
//     h_t = exp(log_a_t) * h_{t-1} + b_t     over log_a, b: [B, S, F] f32
//
// seeded from h0 [B, F] and returning every h_t [B, S, F] beside the state
// after the last step, h_out [B, F].  Any S: nothing is padded.
//
// Replaces: src/repro/kernels/rglru/rglru.py, rglru_scan_state (Pallas TPU
// kernel `_kernel`; `rglru_scan` is its zero-state wrapper).
//
// Bound on this card: bytes.  Each element of log_a and b is read once and
// each h_t written once (12 bytes per (b, t, f)) for two flops and one
// exp, far below the card's ~295 flops per byte.
//
// Design: one thread per (b, f), looping over t with h carried in a
// register in f32; h_out is written once at the end.  Neighbouring threads
// take neighbouring f, so every load and store of a time step is coalesced
// across the warp.  The loads of a step do not depend on h, so the unrolled
// loop issues several steps' loads ahead of the dependent FMA chain.  The
// TPU kernel instead walks time chunks on a sequential grid axis with h in
// VMEM scratch; here no state crosses blocks.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ b, const float* __restrict__ h0,
                  float* __restrict__ h, float* __restrict__ h_out, int S,
                  int F) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (f >= F) return;
  const size_t state = (size_t)row * F + f;
  const size_t base = (size_t)row * S * F + f;
  float hv = h0[state];
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const size_t i = base + (size_t)t * F;
    hv = expf(__ldg(log_a + i)) * hv + __ldg(b + i);
    h[i] = hv;
  }
  h_out[state] = hv;
}

}  // namespace

// log_a, b, h: [B, S, F] f32; h0, h_out: [B, F] f32.  Returns the launch's
// cudaError_t.
extern "C" int rglru_scan_launch(const void* log_a, const void* b,
                                 const void* h0, void* h, void* h_out, int B,
                                 int S, int F, void* stream) {
  if (B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((F + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_out), S, F);
  return cudaGetLastError();
}
