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
// exp, far below the card's ~295 flops per byte.  Reaching the bound takes
// ~25 KB of reads in flight on every SM at all times (Little's law at
// 3.35 TB/s and ~1 us of loaded latency): far more than a thread's
// registers can hold for loads issued ahead of a dependent chain.
//
// Design: channels in parallel, time streamed through shared memory.
//   * A CTA takes W channels (W = 32 or 64, one thread each) of one row
//     across all of time, so each step's row of a tile is 128 or 256
//     contiguous bytes.  The wrapper picks W = 32 where 64 would leave
//     fewer than two CTAs an SM.
//   * Time goes in stages of kSteps steps through a ring of shared memory
//     (log_a and b, 16 KB a stage at W = 64).  Every thread copies its
//     share of a stage by cp.async (16 bytes a copy, or 4 where F or a base
//     address forbids 16) and arrives on the stage's `full` mbarrier when
//     its copies land; each consumer arrives on its `empty` mbarrier when
//     it has read the stage, and the stage is refilled only after all
//     have.  While one stage is consumed the next ones are in flight.
//   * The consumer keeps h in a register in f32 and computes exp(log_a)
//     for a batch of steps ahead of the dependent FMA chain, the same
//     fmaf(expf(la), h, b) a step as before, so no rounding moves (a pad
//     step, log_a = b = 0, passes h through bit for bit).  h_t is stored
//     from registers, one coalesced row a step, through a pointer that
//     advances by F; where every lane holds a channel the store is not
//     predicated (a branch and a 64-bit index product around each step's
//     store held back the one-warp CTAs of a single row).
//   * No thread leaves early: channels past F take part in every copy
//     round and barrier and store nothing.
// The TPU kernel walks time chunks on a sequential grid axis with h in
// VMEM scratch; here a loop inside the CTA does, and no state crosses
// CTAs.
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kSteps = 32;  // time steps a ring stage holds

// The ring of W channels: stages of log_a and b.  Four CTAs of 64
// channels (three stages) fit an SM, as do six of 32 (four stages).
template <int W>
struct Ring {
  static constexpr int kStages = W == 64 ? 3 : 4;
  static constexpr int kTile = kSteps * W;  // floats of one array a stage
  static constexpr int kFloats = kStages * 2 * kTile;
};

// One stage's steps for one channel: exp(log_a) for 8 steps ahead of the
// FMA chain, each h_t stored at `dst`, `stride` floats apart, where
// `store` (ALL: every lane of the CTA stores, so no predicate).
template <int W, bool ALL>
__device__ __forceinline__ float scan_stage(float hv, const float* la,
                                            const float* bs, float* dst,
                                            size_t stride, int n, bool store) {
  int t = 0;
  for (; t + 8 <= n; t += 8) {
    float a[8], bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j] = expf(la[(t + j) * W]);
      bv[j] = bs[(t + j) * W];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      hv = fmaf(a[j], hv, bv[j]);
      if (ALL || store) *dst = hv;
      dst += stride;
    }
  }
  for (; t < n; ++t) {
    hv = fmaf(expf(la[t * W]), hv, bs[t * W]);
    if (ALL || store) *dst = hv;
    dst += stride;
  }
  return hv;
}

template <int W, int COPY>
__global__ void __launch_bounds__(W)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ b, const float* __restrict__ h0,
                  float* __restrict__ h, float* __restrict__ h_out, int S,
                  int F) {
  using R = Ring<W>;
  static_assert(COPY == 16 || COPY == 4, "copies of 16 or 4 bytes");
  // [stage][log_a, b][kSteps][W]
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[R::kStages], empty[R::kStages];
  const int lane = threadIdx.x;
  const int f0 = blockIdx.x * W, f = f0 + lane;
  const int width = min(W, F - f0);  // channels of this CTA
  const bool live = lane < width;
  const size_t row = blockIdx.y;
  const size_t g_row = row * S * F + f0;  // (row, t = 0, f0)
  if (lane == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      hopper::mbar_init(&full[s], W);
      hopper::mbar_init(&empty[s], W);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int n_chunks = (S + kSteps - 1) / kSteps;
  // chunk c's log_a and b into its stage; every thread arrives on the
  // stage's `full` barrier once its own copies have landed
  auto issue = [&](int c) {
    float* st = smem + (c % R::kStages) * 2 * R::kTile;
    const int n = min(kSteps, S - c * kSteps);
    const size_t g = g_row + (size_t)c * kSteps * F;
    if constexpr (COPY == 16) {
      constexpr int kPerRow = W / 4;  // copies in a step's row
      for (int i = lane; i < n * kPerRow; i += W) {
        const int t = i / kPerRow, q = 4 * (i % kPerRow);
        if (q < width) {
          const size_t at = g + (size_t)t * F + q;
          hopper::cp_async<16>(st + t * W + q, log_a + at);
          hopper::cp_async<16>(st + R::kTile + t * W + q, b + at);
        }
      }
    } else if (live) {
      for (int t = 0; t < n; ++t) {
        const size_t at = g + (size_t)t * F + lane;
        hopper::cp_async<4>(st + t * W + lane, log_a + at);
        hopper::cp_async<4>(st + R::kTile + t * W + lane, b + at);
      }
    }
    hopper::cp_async_mbar_arrive(&full[c % R::kStages]);
  };

  for (int c = 0; c < min(R::kStages, n_chunks); ++c) issue(c);
  float hv = live ? h0[row * F + f] : 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    // refill the stage chunk c - 1 read, once every lane has read it
    if (c > 0 && c - 1 + R::kStages < n_chunks) {
      hopper::mbar_wait(&empty[(c - 1) % R::kStages],
                        ((c - 1) / R::kStages) & 1);
      issue(c - 1 + R::kStages);
    }
    const int s = c % R::kStages;
    hopper::mbar_wait(&full[s], (c / R::kStages) & 1);
    const float* la_s = smem + s * 2 * R::kTile + lane;
    const float* b_s = la_s + R::kTile;
    const int n = min(kSteps, S - c * kSteps);
    const size_t g = g_row + (size_t)c * kSteps * F;
    if (width == W)  // every lane stores: no predicate
      hv = scan_stage<W, true>(hv, la_s, b_s, h + g + lane, F, n, true);
    else
      hv = scan_stage<W, false>(hv, la_s, b_s, h + g + lane, F, n, live);
    hopper::mbar_arrive(&empty[s]);
  }
  if (live) h_out[row * F + f] = hv;
}

template <int W, int COPY>
cudaError_t launch(const float* log_a, const float* b, const float* h0,
                   float* h, float* h_out, int B, int S, int F,
                   cudaStream_t stream) {
  const int smem = Ring<W>::kFloats * (int)sizeof(float);
  auto kern = rglru_scan_kernel<W, COPY>;
  // the ring's shared memory and the carveout that fits the CTAs an SM
  // holds: set once per instance and device (a mixed tick launches the
  // scan once a layer)
  static unsigned long long granted = 0;  // bit d: set on device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!(granted >> dev & 1ull)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    granted |= 1ull << dev;
  }
  const dim3 grid((F + W - 1) / W, B);
  kern<<<grid, W, smem, stream>>>(log_a, b, h0, h, h_out, S, F);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one CTA (the wrapper's `smem_bytes`); -1 for a
// width the library lacks.
extern "C" int rglru_scan_smem_bytes(int channels) {
  const int f = channels == 64   ? Ring<64>::kFloats
                : channels == 32 ? Ring<32>::kFloats
                                 : -1;
  return f < 0 ? -1 : f * (int)sizeof(float);
}

// log_a, b, h: [B, S, F] f32; h0, h_out: [B, F] f32; every base pointer
// 4-byte aligned, log_a and b 16-byte aligned with F % 4 == 0 when
// copy_bytes is 16 (else 4).  channels: 32 or 64.  Returns the launch's
// cudaError_t.
extern "C" int rglru_scan_launch(const void* log_a, const void* b,
                                 const void* h0, void* h, void* h_out, int B,
                                 int S, int F, int channels, int copy_bytes,
                                 void* stream) {
  if (B > 65535) return cudaErrorInvalidValue;
  const auto in = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RGLRU_LAUNCH(W, COPY)                                                \
  if (channels == W && copy_bytes == COPY)                                   \
    return launch<W, COPY>(in(log_a), in(b), in(h0), o(h), o(h_out), B, S, F, \
                           st);
  RGLRU_LAUNCH(64, 16)
  RGLRU_LAUNCH(64, 4)
  RGLRU_LAUNCH(32, 16)
  RGLRU_LAUNCH(32, 4)
#undef RGLRU_LAUNCH
  return cudaErrorInvalidValue;
}
