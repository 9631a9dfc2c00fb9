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
// at which the tensor cores would become the limit.
//
// Design.  The TPU kernel walks a sequential grid of 512-key blocks per
// (row, KV head) with its online-softmax state in VMEM scratch.  Hopper has
// no sequential grid, and B x Kv CTAs are too few to fill 132 SMs (32 at
// yi-6b's 8 x 4, 8 at recurrentgemma's MQA), so the key axis is cut into
// `n_split` splits of `split_len` keys (the wrapper picks them for about
// two CTAs per SM) and each CTA takes one (key split, KV head, row):
//   * it holds the G = H/Kv query heads of its group, so each K/V tile is
//     read from device memory once for the whole group;
//   * it walks its split in tiles of 32 keys: one lane per key reads the
//     key's position, and a tile no key admits is skipped without loading;
//     admitted keys' K and V rows come in with 16-byte vector loads along
//     D through the caller's B, Kv and S strides (the model passes its
//     [B, S, Kv, D] ring as a [B, Kv, S, D] view, read in place);
//   * scores are f32 dot products scaled by D^-0.5 after the dot; one warp
//     per head keeps the online softmax (max and sum by shuffles), and the
//     f32 probabilities meet V in f32.  Both products read shared memory
//     as float4 (q and p broadcast across a warp; key rows padded by 4
//     floats, so a quarter-warp's eight rows fall on distinct banks), four
//     FMAs for every two loads;
//   * it writes its unnormalised accumulator, running max m and sum l as
//     f32 partials to scratch the wrapper allocates.
// The combine kernel (split_combine.cuh, shared with the paged decode
// kernel), one CTA per (head, row), merges the splits with the logsumexp
// rule and writes exact zeros where no key was admitted.  Any S, no
// padding.  CUDA-core FMAs only (no wgmma/TMA yet).
#include "attn_common.cuh"
#include "split_combine.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // keys per tile: one per lane of a warp

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ k_pos,
                    const int* __restrict__ q_pos, float* __restrict__ o_part,
                    float* __restrict__ ml_part, int H, int Kv, int S,
                    int split_len, long long sb, long long sh, long long ss,
                    int window, float scale) {
  constexpr int LD = D + 4;  // padded key rows: conflict-free float4 reads
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = D / V;
  static_assert(D % V == 0, "head dim must be a multiple of the vector");
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int G = H / Kv;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // [G][D] (every array 16-byte aligned)
  float* k_s = q_s + G * D;        // [kTile][LD]
  float* v_s = k_s + kTile * LD;   // [kTile][D]
  float* acc = v_s + kTile * D;    // [G][D]
  float* p_s = acc + G * D;        // [G][kTile] scores, then probabilities
  float* m_s = p_s + G * kTile;    // [G] running max
  float* l_s = m_s + G;            // [G] running sum
  float* a_s = l_s + G;            // [G] rescale factor of this tile
  int* ok_s = reinterpret_cast<int*>(a_s + G);  // [kTile] key admitted

  const int qp = q_pos[b];
  attn::load_tile<T, D>(q + ((size_t)b * H + (size_t)kv * G) * D, q_s, G, D);
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) acc[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_s[g] = attn::NEG_INIT;
    l_s[g] = 0.f;
  }
  const int lo = split * split_len;
  const int hi = min(S, lo + split_len);
  const T* kb = k + (size_t)b * sb + (size_t)kv * sh;
  const T* vb = v + (size_t)b * sb + (size_t)kv * sh;
  const int* pb = k_pos + (size_t)b * S;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    int ok = 0;
    if (threadIdx.x < kTile) {
      const int t = t0 + threadIdx.x;
      if (t < hi) {
        const int kp = pb[t];
        ok = kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
      }
      ok_s[threadIdx.x] = ok;
    }
    // a barrier too: every thread is past the previous tile's scores
    if (!__syncthreads_or(ok)) continue;

    for (int i = threadIdx.x; i < kTile * VPR; i += blockDim.x) {
      const int t = i / VPR, c = (i % VPR) * V;
      float* kd = k_s + t * LD + c;
      float* vd = v_s + t * D + c;
      if (ok_s[t]) {
        const size_t off = (size_t)(t0 + t) * ss + c;
        const uint4 kr = __ldg(reinterpret_cast<const uint4*>(kb + off));
        const uint4 vr = __ldg(reinterpret_cast<const uint4*>(vb + off));
        const T* ke = reinterpret_cast<const T*>(&kr);
        const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          kd[j] = attn::to_float(ke[j]);
          vd[j] = attn::to_float(ve[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) vd[j] = 0.f;  // p is 0 there: keep p*v 0
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < G * kTile; i += blockDim.x) {
      const int t = i % kTile, g = i / kTile;
      float s = attn::MASKED;
      if (ok_s[t]) {
        const float4* qr = reinterpret_cast<const float4*>(q_s + g * D);
        const float4* kr = reinterpret_cast<const float4*>(k_s + t * LD);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D / 4; ++d) {
          const float4 a = qr[d], c = kr[d];
          dot = fmaf(a.x, c.x, dot);
          dot = fmaf(a.y, c.y, dot);
          dot = fmaf(a.z, c.z, dot);
          dot = fmaf(a.w, c.w, dot);
        }
        s = dot * scale;
      }
      p_s[g * kTile + t] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += n_warps) {
      const float s = p_s[g * kTile + lane];
      float mb = s;
#pragma unroll
      for (int o = 16; o; o >>= 1) mb = fmaxf(mb, __shfl_xor_sync(~0u, mb, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mb);
      const float p = s == attn::MASKED ? 0.f : expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[g] = m_new;
        l_s[g] = alpha * l_s[g] + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x * 4; i < G * D; i += blockDim.x * 4) {
      const int g = i / D, d = i % D;
      const float* pr = p_s + g * kTile;
      const float al = a_s[g];
      float4 a = *reinterpret_cast<const float4*>(acc + i);
      a.x *= al;
      a.y *= al;
      a.z *= al;
      a.w *= al;
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) {
        const float p = pr[t];
        const float4 vv = *reinterpret_cast<const float4*>(v_s + t * D + d);
        a.x = fmaf(p, vv.x, a.x);
        a.y = fmaf(p, vv.y, a.y);
        a.z = fmaf(p, vv.z, a.z);
        a.w = fmaf(p, vv.w, a.w);
      }
      *reinterpret_cast<float4*>(acc + i) = a;
    }
  }
  __syncthreads();

  const size_t part = ((size_t)b * Kv + kv) * n_split + split;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    o_part[part * G * D + i] = acc[i];
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    ml_part[(part * G + g) * 2] = m_s[g];
    ml_part[(part * G + g) * 2 + 1] = l_s[g];
  }
}

// dynamic shared memory of one split CTA (the wrapper checks the same sum)
size_t smem_bytes(int G, int D) {
  return sizeof(float) * (2 * (size_t)G * D + (size_t)kTile * (2 * D + 4) +
                          (size_t)G * kTile + 3 * (size_t)G) +
         sizeof(int) * kTile;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kpos, const void* qpos, float* o_part,
                   float* ml_part, void* out, int B, int H, int Kv, int S,
                   int split_len, int n_split, long long sb, long long sh,
                   long long ss, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Kv, D);
  auto kern = decode_split_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(n_split, Kv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kpos),
      static_cast<const int*>(qpos), o_part, ml_part, H, Kv, S, split_len,
      sb, sh, ss, window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn::decode_combine_kernel<T><<<dim3(H, B), D, 0, stream>>>(
      o_part, ml_part, static_cast<T*>(out), H, Kv, D, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* kpos, const void* qpos, float* o_part,
                     float* ml_part, void* out, int B, int H, int Kv, int S,
                     int split_len, int n_split, long long sb, long long sh,
                     long long ss, int window, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, kpos, qpos, o_part, ml_part, out, B, H, Kv, S, split_len, n_split, sb, sh, ss, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, kpos, qpos, o_part, ml_part, out, B, H, Kv, S, split_len, n_split, sb, sh, ss, window, scale, s);
    case 120: return launch<T, 120>(q, k, v, kpos, qpos, o_part, ml_part, out, B, H, Kv, S, split_len, n_split, sb, sh, ss, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, kpos, qpos, o_part, ml_part, out, B, H, Kv, S, split_len, n_split, sb, sh, ss, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, kpos, qpos, o_part, ml_part, out, B, H, Kv, S, split_len, n_split, sb, sh, ss, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,D] contiguous; k, v [B,Kv,S,D] with D contiguous and element
// strides sb, sh, ss (shared by k and v); k_pos [B,S] int32; q_pos [B]
// int32; o_part [B,Kv,n_split,G,D] and ml_part [B,Kv,n_split,G,2] f32
// scratch; out [B,H,D].  dtype: 0 = float32, 1 = bfloat16 (q, k, v and
// out alike).  Returns the launches' cudaError_t.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_pos,
    const void* q_pos, void* o_part, void* ml_part, void* out, int B, int H,
    int Kv, int S, int D, int split_len, int n_split, long long sb,
    long long sh, long long ss, int window, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* ml = static_cast<float*>(ml_part);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, k_pos, q_pos, op, ml, out, B, H, Kv,
                           S, split_len, n_split, sb, sh, ss, window, scale,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, k_pos, q_pos, op, ml, out, B,
                                   H, Kv, S, split_len, n_split, sb, sh, ss,
                                   window, scale, s);
  return cudaErrorInvalidValue;
}
