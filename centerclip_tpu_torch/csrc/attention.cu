// Multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel centerclip_tpu/ops/attention_pallas.py
// (_mha_kernel / _mha_fwd_call, entry fused_mha).  Computes, per sample b
// and head h, straight from the packed [B, L, 3*D] output of the QKV
// projection (row stride 3*D, q | k | v column blocks, head h at columns
// h*hd .. h*hd+hd-1 of each block):
//
//   logits = (q * hd^-0.5) . k^T        fp32 accumulation
//   probs  = softmax(logits + mask)     fp32, mask optional [L, L] additive
//   out    = probs.to(T) . v            fp32 accumulation, stored as T
//
// which is the arithmetic of the plain version in ops/attention_cuda.py
// (q is scaled and rounded to T first, as `q * scale` does on a T tensor).
//
// Bound on this card: at CLIP's short sequences (L = 50 vision, 32 text)
// the work is ~4*L*hd flops per loaded element, far below the ~295
// flop/byte ridge of an H100, so the kernel is bound by moving q, k, v and
// out through device memory.  Design: one CTA per (sample, head) stages its
// q, k^T and v tiles in shared memory once, keeps the fp32 [L, L] scores and
// probabilities in shared memory (never in device memory), and writes the
// [L, hd] output into the [B, L, D] result without any head transpose.  The
// TPU kernel's block-diagonal multi-sample batching was a device of the
// TPU's matrix unit and is not carried over; tensor-core (mma/wgmma) tiles
// are left to a later change.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// shared memory: q [L, hd], k^T [hd, L], v [L, hd] in T, then the fp32
// scores [L, L] at a 16-byte aligned offset
__host__ __device__ inline size_t scores_offset(int L, int hd, size_t elem) {
  return (3 * (size_t)L * hd * elem + 15) / 16 * 16;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                     T* __restrict__ out, int L, int H, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* skt = sq + L * hd;
  T* sv = skt + L * hd;
  float* sp = reinterpret_cast<float*>(smem + scores_offset(L, hd, sizeof(T)));

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int D = H * hd;
  const size_t row = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * L * row + (size_t)h * hd;

  for (int e = threadIdx.x; e < L * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    const T* r = base + i * row + d;
    sq[e] = from_f<T>(to_f<T>(r[0]) * scale);
    skt[d * L + i] = r[D];
    sv[e] = r[2 * D];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < L * L; e += blockDim.x) {
    const int i = e / L, j = e % L;
    const T* qi = sq + i * hd;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d)
      acc = fmaf(to_f<T>(qi[d]), to_f<T>(skt[d * L + j]), acc);
    if (mask != nullptr) acc += mask[e];
    sp[e] = acc;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < L; i += nwarps) {
    float* pr = sp + i * L;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float ex = expf(pr[j] - m);
      pr[j] = ex;
      s += ex;
    }
    s = warp_sum(s);
    // probabilities are rounded to T before P.V, as the plain version does
    for (int j = lane; j < L; j += 32) pr[j] = to_f<T>(from_f<T>(pr[j] / s));
  }
  __syncthreads();

  T* ob = out + (size_t)b * L * D + (size_t)h * hd;
  for (int e = threadIdx.x; e < L * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    const float* pr = sp + i * L;
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc = fmaf(pr[j], to_f<T>(sv[j * hd + d]), acc);
    ob[(size_t)i * D + d] = from_f<T>(acc);
  }
}

template <typename T>
int launch(const void* qkv, const void* mask, void* out, int B, int L, int H,
           int hd, float scale, cudaStream_t stream) {
  const size_t smem = scores_offset(L, hd, sizeof(T)) + (size_t)L * L * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  attention_fwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask),
      static_cast<T*>(out), L, H, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs (the wrapper checks it against the
// card's opt-in limit before launching).
size_t cc_attention_smem_bytes(int L, int hd, int elem_bytes) {
  return scores_offset(L, hd, (size_t)elem_bytes) + (size_t)L * L * sizeof(float);
}

// dtype: 0 float32, 1 bfloat16, 2 float16.  mask may be null.
int cc_attention_fwd(const void* qkv, const void* mask, void* out, int B, int L,
                     int H, int hd, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(qkv, mask, out, B, L, H, hd, scale, s);
    case 1: return launch<__nv_bfloat16>(qkv, mask, out, B, L, H, hd, scale, s);
    case 2: return launch<__half>(qkv, mask, out, B, L, H, hd, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
