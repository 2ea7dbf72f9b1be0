// Multi-head self-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel centerclip_tpu/ops/attention_pallas.py
// (_mha_bwd_kernel / _mha_bwd_call, the custom VJP of fused_mha).  Per
// sample b and head h, from the packed [B, L, 3*D] QKV projection (row
// stride 3*D, q | k | v column blocks, head h at columns h*hd .. h*hd+hd-1
// of each block) and the output gradient dO [B, L, D], it recomputes the
// forward's probabilities and writes the gradient of the packed input:
//
//   qs  = (q * hd^-0.5) rounded to T       as the forward
//   P   = softmax(qs . k^T + mask)         fp32, never saved by the forward
//   dV  = P_T^T . dO                       P rounded to T, as in the forward's P.V
//   dP  = dO . V^T                         fp32
//   dS  = P * (dP - rowsum(dP * P))        fp32 (softmax VJP)
//   dQ  = hd^-0.5 * dS . K,  dK = dS^T . qs
//   dqkv[b, :, h-th columns of q | k | v] = dQ | dK | dV, stored as T
//   dmask += dS                            fp32 atomics, only when asked
//
// which is the arithmetic of attention_bwd_plain in ops/attention_cuda.py.
//
// Bound on this card: at CLIP's short sequences (L = 50 vision, 32 text)
// the five [L, L, hd] products are ~10*L*hd flops per loaded element, far
// below the ~295 flop/byte ridge of an H100, so the kernel is bound by
// reading q, k, v, dO and writing dq, dk, dv once.  Design: one CTA per
// (sample, head) stages q (scaled), k (both layouts), v^T and dO in shared
// memory once, keeps the fp32 [L, L] probabilities and dS in shared memory
// (nothing [L, L]-sized is read from or written to device memory except the
// optional mask gradient), and writes dq | dk | dv straight into the packed
// [B, L, 3*D] gradient, so the QKV projection's backward stays one matmul.
// The products run on CUDA cores from shared memory, like the forward;
// tensor-core tiles are left to a later change.  The TPU kernel's
// sequential-grid accumulation of dmask has no counterpart here: CTAs add
// their dS into the fp32 [L, L] buffer with atomicAdd.
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

// shared memory: qs [L, hd], k^T [hd, L], k [L, hd], v^T [hd, L], dO [L, hd]
// in T, then P and dP/dS, each fp32 [L, L], at a 16-byte aligned offset
__host__ __device__ inline size_t probs_offset(int L, int hd, size_t elem) {
  return (5 * (size_t)L * hd * elem + 15) / 16 * 16;
}

__host__ __device__ inline size_t smem_size(int L, int hd, size_t elem) {
  return probs_offset(L, hd, elem) + 2 * (size_t)L * L * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                     const T* __restrict__ dout, T* __restrict__ dqkv,
                     float* __restrict__ dmask, int L, int H, int hd,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = L * hd;
  T* sq = reinterpret_cast<T*>(smem);
  T* skt = sq + n;
  T* sk = skt + n;
  T* svt = sk + n;
  T* sdo = svt + n;
  float* sp = reinterpret_cast<float*>(smem + probs_offset(L, hd, sizeof(T)));
  float* sds = sp + L * L;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int D = H * hd;
  const size_t row = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * L * row + (size_t)h * hd;
  const T* dob = dout + (size_t)b * L * D + (size_t)h * hd;

  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    const T* r = base + i * row + d;
    sq[e] = from_f<T>(to_f<T>(r[0]) * scale);
    const T kk = r[D];
    skt[d * L + i] = kk;
    sk[e] = kk;
    svt[d * L + i] = r[2 * D];
    sdo[e] = dob[(size_t)i * D + d];
  }
  __syncthreads();

  // logits and dP = dO . V^T
  for (int e = threadIdx.x; e < L * L; e += blockDim.x) {
    const int i = e / L, j = e % L;
    const T* qi = sq + i * hd;
    const T* gi = sdo + i * hd;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < hd; ++d) {
      s = fmaf(to_f<T>(qi[d]), to_f<T>(skt[d * L + j]), s);
      dp = fmaf(to_f<T>(gi[d]), to_f<T>(svt[d * L + j]), dp);
    }
    if (mask != nullptr) s += mask[e];
    sp[e] = s;
    sds[e] = dp;
  }
  __syncthreads();

  // softmax (the forward's order of operations) and the softmax VJP, one
  // warp per row; a masked (-inf) entry has P = 0 and so dS = 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int i = warp; i < L; i += nwarps) {
    float* pr = sp + i * L;
    float* gr = sds + i * L;
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
    float dot = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = pr[j] / s;
      pr[j] = p;
      dot = fmaf(gr[j], p, dot);
    }
    dot = warp_sum(dot);
    for (int j = lane; j < L; j += 32) gr[j] = pr[j] * (gr[j] - dot);
  }
  __syncthreads();

  if (dmask != nullptr) {
    for (int e = threadIdx.x; e < L * L; e += blockDim.x)
      atomicAdd(dmask + e, sds[e]);
  }

  // e = (token t, channel d): dV[t] and dK[t] sum over query rows i, dQ[t]
  // over key rows j
  T* gb = dqkv + (size_t)b * L * row + (size_t)h * hd;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int t = e / hd, d = e % hd;
    float dv = 0.f, dk = 0.f, dq = 0.f;
    for (int i = 0; i < L; ++i) {
      const float pb = to_f<T>(from_f<T>(sp[i * L + t]));
      dv = fmaf(pb, to_f<T>(sdo[i * hd + d]), dv);
      dk = fmaf(sds[i * L + t], to_f<T>(sq[i * hd + d]), dk);
      dq = fmaf(sds[t * L + i], to_f<T>(sk[i * hd + d]), dq);
    }
    T* g = gb + t * row + d;
    g[0] = from_f<T>(dq * scale);
    g[D] = from_f<T>(dk);
    g[2 * D] = from_f<T>(dv);
  }
}

template <typename T>
int launch(const void* qkv, const void* mask, const void* dout, void* dqkv,
           void* dmask, int B, int L, int H, int hd, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_size(L, hd, sizeof(T));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  attention_bwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask),
      static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<float*>(dmask), L, H, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs (the wrapper checks it against the
// card's opt-in limit before launching).
size_t cc_attention_bwd_smem_bytes(int L, int hd, int elem_bytes) {
  return smem_size(L, hd, (size_t)elem_bytes);
}

// dtype: 0 float32, 1 bfloat16, 2 float16.  mask and dmask may be null;
// a non-null dmask must hold zeros (or a sum to add to) on entry.
int cc_attention_bwd(const void* qkv, const void* mask, const void* dout,
                     void* dqkv, void* dmask, int B, int L, int H, int hd,
                     int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(qkv, mask, dout, dqkv, dmask, B, L, H, hd, scale, s);
    case 1: return launch<__nv_bfloat16>(qkv, mask, dout, dqkv, dmask, B, L, H, hd, scale, s);
    case 2: return launch<__half>(qkv, mask, dout, dqkv, dmask, B, L, H, hd, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
