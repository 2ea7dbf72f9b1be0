// LayerNorm forward (kernel C) for Hopper (sm_90a).
//
// Replaces the TPU kernel centerclip_tpu/ops/layernorm_pallas.py
// (_ln_fwd_kernel / _ln_fwd_call, entry fused_layernorm): LayerNorm over the
// last axis of a row-major x [R, D] (fp32, bf16 or fp16) with fp32 gamma and
// beta, fp32 statistics, eps, output y in x's dtype:
//
//   mean = sum(x) / D;  var = sum((x - mean)^2) / D;
//   y    = (x - mean) * rsqrt(var + eps) * gamma + beta
//
// Bound on this card: a few flops an element, so reading x and writing y
// once (2 R D bytes in bf16) over the memory rate -- at the towers' large
// row counts.  Most calls are small, though (a text batch, a pipeline
// microbatch, a search's queries: 128-4800 rows, a few microseconds), and
// there launch latency and the host's launch path decide.  Design:
//
// * A warp normalises a row: no shared memory and no block barrier.  Mean
//   and centred variance are warp sums by xor shuffles from registers (every
//   lane ends with the same bits), the two passes of the plain version.
// * Vector path (a row a whole number V <= kMaxVecs of 512-byte warp-wide
//   pieces, every pointer 16-byte aligned): lane l holds the row's 16-byte
//   vectors l, l + 32, ..., V of them (3 for bf16 D = 768, 2 for 512; 6 / 4
//   for fp32), so every load and store is 16 bytes a lane, neighbouring
//   lanes on neighbouring addresses, and no lane is masked.  gamma and
//   beta for those columns are loaded once per warp and held in registers
//   across every row the warp takes.  The next row's vectors are loaded
//   while this row is reduced (two rows in flight a warp).
// * Scalar path, same arithmetic: any other D or alignment; lane l takes
//   columns l, l + 32, ... and reads the row three times (the later reads
//   hit L1).
// * Grid: warp w of W = ctas x kWarps takes rows w, w + W, ...; the wrapper
//   (ops/layernorm_triton.fwd_launch_plan) sizes ctas from R and the SM
//   count: one row a warp while R is small, so a small call spreads over
//   the card, and at most as many CTAs as are resident at once, each warp
//   streaming its rows, when R is large.
// * Plain C interface, launched from Python through ctypes: a call costs
//   the host one foreign call, not a Python launcher.
//
// Sums: on the vector path each 16-byte vector's elements in order, then a
// lane's vectors in order (independent chains), on the scalar path a
// lane's columns in order; then the warp's xor tree (offsets 16, 8, 4, 2,
// 1).  The squares and the output use fmaf.
// tests/test_torch_ln_kmedoids_design.py emulates this order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;      // warps (rows in flight) per CTA
constexpr int kMaxVecs = 8;    // 16-byte vectors a lane on the vector path

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// element e of a 16-byte vector of T
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int e) {
  return to_f(reinterpret_cast<const T*>(&v)[e]);
}

template <typename T, int V>
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_vector_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y, int R,
                     int D, float eps) {
  constexpr int E = 16 / sizeof(T);           // elements in a vector
  const int lane = threadIdx.x & 31;
  const int W = gridDim.x * kWarps;
  int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  uint4 next[V];
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)r * D);
#pragma unroll
  for (int v = 0; v < V; ++v) next[v] = __ldg(src + lane + 32 * v);
  float g[V][E], b[V][E];
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 gv = __ldg(reinterpret_cast<const float4*>(gamma) + ((lane + 32 * v) * E + e) / 4);
      const float4 bv = __ldg(reinterpret_cast<const float4*>(beta) + ((lane + 32 * v) * E + e) / 4);
      g[v][e] = gv.x; g[v][e + 1] = gv.y; g[v][e + 2] = gv.z; g[v][e + 3] = gv.w;
      b[v][e] = bv.x; b[v][e + 1] = bv.y; b[v][e + 2] = bv.z; b[v][e + 3] = bv.w;
    }
  for (; r < R; r += W) {
    uint4 cur[V];
#pragma unroll
    for (int v = 0; v < V; ++v) cur[v] = next[v];
    if (r + W < R) {
      src = reinterpret_cast<const uint4*>(x + (size_t)(r + W) * D);
#pragma unroll
      for (int v = 0; v < V; ++v) next[v] = __ldg(src + lane + 32 * v);
    }
    // each vector's elements in order, then the vectors in order: V
    // independent chains
    float t[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      t[v] = elem<T>(cur[v], 0);
#pragma unroll
      for (int e = 1; e < E; ++e) t[v] += elem<T>(cur[v], e);
    }
    float s = t[0];
#pragma unroll
    for (int v = 1; v < V; ++v) s += t[v];
    const float mean = warp_sum(s) / (float)D;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      t[v] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = elem<T>(cur[v], e) - mean;
        t[v] = fmaf(d, d, t[v]);
      }
    }
    float q = t[0];
#pragma unroll
    for (int v = 1; v < V; ++v) q += t[v];
    const float rstd = rsqrtf(warp_sum(q) / (float)D + eps);
    uint4* dst = reinterpret_cast<uint4*>(y + (size_t)r * D);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int e = 0; e < E; ++e)
        o[e] = from_f<T>(fmaf((elem<T>(cur[v], e) - mean) * rstd, g[v][e],
                              b[v][e]));
      dst[lane + 32 * v] = out;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_scalar_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y, int R,
                     int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int W = gridDim.x * kWarps;
  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < R; r += W) {
    const T* xr = x + (size_t)r * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += to_f(xr[c]);
    const float mean = warp_sum(s) / (float)D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = to_f(xr[c]) - mean;
      q = fmaf(d, d, q);
    }
    const float rstd = rsqrtf(warp_sum(q) / (float)D + eps);
    T* yr = y + (size_t)r * D;
    for (int c = lane; c < D; c += 32)
      yr[c] = from_f<T>(fmaf((to_f(xr[c]) - mean) * rstd, gamma[c], beta[c]));
  }
}

// a kernel's address, for cudaLaunchKernel and the occupancy query
using Kernel = const void*;

// the kernel for dtype (0 float32, 1 bfloat16, 2 float16) and V 16-byte
// vectors a lane (0: the scalar path); nullptr if there is none
template <typename T>
Kernel pick(int vecs) {
  static const Kernel vector[kMaxVecs] = {
      (Kernel)ln_fwd_vector_kernel<T, 1>, (Kernel)ln_fwd_vector_kernel<T, 2>,
      (Kernel)ln_fwd_vector_kernel<T, 3>, (Kernel)ln_fwd_vector_kernel<T, 4>,
      (Kernel)ln_fwd_vector_kernel<T, 5>, (Kernel)ln_fwd_vector_kernel<T, 6>,
      (Kernel)ln_fwd_vector_kernel<T, 7>, (Kernel)ln_fwd_vector_kernel<T, 8>};
  if (vecs == 0) return (Kernel)ln_fwd_scalar_kernel<T>;
  return vecs >= 1 && vecs <= kMaxVecs ? vector[vecs - 1] : nullptr;
}

Kernel kernel_for(int dtype, int vecs) {
  switch (dtype) {
    case 0: return pick<float>(vecs);
    case 1: return pick<__nv_bfloat16>(vecs);
    case 2: return pick<__half>(vecs);
    default: return nullptr;
  }
}

int elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

extern "C" {

// CTAs of the kernel for (dtype, vecs) resident on one SM at once; 0 if
// there is no such kernel.
int cc_layernorm_fwd_ctas_per_sm(int dtype, int vecs) {
  const Kernel k = kernel_for(dtype, vecs);
  int n = 0;
  if (k == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kWarps * 32, 0)
          != cudaSuccess)
    return 0;
  return n;
}

// y = LayerNorm(x) for x, y [R, D] of dtype (0 float32, 1 bfloat16,
// 2 float16), gamma, beta fp32 [D]; ctas CTAs of kWarps warps.  vecs > 0
// takes the vector path: a row exactly vecs x 512 bytes and every pointer
// 16-byte aligned; vecs 0 the scalar path.
int cc_layernorm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                     int R, int D, int dtype, int vecs, int ctas, float eps,
                     void* stream) {
  const Kernel k = kernel_for(dtype, vecs);
  if (k == nullptr || R < 1 || D < 1 || ctas < 1) return (int)cudaErrorInvalidValue;
  if (vecs > 0) {
    const uintptr_t any = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)
        | reinterpret_cast<uintptr_t>(gamma) | reinterpret_cast<uintptr_t>(beta);
    if ((size_t)D * elem_bytes(dtype) != (size_t)vecs * 512 || (any & 15))
      return (int)cudaErrorInvalidValue;
  }
  // every kernel takes (const T* x, const float* gamma, const float* beta,
  // T* y, int R, int D, float eps)
  void* args[] = {&x, &gamma, &beta, &y, &R, &D, &eps};
  const cudaError_t e = cudaLaunchKernel(k, dim3(ctas), dim3(kWarps * 32), args, 0,
                                         static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

const char* cc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
