// QuickGELU (kernel F) for Hopper (sm_90a): y = x * sigmoid(1.702 x) and
// its gradient, one pass over device memory each way.
//
// F replaces no TPU kernel: the JAX package leaves `quick_gelu`
// (centerclip_tpu/models/layers.py:22) to XLA, which fuses it into the
// surrounding elementwise work.  In eager PyTorch the same function is
// three kernels forward (1.702 x, sigmoid, the product: 7 tensor-sizes of
// traffic) and five backward (14 tensor-sizes), and autograd keeps both x
// and sigmoid's output for the backward.  F is bound by bytes: a few
// flops an element against 2 tensor-sizes forward (read x, write y) and 3
// backward (read x and dy, write dx); its wrapper (ops/quick_gelu.py)
// keeps x alone for the backward and recomputes the sigmoid from it.
//
// Bits: every step is the eager op's, rounded to the tensor's dtype where
// the eager op rounds (its output), in fp32 in between:
//
//   forward   a   = rnd(x * 1.702f)
//             s   = rnd(1 / (1 + expf(-a)))         (PyTorch's sigmoid)
//             y   = rnd(x * s)
//   backward  g_s = rnd(dy * x)                     (mul's grad of s)
//             g_a = sigmoid_backward(g_s, s)         (`sigmoid_grad`)
//             g_x = rnd(g_a * 1.702f)
//             dx  = rnd(rnd(dy * s) + g_x)           (mul's grad of x, summed)
//
// PyTorch's `sigmoid_backward` computes `a * (scalar_t(1) - b) * b` on the
// dtype itself, so in bf16 and fp16 each of its three steps rounds (held
// on the card: the opmath order, one rounding, differs in 27-29 % of
// elements).  expf and the reciprocal are the accurate ones (no
// --use_fast_math), as in PyTorch's kernels; `__frcp_rn(d)` and
// `1.0f / d` are both the correctly rounded 1 / d.  Every fp32 product and
// sum goes through __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never
// contracts into an FMA.
//
// Cost: the accurate expf and reciprocal and a conversion for every
// rounding make F issue-bound when each step runs in fp32: the card then
// issues instructions for longer than it moves the bytes (bf16 at
// [302592, 3072]: backward 66 % of its byte bound, forward 81 %).  So on
// the vector path bf16 and fp16 run two elements at a time as bf16x2 /
// half2: a step whose operands are both of the dtype is the dtype's packed
// instruction, and the fp32 steps round a pair by one packed conversion
// (backward 86 %, forward 83 %).  fp32 and the scalar paths take an
// element at a time.
//
// Design: a grid-stride loop over 16-byte vectors (8 bf16 / fp16 or 4
// fp32 a load), kUnroll vectors of each input a thread loaded before any is
// used, so that every thread has kUnroll (forward) or 2 x kUnroll
// (backward) 16-byte loads in flight; the grid is the CTAs resident on the
// card at once (the wrapper sizes it from the SM count and the occupancy
// query) or fewer for a small tensor.  The elements past the last whole
// vector (a ragged count) are taken by the first threads of the grid.  A
// pointer that is not 16-byte aligned (a view into a tensor) takes the
// scalar kernel, the same steps an element at a time.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads a CTA
constexpr int kUnroll = 4;      // 16-byte vectors of an input in flight a thread

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

// v rounded to T and back: the value an eager op's output holds
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// PyTorch's sigmoid of a value a of the tensor's dtype, in fp32: 1 / (1 +
// expf(-a)); the reciprocal correctly rounded, as the division's is
__device__ __forceinline__ float sigmoid_f(float a) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-a)));
}

// ---- an element at a time, in fp32 with a rounding to T after each step
template <typename T>
__device__ __forceinline__ T qgelu_fwd(T xv) {
  const float x = to_f(xv);
  const float s = rnd<T>(sigmoid_f(rnd<T>(__fmul_rn(x, 1.702f))));
  return from_f<T>(__fmul_rn(x, s));
}

template <typename T>
__device__ __forceinline__ T qgelu_bwd(T xv, T dyv) {
  const float x = to_f(xv), dy = to_f(dyv);
  const float s = rnd<T>(sigmoid_f(rnd<T>(__fmul_rn(x, 1.702f))));
  const float g_s = rnd<T>(__fmul_rn(dy, x));
  // sigmoid_backward(g_s, s) = g_s * (1 - s) * s, a step at a time in T
  const float g_a = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(g_s, rnd<T>(__fsub_rn(1.0f, s)))), s));
  const float g_x = rnd<T>(__fmul_rn(g_a, 1.702f));
  return from_f<T>(__fadd_rn(rnd<T>(__fmul_rn(dy, s)), g_x));
}

// ---- two elements at a time in bf16x2 / half2 (the vector path).  A
// step whose operands are both of the dtype runs as the dtype's own packed
// instruction: it rounds the exact result once, which is what fp32 then the
// dtype gives, since fp32 has more than twice the dtype's precision plus
// two bits (8 + 8 + 2 <= 24 for bf16, 11 + 11 + 2 <= 24 for fp16), so the
// double rounding is innocuous.  `_rn` keeps nvcc from contracting a
// product and a sum into one FMA.  The steps with 1.702f and the sigmoid
// stay in fp32, rounded by one packed conversion a pair.
template <typename P> struct Packed;
template <> struct Packed<__nv_bfloat162> {
  static __device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
  static __device__ __forceinline__ __nv_bfloat162 from_f2(float2 v) { return __float22bfloat162_rn(v); }
  static __device__ __forceinline__ __nv_bfloat162 mul(__nv_bfloat162 a, __nv_bfloat162 b) { return __hmul2_rn(a, b); }
  static __device__ __forceinline__ __nv_bfloat162 add(__nv_bfloat162 a, __nv_bfloat162 b) { return __hadd2_rn(a, b); }
  static __device__ __forceinline__ __nv_bfloat162 sub(__nv_bfloat162 a, __nv_bfloat162 b) { return __hsub2_rn(a, b); }
  static __device__ __forceinline__ __nv_bfloat162 one() { return __float2bfloat162_rn(1.0f); }
};
template <> struct Packed<__half2> {
  static __device__ __forceinline__ float2 to_f2(__half2 v) { return __half22float2(v); }
  static __device__ __forceinline__ __half2 from_f2(float2 v) { return __float22half2_rn(v); }
  static __device__ __forceinline__ __half2 mul(__half2 a, __half2 b) { return __hmul2_rn(a, b); }
  static __device__ __forceinline__ __half2 add(__half2 a, __half2 b) { return __hadd2_rn(a, b); }
  static __device__ __forceinline__ __half2 sub(__half2 a, __half2 b) { return __hsub2_rn(a, b); }
  static __device__ __forceinline__ __half2 one() { return __float2half2_rn(1.0f); }
};

// rnd(v * 1.702f) of a pair
template <typename P>
__device__ __forceinline__ P scaled2(P v) {
  const float2 f = Packed<P>::to_f2(v);
  return Packed<P>::from_f2(make_float2(__fmul_rn(f.x, 1.702f), __fmul_rn(f.y, 1.702f)));
}

template <typename P>
__device__ __forceinline__ P sigmoid2(P x) {
  const float2 a = Packed<P>::to_f2(scaled2(x));
  return Packed<P>::from_f2(make_float2(sigmoid_f(a.x), sigmoid_f(a.y)));
}

template <typename P>
__device__ __forceinline__ P qgelu_fwd2(P x) {
  return Packed<P>::mul(x, sigmoid2(x));
}

template <typename P>
__device__ __forceinline__ P qgelu_bwd2(P x, P dy) {
  using K = Packed<P>;
  const P s = sigmoid2(x);
  const P g_a = K::mul(K::mul(K::mul(dy, x), K::sub(K::one(), s)), s);
  return K::add(K::mul(dy, s), scaled2(g_a));
}

// a 16-byte vector of T: fp32 an element at a time, 16-bit types a pair
template <typename T> struct Vec {
  static __device__ __forceinline__ uint4 fwd(uint4 xv) {
    uint4 out;
    const T* xs = reinterpret_cast<const T*>(&xv);
    T* ys = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int e = 0; e < 16 / (int)sizeof(T); ++e) ys[e] = qgelu_fwd<T>(xs[e]);
    return out;
  }
  static __device__ __forceinline__ uint4 bwd(uint4 xv, uint4 dyv) {
    uint4 out;
    const T* xs = reinterpret_cast<const T*>(&xv);
    const T* ds = reinterpret_cast<const T*>(&dyv);
    T* os = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int e = 0; e < 16 / (int)sizeof(T); ++e) os[e] = qgelu_bwd<T>(xs[e], ds[e]);
    return out;
  }
};
template <typename P> struct Vec2 {
  static __device__ __forceinline__ uint4 fwd(uint4 xv) {
    uint4 out;
    const P* xs = reinterpret_cast<const P*>(&xv);
    P* ys = reinterpret_cast<P*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e) ys[e] = qgelu_fwd2<P>(xs[e]);
    return out;
  }
  static __device__ __forceinline__ uint4 bwd(uint4 xv, uint4 dyv) {
    uint4 out;
    const P* xs = reinterpret_cast<const P*>(&xv);
    const P* ds = reinterpret_cast<const P*>(&dyv);
    P* os = reinterpret_cast<P*>(&out);
#pragma unroll
    for (int e = 0; e < 4; ++e) os[e] = qgelu_bwd2<P>(xs[e], ds[e]);
    return out;
  }
};
template <> struct Vec<__nv_bfloat16> : Vec2<__nv_bfloat162> {};
template <> struct Vec<__half> : Vec2<__half2> {};

// y = QuickGELU(x) for n elements; every pointer 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(kThreads)
qgelu_elementwise_fwd(const T* __restrict__ x, T* __restrict__ y, int64_t n) {
  constexpr int E = 16 / sizeof(T);
  const int64_t nvec = n / E;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  int64_t i = first;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(xv + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) yv[i + u * stride] = Vec<T>::fwd(v[u]);
  }
  for (; i < nvec; i += stride) yv[i] = Vec<T>::fwd(__ldg(xv + i));
  const int64_t t = nvec * E + first;
  if (t < n) y[t] = qgelu_fwd<T>(x[t]);
}

// dx = the gradient of QuickGELU at x for the output gradient dy; every
// pointer 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(kThreads)
qgelu_elementwise_bwd(const T* __restrict__ x, const T* __restrict__ dy,
                      T* __restrict__ dx, int64_t n) {
  constexpr int E = 16 / sizeof(T);
  const int64_t nvec = n / E;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* dv = reinterpret_cast<const uint4*>(dy);
  uint4* ov = reinterpret_cast<uint4*>(dx);
  int64_t i = first;
  for (; i + (kUnroll - 1) * stride < nvec; i += kUnroll * stride) {
    uint4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = __ldg(xv + i + u * stride);
      b[u] = __ldg(dv + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) ov[i + u * stride] = Vec<T>::bwd(a[u], b[u]);
  }
  for (; i < nvec; i += stride) ov[i] = Vec<T>::bwd(__ldg(xv + i), __ldg(dv + i));
  const int64_t t = nvec * E + first;
  if (t < n) dx[t] = qgelu_bwd<T>(x[t], dy[t]);
}

// the same steps an element at a time, for any alignment
template <typename T>
__global__ void __launch_bounds__(kThreads)
qgelu_elementwise_fwd_scalar(const T* __restrict__ x, T* __restrict__ y,
                             int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    y[i] = qgelu_fwd<T>(x[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qgelu_elementwise_bwd_scalar(const T* __restrict__ x, const T* __restrict__ dy,
                             T* __restrict__ dx, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    dx[i] = qgelu_bwd<T>(x[i], dy[i]);
}

// a kernel's address, for cudaLaunchKernel and the occupancy query
using Kernel = const void*;

template <typename T>
Kernel pick(bool backward, bool vector) {
  if (backward)
    return vector ? (Kernel)qgelu_elementwise_bwd<T>
                  : (Kernel)qgelu_elementwise_bwd_scalar<T>;
  return vector ? (Kernel)qgelu_elementwise_fwd<T>
                : (Kernel)qgelu_elementwise_fwd_scalar<T>;
}

// the kernel for dtype (0 float32, 1 bfloat16, 2 float16); nullptr if none
Kernel kernel_for(int dtype, bool backward, bool vector) {
  switch (dtype) {
    case 0: return pick<float>(backward, vector);
    case 1: return pick<__nv_bfloat16>(backward, vector);
    case 2: return pick<__half>(backward, vector);
    default: return nullptr;
  }
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// threads a CTA of every kernel in this file
int cc_quick_gelu_threads() { return kThreads; }

// CTAs of the kernel for (dtype, backward, vector) resident on one SM at
// once; 0 if there is no such kernel.
int cc_quick_gelu_ctas_per_sm(int dtype, int backward, int vector) {
  const Kernel k = kernel_for(dtype, backward != 0, vector != 0);
  int n = 0;
  if (k == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kThreads, 0)
          != cudaSuccess)
    return 0;
  return n;
}

// y = QuickGELU(x), x and y n elements of dtype (0 float32, 1 bfloat16,
// 2 float16); ctas CTAs.  vector != 0 takes the 16-byte path and needs
// both pointers 16-byte aligned.
int cc_quick_gelu_fwd(const void* x, void* y, int64_t n, int dtype, int vector,
                      int ctas, void* stream) {
  const Kernel k = kernel_for(dtype, false, vector != 0);
  if (k == nullptr || n < 1 || ctas < 1) return (int)cudaErrorInvalidValue;
  if (vector && !(aligned(x) && aligned(y))) return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &y, &n};
  const cudaError_t e = cudaLaunchKernel(k, dim3(ctas), dim3(kThreads), args, 0,
                                         static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// dx = QuickGELU'(x) * dy, elementwise as above; vector != 0 needs all
// three pointers 16-byte aligned.
int cc_quick_gelu_bwd(const void* x, const void* dy, void* dx, int64_t n,
                      int dtype, int vector, int ctas, void* stream) {
  const Kernel k = kernel_for(dtype, true, vector != 0);
  if (k == nullptr || n < 1 || ctas < 1) return (int)cudaErrorInvalidValue;
  if (vector && !(aligned(x) && aligned(dy) && aligned(dx)))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&x, &dy, &dx, &n};
  const cudaError_t e = cudaLaunchKernel(k, dim3(ctas), dim3(kThreads), args, 0,
                                         static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

const char* cc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
