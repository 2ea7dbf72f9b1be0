// Batched k-medoids (KKZ seeding + Lloyd iterations) for Hopper (sm_90a).
//
// Replaces the TPU kernel centerclip_tpu/ops/kmedoids_pallas.py
// (_kmedoids_kernel / kmedoids_from_distances, entry
// batch_fast_kmedoids_pallas).  Input: per segment b the [N, N] fp32
// distance matrix D (all-negative shift and self-nearest diagonal already
// applied, see ops/distances.py) and the points' L2 norms l2 [N].  Output:
// medoid ids meds [K] and the assignment assign [N] (int32), plus the
// number of Lloyd steps the segment ran.
//
//   KKZ:    meds[0] = argmax_n l2[n]; then meds[i] = argmax_n mindist[n],
//           mindist[n] = min over chosen m of D[m, n]
//   Lloyd:  assign[n] = argmin_k D[meds[k], n]
//           meds[k]   = argmin over members n of cluster k of
//                       sum over members m of D[n, m]   (empty cluster: 0)
//           until the medoid set stops changing or iter_limit steps
//   then    sort the ids (id_sort) and assign once more.
//
// Every argmin/argmax keeps the first index on ties, as torch/jnp do.
//
// Bound on this card: D is 38 KB per segment at the flagship N = 98, read
// from device memory once (7.4 MB for 192 segments, ~2 us at 3.35 TB/s),
// while the iterations are a chain of small dependent steps: the kernel is
// latency-bound.  Design: one CTA per segment holds D in shared memory for
// the whole run, so the iterations never touch device memory.  The TPU
// kernel's one-hot matmul D @ onehot(assign) (O(N^2 K) flops per step) was
// a device of the TPU's matrix unit; here the update needs only each
// candidate's sum over its own cluster's members, O(N^2) adds per step.
// N is limited by shared memory (N <= ~235); the wrapper raises above it.
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// (v, i) beats (bv, bi): strictly better value, or equal value and lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi, bool is_max) {
  if (is_max ? (v > bv) : (v < bv)) return true;
  return v == bv && i < bi;
}

// block-wide first-index argmax/argmin; every thread gets the result
__device__ void block_arg_best(float& v, int& i, bool is_max, float* red_v, int* red_i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i, is_max)) { v = ov; i = oi; }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? red_v[lane] : (is_max ? -INFINITY : INFINITY);
    i = lane < nw ? red_i[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (beats(ov, oi, v, i, is_max)) { v = ov; i = oi; }
    }
    if (lane == 0) { red_v[0] = v; red_i[0] = i; }
  }
  __syncthreads();
  v = red_v[0];
  i = red_i[0];
  __syncthreads();   // red_* may be reused by the next call
}

__host__ __device__ inline size_t smem_bytes(int N, int K) {
  return ((size_t)N * N + 2 * (size_t)N + 2 * (size_t)K + 64) * 4;
}

__global__ void __launch_bounds__(kThreads)
kmedoids_kernel(const float* __restrict__ D, const float* __restrict__ l2,
                int* __restrict__ meds_out, int* __restrict__ assign_out,
                int* __restrict__ steps_out, int N, int K, int iter_limit,
                int id_sort) {
  extern __shared__ __align__(16) float smem[];
  float* sD = smem;                                   // [N, N]
  float* s = sD + (size_t)N * N;                      // [N] mindist, then sums
  int* assign = reinterpret_cast<int*>(s + N);        // [N]
  int* meds = assign + N;                             // [K]
  int* new_meds = meds + K;                           // [K]
  float* red_v = reinterpret_cast<float*>(new_meds + K);  // [32]
  int* red_i = reinterpret_cast<int*>(red_v + 32);        // [32]
  __shared__ int changed;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x;
  const float* Db = D + (size_t)b * N * N;
  for (int e = tid; e < N * N; e += nt) sD[e] = Db[e];
  __syncthreads();

  // ---- KKZ seeding
  float v = -INFINITY;
  int idx = INT_MAX;
  for (int n = tid; n < N; n += nt) {
    const float x = l2[(size_t)b * N + n];
    if (beats(x, n, v, idx, true)) { v = x; idx = n; }
  }
  block_arg_best(v, idx, true, red_v, red_i);
  if (tid == 0) meds[0] = idx;
  for (int n = tid; n < N; n += nt) s[n] = sD[(size_t)idx * N + n];
  __syncthreads();
  for (int k = 1; k < K; ++k) {
    v = -INFINITY;
    idx = INT_MAX;
    for (int n = tid; n < N; n += nt)
      if (beats(s[n], n, v, idx, true)) { v = s[n]; idx = n; }
    block_arg_best(v, idx, true, red_v, red_i);
    if (tid == 0) meds[k] = idx;
    for (int n = tid; n < N; n += nt) s[n] = fminf(s[n], sD[(size_t)idx * N + n]);
    __syncthreads();
  }

  // ---- Lloyd iterations to the medoid fixed point
  int steps = 0;
  while (steps < iter_limit) {
    if (tid == 0) changed = 0;
    for (int n = tid; n < N; n += nt) {
      float best = INFINITY;
      int bk = 0;
      for (int k = 0; k < K; ++k) {
        const float d = sD[(size_t)meds[k] * N + n];
        if (d < best) { best = d; bk = k; }
      }
      assign[n] = bk;
    }
    __syncthreads();
    for (int n = tid; n < N; n += nt) {
      const int a = assign[n];
      const float* row = sD + (size_t)n * N;
      float acc = 0.f;
      for (int m = 0; m < N; ++m)
        if (assign[m] == a) acc += row[m];
      s[n] = acc;
    }
    __syncthreads();
    for (int k = tid; k < K; k += nt) {
      float best = INFINITY;
      int bn = -1;
      for (int n = 0; n < N; ++n)
        if (assign[n] == k && s[n] < best) { best = s[n]; bn = n; }
      const int nm = bn < 0 ? 0 : bn;   // argmin over all-zero scores is 0
      if (nm != meds[k]) changed = 1;
      new_meds[k] = nm;
    }
    __syncthreads();
    for (int k = tid; k < K; k += nt) meds[k] = new_meds[k];
    ++steps;
    const int c = changed;
    __syncthreads();
    if (!c) break;
  }

  // ---- sort the ids (stable rank) and assign from the final medoids
  if (id_sort) {
    for (int k = tid; k < K; k += nt) {
      const int mk = meds[k];
      int rank = 0;
      for (int j = 0; j < K; ++j)
        rank += (meds[j] < mk) || (meds[j] == mk && j < k);
      new_meds[rank] = mk;
    }
    __syncthreads();
    for (int k = tid; k < K; k += nt) meds[k] = new_meds[k];
    __syncthreads();
  }
  for (int n = tid; n < N; n += nt) {
    float best = INFINITY;
    int bk = 0;
    for (int k = 0; k < K; ++k) {
      const float d = sD[(size_t)meds[k] * N + n];
      if (d < best) { best = d; bk = k; }
    }
    assign_out[(size_t)b * N + n] = bk;
  }
  for (int k = tid; k < K; k += nt) meds_out[(size_t)b * K + k] = meds[k];
  if (tid == 0) steps_out[b] = steps;
}

}  // namespace

extern "C" {

size_t cc_kmedoids_smem_bytes(int N, int K) { return smem_bytes(N, K); }

int cc_kmedoids(const void* D, const void* l2, void* meds, void* assign,
                void* steps, int B, int N, int K, int iter_limit, int id_sort,
                void* stream) {
  const size_t smem = smem_bytes(N, K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kmedoids_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kmedoids_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(D), static_cast<const float*>(l2),
      static_cast<int*>(meds), static_cast<int*>(assign),
      static_cast<int*>(steps), N, K, iter_limit, id_sort);
  return (int)cudaGetLastError();
}

const char* cc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
