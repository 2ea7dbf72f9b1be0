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
// latency-bound, and its design shortens that chain.  One CTA per segment
// holds D in shared memory for the whole run (5 CTAs per SM at N = 98):
//
// * D arrives by one bulk asynchronous copy (cp.async.bulk, completion on
//   an mbarrier) when N * N is a multiple of 4 (then every segment's D is
//   16-byte aligned and a multiple of 16 bytes); other N use 4-byte
//   cp.async.  Warp 0 finds the first medoid (argmax of l2) meanwhile.
// * KKZ runs in warp 0 alone, with no block barrier: each lane keeps its
//   ceil(N / 32) values of mindist in registers, as ints of the same
//   order; each step is a first-index argmax by two warp reductions
//   (redux.sync: the largest value, then the lowest index holding it) and
//   one read of row D[idx].
// * A Lloyd step takes three block barriers.  Each warp assigns a chunk of
//   32 points and turns the chunk into member lists without atomics:
//   __match_any_sync gives each lane the chunk's lanes of its cluster, and
//   the chunk's bit mask of every cluster goes to shared memory.  Each
//   candidate then sums D[n, m] over its own cluster's members only, in
//   ascending m (O(N * cluster size) instead of O(N^2) per step), and each
//   cluster takes the first-index argmin over its members.
//
// The sums run in ascending member order, as before this design, so the
// output is the same to the bit.  The TPU kernel's one-hot matmul
// D @ onehot(assign) (O(N^2 K) flops per step) was a device of the TPU's
// matrix unit.
//
// Two variants of the one algorithm, chosen by the wrapper from N alone:
//
// * shared (N <= 235, where D fits in a CTA's shared memory whatever K):
//   as above, 128 threads.
// * global (N <= 512; ViT-B/16 clusters N = 2 x 196 = 392 tokens with
//   K = 160): D stays in device memory and every read of it goes through
//   L2; the block's shared memory holds only the sums, assignment, medoids
//   and member masks (13 KB at N = 392, K = 160), so 8 CTAs of 256 threads
//   share an SM and all segments of a training step (768) are resident at
//   once.  The steps, their order and every sum are those of the shared
//   variant, so the two give the same bits on the same D.  Chosen over a
//   cluster of CTAs holding D in distributed shared memory: at N = 392 a
//   segment's D is 614 KB, so all the SMs' shared memory holds fewer than
//   50 segments at a time and 768 would run in ~20 waves of the same
//   latency-bound chain, while here every segment's chain runs at once and
//   the cost is the reads of medoid rows from L2 / device memory.
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // shared variant
constexpr int kGlobalThreads = 256;    // global variant
constexpr int kMaxChunks = 8;          // 32-point chunks, shared: N <= 256
constexpr int kGlobalMaxChunks = 16;   // global: N <= 512

// (v, i) beats (bv, bi): strictly better value, or equal value and lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi, bool is_max) {
  if (is_max ? (v > bv) : (v < bv)) return true;
  return v == bv && i < bi;
}

// a float as an int of the same order (-0 taken as +0, which it equals)
__device__ __forceinline__ int ordered(float f) {
  if (f == 0.f) f = 0.f;
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// first-index argmax over the warp of each lane's (v, i); every lane gets it
__device__ __forceinline__ int warp_argmax(float v, int i) {
  const int best = __reduce_max_sync(0xffffffffu, ordered(v));
  return __reduce_min_sync(0xffffffffu, ordered(v) == best ? i : INT_MAX);
}

// first k of the lowest D[meds[k], n] (column n of the medoids' rows)
__device__ __forceinline__ int nearest_medoid(const float* sD, const int* meds,
                                              int N, int K, int n) {
  float best = INFINITY;
  int bk = 0;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float d = sD[(size_t)meds[k] * N + n];
    if (d < best) { best = d; bk = k; }
  }
  return bk;
}

__host__ __device__ inline int n_chunks(int N) { return (N + 31) / 32; }

// dynamic shared memory: D [N, N], sums [N], assign [N], meds [K],
// new_meds [K], member masks [K, chunks], and 16 words that cover the
// kernel's static shared memory (its mbarrier and stop flags), which
// counts against the same per-CTA limit
__host__ __device__ inline size_t smem_bytes(int N, int K) {
  return ((size_t)N * N + 2 * (size_t)N + 2 * (size_t)K
          + (size_t)K * n_chunks(N) + 16) * 4;
}

// the global variant's: the same without D
__host__ __device__ inline size_t global_smem_bytes(int N, int K) {
  return smem_bytes(N, K) - (size_t)N * N * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// C = ceil(N / 32) chunks of 32 points, a compile-time count; kShared: D
// copied into shared memory (else read from device memory)
template <int C, bool kShared>
__global__ void __launch_bounds__(kShared ? kThreads : kGlobalThreads)
kmedoids_kernel(const float* __restrict__ D, const float* __restrict__ l2,
                int* __restrict__ meds_out, int* __restrict__ assign_out,
                int* __restrict__ steps_out, int N, int K, int iter_limit,
                int id_sort) {
  extern __shared__ __align__(128) float smem[];
  float* sD = smem;                                   // [N, N], shared only
  float* s = kShared ? sD + (size_t)N * N : smem;     // [N] candidate sums
  int* assign = reinterpret_cast<int*>(s + N);        // [N]
  int* meds = assign + N;                             // [K]
  int* new_meds = meds + K;                           // [K]
  unsigned* members = reinterpret_cast<unsigned*>(new_meds + K);  // [K, C]
  __shared__ __align__(8) uint64_t loaded;            // mbarrier of the copy
  __shared__ int changed[2];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, n_warps = nt >> 5;
  const int b = blockIdx.x;
  const float* Db = D + (size_t)b * N * N;
  const float* Dm = kShared ? sD : Db;                // where D's rows are read
  const uint32_t bytes = (uint32_t)N * N * 4;
  const bool bulk = bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(Db) & 15) == 0;

  // ---- D into shared memory (shared variant)
  if constexpr (kShared) {
    if (bulk) {
      if (tid == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_addr(&loaded)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      __syncthreads();
      if (tid == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(smem_addr(&loaded)), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            :: "r"(smem_addr(sD)), "l"(Db), "r"(bytes), "r"(smem_addr(&loaded))
            : "memory");
      }
    } else {
      for (int e = tid; e < N * N; e += nt)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(smem_addr(sD + e)), "l"(Db + e) : "memory");
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }

  // ---- KKZ's first medoid while D lands: argmax of the norms (warp 0)
  int idx = 0;
  if (warp == 0) {
    float v = -INFINITY;
    int i = INT_MAX;
    for (int n = lane; n < N; n += 32) {
      const float x = l2[(size_t)b * N + n];
      if (beats(x, n, v, i, true)) { v = x; i = n; }
    }
    idx = warp_argmax(v, i);
  }
  if constexpr (kShared) {
    if (bulk) {
      uint32_t done = 0;
      while (!done)
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(&loaded)) : "memory");
    } else {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
  }

  // ---- KKZ seeding in warp 0: mindist of points lane + 32 j in registers
  if (warp == 0) {
    int md[C];                 // ordered(mindist), INT_MIN past N
    const float* row = Dm + (size_t)idx * N;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int n = lane + 32 * j;
      md[j] = n < N ? ordered(row[n]) : INT_MIN;
    }
    if (lane == 0) meds[0] = idx;
    for (int k = 1; k < K; ++k) {
      int v = md[0];
#pragma unroll
      for (int j = 1; j < C; ++j) v = max(v, md[j]);
      const int best = __reduce_max_sync(0xffffffffu, v);
      int i = INT_MAX;           // the lane's first point holding it
#pragma unroll
      for (int j = C - 1; j >= 0; --j)
        if (md[j] == best) i = lane + 32 * j;
      idx = __reduce_min_sync(0xffffffffu, i);
      if (lane == 0) meds[k] = idx;
      row = Dm + (size_t)idx * N;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int n = lane + 32 * j;
        if (n < N) md[j] = min(md[j], ordered(row[n]));
      }
    }
  }
  __syncthreads();

  // ---- Lloyd iterations to the medoid fixed point, three barriers a step
  int steps = 0;
  while (steps < iter_limit) {
    const int p = steps & 1;
    if (tid == 0) changed[p] = 0;
    // assignment and member masks, one warp per 32-point chunk
    for (int c = warp; c < C; c += n_warps) {
      for (int k = lane; k < K; k += 32) members[k * C + c] = 0u;
      __syncwarp();
      const int n = 32 * c + lane;
      int a = -1;
      if (n < N) {
        a = nearest_medoid(Dm, meds, N, K, n);
        assign[n] = a;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, a);
      if (a >= 0 && lane == __ffs(peers) - 1) members[a * C + c] = peers;
    }
    __syncthreads();
    // each candidate's sum over its own cluster's members, ascending
    for (int n = tid; n < N; n += nt) {
      const unsigned* mine = members + assign[n] * C;
      const float* row = Dm + (size_t)n * N;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
        for (unsigned w = mine[c]; w; w &= w - 1)
          acc += row[32 * c + __ffs(w) - 1];
      s[n] = acc;
    }
    __syncthreads();
    // each cluster's first-index argmin over its members
    for (int k = tid; k < K; k += nt) {
      float best = INFINITY;
      int bn = -1;
#pragma unroll
      for (int c = 0; c < C; ++c)
        for (unsigned w = members[k * C + c]; w; w &= w - 1) {
          const int m = 32 * c + __ffs(w) - 1;
          if (s[m] < best) { best = s[m]; bn = m; }
        }
      const int nm = bn < 0 ? 0 : bn;   // argmin over all-zero scores is 0
      if (nm != meds[k]) changed[p] = 1;
      meds[k] = nm;
    }
    __syncthreads();
    ++steps;
    if (!changed[p]) break;
  }

  // ---- sort the ids (stable rank) and assign from the final medoids
  if (id_sort) {
    for (int k = tid; k < K; k += nt) {
      const int mk = meds[k];
      int rank = 0;
#pragma unroll 8
      for (int j = 0; j < K; ++j)
        rank += (meds[j] < mk) || (meds[j] == mk && j < k);
      new_meds[rank] = mk;
    }
    __syncthreads();
    for (int k = tid; k < K; k += nt) meds[k] = new_meds[k];
    __syncthreads();
  }
  for (int n = tid; n < N; n += nt)
    assign_out[(size_t)b * N + n] = nearest_medoid(Dm, meds, N, K, n);
  for (int k = tid; k < K; k += nt) meds_out[(size_t)b * K + k] = meds[k];
  if (tid == 0) steps_out[b] = steps;
}

using Kernel = void (*)(const float*, const float*, int*, int*, int*, int, int,
                       int, int);

int launch(Kernel kernel, int threads, size_t smem, const void* D, const void* l2,
           void* meds, void* assign, void* steps, int B, int N, int K,
           int iter_limit, int id_sort, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(D), static_cast<const float*>(l2),
      static_cast<int*>(meds), static_cast<int*>(assign),
      static_cast<int*>(steps), N, K, iter_limit, id_sort);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t cc_kmedoids_smem_bytes(int N, int K) { return smem_bytes(N, K); }

size_t cc_kmedoids_global_smem_bytes(int N, int K) { return global_smem_bytes(N, K); }

// Shared variant: 1 <= N <= 256 and smem_bytes(N, K) within the opt-in limit.
int cc_kmedoids(const void* D, const void* l2, void* meds, void* assign,
                void* steps, int B, int N, int K, int iter_limit, int id_sort,
                void* stream) {
  static const Kernel kernels[kMaxChunks] = {
      kmedoids_kernel<1, true>, kmedoids_kernel<2, true>, kmedoids_kernel<3, true>,
      kmedoids_kernel<4, true>, kmedoids_kernel<5, true>, kmedoids_kernel<6, true>,
      kmedoids_kernel<7, true>, kmedoids_kernel<8, true>};
  if (N < 1 || N > 32 * kMaxChunks) return (int)cudaErrorInvalidValue;
  return launch(kernels[n_chunks(N) - 1], kThreads, smem_bytes(N, K), D, l2, meds,
                assign, steps, B, N, K, iter_limit, id_sort, stream);
}

// Global variant: 1 <= N <= 512; D read from device memory.
int cc_kmedoids_global(const void* D, const void* l2, void* meds, void* assign,
                       void* steps, int B, int N, int K, int iter_limit,
                       int id_sort, void* stream) {
  static const Kernel kernels[kGlobalMaxChunks] = {
      kmedoids_kernel<1, false>,  kmedoids_kernel<2, false>,
      kmedoids_kernel<3, false>,  kmedoids_kernel<4, false>,
      kmedoids_kernel<5, false>,  kmedoids_kernel<6, false>,
      kmedoids_kernel<7, false>,  kmedoids_kernel<8, false>,
      kmedoids_kernel<9, false>,  kmedoids_kernel<10, false>,
      kmedoids_kernel<11, false>, kmedoids_kernel<12, false>,
      kmedoids_kernel<13, false>, kmedoids_kernel<14, false>,
      kmedoids_kernel<15, false>, kmedoids_kernel<16, false>};
  if (N < 1 || N > 32 * kGlobalMaxChunks) return (int)cudaErrorInvalidValue;
  return launch(kernels[n_chunks(N) - 1], kGlobalThreads, global_smem_bytes(N, K), D,
                l2, meds, assign, steps, B, N, K, iter_limit, id_sort, stream);
}

const char* cc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
