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
// Four variants of the one algorithm, chosen by the wrapper from N (and,
// past N = 512, K), which give the same bits on the same D:
//
// * shared (N <= 235, where D fits in a CTA's shared memory whatever K):
//   kmedoids_kernel, as above, 128 threads.
// * global (N <= 512; ViT-B/16 clusters N = 2 x 196 = 392 tokens with
//   K = 160): kmedoids_global_kernel.  D stays in device memory (614 KB a
//   segment at N = 392, 472 MB for a training step's 768 segments, well
//   past the 50 MB L2), so every read of it costs a round trip to device
//   memory, and a segment's time is the length of its chain of such reads.
//   An earlier design ran the shared variant's steps on D in device
//   memory: KKZ in warp 0 (K dependent row reads, ~2 us each on an H100),
//   and every Lloyd step's assignment read all K medoid rows for every
//   point (251 KB a segment a step at K = 160, in dependent batches of 8
//   loads a thread).  On ViT-B/16's tokens (H100), KKZ was half of its
//   time at an encode's 192 segments and Lloyd the rest.  This design
//   shortens both chains and reads only what changed:
//   - KKZ runs over all 8 warps, each thread keeping mindist of 2 points,
//     with one block barrier a step for the first-index argmax.  While
//     the block agrees on the pick, each warp prefetches the row of its
//     own argmax into L2: the next pick is often one of them, so its row
//     read hits L2 instead of device memory.  KKZ also keeps each point's
//     nearest chosen medoid (first index on ties) and whether another one
//     ties it: that is the first Lloyd step's assignment, from the rows
//     KKZ reads anyway.
//   - Each point keeps (nearest value, k, tie flag).  After an update, a
//     point whose own medoid stayed compares only the medoids that moved,
//     (value, k) in lexicographic order, which is exactly the first-index
//     argmin over all K.  A point whose own medoid moved is scanned over
//     all K by its whole warp at once (K / 32 loads a lane, then warp
//     reductions), one such point after another.
//   - Sums and argmins run only for clusters whose member set changed (an
//     unchanged member set gives the same sums, so the same medoid); a
//     candidate's sum loads its members 4 at a time and adds them in
//     ascending order.
//   - The last assignment after the id sort is each point's k mapped to
//     its rank when no other medoid ties it, and a warp scan of the sorted
//     medoids only where one may.
//   8 warps a CTA and at most 40 registers a thread, so that 6 CTAs share
//   an SM and all 768 segments of a training step are resident at once
//   (15 KB of shared memory each at N = 392, K = 160).  A cluster of 4
//   CTAs holding a segment's D in distributed shared memory was not built:
//   all SMs together would hold ~33 segments at a time, so a training
//   step's 768 would run in ~24 waves of the same dependent chain, and an
//   encode's 192 in ~6.
// * large (512 < N <= 3136; ViT-B/16 with segments of 3 or 4 frames
//   clusters N = 588 or 784 tokens, a whole 12-frame clip is N = 2352):
//   the global variant's kernel with its chunk count read from N at run
//   time (kmedoids_global_kernel<0>), at most 64 registers a thread (4 CTAs
//   an SM: a training step's 512 segments of 588 points are resident).
//   KKZ keeps each point's mindist, nearest chosen medoid and tie flag in
//   the shared-memory arrays the Lloyd steps keep them in anyway, instead
//   of in registers (the global variant holds 2 points a thread there,
//   which is its N = 512 cap); each thread updates its own points after a
//   pick, kScanBatch row loads in flight.  Everything else is the global
//   variant's, step for step, so the bits are the same.  Shared memory
//   grows with N and K (150 KB at N = 2352, K = 392, 194 KB at N = 3136,
//   K = 392, the member masks the most of it): 3136 = 16 frames of 196
//   tokens is the largest N at which every K <= 392 fits.
// * scratch (past the large variant: N > 3136, e.g. a ViT-B/16 segment of
//   20 frames, N = 3920, or a K whose member masks pass a CTA's shared
//   memory, e.g. K = N = 2352): the large variant's kernel body
//   (kmedoids_scratch_kernel runs global_body<-1>) with the member masks,
//   K x ceil(N / 32) words (192 KB at N = 3920, K = 392; 691 KB at
//   N = K = 2352), in a device-memory scratch of each segment that the
//   wrapper allocates, and the per-point and per-cluster state (13 N +
//   10 K bytes: 52 KB at N = 3920, K = 160) in shared memory where it fits
//   (N + K up to ~17 000), else in the scratch too.  At N = 3920, K = 160
//   the large layout would fit (131 KB) but hold one CTA an SM; this one
//   holds 4.  The moved-medoid list keeps k alone (the new medoid is
//   meds[k]) instead of packing both into 32 bits, so N is not held to 15
//   bits.  The same steps in the same order: the same bits as the large
//   variant where both run.
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // shared variant
constexpr int kGlobalThreads = 256;    // global variant
constexpr int kGlobalWarps = kGlobalThreads / 32;
constexpr int kGlobalCtasPerSm = 6;    // global: a training step's 768 resident
// large: a training step's 512 segments of 588 points (or 384 of 784)
// resident on 132 SMs, with room for KKZ's loads in registers
constexpr int kLargeCtasPerSm = 4;
constexpr int kMaxChunks = 8;          // 32-point chunks, shared: N <= 256
constexpr int kGlobalMaxChunks = 16;   // global: N <= 512
constexpr int kLargeMaxN = 3136;       // large: 16 frames of 196 tokens
// points a thread keeps in registers in the global variant's KKZ
constexpr int kKkzPoints = 32 * kGlobalMaxChunks / kGlobalThreads;
constexpr int kScanBatch = 8;          // loads in flight a thread in a scan
// dynamic shared memory the scratch variant may take beside its static
// shared memory (block_argmax's slots and the moved count)
constexpr size_t kScratchMaxSmem = 232448 - 256;
constexpr int kSumBatch = 4;           // loads in flight in a candidate's sum

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

// the global variant's: best, assign, sums [N]; meds, moved [K]; member
// masks [K, chunks]; then bytes: tie [N], dirty [K], moved flags [K]
__host__ __device__ inline size_t global_smem_bytes(int N, int K) {
  return (3 * (size_t)N + 2 * (size_t)K + (size_t)K * n_chunks(N)) * 4
         + ((size_t)N + 2 * (size_t)K + 3) / 4 * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// the shared variant; C = ceil(N / 32) chunks of 32 points, a compile-time
// count
template <int C>
__global__ void __launch_bounds__(kThreads)
kmedoids_kernel(const float* __restrict__ D, const float* __restrict__ l2,
                int* __restrict__ meds_out, int* __restrict__ assign_out,
                int* __restrict__ steps_out, int N, int K, int iter_limit,
                int id_sort) {
  extern __shared__ __align__(128) float smem[];
  float* sD = smem;                                   // [N, N]
  float* s = sD + (size_t)N * N;                      // [N] candidate sums
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
  const uint32_t bytes = (uint32_t)N * N * 4;
  const bool bulk = bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(Db) & 15) == 0;

  // ---- D into shared memory
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

  // ---- KKZ seeding in warp 0: mindist of points lane + 32 j in registers
  if (warp == 0) {
    int md[C];                 // ordered(mindist), INT_MIN past N
    const float* row = sD + (size_t)idx * N;
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
      row = sD + (size_t)idx * N;
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
        a = nearest_medoid(sD, meds, N, K, n);
        assign[n] = a;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, a);
      if (a >= 0 && lane == __ffs(peers) - 1) members[a * C + c] = peers;
    }
    __syncthreads();
    // each candidate's sum over its own cluster's members, ascending
    for (int n = tid; n < N; n += nt) {
      const unsigned* mine = members + assign[n] * C;
      const float* row = sD + (size_t)n * N;
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
    assign_out[(size_t)b * N + n] = nearest_medoid(sD, meds, N, K, n);
  for (int k = tid; k < K; k += nt) meds_out[(size_t)b * K + k] = meds[k];
  if (tid == 0) steps_out[b] = steps;
}

// (d, k) into the running first-index minimum (bv, bk); tie: another k
// holds the minimum value too (once set it stays set until a strictly
// lower value arrives, so it may be set where no tie is left: a hint that
// is never wrong when clear)
__device__ __forceinline__ void take(int d, int k, int& bv, int& bk, bool& tie) {
  if (d < bv) { bv = d; bk = k; tie = false; }
  else if (d == bv) { tie = true; if (k < bk) bk = k; }
}

// the moved-medoid list's entries: k in the low 16 bits, its new medoid
// above them
__device__ __forceinline__ int pack_moved(int k, int med) { return k | (med << 16); }

// point n's (bv, bk, tie) over its current medoid and the medoids that
// moved, moved[0, n_moved) (its own medoid stayed); kPacked: the entries
// are pack_moved(k, medoid), else k alone (the medoid is meds[k])
template <bool kPacked>
__device__ __forceinline__ void scan_moved(const float* __restrict__ Db, const int* meds,
                                           const int* moved, int n_moved, int N,
                                           int n, int& bv, int& bk, bool& tie) {
  for (int i0 = 0; i0 < n_moved; i0 += kScanBatch) {
    int d[kScanBatch], k[kScanBatch];
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u) {
      const int m = i0 + u < n_moved ? moved[i0 + u] : 0;
      k[u] = kPacked ? m & 0xffff : m;
      const int med = kPacked ? m >> 16 : meds[k[u]];
      d[u] = i0 + u < n_moved ? ordered(__ldg(Db + (size_t)med * N + n)) : 0;
    }
#pragma unroll
    for (int u = 0; u < kScanBatch; ++u)
      if (i0 + u < n_moved) take(d[u], k[u], bv, bk, tie);
  }
}

// the warp together: (value, first k, tie) of point n's nearest medoid over
// all K, lane l taking k = l, l + 32, ...; every lane gets it
__device__ __forceinline__ void warp_scan_all(const float* __restrict__ Db,
                                              const int* meds, int N, int K,
                                              int n, int& bv, int& bk, bool& tie) {
  const int lane = threadIdx.x & 31;
  int v = INT_MAX, kk = INT_MAX;
  bool t = false;
#pragma unroll 4
  for (int k = lane; k < K; k += 32)
    take(ordered(__ldg(Db + (size_t)meds[k] * N + n)), k, v, kk, t);
  bv = __reduce_min_sync(0xffffffffu, v);
  const unsigned at_min = __ballot_sync(0xffffffffu, v == bv);
  bk = __reduce_min_sync(0xffffffffu, v == bv ? kk : INT_MAX);
  tie = __popc(at_min) > 1 || __any_sync(0xffffffffu, v == bv && t);
}

// KKZ's next pick is often the argmax another warp's points hold now: each
// warp prefetches the row of its own argmax into L2 (a lane a 128-byte
// line, the last lane the row's last element; a row of more than 31 lines,
// kWide, takes every 32nd line a lane), so that the pick's row read after
// the block's choice hits L2 more often than device memory
template <bool kWide>
__device__ __forceinline__ void prefetch_row(const float* row, int N) {
  const int lane = threadIdx.x & 31;
  if constexpr (kWide) {
    for (int l = lane; l <= (N + 31) / 32; l += 32)
      asm volatile("prefetch.global.L2 [%0];" :: "l"(row + min(32 * l, N - 1)));
  } else if (lane <= (N + 31) / 32) {
    asm volatile("prefetch.global.L2 [%0];" :: "l"(row + min(32 * lane, N - 1)));
  }
}

// the lanes of a 32-point chunk (point n >= N past the end) bring their
// (bv, bk, tie) up to date after the medoids in moved[0, n_moved) moved: a
// point whose own medoid stayed compares the moved ones only; the points
// whose own medoid moved are scanned over all K by the whole warp, one
// after the other (K / 32 loads a lane in flight at once, where a lane
// scanning its own point would wait K / kScanBatch times).  Warp-uniform
// control flow.
template <bool kPacked>
__device__ __forceinline__ void reassign_chunk(const float* __restrict__ Db,
                                               const int* meds, const int* moved,
                                               const unsigned char* moved_flag,
                                               int n_moved, int N, int K, int n,
                                               int& bv, int& bk, bool& tie) {
  const bool valid = n < N;
  const unsigned orphans = __ballot_sync(0xffffffffu, valid && moved_flag[bk]);
  if (valid && !(orphans >> (threadIdx.x & 31) & 1))
    scan_moved<kPacked>(Db, meds, moved, n_moved, N, n, bv, bk, tie);
  for (unsigned o = orphans; o; o &= o - 1) {
    const int src = __ffs(o) - 1;
    int v, k;
    bool t;
    warp_scan_all(Db, meds, N, K, __shfl_sync(0xffffffffu, n, src), v, k, t);
    if ((threadIdx.x & 31) == src) { bv = v; bk = k; tie = t; }
  }
}

// first-index argmax over the CTA of each thread's (ordered value v,
// index i); every thread gets the index.  slots: [2][kGlobalWarps] in
// shared memory; parity p alternates from call to call, so one barrier a
// call suffices (a warp can reach the next call's slots of the same parity
// only after every warp has passed the barrier in between).  Each warp's
// own argmax's row of Db is prefetched into L2 meanwhile, when it differs
// from the one it prefetched last (`fetched`, the same in every lane).
template <bool kWide>
__device__ __forceinline__ int block_argmax(int v, int i, int2* slots, int p,
                                            const float* Db, int N, int& fetched) {
  const int best = __reduce_max_sync(0xffffffffu, v);
  const int idx = __reduce_min_sync(0xffffffffu, v == best ? i : INT_MAX);
  if (idx < N && idx != fetched) {
    prefetch_row<kWide>(Db + (size_t)idx * N, N);
    fetched = idx;
  }
  int2* mine = slots + p * kGlobalWarps;
  if ((threadIdx.x & 31) == 0) mine[threadIdx.x >> 5] = make_int2(best, idx);
  __syncthreads();
  int2 b = mine[0];
#pragma unroll
  for (int w = 1; w < kGlobalWarps; ++w) {
    const int2 c = mine[w];
    if (c.x > b.x || (c.x == b.x && c.y < b.y)) b = c;
  }
  return b.y;
}

// the scratch variant's per-point and per-cluster state: best, assign,
// sums [N]; meds, moved [K]; then bytes: tie [N], dirty [K], moved flags [K]
__host__ __device__ inline size_t scratch_state_bytes(int N, int K) {
  return (3 * (size_t)N + 2 * (size_t)K) * 4 + ((size_t)N + 2 * (size_t)K + 3) / 4 * 4;
}
__host__ __device__ inline bool scratch_state_shared(int N, int K) {
  return scratch_state_bytes(N, K) <= kScratchMaxSmem;
}
// the scratch a segment takes, in 4-byte words (a multiple of 4): its
// member masks [K, chunks], then its state where shared memory cannot hold
// it
__host__ __device__ inline long long scratch_words(int N, int K) {
  const long long state =
      scratch_state_shared(N, K) ? 0 : (long long)scratch_state_bytes(N, K) / 4;
  const long long w = (long long)K * n_chunks(N) + state;
  return (w + 3) / 4 * 4;
}

// The body of the global variant; C = ceil(N / 32) chunks of 32 points, a
// compile-time count; C = 0 is the large variant: the count from N at run
// time, and KKZ's per-point state in shared memory; C = -1 is the scratch
// variant: the large one with its member masks (and, where `state_shared`
// is 0, its state) in `scratch`, `words` 4-byte words a segment, and the
// moved list holding k alone
template <int C>
__device__ __forceinline__ void global_body(const float* __restrict__ D,
                                            const float* __restrict__ l2,
                                            int* __restrict__ meds_out,
                                            int* __restrict__ assign_out,
                                            int* __restrict__ steps_out, int N, int K,
                                            int iter_limit, int id_sort, int* scratch,
                                            long long words, int state_shared) {
  constexpr bool kPacked = C >= 0;
  const int nc = C > 0 ? C : n_chunks(N);
  extern __shared__ __align__(16) int gsm[];
  int* seg = C < 0 ? scratch + (size_t)blockIdx.x * words : nullptr;
  int* best = C < 0 && !state_shared ? seg + (size_t)K * nc : gsm;  // [N] ordered values
  int* assign = best + N;                             // [N] nearest k
  float* s = reinterpret_cast<float*>(assign + N);    // [N] candidate sums
  int* meds = reinterpret_cast<int*>(s + N);          // [K]
  int* moved = meds + K;                              // [K] pack_moved(k, med), or k
  unsigned* members = C < 0 ? reinterpret_cast<unsigned*>(seg)
                            : reinterpret_cast<unsigned*>(moved + K);  // [K, nc]
  unsigned char* tie = C < 0 ? reinterpret_cast<unsigned char*>(moved + K)
                             : reinterpret_cast<unsigned char*>(members + K * nc);  // [N]
  unsigned char* dirty = tie + N;                     // [K] member set changed
  unsigned char* moved_flag = dirty + K;              // [K]
  __shared__ int2 slots[2 * kGlobalWarps];
  __shared__ int n_moved;

  const int tid = threadIdx.x, nt = kGlobalThreads;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const float* Db = D + (size_t)b * N * N;

  for (int k = tid; k < K; k += nt) { dirty[k] = 1; moved_flag[k] = 0; }
  if (tid == 0) n_moved = 0;

  // ---- KKZ over the CTA: mindist of points tid + 256 j as ordered ints,
  // with each point's nearest chosen medoid and tie flag
  int idx, fetched = -1;
  {
    int v = INT_MIN, i = INT_MAX;
    for (int n = tid; n < N; n += nt) {
      const int x = ordered(l2[(size_t)b * N + n]);
      if (x > v) { v = x; i = n; }
    }
    idx = block_argmax<(C <= 0)>(v, i, slots, 0, Db, N, fetched);
  }
  if (tid == 0) meds[0] = idx;
  if constexpr (C > 0) {
    int md[kKkzPoints], ak[kKkzPoints];
    unsigned ties = 0;
#pragma unroll
    for (int j = 0; j < kKkzPoints; ++j) {
      const int n = tid + nt * j;
      md[j] = n < N ? ordered(__ldg(Db + (size_t)idx * N + n)) : INT_MIN;
      ak[j] = 0;
    }
    for (int k = 1; k < K; ++k) {
      int v = INT_MIN, i = INT_MAX;
#pragma unroll
      for (int j = 0; j < kKkzPoints; ++j)
        if (tid + nt * j < N && md[j] > v) { v = md[j]; i = tid + nt * j; }
      idx = block_argmax<(C <= 0)>(v, i, slots, k & 1, Db, N, fetched);
      if (tid == 0) meds[k] = idx;
      const float* row = Db + (size_t)idx * N;
#pragma unroll
      for (int j = 0; j < kKkzPoints; ++j) {
        const int n = tid + nt * j;
        if (n < N) {
          const int d = ordered(__ldg(row + n));
          if (d < md[j]) { md[j] = d; ak[j] = k; ties &= ~(1u << j); }
          else if (d == md[j]) ties |= 1u << j;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kKkzPoints; ++j) {
      const int n = tid + nt * j;
      if (n < N) { best[n] = md[j]; assign[n] = ak[j]; tie[n] = (ties >> j) & 1; }
    }
  } else {
    // the same steps on best, assign and tie in shared memory; a thread
    // reads and writes only its own points n = tid + nt j, so the one
    // barrier a step in block_argmax is all they need
    for (int n = tid; n < N; n += nt) {
      best[n] = ordered(__ldg(Db + (size_t)idx * N + n));
      assign[n] = 0;
      tie[n] = 0;
    }
    for (int k = 1; k < K; ++k) {
      int v = INT_MIN, i = INT_MAX;
      for (int n = tid; n < N; n += nt)
        if (best[n] > v) { v = best[n]; i = n; }
      idx = block_argmax<(C <= 0)>(v, i, slots, k & 1, Db, N, fetched);
      if (tid == 0) meds[k] = idx;
      const float* row = Db + (size_t)idx * N;
      for (int n0 = tid; n0 < N; n0 += nt * kScanBatch) {
        int d[kScanBatch];
#pragma unroll
        for (int u = 0; u < kScanBatch; ++u) {
          const int n = n0 + nt * u;
          d[u] = n < N ? ordered(__ldg(row + n)) : 0;
        }
#pragma unroll
        for (int u = 0; u < kScanBatch; ++u) {
          const int n = n0 + nt * u;
          if (n < N) {
            if (d[u] < best[n]) { best[n] = d[u]; assign[n] = k; tie[n] = 0; }
            else if (d[u] == best[n]) tie[n] = 1;
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- Lloyd iterations to the medoid fixed point, three barriers a step
  int steps = 0;
  while (steps < iter_limit) {
    const int nm = n_moved;
    // the assignment after the last update, and member masks, one warp per
    // 32-point chunk
    for (int c = warp; c < nc; c += kGlobalWarps) {
      for (int k = lane; k < K; k += 32) members[k * nc + c] = 0u;
      __syncwarp();
      const int n = 32 * c + lane;
      int a = n < N ? assign[n] : -1;
      if (nm) {
        int bv = 0, bk = a;
        bool t = false;
        if (n < N) { bv = best[n]; t = tie[n]; }
        reassign_chunk<kPacked>(Db, meds, moved, moved_flag, nm, N, K, n, bv, bk, t);
        if (n < N) {
          best[n] = bv;
          tie[n] = t;
          if (bk != a) { assign[n] = bk; dirty[a] = 1; dirty[bk] = 1; a = bk; }
        }
      }
      const unsigned peers = __match_any_sync(0xffffffffu, a);
      if (a >= 0 && lane == __ffs(peers) - 1) members[a * nc + c] = peers;
    }
    __syncthreads();
    if (tid == 0) n_moved = 0;
    // each candidate of a changed cluster: its sum over its cluster's
    // members, ascending, kSumBatch loads at a time
    for (int n = tid; n < N; n += nt) {
      const int a = assign[n];
      if (!dirty[a]) continue;
      const unsigned* mine = members + a * nc;
      const float* row = Db + (size_t)n * N;
      float acc = 0.f;
      int c = 0;
      unsigned w = mine[0];
      for (bool more = true; more;) {
        int m[kSumBatch];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u) {
          while (!w && c + 1 < nc) w = mine[++c];
          m[u] = w ? 32 * c + __ffs(w) - 1 : -1;
          w &= w - 1;
        }
        float d[kSumBatch];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u) d[u] = m[u] >= 0 ? __ldg(row + m[u]) : 0.f;
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u)
          if (m[u] >= 0) acc += d[u];
        more = m[kSumBatch - 1] >= 0;
      }
      s[n] = acc;
    }
    __syncthreads();
    // each changed cluster's first-index argmin over its members
    for (int k = tid; k < K; k += nt) {
      moved_flag[k] = 0;
      if (!dirty[k]) continue;     // same members, same sums: same medoid
      dirty[k] = 0;
      float bs = INFINITY;
      int bn = -1;
#pragma unroll
      for (int c = 0; c < nc; ++c)
        for (unsigned w = members[k * nc + c]; w; w &= w - 1) {
          const int m = 32 * c + __ffs(w) - 1;
          if (s[m] < bs) { bs = s[m]; bn = m; }
        }
      const int nmk = bn < 0 ? 0 : bn;   // argmin over all-zero scores is 0
      if (nmk != meds[k]) {
        meds[k] = nmk;
        moved_flag[k] = 1;
        moved[atomicAdd(&n_moved, 1)] = kPacked ? pack_moved(k, nmk) : k;
      }
    }
    __syncthreads();
    ++steps;
    if (!n_moved) break;
  }
  // stopped at iter_limit with medoids that moved: bring the assignment up
  // to date
  if (n_moved) {
    for (int c = warp; c < nc; c += kGlobalWarps) {
      const int n = 32 * c + lane;
      int bv = 0, bk = 0;
      bool t = false;
      if (n < N) { bv = best[n]; bk = assign[n]; t = tie[n]; }
      reassign_chunk<kPacked>(Db, meds, moved, moved_flag, n_moved, N, K, n, bv, bk, t);
      if (n < N) { assign[n] = bk; tie[n] = t; }
    }
    __syncthreads();
  }

  // ---- sort the ids (stable rank); the last assignment: a point's k by
  // its rank, or a scan of the sorted medoids where another may tie it
  int* sorted = moved;                                // [K], moved is done
  int* rank_of = reinterpret_cast<int*>(s);           // [K <= N], sums done
  if (id_sort) {
    for (int k = tid; k < K; k += nt) {
      const int mk = meds[k];
      int rank = 0;
#pragma unroll 8
      for (int j = 0; j < K; ++j)
        rank += (meds[j] < mk) || (meds[j] == mk && j < k);
      sorted[rank] = mk;
      rank_of[k] = rank;
    }
    __syncthreads();
  }
  for (int c = warp; c < nc; c += kGlobalWarps) {
    const int n = 32 * c + lane;
    int out = n < N ? assign[n] : 0;
    if (id_sort) {
      const unsigned ties = __ballot_sync(0xffffffffu, n < N && tie[n]);
      if (n < N && !(ties >> lane & 1)) out = rank_of[out];
      for (unsigned o = ties; o; o &= o - 1) {
        const int src = __ffs(o) - 1;
        int v, k;
        bool t;
        warp_scan_all(Db, sorted, N, K, 32 * c + src, v, k, t);
        if (lane == src) out = k;
      }
    }
    if (n < N) assign_out[(size_t)b * N + n] = out;
  }
  for (int k = tid; k < K; k += nt)
    meds_out[(size_t)b * K + k] = id_sort ? sorted[k] : meds[k];
  if (tid == 0) steps_out[b] = steps;
}

// the global (C > 0) and large (C = 0) variants
template <int C>
__global__ void __launch_bounds__(kGlobalThreads,
                                  C > 0 ? kGlobalCtasPerSm : kLargeCtasPerSm)
kmedoids_global_kernel(const float* __restrict__ D, const float* __restrict__ l2,
                       int* __restrict__ meds_out, int* __restrict__ assign_out,
                       int* __restrict__ steps_out, int N, int K, int iter_limit,
                       int id_sort) {
  global_body<C>(D, l2, meds_out, assign_out, steps_out, N, K, iter_limit, id_sort,
                 nullptr, 0, 1);
}

// the scratch variant
__global__ void __launch_bounds__(kGlobalThreads, kLargeCtasPerSm)
kmedoids_scratch_kernel(const float* __restrict__ D, const float* __restrict__ l2,
                        int* __restrict__ meds_out, int* __restrict__ assign_out,
                        int* __restrict__ steps_out, int N, int K, int iter_limit,
                        int id_sort, int* __restrict__ scratch, long long words,
                        int state_shared) {
  global_body<-1>(D, l2, meds_out, assign_out, steps_out, N, K, iter_limit, id_sort,
                  scratch, words, state_shared);
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

// the large variant's layout is the global variant's
size_t cc_kmedoids_large_smem_bytes(int N, int K) { return global_smem_bytes(N, K); }

// Shared variant: 1 <= N <= 256 and smem_bytes(N, K) within the opt-in limit.
int cc_kmedoids(const void* D, const void* l2, void* meds, void* assign,
                void* steps, int B, int N, int K, int iter_limit, int id_sort,
                void* stream) {
  static const Kernel kernels[kMaxChunks] = {
      kmedoids_kernel<1>, kmedoids_kernel<2>, kmedoids_kernel<3>, kmedoids_kernel<4>,
      kmedoids_kernel<5>, kmedoids_kernel<6>, kmedoids_kernel<7>, kmedoids_kernel<8>};
  if (N < 1 || N > 32 * kMaxChunks) return (int)cudaErrorInvalidValue;
  return launch(kernels[n_chunks(N) - 1], kThreads, smem_bytes(N, K), D, l2, meds,
                assign, steps, B, N, K, iter_limit, id_sort, stream);
}

// Global variant: 1 <= N <= 512; D read from device memory.
int cc_kmedoids_global(const void* D, const void* l2, void* meds, void* assign,
                       void* steps, int B, int N, int K, int iter_limit,
                       int id_sort, void* stream) {
  static const Kernel kernels[kGlobalMaxChunks] = {
      kmedoids_global_kernel<1>,  kmedoids_global_kernel<2>,
      kmedoids_global_kernel<3>,  kmedoids_global_kernel<4>,
      kmedoids_global_kernel<5>,  kmedoids_global_kernel<6>,
      kmedoids_global_kernel<7>,  kmedoids_global_kernel<8>,
      kmedoids_global_kernel<9>,  kmedoids_global_kernel<10>,
      kmedoids_global_kernel<11>, kmedoids_global_kernel<12>,
      kmedoids_global_kernel<13>, kmedoids_global_kernel<14>,
      kmedoids_global_kernel<15>, kmedoids_global_kernel<16>};
  if (N < 1 || N > 32 * kGlobalMaxChunks) return (int)cudaErrorInvalidValue;
  return launch(kernels[n_chunks(N) - 1], kGlobalThreads, global_smem_bytes(N, K), D,
                l2, meds, assign, steps, B, N, K, iter_limit, id_sort, stream);
}

// Large variant: 1 <= N <= 3136 and global_smem_bytes(N, K) within the
// opt-in limit; the global variant's steps with its per-point state in
// shared memory.
int cc_kmedoids_large(const void* D, const void* l2, void* meds, void* assign,
                      void* steps, int B, int N, int K, int iter_limit,
                      int id_sort, void* stream) {
  if (N < 1 || N > kLargeMaxN) return (int)cudaErrorInvalidValue;
  return launch(kmedoids_global_kernel<0>, kGlobalThreads, global_smem_bytes(N, K), D,
                l2, meds, assign, steps, B, N, K, iter_limit, id_sort, stream);
}

// the scratch variant's dynamic shared memory: its state where that fits,
// else none
size_t cc_kmedoids_scratch_smem_bytes(int N, int K) {
  return scratch_state_shared(N, K) ? scratch_state_bytes(N, K) : 0;
}

// 4-byte words of device-memory scratch each segment of the scratch
// variant takes
long long cc_kmedoids_scratch_words(int N, int K) { return scratch_words(N, K); }

// Scratch variant: N >= 1 with K * ceil(N / 32) < 2^31; `scratch` holds
// B * cc_kmedoids_scratch_words(N, K) words (no contents needed).
int cc_kmedoids_scratch(const void* D, const void* l2, void* meds, void* assign,
                        void* steps, void* scratch, int B, int N, int K, int iter_limit,
                        int id_sort, void* stream) {
  if (N < 1 || K < 1 || (long long)K * n_chunks(N) >= 0x80000000LL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = cc_kmedoids_scratch_smem_bytes(N, K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute((const void*)kmedoids_scratch_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kmedoids_scratch_kernel<<<B, kGlobalThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(D), static_cast<const float*>(l2), static_cast<int*>(meds),
      static_cast<int*>(assign), static_cast<int*>(steps), N, K, iter_limit, id_sort,
      static_cast<int*>(scratch), scratch_words(N, K), (int)scratch_state_shared(N, K));
  return (int)cudaGetLastError();
}

const char* cc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
