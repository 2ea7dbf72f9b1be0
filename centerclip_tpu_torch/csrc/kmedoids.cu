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
// past N = 512, K and the number of segments), which give the same bits on
// the same D:
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
//   (15 KB of shared memory each at N = 392, K = 160).  A segment spread
//   over a cluster of CTAs (the cluster variant's design, below) does not
//   pay here: a training step's 768 segments already fill the card, and
//   an encode's 192 use 8 warps on each of 132 SMs.
// * scratch (past what a cluster of 16 CTAs holds, e.g. N = K = 3920 or
//   N past ~26 000 at K = 392): kmedoids_scratch_kernel, global_body<-1>:
//   the global variant's steps with the chunk count read from N at run
//   time, KKZ's per-point state (mindist, nearest chosen medoid, tie flag)
//   in the shared-memory arrays the Lloyd steps keep it in (each thread
//   updates its own points after a pick, kScanBatch row loads in flight),
//   and the member masks, K x ceil(N / 32) words, in a device-memory
//   scratch of each segment that the wrapper allocates; the per-point and
//   per-cluster state (13 N + 10 K bytes) in shared memory where it fits
//   (N + K up to ~17 000), else in the scratch too.  The moved-medoid list
//   keeps k alone (the new medoid is meds[k]) instead of packing both into
//   32 bits, so N is not held to 15 bits.  4 CTAs an SM.  An earlier
//   "large" variant ran this body with the masks in shared memory (N <=
//   3136); the cluster variant took its shapes and was faster at every
//   one.
// * cluster (past N = 512 wherever a cluster of at most 16 CTAs holds the
//   segment: ViT-B/16's segments of 3, 4 and 20 frames, N = 588, 784 and
//   3920, whole 12-frame clips, N = 2352, at any K up to N there):
//   kmedoids_cluster_kernel, one segment on a thread-block cluster of Cs
//   CTAs of 8 warps, Cs chosen by the wrapper (1, 2, 4, 8 or 16; past 8 a
//   non-portable cluster size): the largest at which the card holds all B
//   segments' clusters at once, so that a 20-frame training step's 48
//   segments of 3920 take 8 CTAs each and a 4-frame step's 384 segments of
//   784 take one.  The one-CTA variants ran 48, 96 or 8 CTAs of 8 warps at
//   ViT-B/16's 20-frame and whole-clip shapes on 132 SMs: their chains of
//   dependent reads used a fraction of the card's memory parallelism.  CTA
//   r owns the 32-point chunks [r nc / Cs, (r + 1) nc / Cs): their points'
//   (best, assign, tie) and those chunks' columns of the member masks.
//   Every CTA keeps the K-long lists (meds, moved, moved flags) and
//   computes them from the same data, so they agree without copies.
//   - KKZ: each warp's first-index argmax of its CTA's own points goes to
//     its slot in every CTA (distributed shared memory), one cluster
//     barrier a pick, and every warp reduces the slots in order; each CTA
//     reads its own columns of the picked row, and prefetches the row of
//     its own argmax into L2 when it changes (Cs candidates a pick; on one
//     CTA each warp's, as the global variant does).
//   - A Lloyd step, three cluster barriers.  Each CTA brings its own
//     points up to date: a point whose medoid stayed compares the moved
//     ones, and the orphans (points whose medoid moved) go to a list that
//     the warps take kPointBatch at a time, one lane a medoid over all K
//     (the result is the lexicographic (value, k) minimum: the order of
//     the orphans and of the moved medoids does not change it); it builds
//     its own chunks' member masks and each cluster's own member count,
//     with a flag for a changed member set.  Barrier.  Every CTA pulls
//     every CTA's count words, scans the dirty clusters' sizes into their
//     member lists' offsets and their blocks of 32 candidates, and writes
//     its own members into every CTA's lists at offset + members in lower
//     CTAs + rank among its own (the popcounts of its mask words below
//     them): each list ascends.  Barrier.  The blocks, by the warps of the
//     whole cluster in turn: a lane a candidate, kItemBatch loads of its
//     row at the members in flight, then the adds in ascending member
//     order (never a tree), and the block's first-index argmin into its
//     slot in every CTA.  Barrier.  Each CTA folds each dirty cluster's
//     block minima in order into its new medoid.
//   The same sums in the same order and the same first-index choices: the
//   same bits as the scratch variant at every Cs.  Shared memory
//   a CTA: the member lists (N words) and the own mask columns (K
//   ceil(nc / Cs) words) are the most of it (39 KB at N = 3920, K = 160 on
//   8 CTAs, 143 KB at K = N = 2352 on 16); past that (e.g. N = K = 3920)
//   the scratch variant runs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;          // shared variant
constexpr int kGlobalThreads = 256;    // global variant
constexpr int kGlobalWarps = kGlobalThreads / 32;
constexpr int kGlobalCtasPerSm = 6;    // global: a training step's 768 resident
// scratch: 4 CTAs an SM, with room for KKZ's loads in registers
constexpr int kScratchCtasPerSm = 4;
constexpr int kMaxChunks = 8;          // 32-point chunks, shared: N <= 256
constexpr int kGlobalMaxChunks = 16;   // global: N <= 512
// points a thread keeps in registers in the global variant's KKZ
constexpr int kKkzPoints = 32 * kGlobalMaxChunks / kGlobalThreads;
constexpr int kScanBatch = 8;          // loads in flight a thread in a scan
// dynamic shared memory the scratch variant may take beside its static
// shared memory (block_argmax's slots and the moved count)
constexpr size_t kScratchMaxSmem = 232448 - 256;
constexpr int kSumBatch = 4;           // loads in flight in a candidate's sum
// the cluster variant: 256 threads a CTA, up to 16 CTAs a segment (past 8
// a non-portable cluster size), 4 CTAs an SM at most (64 registers a thread)
constexpr int kClusterThreads = 256;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxClusterCtas = 16;
constexpr int kClusterCtasPerSm = 4;
constexpr int kItemBatch = 16;         // loads in flight a lane in a block's sums
constexpr int kPointBatch = 4;         // points a warp scans over all K at once
constexpr unsigned kDirty = 1u << 31;  // a cluster's count word: member set changed

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
// compile-time count; C = -1 is the scratch variant: the count from N at
// run time, KKZ's per-point state in shared memory, and its member masks
// (and, where `state_shared`
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

// the global variant
template <int C>
__global__ void __launch_bounds__(kGlobalThreads, kGlobalCtasPerSm)
kmedoids_global_kernel(const float* __restrict__ D, const float* __restrict__ l2,
                       int* __restrict__ meds_out, int* __restrict__ assign_out,
                       int* __restrict__ steps_out, int N, int K, int iter_limit,
                       int id_sort) {
  global_body<C>(D, l2, meds_out, assign_out, steps_out, N, K, iter_limit, id_sort,
                 nullptr, 0, 1);
}

// the scratch variant
__global__ void __launch_bounds__(kGlobalThreads, kScratchCtasPerSm)
kmedoids_scratch_kernel(const float* __restrict__ D, const float* __restrict__ l2,
                        int* __restrict__ meds_out, int* __restrict__ assign_out,
                        int* __restrict__ steps_out, int N, int K, int iter_limit,
                        int id_sort, int* __restrict__ scratch, long long words,
                        int state_shared) {
  global_body<-1>(D, l2, meds_out, assign_out, steps_out, N, K, iter_limit, id_sort,
                  scratch, words, state_shared);
}

// ---- the cluster variant: one segment on a thread-block cluster of Cs CTAs

// own 32-point chunks a CTA holds at most, of ceil(N / 32) split over Cs
__host__ __device__ inline int cluster_chunks(int N, int Cs) {
  return (n_chunks(N) + Cs - 1) / Cs;
}

// the cluster variant's dynamic shared memory, P = 32 cluster_chunks points
// a CTA: the blocks' minima [ceil(N / 32) + K] (8 bytes: a dirty cluster
// of m members has ceil(m / 32) blocks of candidates, so all of them
// together at most N / 32 + K); best, assign, point list [P]; member masks
// [K, cluster_chunks]; member lists [N]; meds, moved, counts, sizes, prefix,
// offsets [K], block starts [K + 1]; then bytes: tie [P], moved flags [K]
__host__ __device__ inline size_t cluster_smem_bytes(int N, int K, int Cs) {
  const size_t ncr = cluster_chunks(N, Cs), P = 32 * ncr;
  return 8 * ((size_t)n_chunks(N) + K)
         + 4 * (3 * P + (size_t)K * ncr + N + 7 * (size_t)K + 1)
         + (P + K + 3) / 4 * 4;
}

// The cluster's first-index argmax of each thread's (ordered value v,
// index i); every thread of every CTA gets the index.  Each warp's argmax
// goes to its slot in every CTA's `slots` (Cs x 8 of them, one parity of
// two: a CTA writes a parity again only after the barrier of the call in
// between, which every CTA passes after reading it), one cluster barrier
// (a block barrier where the cluster is one CTA), then every warp reduces
// the slots in order.  The next pick is often one of the candidates: on
// one CTA each warp prefetches the row of its own argmax into L2 when it
// differs from the one it prefetched last (`fetched`, the same in every
// lane), as `block_argmax` does; on more, each CTA the row of its own
// argmax (Cs candidates a pick: 8 Cs rows of prefetches a pick cost the
// 20-frame segments more than they saved).
__device__ __forceinline__ int cluster_argmax(cg::cluster_group& cluster, int v, int i,
                                              int2* slots, int rank, int Cs,
                                              const float* Db, int N, int& fetched) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wv = __reduce_max_sync(0xffffffffu, v);
  const int wi = __reduce_min_sync(0xffffffffu, v == wv ? i : INT_MAX);
  if (Cs == 1) {
    if (wi < N && wi != fetched) {
      prefetch_row<true>(Db + (size_t)wi * N, N);
      fetched = wi;
    }
    if (lane == 0) slots[warp] = make_int2(wv, wi);
    __syncthreads();
  } else {
    if (lane < Cs)
      *cluster.map_shared_rank(slots + rank * kClusterWarps + warp, lane) = make_int2(wv, wi);
    cluster.sync();
  }
  int bv = INT_MIN, bi = INT_MAX;
  for (int s = lane; s < Cs * kClusterWarps; s += 32) {
    const int2 c = slots[s];
    if (c.x > bv || (c.x == bv && c.y < bi)) { bv = c.x; bi = c.y; }
  }
  const int gv = __reduce_max_sync(0xffffffffu, bv);
  const int gi = __reduce_min_sync(0xffffffffu, bv == gv ? bi : INT_MAX);
  if (Cs > 1) {
    // this CTA's own argmax
    const int2 c = lane < kClusterWarps ? slots[rank * kClusterWarps + lane]
                                        : make_int2(INT_MIN, INT_MAX);
    const int ov = __reduce_max_sync(0xffffffffu, c.x);
    const int oi = __reduce_min_sync(0xffffffffu, c.x == ov ? c.y : INT_MAX);
    if (oi < N && oi != fetched) {
      if (oi != gi) {
        const float* row = Db + (size_t)oi * N;
        for (int l = threadIdx.x; l <= (N + 31) / 32; l += kClusterThreads)
          asm volatile("prefetch.global.L2 [%0];" :: "l"(row + min(32 * l, N - 1)));
      }
      fetched = oi;
    }
  }
  return gi;
}

// the warp together: (value, first k, tie) of the nearest of the K medoids
// meds[] for kPointBatch points n[] at once, lane l taking k = l, l + 32,
// ... (kPointBatch loads in flight a step); every lane gets them
__device__ __forceinline__ void warp_scan_points(const float* __restrict__ Db,
                                                 const int* meds, int N, int K,
                                                 const int (&n)[kPointBatch],
                                                 int (&bv)[kPointBatch],
                                                 int (&bk)[kPointBatch],
                                                 bool (&tie)[kPointBatch]) {
  const int lane = threadIdx.x & 31;
  int v[kPointBatch], kk[kPointBatch];
  bool t[kPointBatch];
#pragma unroll
  for (int u = 0; u < kPointBatch; ++u) { v[u] = INT_MAX; kk[u] = INT_MAX; t[u] = false; }
#pragma unroll 2
  for (int k = lane; k < K; k += 32) {
    const float* row = Db + (size_t)meds[k] * N;
    int d[kPointBatch];
#pragma unroll
    for (int u = 0; u < kPointBatch; ++u) d[u] = ordered(__ldg(row + n[u]));
#pragma unroll
    for (int u = 0; u < kPointBatch; ++u) take(d[u], k, v[u], kk[u], t[u]);
  }
#pragma unroll
  for (int u = 0; u < kPointBatch; ++u) {
    bv[u] = __reduce_min_sync(0xffffffffu, v[u]);
    const unsigned at_min = __ballot_sync(0xffffffffu, v[u] == bv[u]);
    bk[u] = __reduce_min_sync(0xffffffffu, v[u] == bv[u] ? kk[u] : INT_MAX);
    tie[u] = __popc(at_min) > 1 || __any_sync(0xffffffffu, v[u] == bv[u] && t[u]);
  }
}

// One segment (b = blockIdx.x / Cs) on a cluster of Cs CTAs.  CTA `rank`
// owns the 32-point chunks [rank nc / Cs, (rank + 1) nc / Cs): their
// points' (best, assign, tie) and those chunks' columns of the member
// masks.  Every CTA keeps the K-long lists (meds, moved, moved flags) and
// computes them from the same data, so they stay equal without copies.
__global__ void __launch_bounds__(kClusterThreads, kClusterCtasPerSm)
kmedoids_cluster_kernel(const float* __restrict__ D, const float* __restrict__ l2,
                        int* __restrict__ meds_out, int* __restrict__ assign_out,
                        int* __restrict__ steps_out, int N, int K, int iter_limit,
                        int id_sort) {
  cg::cluster_group cluster = cg::this_cluster();
  const int Cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / Cs;
  const int nc = n_chunks(N), ncr = cluster_chunks(N, Cs), P = 32 * ncr;
  const int c0 = rank * nc / Cs, nlc = (rank + 1) * nc / Cs - c0;
  const int p0 = 32 * c0, np = min(32 * (c0 + nlc), N) - p0;   // own points
  extern __shared__ __align__(16) int2 csm[];
  int2* block_min = csm;                           // [nc + K] a block's (sum, candidate) minimum
  int* best = reinterpret_cast<int*>(block_min + nc + K);  // [P] ordered nearest value
  int* assign = best + P;                          // [P] nearest k
  int* plist = assign + P;                         // [P] own points to scan over all K
  unsigned* members = reinterpret_cast<unsigned*>(plist + P);  // [K, ncr] own columns
  int* list = reinterpret_cast<int*>(members + (size_t)K * ncr);  // [N] member lists
  int* meds = list + N;                            // [K]
  int* moved = meds + K;                           // [K] k of each moved medoid
  unsigned* cd = reinterpret_cast<unsigned*>(moved + K);  // [K] own members | kDirty
  int* size = reinterpret_cast<int*>(cd + K);      // [K] members of a dirty cluster, else -1
  int* pre = size + K;                             // [K] its members in lower CTAs
  int* off = pre + K;                              // [K] its member list's offset
  int* item_start = off + K;                       // [K + 1] its first block of 32 candidates
  unsigned char* tie = reinterpret_cast<unsigned char*>(item_start + K + 1);  // [P]
  unsigned char* moved_flag = tie + P;             // [K]
  __shared__ int2 slots[2][kMaxClusterCtas * kClusterWarps];
  __shared__ int2 scan_part[kClusterWarps];
  __shared__ int n_moved, n_plist;

  constexpr int nt = kClusterThreads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* Db = D + (size_t)b * N * N;

  for (int k = tid; k < K; k += nt) { moved_flag[k] = 0; cd[k] = kDirty; }
  if (tid == 0) { n_moved = 0; n_plist = 0; }
  cluster.sync();                    // every CTA has started: its shared memory may be written

  // ---- KKZ over the cluster: mindist, nearest chosen medoid and tie flag
  // of the own points j = tid + 256 i (a thread reads and writes only its
  // own, so the cluster barrier a pick is all they need)
  int idx, fetched = -1;
  {
    int v = INT_MIN, i = INT_MAX;
    for (int j = tid; j < np; j += nt) {
      const int x = ordered(l2[(size_t)b * N + p0 + j]);
      if (x > v) { v = x; i = p0 + j; }
    }
    idx = cluster_argmax(cluster, v, i, slots[0], rank, Cs, Db, N, fetched);
  }
  if (tid == 0) meds[0] = idx;
  for (int j = tid; j < np; j += nt) {
    best[j] = ordered(__ldg(Db + (size_t)idx * N + p0 + j));
    assign[j] = 0;
    tie[j] = 0;
  }
  for (int k = 1; k < K; ++k) {
    int v = INT_MIN, i = INT_MAX;
    for (int j = tid; j < np; j += nt)
      if (best[j] > v) { v = best[j]; i = p0 + j; }
    idx = cluster_argmax(cluster, v, i, slots[k & 1], rank, Cs, Db, N, fetched);
    if (tid == 0) meds[k] = idx;
    const float* row = Db + (size_t)idx * N + p0;
    for (int j0 = tid; j0 < np; j0 += nt * kScanBatch) {
      int d[kScanBatch];
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        const int j = j0 + nt * u;
        d[u] = j < np ? ordered(__ldg(row + j)) : 0;
      }
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        const int j = j0 + nt * u;
        if (j < np) {
          if (d[u] < best[j]) { best[j] = d[u]; assign[j] = k; tie[j] = 0; }
          else if (d[u] == best[j]) tie[j] = 1;
        }
      }
    }
  }
  __syncthreads();

  // the own points' (best, assign, tie) after the medoids moved[0, nm)
  // moved: a point whose own medoid stayed compares the moved ones only;
  // the points whose own medoid moved go to plist, and the warps take them
  // kPointBatch at a time, over all K.  With `mark`, a changed assignment
  // flags both clusters' member sets as changed.
  auto reassign = [&](int nm, bool mark) {
    for (int j = tid; j < np; j += nt) {
      const int a = assign[j];
      if (moved_flag[a]) { plist[atomicAdd(&n_plist, 1)] = j; continue; }
      int bv = best[j], bk = a;
      bool t = tie[j];
      scan_moved<false>(Db, meds, moved, nm, N, p0 + j, bv, bk, t);
      best[j] = bv;
      tie[j] = t;
      if (bk != a) {
        assign[j] = bk;
        if (mark) { atomicOr(cd + a, kDirty); atomicOr(cd + bk, kDirty); }
      }
    }
    __syncthreads();
    const int no = n_plist;
    for (int o0 = warp * kPointBatch; o0 < no; o0 += kClusterWarps * kPointBatch) {
      int n[kPointBatch], bv[kPointBatch], bk[kPointBatch];
      bool t[kPointBatch];
#pragma unroll
      for (int u = 0; u < kPointBatch; ++u) n[u] = p0 + plist[min(o0 + u, no - 1)];
      warp_scan_points(Db, meds, N, K, n, bv, bk, t);
#pragma unroll
      for (int u = 0; u < kPointBatch; ++u)
        if (lane == u && o0 + u < no) {
          const int j = n[u] - p0, a = assign[j];
          best[j] = bv[u];
          tie[j] = t[u];
          if (bk[u] != a) {
            assign[j] = bk[u];
            if (mark) { atomicOr(cd + a, kDirty); atomicOr(cd + bk[u], kDirty); }
          }
        }
    }
    __syncthreads();
  };

  // ---- Lloyd iterations to the medoid fixed point, three cluster
  // barriers a step
  int steps = 0;
  while (steps < iter_limit) {
    const int nm = n_moved;
    if (nm) reassign(nm, true);
    // the own chunks' member masks and each cluster's own member count
    for (int lc = warp; lc < nlc; lc += kClusterWarps) {
      for (int k = lane; k < K; k += 32) members[k * ncr + lc] = 0u;
      __syncwarp();
      const int j = 32 * lc + lane;
      const int a = j < np ? assign[j] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, a);
      if (a >= 0 && lane == __ffs(peers) - 1) {
        members[a * ncr + lc] = peers;
        atomicAdd(cd + a, (unsigned)__popc(peers));
      }
    }
    cluster.sync();
    if (tid == 0) n_moved = 0;       // read by every thread before the barrier
    // every CTA's count words: each dirty cluster's size, its members in
    // lower CTAs, then (a scan over the threads' contiguous k ranges) its
    // member list's offset and its first block of 32 candidates
    {
      const int per = (K + nt - 1) / nt;
      const int k0 = min(K, tid * per), k1 = min(K, k0 + per);
      int len = 0, items = 0;
      for (int k = k0; k < k1; ++k) {
        unsigned x[kMaxClusterCtas];   // all loads in flight (ranks past Cs read the last)
#pragma unroll
        for (int r = 0; r < kMaxClusterCtas; ++r)
          x[r] = *cluster.map_shared_rank(cd + k, min(r, Cs - 1));
#pragma unroll
        for (int r = 0; r < kMaxClusterCtas; ++r)
          if (r >= Cs) x[r] = 0u;
        unsigned tot = 0, below = 0, dirty = 0;
#pragma unroll
        for (int r = 0; r < kMaxClusterCtas; ++r) {
          dirty |= x[r];
          tot += x[r] & ~kDirty;
          if (r < rank) below += x[r] & ~kDirty;
        }
        const int m = dirty & kDirty ? (int)tot : -1;
        size[k] = m;
        pre[k] = (int)below;
        if (m > 0) { len += m; items += (m + 31) / 32; }
      }
      int a = len, c = items;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, a, d), y = __shfl_up_sync(0xffffffffu, c, d);
        if (lane >= d) { a += x; c += y; }
      }
      if (lane == 31) scan_part[warp] = make_int2(a, c);
      __syncthreads();
      a -= len;
      c -= items;
      for (int w = 0; w < warp; ++w) { a += scan_part[w].x; c += scan_part[w].y; }
      for (int k = k0; k < k1; ++k) {
        off[k] = a;
        item_start[k] = c;
        const int m = size[k];
        if (m > 0) { a += m; c += (m + 31) / 32; }
      }
      if (tid == nt - 1) item_start[K] = c;
    }
    __syncthreads();
    // the own members of each dirty cluster into every CTA's member list,
    // at their rank in ascending order
    for (int j = tid; j < np; j += nt) {
      const int a = assign[j];
      if (size[a] <= 0) continue;
      const unsigned* mask = members + (size_t)a * ncr;
      const int lc = j >> 5;
      int pos = off[a] + pre[a] + __popc(mask[lc] & ((1u << (j & 31)) - 1));
      for (int c = 0; c < lc; ++c) pos += __popc(mask[c]);
      for (int r = 0; r < Cs; ++r) *cluster.map_shared_rank(list + pos, r) = p0 + j;
    }
    cluster.sync();
    // each block of 32 candidates of a dirty cluster, by the warps of the
    // whole cluster in turn: a lane a candidate, its sum over the members in
    // ascending order (kItemBatch loads in flight, then the adds in order),
    // the block's first-index argmin into its slot in every CTA
    {
      const int n_items = item_start[K];
      for (int it = rank * kClusterWarps + warp; it < n_items; it += Cs * kClusterWarps) {
        int lo = 0, hi = K - 1;      // the last k whose blocks start at or before it
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (item_start[mid] <= it) lo = mid; else hi = mid - 1;
        }
        const int m = size[lo];
        const int* mem = list + off[lo];
        const int jc = 32 * (it - item_start[lo]) + lane;
        const int cand = jc < m ? mem[jc] : -1;
        const float* row = Db + (size_t)max(cand, 0) * N;
        float acc = 0.f;
        for (int j0 = 0; j0 < m; j0 += kItemBatch) {
          float d[kItemBatch];
#pragma unroll
          for (int u = 0; u < kItemBatch; ++u)
            d[u] = cand >= 0 && j0 + u < m ? __ldg(row + mem[j0 + u]) : 0.f;
#pragma unroll
          for (int u = 0; u < kItemBatch; ++u)
            if (j0 + u < m) acc += d[u];
        }
        const int v = cand >= 0 ? ordered(acc) : INT_MAX;
        const int bv = __reduce_min_sync(0xffffffffu, v);
        const int bn = __reduce_min_sync(0xffffffffu, cand >= 0 && v == bv ? cand : INT_MAX);
        if (lane < Cs) *cluster.map_shared_rank(block_min + it, lane) = make_int2(bv, bn);
      }
    }
    cluster.sync();
    // each dirty cluster's new medoid, the first-index argmin over its
    // blocks' minima in order (an empty cluster's is 0), the same in every
    // CTA
    for (int k = tid; k < K; k += nt) {
      moved_flag[k] = 0;
      cd[k] = 0;                     // every CTA read it before the last barrier but one
      const int m = size[k];
      if (m < 0) continue;
      int2 least = make_int2(INT_MAX, 0);
      for (int it = item_start[k]; it < item_start[k + 1]; ++it) {
        const int2 c = block_min[it];
        if (c.x < least.x || (c.x == least.x && c.y < least.y)) least = c;
      }
      const int nmk = m ? least.y : 0;
      if (nmk != meds[k]) {
        meds[k] = nmk;
        moved_flag[k] = 1;
        moved[atomicAdd(&n_moved, 1)] = k;
      }
    }
    if (tid == 0) n_plist = 0;
    __syncthreads();
    ++steps;
    if (!n_moved) break;
  }
  // stopped at iter_limit with medoids that moved: bring the assignment up
  // to date
  if (n_moved) reassign(n_moved, false);

  // ---- sort the ids (stable rank); the last assignment: a point's k by
  // its rank, or a scan of the sorted medoids where another may tie it
  int* sorted = moved;                               // [K], moved is done
  int* rank_of = pre;                                // [K]
  if (id_sort) {
    for (int k = tid; k < K; k += nt) {
      const int mk = meds[k];
      int r = 0;
#pragma unroll 8
      for (int j = 0; j < K; ++j) r += (meds[j] < mk) || (meds[j] == mk && j < k);
      sorted[r] = mk;
      rank_of[k] = r;
    }
  }
  if (tid == 0) n_plist = 0;
  __syncthreads();
  for (int j = tid; j < np; j += nt) {
    int out = assign[j];
    if (id_sort) {
      if (tie[j]) { plist[atomicAdd(&n_plist, 1)] = j; continue; }
      out = rank_of[out];
    }
    assign_out[(size_t)b * N + p0 + j] = out;
  }
  __syncthreads();
  if (id_sort) {
    const int no = n_plist;
    for (int o0 = warp * kPointBatch; o0 < no; o0 += kClusterWarps * kPointBatch) {
      int n[kPointBatch], bv[kPointBatch], bk[kPointBatch];
      bool t[kPointBatch];
#pragma unroll
      for (int u = 0; u < kPointBatch; ++u) n[u] = p0 + plist[min(o0 + u, no - 1)];
      warp_scan_points(Db, sorted, N, K, n, bv, bk, t);
#pragma unroll
      for (int u = 0; u < kPointBatch; ++u)
        if (lane == u && o0 + u < no) assign_out[(size_t)b * N + n[u]] = bk[u];
    }
  }
  if (rank == 0) {
    for (int k = tid; k < K; k += nt) meds_out[(size_t)b * K + k] = id_sort ? sorted[k] : meds[k];
    if (tid == 0) steps_out[b] = steps;
  }
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

// the cluster variant's dynamic shared memory a CTA at Cs CTAs a segment
size_t cc_kmedoids_cluster_smem_bytes(int N, int K, int Cs) {
  return cluster_smem_bytes(N, K, Cs);
}

// the cluster variant's launch configuration: B segments of Cs CTAs each
static cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                                  int B, int N, int K, int Cs, void* stream) {
  const size_t smem = cluster_smem_bytes(N, K, Cs);
  cudaError_t e = cudaFuncSetAttribute((const void*)kmedoids_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && Cs > 8)
    e = cudaFuncSetAttribute((const void*)kmedoids_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(B * Cs);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return e;
}

static bool cluster_args_ok(int N, int K, int Cs) {
  return N >= 1 && K >= 1 && K <= N && Cs >= 1 && Cs <= kMaxClusterCtas && Cs <= n_chunks(N);
}

// clusters of Cs CTAs of the cluster variant the card holds at once at
// (N, K) (cudaOccupancyMaxActiveClusters), or a negative CUDA error
int cc_kmedoids_cluster_max_active(int N, int K, int Cs) {
  if (!cluster_args_ok(N, K, Cs)) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config(cfg, attr, 1, N, K, Cs, nullptr);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&n, (const void*)kmedoids_cluster_kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// Cluster variant: 1 <= Cs <= min(16, ceil(N / 32)) CTAs a segment, K <= N
// and cluster_smem_bytes(N, K, Cs) within the opt-in limit; a launch the
// card refuses (e.g. a cluster it cannot hold) returns its error.
int cc_kmedoids_cluster(const void* D, const void* l2, void* meds, void* assign,
                        void* steps, int B, int N, int K, int iter_limit, int id_sort,
                        int Cs, void* stream) {
  if (!cluster_args_ok(N, K, Cs)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config(cfg, attr, B, N, K, Cs, stream);
  if (e != cudaSuccess) return (int)e;
  if (Cs == 1) cfg.numAttrs = 0;     // one CTA a segment: a plain launch
  e = cudaLaunchKernelEx(&cfg, kmedoids_cluster_kernel, static_cast<const float*>(D),
                         static_cast<const float*>(l2), static_cast<int*>(meds),
                         static_cast<int*>(assign), static_cast<int*>(steps), N, K,
                         iter_limit, id_sort);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* cc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
