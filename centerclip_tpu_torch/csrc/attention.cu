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
// (q is scaled and rounded to T first, as `q * scale` does on a T tensor;
// P is normalised in fp32, then rounded to T).
//
// Four variants, chosen by the wrapper from dtype, head_dim and L:
//
// * attention_fwd_mma_kernel (bf16 / fp16, hd % 16 == 0, L <= 128): tensor
//   cores.
//   A persistent grid (as many CTAs of 4 warps as fit on the card) walks
//   the (sample, head) items.  An item's q, k, v rows (hd contiguous
//   elements at a 16-byte aligned offset) come in by 16-byte cp.async into
//   shared tiles of row stride hd + 8 (ldmatrix without bank conflicts),
//   the sequence padded to a multiple of 16 with zero rows; where two
//   stages fit, the next item's rows load while this one computes.  Each
//   warp owns 16 query rows: S = qs.K^T by mma.m16n8k16 (ldmatrix-fed, q
//   scaled and rounded to T in its fragments, fp32 accumulation) stays in
//   registers, 64 keys at a time; the row max and sum are reduced over the
//   quad that holds a row.  P = exp(S - m) / l is rounded to T straight into
//   the A fragments of O = P.V (V through ldmatrix.trans), so P never
//   touches shared memory.  For L > 64 a first pass over the 64-key tiles
//   finds m and l and a second recomputes S and runs P.V: P is rounded after
//   normalisation, as the plain version does (one-pass online softmax would
//   round before).  O is written as T with 16-byte stores through a
//   per-warp staging tile.
//   Bound on this card: at CLIP's short sequences (L = 50, 32) the work is
//   ~4*L*hd flops per element moved, far below the ~295 flop/byte ridge of
//   an H100, so the kernel is bound by moving q, k, v and out; the design
//   keeps everything else on chip, and the two-stage pipeline keeps the
//   loads in flight while the CTA computes (one CTA per item that loads,
//   then computes, ran 1.6x slower at [384, 50, 2304]).
// * attention_fwd_long_kernel (bf16 / fp16, hd % 16 == 0, L > 128): the
//   same arithmetic (exp as cc::exp2_scaled, a few fp32 ulps from expf)
//   split over blocks of 64 query rows.  At
//   ViT-B/16's L = 197 a whole item staged as above takes 185 KB of shared
//   memory, so one CTA of 4 warps would run per SM, its 13 query tiles in
//   4 rounds of 4 warps.  Here one CTA of 4 warps takes (item, 64 query
//   rows) and streams K and V through a ring of 64-key tiles: 55 KB of
//   shared memory and at most 128 registers a thread, so 4 CTAs (16 warps)
//   are resident per SM.  The price is reading K twice and V once per query
//   block, from L2 for all but the first block of an item (the blocks of
//   an item are neighbours in launch order).  Bound on this card: its three
//   [L, L, hd] products (S twice, P.V once) are ~0.75 L flops per byte of
//   q, k, v and out (148 at L = 197), below the ~295 flop/byte ridge, so
//   moving those bytes bounds it (PERF.md has its time beside the bound).
// * attention_fwd_kernel (fp32, short: "cuda_core"): CUDA cores, the
//   products as fmaf loops from shared memory, the fp32 [L, L] scores in
//   shared memory: 3 L hd + L^2 floats, which past L = 163 (hd = 64) no CTA
//   can hold.  Kept for head_dim > 128 and for the lengths where the card
//   shows it faster (ops/attention_cuda.py, FP32_SHORT_RANGES).
// * attention_fwd_tf32x3_kernel (fp32, "tf32x3", any L, hd <= 128): the
//   tensor cores in three TF32 passes (csrc/f32_tile.cuh: x = hi + lo,
//   hi = tf32(x), lo = tf32(x - hi), a product as lo.hi + hi.lo + hi.hi by
//   mma.m16n8k8 with fp32 accumulation; only lo.lo, ~2^-22 relative, is
//   dropped).  One CTA of 4 warps takes (item, 64 query rows) and streams
//   K and V, alternately, as split 32-row tiles through a two-stage
//   cp.async ring (52 KB at hd = 64, 122 registers: 4 CTAs an SM; 32-row
//   stages at 4 CTAs ran faster on the card than 64-row ones at 2, and
//   only the rows before L, padded to 8, are loaded and split).  One pass
//   with an online softmax (the running max, O rescaled, 1 / l at the
//   end), P kept in fp32 registers and split once into the A fragments of
//   P.V.  Where asked it also writes each row's log-sum-exp for the
//   backward.  cuBLAS and cuDNN TF32 stay off in the port
//   (set_fp32_numerics): the split is this kernel's own arithmetic.
//   Measured on an H100 against the plain version's fp32: at most 0.35 of
//   the 1e-5 + 1e-5 |ref| tolerance (L = 393), 0.20-0.30 at ViT-B/16's
//   197; one TF32 pass would miss it 28-100x (CPU emulation,
//   tests/test_torch_attention_design.py).  Bound on this card: S and
//   P.V are 4 L^2 hd flops a head against 16 L hd bytes (49 flops a byte
//   at L = 197); the three passes make 12 L^2 hd TF32 flops, which at
//   495 TFLOP/s take about what the bytes take at 3.35 TB/s (PERF.md has
//   its time beside both and SDPA fp32).
//
// The TPU kernel's block-diagonal multi-sample batching was a device of the
// TPU's matrix unit and is not carried over.
#include <math.h>

#include "f32_tile.cuh"
#include "mma_tile.cuh"

namespace {

using cc::kPad;
using cc::pad16;
using cc::set_smem;
using cc::warp_max;
using cc::warp_sum;

// ------------------------------------------------------------ fp32 (SIMT)
constexpr int kSimtThreads = 256;

// shared memory: q [L, hd], k^T [hd, L], v [L, hd], then the fp32 scores
// [L, L] at a 16-byte aligned offset
__host__ __device__ inline size_t simt_scores_offset(int L, int hd) {
  return (3 * (size_t)L * hd * sizeof(float) + 15) / 16 * 16;
}

__host__ __device__ inline size_t simt_smem(int L, int hd) {
  return simt_scores_offset(L, hd) + (size_t)L * L * sizeof(float);
}

__global__ void __launch_bounds__(kSimtThreads)
attention_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                     float* __restrict__ out, int L, int H, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* skt = sq + L * hd;
  float* sv = skt + L * hd;
  float* sp = reinterpret_cast<float*>(smem + simt_scores_offset(L, hd));

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int D = H * hd;
  const size_t row = 3 * (size_t)D;
  const float* base = qkv + (size_t)b * L * row + (size_t)h * hd;

  for (int e = threadIdx.x; e < L * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    const float* r = base + i * row + d;
    sq[e] = r[0] * scale;
    skt[d * L + i] = r[D];
    sv[e] = r[2 * D];
  }
  __syncthreads();

  for (int e = threadIdx.x; e < L * L; e += blockDim.x) {
    const int i = e / L, j = e % L;
    const float* qi = sq + i * hd;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(qi[d], skt[d * L + j], acc);
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
    for (int j = lane; j < L; j += 32) pr[j] = pr[j] / s;
  }
  __syncthreads();

  float* ob = out + (size_t)b * L * D + (size_t)h * hd;
  for (int e = threadIdx.x; e < L * hd; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    const float* pr = sp + i * L;
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc = fmaf(pr[j], sv[j * hd + d], acc);
    ob[(size_t)i * D + d] = acc;
  }
}

// ----------------------------------------------------- bf16 / fp16 (mma)
constexpr int kWarps = 4;
constexpr int kKeys = 64;          // keys per register tile of S
constexpr int kCols = 64;          // head channels per register tile of O
constexpr int kStage = 16 * (kCols + kPad);

// shared memory: one [16][72] staging tile per warp, then one or two
// stages of q, k, v [Lp][hd + 8] in T (two where they fit: the next head
// loads while this one computes)
__host__ __device__ inline size_t mma_stage_bytes(int L, int hd, size_t elem) {
  return 3 * (size_t)pad16(L) * (hd + kPad) * elem;
}
__host__ __device__ inline int mma_stages(int L, int hd, size_t elem) {
  return cc::n_stages(kWarps * kStage * elem, mma_stage_bytes(L, hd, elem));
}
__host__ __device__ inline size_t mma_smem(int L, int hd, size_t elem) {
  return kWarps * kStage * elem + mma_stages(L, hd, elem) * mma_stage_bytes(L, hd, elem);
}

// S = qs[q0:q0+16] . K[k0:k0+64]^T for one warp, q scaled and rounded to T
// in its fragments; masked: columns >= L (and beyond the tile) are -inf,
// rows >= L get no mask
template <typename T>
__device__ __forceinline__ void scores(float (&s)[kKeys / 8][4], const T* sq, const T* sk,
                                       int ld, int hd, int q0, int k0, int L, int Lp,
                                       float scale, const float* __restrict__ mask,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kKeys / 8; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  for (int ks = 0; ks < hd; ks += 16) {
    uint32_t a[4];
    cc::ldmatrix_x4(a, cc::a_frag(sq, ld, q0, ks, lane));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float lo, hi;
      cc::unpack2<T>(a[r], lo, hi);
      a[r] = cc::pack2<T>(lo * scale, hi * scale);
    }
#pragma unroll
    for (int np = 0; np < kKeys / 16; ++np) {
      if (k0 + np * 16 < Lp) {
        uint32_t b[4];
        cc::ldmatrix_x4(b, cc::b_pair(sk, ld, k0 + np * 16, ks, lane));
        cc::mma16816<T>(s[2 * np], a, b[0], b[1]);
        cc::mma16816<T>(s[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = q0 + g + (e >> 1) * 8;
      const int j = k0 + nt * 8 + 2 * t + (e & 1);
      if (j >= L)
        s[nt][e] = -INFINITY;
      else if (mask != nullptr && i < L)
        s[nt][e] += mask[(size_t)i * L + j];
    }
  }
}

// s = exp(s - ref) in place for the thread's two rows; returns the
// thread's part of each row sum
__device__ __forceinline__ void exp_rows(float (&s)[kKeys / 8][4], const float (&ref)[2],
                                         float (&sum)[2]) {
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = expf(s[nt][e] - ref[e >> 1]);
      sum[e >> 1] += s[nt][e];
    }
}

// P = e / l rounded to T, as the A fragments of P.V (one per 16 keys)
template <typename T>
__device__ __forceinline__ void probs(uint32_t (&pa)[kKeys / 16][4],
                                      const float (&e)[kKeys / 8][4], const float (&inv)[2]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nt = 2 * kk + half;
      pa[kk][2 * half] = cc::pack2<T>(e[nt][0] * inv[0], e[nt][1] * inv[0]);
      pa[kk][2 * half + 1] = cc::pack2<T>(e[nt][2] * inv[1], e[nt][3] * inv[1]);
    }
}

// the row max of a row that is all -inf so far counts as 0, so its
// exponentials are 0 (and a fully masked row's P is 0 / 0, as in the plain
// version)
__device__ __forceinline__ float finite_ref(float m) { return m == -INFINITY ? 0.f : m; }

// one (sample, head): out rows of 16 per warp from the staged q, k, v
template <typename T>
__device__ __forceinline__ void attend(const T* sq, const T* sk, const T* sv, T* stage,
                                       T* ob, int L, int Lp, int ld, int hd, int D,
                                       float scale, const float* __restrict__ mask,
                                       int warp, int lane) {
  const int n_key_tiles = (Lp + kKeys - 1) / kKeys;
  for (int q0 = warp * 16; q0 < Lp; q0 += kWarps * 16) {
    // pass 1: row max and sum over all key tiles (quad-local partial sums)
    float s[kKeys / 8][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kt = 0; kt < n_key_tiles; ++kt) {
      scores<T>(s, sq, sk, ld, hd, q0, kt * kKeys, L, Lp, scale, mask, lane);
      float mn[2], ref[2], sum[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float cm = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kKeys / 8; ++nt)
          cm = fmaxf(cm, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
        mn[r] = fmaxf(m[r], cc::quad_max(cm));
        ref[r] = finite_ref(mn[r]);
      }
      exp_rows(s, ref, sum);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * expf(m[r] - ref[r]) + sum[r];
        m[r] = mn[r];
      }
    }
    const float inv[2] = {1.f / cc::quad_sum(l[0]), 1.f / cc::quad_sum(l[1])};
    const float ref[2] = {finite_ref(m[0]), finite_ref(m[1])};

    // pass 2: O = P.V, 64 head channels at a time; with one key tile the
    // exponentials are still in registers
    uint32_t pa[kKeys / 16][4];
    if (n_key_tiles == 1) probs<T>(pa, s, inv);
    for (int c0 = 0; c0 < hd; c0 += kCols) {
      const int n_tiles = min(kCols, hd - c0) / 8;
      float acc[kCols / 8][4];
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      for (int kt = 0; kt < n_key_tiles; ++kt) {
        const int k0 = kt * kKeys;
        if (n_key_tiles > 1) {
          float sum[2];
          scores<T>(s, sq, sk, ld, hd, q0, k0, L, Lp, scale, mask, lane);
          exp_rows(s, ref, sum);
          probs<T>(pa, s, inv);
        }
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          if (k0 + kk * 16 < Lp) {
#pragma unroll
            for (int np = 0; np < kCols / 16; ++np) {
              if (2 * np < n_tiles) {
                uint32_t bv[4];
                cc::ldmatrix_x4_trans(bv, cc::trans_b_pair(sv, ld, k0 + kk * 16,
                                                           c0 + np * 16, lane));
                cc::mma16816<T>(acc[2 * np], pa[kk], bv[0], bv[1]);
                cc::mma16816<T>(acc[2 * np + 1], pa[kk], bv[2], bv[3]);
              }
            }
          }
        }
      }
      cc::store_tile<T, kCols / 8>(acc, stage, ob, (size_t)D, q0, L, c0, n_tiles,
                                   1.f, lane);
    }
  }
}

// q, k, v of one (sample, head) into a stage, by cp.async (not waited for)
template <typename T>
__device__ __forceinline__ void load_head(T* dst, const T* __restrict__ qkv, int item,
                                          int L, int Lp, int ld, int H, int hd) {
  const int D = H * hd;
  const size_t row = 3 * (size_t)D;
  const T* base = qkv + (size_t)(item / H) * L * row + (size_t)(item % H) * hd;
  const int tile = Lp * ld;
  cc::load_rows(dst, ld, base, row, L, Lp, hd);
  cc::load_rows(dst + tile, ld, base + D, row, L, Lp, hd);
  cc::load_rows(dst + 2 * tile, ld, base + 2 * D, row, L, Lp, hd);
}

// Persistent: a grid of as many CTAs as fit on the card at once walks the
// B*H (sample, head) items; with two stages it loads the next item's q, k,
// v while it computes this one's.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_mma_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                         T* __restrict__ out, int n_items, int L, int H, int hd,
                         float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Lp = pad16(L), ld = hd + kPad, stage_elems = 3 * Lp * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* stage = reinterpret_cast<T*>(smem) + warp * kStage;
  T* buf = reinterpret_cast<T*>(smem) + kWarps * kStage;
  const bool two = mma_stages(L, hd, sizeof(T)) == 2;
  const int D = H * hd;

  int item = blockIdx.x;
  if (item < n_items) load_head(buf, qkv, item, L, Lp, ld, H, hd);
  cc::cp_async_commit();
  for (int it = 0; item < n_items; ++it, item += gridDim.x) {
    const int next = item + gridDim.x;
    const T* cur = buf + (two ? (it & 1) * stage_elems : 0);
    if (two && next < n_items)
      load_head(buf + ((it + 1) & 1) * stage_elems, qkv, next, L, Lp, ld, H, hd);
    cc::cp_async_commit();
    cc::cp_async_wait<1>();     // this item's loads, not the next one's
    __syncthreads();
    T* ob = out + (size_t)(item / H) * L * D + (size_t)(item % H) * hd;
    attend<T>(cur, cur + Lp * ld, cur + 2 * Lp * ld, stage, ob, L, Lp, ld, hd, D, scale,
              mask, warp, lane);
    __syncthreads();            // before the stage is loaded again
    if (!two && next < n_items) load_head(buf, qkv, next, L, Lp, ld, H, hd);
    cc::cp_async_commit();
  }
}

template <typename T>
int launch_mma(const void* qkv, const void* mask, void* out, int B, int L, int H,
               int hd, float scale, cudaStream_t stream) {
  if (hd % 16 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = mma_smem(L, hd, sizeof(T));
  const void* kernel = (const void*)attention_fwd_mma_kernel<T>;
  int err = set_smem(kernel, smem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                kWarps * 32, smem)))
    return err;
  const int n_items = B * H;
  const int grid = min(n_items, max(1, sms * per_sm));
  attention_fwd_mma_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask),
      static_cast<T*>(out), n_items, L, H, hd, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------ bf16 / fp16, L > 128 (long)
using cc::kTile;
constexpr int kLongCtas = 4;       // CTAs per SM the register budget aims at

// shared memory (T): the CTA's 64 query rows, a ring of two stages of K
// and V tiles of 64 rows (rows hd + 8 apart), one [16][72] staging tile
// per warp: 55 296 bytes at hd = 64
__host__ __device__ inline size_t long_smem(int hd, size_t elem) {
  return ((size_t)(1 + 2 * cc::kRing) * kTile * (hd + kPad) + kWarps * kStage) * elem;
}

// One CTA per (sample, head, block of 64 query rows); an item's blocks are
// neighbours in launch order, so its K and V come from device memory about
// once and otherwise from L2.  The q block is staged once, scaled and
// rounded to T in place.  K (pass 1) and K, V (pass 2, once per 64 head
// channels) stream through a two-stage cp.async ring of 64-row tiles: step
// s + 1 loads while step s computes.  Pass 1 finds each row's max m and sum
// l over all key tiles, pass 2 recomputes S and runs O = P.V with
// P = exp(S - m) / l rounded to T (the arithmetic of `attend`; exp as
// cc::exp2_scaled).  Keys are masked only in a tile that reaches past L or
// under a mask.
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32, kLongCtas)
attention_fwd_long_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                          T* __restrict__ out, int L, int H, int hd_arg, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = HD ? HD : hd_arg;         // HD: a head_dim compiled in, else 0
  const int Lp = pad16(L), ld = hd + kPad, tile = kTile * ld;
  const int n_kt = (L + kTile - 1) / kTile;
  const int item = blockIdx.x / n_kt, r0 = (blockIdx.x % n_kt) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = r0 + warp * 16;           // the warp's first query row
  const bool active = q0 < Lp;
  T* sq = reinterpret_cast<T*>(smem);
  T* ring = sq + tile;                     // stage s: K at ring + 2 s tile, V next
  T* stage = ring + 2 * cc::kRing * tile + warp * kStage;
  const int D = H * hd;
  const size_t row = 3 * (size_t)D;
  const T* base = qkv + (size_t)(item / H) * L * row + (size_t)(item % H) * hd;
  T* ob = out + (size_t)(item / H) * L * D + (size_t)(item % H) * hd;
  const int n_steps = n_kt * (1 + (hd + kCols - 1) / kCols);

  auto prefetch = [&](int s) {
    if (s < n_steps) {
      T* st = ring + (s % cc::kRing) * 2 * tile;
      const int k0 = (s % n_kt) * kTile;
      cc::load_tile(st, ld, base + D, row, k0, L, Lp, hd);
      if (s >= n_kt) cc::load_tile(st + tile, ld, base + 2 * D, row, k0, L, Lp, hd);
    }
    cc::cp_async_commit();
  };
  cc::load_tile(sq, ld, base, row, r0, L, Lp, hd);
  for (int s = 0; s < cc::kRing - 1; ++s) prefetch(s);

  // per row (two per thread: g and g + 8): the running max m and the
  // quad-local part of l; after pass 1 m log2 e and 1 / l
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2], mlog[2];
  float acc[kCols / 8][4];
  for (int s = 0; s < n_steps; ++s) {
    cc::cp_async_wait<cc::kRing - 2>();   // step s's tiles (and q)
    if (s == 0) cc::scale_rows(sq, ld, min(kTile, L - r0), hd, scale);
    __syncthreads();
    prefetch(s + cc::kRing - 1);           // into the stage step s - 1 used
    const T* sk = ring + (s % cc::kRing) * 2 * tile;
    const T* sv = sk + tile;
    const int kt = s % n_kt, k0 = kt * kTile;
    const int n_live = min(kKeys, Lp - k0) / 8;     // n-tiles of keys before Lp
    if (active) {
      float sc[kKeys / 8][4];
      cc::tile_product<T>(sc, sq, warp * 16, sk, ld, hd, Lp - k0, lane);
      if (mask != nullptr || k0 + kTile > L) cc::mask_tile(sc, q0, k0, L, mask, lane);
      if (s < n_kt) {
        // pass 1
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float cm = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < kKeys / 8; ++nt)
            cm = fmaxf(cm, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
          const float mn = fmaxf(m[r], cc::quad_max(cm));
          const float nlog = finite_ref(mn) * cc::kLog2e;
          float sum = 0.f;
#pragma unroll
          for (int nt = 0; nt < kKeys / 8; ++nt)
            if (nt < n_live)
              sum += cc::exp2_scaled(sc[nt][2 * r], nlog)
                     + cc::exp2_scaled(sc[nt][2 * r + 1], nlog);
          l[r] = l[r] * cc::exp2_scaled(m[r], nlog) + sum;     // 0 * l while m is -inf
          m[r] = mn;
        }
        if (kt == n_kt - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            inv[r] = 1.f / cc::quad_sum(l[r]);
            mlog[r] = finite_ref(m[r]) * cc::kLog2e;
          }
        }
      } else {
        // pass 2: O[:, c0 .. c0 + 63] += P . V over this key tile, with
        // P = exp(S - m) / l rounded to T in its A fragments
        const int c0 = (s / n_kt - 1) * kCols;
        const int n_tiles = min(kCols, hd - c0) / 8;
        if (kt == 0) {
#pragma unroll
          for (int nt = 0; nt < kCols / 8; ++nt)
            acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
        }
#pragma unroll
        for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[nt][e] = nt < n_live ? cc::exp2_scaled(sc[nt][e], mlog[e >> 1]) : 0.f;
        uint32_t pa[kKeys / 16][4];
        probs<T>(pa, sc, inv);
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          if (k0 + kk * 16 < Lp) {
#pragma unroll
            for (int np = 0; np < kCols / 16; ++np) {
              if (2 * np < n_tiles) {
                uint32_t bv[4];
                cc::ldmatrix_x4_trans(bv, cc::trans_b_pair(sv, ld, kk * 16, c0 + np * 16,
                                                           lane));
                cc::mma16816<T>(acc[2 * np], pa[kk], bv[0], bv[1]);
                cc::mma16816<T>(acc[2 * np + 1], pa[kk], bv[2], bv[3]);
              }
            }
          }
        }
        if (kt == n_kt - 1)
          cc::store_tile<T, kCols / 8>(acc, stage, ob, (size_t)D, q0, L, c0, n_tiles, 1.f,
                                       lane);
      }
    }
  }
}

// the kernel for this head_dim: compiled for ViT's 64, else the generic one
template <typename T>
const void* long_kernel(int hd) {
  return hd == 64 ? (const void*)attention_fwd_long_kernel<T, 64>
                  : (const void*)attention_fwd_long_kernel<T, 0>;
}

template <typename T>
int launch_long(const void* qkv, const void* mask, void* out, int B, int L, int H,
                int hd, float scale, cudaStream_t stream) {
  if (hd % 16 != 0 || L < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = long_smem(hd, sizeof(T));
  const int err = set_smem(long_kernel<T>(hd), smem);
  if (err) return err;
  const long long grid = (long long)B * H * ((L + kTile - 1) / kTile);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const T* q = static_cast<const T*>(qkv);
  const float* mk = static_cast<const float*>(mask);
  T* o = static_cast<T*>(out);
  if (hd == 64)
    attention_fwd_long_kernel<T, 64><<<(unsigned)grid, kWarps * 32, smem, stream>>>(
        q, mk, o, L, H, hd, scale);
  else
    attention_fwd_long_kernel<T, 0><<<(unsigned)grid, kWarps * 32, smem, stream>>>(
        q, mk, o, L, H, hd, scale);
  return (int)cudaGetLastError();
}

// --------------------------------- fp32 (tensor cores, three TF32 passes)
namespace f32 = cc::f32;
constexpr int kF32Keys = 32;       // keys per ring stage
constexpr int kF32Ctas = 4;        // CTAs per SM at hd <= 64 (one past 64)

// shared memory (fp32): the CTA's 64 raw q rows and a ring of two stages,
// each one kF32Keys-row tile of K or V as its hi and lo halves: 52 224
// bytes at hd = 64
__host__ __device__ inline size_t tf32x3_smem(int hd) {
  return (size_t)(kTile + 2 * cc::kRing * kF32Keys) * f32::ld_rows(hd) * sizeof(float);
}

// One CTA per (sample, head, block of 64 query rows), an item's blocks
// neighbours in launch order (K and V from L2 after the first); each warp
// owns 16 query rows.  The steps alternate a key tile's K (S = qs.K^T and
// the online softmax: the running max m, l = sum exp(s - m) and O rescaled
// when m grows, P = exp(S - m) in fp32 registers) and its V (O += P.V), so
// one ring stage holds one split tile.  A key tile at the end is cut to a
// multiple of 8 keys.  After the last tile O / l is written and, where
// `lse` is not null, each row's log-sum-exp m + ln l ([B*H][L], fp32) for
// the backward.  NG: 64-channel groups of O in registers (1 or 2).
template <int HD, int NG>
__global__ void __launch_bounds__(kWarps * 32, NG == 1 ? kF32Ctas : 1)
attention_fwd_tf32x3_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                            float* __restrict__ out, float* __restrict__ lse, int L, int H,
                            int hd_arg, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = HD ? HD : hd_arg;         // HD: a head_dim compiled in, else 0
  constexpr int KT = kF32Keys;
  const int hp = f32::pad8(hd), ld = hp + 4, tile = KT * ld;
  const int n_kt = (L + kTile - 1) / kTile;
  const int item = blockIdx.x / n_kt, r0 = (blockIdx.x % n_kt) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = r0 + warp * 16;           // the warp's first query row
  const bool active = q0 < L;
  float* sq = reinterpret_cast<float*>(smem);
  float* ring = sq + kTile * ld;           // stage s: hi at ring + 2 s tile, lo next
  const int D = H * hd;
  const size_t row = 3 * (size_t)D;
  const float* base = qkv + (size_t)(item / H) * L * row + (size_t)(item % H) * hd;
  const bool vec = f32::vec_ok(qkv, hd);
  const int n_steps = 2 * ((L + KT - 1) / KT);   // step s: K (s even) or V of key tile s / 2

  auto prefetch = [&](int s) {
    const int k0 = (s >> 1) * KT;
    if (s < n_steps)
      f32::load_tile<KT>(ring + (s % cc::kRing) * 2 * tile, ld, base + (1 + (s & 1)) * D,
                         row, k0, L, hd, vec, f32::live_rows<KT>(k0, L));
    cc::cp_async_commit();
  };
  f32::load_tile<kTile>(sq, ld, base, row, r0, L, hd, vec);
  prefetch(0);

  // per row (two a thread: g and g + 8): the running max and the
  // quad-local part of l
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[8 * NG][4], p[KT / 8][4];
#pragma unroll
  for (int ct = 0; ct < 8 * NG; ++ct) o[ct][0] = o[ct][1] = o[ct][2] = o[ct][3] = 0.f;
  for (int s = 0; s < n_steps; ++s) {
    cc::cp_async_wait<0>();                // step s's tile (and q)
    if (s == 0) f32::scale_tile<kTile>(sq, ld, hd, scale);
    float* hi = ring + (s % cc::kRing) * 2 * tile;
    const int k0 = (s >> 1) * KT;
    f32::split_tile<KT>(hi, hi + tile, ld, hd, 1.f, f32::live_rows<KT>(k0, L));
    __syncthreads();
    prefetch(s + 1);                       // into the stage step s - 1 used
    const int n8 = (min(KT, L - k0) + 7) / 8;       // 8-key tiles before L
    if (!active) continue;
    if (!(s & 1)) {
      if (n8 == KT / 8)
        f32::rows_product<KT / 8, true>(p, sq + warp * 16 * ld, hi, hi + tile, ld, hp, n8,
                                        lane);
      else
        f32::rows_product<KT / 8, false>(p, sq + warp * 16 * ld, hi, hi + tile, ld, hp, n8,
                                         lane);
      if (mask != nullptr || k0 + KT > L) f32::mask_scores(p, q0, k0, L, mask, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float cm = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt)
          if (nt < n8) cm = fmaxf(cm, fmaxf(p[nt][2 * r], p[nt][2 * r + 1]));
        const float mn = fmaxf(m[r], cc::quad_max(cm));
        const float nlog = finite_ref(mn) * cc::kLog2e;
        const float shrink = cc::exp2_scaled(m[r], nlog);      // 0 while m is -inf
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = p[nt][2 * r + c];
            x = nt < n8 ? cc::exp2_scaled(x, nlog) : 0.f;
            sum += x;
          }
        l[r] = l[r] * shrink + sum;
        m[r] = mn;
#pragma unroll
        for (int ct = 0; ct < 8 * NG; ++ct) {
          o[ct][2 * r] *= shrink;
          o[ct][2 * r + 1] *= shrink;
        }
      }
    } else {
      if (n8 == KT / 8)
        f32::cols_product<8 * NG, KT / 8, true>(o, p, hi, hi + tile, ld, hp, n8, lane);
      else
        f32::cols_product<8 * NG, KT / 8, false>(o, p, hi, hi + tile, ld, hp, n8, lane);
    }
  }
  if (!active) return;
  float inv[2];
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = cc::quad_sum(l[r]);
    inv[r] = 1.f / sum;
    const int i = q0 + g + 8 * r;
    if (lse != nullptr && t == 0 && i < L)
      lse[(size_t)item * L + i] = finite_ref(m[r]) + logf(sum);
  }
  f32::store_rows<8 * NG>(o, out + (size_t)(item / H) * L * D + (size_t)(item % H) * hd,
                          (size_t)D, q0, L, hd, inv, lane);
}

// the kernel for this head_dim: compiled for ViT's 64, else a generic one
// with one or two 64-channel groups of O
const void* tf32x3_kernel(int hd) {
  return hd == 64 ? (const void*)attention_fwd_tf32x3_kernel<64, 1>
         : hd <= 64 ? (const void*)attention_fwd_tf32x3_kernel<0, 1>
                    : (const void*)attention_fwd_tf32x3_kernel<0, 2>;
}

int launch_tf32x3(const float* qkv, const float* mask, float* out, float* lse, int B, int L,
                  int H, int hd, float scale, cudaStream_t stream) {
  if (L < 1 || hd < 1 || hd > 128) return (int)cudaErrorInvalidValue;
  const size_t smem = tf32x3_smem(hd);
  const long long grid = (long long)B * H * ((L + kTile - 1) / kTile);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const void* kernel = tf32x3_kernel(hd);
  const int err = set_smem(kernel, smem);
  if (err) return err;
  void* args[] = {&qkv, &mask, &out, &lse, &L, &H, &hd, &scale};
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)grid), dim3(kWarps * 32), args, smem,
                               stream);
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA of each variant needs (the wrapper checks
// them against the card's opt-in limit before launching).
size_t cc_attention_mma_smem_bytes(int L, int hd, int elem_bytes) {
  return mma_smem(L, hd, (size_t)elem_bytes);
}

size_t cc_attention_simt_smem_bytes(int L, int hd) { return simt_smem(L, hd); }

size_t cc_attention_long_smem_bytes(int L, int hd, int elem_bytes) {
  (void)L;
  return long_smem(hd, (size_t)elem_bytes);
}

// Registers per thread, shared-memory bytes per CTA and resident CTAs per
// SM (out[0..2]) of the long variant's kernel for head_dim hd and dtype
// (1 bfloat16, 2 float16).
int cc_attention_fwd_long_occupancy(int hd, int dtype, int* out) {
  switch (dtype) {
    case 1:
      return cc::occupancy(long_kernel<__nv_bfloat16>(hd), long_smem(hd, 2), out);
    case 2:
      return cc::occupancy(long_kernel<__half>(hd), long_smem(hd, 2), out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Long-sequence tensor-core variant (L > 128).  dtype: 1 bfloat16,
// 2 float16; hd % 16 == 0; qkv and out 16-byte aligned.  mask may be null.
int cc_attention_fwd_long(const void* qkv, const void* mask, void* out, int B, int L,
                          int H, int hd, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch_long<__nv_bfloat16>(qkv, mask, out, B, L, H, hd, scale, s);
    case 2: return launch_long<__half>(qkv, mask, out, B, L, H, hd, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Tensor-core variant.  dtype: 1 bfloat16, 2 float16; hd % 16 == 0; qkv and
// out 16-byte aligned.  mask may be null.
int cc_attention_fwd_mma(const void* qkv, const void* mask, void* out, int B, int L,
                         int H, int hd, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch_mma<__nv_bfloat16>(qkv, mask, out, B, L, H, hd, scale, s);
    case 2: return launch_mma<__half>(qkv, mask, out, B, L, H, hd, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// CUDA-core variant, float32.  mask may be null.
int cc_attention_fwd_simt(const void* qkv, const void* mask, void* out, int B, int L,
                          int H, int hd, float scale, void* stream) {
  const size_t smem = simt_smem(L, hd);
  const int err = set_smem((const void*)attention_fwd_kernel, smem);
  if (err) return err;
  attention_fwd_kernel<<<B * H, kSimtThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(mask),
      static_cast<float*>(out), L, H, hd, scale);
  return (int)cudaGetLastError();
}

size_t cc_attention_tf32x3_smem_bytes(int L, int hd) {
  (void)L;
  return tf32x3_smem(hd);
}

// Registers per thread, shared-memory bytes per CTA and resident CTAs per
// SM (out[0..2]) of the fp32 tensor-core variant's kernel for head_dim hd.
int cc_attention_fwd_tf32x3_occupancy(int hd, int* out) {
  return cc::occupancy(tf32x3_kernel(hd), tf32x3_smem(hd), out);
}

// fp32 tensor-core variant (three TF32 passes): 1 <= hd <= 128, any L >= 1.
// mask may be null; lse, where not null, receives each row's log-sum-exp
// ([B * H][L] fp32) for the backward.
int cc_attention_fwd_tf32x3(const void* qkv, const void* mask, void* out, void* lse, int B,
                            int L, int H, int hd, float scale, void* stream) {
  return launch_tf32x3(static_cast<const float*>(qkv), static_cast<const float*>(mask),
                       static_cast<float*>(out), static_cast<float*>(lse), B, L, H, hd,
                       scale, static_cast<cudaStream_t>(stream));
}

const char* cc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
