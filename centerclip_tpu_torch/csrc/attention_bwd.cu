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
// Four variants, chosen by the wrapper from dtype, head_dim and L:
//
// * attention_bwd_mma_kernel (bf16 / fp16, hd % 16 == 0, L <= 128): tensor
//   cores, one CTA of 4 warps per (sample, head).  qs, k, v and dO rows come
//   in by 16-byte cp.async into shared tiles of row stride hd + 8, the
//   sequence padded to a multiple of 16 with zero rows.
//   Query rows: each warp owns 16 of them and computes S = qs.K^T and
//   dP = dO.V^T by mma.m16n8k16 over the whole (padded) key range, in
//   registers; the softmax, delta = rowsum(dP * P) and dS = P (dP - delta)
//   in fp32 registers (quad shuffles per row); and dQ = hd^-0.5 dS.K in the
//   same warp, dS going from C registers to A fragments.  dS is an mma
//   operand as the pair dS_hi = T(dS), dS_lo = T(dS - dS_hi) with two mmas
//   per product, which keeps the plain version's fp32 dS to about 2^-16
//   (one T(dS) would round it to 2^-8).  The warp writes P (as T) and
//   dS_hi, dS_lo to shared memory.
//   Key rows, after one barrier: each warp owns 16 key rows and computes
//   dV = P_T^T . dO and dK = dS^T . qs, the transposed operands through
//   ldmatrix.trans.  Every sum runs in a fixed order and dq, dk, dv take no
//   atomics, so the kernel is deterministic (training resumes bit for bit).
//   Outputs go out as T through a per-warp staging tile, 16 bytes a store.
//   Bound on this card: the five [L, L, hd] products are ~10*L*hd flops per
//   element moved, far below the ~295 flop/byte ridge of an H100, so the
//   kernel is bound by reading q, k, v, dO and writing dq, dk, dv once; the
//   design keeps every [L, L] intermediate on chip.  S and dP of a warp's
//   rows are held whole in registers, which caps L at 128 (two register
//   widths, 64 and 128 keys, are compiled).
// * the long variant (bf16 / fp16, hd % 16 == 0, L > 128: ViT-B/16's 197
//   tokens, and 1 + K after its cluster layer, up to 1 + 784 for segments
//   of 4 frames): the same
//   arithmetic with no [L, L] row and no whole head held anywhere, in two
//   launches of 4-warp CTAs that stream 64-row tiles through a cp.async
//   ring.  attention_bwd_dq_kernel takes (item, 64 query rows): pass 1 over
//   the key tiles computes S and dP and keeps, per row, the running max m,
//   l = sum exp(s - m) and a = sum exp(s - m) dP (both rescaled when m
//   grows), which give the softmax's max and sum and delta = rowsum(dP * P)
//   = a / l, written as fp32 scratch for the second launch; pass 2
//   recomputes S and dP, forms P and dS = P (dP - delta) and accumulates
//   dQ = hd^-0.5 dS.K (dS as the hi/lo pair) in registers.
//   attention_bwd_dkv_kernel takes (item, 64 keys): it stages K and V of its
//   tile, streams qs, dO and the statistics of 64 query rows at a time, and
//   per warp of 16 keys computes S^T = K.qs^T and dP^T = V.dO^T, then P^T
//   and dS^T, then dV += T(P)^T.dO and dK += dS^T.qs, the C tiles becoming
//   A fragments in registers.  delta is not taken from the rounded forward
//   output (rowsum(dO * O) would move dS by about 2^-8).  Each kernel needs
//   64-66 KB of shared memory whatever L (only the statistics scratch, 12
//   bytes a query row, grows with it) and at most 168 registers a thread,
//   so 3 CTAs (12 warps) are resident per SM (a CTA holding a whole
//   (sample, head) needs ~140 KB at L = 197, one per SM).  S and
//   dP are still computed three times (twice in the first launch, once in
//   the second): 11 products of 2 L^2 hd flops per head, ~1.0 Tflop for
//   ViT-B/16's 1536 x 12 heads at L = 197, ~1.0 ms at the H100's dense bf16
//   peak, about the 0.97 ms its bytes take.  Sums run in a fixed order and
//   nothing is atomic: deterministic.  No mask gradient (only the text
//   tower has a mask, at L <= 77).
// * attention_bwd_kernel (fp32, short: "cuda_core"): CUDA cores, the
//   products as fmaf loops from shared memory, P and dS as fp32 [L, L]
//   tiles in shared memory: 5 L hd + 2 L^2 floats, which past L = 108
//   (hd = 64) no CTA can hold.  Kept for head_dim > 128 and for the lengths
//   where the card shows it faster.  The one fp32 variant with a mask
//   gradient.
// * the fp32 tensor-core variant ("tf32x3": attention_bwd_tf32x3_dq_kernel,
//   then attention_bwd_tf32x3_dkv_kernel; any L, hd <= 128): every product
//   in three TF32 passes on the tensor cores (csrc/f32_tile.cuh), no
//   statistics pass.  The forward's tf32x3 kernel hands over each row's
//   log-sum-exp and its fp32 output O, so P = exp(S - lse) needs no max or
//   sum, and delta = rowsum(dO * O) (in exact arithmetic rowsum(dP * P);
//   the bf16 variants cannot take it, their O is rounded).  Launch 1,
//   (item, 64 query rows): delta, then per stage of 32 keys its V and its
//   K: S, dP -> P, dS -> dQ (3 products); launch 2, (item, 64 keys),
//   query rows 16 a step: S^T, dP^T -> P^T, dS^T -> dV, dK (4 products):
//   7 products where the earlier FFMA design took 9.  70 KB of shared
//   memory at hd = 64 each and 168 / 166 registers: 3 CTAs an SM (which
//   the card ran faster than 64-key stages / 32-row steps at 2).  Sums in
//   a fixed order, no atomics: deterministic.  No mask gradient.
//   Measured on an H100 against the plain version: at most 0.10 of the
//   1e-4 + 1e-4 |ref| tolerance (L = 785), 0.02-0.04 at ViT-B/16's 197.
//   Bound on this card: the five [L, L, hd] products the backward needs
//   are 10 L^2 hd flops a head, 30 L^2 hd TF32 flops in three passes,
//   against 28 L hd bytes: the TF32 rate bounds it past L ~ 100.
//
// The TPU kernel's sequential-grid accumulation of dmask has no counterpart
// here: CTAs add their dS into the fp32 [L, L] buffer with atomicAdd.
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

// shared memory: qs [L, hd], k^T [hd, L], k [L, hd], v^T [hd, L], dO [L, hd],
// then P and dP/dS, each [L, L], all fp32
__host__ __device__ inline size_t simt_smem(int L, int hd) {
  return (5 * (size_t)L * hd + 2 * (size_t)L * L) * sizeof(float);
}

__global__ void __launch_bounds__(kSimtThreads)
attention_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                     const float* __restrict__ dout, float* __restrict__ dqkv,
                     float* __restrict__ dmask, int L, int H, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = L * hd;
  float* sq = reinterpret_cast<float*>(smem);
  float* skt = sq + n;
  float* sk = skt + n;
  float* svt = sk + n;
  float* sdo = svt + n;
  float* sp = sdo + n;
  float* sds = sp + L * L;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int D = H * hd;
  const size_t row = 3 * (size_t)D;
  const float* base = qkv + (size_t)b * L * row + (size_t)h * hd;
  const float* dob = dout + (size_t)b * L * D + (size_t)h * hd;

  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int i = e / hd, d = e % hd;
    const float* r = base + i * row + d;
    sq[e] = r[0] * scale;
    const float kk = r[D];
    skt[d * L + i] = kk;
    sk[e] = kk;
    svt[d * L + i] = r[2 * D];
    sdo[e] = dob[(size_t)i * D + d];
  }
  __syncthreads();

  // logits and dP = dO . V^T
  for (int e = threadIdx.x; e < L * L; e += blockDim.x) {
    const int i = e / L, j = e % L;
    const float* qi = sq + i * hd;
    const float* gi = sdo + i * hd;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < hd; ++d) {
      s = fmaf(qi[d], skt[d * L + j], s);
      dp = fmaf(gi[d], svt[d * L + j], dp);
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
  float* gb = dqkv + (size_t)b * L * row + (size_t)h * hd;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int t = e / hd, d = e % hd;
    float dv = 0.f, dk = 0.f, dq = 0.f;
    for (int i = 0; i < L; ++i) {
      dv = fmaf(sp[i * L + t], sdo[i * hd + d], dv);
      dk = fmaf(sds[i * L + t], sq[i * hd + d], dk);
      dq = fmaf(sds[t * L + i], sk[i * hd + d], dq);
    }
    float* g = gb + t * row + d;
    g[0] = dq * scale;
    g[D] = dk;
    g[2 * D] = dv;
  }
}

// ----------------------------------------------------- bf16 / fp16 (mma)
constexpr int kWarps = 4;
constexpr int kCols = 64;          // head channels per register tile
constexpr int kStage = 16 * (kCols + kPad);
constexpr int kMaxL = 128;

// shared memory (T): qs, k, v, dO [Lp][hd + 8]; P, dS_hi, dS_lo
// [Lp][Lp + 8]; one [16][72] staging tile per warp
__host__ __device__ inline size_t mma_smem(int L, int hd, size_t elem) {
  const size_t Lp = pad16(L);
  return (4 * Lp * (hd + kPad) + 3 * Lp * (Lp + kPad) + kWarps * kStage) * elem;
}

// x as T(x) (hi) and T(x - hi) (lo), two values packed per register
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = cc::pack2<T>(x0, x1);
  lo = cc::pack2<T>(x0 - cc::to_f<T>(cc::from_f<T>(x0)),
                    x1 - cc::to_f<T>(cc::from_f<T>(x1)));
}

template <typename T, int LPT>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_mma_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                         const T* __restrict__ dout, T* __restrict__ dqkv,
                         float* __restrict__ dmask, int L, int H, int hd, float scale) {
  constexpr int NT = LPT / 8;      // key n-tiles held in registers
  extern __shared__ __align__(16) unsigned char smem[];
  const int Lp = pad16(L), ld = hd + kPad, lds = Lp + kPad;
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + Lp * ld;
  T* sv = sk + Lp * ld;
  T* sdo = sv + Lp * ld;
  T* sp = sdo + Lp * ld;
  T* sdh = sp + Lp * lds;
  T* sdl = sdh + Lp * lds;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* stage = sdl + Lp * lds + warp * kStage;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int D = H * hd;
  const size_t row = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * L * row + (size_t)h * hd;
  cc::load_rows(sq, ld, base, row, L, Lp, hd);
  cc::load_rows(sk, ld, base + D, row, L, Lp, hd);
  cc::load_rows(sv, ld, base + 2 * D, row, L, Lp, hd);
  cc::load_rows(sdo, ld, dout + (size_t)b * L * D + (size_t)h * hd, (size_t)D, L, Lp, hd);
  cc::cp_async_wait_all();
  __syncthreads();
  for (int e = threadIdx.x; e < L * hd; e += blockDim.x) {
    T* p = sq + (e / hd) * ld + e % hd;
    *p = cc::from_f<T>(cc::to_f<T>(*p) * scale);
  }
  __syncthreads();

  T* gb = dqkv + (size_t)b * L * row + (size_t)h * hd;

  // ------------------------------------------------ query rows, per warp
  for (int q0 = warp * 16; q0 < Lp; q0 += kWarps * 16) {
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    for (int ks = 0; ks < hd; ks += 16) {
      uint32_t aq[4], ag[4];
      cc::ldmatrix_x4(aq, cc::a_frag(sq, ld, q0, ks, lane));
      cc::ldmatrix_x4(ag, cc::a_frag(sdo, ld, q0, ks, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (np * 16 < Lp) {
          uint32_t bk[4], bv[4];
          cc::ldmatrix_x4(bk, cc::b_pair(sk, ld, np * 16, ks, lane));
          cc::mma16816<T>(s[2 * np], aq, bk[0], bk[1]);
          cc::mma16816<T>(s[2 * np + 1], aq, bk[2], bk[3]);
          cc::ldmatrix_x4(bv, cc::b_pair(sv, ld, np * 16, ks, lane));
          cc::mma16816<T>(dp[2 * np], ag, bv[0], bv[1]);
          cc::mma16816<T>(dp[2 * np + 1], ag, bv[2], bv[3]);
        }
      }
    }

    // mask, softmax and its VJP for the two rows this thread holds; rows
    // >= L (padding) get P = dS = 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + g + 8 * r;
      float m = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = nt * 8 + 2 * t + c;
          float& x = s[nt][2 * r + c];
          if (j >= L)
            x = -INFINITY;
          else if (mask != nullptr && i < L)
            x += mask[(size_t)i * L + j];
          m = fmaxf(m, x);
        }
      }
      m = cc::quad_max(m);
      const float ref = m == -INFINITY ? 0.f : m;
      float l = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[nt][2 * r + c];
          x = expf(x - ref);
          l += x;
        }
      l = cc::quad_sum(l);
      float dot = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[nt][2 * r + c];
          x = i < L ? x / l : 0.f;
          dot += dp[nt][2 * r + c] * x;
        }
      dot = cc::quad_sum(dot);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          dp[nt][2 * r + c] = s[nt][2 * r + c] * (dp[nt][2 * r + c] - dot);
    }

    // P as T and dS as (hi, lo) for the key-row products; dmask
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt * 8 < Lp) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = (q0 + g + 8 * r) * lds + nt * 8 + 2 * t;
          uint32_t hi, lo;
          split2<T>(dp[nt][2 * r], dp[nt][2 * r + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(sp + off) =
              cc::pack2<T>(s[nt][2 * r], s[nt][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(sdh + off) = hi;
          *reinterpret_cast<uint32_t*>(sdl + off) = lo;
        }
      }
    }
    if (dmask != nullptr) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + g + (e >> 1) * 8, j = nt * 8 + 2 * t + (e & 1);
          if (i < L && j < L) atomicAdd(dmask + (size_t)i * L + j, dp[nt][e]);
        }
    }

    // dQ = hd^-0.5 * dS . K, 64 channels at a time
    for (int c0 = 0; c0 < hd; c0 += kCols) {
      const int n_tiles = min(kCols, hd - c0) / 8;
      float acc[kCols / 8][4];
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        if (kk * 16 < Lp) {
          uint32_t ah[4], al[4];
          split2<T>(dp[2 * kk][0], dp[2 * kk][1], ah[0], al[0]);
          split2<T>(dp[2 * kk][2], dp[2 * kk][3], ah[1], al[1]);
          split2<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1], ah[2], al[2]);
          split2<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
          for (int np = 0; np < kCols / 16; ++np) {
            if (2 * np < n_tiles) {
              uint32_t bk[4];
              cc::ldmatrix_x4_trans(bk, cc::trans_b_pair(sk, ld, kk * 16, c0 + np * 16,
                                                         lane));
              cc::mma16816<T>(acc[2 * np], ah, bk[0], bk[1]);
              cc::mma16816<T>(acc[2 * np], al, bk[0], bk[1]);
              cc::mma16816<T>(acc[2 * np + 1], ah, bk[2], bk[3]);
              cc::mma16816<T>(acc[2 * np + 1], al, bk[2], bk[3]);
            }
          }
        }
      }
      cc::store_tile<T, kCols / 8>(acc, stage, gb, row, q0, L, c0, n_tiles, scale, lane);
    }
  }
  __syncthreads();

  // -------------------------------------------------- key rows, per warp
  for (int k0 = warp * 16; k0 < Lp; k0 += kWarps * 16) {
    for (int c0 = 0; c0 < hd; c0 += kCols) {
      const int n_tiles = min(kCols, hd - c0) / 8;
      float av[kCols / 8][4], ak[kCols / 8][4];
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) av[nt][e] = ak[nt][e] = 0.f;
      for (int i0 = 0; i0 < Lp; i0 += 16) {
        uint32_t ap[4], ah[4], al[4];
        cc::ldmatrix_x4_trans(ap, cc::trans_a(sp, lds, i0, k0, lane));
        cc::ldmatrix_x4_trans(ah, cc::trans_a(sdh, lds, i0, k0, lane));
        cc::ldmatrix_x4_trans(al, cc::trans_a(sdl, lds, i0, k0, lane));
#pragma unroll
        for (int np = 0; np < kCols / 16; ++np) {
          if (2 * np < n_tiles) {
            uint32_t bo[4], bq[4];
            cc::ldmatrix_x4_trans(bo, cc::trans_b_pair(sdo, ld, i0, c0 + np * 16, lane));
            cc::mma16816<T>(av[2 * np], ap, bo[0], bo[1]);
            cc::mma16816<T>(av[2 * np + 1], ap, bo[2], bo[3]);
            cc::ldmatrix_x4_trans(bq, cc::trans_b_pair(sq, ld, i0, c0 + np * 16, lane));
            cc::mma16816<T>(ak[2 * np], ah, bq[0], bq[1]);
            cc::mma16816<T>(ak[2 * np], al, bq[0], bq[1]);
            cc::mma16816<T>(ak[2 * np + 1], ah, bq[2], bq[3]);
            cc::mma16816<T>(ak[2 * np + 1], al, bq[2], bq[3]);
          }
        }
      }
      cc::store_tile<T, kCols / 8>(ak, stage, gb + D, row, k0, L, c0, n_tiles, 1.f, lane);
      cc::store_tile<T, kCols / 8>(av, stage, gb + 2 * D, row, k0, L, c0, n_tiles, 1.f,
                                   lane);
    }
  }
}

template <typename T, int LPT>
int launch_mma(const void* qkv, const void* mask, const void* dout, void* dqkv,
               void* dmask, int B, int L, int H, int hd, float scale,
               cudaStream_t stream) {
  const size_t smem = mma_smem(L, hd, sizeof(T));
  const int err = set_smem((const void*)attention_bwd_mma_kernel<T, LPT>, smem);
  if (err) return err;
  attention_bwd_mma_kernel<T, LPT><<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask),
      static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<float*>(dmask), L, H, hd, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_mma(const void* qkv, const void* mask, const void* dout, void* dqkv,
               void* dmask, int B, int L, int H, int hd, float scale,
               cudaStream_t stream) {
  if (hd % 16 != 0 || L < 1 || L > kMaxL) return (int)cudaErrorInvalidValue;
  if (L <= 64)
    return launch_mma<T, 64>(qkv, mask, dout, dqkv, dmask, B, L, H, hd, scale, stream);
  return launch_mma<T, 128>(qkv, mask, dout, dqkv, dmask, B, L, H, hd, scale, stream);
}

// ------------------------------------------ bf16 / fp16, L > 128 (long)
// Two launches, neither of which holds a whole head: the first takes
// (item, block of 64 query rows), the second (item, tile of 64 keys); each
// streams the other side's rows through a two-stage cp.async ring of
// 64-row tiles (step s + 1 loads while step s computes).
using cc::kTile;
constexpr int kLongCtas = 3;       // CTAs per SM the register budget aims at
constexpr int kHalf = 32;          // queries per register pass of the dK / dV kernel

// Shared memory (T) of the dQ kernel: q and dO of its block, a ring of two
// stages of K and V tiles, one [16][72] staging tile per warp (64 512 bytes
// at hd = 64); the dK / dV kernel stages K and V and rings q and dO, and
// adds the ring's fp32 row statistics (2 stages x 3 x 64; 66 048 bytes).
__host__ __device__ inline size_t dq_smem(int hd, size_t elem) {
  return ((size_t)(2 + 2 * cc::kRing) * kTile * (hd + kPad) + kWarps * kStage) * elem;
}
__host__ __device__ inline size_t dkv_smem(int hd, size_t elem) {
  return dq_smem(hd, elem) + cc::kRing * 3 * kTile * sizeof(float);
}

// Launch 1: one CTA per (sample, head, block of 64 query rows); q (scaled
// and rounded to T in place) and dO are staged once, K and V stream through
// the ring twice (pass 2 once per 64 head channels).  Pass 1: S = qs.K^T and
// dP = dO.V^T per key tile, and per row the running max m,
// l = sum exp(s - m) and a = sum exp(s - m) dP (both rescaled as m grows),
// which give the softmax and delta = rowsum(P dP) = a / l; the three go to
// `stats` ([3][B*H][64 * key tiles] fp32: m log2 e, m taken as 0 for a row
// that is all -inf; 1 / l; delta) for launch 2 (exp as cc::exp2_scaled).  Pass 2: S and dP again, P = exp(S - m) / l,
// dS = P (dP - delta), and dQ = hd^-0.5 dS.K with dS as the hi/lo pair, in
// registers.
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32, kLongCtas)
attention_bwd_dq_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                        const T* __restrict__ dout, T* __restrict__ dqkv,
                        float* __restrict__ stats, int n_items, int L, int H,
                        int hd_arg, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = HD ? HD : hd_arg;         // HD: a head_dim compiled in, else 0
  const int Lp = pad16(L), ld = hd + kPad, tile = kTile * ld;
  const int n_kt = (L + kTile - 1) / kTile, Ls = n_kt * kTile;
  const int item = blockIdx.x / n_kt, r0 = (blockIdx.x % n_kt) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = r0 + warp * 16;           // the warp's first query row
  const bool active = q0 < Lp;
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = sq + tile;
  T* ring = sdo + tile;                    // stage s: K at ring + 2 s tile, V next
  T* stage = ring + 2 * cc::kRing * tile + warp * kStage;
  const int D = H * hd;
  const size_t row = 3 * (size_t)D;
  const size_t first = (size_t)(item / H) * L, col = (size_t)(item % H) * hd;
  const T* base = qkv + first * row + col;
  T* gb = dqkv + first * row + col;
  const int n_steps = n_kt * (1 + (hd + kCols - 1) / kCols);

  auto prefetch = [&](int s) {
    if (s < n_steps) {
      T* st = ring + (s % cc::kRing) * 2 * tile;
      const int k0 = (s % n_kt) * kTile;
      cc::load_tile(st, ld, base + D, row, k0, L, Lp, hd);
      cc::load_tile(st + tile, ld, base + 2 * D, row, k0, L, Lp, hd);
    }
    cc::cp_async_commit();
  };
  cc::load_tile(sq, ld, base, row, r0, L, Lp, hd);
  cc::load_tile(sdo, ld, dout + first * D + col, (size_t)D, r0, L, Lp, hd);
  for (int s = 0; s < cc::kRing - 1; ++s) prefetch(s);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
  // after pass 1: m log2 e, 1 / l and delta per row
  float ref[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  float acc[kCols / 8][4];
  for (int s = 0; s < n_steps; ++s) {
    cc::cp_async_wait<cc::kRing - 2>();   // step s's tiles (and q, dO)
    if (s == 0) cc::scale_rows(sq, ld, min(kTile, L - r0), hd, scale);
    __syncthreads();
    prefetch(s + cc::kRing - 1);           // into the stage step s - 1 used
    const T* sk = ring + (s % cc::kRing) * 2 * tile;
    const T* sv = sk + tile;
    const int kt = s % n_kt, k0 = kt * kTile;
    const int n_live = min(kTile, Lp - k0) / 8;     // n-tiles of keys before Lp
    if (active) {
      float sc[kTile / 8][4], dp[kTile / 8][4];
      cc::tile_product<T>(sc, sq, warp * 16, sk, ld, hd, Lp - k0, lane);
      cc::tile_product<T>(dp, sdo, warp * 16, sv, ld, hd, Lp - k0, lane);
      if (mask != nullptr || k0 + kTile > L) cc::mask_tile(sc, q0, k0, L, mask, lane);
      if (s < n_kt) {
        // pass 1: per row (two per thread: g and g + 8) m, l and a
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float tmax = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < kTile / 8; ++nt)
            tmax = fmaxf(tmax, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
          const float mn = fmaxf(m[r], cc::quad_max(tmax));
          const float nlog = (mn == -INFINITY ? 0.f : mn) * cc::kLog2e;
          float ls = 0.f, as = 0.f;
#pragma unroll
          for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              if (nt < n_live) {
                const float x = cc::exp2_scaled(sc[nt][2 * r + c], nlog);
                ls += x;
                as += x * dp[nt][2 * r + c];
              }
            }
          const float shrink = cc::exp2_scaled(m[r], nlog);     // 0 while m is -inf
          l[r] = l[r] * shrink + cc::quad_sum(ls);
          a[r] = a[r] * shrink + cc::quad_sum(as);
          m[r] = mn;
        }
        if (kt == n_kt - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            ref[r] = (m[r] == -INFINITY ? 0.f : m[r]) * cc::kLog2e;
            inv[r] = 1.f / l[r];
            delta[r] = a[r] / l[r];
            if (t == 0) {
              const size_t i = (size_t)item * Ls + q0 + g + 8 * r;
              const size_t plane = (size_t)n_items * Ls;
              stats[i] = ref[r];
              stats[plane + i] = inv[r];
              stats[2 * plane + i] = delta[r];
            }
          }
        }
      } else {
        // pass 2: dQ[:, c0 .. c0 + 63] += dS . K over this key tile; rows
        // >= L (padding) get P = dS = 0
        const int c0 = (s / n_kt - 1) * kCols;
        const int n_tiles = min(kCols, hd - c0) / 8;
        if (kt == 0) {
#pragma unroll
          for (int nt = 0; nt < kCols / 8; ++nt)
            acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
        }
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = nt < n_live && q0 + g + 8 * r < L
                                ? cc::exp2_scaled(sc[nt][e], ref[r]) * inv[r] : 0.f;
            dp[nt][e] = p * (dp[nt][e] - delta[r]);
          }
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          if (k0 + kk * 16 < Lp) {
            uint32_t ah[4], al[4];
            split2<T>(dp[2 * kk][0], dp[2 * kk][1], ah[0], al[0]);
            split2<T>(dp[2 * kk][2], dp[2 * kk][3], ah[1], al[1]);
            split2<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1], ah[2], al[2]);
            split2<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
            for (int np = 0; np < kCols / 16; ++np) {
              if (2 * np < n_tiles) {
                uint32_t bk[4];
                cc::ldmatrix_x4_trans(bk, cc::trans_b_pair(sk, ld, kk * 16, c0 + np * 16,
                                                           lane));
                cc::mma16816<T>(acc[2 * np], ah, bk[0], bk[1]);
                cc::mma16816<T>(acc[2 * np], al, bk[0], bk[1]);
                cc::mma16816<T>(acc[2 * np + 1], ah, bk[2], bk[3]);
                cc::mma16816<T>(acc[2 * np + 1], al, bk[2], bk[3]);
              }
            }
          }
        }
        if (kt == n_kt - 1)
          cc::store_tile<T, kCols / 8>(acc, stage, gb, row, q0, L, c0, n_tiles, scale,
                                       lane);
      }
    }
  }
}

// Launch 2: one CTA per (sample, head, tile of 64 keys); K and V of its tile
// are staged once, and q (scaled and rounded to T on arrival, each thread
// on its own chunks), dO and the rows' statistics stream through the ring
// in blocks of 64 queries (once per 64 head channels).  Each warp owns 16
// keys: per 32 queries S^T = K.qs^T and dP^T = V.dO^T, then P^T and dS^T
// from the statistics, then dV += T(P)^T.dO and dK += dS^T.qs (dS as the
// hi/lo pair), the C tiles becoming A fragments in registers.  Every sum
// runs in a fixed order; nothing is atomic.
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32, kLongCtas)
attention_bwd_dkv_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                         const T* __restrict__ dout, T* __restrict__ dqkv,
                         const float* __restrict__ stats, int n_items, int L, int H,
                         int hd_arg, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = HD ? HD : hd_arg;
  const int Lp = pad16(L), ld = hd + kPad, tile = kTile * ld;
  const int n_kt = (L + kTile - 1) / kTile, Ls = n_kt * kTile;
  const int item = blockIdx.x / n_kt, j0 = (blockIdx.x % n_kt) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int jw = j0 + warp * 16;           // the warp's first key
  const bool active = jw < Lp;
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + tile;
  T* ring = sv + tile;                     // stage s: q at ring + 2 s tile, dO next
  float* sst = reinterpret_cast<float*>(ring + 2 * cc::kRing * tile);  // stage s: m, l, delta
  T* stage = reinterpret_cast<T*>(sst + 3 * cc::kRing * kTile) + warp * kStage;
  const int D = H * hd;
  const size_t row = 3 * (size_t)D;
  const size_t first = (size_t)(item / H) * L, col = (size_t)(item % H) * hd;
  const T* base = qkv + first * row + col;
  const T* dob = dout + first * D + col;
  T* gb = dqkv + first * row + col;
  const size_t plane = (size_t)n_items * Ls;
  const int n_steps = n_kt * ((hd + kCols - 1) / kCols);

  auto prefetch = [&](int s) {
    if (s < n_steps) {
      T* st = ring + (s % cc::kRing) * 2 * tile;
      const int i0 = (s % n_kt) * kTile;
      cc::load_tile(st, ld, base, row, i0, L, Lp, hd);
      cc::load_tile(st + tile, ld, dob, (size_t)D, i0, L, Lp, hd);
      for (int e = threadIdx.x; e < 3 * kTile; e += blockDim.x)
        cc::cp_async4(sst + (s % cc::kRing) * 3 * kTile + e,
                      stats + (e / kTile) * plane + (size_t)item * Ls + i0 + e % kTile);
    }
    cc::cp_async_commit();
  };
  cc::load_tile(sk, ld, base + D, row, j0, L, Lp, hd);
  cc::load_tile(sv, ld, base + 2 * D, row, j0, L, Lp, hd);
  for (int s = 0; s < cc::kRing - 1; ++s) prefetch(s);

  float av[kCols / 8][4], ak[kCols / 8][4];
  for (int s = 0; s < n_steps; ++s) {
    cc::cp_async_wait<cc::kRing - 2>();   // step s's rows (and K, V)
    T* sq = ring + (s % cc::kRing) * 2 * tile;
    const int qt = s % n_kt, i0 = qt * kTile;
    cc::scale_rows(sq, ld, min(kTile, L - i0), hd, scale);
    __syncthreads();
    prefetch(s + cc::kRing - 1);           // into the stage step s - 1 used
    const T* sdo = sq + tile;
    const float* rmax = sst + (s % cc::kRing) * 3 * kTile;
    const float* rinv = rmax + kTile;
    const float* rdelta = rinv + kTile;
    if (active) {
      const int c0 = (s / n_kt) * kCols;
      const int n_tiles = min(kCols, hd - c0) / 8;
      if (qt == 0) {
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) av[nt][e] = ak[nt][e] = 0.f;
      }
#pragma unroll
      for (int h0 = 0; h0 < kTile; h0 += kHalf) {
        if (i0 + h0 < Lp) {
          // S^T and dP^T of the warp's 16 keys (rows) and queries i0 + h0 ..
          float st[kHalf / 8][4], dpt[kHalf / 8][4];
#pragma unroll
          for (int nt = 0; nt < kHalf / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < hd; ks += 16) {
            uint32_t ak_[4], av_[4];
            cc::ldmatrix_x4(ak_, cc::a_frag(sk, ld, warp * 16, ks, lane));
            cc::ldmatrix_x4(av_, cc::a_frag(sv, ld, warp * 16, ks, lane));
#pragma unroll
            for (int np = 0; np < kHalf / 16; ++np) {
              if (i0 + h0 + np * 16 < Lp) {
                uint32_t bq[4], bo[4];
                cc::ldmatrix_x4(bq, cc::b_pair(sq, ld, h0 + np * 16, ks, lane));
                cc::mma16816<T>(st[2 * np], ak_, bq[0], bq[1]);
                cc::mma16816<T>(st[2 * np + 1], ak_, bq[2], bq[3]);
                cc::ldmatrix_x4(bo, cc::b_pair(sdo, ld, h0 + np * 16, ks, lane));
                cc::mma16816<T>(dpt[2 * np], av_, bo[0], bo[1]);
                cc::mma16816<T>(dpt[2 * np + 1], av_, bo[2], bo[3]);
              }
            }
          }
          // element (key j = jw + g + 8 (e / 2), query i = i0 + h0 + 8 nt +
          // 2 t + e % 2); statistics of rows past L are never read, and
          // only a block at the edge or under a mask checks
          const bool edge = mask != nullptr || i0 + h0 + kHalf > L || j0 + kTile > L;
#pragma unroll
          for (int nt = 0; nt < kHalf / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = jw + g + (e >> 1) * 8;
              const int il = h0 + nt * 8 + 2 * t + (e & 1), i = i0 + il;
              float p = 0.f, ds = 0.f;
              if (!edge || (i < L && j < L)) {
                float x = st[nt][e];
                if (mask != nullptr) x += mask[(size_t)i * L + j];
                p = cc::exp2_scaled(x, rmax[il]) * rinv[il];
                ds = p * (dpt[nt][e] - rdelta[il]);
              }
              st[nt][e] = p;
              dpt[nt][e] = ds;
            }
#pragma unroll
          for (int kk = 0; kk < kHalf / 16; ++kk) {
            if (i0 + h0 + kk * 16 < Lp) {
              const uint32_t ap[4] = {cc::pack2<T>(st[2 * kk][0], st[2 * kk][1]),
                                      cc::pack2<T>(st[2 * kk][2], st[2 * kk][3]),
                                      cc::pack2<T>(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                      cc::pack2<T>(st[2 * kk + 1][2], st[2 * kk + 1][3])};
              uint32_t ah[4], al[4];
              split2<T>(dpt[2 * kk][0], dpt[2 * kk][1], ah[0], al[0]);
              split2<T>(dpt[2 * kk][2], dpt[2 * kk][3], ah[1], al[1]);
              split2<T>(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1], ah[2], al[2]);
              split2<T>(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
              for (int np = 0; np < kCols / 16; ++np) {
                if (2 * np < n_tiles) {
                  uint32_t bo[4], bq[4];
                  cc::ldmatrix_x4_trans(bo, cc::trans_b_pair(sdo, ld, h0 + kk * 16,
                                                             c0 + np * 16, lane));
                  cc::mma16816<T>(av[2 * np], ap, bo[0], bo[1]);
                  cc::mma16816<T>(av[2 * np + 1], ap, bo[2], bo[3]);
                  cc::ldmatrix_x4_trans(bq, cc::trans_b_pair(sq, ld, h0 + kk * 16,
                                                             c0 + np * 16, lane));
                  cc::mma16816<T>(ak[2 * np], ah, bq[0], bq[1]);
                  cc::mma16816<T>(ak[2 * np], al, bq[0], bq[1]);
                  cc::mma16816<T>(ak[2 * np + 1], ah, bq[2], bq[3]);
                  cc::mma16816<T>(ak[2 * np + 1], al, bq[2], bq[3]);
                }
              }
            }
          }
        }
      }
      if (qt == n_kt - 1) {
        cc::store_tile<T, kCols / 8>(ak, stage, gb + D, row, jw, L, c0, n_tiles, 1.f, lane);
        cc::store_tile<T, kCols / 8>(av, stage, gb + 2 * D, row, jw, L, c0, n_tiles, 1.f,
                                     lane);
      }
    }
  }
}

// the kernels for this head_dim: compiled for ViT's 64, else the generic ones
template <typename T>
const void* dq_kernel(int hd) {
  return hd == 64 ? (const void*)attention_bwd_dq_kernel<T, 64>
                  : (const void*)attention_bwd_dq_kernel<T, 0>;
}
template <typename T>
const void* dkv_kernel(int hd) {
  return hd == 64 ? (const void*)attention_bwd_dkv_kernel<T, 64>
                  : (const void*)attention_bwd_dkv_kernel<T, 0>;
}

template <typename T>
int launch_long(const void* qkv, const void* mask, const void* dout, void* dqkv,
                void* stats, int B, int L, int H, int hd, float scale,
                cudaStream_t stream) {
  if (hd % 16 != 0 || L < 1) return (int)cudaErrorInvalidValue;
  int n_items = B * H;
  const long long grid = (long long)n_items * ((L + kTile - 1) / kTile);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const void* q = qkv;
  const void* mk = mask;
  const void* dout_ = dout;
  void* out = dqkv;
  void* st = stats;
  void* args[] = {&q, &mk, &dout_, &out, &st, &n_items, &L, &H, &hd, &scale};
  size_t smem = dq_smem(hd, sizeof(T));
  int err = set_smem(dq_kernel<T>(hd), smem);
  if (!err)
    err = (int)cudaLaunchKernel(dq_kernel<T>(hd), dim3((unsigned)grid), dim3(kWarps * 32),
                                args, smem, stream);
  if (err) return err;
  smem = dkv_smem(hd, sizeof(T));
  if ((err = set_smem(dkv_kernel<T>(hd), smem))) return err;
  return (int)cudaLaunchKernel(dkv_kernel<T>(hd), dim3((unsigned)grid), dim3(kWarps * 32),
                               args, smem, stream);
}

template <typename T>
int long_occupancy(int which, int hd, int* out) {
  if (which == 0) return cc::occupancy(dq_kernel<T>(hd), dq_smem(hd, sizeof(T)), out);
  return cc::occupancy(dkv_kernel<T>(hd), dkv_smem(hd, sizeof(T)), out);
}

// --------------------------------- fp32 (tensor cores, three TF32 passes)
// Two launches, as the long variant's, with no statistics pass: the
// forward (kernel A's tf32x3 variant) hands over each row's log-sum-exp
// and its output O, and delta = rowsum(dO * O) replaces rowsum(dP * P)
// (O is fp32 here, so nothing is rounded on the way).  Every product runs
// on the tensor cores in three TF32 passes (csrc/f32_tile.cuh).
namespace f32 = cc::f32;
constexpr int kF32Keys = 32;       // keys per ring stage of the dQ launch
constexpr int kQRows = 16;         // query rows per step of the dK / dV launch
constexpr int kDqCtas = 3;         // CTAs per SM at hd <= 64, each launch (one
constexpr int kDkvCtas = 3;        // past 64: more registers, twice the smem)

// shared memory (fp32) of the dQ launch: q (scaled) and dO of its 64 rows,
// raw, and a ring of two stages of one split kF32Keys-row tile (V or K):
// 69 632 bytes at hd = 64; of the dK / dV launch: K and V of its 64 keys,
// raw, and a ring of two stages of kQRows query rows' split q and dO with
// their log-sum-exp and delta: 69 888
__host__ __device__ inline size_t tf32x3_dq_smem(int hd) {
  return (size_t)(2 * kTile + 2 * cc::kRing * kF32Keys) * f32::ld_rows(hd) * sizeof(float);
}
__host__ __device__ inline size_t tf32x3_dkv_smem(int hd) {
  return ((size_t)(2 * kTile + cc::kRing * 4 * kQRows) * f32::ld_rows(hd)
          + cc::kRing * 2 * kQRows) * sizeof(float);
}

// Launch 1: one CTA per (sample, head, block of 64 query rows), 16 rows a
// warp.  First each row's delta = rowsum(dO * O) from O staged in the
// ring's second stage before its first use (two lanes a row, a fixed
// order; also written to `delta`, [B*H][L], for launch 2).  Then per key tile: its V
// (dP = dO.V^T, kept in registers), then its K (S = qs.K^T,
// P = exp(S - lse), dS = P (dP - delta), dQ += dS.K).  3 products a tile.
template <int HD, int NG>
__global__ void __launch_bounds__(kWarps * 32, NG == 1 ? kDqCtas : 1)
attention_bwd_tf32x3_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                               const float* __restrict__ dout, const float* __restrict__ out,
                               const float* __restrict__ lse, float* __restrict__ dqkv,
                               float* __restrict__ delta, int L, int H, int hd_arg,
                               float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = HD ? HD : hd_arg;
  constexpr int KT = kF32Keys;
  static_assert(2 * KT >= kTile, "the ring's second stage holds O's 64 rows");
  const int hp = f32::pad8(hd), ld = hp + 4, tile = kTile * ld, ktile = KT * ld;
  const int n_kt = (L + kTile - 1) / kTile;
  const int item = blockIdx.x / n_kt, r0 = (blockIdx.x % n_kt) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q0 = r0 + warp * 16;           // the warp's first query row
  const bool active = q0 < L;
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + tile;
  float* ring = sdo + tile;                // stage s: hi at ring + 2 s ktile, lo next
  const int D = H * hd;
  const size_t row = 3 * (size_t)D;
  const size_t first = (size_t)(item / H) * L, col = (size_t)(item % H) * hd;
  const float* base = qkv + first * row + col;
  const bool vec = f32::vec_ok(qkv, hd) && f32::vec_ok(dout, hd) && f32::vec_ok(out, hd);
  const int n_steps = 2 * ((L + KT - 1) / KT);  // step s: V (s even) or K of key tile s / 2

  auto prefetch = [&](int s) {
    const int k0 = (s >> 1) * KT;
    if (s < n_steps)
      f32::load_tile<KT>(ring + (s % cc::kRing) * 2 * ktile, ld, base + (2 - (s & 1)) * D,
                         row, k0, L, hd, vec, f32::live_rows<KT>(k0, L));
    cc::cp_async_commit();
  };
  f32::load_tile<kTile>(sq, ld, base, row, r0, L, hd, vec);
  f32::load_tile<kTile>(sdo, ld, dout + first * D + col, (size_t)D, r0, L, hd, vec);
  // O of the block into the ring's second stage (its 2 KT rows hold 64)
  f32::load_tile<kTile>(ring + 2 * ktile, ld, out + first * D + col, (size_t)D, r0, L, hd,
                        vec);
  prefetch(0);

  // per row (g and g + 8): lse log2 e and delta (0 past L)
  float ll[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + g + 8 * r;
    ll[r] = i < L ? lse[(size_t)item * L + i] * cc::kLog2e : 0.f;
  }
  float dq[8 * NG][4], dp[KT / 8][4], sc[KT / 8][4];
#pragma unroll
  for (int ct = 0; ct < 8 * NG; ++ct) dq[ct][0] = dq[ct][1] = dq[ct][2] = dq[ct][3] = 0.f;
  for (int s = 0; s < n_steps; ++s) {
    cc::cp_async_wait<0>();                // step s's tile (and q, dO)
    if (s == 0) f32::scale_tile<kTile>(sq, ld, hd, scale);
    float* hi = ring + (s % cc::kRing) * 2 * ktile;
    const int k0 = (s >> 1) * KT;
    f32::split_tile<KT>(hi, hi + ktile, ld, hd, 1.f, f32::live_rows<KT>(k0, L));
    __syncthreads();
    if (s == 0) {
      // delta of row q0 + lane / 2 over the channels of parity lane % 2,
      // the two halves added (either order gives the same bits); O is in
      // the second stage until prefetch(1)
      const int r = lane >> 1;
      const float* o_r = ring + 2 * ktile + (warp * 16 + r) * ld;
      const float* do_r = sdo + (warp * 16 + r) * ld;
      float sum = 0.f;
      for (int c = lane & 1; c < hd; c += 2) sum = fmaf(do_r[c], o_r[c], sum);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      dl[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
      dl[1] = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
      if (!(lane & 1) && q0 + r < L) delta[(size_t)item * L + q0 + r] = sum;
      __syncthreads();                     // every O row read
    }
    prefetch(s + 1);                       // into the stage step s - 1 used
    if (!active) continue;
    const int n8 = (min(KT, L - k0) + 7) / 8;       // 8-key tiles before L
    const bool full = n8 == KT / 8;
    if (!(s & 1)) {
      if (full)
        f32::rows_product<KT / 8, true>(dp, sdo + warp * 16 * ld, hi, hi + ktile, ld, hp, n8,
                                           lane);
      else
        f32::rows_product<KT / 8, false>(dp, sdo + warp * 16 * ld, hi, hi + ktile, ld, hp,
                                            n8, lane);
    } else {
      if (full)
        f32::rows_product<KT / 8, true>(sc, sq + warp * 16 * ld, hi, hi + ktile, ld, hp, n8,
                                           lane);
      else
        f32::rows_product<KT / 8, false>(sc, sq + warp * 16 * ld, hi, hi + ktile, ld, hp,
                                            n8, lane);
      if (mask != nullptr || k0 + KT > L) f32::mask_scores(sc, q0, k0, L, mask, lane);
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = nt < n8 ? cc::exp2_scaled(sc[nt][e], ll[e >> 1]) : 0.f;
          sc[nt][e] = pr * (dp[nt][e] - dl[e >> 1]);
        }
      if (full)
        f32::cols_product<8 * NG, KT / 8, true>(dq, sc, hi, hi + ktile, ld, hp, n8, lane);
      else
        f32::cols_product<8 * NG, KT / 8, false>(dq, sc, hi, hi + ktile, ld, hp, n8, lane);
    }
  }
  if (!active) return;
  const float mul[2] = {scale, scale};
  f32::store_rows<8 * NG>(dq, dqkv + first * row + col, row, q0, L, hd, mul, lane);
}

// Launch 2: one CTA per (sample, head, tile of 64 keys), 16 keys a warp.
// K and V of its keys are staged raw once; q (scaled), dO and the rows'
// log-sum-exp and delta stream through the ring kQRows query rows a step.
// Per step: S^T = K.qs^T and dP^T = V.dO^T in one loop, P^T =
// exp(S^T - lse) and dS^T = P^T (dP^T - delta) in registers (queries or
// keys at or past L give 0), then dV += P^T.dO and dK += dS^T.qs.  4
// products.  Every sum runs in a fixed order; nothing is atomic.
template <int HD, int NG>
__global__ void __launch_bounds__(kWarps * 32, NG == 1 ? kDkvCtas : 1)
attention_bwd_tf32x3_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                                const float* __restrict__ dout, const float* __restrict__ lse,
                                const float* __restrict__ delta, float* __restrict__ dqkv,
                                int L, int H, int hd_arg, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = HD ? HD : hd_arg;
  const int hp = f32::pad8(hd), ld = hp + 4, qtile = kQRows * ld;
  const int n_kt = (L + kTile - 1) / kTile, n_steps = (L + kQRows - 1) / kQRows;
  const int item = blockIdx.x / n_kt, j0 = (blockIdx.x % n_kt) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int jw = j0 + warp * 16;           // the warp's first key
  const bool active = jw < L;
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + kTile * ld;
  float* ring = sv + kTile * ld;           // stage s: q hi, q lo, dO hi, dO lo
  float* sst = ring + cc::kRing * 4 * qtile;   // stage s: lse log2 e, delta at sst + 64 s
  const int D = H * hd;
  const size_t row = 3 * (size_t)D;
  const size_t first = (size_t)(item / H) * L, col = (size_t)(item % H) * hd;
  const float* base = qkv + first * row + col;
  const float* dob = dout + first * D + col;
  const bool vec = f32::vec_ok(qkv, hd) && f32::vec_ok(dout, hd);

  auto prefetch = [&](int s) {
    if (s < n_steps) {
      float* stage = ring + (s % cc::kRing) * 4 * qtile;
      const int i0 = s * kQRows, rows = f32::live_rows<kQRows>(i0, L);
      f32::load_tile<kQRows>(stage, ld, base, row, i0, L, hd, vec, rows);
      f32::load_tile<kQRows>(stage + 2 * qtile, ld, dob, (size_t)D, i0, L, hd, vec, rows);
      const int e = threadIdx.x;           // one statistic a thread
      if (e < 2 * kQRows) {
        float* d = sst + (s % cc::kRing) * 2 * kQRows + e;
        const int i = i0 + e % kQRows;
        if (i < L)
          cc::cp_async4(d, (e < kQRows ? lse : delta) + (size_t)item * L + i);
        else
          *d = 0.f;
      }
    }
    cc::cp_async_commit();
  };
  f32::load_tile<kTile>(sk, ld, base + D, row, j0, L, hd, vec);
  f32::load_tile<kTile>(sv, ld, base + 2 * D, row, j0, L, hd, vec);
  prefetch(0);

  float dk[8 * NG][4], dv[8 * NG][4];
#pragma unroll
  for (int ct = 0; ct < 8 * NG; ++ct)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[ct][e] = dv[ct][e] = 0.f;
  for (int s = 0; s < n_steps; ++s) {
    cc::cp_async_wait<0>();                // step s's rows (and K, V)
    float* qh = ring + (s % cc::kRing) * 4 * qtile;     // q hi; q lo, dO hi, dO lo next
    float* rs = sst + (s % cc::kRing) * 2 * kQRows;
    const int rows = f32::live_rows<kQRows>(s * kQRows, L);
    f32::split_tile<kQRows>(qh, qh + qtile, ld, hd, scale, rows);
    f32::split_tile<kQRows>(qh + 2 * qtile, qh + 3 * qtile, ld, hd, 1.f, rows);
    if (threadIdx.x < kQRows) rs[threadIdx.x] *= cc::kLog2e;   // its own copy
    __syncthreads();
    prefetch(s + 1);                       // into the stage step s - 1 used
    if (!active) continue;
    const int i0 = s * kQRows;
    const int n8 = (min(kQRows, L - i0) + 7) / 8;   // 8-query tiles before L
    // element (key j = jw + g + 8 (e / 2), query i = i0 + 8 nt + 2 t + e % 2)
    float st[kQRows / 8][4], dpt[kQRows / 8][4];
    const bool full = n8 == kQRows / 8;
    if (full)
      f32::rows_product2<kQRows / 8, true>(st, sk + warp * 16 * ld, qh, qh + qtile, dpt,
                                           sv + warp * 16 * ld, qh + 2 * qtile,
                                           qh + 3 * qtile, ld, hp, n8, lane);
    else
      f32::rows_product2<kQRows / 8, false>(st, sk + warp * 16 * ld, qh, qh + qtile, dpt,
                                            sv + warp * 16 * ld, qh + 2 * qtile,
                                            qh + 3 * qtile, ld, hp, n8, lane);
    const bool edge = mask != nullptr || i0 + kQRows > L || j0 + kTile > L;
#pragma unroll
    for (int nt = 0; nt < kQRows / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = jw + g + (e >> 1) * 8;
        const int il = nt * 8 + 2 * t + (e & 1), i = i0 + il;
        float p = 0.f, ds = 0.f;
        if (nt < n8 && (!edge || (i < L && j < L))) {
          float x = st[nt][e];
          if (mask != nullptr) x += mask[(size_t)i * L + j];
          p = cc::exp2_scaled(x, rs[il]);
          ds = p * (dpt[nt][e] - rs[kQRows + il]);
        }
        st[nt][e] = p;
        dpt[nt][e] = ds;
      }
    if (full) {
      f32::cols_product<8 * NG, kQRows / 8, true>(dv, st, qh + 2 * qtile, qh + 3 * qtile, ld,
                                                  hp, n8, lane);
      f32::cols_product<8 * NG, kQRows / 8, true>(dk, dpt, qh, qh + qtile, ld, hp, n8, lane);
    } else {
      f32::cols_product<8 * NG, kQRows / 8, false>(dv, st, qh + 2 * qtile, qh + 3 * qtile, ld,
                                                   hp, n8, lane);
      f32::cols_product<8 * NG, kQRows / 8, false>(dk, dpt, qh, qh + qtile, ld, hp, n8, lane);
    }
  }
  if (!active) return;
  const float one[2] = {1.f, 1.f};
  float* gb = dqkv + first * row + col;
  f32::store_rows<8 * NG>(dk, gb + D, row, jw, L, hd, one, lane);
  f32::store_rows<8 * NG>(dv, gb + 2 * D, row, jw, L, hd, one, lane);
}

// the kernels for this head_dim: compiled for ViT's 64, else generic ones
// with one or two 64-channel groups of the outputs
const void* tf32x3_dq_kernel(int hd) {
  return hd == 64 ? (const void*)attention_bwd_tf32x3_dq_kernel<64, 1>
         : hd <= 64 ? (const void*)attention_bwd_tf32x3_dq_kernel<0, 1>
                    : (const void*)attention_bwd_tf32x3_dq_kernel<0, 2>;
}
const void* tf32x3_dkv_kernel(int hd) {
  return hd == 64 ? (const void*)attention_bwd_tf32x3_dkv_kernel<64, 1>
         : hd <= 64 ? (const void*)attention_bwd_tf32x3_dkv_kernel<0, 1>
                    : (const void*)attention_bwd_tf32x3_dkv_kernel<0, 2>;
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA of each variant needs (the wrapper checks
// them against the card's opt-in limit before launching).
size_t cc_attention_bwd_mma_smem_bytes(int L, int hd, int elem_bytes) {
  return mma_smem(L, hd, (size_t)elem_bytes);
}

size_t cc_attention_bwd_simt_smem_bytes(int L, int hd) { return simt_smem(L, hd); }

// Long-sequence variant (L > 128): the larger of its two kernels' needs.
size_t cc_attention_bwd_long_smem_bytes(int L, int hd, int elem_bytes) {
  (void)L;
  return dkv_smem(hd, (size_t)elem_bytes);
}

// Rows of fp32 statistics per (sample, head) the long variant's `stats`
// scratch holds ([3][B*H][this]).
int cc_attention_bwd_long_stats_len(int L) { return (L + kTile - 1) / kTile * kTile; }

// Registers per thread, shared-memory bytes per CTA and resident CTAs per
// SM (out[0..2]) of the long variant's dQ (which = 0) or dK / dV (which = 1)
// kernel for head_dim hd and dtype (1 bfloat16, 2 float16).
int cc_attention_bwd_long_occupancy(int which, int hd, int dtype, int* out) {
  switch (dtype) {
    case 1: return long_occupancy<__nv_bfloat16>(which, hd, out);
    case 2: return long_occupancy<__half>(which, hd, out);
    default: return (int)cudaErrorInvalidValue;
  }
}


// Tensor-core variant.  dtype: 1 bfloat16, 2 float16; hd % 16 == 0,
// 1 <= L <= 128; qkv, dout and dqkv 16-byte aligned.  mask and dmask may be
// null; a non-null dmask must hold zeros (or a sum to add to) on entry.
int cc_attention_bwd_mma(const void* qkv, const void* mask, const void* dout,
                         void* dqkv, void* dmask, int B, int L, int H, int hd,
                         int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_mma<__nv_bfloat16>(qkv, mask, dout, dqkv, dmask, B, L, H, hd, scale, s);
    case 2:
      return launch_mma<__half>(qkv, mask, dout, dqkv, dmask, B, L, H, hd, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Long-sequence tensor-core variant (L > 128): two launches.  dtype as
// above; hd % 16 == 0; qkv, dout and dqkv 16-byte aligned; mask may be
// null (no mask gradient); stats is fp32 scratch of
// 3 * B * H * cc_attention_bwd_long_stats_len(L) values.
int cc_attention_bwd_long(const void* qkv, const void* mask, const void* dout,
                          void* dqkv, void* stats, int B, int L, int H, int hd,
                          int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_long<__nv_bfloat16>(qkv, mask, dout, dqkv, stats, B, L, H, hd, scale,
                                        s);
    case 2:
      return launch_long<__half>(qkv, mask, dout, dqkv, stats, B, L, H, hd, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// CUDA-core variant, float32.  mask and dmask as above.
int cc_attention_bwd_simt(const void* qkv, const void* mask, const void* dout,
                          void* dqkv, void* dmask, int B, int L, int H, int hd,
                          float scale, void* stream) {
  const size_t smem = simt_smem(L, hd);
  const int err = set_smem((const void*)attention_bwd_kernel, smem);
  if (err) return err;
  attention_bwd_kernel<<<B * H, kSimtThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(mask),
      static_cast<const float*>(dout), static_cast<float*>(dqkv),
      static_cast<float*>(dmask), L, H, hd, scale);
  return (int)cudaGetLastError();
}

// fp32 tensor-core variant: the larger of its two kernels' needs.
size_t cc_attention_bwd_tf32x3_smem_bytes(int L, int hd) {
  (void)L;
  return tf32x3_dq_smem(hd) > tf32x3_dkv_smem(hd) ? tf32x3_dq_smem(hd) : tf32x3_dkv_smem(hd);
}

// Registers per thread, shared-memory bytes per CTA and resident CTAs per
// SM (out[0..2]) of the fp32 tensor-core variant's dQ (which = 0) or dK / dV
// (which = 1) kernel for head_dim hd.
int cc_attention_bwd_tf32x3_occupancy(int which, int hd, int* out) {
  if (which == 0) return cc::occupancy(tf32x3_dq_kernel(hd), tf32x3_dq_smem(hd), out);
  return cc::occupancy(tf32x3_dkv_kernel(hd), tf32x3_dkv_smem(hd), out);
}

// fp32 tensor-core variant (three TF32 passes): two launches.
// 1 <= hd <= 128, any L >= 1; mask may be null (no mask gradient).  out and
// lse are the forward's output [B, L, H * hd] and log-sum-exp [B * H][L]
// (cc_attention_fwd_tf32x3 on the same qkv and mask); delta is fp32
// scratch of B * H * L values.
int cc_attention_bwd_tf32x3(const void* qkv, const void* mask, const void* dout,
                            const void* out, const void* lse, void* dqkv, void* delta, int B,
                            int L, int H, int hd, float scale, void* stream) {
  if (L < 1 || hd < 1 || hd > 128) return (int)cudaErrorInvalidValue;
  const long long grid = (long long)B * H * ((L + kTile - 1) / kTile);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* dq_args[] = {&qkv, &mask, &dout, &out, &lse, &dqkv, &delta, &L, &H, &hd, &scale};
  size_t smem = tf32x3_dq_smem(hd);
  int err = set_smem(tf32x3_dq_kernel(hd), smem);
  if (!err)
    err = (int)cudaLaunchKernel(tf32x3_dq_kernel(hd), dim3((unsigned)grid),
                                dim3(kWarps * 32), dq_args, smem, st);
  if (err) return err;
  void* dkv_args[] = {&qkv, &mask, &dout, &lse, &delta, &dqkv, &L, &H, &hd, &scale};
  smem = tf32x3_dkv_smem(hd);
  if ((err = set_smem(tf32x3_dkv_kernel(hd), smem))) return err;
  return (int)cudaLaunchKernel(tf32x3_dkv_kernel(hd), dim3((unsigned)grid), dim3(kWarps * 32),
                               dkv_args, smem, st);
}

const char* cc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
