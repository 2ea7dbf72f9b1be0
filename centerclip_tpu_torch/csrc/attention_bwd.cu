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
// Three variants, chosen by the wrapper from dtype, head_dim and L:
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
// * attention_bwd_tiled_kernel (bf16 / fp16, hd % 16 == 0, 128 < L <= 256):
//   the same arithmetic with no [L, L] row held whole anywhere; one CTA of
//   8 warps per (sample, head), qs, k, v and dO in shared memory as above.
//   Query rows: each warp owns 16 of them and sweeps the keys twice in
//   tiles of 32.  The first sweep computes S and dP per tile and keeps, per
//   row, the running max m, l = sum exp(s - m) and a = sum exp(s - m) dP
//   (both rescaled when m grows), which give the softmax's max and sum and
//   delta = rowsum(dP * P) = a / l; the three go to shared memory.  The
//   second sweep recomputes S and dP per tile, forms P = exp(s - m) / l and
//   dS = P (dP - delta) in fp32 and accumulates dQ = hd^-0.5 dS.K (dS as
//   the hi/lo pair) in registers.  Key rows, after one barrier: each warp
//   owns 16 key rows and loops over query tiles of 16: S^T = K.qs^T and
//   dP^T = V.dO^T, then P^T and dS^T from the rows' m, l and delta, then
//   dV += T(P)^T.dO and dK += dS^T.qs, the C tiles becoming A fragments in
//   registers.  delta is not taken from the rounded forward output
//   (rowsum(dO * O) would move dS by about 2^-8).  S and dP are computed
//   three times instead of once: at L = 197, hd = 64 that is ~11 products
//   of 2 Lp^2 hd flops per head, ~1.1 Tflop for ViT-B/16's 1536 x 12
//   heads, ~1.1 ms at the H100's dense bf16 peak, above the 0.97 ms its
//   bytes take.  One CTA (~140 KB of shared memory at L = 197) fills an SM.
//   Sums run in a fixed order and nothing is atomic: deterministic.  No
//   mask gradient (only the text tower has a mask, at L <= 77).
// * attention_bwd_kernel (fp32): CUDA cores, the products as fmaf loops from
//   shared memory (no exact fp32 tensor-core product; TF32 is off), P and dS
//   as fp32 [L, L] tiles in shared memory.
//
// The TPU kernel's sequential-grid accumulation of dmask has no counterpart
// here: CTAs add their dS into the fp32 [L, L] buffer with atomicAdd.
#include <math.h>

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

// ----------------------------------- bf16 / fp16, 128 < L <= 256 (key tiles)
constexpr int kTiledWarps = 8;
constexpr int kKeyTile = 32;       // keys per register tile of the query sweeps
constexpr int kKT = kKeyTile / 8;  // its n-tiles
constexpr int kTiledMaxL = 256;

// shared memory: qs, k, v, dO [Lp][hd + 8] (T); the rows' max, sum and
// delta [Lp] each (fp32); one [16][72] staging tile (T) per warp
__host__ __device__ inline size_t tiled_smem(int L, int hd, size_t elem) {
  const size_t Lp = pad16(L);
  return 4 * Lp * (hd + kPad) * elem + 3 * Lp * sizeof(float)
         + kTiledWarps * kStage * elem;
}

// S = qs.K^T and dP = dO.V^T for query rows q0..q0+15 and keys
// j0..j0+kKeyTile-1, then the keys past L set to -inf and the mask added on
// real query rows.  Key n-tiles past the padded length are not computed.
template <typename T>
__device__ __forceinline__ void score_tile(float (&s)[kKT][4], float (&dp)[kKT][4],
                                           const T* sq, const T* sk, const T* sv,
                                           const T* sdo, const float* mask, int ld,
                                           int q0, int j0, int L, int Lp, int hd,
                                           int lane) {
#pragma unroll
  for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
  for (int ks = 0; ks < hd; ks += 16) {
    uint32_t aq[4], ag[4];
    cc::ldmatrix_x4(aq, cc::a_frag(sq, ld, q0, ks, lane));
    cc::ldmatrix_x4(ag, cc::a_frag(sdo, ld, q0, ks, lane));
#pragma unroll
    for (int np = 0; np < kKT / 2; ++np) {
      if (j0 + np * 16 < Lp) {
        uint32_t bk[4], bv[4];
        cc::ldmatrix_x4(bk, cc::b_pair(sk, ld, j0 + np * 16, ks, lane));
        cc::mma16816<T>(s[2 * np], aq, bk[0], bk[1]);
        cc::mma16816<T>(s[2 * np + 1], aq, bk[2], bk[3]);
        cc::ldmatrix_x4(bv, cc::b_pair(sv, ld, j0 + np * 16, ks, lane));
        cc::mma16816<T>(dp[2 * np], ag, bv[0], bv[1]);
        cc::mma16816<T>(dp[2 * np + 1], ag, bv[2], bv[3]);
      }
    }
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = q0 + g + (e >> 1) * 8, j = j0 + nt * 8 + 2 * t + (e & 1);
      if (j >= L)
        s[nt][e] = -INFINITY;
      else if (mask != nullptr && i < L)
        s[nt][e] += mask[(size_t)i * L + j];
    }
}

template <typename T>
__global__ void __launch_bounds__(kTiledWarps * 32)
attention_bwd_tiled_kernel(const T* __restrict__ qkv, const float* __restrict__ mask,
                           const T* __restrict__ dout, T* __restrict__ dqkv, int L,
                           int H, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Lp = pad16(L), ld = hd + kPad;
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + Lp * ld;
  T* sv = sk + Lp * ld;
  T* sdo = sv + Lp * ld;
  float* rmax = reinterpret_cast<float*>(sdo + Lp * ld);
  float* rsum = rmax + Lp;
  float* rdelta = rsum + Lp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* stage = reinterpret_cast<T*>(rdelta + Lp) + warp * kStage;

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
  for (int q0 = warp * 16; q0 < Lp; q0 += kTiledWarps * 16) {
    // sweep 1: per row (two per thread: g and g + 8) the running max m,
    // l = sum exp(s - m) and a = sum exp(s - m) dP
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
    for (int j0 = 0; j0 < Lp; j0 += kKeyTile) {
      float s[kKT][4], dp[kKT][4];
      score_tile<T>(s, dp, sq, sk, sv, sdo, mask, ld, q0, j0, L, Lp, hd, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tmax = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kKT; ++nt)
          tmax = fmaxf(tmax, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
        const float mn = fmaxf(m[r], cc::quad_max(tmax));
        const float ref = mn == -INFINITY ? 0.f : mn;
        float ls = 0.f, as = 0.f;
#pragma unroll
        for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = expf(s[nt][2 * r + c] - ref);
            ls += x;
            as += x * dp[nt][2 * r + c];
          }
        const float shrink = expf(m[r] - ref);      // 0 while m is -inf
        l[r] = l[r] * shrink + cc::quad_sum(ls);
        a[r] = a[r] * shrink + cc::quad_sum(as);
        m[r] = mn;
      }
    }
    float ref[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ref[r] = m[r] == -INFINITY ? 0.f : m[r];
      delta[r] = a[r] / l[r];
      if (t == 0) {
        const int i = q0 + g + 8 * r;
        rmax[i] = ref[r];
        rsum[i] = l[r];
        rdelta[i] = delta[r];
      }
    }

    // sweep 2: P and dS per key tile, dQ = hd^-0.5 * dS . K, 64 channels
    // at a time; rows >= L (padding) get P = dS = 0
    for (int c0 = 0; c0 < hd; c0 += kCols) {
      const int n_tiles = min(kCols, hd - c0) / 8;
      float acc[kCols / 8][4];
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      for (int j0 = 0; j0 < Lp; j0 += kKeyTile) {
        float s[kKT][4], dp[kKT][4];
        score_tile<T>(s, dp, sq, sk, sv, sdo, mask, ld, q0, j0, L, Lp, hd, lane);
#pragma unroll
        for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = q0 + g + 8 * r < L ? expf(s[nt][e] - ref[r]) / l[r] : 0.f;
            dp[nt][e] = p * (dp[nt][e] - delta[r]);
          }
#pragma unroll
        for (int kk = 0; kk < kKT / 2; ++kk) {
          if (j0 + kk * 16 < Lp) {
            uint32_t ah[4], al[4];
            split2<T>(dp[2 * kk][0], dp[2 * kk][1], ah[0], al[0]);
            split2<T>(dp[2 * kk][2], dp[2 * kk][3], ah[1], al[1]);
            split2<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1], ah[2], al[2]);
            split2<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
            for (int np = 0; np < kCols / 16; ++np) {
              if (2 * np < n_tiles) {
                uint32_t bk[4];
                cc::ldmatrix_x4_trans(bk, cc::trans_b_pair(sk, ld, j0 + kk * 16,
                                                           c0 + np * 16, lane));
                cc::mma16816<T>(acc[2 * np], ah, bk[0], bk[1]);
                cc::mma16816<T>(acc[2 * np], al, bk[0], bk[1]);
                cc::mma16816<T>(acc[2 * np + 1], ah, bk[2], bk[3]);
                cc::mma16816<T>(acc[2 * np + 1], al, bk[2], bk[3]);
              }
            }
          }
        }
      }
      cc::store_tile<T, kCols / 8>(acc, stage, gb, row, q0, L, c0, n_tiles, scale, lane);
    }
  }
  __syncthreads();

  // -------------------------------------------------- key rows, per warp
  for (int k0 = warp * 16; k0 < Lp; k0 += kTiledWarps * 16) {
    for (int c0 = 0; c0 < hd; c0 += kCols) {
      const int n_tiles = min(kCols, hd - c0) / 8;
      float av[kCols / 8][4], ak[kCols / 8][4];
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) av[nt][e] = ak[nt][e] = 0.f;
      for (int i0 = 0; i0 < Lp; i0 += 16) {
        // S^T and dP^T of keys k0..k0+15 (rows) and queries i0..i0+15
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
        for (int ks = 0; ks < hd; ks += 16) {
          uint32_t ak_[4], av_[4], bq[4], bo[4];
          cc::ldmatrix_x4(ak_, cc::a_frag(sk, ld, k0, ks, lane));
          cc::ldmatrix_x4(bq, cc::b_pair(sq, ld, i0, ks, lane));
          cc::mma16816<T>(st[0], ak_, bq[0], bq[1]);
          cc::mma16816<T>(st[1], ak_, bq[2], bq[3]);
          cc::ldmatrix_x4(av_, cc::a_frag(sv, ld, k0, ks, lane));
          cc::ldmatrix_x4(bo, cc::b_pair(sdo, ld, i0, ks, lane));
          cc::mma16816<T>(dpt[0], av_, bo[0], bo[1]);
          cc::mma16816<T>(dpt[1], av_, bo[2], bo[3]);
        }
        // element (key j = k0 + g + 8 (e / 2), query i = i0 + 8 nt + 2 t + e % 2)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = k0 + g + (e >> 1) * 8, i = i0 + nt * 8 + 2 * t + (e & 1);
            float p = 0.f;
            if (i < L && j < L) {
              float x = st[nt][e];
              if (mask != nullptr) x += mask[(size_t)i * L + j];
              p = expf(x - rmax[i]) / rsum[i];
            }
            st[nt][e] = p;
            dpt[nt][e] = p * (dpt[nt][e] - rdelta[i]);
          }
        const uint32_t ap[4] = {cc::pack2<T>(st[0][0], st[0][1]),
                                cc::pack2<T>(st[0][2], st[0][3]),
                                cc::pack2<T>(st[1][0], st[1][1]),
                                cc::pack2<T>(st[1][2], st[1][3])};
        uint32_t ah[4], al[4];
        split2<T>(dpt[0][0], dpt[0][1], ah[0], al[0]);
        split2<T>(dpt[0][2], dpt[0][3], ah[1], al[1]);
        split2<T>(dpt[1][0], dpt[1][1], ah[2], al[2]);
        split2<T>(dpt[1][2], dpt[1][3], ah[3], al[3]);
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

template <typename T>
int launch_tiled(const void* qkv, const void* mask, const void* dout, void* dqkv, int B,
                 int L, int H, int hd, float scale, cudaStream_t stream) {
  if (hd % 16 != 0 || L <= kMaxL || L > kTiledMaxL) return (int)cudaErrorInvalidValue;
  const size_t smem = tiled_smem(L, hd, sizeof(T));
  const int err = set_smem((const void*)attention_bwd_tiled_kernel<T>, smem);
  if (err) return err;
  attention_bwd_tiled_kernel<T><<<B * H, kTiledWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask),
      static_cast<const T*>(dout), static_cast<T*>(dqkv), L, H, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA of each variant needs (the wrapper checks
// them against the card's opt-in limit before launching).
size_t cc_attention_bwd_mma_smem_bytes(int L, int hd, int elem_bytes) {
  return mma_smem(L, hd, (size_t)elem_bytes);
}

size_t cc_attention_bwd_simt_smem_bytes(int L, int hd) { return simt_smem(L, hd); }

size_t cc_attention_bwd_tiled_smem_bytes(int L, int hd, int elem_bytes) {
  return tiled_smem(L, hd, (size_t)elem_bytes);
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

// Key-tiled tensor-core variant.  dtype as above; hd % 16 == 0,
// 128 < L <= 256; qkv, dout and dqkv 16-byte aligned; mask may be null.
int cc_attention_bwd_tiled(const void* qkv, const void* mask, const void* dout,
                           void* dqkv, int B, int L, int H, int hd, int dtype,
                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch_tiled<__nv_bfloat16>(qkv, mask, dout, dqkv, B, L, H, hd, scale, s);
    case 2:
      return launch_tiled<__half>(qkv, mask, dout, dqkv, B, L, H, hd, scale, s);
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

const char* cc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
