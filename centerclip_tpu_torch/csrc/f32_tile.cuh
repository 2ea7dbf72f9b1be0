// Building blocks of the fp32 attention kernels ("tf32x3", sm_90a): 64- or
// 32-row tiles of one head in shared memory, loaded by cp.async, and
// products on the tensor cores in three TF32 passes.
//
// The split.  Tensor cores take fp32 operands only as TF32 (10 stored
// mantissa bits).  Each operand x is split once into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna), and a product A.B is taken as
// lo_A.hi_B + hi_A.lo_B + hi_A.hi_B by mma.m16n8k8 with fp32
// accumulation, the two small terms before the big one in every k-step
// (CUTLASS's OpMultiplyAddFastF32 order).  Only lo_A.lo_B (~2^-22
// relative) is dropped, so a product keeps about fp32's precision; one
// TF32 pass (what cuBLAS does with TF32 on) would not (PERF.md and
// tests/test_torch_attention_design.py hold both against the fp32 plain
// versions).
//
// Where operands are split.  A tile that all four warps of a CTA read (the
// streamed K and V of the forward and of the dQ launch, the streamed q and
// dO of the dK / dV launch) is split once on arrival, each thread on the
// chunks it copied itself, into a hi tile (in place) and a lo tile of the
// same layout.  A warp's own 16 rows (its q, its dO, its keys' K and V)
// stay raw fp32 and the warp splits the four values of each A fragment as
// it reads them: nobody else reads them.  Probabilities and dS leave the
// accumulator as fp32 and are split once, as A fragments.
//
// Fragment layouts of mma.m16n8k8.tf32 (g = lane / 4, t = lane % 4):
//   A (16 x 8): a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4),
//               a3 (row g+8, k t+4)
//   B (8 x 8):  b0 (k t, n g), b1 (k t+4, n g)
//   C (16 x 8): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same)
// A C tile (scores: rows x 8 keys) becomes the A fragment of a product over
// those keys with k index t read as key 2t and t + 4 as key 2t + 1:
// a = (c0, c2, c1, c3), and the B fragment is then read at keys 2t and
// 2t + 1 (cols_product).  The order of k inside one mma does not change
// the sum.
//
// Tiles are row major with a row stride of ld_rows(hd) = pad8(hd) + 4
// floats, 4 times an odd number, so both ways the fragments are read (row
// g, column t: rows_product; row 2t, column g: cols_product) hit 32
// distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace cc {
namespace f32 {

__host__ __device__ inline int pad8(int x) { return (x + 7) & ~7; }
// row stride of a head tile: channels padded with zeros to a multiple of 8
// (one mma k-step), plus 4
__host__ __device__ inline int ld_rows(int hd) { return pad8(hd) + 4; }

// whether a head's rows in `p` may be copied 16 bytes at a time
__device__ __forceinline__ bool vec_ok(const float* p, int hd) {
  return hd % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The rows of a streamed tile of ROWS rows from r0 that any product reads:
// those before L, padded to a whole 8-row mma tile
template <int ROWS>
__device__ __forceinline__ int live_rows(int r0, int L) {
  return min(ROWS, pad8(L - r0));
}

// Rows r0 .. r0 + rows - 1 (rows <= ROWS) of one head (hd floats at
// base + i * stride) into dst (rows ld apart) by cp.async, 16 bytes a copy
// where `vec`, else 4; rows at or past L and the channels hd .. pad8(hd) - 1
// are zeroed.  A CTA of 128 threads; not waited for.
template <int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* base,
                                          size_t stride, int r0, int L, int hd, bool vec,
                                          int rows = ROWS) {
  const int per_row = pad8(hd) / 4;
  for (int e = threadIdx.x; e < rows * per_row; e += 128) {
    const int i = e / per_row, c = (e % per_row) * 4;
    float* d = dst + i * ld + c;
    const float* src = base + (size_t)(r0 + i) * stride + c;
    if (r0 + i >= L || c >= hd) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (vec) {
      cp_async16(d, src);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (c + q < hd)
          cp_async4(d + q, src + q);
        else
          d[q] = 0.f;
      }
    }
  }
}

// x * scale in place, on the chunks of a tile this thread's load_tile
// copied: once its cp.async group has been waited for, no barrier is
// needed before this
template <int ROWS>
__device__ __forceinline__ void scale_tile(float* dst, int ld, int hd, float scale) {
  const int per_row = pad8(hd) / 4;
  for (int e = threadIdx.x; e < ROWS * per_row; e += 128) {
    float4* p = reinterpret_cast<float4*>(dst + (e / per_row) * ld + (e % per_row) * 4);
    float4 v = *p;
    v.x *= scale;
    v.y *= scale;
    v.z *= scale;
    v.w *= scale;
    *p = v;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (lo rounded: the error left is ~2^-22 x)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// (x * mul) split, in place into hi and into lo at the same offset, on the
// chunks of a tile (its first `rows` rows) this thread's load_tile copied
// (no barrier needed before; one is needed before any other thread reads
// the halves)
template <int ROWS>
__device__ __forceinline__ void split_tile(float* hi, float* lo, int ld, int hd, float mul,
                                           int rows = ROWS) {
  const int per_row = pad8(hd) / 4;
  for (int e = threadIdx.x; e < rows * per_row; e += 128) {
    const int off = (e / per_row) * ld + (e % per_row) * 4;
    const float4 v = *reinterpret_cast<const float4*>(hi + off);
    uint4 h, l;
    split(v.x * mul, h.x, l.x);
    split(v.y * mul, h.y, l.y);
    split(v.z * mul, h.z, l.z);
    split(v.w * mul, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// d += a . b over one m16n8k8 TF32 tile, fp32 accumulation (not volatile:
// the compiler may interleave independent tiles)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[c0 + nt] += A . B_nt for nt < n (b[nt] = {hi0, hi1, lo0, lo1}): the
// three passes, small terms first, each pass over all n-tiles (independent
// accumulators between dependent mma)
template <int NC, int NT>
__device__ __forceinline__ void mma3(float (&c)[NC][4], int c0, const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&b)[NT][4],
                                     int n) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < n) mma_tf32(c[c0 + nt], al, b[nt][0], b[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < n) mma_tf32(c[c0 + nt], ah, b[nt][2], b[nt][3]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt < n) mma_tf32(c[c0 + nt], ah, b[nt][0], b[nt][1]);
}

// c[nt] += A . B^T over channels k .. k + 7, for one warp: A the warp's 16
// raw fp32 rows at `sa` (split as read), B the rows 8 nt .. 8 nt + 7 of a
// split tile (bh, bl), nt < n
template <int NT>
__device__ __forceinline__ void rows_step(float (&c)[NT][4], const float* sa, const float* bh,
                                          const float* bl, int ld, int k, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* a = sa + g * ld + t + k;
  uint32_t ah[4], al[4];
  split(a[0], ah[0], al[0]);
  split(a[8 * ld], ah[1], al[1]);
  split(a[4], ah[2], al[2]);
  split(a[8 * ld + 4], ah[3], al[3]);
  uint32_t b[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt < n) {
      const int off = (nt * 8 + g) * ld + k + t;
      b[nt][0] = __float_as_uint(bh[off]);
      b[nt][1] = __float_as_uint(bh[off + 4]);
      b[nt][2] = __float_as_uint(bl[off]);
      b[nt][3] = __float_as_uint(bl[off + 4]);
    }
  }
  mma3(c, 0, ah, al, b, n);
}

// c[nt] = A . B^T over the hp (= pad8(hd)) channels (rows_step's A and B),
// nt < n (the rest stay 0).  S = qs.K^T, dP = dO.V^T.  FULL: n is NT, so
// no load or mma sits behind a branch (the compiler interleaves them
// freely); the kernels take it for every whole tile.  The k loop unrolls
// whole where hd is compiled in (4 % faster forward on the card than two
// steps at a time; the pair below, 4 steps).
template <int NT, bool FULL>
__device__ __forceinline__ void rows_product(float (&c)[NT][4], const float* sa,
                                             const float* bh, const float* bl, int ld,
                                             int hp, int n, int lane) {
  if (FULL) n = NT;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int k = 0; k < hp; k += 8) rows_step(c, sa, bh, bl, ld, k, n, lane);
}

// Two such products over one loop, their k-steps interleaved (twice the
// independent mma a warp has in flight): the dK / dV launch's
// S^T = K.qs^T and dP^T = V.dO^T, 3 % faster on the card (B) than one
// after the other.
template <int NT, bool FULL>
__device__ __forceinline__ void rows_product2(float (&c)[NT][4], const float* sa,
                                              const float* bh, const float* bl,
                                              float (&d)[NT][4], const float* sa2,
                                              const float* bh2, const float* bl2, int ld,
                                              int hp, int n, int lane) {
  if (FULL) n = NT;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = d[nt][e] = 0.f;
#pragma unroll 4
  for (int k = 0; k < hp; k += 8) {
    rows_step(c, sa, bh, bl, ld, k, n, lane);
    rows_step(d, sa2, bh2, bl2, ld, k, n, lane);
  }
}

// acc[ct] += P . B over k-steps kk < n_k (8 keys, or queries, each), for
// the channel tiles ct with 8 ct < hp: P in C layout (16 rows x 8 NK
// columns, split here, once per element), B rows 8 kk .. 8 kk + 7 of a
// split tile (rows = k, columns = channels), read at rows 2t and 2t + 1 to
// match P's k order.  O += P.V, dQ += dS.K, dV += P^T.dO, dK += dS^T.qs.
// FULL: n_k is NK (as in rows_product).
template <int NC, int NK, bool FULL>
__device__ __forceinline__ void cols_product(float (&acc)[NC][4], const float (&p)[NK][4],
                                             const float* bh, const float* bl, int ld, int hp,
                                             int n_k, int lane) {
  if (FULL) n_k = NK;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kGroup = 8;        // channel tiles whose B fragments load together
  static_assert(NC % kGroup == 0, "channel tiles come in groups of 8");
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    if (kk < n_k) {
      uint32_t ah[4], al[4];
      split(p[kk][0], ah[0], al[0]);
      split(p[kk][2], ah[1], al[1]);
      split(p[kk][1], ah[2], al[2]);
      split(p[kk][3], ah[3], al[3]);
      const int r = (kk * 8 + 2 * t) * ld + g;
#pragma unroll
      for (int c0 = 0; c0 < NC; c0 += kGroup) {
        const int n = min(kGroup, hp / 8 - c0);
        uint32_t b[kGroup][4];
#pragma unroll
        for (int ct = 0; ct < kGroup; ++ct) {
          if (ct < n) {
            const int off = r + (c0 + ct) * 8;
            b[ct][0] = __float_as_uint(bh[off]);
            b[ct][1] = __float_as_uint(bh[off + ld]);
            b[ct][2] = __float_as_uint(bl[off]);
            b[ct][3] = __float_as_uint(bl[off + ld]);
          }
        }
        mma3(acc, c0, ah, al, b, n);
      }
    }
  }
}

// The softmax's mask on a C tile of scores (query rows i0 .., keys k0 ..,
// NT 8-key n-tiles): keys at or past L are -inf; `mask` [L, L] (may be
// null) is added on rows before L
template <int NT>
__device__ __forceinline__ void mask_scores(float (&s)[NT][4], int i0, int k0, int L,
                                            const float* __restrict__ mask, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + (e >> 1) * 8, j = k0 + nt * 8 + 2 * t + (e & 1);
      if (j >= L)
        s[nt][e] = -INFINITY;
      else if (mask != nullptr && i < L)
        s[nt][e] += mask[(size_t)i * L + j];
    }
}

// acc * mul into dst[i * stride + c] for the warp's rows i = r0 + g + 8 h
// < rows and channels c = 8 ct + 2 t (+1) < hd
template <int NC>
__device__ __forceinline__ void store_rows(const float (&acc)[NC][4], float* dst,
                                           size_t stride, int r0, int rows, int hd,
                                           const float (&mul)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + g + 8 * h;
    if (i < rows) {
      float* d = dst + (size_t)i * stride;
#pragma unroll
      for (int ct = 0; ct < NC; ++ct) {
        const int c = ct * 8 + 2 * t;
        if (c < hd) d[c] = acc[ct][2 * h] * mul[h];
        if (c + 1 < hd) d[c + 1] = acc[ct][2 * h + 1] * mul[h];
      }
    }
  }
}

}  // namespace f32
}  // namespace cc
