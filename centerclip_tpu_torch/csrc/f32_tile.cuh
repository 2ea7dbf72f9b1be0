// Building blocks of the fp32 attention kernels for long sequences (sm_90a):
// 64-row tiles of one head in shared memory, loaded by cp.async, and fp32
// FFMA products from register tiles of 4 x 4 outputs a thread.
//
// A CTA has 256 threads, thread (ty, tx) = (tid / 16, tid % 16).  Over a
// 64 x 64 tile of scores it owns rows ty * 4 + i and columns tx + 16 j
// (i, j < 4); over a 64-row tile of head channels, rows ty * 4 + i and
// channels tx * 4 + c + 64 g.  A row's 16 owners are 16 neighbouring lanes
// of one warp, so a row's max or sum is 4 shuffles.  Tiles are row major:
// a head tile's rows are its 64 tokens (channels padded with zeros to a
// multiple of 4, row stride ld_rows(hd), a multiple of 4 floats), a score
// tile's rows are its 64 queries (or keys), row stride kLd.  With those
// strides (hd a multiple of 8), the float4 loads of one quarter warp (8
// lanes) fall in 8 distinct groups of 4 banks or on one address: no bank
// conflicts.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace cc {
namespace f32 {

constexpr int kThreads = 256;
constexpr int kLd = kTile + 4;     // row stride of a 64 x 64 score tile
constexpr int kCols = 64;          // head channels of one register tile

__host__ __device__ inline int pad4(int x) { return (x + 3) & ~3; }
// row stride of a 64-row head tile
__host__ __device__ inline int ld_rows(int hd) { return pad4(hd) + 4; }

// whether a head's rows in `p` may be copied 16 bytes at a time
__device__ __forceinline__ bool vec_ok(const float* p, int hd) {
  return hd % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Rows r0 .. r0 + 63 of one head (hd floats at base + i * stride) into dst
// (rows ld apart) by cp.async, 16 bytes a copy where `vec`, else 4; rows
// at or past L and the channels hd .. pad4(hd) - 1 are zeroed.  Not waited
// for.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* base,
                                          size_t stride, int r0, int L, int hd, bool vec) {
  const int per_row = pad4(hd) / 4;
  for (int e = threadIdx.x; e < kTile * per_row; e += kThreads) {
    const int i = e / per_row, c = (e % per_row) * 4;
    float* d = dst + i * ld + c;
    const float* src = base + (size_t)(r0 + i) * stride + c;
    if (r0 + i >= L) {
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

// x * scale in a tile load_tile filled, each thread on the elements it
// copied itself: once its cp.async group has been waited for, no barrier is
// needed before this
__device__ __forceinline__ void scale_tile(float* dst, int ld, int hd, float scale) {
  const int per_row = pad4(hd) / 4;
  for (int e = threadIdx.x; e < kTile * per_row; e += kThreads) {
    float4* p = reinterpret_cast<float4*>(dst + (e / per_row) * ld + (e % per_row) * 4);
    float4 v = *p;
    v.x *= scale;
    v.y *= scale;
    v.z *= scale;
    v.w *= scale;
    *p = v;
  }
}

// c[i][j] = sum over channels d of a[ty * 4 + i][d] * b[tx + 16 j][d]: a
// product over head channels of two head tiles (S = q.K^T, dP = dO.V^T and
// their transposes), d in ascending order
__device__ __forceinline__ void rows_product(float (&c)[4][4], const float* sa,
                                             const float* sb, int ld, int hd) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* a = sa + ty * 4 * ld;
  const float* b = sb + tx * ld;
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
  const int hp = pad4(hd);
#pragma unroll 2
  for (int d = 0; d < hp; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + 16 * j * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[i][j] = fmaf(av[i].x, bv[j].x, c[i][j]);
        c[i][j] = fmaf(av[i].y, bv[j].y, c[i][j]);
        c[i][j] = fmaf(av[i].z, bv[j].z, c[i][j]);
        c[i][j] = fmaf(av[i].w, bv[j].w, c[i][j]);
      }
  }
}

// o[i][4 g + c] += sum over the 64 columns j of p[ty * 4 + i][j] *
// v[j][tx * 4 + 64 g + c]: a score tile (rows kLd apart) times a head tile
// (P.V, dS.K, P^T.dO, dS^T.q), j in ascending order; channels past hd are
// not computed
template <int NG>
__device__ __forceinline__ void keys_product(float (&o)[4][4 * NG], const float* sp,
                                             const float* sv, int ld, int hd) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* p = sp + ty * 4 * kLd;
  const int hp = pad4(hd);
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(p + i * kLd + j);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c0 = tx * 4 + kCols * g;
      if (c0 < hp) {
        const float* v = sv + j * ld + c0;
        const float4 v0 = *reinterpret_cast<const float4*>(v);
        const float4 v1 = *reinterpret_cast<const float4*>(v + ld);
        const float4 v2 = *reinterpret_cast<const float4*>(v + 2 * ld);
        const float4 v3 = *reinterpret_cast<const float4*>(v + 3 * ld);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* r = o[i] + 4 * g;
          r[0] = fmaf(pv[i].x, v0.x, r[0]);
          r[1] = fmaf(pv[i].x, v0.y, r[1]);
          r[2] = fmaf(pv[i].x, v0.z, r[2]);
          r[3] = fmaf(pv[i].x, v0.w, r[3]);
          r[0] = fmaf(pv[i].y, v1.x, r[0]);
          r[1] = fmaf(pv[i].y, v1.y, r[1]);
          r[2] = fmaf(pv[i].y, v1.z, r[2]);
          r[3] = fmaf(pv[i].y, v1.w, r[3]);
          r[0] = fmaf(pv[i].z, v2.x, r[0]);
          r[1] = fmaf(pv[i].z, v2.y, r[1]);
          r[2] = fmaf(pv[i].z, v2.z, r[2]);
          r[3] = fmaf(pv[i].z, v2.w, r[3]);
          r[0] = fmaf(pv[i].w, v3.x, r[0]);
          r[1] = fmaf(pv[i].w, v3.y, r[1]);
          r[2] = fmaf(pv[i].w, v3.z, r[2]);
          r[3] = fmaf(pv[i].w, v3.w, r[3]);
        }
      }
    }
  }
}

// The softmax's mask on a score tile of query rows row0 + i and keys
// key0 + 16 j: keys at or past L are -inf; `mask` [L, L] (may be null) is
// added on rows before L
__device__ __forceinline__ void mask_scores(float (&s)[4][4], int row0, int key0, int L,
                                            const float* __restrict__ mask) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + i, k = key0 + 16 * j;
      if (k >= L)
        s[i][j] = -INFINITY;
      else if (mask != nullptr && r < L)
        s[i][j] += mask[(size_t)r * L + k];
    }
}

// max / sum over the 16 lanes that hold one row of a score tile
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// o * mul into dst[r * stride + c] for rows r = row0 + i < L and the
// thread's channels c < hd
template <int NG>
__device__ __forceinline__ void store_rows(const float (&o)[4][4 * NG], float* dst,
                                           size_t stride, int row0, int L, int hd,
                                           float mul) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row0 + i < L) {
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ch = tx * 4 + kCols * g + c;
          if (ch < hd) dst[(size_t)(row0 + i) * stride + ch] = o[i][4 * g + c] * mul;
        }
    }
  }
}

}  // namespace f32
}  // namespace cc
